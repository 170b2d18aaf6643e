// Shared helpers of the port's CUDA kernels (plain C interface, built with
// nvcc -gencode arch=compute_90a,code=sm_90a -fmad=false; see kernels.py).
//
// The library is compiled with -fmad=false: every a * b + c below rounds
// twice, exactly like the PyTorch ops of the kernels' plain versions. Where
// the JAX reference's compiled arithmetic contracts into a fused
// multiply-add, the kernel says so with an explicit __fmaf_rn.
#pragma once

#include <cuda_runtime.h>

namespace rek {

// Threads of a block that walks one screen tile; each thread owns up to
// kMaxPix pixels of the tile (tiles up to 1024 pixels, 8x128 by default).
constexpr int kThreads = 256;
constexpr int kMaxPix = 4;

// max / min that keep a NaN in x, like jnp.maximum and torch.clamp
__device__ __forceinline__ float max_nan(float x, float lo) {
  return (x < lo) ? lo : x;
}
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return (x < lo) ? lo : ((x > hi) ? hi : x);
}

// 1 / sqrt(x) as PyTorch's CUDA rsqrt computes it (rsqrtf, within 2 ulp),
// so that a kernel follows its plain version on the card; the JAX
// reference's rsqrt may differ in the last bits
__device__ __forceinline__ float rsqrt_pt(float x) { return rsqrtf(x); }

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename K>
__host__ cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rek
