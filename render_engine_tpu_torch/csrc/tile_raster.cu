// K1: the tile rasterizer.
//
// Replaces render_engine_tpu/render/raster_pallas.py::_tile_kernel (launched
// by _launch). One block walks one screen tile (8x128 by default); each of
// its 256 threads owns 4 of the tile's pixel centres and keeps their
// nearest depth, winner triangle id and winner candidate slot in registers
// for one layer, or for the opaque and the transparent layer (two_pass).
//
// The block stages the tile's live candidates, (10, K) floats and K ids,
// about 9 KB at K = 208, in shared memory, and reads the three trip counts
// (opaque window, transparent window, global list) from device memory, so
// the host never waits on them. Candidates are visited in table order and
// a nearer depth must win with a strict <, so the first candidate seen
// keeps an exact tie: that is the reference's contract.
//
// What bounds it on an H100: arithmetic. Per candidate and pixel it does
// about 25 float operations and no memory traffic; the candidate's 10
// scalars are one broadcast shared-memory read per warp. The outputs,
// 12 or 24 bytes a pixel, are written once with coalesced stores.
//
// Rounding: the JAX reference, compiled by XLA, contracts each edge
// function into fma(bx - ax, py - ay, -((by - ay) * (px - ax))) and the
// depth sum into fma(l2, z2, fma(l0, z0, l1 * z1)). The kernel writes those
// fused forms with __fmaf_rn and nothing else is contracted (-fmad=false),
// so winners on triangle edges and on exact ties agree with the reference
// and with the plain PyTorch version bit for bit.

#include "common.cuh"

namespace rek {
namespace {

__device__ __forceinline__ float edge(float ax, float ay, float bx, float by,
                                      float px, float py) {
  return __fmaf_rn(bx - ax, py - ay, -((by - ay) * (px - ax)));
}

__global__ void __launch_bounds__(kThreads)
tile_raster_kernel(const float* __restrict__ data, const int* __restrict__ ids,
                   const int* __restrict__ counts, float* __restrict__ d_out,
                   int* __restrict__ w_out, int* __restrict__ s_out,
                   float* __restrict__ td_out, int* __restrict__ tw_out,
                   int* __restrict__ ts_out, int k, int tiles_x, int th,
                   int tw, int tile_budget, int trans_budget, int two_pass) {
  extern __shared__ float smem[];
  float* sdat = smem;                                // (10, k)
  int* sid = reinterpret_cast<int*>(smem + 10 * k);  // (k,)

  const int t = blockIdx.x;
  const int npx = th * tw;
  const int glob0 = tile_budget + trans_budget;
  const int n0 = min(max(counts[t * 3 + 0], 0), tile_budget);
  const int n1 = min(max(counts[t * 3 + 1], 0), trans_budget);
  const int n2 = min(max(counts[t * 3 + 2], 0), k - glob0);

  const float* src = data + static_cast<size_t>(t) * 10 * k;
  const int* isrc = ids + static_cast<size_t>(t) * k;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const bool live = i < n0 ||
                      (i >= tile_budget && i < tile_budget + n1) ||
                      (i >= glob0 && i < glob0 + n2);
    if (live) {
#pragma unroll
      for (int c = 0; c < 10; ++c) sdat[c * k + i] = src[c * k + i];
      sid[i] = isrc[i];
    }
  }
  __syncthreads();

  const int oy = (t / tiles_x) * th;
  const int ox = (t % tiles_x) * tw;
  float px[kMaxPix], py[kMaxPix];
  float bd[kMaxPix], btd[kMaxPix];
  int bt[kMaxPix], bk[kMaxPix], btt[kMaxPix], btk[kMaxPix];
#pragma unroll
  for (int j = 0; j < kMaxPix; ++j) {
    const int p = threadIdx.x + j * kThreads;
    py[j] = (static_cast<float>(p / tw) + static_cast<float>(oy)) + 0.5f;
    px[j] = (static_cast<float>(p % tw) + static_cast<float>(ox)) + 0.5f;
    bd[j] = btd[j] = __int_as_float(0x7f800000);  // +inf
    bt[j] = bk[j] = btt[j] = btk[j] = -1;
  }

  auto visit = [&](int kk) {
    const float x0 = sdat[0 * k + kk], y0 = sdat[1 * k + kk];
    const float x1 = sdat[2 * k + kk], y1 = sdat[3 * k + kk];
    const float x2 = sdat[4 * k + kk], y2 = sdat[5 * k + kk];
    const float z0 = sdat[6 * k + kk], z1 = sdat[7 * k + kk];
    const float z2 = sdat[8 * k + kk], cls = sdat[9 * k + kk];
    const int tid = sid[kk];
#pragma unroll
    for (int j = 0; j < kMaxPix; ++j) {
      const float l0 = edge(x1, y1, x2, y2, px[j], py[j]);
      const float l1 = edge(x2, y2, x0, y0, px[j], py[j]);
      const float l2 = edge(x0, y0, x1, y1, px[j], py[j]);
      const float area = (l0 + l1) + l2;
      const bool nz = fabsf(area) > 1e-9f;
      bool inside = ((l0 >= 0.0f) && (l1 >= 0.0f) && (l2 >= 0.0f)) ||
                    ((l0 <= 0.0f) && (l1 <= 0.0f) && (l2 <= 0.0f));
      inside = inside && nz && (cls > 0.0f);
      const float inv_area = 1.0f / (nz ? area : 1.0f);
      const float d = __fmaf_rn(l2, z2, __fmaf_rn(l0, z0, l1 * z1)) * inv_area;
      inside = inside && (d >= -1.0f) && (d <= 1.0f);
      if (two_pass) {
        if (inside && cls < 1.5f && d < bd[j]) {
          bd[j] = d;
          bt[j] = tid;
          bk[j] = kk;
        }
        if (inside && cls > 1.5f && d < btd[j]) {
          btd[j] = d;
          btt[j] = tid;
          btk[j] = kk;
        }
      } else if (inside && d < bd[j]) {
        bd[j] = d;
        bt[j] = tid;
        bk[j] = kk;
      }
    }
  };
  for (int i = 0; i < n0; ++i) visit(i);
  for (int i = 0; i < n1; ++i) visit(tile_budget + i);
  for (int i = 0; i < n2; ++i) visit(glob0 + i);

  const size_t base = static_cast<size_t>(t) * npx;
#pragma unroll
  for (int j = 0; j < kMaxPix; ++j) {
    const int p = threadIdx.x + j * kThreads;
    if (p >= npx) continue;
    d_out[base + p] = bt[j] >= 0 ? bd[j] : 1.0f;
    w_out[base + p] = bt[j];
    s_out[base + p] = bk[j];
    if (two_pass) {
      td_out[base + p] = btt[j] >= 0 ? btd[j] : 1.0f;
      tw_out[base + p] = btt[j];
      ts_out[base + p] = btk[j];
    }
  }
}

}  // namespace
}  // namespace rek

// data (nt, 10, k) f32, ids (nt, 1, k) i32, counts (nt, 1, 3) i32; outputs
// (nt, th, tw): depth f32, winner i32, slot i32, then the transparent
// layer's three when two_pass (null otherwise). Returns cudaGetLastError().
extern "C" int launch_tile_raster(const float* data, const int* ids,
                                  const int* counts, float* d_out, int* w_out,
                                  int* s_out, float* td_out, int* tw_out,
                                  int* ts_out, int nt, int k, int tiles_x,
                                  int th, int tw, int tile_budget,
                                  int trans_budget, int two_pass,
                                  cudaStream_t stream) {
  if (th * tw > rek::kThreads * rek::kMaxPix) return cudaErrorInvalidValue;
  if (nt == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(k) * 11 * sizeof(float);
  cudaError_t err = rek::allow_smem(rek::tile_raster_kernel, smem);
  if (err != cudaSuccess) return err;
  rek::tile_raster_kernel<<<nt, rek::kThreads, smem, stream>>>(
      data, ids, counts, d_out, w_out, s_out, td_out, tw_out, ts_out, k,
      tiles_x, th, tw, tile_budget, trans_budget, two_pass);
  return cudaGetLastError();
}
