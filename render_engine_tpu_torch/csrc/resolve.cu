// K2: the attribute resolve.
//
// Replaces render_engine_tpu/render/raster_pallas.py::_resolve_kernel (run
// through resolve_attributes_pallas). Per tile, each pixel's winner slot
// picks its candidate's attribute row: out[a, t, y, x] = rows[t, slot, a],
// and 0 where the pixel is empty (slot < 0). On the TPU this was a one-hot
// matrix product, because a gather is slow there; here it is the gather
// itself, exact and with no multiply.
//
// What bounds it on an H100: memory. Each pixel reads its winner's row of
// A floats (A = 48, 56 or 64; rows of one tile are re-read by many pixels
// and stay in L1/L2) and writes A floats. One block walks one tile; its
// threads walk the tile's pixels, so every channel plane is written with
// coalesced stores.

#include "common.cuh"

namespace rek {
namespace {

__global__ void __launch_bounds__(kThreads)
resolve_kernel(const int* __restrict__ slot, const float* __restrict__ rows,
               float* __restrict__ out, int tb, int npx, int k, int a) {
  const int t = blockIdx.x;
  for (int p = threadIdx.x; p < npx; p += blockDim.x) {
    const int s = slot[static_cast<size_t>(t) * npx + p];
    const bool hit = s >= 0 && s < k;
    const float* row = rows + (static_cast<size_t>(t) * k + (hit ? s : 0)) * a;
    for (int c = 0; c < a; ++c) {
      out[(static_cast<size_t>(c) * tb + t) * npx + p] = hit ? row[c] : 0.0f;
    }
  }
}

}  // namespace
}  // namespace rek

// slot (tb, npx) i32, rows (tb, k, a) f32 -> out (a, tb, npx) f32.
// Returns cudaGetLastError().
extern "C" int launch_resolve(const int* slot, const float* rows, float* out,
                              int tb, int npx, int k, int a,
                              cudaStream_t stream) {
  if (tb == 0) return cudaSuccess;
  rek::resolve_kernel<<<tb, rek::kThreads, 0, stream>>>(slot, rows, out, tb,
                                                        npx, k, a);
  return cudaGetLastError();
}
