// The default route's tall G-buffers: both layers, every pixel, in place
// from K1's planes and the candidate rows.
//
// Replaces no Pallas kernel: the JAX package leaves its default route
// (fused_shading=False) to XLA. In the port the same stage was the chain
// that render/tall_gbuffer.py::tall_gbuffer_reference keeps as the plain
// version: per layer, K2 (resolve.cu) over every tile into an (A, NT, th,
// tw) channel image (398 MB at 1080p with A = 48), then
// raster_pallas._gbuffer_from_channels and _shading_planes (some seventy
// elementwise passes and stacks over every pixel). This kernel fuses K2
// over every tile with that chain. The shading kernel after it
// (deferred_shade.cu) reads the planes only where a layer is covered, 3.7%
// of the opaque layer's pixels and 0.12% of the transparent layer's on the
// benchmark's default cell, so nearly all of the chain's work built
// values that nothing read.
//
// For a covered pixel (winner >= 0) the kernel reads its winner's
// candidate row rows[tile, slot, :] in place (K3 and custom_gbuffer.cu
// read it the same way), and only the channels the chain reads: 0-5 and
// 10-27 for the interpolation (gbuffer_interp.cuh: barycentrics, world
// position, unit normal, uv), 28-31 the material and albedo, 32-34 the
// emissive, alpha and specular (or the packed spec/Ns, which it unpacks as
// bank.unpack_spec_shin does). Every other pixel gets what the chain gives
// it there: position, normal, albedo and uv 0, MATERIAL_BACKGROUND,
// emissive 0, alpha 1, specular 1, the default shininess. So every plane
// holds the chain's values on every pixel, and the shading systems'
// planes (gbuffer_planes), a shadow_factor callback's plain shading and
// render_gbuffers_pallas read what they read before.
//
// One block a tile (th x tw pixels, 8 x 128 on the main path), one thread
// a pixel, blockIdx.y the layer: one launch for both layers. A block takes
// __syncthreads_or of its pixels' coverage, so a tile with nothing covered
// reads no candidate row at all. The three-float planes and the uv, most
// of the bytes written, go through shared memory and out as whole 16-byte
// stores; the one-value planes are coalesced 4-byte stores.
//
// What bounds it on an H100: memory. At 1080p each of the 2 x 2,073,600
// pixels reads its winner id (4 B) and writes 60 B of planes (64 with a
// shininess plane); a covered pixel reads its slot and depth (8 B) and,
// once per distinct row, the 31 channels of its row that it needs. About
// 0.27 GB, 0.08 ms at 3.35 TB/s (kernel_bounds.tall_gbuffer_work), against
// the chain's 2 x 398 MB of K2 output alone.
//
// Rounding: the interpolation is gbuffer_interp.cuh's, which
// custom_gbuffer.cu shares; built with -fmad=false (kernels.py), every
// product and sum rounds on its own, as the chain's separate PyTorch
// operations do on the card; the spec/Ns unpacking's multiplications are
// by powers of two.

#include "gbuffer_interp.cuh"

namespace rek {

// The launch's arguments (render/tall_gbuffer.py's TallArgs mirrors it
// field for field).
struct TallArgs {
  // each layer's (nt, th, tw) planes: 0 opaque, 1 transparent
  const int* slot[2];     // winner slot among the tile's candidate rows
  const int* winner[2];   // winner triangle, -1 where empty
  const float* depth[2];  // NDC depth
  const float* rows;      // (nt, k, a) candidate attribute rows
  const float* inv_pv;    // (4, 4) inv(proj_view) at strides (ipv_s0, ipv_s1)
  // outputs, each layer's (nt * th, tw[, 3 or 2]) planes
  float* pos[2];
  float* nrm[2];
  float* alb[2];
  int* mat[2];
  float* uv[2];
  float* emis[2];
  float* alpha[2];
  float* spec[2];
  float* shin[2];  // with packed (spec, Ns) rows, else null
  int nt, th, tw, tiles_x, k, a, width, height, ipv_s0, ipv_s1, spec_packed;
  float shin_default;   // bank.DEFAULT_SHININESS
};

namespace {

constexpr int kMaxTile = 1024;           // pixels of a tile, one a thread
constexpr int kMaterialBackground = -1;  // gbuffer.MATERIAL_BACKGROUND
constexpr int kChannels = 35;            // channels 0-34 are read

__global__ void __launch_bounds__(kMaxTile) tall_gbuffer_kernel(TallArgs A) {
  // the tile's position, normal and albedo planes and its uv plane, staged
  // for whole-line stores
  __shared__ __align__(16) float stage3[3][3 * kMaxTile];
  __shared__ __align__(16) float stage2[2 * kMaxTile];
  const int layer = blockIdx.y;
  const int t = blockIdx.x;
  const int lx = threadIdx.x % A.tw, ly = threadIdx.x / A.tw;
  const size_t p = static_cast<size_t>(t) * A.th * A.tw + threadIdx.x;
  const bool covered = A.winner[layer][p] >= 0;
  V3 pos = {0.0f, 0.0f, 0.0f}, nrm = pos, alb = pos;
  float u = 0.0f, v = 0.0f, emis = 0.0f, alpha = 1.0f, spec = 1.0f,
        shin = A.shin_default;
  int mat = kMaterialBackground;
  if (__syncthreads_or(covered) && covered) {
    const int s = A.slot[layer][p];
    const bool hit = s >= 0 && s < A.k;  // K2 reads 0 for any other slot
    const float* row =
        A.rows + (static_cast<size_t>(t) * A.k + (hit ? s : 0)) * A.a;
    auto ch = [&](int c) { return hit ? __ldg(row + c) : 0.0f; };
    const PixelInterp g = interpolate(
        ch, tall_center((t % A.tiles_x) * A.tw, lx),
        tall_center((t / A.tiles_x) * A.th, ly), 0.0f, A.depth[layer][p],
        A.inv_pv, A.ipv_s0, A.ipv_s1, A.width, A.height);
    pos = g.pos, nrm = g.nrm, u = g.u, v = g.v;
    mat = static_cast<int>(ch(28));
    alb = {ch(29), ch(30), ch(31)};
    emis = ch(32), alpha = ch(33);
    const float sp = ch(34);
    if (A.spec_packed) {  // bank.unpack_spec_shin
      const float hq = floorf(sp * (1.0f / 4096.0f));
      spec = (sp - hq * 4096.0f) * (1.0f / 1024.0f);
      shin = hq;
    } else {
      spec = sp;
    }
  }
  A.mat[layer][p] = mat;
  A.emis[layer][p] = emis;
  A.alpha[layer][p] = alpha;
  A.spec[layer][p] = spec;
  if (A.spec_packed) A.shin[layer][p] = shin;
  const V3 v3[3] = {pos, nrm, alb};
  for (int q = 0; q < 3; ++q) {
    float* st = stage3[q] + 3 * threadIdx.x;
    st[0] = v3[q].x, st[1] = v3[q].y, st[2] = v3[q].z;
  }
  stage2[2 * threadIdx.x] = u;
  stage2[2 * threadIdx.x + 1] = v;
  __syncthreads();
  // a tile's pixels are consecutive in each plane: 3 (2) * npx floats a
  // plane, as float4 where the tile's start is 16-byte aligned (npx % 4 ==
  // 0)
  const int npx = A.th * A.tw;
  float* const planes[4] = {A.pos[layer], A.nrm[layer], A.alb[layer],
                            A.uv[layer]};
  for (int q = 0; q < 4; ++q) {
    const int nf = q < 3 ? 3 : 2;  // floats a pixel
    const float* src = q < 3 ? stage3[q] : stage2;
    float* dst = planes[q] + static_cast<size_t>(t) * npx * nf;
    if (npx % 4 == 0) {
      for (int j = threadIdx.x; j < nf * npx / 4; j += npx) {
        reinterpret_cast<float4*>(dst)[j] =
            reinterpret_cast<const float4*>(src)[j];
      }
    } else {
      for (int j = threadIdx.x; j < nf * npx; j += npx) dst[j] = src[j];
    }
  }
}

}  // namespace
}  // namespace rek

// See TallArgs for the layouts. Returns cudaGetLastError().
extern "C" int launch_tall_gbuffer(const rek::TallArgs* args,
                                   cudaStream_t stream) {
  const rek::TallArgs& A = *args;
  const int npx = A.th * A.tw;
  if (npx < 1 || npx > rek::kMaxTile || A.tiles_x < 1 || A.k < 1 ||
      A.a < rek::kChannels || (A.spec_packed && A.shin[0] == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (A.nt == 0) return cudaSuccess;
  rek::tall_gbuffer_kernel<<<dim3(A.nt, 2), npx, 0, stream>>>(A);
  return cudaGetLastError();
}
