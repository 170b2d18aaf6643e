// The custom-shading hook's G-buffer on the fused route: both layers, in
// place, and only on the pixels a shading system owns.
//
// Replaces no Pallas kernel: the JAX package forms this G-buffer in XLA
// (render_engine_tpu/render/frame.py::_fused_custom_shading: K2 over every
// tile, then the G-buffer from its channels). In the port the same stage
// was the chain that render/custom_gbuffer.py::custom_gbuffer_reference
// keeps as the plain version: per layer, K2 (resolve.cu) over every tile
// into an (A, NT, th, tw) channel image, raster_pallas.
// _gbuffer_from_channels (some forty elementwise passes and stacks over
// every pixel), the material's albedo and normal maps
// (textures.sample_atlas, geometry.perturb_normal) and the pixels' systems
// tri_sys[winner]. The shading functions' output is kept only where
// shade_systems_color finds a pixel of their system, 1.8% of the pixels on
// the custom benchmark cell, so nearly all of that work was thrown away.
//
// A pixel is owned when a triangle won it (winner >= 0), it lies inside the
// band's image (column < width, band-local row < rows_in), and the
// winner's render system has a shading function (sys_shaded). For an owned
// pixel the kernel reads its winner's candidate row rows[tile, slot, :] in
// place (K3 reads it the same way) and computes what the chain computes:
// the perspective-correct barycentrics (channels 0-5 and 25-27), the world
// position unprojected through inv(proj_view) at the global row (band-local
// row + y_off), the unit normal (10-18), the uv (19-24), the material (28)
// and albedo (29-31), and, where the layer is textured, the material's
// albedo map and, with normal maps, its normal map in the winner's tangent
// frame (55-58). Every other pixel gets fixed values: position, normal and
// albedo 0, material MATERIAL_BACKGROUND. The function still runs over the
// full planes, and torch.where discards its output there, so the image is
// the one the chain gave. Every pixel gets its system, tri_sys[winner]
// (clamped), as the chain's px_sys plane has it.
//
// One block a tile (th x tw pixels, 8 x 128 on the main path), one thread
// a pixel, blockIdx.y the layer: one launch for both layers. A block takes
// __syncthreads_or of its pixels' ownership, so a tile with no owned pixel
// (63% of the custom cell's tiles) skips the branch as a whole and reads no
// candidate row and no texel. The three-float planes, most of the bytes
// written, go through shared memory and out as whole 16-byte stores: a
// pixel's own 12 bytes would be three 4-byte stores 12 bytes apart.
//
// What bounds it on an H100: memory. At 1080p each of the 2 x 2,073,600
// pixels reads its winner id (4 B) and writes its planes (position, normal
// and albedo 36 B, material and system 8 B); an owned pixel reads its slot
// and depth (8 B), the 32 channels of its row that it needs (once per
// distinct row) and its atlas texels (12 B each, in L2). About 0.2 GB, 0.06
// ms at 3.35 TB/s (kernel_bounds.custom_gbuffer_work), against the chain's
// 2 x 531 MB of K2 output alone.
//
// Rounding: the interpolation (barycentrics, unprojection, normal, uv) is
// gbuffer_interp.cuh's, which the default route's tall_gbuffer.cu shares;
// built with -fmad=false (kernels.py), every product and sum rounds on its
// own, as the chain's separate PyTorch operations do on the card.

#include "gbuffer_interp.cuh"

namespace rek {

// The launch's arguments (render/custom_gbuffer.py's CustomArgs mirrors it
// field for field).
struct CustomArgs {
  // each layer's (nt, th, tw) planes: 0 opaque, 1 transparent
  const int* slot[2];     // winner slot among the tile's candidate rows
  const int* winner[2];   // winner triangle, -1 where empty
  const float* depth[2];  // NDC depth
  const float* rows;      // (nt, k, a) candidate attribute rows
  const int* tri_sys;     // (n_tri,) each triangle's render system, -1 none
  const int* sys_shaded;  // (n_sys,) 1 where a system has a shading function
  const float* inv_pv;    // (4, 4) inv(proj_view) at strides (ipv_s0, ipv_s1)
  // the materials' texture ids (n_mat, 6) and the atlas, or null
  const int* mat_textures;
  const int* tex_layer;   // (n_tex,)
  const float* uv_rect;   // (n_tex, 4)
  const float* layers;    // (n_layers, atlas_size, atlas_size, 3)
  // outputs, each layer's (nt * th, tw[, 3]) planes
  float* pos[2];
  float* nrm[2];
  float* alb[2];
  int* mat[2];
  int* px_sys[2];
  int nt, th, tw, tiles_x, k, a, width, h_total, rows_in, n_tri, n_sys,
      n_mat, n_tex, atlas_size, ipv_s0, ipv_s1, with_norm;
  int textured[2];  // 1 where the layer takes the atlas
  float y_off;      // the band's first image row
};

namespace {

constexpr int kMaxTile = 1024;            // pixels of a tile, one a thread
constexpr int kMaterialBackground = -1;   // gbuffer.MATERIAL_BACKGROUND

// The owned pixel at tile-local (lx, ly) of tile t: its G-buffer values
__device__ void owned_pixel(const CustomArgs& A, int layer, int t, size_t p,
                            int lx, int ly, V3* pos, V3* nrm, V3* alb,
                            int* mat) {
  const int s = A.slot[layer][p];
  const float d = A.depth[layer][p];
  const bool hit = s >= 0 && s < A.k;  // K2 reads 0 for any other slot
  const float* row =
      A.rows + (static_cast<size_t>(t) * A.k + (hit ? s : 0)) * A.a;
  auto ch = [&](int c) { return hit ? __ldg(row + c) : 0.0f; };

  const PixelInterp g = interpolate(
      ch, tall_center((t % A.tiles_x) * A.tw, lx),
      tall_center((t / A.tiles_x) * A.th, ly), A.y_off, d, A.inv_pv, A.ipv_s0,
      A.ipv_s1, A.width, A.h_total);
  V3 n = g.nrm;
  const float u = g.u, v = g.v;
  *mat = static_cast<int>(ch(28));
  V3 albedo = {ch(29), ch(30), ch(31)};

  if (A.textured[layer]) {
    const AtlasView at = {A.layers, A.tex_layer, A.uv_rect, A.n_tex,
                          A.atlas_size};
    const int* tx = A.mat_textures + 6 * min(max(*mat, 0), A.n_mat - 1);
    if (A.with_norm && tx[3] >= 0) {
      n = perturb_normal(n, {ch(55), ch(56), ch(57)}, ch(58),
                         sample_texture(at, tx[3], u, v));
    }
    if (tx[0] >= 0) albedo = sample_texture(at, tx[0], u, v);
  }
  *pos = g.pos;
  *nrm = n;
  *alb = albedo;
}

__global__ void __launch_bounds__(kMaxTile)
    custom_gbuffer_kernel(CustomArgs A) {
  // the tile's position, normal and albedo planes, staged for whole-line
  // stores
  __shared__ __align__(16) float stage[3][3 * kMaxTile];
  const int layer = blockIdx.y;
  const int t = blockIdx.x;
  const int lx = threadIdx.x % A.tw, ly = threadIdx.x / A.tw;
  const size_t p = static_cast<size_t>(t) * A.th * A.tw + threadIdx.x;
  const int wn = A.winner[layer][p];
  const int sys = A.tri_sys[min(max(wn, 0), A.n_tri - 1)];
  const bool inside = (t % A.tiles_x) * A.tw + lx < A.width &&
                      (t / A.tiles_x) * A.th + ly < A.rows_in;
  const bool owned = wn >= 0 && inside && sys >= 0 && sys < A.n_sys &&
                     A.sys_shaded[sys] != 0;
  V3 pos = {0.0f, 0.0f, 0.0f}, nrm = pos, alb = pos;
  int mat = kMaterialBackground;
  if (__syncthreads_or(owned) && owned) {
    owned_pixel(A, layer, t, p, lx, ly, &pos, &nrm, &alb, &mat);
  }
  A.mat[layer][p] = mat;
  A.px_sys[layer][p] = sys;
  const V3 v[3] = {pos, nrm, alb};
  for (int q = 0; q < 3; ++q) {
    float* st = stage[q] + 3 * threadIdx.x;
    st[0] = v[q].x, st[1] = v[q].y, st[2] = v[q].z;
  }
  __syncthreads();
  // a tile's pixels are consecutive in each plane: 3 * npx floats a plane,
  // as float4 where the tile's start is 16-byte aligned (npx % 4 == 0)
  const int npx = A.th * A.tw;
  const size_t base = static_cast<size_t>(t) * npx * 3;
  float* const planes[3] = {A.pos[layer], A.nrm[layer], A.alb[layer]};
  for (int q = 0; q < 3; ++q) {
    if (npx % 4 == 0) {
      float4* dst = reinterpret_cast<float4*>(planes[q] + base);
      const float4* src = reinterpret_cast<const float4*>(stage[q]);
      for (int j = threadIdx.x; j < 3 * npx / 4; j += npx) dst[j] = src[j];
    } else {
      for (int j = threadIdx.x; j < 3 * npx; j += npx) {
        planes[q][base + j] = stage[q][j];
      }
    }
  }
}

}  // namespace
}  // namespace rek

// See CustomArgs for the layouts. Returns cudaGetLastError().
extern "C" int launch_custom_gbuffer(const rek::CustomArgs* args,
                                     cudaStream_t stream) {
  const rek::CustomArgs& A = *args;
  const int npx = A.th * A.tw;
  if (npx < 1 || npx > rek::kMaxTile || A.tiles_x < 1 || A.n_tri < 1 ||
      A.n_sys < 1 || A.k < 1 || A.a < (A.with_norm ? 59 : 32)) {
    return cudaErrorInvalidValue;
  }
  if (A.nt == 0) return cudaSuccess;
  rek::custom_gbuffer_kernel<<<dim3(A.nt, 2), npx, 0, stream>>>(A);
  return cudaGetLastError();
}
