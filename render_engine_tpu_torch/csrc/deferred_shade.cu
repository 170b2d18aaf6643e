// The default route's shading: the atlas, the shadow maps' PCF factor and
// Blinn-Phong of both layers, per pixel, in one launch.
//
// Replaces no Pallas kernel: the JAX package leaves its default route
// (RenderSettings(fused_shading=False)) to XLA. In the port the same stage
// was render/deferred_shade.py::deferred_shade_reference, the chain of
// PyTorch operations that render/frame.py::_render_frame_tiled ran after
// raster_pallas.gbuffers_tall: textures.sample_atlas per texture role and
// layer, geometry.perturb_normal, shadows.make_shadow_factor (every slot's
// PCF at every pcf_scale-th pixel, repeated in k x k blocks) and
// lighting.shade per layer, a few hundred passes over full-frame planes.
//
// One thread owns one pixel of the tall tile layout (rows x cols, both
// layers). It reads the G-buffer planes of its pixel once, and for each
// covered layer:
//   1. samples the atlas: the albedo, the spec / emissive / dissolve maps'
//      red channel as multipliers, and the normal map in the winner
//      triangle's tangent frame (geometry.triangle_tangents of the winner's
//      positions and uvs, computed where a normal map is sampled);
//   2. on the opaque layer, where a live light owns a shadow slot, computes
//      each such slot's 3x3 PCF factor at the world position of the pixel
//      (r - r % k, c - c % k) of the tall layout, k = pcf_scale: the block
//      anchors of the plain version's [::k, ::k] slicing;
//   3. runs lighting.shade's loop: the directional rows, the first four
//      point rows one by one (with a shadow factor), the other point rows
//      in chunks of 8 summed apart, the spot rows; dead rows (i >= count)
//      are skipped, since they add exactly 0;
//   4. applies the diffuse floor and the emissive bypass;
// and writes the eight packed planes that compose reads, [lit rgb | t_lit
// rgb | t_alpha | flags], as one 32-byte row (t_alpha 0 where the
// transparent layer is empty, unless every pixel is textured: the compose
// reads it only where that layer is in front). With gbuffer planes asked for
// (render systems that shade their own pixels) it also textures every
// pixel, covered or not, and writes the textured albedo and normal planes.
// The light rows go into shared memory once per block, with the values
// every pixel derives from them (unit directions, the spot cone's width,
// each row's liveness and the slots its light owns).
//
// What bounds it on an H100: memory. At 1080p each of the 2,073,600 pixels
// reads its two winner ids (8 B) and writes 32 B; a covered layer reads
// about 60 B more, and where the transparent layer is covered the two
// depths and its alpha (12 B) decide the flags and the blend; the atlas
// and the shadow maps (4 MB a slot) stay in the 50 MB L2. On the space
// scene, where 4% of the pixels are covered, that is about 88 MB, 0.026 ms
// at 3.35 TB/s (kernel_bounds.deferred_shade_work). What the design does about it:
// each thread issues its pixel's loads before the block's barrier, so a
// warp of mostly empty pixels streams whole lines; a block stages the light
// rows only where a pixel of it is covered, and the uncovered lanes of a
// warp idle through the light loop (about 60 operations per covered pixel,
// layer and live light); the tangent frame of a normal-mapped pixel is
// computed from its winner's positions and uvs in place, where a table made
// in PyTorch took some 20 small kernels; a pixel's slot factors sit in its
// thread's column of shared memory (registers spilled). Two pixels a
// thread measured slower than one.
//
// Rounding: built with -fmad=false, the kernel keeps the plain version's
// order of operations as PyTorch computes it on the card (read there from
// PyTorch's outputs): a sum over three channels, and so each dot product
// and vector norm, is (x0 + x2) + x1, as PyTorch's reduction splits it over
// two lanes; a chunk's sum over its lights and the product over the slots
// use four accumulators; a division by a Python number multiplies by its
// reciprocal; the light-clip product is cuBLAS's chain of fused
// multiply-adds; torch.remainder is fmod-based; the cross product's terms
// are fused as PyTorch's build fuses them. On the headline frame the
// kernel equals its plain version on the card to the bit; where an order
// still differs in the last bits, powf amplifies it and a PCF tap can flip
// at a shadow edge.

#include "common.cuh"

namespace rek {

// The launch's arguments (render/deferred_shade.py's DeferredArgs mirrors
// it field for field). Outside the anonymous namespace: the C launcher takes
// a pointer to it, and a type with internal linkage would hide the launcher.
struct DeferredArgs {
  // the planes of each layer (0 opaque, 1 transparent), (rows, cols[, c])
  const float* pos[2];    // (.., 3) world position, 0 where empty
  const float* nrm[2];    // (.., 3) unit normal
  const float* alb[2];    // (.., 3)
  const int* mat[2];      // material id, -1 where empty
  const int* tri[2];      // winner triangle, -1 where empty
  const float* depth[2];
  const float* uv[2];     // (.., 2)
  const float* emis[2];
  const float* spec[2];
  const float* shin[2];   // per-pixel exponent, or null (shin_const)
  const float* t_alpha;   // the transparent layer's alpha
  // lighting.LightArrays
  const float *dir_direction, *dir_diffuse, *dir_specular, *dir_ambient;
  const int *dir_count, *dir_entity;
  const float *pt_position, *pt_diffuse, *pt_specular, *pt_ambient,
      *pt_atten, *pt_radius;
  const int *pt_count, *pt_entity;
  const float *sp_position, *sp_direction, *sp_diffuse, *sp_specular,
      *sp_ambient, *sp_atten, *sp_cutoff;
  const int *sp_count, *sp_entity;
  const float* cam;  // (3,)
  // shadows.ShadowState, or null
  const float* maps;        // (n_slots, res, res)
  const float* light_mats;  // (n_slots, 4, 4)
  const int* slot_entity;   // (n_slots,)
  // the atlas, or null
  const int* mat_textures;  // (n_mat, 6) texture ids per role, -1 unset
  const int* tex_layer;     // (n_tex,)
  const float* uv_rect;     // (n_tex, 4)
  const float* layers;      // (n_layers, size, size, 3)
  // the triangles' world positions (n_tri, 3, 3) and uvs (n_tri, 3, 2) at
  // strides (pos_st, pos_sv, 1) and (uv_st, uv_sv, 1), or null without
  // normal maps
  const float* tri_pos;
  const float* tri_uv;
  // outputs
  float* out;         // (rows, cols, 8)
  float* alb_out[2];  // (rows, cols, 3) textured albedo, or null
  float* nrm_out[2];  // (rows, cols, 3) textured normal, or null
  int rows, cols, nd, np, ns, n_slots, res, pcf_k, n_mat, n_tex, atlas_size,
      n_tri, pos_st, pos_sv, uv_st, uv_sv, with_spec, with_emis, with_diss,
      with_norm;
  float shin_const;
};

namespace {

constexpr int kRow = 24;      // staged light row: see stage_light
constexpr int kMaxSlots = 8;  // shadow slots a kernel call can read
constexpr int kHead = 4;      // point rows lighting.shade shadows one by one
constexpr int kChunk = 8;     // its chunk of point rows
constexpr float kDiffuseFloor = 0.08f;  // lighting.DIFFUSE_FLOOR
constexpr float kPcfBias = 2e-3f;       // shadows.PCF_BIAS


struct V3 {
  float x, y, z;
};

// a sum over three channels as PyTorch reduces the last dimension of size
// 3: two lanes, the first holding elements 0 and 2
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return (a + c) + b;
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return sum3(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ float norm(V3 v) {
  return sqrtf(sum3(v.x * v.x, v.y * v.y, v.z * v.z));
}
// v / where(|v| > eps, |v|, 1)
__device__ __forceinline__ V3 unit(V3 v, float eps) {
  const float n = norm(v);
  const float d = n > eps ? n : 1.0f;
  return {v.x / d, v.y / d, v.z / d};
}
__device__ __forceinline__ V3 load3(const float* p, size_t i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
// torch.maximum: NaN in either argument gives NaN
__device__ __forceinline__ float maximum(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7fc00000);
  return a > b ? a : b;
}
// torch.remainder(x, 1.0) on the card
__device__ __forceinline__ float rem1(float x) {
  float m = fmodf(x, 1.0f);
  if (m != 0.0f && m < 0.0f) m += 1.0f;
  return m;
}
// torch.pow(x, e) for a Python number e, with PyTorch's special cases
__device__ __forceinline__ float pow_scalar(float x, float e) {
  if (e == 0.0f) return 1.0f;
  if (e == 1.0f) return x;
  if (e == 0.5f) return sqrtf(x);
  if (e == 2.0f) return x * x;
  if (e == 3.0f) return (x * x) * x;
  return powf(x, e);
}

// A staged light row (shared memory, kRow floats):
//   0:3 position (point, spot) | 3:6 the unit light direction of a
//   directional row, unit(-direction), or the negated unit cone axis of a
//   spot row, -unit(direction) | 6:9 diffuse | 9:12 specular | 12:15
//   ambient | 15:17 attenuation (linear, quadratic) | 17 radius (point) |
//   18 cos outer (spot) | 19 the cone's width, max(inner - outer, 1e-6)
//   (spot) | 20 live (i < count)
// and in `own` the bit mask of the shadow slots its light owns.
__device__ void stage_light(const DeferredArgs& A, int r, float* L,
                            int* own) {
  for (int c = 0; c < kRow; ++c) L[c] = 0.0f;
  int i, entity, count;
  const float *dif, *spe, *amb;
  if (r < A.nd) {
    i = r, entity = A.dir_entity[i], count = A.dir_count[0];
    dif = A.dir_diffuse, spe = A.dir_specular, amb = A.dir_ambient;
    const V3 d = load3(A.dir_direction, i);
    const V3 l = unit({-d.x, -d.y, -d.z}, 1e-9f);
    L[3] = l.x, L[4] = l.y, L[5] = l.z;
  } else if (r < A.nd + A.np) {
    i = r - A.nd, entity = A.pt_entity[i], count = A.pt_count[0];
    dif = A.pt_diffuse, spe = A.pt_specular, amb = A.pt_ambient;
    for (int c = 0; c < 3; ++c) L[c] = A.pt_position[3 * i + c];
    L[15] = A.pt_atten[2 * i], L[16] = A.pt_atten[2 * i + 1];
    L[17] = A.pt_radius[i];
  } else {
    i = r - A.nd - A.np, entity = A.sp_entity[i];
    count = A.sp_count[0];
    dif = A.sp_diffuse, spe = A.sp_specular, amb = A.sp_ambient;
    for (int c = 0; c < 3; ++c) L[c] = A.sp_position[3 * i + c];
    const V3 s = unit(load3(A.sp_direction, i), 1e-9f);
    L[3] = -s.x, L[4] = -s.y, L[5] = -s.z;
    L[15] = A.sp_atten[2 * i], L[16] = A.sp_atten[2 * i + 1];
    const float inner = A.sp_cutoff[2 * i], outer = A.sp_cutoff[2 * i + 1];
    L[18] = outer;
    L[19] = max_nan(inner - outer, 1e-6f);
  }
  for (int c = 0; c < 3; ++c) {
    L[6 + c] = dif[3 * i + c];
    L[9 + c] = spe[3 * i + c];
    L[12 + c] = amb[3 * i + c];
  }
  L[20] = i < count ? 1.0f : 0.0f;
  int mask = 0;
  for (int q = 0; q < A.n_slots; ++q) {
    if (entity >= 0 && A.slot_entity[q] == entity) mask |= 1 << q;
  }
  *own = mask;
}

// One row of the light-clip product einsum("ij,...j->...i", mat, [x y z 1])
// as cuBLAS accumulates it
__device__ __forceinline__ float clip_row(const float* m, float x, float y,
                                          float z) {
  return __fmaf_rn(m[3], 1.0f,
                   __fmaf_rn(m[2], z, __fmaf_rn(m[1], y, m[0] * x)));
}

// shadows.pcf_factor of slot q at world position w
__device__ float pcf(const DeferredArgs& A, int q, V3 w) {
  const float* m = A.light_mats + 16 * q;
  const float cx = clip_row(m, w.x, w.y, w.z);
  const float cy = clip_row(m + 4, w.x, w.y, w.z);
  const float cz = clip_row(m + 8, w.x, w.y, w.z);
  const float cw = clip_row(m + 12, w.x, w.y, w.z);
  const float dw = fabsf(cw) > 1e-9f ? cw : 1.0f;
  const float nx = cx / dw, ny = cy / dw, z = cz / dw;
  const bool inside =
      fabsf(nx) <= 1.0f && fabsf(ny) <= 1.0f && z <= 1.0f && cw > 0.0f;
  const int res = A.res;
  const float rf = static_cast<float>(res);
  const float u = ((nx * 0.5f) + 0.5f) * rf - 0.5f;
  const float v = (0.5f - ny * 0.5f) * rf - 0.5f;
  const int ui = static_cast<int>(clamp_nan(rintf(u), -1.0f, rf));
  const int vi = static_cast<int>(clamp_nan(rintf(v), -1.0f, rf));
  const int uc = min(max(ui, 0), res - 1), vc = min(max(vi, 0), res - 1);
  const float* map = A.maps + static_cast<size_t>(q) * res * res;
  const float zb = z - kPcfBias;
  float lit = 0.0f;
  for (int dy = -1; dy <= 1; ++dy) {
    const int ty = min(max(vc + dy, 0), res - 1);
    for (int dx = -1; dx <= 1; ++dx) {
      const int tx = min(max(uc + dx, 0), res - 1);
      lit += zb <= __ldg(map + static_cast<size_t>(ty) * res + tx) ? 1.0f
                                                                    : 0.0f;
    }
  }
  // a division by the Python number 9.0: PyTorch multiplies by 1 / 9
  return inside ? lit * (1.0f / 9.0f) : 1.0f;
}

// textures.sample_atlas of texture id `tex` at model-space (u, v)
__device__ V3 sample_atlas(const DeferredArgs& A, int tex, float uu,
                           float vv) {
  const int t = min(max(tex, 0), A.n_tex - 1);
  const int s = A.atlas_size;
  const float sf = static_cast<float>(s) - 1.0f;
  const int lay = A.tex_layer[t];
  const float* rect = A.uv_rect + 4 * t;
  const float u = rect[2] + rem1(uu) * rect[0];
  const float v = rect[3] + (1.0f - rem1(vv)) * rect[1];
  const int u0 = static_cast<int>(clamp_nan(floorf(u), 0.0f, sf));
  const int v0 = static_cast<int>(clamp_nan(floorf(v), 0.0f, sf));
  const int u1 = min(u0 + 1, s - 1), v1 = min(v0 + 1, s - 1);
  const float fu = u - static_cast<float>(u0);
  const float fv = v - static_cast<float>(v0);
  const float* base = A.layers + static_cast<size_t>(lay) * s * s * 3;
  const float* c00 = base + (static_cast<size_t>(v0) * s + u0) * 3;
  const float* c01 = base + (static_cast<size_t>(v0) * s + u1) * 3;
  const float* c10 = base + (static_cast<size_t>(v1) * s + u0) * 3;
  const float* c11 = base + (static_cast<size_t>(v1) * s + u1) * 3;
  float o[3];
  for (int c = 0; c < 3; ++c) {
    o[c] = (((__ldg(c00 + c) * (1.0f - fu)) * (1.0f - fv) +
             (__ldg(c01 + c) * fu) * (1.0f - fv)) +
            (__ldg(c10 + c) * (1.0f - fu)) * fv) +
           (__ldg(c11 + c) * fu) * fv;
  }
  return {o[0], o[1], o[2]};
}

// torch.linalg.cross on the card: PyTorch's build contracts each
// component a_i b_j - a_j b_i into fma(a_i, b_j, -(a_j b_i))
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {__fmaf_rn(a.y, b.z, -(a.z * b.y)), __fmaf_rn(a.z, b.x, -(a.x * b.z)),
          __fmaf_rn(a.x, b.y, -(a.y * b.x))};
}

// geometry.triangle_tangents of triangle t: its tangent and handedness
__device__ void triangle_tangent(const DeferredArgs& A, int t, V3* tan,
                                 float* handed) {
  const float* p = A.tri_pos + static_cast<size_t>(t) * A.pos_st;
  const float* w = A.tri_uv + static_cast<size_t>(t) * A.uv_st;
  const V3 p0 = {p[0], p[1], p[2]};
  const V3 p1 = {p[A.pos_sv], p[A.pos_sv + 1], p[A.pos_sv + 2]};
  const V3 p2 = {p[2 * A.pos_sv], p[2 * A.pos_sv + 1], p[2 * A.pos_sv + 2]};
  const V3 e1 = {p1.x - p0.x, p1.y - p0.y, p1.z - p0.z};
  const V3 e2 = {p2.x - p0.x, p2.y - p0.y, p2.z - p0.z};
  const float du1 = w[A.uv_sv] - w[0], dv1 = w[A.uv_sv + 1] - w[1];
  const float du2 = w[2 * A.uv_sv] - w[0], dv2 = w[2 * A.uv_sv + 1] - w[1];
  const float det = du1 * dv2 - du2 * dv1;
  const float r = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;
  *tan = {(e1.x * dv2 - e2.x * dv1) * r, (e1.y * dv2 - e2.y * dv1) * r,
          (e1.z * dv2 - e2.z * dv1) * r};
  const V3 bit = {(e2.x * du1 - e1.x * du2) * r, (e2.y * du1 - e1.y * du2) * r,
                  (e2.z * du1 - e1.z * du2) * r};
  *handed = dot(cross(cross(e1, e2), *tan), bit) < 0.0f ? -1.0f : 1.0f;
}

// geometry.perturb_normal
__device__ V3 perturb_normal(V3 n, V3 tan, float handed, V3 smp) {
  const float nt = dot(n, tan);
  V3 t = {tan.x - n.x * nt, tan.y - n.y * nt, tan.z - n.z * nt};
  const float tl = norm(t);
  if (!(tl > 1e-8f)) return n;
  t = {t.x / tl, t.y / tl, t.z / tl};
  V3 b = cross(n, t);
  b = {b.x * handed, b.y * handed, b.z * handed};
  const float m0 = smp.x * 2.0f - 1.0f, m1 = smp.y * 2.0f - 1.0f;
  const float m2 = smp.z * 2.0f - 1.0f;
  const V3 p = {(m0 * t.x + m1 * b.x) + m2 * n.x,
                (m0 * t.y + m1 * b.y) + m2 * n.y,
                (m0 * t.z + m1 * b.z) + m2 * n.z};
  return unit(p, 1e-12f);
}

// What one layer of one pixel shades from
struct Px {
  V3 pos, n, alb, view;
  float spec_k, shin, emis;
};

// lighting._blinn_phong for light direction l
__device__ __forceinline__ V3 blinn_phong(const Px& P, V3 l, const float* L,
                                          bool per_pixel_shin,
                                          float shin_const) {
  const float ndl = max_nan(dot(P.n, l), 0.0f);
  const V3 h = unit({l.x + P.view.x, l.y + P.view.y, l.z + P.view.z}, 1e-9f);
  const float ndh = max_nan(dot(P.n, h), 0.0f);
  float pw = 0.0f;
  if (ndl > 0.0f) {
    pw = per_pixel_shin ? powf(ndh, P.shin) : pow_scalar(ndh, shin_const);
  }
  const float spec = pw * P.spec_k;
  return {(L[12] * P.alb.x + (L[6] * ndl) * P.alb.x) + L[9] * spec,
          (L[13] * P.alb.y + (L[7] * ndl) * P.alb.y) + L[10] * spec,
          (L[14] * P.alb.z + (L[8] * ndl) * P.alb.z) + L[11] * spec};
}

// a point or spot row: the unit direction to the light, its distance and
// attenuation 1 / (1 + l d + q d^2)
__device__ __forceinline__ V3 to_light(const Px& P, const float* L, float* d,
                                       float* atten) {
  const V3 lv = {L[0] - P.pos.x, L[1] - P.pos.y, L[2] - P.pos.z};
  *d = norm(lv);
  const float dd = *d > 1e-9f ? *d : 1.0f;
  *atten = 1.0f / ((1.0f + L[15] * *d) + (L[16] * *d) * *d);
  return {lv.x / dd, lv.y / dd, lv.z / dd};
}

__device__ __forceinline__ V3 scale(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}

// The product of the factors of the slots in `mask` (1 for the others),
// as PyTorch's prod over the slot axis takes it: four accumulators, a_i =
// g_i * g_{i+4}, then ((a_0 * a_1) * a_2) * a_3
__device__ __forceinline__ float slot_product(const float* f, int mask) {
  float a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float g0 = ((mask >> i) & 1) ? f[i * kThreads] : 1.0f;
    const float g1 = ((mask >> (i + 4)) & 1) ? f[(i + 4) * kThreads] : 1.0f;
    a[i] = g0 * g1;
  }
  return ((a[0] * a[1]) * a[2]) * a[3];
}

// point row j without a shadow factor: (c * atten), 0 for a dead row
__device__ __forceinline__ V3 point_term(const Px& P, const float* sl, int j,
                                         bool pps, float shin_const) {
  const float* L = sl + j * kRow;
  if (L[20] == 0.0f) return {0.0f, 0.0f, 0.0f};
  float d, atten;
  const V3 l = to_light(P, L, &d, &atten);
  if (L[17] > 0.0f && d > L[17]) atten = 0.0f;
  return scale(blinn_phong(P, l, L, pps, shin_const), atten);
}

// lighting.shade's color of one covered pixel: `f` holds its slot factors
// (with_sf: the opaque layer with shadow maps)
__device__ V3 shade(const DeferredArgs& A, const float* sl, const int* own,
                    const Px& P, bool with_sf, const float* f) {
  const bool pps = A.shin[0] != nullptr;
  const float sc = A.shin_const;
  V3 color = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < A.nd; ++i) {
    const float* L = sl + i * kRow;
    if (L[20] == 0.0f) continue;
    V3 c = blinn_phong(P, {L[3], L[4], L[5]}, L, pps, sc);
    if (with_sf && own[i]) c = scale(c, slot_product(f, own[i]));
    color = add(color, c);
  }
  const int n_head = with_sf ? min(kHead, A.np) : 0;
  for (int i = 0; i < n_head; ++i) {
    const int r = A.nd + i;
    const float* L = sl + r * kRow;
    if (L[20] == 0.0f) continue;
    float d, atten;
    const V3 l = to_light(P, L, &d, &atten);
    if (L[17] > 0.0f && d > L[17]) atten = 0.0f;
    V3 c = scale(blinn_phong(P, l, L, pps, sc), atten);
    if (own[r]) c = scale(c, slot_product(f, own[r]));
    color = add(color, c);
  }
  // the chunks: PyTorch sums a chunk's (up to 8) rows with four
  // accumulators, a_i = x_i + x_{i+4}, then ((a_0 + a_1) + a_2) + a_3
  V3 cp = {0.0f, 0.0f, 0.0f};
  for (int lo = n_head; lo < A.np; lo += kChunk) {
    const int hi = min(lo + kChunk, A.np);
    V3 part = {0.0f, 0.0f, 0.0f};
    for (int i = 0; i < 4 && lo + i < hi; ++i) {
      V3 a = point_term(P, sl, A.nd + lo + i, pps, sc);
      if (lo + i + 4 < hi) {
        a = add(a, point_term(P, sl, A.nd + lo + i + 4, pps, sc));
      }
      part = i == 0 ? a : add(part, a);
    }
    cp = lo == n_head ? part : add(cp, part);
  }
  color = add(color, cp);
  for (int i = 0; i < A.ns; ++i) {
    const int r = A.nd + A.np + i;
    const float* L = sl + r * kRow;
    if (L[20] == 0.0f) continue;
    float d, atten;
    const V3 l = to_light(P, L, &d, &atten);
    const float cos_t = dot(l, {L[3], L[4], L[5]});
    const float intensity = clamp_nan((cos_t - L[18]) / L[19], 0.0f, 1.0f);
    V3 c = scale(scale(blinn_phong(P, l, L, pps, sc), intensity), atten);
    if (with_sf && own[r]) c = scale(c, slot_product(f, own[r]));
    color = add(color, c);
  }
  color = {maximum(color.x, kDiffuseFloor * P.alb.x),
           maximum(color.y, kDiffuseFloor * P.alb.y),
           maximum(color.z, kDiffuseFloor * P.alb.z)};
  if (P.emis > 0.0f) color = scale(P.alb, P.emis);
  return color;
}

// The planes of layer `layer` at pixel p, the atlas applied (`textured`):
// fills P (its view vector too) and, on the transparent layer, the alpha
template <int layer>
__device__ void layer_inputs(const DeferredArgs& A, size_t p, bool textured,
                             Px* P, float* alpha) {
  P->pos = load3(A.pos[layer], p);
  P->n = load3(A.nrm[layer], p);
  P->alb = load3(A.alb[layer], p);
  P->spec_k = A.spec[layer][p];
  P->emis = A.emis[layer][p];
  P->shin = A.shin[layer] != nullptr ? A.shin[layer][p] : A.shin_const;
  if (layer == 1) *alpha = A.t_alpha[p];
  if (textured) {
    const int m = min(max(A.mat[layer][p], 0), A.n_mat - 1);
    const int* tx = A.mat_textures + 6 * m;
    const float u = A.uv[layer][2 * p], v = A.uv[layer][2 * p + 1];
    if (A.with_spec && tx[1] >= 0) {
      P->spec_k = P->spec_k * sample_atlas(A, tx[1], u, v).x;
    }
    if (A.with_emis && tx[2] >= 0) {
      P->emis = P->emis * sample_atlas(A, tx[2], u, v).x;
    }
    if (layer == 1 && A.with_diss && tx[4] >= 0) {
      *alpha = *alpha * sample_atlas(A, tx[4], u, v).x;
    }
    if (A.with_norm && tx[3] >= 0) {
      V3 tan;
      float handed;
      triangle_tangent(A, min(max(A.tri[layer][p], 0), A.n_tri - 1), &tan,
                       &handed);
      P->n = perturb_normal(P->n, tan, handed, sample_atlas(A, tx[3], u, v));
    }
    if (tx[0] >= 0) P->alb = sample_atlas(A, tx[0], u, v);
  }
  const V3 cam = {A.cam[0], A.cam[1], A.cam[2]};
  P->view = unit({cam.x - P->pos.x, cam.y - P->pos.y, cam.z - P->pos.z},
                 1e-9f);
}

// One pixel p of the tall layout, both layers: the packed row, and the
// textured G-buffer planes where asked for. `need` holds the shadow slots
// that a live shadowed row owns.
__device__ __forceinline__ void shade_pixel(const DeferredArgs& A,
                                            const float* sl, const int* own,
                                            float* f, int need, size_t p,
                                            int tri_o, int tri_t, float d_o,
                                            float d_t) {
  const bool cov_o = tri_o >= 0, cov_t = tri_t >= 0;
  const bool planes = A.alb_out[0] != nullptr;
  const bool atlas = A.mat_textures != nullptr;
  float o[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                (cov_o ? 1.0f : 0.0f) +
                    2.0f * (cov_t && d_t <= d_o ? 1.0f : 0.0f)};

  // --- the opaque layer ---
  if (cov_o || planes) {
    Px P;
    float unused;
    layer_inputs<0>(A, p, atlas, &P, &unused);
    if (planes) {
      for (int c = 0; c < 3; ++c) {
        A.alb_out[0][3 * p + c] = (&P.alb.x)[c];
        A.nrm_out[0][3 * p + c] = (&P.n.x)[c];
      }
    }
    if (cov_o) {
      const bool with_sf = A.maps != nullptr;
      if (with_sf) {
        const int k = A.pcf_k;
        const size_t r0 = p / A.cols, c0 = p % A.cols;
        const size_t anchor = (r0 - r0 % k) * A.cols + (c0 - c0 % k);
        const V3 w = load3(A.pos[0], anchor);
#pragma unroll 1
        for (int q = 0; q < A.n_slots; ++q) {
          if ((need >> q) & 1) f[q * kThreads] = pcf(A, q, w);
        }
      }
      const V3 c = shade(A, sl, own, P, with_sf, f);
      o[0] = c.x, o[1] = c.y, o[2] = c.z;
    }
  }
  // --- the transparent layer, without shadow factors ---
  if (cov_t || planes) {
    Px P;
    float alpha;
    layer_inputs<1>(A, p, atlas, &P, &alpha);
    o[6] = alpha;
    if (planes) {
      for (int c = 0; c < 3; ++c) {
        A.alb_out[1][3 * p + c] = (&P.alb.x)[c];
        A.nrm_out[1][3 * p + c] = (&P.n.x)[c];
      }
    }
    if (cov_t) {
      const V3 c = shade(A, sl, own, P, false, nullptr);
      o[3] = c.x, o[4] = c.y, o[5] = c.z;
    }
  }
  float4* dst = reinterpret_cast<float4*>(A.out + 8 * p);
  dst[0] = make_float4(o[0], o[1], o[2], o[3]);
  dst[1] = make_float4(o[4], o[5], o[6], o[7]);
}

// One thread a pixel. The thread issues its pixel's loads of the winner
// ids, and where the transparent layer is covered of both depths, before
// anything waits on them; a block stages the light rows only where one of
// its pixels is covered.
__global__ void __launch_bounds__(kThreads)
    deferred_shade_kernel(DeferredArgs A) {
  // the staged light rows (nl, kRow), then each row's slot mask (nl,)
  extern __shared__ float sl[];
  __shared__ int need;
  // each thread's slot factors, a column of stride kThreads
  __shared__ float fac[kMaxSlots * kThreads];
  const int nl = A.nd + A.np + A.ns;
  int* own = reinterpret_cast<int*>(sl + nl * kRow);
  const size_t npix = static_cast<size_t>(A.rows) * A.cols;
  const size_t p = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool in = p < npix;
  const int tri_o = in ? A.tri[0][p] : -1;
  const int tri_t = in ? A.tri[1][p] : -1;
  // the depths decide the flags only where the transparent layer is
  // covered
  float d_o = 0.0f, d_t = 0.0f;
  if (tri_t >= 0) d_o = A.depth[0][p], d_t = A.depth[1][p];
  if (threadIdx.x == 0) need = 0;
  if (__syncthreads_or(tri_o >= 0 || tri_t >= 0)) {
    // the slots the shadowed rows own (the directional and spot rows and
    // the first kHead point rows), where the row is live
    const int n_sf = A.nd + min(kHead, A.np);
    for (int r = threadIdx.x; r < nl; r += kThreads) {
      float* L = sl + r * kRow;
      stage_light(A, r, L, own + r);
      if ((r < n_sf || r >= A.nd + A.np) && L[20] != 0.0f && own[r]) {
        atomicOr(&need, own[r]);
      }
    }
  }
  __syncthreads();
  if (in) {
    shade_pixel(A, sl, own, fac + threadIdx.x, need, p, tri_o, tri_t, d_o,
                d_t);
  }
}

size_t staged_bytes(int nl) {
  return static_cast<size_t>(nl) * (kRow * sizeof(float) + sizeof(int));
}

}  // namespace
}  // namespace rek

// See DeferredArgs for the layouts; optional inputs are null when absent.
// Returns cudaGetLastError().
extern "C" int launch_deferred_shade(const rek::DeferredArgs* args,
                                     cudaStream_t stream) {
  const rek::DeferredArgs& A = *args;
  if (A.n_slots > rek::kMaxSlots || A.nd < 0 || A.np < 0 || A.ns < 0 ||
      A.pcf_k < 1 || A.cols < 1) {
    return cudaErrorInvalidValue;
  }
  const size_t npix = static_cast<size_t>(A.rows) * A.cols;
  if (npix == 0) return cudaSuccess;
  const size_t smem = rek::staged_bytes(A.nd + A.np + A.ns);
  cudaError_t err = rek::allow_smem(rek::deferred_shade_kernel, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      static_cast<unsigned>((npix + rek::kThreads - 1) / rek::kThreads);
  rek::deferred_shade_kernel<<<blocks, rek::kThreads, smem, stream>>>(A);
  return cudaGetLastError();
}
