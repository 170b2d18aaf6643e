// Vector arithmetic, the atlas tap and the normal map as the port's plain
// PyTorch versions compute them on the card: shared by the default route's
// shading (deferred_shade.cu) and the custom-shading hook's G-buffer
// (custom_gbuffer.cu).
//
// The library is built with -fmad=false (kernels.py), so every product and
// sum below rounds on its own, as PyTorch's separate elementwise operations
// do; the orders of the reductions were read from PyTorch's outputs on the
// card (torch 2.11).
#pragma once

#include "common.cuh"

namespace rek {

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
// torch.remainder(x, 1.0) on the card
__device__ __forceinline__ float rem1(float x) {
  float m = fmodf(x, 1.0f);
  if (m != 0.0f && m < 0.0f) m += 1.0f;
  return m;
}

// textures.TextureAtlas: layers (n_layers, size, size, 3), tex_layer
// (n_tex,), uv_rect (n_tex, 4)
struct AtlasView {
  const float* layers;
  const int* tex_layer;
  const float* uv_rect;
  int n_tex, size;
};

// textures.sample_atlas of texture id `tex` at model-space (u, v)
__device__ inline V3 sample_texture(const AtlasView& at, int tex, float uu,
                                    float vv) {
  const int t = min(max(tex, 0), at.n_tex - 1);
  const int s = at.size;
  const float sf = static_cast<float>(s) - 1.0f;
  const int lay = at.tex_layer[t];
  const float* rect = at.uv_rect + 4 * t;
  const float u = rect[2] + rem1(uu) * rect[0];
  const float v = rect[3] + (1.0f - rem1(vv)) * rect[1];
  const int u0 = static_cast<int>(clamp_nan(floorf(u), 0.0f, sf));
  const int v0 = static_cast<int>(clamp_nan(floorf(v), 0.0f, sf));
  const int u1 = min(u0 + 1, s - 1), v1 = min(v0 + 1, s - 1);
  const float fu = u - static_cast<float>(u0);
  const float fv = v - static_cast<float>(v0);
  const float* base = at.layers + static_cast<size_t>(lay) * s * s * 3;
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

// geometry.perturb_normal
__device__ inline V3 perturb_normal(V3 n, V3 tan, float handed, V3 smp) {
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

}  // namespace rek
