// One pixel's G-buffer interpolation from its winner's candidate row, as
// raster_pallas._gbuffer_from_channels computes it on the card: shared by
// the custom-shading hook's G-buffer (custom_gbuffer.cu) and the default
// route's tall G-buffers (tall_gbuffer.cu).
//
// Rounding: the library is built with -fmad=false (kernels.py), so every
// product and sum rounds on its own, as the chain's separate PyTorch
// operations do on the card; a division by a Python number multiplies by
// its reciprocal (PyTorch's CUDA division by a host scalar); `1.0 / x` is a
// true division (PyTorch's reciprocal); the vector norm takes PyTorch's
// order (shade_math.cuh).
#pragma once

#include "shade_math.cuh"

namespace rek {

// raster_pallas._tall_pixel_centers: (origin + index) + 0.5
__device__ __forceinline__ float tall_center(int origin, int index) {
  return (static_cast<float>(origin) + static_cast<float>(index)) + 0.5f;
}

struct PixelInterp {
  V3 pos;      // the world position
  V3 nrm;      // the unit normal
  float u, v;  // the uv
};

// The pixel center (px, py) in the triangle of its winner row: `ch(c)`
// reads channel c (0-5 the screen vertices, 10-18 the normals, 19-24 the
// uvs, 25-27 the inverse w's). The perspective-correct barycentrics at the
// band-local center; the world position of NDC depth `d` at image row
// py + y_off of a width x h_total image, through inv(proj_view) (4, 4) at
// strides (ipv_s0, ipv_s1).
template <class Ch>
__device__ __forceinline__ PixelInterp interpolate(
    const Ch& ch, float px, float py, float y_off, float d,
    const float* inv_pv, int ipv_s0, int ipv_s1, int width, int h_total) {
  const float x0 = ch(0), y0 = ch(1), x1 = ch(2), y1 = ch(3), x2 = ch(4),
              y2 = ch(5);
  const float l0 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1);
  const float l1 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2);
  const float l2 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0);
  const float area = (l0 + l1) + l2;
  const float inv_area = 1.0f / (fabsf(area) > 1e-12f ? area : 1.0f);
  const float w0 = (l0 * inv_area) * ch(25);
  const float w1 = (l1 * inv_area) * ch(26);
  const float w2 = (l2 * inv_area) * ch(27);
  const float den = (w0 + w1) + w2;
  const float inv_d = 1.0f / (fabsf(den) > 1e-12f ? den : 1.0f);
  const float b0 = w0 * inv_d, b1 = w1 * inv_d, b2 = w2 * inv_d;

  // the world position: the global row's NDC through inv(proj_view)
  const float inv_wd = 1.0f / static_cast<float>(width);
  const float inv_ht = 1.0f / static_cast<float>(h_total);
  const float ndc_x = (px * inv_wd) * 2.0f - 1.0f;
  const float ndc_y = 1.0f - ((py + y_off) * inv_ht) * 2.0f;
  float wp[4];
  for (int r = 0; r < 4; ++r) {
    const float* m = inv_pv + r * ipv_s0;
    wp[r] = ((__ldg(m) * ndc_x + __ldg(m + ipv_s1) * ndc_y) +
             __ldg(m + 2 * ipv_s1) * d) +
            __ldg(m + 3 * ipv_s1);
  }
  const float inv_w = 1.0f / (fabsf(wp[3]) > 1e-12f ? wp[3] : 1.0f);
  PixelInterp g;
  g.pos = {wp[0] * inv_w, wp[1] * inv_w, wp[2] * inv_w};

  float* nc = &g.nrm.x;
  for (int c = 0; c < 3; ++c) {
    nc[c] = (b0 * ch(10 + c) + b1 * ch(13 + c)) + b2 * ch(16 + c);
  }
  g.nrm = unit(g.nrm, 1e-12f);
  g.u = (b0 * ch(19) + b1 * ch(21)) + b2 * ch(23);
  g.v = (b0 * ch(20) + b1 * ch(22)) + b2 * ch(24);
  return g;
}

}  // namespace rek
