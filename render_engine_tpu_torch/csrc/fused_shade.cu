// K3: the fused shade.
//
// Replaces render_engine_tpu/render/shade_pallas.py::_shade_kernel (run
// through fused_shade). One block shades one screen tile; each of its 256
// threads owns 4 of the tile's pixels and, for the opaque and then the
// transparent layer:
//   1. reads its winner's attribute row straight from `rows` (K2's
//      resolve, done in place: the per-pixel channel images never exist);
//   2. interpolates perspective-correct barycentrics, the normal
//      (normalised by 1/sqrt) and decodes channel 34 (spec strength, or
//      the packed (strength, Ns) pair);
//   3. applies the texture overrides: albedo, the spec / emissive /
//      dissolve deltas and the normal-mapped normal;
//   4. unprojects its depth through the inverse proj-view (+ the buffer's
//      global pixel origin) to a world position;
//   5. runs Blinn-Phong over the live lights, or over the tile's culled
//      light list: dir / point / spot, attenuation, radius cutoff, smooth
//      spot cone, ndh^shin; on the opaque layer each light's per-slot PCF
//      factors multiply in, picked through the inverse map inv[s, tile];
//   6. applies the diffuse floor, the emissive bypass and the coverage.
// Output (8, NT, th, tw) = [lit rgb | t_lit rgb | alpha | flags], flags
// bit0 = opaque covered, bit1 = transparent in front.
//
// What bounds it on an H100: the light loop's arithmetic (about 60 float
// operations per light and pixel, with one powf) and the row reads (35 of
// A floats per covered pixel and layer). The light table (20 x 28 floats
// in the demo) is staged in shared memory, so a light's columns are
// broadcast reads; the rows are read from global memory through L1/L2
// (K x A floats a tile, 53 KB at K = 208, A = 64: too large to stage in
// 48 KB of static shared memory, and each row is read by several pixels).
// Uncovered pixels skip both layers outright, which replaces the
// reference's per-tile "any pixel covered" gate.
//
// Rounding: the library is built with -fmad=false and every expression
// keeps the reference's order of operations, so the kernel follows the
// plain PyTorch version op for op; they differ only where JAX uses rsqrt
// (here 1/sqrtf) and in powf's last bits.

#include "common.cuh"

namespace rek {
namespace {

constexpr int kLCol = 28;  // packed light-table row width (shade_pallas.py)

struct ShadeArgs {
  const float* rows;  // (nt, k, a)
  const int* s_o;     // (nt, npx) winner slots, opaque / transparent
  const int* s_t;
  const float* d_o;   // (nt, npx) depths
  const float* d_t;
  const float* ltab;  // (nl, kLCol)
  const int* lcount;  // (1,) live lights
  const float* cam;   // (3,)
  const float* ipv;   // (4, 4) inverse proj-view, row major
  const float* org;   // (2,) global pixel origin of this buffer
  const float* sf;    // (n_slots, tb, npx) compact PCF factor tiles, or null
  const int* sfi;     // (n_slots, nt) tile -> compact row (-1 = lit)
  const float* ovr;   // (2 * ovr_chans, nt, npx) texture overrides, or null
  const int* tlist;   // (nt, lb) per-tile light lists, or null
  const int* tcount;  // (nt,)
  float* out;         // (8, nt, npx)
  int nt, k, a, tiles_x, th, tw, n_slots, tb, lb, nl;
  float width, height;
  int ovr_chans, with_norm, with_diss, spec_packed;
  float shin_const, diffuse_floor;
};

struct Lit {
  float r, g, b, alpha;
};

// One layer of one pixel (covered): the body of the reference's
// shade_layer for a single pixel centre (px, py).
__device__ Lit shade_pixel(const ShadeArgs& A, const float* sl, int t, int p,
                           int slot, float depth, float px, float py,
                           bool use_shadows, int ovr_base, int n_iter,
                           const float* ipv, float cx, float cy, float cz,
                           float ox, float oy) {
  const int npx = A.th * A.tw;
  const float* ch =
      A.rows + (static_cast<size_t>(t) * A.k + min(slot, A.k - 1)) * A.a;
  // --- interpolation (_interp) ---
  const float x0 = ch[0], y0 = ch[1], x1 = ch[2], y1 = ch[3];
  const float x2 = ch[4], y2 = ch[5];
  const float l0 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1);
  const float l1 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2);
  const float l2 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0);
  const float area = (l0 + l1) + l2;
  const float inv_area = 1.0f / (fabsf(area) > 1e-12f ? area : 1.0f);
  const float w0 = (l0 * inv_area) * ch[25];
  const float w1 = (l1 * inv_area) * ch[26];
  const float w2 = (l2 * inv_area) * ch[27];
  const float denom = (w0 + w1) + w2;
  const float inv_d = 1.0f / (fabsf(denom) > 1e-12f ? denom : 1.0f);
  const float p0 = w0 * inv_d, p1 = w1 * inv_d, p2 = w2 * inv_d;
  float nx = (p0 * ch[10] + p1 * ch[13]) + p2 * ch[16];
  float ny = (p0 * ch[11] + p1 * ch[14]) + p2 * ch[17];
  float nz = (p0 * ch[12] + p1 * ch[15]) + p2 * ch[18];
  const float nl = rsqrt_rn(max_nan((nx * nx + ny * ny) + nz * nz, 1e-24f));
  nx = nx * nl;
  ny = ny * nl;
  nz = nz * nl;
  float ar = ch[29], ag = ch[30], ab = ch[31];
  float emissive = ch[32];
  float alpha = ch[33];
  float spec_k = ch[34];
  float shin = A.shin_const;
  if (A.spec_packed) {
    const float hq = floorf(spec_k * (1.0f / 4096.0f));
    spec_k = (spec_k - hq * 4096.0f) * (1.0f / 1024.0f);
    shin = hq;
  }
  // --- texture overrides ---
  if (A.ovr != nullptr) {
    auto o = [&](int c) {
      return A.ovr[(static_cast<size_t>(ovr_base + c) * A.nt + t) * npx + p];
    };
    const int base_chans = A.ovr_chans - (A.with_norm ? 4 : 0);
    if (o(3) > 0.5f) {
      ar = o(0);
      ag = o(1);
      ab = o(2);
    }
    if (base_chans >= 5) spec_k = spec_k * (1.0f + o(4));
    if (base_chans >= 6) emissive = emissive * (1.0f + o(5));
    if (A.with_diss && base_chans >= 7) alpha = alpha * (1.0f + o(6));
    if (A.with_norm && o(base_chans + 3) > 0.5f) {
      nx = o(base_chans + 0);
      ny = o(base_chans + 1);
      nz = o(base_chans + 2);
    }
  }
  // --- world position from depth ---
  const float ndc_x = ((px + ox) / A.width) * 2.0f - 1.0f;
  const float ndc_y = 1.0f - ((py + oy) / A.height) * 2.0f;
  float c[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    c[r] = ((ipv[r * 4 + 0] * ndc_x + ipv[r * 4 + 1] * ndc_y) +
            ipv[r * 4 + 2] * depth) + ipv[r * 4 + 3];
  }
  const float inv_w = 1.0f / (fabsf(c[3]) > 1e-12f ? c[3] : 1.0f);
  const float wx = c[0] * inv_w, wy = c[1] * inv_w, wz = c[2] * inv_w;
  float vx = cx - wx, vy = cy - wy, vz = cz - wz;
  const float vl = rsqrt_rn(max_nan((vx * vx + vy * vy) + vz * vz, 1e-24f));
  vx = vx * vl;
  vy = vy * vl;
  vz = vz * vl;
  // --- Blinn-Phong over the lights ---
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  for (int i = 0; i < n_iter; ++i) {
    int li = i;
    if (A.tlist != nullptr) {
      li = A.tlist[static_cast<size_t>(t) * A.lb + i];
      li = min(max(li, 0), A.nl - 1);
    }
    const float* L = sl + li * kLCol;
    const float kind = L[0];
    const float tx = L[1] - wx, ty = L[2] - wy, tz = L[3] - wz;
    const float d2 = (tx * tx + ty * ty) + tz * tz;
    const float d = sqrtf(max_nan(d2, 1e-18f));
    const float invd = 1.0f / d;
    const bool is_dir = kind < 0.5f;
    const float lx = is_dir ? -L[4] : tx * invd;
    const float ly = is_dir ? -L[5] : ty * invd;
    const float lz = is_dir ? -L[6] : tz * invd;
    float atten = is_dir ? 1.0f : 1.0f / ((1.0f + L[16] * d) + L[17] * d2);
    const float radius = L[20];
    if (radius > 0.0f && d > radius) atten = 0.0f;
    const float cos_t = -((lx * L[4] + ly * L[5]) + lz * L[6]);
    const float eps = max_nan(L[18] - L[19], 1e-6f);
    const float spot_i = clamp_nan((cos_t - L[19]) / eps, 0.0f, 1.0f);
    const float intensity = kind > 1.5f ? spot_i : 1.0f;
    const float ndl = max_nan((nx * lx + ny * ly) + nz * lz, 0.0f);
    const float hx = lx + vx, hy = ly + vy, hz = lz + vz;
    const float hl = rsqrt_rn(max_nan((hx * hx + hy * hy) + hz * hz, 1e-24f));
    const float ndh = max_nan(((nx * hx + ny * hy) + nz * hz) * hl, 0.0f);
    const float spec = (ndl > 0.0f ? powf(ndh, shin) : 0.0f) * spec_k;
    float s = atten * intensity;
    if (use_shadows) {
      for (int q = 0; q < A.n_slots; ++q) {
        const int inv = A.sfi[static_cast<size_t>(q) * A.nt + t];
        const float mapped = inv >= 0 ? 1.0f : 0.0f;
        if (L[21 + q] * mapped > 0.5f) {
          s = s * A.sf[(static_cast<size_t>(q) * A.tb + max(inv, 0)) * npx + p];
        }
      }
    }
    cr = cr + s * ((L[13] * ar + (L[7] * ndl) * ar) + L[10] * spec);
    cg = cg + s * ((L[14] * ag + (L[8] * ndl) * ag) + L[11] * spec);
    cb = cb + s * ((L[15] * ab + (L[9] * ndl) * ab) + L[12] * spec);
  }
  cr = max_nan(cr, A.diffuse_floor * ar);
  cg = max_nan(cg, A.diffuse_floor * ag);
  cb = max_nan(cb, A.diffuse_floor * ab);
  if (emissive > 0.0f) {
    cr = ar * emissive;
    cg = ag * emissive;
    cb = ab * emissive;
  }
  return Lit{cr, cg, cb, alpha};
}

__global__ void __launch_bounds__(kThreads) fused_shade_kernel(ShadeArgs A) {
  extern __shared__ float sl[];  // (nl, kLCol) light table
  const int t = blockIdx.x;
  for (int i = threadIdx.x; i < A.nl * kLCol; i += blockDim.x) {
    sl[i] = A.ltab[i];
  }
  __syncthreads();

  float ipv[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) ipv[i] = A.ipv[i];
  const float cx = A.cam[0], cy = A.cam[1], cz = A.cam[2];
  const float ox = A.org[0], oy = A.org[1];
  int n_iter = A.tlist != nullptr ? A.tcount[t] : A.lcount[0];
  n_iter = min(max(n_iter, 0), A.tlist != nullptr ? A.lb : A.nl);

  const int npx = A.th * A.tw;
  const int ty0 = (t / A.tiles_x) * A.th;
  const int tx0 = (t % A.tiles_x) * A.tw;
  const size_t base = static_cast<size_t>(t) * npx;
  const size_t plane = static_cast<size_t>(A.nt) * npx;
#pragma unroll 1
  for (int j = 0; j < kMaxPix; ++j) {
    const int p = threadIdx.x + j * kThreads;
    if (p >= npx) break;
    const float py = (static_cast<float>(p / A.tw) + static_cast<float>(ty0)) + 0.5f;
    const float px = (static_cast<float>(p % A.tw) + static_cast<float>(tx0)) + 0.5f;
    const int so = A.s_o[base + p], st = A.s_t[base + p];
    const float dop = A.d_o[base + p], dtp = A.d_t[base + p];
    const bool cov_o = so >= 0, cov_t = st >= 0;
    Lit o{0.0f, 0.0f, 0.0f, 0.0f}, tr{0.0f, 0.0f, 0.0f, 1.0f};
    if (cov_o) {
      o = shade_pixel(A, sl, t, p, so, dop, px, py, A.n_slots > 0, 0, n_iter,
                      ipv, cx, cy, cz, ox, oy);
    }
    if (cov_t) {
      tr = shade_pixel(A, sl, t, p, st, dtp, px, py, false, A.ovr_chans,
                       n_iter, ipv, cx, cy, cz, ox, oy);
    }
    const bool t_front = cov_t && (dtp <= dop);
    float* out = A.out + base + p;
    out[0 * plane] = o.r;
    out[1 * plane] = o.g;
    out[2 * plane] = o.b;
    out[3 * plane] = tr.r;
    out[4 * plane] = tr.g;
    out[5 * plane] = tr.b;
    out[6 * plane] = tr.alpha;
    out[7 * plane] = (cov_o ? 1.0f : 0.0f) + 2.0f * (t_front ? 1.0f : 0.0f);
  }
}

}  // namespace
}  // namespace rek

// See ShadeArgs for the layouts; optional inputs are null when absent.
// Returns cudaGetLastError().
extern "C" int launch_fused_shade(
    const float* rows, const int* s_o, const int* s_t, const float* d_o,
    const float* d_t, const float* ltab, const int* lcount, const float* cam,
    const float* ipv, const float* org, const float* sf, const int* sfi,
    const float* ovr, const int* tlist, const int* tcount, float* out, int nt,
    int k, int a, int tiles_x, int th, int tw, int n_slots, int tb, int lb,
    int nl, float width, float height, int ovr_chans, int with_norm,
    int with_diss, int spec_packed, float shin_const, float diffuse_floor,
    cudaStream_t stream) {
  if (th * tw > rek::kThreads * rek::kMaxPix || a < 35 || nl < 1 ||
      n_slots > rek::kLCol - 21) {
    return cudaErrorInvalidValue;
  }
  if (nt == 0) return cudaSuccess;
  rek::ShadeArgs args{rows, s_o, s_t, d_o, d_t, ltab, lcount, cam,
                      ipv, org, sf, sfi, ovr, tlist, tcount, out,
                      nt, k, a, tiles_x, th, tw, n_slots, tb, lb, nl,
                      width, height, ovr_chans, with_norm, with_diss,
                      spec_packed, shin_const, diffuse_floor};
  const size_t smem = static_cast<size_t>(nl) * rek::kLCol * sizeof(float);
  cudaError_t err = rek::allow_smem(rek::fused_shade_kernel, smem);
  if (err != cudaSuccess) return err;
  rek::fused_shade_kernel<<<nt, rek::kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}
