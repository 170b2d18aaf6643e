// K3: the fused shade.
//
// Replaces render_engine_tpu/render/shade_pallas.py::_shade_kernel (run
// through fused_shade). One block shades one screen tile in two passes.
//
// Pass A: each of the 256 threads reads the four slot / depth planes at its
// pixels p = j * 256 + thread (j < 4; neighbouring lanes on neighbouring
// addresses, so every load and store of a warp covers whole 128-byte
// lines), writes plane 7 (flags: bit0 opaque covered, bit1 transparent in
// front) and the constant values of every uncovered layer (rgb 0, and
// alpha 1 on the transparent layer), and compacts the covered (pixel,
// layer) items into a work list in shared memory: a warp ballot per row of
// pixels and a scan over the block's warps, opaque items first, each layer
// in pixel order (render/shade_pallas.py::shade_work_list mirrors it). A
// tile with nothing covered ends there: in the black space scene most do.
//
// Pass B: the threads take the work list one item each, so every lane of a
// warp runs a light loop, whichever pixels of the tile are covered. For its
// item a thread:
//   1. reads its winner's attribute row straight from `rows` (K2's
//      resolve, done in place: the per-pixel channel images never exist);
//   2. interpolates perspective-correct barycentrics, the normal
//      (normalised by rsqrt) and decodes channel 34 (spec strength, or
//      the packed (strength, Ns) pair);
//   3. applies the texture overrides: albedo, the spec / emissive /
//      dissolve deltas and the normal-mapped normal;
//   4. unprojects its depth through the inverse proj-view (+ the buffer's
//      global pixel origin) to a world position;
//   5. runs Blinn-Phong over the live lights, or over the tile's culled
//      light list: dir / point / spot, attenuation, radius cutoff, smooth
//      spot cone, ndh^shin; on the opaque layer each light's per-slot PCF
//      factors multiply in, picked through the inverse map inv[s, tile];
//   6. applies the diffuse floor and the emissive bypass, and stores its
//      layer's planes.
// Output (8, NT, th, tw) = [lit rgb | t_lit rgb | alpha | flags]; every
// element is written once, by pass A or by pass B.
//
// What bounds it on an H100: memory, at the frame's shapes: 48 bytes a
// pixel of planes in and out, against about 60 float operations per
// covered item and light. The old design walked 4 pixels a thread one after
// another and ran the light loop for a warp with one covered lane while 31
// idled, twice (one inlined copy per layer); the work list keeps the lanes
// busy and instantiates one layer's shade once. The light table and the
// scene constants (inverse proj-view, camera, origin) sit in shared memory,
// read as broadcasts. The attribute rows are read through L1: a warp's
// items are neighbouring pixels, mostly of one triangle, so its loads of a
// channel hit the same few lines.
//
// Rounding: the library is built with -fmad=false and every expression
// keeps the reference's order of operations, so the kernel follows the
// plain PyTorch version op for op, as PyTorch computes it on the card:
// rsqrt from rsqrtf, powf, and the NDC terms' division by the buffer size
// as a multiplication by its reciprocal. Against the JAX reference and the
// plain version on the CPU these differ in the last bits, which the
// specular exponent amplifies: hence the 1e-5 tolerance.

#include "common.cuh"

namespace rek {
namespace {

constexpr int kLCol = 28;  // packed light-table row width (shade_pallas.py)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxItems = 2 * kThreads * kMaxPix;
constexpr int kScene = 21;  // ipv (16), camera (3), pixel origin (2)

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

// One covered item: pixel p of tile t on `layer` (0 opaque, 1 transparent):
// the body of the reference's shade_layer for a single pixel centre.
// `sl` is the light table, `sc` the scene constants, both in shared memory.
__device__ void shade_item(const ShadeArgs& A, const float* sl,
                           const float* sc, int t, int p, int layer,
                           int n_iter) {
  const int npx = A.th * A.tw;
  const size_t pix = static_cast<size_t>(t) * npx + p;
  const int slot = layer ? A.s_t[pix] : A.s_o[pix];
  const float depth = layer ? A.d_t[pix] : A.d_o[pix];
  const bool use_shadows = layer == 0 && A.n_slots > 0;
  const int ovr_base = layer ? A.ovr_chans : 0;
  const float py = (static_cast<float>(p / A.tw) +
                    static_cast<float>((t / A.tiles_x) * A.th)) + 0.5f;
  const float px = (static_cast<float>(p % A.tw) +
                    static_cast<float>((t % A.tiles_x) * A.tw)) + 0.5f;
  const float* ch =
      A.rows + (static_cast<size_t>(t) * A.k + min(slot, A.k - 1)) * A.a;
  // --- interpolation (_interp) ---
  const float x0 = __ldg(ch + 0), y0 = __ldg(ch + 1), x1 = __ldg(ch + 2);
  const float y1 = __ldg(ch + 3), x2 = __ldg(ch + 4), y2 = __ldg(ch + 5);
  const float l0 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1);
  const float l1 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2);
  const float l2 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0);
  const float area = (l0 + l1) + l2;
  const float inv_area = 1.0f / (fabsf(area) > 1e-12f ? area : 1.0f);
  const float w0 = (l0 * inv_area) * __ldg(ch + 25);
  const float w1 = (l1 * inv_area) * __ldg(ch + 26);
  const float w2 = (l2 * inv_area) * __ldg(ch + 27);
  const float denom = (w0 + w1) + w2;
  const float inv_d = 1.0f / (fabsf(denom) > 1e-12f ? denom : 1.0f);
  const float p0 = w0 * inv_d, p1 = w1 * inv_d, p2 = w2 * inv_d;
  float nx = (p0 * __ldg(ch + 10) + p1 * __ldg(ch + 13)) + p2 * __ldg(ch + 16);
  float ny = (p0 * __ldg(ch + 11) + p1 * __ldg(ch + 14)) + p2 * __ldg(ch + 17);
  float nz = (p0 * __ldg(ch + 12) + p1 * __ldg(ch + 15)) + p2 * __ldg(ch + 18);
  const float nl = rsqrt_pt(max_nan((nx * nx + ny * ny) + nz * nz, 1e-24f));
  nx = nx * nl;
  ny = ny * nl;
  nz = nz * nl;
  float ar = __ldg(ch + 29), ag = __ldg(ch + 30), ab = __ldg(ch + 31);
  float emissive = __ldg(ch + 32);
  float alpha = __ldg(ch + 33);
  float spec_k = __ldg(ch + 34);
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
  // PyTorch's CUDA division by a Python float multiplies by its reciprocal
  const float ndc_x = ((px + sc[19]) * (1.0f / A.width)) * 2.0f - 1.0f;
  const float ndc_y = 1.0f - ((py + sc[20]) * (1.0f / A.height)) * 2.0f;
  float c[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    c[r] = ((sc[r * 4 + 0] * ndc_x + sc[r * 4 + 1] * ndc_y) +
            sc[r * 4 + 2] * depth) + sc[r * 4 + 3];
  }
  const float inv_w = 1.0f / (fabsf(c[3]) > 1e-12f ? c[3] : 1.0f);
  const float wx = c[0] * inv_w, wy = c[1] * inv_w, wz = c[2] * inv_w;
  float vx = sc[16] - wx, vy = sc[17] - wy, vz = sc[18] - wz;
  const float vl = rsqrt_pt(max_nan((vx * vx + vy * vy) + vz * vz, 1e-24f));
  vx = vx * vl;
  vy = vy * vl;
  vz = vz * vl;
  // --- Blinn-Phong over the lights ---
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
#pragma unroll 1
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
    const float hl = rsqrt_pt(max_nan((hx * hx + hy * hy) + hz * hz, 1e-24f));
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
  const size_t plane = static_cast<size_t>(A.nt) * npx;
  float* out = A.out + pix;
  if (layer == 0) {
    out[0 * plane] = cr;
    out[1 * plane] = cg;
    out[2 * plane] = cb;
  } else {
    out[3 * plane] = cr;
    out[4 * plane] = cg;
    out[5 * plane] = cb;
    out[6 * plane] = alpha;
  }
}

// 4 blocks of 256 threads an SM (64 registers a thread): pass A keeps 16 KB
// of plane loads in flight an SM, several times what the memory's latency
// needs; pass B's light loop needs the registers.
__global__ void __launch_bounds__(kThreads, 4) fused_shade_kernel(ShadeArgs A) {
  extern __shared__ float sl[];  // (nl, kLCol) light table
  __shared__ float sc[kScene];
  __shared__ short items[kMaxItems];
  __shared__ int wcount[kMaxPix][2][kWarps];
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int npx = A.th * A.tw;
  const size_t base = static_cast<size_t>(t) * npx;
  const size_t plane = static_cast<size_t>(A.nt) * npx;

  // --- pass A: flags, uncovered layers, ballots ---
  unsigned bal[kMaxPix][2];
#pragma unroll
  for (int j = 0; j < kMaxPix; ++j) {
    const int p = j * kThreads + threadIdx.x;
    const bool in = p < npx;
    const int so = in ? A.s_o[base + p] : -1;
    const int st = in ? A.s_t[base + p] : -1;
    const float dop = in ? A.d_o[base + p] : 1.0f;
    const float dtp = in ? A.d_t[base + p] : 1.0f;
    const bool cov_o = so >= 0, cov_t = st >= 0;
    if (in) {
      const bool t_front = cov_t && (dtp <= dop);
      float* out = A.out + base + p;
      out[7 * plane] = (cov_o ? 1.0f : 0.0f) + 2.0f * (t_front ? 1.0f : 0.0f);
      if (!cov_o) {
        out[0 * plane] = 0.0f;
        out[1 * plane] = 0.0f;
        out[2 * plane] = 0.0f;
      }
      if (!cov_t) {
        out[3 * plane] = 0.0f;
        out[4 * plane] = 0.0f;
        out[5 * plane] = 0.0f;
        out[6 * plane] = 1.0f;
      }
    }
    bal[j][0] = __ballot_sync(0xffffffffu, cov_o);
    bal[j][1] = __ballot_sync(0xffffffffu, cov_t);
    if (lane == 0) {
      wcount[j][0][warp] = __popc(bal[j][0]);
      wcount[j][1][warp] = __popc(bal[j][1]);
    }
  }
  for (int i = threadIdx.x; i < A.nl * kLCol; i += blockDim.x) {
    sl[i] = A.ltab[i];
  }
  if (threadIdx.x < 16) {
    sc[threadIdx.x] = A.ipv[threadIdx.x];
  } else if (threadIdx.x < 19) {
    sc[threadIdx.x] = A.cam[threadIdx.x - 16];
  } else if (threadIdx.x < kScene) {
    sc[threadIdx.x] = A.org[threadIdx.x - 19];
  }
  __syncthreads();

  // --- the work list: item p (opaque) or npx + p (transparent), opaque
  // items first, each layer in pixel order, i.e. in (j, warp, lane) order
  int before[kMaxPix][2];
  int total[2] = {0, 0};
#pragma unroll
  for (int j = 0; j < kMaxPix; ++j) {
#pragma unroll
    for (int l = 0; l < 2; ++l) before[j][l] = total[l];
    for (int w = 0; w < kWarps; ++w) {
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        if (w == warp) before[j][l] = total[l];
        total[l] += wcount[j][l][w];
      }
    }
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kMaxPix; ++j) {
    const int p = j * kThreads + threadIdx.x;
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      if ((bal[j][l] >> lane) & 1u) {
        items[l * total[0] + before[j][l] + __popc(bal[j][l] & below)] =
            static_cast<short>(l * npx + p);
      }
    }
  }
  const int n_items = total[0] + total[1];
  if (n_items == 0) return;  // uniform: nothing covered in the tile
  __syncthreads();

  // --- pass B: one item a thread ---
  int n_iter = A.tlist != nullptr ? A.tcount[t] : A.lcount[0];
  n_iter = min(max(n_iter, 0), A.tlist != nullptr ? A.lb : A.nl);
  for (int i = threadIdx.x; i < n_items; i += blockDim.x) {
    const int it = items[i];
    const int layer = it >= npx ? 1 : 0;
    shade_item(A, sl, sc, t, it - layer * npx, layer, n_iter);
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

// Blocks of the kernel that one SM holds at once with a light table of `nl`
// rows in dynamic shared memory (the CUDA occupancy calculator's answer for
// this build's registers and static shared memory), or -1 on an error.
extern "C" int fused_shade_blocks_per_sm(int nl) {
  const size_t smem = static_cast<size_t>(nl) * rek::kLCol * sizeof(float);
  if (rek::allow_smem(rek::fused_shade_kernel, smem) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, rek::fused_shade_kernel, rek::kThreads, smem) !=
      cudaSuccess) {
    return -1;
  }
  return blocks;
}
