// K3: the fused shade.
//
// Replaces render_engine_tpu/render/shade_pallas.py::_shade_kernel (run
// through fused_shade). One launch a call. A block of 128 threads owns 256
// consecutive pixels of one screen tile (two rows of an 8x128 tile), so a
// tile is spread over ceil(th * tw / 256) blocks (grid nt x 4 at 8x128).
// No atomic anywhere: blocks share nothing, and the outputs do not depend
// on the order in which they run. Each block runs two passes.
//
// Pass A: each thread reads the four slot / depth planes at its two pixels
// p0 + j * 128 + thread, all eight loads before any store (neighbouring
// lanes on neighbouring addresses, so every load and store of a warp
// covers whole 128-byte lines), writes plane 7 (flags: bit0 opaque
// covered, bit1 transparent in front) and the constant values of every
// uncovered layer (rgb 0, and alpha 1 on the transparent layer), and
// compacts the block's covered (pixel, layer) items into a work list in
// shared memory: a warp ballot per pixel and layer and a scan over the
// block's warps, opaque items first, each layer in pixel order
// (render/shade_pallas.py::shade_block_items mirrors it). A block with
// nothing covered ends there, before it copies anything: in the black
// space scene most do.
//
// Staging: a block with work copies into shared memory the scene constants
// (inverse proj-view, camera, pixel origin), its tile's slot -> factor-row
// map, and the light rows its loop reads, in loop order: on the list route
// row i is ltab[clamp(tlist[t, i], 0, nl - 1)], on the dense route ltab[i],
// for i < n_iter (render/shade_pallas.py::staged_light_rows mirrors it),
// with each row's skip cutoff (skip_cut). The loop reads row i with no
// global load, as a broadcast.
//
// Pass B: the threads take the work list one item each, so every lane of a
// warp runs a light loop, whichever pixels are covered. For its item a
// thread:
//   1. reads its winner's attribute row straight from `rows` (K2's
//      resolve, done in place: the per-pixel channel images never exist);
//   2. interpolates perspective-correct barycentrics, the normal
//      (normalised by rsqrt) and decodes channel 34 (spec strength, or
//      the packed (strength, Ns) pair);
//   3. applies the texture overrides: albedo, the spec / emissive /
//      dissolve deltas and the normal-mapped normal;
//   4. unprojects its depth through the inverse proj-view (+ the buffer's
//      global pixel origin) to a world position;
//   5. on the opaque layer reads its PCF factor of each mapped shadow slot
//      once, into its own column of shared memory;
//   6. runs Blinn-Phong over the staged rows in order: dir / point / spot,
//      attenuation, radius cutoff, smooth spot cone, ndh^shin, and on the
//      opaque layer each owned and mapped slot's factor; a light that its
//      radius cuts off adds exactly +-0 where the values are bounded, and
//      the lane passes over it (skip_cut);
//   7. applies the diffuse floor and the emissive bypass, and stores its
//      layer's planes.
// Output (8, NT, th, tw) = [lit rgb | t_lit rgb | alpha | flags]; every
// element is written once, by pass A or by pass B.
//
// What bounds it on an H100. The planes move 48 bytes a pixel; the light
// loop costs a few hundred instructions per covered item and light (IEEE
// divisions, sqrtf, powf), a chain of dependent steps. On the many-lights
// scene about 2% of the pixels are covered, in the few tiles a large
// object covers: the kernel lasts as long as its busiest blocks' loops.
// So a busy tile's items are spread over four blocks, and over SMs (a
// block that owned the whole tile would run up to 2048 items on one SM);
// the loop reads no global memory; and a light that its radius cuts off
// at the pixel costs the lane a distance test instead of the loop body. What
// remains is the busiest blocks' loop on a few warps an SM, whose latency
// nothing hides; overlapping two lights a thread was measured slower
// (PERF.md). Where the loop is short, as on the headline, pass A's memory
// traffic bounds the kernel: two pixels a thread keep twice the loads in
// flight. Blocks without work copy nothing, and a list block stages its lb
// rows, not the table (96 rows, 11,136 B with cutoffs, on the many-lights
// scene, against 30,016 B for the whole table).
//
// Rounding: the library is built with -fmad=false and every expression
// keeps the reference's order of operations, so the kernel follows the
// plain PyTorch version op for op, as PyTorch computes it on the card:
// rsqrt from rsqrtf, powf, and the NDC terms' division by the buffer size
// as a multiplication by its reciprocal. Each item sums its lights from
// the first up; skipping a light that adds +-0 changes no bit. Against the
// JAX reference and the plain version on the CPU these differ in the last
// bits, which the specular exponent amplifies: hence the 1e-5 tolerance.

#include "common.cuh"

namespace rek {
namespace {

constexpr int kLCol = 28;  // packed light-table row width (shade_pallas.py)
constexpr int kMaxSlots = kLCol - 21;  // shadow-slot ownership columns
constexpr int kBlock = 128;               // threads a block
constexpr int kBlocksPerSm = 8;           // at most 64 registers a thread
constexpr int kWarps = kBlock / 32;
constexpr int kPixA = 2;                // pixels a thread in pass A
constexpr int kChunk = kBlock * kPixA;  // pixels a block owns
constexpr int kMaxItems = 2 * kChunk;
constexpr int kScene = 21;  // ipv (16), camera (3), pixel origin (2)

// The bounds under which a light cut off by its radius adds exactly +-0
// (see skip_cut)
constexpr float kFinite = 3.4028235e38f;   // FLT_MAX
constexpr float kPos = 1.152921504606847e18f;  // 2^60: positions, cone
constexpr float kColor = 1.099511627776e12f;   // 2^40: colours, spec
constexpr float kShin = 65536.0f;              // 2^16: the exponent
constexpr float kNormal2 = 1.00048828125f;     // 1 + 2^-11: |n|^2

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

__device__ __forceinline__ bool within(float x, float b) {
  return fabsf(x) <= b;  // false for NaN
}

// Skipping lights. A light whose radius cuts an item off (radius > 0 and
// d > radius) has attenuation 0. Where the light's and the item's values
// are bounded (skip_cut, item_bounded) the rest of its terms are finite:
// the spot intensity lies in [0, 1], ndh below 1.0003 (|n| <= 1.00025),
// ndh^shin below 1e7 (shin <= 2^16), each colour term below 2^80 and the
// specular one below 2^112. The light's contribution s * (...) is then
// +-0, and a sum that starts at +0 and so never becomes -0 stays as it is:
// the loop may pass over the light and every output bit stays the same.
// render/shade_pallas.py::shade_skip_cut and shade_skip_item mirror the
// bounds, and tests hold the plain version to them.

// A staged row's cutoff: its radius where its values are bounded (kPos
// for the position and the cone, 2 for the direction, kColor for the
// colours), else +inf (never skipped).
__device__ float skip_cut(const float* L) {
  bool ok = L[20] > 0.0f && within(L[20], kFinite);
  for (int c = 1; c <= 3; ++c) ok = ok && within(L[c], kPos);
  for (int c = 4; c <= 6; ++c) ok = ok && within(L[c], 2.0f);
  for (int c = 7; c <= 15; ++c) ok = ok && within(L[c], kColor);
  ok = ok && within(L[18], kPos) && within(L[19], kPos);
  return ok ? L[20] : __int_as_float(0x7f800000);
}

// Whether a bounded item at (wx, wy, wz) skips staged light L with cutoff
// rc (skip_cut); d is the loop's own d.
__device__ __forceinline__ bool skips(const float* L, float rc, float wx,
                                      float wy, float wz) {
  const float tx = L[1] - wx, ty = L[2] - wy, tz = L[3] - wz;
  return sqrtf(max_nan((tx * tx + ty * ty) + tz * tz, 1e-18f)) > rc;
}

// Whether an item's values are bounded: world position within kPos, view
// vector within 2, |n|^2 within kNormal2, albedo and spec strength within
// kColor, exponent in [0, kShin]. (Its PCF factors must be finite too.)
__device__ bool item_bounded(float wx, float wy, float wz, float vx, float vy,
                             float vz, float nx, float ny, float nz, float ar,
                             float ag, float ab, float spec_k, float shin) {
  return within(wx, kPos) && within(wy, kPos) && within(wz, kPos) &&
         within(vx, 2.0f) && within(vy, 2.0f) && within(vz, 2.0f) &&
         (nx * nx + ny * ny) + nz * nz <= kNormal2 && within(ar, kColor) &&
         within(ag, kColor) && within(ab, kColor) && within(spec_k, kColor) &&
         shin >= 0.0f && shin <= kShin;
}

// One covered item: pixel p of tile t on `layer` (0 opaque, 1 transparent):
// the body of the reference's shade_layer for a single pixel centre.
// `sl` holds the n_iter staged light rows and `cut` their skip cutoffs
// (skip_cut), `sc` the scene constants, `sinv` the tile's factor row of
// each slot, all in shared memory; `fac` is this thread's column of
// factors (stride kBlock).
__device__ void shade_item(const ShadeArgs& A, const float* sl,
                           const float* cut, const float* sc,
                           const int* sinv, float* fac, int t, int p,
                           int layer, int n_iter) {
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
  // --- whether the loop may skip lights (item_bounded), and the item's PCF
  // factors, once: slot q applies where it is mapped (the tile has a
  // factor row) and the light owns it ---
  bool safe = item_bounded(wx, wy, wz, vx, vy, vz, nx, ny, nz, ar, ag, ab,
                           spec_k, shin);
  if (use_shadows) {
    for (int q = 0; q < A.n_slots; ++q) {
      if (sinv[q] >= 0) {
        const float f =
            A.sf[(static_cast<size_t>(q) * A.tb + sinv[q]) * npx + p];
        fac[q * kBlock] = f;
        safe = safe && fabsf(f) <= kFinite;
      }
    }
  }
  // --- Blinn-Phong over the staged lights, in order. Each lane first
  // passes over the lights that skip (see skip_cut: each adds exactly +-0
  // to the sums), on its own, then the warp shades each lane's next light
  // together ---
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
#pragma unroll 1
  for (int i = 0;; ++i) {
    while (i < n_iter && safe && skips(sl + i * kLCol, cut[i], wx, wy, wz)) {
      ++i;
    }
    if (i >= n_iter) break;
    const float* L = sl + i * kLCol;
    const float tx = L[1] - wx, ty = L[2] - wy, tz = L[3] - wz;
    const float d2 = (tx * tx + ty * ty) + tz * tz;
    const float d = sqrtf(max_nan(d2, 1e-18f));
    const float kind = L[0];
    const float invd = 1.0f / d;
    const bool is_dir = kind < 0.5f;
    const float lx = is_dir ? -L[4] : tx * invd;
    const float ly = is_dir ? -L[5] : ty * invd;
    const float lz = is_dir ? -L[6] : tz * invd;
    float atten = 1.0f;
    if (!is_dir) atten = 1.0f / ((1.0f + L[16] * d) + L[17] * d2);
    const float radius = L[20];
    if (radius > 0.0f && d > radius) atten = 0.0f;
    float intensity = 1.0f;
    if (kind > 1.5f) {
      const float cos_t = -((lx * L[4] + ly * L[5]) + lz * L[6]);
      const float eps = max_nan(L[18] - L[19], 1e-6f);
      intensity = clamp_nan((cos_t - L[19]) / eps, 0.0f, 1.0f);
    }
    const float ndl = max_nan((nx * lx + ny * ly) + nz * lz, 0.0f);
    const float hx = lx + vx, hy = ly + vy, hz = lz + vz;
    const float hl = rsqrt_pt(max_nan((hx * hx + hy * hy) + hz * hz, 1e-24f));
    const float ndh = max_nan(((nx * hx + ny * hy) + nz * hz) * hl, 0.0f);
    float pw = 0.0f;
    if (ndl > 0.0f) pw = powf(ndh, shin);
    const float spec = pw * spec_k;
    float s = atten * intensity;
    if (use_shadows) {
      for (int q = 0; q < A.n_slots; ++q) {
        const float mapped = sinv[q] >= 0 ? 1.0f : 0.0f;
        if (L[21 + q] * mapped > 0.5f) s = s * fac[q * kBlock];
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

// 8 blocks of 128 threads an SM (64 registers a thread): the light loop
// needs the registers, so pass A keeps its loads in flight by issuing all
// kPixA pixels' loads before any store.
__global__ void __launch_bounds__(kBlock, kBlocksPerSm)
    fused_shade_kernel(ShadeArgs A) {
  // the staged light rows (n_rows, kLCol), then their cutoffs (n_rows,)
  extern __shared__ float sl[];
  __shared__ float sc[kScene];
  __shared__ int sinv[kMaxSlots];
  __shared__ float fac[kMaxSlots * kBlock];
  __shared__ short items[kMaxItems];
  __shared__ int wcount[kPixA][2][kWarps];
  const int npx = A.th * A.tw;
  const int n_chunks = (npx + kChunk - 1) / kChunk;
  const int t = blockIdx.x / n_chunks;
  const int p0 = (blockIdx.x - t * n_chunks) * kChunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t base = static_cast<size_t>(t) * npx;
  const size_t plane = static_cast<size_t>(A.nt) * npx;

  // --- pass A: flags, uncovered layers, ballots; pixel p0 + j * kBlock
  // + thread ---
  int so[kPixA], st[kPixA];
  float dop[kPixA], dtp[kPixA];
#pragma unroll
  for (int j = 0; j < kPixA; ++j) {
    const int p = p0 + j * kBlock + threadIdx.x;
    const bool in = p < npx;
    so[j] = in ? A.s_o[base + p] : -1;
    st[j] = in ? A.s_t[base + p] : -1;
    dop[j] = in ? A.d_o[base + p] : 1.0f;
    dtp[j] = in ? A.d_t[base + p] : 1.0f;
  }
  unsigned bal[kPixA][2];
#pragma unroll
  for (int j = 0; j < kPixA; ++j) {
    const int p = p0 + j * kBlock + threadIdx.x;
    const bool cov_o = so[j] >= 0, cov_t = st[j] >= 0;
    if (p < npx) {
      const bool t_front = cov_t && (dtp[j] <= dop[j]);
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
  __syncthreads();

  // --- the work list: item p (opaque) or npx + p (transparent), opaque
  // items first, each layer in pixel order, i.e. in (j, warp, lane) order
  int before[kPixA][2];
  int total[2] = {0, 0};
#pragma unroll
  for (int j = 0; j < kPixA; ++j) {
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
  for (int j = 0; j < kPixA; ++j) {
    const int p = p0 + j * kBlock + threadIdx.x;
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      if ((bal[j][l] >> lane) & 1u) {
        items[l * total[0] + before[j][l] + __popc(bal[j][l] & below)] =
            static_cast<short>(l * npx + p);
      }
    }
  }
  const int n_items = total[0] + total[1];
  if (n_items == 0) return;  // uniform: nothing covered in the block

  // --- staging: scene constants, the slot map, the loop's light rows and
  // their cutoffs ---
  const bool listed = A.tlist != nullptr;
  const int n_rows = listed ? A.lb : A.nl;
  int n_iter = listed ? A.tcount[t] : A.lcount[0];
  n_iter = min(max(n_iter, 0), n_rows);
  auto row = [&](int i) {
    const int li =
        listed ? A.tlist[static_cast<size_t>(t) * A.lb + i] : i;
    return A.ltab + min(max(li, 0), A.nl - 1) * kLCol;
  };
  for (int e = threadIdx.x; e < n_iter * kLCol; e += kBlock) {
    const int i = e / kLCol;
    sl[e] = row(i)[e - i * kLCol];
  }
  float* cut = sl + n_rows * kLCol;
  for (int i = threadIdx.x; i < n_iter; i += kBlock) {
    cut[i] = skip_cut(row(i));
  }
  if (threadIdx.x < 16) {
    sc[threadIdx.x] = A.ipv[threadIdx.x];
  } else if (threadIdx.x < 19) {
    sc[threadIdx.x] = A.cam[threadIdx.x - 16];
  } else if (threadIdx.x < kScene) {
    sc[threadIdx.x] = A.org[threadIdx.x - 19];
  } else if (threadIdx.x >= 32 && threadIdx.x < 32 + A.n_slots) {
    const int q = threadIdx.x - 32;
    sinv[q] = A.sfi[static_cast<size_t>(q) * A.nt + t];
  }
  __syncthreads();

  // --- pass B: one item a thread ---
  for (int i = threadIdx.x; i < n_items; i += kBlock) {
    const int it = items[i];
    const int layer = it >= npx ? 1 : 0;
    shade_item(A, sl, cut, sc, sinv, fac + threadIdx.x, t, it - layer * npx,
               layer, n_iter);
  }
}

// dynamic shared memory for n_rows staged rows and their cutoffs
size_t staged_bytes(int n_rows) {
  return static_cast<size_t>(n_rows) * (kLCol + 1) * sizeof(float);
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
      n_slots > rek::kMaxSlots || (tlist != nullptr && lb < 1)) {
    return cudaErrorInvalidValue;
  }
  if (nt == 0) return cudaSuccess;
  rek::ShadeArgs args{rows, s_o, s_t, d_o, d_t, ltab, lcount, cam,
                      ipv, org, sf, sfi, ovr, tlist, tcount, out,
                      nt, k, a, tiles_x, th, tw, n_slots, tb, lb, nl,
                      width, height, ovr_chans, with_norm, with_diss,
                      spec_packed, shin_const, diffuse_floor};
  // room for the most rows a block can stage: the list length or the table
  const size_t smem = rek::staged_bytes(tlist != nullptr ? lb : nl);
  cudaError_t err = rek::allow_smem(rek::fused_shade_kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_chunks = (th * tw + rek::kChunk - 1) / rek::kChunk;
  rek::fused_shade_kernel<<<nt * n_chunks, rek::kBlock, smem, stream>>>(
      args);
  return cudaGetLastError();
}

// Blocks of the kernel that one SM holds at once with room for `n_rows`
// staged light rows in dynamic shared memory (the list length on the list
// route, the table's rows on the dense route): the CUDA occupancy
// calculator's answer for this build's registers and static shared memory,
// or -1 on an error.
extern "C" int fused_shade_blocks_per_sm(int n_rows) {
  const size_t smem = rek::staged_bytes(n_rows);
  if (rek::allow_smem(rek::fused_shade_kernel, smem) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, rek::fused_shade_kernel, rek::kBlock, smem) !=
      cudaSuccess) {
    return -1;
  }
  return blocks;
}
