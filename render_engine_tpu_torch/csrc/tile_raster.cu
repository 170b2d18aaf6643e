// K1: the tile rasterizer.
//
// Replaces render_engine_tpu/render/raster_pallas.py::_tile_kernel (launched
// by _launch). One block walks one screen tile (8x128 by default) and keeps,
// per pixel centre, the nearest depth and its candidate slot in registers
// for one layer, or for the opaque and the transparent layer (kTwoPass, a
// template parameter, so the one-pass mode carries only one layer's state);
// the winner's triangle id is the slot's, read from shared memory at the
// store.
//
// Thread map: each thread owns one column of the tile and up to kMaxPix
// consecutive rows of it (8x128: threads 0-127 rows 0-3, threads 128-255
// rows 4-7), so a warp owns a compact 32x4 rectangle of pixel centres and,
// for each of its rows, stores 32 neighbouring pixels at once.
//
// The block stages the tile's live candidates in shared memory: the (10, K)
// floats, the ids, and a conservative screen box per candidate computed once
// there (skip_box). The three trip counts (opaque window, transparent window,
// global list) are read on the device, so the host never waits on them.
// Candidates are visited in table order and a nearer depth must win with a
// strict <, so the first candidate seen keeps an exact tie: that is the
// reference's contract.
//
// What bounds it on an H100. Before this design, arithmetic: every live
// candidate was tested against all 1,024 pixels of its tile, at 25-30
// instructions a pair, though most of the scene's triangles are a few pixels
// wide. Now each warp takes the candidates 32 at a time, each lane testing
// one candidate's box against the warp's rectangle, and visits in order only
// those whose box meets it (a ballot: one decision per warp, no
// divergence); in a visited candidate a lane whose column misses the box and
// a row whose centre line misses it do nothing. The edge terms that do not
// depend on the row, (bx - ax) and (by - ay) * (px - ax), are formed once
// per candidate and column, and the depth's division runs only for pixels
// that pass the edge test. What remains, on the 1080p frame (PERF.md): the
// outputs, 12 or 24 bytes a pixel (a kernel that only stores them takes 0.78
// of the bound's rate), each block's serial chain of counts, staging and
// box before its loop, at 4 blocks an SM (__launch_bounds__: 64 registers),
// and in the shadow map the busiest tiles (up to 151 candidates, many of
// them large triangles that every warp of the tile must test).
//
// The box is conservative for the rounded, fused edge forms: a pixel centre
// outside it is never "inside", whatever the rounding. For a triangle of
// exact double area A and edge-function rounding errors summing to at most
// E over the tile, an accepted centre has barycentrics >= -E/|A|, so it lies
// within the vertex box grown by (width, height) * E/|A|; the box is grown
// by twice that, rounded outward to float. Slivers (|A| <= 2E), coordinates
// beyond 2^24 and NaN get an unbounded box and are never skipped.
// render_engine_tpu_torch/render/raster_pallas.py::k1_skip_boxes mirrors
// this for the CPU tests.
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

// staged channels per candidate: 0-9 the data rows (x0 y0 x1 y1 x2 y2 z0 z1
// z2 cls), 10-13 the skip box (xlo xhi ylo yhi), 14 the triangle id
constexpr int kCh = 15;
constexpr double kMaxCoord = 16777216.0;  // 2^24: beyond it, never skip

// The conservative box of one candidate for the pixel centres of a tile,
// [pxlo, pxhi] x [pylo, pyhi]; see the note above.
__device__ void skip_box(const float* v, int k, double pxlo, double pxhi,
                         double pylo, double pyhi, float* box) {
  const float inf = __int_as_float(0x7f800000);
  box[0] = -inf;
  box[k] = inf;
  box[2 * k] = -inf;
  box[3 * k] = inf;
  double x[3], y[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    x[i] = v[(2 * i) * k];
    y[i] = v[(2 * i + 1) * k];
    if (!(fabs(x[i]) <= kMaxCoord && fabs(y[i]) <= kMaxCoord)) return;
  }
  const double xmin = fmin(fmin(x[0], x[1]), x[2]);
  const double xmax = fmax(fmax(x[0], x[1]), x[2]);
  const double ymin = fmin(fmin(y[0], y[1]), y[2]);
  const double ymax = fmax(fmax(y[0], y[1]), y[2]);
  double eb = 0.0;
#pragma unroll
  for (int e = 0; e < 3; ++e) {  // edges a -> b: (1, 2), (2, 0), (0, 1)
    const int a = (e + 1) % 3, b = (e + 2) % 3;
    eb = eb + (fabs(x[b] - x[a]) * fmax(fabs(pylo - y[a]), fabs(pyhi - y[a])) +
               fabs(y[b] - y[a]) * fmax(fabs(pxlo - x[a]), fabs(pxhi - x[a])));
  }
  // 3 roundings of 2^-24 each bound one edge's error; 4 for margin, plus an
  // absolute term for results near the subnormal range
  eb = eb * (4.0 * 5.9604644775390625e-08) + 7.888609052210118e-31;
  const double p1 = (x[1] - x[0]) * (y[2] - y[0]);
  const double p2 = (x[2] - x[0]) * (y[1] - y[0]);
  const double area =
      fabs(p1 - p2) - 3.552713678800501e-15 * (fabs(p1) + fabs(p2));
  if (!(area > 2.0 * eb)) return;
  const double s = (2.0 * eb) / area;
  const double mx = (xmax - xmin) * s + 9.5367431640625e-07;
  const double my = (ymax - ymin) * s + 9.5367431640625e-07;
  box[0] = __double2float_rd(xmin - mx);
  box[k] = __double2float_ru(xmax + mx);
  box[2 * k] = __double2float_rd(ymin - my);
  box[3 * k] = __double2float_ru(ymax + my);
}

// 4 blocks an SM: more would spill the two-pass layer state
template <bool kTwoPass>
__global__ void __launch_bounds__(kThreads, 4)
tile_raster_kernel(const float* __restrict__ data, const int* __restrict__ ids,
                   const int* __restrict__ counts, float* __restrict__ d_out,
                   int* __restrict__ w_out, int* __restrict__ s_out,
                   float* __restrict__ td_out, int* __restrict__ tw_out,
                   int* __restrict__ ts_out, int k, int tiles_x, int th,
                   int tw, int tile_budget, int trans_budget) {
  extern __shared__ float smem[];  // (kCh, k)
  float* sbox = smem + 10 * k;
  int* sid = reinterpret_cast<int*>(smem + 14 * k);

  const int t = blockIdx.x;
  const int oy = (t / tiles_x) * th;
  const int ox = (t % tiles_x) * tw;
  const int glob0 = tile_budget + trans_budget;
  const int n0 = min(max(counts[t * 3 + 0], 0), tile_budget);
  const int n1 = min(max(counts[t * 3 + 1], 0), trans_budget);
  const int n2 = min(max(counts[t * 3 + 2], 0), k - glob0);

  const double pxlo = ox + 0.5, pxhi = ox + tw - 0.5;
  const double pylo = oy + 0.5, pyhi = oy + th - 0.5;
  const float* src = data + static_cast<size_t>(t) * 10 * k;
  const int* isrc = ids + static_cast<size_t>(t) * k;
  auto live = [&](int i) {
    return i < n0 || (i >= tile_budget && i < tile_budget + n1) ||
           (i >= glob0 && i < glob0 + n2);
  };
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    if (live(i)) {
#pragma unroll
      for (int c = 0; c < 10; ++c) smem[c * k + i] = src[c * k + i];
      sid[i] = isrc[i];
      skip_box(smem + i, k, pxlo, pxhi, pylo, pyhi, sbox + i);
    }
  }
  __syncthreads();

  // this thread's column and rows (the launcher checks that they cover the
  // tile: tw <= kThreads and ceil(th / (kThreads / tw)) <= kMaxPix)
  const int groups = kThreads / tw;
  const int rows_per = (th + groups - 1) / groups;
  const int col = threadIdx.x % tw;
  const int row0 = (threadIdx.x / tw) * rows_per;
  const int nrows = threadIdx.x < groups * tw
                        ? max(0, min(rows_per, th - row0)) : 0;
  const float px = (static_cast<float>(col) + static_cast<float>(ox)) + 0.5f;
  float py[kMaxPix];
#pragma unroll
  for (int j = 0; j < kMaxPix; ++j) {
    py[j] = (static_cast<float>(row0 + j) + static_cast<float>(oy)) + 0.5f;
  }
  // the warp's rectangle of pixel centres
  const float inf = __int_as_float(0x7f800000);
  float wx0 = nrows ? px : inf, wx1 = nrows ? px : -inf;
  float wy0 = nrows ? py[0] : inf;
  float wy1 = nrows ? (static_cast<float>(row0 + nrows - 1) +
                       static_cast<float>(oy)) + 0.5f
                    : -inf;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    wx0 = fminf(wx0, __shfl_xor_sync(0xffffffffu, wx0, m));
    wx1 = fmaxf(wx1, __shfl_xor_sync(0xffffffffu, wx1, m));
    wy0 = fminf(wy0, __shfl_xor_sync(0xffffffffu, wy0, m));
    wy1 = fmaxf(wy1, __shfl_xor_sync(0xffffffffu, wy1, m));
  }

  // per row: the nearest depth and its candidate slot (the winner's id is
  // the slot's, read back at the store), for one or two layers
  float bd[kMaxPix], btd[kMaxPix];
  int bk[kMaxPix], btk[kMaxPix];
#pragma unroll
  for (int j = 0; j < kMaxPix; ++j) {
    bd[j] = btd[j] = inf;
    bk[j] = btk[j] = -1;
  }

  auto visit = [&](int kk) {
    const float xlo = sbox[kk], xhi = sbox[k + kk];
    const float ylo = sbox[2 * k + kk], yhi = sbox[3 * k + kk];
    const float cls = smem[9 * k + kk];
    if (!(px >= xlo && px <= xhi && cls > 0.0f)) return;
    const float x0 = smem[0 * k + kk], y0 = smem[1 * k + kk];
    const float x1 = smem[2 * k + kk], y1 = smem[3 * k + kk];
    const float x2 = smem[4 * k + kk], y2 = smem[5 * k + kk];
    const float z0 = smem[6 * k + kk], z1 = smem[7 * k + kk];
    const float z2 = smem[8 * k + kk];
    // edge(a, b) = fma(bx - ax, py - ay, -((by - ay) * (px - ax))); the
    // product does not depend on the row
    const float u0 = x2 - x1, q0 = (y2 - y1) * (px - x1);
    const float u1 = x0 - x2, q1 = (y0 - y2) * (px - x2);
    const float u2 = x1 - x0, q2 = (y1 - y0) * (px - x0);
#pragma unroll
    for (int j = 0; j < kMaxPix; ++j) {
      if (j >= nrows || py[j] < ylo || py[j] > yhi) continue;
      const float l0 = __fmaf_rn(u0, py[j] - y1, -q0);
      const float l1 = __fmaf_rn(u1, py[j] - y2, -q1);
      const float l2 = __fmaf_rn(u2, py[j] - y0, -q2);
      const float area = (l0 + l1) + l2;
      const bool inside =
          (((l0 >= 0.0f) && (l1 >= 0.0f) && (l2 >= 0.0f)) ||
           ((l0 <= 0.0f) && (l1 <= 0.0f) && (l2 <= 0.0f))) &&
          fabsf(area) > 1e-9f;
      if (!inside) continue;
      const float d =
          __fmaf_rn(l2, z2, __fmaf_rn(l0, z0, l1 * z1)) * (1.0f / area);
      if (!((d >= -1.0f) && (d <= 1.0f))) continue;
      if (kTwoPass) {
        if (cls < 1.5f && d < bd[j]) {
          bd[j] = d;
          bk[j] = kk;
        }
        if (cls > 1.5f && d < btd[j]) {
          btd[j] = d;
          btk[j] = kk;
        }
      } else if (d < bd[j]) {
        bd[j] = d;
        bk[j] = kk;
      }
    }
  };
  // The warp's candidates in table order (the opaque window, the
  // transparent window, the global list), 32 at a time: each lane tests
  // one candidate's box against the warp's rectangle, and the warp visits
  // the candidates whose box meets it.
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < k; base += 32) {
    const int i = base + lane;
    bool meets = i < k && live(i);
    if (meets) {
      meets = sbox[k + i] >= wx0 && sbox[i] <= wx1 &&
              sbox[3 * k + i] >= wy0 && sbox[2 * k + i] <= wy1;
    }
    for (unsigned m = __ballot_sync(0xffffffffu, meets); m; m &= m - 1) {
      visit(base + __ffs(m) - 1);
    }
  }

  const size_t base = static_cast<size_t>(t) * th * tw;
#pragma unroll
  for (int j = 0; j < kMaxPix; ++j) {
    if (j >= nrows) continue;
    const size_t p = base + static_cast<size_t>(row0 + j) * tw + col;
    const int w = bk[j] >= 0 ? sid[bk[j]] : -1;
    d_out[p] = w >= 0 ? bd[j] : 1.0f;
    w_out[p] = w;
    s_out[p] = bk[j];
    if (kTwoPass) {
      const int tw_id = btk[j] >= 0 ? sid[btk[j]] : -1;
      td_out[p] = tw_id >= 0 ? btd[j] : 1.0f;
      tw_out[p] = tw_id;
      ts_out[p] = btk[j];
    }
  }
}

template <bool kTwoPass>
cudaError_t launch(const float* data, const int* ids, const int* counts,
                   float* d_out, int* w_out, int* s_out, float* td_out,
                   int* tw_out, int* ts_out, int nt, int k, int tiles_x,
                   int th, int tw, int tile_budget, int trans_budget,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(k) * kCh * sizeof(float);
  cudaError_t err = allow_smem(tile_raster_kernel<kTwoPass>, smem);
  if (err != cudaSuccess) return err;
  tile_raster_kernel<kTwoPass><<<nt, kThreads, smem, stream>>>(
      data, ids, counts, d_out, w_out, s_out, td_out, tw_out, ts_out, k,
      tiles_x, th, tw, tile_budget, trans_budget);
  return cudaGetLastError();
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
  if (tw < 1 || th < 1 || tw > rek::kThreads ||
      (th + rek::kThreads / tw - 1) / (rek::kThreads / tw) > rek::kMaxPix) {
    return cudaErrorInvalidValue;
  }
  if (nt == 0) return cudaSuccess;
  return two_pass
             ? rek::launch<true>(data, ids, counts, d_out, w_out, s_out,
                                 td_out, tw_out, ts_out, nt, k, tiles_x, th,
                                 tw, tile_budget, trans_budget, stream)
             : rek::launch<false>(data, ids, counts, d_out, w_out, s_out,
                                  td_out, tw_out, ts_out, nt, k, tiles_x, th,
                                  tw, tile_budget, trans_budget, stream);
}
