#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (render_engine_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own):
  1. build   compile csrc/*.cu (one nvcc per source, in parallel, sm_90a)
             into one library and time it;
  2. kernels run the space scene at 1920x1080 with shadows (1024^2 maps,
             2 slots, an update every 3 frames) to its fourth frame, which
             renders a shadow map with both slots mapped; keep the inputs of
             every K1 call of that frame (the one-pass shadow raster, then
             the two-pass main raster), of K2 (resolve) and of K3 (fused
             shade with the shadow-slot factors), then run each kernel and
             its plain PyTorch version on them on the card: K1 (both modes)
             and K2 must match exactly, K3 within 1e-5; time each;
  3. frame   the same state, shadow maps included, rendered through the
             kernels and through the plain versions must agree (the image
             within 1e-5), and Engine.render() must leave the shadow state
             as it was;
  4. small   the 128x32 / 10-asteroid engine, 4 frames on the card against
             the same frames on the CPU (plain versions), without shadows
             and with them (128^2 maps, 6 slots, an update every frame):
             world columns, camera, every drop counter, the shadow state
             and the image as the CPU parity tests hold them;
  5. slice   build_space_engine at 1920x1080, 10,000 asteroids, capacity
             16384, max_tris 16384, with the demo's shadow defaults; 3
             warm-up and 30 timed frames (torch.cuda.synchronize per frame);
             each frame must launch K1 twice when its update renders a map
             (host tick % 3 == 0) and once otherwise, K2 and K3 once, and
             give a finite (1080,1920,3) image; then all 13 drop counters
             (6 step, 7 render) must be 0. Frames are not recorded here.
  6. replay  frames timed with recording off and on in turns (off, on,
             on, off); then, under torch.use_deterministic_algorithms(True),
             the same engine records 12 frames (rendered, step-only and
             one fused frame without an image, a draw-distance change
             before frame 6, a 2^32-1 seed), flushes the log (timed) and
             loads it; a second full-size engine replays it with each
             frame's live render flag: world hashes, launches per frame and
             the images of the rendered frames must equal the live run's,
             and the shadow state and draw distance at the end too. Then a
             replay with the detached camera (Esc, then W and a mouse
             turn): the same hashes, finite images unlike the live ones;
             then past the end, Up (one live frame, paused) and Right
             (RUN).
  7. lights  the many-lights configuration: 1280x720, 200 asteroids, 256
             point lights made from a seed (radii 40 to 90), 268 light-table
             rows, light_tile_budget 96, two render systems. K1 (both
             modes) and K2 on a frame's inputs against their plain versions
             (exact) and the frame through kernels against plain versions
             (1e-5); K3 with the frame's per-tile light lists against its
             plain version (1e-5) and the loop over every light (equal); the
             frame at budget 96 against budget 0 (torch.equal while
             light_tile_overflow is 0); all 14 drop counters 0; launches a
             frame; times of K3 with lists and dense, of select_tile_lights,
             and ms/frame in turns budget 0, 96, 96, 0.
  8. custom  the 1080p/10k engine again with a fragment-shading function on
             the lit system and a draw callback on the light sources: K2
             over every tile (twice a frame, 531 MB a launch) against its
             plain version (exact) and one torch.gather; the frame through
             kernels against plain versions; pixels the shading system does
             not own equal the frame without it; launches a frame (K2
             three); ms/frame with and without the function in turns; peak
             device memory.
  9. golden  a 256x144 engine with a cubemap skybox: the golden path
             (backend="jnp") against the fused path on the card, and the
             card against the CPU.
  10. configs the benchmark configurations of
             benchmarks/run_benchmarks_torch.py at their full scene size,
             with frame counts cut (the lights configuration is phase 7's):
             scene at 800x600 (7 tile columns, the last one 32 pixels wide:
             K1 in both modes, K2 and K3 on a frame's inputs against their
             plain versions, and the frame through kernels against plain
             versions); asteroids (10,000 under a thrusting patrol,
             collision_large_budget 64: all 13 drop counters 0, a finite
             image); tick (a 100,000-entity world, capacity 131,072: the
             entities alive, the step counters, the host's cost of the
             step's random draws, a rendered frame at max_tris 49152 with
             K1, K2 and K3 against their plain versions, peak device
             memory); playback (300 step frames recorded and replayed bit
             for bit, two steps past the end, 10 recorded 1080p frames).
             Each prints its JSON line.
The last three lines are the kernels' JSON record, the card's name and
power limit (nvidia-smi), and {"ok": true, "device": {...}}.

Each kernel's record carries its bound (render_engine_tpu_torch/
kernel_bounds.py, from the captured inputs) and K2 the time of one
torch.gather computing the same values. The kernels phase also runs
synthetic cases made with numpy from a seed: K1 in both modes on an
adversarial candidate table (exact), K3 with every pixel covered in both
layers and with none covered (1e-5).

    python3 chip_smoke.py --earlier DIR

also builds the kernels of DIR/render_engine_tpu_torch/csrc (an earlier
checkout) and times them on the same captured inputs in turns (earlier,
current, current, earlier); their time goes into the records' earlier_ms,
which is null without the option.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

SLICE = dict(width=1920, height=1080, capacity=16384, num_asteroids=10000,
             max_tris=16384)
SMALL = dict(width=128, height=32, capacity=128, num_asteroids=10,
             max_tris=2048)
WARMUP, TIMED = 3, 30
DT = 1.0 / 60.0
# phase 6: each recorded frame's render flag; frame REPLAY_FUSED_AT
# advances as a fused frame without an image
REPLAY_RENDER = (True, True, False, True, False, True, True, False, True,
                 True, True, True)
REPLAY_FUSED_AT = 4
REPLAY_DRAW_AT, REPLAY_DRAW_DISTANCE = 6, 1200.0
REPLAY_BIG_SEED_AT = 2
RECORD_TURNS, TURN_FRAMES = ("off", "on", "on", "off") * 5, 10
CAPTURE_FRAME = 3  # frames 0 and 3 render maps at interval 3: both slots
# phase 7: the many-lights configuration at its full size
# (demo.space_scene.build_many_lights_engine)
LIGHTS = dict(width=1280, height=720)
N_POINT_LIGHTS, LIGHT_TILE_BUDGET = 256, 96
BUDGET_TURNS = (0, LIGHT_TILE_BUDGET, LIGHT_TILE_BUDGET, 0) * 3
SHADE_TURNS = ("without", "with", "with", "without") * 3
TCOUNT_BINS = (0, 1, 9, 17, 33, 49, 65, 81, 97)
GOLDEN = dict(width=256, height=144, capacity=256, num_asteroids=64,
              max_tris=8192)
# phase 10: frame counts of the benchmark configurations (their scene
# sizes are the benchmark script's own, at scale 1)
CONFIG_FRAMES = dict(scene=10, asteroids=10, tick=10, tick_burst=10,
                     playback=300, playback_recorded=10)
CONFIG_SCALE = 1.0  # the benchmark script's BENCH_SCALE: full size
SCENE_FIXED_ENTITIES = 6  # beside the asteroids: stars, ship, station, ...

KERNELS = {  # record name -> (launch-count key, source, TPU kernel)
    "tile_raster": ("tile_raster",
                    "render_engine_tpu_torch/csrc/tile_raster.cu",
                    "render_engine_tpu/render/raster_pallas.py:37"),
    "tile_raster_one_pass": ("tile_raster_one_pass",
                             "render_engine_tpu_torch/csrc/tile_raster.cu",
                             "render_engine_tpu/render/raster_pallas.py:37"),
    "resolve": ("resolve", "render_engine_tpu_torch/csrc/resolve.cu",
                "render_engine_tpu/render/raster_pallas.py:476"),
    "fused_shade": ("fused_shade",
                    "render_engine_tpu_torch/csrc/fused_shade.cu",
                    "render_engine_tpu/render/shade_pallas.py:249"),
    # K2 over every tile of a layer (phase 8: the K2 launches of its run
    # whose slot planes hold every tile of the frame) and K3 over per-tile
    # light lists (phase 7): their launches come from those phases' runs
    "resolve_full_frame": ("resolve_full_frame",
                           "render_engine_tpu_torch/csrc/resolve.cu",
                           "render_engine_tpu/render/raster_pallas.py:476"),
    "fused_shade_tile_lists": ("fused_shade_tile_lists",
                               "render_engine_tpu_torch/csrc/fused_shade.cu",
                               "render_engine_tpu/render/shade_pallas.py:249"),
}
MAIN_PATH = ("tile_raster", "tile_raster_one_pass", "resolve", "fused_shade")
DROP_KEYS = 13  # 6 step counters and 7 render counters with shadows
DROP_KEYS_LIGHTS = 14  # and light_tile_overflow with a light-list budget
LIVE_BINS = (0, 1, 9, 17, 33, 65, 129, 257)  # K1 live candidates a tile


def log(*a):
    print(*a, flush=True)


def device_ms(fn, reps):
    """The device's ms per call: ``reps`` calls enqueued behind a sleeping
    kernel, so that the host's cost of issuing them is hidden, timed by
    CUDA events; the median of 3 such runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10 ** 7)
    b.record()
    torch.cuda.synchronize()
    cycles_per_ms = 1e7 / a.elapsed_time(b)
    runs = []
    for _ in range(3):
        torch.cuda._sleep(int(cycles_per_ms * (2.0 * reps * host_ms + 1.0)))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        runs.append(a.elapsed_time(b) / reps)
    return statistics.median(runs)


def cuda_ms(fn, reps):
    """Median of ``reps`` single-call times in ms, by CUDA events (the
    host's cost of issuing the call included)."""
    import torch

    fn()  # warm
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs(a, b):
    return max(float((x.double() - y.double()).abs().max()) if x.numel()
               else 0.0 for x, y in zip(a, b))


class Capture:
    """Wrap a module function: keep a copy of every call's arguments (or
    what ``note`` makes of them), then delegate."""

    def __init__(self, module, name, note=None):
        self.module, self.name, self.note = module, name, note
        self.fn = getattr(module, name)
        self.calls = []

    def __call__(self, *args, **kw):
        import torch

        def keep(v):
            return v.clone() if isinstance(v, torch.Tensor) else v
        if self.note is not None:
            self.calls.append(self.note(*args, **kw))
        else:
            self.calls.append(([keep(a) for a in args],
                               {k: keep(v) for k, v in kw.items()}))
        return self.fn(*args, **kw)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


class Plain:
    """Route the three kernel wrappers to their plain PyTorch versions on
    the card (for the whole-frame comparison)."""

    def __enter__(self):
        from render_engine_tpu_torch.render import raster_pallas as RP
        from render_engine_tpu_torch.render import shade_pallas as SP

        self.saved = [(RP, "tile_raster", RP.tile_raster),
                      (RP, "resolve_attributes_pallas",
                       RP.resolve_attributes_pallas),
                      (SP, "shade_tiles", SP.shade_tiles)]
        RP.tile_raster = RP.tile_raster_reference
        RP.resolve_attributes_pallas = (
            lambda slot, rows, cfg=None:
            RP.resolve_attributes_reference(slot, rows))
        SP.shade_tiles = SP.fused_shade_reference
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


class Library:
    """Route the kernel wrappers' launches to another loaded library."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        from render_engine_tpu_torch import kernels

        self.saved = kernels.library()
        kernels._lib = self.lib
        return self

    def __exit__(self, *exc):
        from render_engine_tpu_torch import kernels

        kernels._lib = self.saved


def kernel_ms(name, kern, earlier):
    """The kernel's device ms (see device_ms); with an earlier
    library, in turns earlier, current, current, earlier, and then also the
    earlier kernel's ms (each the mean of its two turns)."""
    if earlier is None:
        return device_ms(kern, 20), None
    turns = []
    for which in ("earlier", "current", "current", "earlier"):
        if which == "earlier":
            with Library(earlier):
                turns.append(device_ms(kern, 20))
        else:
            turns.append(device_ms(kern, 20))
    log(f"[kernels] {name} in turns (earlier, current, current, earlier): "
        f"{', '.join(f'{t:.4f}' for t in turns)} ms")
    return (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2


def live_histogram(counts, k, tile_budget, trans_budget):
    from render_engine_tpu_torch import kernel_bounds as KB

    per_tile = KB.k1_live(counts, k, tile_budget, trans_budget).sum(1)
    bins = [int(((per_tile >= lo) & (per_tile < hi)).sum())
            for lo, hi in zip(LIVE_BINS, LIVE_BINS[1:])]
    return ", ".join(f"[{lo},{hi}): {n}" for lo, hi, n in
                     zip(LIVE_BINS, LIVE_BINS[1:], bins)) + (
        f"; max {int(per_tile.max())}, mean {float(per_tile.double().mean()):.1f}")


def synthetic_k1(two_pass, seed, dev):
    """An adversarial K1 table, 16 x 8 tiles of 8x128 with B = 112, BT = 64
    and a full global list of 32: small triangles, vertices on pixel
    centres, slivers (collinear, and 1e-3 and 1e-6 off; short, and long
    ones starting just past a pixel centre on their line), coordinates up
    to 1e6 and beyond 2^24, NaN coordinates and exact depth ties (a
    candidate repeated under another id); every fourth tile has full
    windows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    tiles_x, tiles_y, th, tw = 16, 8, 8, 128
    bud, tbud, glob = 112, 64, 32
    k, nt = bud + tbud + glob, tiles_x * tiles_y
    ox = ((np.arange(nt) % tiles_x) * tw)[:, None].astype(np.float64)
    oy = ((np.arange(nt) // tiles_x) * th)[:, None].astype(np.float64)
    cx = ox + rng.uniform(-6, tw + 6, (nt, k))
    cy = oy + rng.uniform(-6, th + 6, (nt, k))
    v = np.stack([cx, cy] * 3, axis=1) + rng.uniform(-5, 5, (nt, 6, k))
    kind = rng.integers(0, 8, (nt, k))
    # vertices on pixel centres: edges run through centres
    on = kind == 1
    v = np.where(on[:, None], np.floor(v) + 0.5, v)
    # slivers: the third vertex on (or just off) the first two's line
    sl = kind == 2
    length = rng.uniform(5, 400, (nt, k))
    ang = rng.uniform(0, 2 * np.pi, (nt, k))
    off = rng.choice([0.0, 1e-3, 1e-6], (nt, k))
    ex, ey = np.cos(ang), np.sin(ang)
    bx, by = v[:, 0] + length * ex, v[:, 1] + length * ey
    mx = 0.5 * (v[:, 0] + bx) - off * ey
    my = 0.5 * (v[:, 1] + by) + off * ex
    for i, arr in ((2, bx), (3, by), (4, mx), (5, my)):
        v[:, i] = np.where(sl, arr, v[:, i])
    # long slivers on a line through a pixel centre, starting just past it
    # (the rounded edge test can accept centres beyond the vertex box)
    ls = kind == 7
    px0, py0 = ox + np.floor(cx - ox) + 0.5, oy + np.floor(cy - oy) + 0.5
    start = rng.uniform(0.5, 20, (nt, k))
    far = 10.0 ** rng.uniform(1, 6, (nt, k))
    ax, ay = px0 + start * ex, py0 + start * ey
    long_sliver = (ax, ay, ax + far * ex, ay + far * ey,
                   ax + 0.5 * far * ex - off * far * ey,
                   ay + 0.5 * far * ey + off * far * ex)
    for i, arr in enumerate(long_sliver):
        v[:, i] = np.where(ls, arr, v[:, i])
    # huge coordinates: one vertex far away, up to 1e6 or beyond 2^24
    for kd, scale in ((3, 1e6), (4, 4e7)):
        far = kind == kd
        which = rng.integers(0, 3, (nt, k))
        for c in range(3):
            m = far & (which == c)
            v[:, 2 * c] = np.where(m, rng.uniform(-scale, scale, (nt, k)),
                                   v[:, 2 * c])
            v[:, 2 * c + 1] = np.where(m, rng.uniform(-scale, scale,
                                                      (nt, k)), v[:, 2 * c + 1])
    z = rng.uniform(-1.2, 1.2, (nt, 3, k))
    cls = (rng.integers(1, 3, (nt, k)) if two_pass
           else np.ones((nt, k))).astype(np.float64)
    cls[rng.random((nt, k)) < 0.05] = 0.0
    data = np.concatenate([v, z, cls[:, None]], axis=1).astype(np.float32)
    nan = kind == 5
    data[:, 0][nan] = np.nan
    ids = (np.arange(nt)[:, None] * k + np.arange(k)[None]).astype(np.int32)
    # exact ties: a candidate repeats its predecessor under another id
    tie = kind == 6
    tie[:, 0] = False
    src = np.where(tie, np.arange(k)[None] - 1, np.arange(k)[None])
    data = np.take_along_axis(data, src[:, None, :], axis=2)
    # the global list: the same 32 big triangles in every tile
    g = rng.uniform([-600, -300] * 3, [2648, 364] * 3, (glob, 6)).T
    data[:, :6, bud + tbud:] = g[None].astype(np.float32)
    data[:, 6:9, bud + tbud:] = rng.uniform(-1.2, 1.2, (3, glob))[None]
    data[:, 9, bud + tbud:] = 1.0
    ids[:, bud + tbud:] = nt * k + np.arange(glob)
    n0 = np.where(np.arange(nt) % 4 == 0, bud, rng.integers(0, bud + 1, nt))
    n1 = (np.where(np.arange(nt) % 4 == 0, tbud,
                   rng.integers(0, tbud + 1, nt)) if two_pass
          else np.zeros(nt, np.int64))
    counts = np.stack([n0, n1, np.full(nt, glob)], axis=1)[:, None, :]
    args = [torch.from_numpy(data).to(dev),
            torch.from_numpy(ids[:, None, :].copy()).to(dev),
            torch.from_numpy(counts.astype(np.int32)).to(dev)]
    kw = dict(tiles_x=tiles_x, tile_h=th, tile_w=tw, tile_budget=bud,
              trans_budget=tbud, two_pass=two_pass)
    return args, kw


def synthetic_k3(a3, kw3, covered, seed):
    """K3 on the captured frame's lights, camera, overrides and slot
    factors, with every pixel covered in both layers (random slots, depths
    in [-0.99, 0.99]) or none. Each tile's rows are attribute rows that
    covered pixels of the frame referenced, moved onto one triangle that
    encloses the tile, so every pixel's barycentrics stay in [0, 1]."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    rows, s_o, s_t, d_o, d_t, *rest = a3
    nt, k, _ = rows.shape
    th, tw = s_o.shape[1], s_o.shape[2]
    dev = rows.device
    cov = s_o >= 0
    t_idx = torch.arange(nt, device=dev)[:, None, None].expand_as(s_o)[cov]
    good = rows[t_idx, s_o[cov].long()]
    pick = torch.from_numpy(rng.integers(0, good.shape[0], (nt, k))).to(dev)
    syn = good[pick].clone()
    tids = torch.arange(nt, device=dev)
    ox = ((tids % kw3["tiles_x"]) * tw).float()[:, None]
    oy = (torch.div(tids, kw3["tiles_x"], rounding_mode="floor")
          * th).float()[:, None]
    jit = torch.from_numpy(rng.uniform(0, 50, (nt, k, 6))).float().to(dev)
    syn[:, :, 0] = ox - 200 - jit[..., 0]
    syn[:, :, 1] = oy - 200 - jit[..., 1]
    syn[:, :, 2] = ox + 3 * tw + 400 + jit[..., 2]
    syn[:, :, 3] = oy - 200 - jit[..., 3]
    syn[:, :, 4] = ox - 200 - jit[..., 4]
    syn[:, :, 5] = oy + 3 * th + 400 + jit[..., 5]
    shape = (nt, th, tw)
    if covered:
        so = torch.from_numpy(rng.integers(0, k, shape).astype(np.int32))
        st = torch.from_numpy(rng.integers(0, k, shape).astype(np.int32))
        do = torch.from_numpy(rng.uniform(-0.99, 0.99, shape)).float()
        dt = torch.from_numpy(rng.uniform(-0.99, 0.99, shape)).float()
    else:
        so = st = torch.full(shape, -1, dtype=torch.int32)
        do = dt = torch.ones(shape)
    return ([syn.contiguous(), so.to(dev), st.to(dev), do.to(dev),
             dt.to(dev), *rest], kw3)


def k2_gather(slot, rows):
    """K2's values from one torch.gather: rows with one zero row appended,
    channels leading, empty slots pointed at the zero row (the index is
    built here, outside the timed call)."""
    import torch

    tb, th, tw = slot.shape
    _, k, a = rows.shape
    table = torch.cat([rows, rows.new_zeros(tb, 1, a)], dim=1).permute(
        2, 0, 1).contiguous()  # (A, TB, K + 1)
    flat = slot.reshape(tb, th * tw).long()
    idx = torch.where((flat >= 0) & (flat < k), flat, k)[None].expand(
        a, tb, th * tw).contiguous()
    return lambda: [torch.gather(table, 2, idx).reshape(a, tb, th, tw)]


def kernel_record(name, tol, kern, plain, work, library=None, earlier=None,
                  plain_reps=3):
    """One kernel on captured inputs against its plain version (``tol`` 0:
    exact): its device ms (in turns with an ``earlier`` library's), the
    plain version's and the library call's, its bound and share."""
    import torch

    from render_engine_tpu_torch import kernel_bounds as KB

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = check_close(name, got, want, tol)
    ms, earlier_ms = kernel_ms(name, kern, earlier)
    call_ms = cuda_ms(kern, 20)
    plain_ms = cuda_ms(plain, plain_reps)
    library_ms = None
    if library is not None:
        check_close(f"{name} (torch.gather)", library(), want, 0.0)
        library_ms = device_ms(library, 20)
    bound_ms, bound_by = KB.bound(work["bytes"], work["ops"])
    log(f"[kernels] {name}: max_abs_err {err:.3g} (tolerance {tol}) "
        f"kernel {ms:.4f} ms (one call with its host cost "
        f"{call_ms:.4f} ms), plain {plain_ms:.3f} ms"
        + ("" if library_ms is None else f", torch.gather "
           f"{library_ms:.4f} ms")
        + ("" if earlier_ms is None else f", earlier {earlier_ms:.4f} ms")
        + f"; bound {bound_ms:.4f} ms by {bound_by} ({work}), share "
        f"{bound_ms / ms:.3f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / ms, library_ms=library_ms,
                earlier_ms=earlier_ms)


def phase_build():
    from render_engine_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build(verbose=True)
    kernels.library()
    log(f"[build] nvcc {' '.join(kernels.NVCC_FLAGS)}: "
        f"{time.perf_counter() - t0:.1f} s")


def phase_kernels(eng, earlier=None):
    """Frames 0-2, then frame 3 with every kernel call's inputs captured;
    each kernel against its plain version on those inputs, its bound and
    (K2) its one-call yardstick; then the synthetic cases. Returns
    per-kernel records."""
    import torch

    from render_engine_tpu_torch import kernel_bounds as KB
    from render_engine_tpu_torch.render import raster_pallas as RP
    from render_engine_tpu_torch.render import shade_pallas as SP

    for _ in range(CAPTURE_FRAME):
        eng.frame(None, DT)
    with Capture(RP, "tile_raster") as k1, \
            Capture(RP, "resolve_attributes_pallas") as k2, \
            Capture(SP, "shade_tiles") as k3:
        img = eng.frame(None, DT)
        torch.cuda.synchronize()
    if tuple(img.shape) != (SLICE["height"], SLICE["width"], 3):
        raise RuntimeError(f"frame {CAPTURE_FRAME} has shape "
                           f"{tuple(img.shape)}")
    modes = [kw["two_pass"] for _, kw in k1.calls]
    if modes != [False, True] or len(k2.calls) < 1 or len(k3.calls) != 1:
        raise RuntimeError(
            f"frame {CAPTURE_FRAME} made K1 calls with two_pass {modes}, "
            f"{len(k2.calls)} K2 and {len(k3.calls)} K3 calls; expected the "
            "shadow raster, the main raster, K2 and one K3")
    (a1s, kw1s), (a1, kw1) = k1.calls
    a2, _ = k2.calls[0]
    a3, kw3 = k3.calls[0]
    sh = eng.shadow_state
    log(f"[kernels] frame {CAPTURE_FRAME}: shadow slots "
        f"{sh.slot_entity.tolist()}, faces {sh.slot_face.tolist()}, tick "
        f"{sh.tick}, cursor {sh.cursor}")
    if kw3["sf"] is None or int((kw3["sfi"] >= 0).sum()) == 0:
        raise RuntimeError("K3 got no shadow-slot factor tiles")
    if int((sh.slot_entity >= 0).sum()) != 2:
        raise RuntimeError("both shadow slots should be mapped")
    for name, (a, kw) in (("K1 one-pass", (a1s, kw1s)), ("K1", (a1, kw1))):
        log(f"[kernels] {name} inputs: data {tuple(a[0].shape)}, counts max "
            f"{a[2][:, 0].max(0).values.tolist()}, two_pass "
            f"{kw['two_pass']}; live candidates a tile: "
            + live_histogram(a[2], a[0].shape[2], kw["tile_budget"],
                             kw["trans_budget"]))
    log(f"[kernels] K2 inputs: slot {tuple(a2[0].shape)}, rows "
        f"{tuple(a2[1].shape)}")
    log(f"[kernels] K3 inputs: rows {tuple(a3[0].shape)}, ltab "
        f"{tuple(a3[5].shape)}, overrides "
        f"{None if kw3['ovr'] is None else tuple(kw3['ovr'].shape)}, slot "
        f"factors {tuple(kw3['sf'].shape)}, inverse map "
        f"{tuple(kw3['sfi'].shape)} with {int((kw3['sfi'] >= 0).sum())} "
        "mapped tiles")

    # name, tolerance, kernel, plain version, work, one-call yardstick
    cases = [
        ("tile_raster_one_pass", 0.0,
         lambda: RP.tile_raster(*a1s, **kw1s),
         lambda: RP.tile_raster_reference(*a1s, **kw1s),
         KB.tile_raster_work(*a1s, **kw1s), None),
        ("tile_raster", 0.0,
         lambda: RP.tile_raster(*a1, **kw1),
         lambda: RP.tile_raster_reference(*a1, **kw1),
         KB.tile_raster_work(*a1, **kw1), None),
        ("resolve", 0.0,
         lambda: [RP.resolve_attributes_pallas(*a2)],
         lambda: [RP.resolve_attributes_reference(*a2)],
         KB.resolve_work(*a2), k2_gather(*a2)),
        ("fused_shade", 1e-5,
         lambda: [SP.shade_tiles(*a3, **kw3)],
         lambda: [SP.fused_shade_reference(*a3, **kw3)],
         KB.fused_shade_work(*a3, **kw3), None),
    ]
    rec = {name: kernel_record(name, tol, kern, plain, work, library,
                               earlier=earlier)
           for name, tol, kern, plain, work, library in cases}

    synthetic = [(f"synthetic K1 two_pass={tp}", 0.0, *synthetic_k1(tp, 3 + tp, a1[0].device),
                  RP.tile_raster, RP.tile_raster_reference)
                 for tp in (False, True)]
    synthetic += [(f"synthetic K3 {'all' if c else 'none'} covered", 1e-5,
                   *synthetic_k3(a3, kw3, c, 5), lambda *a, **kw: [
                       SP.shade_tiles(*a, **kw)],
                   lambda *a, **kw: [SP.fused_shade_reference(*a, **kw)])
                  for c in (True, False)]
    for name, tol, args, kw, kern, plain in synthetic:
        got, want = kern(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        err = check_close(name, got, want, tol)
        log(f"[kernels] {name}: max_abs_err {err:.3g} (tolerance {tol}), "
            f"kernel {device_ms(lambda: kern(*args, **kw), 5):.4f} ms")
    return rec


def check_close(name, got, want, tol):
    """Max abs error; raise unless equal (tol 0) or within rtol = atol =
    tol."""
    import torch

    err = max_abs(got, want)
    if tol == 0.0:
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
    else:
        ok = all(torch.allclose(g, w, rtol=tol, atol=tol)
                 for g, w in zip(got, want))
    if not ok:
        raise RuntimeError(f"{name} disagrees with its plain version "
                           f"(max abs err {err})")
    return err


def phase_frame(eng):
    """The current state, shadow maps included, rendered through the
    kernels and through the plain versions; render() must not touch the
    shadow state."""
    import torch

    sh = eng.shadow_state
    maps = sh.maps.clone()
    img_k = eng.render()
    with Plain():
        img_p = eng.render()
    torch.cuda.synchronize()
    if eng.shadow_state is not sh or not torch.equal(sh.maps, maps):
        raise RuntimeError("Engine.render() moved the shadow state")
    err = float((img_k - img_p).abs().max())
    log(f"[frame] kernels vs plain versions, whole 1080p frame with shadows "
        f"(tick {sh.tick}, cursor {sh.cursor}): max abs diff {err:.3g}")
    if not err <= 1e-5:
        raise RuntimeError(f"frame through the kernels differs by {err}")


def _same_shadow_state(i, sc, sg):
    """The CPU and card shadow states: schedule exactly, light matrices
    within 1e-5 and maps within the stated tolerance."""
    import torch

    for name in ("slot_entity", "slot_face"):
        if not torch.equal(getattr(sc, name), getattr(sg, name).cpu()):
            raise RuntimeError(f"small frame {i}: shadow {name} differs")
    if (sc.cursor, sc.tick) != (sg.cursor, sg.tick):
        raise RuntimeError(f"small frame {i}: shadow cursor/tick differ")
    if not torch.allclose(sg.light_mats.cpu(), sc.light_mats, rtol=1e-5,
                          atol=1e-5):
        raise RuntimeError(f"small frame {i}: light matrices differ")
    # maps: K1 is exact on equal inputs, but the light camera's last bits
    # differ between the CPU and the card (trig, 4x4 products), and CUDA's
    # "/ 3.0" in the binning's depth bucket multiplies by the reciprocal:
    # a triangle edge can cross a texel center, or an overflowing tile
    # window can keep another far candidate. So at most 0.5% of texels may
    # differ by more than 1e-5.
    far = ((sg.maps.cpu() - sc.maps).abs() > 1e-5).double().mean()
    log(f"[small] frame {i}: shadow maps, share of texels differing by more "
        f"than 1e-5: {float(far):.4%}")
    if float(far) > 5e-3:
        raise RuntimeError(f"small frame {i}: shadow maps differ")


def frame_inputs(i):
    """Frame i's inputs: idle, then W, then W with a mouse turn."""
    import numpy as np

    from render_engine_tpu_torch.logic.types import KEY_W, InputState

    inp = InputState.idle(i)
    if i == 1:
        return inp.with_keys(KEY_W)
    if i >= 2:
        return dataclasses.replace(
            inp.with_keys(KEY_W),
            mouse_delta=np.array([0.02, -0.01], np.float32))
    return inp


def phase_small():
    """4 frames of the small engine on the card against the CPU, without
    and with shadows."""
    import torch

    from render_engine_tpu_torch.demo.space_scene import build_space_engine
    from render_engine_tpu_torch.render.frame import to_srgb_u8

    for shadows in (False, True):
        tag = "with shadows" if shadows else "no shadows"
        engines = {d: build_space_engine(device=d, enable_shadows=shadows,
                                         **SMALL)
                   for d in ("cpu", "cuda")}
        for i in range(4):
            inp = frame_inputs(i)
            imgs = {d: e.frame(inp, DT).cpu() for d, e in engines.items()}
            wc, wg = engines["cpu"].world, engines["cuda"].world
            if not torch.equal(wc.alive, wg.alive.cpu()):
                raise RuntimeError(f"small frame {i}: alive differs")
            for name in ("type_id", "model_id", "flags"):
                if not torch.equal(wc[name], wg[name].cpu()):
                    raise RuntimeError(f"small frame {i}: {name} differs")
            for name in ("position", "velocity", "orientation", "aabb_min",
                         "aabb_max"):
                if not torch.allclose(wg[name].cpu(), wc[name], rtol=1e-5,
                                      atol=1e-4):
                    raise RuntimeError(f"small frame {i}: {name} differs")
            cams = [e.camera.serialize().cpu() for e in engines.values()]
            if not torch.allclose(cams[0], cams[1], rtol=1e-5, atol=1e-5):
                raise RuntimeError(f"small frame {i}: camera differs")
            drops = [e.drop_stats() for e in engines.values()]
            if drops[0] != drops[1]:
                raise RuntimeError(f"small frame {i}: drop counters {drops}")
            if shadows:
                if len(drops[0]) != DROP_KEYS:
                    raise RuntimeError(f"small frame {i}: {len(drops[0])} "
                                       f"drop counters, expected {DROP_KEYS}")
                _same_shadow_state(i, engines["cpu"].shadow_state,
                                   engines["cuda"].shadow_state)
            diff = float((imgs["cpu"] - imgs["cuda"]).abs().max())
            u8 = float((to_srgb_u8(imgs["cpu"]) != to_srgb_u8(imgs["cuda"]))
                       .double().mean())
            log(f"[small] {tag}, frame {i}: image max abs diff {diff:.3g}, "
                f"u8 values differing {u8:.2%}")
            if not (diff <= 2.0 / 255.0 and u8 <= 1e-3):
                raise RuntimeError(f"small frame {i}: image differs")
        log(f"[small] {tag}: 4 frames agree, drop counters "
            f"{engines['cuda'].drop_stats()}")


def phase_slice(eng):
    """Warm-up and timed frames of the full slice with shadows; launch
    counts per frame; the 13 drop counters."""
    import torch

    from render_engine_tpu_torch import kernels

    eng.reset()
    interval = eng.config.shadow_update_interval
    kernels.reset_launch_counts()
    times = []
    img = None
    shadow_frames = 0
    for i in range(WARMUP + TIMED):
        before = dict(kernels.LAUNCHES)
        renders_map = eng.shadow_state.tick % interval == 0
        shadow_frames += renders_map
        t0 = time.perf_counter()
        img = eng.frame(None, DT)
        torch.cuda.synchronize()
        if i >= WARMUP:
            times.append((time.perf_counter() - t0) * 1e3)
        per_frame = {k: n - before[k] for k, n in kernels.LAUNCHES.items()}
        want = frame_launches(renders_map)
        if per_frame != want:
            raise RuntimeError(f"frame {i} launched {per_frame}, expected "
                               f"{want}")
    launches = dict(kernels.LAUNCHES)
    frames = WARMUP + TIMED
    log(f"[slice] launches in {frames} frames: {launches} ({shadow_frames} "
        f"frames render a shadow map: K1 twice on those, once on the rest; "
        "K2 and K3 once a frame)")
    if tuple(img.shape) != (SLICE["height"], SLICE["width"], 3):
        raise RuntimeError(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("image has non-finite values")
    lit = float((img.amax(dim=-1) > 0.05).double().mean())
    log(f"[slice] image {tuple(img.shape)}, max {float(img.max()):.3f}, "
        f"share of pixels above 0.05: {lit:.3f}")
    # space is black: the asteroids, stars and station light about 0.7%
    # of the 1080p frame
    if not (float(img.max()) > 0.5 and lit > 1e-3):
        raise RuntimeError("the image is (nearly) blank")
    med = statistics.median(times)
    log(f"[slice] {TIMED} timed frames: median {med:.2f} ms/frame, min "
        f"{min(times):.2f}, max {max(times):.2f} "
        f"({1e3 / med:.1f} frames/s)")
    drops = eng.drop_stats()
    log(f"[slice] drop counters ({len(drops)}): {drops}")
    if len(drops) != DROP_KEYS or any(drops.values()):
        raise RuntimeError(f"expected {DROP_KEYS} drop counters, all 0")
    return launches


def frame_launches(renders_map, resolve=1, tile_lists=0):
    """The launches one frame must make: K1 twice when it renders a shadow
    map and once otherwise, K2 ``resolve`` times, K3 once (``tile_lists``:
    1 when it loops over lists)."""
    return {"tile_raster": 1 + int(renders_map),
            "tile_raster_one_pass": int(renders_map), "resolve": resolve,
            "fused_shade": 1, "fused_shade_tile_lists": tile_lists}


def hold_kernels(eng, label, k3=False):
    """One more frame of ``eng``, which must render a shadow map, with
    every kernel call's inputs captured: K1 in both modes and K2 (the
    frame's first call) against their plain versions at this path's
    shapes, exact; with ``k3`` also K3 within 1e-5. Returns the frame."""
    import torch

    from render_engine_tpu_torch.render import raster_pallas as RP
    from render_engine_tpu_torch.render import shade_pallas as SP

    with Capture(RP, "tile_raster") as k1, \
            Capture(RP, "resolve_attributes_pallas") as k2, \
            Capture(SP, "shade_tiles") as k3c:
        img = eng.frame(None, DT)
    modes = [kw["two_pass"] for _, kw in k1.calls]
    if modes != [False, True] or len(k2.calls) != 1 or len(k3c.calls) != 1:
        raise RuntimeError(f"{label}: K1 calls with two_pass {modes}, "
                           f"{len(k2.calls)} K2 calls, {len(k3c.calls)} K3 "
                           "calls")
    for (a, kw), name in zip(k1.calls, ("K1 one-pass", "K1")):
        err = check_close(f"{label} {name}", RP.tile_raster(*a, **kw),
                          RP.tile_raster_reference(*a, **kw), 0.0)
        log(f"[{label}] {name} on this frame's inputs (data "
            f"{tuple(a[0].shape)}, tile_budget {kw['tile_budget']}, "
            f"trans_budget {kw['trans_budget']}): max_abs_err {err:.3g} "
            "(exact)")
    a2 = k2.calls[0][0]
    err = check_close(f"{label} K2", [RP.resolve_attributes_pallas(*a2)],
                      [RP.resolve_attributes_reference(*a2)], 0.0)
    log(f"[{label}] K2 on this frame's inputs (slot {tuple(a2[0].shape)}, "
        f"rows {tuple(a2[1].shape)}): max_abs_err {err:.3g} (exact)")
    if k3:
        a3, kw3 = k3c.calls[0]
        err = check_close(f"{label} K3", [SP.shade_tiles(*a3, **kw3)],
                          [SP.fused_shade_reference(*a3, **kw3)], 1e-5)
        covered = int((a3[1] >= 0).sum()) + int((a3[2] >= 0).sum())
        log(f"[{label}] K3 on this frame's inputs (rows "
            f"{tuple(a3[0].shape)}, {covered} covered items, slot factors "
            f"{None if kw3['sf'] is None else tuple(kw3['sf'].shape)}): "
            f"max_abs_err {err:.3g} (tolerance 1e-05)")
    torch.cuda.synchronize()
    return img


def frame_through_plain(eng, label, what):
    """The current state through the kernels and through the plain
    versions: the images within 1e-5."""
    import torch

    img_k = eng.render()
    with Plain():
        img_p = eng.render()
    torch.cuda.synchronize()
    err = float((img_k - img_p).abs().max())
    log(f"[{label}] kernels vs plain versions, {what}: max abs diff "
        f"{err:.3g}")
    if not err <= 1e-5:
        raise RuntimeError(f"{label}: the frame through the kernels differs "
                           f"by {err}")
    return img_k


def launch_delta(before):
    from render_engine_tpu_torch import kernels

    return {k: n - before[k] for k, n in kernels.LAUNCHES.items()}


def timed_frame(fn):
    """fn() and its ms, synchronized."""
    from render_engine_tpu_torch.runtime.profiling import timed

    return timed(fn)


def turn_medians(eng, turns, start, label, what=""):
    """Median ms/frame of TURN_FRAMES rendered frames a turn, each turn
    begun by ``start(which)`` (which resets the engine into that kind);
    per kind the median of its turn medians."""
    from render_engine_tpu_torch.runtime.profiling import turn_medians as tm

    return tm(lambda: eng.frame(None, DT), turns, start, frames=TURN_FRAMES,
              log=log, label=label, what=what)[0]


def record_turns(eng):
    """ms/frame with recording off and on, in RECORD_TURNS order."""
    def start(which):
        eng.config.record_history = which == "on"
        eng.reset()

    turns = turn_medians(eng, RECORD_TURNS, start, "replay", "recording ")
    eng.config.record_history = False
    return turns


def record_live(eng):
    """Record the REPLAY_RENDER frames on ``eng`` from a reset; flush and
    load the log. Returns the log, each frame's hash, launches and image,
    the frames' ms, the flush ms and the npz size."""
    import tempfile

    from render_engine_tpu_torch import kernels
    from render_engine_tpu_torch.runtime.history import HistoryLog
    from render_engine_tpu_torch.utils.hashing import world_hash

    eng.config.record_history = True
    eng.reset()
    live, live_ms = [], []
    kernels.reset_launch_counts()
    for i, render in enumerate(REPLAY_RENDER):
        if i == REPLAY_DRAW_AT:
            eng.set_draw_distances(draw_distance=REPLAY_DRAW_DISTANCE)
        inp = frame_inputs(i)
        if i == REPLAY_BIG_SEED_AT:
            inp = dataclasses.replace(inp, rng_seed=2**32 - 1)
        before = dict(kernels.LAUNCHES)
        img, ms = timed_frame(lambda: eng.frame(
            inp, DT, render=render,
            advance="fused" if i == REPLAY_FUSED_AT else None))
        live_ms.append(ms)
        live.append(dict(hash=world_hash(eng.world),
                         launches=launch_delta(before), img=img))
    with tempfile.TemporaryDirectory() as d:
        eng.config.history_dir = d
        path, flush_ms = timed_frame(eng.flush_history)
        size = os.path.getsize(path)
        history = HistoryLog.load(d)
    eng.config.record_history = False
    log(f"[replay] live: {len(REPLAY_RENDER)} frames (render "
        f"{''.join('TF'[not r] for r in REPLAY_RENDER)}, frame "
        f"{REPLAY_FUSED_AT} fused without an image), launches "
        f"{dict(kernels.LAUNCHES)}; flush of the {eng.config.capacity}-row "
        f"baseline {flush_ms:.1f} ms, npz {size} bytes")
    if history.num_frames != len(REPLAY_RENDER):
        raise RuntimeError(f"the log holds {history.num_frames} frames")
    return history, live, live_ms, flush_ms, size


def replay_checked(eng, eng2, history, live):
    """Replay ``history`` on ``eng2`` with each frame's live render flag;
    hashes, launches and images must equal the live frames', and the
    shadow state and draw distance ``eng``'s at the end. Returns the
    launches and each frame's ms."""
    import torch

    from render_engine_tpu_torch import kernels
    from render_engine_tpu_torch.runtime.replay import Player
    from render_engine_tpu_torch.utils.hashing import world_hash

    kernels.reset_launch_counts()
    player = Player(eng2, history)
    replay_ms = []
    for i, render in enumerate(REPLAY_RENDER):
        before = dict(kernels.LAUNCHES)
        (img, _), ms = timed_frame(lambda: player.step(render=render))
        replay_ms.append(ms)
        got, want = launch_delta(before), live[i]
        if world_hash(eng2.world) != want["hash"]:
            raise RuntimeError(f"replayed frame {i}: world hash differs")
        if got != want["launches"]:
            raise RuntimeError(f"replayed frame {i} launched {got}, live "
                               f"{want['launches']}")
        if (img is None) != (want["img"] is None) or (
                img is not None and not torch.equal(img, want["img"])):
            raise RuntimeError(f"replayed frame {i}: image differs")
    launches = dict(kernels.LAUNCHES)
    a, b = eng.shadow_state, eng2.shadow_state
    if not (all(torch.equal(getattr(a, n), getattr(b, n)) for n in
                ("maps", "light_mats", "slot_entity", "slot_face"))
            and (a.cursor, a.tick) == (b.cursor, b.tick)):
        raise RuntimeError("replay: shadow state differs at the end")
    if eng2.camera.draw_distance != REPLAY_DRAW_DISTANCE:
        raise RuntimeError("replay: the draw-distance change was lost")
    missing = [k for k in MAIN_PATH if launches[k] == 0]
    if missing:
        raise RuntimeError(f"replay launched no {missing}")
    log(f"[replay] {len(REPLAY_RENDER)} replayed frames: world hashes, "
        "launches per frame and the rendered images equal the live run's "
        "(torch.equal), shadow state equal, draw distance "
        f"{eng2.camera.draw_distance}; launches {launches}")
    return launches, replay_ms


def replay_detached(eng2, history, live):
    """Replay again from a reset with the detached camera (Esc, then W and
    a mouse turn), then past the end: Up, then Right."""
    import numpy as np
    import torch

    from render_engine_tpu_torch.logic.types import (KEY_ESC, KEY_RIGHT,
                                                     KEY_UP, KEY_W,
                                                     InputState)
    from render_engine_tpu_torch.runtime.replay import PlaybackMode, Player
    from render_engine_tpu_torch.utils.hashing import world_hash

    eng2.reset()
    player = Player(eng2, history)
    for i in range(len(REPLAY_RENDER)):
        controls = InputState.idle(i).with_keys(KEY_ESC)
        if i:
            controls = dataclasses.replace(
                InputState.idle(i).with_keys(KEY_W),
                mouse_delta=np.array([0.03, 0.0], np.float32))
        img, _ = player.step(controls, render=True)
        if world_hash(eng2.world) != live[i]["hash"]:
            raise RuntimeError(f"detached replay frame {i}: world hash "
                               "differs")
        if tuple(img.shape) != (SLICE["height"], SLICE["width"], 3) or \
                not bool(torch.isfinite(img).all()):
            raise RuntimeError(f"detached replay frame {i}: image")
        if i >= 1 and live[i]["img"] is not None and torch.equal(
                img, live[i]["img"]):
            raise RuntimeError(f"detached replay frame {i}: the image is "
                               "the recorded camera's")
    if player.mode != PlaybackMode.DEBUG_CUSTOM_MOVEMENT:
        raise RuntimeError(f"detached replay ended in {player.mode}")
    moved = float((player.detached_camera.position
                   - eng2.camera.position).norm())
    log("[replay] detached camera: world hashes equal the live run's, "
        f"finite images unlike the live ones; camera {moved:.3f} units from "
        "the recorded one")

    player.step(render=False)
    if player.mode != PlaybackMode.ONE_PAST_LAST_FRAME:
        raise RuntimeError(f"past the end: {player.mode}")
    h0 = world_hash(eng2.world)
    player.step(InputState.idle(100).with_keys(KEY_UP), render=True)
    if player.mode != PlaybackMode.ONE_PAST_LAST_PAUSE or \
            world_hash(eng2.world) == h0:
        raise RuntimeError("Up past the end did not step one frame")
    player.step(InputState.idle(101).with_keys(KEY_RIGHT), render=True)
    if player.mode != PlaybackMode.RUN:
        raise RuntimeError(f"Right did not resume: {player.mode}")
    log("[replay] past the end: ONE_PAST_LAST_FRAME, Up stepped one live "
        "frame (ONE_PAST_LAST_PAUSE), Right resumed RUN")


def phase_replay(eng):
    """Recording off and on in turns; then, under deterministic
    algorithms, record on ``eng``, replay on a second engine, replay with
    the detached camera and step past the end. Returns the launches of the
    checked replay."""
    import torch

    from render_engine_tpu_torch.demo.space_scene import build_space_engine

    turns = record_turns(eng)
    torch.use_deterministic_algorithms(True)
    try:
        history, live, live_ms, flush_ms, size = record_live(eng)
        eng2 = build_space_engine(device="cuda", **SLICE)
        eng2.config.record_history = False
        launches, replay_ms = replay_checked(eng, eng2, history, live)
        replay_detached(eng2, history, live)
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"[replay] deterministic algorithms on: live median "
        f"{statistics.median(live_ms):.2f} ms/frame, replay median "
        f"{statistics.median(replay_ms):.2f} ms/frame (per frame: live "
        f"{', '.join(f'{t:.1f}' for t in live_ms)}; replay "
        f"{', '.join(f'{t:.1f}' for t in replay_ms)})")
    log(json.dumps({"replay": {
        "ms_per_frame_record_off": turns["off"],
        "ms_per_frame_record_on": turns["on"],
        "flush_ms": flush_ms, "npz_bytes": size,
        "live_ms_per_frame_deterministic": statistics.median(live_ms),
        "replay_ms_per_frame_deterministic": statistics.median(replay_ms),
        "frames": len(REPLAY_RENDER)}}))
    return launches


def build_lights_engine():
    """The many-lights engine at its full size: 720p, 200 asteroids, 256
    seeded point lights, 268 light-table rows, two render systems."""
    from render_engine_tpu_torch.demo.space_scene import (
        build_many_lights_engine)

    eng = build_many_lights_engine(device="cuda", n_lights=N_POINT_LIGHTS,
                                   light_tile_budget=LIGHT_TILE_BUDGET,
                                   **LIGHTS)
    if len(eng.compiled_systems.names) != 2:
        raise RuntimeError(f"render systems {eng.compiled_systems.names}")
    return eng


def phase_lights():
    """K3's tile-list branch on the many-lights frame. Returns the kernel
    record and the launches of the path's counted run."""
    import torch

    from render_engine_tpu_torch import kernel_bounds as KB
    from render_engine_tpu_torch import kernels
    from render_engine_tpu_torch.render import frame as F
    from render_engine_tpu_torch.render import raster_pallas as RP
    from render_engine_tpu_torch.render import shade_pallas as SP

    t0 = time.perf_counter()
    eng = build_lights_engine()
    listed = eng.config.render
    dense = dataclasses.replace(listed, light_tile_budget=0)
    log(f"[lights] engine built in {time.perf_counter() - t0:.1f} s: "
        f"{LIGHTS}, {N_POINT_LIGHTS} point lights, light_tile_budget "
        f"{LIGHT_TILE_BUDGET}, systems {eng.compiled_systems.names}")

    def set_budget(budget):
        eng.config.render = listed if budget else dense

    def start_turn(budget):
        eng.reset()  # restores the render settings too
        set_budget(budget)

    # the path's counted run: launches per frame and the 14 counters
    kernels.reset_launch_counts()
    interval = eng.config.shadow_update_interval
    frames = 6
    for i in range(frames):
        before = dict(kernels.LAUNCHES)
        renders_map = eng.shadow_state.tick % interval == 0
        img = eng.frame(None, DT)
        got, want = launch_delta(before), frame_launches(renders_map,
                                                         tile_lists=1)
        if got != want:
            raise RuntimeError(f"lights frame {i} launched {got}, expected "
                               f"{want}")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if tuple(img.shape) != (LIGHTS["height"], LIGHTS["width"], 3) or \
            not bool(torch.isfinite(img).all()):
        raise RuntimeError("lights: image")
    drops = eng.drop_stats()
    log(f"[lights] launches in {frames} frames: {launches}; drop counters "
        f"({len(drops)}): {drops}")
    if len(drops) != DROP_KEYS_LIGHTS or any(drops.values()):
        raise RuntimeError(f"expected {DROP_KEYS_LIGHTS} drop counters, "
                           "all 0")

    # one more frame, which renders a shadow map: K1 in both modes and K2
    # at this path's shapes (other tile counts and budgets than the
    # headline's) against their plain versions, exact
    hold_kernels(eng, "lights")

    # the same state through the kernels at budget 96, through the plain
    # versions, and through the kernels at budget 0
    with Capture(SP, "shade_tiles") as k3, \
            Capture(F, "select_tile_lights") as sel:
        img_l = eng.render()
    with Plain():
        img_p = eng.render()
    set_budget(0)
    img_d = eng.render()
    set_budget(LIGHT_TILE_BUDGET)
    torch.cuda.synchronize()
    err = float((img_l - img_p).abs().max())
    log(f"[lights] kernels vs plain versions, whole 720p frame with tile "
        f"light lists: max abs diff {err:.3g}")
    if not err <= 1e-5:
        raise RuntimeError(f"lights frame through the kernels differs by "
                           f"{err}")
    same = torch.equal(img_l, img_d)
    log(f"[lights] frame at budget {LIGHT_TILE_BUDGET} against budget 0: "
        f"torch.equal {same}, max abs diff "
        f"{float((img_l - img_d).abs().max()):.3g}; image max "
        f"{float(img_l.max()):.3f}, mean {float(img_l.mean()):.4f}")
    if not same:
        raise RuntimeError("the tile-listed frame differs from the dense "
                           "one with no overflow")
    a3, kw3 = k3.calls[0]
    tlist, tcount = kw3["tlist"], kw3["tcount"]
    if tlist is None or tuple(tlist.shape) != (a3[0].shape[0],
                                               LIGHT_TILE_BUDGET):
        raise RuntimeError("K3 got no tile light lists")
    bins = [int(((tcount >= lo) & (tcount < hi)).sum())
            for lo, hi in zip(TCOUNT_BINS, TCOUNT_BINS[1:])]
    n_live = int(a3[6][0])
    log(f"[lights] K3 inputs: rows {tuple(a3[0].shape)}, ltab "
        f"{tuple(a3[5].shape)} ({a3[5].numel() * 4} B of shared memory), "
        f"{n_live} live lights, tlist {tuple(tlist.shape)}; tcount a tile: "
        + ", ".join(f"[{lo},{hi}): {n}" for lo, hi, n in
                    zip(TCOUNT_BINS, TCOUNT_BINS[1:], bins))
        + f"; max {int(tcount.max())}, mean "
        f"{float(tcount.double().mean()):.1f}; K3 blocks an SM with this "
        f"table: {SP.blocks_per_sm(a3[5].shape[0])} (with the headline's 20 "
        f"rows: {SP.blocks_per_sm(20)})")
    kw_dense = dict(kw3, tlist=None, tcount=None)
    rec = kernel_record(
        "fused_shade_tile_lists", 1e-5,
        lambda: [SP.shade_tiles(*a3, **kw3)],
        lambda: [SP.fused_shade_reference(*a3, **kw3)],
        KB.fused_shade_work(*a3, **kw3), plain_reps=1)
    out_l = SP.shade_tiles(*a3, **kw3)
    out_d = SP.shade_tiles(*a3, **kw_dense)
    if not torch.equal(out_l, out_d):
        raise RuntimeError("K3 with lists differs from K3 over every light")
    dense_rec = kernel_record(
        f"fused_shade over all {n_live} lights", 1e-5,
        lambda: [SP.shade_tiles(*a3, **kw_dense)],
        lambda: [SP.fused_shade_reference(*a3, **kw_dense)],
        KB.fused_shade_work(*a3, **kw_dense), plain_reps=1)
    sa, skw = sel.calls[0]
    select_ms = device_ms(lambda: SP.select_tile_lights(*sa, **skw), 20)
    select_host = cuda_ms(lambda: SP.select_tile_lights(*sa, **skw), 10)
    log(f"[lights] K3 with lists {rec['ms']:.4f} ms against "
        f"{dense_rec['ms']:.4f} ms over all lights (equal outputs); "
        f"select_tile_lights {select_ms:.4f} ms of device time (one call "
        f"with its host cost {select_host:.3f} ms)")
    turns = turn_medians(eng, BUDGET_TURNS, start_turn, "lights", "budget ")
    rec.update(dense_ms=dense_rec["ms"], dense_bound_ms=dense_rec["bound_ms"],
               dense_bound_by=dense_rec["bound_by"], select_ms=select_ms,
               tcount_max=int(tcount.max()),
               tcount_mean=float(tcount.double().mean()),
               ms_per_frame_budget_0=turns[0],
               ms_per_frame_budget_96=turns[LIGHT_TILE_BUDGET])
    return rec, launches, frames


def custom_systems(eng):
    """The engine's two systems, recompiled: the lit one with a
    fragment-shading function over the normal, the albedo, the default
    color and a uniform; the light sources with a draw callback (a sortable
    filter, a gate on a tensor, a uniform write, the skybox). Returns the
    compiled systems with and without the shading function."""
    import torch

    from render_engine_tpu_torch.ecs import registry as R
    from render_engine_tpu_torch.render.render_system import compile_systems

    lit, sources = eng.compiled_systems.src

    def shade(sp):
        tone = torch.as_tensor(sp.uniforms["tone"], dtype=torch.float32,
                               device=sp.base_color.device)
        n = 0.5 * (sp.normal + 1.0)
        return (sp.base_color * tone + 0.2 * sp.albedo * n).clamp(0.0, 1.0)

    def draw(dp):
        cam = dp.get_camera()
        dp.draw_models(*sources.model_ids, sortable=R.SORTABLE_SPOT,
                       when=cam.position[2] > 0.0)
        dp.write_uniform("emissive_boost",
                         torch.ones((), device=dp.world.device))
        dp.draw_skybox(cam.position[2] > 0.0)

    sources = dataclasses.replace(sources, draw=draw)
    toned = dataclasses.replace(lit, uniforms=lit.uniforms + (("tone", 0.8),))
    return (compile_systems((dataclasses.replace(toned, shade=shade),
                             sources), eng.bank),
            compile_systems((lit, sources), eng.bank),
            lambda sp: sp.base_color * float("nan"))


def phase_custom(eng):
    """K2 over every tile on the headline engine with custom shading.
    Returns the kernel record and the launches of the path's counted
    run."""
    import torch

    from render_engine_tpu_torch import kernel_bounds as KB
    from render_engine_tpu_torch import kernels
    from render_engine_tpu_torch.render import raster_pallas as RP
    from render_engine_tpu_torch.render.render_system import compile_systems

    eng.config.record_history = False
    eng.reset()
    default = eng.compiled_systems
    shaded, unshaded, marker = custom_systems(eng)
    eng.compiled_systems = shaded

    # the path's counted run; a K2 launch is over every tile when its slot
    # planes hold all of the frame's tiles
    nt = -(-SLICE["height"] // 8) * -(-SLICE["width"] // 128)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    interval = eng.config.shadow_update_interval
    frames = 6
    with Capture(RP, "resolve_attributes_pallas",
                 note=lambda slot, rows, *a, **kw: slot.shape[0]) as tiles:
        for i in range(frames):
            before = dict(kernels.LAUNCHES)
            renders_map = eng.shadow_state.tick % interval == 0
            img = eng.frame(None, DT)
            got, want = launch_delta(before), frame_launches(renders_map,
                                                             resolve=3)
            seen = tiles.calls[3 * i:]
            if got != want or len(seen) != 3 or seen[0] >= nt or \
                    seen[1:] != [nt, nt]:
                raise RuntimeError(f"custom frame {i} launched {got} with K2 "
                                   f"over {seen} tiles, expected {want} with "
                                   f"K2 over fewer than {nt}, {nt}, {nt}")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    launches["resolve_full_frame"] = sum(t == nt for t in tiles.calls)
    peak = torch.cuda.max_memory_allocated()
    log(f"[custom] launches in {frames} frames: {launches} (K2 three a "
        "frame: the textured tiles, then every tile of the opaque and of "
        f"the transparent layer); peak device memory {peak / 2**20:.0f} MiB")
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("custom: image has non-finite values")

    with Capture(RP, "resolve_attributes_pallas") as k2:
        img_s = eng.render()
    with Plain():
        img_p = eng.render()
    eng.compiled_systems = unshaded
    img_u = eng.render()
    lit = shaded.src[0]
    eng.compiled_systems = compile_systems(
        (dataclasses.replace(lit, shade=marker), shaded.src[1]), eng.bank)
    owned = torch.isnan(eng.render()).any(dim=-1)
    eng.compiled_systems = default
    img_0 = eng.render()
    eng.compiled_systems = shaded
    torch.cuda.synchronize()
    err = float((img_s - img_p).abs().max())
    log(f"[custom] kernels vs plain versions, whole 1080p frame with custom "
        f"shading: max abs diff {err:.3g}")
    if not err <= 1e-5:
        raise RuntimeError(f"custom frame through the kernels differs by "
                           f"{err}")
    changed = (img_s != img_u).any(dim=-1)
    log(f"[custom] the shading system owns {int(owned.sum())} pixels; "
        f"{int(changed.sum())} differ from the frame without the function, "
        f"{int((changed & ~owned).sum())} of them outside its pixels; the "
        "draw callback's frame equals the static systems': "
        f"{torch.equal(img_u, img_0)}")
    if bool((changed & ~owned).any()) or not bool(changed.any()) \
            or not bool(owned.any()):
        raise RuntimeError("custom shading touched pixels it does not own, "
                           "or none")
    if not torch.equal(img_u, img_0):
        raise RuntimeError("the draw callback (every light source drawn, "
                           "boost x 1, skybox on) changed the frame")

    full = [c for c in k2.calls if c[0][0].shape[0] == nt]
    if len(k2.calls) != 3 or len(full) != 2:
        raise RuntimeError(f"{len(k2.calls)} K2 calls, {len(full)} of them "
                           "over every tile")
    a2 = full[0][0]
    covered = float((a2[0] >= 0).double().mean())
    out_bytes = a2[1].shape[2] * a2[0].numel() * 4
    log(f"[custom] K2 full-frame inputs: slot {tuple(a2[0].shape)}, rows "
        f"{tuple(a2[1].shape)}, output {out_bytes / 1e6:.1f} MB, covered "
        f"pixels {covered:.4f}")
    rec = kernel_record(
        "resolve_full_frame", 0.0,
        lambda: [RP.resolve_attributes_pallas(*a2)],
        lambda: [RP.resolve_attributes_reference(*a2)],
        KB.resolve_work(*a2), k2_gather(*a2))

    def start_turn(which):
        eng.reset()
        eng.compiled_systems = shaded if which == "with" else unshaded

    turns = turn_medians(eng, SHADE_TURNS, start_turn, "custom",
                         "shading function: ")
    eng.compiled_systems = default
    rec.update(ms_per_frame_with_shading=turns["with"],
               ms_per_frame_without_shading=turns["without"],
               peak_memory_bytes=peak, output_bytes=out_bytes)
    return rec, launches, frames


def render_launches(label, before, frames):
    """The launches since ``before``: every kernel of the rendered path
    must have run. Returns them."""
    got = launch_delta(before)
    log(f"[{label}] launches in {frames} rendered frames: {got}")
    missing = [k for k in MAIN_PATH if got[k] == 0]
    if missing:
        raise RuntimeError(f"{label} launched no {missing}")
    return got


def config_scene(RB):
    """800x600: the last of 7 tile columns is 32 pixels wide."""
    import torch

    from render_engine_tpu_torch import kernels

    kernels.reset_launch_counts()
    before = dict(kernels.LAUNCHES)
    rec, eng = RB.bench_scene(scale=CONFIG_SCALE,
                              frames=CONFIG_FRAMES["scene"])
    render_launches("configs scene", before, WARMUP + CONFIG_FRAMES["scene"])
    sc = RB._scaler(CONFIG_SCALE)
    s = eng.config.render
    size = (sc(600, 96), sc(800, 128))
    if (s.height, s.width) != size or (
            CONFIG_SCALE == 1.0 and s.width % s.raster.tile_w == 0):
        raise RuntimeError(f"scene renders {s.width}x{s.height}")
    interval = eng.config.shadow_update_interval
    while eng.shadow_state.tick % interval:
        eng.frame(None, DT)
    img = hold_kernels(eng, "configs scene", k3=True)
    if tuple(img.shape) != (*size, 3) or \
            not bool(torch.isfinite(img).all()) or float(img.max()) < 0.5:
        raise RuntimeError("scene: image")
    tw = s.raster.tile_w
    frame_through_plain(
        eng, "configs scene", f"whole {s.width}x{s.height} frame "
        f"({-(-s.width // tw)} tile columns, the last {s.width % tw or tw} "
        "pixels wide)")
    log(json.dumps(rec))
    return rec


def config_asteroids(RB):
    import torch

    from render_engine_tpu_torch import kernels

    before = dict(kernels.LAUNCHES)
    rec, eng = RB.bench_asteroids(scale=CONFIG_SCALE,
                                  frames=CONFIG_FRAMES["asteroids"])
    # drop_stats inside the benchmark launched K1 once more
    render_launches("configs asteroids", before,
                    WARMUP + CONFIG_FRAMES["asteroids"])
    drops = rec["drops"]
    img = eng.render()
    sc = RB._scaler(CONFIG_SCALE)
    if tuple(img.shape) != (sc(1080, 144), sc(1920, 256), 3) or \
            not bool(torch.isfinite(img).all()) or float(img.max()) < 0.5:
        raise RuntimeError("asteroids: image")
    log(f"[configs asteroids] collision_large_budget "
        f"{eng.config.collision_large_budget}, drop counters "
        f"({len(drops)}): {drops}")
    if eng.config.collision_large_budget != 64 or len(drops) != DROP_KEYS \
            or any(drops.values()):
        raise RuntimeError(f"asteroids: expected {DROP_KEYS} drop counters, "
                           "all 0, at collision_large_budget 64")
    log(json.dumps(rec))
    return rec


def config_tick(RB):
    """The 100,000-entity world: steps, a burst, then one rendered frame
    at max_tris 49152 with the kernels held to their plain versions."""
    import torch

    from render_engine_tpu_torch.logic import random as RND
    from render_engine_tpu_torch.logic.step import STEP_DROP_KEYS

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec, eng = RB.bench_tick(scale=CONFIG_SCALE, frames=CONFIG_FRAMES["tick"],
                             burst=CONFIG_FRAMES["tick_burst"])
    log(f"[configs tick] built and stepped in "
        f"{time.perf_counter() - t0:.1f} s: capacity {rec['capacity']}, "
        f"{rec['alive']} alive, {1e3 / rec['steps_per_sec']:.2f} ms a step "
        f"frame by frame, {1e3 / rec['scan_steps_per_sec']:.2f} ms a step "
        f"in a run_frames burst of {CONFIG_FRAMES['tick_burst']}")
    sc = RB._scaler(CONFIG_SCALE)
    entities = sc(100000, 1000) + SCENE_FIXED_ENTITIES
    if rec["alive"] != entities or \
            rec["capacity"] != 1 << (entities + 58).bit_length():
        raise RuntimeError(f"tick: {rec['alive']} alive of capacity "
                           f"{rec['capacity']}")
    c = eng.config
    budgets = {"collision_query_dropped": "the step's query budget",
               "collision_cell_dropped": f"collision_budget "
               f"{c.collision_budget} a cell",
               "collision_pair_dropped": f"collision_pairs "
               f"{c.collision_pairs}",
               "collision_large_dropped": f"collision_large_budget "
               f"{c.collision_large_budget}",
               "spawn_dropped": f"spawn_budget {c.spawn_budget}",
               "oob_killed": "no budget: entities deleted out of bounds"}
    step = {k: rec["drops"][k] for k in STEP_DROP_KEYS}
    log(f"[configs tick] step counters: {step}")
    for k, v in step.items():
        if v:
            log(f"[configs tick] FINDING: {k} = {v} ({budgets[k]})")
    # the step's random draws are made on the host, bit for bit jax.random's:
    # a key, one split per random callback, two uniform(3) draws
    reps = 200
    t0 = time.perf_counter()
    for i in range(reps):
        _, sub = RND.split(RND.key(i))
        RND.uniform(sub, (3,), minval=-8.0, maxval=8.0)
        RND.uniform(sub, (3,), minval=-2.0, maxval=2.0)
    log(f"[configs tick] the step's host threefry draws (a key, a split, "
        f"two uniform(3)): {(time.perf_counter() - t0) / reps * 1e3:.3f} ms "
        "a step, whatever the entity count")
    if eng.shadow_state.tick % c.shadow_update_interval:
        raise RuntimeError("tick: the first rendered frame should render a "
                           "shadow map")
    img = hold_kernels(eng, "configs tick", k3=True)
    if tuple(img.shape) != (sc(1080, 144), sc(1920, 256), 3) or \
            not bool(torch.isfinite(img).all()):
        raise RuntimeError("tick: image")
    frame_through_plain(eng, "configs tick", f"whole {img.shape[1]}x"
                        f"{img.shape[0]} frame at max_tris "
                        f"{c.render.max_tris}")
    rdrops = eng.render_drop_stats()
    log(f"[configs tick] render counters at max_tris {c.render.max_tris}: "
        f"{rdrops}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[configs tick] peak device memory {peak / 2**20:.0f} MiB")
    rec["peak_memory_bytes"] = peak
    log(json.dumps(rec))
    return rec


def config_playback(RB):
    from render_engine_tpu_torch import kernels

    before = dict(kernels.LAUNCHES)
    rec, eng = RB.bench_playback(
        scale=CONFIG_SCALE, frames=CONFIG_FRAMES["playback"],
        recorded_frames=CONFIG_FRAMES["playback_recorded"])
    render_launches("configs playback", before,
                    WARMUP + CONFIG_FRAMES["playback_recorded"])
    log(f"[configs playback] {CONFIG_FRAMES['playback']} step frames "
        f"recorded at {1e3 / rec['record_fps']:.2f} ms and replayed at "
        f"{1e3 / rec['value']:.2f} ms a frame; bit_deterministic "
        f"{rec['bit_deterministic']}; past the end: parked "
        f"{rec['past_end_parked']}, Up stepped one live frame "
        f"{rec['past_end_up_stepped']}; {eng.history.num_frames} recorded "
        f"1080p frames at {rec['recorded_ms_per_frame']:.2f} ms")
    if not (rec["bit_deterministic"] and rec["past_end_parked"]
            and rec["past_end_up_stepped"]):
        raise RuntimeError("playback: the replay diverged, or the steps "
                           "past the end misbehaved")
    log(json.dumps(rec))
    return rec


def phase_configs():
    """The benchmark configurations at full scene size with cut frame
    counts; each is checked as the module docstring says."""
    import torch

    from benchmarks import run_benchmarks_torch as RB

    for config in (config_scene, config_asteroids, config_tick,
                   config_playback):
        t0 = time.perf_counter()
        config(RB)
        torch.cuda.empty_cache()
        log(f"[configs] {config.__name__[len('config_'):]}: "
            f"{time.perf_counter() - t0:.1f} s")


def image_agreement(a, b):
    """Share of pixels within 2e-2, the median and the max of the per-pixel
    max abs difference of two images."""
    diff = (a - b).abs().amax(dim=-1)
    return (float((diff < 2e-2).double().mean()), float(diff.median()),
            float(diff.max()))


def phase_golden():
    """The golden path on a small engine with a cubemap skybox: against
    the fused path on the card, and the card against the CPU."""
    import torch

    from render_engine_tpu_torch.demo.space_scene import build_space_engine
    from render_engine_tpu_torch.render import skybox as SB
    from render_engine_tpu_torch.render.frame import to_srgb_u8

    imgs = {}
    for dev in ("cpu", "cuda"):
        eng = build_space_engine(device=dev, **GOLDEN)
        eng.config.record_history = False
        eng.set_skybox(SB.starfield_cubemap(64, device=eng.device))
        for i in range(3):
            eng.frame(frame_inputs(i), DT)
        fused = eng.render()
        eng.config.render = dataclasses.replace(eng.config.render,
                                                backend="jnp")
        imgs[dev] = (fused.cpu(), eng.render().cpu())
        eng.set_skybox(SB.cubemap_rows(eng.cubemap))
        rows = eng.render().cpu()
        if not torch.allclose(rows, imgs[dev][1], rtol=0, atol=1e-6):
            raise RuntimeError(f"golden on {dev}: the row sampler's "
                               "background differs from the four-tap one")
    for dev, (fused, golden) in imgs.items():
        near, med, worst = image_agreement(fused, golden)
        log(f"[golden] {dev}: fused against golden at {GOLDEN['width']}x"
            f"{GOLDEN['height']} with shadows and a cubemap: "
            f"{near:.4f} of pixels within 2e-2, median {med:.3g}, max "
            f"{worst:.3g}")
        if not (near > 0.98 and med <= 1e-5):
            raise RuntimeError(f"golden on {dev} disagrees with the fused "
                               "path")
        if not bool(torch.isfinite(golden).all()) or \
                float(golden.max()) < 0.5:
            raise RuntimeError(f"golden on {dev}: blank or non-finite")
    a, b = imgs["cuda"][1], imgs["cpu"][1]
    far = float(((a - b).abs().amax(dim=-1) > 2.0 / 255.0).double().mean())
    u8 = float((to_srgb_u8(a) != to_srgb_u8(b)).double().mean())
    log(f"[golden] card against CPU: {far:.4%} of pixels differ by more "
        f"than 2/255, u8 values differing {u8:.2%}")
    if far > 5e-3:
        raise RuntimeError("golden: the card's frame differs from the CPU's")



def main() -> int:
    # cuBLAS is deterministic only with a fixed workspace, set before CUDA
    # starts (phase 6 runs with deterministic algorithms)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", metavar="DIR",
                    help="an earlier checkout whose kernels to time in "
                         "turns with the current ones")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import render_engine_tpu_torch  # noqa: F401  (fails outside the repo)
    from render_engine_tpu_torch.demo.space_scene import build_space_engine

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {smi}")
    phase_build()
    earlier = None
    if args.earlier:
        from render_engine_tpu_torch import kernels

        src = os.path.join(args.earlier, "render_engine_tpu_torch", "csrc")
        earlier = kernels.load(kernels.build(
            csrc=src, lib_path=os.path.join(args.earlier, "_build",
                                            "librender_kernels.so")))
        log(f"[build] earlier kernels from {src}")

    t0 = time.perf_counter()
    eng = build_space_engine(device="cuda", **SLICE)
    eng.config.record_history = False
    log(f"[slice] engine built in {time.perf_counter() - t0:.1f} s: "
        f"{SLICE}")
    rec = phase_kernels(eng, earlier)
    phase_frame(eng)
    phase_small()
    launches = phase_slice(eng)
    replay_launches = phase_replay(eng)
    frames = WARMUP + TIMED
    # per frame: the two-pass main raster once, the one-pass shadow raster
    # on map frames (tile_raster counts both modes)
    per_frame = {"tile_raster": (launches["tile_raster"]
                                 - launches["tile_raster_one_pass"]) / frames,
                 "tile_raster_one_pass": launches["tile_raster_one_pass"]
                 / frames, "resolve": launches["resolve"] / frames,
                 "fused_shade": launches["fused_shade"] / frames}
    rec_c, launches_c, frames_c = phase_custom(eng)
    del eng
    torch.cuda.empty_cache()
    rec_l, launches_l, frames_l = phase_lights()
    phase_golden()
    phase_configs()
    # the two branch rows take their launches from their own phase's run
    rec.update(resolve_full_frame=rec_c, fused_shade_tile_lists=rec_l)
    for name, run, n in (("resolve_full_frame", launches_c, frames_c),
                         ("fused_shade_tile_lists", launches_l, frames_l)):
        launches[name] = run[name]
        per_frame[name] = run[name] / n
        if run[name] == 0:
            raise RuntimeError(f"{name}: no launch on its path")

    kern = [dict(name=n, route="cuda", source=src, replaces=rep,
                 launches=launches[key], launches_per_frame=per_frame[n],
                 replay_launches=replay_launches.get(key, 0), **rec[n])
            for n, (key, src, rep) in KERNELS.items()]
    log(json.dumps({"kernels": kern}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
