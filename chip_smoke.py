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
             (6 step, 7 render) must be 0.
The last three lines are the kernels' JSON record, the card's name and
power limit (nvidia-smi), and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
CAPTURE_FRAME = 3  # frames 0 and 3 render maps at interval 3: both slots

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
}
DROP_KEYS = 13  # 6 step counters and 7 render counters with shadows


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps):
    """Median of ``reps`` single-call times in ms, by CUDA events."""
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
    """Wrap a module function: keep a copy of every call's arguments, then
    delegate."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = []

    def __call__(self, *args, **kw):
        import torch

        def keep(v):
            return v.clone() if isinstance(v, torch.Tensor) else v
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
            lambda slot, rows, cfg=None: RP.resolve_attributes_reference(
                slot, rows))
        SP.shade_tiles = SP.fused_shade_reference
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def phase_build():
    from render_engine_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build(verbose=True)
    kernels.library()
    log(f"[build] nvcc {' '.join(kernels.NVCC_FLAGS)}: "
        f"{time.perf_counter() - t0:.1f} s")


def phase_kernels(eng):
    """Frames 0-2, then frame 3 with every kernel call's inputs captured;
    each kernel against its plain version on those inputs. Returns
    per-kernel records."""
    import torch

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
            f"{kw['two_pass']}")
    log(f"[kernels] K2 inputs: slot {tuple(a2[0].shape)}, rows "
        f"{tuple(a2[1].shape)}")
    log(f"[kernels] K3 inputs: rows {tuple(a3[0].shape)}, ltab "
        f"{tuple(a3[5].shape)}, overrides "
        f"{None if kw3['ovr'] is None else tuple(kw3['ovr'].shape)}, slot "
        f"factors {tuple(kw3['sf'].shape)}, inverse map "
        f"{tuple(kw3['sfi'].shape)} with {int((kw3['sfi'] >= 0).sum())} "
        "mapped tiles")

    cases = [
        ("tile_raster_one_pass", 0.0,
         lambda: RP.tile_raster(*a1s, **kw1s),
         lambda: RP.tile_raster_reference(*a1s, **kw1s)),
        ("tile_raster", 0.0,
         lambda: RP.tile_raster(*a1, **kw1),
         lambda: RP.tile_raster_reference(*a1, **kw1)),
        ("resolve", 0.0,
         lambda: [RP.resolve_attributes_pallas(*a2)],
         lambda: [RP.resolve_attributes_reference(*a2)]),
        ("fused_shade", 1e-5,
         lambda: [SP.shade_tiles(*a3, **kw3)],
         lambda: [SP.fused_shade_reference(*a3, **kw3)]),
    ]
    rec = {}
    for name, tol, kern, plain in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = max_abs(got, want)
        if tol == 0.0:
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
        else:
            ok = all(torch.allclose(g, w, rtol=tol, atol=tol)
                     for g, w in zip(got, want))
        ms = cuda_ms(kern, 20)
        plain_ms = cuda_ms(plain, 3)
        log(f"[kernels] {name}: max_abs_err {err:.3g} (tolerance {tol}) "
            f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms")
        if not ok:
            raise RuntimeError(f"{name} disagrees with its plain version "
                               f"(max abs err {err})")
        rec[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return rec


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


def phase_small():
    """4 frames of the small engine on the card against the CPU, without
    and with shadows."""
    import numpy as np
    import torch

    from render_engine_tpu_torch.demo.space_scene import build_space_engine
    from render_engine_tpu_torch.logic.types import KEY_W, InputState
    from render_engine_tpu_torch.render.frame import to_srgb_u8

    for shadows in (False, True):
        tag = "with shadows" if shadows else "no shadows"
        engines = {d: build_space_engine(device=d, enable_shadows=shadows,
                                         **SMALL)
                   for d in ("cpu", "cuda")}
        for i in range(4):
            inp = InputState.idle(i)
            if i == 1:
                inp = inp.with_keys(KEY_W)
            elif i >= 2:
                inp = dataclasses.replace(
                    inp.with_keys(KEY_W),
                    mouse_delta=np.array([0.02, -0.01], np.float32))
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
        want = {"tile_raster": 1 + renders_map,
                "tile_raster_one_pass": int(renders_map), "resolve": 1,
                "fused_shade": 1}
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import render_engine_tpu_torch  # noqa: F401  (fails outside the repo)
    from render_engine_tpu_torch.demo.space_scene import build_space_engine

    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    phase_build()

    t0 = time.perf_counter()
    eng = build_space_engine(device="cuda", **SLICE)
    log(f"[slice] engine built in {time.perf_counter() - t0:.1f} s: "
        f"{SLICE}")
    rec = phase_kernels(eng)
    phase_frame(eng)
    phase_small()
    launches = phase_slice(eng)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kern = [dict(name=n, route="cuda", source=src, replaces=rep,
                 launches=launches[key], **rec[n])
            for n, (key, src, rep) in KERNELS.items()]
    log(json.dumps({"kernels": kern}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
