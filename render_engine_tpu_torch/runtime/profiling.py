"""Per-stage frame profiling.

Port of ``render_engine_tpu/runtime/profiling.py``:

  * ``StageTimer``: EWMA per-stage host timings (alpha 0.6 over 5 frames),
    the frame-time HUD.
  * ``trace()``: a ``torch.profiler`` wrapper for deep dives (writes a
    Chrome trace under ``log_dir``).

and adds what the benchmarks share: ``require_device`` / ``device_info``
(a measurement names the card it ran on, and fails where there is none),
``device_activity`` (a trace's device rows: their sum, the time the device
was busy and their span),
``timed`` and ``turn_medians`` (two variants compared in alternating turns
inside one process, because the host clock drifts between runs) and
``graph_pool_bytes`` (the memory of a set of captured programs).

PyTorch returns before the device finishes, so a stage that ends in device
work passes ``sync=`` a tensor or a nest of tensors: the timer then waits
with ``torch.cuda.synchronize()`` when one of them lives on a CUDA device.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import subprocess
import time

import torch

EWMA_ALPHA = 0.6
EWMA_WINDOW = 5


def _tensors(nest):
    """The tensors of a nest of dicts, lists, tuples and dataclasses."""
    if isinstance(nest, torch.Tensor):
        yield nest
    elif isinstance(nest, dict):
        for v in nest.values():
            yield from _tensors(v)
    elif isinstance(nest, (list, tuple)):
        for v in nest:
            yield from _tensors(v)
    elif hasattr(nest, "__dataclass_fields__"):
        for name in nest.__dataclass_fields__:
            yield from _tensors(getattr(nest, name))


class StageTimer:
    def __init__(self):
        self._ewma: dict[str, float] = {}
        self._history: dict[str, list] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            for t in _tensors(sync):
                if t.is_cuda:
                    torch.cuda.synchronize(t.device)
                    break
        dt = time.perf_counter() - t0
        hist = self._history.setdefault(name, [])
        hist.append(dt)
        del hist[:-EWMA_WINDOW]
        prev = self._ewma.get(name, dt)
        self._ewma[name] = EWMA_ALPHA * dt + (1.0 - EWMA_ALPHA) * prev

    def history(self, name: str) -> list[float]:
        """The stage's last ``EWMA_WINDOW`` timings, in milliseconds."""
        return [t * 1e3 for t in self._history.get(name, [])]

    def report(self) -> dict[str, float]:
        """EWMA milliseconds per stage."""
        return {k: v * 1e3 for k, v in self._ewma.items()}

    def hud_line(self) -> str:
        parts = [f"{k}={v:.1f}ms" for k, v in sorted(self.report().items())]
        return " | ".join(parts)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` around a block: host activity, and the device's
    where there is one. Yields the profiler (``key_averages()`` after the
    block) and writes ``trace.json`` (Chrome trace) under ``log_dir``."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_activity(events) -> dict:
    """The device rows of a ``torch.profiler`` trace (``prof.events()``;
    kernels, copies and memsets): how many, the sum of their durations,
    the union of their intervals (the time the device ran at least one of
    them) and the span from the first one's start to the last one's end,
    the times in ms. A sum above the union means rows overlapped."""
    rows = sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, total, lo, hi = 0.0, 0.0, None, None
    for start, end in rows:
        total += end - start
        if hi is None or start > hi:
            if hi is not None:
                busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    if hi is not None:
        busy += hi - lo
    return {"rows": len(rows), "sum_ms": total / 1e3, "busy_ms": busy / 1e3,
            "span_ms": (rows[-1][1] - rows[0][0]) / 1e3 if rows else 0.0}


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it is a CUDA device
    and there is no card (a measurement never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu (device='cpu') "
                           "to run on the CPU")
    return device


def device_info(device) -> dict:
    """``{"device": name, "power_limit_w": watts}``: the card's name and
    the power limit ``nvidia-smi`` reports for it; ``"cpu"`` and None for
    the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return {"device": torch.cuda.get_device_name(index),
            "power_limit_w": float(out)}


def sync(device):
    """Wait for ``device``'s queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device="cuda"):
    """``fn()`` and its ms on the host clock, the device's work included."""
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def turn_medians(frame, turns, start, frames=10, device="cuda", log=print,
                 label="turns", what=""):
    """Variants compared in alternating turns: for each entry ``which`` of
    ``turns`` (e.g. a, b, b, a), ``start(which)`` switches to that variant,
    then ``frame()`` runs ``frames`` times, each timed with its device work.
    Returns ``({which: median of its turn medians}, {which: [turn
    medians]})`` in ms and logs one line a variant, ``[label] what which:
    ...``."""
    meds: dict = {}
    for which in turns:
        start(which)
        times = [timed(frame, device)[1] for _ in range(frames)]
        meds.setdefault(which, []).append(statistics.median(times))
    for which, m in meds.items():
        log(f"[{label}] {what}{which}: {frames} frames a turn, turn medians "
            f"{', '.join(f'{t:.2f}' for t in m)} ms; median "
            f"{statistics.median(m):.2f} ms/frame")
    return {k: statistics.median(v) for k, v in meds.items()}, meds


def graph_pool_bytes(pool) -> int:
    """Bytes of the caching allocator's segments in the CUDA graph pool
    ``pool`` (``torch.cuda.graph_pool_handle()``; 0 for None)."""
    if pool is None:
        return 0
    return sum(seg["total_size"]
               for seg in torch.cuda.memory._snapshot()["segments"]
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))
