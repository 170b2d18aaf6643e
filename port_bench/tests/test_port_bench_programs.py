"""A deployment taken by adding files alone.

On a copy of ``port_bench/`` and ``BENCHMARK.json``, a configuration that
names a program only new files give (its program, its reference, a kernel
row and two metric readers, one reading the kernel row's bound and one a
counter of the program's own trace report) runs through ``bench.run`` on
the CPU at the tests' small size, traced, and reports both metrics. Every
file of the copy is left as it was, but ``BENCHMARK.json``, which only
gains entries."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from port_bench import manifest

ROOT = manifest.ROOT
SMALL = dict(width=128, height=96, capacity=128, num_asteroids=20,
             shadow_resolution=128, shadow_max_tris=1024)
CELL = "counted.coast"

NEW_FILES = {
    "programs/counted.py": '''
"""The space program behind a wrapper that counts its frames and reports
the count among the trace report's counters."""

from port_bench.programs import space


class Counted:
    def __init__(self, eng):
        self._eng, self.frames = eng, 0

    def __getattr__(self, name):
        return getattr(self._eng, name)

    def frame(self, *a, **kw):
        self.frames += 1
        return self._eng.frame(*a, **kw)

    def trace_report(self):
        report = self._eng.trace_report()
        report["counters"]["counted_frames"] = self.frames
        return report


def build(cfg, seed, device, overrides=None):
    return Counted(space.build(cfg, seed, device, overrides))
''',
    "reference/programs/counted.py": '''
"""The counted program's reference: the space program's, with its own
reading of the program's states."""

from port_bench.reference import frames
from port_bench.reference.programs.space import Control, Reference

__all__ = ["Control", "Reference", "state_of"]
READS = []


def state_of(eng):
    READS.append(1)
    return frames.state_of(eng)
''',
    "kernels/counted_resolve.py": '''
"""A row on K2's wrapper whose kernel the CPU never profiles."""

PROFILER_NAME = "counted_resolve_kernel"
EXCLUDE = None
WRAPS = ("render_engine_tpu_torch.render.raster_pallas:"
         "resolve_attributes_pallas")


def work(slot, rows, *a, **kw):
    return {"bytes": 4 * (slot.numel() + rows.numel()), "ops": 0}
''',
    "metrics/kernels.counted_resolve_bound_ms.py": '''
def read(rec):
    return rec.get("kernel_bounds", {}).get("counted_resolve")
''',
    "metrics/counted.frames.py": '''
def read(rec):
    return ((rec.get("spans") or {}).get("counters") or {}).get(
        "counted_frames")
''',
}

ENTRIES = {
    "configs": {"name": "counted", "source": "https://example.org/counted",
                "file": "port_bench/configs/counted.json", "reduced": [],
                "why": "the space scene behind a counting wrapper"},
    "workloads": {"name": CELL, "config": "counted", "traffic": "coast",
                  "chips": 1, "why": "the coast mix on the counted program"},
    "per_layer": [
        {"name": "kernels.counted_resolve_bound_ms", "unit": "ms",
         "better": "lower", "source": "device_trace", "layer": "kernels",
         "moves": "frame_ms", "workloads": [CELL]},
        {"name": "counted.frames", "unit": "frames", "better": "higher",
         "source": "program_counter", "layer": "engine and its captured "
         "programs", "moves": "frame_ms", "workloads": [CELL]}],
}

RUN = """
import json, sys, time
sys.path[:0] = [%(tmp)r, %(root)r]
import torch
torch.set_num_threads(2)
from port_bench import bench, spans, tracing
assert bench.__file__.startswith(%(tmp)r), bench.__file__
for name, n in (("PROFILE_FRAMES", 2), ("STEP_CALLS", 2),
                ("RENDER_CALLS", 1), ("SHADOW_UPDATES", 1)):
    setattr(tracing, name, n)
spans.SPAN_FRAMES = 3
res, _ = bench.run(%(cell)r, 7, 6.0, True, time.perf_counter(),
                   device="cpu", overrides=%(small)r)
from port_bench.reference.programs import counted
print(json.dumps({"metrics": res["metrics"], "correct": res["correct"],
                  "checks": res["checks"], "state_reads": len(counted.READS),
                  "modules": sorted(m for m in sys.modules
                                    if m.startswith("port_bench."))}))
"""


def _digests(top):
    out = {}
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, top)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_program_added_as_files_runs_and_reports_its_metrics(tmp_path):
    tmp = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "port_bench"),
                    os.path.join(tmp, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = manifest.load()
    before = _digests(tmp)
    for rel, text in NEW_FILES.items():
        with open(os.path.join(tmp, "port_bench", rel), "w") as f:
            f.write(text.lstrip())
    with open(os.path.join(ROOT, "port_bench", "configs",
                           "space-1080p-10k.json")) as f:
        cfg = dict(json.load(f), name="counted", program="counted")
    with open(os.path.join(tmp, "port_bench", "configs", "counted.json"),
              "w") as f:
        json.dump(cfg, f)
    added = json.loads(json.dumps(bench))
    added["configs"].append(ENTRIES["configs"])
    added["workloads"].append(ENTRIES["workloads"])
    added["per_layer"] += ENTRIES["per_layer"]
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(added, f)
    after = _digests(tmp)
    # no file of the copy edited: only new files
    assert {k: after[k] for k in before} == before
    # BENCHMARK.json only gained entries
    for key, value in bench.items():
        if isinstance(value, list):
            assert added[key][:len(value)] == value, key
        else:
            assert added[key] == value, key

    code = RUN % {"tmp": tmp, "root": ROOT, "cell": CELL, "small": SMALL}
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=1200, cwd=tmp)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], (res["checks"], out.stderr[-3000:])
    for mod in ("port_bench.programs.counted",
                "port_bench.reference.programs.counted",
                "port_bench.kernels.counted_resolve"):
        assert mod in res["modules"], mod
    assert res["state_reads"] > 0
    metrics = res["metrics"]
    assert metrics["kernels.counted_resolve_bound_ms"]["value"] > 0
    assert metrics["kernels.counted_resolve_bound_ms"]["unit"] == "ms"
    # the wrapper's count after the span phase: every frame it ran
    assert metrics["counted.frames"]["value"] >= 3
    # the cell reports what its lists name, no metric of the space cells
    assert set(metrics) == {"kernels.counted_resolve_bound_ms",
                            "counted.frames"}
