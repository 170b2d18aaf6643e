"""The ``custom`` deployment's files: its two readers
(``render.custom_span_ms``, ``render.custom_tiles_resolved``) on a
hand-built record, its cell's traced rehearsal on the CPU at the tests'
small size, its reference importing nothing of the port, and its program
failing at once on a port without the user's render systems."""

import os
import subprocess
import sys
import time

import pytest
import torch

from port_bench import bench, manifest

ROOT = manifest.ROOT
CELL = "space-1080p-10k-custom.coast"
SMALL = dict(width=128, height=96, capacity=128, num_asteroids=20,
             shadow_resolution=128, shadow_max_tris=1024)
READERS = ("render.custom_span_ms", "render.custom_tiles_resolved")


def _span(name, parent, ms):
    return {"name": name, "program": "('frame', 'skip')", "kind": "frame",
            "parent": parent, "start_ms": 0.0, "ms": ms, "self_ms": ms}


def _frame(shade, custom):
    sp = [_span("frame", None, 9.0), _span("render", 0, 8.0),
          _span("render.shade", 1, shade)]
    if custom is not None:
        sp.append(_span("render.custom", 1, custom))
    return {"spans": sp}


RECORD = {"spans": {"frames": [_frame(0.6, 8.1), _frame(0.7, 7.9),
                               _frame(0.6, 8.4), {"unread": True}],
                    "counters": {"frames": 4, "custom_tiles_resolved": 4050,
                                 "custom_tiles_owned": 1210,
                                 "custom_pixels": 63120}}}
WANT = {"render.custom_span_ms": 8.1, "render.custom_tiles_resolved": 4050}


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_hand_built_record(name):
    read = manifest.metric_reader(name)
    assert read(RECORD) == pytest.approx(WANT[name])
    # nothing to read: a record without spans, an engine without
    # tracing, a program with no shading system (no span, no counter)
    assert read({}) is None
    assert read({"spans": None}) is None
    assert read({"spans": {"frames": [_frame(0.6, None)],
                           "counters": {"frames": 1}}}) is None


def test_the_cell_reads_only_its_own_metrics():
    b = manifest.load()
    names = {m["name"] for m in manifest.cell_metrics(b, CELL, True)}
    assert names == set(READERS)
    for other in ("space-1080p-10k.coast", "space-1080p-10k-default.coast",
                  "space-1080p-10k.step"):
        assert not names & {m["name"] for m in
                            manifest.cell_metrics(b, other, True)}


def test_a_traced_rehearsal_reports_both_metrics(monkeypatch):
    """The traced run on the CPU: both readers find what they read, K2's
    tiles for the hook are both layers' tiles of the 128x96 frame, and
    the result stays a contract line."""
    from port_bench import spans, tracing

    for name, n in (("PROFILE_FRAMES", 3), ("STEP_CALLS", 3),
                    ("RENDER_CALLS", 2), ("SHADOW_UPDATES", 2)):
        monkeypatch.setattr(tracing, name, n)
    monkeypatch.setattr(spans, "SPAN_FRAMES", 3)
    torch.set_num_threads(2)
    res, _ = bench.run(CELL, 6, 5.0, True, time.perf_counter(),
                       device="cpu", overrides=SMALL)
    m = res["metrics"]
    assert set(m) == set(READERS)
    assert m["render.custom_tiles_resolved"] == {"value": 2 * 12 * 1,
                                                 "unit": "tiles/frame"}
    assert m["render.custom_span_ms"]["value"] > 0
    assert m["render.custom_span_ms"]["unit"] == "ms"
    assert list(res)[-1] == "checks" and res["correct"], res["checks"]


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import port_bench.reference.custom\n"
            "import port_bench.reference.programs.custom\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "bad = tops & {'render_engine_tpu_torch', 'render_engine_tpu', "
            "'jax', 'jaxlib', 'flax'}\n"
            "assert not bad, bad\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


def test_a_port_without_user_systems_fails_at_once():
    """A port that lacks ``demo/user_systems.py`` (the tree before it):
    the cell's run stops at the program's build with an error, before a
    frame."""
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "sys.modules['render_engine_tpu_torch.demo.user_systems'] = None\n"
            "from port_bench import bench\n"
            "bench.run(%r, 5, 1.0, False, time.perf_counter(), "
            "device='cpu', overrides=%r)\n" % (ROOT, CELL, SMALL))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "ModuleNotFoundError" in out.stderr or "ImportError" in out.stderr
    assert time.perf_counter() - t0 < 60
