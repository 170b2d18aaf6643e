"""The ``lights`` deployment's files: its three readers
(``render.lights_span_ms``, ``render.tile_light_pairs``,
``kernels.k3_roofline``) on hand-built records, its cell's traced
rehearsal on the CPU at the tests' small size, its reference importing
nothing of the port, and its program failing at once on a port whose
``build_many_lights_engine`` takes no scene seed (the tree before it).
The deployment is new files and new entries of ``BENCHMARK.json`` alone:
no module of the harness that was there before it names it."""

import os
import subprocess
import sys
import time

import pytest
import torch

from port_bench import bench, manifest

ROOT = manifest.ROOT
CELL = "lights-720p-256.coast"
SMALL = dict(width=128, height=240, n_lights=16, shadow_resolution=128)
READERS = ("render.lights_span_ms", "render.tile_light_pairs",
           "kernels.k3_roofline")
# the deployment's files, each new beside the harness's
NEW_FILES = ("configs/lights-720p-256.json", "programs/lights.py",
             "reference/lights.py", "reference/programs/lights.py",
             "metrics/render.lights_span_ms.py",
             "metrics/render.tile_light_pairs.py",
             "metrics/kernels.k3_roofline.py")


def _span(name, parent, ms):
    return {"name": name, "program": "('frame', 'skip')", "kind": "frame",
            "parent": parent, "start_ms": 0.0, "ms": ms, "self_ms": ms}


def _frame(lights):
    sp = [_span("frame", None, 6.0), _span("render", 0, 3.0),
          _span("render.resolve", 1, 0.4)]
    if lights is not None:
        sp.append(_span("render.lights", 1, lights))
    sp.append(_span("render.shade", 1, 0.5))
    return {"spans": sp}


RECORD = {"spans": {"frames": [_frame(0.08), _frame(0.07), _frame(0.09),
                               {"unread": True}],
                    "counters": {"frames": 4, "tile_light_pairs": 41234,
                                 "render_drops": {"light_tile_overflow": 0}}},
          "profile": {"roofline_by_kind": {"k1": 40.0, "k3": 27.1}}}
WANT = {"render.lights_span_ms": 0.08, "render.tile_light_pairs": 41234,
        "kernels.k3_roofline": 27.1}


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_hand_built_record(name):
    read = manifest.metric_reader(name)
    assert read(RECORD) == pytest.approx(WANT[name])
    # nothing to read: a record without spans or profile, an engine
    # without tracing, a frame with lists off (no span, no counter, no K3)
    assert read({}) is None
    assert read({"spans": None, "profile": {}}) is None
    assert read({"spans": {"frames": [_frame(None)],
                           "counters": {"frames": 1}},
                 "profile": {"roofline_by_kind": {"k1": 40.0}}}) is None


def test_the_cell_reads_only_its_own_metrics():
    b = manifest.load()
    names = {m["name"] for m in manifest.cell_metrics(b, CELL, True)}
    assert names == set(READERS)
    for m in b["per_layer"]:
        if m["name"] in READERS:
            assert m["workloads"] == [CELL] and m["moves"] == "frame_ms"
    others = [w["name"] for w in b["workloads"] if w["name"] != CELL]
    for other in others:
        assert not set(READERS) & {m["name"] for m in
                                   manifest.cell_metrics(b, other, True)}


def test_the_deployment_is_new_files_alone():
    """Its files exist, and no module of the harness that was there
    before it (every other ``.py`` file under ``port_bench/``) names it."""
    for rel in NEW_FILES:
        assert os.path.exists(os.path.join(ROOT, "port_bench", rel)), rel
    mine = {os.path.normpath(os.path.join(ROOT, "port_bench", r))
            for r in NEW_FILES} | {os.path.abspath(__file__)}
    for d, dirs, files in os.walk(os.path.join(ROOT, "port_bench")):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            p = os.path.normpath(os.path.join(d, f))
            if p in mine or not f.endswith(".py"):
                continue
            with open(p) as fh:
                text = fh.read()
            assert "lights-720p-256" not in text, p
            assert "reference.lights" not in text, p


def test_a_traced_rehearsal_reports_the_lists(monkeypatch):
    """The traced run on the CPU: both program readers find what they
    read (the CPU's profile has no device rows, so no roofline), the
    check passes and the result stays a contract line."""
    from port_bench import spans, tracing

    for name, n in (("PROFILE_FRAMES", 2), ("STEP_CALLS", 2),
                    ("RENDER_CALLS", 1), ("SHADOW_UPDATES", 1)):
        monkeypatch.setattr(tracing, name, n)
    monkeypatch.setattr(spans, "SPAN_FRAMES", 3)
    torch.set_num_threads(2)
    res, _ = bench.run(CELL, 3000000123, 12.0, True, time.perf_counter(),
                       device="cpu", overrides=SMALL)
    m = res["metrics"]
    assert set(m) == {"render.lights_span_ms", "render.tile_light_pairs"}
    assert m["render.lights_span_ms"]["value"] > 0
    assert m["render.lights_span_ms"]["unit"] == "ms"
    pairs = m["render.tile_light_pairs"]
    assert pairs["unit"] == "pairs/frame"
    # 30 tiles, 16 point and 2 spot lights live: fewer than every pair
    assert 0 < pairs["value"] < 30 * 18
    assert list(res)[-1] == "checks" and res["correct"], res["checks"]


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import port_bench.reference.lights\n"
            "import port_bench.reference.programs.lights\n"
            "import torch\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not torch.backends.cudnn.allow_tf32\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "bad = tops & {'render_engine_tpu_torch', 'render_engine_tpu', "
            "'jax', 'jaxlib', 'flax'}\n"
            "assert not bad, bad\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


def test_a_port_without_the_scene_seed_fails_at_once():
    """A port whose ``build_many_lights_engine`` takes no ``seed`` (the
    tree before it): the cell's run stops at the program's build with an
    error, before a frame."""
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from render_engine_tpu_torch.demo import space_scene as S\n"
        "full = S.build_many_lights_engine\n"
        "def before(*, device='cuda', n_lights=256, light_tile_budget=96,\n"
        "           width=1280, height=720):\n"
        "    return full(device=device, n_lights=n_lights, width=width,\n"
        "                height=height, light_tile_budget=light_tile_budget)\n"
        "S.build_many_lights_engine = before\n"
        "from port_bench import bench\n"
        "bench.run(%r, 5, 1.0, False, time.perf_counter(), "
        "device='cpu', overrides=%r)\n" % (ROOT, CELL, SMALL))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "TypeError" in out.stderr and "seed" in out.stderr
    assert time.perf_counter() - t0 < 60
