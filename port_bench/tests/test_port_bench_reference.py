"""The harness's CPU rehearsal at a test-only small size of each
configuration: the port's frames (world, shadow maps, image) against the
frozen reference come out correct; the control (the reference one
precision below) and the planted faults come out not correct; nothing of
JAX is loaded, and the reference imports nothing of the port."""

import ast
import os
import subprocess
import sys
import time

import pytest
import torch

from port_bench import bench, check, manifest

SMALL = dict(width=128, height=96, capacity=128, num_asteroids=20,
             shadow_resolution=128, shadow_max_tris=1024)
# asteroids in the wide shell, some beyond the camera's draw distance, so
# that which of them take logic rests on the frustum's planes
SHELL = dict(SMALL, capacity=4096, num_asteroids=4000)
SECONDS = 5.0  # windows of a few frames of about 1 s on a CPU
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = manifest.ROOT
CELLS = [w["name"] for w in manifest.load()["workloads"]]


def _run(cell, seed=3, program_cls=bench.Program, control=False,
         overrides=SMALL, seconds=SECONDS):
    torch.set_num_threads(2)
    return bench.run(cell, seed, seconds, False, time.perf_counter(),
                     device="cpu", overrides=overrides,
                     program_cls=program_cls, control=control)[0]


def _size(cell):
    traffic = manifest.traffic(manifest.cell(manifest.load(), cell)["traffic"])
    return SMALL if traffic["render"] else SHELL


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_is_correct_and_the_control_is_not(cell):
    res = _run(cell, control=True, overrides=_size(cell))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 3
    assert set(res["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}
    limits = manifest.config(manifest.load(),
                             manifest.cell(manifest.load(), cell)["config"]
                             )["limits"]
    ok, _ = check.judge(res["control"], limits)
    assert not ok, res["control"]


def _restore(eng, world, camv, rows=slice(None)):
    st = eng._state
    st.world.alive[rows] = world.alive[rows]
    st.world.comp_mask[rows] = world.comp_mask[rows]
    for k, col in st.world.comps.items():
        col[rows] = world.comps[k][rows]
    if rows == slice(None):
        st.camv.copy_(camv)
    eng._views.clear()


class Unchanged(bench.Program):
    """A step that returns its state unchanged."""

    def frame(self):
        st = self.eng._state
        world, camv = st.world.clone(), st.camv.clone()
        img = super().frame()
        _restore(self.eng, world, camv)
        return img


class HalfBatch(bench.Program):
    """Half of the entities left out: every other row keeps its state."""

    def frame(self):
        st = self.eng._state
        world, camv = st.world.clone(), st.camv.clone()
        img = super().frame()
        _restore(self.eng, world, camv,
                 slice(1, None, 2))
        return img


class Altered(bench.Program):
    """An answer altered where it is produced: one tile of the image (8
    rows), or one asteroid's position where nothing renders."""

    def frame(self):
        img = super().frame()
        if img is not None:
            img[0:8, :, 0] += 0.5
        else:
            self.eng._state.world.comps["position"][40, 0] += 0.5
            self.eng._views.clear()
        return img


@pytest.mark.parametrize("fault", [Unchanged, HalfBatch, Altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", ["space-1080p-10k.coast",
                                  "space-1080p-10k.step"])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    res = _run(cell, seed=4, program_cls=fault)
    assert not res["correct"], res["checks"]
    assert res["failed"] > 0


def test_no_jax_after_a_rehearsal_and_names_compared_whole():
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from port_bench import bench\n"
        "res, _ = bench.run('space-1080p-10k.step', 5, 1.0, False, "
        "time.perf_counter(), device='cpu', overrides=%r)\n"
        "print('FOUND', bench.forbidden_modules())\n"
        "assert 'render_engine_tpu_torch' in sys.modules\n"
        "sys.modules['render_engine_tpu_torchish'] = sys\n"
        "assert bench.forbidden_modules() == []\n"
        "sys.modules['render_engine_tpu.render'] = sys\n"
        "assert bench.forbidden_modules() == ['render_engine_tpu']\n"
        "sys.modules['jax'] = sys\n"
        "assert bench.forbidden_modules() == ['jax', 'render_engine_tpu']\n"
        % (ROOT, SMALL))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(ROOT, "port_bench", "reference")
    files = [os.path.join(d, f) for d, _, fs in os.walk(ref) for f in fs
             if f.endswith(".py")]
    assert len(files) >= 6
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("render_engine_tpu_torch", "render_engine_tpu",
                               "jax", "jaxlib", "flax"), (f, name)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import port_bench.reference.frames, "
            "port_bench.reference.precision\n"
            "import port_bench.reference.demo, port_bench.reference.step, "
            "port_bench.reference.render\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "bad = tops & {'render_engine_tpu_torch', 'render_engine_tpu', "
            "'jax', 'jaxlib', 'flax'}\n"
            "assert not bad, bad\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


def test_run_py_fails_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable,
                          os.path.join(ROOT, "port_bench", "run.py"),
                          "--workload", "space-1080p-10k.step", "--seed",
                          "3000000000", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_reference_draws_jax_random_numbers():
    """The reference's Threefry keys, splits and uniform draws are JAX's
    (values from ``jax.random`` 0.9 with its partitionable Threefry)."""
    from port_bench.reference import rng

    sub = rng.split(rng.key(12345))[1]
    assert sub == (867802714, 3762255628)
    assert rng.uniform(sub, 3, -8.0, 8.0).tolist() == pytest.approx(
        [2.442154, 0.15865326, 5.833004], abs=1e-6)
    sub = rng.split(rng.key(0xDEADBEEF))[1]
    assert sub == (1847133217, 4101091346)


def test_tf32_rounding():
    from port_bench.reference.precision import TF32, round_tf32

    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.0e4 + 1.0,
                      float("inf"), -2.5])
    r = round_tf32(x)
    assert r.tolist()[:3] == [1.0, 1.0, 1.0 + 2 ** -10]
    assert r[3] == 30000.0 and r[4] == float("inf") and r[5] == -2.5
    a = torch.full((2, 2), 1.0 + 2 ** -12)
    with TF32():
        assert torch.equal(a @ a, torch.full((2, 2), 2.0))
        assert torch.equal(torch.einsum("ij,jk->ik", a, a),
                           torch.full((2, 2), 2.0))
    assert not torch.equal(a @ a, torch.full((2, 2), 2.0))


@pytest.mark.card
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable,
                          os.path.join(ROOT, "port_bench", "run.py"),
                          "--workload", "space-1080p-10k.coast", "--seed",
                          "2999999999", "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


@pytest.mark.parametrize("cell", ["space-1080p-10k.coast",
                                  "space-1080p-10k.step"])
def test_a_traced_rehearsal_reports_the_cells_per_layer_metrics(
        cell, monkeypatch):
    """The traced run on the CPU (host clocks in place of CUDA events, no
    device rows): every per-layer metric that a CPU run can read is there,
    the device ones are left out, and the result stays a contract line."""
    from port_bench import spans, tracing

    for name, n in (("PROFILE_FRAMES", 3), ("STEP_CALLS", 3),
                    ("RENDER_CALLS", 2), ("SHADOW_UPDATES", 2)):
        monkeypatch.setattr(tracing, name, n)
    monkeypatch.setattr(spans, "SPAN_FRAMES", 3)
    torch.set_num_threads(2)
    res, _ = bench.run(cell, 6, SECONDS, True, time.perf_counter(),
                       device="cpu", overrides=SMALL)
    wanted = {m["name"] for m in manifest.cell_metrics(manifest.load(), cell,
                                                       True)}
    device_only = {"kernels.hand_roofline", "kernels.deferred_shade_roofline",
                   "device.idle_share", "device.rows_per_frame"}
    assert set(res["metrics"]) == wanted - device_only
    assert all(v["value"] > 0 for k, v in res["metrics"].items()
               if k != "engine.capture_s")
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert list(res)[-1] == "checks" and res["correct"], res["checks"]
