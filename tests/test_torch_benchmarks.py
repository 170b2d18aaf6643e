"""The port's benchmark scripts at toy sizes on the CPU: the five
configurations of ``benchmarks/run_benchmarks_torch.py`` and the body of
``bench_torch.py``, two timed frames each.

Each record's keys must be a superset of the JAX script's (read from the
source of ``benchmarks/run_benchmarks.py`` and ``bench.py``, whose
functions would need a JAX engine each to run); the playback must be bit
deterministic; the parameters that ``BENCH_SCALE`` does not touch must be
the JAX script's. No time is asserted: a CPU time says nothing of the card.
"""

import ast
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
from benchmarks import run_benchmarks_torch as RB  # noqa: E402

from torch_threads import one_torch_thread  # noqa: E402,F401

SCALE = 0.01
EXTRA = {"ms_per_frame", "device", "power_limit_w"}


def _dict_keys(node):
    return {k.value for k in node.keys if isinstance(k, ast.Constant)}


def jax_result_keys():
    """{config: keys of the dict its JAX function returns} and the keys of
    ``bench.py``'s result, from the scripts' source."""
    with open(os.path.join(ROOT, "benchmarks", "run_benchmarks.py")) as fh:
        tree = ast.parse(fh.read())
    keys = {}
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name.startswith("bench_"):
            ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return)
                   and isinstance(n.value, ast.Dict)]
            keys[fn.name[len("bench_"):]] = _dict_keys(ret[-1].value)
    with open(os.path.join(ROOT, "bench.py")) as fh:
        tree = ast.parse(fh.read())
    head = [n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
            and isinstance(n.value, ast.Dict)
            and getattr(n.targets[0], "id", "") == "result"]
    return keys, _dict_keys(head[0])


JAX_KEYS, JAX_BENCH_KEYS = jax_result_keys()


def test_the_jax_scripts_were_read():
    assert set(JAX_KEYS) == set(RB.ALL) == {"scene", "asteroids", "lights",
                                            "tick", "playback"}
    assert JAX_KEYS["tick"] >= {"steps_per_sec", "scan_steps_per_sec",
                                "scan_entities_per_sec"}
    assert JAX_KEYS["playback"] >= {"bit_deterministic", "record_fps",
                                    "recorded_render_1080p_fps"}
    assert JAX_BENCH_KEYS >= {"value", "windows_fps", "recorded_fps",
                              "drops", "vs_baseline"}


def check_record(name, rec):
    assert rec["config"] == name
    assert set(rec) >= JAX_KEYS[name] | EXTRA, JAX_KEYS[name] - set(rec)
    assert rec["device"] == "cpu" and rec["power_limit_w"] is None
    assert rec["ms_per_frame"] > 0 and rec["value"] > 0
    json.dumps(rec)  # every value serializes


def test_scene_config():
    rec, eng = RB.bench_scene(device="cpu", scale=SCALE, frames=2, warmup=1)
    check_record("scene", rec)
    s = eng.config.render
    assert (s.width, s.height, s.max_tris) == (128, 96, 32768)
    assert eng.config.capacity == 256 and eng.frame_index == 3
    assert not eng.config.record_history


def test_asteroids_config():
    rec, eng = RB.bench_asteroids(device="cpu", scale=SCALE, frames=2,
                                  warmup=1)
    check_record("asteroids", rec)
    assert rec["metric"].startswith("100 asteroids")
    assert eng.config.collision_large_budget == 64
    assert eng.config.capacity == 256 and eng.config.render.max_tris == 16384
    assert (eng.config.render.width, eng.config.render.height) == (256, 144)
    # the extra directional light is in the world
    assert int(eng.world.sortable_mask(1).sum()) == 1
    assert rec["drops"]["collision_large_dropped"] == 0
    assert len(rec["drops"]) == 13


def test_lights_config(monkeypatch):
    monkeypatch.setenv("BENCH_LIGHT_TILE_BUDGET", "24")
    rec, eng = RB.bench_lights(device="cpu", scale=SCALE, frames=2, warmup=1)
    check_record("lights", rec)
    assert rec["light_tile_budget"] == 24
    assert rec["metric"].startswith("8 point lights deferred 720p, 2 render")
    s = eng.config.render
    assert (s.max_point_lights, s.max_spot_lights) == (8, 8)
    assert (s.raster.tile_budget, s.raster.trans_tile_budget) == (192, 128)
    assert eng.config.capacity == 1024 and s.max_tris == 24576
    assert "light_tile_overflow" in rec["drops"] and len(rec["drops"]) == 14


def test_tick_config():
    rec, eng = RB.bench_tick(device="cpu", scale=SCALE, frames=2, burst=3,
                             warmup=1)
    check_record("tick", rec)
    assert rec["alive"] == 1000 + 6 == int(eng.world.alive.sum())
    assert rec["capacity"] == 2048 and eng.config.render.max_tris == 49152
    assert rec["unit"] == "entities_stepped_per_sec"
    assert eng.frame_index == 1 + 2 + 2 * 3
    step = {k: v for k, v in rec["drops"].items()
            if k.startswith(("collision_", "spawn_", "oob_"))}
    assert len(step) == 6 and not any(step.values())


def test_playback_config():
    torch.use_deterministic_algorithms(True)
    try:
        rec, eng = RB.bench_playback(device="cpu", scale=SCALE, frames=12,
                                     recorded_frames=2, warmup=1)
    finally:
        torch.use_deterministic_algorithms(False)
    check_record("playback", rec)
    assert rec["bit_deterministic"] is True
    assert rec["past_end_parked"] and rec["past_end_up_stepped"]
    assert rec["metric"] == "12-frame record/replay"
    assert eng.config.record_history and eng.history.num_frames == 3
    assert (eng.config.render.width, eng.config.render.height) == (256, 144)


def test_scale_follows_the_environment(monkeypatch):
    monkeypatch.setenv("BENCH_SCALE", "0.5")
    s = RB._scaler(None)
    assert (s(800, 128), s(30, 5), s(100000, 1000)) == (400, 15, 50000)
    assert RB._scaler(0.001)(800, 128) == 128
    monkeypatch.delenv("BENCH_SCALE")
    assert RB._scaler(None)(10000, 50) == 10000


def test_results_file(tmp_path, monkeypatch, capsys):
    """``main`` prints each record and appends the run to BENCH_OUT."""
    out = tmp_path / "results.json"
    monkeypatch.setenv("BENCH_OUT", str(out))
    monkeypatch.setenv("BENCH_SCALE", str(SCALE))
    monkeypatch.setitem(RB.ALL, "scene", lambda device: (
        {"config": "scene", "value": 1.0}, None))
    for _ in range(2):
        assert RB.main(["--device", "cpu", "scene"]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[0]) == {
        "config": "scene", "value": 1.0}
    runs = json.loads(out.read_text())
    assert len(runs) == 2 and runs[0]["device"] == "cpu"
    assert runs[1]["scale"] == SCALE
    assert runs[1]["results"] == [{"config": "scene", "value": 1.0}]
    with pytest.raises(SystemExit):
        RB.main(["--device", "cpu", "nope"])


@pytest.mark.parametrize("argv, want", [([], {}), (["--warmup", "6"],
                                                    {"warmup": 6})],
                         ids=["default", "six"])
def test_warmup_option(monkeypatch, capsys, argv, want):
    """``--warmup N`` reaches the configuration's function; without it the
    function keeps its own default."""
    seen = []
    monkeypatch.setenv("BENCH_OUT", "")
    monkeypatch.setitem(RB.ALL, "scene", lambda device, **kw: (
        seen.append(kw) or {"config": "scene", "value": 1.0}, None))
    assert RB.main(["--device", "cpu", *argv, "scene"]) == 0
    assert seen == [want]


def test_no_card_no_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RB.main(["scene"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.run(env={}, device="cuda")


BENCH_ENV = {"BENCH_WIDTH": "128", "BENCH_HEIGHT": "32",
             "BENCH_ASTEROIDS": "10", "BENCH_MAX_TRIS": "2048",
             "BENCH_SHADOW_SLOTS": "3", "BENCH_FRAMES": "2"}


def test_bench_torch_body():
    rec, eng = bench_torch.run(env=BENCH_ENV, device="cpu", warmup=1)
    assert set(rec) >= JAX_BENCH_KEYS | EXTRA | {"windows_ms",
                                                 "recorded_ms_per_frame"}
    assert rec["unit"] == "fps" and rec["frames_per_window"] == 2
    assert len(rec["windows_fps"]) == len(rec["windows_ms"]) == 3
    # both numbers are rounded from the same unrounded fps (value to 2
    # decimals, vs_baseline to 3), so they agree within the two roundings
    assert abs(rec["vs_baseline"] - rec["value"] / 60.0) <= 5e-4 + 5e-3 / 60
    assert rec["metric"].startswith("FPS at 128x32 deferred, space scene "
                                    "(16 entities")
    assert len(rec["drops"]) == 13
    assert eng.config.capacity == 128 and eng.config.shadow_slots == 3
    # warm-up, three windows, then the recorded window alone in the log
    assert eng.frame_index == 1 + 3 * 2 + 2
    assert eng.history.num_frames == 2 and not eng.config.record_history
    json.dumps(rec)


def test_bench_torch_compare_in_turns():
    eng = bench_torch.build_engine(BENCH_ENV, "cpu")
    cmp_ = bench_torch.compare(eng, "BENCH_SHADOW_INTERVAL", "2",
                               env=BENCH_ENV, rounds=1, turn_frames=2)
    assert cmp_["knob"] == "BENCH_SHADOW_INTERVAL"
    assert (cmp_["a"], cmp_["b"]) == (None, "2")
    for k in ("a", "b"):
        assert len(cmp_[f"{k}_turn_medians_ms"]) == 2  # a, b, b, a
        lo, hi = cmp_[f"{k}_range_ms"]
        assert lo <= cmp_[f"{k}_ms_per_frame"] <= hi
    with pytest.raises(ValueError):
        bench_torch.compare(eng, "WIDTH", "2", env=BENCH_ENV)
