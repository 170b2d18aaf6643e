"""The frozen bounds arithmetic (``port_bench/bounds.py``) equals the
port's ``kernel_bounds.py`` today, on the kernels' arguments recorded in
a small CPU frame of each route; and the union arithmetic of the trace."""

import json

import numpy as np
import pytest
import torch

from port_bench import bounds, manifest, scene, tracing

SMALL = dict(width=128, height=96, capacity=128, num_asteroids=20,
             shadow_resolution=128, shadow_max_tris=1024)


def _recorded_calls(config_name):
    from render_engine_tpu_torch.logic.types import InputState
    from render_engine_tpu_torch.render import raster_pallas as RP
    from render_engine_tpu_torch.render import shade_pallas as SP

    cfg = manifest.config(manifest.load(), config_name)
    eng = scene.build(cfg, 5, "cpu", SMALL)
    calls = []
    saved = [(RP, "tile_raster"), (RP, "resolve_attributes_pallas"),
             (SP, "shade_tiles")]
    fns = {n: getattr(m, n) for m, n in saved}

    def wrap(name):
        def f(*a, **kw):
            calls.append((name, a, kw))
            return fns[name](*a, **kw)
        return f
    for m, n in saved:
        setattr(m, n, wrap(n))
    try:
        eng.frame(InputState.idle(0), 1 / 60)  # a map frame
    finally:
        for m, n in saved:
            setattr(m, n, fns[n])
    return calls


@pytest.fixture(scope="module", params=["space-1080p-10k",
                                        "space-1080p-10k-default"])
def calls(request):
    return _recorded_calls(request.param)


def test_frozen_bounds_equal_the_ports(calls):
    from render_engine_tpu_torch import kernel_bounds as KB

    seen = set()
    for name, a, kw in calls:
        if name == "tile_raster":
            got = bounds.tile_raster_work(*a, **kw)
            want = KB.tile_raster_work(*a, **kw)
            seen.add("k1" if kw["two_pass"] else "k1_one_pass")
        elif name == "resolve_attributes_pallas":
            got, want = bounds.resolve_work(*a[:2]), KB.resolve_work(*a[:2])
            seen.add("k2")
        else:
            got = bounds.fused_shade_work(*a, **kw)
            want = KB.fused_shade_work(*a, **kw)
            seen.add("k3")
        assert got == want
        assert bounds.bound(got["bytes"], got["ops"]) == KB.bound(
            want["bytes"], want["ops"])
    assert {"k1", "k1_one_pass", "k2"} <= seen


def test_peaks_are_the_data_sheets():
    assert bounds.H100_BYTES_PER_S == 3.35e12
    assert bounds.H100_F32_OPS_PER_S == 67e12


def test_device_activity_union():
    rows = [(0.0, 10.0), (5.0, 12.0), (20.0, 25.0), (30.0, 31.0),
            (30.5, 30.7)]
    act = tracing.device_activity(rows)
    assert act["rows"] == 5
    assert act["sum_us"] == pytest.approx(10 + 7 + 5 + 1 + 0.2)
    assert act["busy_us"] == pytest.approx(12 + 5 + 1)
    assert act["gaps"] == [(12.0, 20.0), (25.0, 30.0)]
    assert tracing.device_activity([]) == {"rows": 0, "sum_us": 0.0,
                                           "busy_us": 0.0, "gaps": []}


def test_device_activity_matches_the_ports_on_random_rows():
    from types import SimpleNamespace

    from render_engine_tpu_torch.runtime.profiling import device_activity

    rng = np.random.default_rng(3)
    starts = rng.uniform(0, 1000, 200)
    rows = [(float(s), float(s + d)) for s, d in
            zip(starts, rng.exponential(5.0, 200))]
    events = [SimpleNamespace(device_type=torch.autograd.DeviceType.CUDA,
                              time_range=SimpleNamespace(start=s, end=e))
              for s, e in rows]
    want = device_activity(events)
    got = tracing.device_activity(rows)
    assert got["rows"] == want["rows"]
    assert got["sum_us"] / 1e3 == pytest.approx(want["sum_ms"])
    assert got["busy_us"] / 1e3 == pytest.approx(want["busy_ms"])


def test_gaps_named_by_the_innermost_host_operation():
    gaps = [(10.0, 20.0), (30.0, 32.0)]
    host = [(0.0, 100.0, "outer"), (9.0, 19.0, "cudaStreamSynchronize"),
            (31.0, 40.0, "cudaGraphLaunch")]
    named = tracing.name_gaps(gaps, host)
    assert named == [("cudaStreamSynchronize", 10.0), ("cudaGraphLaunch", 2.0)]
    assert tracing.name_gaps([(1.0, 2.0)], []) == [
        ("host, outside any profiled operation", 1.0)]


def test_kernel_kinds_by_profiler_name():
    assert tracing.kernel_kind("void tile_raster_kernel<false>(float const*)"
                               ) == "k1_one_pass"
    assert tracing.kernel_kind("void tile_raster_kernel<true>(float)") == "k1"
    assert tracing.kernel_kind("resolve_kernel(int const*)") == "k2"
    assert tracing.kernel_kind("fused_shade_kernel(ShadeArgs)") == "k3"
    assert tracing.kernel_kind("void at::native::elementwise") is None


def test_metric_readers_on_a_record():
    rec = {"dispatch_s": [0.001, 0.003], "capture_seconds": {("a",): 1.5,
                                                             ("b",): 0.5},
           "step_ms": 3.0, "render_ms": None,
           "profile": {"frames": 30, "rows": 3000, "span_ms": 200.0,
                       "busy_us": 150000.0, "roofline_pct": 48.0}}
    read = {m["name"]: manifest.metric_reader(m["name"])(rec)
            for m in manifest.load()["per_layer"]}
    assert read["engine.dispatch_ms"] == pytest.approx(2.0)
    assert read["engine.capture_s"] == 2.0
    assert read["step.ms"] == 3.0 and read["render.ms"] is None
    assert read["device.idle_share"] == pytest.approx(0.25)
    assert read["device.rows_per_frame"] == 100.0
    assert read["kernels.hand_roofline"] == 48.0
    assert manifest.metric_reader("kernels.hand_roofline")({}) is None
    json.dumps(read)
