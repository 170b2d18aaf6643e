"""The frozen bounds arithmetic (each kernel-row file, ``kernels/<kind>.py``,
and ``bounds.py``'s peaks) equals the port's ``kernel_bounds.py`` today, on
the kernels' arguments recorded in a small CPU frame of each route; the
rows' shares; and the union arithmetic of the trace."""

import importlib
import json

import numpy as np
import pytest
import torch

from port_bench import bounds, manifest, tracing

SMALL = dict(width=128, height=96, capacity=128, num_asteroids=20,
             shadow_resolution=128, shadow_max_tris=1024)
KINDS = manifest.kernel_kinds()
# the port's arithmetic each row's work is a frozen copy of
PORTS = {"k1": "tile_raster_work", "k1_one_pass": "tile_raster_work",
         "k2": "resolve_work", "k3": "fused_shade_work",
         "deferred_shade": "deferred_shade_work"}
# the kinds a map frame of each route records on the CPU
ROUTE_KINDS = {"space-1080p-10k": {"k1", "k1_one_pass", "k2"},
               "space-1080p-10k-default": {"k1", "k1_one_pass", "k2",
                                           "deferred_shade"}}


def _wrapped(row):
    path, name = row.WRAPS.split(":")
    return importlib.import_module(path), name


def _recorded_calls(config_name):
    from render_engine_tpu_torch.logic.types import InputState

    cfg = manifest.config(manifest.load(), config_name)
    eng = manifest.program(cfg).build(cfg, 5, "cpu", SMALL)
    calls = []
    saved = sorted({_wrapped(row) for row in KINDS.values()},
                   key=lambda mn: (mn[0].__name__, mn[1]))
    fns = {(m, n): getattr(m, n) for m, n in saved}

    def wrap(key):
        def f(*a, **kw):
            calls.append((key, a, kw))
            return fns[key](*a, **kw)
        return f
    for key in saved:
        setattr(*key, wrap(key))
    try:
        eng.frame(InputState.idle(0), 1 / 60)  # a map frame
    finally:
        for key in saved:
            setattr(*key, fns[key])
    return calls


@pytest.fixture(scope="module", params=sorted(ROUTE_KINDS))
def calls(request):
    return request.param, _recorded_calls(request.param)


def test_frozen_bounds_equal_the_ports(calls):
    """Each kernel row's work, and so its bound, on every recorded call of
    the wrapper it names equals the port's ``kernel_bounds``; a call is
    one kind's (K1's two modes share a wrapper)."""
    from render_engine_tpu_torch import kernel_bounds as KB

    config_name, recorded = calls
    seen = set()
    for key, a, kw in recorded:
        kinds = [(k, row) for k, row in KINDS.items()
                 if _wrapped(row) == key]
        works = [(k, row.work(*a, **kw)) for k, row in kinds]
        works = [(k, w) for k, w in works if w is not None]
        assert len(works) == 1, (key, works)
        kind, got = works[0]
        port = getattr(KB, PORTS[kind])
        want = port(*a[:2]) if kind == "k2" else port(*a, **kw)
        seen.add(kind)
        assert got == want
        assert bounds.bound(got["bytes"], got["ops"]) == KB.bound(
            want["bytes"], want["ops"])
    assert ROUTE_KINDS[config_name] <= seen


def test_kernel_rows_name_the_ports_wrappers():
    assert set(KINDS) == set(PORTS)
    for kind, row in KINDS.items():
        mod, name = _wrapped(row)
        assert callable(getattr(mod, name)), kind
        assert row.PROFILER_NAME and callable(row.work)


def test_the_recorder_records_each_kinds_bound(calls):
    """``tracing._Recorder`` over one frame: the bounds by kind are those
    of the rows' work on the same calls, and the wrappers are put back."""
    from render_engine_tpu_torch.logic.types import InputState

    config_name, recorded = calls
    want: dict = {}
    for key, a, kw in recorded:
        for k, row in KINDS.items():
            w = row.work(*a, **kw) if _wrapped(row) == key else None
            if w is not None:
                want.setdefault(k, []).append(
                    bounds.bound(w["bytes"], w["ops"])[0])
    cfg = manifest.config(manifest.load(), config_name)
    eng = manifest.program(cfg).build(cfg, 5, "cpu", SMALL)
    before = {key: getattr(*key) for key in map(_wrapped, KINDS.values())}
    with tracing._Recorder(KINDS) as rec:
        eng.frame(InputState.idle(0), 1 / 60)
    assert rec.bounds == want
    assert {key: getattr(*key) for key in before} == before


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
    assert tracing.kernel_kind("deferred_shade_kernel(DeferredArgs)"
                               ) == "deferred_shade"
    assert tracing.kernel_kind("void at::native::elementwise") is None


def test_a_name_two_rows_claim_fails():
    from types import SimpleNamespace

    rows = {"a": SimpleNamespace(PROFILER_NAME="shade", EXCLUDE=None),
            "b": SimpleNamespace(PROFILER_NAME="shade_kernel", EXCLUDE=None)}
    assert tracing.kernel_kind("deferred_shadow", rows) is None
    with pytest.raises(RuntimeError, match="claim"):
        tracing.kernel_kind("fused_shade_kernel", rows)


# profiled launches and us, and bounds (ms), of a default-route and a
# fused-route stretch of frames
PROFILED = {"k1": (30, 1200.0), "k1_one_pass": (10, 400.0),
            "k2": (60, 10000.0), "k3": (30, 1500.0)}
BOUNDS_MS = {"k1": 0.0151, "k1_one_pass": 0.0041, "k2": 0.1217,
             "k3": 0.0308}


def test_the_hand_roofline_is_over_the_four_kinds_alone():
    """``roofline_pct`` over K1, K1 one-pass, K2 and K3 reads the same
    with a ``deferred_shade`` row beside them, and is their summed bound
    over their summed time; ``roofline_by_kind`` gives each kind's."""
    want = 100.0 * sum(n * BOUNDS_MS[k] for k, (n, _) in PROFILED.items()
                       ) / (sum(us for _, us in PROFILED.values()) / 1e3)
    assert tracing.roofline_pct(PROFILED, BOUNDS_MS) == pytest.approx(want)
    with_ds = dict(PROFILED, deferred_shade=(30, 2800.0))
    ds_bounds = dict(BOUNDS_MS, deferred_shade=0.0261)
    assert tracing.roofline_pct(with_ds, ds_bounds) == \
        tracing.roofline_pct(PROFILED, BOUNDS_MS)
    by_kind = tracing.roofline_by_kind(with_ds, ds_bounds)
    assert by_kind["deferred_shade"] == pytest.approx(
        100.0 * 30 * 0.0261 / 2.8)
    assert by_kind["k2"] == pytest.approx(100.0 * 60 * 0.1217 / 10.0)
    assert set(by_kind) == set(with_ds)
    # no hand kernel profiled: no hand share
    only_ds = {"deferred_shade": (30, 2800.0)}
    assert tracing.roofline_pct(only_ds, {"deferred_shade": 0.0261}) is None


@pytest.mark.parametrize("profiled,bounded", [
    (PROFILED, dict(BOUNDS_MS, deferred_shade=0.0261)),
    (dict(PROFILED, deferred_shade=(30, 2800.0)), BOUNDS_MS),
    ({}, {})])
def test_a_kind_profiled_without_a_bound_fails(profiled, bounded):
    with pytest.raises(RuntimeError, match="profiled"):
        tracing.roofline_pct(profiled, bounded)
    with pytest.raises(RuntimeError, match="profiled"):
        tracing.roofline_by_kind(profiled, bounded)


def test_metric_readers_on_a_record():
    rec = {"dispatch_s": [0.001, 0.003], "capture_seconds": {("a",): 1.5,
                                                             ("b",): 0.5},
           "step_ms": 3.0, "render_ms": None,
           "profile": {"frames": 30, "rows": 3000, "span_ms": 200.0,
                       "busy_us": 150000.0, "roofline_pct": 48.0,
                       "roofline_by_kind": {"k1": 40.0,
                                            "deferred_shade": 28.0}}}
    read = {m["name"]: manifest.metric_reader(m["name"])(rec)
            for m in manifest.load()["per_layer"]}
    assert read["engine.dispatch_ms"] == pytest.approx(2.0)
    assert read["engine.capture_s"] == 2.0
    assert read["step.ms"] == 3.0 and read["render.ms"] is None
    assert read["device.idle_share"] == pytest.approx(0.25)
    assert read["device.rows_per_frame"] == 100.0
    assert read["kernels.hand_roofline"] == 48.0
    assert read["kernels.deferred_shade_roofline"] == 28.0
    for m in ("kernels.hand_roofline", "kernels.deferred_shade_roofline"):
        assert manifest.metric_reader(m)({}) is None
    rec["profile"]["roofline_by_kind"] = {"k1": 40.0}  # the fused route
    assert manifest.metric_reader("kernels.deferred_shade_roofline")(
        rec) is None
    json.dumps(read)
