"""BENCHMARK.json against the contract's shapes, and every file a cell
needs found by name."""

import json
import os
import re

import pytest

from port_bench import manifest

ROOT = manifest.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")

BENCH = manifest.load()
E2E = {m["name"] for m in BENCH["end_to_end"]}


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    n = len(BENCH["workloads"])
    # a full check: 2 + 14 runs a cell, each run_seconds + 60 s, each
    # cell 2 x 90 s to compile, 1200 s spare, for all 24 cells
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 \
        + 1200 <= 43200
    assert 1 <= n <= 24


def test_command_and_paths():
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(TEXT.match(w) for w in cmd)
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
        assert not p.endswith("_torch")
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])


def _entries():
    for c in BENCH["configs"]:
        yield "config", c
    for w in BENCH["workloads"]:
        yield "workload", w
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        yield "metric", m


@pytest.mark.parametrize("kind,entry", list(_entries()),
                         ids=lambda v: v if isinstance(v, str) else v["name"])
def test_names_units_and_keys(kind, entry):
    assert NAME.match(entry["name"])
    if kind == "config":
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(entry["source"]) and TEXT.match(entry["why"])
        assert all(NAME.match(k) for k in entry["reduced"])
        assert len(entry["reduced"]) <= 16
    elif kind == "workload":
        assert set(entry) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
        assert entry["chips"] in (1, 4) and TEXT.match(entry["why"])
    else:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower",
                                                                 "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        e2e = entry in BENCH["end_to_end"]
        keys = ({"name", "unit", "better", "bound", "source"} if e2e else
                {"name", "unit", "better", "source", "layer", "moves"})
        assert set(entry) - {"workloads"} == keys
        if e2e:
            assert entry["source"] in ("host_clock", "device_trace")
            assert 0.01 <= entry["bound"] <= 0.25
        else:
            assert TEXT.match(entry["layer"])


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"],
                  BENCH["end_to_end"] + BENCH["per_layer"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_moves_names_an_end_to_end_metric_of_each_cell(m):
    assert m["moves"] in E2E
    cells = m.get("workloads", [w["name"] for w in BENCH["workloads"]])
    for c in cells:
        reported = [e["name"] for e in manifest.cell_metrics(BENCH, c, False)]
        assert m["moves"] in reported, (m["name"], c)
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cfg = manifest.config(BENCH, w["config"])
    assert cfg["name"] == w["config"]
    assert "limits" in cfg
    assert callable(manifest.program(cfg).build)
    ref = manifest.reference(cfg)
    assert issubclass(ref.Control, ref.Reference)
    assert callable(manifest.state_of(cfg))
    if manifest.program_name(cfg) == "space":
        for k in ("space_config", "scene", "fused_shading",
                  "record_history"):
            assert k in cfg
    assert os.path.isfile(manifest.traffic_path(w["traffic"]))
    assert manifest.traffic(w["traffic"])["name"] == w["traffic"]
    names = {m["name"] for m in manifest.cell_metrics(BENCH, w["name"], False)}
    assert {"setup_s"} < names
    per_layer = manifest.cell_metrics(BENCH, w["name"], True)
    assert per_layer
    for m in per_layer:
        assert callable(manifest.metric_reader(m["name"]))


def test_config_files_under_paths_and_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert any(f.startswith(p + "/") for p in BENCH["paths"])
        with open(os.path.join(ROOT, f)) as fh:
            json.load(fh)


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_a_config_without_a_program_is_the_space_program():
    """A configuration file without ``"program"`` (each of today's) is
    built by ``programs/space.py`` and checked by
    ``reference/programs/space.py``, with ``reference/frames.py``'s
    ``state_of``."""
    from port_bench.programs import space
    from port_bench.reference import frames
    from port_bench.reference.programs import space as space_ref

    for c in BENCH["configs"]:
        cfg = manifest.config(BENCH, c["name"])
        assert "program" not in cfg
        assert manifest.program_name(cfg) == "space"
        assert manifest.program(cfg) is space
        assert manifest.reference(cfg) is space_ref
        assert manifest.state_of(cfg) is frames.state_of
    assert manifest.program({"program": "space"}) is space


@pytest.mark.parametrize("name", ["no_such_program", "../bench", "a.b", ""])
def test_a_program_is_found_by_its_file_alone(name):
    with pytest.raises((ModuleNotFoundError, ValueError)):
        manifest.program({"program": name})
    with pytest.raises((ModuleNotFoundError, ValueError)):
        manifest.reference({"program": name})


def test_kernel_rows_found_by_name():
    kinds = manifest.kernel_kinds()
    assert {"k1", "k1_one_pass", "k2", "k3", "deferred_shade"} <= set(kinds)
    for kind, row in kinds.items():
        assert NAME.match(kind)
        assert ":" in row.WRAPS and callable(row.work)
        assert row.EXCLUDE is None or isinstance(row.EXCLUDE, str)
