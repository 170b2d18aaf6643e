"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
configuration's file is the one ``configs`` gives it, a traffic mix ``t``
is ``traffic/<t>.json`` and a per-layer metric ``m`` is read by
``metrics/<m>.py``. A configuration file's ``"program"`` ``p`` (``"space"``
where it has none) is built by ``programs/<p>.py`` and checked by
``reference/programs/<p>.py``; every ``kernels/<kind>.py`` is a kernel row
of the traced run. Adding one is adding files and entries."""

from __future__ import annotations

import glob
import importlib
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DEFAULT_PROGRAM = "space"
# a program's or a kernel kind's name: a module of this package
MODULE_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_path(name: str) -> str:
    return os.path.join(HERE, "traffic", f"{name}.json")


def traffic(name: str) -> dict:
    with open(traffic_path(name)) as f:
        return json.load(f)


def metric_path(name: str) -> str:
    return os.path.join(HERE, "metrics", f"{name}.py")


def metric_reader(name: str):
    """The ``read(record)`` function of ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"port_bench_metric_{name.replace('.', '_')}", metric_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: the end-to-end ones with
    ``trace`` 0, the per-layer ones with 1. A metric without ``workloads``
    belongs to every cell that reports the metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", [cell_name])
            and m["moves"] in names]


def _module(package: str, name: str):
    if not MODULE_NAME.match(name):
        raise ValueError(f"{name!r} is no module name of {package}")
    return importlib.import_module(f"port_bench.{package}.{name}")


def program_name(cfg: dict) -> str:
    return cfg.get("program", DEFAULT_PROGRAM)


def program(cfg: dict):
    """``programs/<program>.py`` of the configuration ``cfg``."""
    return _module("programs", program_name(cfg))


def reference(cfg: dict):
    """``reference/programs/<program>.py`` of the configuration ``cfg``."""
    return _module("reference.programs", program_name(cfg))


def state_of(cfg: dict):
    """The reference file's ``state_of``, or ``reference/frames.py``'s."""
    from port_bench.reference import frames

    return getattr(reference(cfg), "state_of", frames.state_of)


def kernel_kinds() -> dict:
    """Every kernel row: kind -> ``kernels/<kind>.py``, by name."""
    names = sorted(os.path.basename(p)[:-3] for p in
                   glob.glob(os.path.join(HERE, "kernels", "*.py")))
    return {n: _module("kernels", n) for n in names if n != "__init__"}
