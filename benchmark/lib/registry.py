"""Finds a cell's files by the names in BENCHMARK.json: its
configuration (`configs/<config>.json`), its traffic
(`traffic/<traffic>.json`, which names a driver under `drivers/`) and
each of its metrics' readers (`metrics/<metric>.py`). Adding a cell,
a configuration, a mix or a metric adds files; nothing here changes."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(*parts) -> dict:
    with open(os.path.join(BENCH_DIR, *parts)) as fh:
        return json.load(fh)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(ROOT, c["file"])) as fh:
                return json.load(fh)
    raise KeyError(f"no config named {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json("traffic", name + ".json")


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def metric_reader(name: str):
    """The module of `metrics/<name>.py` (a name may hold dots)."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell_metrics(bench: dict, workload: str, kind: str) -> list:
    """The `end_to_end` or `per_layer` entries the cell reports."""
    return [m for m in bench[kind] if applies(m, workload)]
