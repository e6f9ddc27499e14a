"""BENCHMARK.json against the files it names, and discovery of files a
later change adds without editing any."""
import json
import os
import re
import shutil

import pytest

from benchmark.lib import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return registry.load_benchmark()


def test_every_name_resolves(bench):
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(registry.ROOT, c["file"]))
        assert registry.config(bench, c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        traffic = registry.traffic(w["traffic"])
        assert hasattr(registry.driver(traffic["driver"]), "Cell")
        assert set(traffic["limits"]) and traffic["checked_frames"] >= 1
    for m in bench["per_layer"]:
        assert callable(registry.metric_reader(m["name"]).read)


def test_contract_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in bench[k]}) == len(bench[k])
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert w["config"] in {c["name"] for c in bench["configs"]}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        e2e = registry.cell_metrics(bench, w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert registry.cell_metrics(bench, w["name"], "per_layer")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert all(m["moves"] in e2e for m in bench["per_layer"])
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(bench)) < 64 * 1024


def test_added_files_are_found_without_edits(tmp_path, monkeypatch, bench):
    """A new configuration, traffic mix and metric reader, as files in a
    copy of the benchmark, are found by name."""
    root = tmp_path / "checkout"
    shutil.copytree(registry.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    b = root / "benchmark"
    (b / "configs" / "scan_icp_f.json").write_text(json.dumps(
        dict(registry.config(bench, "scan_icp"), name="scan_icp_f")))
    mix = registry.traffic("room1m")
    mix["points"] = 500000
    (b / "traffic" / "room500k.json").write_text(json.dumps(mix))
    (b / "metrics" / "new.metric_ms.py").write_text(
        "FUNCTIONS = ()\n\ndef read(ctx):\n    return 1.5\n")
    added = dict(bench)
    added["configs"] = bench["configs"] + [dict(
        bench["configs"][0], name="scan_icp_f",
        file="benchmark/configs/scan_icp_f.json")]
    added["workloads"] = bench["workloads"] + [{
        "name": "scan_icp_f.room500k", "config": "scan_icp_f",
        "traffic": "room500k", "chips": 1, "why": "a test"}]
    (root / "BENCHMARK.json").write_text(json.dumps(added))
    monkeypatch.setattr(registry, "ROOT", str(root))
    monkeypatch.setattr(registry, "BENCH_DIR", str(b))
    loaded = registry.load_benchmark(str(root))
    w = registry.cell(loaded, "scan_icp_f.room500k")
    assert registry.config(loaded, w["config"])["name"] == "scan_icp_f"
    assert registry.traffic(w["traffic"])["points"] == 500000
    assert registry.metric_reader("new.metric_ms").read(None) == 1.5
