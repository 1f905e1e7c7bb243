"""BENCHMARK.json against the contract's form: names, units, keys, and a
file or module for every cell, configuration and metric."""
import importlib
import json
import re

import pytest

from benchmark import spec
from benchmark.tests.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_names(manifest):
    assert set(manifest) == KEYS["top"]
    names = []
    for section, key in (("configs", "config"), ("workloads", "workload"),
                         ("end_to_end", "end_to_end"),
                         ("per_layer", "per_layer")):
        for entry in manifest[section]:
            extra = set(entry) - KEYS[key]
            assert extra <= ({"workloads"} if section in (
                "end_to_end", "per_layer") else set()), (section, extra)
            assert KEYS[key] <= set(entry), (section, entry)
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for section in ("configs", "workloads"):
        got = [n for s, n in names if s == section]
        assert len(got) == len(set(got))
    metrics = [n for s, n in names if s in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))


def test_one_line_texts_and_limits(manifest):
    for entry in manifest["configs"] + manifest["workloads"]:
        for key in ("why", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200
                assert "\n" not in entry[key] and "\t" not in entry[key]
    for m in manifest["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
        assert m["moves"] in {e["name"] for e in manifest["end_to_end"]}
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert 1 <= manifest["run_seconds"] <= 51
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e


def test_every_piece_is_found(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    for c in manifest["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in manifest["paths"]))
    for w in manifest["workloads"]:
        assert w["config"] in configs
        assert w["chips"] in (1, 4)
        wl = json.loads((ROOT / "benchmark/workloads" / f"{w['name']}.json")
                        .read_text())
        assert wl["config"] == w["config"]
        job = importlib.import_module(f"benchmark.jobs.{wl['job']}")
        assert hasattr(job, "Job")
        assert set(wl["limits"]) and all(
            v >= 0 for v in wl["limits"].values())
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {e["name"]: e for e in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
        assert set(m.get("workloads", cells)) <= cells
        # every cell that reports the metric reports what it moves
        moved = e2e[m["moves"]]
        assert set(m.get("workloads", cells)) <= set(
            moved.get("workloads", cells))
    for c in cells:
        reported = [m for m in manifest["per_layer"]
                    if c in m.get("workloads", cells)]
        assert reported, c
        rates = [e for e in manifest["end_to_end"] if e["name"] != "setup_s"
                 and c in e.get("workloads", cells)]
        assert rates, c


def test_command_stays_in_paths(manifest):
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32
    assert not any(w.startswith("/") or ".." in w for w in cmd)
    for p in manifest["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert not p.endswith("_torch")
