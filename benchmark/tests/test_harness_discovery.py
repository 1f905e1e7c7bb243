"""A cell, a configuration and a per-layer metric are added by new files
and new BENCHMARK.json entries alone: in a copy of the benchmark, a
throwaway cell with its own configuration and metric runs end to end
(tiny, on the CPU) and its metric is read, while every file the copy
started with keeps its bytes except BENCHMARK.json."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark.tests import tiny

SCRIPT = r"""
import json, sys, time, torch
from benchmark import harness, spec
cell = spec.load_cell("throwaway.f32_job")
res = harness.run_cell(cell, 5, 0.5, True, torch.device("cpu"),
                       time.perf_counter())
print(json.dumps({"file": spec.__file__, "metrics": res["metrics"]}))
"""


def _digests(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if "__pycache__" in dirpath:
                continue
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_throwaway_cell_config_and_metric(tmp_path):
    shutil.copytree(tiny.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)

    bench = tmp_path / "benchmark"
    (bench / "configs" / "throwaway.json").write_text(
        json.dumps(tiny.conv_config()))
    wl = json.loads((bench / "workloads" / "conv_mm_vae.f32_job.json")
                    .read_text())
    wl["config"] = "throwaway"
    wl["traffic"]["device_batch"] = 8
    (bench / "workloads" / "throwaway.f32_job.json").write_text(
        json.dumps(wl))
    (bench / "metrics" / "throwaway_jobs.py").write_text(
        "def read(run):\n    return float(len(run.jobs))\n")
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["configs"].append({
        "name": "throwaway", "source": "a test",
        "file": "benchmark/configs/throwaway.json", "reduced": [],
        "why": "a test"})
    manifest["workloads"].append({
        "name": "throwaway.f32_job", "config": "throwaway",
        "traffic": "f32_job", "chips": 1, "why": "a test"})
    manifest["per_layer"].append({
        "name": "throwaway_jobs", "unit": "jobs", "better": "higher",
        "source": "program_counter", "layer": "harness",
        "moves": "tracks_per_s", "workloads": ["throwaway.f32_job"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(tiny.ROOT)]))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["file"].startswith(str(tmp_path))
    assert out["metrics"]["throwaway_jobs"]["value"] >= 1
    assert out["metrics"]["throwaway_jobs"]["unit"] == "jobs"

    after = _digests(tmp_path)
    changed = {k for k in before if after.get(k) != before[k]}
    assert changed == {"BENCHMARK.json"}
