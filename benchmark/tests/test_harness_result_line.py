"""The result line's keys, untraced and traced, with the compared numbers
last; and no result without a card."""
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

BASE = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("trace", [False, True])
def test_keys(trace):
    cell = tiny.conv_cell()
    res = harness.run_cell(cell, 11, 0.2, trace, torch.device("cpu"),
                           time.perf_counter())
    keys = list(res)
    assert set(keys) == BASE | {"checks"} | ({"breakdown"} if trace
                                              else set())
    assert keys[-1] == "checks"
    assert set(res["checks"]) == set(cell.workload["limits"])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    assert isinstance(res["correct"], bool)
    assert res["attempted"] >= 1 and res["failed"] == 0
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert "train_s" in res["metrics"]
    else:
        assert set(res["metrics"]) == {"tracks_per_s", "setup_s"}
        assert res["metrics"]["tracks_per_s"]["unit"] == "tracks/s"
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_no_card_no_result():
    env = dict(os.environ, PYTHONPATH=str(tiny.ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "conv_mm_vae.f32_job", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tiny.ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
