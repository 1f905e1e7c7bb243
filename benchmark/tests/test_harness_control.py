"""The control on the card at each job's own size: the plain reference in
TF32, put in the program's place, fails at least one of a cell's numbers,
and so does each planted fault of the training steps and of the answers.
The further cases (a one-restart k-means, cut UMAPs) set the upper
readings of one number each and are read, not held: a cut k-means that
lands on the best partition gives a right answer.  Skips without a card;
``python3 -m benchmark.control`` reads the same for a cell."""
import json

import pytest
import torch

from benchmark.jobs import conv_job, hard_job
from benchmark.tests import tiny

MUST_FAIL = ("control", "half_batch", "altered_label", "unchanged_state")


def _config(name):
    return json.loads((tiny.ROOT / f"benchmark/configs/{name}.json")
                      .read_text())


def _conv():
    return conv_job, _config("conv_mm_vae"), tiny.conv_cell().workload[
        "limits"]


def _hard():
    return hard_job, _config("hard_beta_vae"), tiny.hard_cell().workload[
        "limits"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [_conv, _hard], ids=["conv", "hard"])
def test_control_and_faults_fail_a_limit(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    job, cfg, limits = cell()
    readings = job.control_readings(cfg, 5, torch.device("cuda", 0))
    for case in MUST_FAIL:
        numbers = readings[case]
        failed = [k for k, v in numbers.items() if v > limits[k]]
        assert failed, (case, numbers)


@pytest.mark.parametrize("cell", [_conv, _hard], ids=["conv", "hard"])
def test_faults_fail_a_limit_on_the_cpu(cell):
    """The control's code path at a tiny size on the CPU, where TF32 does
    not exist: each planted fault fails a number."""
    job, _card_cfg, limits = cell()
    cfg = tiny.conv_config() if job is conv_job else tiny.hard_config()
    readings = job.control_readings(cfg, 5, torch.device("cpu"))
    assert "control" in readings
    for case in MUST_FAIL[1:]:
        numbers = readings[case]
        failed = [k for k, v in numbers.items() if v > limits[k]]
        assert failed, (case, numbers)
