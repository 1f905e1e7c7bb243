"""The conv history limits of ``chip_smoke.py`` phase 10 on the CPU.

Phase 10 holds the data- and tensor-parallel conv fits' histories to the
single-process fit's within a limit measured in the same run: 3 x the
largest pairwise gap of an ensemble of fits that differ in roundoff only
(the nondeterministic fit, the split witness, and fits with one initial
weight moved 1 ulp up).  These tests hold the arithmetic of that limit,
the check that applies it, and the nudge, without a card.
"""
import math
import types

import pytest
import torch

import chip_smoke
from vae_hmc_tpu_torch.models import train


def _hist(*rows):
    return [{"epoch": e + 1, "total": t, "recon": r, "kl": k}
            for e, (t, r, k) in enumerate(rows)]


def test_roundoff_limits_are_factor_times_the_largest_pairwise_gap():
    members = {"a": _hist((1.0, 0.9, 0.1), (0.8, 0.7, 0.1)),
               "b": _hist((1.0003, 0.9001, 0.1), (0.8, 0.7, 0.1002)),
               "c": _hist((0.9999, 0.9, 0.1), (0.8001, 0.6995, 0.1))}
    limits = chip_smoke._roundoff_limits(members, 3.0)
    # total: b vs c in epoch 1; recon: c vs a and b in epoch 2; kl: b vs
    # a and c in epoch 2
    assert limits == pytest.approx({"total": 3 * 4e-4, "recon": 3 * 5e-4,
                                    "kl": 3 * 2e-4}, rel=1e-9)
    assert chip_smoke._roundoff_limits({"a": members["a"]}, 3.0) == {
        "total": 0.0, "recon": 0.0, "kl": 0.0}


@pytest.mark.parametrize("col", ["total", "recon", "kl"])
def test_history_check_applies_each_columns_limit(col):
    want = _hist((0.9267, 0.8579, 0.0688))
    limits = {"total": 2e-3, "recon": 1e-3, "kl": 3e-4}
    inside = [dict(want[0])]
    inside[0][col] += 0.99 * limits[col]
    gaps, bad = chip_smoke._hist_gaps(inside, want, 0.0, 1e-6, limits)
    assert bad is None and gaps[col] == pytest.approx(0.99 * limits[col])
    outside = [dict(want[0])]
    outside[0][col] -= 1.01 * limits[col] + 1e-6
    _, bad = chip_smoke._hist_gaps(outside, want, 0.0, 1e-6, limits)
    assert bad is not None and bad.startswith(col)
    # without limits only rtol and atol count
    _, bad = chip_smoke._hist_gaps(inside, want, 0.0, 1e-6)
    assert bad is not None


def test_a_skipped_all_reduce_lies_outside_a_roundoff_ensembles_limits():
    """Gaps of the size phase 10 logs on an H100 (one epoch, full width):
    roundoff moves the history by a few 1e-4, the planted fault (each rank
    stepping on its own rows' gradients) by 1.7e-2 in the total."""
    base = (0.9266896, 0.8578929, 0.0687966)
    members = {"(a)": _hist(base),
               "nondeterministic": _hist((base[0] + 2.9e-4, base[1] + 4.0e-4,
                                          base[2] - 1.1e-4)),
               "split": _hist((base[0] - 2.9e-4, base[1] - 3.1e-4,
                               base[2] + 2.3e-5))}
    limits = chip_smoke._roundoff_limits(members, chip_smoke.P10_SPREAD_FACTOR)
    sound = _hist((base[0] + 5.5e-4, base[1] + 6.1e-4, base[2] - 6e-5))
    assert chip_smoke._hist_gaps(sound, members["(a)"], 0.0, 1e-6,
                                 limits)[1] is None
    assert chip_smoke._hist_gaps(sound, members["split"], 0.0, 1e-6,
                                 limits)[1] is None
    fault = _hist((base[0] + 1.72e-2, base[1] + 1.69e-3, base[2] + 1.55e-2))
    assert chip_smoke._hist_gaps(fault, members["(a)"], 0.0, 1e-6,
                                 limits)[1] is not None


def test_nudged_fit_moves_one_element_one_ulp_up(monkeypatch):
    model = torch.nn.Sequential(torch.nn.Linear(3, 2))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    seen = {}

    def fake_fit(m, arrays, **kw):
        seen.update({k: v.clone() for k, v in m.state_dict().items()},
                    kw=kw, arrays=arrays)
        return types.SimpleNamespace(history=_hist((1.0, 0.9, 0.1)))

    monkeypatch.setattr(train, "fit", fake_fit)
    hist = chip_smoke._p10_nudged_fit(model, "0.weight", ("x",), epochs=1)
    assert hist == _hist((1.0, 0.9, 0.1))
    assert seen["kw"] == {"epochs": 1} and seen["arrays"] == ("x",)
    assert torch.equal(seen["0.bias"], before["0.bias"])
    w0, w1 = before["0.weight"].view(-1), seen["0.weight"].view(-1)
    assert torch.equal(w0[1:], w1[1:])
    assert w1[0] > w0[0]
    assert torch.equal(w1[0], torch.nextafter(w0[0], torch.tensor(math.inf)))
