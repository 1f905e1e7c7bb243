"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have: a step that leaves the state as it is; half
of each batch left out, the mean taken over the rest; an answer altered
where it is produced (one KMeans label); a fit one epoch short.  (Every cell runs on one chip:
there is no exchange between chips to leave out.)  Tiny, on the CPU, the
card's look skipped; the sound run passes the same numbers."""
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny


def _no_step(monkeypatch):
    class FrozenAdam(torch.optim.Adam):
        def step(self, closure=None):
            return None

    monkeypatch.setattr(torch.optim, "Adam", FrozenAdam)


def _half_batch(monkeypatch):
    from vae_hmc_tpu_torch.models import train

    own_rows, elbo = train._own_rows, train.elbo_loss_rows

    def half_rows(*a, **k):
        rows = own_rows(*a, **k)

        def first_half(i):
            local, pos = rows(i)
            h = max(1, len(local) // 2)
            return local[:h], pos[:h]
        return first_half

    def mean_over_rest(xhat, x, mu, logvar, beta, reduction, batch_size):
        return elbo(xhat, x, mu, logvar, beta, reduction, x.shape[0])

    mse = train.mse_rows
    monkeypatch.setattr(train, "_own_rows", half_rows)
    monkeypatch.setattr(train, "elbo_loss_rows", mean_over_rest)
    monkeypatch.setattr(train, "mse_rows",
                        lambda xhat, x, batch_size: mse(xhat, x, x.shape[0]))


def _altered_label(monkeypatch):
    from vae_hmc_tpu_torch.cluster import kmeans as km_mod
    from vae_hmc_tpu_torch.pipelines import hard

    kmeans = km_mod.kmeans

    def altered(*a, **k):
        res = kmeans(*a, **k)
        labels = np.array(res.labels)
        labels[0] = (labels[0] + 1) % len(res.centers)
        res.labels = labels
        return res

    monkeypatch.setattr(km_mod, "kmeans", altered)
    monkeypatch.setattr(hard, "kmeans", altered)


def _short_fit(monkeypatch):
    from vae_hmc_tpu_torch.models import api

    fit = api.fit

    def one_epoch_less(*a, **k):
        k["epochs"] = max(1, k["epochs"] - 1)
        return fit(*a, **k)

    monkeypatch.setattr(api, "fit", one_epoch_less)


FAULTS = {
    "conv": {"unchanged_state": (_no_step, "delta3"),
             "half_batch": (_half_batch, "grad0"),
             "altered_label": (_altered_label, "km_assign"),
             "short_fit": (_short_fit, "steps")},
    "hard": {"unchanged_state": (_no_step, "vae_delta3"),
             "half_batch": (_half_batch, "vae_loss3"),
             "altered_label": (_altered_label, "km_assign"),
             "short_fit": (_short_fit, "vae_steps")},
}
CELLS = {"conv": tiny.conv_cell, "hard": tiny.hard_cell}


def _run(cell):
    return harness.run_cell(CELLS[cell](), 21, 0.2, False,
                            torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS)
                                        for f in sorted(FAULTS[c])])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    plant, number = FAULTS[cell][fault]
    plant(monkeypatch)
    res = _run(cell)
    assert res["correct"] is False
    c = res["checks"][number]
    assert c["value"] > c["limit"], (fault, c)


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_sound_run_passes_the_fault_numbers(cell):
    res = _run(cell)
    for _plant, number in FAULTS[cell].values():
        c = res["checks"][number]
        assert c["value"] <= c["limit"], (number, c)
