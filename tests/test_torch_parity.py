"""The port's parity harness (fast mode, synthetic corpus, the CPU): every
one of the 30 reference cells is populated through the port's three tier
runners (mirrors tests/test_parity_check.py), with the JAX package's
cells and tolerances."""
import csv

import numpy as np
import pytest

from vae_hmc_tpu.pipelines import parity as jparity
from vae_hmc_tpu_torch.core.config import Workspace
from vae_hmc_tpu_torch.pipelines import parity
from vae_hmc_tpu_torch.pipelines.sources import SyntheticSource


@pytest.fixture(scope="module")
def parity_rows(tmp_path_factory):
    ws = Workspace(tmp_path_factory.mktemp("torch_parity_ws"))
    src = SyntheticSource.make(24, seed=42, lyrics_coverage=0.9)
    return parity.run_parity_check(src, ws, fast=True, device_batch=12,
                                   device="cpu")


def test_reference_cells_match_jax():
    assert parity.REFERENCE_CELLS == jparity.REFERENCE_CELLS
    assert len(parity.REFERENCE_CELLS) == 30


def test_every_reference_cell_is_populated(parity_rows):
    assert [r.name for r in parity_rows] == list(parity.REFERENCE_CELLS)
    missing = [r.name for r in parity_rows if r.ours is None]
    assert not missing, f"cells with no extracted value: {missing}"


def test_row_semantics_and_table(parity_rows):
    for r in parity_rows:
        assert np.isfinite(r.ours), r.name
        if r.name.endswith((".silhouette", ".ari", ".nmi", ".purity")):
            assert -1.0 - 1e-6 <= r.ours <= 1.0 + 1e-6, (r.name, r.ours)
        assert r.passed == (abs(r.ours - r.ref) <= r.tol)
        want_tol = (abs(r.ref) * 0.15 if "calinski" in r.name else 0.05)
        assert r.tol == pytest.approx(want_tol)
    table = parity.format_table(parity_rows)
    assert "cells within tolerance" in table
    assert all(r.name in table for r in parity_rows)
    jrows = [jparity.ParityRow(r.name, r.ref, r.ours, r.tol, r.source)
             for r in parity_rows]
    assert table == jparity.format_table(jrows)


def test_report_csv_roundtrip(parity_rows, tmp_path):
    p = tmp_path / "parity_report.csv"
    parity.save_report(parity_rows, p)
    with open(p, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == len(parity.REFERENCE_CELLS)
    assert {"cell", "reference", "ours", "tol", "passed",
            "reference_source"} <= set(rows[0])
    by_name = {r["cell"]: float(r["reference"]) for r in rows}
    assert by_name["easy.vae_kmeans.silhouette"] == pytest.approx(0.26059)
    assert by_name["hard.beta_vae.purity"] == pytest.approx(0.36743)
