"""Adjusted Rand index (copy of ``vae_hmc_tpu.metrics.external``; numpy).

Contingency-matrix based, matching sklearn.metrics.adjusted_rand_score;
reductions in float64 on the host (the matrix is k_a x k_b, tiny).
"""
from __future__ import annotations

import numpy as np

from vae_hmc_tpu_torch.metrics.internal import _as_codes


def contingency_matrix(labels_a, labels_b) -> np.ndarray:
    """(k_a, k_b) count matrix; noise labels (-1) are an ordinary class."""
    a = _as_codes(labels_a)
    b = _as_codes(labels_b)
    ka, kb = int(a.max()) + 1, int(b.max()) + 1
    m = np.zeros((ka, kb), dtype=np.int64)
    np.add.at(m, (a, b), 1)
    return m


def _comb2(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64)
    return x * (x - 1.0) / 2.0


def adjusted_rand_index(labels_a, labels_b) -> float:
    """sklearn.metrics.adjusted_rand_score."""
    m = contingency_matrix(labels_a, labels_b)
    n = m.sum()
    sum_comb_c = _comb2(m.sum(axis=1)).sum()
    sum_comb_k = _comb2(m.sum(axis=0)).sum()
    sum_comb = _comb2(m).sum()
    total = _comb2(np.array([n]))[0]
    if total == 0:
        return 1.0
    expected = sum_comb_c * sum_comb_k / total
    max_index = 0.5 * (sum_comb_c + sum_comb_k)
    denom = max_index - expected
    if denom == 0:
        return 1.0
    return float((sum_comb - expected) / denom)
