"""External (label-vs-label) clustering metrics: ARI, NMI, purity (copy of
``vae_hmc_tpu.metrics.external``; numpy).

Contingency-matrix based, matching sklearn.metrics.adjusted_rand_score and
normalized_mutual_info_score (average_method='arithmetic') and the
reference's hand-rolled crosstab-max purity (reference scripts/20:29-37);
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


def _entropy(counts: np.ndarray) -> float:
    p = counts[counts > 0].astype(np.float64)
    p = p / p.sum()
    return float(-(p * np.log(p)).sum())


def mutual_info(labels_a, labels_b) -> float:
    m = contingency_matrix(labels_a, labels_b).astype(np.float64)
    n = m.sum()
    pij = m / n
    pi = pij.sum(axis=1, keepdims=True)
    pj = pij.sum(axis=0, keepdims=True)
    nz = pij > 0
    return float((pij[nz] * (np.log(pij[nz]) - np.log((pi @ pj)[nz]))).sum())


_AVERAGES = {"arithmetic": lambda ha, hb: 0.5 * (ha + hb),
             "geometric": lambda ha, hb: np.sqrt(ha * hb),
             "min": min, "max": max}


def normalized_mutual_info(labels_a, labels_b,
                           average_method: str = "arithmetic") -> float:
    """sklearn.metrics.normalized_mutual_info_score; `average_method` is
    the mean of the two entropies that normalizes the mutual information
    (arithmetic, geometric, min or max)."""
    if average_method not in _AVERAGES:
        raise ValueError(average_method)
    a = _as_codes(labels_a)
    b = _as_codes(labels_b)
    ha = _entropy(np.bincount(a))
    hb = _entropy(np.bincount(b))
    if ha == 0.0 and hb == 0.0:
        return 1.0  # both labelings single-cluster: sklearn special case
    mi = mutual_info(a, b)
    denom = _AVERAGES[average_method](ha, hb)
    if denom == 0.0:
        return 0.0
    return float(np.clip(mi / denom, 0.0, 1.0))


def purity(cluster_labels, true_labels) -> float:
    """Crosstab-max purity (reference scripts/20:29-37): for each cluster take
    the majority true class; purity = sum(majorities) / N."""
    m = contingency_matrix(cluster_labels, true_labels)
    if m.sum() == 0:
        return 0.0
    return float(m.max(axis=1).sum() / m.sum())
