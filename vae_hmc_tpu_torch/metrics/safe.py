"""Noise-aware metric wrappers (copy of ``vae_hmc_tpu.metrics.safe`` on the
port's metrics).

Conventions preserved from the reference (scripts/09:49-60, 13:62-112,
16:57-106, 20:40-47):
  - silhouette / Davies-Bouldin / Calinski-Harabasz drop DBSCAN noise
    points (label == -1) before scoring and return None when fewer than 2
    clusters remain (silhouette also when fewer than 3 points remain);
  - ARI keeps noise points as a regular label (13:103-111).
A degenerate cell yields None, as in the reference.  The JAX package also
turns ANY exception into None; here only the metrics' own ValueError for
degenerate labels does, so a kernel or CUDA error propagates.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from vae_hmc_tpu_torch.metrics import external, internal


def _drop_noise(x, labels):
    labels = np.asarray(labels)
    keep = labels != -1
    return np.asarray(x)[keep], labels[keep]


def safe_silhouette(x, labels, device="cuda") -> Optional[float]:
    xk, lk = _drop_noise(x, labels)
    if len(np.unique(lk)) < 2 or len(lk) < 3:
        return None
    try:
        return internal.silhouette(xk, lk, device=device)
    except ValueError:
        return None


def safe_davies_bouldin(x, labels, device="cuda") -> Optional[float]:
    xk, lk = _drop_noise(x, labels)
    if len(np.unique(lk)) < 2:
        return None
    return internal.davies_bouldin(xk, lk, device=device)


def safe_calinski_harabasz(x, labels, device="cuda") -> Optional[float]:
    xk, lk = _drop_noise(x, labels)
    if len(np.unique(lk)) < 2:
        return None
    return internal.calinski_harabasz(xk, lk, device=device)


def safe_ari(labels_pred, labels_true) -> Optional[float]:
    try:
        return external.adjusted_rand_index(labels_pred, labels_true)
    except (ValueError, TypeError):
        return None


def noise_fraction(labels) -> float:
    labels = np.asarray(labels)
    if labels.size == 0:
        return 0.0
    return float(np.mean(labels == -1))


def n_effective_clusters(labels) -> int:
    labels = np.asarray(labels)
    return int(len(np.unique(labels[labels != -1])))
