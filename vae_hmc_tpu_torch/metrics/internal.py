"""Internal clustering metrics on kernel 2 (port of
``vae_hmc_tpu.metrics.internal`` silhouette and davies_bouldin).

sklearn conventions: euclidean distances of the mean-centred features
(centring bounds the f32 cancellation of |a|^2 + |b|^2 - 2ab); a point in a
singleton cluster scores 0; ``b`` takes the nearest OTHER non-empty
cluster.  Every distance goes through ``ops.kernels.distance``: one launch
for silhouette, two for Davies-Bouldin (points -> centroids, centroids ->
centroids).
"""
from __future__ import annotations

import numpy as np
import torch

from vae_hmc_tpu_torch.core.device import resolve_device
from vae_hmc_tpu_torch.ops.kernels.distance import pairwise_dists


def _as_codes(labels) -> np.ndarray:
    """Labels -> dense 0..k-1 int codes (sorted-unique order, sklearn-style)."""
    _, codes = np.unique(np.asarray(labels), return_inverse=True)
    return codes.astype(np.int64)


def _center(x, dev: torch.device) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    return (x - torch.mean(x, dim=0, keepdim=True)).contiguous()


def _silhouette_from_d(d: torch.Tensor, codes: torch.Tensor,
                       n_clusters: int) -> torch.Tensor:
    onehot = torch.nn.functional.one_hot(codes, n_clusters).to(d.dtype)
    counts = torch.sum(onehot, dim=0)                       # (k,)
    sums = torch.matmul(d, onehot)                          # (N, k)
    own = counts[codes]
    intra = torch.gather(sums, 1, codes[:, None])[:, 0]
    a = intra / torch.clamp(own - 1.0, min=1.0)
    mean_other = sums / torch.clamp(counts[None, :], min=1.0)
    mask = onehot.bool() | (counts[None, :] == 0)           # own + empty
    b = torch.amin(torch.where(mask, torch.inf, mean_other), dim=1)
    s = (b - a) / torch.clamp(torch.maximum(a, b), min=1e-30)
    s = torch.where(own <= 1.0, 0.0, s)      # singleton clusters score 0
    return torch.mean(s)


def silhouette(x, labels, device="cuda") -> float:
    """sklearn.metrics.silhouette_score (euclidean, full, no sampling)."""
    dev = resolve_device(device)
    codes = _as_codes(labels)
    k = int(codes.max()) + 1 if codes.size else 0
    if k < 2 or k > len(codes) - 1:
        raise ValueError("silhouette requires 2 <= n_labels <= n_samples - 1")
    xc = _center(x, dev)
    d = pairwise_dists(xc)
    return float(_silhouette_from_d(d, torch.as_tensor(codes, device=dev), k))


def davies_bouldin(x, labels, device="cuda") -> float:
    """sklearn.metrics.davies_bouldin_score."""
    dev = resolve_device(device)
    codes_np = _as_codes(labels)
    k = int(codes_np.max()) + 1
    if k < 2:
        raise ValueError("davies_bouldin requires >= 2 clusters")
    xc = _center(x, dev)
    codes = torch.as_tensor(codes_np, device=dev)
    onehot = torch.nn.functional.one_hot(codes, k).to(xc.dtype)
    counts = torch.clamp(torch.sum(onehot, dim=0), min=1.0)
    centroids = (torch.matmul(onehot.T, xc) / counts[:, None]).contiguous()
    d_pc = pairwise_dists(xc, centroids)                    # (N, k)
    s = torch.sum(d_pc * onehot, dim=0) / counts            # (k,)
    m = pairwise_dists(centroids)                           # (k, k)
    r = (s[:, None] + s[None, :]) / torch.where(m > 0, m, torch.inf)
    r = torch.where(torch.eye(k, dtype=torch.bool, device=dev), -torch.inf, r)
    return float(torch.mean(torch.amax(r, dim=1)))
