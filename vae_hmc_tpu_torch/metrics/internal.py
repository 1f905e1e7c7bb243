"""Internal clustering metrics on kernel 2 (port of
``vae_hmc_tpu.metrics.internal``).

sklearn conventions: euclidean distances of the mean-centred features
(centring bounds the f32 cancellation of |a|^2 + |b|^2 - 2ab); a point in a
singleton cluster scores 0; ``b`` takes the nearest OTHER non-empty
cluster.  Every distance goes through ``ops.kernels.distance``: one launch
for silhouette, two for Davies-Bouldin (points -> centroids, centroids ->
centroids).

The masked variants score the points labelled >= 0 only (DBSCAN noise, -1,
carries zero weight) without subsetting the distance or feature matrix, so
a sweep reuses one device-resident matrix for every cell.  ``lazy=True``
returns the 0-d device tensor, so a sweep fetches every cell's scores in
one transfer.  (The JAX package pads k to a bucket to limit XLA compiles;
nothing here compiles per k, so k is exact.)
"""
from __future__ import annotations

import numpy as np
import torch

from vae_hmc_tpu_torch.core.device import resolve_device
from vae_hmc_tpu_torch.core.profiling import as_tensor, span, sync
from vae_hmc_tpu_torch.ops.kernels.distance import pairwise_dists


def _as_codes(labels) -> np.ndarray:
    """Labels -> dense 0..k-1 int codes (sorted-unique order, sklearn-style)."""
    _, codes = np.unique(np.asarray(labels), return_inverse=True)
    return codes.astype(np.int64)


def _masked_codes(labels):
    """-> (codes with -1 for noise, k) over the labels >= 0; raises unless
    at least 2 clusters remain."""
    labels = np.asarray(labels)
    classes = np.unique(labels[labels >= 0])
    if len(classes) < 2:
        raise ValueError("need >= 2 clusters among non-noise points")
    codes = np.full(labels.shape, -1, dtype=np.int64)
    keep = labels >= 0
    codes[keep] = np.searchsorted(classes, labels[keep])
    return codes, len(classes)


def center(x, dev: torch.device) -> torch.Tensor:
    """(N, ...) -> (N, d) float32 rows on `dev` minus their mean, contiguous."""
    x = as_tensor(x, dev, "metrics.input", torch.float32)
    x = x.reshape(x.shape[0], -1)
    return (x - torch.mean(x, dim=0, keepdim=True)).contiguous()


def centered_euclidean_dists(x, device="cuda") -> torch.Tensor:
    """(N, ...) -> (N, N) euclidean distances of the mean-centred flattened
    rows: one kernel 2 launch (the sweep's per-representation cache).  A
    tensor argument stays on its own device."""
    dev = x.device if isinstance(x, torch.Tensor) else resolve_device(device)
    return pairwise_dists(center(x, dev))


def _onehot(codes: torch.Tensor, n_clusters: int) -> torch.Tensor:
    """(N, k) float one-hot; rows with code -1 are all zero."""
    valid = codes >= 0
    onehot = torch.nn.functional.one_hot(torch.where(valid, codes, 0),
                                         n_clusters).to(torch.float32)
    return onehot * valid[:, None]


def _silhouette_from_d(d: torch.Tensor, codes: torch.Tensor,
                       n_clusters: int) -> torch.Tensor:
    """Mean silhouette over the points with code >= 0, from the full (N, N)
    distance matrix."""
    valid = codes >= 0
    safe = torch.where(valid, codes, 0)
    onehot = _onehot(codes, n_clusters).to(d.dtype)
    counts = torch.sum(onehot, dim=0)                       # (k,)
    sums = torch.matmul(d, onehot)                          # (N, k)
    own = counts[safe]
    intra = torch.gather(sums, 1, safe[:, None])[:, 0]
    a = intra / torch.clamp(own - 1.0, min=1.0)
    mean_other = sums / torch.clamp(counts[None, :], min=1.0)
    mask = (torch.nn.functional.one_hot(safe, n_clusters).bool()
            | (counts[None, :] == 0))                       # own + empty
    b = torch.amin(torch.where(mask, torch.inf, mean_other), dim=1)
    s = (b - a) / torch.clamp(torch.maximum(a, b), min=1e-30)
    s = torch.where(own <= 1.0, 0.0, s)      # singleton clusters score 0
    s = torch.where(valid, s, 0.0)
    return torch.sum(s) / torch.clamp(torch.sum(valid), min=1)


def silhouette(x, labels, device="cuda") -> float:
    """sklearn.metrics.silhouette_score (euclidean, full, no sampling)."""
    with span("metrics.silhouette"):
        dev = resolve_device(device)
        codes = _as_codes(labels)
        k = int(codes.max()) + 1 if codes.size else 0
        if k < 2 or k > len(codes) - 1:
            raise ValueError(
                "silhouette requires 2 <= n_labels <= n_samples - 1")
        d = pairwise_dists(center(x, dev))
        s = _silhouette_from_d(
            d, as_tensor(codes, dev, "metrics.labels"), k)
        with sync("metrics.silhouette"):
            return float(s)


def silhouette_from_dists(d: torch.Tensor, labels) -> float:
    """Silhouette from a precomputed (N, N) euclidean distance matrix."""
    codes = _as_codes(labels)
    k = int(codes.max()) + 1 if codes.size else 0
    if k < 2 or k > len(codes) - 1:
        raise ValueError("silhouette requires 2 <= n_labels <= n_samples - 1")
    return float(_silhouette_from_d(d, torch.as_tensor(codes, device=d.device),
                                    k))


def silhouette_from_dists_masked(d: torch.Tensor, labels, lazy: bool = False):
    """Noise-aware silhouette from a precomputed full distance matrix:
    label -1 points are dropped from the score without subsetting d."""
    codes, k = _masked_codes(labels)
    if int(np.sum(codes >= 0)) < 3:
        raise ValueError("need >= 3 non-noise points")
    out = _silhouette_from_d(d, torch.as_tensor(codes, device=d.device), k)
    return out if lazy else float(out)


def _dbi(xc: torch.Tensor, codes: torch.Tensor, n_clusters: int) -> torch.Tensor:
    """Davies-Bouldin over the points with code >= 0 of the centred x
    (distances are translation-invariant, so centring by the full mean
    matches sklearn on the subset)."""
    onehot = _onehot(codes, n_clusters)
    counts = torch.clamp(torch.sum(onehot, dim=0), min=1.0)
    centroids = (torch.matmul(onehot.T, xc) / counts[:, None]).contiguous()
    d_pc = pairwise_dists(xc, centroids)                    # (N, k)
    s = torch.sum(d_pc * onehot, dim=0) / counts            # (k,)
    m = pairwise_dists(centroids)                           # (k, k)
    r = (s[:, None] + s[None, :]) / torch.where(m > 0, m, torch.inf)
    r = torch.where(torch.eye(n_clusters, dtype=torch.bool, device=xc.device),
                    -torch.inf, r)
    return torch.mean(torch.amax(r, dim=1))


def davies_bouldin(x, labels, device="cuda") -> float:
    """sklearn.metrics.davies_bouldin_score."""
    with span("metrics.davies_bouldin"):
        dev = resolve_device(device)
        codes = _as_codes(labels)
        k = int(codes.max()) + 1
        if k < 2:
            raise ValueError("davies_bouldin requires >= 2 clusters")
        dbi = _dbi(center(x, dev),
                   as_tensor(codes, dev, "metrics.labels"), k)
        with sync("metrics.davies_bouldin"):
            return float(dbi)


def davies_bouldin_masked(x, labels, lazy: bool = False,
                          centred: bool = False, device="cuda"):
    """DBI ignoring noise (label -1) without subsetting x.  A tensor x stays
    on its own device; centred=True says x is already mean-centred (a sweep
    centres its (N, 82,688) representation once, not once per cell)."""
    codes, k = _masked_codes(labels)
    dev = x.device if isinstance(x, torch.Tensor) else resolve_device(device)
    xc = x if centred else center(x, dev)
    out = _dbi(xc, torch.as_tensor(codes, device=dev), k)
    return out if lazy else float(out)


def calinski_harabasz(x, labels, device="cuda") -> float:
    """sklearn.metrics.calinski_harabasz_score."""
    dev = resolve_device(device)
    codes_np = _as_codes(labels)
    k = int(codes_np.max()) + 1
    if k < 2:
        raise ValueError("calinski_harabasz requires >= 2 clusters")
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    n = x.shape[0]
    codes = torch.as_tensor(codes_np, device=dev)
    mean = torch.mean(x, dim=0)
    onehot = _onehot(codes, k)
    counts = torch.clamp(torch.sum(onehot, dim=0), min=1.0)
    centroids = torch.matmul(onehot.T, x) / counts[:, None]
    extra = torch.sum(counts * torch.sum((centroids - mean) ** 2, dim=1))
    intra = torch.sum((x - centroids[codes]) ** 2)
    return float(extra / torch.clamp(intra, min=1e-30) * (n - k) / (k - 1.0))
