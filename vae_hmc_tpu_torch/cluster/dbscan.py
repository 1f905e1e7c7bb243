"""DBSCAN: kernel 2 distances + sklearn-exact labeling (port of
``vae_hmc_tpu.cluster.dbscan``).

Replaces sklearn.cluster.DBSCAN as used in the medium sweeps (reference
scripts/13:131, 14:77, 15:87, 16:221).  The (N, N) neighbourhood graph is a
threshold of kernel 2's distances; labeling is sklearn's algorithm: clusters
are the connected components of the core-core graph, numbered in order of
their lowest core index (sklearn's seed order), border points take the
lowest cluster id among their core neighbours, the rest is noise (-1).

Two labelers: on the host (scipy connected components, copied) for the
numpy-input path, and on the device (minimum-core-index propagation, a
loop of torch ops) for distances that already live on the device.  Only
the numpy-input path refines threshold-adjacent pairs in float64; the
device paths threshold the f32 distances as they are.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from vae_hmc_tpu_torch.core.device import resolve_device
from vae_hmc_tpu_torch.ops.kernels.distance import pairwise_dists


def _refine_threshold_band(x32: np.ndarray, d2: np.ndarray,
                           eps: float) -> np.ndarray:
    """Exact-f64 recompute of squared distances within the f32 cancellation
    band of eps^2; returns d2 with those entries replaced.

    The bulk (N, N) matrix comes from |a|^2+|b|^2-2ab in f32, whose
    absolute error scales with the row norms — for points whose true
    distance is within that error of eps, the <= eps decision can flip vs
    sklearn (whose KDTree accumulates (a-b)^2 in float64).  Only the
    threshold-adjacent pairs are recomputed, as (a-b)^2 in f64 on host."""
    thr = float(eps) * float(eps)
    norms = (x32.astype(np.float64) ** 2).sum(axis=1)
    # conservative dot-trick error bound: O(d) ulps of the largest term
    err = ((x32.shape[1] + 16) * np.finfo(np.float32).eps
           * (norms[:, None] + norms[None, :] + thr))
    band = np.abs(d2 - thr) <= err
    band |= band.T
    ii, jj = np.nonzero(band)
    if ii.size:
        diff = x32[ii].astype(np.float64) - x32[jj].astype(np.float64)
        d2 = d2.astype(np.float64, copy=True)
        d2[ii, jj] = np.einsum("ij,ij->i", diff, diff)
    return d2


def _sq_dists_host(x32: np.ndarray, dev: torch.device) -> np.ndarray:
    """Squared kernel 2 distances of host rows, fetched to the host."""
    d = pairwise_dists(torch.from_numpy(x32).to(dev))
    return (d * d).cpu().numpy()


def neighbor_graph(x: np.ndarray, eps: float, device="cuda") -> np.ndarray:
    """(N, N) bool adjacency: ||xi - xj|| <= eps (self included, as sklearn).
    Bulk distances from kernel 2; threshold-adjacent pairs refined in f64
    (_refine_threshold_band) for sklearn-exact decisions."""
    x32 = np.ascontiguousarray(x, np.float32).reshape(len(x), -1)
    d2 = _sq_dists_host(x32, resolve_device(device))
    return _refine_threshold_band(x32, d2, eps) <= eps * eps


def labels_from_adjacency(adj: np.ndarray, min_samples: int) -> np.ndarray:
    """sklearn-exact DBSCAN labels from a boolean epsilon-adjacency matrix
    (host; scipy connected components over the core-core subgraph)."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph

    n = adj.shape[0]
    core = adj.sum(axis=1) >= min_samples          # self-inclusive (sklearn)
    labels = np.full(n, -1, dtype=np.int64)
    core_idx = np.flatnonzero(core)
    if core_idx.size == 0:
        return labels
    sub = sp.csr_matrix(adj[np.ix_(core_idx, core_idx)])
    n_comp, comp = csgraph.connected_components(sub, directed=False)
    # component id -> cluster id ordered by lowest core index (seed order)
    first_seen = np.full(n_comp, n, dtype=np.int64)
    np.minimum.at(first_seen, comp, core_idx)
    order = np.argsort(first_seen, kind="stable")
    comp_to_cluster = np.empty(n_comp, dtype=np.int64)
    comp_to_cluster[order] = np.arange(n_comp)
    labels[core_idx] = comp_to_cluster[comp]
    # border points: min cluster id among core neighbors
    border = np.flatnonzero(~core & adj[:, core_idx].any(axis=1))
    if border.size:
        nb = adj[np.ix_(border, core_idx)]
        core_labels = labels[core_idx]
        big = np.where(nb, core_labels[None, :], np.iinfo(np.int64).max)
        labels[border] = big.min(axis=1)
    return labels


def _label_body(adj: torch.Tensor, min_samples: int) -> torch.Tensor:
    """On-device sklearn-exact labeling from a boolean (N, N) adjacency:
    root[i] = lowest core index reachable from core i, propagated over the
    core-core subgraph to a fixpoint (one masked (N, N) min-reduce a sweep;
    O(graph diameter) sweeps), then clusters ranked by their root."""
    n = adj.shape[0]
    dev = adj.device
    adj = adj & adj.T                    # symmetry guard (distances are)
    core = torch.sum(adj, dim=1) >= min_samples
    idx = torch.arange(n, device=dev)
    big = torch.tensor(n, device=dev)
    core_adj = adj & core[:, None] & core[None, :]
    root = torch.where(core, idx, big)
    while True:
        nbr_min = torch.amin(torch.where(core_adj, root[None, :], big), dim=1)
        new = torch.minimum(root, nbr_min)
        if torch.equal(new, root):
            break
        root = new
    # cluster id = rank of the component's root among distinct roots
    is_root = core & (root == idx)
    rank = torch.cumsum(is_root.to(torch.int64), dim=0) - 1
    core_label = rank[torch.clamp(root, 0, n - 1)]
    # border points: min cluster id among core neighbors
    border = torch.amin(torch.where(adj & core[None, :], core_label[None, :],
                                    big), dim=1)
    return torch.where(core, core_label,
                       torch.where(border < big, border, -1))


def dbscan_from_dists_device(d: torch.Tensor, eps: float,
                             min_samples: int) -> np.ndarray:
    """DBSCAN from an (N, N) euclidean distance tensor; only the (N,)
    labels are fetched."""
    return _label_body(d <= eps, min_samples).cpu().numpy()


def dbscan_sweep_from_dists_device(d: torch.Tensor,
                                   eps_values: Sequence[float],
                                   min_samples_values: Sequence[int]
                                   ) -> Dict[Tuple[float, int], np.ndarray]:
    """Labels for the whole (eps x min_samples) grid from one (N, N)
    distance tensor, with one host fetch.  Cells are labelled one after
    another: one (N, N) adjacency at a time (the JAX package's vmapped
    grid holds all of them, (24, N, N))."""
    pairs = [(float(e), int(m)) for e in eps_values
             for m in min_samples_values]
    labels = torch.stack([_label_body(d <= e, m) for e, m in pairs]).cpu()
    return {p: labels[i].numpy() for i, p in enumerate(pairs)}


def dbscan(x, eps: float, min_samples: int = 5, device="cuda") -> np.ndarray:
    """A tensor x stays on its device (unrefined thresholds); numpy x gets
    the f64-refined host path, with its distances from `device`."""
    if isinstance(x, torch.Tensor):
        d = pairwise_dists(x.reshape(x.shape[0], -1).contiguous())
        return dbscan_from_dists_device(d, eps, min_samples)
    return labels_from_adjacency(neighbor_graph(x, eps, device), min_samples)


def dbscan_sweep(x, eps_values, min_samples_values, device="cuda"):
    """Grid over (eps, min_samples) sharing ONE distance matrix — the
    reference recomputes distances per cell (16:219-242)."""
    if isinstance(x, torch.Tensor):
        d = pairwise_dists(x.reshape(x.shape[0], -1).contiguous())
        return dbscan_sweep_from_dists_device(d, eps_values,
                                              min_samples_values)
    x32 = np.ascontiguousarray(x, np.float32).reshape(len(x), -1)
    d2 = _sq_dists_host(x32, resolve_device(device))
    out = {}
    for eps in eps_values:
        adj = _refine_threshold_band(x32, d2, eps) <= eps * eps
        for ms in min_samples_values:
            out[(float(eps), int(ms))] = labels_from_adjacency(adj, ms)
    return out
