"""Agglomerative (Ward) clustering: kernel 2 distances + NN-chain merge
(port of ``vae_hmc_tpu.cluster.agglomerative``).

Replaces sklearn.cluster.AgglomerativeClustering(linkage='ward') as used in
the medium sweeps (reference scripts/13:125, 16:201).  The pairwise
distances come from kernel 2 and are squared in float64 on the host; the
merge sequence is the nearest-neighbour-chain algorithm with Lance-Williams
Ward updates, an inherently sequential O(N^2) host loop, run by the port's
copy of ``ward.cpp`` (``cluster.native``).  The numpy NN-chain below is its
plain version: the tests hold the native one against it.

Labels match sklearn up to label permutation.
"""
from __future__ import annotations

import numpy as np
import torch

from vae_hmc_tpu_torch.cluster.native import ward_nn_chain_native
from vae_hmc_tpu_torch.core.device import resolve_device
from vae_hmc_tpu_torch.ops.kernels.distance import pairwise_dists


def _sq_dists_f64(x, device) -> np.ndarray:
    dev = x.device if isinstance(x, torch.Tensor) else resolve_device(device)
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    d = pairwise_dists(xt.reshape(xt.shape[0], -1).contiguous())
    return d.cpu().numpy().astype(np.float64) ** 2


def ward_linkage_matrix(x, device="cuda") -> np.ndarray:
    """Compute the (N-1, 4) merge sequence [i, j, dist, size] (scipy format,
    sorted by distance, merged clusters numbered n + step)."""
    return ward_linkage_from_sq_dists(_sq_dists_f64(x, device))


def ward_linkage_from_sq_dists(d2: np.ndarray) -> np.ndarray:
    """Linkage from a precomputed squared-distance matrix (consumed).
    Lets the sweep reuse the representation's cached distances."""
    return ward_nn_chain_native(np.asarray(d2, dtype=np.float64))


def _ward_nn_chain_numpy_from_d2(d2: np.ndarray) -> np.ndarray:
    """NN-chain Ward in numpy: the plain version of the native one."""
    # Lance-Williams update for Ward on squared distances:
    # d2(k, i∪j) = ((si+sk) d2(k,i) + (sj+sk) d2(k,j) - sk d2(i,j)) / (si+sj+sk)
    n = d2.shape[0]
    np.fill_diagonal(d2, np.inf)
    size = np.ones(n)
    active = np.ones(n, dtype=bool)
    cluster_id = np.arange(n)            # scipy-style ids; merged -> n + step
    merges = np.zeros((n - 1, 4))
    chain: list = []
    for step in range(n - 1):
        if not chain:
            chain.append(int(np.flatnonzero(active)[0]))
        while True:
            a = chain[-1]
            row = np.where(active, d2[a], np.inf).copy()
            row[a] = np.inf
            b = int(np.argmin(row))
            if len(chain) > 1 and b == chain[-2]:
                break
            chain.append(b)
        b = chain.pop()
        a = chain.pop()
        dist = np.sqrt(d2[a, b])
        ia, ib = cluster_id[a], cluster_id[b]
        lo, hi = (ia, ib) if ia < ib else (ib, ia)
        merges[step] = (lo, hi, dist, size[a] + size[b])
        # Lance-Williams Ward update into slot a; deactivate b
        sa, sb = size[a], size[b]
        sk = size
        with np.errstate(invalid="ignore"):
            new = ((sa + sk) * d2[a] + (sb + sk) * d2[b] - sk * d2[a, b]) / (
                sa + sb + sk)
        d2[a, :] = new
        d2[:, a] = new
        d2[a, a] = np.inf
        active[b] = False
        d2[b, :] = np.inf
        d2[:, b] = np.inf
        size[a] = sa + sb
        cluster_id[a] = n + step
    # scipy expects merges sorted by distance (NN-chain emits unsorted)
    order = np.argsort(merges[:, 2], kind="stable")
    merges = merges[order]
    old_new = {n + int(old): n + new for new, old in enumerate(order)}
    for step in range(n - 1):
        for col in (0, 1):
            v = int(merges[step, col])
            if v >= n:
                merges[step, col] = old_new[v]
    return merges


def cut_tree_n_clusters(merges: np.ndarray, n: int, n_clusters: int) -> np.ndarray:
    """Labels from the linkage matrix by undoing the last n_clusters-1 merges
    (sklearn AgglomerativeClustering semantics).  Label ids are assigned by
    sorted root id — compare via ARI."""
    parent = np.arange(n + len(merges))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    stop = len(merges) - (n_clusters - 1)
    for step in range(stop):
        i, j = int(merges[step, 0]), int(merges[step, 1])
        parent[find(i)] = n + step
        parent[find(j)] = n + step
    roots = np.asarray([find(i) for i in range(n)])
    _, labels = np.unique(roots, return_inverse=True)
    return labels.astype(np.int32)


def agglomerative_ward(x, n_clusters: int, device="cuda") -> np.ndarray:
    merges = ward_linkage_matrix(x, device)
    return cut_tree_n_clusters(merges, len(x), n_clusters)
