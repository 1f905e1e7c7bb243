"""KMeans: greedy k-means++ init + Lloyd iterations, the n_init restarts run
as one batch dimension (port of ``vae_hmc_tpu.cluster.kmeans``).

Algorithmic parity with sklearn.cluster.KMeans, as in the JAX package (not
bit parity: the random streams differ):
  - greedy k-means++ with n_local_trials = 2 + floor(ln k);
  - Lloyd updates; a restart stops when its squared centre shift is
    <= tol * mean per-feature variance of X (sklearn's tolerance scaling);
    stopped restarts stay frozen while the others run on;
  - empty clusters re-seeded at the points farthest from their centres;
  - best of n_init by final inertia.
Squared distances to centres are a plain matmul (|x|^2 + |c|^2 - 2 x c^T).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from vae_hmc_tpu_torch.core.config import KMeansConfig
from vae_hmc_tpu_torch.core.device import resolve_device
from vae_hmc_tpu_torch.core.profiling import as_tensor, span, sync


@dataclass
class KMeansResult:
    labels: np.ndarray          # (N,) int32
    centers: np.ndarray         # (k, d)
    inertia: float
    n_iter: int


def _sq_dists_to_centers(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(N, d) x (R, k, d) -> (R, N, k) squared distances."""
    xn = torch.sum(x * x, dim=1)[None, :, None]
    cn = torch.sum(centers * centers, dim=2)[:, None, :]
    return torch.clamp(xn + cn - 2.0 * torch.matmul(x, centers.transpose(1, 2)),
                       min=0.0)


def _kmeanspp_init(x: torch.Tensor, k: int, n_init: int,
                   gen: torch.Generator) -> torch.Tensor:
    """Greedy k-means++ for n_init restarts at once -> (R, k, d) centres."""
    n, d = x.shape
    dev = x.device
    rows = torch.arange(n_init, device=dev)
    n_trials = 2 + int(math.floor(math.log(k)))
    first = torch.randint(0, n, (n_init,), generator=gen, device=dev)
    centers = torch.zeros((n_init, k, d), dtype=x.dtype, device=dev)
    centers[:, 0] = x[first]
    d2 = _sq_dists_to_centers(x, centers[:, :1])[:, :, 0]          # (R, N)
    for c in range(1, k):
        pot = torch.sum(d2, dim=1, keepdim=True)                    # (R, 1)
        r = torch.rand((n_init, n_trials), generator=gen, device=dev) * pot
        cand = torch.searchsorted(torch.cumsum(d2, dim=1), r)
        cand = torch.clamp(cand, 0, n - 1)                          # (R, L)
        cand_pts = x[cand]                                          # (R, L, d)
        new_d2 = torch.minimum(d2[:, :, None],
                               _sq_dists_to_centers(x, cand_pts))   # (R, N, L)
        best = torch.argmin(torch.sum(new_d2, dim=1), dim=1)        # (R,)
        centers[:, c] = cand_pts[rows, best]
        d2 = new_d2[rows, :, best]
    return centers


def _assign(x, centers):
    d2 = _sq_dists_to_centers(x, centers)                           # (R, N, k)
    return torch.argmin(d2, dim=2), d2


def _update(x, centers, labels, d2):
    r, k, _ = centers.shape
    onehot = torch.nn.functional.one_hot(labels, k).to(x.dtype)     # (R, N, k)
    counts = torch.sum(onehot, dim=1)                               # (R, k)
    sums = torch.matmul(onehot.transpose(1, 2), x)                  # (R, k, d)
    new = sums / torch.clamp(counts, min=1.0)[:, :, None]
    # empty-cluster relocation: the points farthest from their own centre,
    # the farthest to the first empty cluster
    d_own = torch.amin(d2, dim=2)                                   # (R, N)
    order = torch.argsort(-d_own, dim=1)
    empty = counts == 0
    rank = torch.clamp(torch.cumsum(empty.to(torch.int64), dim=1) - 1,
                       0, x.shape[0] - 1)
    donor = x[torch.gather(order, 1, rank)]                         # (R, k, d)
    return torch.where(empty[:, :, None], donor, new)


def _lloyd(x: torch.Tensor, centers: torch.Tensor, max_iter: int,
           tol_scaled: torch.Tensor):
    """Lloyd iterations of R restarts at once from `centers` (R, k, d); a
    restart freezes once its squared centre shift is <= tol_scaled.
    -> (labels (R, N), centers, inertia (R,), n_iter (R,))."""
    n_init = centers.shape[0]
    done = torch.zeros(n_init, dtype=torch.bool, device=x.device)
    n_iter = torch.zeros(n_init, dtype=torch.int64, device=x.device)
    for _ in range(max_iter):
        labels, d2 = _assign(x, centers)
        new = _update(x, centers, labels, d2)
        shift2 = torch.sum((new - centers) ** 2, dim=(1, 2))
        centers = torch.where(done[:, None, None], centers, new)
        n_iter += (~done).to(torch.int64)
        done = done | (shift2 <= tol_scaled)
        with sync("kmeans.done"):
            stop = bool(done.all())
        if stop:
            break
    labels, d2 = _assign(x, centers)
    inertia = torch.gather(d2, 2, labels[:, :, None])[:, :, 0].sum(dim=1)
    return labels, centers, inertia, n_iter


def tol_scaled(x: torch.Tensor, tol: float) -> torch.Tensor:
    """sklearn's tolerance: tol x the mean per-feature variance of X."""
    return tol * torch.mean(torch.var(x, dim=0, correction=0))


def _fetch(t: torch.Tensor) -> torch.Tensor:
    """`t` on the host (one wait on the device)."""
    with sync("kmeans.result"):
        return t.cpu()


def kmeans(x, cfg: KMeansConfig = KMeansConfig(), device="cuda") -> KMeansResult:
    with span("kmeans"):
        dev = resolve_device(device)
        x = as_tensor(x, dev, "kmeans.input", torch.float32)
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed)
        with span("kmeans.init"):
            centers = _kmeanspp_init(x, cfg.n_clusters, cfg.n_init, gen)
        with span("kmeans.lloyd"):
            labels, centers, inertia, n_iter = _lloyd(
                x, centers, cfg.max_iter, tol_scaled(x, cfg.tol))
        inertia = _fetch(inertia)
        best = int(torch.argmin(inertia))
        return KMeansResult(
            labels=_fetch(labels[best]).numpy().astype(np.int32),
            centers=_fetch(centers[best]).numpy(),
            inertia=float(inertia[best]),
            n_iter=int(_fetch(n_iter)[best]))


def kmeans_fit_predict(x, n_clusters: int, n_init: int = 20, seed: int = 42,
                       device="cuda") -> np.ndarray:
    return kmeans(x, KMeansConfig(n_clusters=n_clusters, n_init=n_init,
                                  seed=seed), device=device).labels
