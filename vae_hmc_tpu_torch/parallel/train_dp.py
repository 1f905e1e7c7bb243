"""Data-parallel (+ tensor-parallel) training and sharded KMeans restarts
over a mesh (port of ``vae_hmc_tpu.parallel.train_dp``).

``dp_fit`` is the mesh entry point to the one trainer
(``models/train.fit``): each data index trains on its own rows, gradients
are summed over the 'data' group, and layers the caller's sharding marks
are tensor-parallel over 'model' (``parallel/mesh``).  With the same
permutation, noise and weights it is step-equivalent to a single-device
``fit`` up to the order of reduction.

``kmeans_restarts_sharded`` spreads the n_init restarts over every rank of
the mesh; only the best-of choice crosses ranks.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from vae_hmc_tpu_torch.cluster.kmeans import _kmeanspp_init, _lloyd, tol_scaled
from vae_hmc_tpu_torch.core.config import KMeansConfig
from vae_hmc_tpu_torch.models.train import FitResult, fit
from vae_hmc_tpu_torch.parallel import collectives


def dp_fit(model: torch.nn.Module, arrays: Sequence, mesh,
           param_shardings=None, *, epochs: int, batch_size: int,
           learning_rate: float, beta: float = 1.0, reduction: str = "mean",
           seed: int = 42, kl_anneal_epochs: int = 0,
           variational: bool = True, verbose: bool = False,
           compute_dtype: Optional[str] = None, n_rows: Optional[int] = None,
           perms: Optional[Sequence[np.ndarray]] = None,
           eps_fn: Optional[Callable] = None) -> FitResult:
    return fit(model, arrays, epochs=epochs, batch_size=batch_size,
               learning_rate=learning_rate, beta=beta, reduction=reduction,
               seed=seed, kl_anneal_epochs=kl_anneal_epochs,
               variational=variational, verbose=verbose,
               compute_dtype=compute_dtype, perms=perms, eps_fn=eps_fn,
               mesh=mesh, param_shardings=param_shardings, n_rows=n_rows)


def _restart_generator(seed: int, restart: int,
                       device: torch.device) -> torch.Generator:
    state = np.random.SeedSequence([seed, restart]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def kmeans_restarts_sharded(x, n_clusters: int, n_init: int, mesh,
                            seed: int = 42):
    """KMeans with the n_init restarts spread over every rank of the mesh
    (the flattened ('data', 'model') axes): n_init is raised to at least the
    number of ranks and padded to a multiple of it, as the JAX package
    does.  Restart r draws its k-means++ start from a generator seeded by
    (seed, r) alone and runs the port's Lloyd loop (``cluster/kmeans``), so
    each restart, and the best of them, does not depend on the number of
    ranks.  The best is the lowest inertia (the lowest restart index among
    equals), chosen from an all-reduce of every restart's inertia and
    broadcast from the rank that ran it.  `x` (N, d): the same on every
    rank.  -> (labels (N,) int32, centers (k, d), inertia)."""
    cfg = KMeansConfig(n_clusters=n_clusters, n_init=n_init, seed=seed)
    world = mesh.size
    n_init = max(n_init, world)
    n_init = -(-n_init // world) * world                 # pad to a multiple
    per = n_init // world
    x = torch.as_tensor(x, dtype=torch.float32, device=mesh.device)
    mine = range(mesh.rank * per, (mesh.rank + 1) * per)
    centers = torch.cat([
        _kmeanspp_init(x, n_clusters, 1,
                       _restart_generator(seed, r, mesh.device))
        for r in mine])
    labels, centers, inertia, _ = _lloyd(x, centers, cfg.max_iter,
                                         tol_scaled(x, cfg.tol))
    every = torch.zeros(n_init, dtype=inertia.dtype, device=mesh.device)
    every[mine.start:mine.stop] = inertia
    collectives.all_reduce_sum(every)
    best = int(torch.argmin(every))
    owner, j = divmod(best, per)
    lab = labels[j].contiguous() if owner == mesh.rank else torch.zeros_like(
        labels[0])
    cen = centers[j].contiguous() if owner == mesh.rank else torch.zeros_like(
        centers[0])
    collectives.broadcast(lab, owner)
    collectives.broadcast(cen, owner)
    return (lab.cpu().numpy().astype(np.int32), cen.cpu().numpy(),
            float(every[best]))
