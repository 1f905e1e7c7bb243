"""Train/export entry points (port of ``vae_hmc_tpu.models.api``
``train_conv_mm_vae``, ``train_dense_vae``, ``train_hard_vae`` and
``train_ae``; reference scripts 06, 12, 19 and 22).

Each runs model init -> training -> posterior-mean latent export and
returns (model, history, latents on the device).  Weights start from
torch's default initialization under ``cfg.seed`` (the JAX package uses
the same U(-1/sqrt(fan_in), ...) family, so loss scales are comparable;
exact RNG parity is impossible).  `model`, `perms` and `eps_fn` are test
hooks: carried-over weights and injected randomness.  The JAX package's
``prepare_*`` (AOT-compiled trainers built ahead from shapes) have no
counterpart: nothing here compiles.

Pass `mesh=` (``parallel.mesh.make_mesh`` / ``multihost.global_mesh``) to
train on every rank of a process group: each rank passes the full arrays
(or its ``ShardedRows``), as the JAX API takes them, and moves only its own
rows to the mesh's device (``fit`` on the mesh, as ``dp_fit``); the conv
model also tensor-shards its two giant FC layers over 'model'
(``conv_mm_param_sharding``).  The latent export encodes each rank's rows
and gathers them, so every rank returns the full (N, latent) latents.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from vae_hmc_tpu_torch.core import profiling
from vae_hmc_tpu_torch.core.config import (AeConfig, ConvMMVaeConfig,
                                           DenseVaeConfig, HardVaeConfig)
from vae_hmc_tpu_torch.core.device import resolve_device
from vae_hmc_tpu_torch.models.ae import AE
from vae_hmc_tpu_torch.models.conv_mm_vae import ConvMMVAE
from vae_hmc_tpu_torch.models.dense_vae import DenseVAE
from vae_hmc_tpu_torch.models.train import encode_in_batches, fit
from vae_hmc_tpu_torch.parallel import collectives
from vae_hmc_tpu_torch.parallel.mesh import conv_mm_param_sharding
from vae_hmc_tpu_torch.parallel.multihost import ShardedRows, shard_rows


def build_conv_mm_vae(cfg: ConvMMVaeConfig, n_mels: int, n_frames: int,
                      lyrics_dim: int) -> ConvMMVAE:
    """ConvMMVAE initialized from ``cfg.seed`` without touching the global
    torch RNG (float32 parameters whatever ``cfg.compute_dtype``: the
    trainer casts them per step)."""
    return _seeded(cfg.seed, lambda: ConvMMVAE(
        n_mels=n_mels, n_frames=n_frames, channels=tuple(cfg.audio_channels),
        fc_dim=cfg.audio_fc_dim, latent_dim=cfg.latent_dim,
        lyrics_dim=lyrics_dim))


def _seeded(seed: int, make: Callable[[], torch.nn.Module]) -> torch.nn.Module:
    """make() with torch's CPU generator seeded by `seed`, leaving the
    global torch RNG as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return make()


def train_conv_mm_vae(x, lyr, mask, cfg: ConvMMVaeConfig, device="cuda",
                      model: Optional[ConvMMVAE] = None,
                      perms: Optional[Sequence[np.ndarray]] = None,
                      eps_fn: Optional[Callable] = None,
                      verbose: bool = False, mesh=None):
    """x: (N, n_mels, T, 1) standardized log-mel; lyr: (N, 384) lyrics
    embeddings (zeros when missing); mask: (N,) or (N, 1) presence gate.
    Arrays may be numpy or tensors; they move to `device` (on a mesh: this
    rank's rows to the mesh's device; x may be ``ShardedRows``).  Training
    runs in ``cfg.compute_dtype`` ("float32", or "bfloat16" mixed
    precision); the latent export in float32, as the JAX package's.
    `model`, `perms` and `eps_fn` are test hooks (carried-over weights,
    injected randomness).  -> (model, history, mu (N, latent) on the
    device)."""
    dev, arrays, span = _stage(mesh, device, x, lyr, mask)
    arrays[2] = arrays[2].reshape(-1, 1)
    if model is None:
        model = build_conv_mm_vae(cfg, arrays[0].shape[1], arrays[0].shape[2],
                                  arrays[1].shape[1])
    model = model.to(dev)
    res = _fit(model, arrays, span, mesh, conv_mm_param_sharding,
               epochs=cfg.epochs, batch_size=cfg.batch_size,
               learning_rate=cfg.learning_rate, beta=cfg.beta,
               reduction=cfg.loss_reduction, seed=cfg.seed, verbose=verbose,
               compute_dtype=cfg.compute_dtype, perms=perms, eps_fn=eps_fn)
    model.eval()
    mu = _export(lambda xb, lb, mb: model.encode(xb, lb, mb)[0], arrays,
                 model.latent_dim, mesh, span, batch_size=256)
    return model, res.history, mu


def _stage(mesh, device, *arrays):
    """-> (device, float32 tensors, span (start, stop, N)): the whole
    arrays on `device`, or on a mesh this rank's rows [start, stop) on its
    device (``shard_rows``; x may be ShardedRows already)."""
    with profiling.span("train.stage_in"):
        if mesh is None:
            dev = resolve_device(device)
            n = int(arrays[0].shape[0])
            return dev, [profiling.as_tensor(a, dev, "train.stage_in",
                                              torch.float32)
                         for a in arrays], (0, n, n)
        n = (arrays[0].n_global if isinstance(arrays[0], ShardedRows)
             else int(arrays[0].shape[0]))
        staged = [shard_rows(a, mesh, n) for a in arrays]
        return (mesh.device, [r.local.to(torch.float32) for r in staged],
                (staged[0].start, staged[0].stop, n))


def _fit(model, arrays, span, mesh, sharding=None, **kw):
    """``fit`` of `model` on this rank's tensors: as they are, or on a mesh
    as ShardedRows, with the sharding plan `sharding(mesh, model)`."""
    if mesh is not None:
        arrays = [ShardedRows(t, *span) for t in arrays]
        kw.update(mesh=mesh, n_rows=span[2], param_shardings=(
            None if sharding is None else sharding(mesh, model)))
    return fit(model, arrays, **kw)


def _export(encode_fn: Callable, arrays, latent_dim: int, mesh, span,
            batch_size: int = 512) -> torch.Tensor:
    """Posterior means of every row: on a mesh each rank encodes its own
    rows and the ranges are gathered over 'data' (every rank gets all N)."""
    with profiling.span("train.export"):
        if mesh is None:
            return encode_in_batches(encode_fn, arrays,
                                     batch_size=batch_size)
        start, stop, n = span
        local = (encode_in_batches(encode_fn, arrays, batch_size=batch_size)
                 if stop > start else torch.zeros((0, latent_dim),
                                                  device=mesh.device))
        return collectives.all_gather_rows(local, start, n, mesh.data_group)


def train_dense_vae(x, cfg: DenseVaeConfig, device="cuda",
                    model: Optional[DenseVAE] = None,
                    perms: Optional[Sequence[np.ndarray]] = None,
                    eps_fn: Optional[Callable] = None, mesh=None):
    """Easy-tier basic VAE (reference scripts/06): x is the standardized
    (N, 80) MFCC-stats matrix (numpy or a tensor; on a mesh, see the
    module's docstring).  -> (model, history, mu (N, latent) on the
    device)."""
    dev, arrays, span = _stage(mesh, device, x)
    if model is None:
        model = _seeded(cfg.seed, lambda: DenseVAE(
            arrays[0].shape[1], tuple(cfg.hidden_dims), cfg.latent_dim))
    model = model.to(dev)
    res = _fit(model, arrays, span, mesh, epochs=cfg.epochs,
               batch_size=cfg.batch_size, learning_rate=cfg.learning_rate,
               beta=cfg.beta, reduction=cfg.loss_reduction, seed=cfg.seed,
               perms=perms, eps_fn=eps_fn)
    model.eval()
    mu = _export(lambda xb: model.encode(xb)[0], arrays, model.latent_dim,
                 mesh, span)
    return model, res.history, mu


def train_hard_vae(x, cfg: HardVaeConfig, cond=None, device="cuda",
                   model: Optional[DenseVAE] = None,
                   perms: Optional[Sequence[np.ndarray]] = None,
                   eps_fn: Optional[Callable] = None, mesh=None):
    """Hard-tier Beta-VAE / CVAE (reference scripts/19): x is the
    early-fused (N, D) feature matrix (one-hots already appended where the
    config asks, 19:174-177); `cond` the CVAE's conditioning one-hot
    (19:180-189), used only when cfg.use_cvae.  On a mesh, see the
    module's docstring.  -> (model, history, mu (N, latent) on the
    device)."""
    inputs = (x,) if cond is None or not cfg.use_cvae else (x, cond)
    dev, arrays, span = _stage(mesh, device, *inputs)
    cond_dim = int(arrays[1].shape[1]) if len(arrays) > 1 else 0
    if model is None:
        model = _seeded(cfg.seed, lambda: DenseVAE(
            arrays[0].shape[1], (cfg.hidden_dim, cfg.hidden_dim),
            cfg.latent_dim, cond_dim))
    model = model.to(dev)
    res = _fit(model, arrays, span, mesh, epochs=cfg.epochs,
               batch_size=cfg.batch_size, learning_rate=cfg.learning_rate,
               beta=cfg.beta, reduction=cfg.loss_reduction, seed=cfg.seed,
               kl_anneal_epochs=cfg.kl_anneal_epochs, perms=perms,
               eps_fn=eps_fn)
    model.eval()
    mu = _export(lambda *b: model.encode(*b)[0], arrays, model.latent_dim,
                 mesh, span)
    return model, res.history, mu


def train_ae(x, cfg: AeConfig, device="cuda", model: Optional[AE] = None,
             perms: Optional[Sequence[np.ndarray]] = None):
    """Deterministic AE baseline (reference scripts/22:139-171): MSE mean,
    no KL.  -> (model, history, z (N, latent) on `device`)."""
    dev, arrays, span = _stage(None, device, x)
    if model is None:
        model = _seeded(cfg.seed, lambda: AE(arrays[0].shape[1],
                                             cfg.hidden_dim, cfg.latent_dim))
    model = model.to(dev)
    res = fit(model, arrays, epochs=cfg.epochs, batch_size=cfg.batch_size,
              learning_rate=cfg.learning_rate, seed=cfg.seed,
              variational=False, perms=perms)
    model.eval()
    z = _export(model.encode, arrays, model.latent_dim, None, span)
    return model, res.history, z
