"""Train/export entry point of the conv multimodal VAE (port of
``vae_hmc_tpu.models.api.train_conv_mm_vae``; reference scripts/12).

Model init -> training -> posterior-mean latent export, returning
(model, history, mu).  Weights start from torch's default initialization
under ``cfg.seed`` (the JAX package uses the same U(-1/sqrt(fan_in), ...)
family for its kernels, so loss scales are comparable; exact RNG parity is
impossible).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from vae_hmc_tpu_torch.core.config import ConvMMVaeConfig
from vae_hmc_tpu_torch.core.device import resolve_device
from vae_hmc_tpu_torch.models.conv_mm_vae import ConvMMVAE
from vae_hmc_tpu_torch.models.train import encode_in_batches, fit


def build_conv_mm_vae(cfg: ConvMMVaeConfig, n_mels: int, n_frames: int,
                      lyrics_dim: int) -> ConvMMVAE:
    """ConvMMVAE initialized from ``cfg.seed`` without touching the global
    torch RNG."""
    if cfg.compute_dtype != "float32":
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: only float32 "
                         "is ported")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        return ConvMMVAE(n_mels=n_mels, n_frames=n_frames,
                         channels=tuple(cfg.audio_channels),
                         fc_dim=cfg.audio_fc_dim, latent_dim=cfg.latent_dim,
                         lyrics_dim=lyrics_dim)


def train_conv_mm_vae(x, lyr, mask, cfg: ConvMMVaeConfig, device="cuda",
                      model: Optional[ConvMMVAE] = None,
                      perms: Optional[Sequence[np.ndarray]] = None,
                      eps_fn: Optional[Callable] = None):
    """x: (N, n_mels, T, 1) standardized log-mel; lyr: (N, 384) lyrics
    embeddings (zeros when missing); mask: (N,) or (N, 1) presence gate.
    Arrays may be numpy or tensors; they move to `device`.  `model`,
    `perms` and `eps_fn` are test hooks (carried-over weights, injected
    randomness).  -> (model, history, mu (N, latent) on `device`)."""
    dev = resolve_device(device)
    arrays = (torch.as_tensor(x, dtype=torch.float32, device=dev),
              torch.as_tensor(lyr, dtype=torch.float32, device=dev),
              torch.as_tensor(mask, dtype=torch.float32,
                              device=dev).reshape(-1, 1))
    if model is None:
        model = build_conv_mm_vae(cfg, arrays[0].shape[1], arrays[0].shape[2],
                                  arrays[1].shape[1])
    model = model.to(dev)
    res = fit(model, arrays, epochs=cfg.epochs, batch_size=cfg.batch_size,
              learning_rate=cfg.learning_rate, beta=cfg.beta,
              reduction=cfg.loss_reduction, seed=cfg.seed, perms=perms,
              eps_fn=eps_fn)
    model.eval()
    mu = encode_in_batches(lambda xb, lb, mb: model.encode(xb, lb, mb)[0],
                           arrays, batch_size=256)
    return model, res.history, mu
