"""ELBO losses, both reference reductions (port of ``vae_hmc_tpu.models.losses``).

  - "mean" (scripts 06:182-188, 12:262-264): MSE mean over all elements +
    beta * KL mean over all elements;
  - "sum" (script 19:226-228): per-sample sums, then the batch mean.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def elbo_loss(xhat, x, mu, logvar, beta: float = 1.0,
              reduction: str = "mean") -> Tuple[torch.Tensor, Dict]:
    return elbo_loss_rows(xhat, x, mu, logvar, beta, reduction, x.shape[0])


def elbo_loss_rows(xhat, x, mu, logvar, beta: float, reduction: str,
                   batch_size: int) -> Tuple[torch.Tensor, Dict]:
    """``elbo_loss`` of a global batch of `batch_size` rows, from the rows
    at hand (any subset, even none): sums over these rows divided by the
    whole batch's normalizer (batch_size x elements a row for "mean",
    batch_size for "sum"), so that the terms of a batch's row shards add up
    to the whole batch's ``elbo_loss``."""
    sq = (xhat - x) ** 2
    kl_terms = 1.0 + logvar - mu ** 2 - torch.exp(logvar)
    if reduction == "mean":
        recon = torch.sum(sq) / (batch_size * math.prod(x.shape[1:]))
        kl = -0.5 * torch.sum(kl_terms) / (batch_size * mu.shape[-1])
    elif reduction == "sum":
        recon = torch.sum(torch.sum(sq, dim=tuple(range(1, x.ndim)))
                          ) / batch_size
        kl = torch.sum(-0.5 * torch.sum(kl_terms, dim=-1)) / batch_size
    else:
        raise ValueError(f"unknown reduction {reduction!r}")
    loss = recon + beta * kl
    return loss, {"recon": recon, "kl": kl, "total": loss}


def mse_rows(xhat, x, batch_size: int) -> torch.Tensor:
    """The AE's MSE mean of a global batch of `batch_size` rows, from the
    rows at hand: their squared-error sum over batch_size x elements a
    row."""
    return torch.sum((xhat - x) ** 2) / (batch_size * math.prod(x.shape[1:]))
