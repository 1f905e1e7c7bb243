"""ELBO losses, both reference reductions (port of ``vae_hmc_tpu.models.losses``).

  - "mean" (scripts 06:182-188, 12:262-264): MSE mean over all elements +
    beta * KL mean over all elements;
  - "sum" (script 19:226-228): per-sample sums, then the batch mean.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def elbo_loss(xhat, x, mu, logvar, beta: float = 1.0,
              reduction: str = "mean") -> Tuple[torch.Tensor, Dict]:
    if reduction == "mean":
        recon = torch.mean((xhat - x) ** 2)
        kl = -0.5 * torch.mean(1.0 + logvar - mu ** 2 - torch.exp(logvar))
    elif reduction == "sum":
        recon = torch.mean(torch.sum((xhat - x) ** 2,
                                     dim=tuple(range(1, x.ndim))))
        kl = torch.mean(-0.5 * torch.sum(
            1.0 + logvar - mu ** 2 - torch.exp(logvar), dim=-1))
    else:
        raise ValueError(f"unknown reduction {reduction!r}")
    loss = recon + beta * kl
    return loss, {"recon": recon, "kl": kl, "total": loss}
