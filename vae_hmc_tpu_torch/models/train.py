"""VAE trainer and latent export (port of ``vae_hmc_tpu.models.train``
``fit`` and ``encode_in_batches``, single device).

Same schedule as the JAX fused trainer: one permutation per epoch, the full
batches, then one remainder step whose metrics weigh ``rem`` rows in the
history (DataLoader drop_last=False semantics of the reference), the
``_beta_at`` KL warm-up, Adam with optax's defaults.  Per-step metrics stay
on the device and are fetched once per epoch.  The random streams
(permutations, reparameterization noise) are torch's; tests inject the
JAX side's through ``perms`` and ``eps_fn``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from vae_hmc_tpu_torch.models.losses import elbo_loss


@dataclass
class FitResult:
    history: List[Dict[str, float]]     # one row per epoch


def _beta_at(beta: float, epoch: int, anneal_epochs: int) -> float:
    if anneal_epochs and anneal_epochs > 0:
        return beta * min(1.0, (epoch + 1) / anneal_epochs)
    return beta


def fit(model: torch.nn.Module, arrays: Sequence[torch.Tensor], *,
        epochs: int, batch_size: int, learning_rate: float,
        beta: float = 1.0, reduction: str = "mean", seed: int = 42,
        kl_anneal_epochs: int = 0, variational: bool = True,
        perms: Optional[Sequence[np.ndarray]] = None,
        eps_fn: Optional[Callable[[int, int], torch.Tensor]] = None
        ) -> FitResult:
    """Train `model` in place on row-aligned `arrays` (arrays[0] is the
    reconstruction target; every array goes to the model, as the CVAE's
    condition does; all live on the model's device).

    variational=True: `model(*batch, eps=...)` -> (xhat, mu, logvar) and
    the ELBO of `reduction`.  variational=False (the AE baseline):
    `model(*batch)` -> (xhat, ...) and the MSE mean, with kl = 0 in the
    history (``vae_hmc_tpu/models/train.py:228-231``).
    `perms[e]` replaces epoch e's permutation and `eps_fn(epoch, step)`
    the reparameterization noise of a step (test hooks)."""
    n = int(arrays[0].shape[0])
    dev = arrays[0].device
    n_full, rem = divmod(n, batch_size)
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate)
    gen = torch.Generator()
    gen.manual_seed(seed)
    model.train()

    def step(idx, epoch, i, beta_now):
        batch = [a[idx] for a in arrays]
        if variational:
            eps = None if eps_fn is None else eps_fn(epoch, i)
            xhat, mu, logvar = model(*batch, eps=eps)
            loss, aux = elbo_loss(xhat, batch[0], mu, logvar, beta_now,
                                  reduction)
        else:
            loss = torch.mean((model(*batch)[0] - batch[0]) ** 2)
            aux = {"total": loss, "recon": loss, "kl": torch.zeros_like(loss)}
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return torch.stack([aux["total"], aux["recon"], aux["kl"]]).detach()

    history = []
    for epoch in range(epochs):
        perm = (torch.as_tensor(np.asarray(perms[epoch]), dtype=torch.int64)
                if perms is not None else torch.randperm(n, generator=gen))
        perm = perm.to(dev)
        beta_now = _beta_at(beta, epoch, kl_anneal_epochs)
        totals = torch.zeros(3, dtype=torch.float32, device=dev)
        for i in range(n_full):
            idx = perm[i * batch_size:(i + 1) * batch_size]
            totals += step(idx, epoch, i, beta_now) * batch_size
        if rem:
            totals += step(perm[n_full * batch_size:], epoch, n_full,
                           beta_now) * rem
        avg = (totals / n).cpu().numpy()                 # one fetch per epoch
        history.append({"epoch": epoch + 1, "total": float(avg[0]),
                        "recon": float(avg[1]), "kl": float(avg[2])})
    return FitResult(history=history)


@torch.no_grad()
def encode_in_batches(encode_fn: Callable, arrays: Sequence[torch.Tensor],
                      batch_size: int = 512) -> torch.Tensor:
    """Posterior-mean export over all rows (reference scripts/12:289-309):
    `encode_fn(*batch)` per contiguous batch, concatenated on the device."""
    n = int(arrays[0].shape[0])
    return torch.cat([encode_fn(*(a[s:s + batch_size] for a in arrays))
                      for s in range(0, n, batch_size)], dim=0)
