"""Plain dense models of the hard tier (reference scripts 19 and 22), their
losses and Adam steps.

Beta-VAE (19:64-121, unconditioned): encoder ReLU(enc1), ReLU(enc2), then
mu and logvar; decoder ReLU(dec1), ReLU(dec2), linear out; z = mu + eps x
exp(logvar / 2).  Loss ("sum" reduction, 19:226-228): per-sample sums of
squared errors and of -1/2 (1 + logvar - mu^2 - exp(logvar)), their batch
means, recon + beta x kl.
AE baseline (22:66-88): ReLU(e1), ReLU(e2), e3; ReLU(d1), ReLU(d2), d3;
loss the mean squared error over all elements.
Adam as ``conv_vae.Adam``.  Leaves are named as the port's modules name
them (the Flax modules' names).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.conv_vae import Adam


def _lin(w, name, x):
    return F.linear(x, w[name + ".weight"], w[name + ".bias"])


def vae_encode(w: Dict[str, torch.Tensor], x: torch.Tensor):
    h = F.relu(_lin(w, "enc2", F.relu(_lin(w, "enc1", x))))
    return _lin(w, "mu", h), _lin(w, "logvar", h)


def vae_decode(w: Dict[str, torch.Tensor], z: torch.Tensor) -> torch.Tensor:
    return _lin(w, "out", F.relu(_lin(w, "dec2", F.relu(_lin(w, "dec1", z)))))


def vae_elbo_sum(xhat, mu, logvar, x, beta: float):
    b = x.shape[0]
    recon = ((xhat - x) ** 2).sum() / b
    kl = (-0.5 * (1.0 + logvar - mu ** 2 - torch.exp(logvar))).sum() / b
    return recon + beta * kl


def vae_loss(w, x, eps, beta: float):
    mu, logvar = vae_encode(w, x)
    xhat = vae_decode(w, mu + eps * torch.exp(0.5 * logvar))
    return vae_elbo_sum(xhat, mu, logvar, x, beta)


def ae_encode(w: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return _lin(w, "e3", F.relu(_lin(w, "e2", F.relu(_lin(w, "e1", x)))))


def ae_decode(w: Dict[str, torch.Tensor], z: torch.Tensor) -> torch.Tensor:
    return _lin(w, "d3", F.relu(_lin(w, "d2", F.relu(_lin(w, "d1", z)))))


def mse(xhat, x):
    return ((xhat - x) ** 2).sum() / x.numel()


def ae_loss(w, x, _eps=None, _beta=None):
    return mse(ae_decode(w, ae_encode(w, x)), x)


def steps(w0: Dict[str, torch.Tensor], loss_fn, batches, noises, beta: float,
          lr: float) -> dict:
    """Adam steps from `w0` on the given batches (and noises): ->
    {"grad0", "losses", "after"}."""
    opt = Adam(w0, lr)
    out = {"losses": []}
    for i, (x, eps) in enumerate(zip(batches, noises)):
        val, grads = opt.step(lambda w: loss_fn(w, x, eps, beta))
        if i == 0:
            out["grad0"] = grads
        out["losses"].append(float(val))
    out["after"] = {k: v.detach().clone() for k, v in opt.w.items()}
    return out
