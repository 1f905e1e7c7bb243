"""Plain conv multimodal VAE of reference script 12, its ELBO and Adam.

Forward, from a dict of leaves (``benchmark.weights.conv_vae_leaves``):
  audio: three 3x3 stride-2 padding-1 convs with ReLU, flatten (C, H, W),
  a ReLU FC to ``audio_fc_dim``, then mu_a (logvar_a is computed by the
  published model and unused);
  lyrics: 384 -> 256 -> 128, ReLU each, times the presence mask m;
  fusion: ReLU FC of [mu_a, lyrics, m] to 256, then mu and logvar;
  z = mu + eps * exp(logvar / 2);
  decoder: ReLU FC 32 -> 256, ReLU FC -> C x H x W, transposed 4x4
  stride-2 padding-1 convs with ReLU between, cropped to (n_mels, T).
Loss ("mean" reduction): sum of squared errors / (B x elements) + beta x
(-1/2 sum(1 + logvar - mu^2 - exp(logvar)) / (B x latent)).
Adam: lr from the configuration, betas (0.9, 0.999), eps 1e-8, bias
correction, no weight decay.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def _lin(w, name, x):
    return F.linear(x, w[name + ".weight"], w[name + ".bias"])


def encode(w: Dict[str, torch.Tensor], x: torch.Tensor, lyr: torch.Tensor,
           m: torch.Tensor, n_conv: int = 3):
    """x (B, n_mels, T, 1), lyr (B, L), m (B, 1) -> (mu, logvar)."""
    h = x.permute(0, 3, 1, 2)
    for i in range(n_conv):
        h = F.relu(F.conv2d(h, w[f"enc_convs.{i}.weight"],
                            w[f"enc_convs.{i}.bias"], stride=2, padding=1))
    h = F.relu(_lin(w, "enc_fc", h.flatten(1)))
    mu_a = _lin(w, "mu_a", h)
    ly = F.relu(_lin(w, "lyr2", F.relu(_lin(w, "lyr1", lyr)))) * m
    f = F.relu(_lin(w, "fuse", torch.cat([mu_a, ly, m], dim=1)))
    return _lin(w, "mu", f), _lin(w, "logvar", f)


def decode(w: Dict[str, torch.Tensor], z: torch.Tensor, shape, n_conv: int = 3):
    """z (B, latent) -> (B, n_mels, T, 1); shape = (C, H, W, n_mels, T)."""
    c, hh, ww, n_mels, t = shape
    h = F.relu(_lin(w, "dec_fc2", F.relu(_lin(w, "dec_fc1", z))))
    h = h.view(z.shape[0], c, hh, ww)
    for i in range(n_conv):
        h = F.conv_transpose2d(h, w[f"dec_convs.{i}.weight"],
                               w[f"dec_convs.{i}.bias"], stride=2, padding=1)
        if i < n_conv - 1:
            h = F.relu(h)
    return h[:, :, :n_mels, :t].permute(0, 2, 3, 1)


def elbo(xhat, mu, logvar, x, beta: float):
    b = x.shape[0]
    recon = ((xhat - x) ** 2).sum() / (b * x[0].numel())
    kl = -0.5 * (1.0 + logvar - mu ** 2 - torch.exp(logvar)).sum() / (
        b * mu.shape[1])
    return recon + beta * kl


def loss(w, x, lyr, m, eps, beta: float, shape):
    mu, logvar = encode(w, x, lyr, m)
    xhat = decode(w, mu + eps * torch.exp(0.5 * logvar), shape)
    return elbo(xhat, mu, logvar, x, beta)


class Adam:
    """Adam over a dict of leaves (copied from `w0`)."""

    def __init__(self, w0: Dict[str, torch.Tensor], lr: float):
        self.w = {k: v.detach().clone().requires_grad_(True)
                  for k, v in w0.items()}
        self.m = {k: torch.zeros_like(v) for k, v in w0.items()}
        self.v = {k: torch.zeros_like(v) for k, v in w0.items()}
        self.t, self.lr = 0, lr

    def step(self, loss_of) -> tuple:
        """One step on ``loss_of(leaves)``; -> (loss, gradients by leaf);
        a leaf the loss does not use has a zero gradient."""
        val = loss_of(self.w)
        grads = torch.autograd.grad(val, list(self.w.values()),
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.w.values(), grads)]
        self.t += 1
        b1, b2 = BETAS
        with torch.no_grad():
            for (k, p), g in zip(self.w.items(), grads):
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mh = self.m[k] / (1 - b1 ** self.t)
                vh = self.v[k] / (1 - b2 ** self.t)
                p.sub_(self.lr * mh / (vh.sqrt() + ADAM_EPS))
        return val.detach(), dict(zip(self.w, grads))


class Trainer(Adam):
    """The fit's steps: one epoch's permutation, full batches then the
    remainder, noise from ``noise(epoch, step)`` cut to the batch."""

    def __init__(self, w0: Dict[str, torch.Tensor], lr: float, beta: float,
                 batch: int, shape):
        super().__init__(w0, lr)
        self.beta, self.batch, self.shape = beta, batch, shape

    def step(self, x, lyr, m, eps) -> tuple:
        """-> (loss as a float tensor, gradients)."""
        return super().step(
            lambda w: loss(w, x, lyr, m, eps, self.beta, self.shape))

    def epoch_steps(self, x, lyr, m, perm: np.ndarray, noise, epoch: int):
        """Yields (step, rows, loss, grads) over one epoch."""
        n = x.shape[0]
        for i, s in enumerate(range(0, n, self.batch)):
            rows = torch.as_tensor(perm[s:s + self.batch], device=x.device)
            eps = noise(epoch, i)[:len(rows)]
            val, grads = self.step(x[rows], lyr[rows], m[rows], eps)
            yield i, len(rows), val, grads


def export(w: Dict[str, torch.Tensor], x, lyr, m, batch: int = 256
           ) -> torch.Tensor:
    """Posterior means of every row."""
    with torch.no_grad():
        return torch.cat([encode(w, x[s:s + batch], lyr[s:s + batch],
                                 m[s:s + batch])[0]
                          for s in range(0, x.shape[0], batch)])


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   skip: List[str] = ()):
    """-> (max over leaves of |prog norm - ref norm| / max(ref norm, median
    ref norm), that leaf), leaves in `skip` left out."""
    keys = [k for k in ref if k not in skip]
    med = float(np.median([ref[k] for k in keys]))
    return max((abs(prog[k] - ref[k]) / max(ref[k], med), k) for k in keys)
