"""Dense (MLP) VAE family: basic VAE, Beta-VAE, CVAE — one module (port of
``vae_hmc_tpu.models.dense_vae.DenseVAE``).

  - easy-tier basic VAE (reference scripts/06:145-179): enc
    input->256->256 -> (mu, logvar latent=16); dec latent->256->256->input;
  - hard-tier Beta-VAE (19:64-121 with conditional=False): same topology,
    beta=4;
  - hard-tier CVAE (19:64-121 conditional=True): the condition one-hot is
    concatenated to the encoder input AND to z at the decoder input
    (19:99-102, 19:110-115).

ReLU activations, linear output.  The layers carry the Flax module's names
(enc1.., mu, logvar, dec1.., out), so ``models.convert.linear_state_dict``
maps a Flax parameter tree onto this module one to one.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class DenseVAE(nn.Module):
    def __init__(self, input_dim: int, hidden_dims: Sequence[int] = (256, 256),
                 latent_dim: int = 16, cond_dim: int = 0):
        super().__init__()
        self.input_dim, self.latent_dim = input_dim, latent_dim
        self.cond_dim = cond_dim                # > 0 -> CVAE
        hidden = tuple(hidden_dims)
        dims = (input_dim + cond_dim,) + hidden
        self.enc_names = [f"enc{i + 1}" for i in range(len(hidden))]
        for i, name in enumerate(self.enc_names):
            self.add_module(name, nn.Linear(dims[i], dims[i + 1]))
        self.mu = nn.Linear(hidden[-1], latent_dim)
        self.logvar = nn.Linear(hidden[-1], latent_dim)
        ddims = (latent_dim + cond_dim,) + tuple(reversed(hidden))
        self.dec_names = [f"dec{i + 1}" for i in range(len(hidden))]
        for i, name in enumerate(self.dec_names):
            self.add_module(name, nn.Linear(ddims[i], ddims[i + 1]))
        self.out = nn.Linear(ddims[-1], input_dim)

    @property
    def conditional(self) -> bool:
        return self.cond_dim > 0

    def encode(self, x: torch.Tensor, c: Optional[torch.Tensor] = None):
        """-> (mu, logvar)."""
        h = torch.cat([x, c], dim=-1) if self.conditional else x
        for name in self.enc_names:
            h = F.relu(getattr(self, name)(h))
        return self.mu(h), self.logvar(h)

    def decode(self, z: torch.Tensor, c: Optional[torch.Tensor] = None):
        h = torch.cat([z, c], dim=-1) if self.conditional else z
        for name in self.dec_names:
            h = F.relu(getattr(self, name)(h))
        return self.out(h)

    def forward(self, x, c: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """-> (xhat, mu, logvar).  The reparameterization noise is `eps`
        (tests feed both frameworks the same eps) or a draw from
        `generator`, in mu's dtype (``reparameterize``)."""
        mu, logvar = self.encode(x, c)
        return (self.decode(reparameterize(mu, logvar, eps, generator), c),
                mu, logvar)


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """mu + eps * exp(logvar / 2) in mu's dtype (bf16 under the trainer's
    mixed precision, as ``vae_hmc_tpu/models/dense_vae.py:85-88`` draws
    it).  eps is given, or drawn from `generator`; torch's global
    generator is never used."""
    std = torch.exp(0.5 * logvar)
    if eps is None:
        if generator is None:
            raise ValueError("reparameterize needs eps or a generator")
        eps = torch.randn(std.shape, generator=generator, dtype=mu.dtype,
                          device=mu.device)
    return mu + eps.to(device=mu.device, dtype=mu.dtype) * std
