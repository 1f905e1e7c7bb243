"""Conv multimodal VAE with gated lyrics fusion (port of
``vae_hmc_tpu.models.conv_mm_vae.ConvMMVAE``; reference scripts/12:83-190).

  - audio encoder: three 3x3 stride-2 convs (32/64/128 ch) + 256-d FC head
    -> (mu_a, logvar_a);
  - lyrics projector 384 -> 256 -> 128, ReLU, gated by the presence mask;
  - fusion MLP on [mu_a, l, m] -> (mu, logvar) of the final latent;
  - decoder: FC -> ConvTranspose2d(4, 2, 1) stack (64/32/1 ch), cropped to
    the input (n_mels, T) (12:134-141, 12:260).

Internally NCHW for cuDNN; at the public boundary the JAX layout
(B, n_mels, T, 1).  Parameter names follow the Flax module's, so
``models.convert`` maps a Flax parameter tree onto this module one to one.
At full width (128, 646) the encoder flattens 128 x 16 x 81 = 165,888
features into the 256-d FC.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vae_hmc_tpu_torch.models.dense_vae import reparameterize


def _conv_out(n: int, k: int = 3, s: int = 2, p: int = 1) -> int:
    return (n + 2 * p - k) // s + 1


def conv_tower_shape(h: int, w: int, n_layers: int = 3) -> Tuple[int, int]:
    for _ in range(n_layers):
        h, w = _conv_out(h), _conv_out(w)
    return h, w


class ConvMMVAE(nn.Module):
    def __init__(self, n_mels: int = 128, n_frames: int = 646,
                 channels: Tuple[int, ...] = (32, 64, 128), fc_dim: int = 256,
                 latent_dim: int = 32, lyrics_dim: int = 384,
                 lyrics_proj_dim: int = 128):
        super().__init__()
        self.n_mels, self.n_frames = n_mels, n_frames
        self.latent_dim = latent_dim
        self.channels = tuple(channels)
        self.enc_hw = conv_tower_shape(n_mels, n_frames, len(channels))
        ins = (1,) + self.channels[:-1]
        self.enc_convs = nn.ModuleList(
            nn.Conv2d(i, o, 3, stride=2, padding=1)
            for i, o in zip(ins, self.channels))
        eh, ew = self.enc_hw
        flat = eh * ew * self.channels[-1]
        self.enc_fc = nn.Linear(flat, fc_dim)
        self.mu_a = nn.Linear(fc_dim, latent_dim)
        self.logvar_a = nn.Linear(fc_dim, latent_dim)
        self.lyr1 = nn.Linear(lyrics_dim, 256)
        self.lyr2 = nn.Linear(256, lyrics_proj_dim)
        self.fuse = nn.Linear(latent_dim + lyrics_proj_dim + 1, 256)
        self.mu = nn.Linear(256, latent_dim)
        self.logvar = nn.Linear(256, latent_dim)
        self.dec_fc1 = nn.Linear(latent_dim, 256)
        self.dec_fc2 = nn.Linear(256, flat)
        dch = tuple(reversed(self.channels[:-1])) + (1,)       # (64, 32, 1)
        self.dec_convs = nn.ModuleList(
            nn.ConvTranspose2d(i, o, 4, stride=2, padding=1)
            for i, o in zip((self.channels[-1],) + dch[:-1], dch))

    def encode_audio(self, x_nchw: torch.Tensor):
        h = x_nchw
        for conv in self.enc_convs:
            h = F.relu(conv(h))
        h = F.relu(self.enc_fc(h.flatten(1)))                  # NCHW flatten
        return self.mu_a(h), self.logvar_a(h)

    def encode(self, x: torch.Tensor, lyr: torch.Tensor, m: torch.Tensor):
        """Posterior mean path: x (B, n_mels, T, 1), lyr (B, L), m (B, 1)
        -> (mu, logvar)."""
        mu_a, _ = self.encode_audio(x.permute(0, 3, 1, 2))
        l = F.relu(self.lyr2(F.relu(self.lyr1(lyr)))) * m
        h = F.relu(self.fuse(torch.cat([mu_a, l, m], dim=-1)))
        return self.mu(h), self.logvar(h)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, latent) -> xhat (B, n_mels, T, 1)."""
        eh, ew = self.enc_hw
        h = F.relu(self.dec_fc1(z))
        h = F.relu(self.dec_fc2(h)).view(z.shape[0], self.channels[-1], eh, ew)
        for deconv in self.dec_convs[:-1]:
            h = F.relu(deconv(h))
        h = self.dec_convs[-1](h)
        h = h[:, :, : self.n_mels, : self.n_frames]            # crop (ref 12:260)
        return h.permute(0, 2, 3, 1)

    def forward(self, x, lyr, m, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """-> (xhat, mu, logvar).  The reparameterization noise is `eps`
        (tests feed both frameworks the same eps) or a draw from
        `generator`, in mu's dtype (``reparameterize``)."""
        mu, logvar = self.encode(x, lyr, m)
        return (self.decode(reparameterize(mu, logvar, eps, generator)),
                mu, logvar)

