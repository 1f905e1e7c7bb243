"""Deterministic autoencoder baseline (port of ``vae_hmc_tpu.models.ae.AE``;
reference scripts/22:66-88).

enc: in -> 256 -> 256 -> z (ReLU between, linear bottleneck);
dec: z -> 256 -> 256 -> in (ReLU between, linear output).
Used only as the hard-tier comparison arm (22:139-171).  Layer names are
the Flax module's (e1..e3, d1..d3).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class AE(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int = 256,
                 latent_dim: int = 16):
        super().__init__()
        h, z = hidden_dim, latent_dim
        self.latent_dim = latent_dim
        self.e1 = nn.Linear(input_dim, h)
        self.e2 = nn.Linear(h, h)
        self.e3 = nn.Linear(h, z)
        self.d1 = nn.Linear(z, h)
        self.d2 = nn.Linear(h, h)
        self.d3 = nn.Linear(h, input_dim)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.e3(F.relu(self.e2(F.relu(self.e1(x)))))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.d3(F.relu(self.d2(F.relu(self.d1(z)))))

    def forward(self, x):
        """-> (xhat, z)."""
        z = self.encode(x)
        return self.decode(z), z
