"""Conv multimodal VAE with gated lyrics fusion (port of
``vae_hmc_tpu.models.conv_mm_vae.ConvMMVAE``; reference scripts/12:83-190).

  - audio encoder: three 3x3 stride-2 convs (32/64/128 ch) + 256-d FC head
    -> (mu_a, logvar_a);
  - lyrics projector 384 -> 256 -> 128, ReLU, gated by the presence mask;
  - fusion MLP on [mu_a, l, m] -> (mu, logvar) of the final latent;
  - decoder: FC -> ConvTranspose2d(4, 2, 1) stack (64/32/1 ch), cropped to
    the input (n_mels, T) (12:134-141, 12:260).

A float32 decode on CUDA runs the forward of each ConvTranspose2d of 32 or
more output channels as one stride-1 2x2 convolution over its four output
phases and an interleave (``phase_conv_transpose2d``): cuDNN offers a
stride-2 transposed conv's forward only FFT or dgrad engines, and the phase
form runs on its fprop engines.  Its backward is the transposed conv's own.  bf16, the CPU and the
1-channel last layer keep the module's forward (``phase_deconv_engages``);
``DECONV_PATHS`` counts the calls of each path.

Internally NCHW for cuDNN; at the public boundary the JAX layout
(B, n_mels, T, 1).  Parameter names follow the Flax module's, so
``models.convert`` maps a Flax parameter tree onto this module one to one.
At full width (128, 646) the encoder flattens 128 x 16 x 81 = 165,888
features into the 256-d FC.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vae_hmc_tpu_torch.core.profiling import span
from vae_hmc_tpu_torch.models.dense_vae import reparameterize

# the decoder's transposed-conv calls by path since the last reset
DECONV_PATHS: Dict[str, int] = {"phase": 0, "transposed": 0}


def reset_deconv_paths() -> None:
    for k in DECONV_PATHS:
        DECONV_PATHS[k] = 0


def deconv_path_counts() -> Dict[str, int]:
    return dict(DECONV_PATHS)


def _conv_out(n: int, k: int = 3, s: int = 2, p: int = 1) -> int:
    return (n + 2 * p - k) // s + 1


def conv_tower_shape(h: int, w: int, n_layers: int = 3) -> Tuple[int, int]:
    for _ in range(n_layers):
        h, w = _conv_out(h), _conv_out(w)
    return h, w


def phase_weight(weight: torch.Tensor) -> torch.Tensor:
    """A ConvTranspose2d(4, 2, 1) weight (Cin, Cout, 4, 4) -> the stride-1
    2x2 conv weight (4 Cout, Cin, 2, 2) of its four output phases, in the
    order (ry, rx) = (0, 0), (0, 1), (1, 0), (1, 1).  Phase r at window
    offset a takes tap 3 - r - 2a in each axis: flipped, tap 2a + r."""
    cin, cout = weight.shape[:2]
    w = weight.flip(2, 3).view(cin, cout, 2, 2, 2, 2)   # c, o, ay, ry, ax, rx
    return w.permute(3, 5, 1, 0, 2, 4).reshape(4 * cout, cin, 2, 2)


def _phase_forward(x, weight, bias):
    b, _, h, w = x.shape
    cout = weight.shape[1]
    y = F.conv2d(x, phase_weight(weight), padding=1)
    # out[b, o, 2i + ry, 2j + rx] = y[b, (2 ry + rx) cout + o, i + ry, j + rx]
    # + bias[o]: a strided view of y in the output's order, read once by the
    # pass that adds the bias (torch's conv would add it in a pass of its
    # own over y; the same sums, 9-15% of the layer on an H100)
    sb, sc, sh, sw = y.stride()
    phases = y.as_strided((b, cout, h, 2, w, 2),
                          (sb, sc, sh, 2 * cout * sc + sh, sw, cout * sc + sw))
    out = torch.empty((b, cout, 2 * h, 2 * w), dtype=y.dtype, device=y.device)
    out6 = out.view(b, cout, h, 2, w, 2)
    if bias is None:
        out6.copy_(phases)
    else:
        torch.add(phases, bias.view(cout, 1, 1, 1, 1), out=out6)
    return out


class _PhaseDeconv(torch.autograd.Function):
    """The forward as four output phases; the backward the op autograd
    runs for ``F.conv_transpose2d`` (the input gradient a strided fprop
    conv, the weight and bias gradients on their engines of today).  Saves
    x and the weight, not the phase weight or the conv's output."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.bias_sizes = None if bias is None else list(bias.shape)
        return _phase_forward(x, weight, bias)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        need = ctx.needs_input_grad
        return torch.ops.aten.convolution_backward(
            grad, x, weight, ctx.bias_sizes, [2, 2], [1, 1], [1, 1], True,
            [0, 0], 1, [need[0], need[1], need[2]])


def phase_conv_transpose2d(x: torch.Tensor, weight: torch.Tensor,
                           bias: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """``F.conv_transpose2d(x, weight, bias, stride=2, padding=1)`` for a
    (Cin, Cout, 4, 4) weight: one ``conv2d`` of the phase weight with
    padding 1 -> (B, 4 Cout, H + 1, W + 1), each phase's H x W window
    interleaved into (B, Cout, 2H, 2W) with the bias added.  The same
    products as the transposed conv, plus the windows' border outputs,
    thrown away."""
    return _PhaseDeconv.apply(x, weight, bias)


# The phase form's conv has 4 Cout output channels.  Alone at batch 64 on an
# H100 (cuDNN 9.2, chip_smoke.py phase 2), against the transposed conv's
# measured engine it gained at Cout 64 (1.04 -> 0.73 ms) and 32 (1.55 ->
# 0.81 ms), and lost at Cout 1, a 4-column GEMM (0.35 -> 0.47 ms).
PHASE_MIN_OUT_CHANNELS = 32


def phase_deconv_engages(x: torch.Tensor, deconv: nn.ConvTranspose2d
                         ) -> bool:
    """The decoder's rule: float32 on CUDA, the traffic timed to gain, at
    output widths timed to gain.  bf16 keeps the engines its goldens were
    certified on, the CPU the path its parity tests hold."""
    return (x.is_cuda and x.dtype == torch.float32
            and deconv.out_channels >= PHASE_MIN_OUT_CHANNELS)


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
        last = len(self.dec_convs) - 1
        for i, deconv in enumerate(self.dec_convs):
            if phase_deconv_engages(h, deconv):
                DECONV_PATHS["phase"] += 1
                with span("model.deconv"):
                    h = phase_conv_transpose2d(h, deconv.weight, deconv.bias)
            else:
                DECONV_PATHS["transposed"] += 1
                h = deconv(h)
            if i < last:
                h = F.relu(h)
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

