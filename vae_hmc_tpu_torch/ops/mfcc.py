"""MFCC + stats pooling, batched on the device (port of
``vae_hmc_tpu.ops.mfcc``).

librosa semantics (reference scripts/06:56-141, 18:73-97): mel power
spectrogram (n_mels=128, fmax=sr/2) -> power_to_db(ref=1.0, top_db=80) ->
DCT-II ortho along the mel axis -> first n_mfcc rows.  The mel product and
the dB with its floor are kernel 1 (``ops.kernels.logmel``) with
``ref_max=False, top_db=80, standardize=False``, the function of the JAX
package's XLA ``apply_mel`` + ``power_to_db`` here; CPU tensors take its
plain version.  The DCT is a static (n_mfcc, n_mels) matrix applied as a
``torch.matmul`` (the JAX package also computes it outside any kernel).

Stats pooling = concat(mean_t, std_t) per coefficient (06:83-87, 18:91-93),
with optional per-track frame masks for the hard tier's variable-length
clips (18:88: tracks are loaded up to 20 s *without* padding, so T varies).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from vae_hmc_tpu_torch.core.config import MfccConfig
from vae_hmc_tpu_torch.ops import mel as mel_ops
from vae_hmc_tpu_torch.ops.kernels.logmel import mel_db_standardize
from vae_hmc_tpu_torch.ops.stft import power_spectrogram

_TOP_DB = 80.0                    # librosa.feature.mfcc's power_to_db default


@functools.lru_cache(maxsize=4)
def dct_ii_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) orthonormal DCT-II matrix (scipy.fftpack.dct
    norm='ortho'), float32; cached, so callers must not write to it."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    mat = np.sqrt(2.0 / n_in) * np.cos(np.pi * k * (2 * n + 1) / (2.0 * n_in))
    mat[0, :] *= 1.0 / np.sqrt(2.0)
    return mat.astype(np.float32)


def mfcc_batch(y: torch.Tensor, cfg: MfccConfig = MfccConfig()) -> torch.Tensor:
    """Waveforms (B, n_samples) -> MFCC (B, n_mfcc, T)."""
    dev = y.device
    spec = power_spectrogram(y, n_fft=cfg.n_fft, hop_length=cfg.hop_length)
    db = mel_db_standardize(spec, mel_ops.mel_table(cfg, dev), ref_max=False,
                            top_db=_TOP_DB, standardize=False)
    dct = torch.tensor(dct_ii_matrix(cfg.n_mfcc, cfg.n_mels), device=dev)
    return torch.matmul(dct, db)


def stats_pool(feats: torch.Tensor,
               frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, C, T) -> (B, 2C) [mean_t || std_t], population std (ddof=0).

    `frame_mask` (B, T) restricts the statistics to valid frames (the hard
    tier's clips shorter than the 20 s budget keep their true length,
    reference scripts/18:88-93)."""
    if frame_mask is None:
        mu = torch.mean(feats, dim=-1)
        sd = torch.std(feats, dim=-1, correction=0)
    else:
        m = frame_mask[:, None, :].to(feats.dtype)          # (B, 1, T)
        cnt = torch.clamp(torch.sum(m, dim=-1), min=1.0)
        mu = torch.sum(feats * m, dim=-1) / cnt
        var = torch.sum(((feats - mu[..., None]) * m) ** 2, dim=-1) / cnt
        sd = torch.sqrt(var)
    return torch.cat([mu, sd], dim=-1)


def frame_mask_from_lengths(lengths: torch.Tensor, n_samples: int,
                            cfg: MfccConfig) -> torch.Tensor:
    """Sample lengths (B,) -> frame validity mask (B, T) float32 under
    center=True framing (valid frames = 1 + length // hop, librosa stft
    semantics; T = 1 + n_samples // hop)."""
    t = 1 + n_samples // cfg.hop_length
    valid = 1 + lengths.to(torch.int64) // cfg.hop_length
    idx = torch.arange(t, device=lengths.device)[None, :]
    return (idx < valid[:, None]).to(torch.float32)


def mfcc_stats_batch(y: torch.Tensor, cfg: MfccConfig = MfccConfig(),
                     lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Waveforms (B, n_samples) -> (B, 2*n_mfcc) stats vectors.

    Device counterpart of reference scripts/06:56-89 `extract_mfcc_feature`
    (easy preset: fixed 30 s pad/trim, lengths=None) and scripts/18:73-97
    `extract_mfcc_stats` (hard preset: pass the true lengths, on y's
    device)."""
    feats = mfcc_batch(y, cfg)
    mask = None
    if lengths is not None:
        mask = frame_mask_from_lengths(
            torch.as_tensor(lengths, device=y.device), y.shape[-1], cfg)
    return stats_pool(feats, mask)
