"""Batched power spectrogram (port of ``vae_hmc_tpu.ops.stft``).

librosa stft semantics: center=True reflect padding, periodic Hann window
of n_fft.  The rDFT is two plain fp32 matmuls against a cos/sin basis, as
the JAX package computes it (``method="dft"``); they go to cuBLAS with TF32
off (core.device), the analogue of the reference's ``Precision.HIGHEST``.
``method="fft"`` takes ``torch.fft.rfft`` instead.

(B, n_samples) in, (B, 1 + n_fft//2, n_frames) out: a view of a buffer
whose rows are padded with zeros to a multiple of 4 frames (16 bytes), so
that kernel 1 (``ops.kernels.logmel``) can copy each row segment with a TMA
bulk copy; at T = 646 a row is 2,584 bytes, which is not 16-byte aligned.
The values are those of the contiguous result.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def hann_window(n: int, device=None) -> torch.Tensor:
    """Periodic Hann (scipy.signal.get_window('hann', n, fftbins=True)),
    computed in float64 and rounded once, as the JAX package does.  Made
    once per (n, device): a spectrogram then copies nothing from the host,
    so a CUDA graph can capture it."""
    k = torch.arange(n, dtype=torch.float64)
    w = 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)
    return w.to(device=device, dtype=torch.float32)


def frame_signal(y: torch.Tensor, n_fft: int,
                 hop_length: int) -> torch.Tensor:
    """(B, L) -> (B, T, n_fft) frames, librosa center=True semantics:
    T = 1 + L // hop."""
    if y.ndim != 2:
        raise ValueError(f"expected (batch, samples), got {tuple(y.shape)}")
    if n_fft % hop_length:
        raise ValueError(f"hop_length {hop_length} must divide n_fft {n_fft}")
    t = 1 + y.shape[1] // hop_length
    pad = n_fft // 2
    # reflect padding needs a (N, C, L) view
    y = F.pad(y[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    # slice framing: frame t is r = n_fft/hop consecutive hop-blocks
    r = n_fft // hop_length
    need = (t - 1) * hop_length + n_fft
    blocks = y[:, :need].reshape(y.shape[0], need // hop_length, hop_length)
    return torch.cat([blocks[:, i:i + t, :] for i in range(r)], dim=2)


@functools.lru_cache(maxsize=None)
def dft_matrices(n_fft: int, device=None):
    """(n_fft, F) cos and sin rDFT bases, F = n_fft//2 + 1, made once per
    (n_fft, device) as ``hann_window`` is.

    The angle is reduced mod n_fft in integer arithmetic before the float
    multiply (t*f <= n_fft^2/2 is exact), so cos/sin never see a large
    argument and the basis does not drift."""
    t = torch.arange(n_fft, dtype=torch.int64, device=device)[:, None]
    f = torch.arange(n_fft // 2 + 1, dtype=torch.int64, device=device)[None, :]
    tf = (t * f) % n_fft
    ang = tf.to(torch.float32) * torch.tensor(2.0 * math.pi / n_fft,
                                              dtype=torch.float32,
                                              device=device)
    return torch.cos(ang), torch.sin(ang)


def power_spectrogram(y: torch.Tensor, n_fft: int = 2048,
                      hop_length: int = 512, power: float = 2.0,
                      method: str = "dft") -> torch.Tensor:
    """(B, L) waveforms -> (B, 1 + n_fft//2, T) |STFT|^power, with the row
    pitch padded to a multiple of 4 frames (``row_aligned``).

    method="dft" (the default, which every tier uses): two fp32 matmuls
    against the cos/sin basis.  method="fft": ``torch.fft.rfft`` (cuFFT on
    the card), |X| raised to `power` as the JAX package's "fft" branch
    does; the two agree to f32 roundoff."""
    if method not in ("dft", "fft"):
        raise ValueError(f"method must be 'dft' or 'fft', got {method!r}")
    frames = frame_signal(y, n_fft, hop_length)
    frames = frames * hann_window(n_fft, y.device)
    if method == "fft":
        mag = torch.fft.rfft(frames, n=n_fft, dim=-1).abs()     # (B, T, F)
        if power != 1.0:
            mag = mag ** power
        return row_aligned(mag.transpose(1, 2))
    cos_m, sin_m = dft_matrices(n_fft, y.device)
    re = torch.matmul(frames, cos_m)                           # (B, T, F)
    im = torch.matmul(frames, sin_m)
    mag = re * re + im * im
    if power == 1.0:
        mag = torch.sqrt(mag)
    elif power != 2.0:
        mag = mag ** (power / 2.0)
    return row_aligned(mag.transpose(1, 2))                     # (B, F, T)


def row_aligned(x: torch.Tensor) -> torch.Tensor:
    """(B, F, T) -> the same values as a view of a (B, F, Tp) buffer, Tp the
    next multiple of 4 (16-byte rows), with the pad columns zero.  Returns x
    itself when it already has that layout."""
    b, f, t = x.shape
    tp = -(-t // 4) * 4
    if x.stride() == (f * tp, tp, 1) and x.data_ptr() % 16 == 0:
        return x
    buf = torch.empty((b, f, tp), dtype=x.dtype, device=x.device)
    buf[:, :, t:].zero_()
    buf[:, :, :t].copy_(x)
    return buf[:, :, :t]


def pad_with_reflect_tail(y: np.ndarray, target_len: int, n_fft: int) -> np.ndarray:
    """Stage a variable-length track into a fixed (target_len,) buffer for the
    masked-stats path (copy of the JAX package's, numpy): zero-pad, but write
    the first n_fft//2 padded samples as the np.pad 'reflect' continuation of
    the signal.  This makes the frames near the track's true end identical
    to librosa's center=True reflect padding of the *unpadded* signal (hard
    tier, reference scripts/18:88: clips are loaded at true length, not
    padded), so masked stats are exact rather than approximately right at
    the boundary.
    """
    y = np.asarray(y)
    n = y.shape[-1]
    if n >= target_len:
        return y[..., :target_len]
    out = np.zeros(y.shape[:-1] + (target_len,), dtype=y.dtype)
    out[..., :n] = y
    p = min(n_fft // 2, target_len - n, n - 1)
    if p > 0:
        out[..., n:n + p] = y[..., n - 2:n - 2 - p:-1] if n - 2 - p >= 0 \
            else y[..., n - 2::-1][..., :p]
    return out
