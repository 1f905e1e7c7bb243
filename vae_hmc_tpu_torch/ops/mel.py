"""Mel filterbank and the plain log-mel path (port of ``vae_hmc_tpu.ops.mel``).

The filterbank is a static (n_mels, n_freq) matrix built on the host with
librosa's Slaney construction (htk=False, norm='slaney'); the functions
below it are the plain torch composition that kernel 1
(``ops.kernels.logmel``) fuses: mel matmul, power_to_db with the
per-sample ref=max and top_db floor, per-sample standardization.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from vae_hmc_tpu_torch.core.config import MelConfig
from vae_hmc_tpu_torch.core.profiling import sync
from vae_hmc_tpu_torch.ops.stft import power_spectrogram


# ---------------------------------------------------------------------------
# Filterbank construction (host, static) -- numpy copy of the JAX package's
# ---------------------------------------------------------------------------


def hz_to_mel(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa htk=False)."""
    freq = np.asanyarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if mels.ndim:
        log_t = freq >= min_log_hz
        mels[log_t] = min_log_mel + np.log(freq[log_t] / min_log_hz) / logstep
    elif freq >= min_log_hz:
        mels = min_log_mel + np.log(freq / min_log_hz) / logstep
    return mels


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asanyarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if mels.ndim:
        log_t = mels >= min_log_mel
        freqs[log_t] = min_log_hz * np.exp(logstep * (mels[log_t] - min_log_mel))
    elif mels >= min_log_mel:
        freqs = min_log_hz * np.exp(logstep * (mels - min_log_mel))
    return freqs


def mel_frequencies(n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    return mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels))


def mel_filterbank(sr: int, n_fft: int, n_mels: int = 128, fmin: float = 0.0,
                   fmax: Optional[float] = None,
                   dtype=np.float32) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) triangular Slaney-normalized filterbank."""
    if fmax is None:
        fmax = sr / 2.0
    n_freq = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_freq)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])      # slaney norm
    weights *= enorm[:, None]
    return weights.astype(dtype)


def filterbank_bands(fb: np.ndarray) -> np.ndarray:
    """(n_mels, 2) int32: each row's half-open range [lo, hi) of frequency
    bins with a nonzero weight ([n_freq, 0) for an all-zero row).  Kernel 1
    sums only over these bins."""
    nz = fb != 0
    any_nz = nz.any(axis=1)
    lo = np.where(any_nz, np.argmax(nz, axis=1), fb.shape[1])
    hi = np.where(any_nz, fb.shape[1] - np.argmax(nz[:, ::-1], axis=1), 0)
    return np.stack([lo, hi], axis=1).astype(np.int32)


def filterbank_weights(fb: np.ndarray, bands: np.ndarray) -> np.ndarray:
    """(nnz,) float32: each row's weights over its band ``[lo, hi)``, packed
    row after row (nnz = sum of hi - lo).  With the bands this is kernel 1's
    compact filterbank table (2,018 weights for the 128-mel Slaney bank)."""
    return np.concatenate([np.asarray(row[lo:hi], np.float32)
                           for row, (lo, hi) in zip(fb, bands)]
                          + [np.zeros(0, np.float32)])


@functools.lru_cache(maxsize=8)
def _filterbank_and_bands(sr: int, n_fft: int, n_mels: int, fmin: float,
                          fmax: Optional[float]):
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    bands = filterbank_bands(fb)
    return fb, bands, filterbank_weights(fb, bands)


def _table(a: np.ndarray, device) -> torch.Tensor:
    """A host table copied to `device` (a wait on the device)."""
    with sync("mel.table"):
        return torch.tensor(a, device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class MelTable:
    """A mel filterbank on one device, in both forms its readers take:
    `fb`, the dense (M, F) float32 bank of the plain path, and kernel 1's
    compact table: `bands`, int32 (M, 2), each row's [lo, hi) of nonzero
    bins (``filterbank_bands``), and `weights`, float32 (nnz,), the rows'
    weights over their bands packed in row order (``filterbank_weights``).
    Each of the three is copied to the device in its own ``mel.table``
    sync range when the table is built."""
    fb: torch.Tensor
    bands: torch.Tensor
    weights: torch.Tensor

    @classmethod
    def from_bank(cls, fb, device) -> "MelTable":
        """The table of an arbitrary dense (M, F) bank held on the host."""
        fb = np.asarray(fb, np.float32)
        bands = filterbank_bands(fb)
        return cls(*(_table(a, device) for a in
                     (fb, bands, filterbank_weights(fb, bands))))


def mel_table(cfg, device) -> MelTable:
    """The ``MelTable`` of the filterbank of a ``MelConfig`` or
    ``MfccConfig`` (any config with ``sample_rate``, ``n_fft``, ``n_mels``,
    ``fmin`` and ``fmax``) on `device`; the host side is cached by those
    five values, the device copies are made anew on each call."""
    return MelTable(*(_table(a, device) for a in _filterbank_and_bands(
        cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)))


def effective_top_db(cfg: MelConfig) -> Optional[float]:
    """top_db <= 0 (or None) disables the floor, as in the JAX package."""
    return cfg.top_db if cfg.top_db is not None and cfg.top_db > 0 else None


# ---------------------------------------------------------------------------
# Plain torch path
# ---------------------------------------------------------------------------


def power_to_db(s: torch.Tensor, ref_max: bool = True, amin: float = 1e-10,
                top_db: Optional[float] = 80.0) -> torch.Tensor:
    """librosa.power_to_db over a batch: (B, n_mels, T) -> dB, with each
    sample's own max as the reference when ref_max."""
    log_spec = 10.0 * torch.log10(torch.clamp(s, min=amin))
    if ref_max:
        ref = torch.amax(s, dim=(-2, -1), keepdim=True)
        log_spec = log_spec - 10.0 * torch.log10(torch.clamp(ref, min=amin))
    if top_db is not None:
        peak = torch.amax(log_spec, dim=(-2, -1), keepdim=True)
        log_spec = torch.maximum(log_spec, peak - top_db)
    return log_spec


def apply_mel(spec: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """(B, F, T) power spec x (n_mels, F) filterbank -> (B, n_mels, T)."""
    return torch.matmul(fb, spec)


def logmel_batch(y: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """Waveform batch (B, n_samples) -> log-mel dB (B, n_mels, T)."""
    spec = power_spectrogram(y, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                             power=cfg.power)
    mel = apply_mel(spec, mel_table(cfg, y.device).fb)
    return power_to_db(mel, ref_max=cfg.ref_max, top_db=effective_top_db(cfg))


def per_sample_standardize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Whole-spectrogram mean/std per sample (reference scripts/10:69-72):
    population std (correction=0, as jnp.std), eps added to the std."""
    dims = tuple(range(1, x.ndim))
    mu = torch.mean(x, dim=dims, keepdim=True)
    sd = torch.std(x, dim=dims, keepdim=True, correction=0) + eps
    return (x - mu) / sd
