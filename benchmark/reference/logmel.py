"""Plain log-mel and MFCC features (librosa's definitions, float32).

- power spectrogram: center=True reflect padding, periodic Hann window,
  the real DFT as two products with a cos/sin basis (|X|^2);
- Slaney mel filterbank (librosa ``filters.mel``, htk=False,
  norm='slaney'), built in float64 on the host;
- ``power_to_db`` with amin 1e-10, a per-sample max reference where asked,
  and the top_db floor below the sample's peak;
- per-sample standardization: (x - mean) / (population std + 1e-6);
- MFCC: the orthonormal DCT-II of the dB mel spectrogram (reference 1.0,
  80 dB floor), its first n_mfcc rows; stats = per-coefficient mean and
  population std over the frames.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

AMIN = 1e-10
EPS = 1e-6


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1e-12) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = m * (200.0 / 3)
    log = 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0))
    return np.where(m >= 15.0, log, lin)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax=None) -> np.ndarray:
    fmax = sr / 2.0 if fmax is None else fmax
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                   n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    w *= (2.0 / (mel_f[2:] - mel_f[:-2]))[:, None]
    return w


def power_spectrogram(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, L) -> (B, 1 + n_fft // 2, 1 + L // hop) power."""
    pad = n_fft // 2
    yp = F.pad(y[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = yp.unfold(1, n_fft, hop)                     # (B, T, n_fft)
    n = torch.arange(n_fft, dtype=torch.float64)
    window = (0.5 - 0.5 * torch.cos(2 * math.pi * n / n_fft)).to(y)
    k = torch.arange(n_fft // 2 + 1, dtype=torch.float64)
    ang = 2 * math.pi * ((n[:, None] * k[None, :]) % n_fft) / n_fft
    cos, sin = torch.cos(ang).to(y), torch.sin(ang).to(y)
    fw = frames * window
    re, im = fw @ cos, fw @ sin
    return (re * re + im * im).transpose(1, 2)


def power_to_db(s: torch.Tensor, ref_max: bool, top_db) -> torch.Tensor:
    db = 10.0 * torch.log10(torch.clamp(s, min=AMIN))
    if ref_max:
        ref = torch.amax(s, dim=(1, 2), keepdim=True)
        db = db - 10.0 * torch.log10(torch.clamp(ref, min=AMIN))
    if top_db is not None:
        db = torch.maximum(db, torch.amax(db, dim=(1, 2), keepdim=True)
                           - top_db)
    return db


def logmel(y: torch.Tensor, mel: dict) -> torch.Tensor:
    """Standardized log-mel (B, n_mels, T) of waveforms (B, L)."""
    fb = torch.as_tensor(mel_filterbank(
        mel["sample_rate"], mel["n_fft"], mel["n_mels"], mel["fmin"],
        mel["fmax"]), dtype=torch.float32, device=y.device)
    s = fb @ power_spectrogram(y, mel["n_fft"], mel["hop_length"])
    db = power_to_db(s, mel["ref_max"], mel["top_db"] or None)
    mu = db.mean(dim=(1, 2), keepdim=True)
    sd = db.std(dim=(1, 2), keepdim=True, correction=0) + EPS
    return (db - mu) / sd


def dct_ortho(n_out: int, n_in: int) -> np.ndarray:
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    m = np.sqrt(2.0 / n_in) * np.cos(np.pi * k * (2 * n + 1) / (2.0 * n_in))
    m[0] /= np.sqrt(2.0)
    return m


def mfcc_stats(y: torch.Tensor, mfcc: dict) -> torch.Tensor:
    """(B, L) -> (B, 2 n_mfcc): per-coefficient mean and std over frames."""
    fb = torch.as_tensor(mel_filterbank(
        mfcc["sample_rate"], mfcc["n_fft"], mfcc["n_mels"], mfcc["fmin"],
        mfcc["fmax"]), dtype=torch.float32, device=y.device)
    s = fb @ power_spectrogram(y, mfcc["n_fft"], mfcc["hop_length"])
    db = power_to_db(s, False, 80.0)
    dct = torch.as_tensor(dct_ortho(mfcc["n_mfcc"], mfcc["n_mels"]),
                          dtype=torch.float32, device=y.device)
    c = dct @ db
    return torch.cat([c.mean(dim=2), c.std(dim=2, correction=0)], dim=1)
