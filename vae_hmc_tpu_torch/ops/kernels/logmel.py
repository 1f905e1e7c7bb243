"""Kernel 1: fused mel -> dB -> floor -> per-sample standardize.

Port of the Pallas kernel ``mel_db_standardize`` in
``vae_hmc_tpu/ops/pallas/logmel_kernel.py``; the CUDA source is
``csrc/logmel.cu`` (design and bound in its header).  In the port this
kernel is the production feature path (``pipelines.features``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vae_hmc_tpu_torch.core.config import MelConfig
from vae_hmc_tpu_torch.ops import mel as mel_ops
from vae_hmc_tpu_torch.ops.kernels import build
from vae_hmc_tpu_torch.ops.stft import power_spectrogram

_AMIN = 1e-10


def mel_db_standardize_plain(spec: torch.Tensor, fb: torch.Tensor, *,
                             ref_max: bool = True,
                             top_db: Optional[float] = None,
                             standardize: bool = True,
                             eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, F, T) x (M, F) -> (B, M, T)."""
    x = mel_ops.power_to_db(mel_ops.apply_mel(spec, fb), ref_max=ref_max,
                            amin=_AMIN, top_db=top_db)
    return mel_ops.per_sample_standardize(x, eps) if standardize else x


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def mel_db_standardize(spec: torch.Tensor, fb: torch.Tensor, *,
                       ref_max: bool = True, top_db: Optional[float] = None,
                       standardize: bool = True, eps: float = 1e-6,
                       bands: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, F, T) power spectrogram x (M, F) filterbank -> (B, M, T) features.

    `bands` is ``mel_ops.filterbank_bands`` of fb, int32 (M, 2) on fb's
    device (``mel_ops.filterbank_bands_tensor`` caches it per config); the
    kernel sums only over those bins.  Left out, it is derived from fb
    through a host copy.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if spec.device.type == "cpu":
        return mel_db_standardize_plain(spec, fb, ref_max=ref_max,
                                        top_db=top_db,
                                        standardize=standardize, eps=eps)
    if spec.device.type != "cuda" or fb.device != spec.device:
        raise ValueError(f"spec on {spec.device}, fb on {fb.device}: both "
                         "must be on one CUDA device")
    if spec.dtype != torch.float32 or fb.dtype != torch.float32:
        raise TypeError("mel_db_standardize takes float32 tensors")
    if spec.ndim != 3 or fb.ndim != 2 or fb.shape[1] != spec.shape[1]:
        raise ValueError(f"shapes spec {tuple(spec.shape)} / fb "
                         f"{tuple(fb.shape)}: want (B, F, T) and (M, F)")
    if not (spec.is_contiguous() and fb.is_contiguous()):
        raise ValueError("mel_db_standardize takes contiguous tensors")
    b, f, t = spec.shape
    m = fb.shape[0]
    out = torch.empty((b, m, t), dtype=torch.float32, device=spec.device)
    if b == 0:
        return out
    if bands is None:
        bands = torch.from_numpy(mel_ops.filterbank_bands(
            fb.cpu().numpy())).to(spec.device)
    if (bands.device != spec.device or bands.dtype != torch.int32
            or tuple(bands.shape) != (m, 2) or not bands.is_contiguous()):
        raise ValueError(f"bands {tuple(bands.shape)} {bands.dtype} on "
                         f"{bands.device}: want contiguous int32 ({m}, 2) "
                         f"on {spec.device}")
    lib = build.library("logmel")
    fn = lib.mel_db_standardize
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    stream = torch.cuda.current_stream(spec.device).cuda_stream
    err = fn(spec.data_ptr(), fb.data_ptr(), bands.data_ptr(), out.data_ptr(),
             b, m, f, t,
             int(ref_max), int(top_db is not None),
             float(top_db) if top_db is not None else 0.0,
             int(standardize), float(eps), stream)
    build.check(lib, err, "mel_db_standardize")
    build.LAUNCHES["mel_db_standardize"] += 1
    return out


def logmel_standardized(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Waveforms (B, n_samples) -> features (B, n_mels, T) through the
    kernel; counterpart of ``logmel_standardized_pallas``."""
    spec = power_spectrogram(y, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                             power=cfg.power)
    fb = mel_ops.mel_filterbank_tensor(cfg, y.device)
    bands = mel_ops.filterbank_bands_tensor(cfg, y.device)
    return mel_db_standardize(spec, fb, ref_max=cfg.ref_max,
                              top_db=mel_ops.effective_top_db(cfg),
                              standardize=cfg.per_sample_standardize,
                              bands=bands)
