"""Kernel 1: fused mel -> dB -> floor -> per-sample standardize.

Port of the Pallas kernel ``mel_db_standardize`` in
``vae_hmc_tpu/ops/pallas/logmel_kernel.py``; the CUDA source is
``csrc/logmel.cu``.  One launch: a cluster of 8 thread blocks per sample
keeps the sample's (M, T) mel slice in shared memory, streams the
spectrogram once through a cp.async ring and sums each filterbank row over
its own band only; the per-sample max, mean and variance cross the cluster
through distributed shared memory.  Bound by the bytes of the spectrogram
(header of the source).  In the port this kernel is the production feature
path (``pipelines.features``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vae_hmc_tpu_torch.core.config import MelConfig
from vae_hmc_tpu_torch.ops import mel as mel_ops
from vae_hmc_tpu_torch.ops.kernels import build
from vae_hmc_tpu_torch.ops.stft import power_spectrogram, row_aligned

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


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
    ctypes.c_longlong] + [ctypes.c_int] * 3 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def _rows_16b(spec: torch.Tensor) -> bool:
    """Whether a TMA tensor map can describe spec as it lies: unit stride
    along T, row and sample strides of whole 16-byte units, a 16-byte
    aligned base."""
    s0, s1, s2 = spec.stride()
    return s2 == 1 and s1 % 4 == 0 and s0 % 4 == 0 and spec.data_ptr() % 16 == 0


def _library() -> ctypes.CDLL:
    lib = build.library("logmel")
    lib.mel_db_standardize.argtypes = _ARGTYPES
    lib.mel_db_standardize.restype = ctypes.c_int
    lib.mel_db_cluster_occupancy.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.mel_db_cluster_occupancy.restype = ctypes.c_int
    return lib


def cluster_occupancy(n_mels: int, n_freq: int, n_frames: int,
                      nnz: int) -> int:
    """Clusters of kernel 1 (8 blocks each) that the current CUDA device
    holds at once for this shape and filterbank size."""
    lib = _library()
    out = ctypes.c_int(0)
    build.check(lib, lib.mel_db_cluster_occupancy(n_mels, n_freq, n_frames,
                                                  nnz, ctypes.byref(out)),
                "mel_db_cluster_occupancy")
    return out.value


def mel_db_standardize(spec: torch.Tensor, fb: torch.Tensor, *,
                       ref_max: bool = True, top_db: Optional[float] = None,
                       standardize: bool = True, eps: float = 1e-6,
                       bands: Optional[torch.Tensor] = None,
                       weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, F, T) power spectrogram x (M, F) filterbank -> (B, M, T) features.

    The kernel reads spec through a TMA tensor map, which needs 16-byte
    aligned rows: ``ops.stft.power_spectrogram`` pads its rows so; any other
    layout is first copied into one (``ops.stft.row_aligned``).
    It reads the filterbank as a compact table: `bands`, int32
    (M, 2), each row's [lo, hi) of nonzero bins (``mel_ops.filterbank_bands``),
    and `weights`, float32 (nnz,), the rows' weights over their bands packed
    in row order (``mel_ops.filterbank_weights``); both on spec's device
    (``mel_ops.filterbank_{bands,weights}_tensor`` cache them per config).
    Left out, they are derived from fb through a host copy.  CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
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
    if not fb.is_contiguous():
        raise ValueError("mel_db_standardize takes a contiguous filterbank")
    b, f, t = spec.shape
    m = fb.shape[0]
    out = torch.empty((b, m, t), dtype=torch.float32, device=spec.device)
    if b == 0:
        return out
    if bands is None or weights is None:
        fb_host = fb.cpu().numpy()
        bands_host = mel_ops.filterbank_bands(fb_host)
        bands = torch.from_numpy(bands_host).to(spec.device)
        weights = torch.from_numpy(mel_ops.filterbank_weights(
            fb_host, bands_host)).to(spec.device)
    if (bands.device != spec.device or bands.dtype != torch.int32
            or tuple(bands.shape) != (m, 2) or not bands.is_contiguous()):
        raise ValueError(f"bands {tuple(bands.shape)} {bands.dtype} on "
                         f"{bands.device}: want contiguous int32 ({m}, 2) "
                         f"on {spec.device}")
    if (weights.device != spec.device or weights.dtype != torch.float32
            or weights.ndim != 1 or not weights.is_contiguous()):
        raise ValueError(f"weights {tuple(weights.shape)} {weights.dtype} on "
                         f"{weights.device}: want contiguous float32 (nnz,) "
                         f"on {spec.device}")
    if not _rows_16b(spec):
        spec = row_aligned(spec)
    lib = _library()
    stream = torch.cuda.current_stream(spec.device).cuda_stream
    err = lib.mel_db_standardize(
        spec.data_ptr(), bands.data_ptr(), weights.data_ptr(), out.data_ptr(),
        b, m, f, t, spec.stride(1), spec.stride(0), weights.numel(),
        int(ref_max), int(top_db is not None),
        float(top_db) if top_db is not None else 0.0, int(standardize),
        float(eps), stream)
    build.check(lib, err, "mel_db_standardize")
    build.LAUNCHES["mel_db_standardize"] += 1
    return out


def logmel_standardized(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Waveforms (B, n_samples) -> features (B, n_mels, T) through the
    kernel; counterpart of ``logmel_standardized_pallas``."""
    spec = power_spectrogram(y, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                             power=cfg.power)
    fb = mel_ops.mel_filterbank_tensor(cfg, y.device)
    return mel_db_standardize(
        spec, fb, ref_max=cfg.ref_max, top_db=mel_ops.effective_top_db(cfg),
        standardize=cfg.per_sample_standardize,
        bands=mel_ops.filterbank_bands_tensor(cfg, y.device),
        weights=mel_ops.filterbank_weights_tensor(cfg, y.device))
