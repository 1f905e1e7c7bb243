"""Kernel 2: tiled pairwise euclidean distances.

Port of the Pallas kernel ``pairwise_dists_pallas`` in
``vae_hmc_tpu/ops/pallas/distance_kernel.py``; the CUDA source is
``csrc/distance.cu`` (design and bound in its header).  It takes x and y
separately, so silhouette calls it with y = x and Davies-Bouldin for
point -> centroid and centroid -> centroid.  Callers centre the inputs.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vae_hmc_tpu_torch.ops.kernels import build


def pairwise_dists_plain(x: torch.Tensor,
                         y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: sqrt(max(|x|^2 + |y|^2 - 2 x y^T, 0)), with an
    exactly zero diagonal when y is x (sklearn's convention; at d = 82,688
    the f32 cancellation residue of |x|^2 + |x|^2 - 2 x.x reaches ~2 after
    the sqrt)."""
    self_dist = y is None or y is x
    y = x if y is None else y
    xn = torch.sum(x * x, dim=1)[:, None]
    yn = torch.sum(y * y, dim=1)[None, :]
    d2 = xn + yn - 2.0 * torch.matmul(x, y.T)
    d = torch.sqrt(torch.clamp(d2, min=0.0))
    if self_dist:
        d.fill_diagonal_(0.0)
    return d


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def pairwise_dists(x: torch.Tensor,
                   y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, d) x (M, d) -> (N, M) euclidean distances (y defaults to x; then
    the diagonal is exactly 0).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    self_dist = y is None or y is x
    y = x if y is None else y
    if x.device.type == "cpu":
        return pairwise_dists_plain(x, y)
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"x on {x.device}, y on {y.device}: both must be "
                         "on one CUDA device")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError("pairwise_dists takes float32 tensors")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)} / y {tuple(y.shape)}: "
                         "want (N, d) and (M, d)")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("pairwise_dists takes contiguous tensors")
    n, d = x.shape
    m = y.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n == 0 or m == 0:
        return out
    xn = torch.empty((n,), dtype=torch.float32, device=x.device)
    yn = xn if self_dist else torch.empty((m,), dtype=torch.float32,
                                          device=x.device)
    lib = build.library("distance")
    fn = lib.pairwise_dists
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), y.data_ptr(), xn.data_ptr(), yn.data_ptr(),
             out.data_ptr(), n, m, d, int(self_dist), stream)
    build.check(lib, err, "pairwise_dists")
    build.LAUNCHES["pairwise_dists"] += 1
    return out
