"""Kernel 2: tiled pairwise euclidean distances.

Port of the Pallas kernel ``pairwise_dists_pallas`` in
``vae_hmc_tpu/ops/pallas/distance_kernel.py``; the CUDA source is
``csrc/distance.cu``.  One launch computes the row norms and the products
of a 64x64 tile (8x8 outputs a thread) from a cp.async ring; for y = x only
the tiles i <= j run and write both halves.  When the tiles cannot fill the card (the mel-flat
width, d = 82,688, at a few hundred rows) the wrapper splits d
(``split_k_bounds``) and a second launch sums the slices in a fixed order.
It takes x and y separately, so silhouette calls it with y = x and
Davies-Bouldin for point -> centroid and centroid -> centroid.  Callers
centre the inputs.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from vae_hmc_tpu_torch.ops.kernels import build

TILE = 64                # output tile edge (BT in csrc/distance.cu)
CHUNK = 32               # columns per ring stage (BK): slice widths align to it
SPLIT_MIN_COLS = 1024    # no slice narrower than this (about)
H100_SMS = 132
BLOCKS_PER_SM = 2        # tile blocks resident on an H100 SM (registers)


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


def n_tiles(n: int, m: int, self_dist: bool) -> int:
    """Output tiles the kernel runs: i <= j only when y is x."""
    nbi, nbj = -(-n // TILE), -(-m // TILE)
    return nbi * (nbi + 1) // 2 if self_dist else nbi * nbj


def split_k_bounds(tiles: int, d: int, sms: int = H100_SMS,
                   blocks_per_sm: int = BLOCKS_PER_SM) -> List[Tuple[int, int]]:
    """The d-slices [k0, k1) of one call.  One slice unless the tiles are
    well under the SM count (2 tiles <= sms); then as many slices as
    tiles x slices fit in one round of resident blocks (blocks_per_sm x
    sms: a block more would start a second round), each SPLIT_MIN_COLS
    columns or more, all but the last CHUNK-aligned.  The slices cover
    [0, d) exactly and none is empty."""
    slices = 1
    if 2 * tiles <= sms and d >= 2 * SPLIT_MIN_COLS:
        slices = max(1, min(blocks_per_sm * sms // tiles,
                            d // SPLIT_MIN_COLS))
    width = -(-d // slices)
    width = -(-width // CHUNK) * CHUNK
    slices = -(-d // width) if d else 1
    return [(s * width, min(d, (s + 1) * width)) for s in range(slices)]


_OCCUPANCY: Dict[int, Tuple[int, int]] = {}   # device -> (sms, blocks per SM)


def occupancy(device: torch.device) -> Tuple[int, int]:
    """(SMs, tile blocks resident on one SM) of a CUDA device: one round of
    the tile kernel, which ``split_k_bounds`` fills."""
    device = torch.device(device)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _OCCUPANCY:
        lib = build.library("distance")
        blocks = ctypes.c_int(0)
        fn = lib.pairwise_blocks_per_sm
        fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
        build.check(lib, fn(ctypes.byref(blocks)), "pairwise_blocks_per_sm")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _OCCUPANCY[index] = (sms, blocks.value)
    return _OCCUPANCY[index]


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def pairwise_dists(x: torch.Tensor,
                   y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, d) x (M, d) -> (N, M) euclidean distances (y defaults to x; then
    the output is exactly symmetric with an exactly zero diagonal).

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
    lib = build.library("distance")
    tiles = n_tiles(n, m, self_dist)
    bounds = split_k_bounds(tiles, d, *occupancy(x.device))
    ws = None
    if len(bounds) > 1:
        ws = torch.empty((len(bounds), tiles, TILE * TILE + 2 * TILE),
                         dtype=torch.float32, device=x.device)
    fn = lib.pairwise_dists
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(), n, m, d, int(self_dist),
             len(bounds), bounds[0][1] - bounds[0][0], stream)
    build.check(lib, err, "pairwise_dists")
    build.LAUNCHES["pairwise_dists"] += 1
    return out
