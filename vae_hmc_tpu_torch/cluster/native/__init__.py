"""ctypes binding of the native ward NN-chain (``ward.cpp``), built at
first use.

``g++ -O3 -shared -fPIC -std=c++17`` compiles ``ward.cpp`` into the
git-ignored ``build/torch_kernels/libward-<source hash>.so`` beside the CUDA
kernels, never into the package.  A failed build raises with g++'s output:
there is no quiet fallback to the numpy NN-chain.  ctypes releases the GIL
during the call, so a linkage on a worker thread overlaps the caller.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from vae_hmc_tpu_torch.ops.kernels.build import gxx_library

_SRC = Path(__file__).parent / "ward.cpp"


def _bind(lib: ctypes.CDLL) -> None:
    lib.ward_nn_chain.restype = ctypes.c_int
    lib.ward_nn_chain.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_long,
        ctypes.POINTER(ctypes.c_double)]


def _get_lib() -> ctypes.CDLL:
    return gxx_library(_SRC, "ward", _bind)


def ward_nn_chain_native(d2: np.ndarray) -> np.ndarray:
    """d2: (N, N) float64 squared distances (consumed/modified).
    Returns the scipy-format (N-1, 4) linkage matrix, sorted by distance
    with relabeled cluster ids (same post-processing as the numpy path)."""
    lib = _get_lib()
    d2 = np.ascontiguousarray(d2, dtype=np.float64)
    n = d2.shape[0]
    if d2.shape != (n, n) or n < 2:
        raise ValueError(f"want an (N, N) matrix with N >= 2, got {d2.shape}")
    merges = np.zeros((n - 1, 4), dtype=np.float64)
    rc = lib.ward_nn_chain(
        d2.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        merges.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise RuntimeError(f"ward_nn_chain failed rc={rc}")
    order = np.argsort(merges[:, 2], kind="stable")
    merges = merges[order]
    old_new = {n + int(old): n + new for new, old in enumerate(order)}
    for step in range(n - 1):
        for col in (0, 1):
            v = int(merges[step, col])
            if v >= n:
                merges[step, col] = old_new[v]
    return merges
