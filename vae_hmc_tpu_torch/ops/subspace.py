"""Top-k symmetric eigensolver by block subspace iteration (port of
``vae_hmc_tpu.ops.subspace``).

The JAX package iterates instead of calling a dense ``eigh`` because XLA's
TPU lowering of ``eigh`` unrolls its sweeps into executables that grow
with the operand.  Nothing here compiles per shape, so ``ops.pca`` and
the dense UMAP init (``viz.umap._spectral_init``) call
``torch.linalg.eigh`` at every size.  What iterates here is the sparse
UMAP init (``viz.umap._spectral_init_sparse``), whose operator is an edge
list, not a matrix: it runs ``_iterate``.  ``topk_eigh`` and
``topk_eigh_deflated`` are the JAX package's dense-matrix entry points,
kept with it for parity.

Each step is one (n, n) x (n, m) product and a Löwdin orthonormalization
(an (m, m) ``eigh``), then a Rayleigh-Ritz ``eigh`` of the converged block.
The start block is a standard normal (n, m) draw from a generator seeded
by ``seed``; tests pass ``q0`` to start from the JAX package's block.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def start_block(n: int, m: int, seed: int, device) -> torch.Tensor:
    """Standard normal (n, m) float32 start block from its own generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn((n, m), generator=gen, device=device,
                       dtype=torch.float32)


def _loewdin(z: torch.Tensor) -> torch.Tensor:
    """Symmetric (Löwdin) orthonormalization of the (n, m) block.

    The eigenvalue floor is relative to the largest: once the block
    converges, its Gram matrix is rank-deficient at f32 and the trailing
    eigenvalues come out slightly negative (~eps * w_max); an absolute floor
    would turn them into 1/sqrt(tiny) blowups."""
    w, v = torch.linalg.eigh(z.T @ z)                 # ascending
    floor = torch.clamp(w[-1], min=1e-30) * 1e-6
    inv_sqrt = (v / torch.sqrt(torch.maximum(w, floor))[None, :]) @ v.T
    return z @ inv_sqrt


def _iterate(matvec: Callable[[torch.Tensor], torch.Tensor],
             project: Callable[[torch.Tensor], torch.Tensor],
             q: torch.Tensor, k: int, n_iter: int):
    """Subspace iteration from start block q, then Rayleigh-Ritz:
    -> (vals (k,) descending, vecs (n, k))."""
    q = _loewdin(project(q))
    for _ in range(n_iter):
        q = _loewdin(project(matvec(q)))
    w, v = torch.linalg.eigh(q.T @ matvec(q))         # ascending
    w, v = torch.flip(w, (0,))[:k], torch.flip(v, (1,))[:, :k]
    return w, q @ v


def topk_eigh(a: torch.Tensor, k: int, n_iter: int = 150,
              oversample: int = 8, seed: int = 0,
              q0: Optional[torch.Tensor] = None):
    """Top-k eigenpairs (descending) of a symmetric PSD (n, n) matrix:
    -> (vals (k,), vecs (n, k)); eigenvector signs are arbitrary."""
    n = a.shape[0]
    m = min(n, k + oversample)
    q = start_block(n, m, seed, a.device) if q0 is None else q0.to(a)
    return _iterate(lambda z: a @ z, lambda z: z, q, k, n_iter)


def deflation(u0: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """z -> z with the unit direction of u0 (n,) projected out."""
    u0 = u0 / torch.clamp(torch.linalg.vector_norm(u0), min=1e-30)
    return lambda z: z - torch.outer(u0, u0 @ z)


def topk_eigh_deflated(a: torch.Tensor, u0: torch.Tensor, k: int,
                       n_iter: int = 150, oversample: int = 8, seed: int = 0,
                       q0: Optional[torch.Tensor] = None):
    """Top-k eigenpairs of symmetric PSD ``a`` on the complement of its
    known eigenvector ``u0`` (projected out of the iterate every step)."""
    n = a.shape[0]
    m = min(n - 1, k + oversample)
    q = start_block(n, m, seed, a.device) if q0 is None else q0.to(a)
    return _iterate(lambda z: a @ z, deflation(u0), q, k, n_iter)
