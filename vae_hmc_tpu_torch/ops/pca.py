"""PCA with sklearn.decomposition.PCA semantics (port of
``vae_hmc_tpu.ops.pca``).

Used by script 13's optional ``pca_dim`` reduction, script 15's PCA
panels, the pre-projection before UMAP/t-SNE (reference 14:196-199) and
t-SNE's PCA init (08:120).  sklearn's details: column centring, components
from the smaller side of the centred matrix (the (n, n) Gram matrix when
n <= d, the (d, d) scatter matrix otherwise), Vt-based ``svd_flip`` (the
largest-|loading| entry of each component is made positive, sklearn >= 1.5)
and explained variance with ddof = 1.

The small side is factored with the exact ``torch.linalg.eigh`` at every
size.  The JAX package switches to subspace iteration above a side of 512
(``_EXACT_EIGH_MAX``) only because XLA's TPU lowering of ``eigh`` compiles
to executables that grow with the operand; nothing here compiles per
shape.  The Gram or scatter product is a plain fp32 matmul (TF32 off,
``core.device``).  Fitted attributes are tensors on the input's device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from vae_hmc_tpu_torch.core.device import as_rows


def _fit(x: torch.Tensor, k: int):
    """-> (mean (d,), components (k, d), variance (k,), variance ratio (k,))."""
    n, d = x.shape
    mean = torch.mean(x, dim=0)
    xc = x - mean
    if n <= d:                      # Gram side: xc = U S Vt, xc xc^T = U S^2 U^T
        vals, u = torch.linalg.eigh(xc @ xc.T)               # ascending
        vals, u = torch.flip(vals, (0,))[:k], torch.flip(u, (1,))[:, :k]
        s = torch.sqrt(torch.clamp(vals, min=0.0))
        vt = (u.T @ xc) / torch.clamp(s, min=1e-12)[:, None]
    else:                           # scatter side: xc^T xc = V S^2 V^T
        vals, v = torch.linalg.eigh(xc.T @ xc)
        vals, v = torch.flip(vals, (0,))[:k], torch.flip(v, (1,))[:, :k]
        s = torch.sqrt(torch.clamp(vals, min=0.0))
        vt = v.T
    # svd_flip, Vt-based: the max-|loading| entry of each row is positive
    max_idx = torch.argmax(torch.abs(vt), dim=1)
    signs = torch.sign(vt[torch.arange(vt.shape[0], device=vt.device), max_idx])
    vt = vt * signs[:, None]
    var = s ** 2 / (n - 1)
    total_var = torch.sum(torch.var(xc, dim=0, correction=1))
    return mean, vt.contiguous(), var, var / total_var


@dataclass
class PCA:
    n_components: int
    # allow_cap=True fits min(n_components, n, d) components; by default an
    # oversize n_components raises, as sklearn does
    allow_cap: bool = False
    device: str = "cuda"          # for numpy inputs; tensors keep theirs
    mean_: Optional[torch.Tensor] = None
    components_: Optional[torch.Tensor] = None                  # (k, d)
    explained_variance_: Optional[torch.Tensor] = None
    explained_variance_ratio_: Optional[torch.Tensor] = None
    n_components_: Optional[int] = None      # the k fitted, after capping

    def fit(self, x) -> "PCA":
        x = as_rows(x, self.device)
        n, d = x.shape
        kk = min(self.n_components, n, d)
        if kk < self.n_components and not self.allow_cap:
            raise ValueError(
                f"n_components={self.n_components} must be <= "
                f"min(n_samples, n_features)={kk} "
                "(sklearn parity; pass allow_cap=True to fit the capped "
                "component count instead)")
        self.n_components_ = kk
        (self.mean_, self.components_, self.explained_variance_,
         self.explained_variance_ratio_) = _fit(x, kk)
        return self

    def transform(self, x) -> torch.Tensor:
        x = as_rows(x, self.device).to(self.mean_.device)
        return (x - self.mean_) @ self.components_.T

    def fit_transform(self, x) -> torch.Tensor:
        x = as_rows(x, self.device)
        return self.fit(x).transform(x)
