"""Plain PCA: centre the rows, the covariance's leading eigenvectors, the
projection on them (float64 where the input is)."""
from __future__ import annotations

import torch


def project(x: torch.Tensor, k: int) -> torch.Tensor:
    xc = x - x.mean(0, keepdim=True)
    _vals, vecs = torch.linalg.eigh(xc.T @ xc)
    return xc @ vecs[:, -k:].flip(1)


def gram_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a a^T - b b^T| / max |b b^T|: the projections compared up to a
    sign or rotation of the components."""
    ga, gb = a @ a.T, b @ b.T
    return float((ga - gb).abs().max() / gb.abs().max())
