"""Exact t-SNE on the device (port of ``vae_hmc_tpu.viz.tsne``).

The reference runs sklearn's Barnes-Hut t-SNE on the host (scripts
08:118-120: perplexity 30, lr 200, 1500 iterations, init='pca').  At
N ~ 3k the exact O(N^2) method is dense (N, N) work for the device:
binary-searched per-point precisions to hit the perplexity, symmetrized P,
early exaggeration x12 for the first 250 iterations, momentum 0.5 -> 0.8
and adaptive gains, as in sklearn's schedule.  The input's squared
distances come from kernel 2 (``ops.kernels.distance``) on the centred
rows; the optimizer's (N, 2) distances are plain torch ops (no contraction
worth a kernel at d = 2).  The loops branch only on Python integers, so
they queue their launches without waiting on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from vae_hmc_tpu_torch.core.config import TsneConfig
from vae_hmc_tpu_torch.core.device import as_rows
from vae_hmc_tpu_torch.metrics.internal import center
from vae_hmc_tpu_torch.ops.kernels.distance import pairwise_dists
from vae_hmc_tpu_torch.ops.pca import PCA

_EPS = 1e-12


def input_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """(N, d) -> (N, N) squared euclidean distances: kernel 2 on the
    centred rows, squared."""
    d = pairwise_dists(center(x, x.device))
    return d * d


def _binary_search_perplexity(d2: torch.Tensor, perplexity: float,
                              n_steps: int = 50) -> torch.Tensor:
    """Conditional P: per-row precision beta such that the entropy of the
    row's softmax(-d2 beta) is log(perplexity)."""
    n = d2.shape[0]
    dev = d2.device
    target = float(np.log(perplexity))
    eye = torch.eye(n, dtype=torch.bool, device=dev)

    def entropy_and_p(beta):
        logits = torch.where(eye, -torch.inf, -d2 * beta[:, None])
        p = torch.softmax(logits, dim=1)
        h = -torch.sum(torch.where(p > 0, p * torch.log(p + _EPS), 0.0), dim=1)
        return h, p

    beta = torch.ones(n, device=dev)
    lo = torch.zeros(n, device=dev)
    hi = torch.full((n,), torch.inf, device=dev)
    for _ in range(n_steps):
        h, _ = entropy_and_p(beta)
        too_high = h > target          # entropy too high -> increase beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0,
                           torch.where(torch.isinf(lo), beta / 2.0,
                                       0.5 * (lo + hi)))
    return entropy_and_p(beta)[1]


def _tsne_optimize(p_cond: torch.Tensor, y0: torch.Tensor,
                   learning_rate: float, n_iter: int, early_iter: int = 250,
                   early_exaggeration: float = 12.0) -> torch.Tensor:
    n = p_cond.shape[0]
    p = torch.clamp((p_cond + p_cond.T) / (2.0 * n), min=_EPS)
    p_early = p * early_exaggeration
    eye = torch.eye(n, dtype=torch.bool, device=p.device)

    def grad(y, pmat):
        sq = torch.sum(y * y, dim=1)
        d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (y @ y.T), min=0.0)
        num = torch.where(eye, 0.0, 1.0 / (1.0 + d2))
        q = torch.clamp(num / torch.sum(num), min=_EPS)
        pq = (pmat - q) * num                                   # (N, N)
        # 4 (diag(rowsum(pq)) - pq) y, without forming the diagonal matrix
        return 4.0 * (torch.sum(pq, dim=1)[:, None] * y - pq @ y)

    y = y0.clone()
    vel = torch.zeros_like(y0)
    gains = torch.ones_like(y0)
    for i in range(n_iter):
        early = i < early_iter
        g = grad(y, p_early if early else p)
        same_sign = torch.sign(g) == torch.sign(vel)
        gains = torch.clamp(torch.where(same_sign, gains * 0.8, gains + 0.2),
                            min=0.01)
        vel = (0.5 if early else 0.8) * vel - learning_rate * gains * g
        y = y + vel
        y = y - torch.mean(y, dim=0, keepdim=True)
    return y


def pca_init(x: torch.Tensor) -> torch.Tensor:
    """sklearn's init='pca': PCA(2) scaled so column 0 has std 1e-4."""
    y0 = PCA(2).fit_transform(x)
    return y0 / (torch.std(y0[:, 0], correction=0) + 1e-12) * 1e-4


def tsne(x, cfg: TsneConfig = TsneConfig(), device="cuda") -> np.ndarray:
    """(N, d) numpy or tensor -> (N, 2) embedding (host numpy).  A tensor
    stays on its own device."""
    x = as_rows(x, device)
    n = int(x.shape[0])
    perplexity = min(cfg.perplexity, max(2.0, (n - 1) / 3.0))
    p_cond = _binary_search_perplexity(input_sq_dists(x), perplexity)
    if cfg.init == "pca" and x.shape[1] >= 2:
        y0 = pca_init(x)
    else:
        rng = np.random.default_rng(cfg.seed)
        y0 = torch.as_tensor(rng.standard_normal((n, 2)) * 1e-4,
                             dtype=torch.float32, device=x.device)
    return _tsne_optimize(p_cond, y0, cfg.learning_rate,
                          cfg.n_iter).cpu().numpy()
