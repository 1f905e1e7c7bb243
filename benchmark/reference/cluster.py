"""Plain clustering numbers: squared distances to centres, k-means, the
silhouette and Davies-Bouldin scores (sklearn's definitions), ARI, NMI and
purity.

Distances are computed in the dtype of the input: the reference passes
float64, the control float32 (where products may run in TF32).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N, d) x (k, d) -> (N, k) squared euclidean distances."""
    return torch.clamp((x * x).sum(1)[:, None] + (c * c).sum(1)[None, :]
                       - 2.0 * x @ c.T, min=0.0)


def dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(sq_dists(x, y))


def assignment_excess(x: torch.Tensor, centers: torch.Tensor,
                      labels: torch.Tensor) -> float:
    """How far the given labels are from the nearest centres: max over
    rows of (d2 to the labelled centre - least d2) / mean least d2."""
    d2 = sq_dists(x, centers)
    own = d2.gather(1, labels[:, None])[:, 0]
    least = d2.min(1).values
    return float((own - least).max() / least.mean().clamp(min=1e-30))


def inertia(x: torch.Tensor, centers: torch.Tensor,
            labels: torch.Tensor) -> float:
    return float(((x - centers[labels]) ** 2).sum())


def kmeans(x: torch.Tensor, k: int, n_init: int, seed: int,
           max_iter: int = 300, tol: float = 1e-4):
    """k-means++ seeding (greedy, 2 + floor(ln k) trials), Lloyd
    iterations until the squared centre shift is <= tol x the mean feature
    variance, best of n_init by inertia.  -> (labels, centers, inertia)."""
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    n = x.shape[0]
    tol_s = tol * float(x.var(0, correction=0).mean())
    best = None
    trials = 2 + int(math.log(k))
    for _ in range(n_init):
        c = x[torch.randint(0, n, (1,), generator=gen, device=x.device)]
        d2 = sq_dists(x, c)[:, 0]
        for _j in range(1, k):
            r = torch.rand(trials, generator=gen, device=x.device) * d2.sum()
            cand = torch.searchsorted(torch.cumsum(d2, 0), r).clamp(0, n - 1)
            nd = torch.minimum(d2[:, None], sq_dists(x, x[cand]))
            pick = int(nd.sum(0).argmin())
            c = torch.cat([c, x[cand[pick]][None]])
            d2 = nd[:, pick]
        for _it in range(max_iter):
            lab = sq_dists(x, c).argmin(1)
            oh = torch.nn.functional.one_hot(lab, k).to(x.dtype)
            cnt = oh.sum(0)
            new = torch.where(cnt[:, None] > 0,
                              (oh.T @ x) / cnt.clamp(min=1)[:, None], c)
            shift = float(((new - c) ** 2).sum())
            c = new
            if shift <= tol_s:
                break
        lab = sq_dists(x, c).argmin(1)
        val = inertia(x, c, lab)
        if best is None or val < best[2]:
            best = (lab, c, val)
    return best


def silhouette(x: torch.Tensor, labels: torch.Tensor) -> float:
    """Mean silhouette of the mean-centred rows; singleton clusters score 0."""
    xc = x - x.mean(0, keepdim=True)
    d = dists(xc, xc)
    d.fill_diagonal_(0.0)
    k = int(labels.max()) + 1
    oh = torch.nn.functional.one_hot(labels, k).to(x.dtype)
    cnt = oh.sum(0)
    sums = d @ oh
    own = cnt[labels]
    a = sums.gather(1, labels[:, None])[:, 0] / (own - 1).clamp(min=1)
    mean_other = sums / cnt.clamp(min=1)[None, :]
    mean_other[torch.arange(len(labels)), labels] = math.inf
    mean_other[:, cnt == 0] = math.inf
    b = mean_other.min(1).values
    s = (b - a) / torch.maximum(a, b).clamp(min=1e-30)
    s = torch.where(own <= 1, torch.zeros_like(s), s)
    return float(s.mean())


def davies_bouldin(x: torch.Tensor, labels: torch.Tensor) -> float:
    k = int(labels.max()) + 1
    oh = torch.nn.functional.one_hot(labels, k).to(x.dtype)
    cnt = oh.sum(0).clamp(min=1)
    cen = (oh.T @ x) / cnt[:, None]
    s = (dists(x, cen) * oh).sum(0) / cnt
    m = dists(cen, cen)
    r = (s[:, None] + s[None, :]) / torch.where(m > 0, m,
                                                 torch.full_like(m, math.inf))
    r.fill_diagonal_(-math.inf)
    return float(r.max(1).values.mean())


def _contingency(a, b) -> np.ndarray:
    _, a = np.unique(np.asarray(a), return_inverse=True)
    _, b = np.unique(np.asarray(b), return_inverse=True)
    m = np.zeros((a.max() + 1, b.max() + 1), np.int64)
    np.add.at(m, (a, b), 1)
    return m


def ari(a, b) -> float:
    m = _contingency(a, b).astype(np.float64)

    def c2(v):
        return (v * (v - 1) / 2).sum()

    n = m.sum()
    sa, sb, sab = c2(m.sum(1)), c2(m.sum(0)), c2(m)
    expected = sa * sb / (n * (n - 1) / 2)
    denom = 0.5 * (sa + sb) - expected
    return 1.0 if denom == 0 else float((sab - expected) / denom)


def nmi(a, b) -> float:
    m = _contingency(a, b).astype(np.float64)
    p = m / m.sum()
    pa, pb = p.sum(1), p.sum(0)

    def h(q):
        q = q[q > 0]
        return float(-(q * np.log(q)).sum())

    nz = p > 0
    mi = float((p[nz] * np.log(p[nz] / np.outer(pa, pb)[nz])).sum())
    ha, hb = h(pa), h(pb)
    if ha == 0 and hb == 0:
        return 1.0
    return float(np.clip(mi / (0.5 * (ha + hb)), 0.0, 1.0)) if ha + hb else 0.0


def purity(pred, true) -> float:
    m = _contingency(pred, true)
    return float(m.max(1).sum() / m.sum())


def label_inertia(x: torch.Tensor, labels: torch.Tensor) -> float:
    """Sum of squared distances of the rows to their label's mean (a
    converged k-means's inertia, from its labels alone)."""
    k = int(labels.max()) + 1
    oh = torch.nn.functional.one_hot(labels, k).to(x.dtype)
    cen = (oh.T @ x) / oh.sum(0).clamp(min=1)[:, None]
    return inertia(x, cen, labels)


def inertia_excess(x: torch.Tensor, labels: torch.Tensor, k: int,
                   n_init: int, seed: int) -> float:
    """How far the labels' inertia lies above that of this module's k-means
    with the same k and restarts: max(0, ratio - 1)."""
    _lab, _c, best = kmeans(x, k, n_init, seed)
    return max(0.0, label_inertia(x, labels) / max(best, 1e-300) - 1.0)


def knn_recall(x: torch.Tensor, y: torch.Tensor, k: int) -> float:
    """Mean share of each row's k nearest neighbours in `x` that are also
    among its k nearest in `y` (the row itself left out)."""
    def knn(a):
        d = sq_dists(a, a)
        d.fill_diagonal_(math.inf)
        return d.topk(k, dim=1, largest=False).indices

    nx, ny = knn(x), knn(y)
    hit = (nx[:, :, None] == ny[:, None, :]).any(2)
    return float(hit.double().mean())
