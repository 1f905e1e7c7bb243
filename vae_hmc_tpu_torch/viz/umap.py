"""First-party UMAP on the device (port of ``vae_hmc_tpu.viz.umap``).

The reference treats umap-learn as an optional host dependency and falls
back to t-SNE without it (scripts 08:14-18, 14:13-25, 21:13-17).  This is
the whole UMAP pipeline (McInnes, Healy & Melville 2018) in torch ops:

  1. exact kNN from an (N, N) distance matrix (kernel 2 for ``umap_2d``
     from features; the medium tier passes each representation's cached
     kernel 2 matrix) with the diagonal at +inf, then ``topk``;
  2. fuzzy simplicial set: rho = nearest-neighbour distance, sigma
     binary-searched so sum_j exp(-(d_ij - rho_i)+ / sigma_i) = log2(k),
     symmetrized by the fuzzy union W + W^T - W * W^T, computed edge-wise
     on the (i, knn(i)) pairs (``_edge_weights``); the dense W exists only
     for the small-graph API (``fuzzy_simplicial_set``);
  3. spectral initialization: the leading nontrivial eigenvectors of the
     normalized graph Laplacian by deflated subspace iteration whose matvec
     is a gather and an ``index_add_`` over the edge list;
  4. SGD with negative sampling: per-epoch vectorized pass over all edges
     with umap-learn's epochs-per-sample schedule, attraction on both
     endpoints, ``negative_sample_rate`` uniform negatives repelling the
     head, gradient clipping at +-4, linearly decaying learning rate.

Randomness: the spectral start block is drawn from a generator seeded 0
(the JAX package's fixed key); the init jitter and every epoch's negatives
come from one generator seeded by ``seed``.  ``index_add_`` on CUDA adds in
the order its atomics land, so two runs on the card differ in the last
bits; the embedding is held to quality bands (trustworthiness, cluster
recovery), not to bits.  Deviations from umap-learn, as in the JAX
package: updates within an epoch are summed, not applied in sequence, and
the negatives read the epoch's starting positions.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from vae_hmc_tpu_torch.core.device import as_rows
from vae_hmc_tpu_torch.metrics.internal import center
from vae_hmc_tpu_torch.ops.kernels.distance import pairwise_dists
from vae_hmc_tpu_torch.ops.subspace import _iterate, deflation, start_block


def find_ab_params(spread: float = 1.0, min_dist: float = 0.1):
    """Least-squares fit of 1/(1 + a d^{2b}) to the fuzzy membership target
    curve (umap-learn's find_ab_params, Gauss-Newton instead of scipy)."""
    d = np.linspace(0.0, spread * 3.0, 300, dtype=np.float64)
    target = np.where(d <= min_dist, 1.0,
                      np.exp(-(d - min_dist) / spread))
    a, b = 1.5, 1.0
    for _ in range(200):
        da = d ** (2.0 * b)
        f = 1.0 / (1.0 + a * da)
        r = f - target
        # jacobian of f wrt (a, b)
        denom2 = (1.0 + a * da) ** 2
        with np.errstate(divide="ignore", invalid="ignore"):
            dfda = -da / denom2
            dfdb = np.where(d > 0, -2.0 * a * da * np.log(d ** 2) / denom2,
                            0.0)
        J = np.stack([dfda, dfdb], axis=1)
        g = J.T @ r
        H = J.T @ J + 1e-8 * np.eye(2)
        step = np.linalg.solve(H, g)
        a, b = a - step[0], b - step[1]
    return float(a), float(b)


def _knn_from_dists(d: torch.Tensor, k: int):
    """(N, N) distances -> (knn_d (N, k) ascending, knn_i (N, k) int64),
    self excluded."""
    eye = torch.eye(d.shape[0], dtype=torch.bool, device=d.device)
    return torch.topk(torch.where(eye, torch.inf, d), k, dim=1, largest=False)


def _knn(x: torch.Tensor, k: int):
    """kNN of the rows of x from kernel 2's distances of the centred rows."""
    return _knn_from_dists(pairwise_dists(center(x, x.device)), k)


def _smooth_knn(knn_d: torch.Tensor, n_iter: int = 64):
    """Per-point (rho, sigma): umap-learn's smooth_knn_dist binary search."""
    n, k = knn_d.shape
    dev = knn_d.device
    target = float(np.log2(k))
    rho = knn_d[:, 0]
    adj = torch.clamp(knn_d - rho[:, None], min=0.0)
    lo = torch.zeros(n, device=dev)
    hi = torch.full((n,), torch.inf, device=dev)
    mid = torch.ones(n, device=dev)
    for _ in range(n_iter):
        val = torch.sum(torch.exp(-adj / mid[:, None]), dim=1)
        too_high = val > target
        hi = torch.where(too_high, mid, hi)
        lo = torch.where(too_high, lo, mid)
        mid = torch.where(too_high, (lo + hi) / 2.0,
                          torch.where(torch.isinf(hi), mid * 2.0,
                                      (lo + hi) / 2.0))
    # umap floors sigma at MIN_K_DIST_SCALE * mean distance
    sigma = torch.maximum(mid, 1e-3 * torch.mean(knn_d))
    return rho, sigma


def _memberships(knn_d, rho, sigma) -> torch.Tensor:
    return torch.exp(-torch.clamp(knn_d - rho[:, None], min=0.0)
                     / sigma[:, None])


def fuzzy_simplicial_set(x, n_neighbors: int, device="cuda") -> torch.Tensor:
    """(N, d) -> dense (N, N) symmetrized membership matrix W."""
    knn_d, knn_i = _knn(as_rows(x, device), n_neighbors)
    rho, sigma = _smooth_knn(knn_d)
    return _build_w(knn_d, knn_i, rho, sigma)


def _build_w(knn_d, knn_i, rho, sigma) -> torch.Tensor:
    n, k = knn_d.shape
    rows = torch.arange(n, device=knn_d.device).repeat_interleave(k)
    W = torch.zeros((n, n), dtype=torch.float32, device=knn_d.device)
    W[rows, knn_i.reshape(-1)] = _memberships(knn_d, rho, sigma).reshape(-1)
    return W + W.T - W * W.T          # fuzzy union


def _edge_list(Wsym: torch.Tensor, knn_i: torch.Tensor):
    """Fixed-shape directed edge list covering every nonzero of Wsym:
    the (i, knn(i)) pairs, then their reverses, with the reverse copy of a
    mutual-kNN pair weight-zeroed so each directed edge counts once."""
    n, k = knn_i.shape
    rows = torch.arange(n, device=knn_i.device).repeat_interleave(k)
    cols = knn_i.reshape(-1)
    w_dir = Wsym[rows, cols]
    back = knn_i[knn_i]                                   # (N, k, k)
    mutual = torch.any(back == torch.arange(n, device=knn_i.device)[:, None,
                                                                    None],
                       dim=-1).reshape(-1)
    w_rev = torch.where(mutual, 0.0, w_dir)
    return (torch.cat([rows, cols]), torch.cat([cols, rows]),
            torch.cat([w_dir, w_rev]))


def _edge_weights(knn_d, knn_i, rho, sigma):
    """The fuzzy-union edge list straight from the kNN arrays, with no
    dense (N, N) matrix; the same layout and weights as
    ``_edge_list(_build_w(...))``:
      W[i,c] = w[i,j];  W[c,i] = w[c,j'] where knn(c)[j'] == i, else 0;
      W_sym  = W[i,c] + W[c,i] - W[i,c] W[c,i]."""
    n, k = knn_i.shape
    w = _memberships(knn_d, rho, sigma)
    rows = torch.arange(n, device=knn_i.device).repeat_interleave(k)
    cols = knn_i.reshape(-1)                  # (N*k,)
    w_ic = w.reshape(-1)
    hit = knn_i[cols] == rows[:, None]        # (N*k, k)
    w_ci = torch.sum(torch.where(hit, w[cols], 0.0), dim=1)
    mutual = torch.any(hit, dim=1)
    w_dir = w_ic + w_ci - w_ic * w_ci         # fuzzy union, = W_sym[i, c]
    w_rev = torch.where(mutual, 0.0, w_dir)
    return (torch.cat([rows, cols]), torch.cat([cols, rows]),
            torch.cat([w_dir, w_rev]))


def _eps_per_sample(weights: torch.Tensor, n_epochs: int) -> torch.Tensor:
    """umap make_epochs_per_sample: edges too weak to be sampled even once
    (w < w_max / n_epochs, the zero-weight reverse copies included) get
    +inf and never fire."""
    w_max = torch.max(weights)
    return torch.where(weights >= w_max / n_epochs,
                       w_max / torch.clamp(weights, min=1e-30), torch.inf)


def _scale_box(y0: torch.Tensor) -> torch.Tensor:
    """Scale to the +-10 box umap-learn uses."""
    return y0 * (10.0 / torch.clamp(torch.max(torch.abs(y0)), min=1e-8))


def _spectral_init_sparse(heads, tails, weights, n: int, n_iter: int = 150,
                          oversample: int = 8, q0=None) -> torch.Tensor:
    """Deflated top-2 eigenvectors of 2I - L = I + D^{-1/2} W D^{-1/2},
    whose matvec is a gather and an index_add_ over the edge list (the
    trivial eigenvector D^{1/2} 1 is projected out each step).  The start
    block is drawn from a generator seeded 0 unless `q0` is given."""
    dev = weights.device
    deg = torch.clamp(torch.zeros(n, device=dev).index_add_(0, heads, weights),
                      min=1e-8)
    inv_sqrt = 1.0 / torch.sqrt(deg)
    wcol = weights[:, None]

    def matvec(v):                            # (I + S) v, S = D^-1/2 W D^-1/2
        u = inv_sqrt[:, None] * v
        s = torch.zeros_like(v).index_add_(0, heads, wcol * u[tails])
        return v + inv_sqrt[:, None] * s

    m = min(n - 1, 2 + oversample)
    q = start_block(n, m, 0, dev) if q0 is None else q0.to(weights)
    _, y0 = _iterate(matvec, deflation(torch.sqrt(deg)), q, 2, n_iter)
    return _scale_box(y0)


def _spectral_init(W: torch.Tensor) -> torch.Tensor:
    """Dense-W spectral init (the small-graph API): the two leading
    nontrivial eigenvectors of the normalized Laplacian, from the exact
    ``torch.linalg.eigh`` at every size.  The JAX package switches to
    deflated subspace iteration above 512 nodes only because XLA's TPU
    lowering of ``eigh`` compiles to executables that grow with the
    operand; nothing here compiles per shape (as ``ops.pca``)."""
    n = W.shape[0]
    d = torch.clamp(torch.sum(W, dim=1), min=1e-8)
    inv_sqrt = 1.0 / torch.sqrt(d)
    S = inv_sqrt[:, None] * W * inv_sqrt[None, :]
    _, vecs = torch.linalg.eigh(torch.eye(n, device=W.device) - S)
    return _scale_box(vecs[:, 1:3])


def _optimize(y0, heads, tails, eps_per_sample, gen: torch.Generator, a: float,
              b: float, n_epochs: int, neg_rate: int,
              lr: float) -> torch.Tensor:
    """Epoch-batched negative-sampling SGD.

    Layout (from ``_edge_weights``/``_edge_list``): heads = [rows; cols],
    tails = [cols; rows] with rows = repeat(arange(N), k), so the first E/2
    edges are grouped by head: the row-indexed updates are a reshape-sum and
    the column-indexed ones one ``index_add_``."""
    n = y0.shape[0]
    e = heads.shape[0]
    e2 = e // 2
    k = e2 // n
    if e2 * 2 != e or k * n != e2:
        raise ValueError("heads/tails must be the [direct; reverse] kNN-edge "
                         "layout")
    cols = tails[:e2]                       # == heads[e2:]
    y = y0.clone()
    eons = eps_per_sample.clone()
    for epoch in range(n_epochs):
        alpha = lr * (1.0 - epoch / n_epochs)
        active = (eons <= epoch)[:, None]
        yh = y[heads]
        diff = yh - y[tails]
        d2 = torch.sum(diff * diff, dim=1)
        # attraction: both endpoints move (umap move_other=True)
        coeff = torch.where(d2 > 0.0, (-2.0 * a * b * d2 ** (b - 1.0))
                            / (a * d2 ** b + 1.0), 0.0)
        g = torch.where(active, torch.clamp(coeff[:, None] * diff, -4.0, 4.0),
                        0.0)
        # negatives: neg_rate uniform points repel each active head
        negs = torch.randint(0, n, (e, neg_rate), generator=gen,
                             device=y.device)
        diff_n = yh[:, None, :] - y[negs]                      # (E, R, 2)
        d2n = torch.sum(diff_n * diff_n, dim=2)
        coeff_n = (2.0 * b) / ((0.001 + d2n) * (a * d2n ** b + 1.0))
        gn = torch.clamp(coeff_n[..., None] * diff_n, -4.0, 4.0)
        gn = torch.where(d2n[..., None] > 0.0, gn, 4.0)   # umap: stuck pairs
        gn_sum = torch.where(active, torch.sum(gn, dim=1), 0.0)
        u = alpha * (g + gn_sum)            # total update at heads
        v = -alpha * g                      # total update at tails
        y = y + (u[:e2] + v[e2:]).reshape(n, k, 2).sum(dim=1)
        y = y.index_add(0, cols, u[e2:] + v[:e2])
        eons = torch.where(active[:, 0], eons + eps_per_sample, eons)
    return y


def _umap_params(n: int, n_neighbors: int, n_epochs: int):
    n_neighbors = min(n_neighbors, n - 1)
    if n_epochs <= 0:
        n_epochs = 500 if n <= 10000 else 200    # umap-learn default
    return n_neighbors, int(n_epochs)


def _umap_chain(d: torch.Tensor, seed: int, a: float, b: float,
                n_neighbors: int, n_epochs: int, neg_rate: int,
                lr: float) -> torch.Tensor:
    """UMAP from an (N, N) euclidean distance matrix: kNN -> (rho, sigma)
    -> edge-wise fuzzy union -> epoch schedule -> sparse spectral init ->
    jitter -> negative-sampling SGD."""
    n = d.shape[0]
    knn_d, knn_i = _knn_from_dists(d, n_neighbors)
    rho, sigma = _smooth_knn(knn_d)
    heads, tails, weights = _edge_weights(knn_d, knn_i, rho, sigma)
    eps_per_sample = _eps_per_sample(weights, n_epochs)
    y0 = _spectral_init_sparse(heads, tails, weights, n)
    gen = torch.Generator(device=d.device)
    gen.manual_seed(seed)
    # small init jitter (umap adds 1e-4-scale noise to the spectral init)
    y0 = y0 + 1e-4 * torch.randn(y0.shape, generator=gen, device=d.device)
    return _optimize(y0, heads, tails, eps_per_sample, gen, a, b,
                     n_epochs=n_epochs, neg_rate=neg_rate, lr=lr)


def umap_2d_from_dists(d, n_neighbors: int = 15, min_dist: float = 0.1,
                       n_epochs: int = 0, negative_sample_rate: int = 5,
                       learning_rate: float = 1.0, seed: int = 42,
                       device="cuda") -> np.ndarray:
    """(N, N) euclidean distances -> (N, 2) host embedding.  Distances may
    come from any source (the medium tier passes each representation's
    cached kernel 2 matrix); a tensor stays on its own device."""
    d = as_rows(d, device)
    n_neighbors, n_epochs = _umap_params(int(d.shape[0]), n_neighbors,
                                         n_epochs)
    a, b = find_ab_params(1.0, min_dist)
    return _umap_chain(d, seed, a, b, n_neighbors, n_epochs,
                       int(negative_sample_rate),
                       float(learning_rate)).cpu().numpy()


def umap_2d(x, n_neighbors: int = 15, min_dist: float = 0.1,
            n_epochs: int = 0, negative_sample_rate: int = 5,
            learning_rate: float = 1.0, seed: int = 42,
            device="cuda") -> np.ndarray:
    """(N, d) -> (N, 2) host embedding; the distances are kernel 2's of the
    centred rows."""
    x = as_rows(x, device)
    return umap_2d_from_dists(pairwise_dists(center(x, x.device)), n_neighbors,
                              min_dist, n_epochs, negative_sample_rate,
                              learning_rate, seed)


def umap_2d_from_dists_batch(ds: Sequence, n_neighbors: int = 15,
                             min_dist: float = 0.1, n_epochs: int = 0,
                             negative_sample_rate: int = 5,
                             learning_rate: float = 1.0, seed: int = 42,
                             device="cuda") -> np.ndarray:
    """(B, N, N) distance matrices (a sequence or one tensor) -> (B, N, 2):
    one ``umap_2d_from_dists`` call each, all with the same seed."""
    out: List[np.ndarray] = [
        umap_2d_from_dists(d, n_neighbors, min_dist, n_epochs,
                           negative_sample_rate, learning_rate, seed, device)
        for d in ds]
    return np.stack(out)
