"""The port's PCA and subspace eigensolver against the JAX package and
sklearn.

  - PCA: components, transform and explained-variance ratio within atol
    1e-4 of the JAX package's and of sklearn's, at a wide shape (Gram
    side), two thin ones (scatter side) and one where the JAX package
    leaves its exact eigh for subspace iteration (min(n, d) > 512); the
    port factors with the exact eigh at every size;
  - an oversize n_components raises; allow_cap caps;
  - topk_eigh and topk_eigh_deflated from the JAX package's start block
    on a (64, 64) PSD matrix: eigenvalues within rtol 1e-4, vectors up to
    sign within atol 1e-3;
  - script 13's _build_rep with pca_dim=8 against the JAX package's.
Inputs are low-rank signal plus noise (numpy, from a seed), so the
compared components have well separated eigenvalues.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_sweep_data as sweep_data
from vae_hmc_tpu.ops import pca as jpca
from vae_hmc_tpu.ops import subspace as jsub
from vae_hmc_tpu.pipelines import medium as jmedium
from vae_hmc_tpu_torch.ops import subspace
from vae_hmc_tpu_torch.ops.pca import PCA
from vae_hmc_tpu_torch.pipelines import medium

torch.manual_seed(0)
torch.set_num_threads(1)


def _low_rank(n, d, seed, rank=6):
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.normal(0, 1, (n, rank)))[0]
    v = np.linalg.qr(rng.normal(0, 1, (d, rank)))[0]
    # transforms of order 1, so atol 1e-4 is a relative bound there too
    s = np.sqrt(n) * np.array([0.5, 0.4, 0.3, 0.22, 0.16, 0.12])[:rank]
    x = (u * s) @ v.T + 0.005 * rng.normal(0, 1, (n, d)) + rng.normal(0, 1, d)
    return x.astype(np.float32)


def _sign_align(a, b):
    """Flip the rows of a to b's signs (for solvers with no sign rule)."""
    return a * np.sign(np.sum(a * b, axis=1, keepdims=True))


@pytest.mark.parametrize("shape,k", [((40, 300), 5), ((300, 24), 5),
                                     ((600, 40), 5), ((600, 520), 4)])
def test_pca_matches_jax_and_sklearn(shape, k):
    from sklearn.decomposition import PCA as SkPCA
    n, d = shape
    x = _low_rank(n, d, seed=n + d)
    ours = PCA(k, device="cpu").fit(x)
    y = ours.transform(x).numpy()
    ref = jpca.PCA(k).fit(x)         # subspace iteration at (600, 520)
    sk = SkPCA(k, svd_solver="full").fit(x)
    for want_c, want_y, want_r in (
            (np.asarray(ref.components_), np.asarray(ref.transform(x)),
             np.asarray(ref.explained_variance_ratio_)),
            (sk.components_, sk.transform(x), sk.explained_variance_ratio_)):
        np.testing.assert_allclose(ours.components_.numpy(), want_c, atol=1e-4)
        np.testing.assert_allclose(y, want_y, atol=1e-4)
        np.testing.assert_allclose(ours.explained_variance_ratio_.numpy(),
                                   want_r, atol=1e-4)
    np.testing.assert_allclose(ours.explained_variance_.numpy(),
                               sk.explained_variance_, rtol=1e-4)
    np.testing.assert_allclose(ours.mean_.numpy(), sk.mean_, atol=1e-5)
    np.testing.assert_allclose(PCA(k, device="cpu").fit_transform(
        torch.from_numpy(x)).numpy(), y, atol=1e-5)


def test_pca_oversize_raises_and_allow_cap_caps():
    x = _low_rank(10, 30, seed=1)
    with pytest.raises(ValueError, match="allow_cap"):
        PCA(12, device="cpu").fit(x)
    with pytest.raises(ValueError, match="allow_cap"):
        jpca.PCA(12).fit(x)
    capped = PCA(12, allow_cap=True, device="cpu").fit(x)
    ref = jpca.PCA(12, allow_cap=True).fit(x)
    assert capped.n_components_ == ref.n_components_ == 10
    assert tuple(capped.components_.shape) == (10, 30)
    np.testing.assert_allclose(capped.components_[:5].numpy(),
                               np.asarray(ref.components_)[:5], atol=1e-4)


def _psd(n=64, seed=3):
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.normal(0, 1, (n, n)))[0]
    w = 10.0 * 0.7 ** np.arange(n)
    return ((q * w) @ q.T).astype(np.float32), q


def test_topk_eigh_matches_jax():
    a, _ = _psd()
    k, m = 4, 4 + 8
    q0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (64, m),
                                      jnp.float32))
    jw, jv = map(np.asarray, jsub.topk_eigh(jnp.asarray(a), k))
    w, v = subspace.topk_eigh(torch.from_numpy(a), k,
                              q0=torch.from_numpy(q0))
    np.testing.assert_allclose(w.numpy(), jw, rtol=1e-4)
    v = v.numpy()
    np.testing.assert_allclose(_sign_align(v.T, jv.T), jv.T, atol=1e-3)
    # the eigenvectors of the exact solver
    ew, ev = np.linalg.eigh(a.astype(np.float64))
    np.testing.assert_allclose(w.numpy(), ew[::-1][:k], rtol=1e-4)
    np.testing.assert_allclose(_sign_align(v.T, ev[:, ::-1][:, :k].T),
                               ev[:, ::-1][:, :k].T, atol=1e-3)
    # its own generator's start block converges to the same pairs
    w2, _ = subspace.topk_eigh(torch.from_numpy(a), k)
    np.testing.assert_allclose(w2.numpy(), jw, rtol=1e-4)


def test_topk_eigh_deflated_matches_jax():
    a, q = _psd()
    u0 = q[:, 0].astype(np.float32)             # the top eigenvector
    k, m = 3, 3 + 8
    q0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (64, m),
                                      jnp.float32))
    jw, jv = map(np.asarray, jsub.topk_eigh_deflated(
        jnp.asarray(a), jnp.asarray(u0), k))
    w, v = subspace.topk_eigh_deflated(torch.from_numpy(a),
                                       torch.from_numpy(u0), k,
                                       q0=torch.from_numpy(q0))
    np.testing.assert_allclose(w.numpy(), jw, rtol=1e-4)
    np.testing.assert_allclose(w.numpy(), 10.0 * 0.7 ** np.arange(1, 4),
                               rtol=1e-4)
    np.testing.assert_allclose(_sign_align(v.numpy().T, jv.T), jv.T,
                               atol=1e-3)


def test_build_rep_pca_dim_matches_jax():
    arrays, genre_map = sweep_data.reps_data()
    x, ids = arrays["baseline_mel_flat"]                     # (120, 300)
    ref = jmedium._build_rep("r", x, ids, genre_map, standardize=False,
                             pca_dim=8)
    rep = medium._build_rep("r", x, ids, genre_map, standardize=False,
                            pca_dim=8, device="cpu")
    assert tuple(rep.x_dev.shape) == (120, 8)
    np.testing.assert_allclose(rep.x_dev.numpy(), np.asarray(ref.x_dev),
                               atol=1e-4)
    off = ~np.eye(120, dtype=bool)
    np.testing.assert_allclose(rep.dists_dev.numpy()[off],
                               np.asarray(ref.dists_dev)[off], atol=1e-4)
    np.testing.assert_array_equal(rep.y_true, ref.y_true)
    # the clamp for tiny runs: pca_dim above N fits N components
    small = medium._build_rep("r", x[:6], ids[:6], None, False, pca_dim=8,
                              device="cpu")
    assert tuple(small.x_dev.shape) == (6, 6)
