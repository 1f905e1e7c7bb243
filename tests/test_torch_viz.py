"""The port's t-SNE, UMAP, projection dispatch and figure writers against
the JAX package (numpy inputs from a seed, CPU).

  - t-SNE, stage by stage at atol 1e-5: the perplexity-searched P (the
    port's squared distances are kernel 2's, of the centred rows), one
    optimizer step from the same y0 (early and late schedule), the PCA
    init; end to end on blobs, trustworthiness above 0.9 and within 0.03
    of the JAX package's;
  - UMAP's exact parts: find_ab_params; kNN indices (no ties in the data)
    and distances; rho, sigma, the edge-wise fuzzy union and its dense
    small-graph counterpart, epochs per sample (atol 1e-5); the spectral
    init from the JAX package's start block, per column up to sign (atol
    1e-3 on the +-10 box), and how far one-ulp moves of the edge weights
    move that init (1e-3 to 1e-2); end to end, trustworthiness above 0.9
    and ARI above 0.95 on blobs (the random streams differ, ROADMAP parity
    rule 2, so the embedding is held to quality, as tests/test_umap.py
    holds the JAX one);
  - reduce_2d's dispatch and pre_pca_dim step;
  - every figure writer draws a PNG, and writes its data as .npz when
    matplotlib cannot be imported.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_hmc_tpu.core import config as jconfig
from vae_hmc_tpu.metrics.internal import pairwise_sq_dists as jsq
from vae_hmc_tpu.ops.pca import PCA as JPCA
from vae_hmc_tpu.viz import projections as jproj
from vae_hmc_tpu.viz import tsne as jtsne
from vae_hmc_tpu.viz import umap as jumap
from vae_hmc_tpu_torch.core import config
from vae_hmc_tpu_torch.viz import plots, projections
from vae_hmc_tpu_torch.viz import tsne as tsne_mod
from vae_hmc_tpu_torch.viz import umap as umap_mod

torch.manual_seed(0)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def clustered():
    """3 blobs of 40 in 10-d (the JAX package's tests/test_viz.py data)."""
    rng = np.random.default_rng(7)
    centers = rng.normal(0, 8, (3, 10))
    y = np.repeat(np.arange(3), 40)
    x = (centers[y] + rng.normal(0, 1.0, (120, 10))).astype(np.float32)
    return x, y


@pytest.fixture(scope="module")
def blobs3():
    """3 blobs of 60 in 10-d (the JAX package's tests/test_umap.py data)."""
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 8, (3, 10))
    y = np.repeat(np.arange(3), 60)
    x = (centers[y] + rng.normal(0, 0.8, (180, 10))).astype(np.float32)
    return x, y


def test_viz_configs_copied_exactly():
    for ours, ref in ((config.TsneConfig(), jconfig.TsneConfig()),
                      (config.UmapConfig(), jconfig.UmapConfig()),
                      (config.UMAP_EASY, jconfig.UMAP_EASY),
                      (config.UMAP_HARD, jconfig.UMAP_HARD)):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert config.asdict(config.Workspace("/w")) == jconfig.asdict(
        jconfig.Workspace("/w"))
    assert config.asdict(config.ConvMMVaeConfig()) == jconfig.asdict(
        jconfig.ConvMMVaeConfig())


# ---------------------------------------------------------------------------
# t-SNE
# ---------------------------------------------------------------------------


def test_tsne_perplexity_search_matches_jax():
    x = np.random.default_rng(1).normal(0, 1, (60, 10)).astype(np.float32)
    perplexity = min(30.0, max(2.0, 59 / 3.0))
    ref = np.asarray(jtsne._binary_search_perplexity(jsq(jnp.asarray(x)),
                                                     perplexity))
    d2 = tsne_mod.input_sq_dists(torch.from_numpy(x))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jsq(jnp.asarray(x))),
                               atol=1e-4)
    p = tsne_mod._binary_search_perplexity(d2, perplexity).numpy()
    np.testing.assert_allclose(p, ref, atol=1e-5)
    np.testing.assert_allclose(p.sum(axis=1), 1.0, atol=1e-5)
    assert np.all(np.diag(p) == 0.0)


@pytest.mark.parametrize("early_iter", [250, 0])
def test_tsne_one_step_matches_jax(early_iter):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (60, 10)).astype(np.float32)
    p_cond = np.array(jtsne._binary_search_perplexity(
        jsq(jnp.asarray(x)), 19.0))
    # a y0 that the step moves by 0.2-7 units: f32 rounding stays < 1e-5
    y0 = (1e-2 * rng.normal(0, 1, (60, 2))).astype(np.float32)
    ref = np.asarray(jtsne._tsne_optimize(jnp.asarray(p_cond),
                                          jnp.asarray(y0), 200.0, n_iter=1,
                                          early_iter=early_iter))
    ours = tsne_mod._tsne_optimize(torch.from_numpy(p_cond),
                                   torch.from_numpy(y0), 200.0, n_iter=1,
                                   early_iter=early_iter).numpy()
    assert np.abs(ours - y0).max() > 0.1              # the step moved y
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_tsne_pca_init_matches_jax(clustered):
    x, _ = clustered
    ref = np.asarray(JPCA(2).fit_transform(x))
    ref = ref / (ref[:, 0].std() + 1e-12) * 1e-4
    ours = tsne_mod.pca_init(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    np.testing.assert_allclose(ours * 1e4, ref * 1e4, atol=1e-4)


def test_tsne_end_to_end_quality(clustered):
    from sklearn.manifold import trustworthiness
    x, _ = clustered
    cfg = config.TsneConfig(n_iter=800, perplexity=15)
    ours = tsne_mod.tsne(x, cfg, device="cpu")
    ref = jtsne.tsne(x, jconfig.TsneConfig(n_iter=800, perplexity=15))
    assert ours.shape == (120, 2) and np.isfinite(ours).all()
    t_ours = trustworthiness(x, ours, n_neighbors=10)
    t_ref = trustworthiness(x, ref, n_neighbors=10)
    assert t_ours > 0.9 and abs(t_ours - t_ref) <= 0.03, (t_ours, t_ref)


# ---------------------------------------------------------------------------
# UMAP
# ---------------------------------------------------------------------------


def test_find_ab_params_equal():
    for min_dist in (0.1, 0.15):
        assert umap_mod.find_ab_params(1.0, min_dist) == \
            jumap.find_ab_params(1.0, min_dist)


def _jax_graph(x, k):
    knn_d, knn_i = jumap._knn(jnp.asarray(x), k)
    rho, sigma = jumap._smooth_knn(knn_d)
    return knn_d, knn_i, rho, sigma


def test_umap_graph_stages_match_jax():
    x = np.random.default_rng(3).normal(0, 1, (60, 4)).astype(np.float32)
    k = 8
    knn_d, knn_i, rho, sigma = _jax_graph(x, k)
    d, i = umap_mod._knn(torch.from_numpy(x), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(knn_i))
    np.testing.assert_allclose(d.numpy(), np.asarray(knn_d), atol=1e-5)

    # from the JAX kNN on: the same arithmetic on the same inputs
    t_d = torch.from_numpy(np.array(knn_d))
    t_i = torch.from_numpy(np.array(knn_i, dtype=np.int64))
    r, s = umap_mod._smooth_knn(t_d)
    np.testing.assert_allclose(r.numpy(), np.asarray(rho), atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sigma), atol=1e-5)
    h, t, w = umap_mod._edge_weights(t_d, t_i, r, s)
    jh, jt, jw = map(np.asarray, jumap._edge_weights(knn_d, knn_i, rho,
                                                     sigma))
    np.testing.assert_array_equal(h.numpy(), jh)
    np.testing.assert_array_equal(t.numpy(), jt)
    np.testing.assert_allclose(w.numpy(), jw, atol=1e-5)
    eps = umap_mod._eps_per_sample(torch.from_numpy(jw.copy()), 200).numpy()
    jeps = np.asarray(jumap._eps_per_sample(jnp.asarray(jw), 200))
    np.testing.assert_array_equal(np.isinf(eps), np.isinf(jeps))
    np.testing.assert_allclose(eps, jeps, atol=1e-5)

    # the small-graph API: dense W, its edge list (== the edge-wise union)
    W = umap_mod.fuzzy_simplicial_set(x, k, device="cpu")
    jW = np.asarray(jumap.fuzzy_simplicial_set(jnp.asarray(x), k))
    np.testing.assert_allclose(W.numpy(), jW, atol=1e-5)
    eh, et, ew = umap_mod._edge_list(W, t_i)
    np.testing.assert_array_equal(eh.numpy(), jh)
    np.testing.assert_array_equal(et.numpy(), jt)
    np.testing.assert_allclose(ew.numpy(), jw, atol=1e-5)


def _sign_cols(a, b):
    return a * np.sign(np.sum(a * b, axis=0, keepdims=True))


def test_spectral_init_matches_jax_from_its_start_block():
    """A rectangle 4 x 1 (plus two small noise dimensions): one connected
    graph whose first two Laplacian eigenvectors are well separated, so
    each column is determined up to sign."""
    rng = np.random.default_rng(5)
    n = 120
    x = np.concatenate([rng.uniform(0, 1, (n, 2)) * [4.0, 1.0],
                        0.05 * rng.normal(0, 1, (n, 2))], axis=1)
    x = x.astype(np.float32)
    knn_d, knn_i, rho, sigma = _jax_graph(x, 10)
    jh, jt, jw = jumap._edge_weights(knn_d, knn_i, rho, sigma)
    ref = np.asarray(jumap._spectral_init_sparse(jh, jt, jw, n))
    q0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (n, 10),
                                    jnp.float32))
    ours = umap_mod._spectral_init_sparse(
        torch.from_numpy(np.array(jh, dtype=np.int64)),
        torch.from_numpy(np.array(jt, dtype=np.int64)),
        torch.from_numpy(np.array(jw)), n, q0=torch.from_numpy(q0)).numpy()
    np.testing.assert_allclose(_sign_cols(ours, ref), ref, atol=1e-3)
    # the dense small-graph init (exact eigh at every size)
    W = np.array(jumap._build_w(knn_d, knn_i, rho, sigma))
    dense = umap_mod._spectral_init(torch.from_numpy(W)).numpy()
    jdense = np.asarray(jumap._spectral_init(jnp.asarray(W)))
    np.testing.assert_allclose(_sign_cols(dense, jdense), jdense, atol=1e-3)


def test_spectral_init_moves_by_1e3_under_one_ulp():
    """On the same rectangle, moving the edge weights by one ulp (all up,
    all down, random halves up) moves the sparse init by about 1e-3 of its
    +-10 box on the CPU alone: 150 fp32 iterations on an operator whose
    leading eigenvalues lie close together carry last-bit changes that far.
    So the card (kernel 2's distances, index_add_'s atomics) cannot be held
    to the CPU's init much below that (tools/umap_init_spread)."""
    from vae_hmc_tpu_torch.tools import umap_init_spread as spread
    x, q0 = spread.rectangle()
    moves = spread.cpu_readings(x, q0)["ulp_moves"]
    assert len(moves) == 10 and all(m > 0.0 for m in moves.values())
    assert 1e-3 < max(moves.values()) < 1e-2


def test_umap_end_to_end_quality(blobs3):
    from sklearn.manifold import trustworthiness
    from sklearn.metrics import adjusted_rand_score

    from vae_hmc_tpu_torch.cluster.kmeans import kmeans_fit_predict
    x, y = blobs3
    emb = umap_mod.umap_2d(x, n_neighbors=12, n_epochs=200, seed=0,
                           device="cpu")
    assert emb.shape == (180, 2) and np.isfinite(emb).all()
    assert trustworthiness(x, emb, n_neighbors=10) > 0.9
    yhat = kmeans_fit_predict(emb, 3, n_init=5, seed=0, device="cpu")
    assert adjusted_rand_score(y, yhat) > 0.95
    # from distances: the same chain; a batch is one call per matrix
    xt = torch.from_numpy(x)
    d = torch.cdist(xt - xt.mean(0), xt - xt.mean(0))
    single = umap_mod.umap_2d_from_dists(d, n_neighbors=12, n_epochs=200,
                                         seed=0)
    assert trustworthiness(x, single, n_neighbors=10) > 0.9
    batch = umap_mod.umap_2d_from_dists_batch([d, d], n_neighbors=12,
                                              n_epochs=200, seed=0)
    assert batch.shape == (2, 180, 2)
    np.testing.assert_array_equal(batch[0], single)
    np.testing.assert_array_equal(batch[1], single)


# ---------------------------------------------------------------------------
# reduce_2d
# ---------------------------------------------------------------------------


def test_reduce_2d_dispatch(clustered):
    x, _ = clustered
    xy, used = projections.reduce_2d(x, "pca", device="cpu")
    ref, jused = jproj.reduce_2d(x, "pca")
    assert used == jused == "pca"
    np.testing.assert_allclose(xy, ref, atol=1e-4)
    xy, used = projections.reduce_2d(torch.from_numpy(x), "UMAP")
    assert used == "umap" and xy.shape == (120, 2)
    xy, used = projections.reduce_2d(
        x, "tsne", tsne_cfg=config.TsneConfig(n_iter=50), device="cpu")
    assert used == "tsne" and xy.shape == (120, 2)
    with pytest.raises(ValueError, match="unknown projection"):
        projections.reduce_2d(x, "isomap", device="cpu")


def test_reduce_2d_pre_pca_dim():
    x = np.random.default_rng(6).normal(0, 1, (60, 200)).astype(np.float32)
    xy, used = projections.reduce_2d(x, "pca", pre_pca_dim=20, device="cpu")
    ref, _ = jproj.reduce_2d(x, "pca", pre_pca_dim=20)
    np.testing.assert_allclose(xy, ref, atol=1e-4)
    xy, used = projections.reduce_2d(
        x, "tsne", tsne_cfg=config.TsneConfig(n_iter=50), pre_pca_dim=20,
        device="cpu")
    assert used == "tsne" and xy.shape == (60, 2)
    # clamped by N: 80 > 60 rows fits 60 components, as the JAX package
    xy, _ = projections.reduce_2d(x, "pca", pre_pca_dim=80, device="cpu")
    ref, _ = jproj.reduce_2d(x, "pca", pre_pca_dim=80)
    np.testing.assert_allclose(xy, ref, atol=1e-4)


@pytest.mark.parametrize("installed,env,want", [
    (False, "1", False), (True, "", False), (True, "1", True)])
def test_use_umap_learn_needs_package_and_env(monkeypatch, installed, env,
                                              want):
    """The one place that decides on umap-learn (reduce_2d and script 15):
    the variable alone, without the package, keeps the first-party UMAP."""
    monkeypatch.setattr(projections, "_HAVE_UMAP_LEARN", installed)
    monkeypatch.setenv("VAE_HMC_USE_UMAP_LEARN", env)
    assert projections.use_umap_learn() is want


# ---------------------------------------------------------------------------
# Figure writers
# ---------------------------------------------------------------------------


def _writers(tmp_path):
    rng = np.random.default_rng(8)
    xy = rng.normal(0, 1, (30, 2))
    y = np.repeat(np.arange(3), 10)
    hist = [{"epoch": 1, "total": 1.0, "recon": 0.8, "kl": 0.2},
            {"epoch": 2, "total": 0.9, "recon": 0.7, "kl": 0.2}]
    panel = (xy, y, "panel")
    return {
        "scatter": lambda: plots.scatter_2d(xy, y, tmp_path / "s.png", "t"),
        "scatter_noise": lambda: plots.scatter_2d(
            xy, np.where(y == 0, -1, y), tmp_path / "n.png", "t",
            noise_as_x=True),
        "curves": lambda: plots.training_curves(hist, tmp_path / "c.png"),
        "bars": lambda: plots.grouped_bars(
            [{"m": "a", "s": 0.3, "n": 0.1}, {"m": "b", "s": 0.5, "n": None}],
            "m", ["s", "n"], tmp_path / "b.png", "t"),
        "stacked": lambda: plots.stacked_bar_distribution(
            np.array([[3, 1], [2, 4]]), ["c0", "c1"], ["g0", "g1"],
            tmp_path / "st.png", "t"),
        "line": lambda: plots.line_sweep([0.1, 0.2], [5, 3],
                                         tmp_path / "l.png", "x", "y", "t"),
        "pca_var": lambda: plots.pca_variance_plot(
            np.array([0.5, 0.3, 0.1]), tmp_path / "v.png", "t"),
        "recon": lambda: plots.recon_overlay(
            rng.normal(0, 1, (5, 20)), rng.normal(0, 1, (5, 20)),
            tmp_path / "r.png"),
        "side_by_side": lambda: plots.side_by_side(
            [[panel, panel]] * 3, tmp_path / "sbs.png", dpi=40),
    }


WRITERS = ["scatter", "scatter_noise", "curves", "bars", "stacked", "line",
           "pca_var", "recon", "side_by_side"]


@pytest.mark.parametrize("name", WRITERS)
def test_figure_writer_draws_png(tmp_path, name):
    assert plots.figure_kind() == "png"
    path = _writers(tmp_path)[name]()
    assert path.suffix == ".png" and path.stat().st_size > 1000
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("name", WRITERS)
def test_figure_writer_saves_npz_without_matplotlib(tmp_path, monkeypatch,
                                                    name):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    assert plots.figure_kind() == "npz"
    path = _writers(tmp_path)[name]()
    assert path.suffix == ".npz" and not path.with_suffix(".png").exists()
    with np.load(path) as data:
        keys = set(data.files)
        if name.startswith("scatter"):
            assert keys == {"xy", "labels", "title"}
            assert data["xy"].shape == (30, 2)
            assert str(data["title"]) == "t"
        if name == "side_by_side":
            assert {"xy_2_1", "labels_2_1", "title_2_1"} <= keys
        if name == "line":
            np.testing.assert_array_equal(data["y"], [5, 3])
