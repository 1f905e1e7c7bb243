"""Scripts 13 and 16's clustering pieces on the port against the JAX package.

Every distance of the port comes from kernel 2 (its plain version on the
CPU).  The data are hierarchical blobs: 4 groups far apart, each two
sub-blobs at 2.0, 1.6, 1.3 and 1.05 units, so KMeans and ward have one best
partition at every k in 4..8 and the two packages' different random
streams (ROADMAP parity rule 2) find the same one.  No off-diagonal pair
lies within 1e-4 of any DBSCAN eps of the grids, so f32 rounding cannot
flip a threshold (asserted).

  - the distance caches agree off the diagonal within 1e-4: the f32
    cancellation error of |a|^2+|b|^2-2ab is a few ulps of |a|^2 (~9
    here) in each package;
  - masked silhouette / Davies-Bouldin and Calinski-Harabasz: rtol 1e-5;
  - DBSCAN labels identical: the device grid and the f64-refined host path;
  - ward: from the same squared distances, the same linkage (heights rtol
    1e-5); from each package's own distances, merge indices and cut-tree
    labels identical and heights within 1e-4 (the distance gap above); the
    native NN-chain against the numpy one;
  - cluster_suite / full_sweep: same row schema, order, n_clusters_found
    and n_noise, metrics within atol 1e-4.
"""
import numpy as np
import pytest
import torch

from vae_hmc_tpu.cluster import agglomerative as jagg
from vae_hmc_tpu.cluster import dbscan as jdb
from vae_hmc_tpu.cluster import sweep as jsweep
from vae_hmc_tpu.cluster.kmeans import kmeans_fit_predict as jkfp
from vae_hmc_tpu.metrics import external as jext
from vae_hmc_tpu.metrics import internal as jint
from vae_hmc_tpu.metrics import safe as jsafe
from vae_hmc_tpu.ops.scaler import StandardScaler as JScaler
from vae_hmc_tpu_torch.cluster import agglomerative as agg
from vae_hmc_tpu_torch.cluster import dbscan as db
from vae_hmc_tpu_torch.cluster import sweep
from vae_hmc_tpu_torch.cluster.kmeans import kmeans_fit_predict
from vae_hmc_tpu_torch.metrics import internal, safe
from vae_hmc_tpu_torch.ops.scaler import StandardScaler, standardize

from tests import torch_sweep_data as sweep_data

torch.manual_seed(0)
torch.set_num_threads(1)

SWEEP_EPS = sweep_data.SWEEP_EPS
_min_gap = sweep_data._min_gap


@pytest.fixture(scope="module")
def reps_data():
    return sweep_data.reps_data()


def _jax_dists(x):
    return np.sqrt(np.asarray(jint.pairwise_sq_dists(x - x.mean(axis=0))))


def test_data_has_no_pair_near_an_eps(reps_data):
    arrays, _ = reps_data
    for x, _ in arrays.values():
        assert _min_gap(x) > 1e-4


def test_centered_euclidean_dists_off_diagonal_matches_jax(reps_data):
    arrays, _ = reps_data
    for x, _ in arrays.values():
        ours = internal.centered_euclidean_dists(x, device="cpu").numpy()
        ref = np.asarray(jint.centered_euclidean_dists(x))
        off = ~np.eye(len(x), dtype=bool)
        np.testing.assert_allclose(ours[off], ref[off], rtol=0, atol=1e-4)
        assert np.count_nonzero(np.diagonal(ours)) == 0


def _label_cases(n, rng):
    y = np.repeat(np.arange(8), n // 8)[:n]
    noisy = y.copy()
    noisy[rng.choice(n, n // 5, replace=False)] = -1     # DBSCAN noise
    odd = rng.integers(0, 5, n) * 3 + 7                  # sparse label ids
    odd[:10] = -1
    return [y // 2, noisy, odd, np.where(y < 2, -1, y % 3)]


@pytest.mark.parametrize("case", range(4))
def test_masked_metrics_match_jax(reps_data, case):
    arrays, _ = reps_data
    x = arrays["vae_mm_latents"][0]
    labels = _label_cases(len(x), np.random.default_rng(7))[case]
    d_ours = internal.centered_euclidean_dists(x, device="cpu")
    d_ref = jint.centered_euclidean_dists(x)
    np.testing.assert_allclose(
        internal.silhouette_from_dists_masked(d_ours, labels),
        jint.silhouette_from_dists_masked(d_ref, labels), rtol=1e-5)
    lazy = internal.davies_bouldin_masked(torch.from_numpy(x), labels,
                                          lazy=True)
    assert isinstance(lazy, torch.Tensor) and lazy.ndim == 0
    np.testing.assert_allclose(float(lazy),
                               jint.davies_bouldin_masked(x, labels),
                               rtol=1e-5)
    keep = labels >= 0
    np.testing.assert_allclose(
        internal.calinski_harabasz(x[keep], labels[keep], device="cpu"),
        jint.calinski_harabasz(x[keep], labels[keep]), rtol=1e-5)
    if (labels >= 0).all():
        np.testing.assert_allclose(
            internal.silhouette_from_dists(d_ours, labels),
            jint.silhouette_from_dists(d_ref, labels), rtol=1e-5)
    # the safe wrappers subset x and recompute its distances: the bands of
    # tests/test_torch_cluster_metrics.py for the unmasked metrics
    for fn in ("safe_silhouette", "safe_davies_bouldin"):
        np.testing.assert_allclose(getattr(safe, fn)(x, labels, device="cpu"),
                                   getattr(jsafe, fn)(x, labels), atol=5e-4)
    np.testing.assert_allclose(
        safe.safe_calinski_harabasz(x, labels, device="cpu"),
        jsafe.safe_calinski_harabasz(x, labels), rtol=1e-5)


def test_safe_metrics_degenerate_cells_give_none():
    x = np.random.default_rng(0).normal(0, 1, (6, 3)).astype(np.float32)
    for labels in ([-1, -1, -1, -1, 0, 0], [0, 0, 0, 0, 0, 0],
                   [-1, -1, -1, -1, 0, 1]):
        assert safe.safe_silhouette(x, labels, device="cpu") is None
        assert jsafe.safe_silhouette(x, labels) is None
    assert safe.safe_davies_bouldin(x, [-1] * 5 + [0], device="cpu") is None
    assert safe.safe_ari([0, 1, 1], [1, 0, 0]) == jsafe.safe_ari([0, 1, 1],
                                                                 [1, 0, 0])
    assert safe.noise_fraction([-1, 0, -1, 2]) == 0.5
    assert safe.n_effective_clusters([-1, 0, 0, 2]) == 2
    with pytest.raises(ValueError):
        internal.silhouette_from_dists_masked(torch.zeros(4, 4), [-1, 0, 1, -1])


def test_dbscan_device_grid_matches_jax_and_sklearn(reps_data):
    from sklearn.cluster import DBSCAN as SkDBSCAN
    arrays, _ = reps_data
    for name, (x, _) in arrays.items():
        ours = db.dbscan_sweep_from_dists_device(
            internal.centered_euclidean_dists(x, device="cpu"), SWEEP_EPS,
            (3, 5, 8))
        ref = jdb.dbscan_sweep_from_dists_device(
            jint.centered_euclidean_dists(x), SWEEP_EPS, (3, 5, 8))
        assert list(ours) == list(ref)
        found = set()
        for cell, labels in ours.items():
            np.testing.assert_array_equal(labels, ref[cell],
                                          err_msg=f"{name} {cell}")
            sk = SkDBSCAN(eps=cell[0], min_samples=cell[1]).fit_predict(x)
            np.testing.assert_array_equal(labels, sk, err_msg=f"{name} {cell}")
            found.add(len(set(labels.tolist()) - {-1}))
        assert len(found) > 2, (name, found)     # the grid is not degenerate


def test_dbscan_host_path_matches_jax():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(0, 0.3, (40, 4)),
                        rng.normal(4, 0.3, (35, 4)),
                        rng.uniform(-3, 7, (20, 4))]).astype(np.float32)
    for eps, ms in [(0.5, 3), (0.9, 5), (1.5, 12), (0.05, 3)]:
        np.testing.assert_array_equal(db.dbscan(x, eps, ms, device="cpu"),
                                      jdb.dbscan(x, eps, ms))
        np.testing.assert_array_equal(
            db.dbscan(torch.from_numpy(x), eps, ms),
            jdb.dbscan(x, eps, ms))
    ours = db.dbscan_sweep(x, [0.5, 0.9], [3, 5], device="cpu")
    ref = jdb.dbscan_sweep(x, [0.5, 0.9], [3, 5])
    for cell in ref:
        np.testing.assert_array_equal(ours[cell], ref[cell])
    grid = db.dbscan_sweep(torch.from_numpy(x), [0.5, 0.9], [3, 5])
    for cell in ref:
        np.testing.assert_array_equal(grid[cell], ref[cell])


def test_dbscan_host_path_refines_the_eps_band():
    """The f32 |a|^2+|b|^2-2ab squared distance of this pair lands over
    eps^2 while the f64 one is under it (the JAX package's regression
    case): the host path refines it and matches sklearn."""
    from sklearn.cluster import DBSCAN as SkDBSCAN
    eps, ms = 0.3, 3
    c = np.asarray([43.38662338256836, 76.28477478027344], np.float32)
    b = np.asarray([43.57174301147461, 76.52084350585938], np.float32)
    x = np.stack([c, c + np.float32(0.01), c - np.float32(0.01), b])
    sk = SkDBSCAN(eps=eps, min_samples=ms).fit_predict(x)
    assert sk[3] == 0
    np.testing.assert_array_equal(db.dbscan(x, eps, ms, device="cpu"), sk)
    np.testing.assert_array_equal(
        db.dbscan_sweep(x, [eps], [ms], device="cpu")[(eps, ms)], sk)


def test_ward_native_matches_numpy(reps_data):
    """As the JAX package's own test: merges of equal height may swap ids
    (the two NN-chains update in a different operand order), so heights,
    sizes and the induced clusterings must agree."""
    arrays, _ = reps_data
    for x, _ in arrays.values():
        d2 = internal.centered_euclidean_dists(
            x, device="cpu").numpy().astype(np.float64) ** 2
        native = agg.ward_linkage_from_sq_dists(d2.copy())
        plain = agg._ward_nn_chain_numpy_from_d2(d2.copy())
        np.testing.assert_allclose(native[:, 2], plain[:, 2], rtol=1e-12)
        np.testing.assert_array_equal(np.sort(native[:, 3]),
                                      np.sort(plain[:, 3]))
        for k in (2, 4, 6, 8):
            assert jext.adjusted_rand_index(
                agg.cut_tree_n_clusters(native, len(x), k),
                agg.cut_tree_n_clusters(plain, len(x), k)) == 1.0


def test_ward_matches_jax_and_sklearn(reps_data):
    from sklearn.cluster import AgglomerativeClustering
    from sklearn.metrics import adjusted_rand_score
    arrays, _ = reps_data
    for name, (x, _) in arrays.items():
        d_ours = internal.centered_euclidean_dists(
            x, device="cpu").numpy().astype(np.float64)
        ours = agg.ward_linkage_from_sq_dists(d_ours ** 2)
        # the same input: the same linkage
        same = jagg.ward_linkage_from_sq_dists(d_ours ** 2)
        np.testing.assert_array_equal(ours[:, [0, 1, 3]], same[:, [0, 1, 3]])
        np.testing.assert_allclose(ours[:, 2], same[:, 2], rtol=1e-5)
        # each package's own distances: the same merges
        ref = jagg.ward_linkage_from_sq_dists(
            _jax_dists(x).astype(np.float64) ** 2)
        np.testing.assert_array_equal(ours[:, [0, 1, 3]], ref[:, [0, 1, 3]],
                                      err_msg=name)
        np.testing.assert_allclose(ours[:, 2], ref[:, 2], rtol=0, atol=1e-4)
        for k in (2, 4, 5, 6, 7, 8):
            labels = agg.cut_tree_n_clusters(ours, len(x), k)
            np.testing.assert_array_equal(
                labels, jagg.cut_tree_n_clusters(ref, len(x), k))
        sk = AgglomerativeClustering(n_clusters=6, linkage="ward") \
            .fit_predict(x)
        assert adjusted_rand_score(agg.agglomerative_ward(x, 6, device="cpu"),
                                   sk) == pytest.approx(1.0)


def test_scaler_and_kmeans_fit_predict_match_jax(reps_data):
    arrays, _ = reps_data
    x = arrays["vae_mm_latents"][0].copy()
    x[:, 3] = 2.5                                    # a zero-variance column
    ours = StandardScaler().fit_transform(x, device="cpu")
    np.testing.assert_allclose(ours.numpy(),
                               np.asarray(JScaler().fit_transform(x)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(standardize(x, device="cpu").numpy(),
                                  ours.numpy())
    for k in (4, 6, 8):
        a = kmeans_fit_predict(x, k, n_init=10, seed=42, device="cpu")
        assert jext.adjusted_rand_index(a, jkfp(x, k, n_init=10)) == 1.0


def _jax_reps(arrays, genre_map):
    """The JAX package's RepData with its distance cache's diagonal set to
    0 (ROADMAP parity rule 5).  JAX keeps the f32 residue
    sqrt(|x|^2 + |x|^2 - 2 x.x) there, up to 2.6e-3 on the wide
    representation here, and every masked silhouette adds it to a point's
    mean intra-cluster distance: 3e-6 to 1.7e-4 off sklearn's value, where
    the port is within 1e-5 (test_full_sweep_matches_jax checks the port
    against sklearn)."""
    import jax.numpy as jnp
    from vae_hmc_tpu.core.align import labels_for_ids
    reps = []
    for name, (x, ids) in arrays.items():
        rep = jsweep.RepData.build(name, x, labels_for_ids(ids, genre_map))
        rep.dists_dev = jnp.where(jnp.eye(len(x), dtype=bool), 0.0,
                                  rep.dists_dev)
        reps.append(rep)
    return reps


def _port_reps(arrays, genre_map):
    from vae_hmc_tpu_torch.core.align import labels_for_ids
    return [sweep.RepData.build(name, x, labels_for_ids(ids, genre_map),
                                device="cpu")
            for name, (x, ids) in arrays.items()]


def assert_rows_match(ours, ref):
    assert len(ours) == len(ref)
    for r, j in zip(ours, ref):
        assert list(r) == list(j)                       # schema and key order
        for key in r:
            a, b = r[key], j[key]
            if key in ("silhouette", "davies_bouldin", "ari", "score",
                       "noise_frac"):
                assert (a is None) == (b is None), (r, j)
                if a is not None:
                    assert isinstance(a, float)
                    assert a == pytest.approx(b, abs=1e-4), (key, r, j)
            else:
                assert a == b, (key, r, j)


@pytest.fixture(scope="module")
def suite_and_sweep(reps_data):
    arrays, genre_map = reps_data
    out = {"arrays": arrays}
    for tag, reps, mod in (("ours", _port_reps(arrays, genre_map), sweep),
                           ("ref", _jax_reps(arrays, genre_map), jsweep)):
        out[tag] = ([row for rep in reps for row in mod.cluster_suite(rep, 6)],
                    [row for rep in reps for row in mod.full_sweep(rep)])
    return out


def test_cluster_suite_matches_jax(suite_and_sweep):
    ours, ref = suite_and_sweep["ours"][0], suite_and_sweep["ref"][0]
    assert len(ours) == 21
    assert_rows_match(ours, ref)


def test_full_sweep_matches_jax(suite_and_sweep):
    ours, ref = suite_and_sweep["ours"][1], suite_and_sweep["ref"][1]
    assert len(ours) == 102
    assert_rows_match(ours, ref)
    # k = 4 recovers the 4 groups, which are the genres
    assert [r["ari"] for r in ours if r["params"].startswith("k=4")] == \
        pytest.approx([1.0] * 6)
    # the port's silhouettes are sklearn's (f64, noise dropped)
    from sklearn.metrics import silhouette_score
    arrays = suite_and_sweep["arrays"]
    reps = _port_reps(arrays, {})
    by_name = {r.name: r for r in reps}
    checked = 0
    for r in ours:
        if r["silhouette"] is None or r["algo"] == "agglomerative":
            continue
        rep = by_name[r["representation"]]
        if r["algo"] == "kmeans":
            labels = rep.kmeans_labels(int(r["params"][2:]))
        else:
            eps, ms = (p.split("=")[1] for p in r["params"].split(","))
            labels = db.dbscan_sweep_from_dists_device(
                rep.dists_dev, [float(eps)], [int(ms)])[(float(eps), int(ms))]
        x = arrays[r["representation"]][0].astype(np.float64)
        keep = labels >= 0
        assert r["silhouette"] == pytest.approx(
            silhouette_score(x[keep], labels[keep]), abs=1e-5), r
        checked += 1
    assert checked > 40
    assert any(r["n_noise"] > 0 for r in ours)
    assert any(r["silhouette"] is None for r in ours)


def test_sweep_errors_propagate(reps_data, monkeypatch):
    """A failing ward linkage on its thread surfaces in the caller."""
    arrays, genre_map = reps_data

    def broken(d2):
        raise RuntimeError("ward exploded")

    monkeypatch.setattr(sweep, "ward_linkage_from_sq_dists", broken)
    rep = _port_reps({"vae_mm_latents": arrays["vae_mm_latents"]},
                     genre_map)[0]
    with pytest.raises(RuntimeError, match="ward exploded"):
        sweep.full_sweep(rep, ks=(4,))
