"""Port KMeans, silhouette, Davies-Bouldin and ARI against the JAX package.

Silhouette and DBI (kernel 2's consumers; its plain version on the CPU)
agree with JAX within 5e-4.  KMeans runs other random streams than JAX,
so, as tests/test_kmeans.py does against sklearn, it is held to the same
solution quality: label agreement by ARI and the inertia ratio.
"""
import numpy as np
import pytest
import torch

from vae_hmc_tpu.cluster.kmeans import kmeans as jkmeans
from vae_hmc_tpu.core.config import KMeansConfig as JKMeansConfig
from vae_hmc_tpu.metrics import external as jext
from vae_hmc_tpu.metrics import internal as jint
from vae_hmc_tpu_torch.cluster.kmeans import kmeans
from vae_hmc_tpu_torch.core.config import KMeansConfig
from vae_hmc_tpu_torch.metrics import external, internal

torch.manual_seed(0)
torch.set_num_threads(1)


def _blobs(rng, n=300, d=16, k=5, spread=1.0):
    centers = rng.normal(0, 5, (k, d))
    y = rng.integers(0, k, n)
    return (centers[y] + rng.normal(0, spread, (n, d))).astype(np.float32), y


def test_kmeans_config_copy():
    import dataclasses
    assert dataclasses.asdict(KMeansConfig()) == dataclasses.asdict(
        JKMeansConfig())


@pytest.mark.parametrize("k,n_init,spread", [(5, 10, 1.5), (6, 10, 2.5),
                                             (8, 20, 2.0)])
def test_kmeans_matches_jax_quality(k, n_init, spread):
    rng = np.random.default_rng(k)
    x, _ = _blobs(rng, k=min(k, 5), spread=spread)
    ours = kmeans(x, KMeansConfig(n_clusters=k, n_init=n_init, seed=0),
                  device="cpu")
    ref = jkmeans(x, JKMeansConfig(n_clusters=k, n_init=n_init, seed=0))
    assert ours.labels.shape == (len(x),) and ours.centers.shape == (k, 16)
    assert len(np.unique(ours.labels)) == k      # no empty cluster survives
    assert ours.inertia <= ref.inertia * 1.02
    if k <= 5:                                   # one natural solution
        assert jext.adjusted_rand_index(ours.labels, ref.labels) > 0.97
    # the reported inertia is the labels' own
    own = ((x - ours.centers[ours.labels]) ** 2).sum()
    np.testing.assert_allclose(ours.inertia, own, rtol=1e-4)


def test_kmeans_recovers_blobs_and_is_deterministic():
    x, y = _blobs(np.random.default_rng(9), spread=0.8)
    a = kmeans(x, KMeansConfig(n_clusters=5, n_init=10, seed=3), device="cpu")
    b = kmeans(x, KMeansConfig(n_clusters=5, n_init=10, seed=3), device="cpu")
    assert jext.adjusted_rand_index(a.labels, y) > 0.98
    np.testing.assert_array_equal(a.labels, b.labels)


def _label_cases():
    rng = np.random.default_rng(11)
    x, y = _blobs(rng, n=200, k=4, spread=2.0)
    noisy = rng.integers(0, 5, 200)
    noisy[0] = 7                                 # a singleton cluster
    return [("blobs", x, y), ("random labels + singleton", x, noisy),
            ("offset features", x + 100.0, y)]


@pytest.mark.parametrize("case", range(3))
def test_silhouette_and_dbi_match_jax(case):
    what, x, labels = _label_cases()[case]
    np.testing.assert_allclose(
        internal.silhouette(x, labels, device="cpu"),
        jint.silhouette(x, labels), rtol=0, atol=5e-4, err_msg=what)
    np.testing.assert_allclose(
        internal.davies_bouldin(x, labels, device="cpu"),
        jint.davies_bouldin(x, labels), rtol=0, atol=5e-4, err_msg=what)


def test_silhouette_and_dbi_match_jax_at_mel_flat_width():
    """At the mel-flat width (d = 82,688) the JAX distances keep the f32
    cancellation residue of |x|^2 + |x|^2 - 2 x.x on the self-distance
    diagonal; the port sets it to exactly 0 (sklearn's convention).  The
    gap on the diagonal is stated here (under 1 against distances of ~500),
    and it moves silhouette by ~1e-5: both metrics stay within 5e-4."""
    rng = np.random.default_rng(13)
    n, d, k = 64, 82688, 4
    labels = np.arange(n) % k
    x = (rng.normal(0, 1, (k, d))[labels]
         + rng.normal(0, 1, (n, d))).astype(np.float32)
    xc = x - x.mean(axis=0)
    ref_d = np.sqrt(np.asarray(jint.pairwise_sq_dists(xc)))
    ours_d = internal.pairwise_dists(torch.from_numpy(xc)).numpy()
    off = ~np.eye(n, dtype=bool)
    np.testing.assert_allclose(ours_d[off], ref_d[off], rtol=1e-4, atol=1e-2)
    assert np.count_nonzero(np.diagonal(ours_d)) == 0
    assert np.diagonal(ref_d).max() < 1.0 < ref_d[off].min()
    np.testing.assert_allclose(internal.silhouette(x, labels, device="cpu"),
                               jint.silhouette(x, labels), rtol=0, atol=5e-4)
    np.testing.assert_allclose(
        internal.davies_bouldin(x, labels, device="cpu"),
        jint.davies_bouldin(x, labels), rtol=0, atol=5e-4)


def test_metrics_reject_degenerate_labels():
    x = np.zeros((5, 3), np.float32)
    with pytest.raises(ValueError):
        internal.silhouette(x, np.zeros(5), device="cpu")
    with pytest.raises(ValueError):
        internal.davies_bouldin(x, np.zeros(5), device="cpu")


def test_ari_matches_jax():
    rng = np.random.default_rng(12)
    for _ in range(5):
        a, b = rng.integers(-1, 6, 100), rng.integers(0, 4, 100)
        assert external.adjusted_rand_index(a, b) == pytest.approx(
            jext.adjusted_rand_index(a, b), abs=1e-12)
    assert external.adjusted_rand_index([0, 0, 1], [5, 5, 2]) == 1.0


def test_empty_cluster_moves_to_farthest_point():
    from vae_hmc_tpu_torch.cluster.kmeans import _assign, _update
    x = torch.tensor([[0.0, 0.0], [0.1, 0.0], [5.0, 0.0], [9.0, 0.0]])
    centers = torch.tensor([[[0.0, 0.0], [5.0, 0.0], [100.0, 100.0]]])
    labels, d2 = _assign(x, centers)
    new = _update(x, centers, labels, d2)
    # cluster 2 is empty; [9, 0] is the point farthest from its own centre
    torch.testing.assert_close(new[0, 2], torch.tensor([9.0, 0.0]))
    torch.testing.assert_close(new[0, 0], torch.tensor([0.05, 0.0]))
