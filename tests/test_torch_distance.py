"""Port pairwise distances (kernel 2's function) against the JAX package.

The port's plain version (what the wrapper runs on the CPU) against the
Pallas kernel in interpret mode and against sqrt(pairwise_sq_dists), at the
tests/test_pallas.py tolerances: rtol 1e-4, atol 1e-2 (the sqrt of the f32
cancellation residue near zero distances).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_hmc_tpu.metrics.internal import pairwise_sq_dists
from vae_hmc_tpu.ops.pallas.distance_kernel import pairwise_dists_pallas
from vae_hmc_tpu_torch.ops.kernels import build
from vae_hmc_tpu_torch.ops.kernels import distance as dk
from vae_hmc_tpu_torch.ops.kernels.distance import (pairwise_dists,
                                                    pairwise_dists_plain)

torch.manual_seed(0)
torch.set_num_threads(1)


def _centred(rng, n, d, scale=1.0):
    x = rng.normal(0, scale, (n, d)).astype(np.float32)
    return x - x.mean(axis=0)


@pytest.mark.parametrize("n,d,tile", [(100, 40, 32), (37, 17, 16)])
def test_matches_pallas_interpret(n, d, tile):
    x = _centred(np.random.default_rng(n), n, d, scale=2.0)
    ref = np.asarray(pairwise_dists_pallas(jnp.asarray(x), tile_n=tile,
                                           tile_k=tile, interpret=True))
    ours = pairwise_dists(torch.from_numpy(x)).numpy()
    assert ours.shape == (n, n)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("n,m,d", [(37, 17, 17), (64, 6, 32), (5, 5, 300)])
def test_matches_xla_pairwise_sq_dists(n, m, d):
    rng = np.random.default_rng(n + m + d)
    x, y = _centred(rng, n, d), _centred(rng, m, d)
    ref = np.sqrt(np.asarray(pairwise_sq_dists(jnp.asarray(x),
                                               jnp.asarray(y))))
    ours = pairwise_dists(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert ours.shape == (n, m)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-2)


def test_self_distance_diagonal_is_zero_and_symmetric():
    x = torch.from_numpy(_centred(np.random.default_rng(1), 50, 2000, 3.0))
    d = pairwise_dists(x)
    assert torch.count_nonzero(d.diagonal()) == 0
    torch.testing.assert_close(d, d.T, rtol=1e-5, atol=1e-3)


def test_wrapper_cpu_takes_plain_version_and_counts_nothing():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_centred(rng, 20, 8))
    y = torch.from_numpy(_centred(rng, 3, 8))
    before = build.launch_counts()
    got = pairwise_dists(x, y)
    assert build.launch_counts() == before
    torch.testing.assert_close(got, pairwise_dists_plain(x, y), rtol=0, atol=0)
    with pytest.raises(ValueError):
        pairwise_dists(torch.empty((4, 3), device="meta"))



@pytest.mark.parametrize("n,m,d,sms,blocks,split", [
    (1024, None, 32, 132, 2, False),     # silhouette on the main path
    (1024, 6, 32, 132, 2, False),        # Davies-Bouldin, point -> centroid
    (6, None, 32, 132, 2, False),        # centroid -> centroid
    (2924, None, 32, 132, 2, False),     # the full corpus
    (256, None, 82688, 132, 2, True),    # mel-flat width
    (70, None, 20000, 132, 2, True),
    (70, 6, 20000, 132, 2, True),
    (256, None, 82688, 132, 4, True),
    (45, None, 4099, 132, 2, True),
    (300, None, 1500, 132, 2, False),    # too narrow to split
])
def test_split_k_rule(n, m, d, sms, blocks, split):
    """Kernel 2's split-K rule: the slices cover [0, d) exactly, none is
    empty, all but the last are CHUNK-aligned and at least SPLIT_MIN_COLS
    wide, tiles x slices fit one round of resident blocks, and the
    main-path shapes are not split."""
    tiles = dk.n_tiles(n, m or n, m is None)
    bounds = dk.split_k_bounds(tiles, d, sms, blocks)
    assert (len(bounds) > 1) == split
    assert bounds[0][0] == 0 and bounds[-1][1] == d
    for (a, b), (c, _) in zip(bounds, bounds[1:]):
        assert b == c
    assert all(b > a for a, b in bounds)
    if split:
        assert all((b - a) % dk.CHUNK == 0 for a, b in bounds[:-1])
        assert all(b - a >= dk.SPLIT_MIN_COLS for a, b in bounds[:-1])
        assert tiles * len(bounds) <= blocks * sms


def test_tile_counts():
    assert dk.n_tiles(256, 256, True) == 10          # 4 x 4 tiles, i <= j
    assert dk.n_tiles(1024, 1024, True) == 136
    assert dk.n_tiles(1024, 6, False) == 16
    assert dk.n_tiles(37, 37, True) == 1
    assert dk.split_k_bounds(10, 82688, 132, 2)[0] == (0, 3200)
    assert len(dk.split_k_bounds(10, 82688, 132, 2)) == 26
    assert dk.split_k_bounds(1, 0) == [(0, 0)]
