"""The port's parallel path (``parallel/{mesh,train_dp,collectives}``,
``fit(mesh=)``) against the JAX package and against itself.

The port runs one process per rank under ``torch.distributed`` (gloo on
the CPU): ``tests/torch_dist_workers.run_ranks`` spawns 2 and then 4 ranks
once each, runs every case of the file in them (a 60 s process-group
timeout, a join timeout), and the tests read their results.  The JAX side
runs on its 8-virtual-device CPU mesh.  Both packages start from the same
weights (Flax -> ``models/convert``) and the port gets the JAX trainer's
permutations and reparameterization noise (fold_in(root, epoch), then
fold_in(epoch_key, perm_tag) and fold_in(epoch_key, step)), the whole
batch's, of which each rank takes its rows'.

Tolerances: histories against the JAX package within rtol 1e-4 (atol
1e-7) and weights within 2e-5 for 99% of each tensor and one step (lr)
everywhere, as ``tests/test_torch_dense_models.py``; the port on a mesh
against its own single-device ``fit``: 1e-6 (float32, reduction order
only) and, in bf16, 5e-4 x the epoch's total in every column, as
``tests/test_torch_fit_options.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import adjusted_rand_score

from tests.torch_dist_workers import build_model, run_jobs, run_ranks
from tests.torch_parallel_cases import (assert_history, assert_weights,
                                        cols, np_tree, assert_same_on_every_rank,
                                        jax_streams)
from vae_hmc_tpu.models.ae import AE as FlaxAE
from vae_hmc_tpu.models.dense_vae import DenseVAE as FlaxDenseVAE
from vae_hmc_tpu.models.train import fit as jfit
from vae_hmc_tpu_torch.cluster.kmeans import kmeans
from vae_hmc_tpu_torch.core.config import KMeansConfig
from vae_hmc_tpu_torch.models.convert import linear_state_dict
from vae_hmc_tpu_torch.models.train import fit
from vae_hmc_tpu_torch.parallel.mesh import make_mesh
from vae_hmc_tpu_torch.parallel.multihost import ShardedRows
from vae_hmc_tpu_torch.parallel.train_dp import (dp_fit,
                                                 kmeans_restarts_sharded)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread in this module's tests, as the ranks run (the same
    GEMM blocking), and the caller's count again after them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


D, H, LAT, C = 24, 32, 6, 5
MODES = ("easy_mean", "hard_sum_cvae_anneal", "ae_mse")


def _dense_case(mode, n):
    """One of test_torch_dense_models's fit cases at n rows: the Flax
    model's variables, the JAX fit, and the port's job."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, D)).astype(np.float32)
    c = np.eye(C, dtype=np.float32)[rng.integers(0, C, n)]
    kw = dict(epochs=3, batch_size=16, learning_rate=1e-3, seed=5)
    if mode == "ae_mse":
        fmodel = FlaxAE(input_dim=D, hidden_dim=H, latent_dim=LAT)
        variables = jax.jit(lambda k: fmodel.init(k, jnp.zeros((1, D))))(
            jax.random.PRNGKey(2))
        ref = jfit(lambda p, r, xb: (fmodel.apply(p, xb)[0],), variables,
                   (jnp.asarray(x),), variational=False, **kw)
        arrays, spec, kw = [x], ("ae", (D, H, LAT)), {**kw,
                                                      "variational": False}
    else:
        cond = mode == "hard_sum_cvae_anneal"
        cd = C if cond else 0
        fmodel = FlaxDenseVAE(input_dim=D, hidden_dims=(H, H),
                              latent_dim=LAT, cond_dim=cd)
        args = (jnp.zeros((1, D)), jax.random.PRNGKey(1)) + (
            (jnp.zeros((1, cd)),) if cond else ())
        variables = jax.jit(lambda k: fmodel.init(k, *args))(
            jax.random.PRNGKey(3))
        if cond:
            kw = {**kw, "beta": 4.0, "reduction": "sum", "kl_anneal_epochs": 2}
        arrays = [x, c] if cond else [x]

        def apply_fn(p, r, *b):
            return fmodel.apply(p, b[0], r, *b[1:])
        ref = jfit(apply_fn, variables, tuple(jnp.asarray(a) for a in arrays),
                   **kw)
        spec = ("dense", (D, (H, H), LAT, cd))
    perms, eps = jax_streams(kw["seed"], n, kw["batch_size"], kw["epochs"], LAT)
    state = {k: v.numpy() for k, v in linear_state_dict(
        np_tree(variables)["params"]).items()}
    job = dict(model=spec, state=state, arrays=arrays, kw=kw, perms=perms,
               eps=None if mode == "ae_mse" else eps)
    return ref, job


def _bf16_dense_job():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((50, 24)).astype(np.float32)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        model = build_model(("dense", (24, (32, 32), 6, 0)))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    return dict(model=("dense", (24, (32, 32), 6, 0)), state=state,
                arrays=[x], kw=dict(epochs=3, batch_size=16,
                                    learning_rate=1e-3, seed=5,
                                    compute_dtype="bfloat16"))


def _blobs():
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 5, (4, 8))
    y = rng.integers(0, 4, 300)
    return (centers[y] + rng.normal(0, 0.6, (300, 8))).astype(np.float32), y


class Refs:
    """The JAX references and the ranks' results, computed once."""

    def __init__(self, tmp):
        self.dense = {m: _dense_case(m, 50) for m in MODES}
        self.uneven = _dense_case("easy_mean", 45)
        self.blobs, self.truth = _blobs()
        ident = dict(self.uneven[1], perms=[np.arange(45)] * 3)
        self.ident_job = ident
        jobs = {}
        for world in (2, 4):
            jobs[world] = {m: ("fit_job", dict(self.dense[m][1],
                                               mesh_shape=(world, 1)))
                           for m in MODES}
            jobs[world]["kmeans"] = ("kmeans_job", dict(
                x=self.blobs, k=4, n_init=16, seed=0))
        jobs[2]["bf16"] = ("fit_job", dict(_bf16_dense_job(),
                                           mesh_shape=(2, 1)))
        jobs[4].update(
            uneven=("fit_job", dict(self.uneven[1], mesh_shape=(4, 1),
                                    sharded_input=True)),
            ident=("fit_job", dict(ident, mesh_shape=(4, 1))),
            kmeans10=("kmeans_job", dict(x=self.blobs, k=4, n_init=10,
                                         seed=0)))
        self.ranks = {w: run_ranks(run_jobs, w, tmp / f"w{w}", jobs[w],
                                   timeout_s=60.0, join_s=150.0)
                      for w in (2, 4)}

    def every_rank(self, world, label):
        return [rank[label] for rank in self.ranks[world]]

@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return Refs(tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_dp_fit_matches_jax_fit(refs, world, mode):
    ref, _ = refs.dense[mode]
    results = refs.every_rank(world, mode)
    assert_same_on_every_rank(results)
    assert_history(results[0]["history"], ref.history)
    assert_weights(results[0]["state"],
                    {k: v.numpy() for k, v in linear_state_dict(
                        np_tree(ref.params)["params"]).items()}, 1e-3)


def test_dp_fit_uneven_shards_and_remainder_match_jax(refs):
    """45 rows at batch 16 over 4 ranks: shards of 12, 12, 12 and 9 rows,
    a remainder batch of 13, rows staged per rank (ShardedRows)."""
    ref, _ = refs.uneven
    results = refs.every_rank(4, "uneven")
    assert [r["rows"] for r in results] == [(0, 12), (12, 24), (24, 36),
                                            (36, 45)]
    assert_same_on_every_rank(results)
    assert_history(results[0]["history"], ref.history)
    assert_weights(results[0]["state"],
                    {k: v.numpy() for k, v in linear_state_dict(
                        np_tree(ref.params)["params"]).items()}, 1e-3)


def test_rank_without_rows_in_a_batch_matches_fit(refs):
    """In order (the identity permutation), batch 0 holds rows 0-15 and
    the remainder batch rows 32-44: ranks 2-3, then 0-1, own none of them
    and enter the gradient all-reduce with zeros.  The 4-rank history and
    weights equal the single-device fit's within 1e-6."""
    job = refs.ident_job
    model = build_model(job["model"])
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in job["state"].items()})
    res = fit(model, [torch.from_numpy(a) for a in job["arrays"]],
              perms=job["perms"],
              eps_fn=lambda e, i: torch.from_numpy(job["eps"][e][i]),
              **job["kw"])
    got = refs.every_rank(4, "ident")[0]
    assert_history(got["history"], res.history, rtol=1e-6, atol=1e-7)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(got["state"][k], v.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_bf16_on_two_ranks_matches_bf16_on_one_rank(refs):
    """bf16 mixed precision, the dense VAE data parallel on 2 ranks,
    against the same bf16 fit on one rank, with the port's own streams:
    every column within 5e-4 x the epoch's total."""
    world, job = 2, _bf16_dense_job()
    model = build_model(job["model"])
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in job["state"].items()})
    ref = fit(model, [torch.from_numpy(a) for a in job["arrays"]],
              **job["kw"])
    got = refs.every_rank(world, "bf16")[0]["history"]
    assert [h["epoch"] for h in got] == [h["epoch"] for h in ref.history]
    for g, w in zip(got, ref.history):
        gap = np.abs(cols(g) - cols(w)).max()
        assert gap <= 5e-4 * abs(w["total"]), (g, w, gap)


def test_kmeans_restarts_sharded_same_on_1_2_4_ranks(refs):
    """16 restarts (a multiple of 1, 2 and 4) give the same labels,
    centres and inertia on 1, 2 and 4 ranks; ARI > 0.95 against the blobs
    and inertia <= 1.05 x kmeans's, as tests/test_parallel.py asks of the
    JAX package."""
    one = kmeans_restarts_sharded(refs.blobs, 4, 16, make_mesh(device="cpu"),
                                  seed=0)
    for world in (2, 4):
        for got in refs.every_rank(world, "kmeans"):
            np.testing.assert_array_equal(got["labels"], one[0])
            np.testing.assert_array_equal(got["centers"], one[1])
            assert got["inertia"] == one[2]
    ref = kmeans(refs.blobs, KMeansConfig(n_clusters=4, n_init=16, seed=0),
                 device="cpu")
    assert adjusted_rand_score(one[0], refs.truth) > 0.95
    assert one[2] <= ref.inertia * 1.05


def test_kmeans_restarts_padded_to_a_multiple_of_the_world(refs):
    """n_init = 10 on 4 ranks runs 12 restarts, restart r seeded by
    (seed, r) alone: the result of 12 restarts on one rank."""
    one = kmeans_restarts_sharded(refs.blobs, 4, 12, make_mesh(device="cpu"),
                                  seed=0)
    for got in refs.every_rank(4, "kmeans10"):
        np.testing.assert_array_equal(got["labels"], one[0])
        assert got["inertia"] == one[2]


def test_world_size_one_equals_fit(refs):
    """A (1, 1) mesh without a process group runs the mesh path (row
    ownership, partial losses, the gradient all-reduce as identity): the
    same history as fit within 1e-6 and the same weights within 1e-6."""
    job = refs.dense["hard_sum_cvae_anneal"][1]
    out = []
    for mesh in (None, make_mesh(device="cpu")):
        model = build_model(job["model"])
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in job["state"].items()})
        res = fit(model, [torch.from_numpy(a) for a in job["arrays"]],
                  mesh=mesh, perms=job["perms"],
                  eps_fn=lambda e, i: torch.from_numpy(job["eps"][e][i]),
                  **job["kw"])
        out.append((res.history, model.state_dict()))
    assert_history(out[1][0], out[0][0], rtol=1e-6, atol=1e-7)
    for k, v in out[0][1].items():
        np.testing.assert_allclose(out[1][1][k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_fit_on_a_mesh_refuses_checkpoints_and_rows_without_n_rows(tmp_path):
    model = build_model(("dense", (4, (8,), 2, 0)))
    x = torch.zeros((6, 4))
    mesh = make_mesh(device="cpu")
    kw = dict(epochs=1, batch_size=2, learning_rate=1e-3)
    with pytest.raises(ValueError, match="checkpoint"):
        fit(model, (x,), mesh=mesh, checkpoint_dir=str(tmp_path), **kw)
    with pytest.raises(ValueError, match="n_rows"):
        dp_fit(model, (ShardedRows(x, 0, 6, 6),), mesh, **kw)
    with pytest.raises(ValueError, match="mesh"):
        fit(model, (ShardedRows(x, 0, 6, 6),), n_rows=6, **kw)
    with pytest.raises(ValueError, match="range"):
        dp_fit(model, (ShardedRows(x[:3], 0, 3, 6),), mesh, n_rows=6, **kw)


