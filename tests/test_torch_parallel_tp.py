"""The port's tensor parallelism (``parallel/mesh.shard_params``, the
Megatron-style layers on ``parallel/collectives``) in ``fit(mesh=)``: the
ConvMMVAE with its two giant FC layers sharded over 'model', on 2 ranks
(mesh (1, 2)) and 4 ranks (mesh (2, 2), data and tensor parallel), against
the JAX package, and in bf16 against the port's own single-rank fit.

The ranks are spawned processes (gloo on the CPU, a 60 s process-group
timeout, a join timeout), ``tests/torch_dist_workers``; the JAX side runs
on its 8-virtual-device CPU mesh; see ``tests/test_torch_parallel.py``
for the streams and the tolerances.
"""
import numpy as np
import pytest
import torch

from tests.torch_dist_workers import build_model, run_jobs, run_ranks
from tests.torch_parallel_cases import (CONV, assert_history, bf16_conv_job,
                                        cols, conv_case, np_tree,
                                        assert_same_on_every_rank)
from vae_hmc_tpu_torch.models.convert import conv_mm_vae_flax_params
from vae_hmc_tpu_torch.models.train import fit


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread in this module's tests, as the ranks run (the same
    GEMM blocking), and the caller's count again after them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Refs:
    """The JAX references and the ranks' results, computed once."""

    def __init__(self, tmp):
        (self.conv_ref, self.conv_tp_ref), self.conv_job = conv_case()
        jobs = {2: {"conv": ("fit_job", dict(self.conv_job,
                                             mesh_shape=(1, 2)))},
                4: {"conv": ("fit_job", dict(self.conv_job,
                                             mesh_shape=(2, 2))),
                    "bf16": ("fit_job", dict(bf16_conv_job(self.conv_job),
                                             mesh_shape=(2, 2)))}}
        self.ranks = {w: run_ranks(run_jobs, w, tmp / f"w{w}", jobs[w],
                                   timeout_s=60.0, join_s=150.0)
                      for w in (2, 4)}

    def every_rank(self, world, label):
        return [rank[label] for rank in self.ranks[world]]


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return Refs(tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("world,shape", [(2, (1, 2)), (4, (2, 2))])
def test_conv_tensor_parallel_matches_jax(refs, world, shape):
    """ConvMMVAE with enc_fc and dec_fc2 tensor-sharded over 'model' (each
    rank holds half of the 768 flat features).  Against the JAX package's
    fit at the fit-parity tolerance; the model gathered back on every rank
    converts into the JAX layout (conv_mm_vae_flax_params) and matches the
    JAX weights.  Against the JAX package's dp_fit with
    conv_mm_param_sharding on its (4, 2) mesh: every column within 1e-4 x
    the epoch's total, since that run itself leaves the JAX package's fit
    by 4.9e-5 in the KL column (3% of it; its data-parallel runs without
    the sharding stay within 1e-6)."""
    results = refs.every_rank(world, "conv")
    assert results[0]["shard_shapes"]["enc_fc.weight"] == (32, 384)
    assert results[0]["shard_shapes"]["dec_fc2.weight"] == (384, 256)
    assert results[0]["shard_shapes"]["dec_fc2.bias"] == (384,)
    assert results[0]["shard_shapes"]["enc_fc.bias"] == (32,)
    assert_same_on_every_rank(results)
    got = results[0]["history"]
    assert_history(got, refs.conv_ref.history)
    for g, w in zip(got, refs.conv_tp_ref.history):
        gap = np.abs(cols(g) - cols(w)).max()
        assert gap <= 1e-4 * abs(w["total"]), (g, w, gap)
    model = build_model(("conv", CONV))
    flax = conv_mm_vae_flax_params(
        {k: torch.from_numpy(v) for k, v in results[0]["state"].items()},
        model.enc_hw)
    want = np_tree(refs.conv_ref.params)["params"]
    assert set(flax) == set(want)
    for layer, leaves in want.items():
        assert set(flax[layer]) == set(leaves)
        for k, a in leaves.items():
            assert flax[layer][k].shape == a.shape, (layer, k)
            diff = np.abs(flax[layer][k] - a)
            assert diff.max() <= 2e-3, (layer, k, diff.max())
            assert np.mean(diff <= 2e-5) >= 0.99, (layer, k)


def test_bf16_tensor_parallel_matches_bf16_on_one_rank(refs):
    """bf16 mixed precision, the ConvMMVAE data and tensor parallel on
    (2, 2), against the same bf16 fit on one rank, with the port's own
    streams: every column within 5e-4 x the epoch's total."""
    job = bf16_conv_job(refs.conv_job)
    model = build_model(job["model"])
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in job["state"].items()})
    ref = fit(model, [torch.from_numpy(a) for a in job["arrays"]],
              **job["kw"])
    got = refs.every_rank(4, "bf16")
    assert_same_on_every_rank(got)
    assert [h["epoch"] for h in got[0]["history"]] == [
        h["epoch"] for h in ref.history]
    for g, w in zip(got[0]["history"], ref.history):
        gap = np.abs(cols(g) - cols(w)).max()
        assert gap <= 5e-4 * abs(w["total"]), (g, w, gap)
