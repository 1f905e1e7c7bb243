"""JAX-side helpers of the port's parallel tests: the JAX trainer's
streams, the ConvMMVAE case, and the history and weight comparisons.
(The ranks themselves run ``tests/torch_dist_workers``, which is
JAX-free.)"""
import jax
import jax.numpy as jnp
import numpy as np

from tests.torch_dist_workers import build_model
from vae_hmc_tpu.models.conv_mm_vae import ConvMMVAE as FlaxConvMMVAE
from vae_hmc_tpu.models.train import fit as jfit
from vae_hmc_tpu.parallel.mesh import conv_mm_param_sharding as jsharding
from vae_hmc_tpu.parallel.mesh import make_mesh as jmake_mesh
from vae_hmc_tpu.parallel.train_dp import dp_fit as jdp_fit
from vae_hmc_tpu_torch.models.convert import conv_mm_vae_state_dict

CONV = dict(n_mels=16, n_frames=24, latent_dim=8, fc_dim=32)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_streams(seed, n, bs, epochs, lat):
    """The JAX fused trainer's permutations and each step's whole-batch
    noise (normal(fold_in(epoch_key, step), (rows, latent)))."""
    root = jax.random.PRNGKey(seed)
    perm_tag = max(7919, n // bs + 1)
    perms, eps = [], []
    for e in range(epochs):
        ekey = jax.random.fold_in(root, e)
        perm = np.array(jax.random.permutation(
            jax.random.fold_in(ekey, perm_tag), n))
        perms.append(perm)
        eps.append([np.array(jax.random.normal(
            jax.random.fold_in(ekey, i),
            (len(perm[i * bs:(i + 1) * bs]), lat), jnp.float32))
            for i in range(-(-n // bs))])
    return perms, eps


def conv_case():
    """ConvMMVAE at (16, 24) mel, FC 32, 22 rows at batch 8 (a remainder
    of 6): the JAX package's fit, its dp_fit with conv_mm_param_sharding
    on its (4, 2) mesh, and the port's job."""
    rng = np.random.default_rng(4)
    n = 22
    x = rng.normal(0, 1, (n, 16, 24, 1)).astype(np.float32)
    lyr = rng.normal(0, 1, (n, 384)).astype(np.float32)
    m = (rng.random((n, 1)) < 0.7).astype(np.float32)
    fmodel = FlaxConvMMVAE(**CONV)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(fmodel.init)(key, x[:1], lyr[:1], m[:1], key)
    kw = dict(epochs=2, batch_size=8, learning_rate=2e-3, seed=0)
    mesh = jmake_mesh(8)
    arrays = (jnp.asarray(x), jnp.asarray(lyr), jnp.asarray(m))
    ref = jfit(lambda p, r, *b: fmodel.apply(p, *b, r), variables, arrays,
               **kw)
    ref_tp = jdp_fit(lambda p, r, *b: fmodel.apply(p, *b, r), variables,
                     arrays, mesh, param_shardings=jsharding(mesh, variables),
                     **kw)
    perms, eps = jax_streams(0, n, 8, 2, CONV["latent_dim"])
    model = build_model(("conv", CONV))
    state = {k: v.numpy() for k, v in conv_mm_vae_state_dict(
        np_tree(variables)["params"], model.enc_hw).items()}
    return (ref, ref_tp), dict(model=("conv", CONV), state=state,
                               arrays=[x, lyr, m], kw=kw, perms=perms,
                               eps=eps, shard=True)


def bf16_conv_job(conv_job):
    return {**conv_job, "perms": None, "eps": None,
            "kw": {**conv_job["kw"], "compute_dtype": "bfloat16"}}


def cols(h):
    return np.asarray([h["total"], h["recon"], h["kl"]])


def assert_history(got, want, rtol=1e-4, atol=1e-7):
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(cols(g), cols(w), rtol=rtol, atol=atol)


def assert_weights(state, mapped, lr):
    assert set(state) == set(mapped)
    for name, t in state.items():
        diff = np.abs(t - np.asarray(mapped[name]))
        assert diff.max() <= lr, (name, diff.max())
        assert np.mean(diff <= 2e-5) >= 0.99, (name, np.mean(diff <= 2e-5))


def assert_same_on_every_rank(results):
    for r in results[1:]:
        assert r["history"] == results[0]["history"]
        for k, v in r["state"].items():
            np.testing.assert_array_equal(v, results[0]["state"][k], err_msg=k)


