"""Port dense models (``DenseVAE`` plain and conditional, ``AE``) and the
trainer's three loss modes against the JAX package.

Flax params initialized by the JAX package go through
``models.convert.linear_state_dict`` into the torch modules.
  - forwards with the same inputs and injected eps agree to atol 1e-5;
  - ``fit`` against the JAX package's own ``fit``: "mean" (easy), "sum"
    with kl_anneal_epochs (hard CVAE) and variational=False (AE).  The
    port gets the permutations and the reparameterization noise that the
    JAX trainer draws from PRNGKey(seed) (its fold_in / permutation
    derivation, reproduced here), so both see the same batches and eps;
    history within rtol 1e-4 over 3 epochs (Adam's f32 roundoff in two
    frameworks), final weights within 2e-5 for 99% of each tensor and one
    step (lr) everywhere;
  - Flax -> torch -> Flax is bit-exact, and the port's checkpoint, read by
    the JAX package's load_checkpoint, reproduces the port's forward within
    atol 1e-5.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_hmc_tpu.core import artifacts as jart
from vae_hmc_tpu.models.ae import AE as FlaxAE
from vae_hmc_tpu.models.dense_vae import DenseVAE as FlaxDenseVAE
from vae_hmc_tpu.models.train import fit as jfit
from vae_hmc_tpu_torch.core import artifacts
from vae_hmc_tpu_torch.core.config import (AeConfig, DenseVaeConfig,
                                           HardVaeConfig)
from vae_hmc_tpu_torch.models import api
from vae_hmc_tpu_torch.models.ae import AE
from vae_hmc_tpu_torch.models.convert import (linear_flax_params,
                                              linear_state_dict)
from vae_hmc_tpu_torch.models.dense_vae import DenseVAE
from vae_hmc_tpu_torch.models.train import fit

torch.manual_seed(0)
torch.set_num_threads(1)

D, H, LAT, C = 24, 32, 6, 5


def _np_params(variables):
    return jax.tree_util.tree_map(np.asarray, variables)["params"]


def _flax_vae(cond_dim=0, seed=0):
    model = FlaxDenseVAE(input_dim=D, hidden_dims=(H, H), latent_dim=LAT,
                         cond_dim=cond_dim)
    args = (jnp.zeros((1, D)), jax.random.PRNGKey(1)) + (
        (jnp.zeros((1, cond_dim)),) if cond_dim else ())
    return model, jax.jit(lambda k: model.init(k, *args))(
        jax.random.PRNGKey(seed))


def _flax_ae(seed=0):
    model = FlaxAE(input_dim=D, hidden_dim=H, latent_dim=LAT)
    return model, jax.jit(lambda k: model.init(k, jnp.zeros((1, D))))(
        jax.random.PRNGKey(seed))


def _torch_vae(variables, cond_dim=0):
    m = DenseVAE(D, (H, H), LAT, cond_dim)
    m.load_state_dict(linear_state_dict(_np_params(variables)))
    return m


def _torch_ae(variables):
    m = AE(D, H, LAT)
    m.load_state_dict(linear_state_dict(_np_params(variables)))
    return m


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    c = np.eye(C, dtype=np.float32)[rng.integers(0, C, n)]
    return x, c


@pytest.mark.parametrize("cond_dim", [0, C])
def test_dense_vae_forward_matches_flax(cond_dim):
    fmodel, variables = _flax_vae(cond_dim)
    tmodel = _torch_vae(variables, cond_dim)
    x, c = _data(7, seed=cond_dim)
    eps = np.random.default_rng(9).standard_normal((7, LAT)).astype(np.float32)
    cargs = (c[:, :cond_dim],) if cond_dim else ()
    mu, lv = fmodel.apply(variables, x, *cargs, method=fmodel.encode)
    xhat = fmodel.apply(variables, mu + eps * jnp.exp(0.5 * lv), *cargs,
                        method=fmodel.decode)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x),
                     *(torch.from_numpy(a) for a in cargs),
                     eps=torch.from_numpy(eps))
    for g, w in zip(got, (xhat, mu, lv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    assert [n for n, _ in tmodel.named_children()] == (
        ["enc1", "enc2", "mu", "logvar", "dec1", "dec2", "out"])


def test_ae_forward_matches_flax():
    fmodel, variables = _flax_ae()
    tmodel = _torch_ae(variables)
    x, _ = _data(9)
    xhat, z = fmodel.apply(variables, x)
    with torch.no_grad():
        txhat, tz = tmodel(torch.from_numpy(x))
    np.testing.assert_allclose(txhat.numpy(), np.asarray(xhat), atol=1e-5)
    np.testing.assert_allclose(tz.numpy(), np.asarray(z), atol=1e-5)


def _jax_streams(seed, n, batch_size, epochs):
    """The permutations and per-step keys of the JAX package's fused
    trainer (vae_hmc_tpu/models/train.py train_all: fold_in(root, epoch),
    then fold_in(epoch_key, perm_tag) for the shuffle and
    fold_in(epoch_key, step) for the step's rng)."""
    root = jax.random.PRNGKey(seed)
    n_full = n // batch_size
    perm_tag = max(7919, n_full + 1)
    perms, step_keys = [], []
    for e in range(epochs):
        ekey = jax.random.fold_in(root, e)
        perms.append(np.array(jax.random.permutation(
            jax.random.fold_in(ekey, perm_tag), n)))
        step_keys.append(ekey)
    return perms, step_keys


def _eps_fn(step_keys, perms, batch_size):
    """eps of DenseVAE's reparameterize: normal(fold_in(ekey, i), mu.shape)."""
    def eps(epoch, i):
        rows = len(perms[epoch][i * batch_size:(i + 1) * batch_size])
        key = jax.random.fold_in(step_keys[epoch], i)
        return torch.from_numpy(np.array(
            jax.random.normal(key, (rows, LAT), jnp.float32)))
    return eps


def _assert_weights_close(tmodel, flax_params, lr):
    mapped = linear_state_dict(_np_params(flax_params))
    for name, t in tmodel.state_dict().items():
        diff = np.abs(t.numpy() - mapped[name].numpy())
        assert diff.max() <= lr, (name, diff.max())
        assert np.mean(diff <= 2e-5) >= 0.99, (name, np.mean(diff <= 2e-5))


@pytest.mark.parametrize("mode", ["easy_mean", "hard_sum_cvae_anneal",
                                  "ae_mse"])
def test_fit_matches_jax_fit(mode):
    n, bs, epochs, lr, seed = 50, 16, 3, 1e-3, 5
    x, c = _data(n, seed=1)
    perms, step_keys = _jax_streams(seed, n, bs, epochs)
    if mode == "ae_mse":
        fmodel, variables = _flax_ae(seed=2)
        tmodel = _torch_ae(variables)
        ref = jfit(lambda p, rng, xb: (fmodel.apply(p, xb)[0],), variables,
                   (jnp.asarray(x),), epochs=epochs, batch_size=bs,
                   learning_rate=lr, seed=seed, variational=False)
        res = fit(tmodel, (torch.from_numpy(x),), epochs=epochs,
                  batch_size=bs, learning_rate=lr, seed=seed,
                  variational=False, perms=perms)
        assert all(h["kl"] == 0.0 for h in res.history)
    else:
        cond = mode == "hard_sum_cvae_anneal"
        kw = (dict(beta=4.0, reduction="sum", kl_anneal_epochs=2) if cond
              else dict(beta=1.0, reduction="mean"))
        fmodel, variables = _flax_vae(C if cond else 0, seed=3)
        tmodel = _torch_vae(variables, C if cond else 0)
        arrays = (x, c) if cond else (x,)
        if cond:
            def apply_fn(p, rng, xb, cb):
                return fmodel.apply(p, xb, rng, cb)
        else:
            def apply_fn(p, rng, xb):
                return fmodel.apply(p, xb, rng)
        ref = jfit(apply_fn, variables, tuple(jnp.asarray(a) for a in arrays),
                   epochs=epochs, batch_size=bs, learning_rate=lr, seed=seed,
                   **kw)
        res = fit(tmodel, [torch.from_numpy(a) for a in arrays],
                  epochs=epochs, batch_size=bs, learning_rate=lr, seed=seed,
                  perms=perms, eps_fn=_eps_fn(step_keys, perms, bs), **kw)
    for got, want in zip(res.history, ref.history):
        assert got["epoch"] == want["epoch"]
        np.testing.assert_allclose(
            [got[k] for k in ("total", "recon", "kl")],
            [want[k] for k in ("total", "recon", "kl")], rtol=1e-4,
            atol=1e-7)
    _assert_weights_close(tmodel, ref.params, lr)


def test_train_entry_points_seeded_and_hooked():
    """train_dense_vae / train_hard_vae / train_ae: seeded init leaves the
    global RNG alone and repeats; the latents have the model's width; the
    CVAE takes its condition only with use_cvae."""
    x, c = _data(40, seed=4)
    ecfg = DenseVaeConfig(input_dim=D, hidden_dims=(H, H), latent_dim=LAT,
                          epochs=2, batch_size=16)
    state = torch.random.get_rng_state()
    m1, h1, mu1 = api.train_dense_vae(x, ecfg, device="cpu",
                                      perms=[np.arange(40)] * 2,
                                      eps_fn=lambda e, i: torch.zeros(
                                          (16 if i < 2 else 8, LAT)))
    assert torch.equal(state, torch.random.get_rng_state())
    m2, h2, mu2 = api.train_dense_vae(x, ecfg, device="cpu",
                                      perms=[np.arange(40)] * 2,
                                      eps_fn=lambda e, i: torch.zeros(
                                          (16 if i < 2 else 8, LAT)))
    assert h1 == h2 and torch.equal(mu1, mu2) and mu1.shape == (40, LAT)
    hcfg = HardVaeConfig(hidden_dim=H, latent_dim=LAT, epochs=2,
                         batch_size=16, use_cvae=True, cond_genre=True)
    model, hist, mu = api.train_hard_vae(x, hcfg, cond=c, device="cpu")
    assert model.cond_dim == C and mu.shape == (40, LAT) and len(hist) == 2
    plain = HardVaeConfig(hidden_dim=H, latent_dim=LAT, epochs=1,
                          batch_size=16)
    model, _, _ = api.train_hard_vae(x, plain, cond=c, device="cpu")
    assert model.cond_dim == 0
    model, hist, z = api.train_ae(x, AeConfig(hidden_dim=H, latent_dim=LAT,
                                              epochs=2, batch_size=16),
                                  device="cpu")
    assert z.shape == (40, LAT) and hist[-1]["kl"] == 0.0
    assert hist[-1]["total"] == hist[-1]["recon"]


@pytest.mark.parametrize("kind", ["vae", "cvae", "ae"])
def test_flax_params_round_trip_bit_exact(kind):
    _, variables = (_flax_ae(seed=6) if kind == "ae"
                    else _flax_vae(C if kind == "cvae" else 0, seed=6))
    ref = _np_params(variables)
    back = linear_flax_params(linear_state_dict(ref))
    assert set(back) == set(ref)
    for layer, leaves in ref.items():
        assert set(back[layer]) == set(leaves)
        for k, a in leaves.items():
            assert back[layer][k].dtype == a.dtype == np.float32
            np.testing.assert_array_equal(back[layer][k], a,
                                          err_msg=f"{layer}/{k}")


@pytest.mark.parametrize("cond_dim", [0, C])
def test_checkpoint_loads_into_the_jax_package(tmp_path, cond_dim):
    """The port's checkpoint (save_checkpoint of linear_flax_params) read
    by the JAX package's load_checkpoint: the Flax model reproduces the
    port's forward; the port's own reader gives the weights back bit for
    bit."""
    tmodel = DenseVAE(D, (H, H), LAT, cond_dim)
    path = tmp_path / "vae.pt"
    artifacts.save_checkpoint(
        path, {"params": linear_flax_params(tmodel.state_dict())},
        metadata={"cond_dim": cond_dim}, tag="t1")
    assert (tmp_path / "vae_t1.pt").exists()
    fmodel, like = _flax_vae(cond_dim, seed=8)
    params, meta = jart.load_checkpoint(path, like=like)
    assert meta == json.loads(json.dumps({"cond_dim": cond_dim}))
    x, c = _data(5, seed=3)
    eps = np.random.default_rng(2).standard_normal((5, LAT)).astype(np.float32)
    cargs = (c[:, :cond_dim],) if cond_dim else ()
    mu, lv = fmodel.apply(params, x, *cargs, method=fmodel.encode)
    xhat = fmodel.apply(params, mu + eps * jnp.exp(0.5 * lv), *cargs,
                        method=fmodel.decode)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x),
                     *(torch.from_numpy(a) for a in cargs),
                     eps=torch.from_numpy(eps))
    for g, w in zip(got, (xhat, mu, lv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    loaded, _ = artifacts.load_checkpoint(
        path, like={"params": linear_flax_params(tmodel.state_dict())})
    fresh = DenseVAE(D, (H, H), LAT, cond_dim)
    fresh.load_state_dict(linear_state_dict(loaded["params"]))
    for k, v in tmodel.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
