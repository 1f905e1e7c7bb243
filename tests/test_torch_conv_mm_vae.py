"""Port ConvMMVAE against the Flax model, with weights carried across.

Flax params initialized by the JAX package go through
``vae_hmc_tpu_torch.models.convert`` into the torch module; both then see
the same inputs and the same injected reparameterization noise (numpy,
from a seed).  Forward outputs agree to atol 1e-5, gradients (mapped back
through the same conversion, a pure permutation) to rtol 1e-4, and a
3-step Adam trajectory with injected permutations follows the Flax model
trained with optax.adam.  Shapes: n_mels=32, T=65, full channel widths.
``train_conv_mm_vae``'s float32 fit and export in one process run with
cuDNN's measured engine choice on unless the caller set deterministic
cuDNN; bf16 and a mesh keep the heuristic pick; every flag is restored.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_hmc_tpu.core.config import ConvMMVaeConfig as JConvMMVaeConfig
from vae_hmc_tpu.models.conv_mm_vae import ConvMMVAE as FlaxConvMMVAE
from vae_hmc_tpu.models.losses import elbo_loss as jelbo
from vae_hmc_tpu_torch.core.config import ConvMMVaeConfig
from vae_hmc_tpu_torch.core.device import TIMED_ENGINES
from vae_hmc_tpu_torch.models.api import (build_conv_mm_vae,
                                          train_conv_mm_vae)
from vae_hmc_tpu_torch.models.conv_mm_vae import ConvMMVAE
from vae_hmc_tpu_torch.models.convert import (conv_mm_vae_flax_params,
                                              conv_mm_vae_state_dict)
from vae_hmc_tpu_torch.models.losses import elbo_loss
from vae_hmc_tpu_torch.parallel.mesh import make_mesh

torch.manual_seed(0)
torch.set_num_threads(1)

H, W, LYR, LAT = 32, 65, 384, 32


def _flax_model_and_params(seed=0):
    model = FlaxConvMMVAE(n_mels=H, n_frames=W, latent_dim=LAT,
                          lyrics_dim=LYR)
    # jitted: an eager Flax init compiles op by op (~9 s on the CPU)
    params = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, H, W, 1)), jnp.zeros((1, LYR)), jnp.zeros((1, 1)),
        jax.random.PRNGKey(1)))(jax.random.PRNGKey(seed))
    return model, params


def _np_params(params):
    return jax.tree_util.tree_map(np.asarray, params)["params"]


def _torch_model(params) -> ConvMMVAE:
    model = ConvMMVAE(n_mels=H, n_frames=W, latent_dim=LAT, lyrics_dim=LYR)
    model.load_state_dict(conv_mm_vae_state_dict(_np_params(params),
                                                 model.enc_hw))
    return model


def _inputs(rng, b):
    x = rng.standard_normal((b, H, W, 1)).astype(np.float32)
    lyr = rng.standard_normal((b, LYR)).astype(np.float32)
    m = (rng.random((b, 1)) < 0.7).astype(np.float32)
    eps = rng.standard_normal((b, LAT)).astype(np.float32)
    return x, lyr, m, eps


def _flax_forward(model, p, x, lyr, m, eps):
    mu, lv = model.apply(p, x, lyr, m, method=model.encode)
    z = mu + eps * jnp.exp(0.5 * lv)
    return model.apply(p, z, method=model.decode), mu, lv


def test_shapes_and_full_width_flatten():
    m = ConvMMVAE()
    assert m.enc_hw == (16, 81)
    assert m.enc_fc.in_features == 16 * 81 * 128 == 165888
    assert m.dec_fc2.out_features == 165888
    assert ConvMMVAE(n_mels=H, n_frames=W).enc_hw == FlaxConvMMVAE(
        n_mels=H, n_frames=W).enc_hw


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_forward_loss_grads_match_flax(reduction):
    fmodel, params = _flax_model_and_params()
    tmodel = _torch_model(params)
    x, lyr, m, eps = _inputs(np.random.default_rng(1), 4)

    xhat_t, mu_t, lv_t = tmodel(*map(torch.from_numpy, (x, lyr, m)),
                                eps=torch.from_numpy(eps))
    loss_t, aux_t = elbo_loss(xhat_t, torch.from_numpy(x), mu_t, lv_t, 1.0,
                              reduction)
    loss_t.backward()

    def loss_fn(p):
        out = _flax_forward(fmodel, p, x, lyr, m, eps)
        loss, aux = jelbo(out[0], jnp.asarray(x), *out[1:], 1.0, reduction)
        return loss, (aux, out)

    # jitted: eager JAX compiles op by op, seconds on the CPU
    (_, (aux_j, (xhat_j, mu_j, lv_j))), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    for ours, ref in ((xhat_t, xhat_j), (mu_t, mu_j), (lv_t, lv_j)):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=1e-5)
    for k in ("total", "recon", "kl"):
        np.testing.assert_allclose(aux_t[k].item(), float(aux_j[k]),
                                   rtol=1e-5, err_msg=k)
    mapped = conv_mm_vae_state_dict(_np_params(grads), tmodel.enc_hw)
    for name, p in tmodel.named_parameters():
        # logvar_a is unused by the fused forward (reference 12:174): torch
        # leaves its grad None, JAX returns zeros
        g = (np.zeros(p.shape, np.float32) if p.grad is None
             else p.grad.numpy())
        ref = mapped[name].numpy()
        np.testing.assert_allclose(g, ref, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(ref).max(), 1e-6),
                                   err_msg=name)


def test_three_step_adam_trajectory_matches_optax():
    """1 epoch over 10 rows at batch 4: two full steps and a remainder step
    of 2 rows, with injected permutation and noise; the history weighs the
    remainder by its 2 rows, and the exported mu follows the final params."""
    fmodel, params = _flax_model_and_params(seed=3)
    tmodel = _torch_model(params)
    rng = np.random.default_rng(4)
    n, bs, lr = 10, 4, 2e-3
    x, lyr, m, _ = _inputs(rng, n)
    perm = rng.permutation(n)
    eps_steps = [rng.standard_normal((len(perm[s:s + bs]), LAT))
                 .astype(np.float32) for s in range(0, n, bs)]

    cfg = dataclasses.replace(ConvMMVaeConfig(in_mels=H, in_frames=W),
                              epochs=1, batch_size=bs, learning_rate=lr)
    _, history, mu = train_conv_mm_vae(
        x, lyr, m[:, 0], cfg, device="cpu", model=tmodel, perms=[perm],
        eps_fn=lambda e, i: torch.from_numpy(eps_steps[i]))

    tx = optax.adam(lr)
    opt_state = jax.jit(tx.init)(params)
    p = params

    @jax.jit
    def step(q, opt_state, xb, lb, mb, eb):
        def loss_fn(q):
            xhat, mu_, lv = _flax_forward(fmodel, q, xb, lb, mb, eb)
            return jelbo(xhat, xb, mu_, lv, 1.0, "mean")
        (_, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(q)
        updates, opt_state = tx.update(g, opt_state, q)
        return optax.apply_updates(q, updates), opt_state, aux

    totals = np.zeros(3)
    for i, s in enumerate(range(0, n, bs)):
        idx = perm[s:s + bs]
        p, opt_state, aux = step(p, opt_state, x[idx], lyr[idx], m[idx],
                                 eps_steps[i])
        totals += np.asarray([aux["total"], aux["recon"], aux["kl"]]) * len(idx)
    ref_hist = totals / n
    np.testing.assert_allclose(
        [history[0][k] for k in ("total", "recon", "kl")], ref_hist,
        rtol=1e-4)
    mu_j, _ = jax.jit(lambda q: fmodel.apply(q, x, lyr, m,
                                             method=fmodel.encode))(p)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), rtol=1e-4,
                               atol=1e-4)
    # Adam moves each weight by ~lr a step whatever the gradient's size, so
    # where a gradient is ~0 the two frameworks' f32 roundoff can change the
    # step.  Bound: no weight more than one step (lr) apart, and 99% of each
    # tensor within 2e-5 (1% of a step).
    mapped = conv_mm_vae_state_dict(_np_params(p), tmodel.enc_hw)
    for name, t in tmodel.state_dict().items():
        diff = np.abs(t.numpy() - mapped[name].numpy())
        assert diff.max() <= lr, (name, diff.max())
        assert np.mean(diff <= 2e-5) >= 0.99, (name, np.mean(diff <= 2e-5))


@pytest.mark.parametrize("shape", [(H, W), (128, 646)])
def test_flax_params_round_trip_bit_exact(shape):
    """Flax -> torch -> Flax (the checkpoint writer's direction) gives back
    every array bit for bit, in the Flax layout, also at full width."""
    h, w = shape
    model = FlaxConvMMVAE(n_mels=h, n_frames=w, latent_dim=LAT,
                          lyrics_dim=LYR)
    params = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, h, w, 1)), jnp.zeros((1, LYR)), jnp.zeros((1, 1)),
        k))(jax.random.PRNGKey(5))
    ref = _np_params(params)
    back = conv_mm_vae_flax_params(
        conv_mm_vae_state_dict(ref, model.enc_hw), model.enc_hw)
    assert set(back) == set(ref)
    for layer, leaves in ref.items():
        assert set(back[layer]) == set(leaves)
        for k, a in leaves.items():
            assert back[layer][k].dtype == a.dtype == np.float32
            np.testing.assert_array_equal(back[layer][k], a,
                                          err_msg=f"{layer}/{k}")


def test_config_copy_and_seeded_init():
    assert dataclasses.asdict(ConvMMVaeConfig()) == dataclasses.asdict(
        JConvMMVaeConfig())
    a = build_conv_mm_vae(ConvMMVaeConfig(), H, W, LYR).state_dict()
    state = torch.random.get_rng_state()
    b = build_conv_mm_vae(ConvMMVaeConfig(), H, W, LYR).state_dict()
    assert torch.equal(state, torch.random.get_rng_state())
    for k in a:
        assert torch.equal(a[k], b[k]), k


_CUDNN_FLAGS = ("benchmark", "benchmark_limit", "deterministic", "allow_tf32")


def _cudnn_flags():
    return {k: getattr(torch.backends.cudnn, k) for k in _CUDNN_FLAGS}


def _flag_recording_fit(eps_fn=None, compute_dtype="float32", mesh=None):
    """A tiny train_conv_mm_vae on the CPU (12 rows: steps of 8 and 4, an
    export batch) with a pre-hook on the first conv, which the fit
    (training mode) and the export (eval mode) both run: -> [(training,
    cuDNN flags at that call)]."""
    cfg = ConvMMVaeConfig(audio_channels=(4, 8, 8), audio_fc_dim=16,
                          latent_dim=4, epochs=2, batch_size=8,
                          compute_dtype=compute_dtype)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((12, 16, 20, 1)).astype(np.float32)
    lyr = rng.standard_normal((12, 8)).astype(np.float32)
    m = (rng.random(12) < 0.7).astype(np.float32)
    model = build_conv_mm_vae(cfg, 16, 20, 8)
    seen = []
    model.enc_convs[0].register_forward_pre_hook(
        lambda mod, args: seen.append((mod.training, _cudnn_flags())))
    train_conv_mm_vae(x, lyr, m, cfg, device="cpu", model=model,
                      eps_fn=eps_fn, mesh=mesh)
    return seen


@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("benchmark", [False, True])
def test_conv_fit_measures_cudnn_engines_in_a_scope(monkeypatch, benchmark,
                                                    deterministic):
    """A float32 fit and its export in one process run with cuDNN's
    measured engine choice on (its leading candidates timed) and TF32 as
    the caller set it; a caller who set deterministic cuDNN keeps the
    heuristic pick, every flag as it was.  On return every flag is the
    caller's again."""
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", benchmark)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", deterministic)
    caller = _cudnn_flags()
    seen = _flag_recording_fit()
    assert {training for training, _ in seen} == {True, False}
    inside = (caller if deterministic else
              dict(caller, benchmark=True, benchmark_limit=TIMED_ENGINES))
    assert all(flags == inside for _, flags in seen)
    assert _cudnn_flags() == caller


@pytest.mark.parametrize("traffic", ["bfloat16", "mesh"])
def test_conv_fit_keeps_the_heuristic_pick_off_its_measured_traffic(
        monkeypatch, traffic):
    """A bf16 fit, and a fit on a mesh (one rank here), run fit and export
    on cuDNN's heuristic pick: every flag inside is the caller's."""
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    caller = _cudnn_flags()
    seen = (_flag_recording_fit(compute_dtype="bfloat16")
            if traffic == "bfloat16"
            else _flag_recording_fit(mesh=make_mesh(device="cpu")))
    assert {training for training, _ in seen} == {True, False}
    assert all(flags == caller for _, flags in seen)
    assert _cudnn_flags() == caller


def test_conv_fit_restores_cudnn_flags_when_it_raises(monkeypatch):
    class Stop(Exception):
        pass

    def eps_fn(epoch, step):
        if (epoch, step) == (0, 1):
            raise Stop
        return torch.zeros(8, 4)

    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    caller = _cudnn_flags()
    with pytest.raises(Stop):
        _flag_recording_fit(eps_fn)
    assert _cudnn_flags() == caller
