"""The decoder's transposed convs as four output phases
(``models/conv_mm_vae.phase_conv_transpose2d``) against
``F.conv_transpose2d`` on the CPU.

The phase form is a float32-on-CUDA path (``phase_deconv_engages``); here
it is called directly in float64, where it must equal the transposed conv
to rounding, forward and backward, and through the model with the rule
switched on, where the float32 model must match the transposed path.
Without the switch the CPU, in float32 and bf16, runs only the module's
own forward.
"""
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from vae_hmc_tpu_torch.models import conv_mm_vae as cmv
from vae_hmc_tpu_torch.models.conv_mm_vae import (ConvMMVAE,
                                                  phase_conv_transpose2d,
                                                  phase_weight)

# the full ConvMMVAE's decoder: (in, out) channels of its three deconvs
DECONV_CHANNELS = ((128, 64), (64, 32), (32, 1))


def _deconv(cin: int, cout: int, seed: int) -> nn.ConvTranspose2d:
    torch.manual_seed(seed)
    return nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1).double()


@pytest.mark.parametrize("cin,cout", DECONV_CHANNELS)
@pytest.mark.parametrize("h,w", [(4, 6), (5, 7), (6, 9), (1, 3)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_phase_form_equals_conv_transpose2d_float64(cin, cout, h, w,
                                                    with_bias):
    deconv = _deconv(cin, cout, cin + h)
    x = torch.randn(3, cin, h, w, dtype=torch.float64)
    bias = deconv.bias if with_bias else None
    with torch.no_grad():
        want = F.conv_transpose2d(x, deconv.weight, bias, stride=2,
                                  padding=1)
        got = phase_conv_transpose2d(x, deconv.weight, bias)
    assert got.shape == want.shape == (3, cout, 2 * h, 2 * w)
    assert got.is_contiguous()
    assert float((got - want).abs().max()) <= 1e-12


@pytest.mark.parametrize("with_bias", [True, False])
def test_phase_form_reads_a_channels_last_conv_output(with_bias):
    """A channels_last input makes ``conv2d`` return a channels_last output,
    whose width stride is not 1: the interleave reads it by its strides."""
    deconv = _deconv(8, 4, 5)
    x = torch.randn(2, 8, 5, 7, dtype=torch.float64).to(
        memory_format=torch.channels_last)
    bias = deconv.bias if with_bias else None
    with torch.no_grad():
        assert F.conv2d(x, phase_weight(deconv.weight), padding=1).stride(
            3) != 1
        want = F.conv_transpose2d(x, deconv.weight, bias, stride=2,
                                  padding=1)
        got = phase_conv_transpose2d(x, deconv.weight, bias)
    assert float((got - want).abs().max()) <= 1e-12


def test_phase_weight_takes_tap_3_minus_r_minus_2a():
    """Output phase (ry, rx) at window offset (ay, ax) takes tap
    (3 - ry - 2 ay, 3 - rx - 2 ax) of the transposed weight, phases in the
    order (0, 0), (0, 1), (1, 0), (1, 1), output channels inside."""
    cin, cout = 3, 2
    weight = torch.arange(cin * cout * 16, dtype=torch.float64).view(
        cin, cout, 4, 4)
    got = phase_weight(weight)
    assert got.shape == (4 * cout, cin, 2, 2)
    for ry in (0, 1):
        for rx in (0, 1):
            for o in range(cout):
                for c in range(cin):
                    for ay in (0, 1):
                        for ax in (0, 1):
                            assert (got[(2 * ry + rx) * cout + o, c, ay, ax]
                                    == weight[c, o, 3 - ry - 2 * ay,
                                              3 - rx - 2 * ax])


@pytest.mark.parametrize("with_bias", [True, False])
def test_phase_form_gradcheck(with_bias):
    x = torch.randn(2, 3, 3, 4, dtype=torch.float64, requires_grad=True)
    weight = torch.randn(3, 2, 4, 4, dtype=torch.float64, requires_grad=True)
    bias = (torch.randn(2, dtype=torch.float64, requires_grad=True)
            if with_bias else None)
    assert torch.autograd.gradcheck(
        lambda x, weight: phase_conv_transpose2d(x, weight, bias),
        (x, weight))
    if with_bias:
        assert torch.autograd.gradcheck(phase_conv_transpose2d,
                                        (x, weight, bias))


@pytest.mark.parametrize("cin,cout", DECONV_CHANNELS)
@pytest.mark.parametrize("input_grad", [True, False])
def test_phase_form_grads_equal_conv_transpose2d(cin, cout, input_grad):
    """Input, weight and bias gradients through the phase form equal those
    through ``nn.ConvTranspose2d`` (the backward is the same op); without
    an input gradient, only the parameters' are made."""
    deconv = _deconv(cin, cout, cout)
    x0 = torch.randn(2, cin, 5, 6, dtype=torch.float64)
    upstream = torch.randn(2, cout, 10, 12, dtype=torch.float64)
    grads = []
    for fn in (deconv, lambda x: phase_conv_transpose2d(x, deconv.weight,
                                                        deconv.bias)):
        deconv.zero_grad(set_to_none=True)
        x = x0.clone().requires_grad_(input_grad)
        (fn(x) * upstream).sum().backward()
        grads.append((x.grad, deconv.weight.grad, deconv.bias.grad))
    for want, got in zip(*grads):
        if want is None:
            assert got is None
        else:
            assert float((got - want).abs().max()) <= 1e-12


def _model_and_inputs(seed=4):
    torch.manual_seed(seed)
    model = ConvMMVAE(n_mels=32, n_frames=65)
    b = 3
    inputs = (torch.randn(b, 32, 65, 1), torch.randn(b, 384),
              (torch.rand(b, 1) < 0.7).float(), torch.randn(b, 32))
    return model, inputs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_forward_runs_only_the_transposed_path(dtype):
    model, (x, lyr, m, eps) = _model_and_inputs()
    model = model.to(dtype)
    cmv.reset_deconv_paths()
    with torch.no_grad():
        xhat, _, _ = model(x.to(dtype), lyr.to(dtype), m.to(dtype),
                           eps=eps.to(dtype))
    assert xhat.shape == (3, 32, 65, 1) and xhat.dtype == dtype
    assert cmv.deconv_path_counts() == {"phase": 0, "transposed": 3}
    cmv.reset_deconv_paths()
    assert cmv.deconv_path_counts() == {"phase": 0, "transposed": 0}


def test_model_with_the_phase_path_on_matches_transposed(monkeypatch):
    """The float32 model with the rule switched on for the CPU (every deconv
    on the phase form) against the model as it runs here: outputs and every
    gradient within 1e-5 of their norm.  The parameters keep the
    ConvTranspose2d layout."""
    model, (x, lyr, m, eps) = _model_and_inputs()
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    runs = []
    for on in (False, True):
        if on:
            monkeypatch.setattr(cmv, "phase_deconv_engages",
                                lambda h, deconv: True)
        model.zero_grad(set_to_none=True)
        cmv.reset_deconv_paths()
        xhat, mu, logvar = model(x, lyr, m, eps=eps)
        (xhat.square().mean() + mu.sum() + logvar.sum()).backward()
        assert cmv.deconv_path_counts() == (
            {"phase": 3, "transposed": 0} if on
            else {"phase": 0, "transposed": 3})
        runs.append((xhat.detach(), {k: p.grad.clone()
                                     for k, p in model.named_parameters()
                                     if p.grad is not None}))
    (want, want_g), (got, got_g) = runs
    assert float((got - want).norm() / want.norm()) <= 1e-5
    assert set(got_g) == set(want_g)
    assert {f"dec_convs.{i}.weight" for i in range(3)} <= set(got_g)
    for k, g in want_g.items():
        assert float((got_g[k] - g).norm() / g.norm()) <= 1e-5, k
    assert all(isinstance(d, nn.ConvTranspose2d) for d in model.dec_convs)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in sd.items()}
