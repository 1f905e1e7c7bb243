"""Carry Flax weights across into the port's modules: ``ConvMMVAE``,
``DenseVAE``, ``AE`` and ``MiniLM``; and the VAE and AE weights, and
Adam's moments of them, back into the Flax tree, for checkpoints in the
JAX package's format (``flax_params``, ``module_tensors``).

The inverse of ``vae_hmc_tpu.models.torch_port`` (linear, conv2d,
conv_transpose2d and the NCHW-flatten seams), written here so the port
does not import the JAX package.  Every mapping is a transpose or a
permutation, so it maps gradients the same way:
  - Dense kernel (in, out)                 -> Linear weight (out, in);
  - Conv kernel (kh, kw, in, out)          -> Conv2d weight (out, in, kh, kw);
  - ConvTranspose kernel (kh, kw, in, out) -> ConvTranspose2d weight
    (in, out, kh, kw) with BOTH spatial axes flipped (torch's transposed
    conv is the gradient of a correlation, lax's a fractionally strided
    correlation);
  - ``enc_fc`` rows and ``dec_fc2`` columns and bias reordered from the
    Flax NHWC flatten (H, W, C) to torch's NCHW flatten (C, H, W);
  - Embed ``embedding`` -> Embedding weight; LayerNorm ``scale``/``bias``
    -> LayerNorm weight/bias.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

Params = Dict[str, Dict[str, np.ndarray]]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def conv_mm_vae_state_dict(params: Params, enc_hw: Tuple[int, int],
                           channels: Tuple[int, ...] = (32, 64, 128)
                           ) -> Dict[str, torch.Tensor]:
    """Flax ``params`` (``{"enc_conv1": {"kernel", "bias"}, ...}``, the tree
    under ``"params"``, as numpy) -> ``ConvMMVAE`` state_dict."""
    eh, ew = enc_hw
    c = channels[-1]
    sd = {}
    for i in range(len(channels)):
        p = params[f"enc_conv{i + 1}"]
        sd[f"enc_convs.{i}.weight"] = _t(p["kernel"].transpose(3, 2, 0, 1))
        sd[f"enc_convs.{i}.bias"] = _t(p["bias"])
        p = params[f"dec_conv{i + 1}"]
        sd[f"dec_convs.{i}.weight"] = _t(
            p["kernel"][::-1, ::-1].transpose(2, 3, 0, 1))
        sd[f"dec_convs.{i}.bias"] = _t(p["bias"])
    for name in ("mu_a", "logvar_a", "lyr1", "lyr2", "fuse", "mu", "logvar",
                 "dec_fc1"):
        sd[f"{name}.weight"] = _t(params[name]["kernel"].T)
        sd[f"{name}.bias"] = _t(params[name]["bias"])
    k = params["enc_fc"]["kernel"]                       # (H*W*C, out)
    sd["enc_fc.weight"] = _t(k.reshape(eh, ew, c, -1).transpose(3, 2, 0, 1)
                             .reshape(k.shape[1], -1))
    sd["enc_fc.bias"] = _t(params["enc_fc"]["bias"])
    k = params["dec_fc2"]["kernel"]                      # (in, H*W*C)
    sd["dec_fc2.weight"] = _t(k.reshape(-1, eh, ew, c).transpose(3, 1, 2, 0)
                              .reshape(-1, k.shape[0]))
    b = params["dec_fc2"]["bias"]
    sd["dec_fc2.bias"] = _t(b.reshape(eh, ew, c).transpose(2, 0, 1).reshape(-1))
    return sd


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def conv_mm_vae_flax_params(state_dict: Dict[str, torch.Tensor],
                            enc_hw: Tuple[int, int],
                            channels: Tuple[int, ...] = (32, 64, 128)
                            ) -> Params:
    """``ConvMMVAE`` state_dict -> Flax ``params`` (numpy, the tree under
    ``"params"``): ``conv_mm_vae_state_dict`` run backwards, every
    transpose, flip and NCHW -> NHWC reorder undone, so the checkpoint
    writer stores the JAX package's layouts."""
    eh, ew = enc_hw
    c = channels[-1]
    contig = np.ascontiguousarray
    params: Params = {}
    for i in range(len(channels)):
        w = _np(state_dict[f"enc_convs.{i}.weight"])     # (out, in, kh, kw)
        params[f"enc_conv{i + 1}"] = {
            "kernel": contig(w.transpose(2, 3, 1, 0)),
            "bias": _np(state_dict[f"enc_convs.{i}.bias"])}
        w = _np(state_dict[f"dec_convs.{i}.weight"])     # (in, out, kh, kw)
        params[f"dec_conv{i + 1}"] = {
            "kernel": contig(w.transpose(2, 3, 0, 1)[::-1, ::-1]),
            "bias": _np(state_dict[f"dec_convs.{i}.bias"])}
    for name in ("mu_a", "logvar_a", "lyr1", "lyr2", "fuse", "mu", "logvar",
                 "dec_fc1"):
        params[name] = {"kernel": contig(_np(state_dict[f"{name}.weight"]).T),
                        "bias": _np(state_dict[f"{name}.bias"])}
    w = _np(state_dict["enc_fc.weight"])                 # (out, C*H*W)
    params["enc_fc"] = {
        "kernel": contig(w.reshape(-1, c, eh, ew).transpose(2, 3, 1, 0)
                         .reshape(eh * ew * c, -1)),
        "bias": _np(state_dict["enc_fc.bias"])}
    w = _np(state_dict["dec_fc2.weight"])                # (C*H*W, in)
    b = _np(state_dict["dec_fc2.bias"])
    params["dec_fc2"] = {
        "kernel": contig(w.reshape(c, eh, ew, -1).transpose(3, 1, 2, 0)
                         .reshape(w.shape[1], -1)),
        "bias": contig(b.reshape(c, eh, ew).transpose(1, 2, 0).reshape(-1))}
    return params


def linear_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    """Flax ``params`` of a model made of Dense layers only (``DenseVAE``:
    enc1.., mu, logvar, dec1.., out; ``AE``: e1..d3), the tree under
    ``"params"`` as numpy -> the port module's state_dict (its Linear
    layers carry the same names)."""
    sd = {}
    for name, p in params.items():
        sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
        sd[f"{name}.bias"] = _t(p["bias"])
    return sd


def linear_flax_params(state_dict: Dict[str, torch.Tensor]) -> Params:
    """``linear_state_dict`` run backwards: a state_dict of named Linear
    layers -> Flax ``params`` (numpy, kernels (in, out)), for the
    checkpoint writer."""
    params: Params = {}
    for key, t in state_dict.items():
        name, leaf = key.rsplit(".", 1)
        a = _np(t)
        params.setdefault(name, {})[
            "kernel" if leaf == "weight" else "bias"] = (
            np.ascontiguousarray(a.T) if leaf == "weight" else a)
    return params


def minilm_state_dict(variables) -> Dict[str, torch.Tensor]:
    """Flax MiniLM variables (``{"params": {...}}``, as the JAX package's
    ``synthetic_minilm`` returns them or ``MiniLM.init`` makes them) ->
    ``text.minilm.MiniLM`` state_dict."""
    p = variables["params"]
    sd = {f"{name}.weight": _t(p[name]["embedding"])
          for name in ("tok_emb", "pos_emb", "type_emb")}
    sd["emb_ln.weight"] = _t(p["emb_ln"]["scale"])
    sd["emb_ln.bias"] = _t(p["emb_ln"]["bias"])
    i = 0
    while f"layer{i}" in p:
        lp = p[f"layer{i}"]
        for name in ("q", "k", "v", "att_out", "ff1", "ff2"):
            sd[f"layers.{i}.{name}.weight"] = _t(np.asarray(lp[name]["kernel"]).T)
            sd[f"layers.{i}.{name}.bias"] = _t(lp[name]["bias"])
        for name in ("att_ln", "ff_ln"):
            sd[f"layers.{i}.{name}.weight"] = _t(lp[name]["scale"])
            sd[f"layers.{i}.{name}.bias"] = _t(lp[name]["bias"])
        i += 1
    return sd


def flax_params(model: torch.nn.Module,
                tensors: Dict[str, torch.Tensor]) -> Params:
    """Tensors keyed and shaped like `model`'s parameters (the weights, or
    Adam's moments of them) -> the Flax ``params`` layout of the JAX
    package's module.  Every mapping is a transpose, flip or reorder, so a
    moment goes through the same one as its weight."""
    from vae_hmc_tpu_torch.models.conv_mm_vae import ConvMMVAE
    if isinstance(model, ConvMMVAE):
        return conv_mm_vae_flax_params(tensors, model.enc_hw, model.channels)
    return linear_flax_params(tensors)


def module_tensors(model: torch.nn.Module,
                   params: Params) -> Dict[str, torch.Tensor]:
    """``flax_params`` run backwards: Flax ``params`` (numpy) -> tensors
    keyed and shaped like `model`'s parameters."""
    from vae_hmc_tpu_torch.models.conv_mm_vae import ConvMMVAE
    if isinstance(model, ConvMMVAE):
        return conv_mm_vae_state_dict(params, model.enc_hw, model.channels)
    return linear_state_dict(params)
