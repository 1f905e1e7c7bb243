"""Plain Moonlight-16B-A3B (DeepSeek-V3 layout: MLA attention, a dense
first layer, then sigmoid-routed sparse MoE layers with shared experts) as
a lyrics embedder, in float32 with TF32 off, from HuggingFace-named weights
that are drawn here from ``(seed, name)``.

Written from the published equations (``modeling_deepseek.py``), one
sequence at a time, with no cache and no padding:
- RMSNorm ``w * x / sqrt(mean(x^2) + eps)``; every linear ``x @ W.T``.
- MLA: ``q = W_q x`` -> heads x [q_nope | q_pe]; ``[c | k_pe] = W_kva x``,
  ``c = RMSNorm_kv(c)``, ``[k_nope | v] = W_kvb c`` a head; RoPE in
  DeepSeek's form (``rope``); scores ``q . k / sqrt(d_nope + d_rope)``
  with a causal mask, softmax, ``W_o concat_h(p v)``.
- FFN: layer < first_k_dense_replace a SwiGLU; else ``s = sigmoid(W_g x)``,
  the top-k of ``s + b`` chosen, weights ``scale * s_i / (sum s + 1e-20)``,
  ``sum_i w_i E_i(x) + S(x)`` with each routed expert on its own tokens.
- Output: final RMSNorm, the mean over the sequence, L2 normalization.
The per-token parts (norms, FFN, MoE) run over the tokens of all the given
sequences at once, which is the same per-token function; attention runs
one sequence at a time.  ``embed`` walks the layers outermost and draws one
layer's weights at a time, so it holds one float32 layer at most.  Given
the program's expert choices (``follow``), it takes them wherever its own
scores put them within a tolerance of its own k-th (``choose``).

Departures from the published model: no ``lm_head`` (an embedder reads the
hidden state); random weights (``draw``: N(0, s) for linears, the
embedding and the selection bias, 1 + N(0, s) for norm scales, s the
configuration's ``initializer_range`` (0.02, DeepSeek-V3's), each
tensor from its own generator seeded by (seed, name), drawn in the
program's dtype and read here in float32); token ids in place of the
tokenizer (``tiktoken.model`` is not in the repository).

``FAULTS`` are the controls: the reference with one thing changed, put in
the program's place by the benchmark's control.
"""
from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

FAULTS = ("fp8", "no_rope", "bias_in_combine", "no_scale", "no_shared")
F8_MAX = 448.0               # largest float8 e4m3 value
BF16_TOL = 2.0 ** -8         # bf16 rounding, relative (half an ulp)


# -- weights ---------------------------------------------------------------

def parts(cfg: dict) -> List:
    """The model's parts in order: "embed", each layer, "final"."""
    return ["embed"] + list(range(cfg["num_hidden_layers"])) + ["final"]


def leaves(cfg: dict, part) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(HuggingFace name, shape, kind) of a part's tensors; kind "w" (a
    linear, the embedding), "norm" (a norm's scale) or "bias" (the
    selection bias)."""
    h = cfg["hidden_size"]
    if part == "embed":
        return [("model.embed_tokens.weight", (cfg["vocab_size"], h), "w")]
    if part == "final":
        return [("model.norm.weight", (h,), "norm")]
    i, nh = part, cfg["num_attention_heads"]
    dq = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    r = cfg["kv_lora_rank"]
    p = f"model.layers.{i}."
    out = [(p + "input_layernorm.weight", (h,), "norm"),
           (p + "post_attention_layernorm.weight", (h,), "norm"),
           (p + "self_attn.q_proj.weight", (nh * dq, h), "w"),
           (p + "self_attn.kv_a_proj_with_mqa.weight",
            (r + cfg["qk_rope_head_dim"], h), "w"),
           (p + "self_attn.kv_a_layernorm.weight", (r,), "norm"),
           (p + "self_attn.kv_b_proj.weight",
            (nh * (cfg["qk_nope_head_dim"] + cfg["v_head_dim"]), r), "w"),
           (p + "self_attn.o_proj.weight", (h, nh * cfg["v_head_dim"]), "w")]

    def mlp(prefix, width):
        return [(prefix + "gate_proj.weight", (width, h), "w"),
                (prefix + "up_proj.weight", (width, h), "w"),
                (prefix + "down_proj.weight", (h, width), "w")]

    if i < cfg["first_k_dense_replace"]:
        return out + mlp(p + "mlp.", cfg["intermediate_size"])
    e, w = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    out += [(p + "mlp.gate.weight", (e, h), "w"),
            (p + "mlp.gate.e_score_correction_bias", (e,), "bias")]
    for j in range(e):
        out += mlp(p + f"mlp.experts.{j}.", w)
    return out + mlp(p + "mlp.shared_experts.",
                     w * cfg["n_shared_experts"])


def _name_seed(seed: int, name: str) -> int:
    digest = hashlib.blake2b(f"{seed}:{name}".encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little") & ((1 << 63) - 1)


def draw(seed: int, name: str, shape, kind: str, std: float,
         device: torch.device, dtype: torch.dtype,
         gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """One tensor, in `dtype`, from its own stream: N(0, std), plus 1 for a
    norm's scale."""
    gen = gen or torch.Generator(device=device)
    gen.manual_seed(_name_seed(seed, name))
    t = torch.empty(shape, dtype=dtype, device=device)
    t.normal_(0.0, std, generator=gen)
    return t.add_(1.0) if kind == "norm" else t


def part_weights(cfg: dict, seed: int, part, device: torch.device,
                 dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """A part's tensors as drawn in `dtype` (std ``initializer_range``),
    read in float32."""
    gen = torch.Generator(device=device)
    return {name: draw(seed, name, shape, kind, cfg["initializer_range"],
                       device, dtype, gen).float()
            for name, shape, kind in leaves(cfg, part)}


# -- arithmetic ---------------------------------------------------------------

def _q8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude maps to e4m3's largest value)."""
    s = t.abs().max().clamp(min=1e-30) / F8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def mm(x: torch.Tensor, w: torch.Tensor, fault=None) -> torch.Tensor:
    """x @ w.T (with the fp8 fault, both inputs rounded first)."""
    if fault == "fp8":
        x, w = _q8(x), _q8(w)
    return x @ w.T


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """DeepSeek's apply_rotary_pos_emb on x (..., L, d): the last axis
    viewed as (d/2, 2), transposed and flattened (evens then odds), then
    ``x cos + rotate_half(x) sin`` with ``cos, sin`` of ``cat(freqs,
    freqs)``, ``freqs = pos x theta^(-arange(0, d, 2)/d)``."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    freqs = torch.outer(pos.to(torch.float32), inv)
    emb = torch.cat((freqs, freqs), -1)
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(
        x.shape)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return x * emb.cos() + torch.cat((-x2, x1), -1) * emb.sin()


def mla(w: Dict[str, torch.Tensor], p: str, cfg: dict, x: torch.Tensor,
        fault=None) -> torch.Tensor:
    """One sequence's normed hidden states (L, hidden) -> attention's
    output (L, hidden)."""
    n, nh = x.shape[0], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    q = mm(x, w[p + "q_proj.weight"], fault).view(n, nh, dn + dr)
    q = q.transpose(0, 1)                                   # (nh, L, d)
    kva = mm(x, w[p + "kv_a_proj_with_mqa.weight"], fault)
    c, k_pe = kva[:, :r], kva[:, r:]
    c = rms(c, w[p + "kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    kv = mm(c, w[p + "kv_b_proj.weight"], fault).view(n, nh, dn + dv)
    kv = kv.transpose(0, 1)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    pos = torch.arange(n, device=x.device)
    q_pe, k_pe = q[..., dn:], k_pe[None]
    if fault != "no_rope":
        q_pe = rope(q_pe, pos, cfg["rope_theta"])
        k_pe = rope(k_pe, pos, cfg["rope_theta"])
    q = torch.cat((q[..., :dn], q_pe), -1)
    k = torch.cat((k_nope, k_pe.expand(nh, n, dr)), -1)
    if fault == "fp8":
        q, k, v = _q8(q), _q8(k), _q8(v)
    scores = q @ k.transpose(1, 2) / math.sqrt(dn + dr)
    causal = torch.ones(n, n, dtype=torch.bool, device=x.device).triu(1)
    p_att = torch.softmax(scores.masked_fill(causal, -math.inf), -1)
    if fault == "fp8":
        p_att = _q8(p_att)
    o = (p_att @ v).transpose(0, 1).reshape(n, nh * dv)
    return mm(o, w[p + "o_proj.weight"], fault)


def swiglu(w: Dict[str, torch.Tensor], p: str, x: torch.Tensor,
           fault=None) -> torch.Tensor:
    a = F.silu(mm(x, w[p + "gate_proj.weight"], fault)) * mm(
        x, w[p + "up_proj.weight"], fault)
    return mm(a, w[p + "down_proj.weight"], fault)


def choose(scores: torch.Tensor, bias: torch.Tensor, k: int,
           follow: Optional[torch.Tensor] = None, tol: float = BF16_TOL):
    """The top-k of ``scores + bias`` (T, k); with `follow` (the program's
    choice), the program's set for each token whose chosen experts all lie
    within `tol` (relative, of the k-th score) of this one's k-th score
    (the default: bf16 rounding, half an ulp).  -> (choice, share of the
    program's choices not in this one's own top-k, or None without
    `follow`)."""
    sel = scores + bias
    own = torch.topk(sel, k, dim=-1).indices
    if follow is None:
        return own, None
    follow = follow.to(own.device, torch.int64)
    kth = torch.topk(sel, k, dim=-1).values[:, -1:]
    near = sel.gather(1, follow) >= kth - kth.abs() * tol
    take = near.all(-1, keepdim=True)
    differ = (follow[:, :, None] != own[:, None, :]).all(-1)
    return (torch.where(take, follow, own),
            float(differ.float().mean()))


def moe(w: Dict[str, torch.Tensor], p: str, cfg: dict, x: torch.Tensor,
        fault=None, follow: Optional[torch.Tensor] = None,
        tol: float = BF16_TOL, record: Optional[list] = None):
    """Normed hidden states (T, hidden) -> (MoE output (T, hidden), share
    of choices that differ from `follow`, or None); `record` (a list)
    gets the choice made."""
    k = cfg["num_experts_per_tok"]
    scores = torch.sigmoid(mm(x, w[p + "gate.weight"], fault))
    bias = w[p + "gate.e_score_correction_bias"]
    idx, differ = choose(scores, bias, k, follow, tol)
    if record is not None:
        record.append(idx)
    sel = scores + bias if fault == "bias_in_combine" else scores
    wts = sel.gather(1, idx)
    wts = wts / (wts.sum(-1, keepdim=True) + 1e-20)
    if fault != "no_scale":
        wts = wts * cfg["routed_scaling_factor"]
    y = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if len(tok):
            y.index_add_(0, tok, wts[tok, slot, None] * swiglu(
                w, p + f"experts.{e}.", x[tok], fault))
    if fault != "no_shared":
        y = y + swiglu(w, p + "shared_experts.", x, fault)
    return y, differ


# -- the model ---------------------------------------------------------------

def layer(w: Dict[str, torch.Tensor], i: int, cfg: dict,
          hs: List[torch.Tensor], fault=None,
          follow: Optional[torch.Tensor] = None, tol: float = BF16_TOL,
          record: Optional[list] = None) -> List[torch.Tensor]:
    """Layer `i` over sequences' hidden states (each (L, hidden)); a MoE
    layer follows `follow` (the program's choice for the tokens of all the
    sequences, in order) within `tol` (``choose``) and adds its choice to
    `record`."""
    p, eps = f"model.layers.{i}.", cfg["rms_norm_eps"]
    hs = [h + mla(w, p + "self_attn.", cfg,
                  rms(h, w[p + "input_layernorm.weight"], eps), fault)
          for h in hs]
    flat = torch.cat(hs)
    x = rms(flat, w[p + "post_attention_layernorm.weight"], eps)
    if i < cfg["first_k_dense_replace"]:
        y = swiglu(w, p + "mlp.", x, fault)
    else:
        y, _ = moe(w, p + "mlp.", cfg, x, fault, follow, tol, record)
    return list((flat + y).split([len(h) for h in hs]))


def embed(weights: Callable[[object], Dict[str, torch.Tensor]], cfg: dict,
          id_seqs: Sequence, device: torch.device, fault=None,
          follow: Optional[Dict[int, torch.Tensor]] = None,
          tol: float = BF16_TOL,
          record: Optional[Dict[int, torch.Tensor]] = None) -> torch.Tensor:
    """(M,) id sequences -> (M, hidden) unit rows.  `weights(part)` gives a
    part's float32 tensors (``part_weights``), asked for once a part.
    `follow` maps a MoE layer to the program's choice (T, k) for the
    sequences' tokens in order, followed within `tol` (``choose``), so the
    reference walks the program's path through the experts wherever its
    own scores allow it; `record` (a dict) gets each MoE layer's choice."""
    w = weights("embed")["model.embed_tokens.weight"]
    hs = [w[torch.as_tensor(list(s), dtype=torch.int64, device=device)]
          for s in id_seqs]
    del w
    for i in range(cfg["num_hidden_layers"]):
        made: list = []
        hs = layer(weights(i), i, cfg, hs, fault,
                   None if follow is None else follow.get(i), tol, made)
        if record is not None and made:
            record[i] = made[0]
    norm = weights("final")["model.norm.weight"]
    out = []
    for h in hs:
        pooled = rms(h, norm, cfg["rms_norm_eps"]).mean(0)
        out.append(pooled / torch.clamp(pooled.norm(), min=1e-12))
    return torch.stack(out)
