"""A DeepSeek-V3-layout decoder LM as a lyrics embedder: Moonlight-16B-A3B
(``core.config.MoeLMConfig``), the port's own (the JAX package has none).

The layout and names are those of DeepSeek-V3's ``modeling_deepseek.py``;
every linear has no bias.  Each layer is pre-norm residual,
``h = x + MLA(RMSNorm1(x))``, ``x' = h + FFN(RMSNorm2(h))``, with
``RMSNorm(x) = w * x / sqrt(mean(x^2) + eps)`` computed in float32.

- MLA (no query LoRA): ``q = W_q x`` gives heads x (qk_nope | qk_rope);
  ``[c | k_pe] = W_kva x``, ``c = RMSNorm_kv(c)``, ``[k_nope | v]`` a head
  ``= W_kvb c``; ``k_pe`` is one vector a token, shared by all heads.
  RoPE (no scaling) rotates ``q_pe`` and ``k_pe`` over the pairs
  (2i, 2i+1) at frequency theta^(-2i/d_rope), in DeepSeek's view/transpose
  layout (``rope``).  Scores are ``q . k / sqrt(qk_nope + qk_rope)`` under
  a causal mask; ``out = W_o concat_h(sum p v)``.
- FFN: the first ``first_dense`` layers a SwiGLU ``W_down(silu(W_gate x) *
  W_up x)``; the rest a sparse MoE: ``s = sigmoid(W_g x)`` in float32, the
  experts are the top-k of ``s + b`` (``e_score_correction_bias``, used for
  the choice only), their weights ``routed_scale * s_i / (sum_chosen s +
  1e-20)`` (``route``), ``y = sum_i w_i E_i(x) + S(x)`` with SwiGLU experts
  and one SwiGLU ``S`` of width n_shared x expert_width.
- Output: the final RMSNorm, the mean over each sequence's real tokens and
  L2 normalization, as ``text.minilm`` pools.  ``lm_head`` is not held: an
  embedder reads the hidden state.

Precision: weights and GEMM inputs in ``cfg.dtype`` (bfloat16 as
published) with float32 accumulation; RMSNorm, RoPE, the router's scores
and top-k, the softmax (inside the fused attention kernel), the residual
stream and the pooling in float32.

Batching (``encode_ids``): the sequences sorted by length, longest first,
and cut greedily into forwards of at most ``max_batch_tokens`` token slots
(rows x the longest row, padding included).  The residual stream holds
only the real tokens, packed; attention gathers them into padded (rows,
longest) blocks, each row's padding a copy of its last token, which the
causal mask hides from every real query, and the MoE routes real tokens
only.  The token slots are sorted by expert and each expert projection is
one grouped GEMM over all experts (``torch._grouped_mm``, offsets on the
device), so a forward waits on the device only for its ids (``sync.lm.ids``)
and, where counters are asked for, its routing counts
(``sync.lm.moe.counts``).

Weights load from HuggingFace names (``hf_to_state_dict``, over
``minilm.read_safetensors``); the routed experts are held stacked, one
(experts, 2 x width, hidden) gate|up tensor and one (experts, hidden,
width) down tensor a layer.  Moonlight's tokenizer (``tiktoken.model``) is
not in the repository: the encoder takes token ids.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vae_hmc_tpu_torch.core.config import MoeLMConfig
from vae_hmc_tpu_torch.core.device import resolve_device
from vae_hmc_tpu_torch.core.profiling import span, sync

TOKENIZER_FILE = "tiktoken.model"
MISSING_TOKENIZER = (
    f"Moonlight's tokenizer ({TOKENIZER_FILE}) is not in the repository, so "
    "the MoE LM encoder cannot tokenize text: pass token ids")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class LMCounters:
    """What ``encode_ids`` calls encoded, summed over the calls it is given
    to: real tokens, token slots of the forwards (padding included), and
    for each forward the token slots routed to each expert of each MoE
    layer ((moe_layers, n_experts) int64)."""
    tokens: int = 0
    slots: int = 0
    expert_slots: List[np.ndarray] = dataclasses.field(default_factory=list)

    @property
    def padded(self) -> int:
        return self.slots - self.tokens

    @property
    def forwards(self) -> int:
        return len(self.expert_slots)


# -- pieces (module-level, one place each) -----------------------------------

def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` with the input cast to the weight's dtype (the GEMM's
    inputs in the model's dtype, float32 accumulation)."""
    return F.linear(x.to(w.dtype), w)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
         ) -> torch.Tensor:
    """DeepSeek's RoPE, in float32: the pairs (2i, 2i+1) of the last axis
    rotated by angle pos x theta^(-2i/d), returned as [rotated evens |
    rotated odds] (``modeling_deepseek``'s view/transpose then
    rotate-half; the permutation is common to q and k, so q . k is the
    interleaved rotation's).  cos, sin: (..., d/2), broadcast to x."""
    x = x.float()
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.cat((x1 * cos - x2 * sin, x2 * cos + x1 * sin), -1)


def rope_tables(cfg: MoeLMConfig, pos: torch.Tensor):
    """(T,) positions -> cos, sin (T, 1, d_rope/2) float32."""
    d = cfg.qk_rope_dim
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, d, 2, dtype=torch.float32, device=pos.device) / d))
    ang = pos.to(torch.float32)[:, None] * inv[None, :]
    return ang.cos()[:, None, :], ang.sin()[:, None, :]


def route(scores: torch.Tensor, bias: torch.Tensor, top_k: int,
          scale: float):
    """Sigmoid scores (T, E) -> (expert ids (T, k), weights (T, k)): the
    choice by ``scores + bias``, the weights from the scores alone,
    normalized over the chosen and scaled (``noaux_tc``, one group)."""
    idx = torch.topk(scores + bias, top_k, dim=-1, sorted=False).indices
    w = scores.gather(1, idx)
    return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * scale


def length_batches(lengths: Sequence[int], max_batch_tokens: int
                   ) -> List[List[int]]:
    """Row indices cut into forwards: longest first (ties in corpus
    order), each forward as many rows as keep rows x its longest row within
    `max_batch_tokens`."""
    order = sorted(range(len(lengths)), key=lambda i: (-lengths[i], i))
    out: List[List[int]] = []
    for i in order:
        if out and lengths[out[-1][0]] * (len(out[-1]) + 1) \
                <= max_batch_tokens:
            out[-1].append(i)
        else:
            out.append([i])
    return out


class Packing:
    """One forward's layout: B rows padded to S slots; per real token (T,
    rows one after another) its id, position, flat slot b*S + p and row;
    each row's length; per padded slot the token it copies; each row's
    index in the caller's output (`rows`); all in one copy to the device,
    and RoPE's tables.  MoE layers append their routing counts (device
    tensors) here."""

    def __init__(self, cfg: MoeLMConfig, seqs: Sequence[np.ndarray],
                 dev: torch.device, rows: Sequence[int] = ()):
        self.lengths = [len(s) for s in seqs]
        self.B, self.S = len(seqs), max(self.lengths)
        self.T = sum(self.lengths)
        lengths = np.asarray(self.lengths, dtype=np.int64)
        pos = np.concatenate([np.arange(n) for n in self.lengths])
        row = np.repeat(np.arange(self.B), self.lengths)
        start = np.cumsum(lengths) - lengths
        # each padded slot's source token: itself, or its row's last token
        pad_src = start[:, None] + np.minimum(np.arange(self.S)[None, :],
                                              lengths[:, None] - 1)
        host = np.concatenate([np.concatenate(seqs).astype(np.int64), pos,
                               row * self.S + pos, row, lengths,
                               pad_src.reshape(-1),
                               np.asarray(rows, dtype=np.int64)])
        with sync("lm.ids"):
            flat = torch.from_numpy(host).to(dev)
        t, b, n = self.T, self.B, self.B * self.S
        self.ids, self.pos = flat[:t], flat[t:2 * t]
        self.slot, self.row = flat[2 * t:3 * t], flat[3 * t:4 * t]
        self.row_len = flat[4 * t:4 * t + b]
        self.pad_src = flat[4 * t + b:4 * t + b + n]
        self.out_rows = flat[4 * t + b + n:]      # where `rows` were given
        self.cos, self.sin = rope_tables(cfg, self.pos)
        self.expert_counts: List[torch.Tensor] = []


# -- modules -----------------------------------------------------------------

def _param(shape, dtype, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Linear(nn.Module):
    """A bias-free linear layer whose weight (out, in) is set by loading."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype):
        super().__init__()
        self.weight = _param((n_out, n_in), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight)


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int, dtype: torch.dtype):
        super().__init__()
        self.weight = _param((vocab, dim), dtype)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.weight.index_select(0, ids)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.weight = _param((dim,), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """-> float32."""
        x = x.float()
        x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps)
        return x * self.weight.float()


class MLA(nn.Module):
    """Multi-head latent attention (``self_attn``)."""

    def __init__(self, cfg: MoeLMConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        h, nh = cfg.hidden, cfg.heads
        self.q_proj = Linear(h, nh * cfg.qk_head_dim, dtype)
        self.kv_a_proj_with_mqa = Linear(
            h, cfg.kv_lora_rank + cfg.qk_rope_dim, dtype)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_eps, dtype)
        self.kv_b_proj = Linear(
            cfg.kv_lora_rank, nh * (cfg.qk_nope_dim + cfg.v_head_dim), dtype)
        self.o_proj = Linear(nh * cfg.v_head_dim, h, dtype)

    def forward(self, x: torch.Tensor, pk: Packing) -> torch.Tensor:
        """x (T, hidden) normed -> (T, hidden) in the model's dtype."""
        cfg, t, nh = self.cfg, x.shape[0], self.cfg.heads
        with span("lm.attn"):
            q = self.q_proj(x).view(t, nh, cfg.qk_head_dim)
            c, k_pe = self.kv_a_proj_with_mqa(x).split(
                [cfg.kv_lora_rank, cfg.qk_rope_dim], -1)
            kv = self.kv_b_proj(self.kv_a_layernorm(c)).view(
                t, nh, cfg.qk_nope_dim + cfg.v_head_dim)
            k_nope, v = kv.split([cfg.qk_nope_dim, cfg.v_head_dim], -1)
            q_pe = rope(q[..., cfg.qk_nope_dim:], pk.cos, pk.sin)
            k_pe = rope(k_pe[:, None, :], pk.cos, pk.sin)
            dt = q.dtype
            q = torch.cat((q[..., :cfg.qk_nope_dim], q_pe.to(dt)), -1)
            k = torch.cat((k_nope, k_pe.to(dt).expand(t, nh, -1)), -1)
            o = attend(cfg, q, k, v, pk.pad_src, pk.B, pk.S)
            return self.o_proj(o.index_select(0, pk.slot))


def attend(cfg: MoeLMConfig, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, pad_src: torch.Tensor, B: int, S: int
           ) -> torch.Tensor:
    """Per-token q, k, v (T, heads, d) -> causal attention's output at the
    B x S padded slots (B * S, heads * v_head_dim).  The blocks are (B,
    heads, S, d) gathers by `pad_src`: a row's padding repeats its last
    token, after every real position, so the causal mask hides it."""
    nh = cfg.heads
    blocks = [a.index_select(0, pad_src).view(B, S, nh, -1).transpose(1, 2)
              for a in (q, k, v)]
    o = F.scaled_dot_product_attention(*blocks, is_causal=True,
                                       scale=cfg.qk_head_dim ** -0.5)
    return o.transpose(1, 2).reshape(B * S, nh * cfg.v_head_dim)


class MLP(nn.Module):
    """SwiGLU ``down(silu(gate x) * up x)`` (the dense FFN, the shared
    experts)."""

    def __init__(self, hidden: int, width: int, dtype: torch.dtype):
        super().__init__()
        self.gate_proj = Linear(hidden, width, dtype)
        self.up_proj = Linear(hidden, width, dtype)
        self.down_proj = Linear(width, hidden, dtype)

    def forward(self, x: torch.Tensor, pk: Optional[Packing] = None
                ) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Gate(nn.Module):
    """The router (``mlp.gate``): float32 sigmoid scores of the normed
    input, chosen by ``route``."""

    def __init__(self, cfg: MoeLMConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.weight = _param((cfg.n_experts, cfg.hidden), dtype)
        self.e_score_correction_bias = _param((cfg.n_experts,),
                                              torch.float32)

    def forward(self, x: torch.Tensor):
        """x (T, hidden) -> (ids (T, k), weights (T, k) float32)."""
        scores = torch.sigmoid(F.linear(x.float(), self.weight.float()))
        return route(scores, self.e_score_correction_bias, self.cfg.top_k,
                     self.cfg.routed_scale)


class Experts(nn.Module):
    """The routed experts, stacked: gate_up (E, 2 x width, hidden) holds
    each expert's gate_proj over its up_proj; down (E, hidden, width)."""

    def __init__(self, cfg: MoeLMConfig, dtype: torch.dtype):
        super().__init__()
        e, h, w = cfg.n_experts, cfg.hidden, cfg.expert_width
        self.gate_up = _param((e, 2 * w, h), dtype)
        self.down = _param((e, h, w), dtype)

    def forward(self, xs: torch.Tensor, ws: torch.Tensor,
                offs: torch.Tensor) -> torch.Tensor:
        """Slots sorted by expert (N, hidden), their routing weights (N,)
        and each expert's end offset (E,) int32 -> each slot's weighted
        output (N, hidden): a grouped GEMM a projection.  The weight scales
        the SwiGLU activation, which the down projection carries linearly
        to the output."""
        width = self.down.shape[-1]
        gu = torch._grouped_mm(xs, self.gate_up.transpose(-2, -1), offs=offs)
        act = F.silu(gu[:, :width]).mul_(gu[:, width:])
        act = act.mul_(ws[:, None].to(act.dtype))
        return torch._grouped_mm(act, self.down.transpose(-2, -1), offs=offs)


class MoE(nn.Module):
    """The sparse MoE FFN (``mlp``): routed experts plus shared ones."""

    def __init__(self, cfg: MoeLMConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.gate = Gate(cfg, dtype)
        self.experts = Experts(cfg, dtype)
        self.shared_experts = MLP(cfg.hidden, cfg.expert_width * cfg.n_shared,
                                  dtype)

    def forward(self, x: torch.Tensor, pk: Packing) -> torch.Tensor:
        """x (T, hidden) normed -> (T, hidden) float32."""
        cfg, t = self.cfg, x.shape[0]
        xb = x.to(self.experts.down.dtype)
        with span("lm.moe.route"):
            idx, w = self.gate(x)
            flat = idx.reshape(-1)
            order = torch.argsort(flat, stable=True)
            counts = torch.zeros(cfg.n_experts, dtype=torch.int64,
                                 device=x.device).scatter_add_(
                0, flat, torch.ones_like(flat))
            pk.expert_counts.append(counts)
            offs = counts.cumsum(0).to(torch.int32)
            xs = xb.index_select(0, order // cfg.top_k)
            ws = w.reshape(-1).index_select(0, order)
        with span("lm.moe.experts"):
            ys = self.experts(xs, ws, offs)
        with span("lm.moe.shared"):
            shared = self.shared_experts(xb)
        with span("lm.moe.combine"):
            back = torch.empty_like(order).scatter_(
                0, order, torch.arange(len(order), device=x.device))
            y = ys.index_select(0, back)
            return y.view(t, cfg.top_k, -1).sum(1, dtype=torch.float32) \
                + shared.float()


class Layer(nn.Module):
    def __init__(self, cfg: MoeLMConfig, i: int, dtype: torch.dtype):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden, cfg.rms_eps, dtype)
        self.self_attn = MLA(cfg, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden, cfg.rms_eps,
                                                dtype)
        self.mlp = (MLP(cfg.hidden, cfg.dense_width, dtype)
                    if i < cfg.first_dense else MoE(cfg, dtype))

    def forward(self, h: torch.Tensor, pk: Packing) -> torch.Tensor:
        h = h + self.self_attn(self.input_layernorm(h), pk)
        return h + self.mlp(self.post_attention_layernorm(h), pk)


class MoeLM(nn.Module):
    """The decoder without ``lm_head``; parameters are uninitialized until
    loaded (``load_hf``).  State-dict names are the HuggingFace ones without
    the ``model.`` prefix, the routed experts stacked."""

    def __init__(self, cfg: MoeLMConfig = MoeLMConfig()):
        super().__init__()
        self.cfg = cfg
        dtype = _DTYPES[cfg.dtype]
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden, dtype)
        self.layers = nn.ModuleList(Layer(cfg, i, dtype)
                                    for i in range(cfg.layers))
        self.norm = RMSNorm(cfg.hidden, cfg.rms_eps, dtype)

    def forward(self, pk: Packing) -> torch.Tensor:
        """One packed forward -> (B, hidden) float32 unit rows."""
        h = self.embed_tokens(pk.ids).float()
        for layer in self.layers:
            h = layer(h, pk)
        with span("lm.pool"):
            h = self.norm(h)
            sums = h.new_zeros((pk.B, h.shape[1])).index_add_(0, pk.row, h)
            pooled = sums / torch.clamp(pk.row_len[:, None].float(),
                                        min=1e-9)
            return pooled / torch.clamp(torch.linalg.vector_norm(
                pooled, dim=-1, keepdim=True), min=1e-12)


# -- encoding ----------------------------------------------------------------

def encode_ids(model: MoeLM, id_seqs: Sequence, max_batch_tokens: int = 32768,
               counters: Optional[LMCounters] = None,
               to_host: bool = False):
    """(M,) token-id sequences -> (M, hidden) float32 embeddings in their
    order, on the model's device (``to_host``: a numpy array), as
    ``minilm.encode_texts`` embeds texts.  Forwards as ``length_batches``
    cuts them; `counters` (optional) adds what was encoded.  A sequence
    must hold 1 to min(max_positions, max_batch_tokens) ids."""
    cfg = model.cfg
    dev = model.embed_tokens.weight.device
    seqs = [np.asarray(s, dtype=np.int64).reshape(-1) for s in id_seqs]
    limit = min(cfg.max_positions, max_batch_tokens)
    bad = [i for i, s in enumerate(seqs) if not 1 <= len(s) <= limit]
    if bad:
        raise ValueError(f"sequences {bad[:5]} hold {len(seqs[bad[0]])} "
                         f"ids; 1 to {limit} are encoded")
    out = torch.zeros((len(seqs), cfg.hidden), dtype=torch.float32,
                      device=dev)
    with span("lm.encode"), torch.no_grad():
        for rows in length_batches([len(s) for s in seqs], max_batch_tokens):
            pk = Packing(cfg, [seqs[i] for i in rows], dev, rows)
            out.index_copy_(0, pk.out_rows, model(pk))
            if counters is not None:
                counters.tokens += pk.T
                counters.slots += pk.B * pk.S
                with sync("lm.moe.counts"):
                    counters.expert_slots.append(
                        torch.stack(pk.expert_counts).cpu().numpy())
        if not to_host:
            return out
        with sync("lm.result"):
            return out.cpu().numpy()


def warm_attention(model: MoeLM, lengths: Sequence[int],
                   max_batch_tokens: int = 32768) -> None:
    """Runs ``attend`` once at each (rows, longest row) shape of the
    forwards ``encode_ids`` cuts from `lengths`, on zeros: the fused
    attention builds a plan at a shape's first call (seconds over a
    corpus), and this builds them before the corpus is encoded."""
    cfg = model.cfg
    w = model.embed_tokens.weight
    shapes = {(len(rows), max(lengths[i] for i in rows))
              for rows in length_batches(list(lengths), max_batch_tokens)}
    with torch.no_grad():
        for b, s in sorted(shapes):
            qk = w.new_zeros((b * s, cfg.heads, cfg.qk_head_dim))
            v = w.new_zeros((b * s, cfg.heads, cfg.v_head_dim))
            attend(cfg, qk, qk, v, torch.arange(b * s, device=w.device), b,
                   s)


# -- weights -----------------------------------------------------------------

def hf_to_state_dict(sd: Dict[str, torch.Tensor], cfg: MoeLMConfig
                     ) -> Dict[str, torch.Tensor]:
    """HuggingFace names -> this module's, for the tensors `sd` holds (a
    whole checkpoint, or a part such as one layer's): ``model.`` dropped,
    each MoE layer's ``mlp.experts.{e}.{gate,up,down}_proj.weight``
    stacked into ``mlp.experts.gate_up`` / ``mlp.experts.down`` (a layer's
    experts must all be present), ``lm_head.weight`` dropped.  Dtypes pass
    through; loading casts."""
    out, experts = {}, {}
    for name, t in sd.items():
        if name == "lm_head.weight":
            continue
        key = name.removeprefix("model.")
        parts = key.split(".")
        if len(parts) > 4 and parts[2:4] == ["mlp", "experts"]:
            layer, e, proj = int(parts[1]), int(parts[4]), parts[5]
            experts.setdefault(layer, {})[(e, proj)] = t
            continue
        out[key] = t
    for layer, got in sorted(experts.items()):
        missing = [(e, p) for e in range(cfg.n_experts)
                   for p in ("gate_proj", "up_proj", "down_proj")
                   if (e, p) not in got]
        if missing:
            raise KeyError(f"layer {layer}: experts' tensors missing, e.g. "
                           f"{missing[:3]}")
        p = f"layers.{layer}.mlp.experts."
        out[p + "gate_up"] = torch.stack([torch.cat(
            (got[(e, "gate_proj")], got[(e, "up_proj")]))
            for e in range(cfg.n_experts)])
        out[p + "down"] = torch.stack([got[(e, "down_proj")]
                                       for e in range(cfg.n_experts)])
    return out


def load_hf(model: MoeLM, sd: Dict[str, torch.Tensor]) -> None:
    """Copies HuggingFace-named tensors (all, or a part) into `model`;
    raises on a name or shape the model does not have."""
    mapped = hf_to_state_dict(sd, model.cfg)
    params = dict(model.named_parameters())
    unknown = sorted(set(mapped) - set(params))
    if unknown:
        raise KeyError(f"not parameters of the model: {unknown[:5]}")
    with torch.no_grad():
        for k, v in mapped.items():
            if params[k].shape != v.shape:
                raise ValueError(f"{k}: shape {tuple(v.shape)}, the model "
                                 f"has {tuple(params[k].shape)}")
            params[k].copy_(v)


def load_moe_lm(model_dir: Path, dtype: str = "bfloat16",
                device="cuda") -> MoeLM:
    """A HuggingFace checkout (``config.json`` and ``*.safetensors``) ->
    the encoder on `device`, in eval mode."""
    from vae_hmc_tpu_torch.text.minilm import read_safetensors

    model_dir = Path(model_dir)
    dev = resolve_device(device)
    cfg = MoeLMConfig.from_hf(
        json.loads((model_dir / "config.json").read_text()), dtype)
    files = sorted(model_dir.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no *.safetensors in {model_dir}")
    with torch.device(dev):
        model = MoeLM(cfg)
    sd = {}
    for f in files:
        sd.update(read_safetensors(f))
    load_hf(model, sd)
    return model.eval()
