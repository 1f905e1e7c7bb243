"""Operations and bytes of the MoE LM lyrics encoder (Moonlight-16B-A3B's
layout), from its configuration (HuggingFace keys), the sequences'
lengths and the encoder's routing counters.

A forward's FLOPs are 2 x multiply-adds, counted on the real tokens (no
padding): per token, every linear the token passes (attention's
projections, the dense FFN or the router, its k routed experts and the
shared ones), and per sequence of L tokens and layer, attention's q . k
and p v over the causal half, 2 x heads x (d_qk + d_v) x L(L+1)/2.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence

import numpy as np

BF16_BYTES = 2


def attention_params(cfg: dict) -> int:
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    return (h * nh * (dn + dr) + h * (r + dr) + r * nh * (dn + dv)
            + nh * dv * h)


def expert_params(cfg: dict) -> int:
    """One routed expert's weights (gate, up, down)."""
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def token_linear_flops(cfg: dict) -> float:
    """FLOPs of the linears one token passes through the whole model."""
    h, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    dense = cfg["first_k_dense_replace"]
    moe = (cfg["n_routed_experts"] * h
           + cfg["num_experts_per_tok"] * expert_params(cfg)
           + cfg["n_shared_experts"] * expert_params(cfg))
    per = (layers * attention_params(cfg)
           + dense * 3 * h * cfg["intermediate_size"]
           + (layers - dense) * moe)
    return 2.0 * per


def attention_flops(cfg: dict, lengths: Iterable[int]) -> float:
    """q . k and p v of every layer over the causal half."""
    nh = cfg["num_attention_heads"]
    d = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] + cfg["v_head_dim"]
    pairs = sum(n * (n + 1) / 2 for n in lengths)
    return 2.0 * nh * d * pairs * cfg["num_hidden_layers"]


def encode_flops(cfg: dict, lengths: Sequence[int]) -> float:
    return token_linear_flops(cfg) * sum(lengths) + attention_flops(
        cfg, lengths)


def experts_work(cfg: dict, expert_slots: Iterable[np.ndarray]
                 ) -> Dict[str, float]:
    """The routed experts' least work over the forwards' routing counts
    (each (moe_layers, experts)): ops 2 x 3 x hidden x width a routed slot;
    bytes each expert's weights read once in each layer of each forward
    that routes it a token, and each slot's activations in and out (bf16,
    hidden wide)."""
    slots = active = 0
    for counts in expert_slots:
        counts = np.asarray(counts)
        slots += int(counts.sum())
        active += int(np.count_nonzero(counts))
    ops = 2.0 * expert_params(cfg) * slots
    nbytes = BF16_BYTES * (expert_params(cfg) * active
                           + 2 * cfg["hidden_size"] * slots)
    return {"ops": ops, "bytes": nbytes}
