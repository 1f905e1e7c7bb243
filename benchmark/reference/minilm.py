"""Plain sentence embedding of all-MiniLM-L6-v2 (BERT encoder, mean pooling
over the attention mask, L2 normalization), from HuggingFace-named weights.

Tokens: [CLS], one id per whitespace-separated word of the text (the
corpus's vocabulary holds every lyric word whole, so WordPiece keeps each
word as one piece), [SEP]; at most ``max_len`` ids.  Attention is two
products and a softmax with a -1e9 additive mask on padded keys; GELU is
exact (erf); LayerNorm eps 1e-12; token type 0; positions 0..S-1.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def tokenize(texts: Sequence[Optional[str]], vocab: Dict[str, int],
             max_len: int):
    rows = []
    for t in texts:
        ids = [vocab["[CLS]"]] + [vocab.get(w, vocab["[UNK]"])
                                  for w in (t or "").lower().split()]
        rows.append(ids[:max_len - 1] + [vocab["[SEP]"]])
    seq = max(len(r) for r in rows)
    ids = np.full((len(rows), seq), vocab["[PAD]"], np.int64)
    mask = np.zeros((len(rows), seq), np.float32)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
        mask[i, :len(r)] = 1.0
    return ids, mask


def _ln(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def encode(w: Dict[str, torch.Tensor], cfg: dict, ids: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """(B, S) ids and mask -> (B, hidden) unit rows."""
    eps = cfg["layer_norm_eps"]
    b, s = ids.shape
    heads = cfg["num_attention_heads"]
    d = cfg["hidden_size"] // heads
    h = (w["embeddings.word_embeddings.weight"][ids]
         + w["embeddings.position_embeddings.weight"][:s][None]
         + w["embeddings.token_type_embeddings.weight"][0][None, None])
    h = _ln(h, w["embeddings.LayerNorm.weight"], w["embeddings.LayerNorm.bias"],
            eps)
    bias = (1.0 - mask[:, None, None, :]) * -1e9
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{i}."

        def lin(x, name):
            return x @ w[p + name + ".weight"].T + w[p + name + ".bias"]

        def split(x):
            return x.view(b, s, heads, d).transpose(1, 2)

        q = split(lin(h, "attention.self.query"))
        k = split(lin(h, "attention.self.key"))
        v = split(lin(h, "attention.self.value"))
        att = torch.softmax(q @ k.transpose(2, 3) / math.sqrt(d) + bias, -1)
        ctx = (att @ v).transpose(1, 2).reshape(b, s, -1)
        h = _ln(h + lin(ctx, "attention.output.dense"),
                w[p + "attention.output.LayerNorm.weight"],
                w[p + "attention.output.LayerNorm.bias"], eps)
        ff = lin(F.gelu(lin(h, "intermediate.dense")), "output.dense")
        h = _ln(h + ff, w[p + "output.LayerNorm.weight"],
                w[p + "output.LayerNorm.bias"], eps)
    m = mask[:, :, None]
    pooled = (h * m).sum(1) / torch.clamp(m.sum(1), min=1e-9)
    return pooled / torch.clamp(pooled.norm(dim=-1, keepdim=True), min=1e-12)


def embed(w: Dict[str, torch.Tensor], cfg: dict, texts: List[Optional[str]],
          vocab: Dict[str, int], max_len: int, batch: int) -> torch.Tensor:
    """(N,) texts -> (N, hidden) on the weights' device, `batch` at a time."""
    dev = next(iter(w.values())).device
    out = []
    for s in range(0, len(texts), batch):
        ids, mask = tokenize(texts[s:s + batch], vocab, max_len)
        out.append(encode(w, cfg, torch.as_tensor(ids, device=dev),
                          torch.as_tensor(mask, device=dev)))
    return torch.cat(out)
