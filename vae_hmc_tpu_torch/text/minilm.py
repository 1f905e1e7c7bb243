"""MiniLM (all-MiniLM-L6-v2) sentence encoder in PyTorch (port of
``vae_hmc_tpu.text.minilm``).

The reference embeds lyrics with the sentence-transformers encoder
(reference scripts/11:85-93, 18:211-213): a 6-layer / 384-wide / 12-head
BERT encoder, mean-pooled over the attention mask and L2-normalized.

Weights are not bundled (no network to download them): ``load_minilm``
reads a local HuggingFace checkout (``pytorch_model.bin`` or
``model.safetensors`` plus ``vocab.txt``); ``synthetic_minilm`` builds
randomly initialized weights of the real shapes for timing the
transformer path.  ``WordPieceTokenizer`` is a verbatim copy of the JAX
package's.

Numerics follow the Flax module: exact (erf) GELU, LayerNorm eps 1e-12,
position ids ``arange(seq)``, token type 0, a -1e9 additive key mask,
pooling divisor ``max(sum(mask), 1e-9)`` and norm floor 1e-12.  Attention
is written as two matmuls and a softmax: the fused fp32 attention kernels
behind ``scaled_dot_product_attention`` on the GPU run their products on
the tensor cores in a reduced-precision fp32 mode, and parity mode keeps
every contraction IEEE fp32 (TF32 off, ``core.device``).
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import struct
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vae_hmc_tpu_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MiniLMConfig:
    """all-MiniLM-L6-v2 hyperparameters (reference script 11 embeds with
    this exact sentence-transformers model)."""
    vocab_size: int = 30522
    hidden: int = 384
    layers: int = 6
    heads: int = 12
    intermediate: int = 1536
    max_pos: int = 512
    type_vocab: int = 2
    ln_eps: float = 1e-12
    max_seq_len: int = 256  # sentence-transformers truncates at 256 here


class _Layer(nn.Module):
    def __init__(self, cfg: MiniLMConfig):
        super().__init__()
        h = cfg.hidden
        self.heads = cfg.heads
        self.q = nn.Linear(h, h)
        self.k = nn.Linear(h, h)
        self.v = nn.Linear(h, h)
        self.att_out = nn.Linear(h, h)
        self.att_ln = nn.LayerNorm(h, eps=cfg.ln_eps)
        self.ff1 = nn.Linear(h, cfg.intermediate)
        self.ff2 = nn.Linear(cfg.intermediate, h)
        self.ff_ln = nn.LayerNorm(h, eps=cfg.ln_eps)

    def forward(self, h: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        b, s, width = h.shape
        d_head = width // self.heads

        def split(t):                    # (b, s, width) -> (b, heads, s, d)
            return t.view(b, s, self.heads, d_head).transpose(1, 2)

        q, k, v = split(self.q(h)), split(self.k(h)), split(self.v(h))
        att = torch.matmul(q, k.transpose(2, 3)) / math.sqrt(d_head)
        att = torch.softmax(att + mask_bias, dim=-1)
        ctx = torch.matmul(att, v).transpose(1, 2).reshape(b, s, width)
        h = self.att_ln(h + self.att_out(ctx))
        ff = self.ff2(nn.functional.gelu(self.ff1(h), approximate="none"))
        return self.ff_ln(h + ff)


class MiniLM(nn.Module):
    def __init__(self, cfg: MiniLMConfig = MiniLMConfig()):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.pos_emb = nn.Embedding(cfg.max_pos, cfg.hidden)
        self.type_emb = nn.Embedding(cfg.type_vocab, cfg.hidden)
        self.emb_ln = nn.LayerNorm(cfg.hidden, eps=cfg.ln_eps)
        self.layers = nn.ModuleList(_Layer(cfg) for _ in range(cfg.layers))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        """(B, S) int ids, (B, S) float 0/1 mask -> (B, hidden) unit rows."""
        seq = input_ids.shape[1]
        pos = torch.arange(seq, device=input_ids.device)[None, :]
        h = self.emb_ln(self.tok_emb(input_ids) + self.pos_emb(pos)
                        + self.type_emb(torch.zeros_like(input_ids)))
        mask_bias = (1.0 - attention_mask[:, None, None, :]) * -1e9
        for layer in self.layers:
            h = layer(h, mask_bias)
        # mean pooling over attention mask + L2 norm (st pooling config)
        m = attention_mask[:, :, None]
        pooled = torch.sum(h * m, dim=1) / torch.clamp(torch.sum(m, dim=1),
                                                       min=1e-9)
        return pooled / torch.clamp(
            torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-12)


# ---------------------------------------------------------------------------
# WordPiece tokenizer (BERT uncased)
# ---------------------------------------------------------------------------


class WordPieceTokenizer:
    def __init__(self, vocab: Dict[str, int], max_len: int = 256):
        self.vocab = vocab
        self.max_len = max_len
        self.cls = vocab["[CLS]"]
        self.sep = vocab["[SEP]"]
        self.pad = vocab["[PAD]"]
        self.unk = vocab["[UNK]"]

    @classmethod
    def from_vocab_file(cls, path: Path, max_len: int = 256):
        vocab = {}
        for i, line in enumerate(Path(path).read_text(encoding="utf-8").splitlines()):
            vocab[line.strip()] = i
        return cls(vocab, max_len)

    def _basic_tokens(self, text: str) -> List[str]:
        text = text.lower()
        text = re.sub(r"\s+", " ", text)
        out, buf = [], []
        for ch in text:
            if ch.isalnum():
                buf.append(ch)
            else:
                if buf:
                    out.append("".join(buf))
                    buf = []
                if not ch.isspace():
                    out.append(ch)
        if buf:
            out.append("".join(buf))
        return out

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > 100:
            return [self.unk]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            ids.append(cur)
            start = end
        return ids

    def encode_batch(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        rows = []
        for t in texts:
            ids = [self.cls]
            for w in self._basic_tokens(t):
                ids.extend(self._wordpiece(w))
                if len(ids) >= self.max_len - 1:
                    break
            ids = ids[: self.max_len - 1] + [self.sep]
            rows.append(ids)
        seq = max(len(r) for r in rows)
        out = np.full((len(rows), seq), self.pad, dtype=np.int32)
        mask = np.zeros((len(rows), seq), dtype=np.float32)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
            mask[i, : len(r)] = 1.0
        return out, mask


# ---------------------------------------------------------------------------
# Weight loading from a local HF checkout
# ---------------------------------------------------------------------------

_HF_MAP = {
    "tok_emb": "embeddings.word_embeddings.weight",
    "pos_emb": "embeddings.position_embeddings.weight",
    "type_emb": "embeddings.token_type_embeddings.weight",
    "emb_ln": ("embeddings.LayerNorm.weight", "embeddings.LayerNorm.bias"),
}


def _layer_map(i: int) -> Dict[str, str]:
    p = f"encoder.layer.{i}."
    return {
        "q": p + "attention.self.query",
        "k": p + "attention.self.key",
        "v": p + "attention.self.value",
        "att_out": p + "attention.output.dense",
        "att_ln": p + "attention.output.LayerNorm",
        "ff1": p + "intermediate.dense",
        "ff2": p + "output.dense",
        "ff_ln": p + "output.LayerNorm",
    }


_SAFETENSORS_DTYPES = {"F64": torch.float64, "F32": torch.float32,
                       "F16": torch.float16, "BF16": torch.bfloat16,
                       "I64": torch.int64, "I32": torch.int32}


def read_safetensors(path: Path) -> Dict[str, torch.Tensor]:
    """Tensors of a ``.safetensors`` file: an 8-byte little-endian header
    length, a JSON header {name: {dtype, shape, data_offsets}}, then the raw
    little-endian data (offsets relative to the end of the header)."""
    raw = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    data = memoryview(raw)[8 + n:]
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype "
                             f"{meta['dtype']}")
        begin, end = meta["data_offsets"]
        flat = torch.frombuffer(bytearray(data[begin:end]), dtype=dtype)
        out[name] = flat.reshape(meta["shape"])
    return out


def _load_state_dict(model_dir: Path) -> Dict[str, torch.Tensor]:
    model_dir = Path(model_dir)
    st = model_dir / "model.safetensors"
    if st.exists():
        return read_safetensors(st)
    bin_p = model_dir / "pytorch_model.bin"
    if bin_p.exists():
        return torch.load(bin_p, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no model weights in {model_dir}")


def hf_to_state_dict(sd: Dict[str, torch.Tensor],
                     cfg: MiniLMConfig) -> Dict[str, torch.Tensor]:
    """HF BERT names -> this module's names.  HF stores dense weights as
    torch (out, in) already, so every tensor passes through unchanged;
    keys the encoder does not use (the pooler) are dropped."""
    sd = {k.removeprefix("bert."): v for k, v in sd.items()}
    out = {"tok_emb.weight": sd[_HF_MAP["tok_emb"]],
           "pos_emb.weight": sd[_HF_MAP["pos_emb"]],
           "type_emb.weight": sd[_HF_MAP["type_emb"]],
           "emb_ln.weight": sd[_HF_MAP["emb_ln"][0]],
           "emb_ln.bias": sd[_HF_MAP["emb_ln"][1]]}
    for i in range(cfg.layers):
        for name, src in _layer_map(i).items():
            for leaf in ("weight", "bias"):
                out[f"layers.{i}.{name}.{leaf}"] = sd[f"{src}.{leaf}"]
    return {k: v.to(torch.float32) for k, v in out.items()}


def load_minilm(model_dir: Path, cfg: MiniLMConfig = MiniLMConfig(),
                device="cuda") -> Tuple[MiniLM, WordPieceTokenizer]:
    """-> (MiniLM on `device`, in eval mode, tokenizer).  Raises if the
    weights or the vocab are absent, or if a tensor's shape is not `cfg`'s.
    (The JAX package returns (module, params, tokenizer); here the weights
    live in the module.)"""
    dev = resolve_device(device)
    model_dir = Path(model_dir)
    tok = WordPieceTokenizer.from_vocab_file(model_dir / "vocab.txt",
                                             cfg.max_seq_len)
    model = MiniLM(cfg)
    model.load_state_dict(hf_to_state_dict(_load_state_dict(model_dir), cfg))
    return model.to(dev).eval(), tok


def _init_like_flax(model: MiniLM, gen: torch.Generator) -> None:
    """Flax's default initializers, drawn from `gen`: ``nn.Embed`` N(0,
    1/features); ``nn.Dense`` kernels lecun_normal, a normal truncated to
    +-2 std whose std is sqrt(1/fan_in) / 0.8796 (the truncation's own
    std), and zero biases; LayerNorm scale 1 and bias 0."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.weight.shape[1]),
                                   generator=gen)
            elif isinstance(mod, nn.Linear):
                std = 1.0 / math.sqrt(mod.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=gen)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()


def corpus_vocab(texts: Sequence[str], vocab_size: int) -> Dict[str, int]:
    """Special tokens, then every corpus word as a whole-word entry in order
    of first appearance (the JAX package's ``synthetic_minilm`` vocab)."""
    vocab: Dict[str, int] = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3}
    for t in texts:
        for w in re.findall(r"[a-z0-9']+", t.lower()):
            if len(vocab) >= vocab_size:
                break
            vocab.setdefault(w, len(vocab))
    return vocab


def synthetic_minilm(texts: Sequence[str] = (), seed: int = 7,
                     cfg: MiniLMConfig = MiniLMConfig(),
                     device="cuda") -> Tuple[MiniLM, WordPieceTokenizer]:
    """Real-shaped, randomly initialized MiniLM + a corpus-derived vocab.

    For timing the transformer path when the real checkpoint is not
    available: the parameter shapes and therefore the compute are exactly
    those of the real all-MiniLM-L6-v2 forward; the values are random, so
    the embeddings mean nothing for quality.  The weights are drawn on the
    host from a ``torch.Generator`` seeded with `seed` (the same
    distributions as the JAX package's Flax initializers, not its values),
    then moved to `device`.  The vocab holds every word of `texts` whole,
    so WordPiece walks the longest-match path it would with a real vocab.
    """
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = MiniLM(cfg)
    _init_like_flax(model, gen)
    tok = WordPieceTokenizer(corpus_vocab(texts, cfg.vocab_size),
                             cfg.max_seq_len)
    return model.to(dev).eval(), tok


def encode_texts(model: MiniLM, tok: WordPieceTokenizer, texts: List[str],
                 batch_size: int = 128, to_host: bool = True):
    """(M,) texts -> (M, hidden) float32 embeddings, on the model's device.

    Tokenization runs on the host; each batch is padded to its own longest
    row.  (The JAX package pads every batch to 256 only so that one
    compiled program serves the whole corpus; a masked key gets weight
    exp(-1e9) = 0 exactly and padded rows are excluded from the pooling, so
    the padding length does not change the embeddings.)  to_host=False
    returns the device tensor."""
    dev = next(model.parameters()).device
    out = []
    with torch.no_grad():
        for s in range(0, len(texts), batch_size):
            ids, mask = tok.encode_batch(texts[s: s + batch_size])
            out.append(model(torch.from_numpy(ids).to(dev, torch.int64),
                             torch.from_numpy(mask).to(dev)))
    emb = torch.cat(out) if out else torch.zeros(
        (0, model.cfg.hidden), device=dev)
    return emb.cpu().numpy() if to_host else emb


def encode_texts_minilm(texts: List[str], model_dir: Path,
                        batch_size: int = 64, device="cuda") -> np.ndarray:
    model, tok = load_minilm(model_dir, device=device)
    return encode_texts(model, tok, texts, batch_size=batch_size)
