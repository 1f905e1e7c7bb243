"""Lyrics embedding API with its backend chain (port of
``vae_hmc_tpu.text.embed``).

Order, as in the JAX package (which mirrors the reference's
sentence-transformers -> TF-IDF fallback, scripts/18:209-222), after the
port's own first backend:
  0. a MoE LM encoder given by the caller (``lm=``, ``text.moe_lm``,
     Moonlight-16B-A3B) over token ids (``lm_ids=``) -> (M, hidden)
     normalized; its tokenizer (``tiktoken.model``) is not in the
     repository, so text without ids raises;
  1. MiniLM with local weights (env VAE_HMC_MINILM_DIR, an explicit
     model_dir argument, or the HF cache) -> (M, 384) normalized — the
     reference's scripts/11 behavior;
  2. TF-IDF (max_features cap, english stop words) — the reference's own
     hard-tier fallback (18:221-222), ``text.tfidf``;
  3. 'hashed': the deterministic 384-d token-hash bag embedding,
     L2-normalized (a copy of the JAX package's), flagged in the returned
     backend name.
"""
from __future__ import annotations

import hashlib
import os
import re
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from vae_hmc_tpu_torch.core.config import TextEmbedConfig
from vae_hmc_tpu_torch.text.tfidf import TfidfVectorizer

_TOKEN = re.compile(r"(?u)\b\w\w+\b")


def find_minilm_dir(cfg: TextEmbedConfig = TextEmbedConfig()
                    ) -> Optional[Path]:
    """The MiniLM checkpoint directory: VAE_HMC_MINILM_DIR when it names an
    existing path, else the newest HF-cache snapshot of cfg.model_name,
    else None.  The one place the port looks for weights."""
    env = os.environ.get("VAE_HMC_MINILM_DIR")
    if env and Path(env).exists():
        return Path(env)
    # HF cache layout
    cache = Path(os.environ.get("HF_HOME", Path.home() / ".cache/huggingface"))
    pat = cfg.model_name.replace("/", "--")
    hub = cache / "hub" / f"models--{pat}" / "snapshots"
    if hub.exists():
        snaps = sorted(hub.iterdir())
        if snaps:
            return snaps[-1]
    return None


def hashed_embedding(texts: List[str], dim: int = 384) -> np.ndarray:
    """Deterministic token-hash bag embedding, L2-normalized."""
    out = np.zeros((len(texts), dim), dtype=np.float32)
    for i, t in enumerate(texts):
        for tok in _TOKEN.findall((t or "").lower()):
            h = int.from_bytes(hashlib.blake2b(
                tok.encode(), digest_size=8).digest(), "little")
            sign = 1.0 if (h >> 32) & 1 else -1.0
            out[i, h % dim] += sign
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    norms[norms == 0.0] = 1.0
    return out / norms


def embed_texts(texts: List[str], cfg: TextEmbedConfig = TextEmbedConfig(),
                model_dir: Optional[Path] = None,
                allow_tfidf: bool = True,
                device="cuda", lm=None, lm_ids: Optional[Sequence] = None
                ) -> Tuple[np.ndarray, str]:
    """-> (embeddings (M, D) f32 on the host, backend name).

    With `lm` (a loaded ``moe_lm.MoeLM``, on its own device) the texts'
    token ids `lm_ids` (one sequence a text) are encoded by it, backend
    "moe_lm"; without ids it raises FileNotFoundError naming
    ``tiktoken.model``.

    MiniLM runs when a model directory is found; the chain falls through to
    the next backend only when none is.  A directory that is found but
    fails to load raises (the JAX package falls through on any error).
    With no directory, allow_tfidf=True gives TF-IDF (D = the corpus's
    vocabulary, at most cfg.tfidf_max_features) and allow_tfidf=False the
    hashed backend."""
    if lm is not None:
        from vae_hmc_tpu_torch.text import moe_lm
        if lm_ids is None:
            raise FileNotFoundError(moe_lm.MISSING_TOKENIZER)
        if len(lm_ids) != len(texts):
            raise ValueError(f"{len(lm_ids)} id sequences for {len(texts)} "
                             "texts")
        return moe_lm.encode_ids(lm, lm_ids, to_host=True), "moe_lm"
    mdir = Path(model_dir) if model_dir else find_minilm_dir(cfg)
    if mdir is not None:
        from vae_hmc_tpu_torch.text.minilm import encode_texts_minilm
        return encode_texts_minilm(list(texts), mdir, cfg.batch_size,
                                   device=device), "minilm"
    if allow_tfidf:
        vect = TfidfVectorizer(max_features=cfg.tfidf_max_features,
                               stop_words="english")
        emb = vect.fit_transform([t if (t or "").strip() else " "
                                  for t in texts])
        return emb.astype(np.float32), "tfidf"
    return hashed_embedding(list(texts), cfg.embed_dim), "hashed"
