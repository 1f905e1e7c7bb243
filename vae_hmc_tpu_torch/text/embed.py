"""Hashed lyrics embedding (copy of ``vae_hmc_tpu.text.embed.hashed_embedding``).

The deterministic 384-d token-hash bag embedding, L2-normalized: the JAX
package's cheap lyrics backend (``bench.py`` with ``BENCH_LYRICS=hashed``).
The MiniLM transformer backend is not ported yet; callers name the backend
they used.
"""
from __future__ import annotations

import hashlib
import re
from typing import List

import numpy as np

BACKEND = "hashed"

_TOKEN = re.compile(r"(?u)\b\w\w+\b")


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
