"""The modules a run must not load: JAX and the JAX package.

Compared by top-level name, the part before the first dot, whole: the
port's name, ``vae_hmc_tpu_torch``, begins with the JAX package's.
"""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "vae_hmc_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_in(names: Iterable[str]) -> List[str]:
    return sorted({n for n in names if top_level(n) in FORBIDDEN})


def forbidden_loaded() -> List[str]:
    return forbidden_in(list(sys.modules))
