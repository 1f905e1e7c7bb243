"""Regex language heuristic (copy of ``vae_hmc_tpu.text.langdetect``;
reference scripts/18:42-55 semantics exactly):
Bengali unicode block -> 'bn'; latin letters -> 'en'; other non-empty ->
'other'; empty/None -> 'none'."""
from __future__ import annotations

import re

_BN = re.compile(r"[ঀ-৿]")
_LATIN = re.compile(r"[A-Za-z]")


def detect_language_simple(text) -> str:
    if not isinstance(text, str) or not text.strip():
        return "none"
    if _BN.search(text):
        return "bn"
    if _LATIN.search(text):
        return "en"
    return "other"
