"""Track-id alignment — the system's cross-modality "schema" (copy of
``vae_hmc_tpu.core.align``; numpy only).

Every feature/latent array in the contract is paired with a track_ids array;
joins across modalities happen by id lookup.  The reference copy-pastes this
logic into scripts 12/13/14/16 (reference scripts/12:35-60
`align_lyrics_to_audio`, 13:38-57 `labels_for_ids`, 16:13-32
`load_label_map`); this is the single implementation.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def id_to_row(ids: np.ndarray) -> Dict:
    """id -> row index dict. Later duplicates win (dict-update semantics of the
    reference's `{tid: i for i, tid in enumerate(ids)}` comprehension)."""
    return {_norm_id(t): i for i, t in enumerate(np.asarray(ids))}


def _norm_id(t):
    """Track ids appear as int, np.int64 and str across artifacts; normalize."""
    if isinstance(t, (bytes, np.bytes_)):
        t = t.decode()
    if isinstance(t, (str, np.str_)):
        s = str(t).strip()
        try:
            return int(s)
        except ValueError:
            return s
    return int(t)


def align_secondary_to_primary(
    primary_ids: np.ndarray,
    secondary_ids: np.ndarray,
    secondary: np.ndarray,
    fill_value: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Row-align `secondary` (M, D) to the order of `primary_ids` (N,).

    Rows with no match get `fill_value` vectors and mask 0.0 — the
    missing-lyrics gating semantics of reference scripts/12:43-60: the conv
    multimodal VAE consumes a zero lyrics vector and a presence mask.

    Returns (aligned (N, D), mask (N,) float32).
    """
    secondary = np.asarray(secondary)
    lookup = id_to_row(secondary_ids)
    n = len(primary_ids)
    out = np.full((n,) + secondary.shape[1:], fill_value, dtype=secondary.dtype)
    mask = np.zeros((n,), dtype=np.float32)
    for i, tid in enumerate(np.asarray(primary_ids)):
        j = lookup.get(_norm_id(tid))
        if j is not None:
            out[i] = secondary[j]
            mask[i] = 1.0
    return out, mask


def labels_for_ids(
    ids: np.ndarray,
    label_map: Dict,
    missing: str = "unknown",
) -> np.ndarray:
    """Map track ids to string labels (reference scripts/13:38-57)."""
    return np.asarray([label_map.get(_norm_id(t), missing) for t in np.asarray(ids)])


def encode_labels(labels: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """String labels -> (int codes, sorted unique classes).

    Sorted-unique index maps mirror reference scripts/18:224-232.
    """
    labels = np.asarray(labels)
    classes = np.unique(labels)
    lut = {c: i for i, c in enumerate(classes)}
    codes = np.asarray([lut[l] for l in labels], dtype=np.int32)
    return codes, classes
