"""Artifact I/O honoring the reference filesystem contract (the parts of
``vae_hmc_tpu.core.artifacts`` that the ported stages write or read).

The reference's de-facto public API is its file tree: .npy arrays paired
with *_track_ids.npy, metric .csv/.json files (SURVEY.md §1).  Here:
  - npy/csv/json writers with directory creation;
  - the `--tag` snapshot system (reference scripts/19:35-47, 20:20-26,
    21:26-32, 22:36-42: canonical file always overwritten, tagged copy
    preserved);
  - paired array+ids load with shape validation (07:40-55 semantics);
  - checkpoint save/load in the JAX package's format: one .npz whose keys
    are the parameter tree's paths joined by "/" (the Flax tree's, e.g.
    ``params/enc_conv1/kernel``, in Flax layouts; see
    ``models.convert.conv_mm_vae_flax_params``) and a ``.meta.json``
    sidecar, so either package loads the other's checkpoints.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np


def tagged_path(path: Path, tag: Optional[str]) -> Path:
    """`results/foo.json` + tag 'beta_b4' -> `results/foo_beta_b4.json`.

    Mirrors reference scripts/19:35-38 `tagged_path`.
    """
    path = Path(path)
    if not tag:
        return path
    return path.with_name(f"{path.stem}_{tag}{path.suffix}")


def save_and_snapshot(write_fn, path: Path, tag: Optional[str] = None) -> Path:
    """Write canonical artifact, then an identical tagged copy if tag given.

    Mirrors reference scripts/19:40-47 `save_and_snapshot`: the canonical file
    is always (over)written; the tagged sibling preserves the experiment.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    write_fn(path)
    if tag:
        write_fn(tagged_path(path, tag))
    return path


def save_npy(path: Path, arr: np.ndarray, tag: Optional[str] = None) -> Path:
    arr = np.asarray(arr)
    return save_and_snapshot(lambda p: np.save(p, arr), Path(path), tag)


def save_json(path: Path, obj: Any, tag: Optional[str] = None) -> Path:
    def _w(p: Path):
        p.write_text(json.dumps(obj, indent=2, default=_json_default))
    return save_and_snapshot(_w, Path(path), tag)


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, Path):
        return str(o)
    raise TypeError(f"not json-serializable: {type(o)}")


def save_csv_rows(path: Path, header: Sequence[str],
                  rows: Iterable[Sequence[Any]],
                  tag: Optional[str] = None) -> Path:
    """Plain CSV writer (no pandas)."""
    rows = [list(r) for r in rows]

    def _w(p: Path):
        with open(p, "w") as f:
            f.write(",".join(map(str, header)) + "\n")
            for r in rows:
                f.write(",".join(_csv_cell(c) for c in r) + "\n")
    return save_and_snapshot(_w, Path(path), tag)


def _csv_cell(c: Any) -> str:
    if isinstance(c, float) or isinstance(c, np.floating):
        return repr(float(c))
    s = str(c)
    if "," in s or '"' in s or "\n" in s:
        s = '"' + s.replace('"', '""') + '"'
    return s


def load_features(x_path: Path, ids_path: Path) -> Tuple[np.ndarray, np.ndarray]:
    """Load + validate a feature/id pair (reference scripts/07:40-55 checks)."""
    x_path, ids_path = Path(x_path), Path(ids_path)
    if not x_path.exists():
        raise FileNotFoundError(f"missing features: {x_path}")
    if not ids_path.exists():
        raise FileNotFoundError(f"missing track ids: {ids_path}")
    x = np.load(x_path)
    ids = np.load(ids_path, allow_pickle=True)
    if x.shape[0] != ids.shape[0]:
        raise ValueError(
            f"row mismatch {x_path.name}={x.shape[0]} vs {ids_path.name}={ids.shape[0]}")
    return x, ids


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> {"a/b/c": leaf}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, key + "/"))
        else:
            flat[key] = v
    return flat


def save_checkpoint(path: Path, params: Dict, metadata: Optional[Dict] = None,
                    tag: Optional[str] = None) -> Path:
    """A nested dict of arrays as one .npz (keys: the "/"-joined paths) and
    a metadata json sidecar, ``<path>.meta.json``.  The file keeps the
    contract's name (e.g. ``ckpt_epoch_025.pt``): no ".npz" is appended."""
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}

    def _w(p: Path):
        with open(p, "wb") as f:
            np.savez(f, **flat)
        meta_p = p.with_suffix(p.suffix + ".meta.json")
        meta_p.write_text(json.dumps(metadata or {}, indent=2,
                                     default=_json_default))
    return save_and_snapshot(_w, Path(path), tag)


def load_checkpoint(path: Path, like: Optional[Dict] = None):
    """Load a checkpoint saved by ``save_checkpoint`` (or by the JAX
    package's).  -> (flat {path: array}, metadata), or with `like` (a
    nested dict of the same structure) (nested dict of arrays, metadata);
    a missing key or a shape that differs from `like`'s raises."""
    path = Path(path)
    with np.load(path, allow_pickle=False) as npz:
        data = dict(npz)
    meta_p = path.with_suffix(path.suffix + ".meta.json")
    metadata = json.loads(meta_p.read_text()) if meta_p.exists() else {}
    if like is None:
        return data, metadata

    def rebuild(tree: Dict, prefix: str) -> Dict:
        out = {}
        for k, v in tree.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                out[k] = rebuild(v, key + "/")
                continue
            if key not in data:
                raise KeyError(f"checkpoint missing param {key}")
            if tuple(data[key].shape) != tuple(np.shape(v)):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{data[key].shape} vs {np.shape(v)}")
            out[k] = data[key]
        return out
    return rebuild(like, ""), metadata
