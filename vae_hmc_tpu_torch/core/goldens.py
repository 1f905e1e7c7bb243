"""Full-scale quality goldens: a drift tripwire (port of
``vae_hmc_tpu.core.goldens`` for the three tiers).

The repository commits QUALITY_GOLDENS.json with certified full-scale
quality columns; a tier run at a matching (tier, platform, n_tracks) key
compares its freshly written artifacts against them and reports a
``quality_drift`` status:
  * exact float equality unless the entry sets ``_rtol``;
  * keys embed the platform and the track count, so a run with no
    certified entry reports "no-golden" rather than false drift.  The
    platform is the port's device: "gpu" for CUDA, "cpu" otherwise (the
    JAX package asks ``jax.default_backend()``).  The file holds only the
    JAX package's ``:tpu:`` entries, so every run of the port reads
    "no-golden" until the port certifies its own;
  * VAE_HMC_QUALITY_STRICT=1 escalates drift to a RuntimeError.
The file is read, never written.  ``extract_bench`` (bench.py's headline
row) comes with the port's benchmark.
"""
from __future__ import annotations

import csv
import json
import math
import os
from pathlib import Path
from typing import Dict, List, Optional

import torch

GOLDENS_FILENAME = "QUALITY_GOLDENS.json"

# Metrics compared per artifact row.  Counts are included: a clustering
# that moves labels but keeps silhouette identical is still drift.
_MEDIUM_COLS = ("n_clusters_found", "n_noise", "silhouette",
                "davies_bouldin", "ari")
_EASY_COLS = ("silhouette", "calinski_harabasz", "pca_variance")
_HARD_BASELINE_COLS = ("silhouette", "nmi", "ari", "purity")


def goldens_path() -> Path:
    env = os.environ.get("VAE_HMC_GOLDENS_PATH")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / GOLDENS_FILENAME


def load_goldens(path: Optional[Path] = None) -> Dict:
    p = path or goldens_path()
    if not p.is_file():
        return {}
    return json.loads(p.read_text())


def _fnum(v) -> Optional[float]:
    if v is None or v == "":
        return None
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def _csv_rows(path: Path) -> List[Dict[str, str]]:
    with open(path, newline="") as f:
        return [dict(r) for r in csv.DictReader(f)]


def extract_easy(results_dir: Path) -> Dict[str, Dict[str, float]]:
    """compare_metrics/metrics.csv (script 09 contract): every method|input
    row's silhouette / CH / explained-variance columns."""
    rows = _csv_rows(results_dir / "compare_metrics" / "metrics.csv")
    return {f"{r['method']}|{r['input']}":
            {c: _fnum(r.get(c)) for c in _EASY_COLS} for r in rows}


def extract_medium(results_dir: Path) -> Dict[str, Dict[str, float]]:
    """medium_clustering_metrics_all.csv (script 13 contract): the full
    fixed-k suite — 3 representations x all algos."""
    rows = _csv_rows(results_dir / "medium_clustering_metrics_all.csv")
    return {f"{r['representation']}|{r['algo']}|{r['params']}":
            {c: _fnum(r.get(c)) for c in _MEDIUM_COLS} for r in rows}


def extract_hard(results_dir: Path) -> Dict[str, Dict[str, float]]:
    """hard/hard_metrics_vae_latents.json (script 20) + every row of
    hard/baseline_comparison.csv (script 22)."""
    out: Dict[str, Dict[str, float]] = {}
    mp = results_dir / "hard" / "hard_metrics_vae_latents.json"
    metrics = json.loads(mp.read_text())
    out["vae_latents"] = {k: _fnum(v) for k, v in metrics.items()
                          if _fnum(v) is not None}
    for r in _csv_rows(results_dir / "hard" / "baseline_comparison.csv"):
        key = r.get("method") or r.get("representation") or "?"
        out[f"baseline|{key}"] = {c: _fnum(r.get(c))
                                  for c in _HARD_BASELINE_COLS if c in r}
    return out


_EXTRACTORS = {"easy": extract_easy, "medium": extract_medium,
               "hard": extract_hard}


def _values_equal(a: Optional[float], b: Optional[float],
                  rtol: float) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    if rtol == 0.0:
        return a == b
    return abs(a - b) <= rtol * max(abs(a), abs(b), 1e-12)


def check(key: str, observed: Dict[str, Dict[str, float]],
          goldens: Optional[Dict] = None) -> Dict:
    """Compare observed rows against the committed golden entry for `key`.

    Returns {"status": "ok"|"drift"|"no-golden", "key", "mismatches"}.
    With VAE_HMC_QUALITY_STRICT=1, drift raises RuntimeError instead.
    """
    g = load_goldens() if goldens is None else goldens
    entry = g.get(key)
    if entry is None:
        return {"status": "no-golden", "key": key, "mismatches": []}
    rtol = float(entry.get("_rtol", 0.0))
    mismatches: List[str] = []
    for row_key, want in entry.items():
        if row_key.startswith("_"):
            continue
        got = observed.get(row_key)
        if got is None:
            mismatches.append(f"{row_key}: row missing from artifacts")
            continue
        for col, wv in want.items():
            gv = got.get(col)
            if not _values_equal(_fnum(wv), gv, rtol):
                mismatches.append(f"{row_key}.{col}: golden={wv} got={gv}")
    for row_key in observed:
        if row_key not in entry:
            mismatches.append(f"{row_key}: new row not in goldens")
    status = "ok" if not mismatches else "drift"
    result = {"status": status, "key": key, "mismatches": mismatches}
    if status == "drift" and os.environ.get("VAE_HMC_QUALITY_STRICT") == "1":
        raise RuntimeError(
            f"quality drift vs {GOLDENS_FILENAME} [{key}]:\n  "
            + "\n  ".join(mismatches))
    return result


def golden_key(tier: str, n_tracks: int, device) -> str:
    platform = "gpu" if torch.device(device).type == "cuda" else "cpu"
    return f"{tier}:{platform}:{n_tracks}"


def check_tier(tier: str, results_dir: Path, n_tracks: int, device,
               quiet: bool = False) -> Dict:
    """Extract `tier`'s headline artifacts and compare them with the
    goldens; called at the end of a tier's pipeline."""
    key = golden_key(tier, n_tracks, device)
    try:
        observed = _EXTRACTORS[tier](Path(results_dir))
    except (FileNotFoundError, KeyError) as e:
        result = {"status": "no-artifacts", "key": key,
                  "mismatches": [f"extract failed: {e!r}"]}
        if not quiet:
            print(f"[goldens] {result['status']} ({key})")
        return result
    result = check(key, observed)
    if not quiet:
        if result["status"] == "drift":
            print(f"[goldens] QUALITY DRIFT vs committed goldens ({key}):")
            for m in result["mismatches"]:
                print(f"[goldens]   {m}")
        else:
            print(f"[goldens] {result['status']} ({key})")
    return result
