"""Medium tier, scripts 11, 13 and 16 (port of the matching parts of
``vae_hmc_tpu.pipelines.medium``).

Writes the reference's artifact contract for these stages:

  data/lyrics_embeddings.npy (M,D) + lyrics_track_ids.npy
  results/lyrics_embedding_report.csv                         (script 11)
  results/medium_clustering_metrics_all.csv                   (script 13)
  results/medium_full_sweep_metrics.csv
    + medium_full_sweep_best_by_representation.csv
    + medium_full_sweep_best_overall.csv                      (script 16)

Scripts 13 and 16 share one ``RepData`` per representation (its kernel 2
distance matrix, host copy and ward linkage), as ``run_medium_pipeline``
chains them in the JAX package; ``scripts_11_13_16`` chains 11, 13 and 16
on the tensors of ``pipelines.bench_chain.run_core``.  Scripts 10, 12, 14,
15 and 17 and the pipeline runner are not ported yet (ROADMAP Queue 1
item 3).
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from vae_hmc_tpu_torch.cluster import sweep as sweep_mod
from vae_hmc_tpu_torch.cluster.sweep import RepData
from vae_hmc_tpu_torch.core import artifacts
from vae_hmc_tpu_torch.core.align import labels_for_ids
from vae_hmc_tpu_torch.core.config import (SweepConfig, TextEmbedConfig,
                                           Workspace)
from vae_hmc_tpu_torch.core.device import resolve_device, synchronize
from vae_hmc_tpu_torch.ops.scaler import StandardScaler


# ---------------------------------------------------------------------------
# Script 11: lyrics embeddings
# ---------------------------------------------------------------------------


def build_lyrics_embeddings(source, ws: Workspace,
                            cfg: TextEmbedConfig = TextEmbedConfig(),
                            device="cuda") -> Dict:
    """Embeds rows with >= cfg.min_chars of text (reference scripts/11:43);
    skipped rows recorded in the report CSV (11:58-76)."""
    from vae_hmc_tpu_torch.text.embed import embed_texts

    texts, ids, rows = [], [], []
    for i in range(len(source)):
        tid = int(source.track_ids[i])
        t = source.lyrics_text(i) or ""
        n_chars = len(t.strip())
        if n_chars < cfg.min_chars:
            rows.append((tid, "skipped", "too_short", n_chars))
            continue
        texts.append(t)
        ids.append(tid)
        rows.append((tid, "ok", "", n_chars))
    if not texts:
        raise RuntimeError("no rows had usable text")
    # medium tier wants a fixed-width dense embedding (the conv VAE's lyrics
    # branch); minilm when weights exist, else hashed 384-d
    emb, backend = embed_texts(texts, cfg, allow_tfidf=False, device=device)
    ws.data.mkdir(parents=True, exist_ok=True)
    np.save(ws.data / "lyrics_embeddings.npy", emb.astype(np.float32))
    np.save(ws.data / "lyrics_track_ids.npy", np.asarray(ids, dtype=np.int64))
    artifacts.save_csv_rows(ws.results / "lyrics_embedding_report.csv",
                            ["track_id", "status", "reason", "n_chars"], rows)
    return {"emb": emb, "ids": np.asarray(ids), "backend": backend}


# ---------------------------------------------------------------------------
# Representations shared by scripts 13-16
# ---------------------------------------------------------------------------


def _build_rep(name, x, ids, genre_map, standardize, pca_dim: int = 0,
               device="cuda") -> RepData:
    """Host numpy or a tensor; a tensor stays on its device (standardizing
    there, sklearn-equivalent)."""
    if pca_dim:
        raise NotImplementedError(
            "pca_dim > 0 needs ops/pca, not ported yet (ROADMAP Queue 1 "
            "item 3)")
    if isinstance(x, torch.Tensor):
        x = x.reshape(x.shape[0], -1).to(torch.float32)
        if standardize:
            mean = torch.mean(x, dim=0)
            std = torch.std(x, dim=0, correction=0)    # ddof=0, sklearn
            x = (x - mean) / torch.where(std == 0.0, 1.0, std)
    else:
        x = np.asarray(x, np.float32).reshape(len(x), -1)
        if standardize:
            x = StandardScaler().fit_transform(x, device)
    y_true = labels_for_ids(ids, genre_map) if genre_map is not None else None
    return RepData.build(name, x, y_true, device)


def _load_reps(ws: Workspace, genre_map: Optional[Dict],
               standardize: bool = False,
               names: Sequence[str] = ("vae_mm_latents", "baseline_mel_flat",
                                       "baseline_lyrics_only"),
               arrays: Optional[Dict] = None,
               pca_dim: int = 0, device="cuda") -> List[RepData]:
    """arrays: optional {name: (x, ids)} overriding the on-disk artifacts —
    lets a caller thread stage outputs through memory."""
    paths = {
        "vae_mm_latents": (ws.data / "vae_mm_latents_mu.npy",
                           ws.data / "vae_mm_latents_track_ids.npy"),
        "baseline_mel_flat": (ws.data / "audio_cnn_mel_X.npy",
                              ws.data / "audio_cnn_mel_track_ids.npy"),
        "baseline_lyrics_only": (ws.data / "lyrics_embeddings.npy",
                                 ws.data / "lyrics_track_ids.npy"),
    }
    reps = []
    for name in names:
        if arrays is not None and name in arrays:
            x, ids = arrays[name]
        else:
            xp, ip = paths[name]
            x, ids = artifacts.load_features(xp, ip)
        reps.append(_build_rep(name, x, ids, genre_map, standardize, pca_dim,
                               device))
    return reps


def _rows_to_csv(rows: List[Dict], path: Path, header: List[str]) -> Path:
    return artifacts.save_csv_rows(
        path, header,
        [["" if r.get(h) is None else r.get(h) for h in header] for r in rows])


_HDR13 = ["representation", "algo", "params", "n_clusters_found", "n_noise",
          "silhouette", "davies_bouldin", "ari"]
_HDR16 = ["representation", "algo", "params", "n_clusters_found", "n_noise",
          "noise_frac", "silhouette", "davies_bouldin", "ari", "score"]


def cluster_and_evaluate(ws: Workspace, genre_map: Optional[Dict] = None,
                         n_clusters: int = 6,
                         standardize: bool = False,
                         arrays: Optional[Dict] = None,
                         pca_dim: int = 0,
                         reps: Optional[List[RepData]] = None,
                         device="cuda") -> List[Dict]:
    """Script 13: fixed-k suite over the 3 representations.

    `reps`: pass prebuilt RepData to share the cached distance matrices and
    ward linkages with full_clustering_sweep."""
    if reps is None:
        reps = _load_reps(ws, genre_map, standardize, arrays=arrays,
                          pca_dim=pca_dim, device=device)
    for rep in reps:             # every rep's linkage runs while rep 0 scores
        rep.ward_prefetch()
    rows: List[Dict] = []
    for rep in reps:
        rows += sweep_mod.cluster_suite(rep, n_clusters)
    _rows_to_csv(rows, ws.results / "medium_clustering_metrics_all.csv", _HDR13)
    # the reference prints a top-12 heuristic-score ranking view (13:226-236)
    ranked = sorted(rows, key=sweep_mod.heuristic_score, reverse=True)[:12]
    print("Top results (heuristic score):")
    for r in ranked:
        print(f"  {r['representation']:22s} {r['algo']:14s} "
              f"{r['params']:16s} score={sweep_mod.heuristic_score(r):.4f}")
    return rows


def full_clustering_sweep(ws: Workspace, genre_map: Optional[Dict] = None,
                          cfg: SweepConfig = SweepConfig(),
                          standardize: bool = False,
                          arrays: Optional[Dict] = None,
                          reps: Optional[List[RepData]] = None,
                          device="cuda") -> List[Dict]:
    """Script 16: full grid + best-by-representation + best-overall tables."""
    if reps is None:
        reps = _load_reps(ws, genre_map, standardize, cfg.representations,
                          arrays=arrays, device=device)
    for rep in reps:
        rep.ward_prefetch()
    rows: List[Dict] = []
    for rep in reps:
        rows += sweep_mod.full_sweep(rep, cfg.ks, cfg.dbscan_eps,
                                     cfg.dbscan_min_samples, seed=cfg.seed)
    _rows_to_csv(rows, ws.results / "medium_full_sweep_metrics.csv", _HDR16)
    by_score = sorted(rows, key=lambda r: r["score"], reverse=True)
    best_by_rep, seen = [], set()
    for r in by_score:
        if r["representation"] not in seen:
            seen.add(r["representation"])
            best_by_rep.append(r)
    _rows_to_csv(best_by_rep,
                 ws.results / "medium_full_sweep_best_by_representation.csv",
                 _HDR16)
    _rows_to_csv(by_score[:20],
                 ws.results / "medium_full_sweep_best_overall.csv", _HDR16)
    return rows


def scripts_11_13_16(source, ws: Workspace, mu: torch.Tensor,
                     features: torch.Tensor, ids: np.ndarray,
                     n_clusters: int = 6, cfg: SweepConfig = SweepConfig(),
                     device="cuda") -> Dict:
    """Scripts 11, 13 and 16 on the outputs of a run over `source`: the
    posterior means `mu` (N, latent) and log-mel `features` of the tracks
    `ids` (``run_core``'s ``"tensors"``, with its ``"source"``), the lyrics
    embedded from `source`, genres from `source`.  One RepData per
    representation is shared by 13 and 16.  Each script runs in a
    ``stage:<name>`` profiler range and ends in a synchronize.
    -> {"seconds", "rows13", "rows16", "reps", "lyrics_backend"}."""
    dev = resolve_device(device)
    genre_map = {int(i): str(g) for i, g in zip(source.track_ids,
                                                source.genres)}
    t = [time.perf_counter()]
    with record_function("stage:representations"):
        lyr = build_lyrics_embeddings(source, ws, device=dev)
        reps = _load_reps(ws, genre_map, arrays={
            "vae_mm_latents": (mu, ids),
            "baseline_mel_flat": (features, ids),
            "baseline_lyrics_only": (lyr["emb"], lyr["ids"])}, device=dev)
        synchronize(dev)
    t.append(time.perf_counter())
    with record_function("stage:script13"):
        rows13 = cluster_and_evaluate(ws, genre_map, n_clusters, reps=reps,
                                      device=dev)
        synchronize(dev)
    t.append(time.perf_counter())
    with record_function("stage:script16"):
        rows16 = full_clustering_sweep(ws, genre_map, cfg, reps=reps,
                                       device=dev)
        synchronize(dev)
    t.append(time.perf_counter())
    names = ("seconds_representations", "seconds_script13", "seconds_script16")
    seconds = {k: t[i + 1] - t[i] for i, k in enumerate(names)}
    seconds["seconds_total"] = t[-1] - t[0]
    return {"seconds": seconds, "rows13": rows13, "rows16": rows16,
            "reps": reps, "lyrics_backend": lyr["backend"]}
