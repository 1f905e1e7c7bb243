"""Real-data parity harness: run all three tiers and diff the quality
columns against the reference's committed numbers (BASELINE.md).  Port of
``vae_hmc_tpu.pipelines.parity``: the same 30 cells and tolerances, run
through the port's three tier runners on ``device``.

The reference's published metrics (results/ CSVs and JSONs in
NawrozHaseen/VAE-for-Hybrid-Music-Clustering) were produced on the real
FMA-small 2,924-track corpus.  This environment has no audio (zero egress),
so full closure is blocked on data — but the comparison machinery should be
a data swap, not a debugging session, the day a corpus is mounted.  This
module is that machinery:

    python -m vae_hmc_tpu_torch.cli parity-check --manifest data/...csv --root .

runs easy (06-09), medium (10-17) and hard (18-22) with the reference's
exact hyperparameters, extracts the same quality cells the reference
committed, and prints a pass/fail table against BASELINE.md with explicit
tolerances.  Exit code 0 iff every row passes.

Tolerances: VAE training + KMeans are algorithmically equivalent but not
bit-identical to torch+sklearn (different init RNG streams), so parity is
band parity: |ours - ref| <= tol_abs for unit-scale metrics (silhouette /
ARI / NMI / purity / DBI / score / explained variance), relative tol_rel
for Calinski-Harabasz.  The bands are deliberately tight enough to catch a
wrong feature pipeline (which moves silhouette by ~0.1+) and loose enough
to absorb seed-level clustering jitter.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from vae_hmc_tpu_torch.core.config import HardVaeConfig, Workspace
from vae_hmc_tpu_torch.core.device import resolve_device
from vae_hmc_tpu_torch.pipelines.sources import Source


@dataclass(frozen=True)
class ParityRow:
    name: str                  # metric cell, e.g. "easy.vae_kmeans.silhouette"
    ref: float                 # reference value (BASELINE.md)
    ours: Optional[float]
    tol: float                 # |ours - ref| bound (already scaled if rel)
    source: str                # reference artifact the value came from

    @property
    def passed(self) -> bool:
        return self.ours is not None and abs(self.ours - self.ref) <= self.tol


# Reference quality cells (BASELINE.md; file:line in the reference
# repository).
# name -> (ref value, source)
REFERENCE_CELLS: Dict[str, tuple] = {
    # easy tier (results/compare_metrics/metrics.csv:2-3)
    "easy.vae_kmeans.silhouette": (0.26059, "results/compare_metrics/metrics.csv:2"),
    "easy.vae_kmeans.calinski_harabasz": (1325.78, "results/compare_metrics/metrics.csv:2"),
    "easy.pca_mfcc.silhouette": (0.11746, "results/compare_metrics/metrics.csv:3"),
    "easy.pca_mfcc.calinski_harabasz": (540.36, "results/compare_metrics/metrics.csv:3"),
    "easy.pca_mfcc.explained_variance": (0.756, "results/compare_metrics/metrics.csv:3"),
    # medium fixed-k suite (results/medium_clustering_metrics_all.csv:2-3)
    "medium.vae.kmeans6.silhouette": (0.34997, "results/medium_clustering_metrics_all.csv:2"),
    "medium.vae.kmeans6.davies_bouldin": (0.89351, "results/medium_clustering_metrics_all.csv:2"),
    "medium.vae.kmeans6.ari": (0.04255, "results/medium_clustering_metrics_all.csv:2"),
    "medium.vae.agglomerative6.silhouette": (0.31116, "results/medium_clustering_metrics_all.csv:3"),
    "medium.vae.agglomerative6.davies_bouldin": (0.95114, "results/medium_clustering_metrics_all.csv:3"),
    "medium.vae.agglomerative6.ari": (0.04091, "results/medium_clustering_metrics_all.csv:3"),
    # medium sweep best-by-representation (.csv:3-4)
    "medium.sweep_best.vae.silhouette": (0.29602, "results/medium_full_sweep_best_by_representation.csv:3"),
    "medium.sweep_best.vae.ari": (0.05069, "results/medium_full_sweep_best_by_representation.csv:3"),
    "medium.sweep_best.vae.score": (0.13966, "results/medium_full_sweep_best_by_representation.csv:3"),
    "medium.sweep_best.mel_flat.silhouette": (-0.01529, "results/medium_full_sweep_best_by_representation.csv:4"),
    "medium.sweep_best.mel_flat.ari": (0.05109, "results/medium_full_sweep_best_by_representation.csv:4"),
    # hard tier (results/hard/hard_metrics_vae_latents_{beta,cvae}.json)
    "hard.beta_vae.silhouette": (0.13217, "results/hard/hard_metrics_vae_latents_beta.json"),
    "hard.beta_vae.nmi": (0.12845, "results/hard/hard_metrics_vae_latents_beta.json"),
    "hard.beta_vae.ari": (0.09312, "results/hard/hard_metrics_vae_latents_beta.json"),
    "hard.beta_vae.purity": (0.36743, "results/hard/hard_metrics_vae_latents_beta.json"),
    "hard.cvae.silhouette": (0.11103, "results/hard/hard_metrics_vae_latents_cvae.json"),
    "hard.cvae.nmi": (0.11219, "results/hard/hard_metrics_vae_latents_cvae.json"),
    "hard.cvae.ari": (0.08246, "results/hard/hard_metrics_vae_latents_cvae.json"),
    "hard.cvae.purity": (0.34554, "results/hard/hard_metrics_vae_latents_cvae.json"),
    # hard baselines (results/hard/baseline_comparison.csv:3-5)
    "hard.baseline_mfcc.silhouette": (0.17885, "results/hard/baseline_comparison.csv:3"),
    "hard.baseline_mfcc.ari": (0.06258, "results/hard/baseline_comparison.csv:3"),
    "hard.baseline_pca.silhouette": (0.18293, "results/hard/baseline_comparison.csv:4"),
    "hard.baseline_pca.ari": (0.06313, "results/hard/baseline_comparison.csv:4"),
    "hard.baseline_ae.silhouette": (0.18906, "results/hard/baseline_comparison.csv:5"),
    "hard.baseline_ae.ari": (0.05944, "results/hard/baseline_comparison.csv:5"),
}


def _collect_ours(source: Source, ws: Workspace, verbose: bool,
                  device_batch: int, fast: bool,
                  device) -> Dict[str, Optional[float]]:
    """Run the three tiers with reference hyperparameters; return our value
    for every REFERENCE_CELLS key.

    fast=True shrinks durations/epochs so the harness itself can be
    exercised on tiny corpora (CI); the resulting values are NOT parity-
    comparable — fast mode is for testing the machinery, never the
    verdict."""
    from vae_hmc_tpu_torch.core.config import (ConvMMVaeConfig,
                                               DenseVaeConfig, MelConfig,
                                               MfccConfig)
    from vae_hmc_tpu_torch.pipelines import easy, hard, medium

    ours: Dict[str, Optional[float]] = {}
    easy_kw = {}
    medium_kw = {}
    if fast:
        easy_kw = dict(mfcc_cfg=MfccConfig(duration_s=1.5),
                       vae_cfg=DenseVaeConfig(epochs=2, batch_size=8,
                                              latent_dim=4))
        medium_kw = dict(mel_cfg=MelConfig(duration_s=1.5),
                         vae_cfg=ConvMMVaeConfig(epochs=2, batch_size=8,
                                                 latent_dim=8))

    # ---- easy (06-09): 30 s MFCC, 40-epoch dense VAE, KMeans(5) ----
    e = easy.run_easy_pipeline(source, ws, with_viz=False,
                               device_batch=device_batch, verbose=verbose,
                               device=device, **easy_kw)
    for r in e["compare"]["rows"]:
        if r["method"] == "VAE+KMeans":
            ours["easy.vae_kmeans.silhouette"] = r["silhouette"]
            ours["easy.vae_kmeans.calinski_harabasz"] = r["calinski_harabasz"]
        elif r["input"].startswith("MFCC"):
            ours["easy.pca_mfcc.silhouette"] = r["silhouette"]
            ours["easy.pca_mfcc.calinski_harabasz"] = r["calinski_harabasz"]
            ours["easy.pca_mfcc.explained_variance"] = (
                float(r["pca_variance"]) if r["pca_variance"] != "" else None)

    # ---- medium (10-17): 15 s log-mel, 25-epoch conv MM VAE, suite+sweep ----
    m = medium.run_medium_pipeline(source, ws, with_viz=False,
                                   device_batch=device_batch, verbose=verbose,
                                   write_mel_features=False, device=device,
                                   **medium_kw)
    for r in m["suite"]:
        if r["representation"] != "vae_mm_latents":
            continue
        if r["algo"] == "kmeans":
            pre = "medium.vae.kmeans6."
        elif r["algo"] == "agglomerative":
            pre = "medium.vae.agglomerative6."
        else:
            continue
        ours[pre + "silhouette"] = r["silhouette"]
        ours[pre + "davies_bouldin"] = r["davies_bouldin"]
        ours[pre + "ari"] = r["ari"]
    best: Dict[str, Dict] = {}
    for r in m["sweep"]:
        cur = best.get(r["representation"])
        if cur is None or r["score"] > cur["score"]:
            best[r["representation"]] = r
    if "vae_mm_latents" in best:
        b = best["vae_mm_latents"]
        ours["medium.sweep_best.vae.silhouette"] = b["silhouette"]
        ours["medium.sweep_best.vae.ari"] = b["ari"]
        ours["medium.sweep_best.vae.score"] = b["score"]
    if "baseline_mel_flat" in best:
        b = best["baseline_mel_flat"]
        ours["medium.sweep_best.mel_flat.silhouette"] = b["silhouette"]
        ours["medium.sweep_best.mel_flat.ari"] = b["ari"]

    # ---- hard (18-22): 20 s masked MFCC, Beta-VAE AND CVAE, baselines ----
    from vae_hmc_tpu_torch.core.config import MFCC_HARD, TEXT_HARD
    mfcc_hard = (MfccConfig(duration_s=1.5, min_duration_s=0.5) if fast
                 else MFCC_HARD)
    hard.prepare_features(source, ws, mfcc_hard, TEXT_HARD, device_batch,
                          device=device)
    hard_fast = dict(epochs=2, batch_size=8, hidden_dim=32) if fast else {}
    for key, cfg, tag in (
            ("hard.beta_vae.", HardVaeConfig(**hard_fast), "beta"),
            ("hard.cvae.", HardVaeConfig(use_cvae=True, **hard_fast),
             "cvae")):
        hard.train_hard(ws, cfg, tag=tag, verbose=verbose, device=device)
        c = hard.cluster_and_evaluate(ws, seed=cfg.seed, tag=tag,
                                      device=device)
        for mname in ("silhouette", "nmi", "ari", "purity"):
            ours[key + mname] = c["metrics"][mname]
    from vae_hmc_tpu_torch.core.config import AeConfig
    ae_cfg = AeConfig(epochs=2, batch_size=8) if fast else AeConfig()
    rows = hard.compare_with_baselines(ws, ae_cfg=ae_cfg,
                                       seed=HardVaeConfig().seed,
                                       device=device)
    for r in rows:
        if r["method"].startswith("Direct spectral"):
            key = "hard.baseline_mfcc."
        elif r["method"].startswith("PCA("):
            key = "hard.baseline_pca."
        elif r["method"].startswith("Autoencoder"):
            key = "hard.baseline_ae."
        else:
            continue
        ours[key + "silhouette"] = r["silhouette"]
        ours[key + "ari"] = r["ari"]
    return ours


def run_parity_check(source: Source, ws: Workspace, tol_abs: float = 0.05,
                     tol_rel: float = 0.15, verbose: bool = False,
                     device_batch: int = 64,
                     fast: bool = False, device="cuda") -> List[ParityRow]:
    """Run everything on `device`, compare, and return the full row
    table."""
    ours = _collect_ours(source, ws, verbose, device_batch, fast,
                         resolve_device(device))
    rows = []
    for name, (ref, src) in REFERENCE_CELLS.items():
        tol = (abs(ref) * tol_rel if "calinski" in name else tol_abs)
        rows.append(ParityRow(name=name, ref=ref, ours=ours.get(name),
                              tol=tol, source=src))
    return rows


def format_table(rows: List[ParityRow]) -> str:
    lines = [f"{'cell':44s} {'ref':>10s} {'ours':>10s} {'tol':>8s}  verdict",
             "-" * 86]
    for r in rows:
        ours = "  (none)" if r.ours is None else f"{r.ours:10.5f}"
        lines.append(f"{r.name:44s} {r.ref:10.5f} {ours:>10s} "
                     f"{r.tol:8.4f}  {'PASS' if r.passed else 'FAIL'}")
    n_pass = sum(r.passed for r in rows)
    lines.append("-" * 86)
    lines.append(f"{n_pass}/{len(rows)} cells within tolerance")
    return "\n".join(lines)


def save_report(rows: List[ParityRow], path) -> None:
    from vae_hmc_tpu_torch.core.artifacts import save_csv_rows
    save_csv_rows(path, ["cell", "reference", "ours", "tol", "passed",
                         "reference_source"],
                  [[r.name, r.ref, "" if r.ours is None else r.ours, r.tol,
                    r.passed, r.source] for r in rows])
