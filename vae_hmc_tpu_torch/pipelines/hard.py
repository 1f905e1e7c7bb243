"""Hard tier: MFCC stats + lyrics embeddings -> Beta-VAE / CVAE -> KMeans +
silhouette/NMI/ARI/purity -> latent viz -> baseline comparison (port of
``vae_hmc_tpu.pipelines.hard``).

Writes the artifact contract of reference scripts 18-22:

  data/hard/{audio_mfcc_stats,lyrics_emb,track_ids,genres,genre_idx,
             languages,lang_idx}.npy + hard_metadata.csv + build_info.json
  models/hard/{beta_vae_multimodal.pt | cvae_multimodal.pt} (+ .meta.json)
  data/hard/latents_mu.npy
  results/hard/plots/{training_curve,recon_examples,latent_by_*,
                      cluster_dist_over_*}.png + latent_2d.npy
  results/hard/{hard_metrics_vae_latents.json,
                cluster_composition_by_genre.csv,
                cluster_labels_kmeans.npy,
                cluster_distribution_{genre,language}_counts.csv,
                baseline_comparison.csv} + plots/baseline_bars.png
  results/timing_hard.json                      (the runner)

Every artifact honors the --tag snapshot system (reference 19:35-47): the
canonical file is written, then copied with a _tag suffix.  Figures are
PNGs where matplotlib imports, else their data as .npz files of the same
stem (``viz.plots``).

The MFCC stats come from kernel 1 in its MFCC mode, every silhouette and
UMAP's kNN from kernel 2.  Differences from the JAX package, deliberate:
  - reference script 20 renames crosstab columns by indexing the per-track
    genres array with *class* indices (20:88-95); as in the JAX package,
    cluster_composition_by_genre.csv carries the sorted unique class names;
  - the reconstruction overlay's forward draws its noise from a torch
    generator seeded by cfg.seed, not from ``jax.random.PRNGKey(cfg.seed)``;
  - the JAX runner's AOT trainer set-up threads (fired by
    ``prepare_features``'s ``on_shapes`` hook) are not ported: they
    overlap XLA compiles, and nothing here compiles.  The stage order is
    the same.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from vae_hmc_tpu_torch.core import artifacts, goldens
from vae_hmc_tpu_torch.core.align import encode_labels
from vae_hmc_tpu_torch.core.config import (MFCC_HARD, TEXT_HARD, AeConfig,
                                           HardVaeConfig, KMeansConfig,
                                           MfccConfig, TextEmbedConfig,
                                           UmapConfig, Workspace, asdict)
from vae_hmc_tpu_torch.core.device import resolve_device
from vae_hmc_tpu_torch.core.profiling import StageTimer
from vae_hmc_tpu_torch.cluster.kmeans import kmeans
from vae_hmc_tpu_torch.metrics import external, safe
from vae_hmc_tpu_torch.ops.pca import PCA
from vae_hmc_tpu_torch.viz import plots


def _one_hot(idx: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((len(idx), n), dtype=np.float32)
    out[np.arange(len(idx)), idx] = 1.0
    return out


# ---------------------------------------------------------------------------
# Script 18: feature prep
# ---------------------------------------------------------------------------


def prepare_features(source, ws: Workspace,
                     mfcc_cfg: MfccConfig = MFCC_HARD,
                     text_cfg: TextEmbedConfig = TEXT_HARD,
                     device_batch: int = 64, force: bool = False,
                     device="cuda") -> Dict:
    """MFCC stats (kernel 1), language tags and lyrics embeddings (MiniLM
    with a checkpoint, else TF-IDF) of the kept tracks.  Skipped when
    build_info.json exists, unless force (reference 18:167-169)."""
    from vae_hmc_tpu_torch.pipelines.features import build_mfcc_stats
    from vae_hmc_tpu_torch.text.embed import embed_texts
    from vae_hmc_tpu_torch.text.langdetect import detect_language_simple

    dev = resolve_device(device)
    out = ws.data_hard
    out.mkdir(parents=True, exist_ok=True)
    info_p = out / "build_info.json"
    if info_p.exists() and not force:
        return {"skipped": True, "info": json.loads(info_p.read_text())}

    x_audio, ids, report = build_mfcc_stats(source, mfcc_cfg, device_batch,
                                            device=dev)
    # keep text rows aligned to the kept audio rows
    keep_idx = {int(t): i for i, t in enumerate(source.track_ids)}
    texts, languages, genres = [], [], []
    for tid in ids:
        i = keep_idx[int(tid)]
        t = source.lyrics_text(i) or ""
        texts.append(t)
        languages.append(detect_language_simple(t))
        genres.append(str(source.genres[i]))

    x_text, backend = embed_texts(texts, text_cfg, allow_tfidf=True,
                                  device=dev)
    genre_idx, uniq_genres = encode_labels(genres)
    lang_idx, uniq_langs = encode_labels(languages)

    np.save(out / "audio_mfcc_stats.npy", x_audio)
    np.save(out / "lyrics_emb.npy", x_text)
    np.save(out / "track_ids.npy", ids)
    np.save(out / "genres.npy", np.asarray(genres, dtype=object))
    np.save(out / "genre_idx.npy", genre_idx.astype(np.int64))
    np.save(out / "languages.npy", np.asarray(languages, dtype=object))
    np.save(out / "lang_idx.npy", lang_idx.astype(np.int64))
    artifacts.save_csv_rows(out / "hard_metadata.csv",
                            ["track_id", "genre", "language_detected"],
                            [[int(t), g, l] for t, g, l in
                             zip(ids, genres, languages)])
    info = {
        "num_tracks_input": len(source),
        "num_tracks_kept": int(len(ids)),
        "audio_feature_shape": list(x_audio.shape),
        "text_feature_shape": list(x_text.shape),
        "unique_genres": [str(g) for g in uniq_genres],
        "unique_languages": [str(l) for l in uniq_langs],
        "text_embedding_backend": backend,
    }
    info_p.write_text(json.dumps(info, indent=2))
    return {"audio": x_audio, "text": x_text, "ids": ids,
            "genre_idx": genre_idx, "lang_idx": lang_idx, "info": info,
            "report": report}


# ---------------------------------------------------------------------------
# Script 19: Beta-VAE / CVAE training
# ---------------------------------------------------------------------------


def train_hard(ws: Workspace, cfg: HardVaeConfig = HardVaeConfig(),
               tag: Optional[str] = None, verbose: bool = False,
               device="cuda") -> Dict:
    """-> {"latents" (N, latent) on the device, "history", "model",
    "input_dim"}."""
    from vae_hmc_tpu_torch.models.api import train_hard_vae
    from vae_hmc_tpu_torch.models.convert import linear_flax_params

    dev = resolve_device(device)
    d = ws.data_hard
    x_audio = np.load(d / "audio_mfcc_stats.npy")
    x_text = np.load(d / "lyrics_emb.npy")
    y_genre = np.load(d / "genre_idx.npy")
    y_lang = np.load(d / "lang_idx.npy")
    n_genres = int(y_genre.max() + 1) if y_genre.size else 1
    n_langs = int(y_lang.max() + 1) if y_lang.size else 1

    x = np.concatenate([x_audio, x_text], axis=1).astype(np.float32)
    if cfg.include_genre_in_input:        # ref 19:174-175
        x = np.concatenate([x, _one_hot(y_genre, n_genres)], axis=1)
    if cfg.include_lang_in_input:         # ref 19:176-177
        x = np.concatenate([x, _one_hot(y_lang, n_langs)], axis=1)

    cond = None
    if cfg.use_cvae:
        parts = []
        if cfg.cond_genre or not cfg.cond_lang:     # default cond_on=genre
            parts.append(_one_hot(y_genre, n_genres))
        if cfg.cond_lang:
            parts.append(_one_hot(y_lang, n_langs))
        cond = np.concatenate(parts, axis=1)

    model, history, mu = train_hard_vae(x, cfg, cond=cond, device=dev)
    if verbose:
        for h in history:
            print(f"epoch {h['epoch']}: total {h['total']:.4f} recon "
                  f"{h['recon']:.4f} kl {h['kl']:.4f}")

    model_dir = Path(ws.root) / "models" / "hard"
    model_dir.mkdir(parents=True, exist_ok=True)
    name = "cvae_multimodal.pt" if cfg.use_cvae else "beta_vae_multimodal.pt"
    artifacts.save_checkpoint(
        model_dir / name, {"params": linear_flax_params(model.state_dict())},
        metadata={"input_dim": int(x.shape[1]), "latent_dim": cfg.latent_dim,
                  "hidden_dim": cfg.hidden_dim, "beta": cfg.beta,
                  "use_cvae": cfg.use_cvae,
                  "cond_dim": 0 if cond is None else int(cond.shape[1]),
                  "seed": cfg.seed}, tag=tag)
    artifacts.save_npy(d / "latents_mu.npy",
                       mu.cpu().numpy().astype(np.float32), tag=tag)

    plots_dir = ws.results_hard / "plots"
    artifacts.save_and_snapshot(
        lambda p: plots.training_curves(history, p,
                                        "Training Loss (Beta-VAE/CVAE)"),
        plots_dir / "training_curve.png", tag)

    # reconstruction overlays on 6 random rows (ref 19:304-334); the noise
    # comes from a torch generator seeded by cfg.seed
    rng = np.random.default_rng(cfg.seed)
    idx = rng.choice(x.shape[0], size=min(6, x.shape[0]), replace=False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    eps = torch.randn((len(idx), cfg.latent_dim), generator=gen, device=dev)
    batch = [torch.from_numpy(x[idx]).to(dev)]
    if cond is not None:
        batch.append(torch.from_numpy(cond[idx]).to(dev))
    with torch.no_grad():
        xhat = model(*batch, eps=eps)[0].cpu().numpy()
    dims = min(80, x.shape[1])
    artifacts.save_and_snapshot(
        lambda p: plots.recon_overlay(x[idx][:, :dims], xhat[:, :dims], p,
                                      n_examples=len(idx)),
        plots_dir / "recon_examples.png", tag)
    return {"latents": mu, "history": history, "model": model,
            "input_dim": int(x.shape[1])}


# ---------------------------------------------------------------------------
# Script 20: cluster + evaluate
# ---------------------------------------------------------------------------


def cluster_and_evaluate(ws: Workspace, k: Optional[int] = None,
                         seed: int = 42, tag: Optional[str] = None,
                         latents_path: Optional[Path] = None,
                         device="cuda") -> Dict:
    d = ws.data_hard
    lat_path = Path(latents_path) if latents_path else d / "latents_mu.npy"
    z = np.load(lat_path)
    y_genre = np.load(d / "genre_idx.npy")
    genres = np.load(d / "genres.npy", allow_pickle=True)
    if k is None:
        k = int(y_genre.max() + 1)

    # NOTE: no standardization before KMeans — reference 20:65-69
    res = kmeans(z, KMeansConfig(n_clusters=k, n_init=20, seed=seed,
                                 standardize=False), device=device)
    y_pred = res.labels

    metrics = {
        "feature_space": str(lat_path),
        "k": int(k),
        "silhouette": safe.safe_silhouette(z, y_pred, device=device),
        "nmi": float(external.normalized_mutual_info(y_genre, y_pred)),
        "ari": float(external.adjusted_rand_index(y_genre, y_pred)),
        "purity": float(external.purity(y_pred, y_genre)),
    }
    out = ws.results_hard
    out.mkdir(parents=True, exist_ok=True)
    artifacts.save_json(out / "hard_metrics_vae_latents.json", metrics,
                        tag=tag)

    # cluster x genre composition with the sorted unique class names (see
    # the module docstring on reference 20:88-95)
    m = external.contingency_matrix(y_pred, y_genre)
    class_names = [str(c) for c in np.unique(genres)]
    header = ["pred"] + class_names[: m.shape[1]]
    artifacts.save_csv_rows(out / "cluster_composition_by_genre.csv", header,
                            [[i] + list(row) for i, row in enumerate(m)],
                            tag=tag)
    artifacts.save_npy(out / "cluster_labels_kmeans.npy",
                       y_pred.astype(np.int64), tag=tag)
    return {"metrics": metrics, "labels": y_pred, "composition": m}


# ---------------------------------------------------------------------------
# Script 21: latent-space visualizations
# ---------------------------------------------------------------------------


def visualize_latents(ws: Workspace, seed: int = 42,
                      tag: Optional[str] = None,
                      latents_path: Optional[Path] = None,
                      umap_cfg: UmapConfig = UmapConfig(n_neighbors=20,
                                                        min_dist=0.15),
                      device="cuda") -> Dict:
    from vae_hmc_tpu_torch.viz.projections import reduce_2d

    d = ws.data_hard
    lat_path = Path(latents_path) if latents_path else d / "latents_mu.npy"
    z = np.load(lat_path)
    genres = np.load(d / "genres.npy", allow_pickle=True)
    langs = np.load(d / "languages.npy", allow_pickle=True)
    pred_path = ws.results_hard / "cluster_labels_kmeans.npy"
    if not pred_path.exists():
        raise FileNotFoundError(
            "Run hard.cluster_and_evaluate first to create cluster labels.")
    y_pred = np.load(pred_path)

    z2, used = reduce_2d(z, "umap", umap_cfg=umap_cfg, device=device)
    plots_dir = ws.results_hard / "plots"
    plots_dir.mkdir(parents=True, exist_ok=True)
    artifacts.save_npy(plots_dir / "latent_2d.npy", z2.astype(np.float32),
                       tag=tag)

    genre_names = np.asarray([str(g) for g in genres])
    lang_names = np.asarray([str(l) for l in langs])
    outs = {}
    for name, labels, title in (
            ("latent_by_cluster.png", y_pred,
             "Latent space colored by KMeans cluster"),
            ("latent_by_genre.png", genre_names,
             "Latent space colored by true genre"),
            ("latent_by_language.png", lang_names,
             "Latent space colored by detected language")):
        outs[name] = artifacts.save_and_snapshot(
            lambda p, lab=labels, t=title: plots.scatter_2d(z2, lab, p, t),
            plots_dir / name, tag)

    gm = external.contingency_matrix(y_pred, genre_names)
    lm = external.contingency_matrix(y_pred, lang_names)
    g_classes = [str(c) for c in np.unique(genre_names)]
    l_classes = [str(c) for c in np.unique(lang_names)]
    artifacts.save_csv_rows(
        ws.results_hard / "cluster_distribution_genre_counts.csv",
        ["cluster"] + g_classes, [[i] + list(r) for i, r in enumerate(gm)],
        tag=tag)
    artifacts.save_csv_rows(
        ws.results_hard / "cluster_distribution_language_counts.csv",
        ["cluster"] + l_classes, [[i] + list(r) for i, r in enumerate(lm)],
        tag=tag)
    clusters = [str(i) for i in range(gm.shape[0])]
    artifacts.save_and_snapshot(
        lambda p: plots.stacked_bar_distribution(
            gm, clusters, g_classes, p,
            "Cluster distribution over genres (fraction)"),
        plots_dir / "cluster_dist_over_genres.png", tag)
    artifacts.save_and_snapshot(
        lambda p: plots.stacked_bar_distribution(
            lm, clusters, l_classes, p,
            "Cluster distribution over languages (fraction)"),
        plots_dir / "cluster_dist_over_languages.png", tag)
    return {"latent_2d": z2, "method": used, "plots": outs}


# ---------------------------------------------------------------------------
# Script 22: baseline comparison
# ---------------------------------------------------------------------------


def compare_with_baselines(ws: Workspace, k: Optional[int] = None,
                           pca_dim: int = 32,
                           ae_cfg: AeConfig = AeConfig(),
                           seed: int = 42, tag: Optional[str] = None,
                           latents_path: Optional[Path] = None,
                           verbose: bool = False,
                           device="cuda") -> List[Dict]:
    from vae_hmc_tpu_torch.models.api import train_ae

    d = ws.data_hard
    x_audio = np.load(d / "audio_mfcc_stats.npy")
    x_text = np.load(d / "lyrics_emb.npy")
    y = np.load(d / "genre_idx.npy")
    if k is None:
        k = int(y.max() + 1)
    x_fused = np.concatenate([x_audio, x_text], axis=1).astype(np.float32)
    lat_path = Path(latents_path) if latents_path else d / "latents_mu.npy"
    z = np.load(lat_path)

    def eval_kmeans(name, x):
        y_pred = kmeans(x, KMeansConfig(n_clusters=k, n_init=20, seed=seed),
                        device=device).labels
        return {
            "method": name,
            "silhouette": safe.safe_silhouette(x, y_pred, device=device),
            "nmi": float(external.normalized_mutual_info(y, y_pred)),
            "ari": float(external.adjusted_rand_index(y, y_pred)),
            "purity": float(external.purity(y_pred, y)),
        }

    rows = [eval_kmeans("VAE/CVAE latents + KMeans", z),
            eval_kmeans("Direct spectral (MFCC stats) + KMeans", x_audio)]
    x_pca = PCA(min(pca_dim, x_audio.shape[1], x_audio.shape[0]),
                device=device).fit_transform(x_audio).cpu().numpy()
    rows.append(eval_kmeans(f"PCA({x_pca.shape[1]}) + KMeans (audio)", x_pca))

    cfg = AeConfig(**{**asdict(ae_cfg), "input_dim": x_fused.shape[1],
                      "seed": seed})
    _, history, z_ae = train_ae(x_fused, cfg, device=device)
    if verbose:
        print(f"AE final loss {history[-1]['total']:.4f}")
    rows.append(eval_kmeans(f"Autoencoder(z={cfg.latent_dim}) + KMeans "
                            "(fused)", z_ae.cpu().numpy()))

    out = ws.results_hard
    out.mkdir(parents=True, exist_ok=True)
    header = ["method", "silhouette", "nmi", "ari", "purity"]
    artifacts.save_csv_rows(out / "baseline_comparison.csv", header,
                            [["" if r[h] is None else r[h] for h in header]
                             for r in rows], tag=tag)
    artifacts.save_and_snapshot(
        lambda p: plots.grouped_bars(rows, "method",
                                     ["silhouette", "nmi", "ari", "purity"],
                                     p, "Hard Task: Baseline Comparison"),
        out / "plots" / "baseline_bars.png", tag)
    return rows


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------


def run_hard_pipeline(source, ws: Workspace,
                      mfcc_cfg: MfccConfig = MFCC_HARD,
                      text_cfg: TextEmbedConfig = TEXT_HARD,
                      vae_cfg: HardVaeConfig = HardVaeConfig(),
                      ae_cfg: AeConfig = AeConfig(),
                      tag: Optional[str] = None,
                      with_viz: bool = True, device_batch: int = 64,
                      verbose: bool = False, device="cuda") -> Dict:
    """Scripts 18 -> 19 -> 20 -> 21 (when with_viz) -> 22 into `ws`; stage
    seconds in ``timing_hard.json`` (each stage ends in a synchronize).
    -> {"prep", "train", "cluster", "viz", "baselines", "timing",
    "quality_drift", "figures" ("png" or "npz")}."""
    dev = resolve_device(device)
    timer = StageTimer(dev)
    n = len(source)
    with timer.stage("prepare_features", n):
        prep = prepare_features(source, ws, mfcc_cfg, text_cfg, device_batch,
                                device=dev)
    with timer.stage("train_hard", n):
        t = train_hard(ws, vae_cfg, tag=tag, verbose=verbose, device=dev)
    with timer.stage("cluster_and_evaluate", n):
        c = cluster_and_evaluate(ws, seed=vae_cfg.seed, tag=tag, device=dev)
    v = None
    if with_viz:
        with timer.stage("visualize_latents", n):
            v = visualize_latents(ws, seed=vae_cfg.seed, tag=tag, device=dev)
    with timer.stage("compare_with_baselines", n):
        b = compare_with_baselines(ws, ae_cfg=ae_cfg, seed=vae_cfg.seed,
                                   tag=tag, verbose=verbose, device=dev)
    timer.save(ws.results / "timing_hard.json")
    q = goldens.check_tier("hard", ws.results, n, dev)
    return {"prep": prep, "train": t, "cluster": c, "viz": v, "baselines": b,
            "timing": timer.report(), "quality_drift": q,
            "figures": plots.figure_kind()}
