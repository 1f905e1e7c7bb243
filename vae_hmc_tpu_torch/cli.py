"""One CLI entry point with subcommands mirroring reference scripts 00-22
(port of ``vae_hmc_tpu.cli``).

    python -m vae_hmc_tpu_torch.cli <command> [flags]

The same 28 subcommands, flags and defaults as the JAX package's CLI, each
writing the same artifact files, plus one flag: ``--device`` (default
``cuda``; without a GPU the command raises unless it is ``cpu``).  Data
sources: ``--synthetic N`` runs on the deterministic synthetic dataset;
``--synthetic-audio`` drives the real ``--manifest`` rows with synthesized
waveforms; otherwise ``--manifest`` points at the real manifest and audio
tree (paths relative to ``--root``).

Not ported yet: ``bench`` (the port's benchmark) exits non-zero with a
message.  ``run-medium --fast`` trains the conv VAE in bf16 mixed
precision, a non-parity mode, as the JAX package's does.  The JAX
package's persistent XLA compile cache has no counterpart here.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from vae_hmc_tpu_torch.core.config import (AeConfig, ConvMMVaeConfig,
                                           DenseVaeConfig, HardVaeConfig,
                                           KMeansConfig, MelConfig,
                                           MfccConfig, TextEmbedConfig,
                                           Workspace)

BENCH_MISSING = (
    "bench: the port has no benchmark yet (ROADMAP Queue 1 item 2); "
    "python3 chip_smoke.py drives every path on the card meanwhile")
FAST_WARNING = (
    "[run-medium] --fast: bf16 training is a NON-PARITY perf mode; quality "
    "columns are not comparable to the f32 parity run")


def _manifest_path(args) -> Path:
    """Resolve --manifest: absolute paths as given; relative paths against
    --root (the workspace root where data/ lives), falling back to the CWD
    only when the rooted path is absent but the CWD one exists."""
    p = Path(args.manifest)
    if p.is_absolute():
        return p
    rooted = Path(getattr(args, "root", ".")) / p
    if rooted.exists() or not p.exists():
        return rooted
    return p


def _source(args):
    from vae_hmc_tpu_torch.pipelines.sources import (FileSource,
                                                     SyntheticSource)

    if getattr(args, "synthetic_audio", False):
        from vae_hmc_tpu_torch.pipelines.synthetic import \
            dataset_from_manifest
        # REAL manifest rows (ids, genres, titles, text coverage), synthetic
        # waveforms (see synthetic.dataset_from_manifest)
        ds = dataset_from_manifest(_manifest_path(args), seed=args.seed)
        return SyntheticSource(ds, seed=args.seed)
    if getattr(args, "synthetic", 0):
        return SyntheticSource.make(args.synthetic, seed=args.seed)
    from vae_hmc_tpu_torch.core.manifest import read_manifest

    m = read_manifest(_manifest_path(args))
    return FileSource.from_manifest(m, root=Path(args.root))


def _add_device(p) -> None:
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")


def _add_common(p, manifest_default="data/fma_manifest_combined_text_only_clean.csv"):
    p.add_argument("--root", type=str, default=".",
                   help="workspace root (data/ + results/ live here)")
    p.add_argument("--manifest", type=str, default=manifest_default)
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic tracks instead of real audio")
    p.add_argument("--synthetic-audio", action="store_true",
                   help="drive the REAL --manifest rows (ids, genres, "
                        "text-coverage mask) with synthesized waveforms")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device-batch", type=int, default=64)
    p.add_argument("--verbose", action="store_true")
    _add_device(p)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="vae-hmc-torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    # ---- acquisition (00-05) ----
    p = sub.add_parser("download-fma", help="script 00: download FMA-small")
    _add_common(p)
    p = sub.add_parser("build-manifest", help="script 01: balanced manifest")
    _add_common(p)
    p.add_argument("--total-tracks", type=int, default=3000)
    p.add_argument("--n-genres", type=int, default=6)
    p = sub.add_parser("fetch-lyrics", help="script 02: Genius/LRCLIB lyrics")
    _add_common(p, "data/fma_manifest_3k_6genres.csv")
    p.add_argument("--max", type=int, default=1000)
    p.add_argument("--sleep", type=float, default=0.45)
    p = sub.add_parser("fetch-transcriptions", help="script 03: Whisper ASR")
    _add_common(p, "data/fma_manifest_3k_6genres.csv")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--limit", type=int, default=0)
    p = sub.add_parser("combine-manifest", help="script 04: merge text sources")
    _add_common(p, "data/fma_manifest_3k_6genres.csv")
    p.add_argument("--mode", type=str, default="concat_both")
    p = sub.add_parser("clean-manifest", help="script 05: clean manifest")
    _add_common(p, "data/fma_manifest_combined.csv")

    # ---- easy (06-09) ----
    p = sub.add_parser("train-basic-vae", help="script 06: MFCC + dense VAE")
    _add_common(p)
    p.add_argument("--duration", type=float, default=30.0)
    p.add_argument("--n-mfcc", type=int, default=40)
    p.add_argument("--latent-dim", type=int, default=16)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--no-cache-features", action="store_true",
                   help="rebuild MFCCs even if the cache blob exists (06)")
    p = sub.add_parser("cluster-easy", help="script 07: KMeans on latents")
    _add_common(p)
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--n-init", type=int, default=20)
    p = sub.add_parser("viz-easy", help="script 08: latent 2-D viz")
    _add_common(p)
    p.add_argument("--method", dest="reducer", type=str, default="umap",
                   choices=["umap", "tsne"])
    p.add_argument("--reducer", dest="reducer", type=str,
                   choices=["umap", "tsne"], default=argparse.SUPPRESS,
                   help="alias of --method (08)")
    p.add_argument("--umap-n-neighbors", type=int, default=30)    # 08:98
    p.add_argument("--umap-min-dist", type=float, default=0.1)    # 08:99
    p.add_argument("--tsne-perplexity", type=float, default=30.0)  # 08:118
    p.add_argument("--tsne-learning-rate", type=float, default=200.0)
    p.add_argument("--tsne-n-iter", type=int, default=1500)       # 08:120
    p = sub.add_parser("compare-pca", help="script 09: PCA baseline compare")
    _add_common(p)
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--n-init", type=int, default=20)
    p = sub.add_parser("run-easy", help="full easy tier (06-09)")
    _add_common(p)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--duration", type=float, default=30.0)
    p.add_argument("--k", type=int, default=5)

    # ---- medium (10-17) ----
    p = sub.add_parser("build-mel", help="script 10: log-mel features")
    _add_common(p)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--n-mels", type=int, default=128)
    p.add_argument("--top-db", type=float, default=-1.0)
    p.add_argument("--strict", action="store_true")
    p = sub.add_parser("build-lyrics-emb", help="script 11: lyric embeddings")
    _add_common(p)
    p.add_argument("--min-chars", type=int, default=30)
    p.add_argument("--model", type=str,
                   default="sentence-transformers/all-MiniLM-L6-v2")  # 11:85
    p.add_argument("--batch-size", type=int, default=64)              # 11:87
    p = sub.add_parser("train-conv-mm", help="script 12: conv multimodal VAE")
    _add_common(p)
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--latent-dim", type=int, default=32)
    p = sub.add_parser("cluster-medium", help="script 13: cluster suite")
    _add_common(p)
    p.add_argument("--n-clusters", type=int, default=6)
    p.add_argument("--standardize", action="store_true")
    p.add_argument("--pca-dim", type=int, default=0,
                   help="optional PCA pre-reduction of each representation")
    p = sub.add_parser("viz-cluster", help="script 14: generic cluster viz")
    _add_common(p)
    p.add_argument("--repr", dest="repr_path", type=str, required=True)
    p.add_argument("--ids", type=str, required=True)
    p.add_argument("--method", type=str, default="kmeans",
                   choices=["kmeans", "agglomerative", "dbscan"])
    p.add_argument("--n-clusters", type=int, default=6)
    p.add_argument("--eps", type=float, default=0.6)
    p.add_argument("--min-samples", type=int, default=5)
    p.add_argument("--proj", type=str, default="pca",
                   choices=["pca", "umap", "tsne"])
    p.add_argument("--standardize", action="store_true")
    p.add_argument("--pre-pca-dim", type=int, default=50)
    p.add_argument("--tag", type=str, default="run")
    p = sub.add_parser("viz-side-by-side", help="script 15: 3x2 panel + sweep")
    _add_common(p)
    p.add_argument("--k", type=int, default=6)
    p.add_argument("--dbscan-eps-list", type=str,
                   default="0.2,0.3,0.4,0.5,0.6,0.8,1.0")          # 15:88
    p.add_argument("--dbscan-min-samples", type=int, default=5)
    p.add_argument("--standardize", action="store_true")
    p.add_argument("--tag", type=str, default="medium")
    p = sub.add_parser("sweep-medium", help="script 16: full clustering sweep")
    _add_common(p)
    p.add_argument("--standardize", action="store_true")
    p.add_argument("--k-list", type=str, default="4,5,6,7,8")       # 16:181
    p.add_argument("--eps-list", type=str,
                   default="0.3,0.4,0.5,0.6,0.7,0.8,0.9,1.0")       # 16:219
    p.add_argument("--min-samples-list", type=str, default="3,5,8")  # 16:219
    p = sub.add_parser("report-medium", help="script 17: report tables/plots")
    _add_common(p)
    p.add_argument("--max-noise", type=float, default=0.30)
    p.add_argument("--min-clusters", type=int, default=2)
    p = sub.add_parser("run-medium", help="full medium tier (10-17)")
    _add_common(p)
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--duration", type=float, default=15.0,
                   help="audio seconds per track (reference: 15)")
    p.add_argument("--no-write-mel", action="store_true",
                   help="skip the ~1 GB audio_cnn_mel_X.npy write (the "
                        "features stay on the device; the id/report "
                        "contract is still written)")
    p.add_argument("--no-checkpoint", action="store_true",
                   help="skip the 342 MB ckpt_epoch_NNN.pt write; the "
                        "train_log/latent contract is still written")
    p.add_argument("--fast", action="store_true",
                   help="bf16 mixed-precision training (float32 master "
                        "weights) — NON-PARITY: the 25-epoch loss "
                        "trajectory drifts vs the reference's f32 training")

    # ---- hard (18-22) ----
    p = sub.add_parser("prepare-hard", help="script 18: hard feature prep")
    _add_common(p)
    p.add_argument("--duration", type=float, default=20.0)
    p.add_argument("--force", action="store_true")
    p = sub.add_parser("train-hard", help="script 19: Beta-VAE / CVAE")
    _add_common(p)
    p.add_argument("--beta", type=float, default=4.0)
    p.add_argument("--latent-dim", type=int, default=16)
    p.add_argument("--hidden-dim", type=int, default=256)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--cvae", action="store_true")
    p.add_argument("--cond-on", type=str, default="genre",
                   choices=["genre", "lang", "both"])
    p.add_argument("--include-genre-in-input", action="store_true")
    p.add_argument("--include-lang-in-input", action="store_true")
    p.add_argument("--kl-anneal-epochs", type=int, default=0)
    p.add_argument("--tag", type=str, default=None)
    p = sub.add_parser("cluster-hard", help="script 20: KMeans + metrics")
    _add_common(p)
    p.add_argument("--k", type=int, default=None)
    p.add_argument("--tag", type=str, default=None)
    p.add_argument("--latents-path", type=str, default=None)
    p = sub.add_parser("viz-hard", help="script 21: latent viz + distributions")
    _add_common(p)
    p.add_argument("--tag", type=str, default=None)
    p.add_argument("--latents-path", type=str, default=None)
    p = sub.add_parser("compare-hard", help="script 22: baseline comparison")
    _add_common(p)
    p.add_argument("--k", type=int, default=None)
    p.add_argument("--pca-dim", type=int, default=32)
    p.add_argument("--ae-latent", type=int, default=16)
    p.add_argument("--ae-epochs", type=int, default=30)
    p.add_argument("--tag", type=str, default=None)
    p = sub.add_parser("run-hard", help="full hard tier (18-22)")
    _add_common(p)
    p.add_argument("--beta", type=float, default=4.0)
    p.add_argument("--cvae", action="store_true")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--tag", type=str, default=None)
    p.add_argument("--duration", type=float, default=None,
                   help="override the 20 s MFCC window (fast drives)")

    p = sub.add_parser("bench", help="end-to-end benchmark (not ported yet: "
                                     "exits non-zero)")
    p.add_argument("--n-tracks", type=int, default=2924)
    _add_device(p)

    p = sub.add_parser(
        "parity-check",
        help="run all 3 tiers and diff quality columns vs BASELINE.md — "
             "the first thing to run when a real FMA corpus is mounted")
    _add_common(p)
    p.add_argument("--tol-abs", type=float, default=0.05,
                   help="abs tolerance for unit-scale metrics")
    p.add_argument("--tol-rel", type=float, default=0.15,
                   help="rel tolerance for Calinski-Harabasz")
    p.add_argument("--fast", action="store_true",
                   help="shrunk durations/epochs: tests the harness "
                        "machinery only — numbers are NOT comparable to "
                        "BASELINE")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cmd = args.cmd
    if cmd == "bench":
        print(BENCH_MISSING, file=sys.stderr)
        return 2
    from vae_hmc_tpu_torch.core.device import resolve_device

    dev = resolve_device(args.device)
    ws = Workspace(Path(args.root))

    if cmd == "download-fma":
        from vae_hmc_tpu_torch.pipelines import acquisition as acq
        print(json.dumps(acq.download_fma(ws)["verify"], default=str))
    elif cmd == "build-manifest":
        from vae_hmc_tpu_torch.pipelines import acquisition as acq
        m = acq.build_manifest(ws, args.total_tracks, args.n_genres, args.seed)
        print(f"wrote manifest with {len(m)} rows")
    elif cmd == "fetch-lyrics":
        from vae_hmc_tpu_torch.pipelines import acquisition as acq
        print(json.dumps(acq.fetch_lyrics(
            ws, Path(args.manifest), max_to_process=args.max or None,
            sleep_seconds=args.sleep)))
    elif cmd == "fetch-transcriptions":
        from vae_hmc_tpu_torch.pipelines import acquisition as acq
        print(json.dumps(acq.fetch_transcriptions(
            ws, Path(args.manifest), dry_run=args.dry_run,
            limit=args.limit or None)))
    elif cmd == "combine-manifest":
        from vae_hmc_tpu_torch.pipelines import acquisition as acq
        print(json.dumps(acq.combine_manifests(ws, Path(args.manifest),
                                               args.mode)))
    elif cmd == "clean-manifest":
        from vae_hmc_tpu_torch.pipelines import acquisition as acq
        m = acq.clean_manifest(ws, Path(args.manifest))
        print(f"clean manifest rows: {len(m)}")

    elif cmd == "train-basic-vae":
        from vae_hmc_tpu_torch.pipelines import easy
        out = easy.train_basic_vae(
            _source(args), ws,
            MfccConfig(duration_s=args.duration, n_mfcc=args.n_mfcc),
            DenseVaeConfig(latent_dim=args.latent_dim, epochs=args.epochs,
                           batch_size=args.batch_size,
                           learning_rate=args.lr, beta=args.beta,
                           seed=args.seed),
            device_batch=args.device_batch, verbose=args.verbose,
            use_cache=not args.no_cache_features, device=dev)
        print(f"latents: {tuple(out['latents'].shape)}; history final "
              f"{out['history'][-1]}")
    elif cmd == "cluster-easy":
        from vae_hmc_tpu_torch.pipelines import easy
        out = easy.cluster_easy(ws, KMeansConfig(n_clusters=args.k,
                                                 n_init=args.n_init,
                                                 seed=args.seed), device=dev)
        print(json.dumps(out["summary"]["label_distribution"]))
    elif cmd == "viz-easy":
        from vae_hmc_tpu_torch.core.config import TsneConfig, UmapConfig
        from vae_hmc_tpu_torch.pipelines import easy
        out = easy.visualize_easy(
            ws, args.reducer,
            tsne_cfg=TsneConfig(perplexity=args.tsne_perplexity,
                                learning_rate=args.tsne_learning_rate,
                                n_iter=args.tsne_n_iter, seed=args.seed),
            umap_cfg=UmapConfig(n_neighbors=args.umap_n_neighbors,
                                min_dist=args.umap_min_dist, seed=args.seed),
            device=dev)
        print(f"wrote {out['plot']} ({out['method']})")
    elif cmd == "compare-pca":
        from vae_hmc_tpu_torch.pipelines import easy
        out = easy.compare_pca_baseline(ws, KMeansConfig(
            n_clusters=args.k, n_init=args.n_init, seed=args.seed),
            device=dev)
        for r in out["rows"]:
            print(r)
    elif cmd == "run-easy":
        from vae_hmc_tpu_torch.pipelines import easy
        out = easy.run_easy_pipeline(
            _source(args), ws, MfccConfig(duration_s=args.duration),
            DenseVaeConfig(epochs=args.epochs, seed=args.seed),
            KMeansConfig(n_clusters=args.k, seed=args.seed),
            device_batch=args.device_batch, verbose=args.verbose, device=dev)
        print(json.dumps(out["compare"]["rows"], default=str))

    elif cmd == "build-mel":
        from vae_hmc_tpu_torch.pipelines import medium
        out = medium.build_audio_features(
            _source(args), ws,
            MelConfig(duration_s=args.seconds, n_mels=args.n_mels,
                      top_db=args.top_db),
            device_batch=args.device_batch, device=dev)
        print(f"mel X: {tuple(out['x'].shape)}; ok rows "
              f"{out['report'].ok_count()}")
    elif cmd == "build-lyrics-emb":
        from vae_hmc_tpu_torch.pipelines import medium
        out = medium.build_lyrics_embeddings(
            _source(args), ws, TextEmbedConfig(min_chars=args.min_chars,
                                               model_name=args.model,
                                               batch_size=args.batch_size),
            device=dev)
        print(f"emb: {out['emb'].shape} backend={out['backend']}")
    elif cmd == "train-conv-mm":
        from vae_hmc_tpu_torch.pipelines import medium
        out = medium.train_conv_mm(
            ws, ConvMMVaeConfig(epochs=args.epochs,
                                batch_size=args.batch_size,
                                learning_rate=args.lr,
                                latent_dim=args.latent_dim, seed=args.seed),
            verbose=args.verbose, device=dev)
        print(f"latents: {tuple(out['latents'].shape)}")
    elif cmd in ("cluster-medium", "sweep-medium", "report-medium",
                 "viz-side-by-side", "viz-cluster", "run-medium"):
        from vae_hmc_tpu_torch.pipelines import medium
        gm = None
        src = None
        mp = _manifest_path(args)
        if args.synthetic or args.synthetic_audio:
            src = _source(args)
            gm = {int(t): str(g) for t, g in zip(src.track_ids, src.genres)}
        elif mp.exists():
            from vae_hmc_tpu_torch.core.manifest import read_manifest
            gm = read_manifest(mp).genre_map()
        if cmd == "cluster-medium":
            rows = medium.cluster_and_evaluate(ws, gm, args.n_clusters,
                                               args.standardize,
                                               pca_dim=args.pca_dim,
                                               device=dev)
            print(f"{len(rows)} rows -> medium_clustering_metrics_all.csv")
        elif cmd == "sweep-medium":
            from vae_hmc_tpu_torch.core.config import SweepConfig
            scfg = SweepConfig(
                ks=tuple(int(v) for v in args.k_list.split(",")),
                dbscan_eps=tuple(float(v) for v in args.eps_list.split(",")),
                dbscan_min_samples=tuple(
                    int(v) for v in args.min_samples_list.split(",")),
                seed=args.seed)
            rows = medium.full_clustering_sweep(ws, gm, scfg,
                                                standardize=args.standardize,
                                                device=dev)
            print(f"{len(rows)} rows -> medium_full_sweep_metrics.csv")
        elif cmd == "report-medium":
            out = medium.report_tables_and_plots(ws, args.max_noise,
                                                 args.min_clusters)
            print(f"filtered rows: {len(out['filtered'])}")
        elif cmd == "viz-side-by-side":
            out = medium.side_by_side_and_dbscan_sweep(
                ws, k=args.k, dbscan_min_samples=args.dbscan_min_samples,
                eps_list=tuple(float(v)
                               for v in args.dbscan_eps_list.split(",")),
                standardize=args.standardize, tag=args.tag, seed=args.seed,
                device=dev)
            print(f"wrote {out['side_by_side']}")
        elif cmd == "viz-cluster":
            out = medium.visualize_clustering(
                ws, Path(args.repr_path), Path(args.ids), gm, args.method,
                args.n_clusters, args.eps, args.min_samples, args.proj,
                args.standardize, args.pre_pca_dim, args.tag, args.seed,
                device=dev)
            print(f"wrote {out['clusters_png']}")
        else:
            mel_cfg = MelConfig(duration_s=args.duration)
            if args.fast:
                print(FAST_WARNING, file=sys.stderr)
            medium.run_medium_pipeline(
                # reuse the source built for the genre map above
                src if src is not None else _source(args), ws,
                mel_cfg=mel_cfg,
                vae_cfg=ConvMMVaeConfig(
                    epochs=args.epochs, seed=args.seed,
                    in_frames=mel_cfg.n_frames,
                    compute_dtype="bfloat16" if args.fast else "float32"),
                device_batch=args.device_batch, verbose=args.verbose,
                write_mel_features=not args.no_write_mel,
                save_epoch_checkpoints=not args.no_checkpoint, device=dev)
            print("medium pipeline complete")

    elif cmd == "prepare-hard":
        from vae_hmc_tpu_torch.core.config import TEXT_HARD
        from vae_hmc_tpu_torch.pipelines import hard
        out = hard.prepare_features(
            _source(args), ws,
            MfccConfig(duration_s=args.duration, min_duration_s=1.0),
            TEXT_HARD, device_batch=args.device_batch, force=args.force,
            device=dev)
        print(json.dumps(out["info"], default=str))
    elif cmd == "train-hard":
        from vae_hmc_tpu_torch.pipelines import hard
        cfg = HardVaeConfig(
            beta=args.beta, latent_dim=args.latent_dim,
            hidden_dim=args.hidden_dim, epochs=args.epochs,
            batch_size=args.batch_size, learning_rate=args.lr,
            seed=args.seed, use_cvae=args.cvae,
            cond_genre=args.cond_on in ("genre", "both"),
            cond_lang=args.cond_on in ("lang", "both"),
            include_genre_in_input=args.include_genre_in_input,
            include_lang_in_input=args.include_lang_in_input,
            kl_anneal_epochs=args.kl_anneal_epochs)
        out = hard.train_hard(ws, cfg, tag=args.tag, verbose=args.verbose,
                              device=dev)
        print(f"latents: {tuple(out['latents'].shape)}")
    elif cmd == "cluster-hard":
        from vae_hmc_tpu_torch.pipelines import hard
        out = hard.cluster_and_evaluate(
            ws, k=args.k, seed=args.seed, tag=args.tag,
            latents_path=args.latents_path, device=dev)
        print(json.dumps(out["metrics"], default=str))
    elif cmd == "viz-hard":
        from vae_hmc_tpu_torch.pipelines import hard
        out = hard.visualize_latents(ws, seed=args.seed, tag=args.tag,
                                     latents_path=args.latents_path,
                                     device=dev)
        print(f"latent 2-D via {out['method']}")
    elif cmd == "compare-hard":
        from vae_hmc_tpu_torch.pipelines import hard
        rows = hard.compare_with_baselines(
            ws, k=args.k, pca_dim=args.pca_dim,
            ae_cfg=AeConfig(latent_dim=args.ae_latent, epochs=args.ae_epochs),
            seed=args.seed, tag=args.tag, latents_path=args.latents_path,
            device=dev)
        for r in rows:
            print(r)
    elif cmd == "run-hard":
        from dataclasses import replace as _dc_replace

        from vae_hmc_tpu_torch.core.config import MFCC_HARD
        from vae_hmc_tpu_torch.pipelines import hard
        mfcc_cfg = (MFCC_HARD if args.duration is None
                    else _dc_replace(MFCC_HARD, duration_s=args.duration))
        out = hard.run_hard_pipeline(
            _source(args), ws, mfcc_cfg=mfcc_cfg,
            vae_cfg=HardVaeConfig(beta=args.beta, use_cvae=args.cvae,
                                  cond_genre=args.cvae, epochs=args.epochs,
                                  seed=args.seed),
            tag=args.tag, device_batch=args.device_batch,
            verbose=args.verbose, device=dev)
        print(json.dumps(out["cluster"]["metrics"], default=str))

    elif cmd == "parity-check":
        from vae_hmc_tpu_torch.pipelines import parity
        rows = parity.run_parity_check(
            _source(args), ws, tol_abs=args.tol_abs, tol_rel=args.tol_rel,
            verbose=args.verbose, device_batch=args.device_batch,
            fast=args.fast, device=dev)
        print(parity.format_table(rows))
        parity.save_report(rows, ws.results / "parity_report.csv")
        print(f"report -> {ws.results / 'parity_report.csv'}")
        return 0 if all(r.passed for r in rows) else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
