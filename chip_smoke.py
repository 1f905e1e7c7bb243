#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``vae_hmc_tpu_torch``).

    python3 chip_smoke.py          # from the repository root, on a CUDA machine

Phases (any failure exits non-zero; no phase catches its own failure):
  1. identify the card and build the CUDA kernels from ``csrc/`` with nvcc
     (registers and spills from ptxas);
  2. hold each kernel against its plain PyTorch version on the card, at
     every shape phases 3 and 4 give it and at ragged ones, check that a
     NaN sample stays non-finite through kernel 1 and that kernel 2's
     split-K result repeats bit for bit, count launches per call, and time
     kernel, plain version and a PyTorch library yardstick (CUDA graph
     replays, CUDA events); then the fit's Adam kernel against torch's
     foreach Adam on the conv VAE's 32 full-width tensors (lyrics 384 and
     Moonlight's 2,048 wide), 5 steps, one launch a step, timed with torch's
     fused Adam as the yardstick (CUDA events around a loop); then each of
     the decoder's three ConvTranspose2d(4, 2, 1) forwards alone at batch
     64 and 44, ``F.conv_transpose2d`` against the phase form the float32
     fit runs (``models/conv_mm_vae.phase_conv_transpose2d``), under
     cuDNN's heuristic and its measured pick (a subprocess each), in ms and
     TFLOP/s, failing where the phase form leaves float64 by more than 4
     times the transposed conv's own error;
  3. run the main path once at full model width (``run_core``: the medium
     tier's 2,924 synthetic 15 s tracks -> (128, 646) log-mel -> MiniLM
     lyrics embeddings (synthetic real-shaped weights) -> full ConvMMVAE,
     1 epoch at batch 64 = 46 Adam steps -> KMeans(k=6, n_init=10) ->
     silhouette, Davies-Bouldin, ARI), with the kernels' launch counters
     reset just before and read just after;
  4. from phase 3's tensors, the medium tier's scripts 11, 13 and 16: three
     representations (latents (2924, 32), mel-flat (2924, 82,688), lyrics
     embeddings), the clustering suite (21 rows) and the 102-cell sweep,
     every distance from kernel 2, with the launch counters reset just
     before and read just after;
  5. PCA(2) and t-SNE's perplexity-searched P on the card against the CPU
     for one small input; then the whole medium tier,
     ``run_medium_pipeline`` (scripts 10 -> 11 -> 12 -> 13 -> 16 -> 17,
     then 14 and 15 with PCA and UMAP) at the same full width into a
     temporary workspace, with the launch counters reset just before and
     read just after, and script 14 with t-SNE on its latents; it checks
     the tier's file contract (figures as .png, or as .npz data where
     matplotlib is missing), the CSV headers, 21 and 102 rows and every
     embedding's (N, 2) shape, and prints the stage seconds of
     ``timing_medium.json``, the launches and the peak device memory.  Its
     schedule is cut to 1 epoch and goldens keys carry no epoch count, so
     it reads an empty goldens file (VAE_HMC_GOLDENS_PATH) and must report
     "no-golden";
  6. the easy tier, ``run_easy_pipeline`` (scripts 06 -> 07 -> 08 with
     UMAP -> 09) at 2,924 tracks: 30 s clips (MFCC stats through kernel 1 at
     (64, 1025, 1,292)), the full DenseVaeConfig (80 -> 256 -> 256 -> 16, 40
     epochs at batch 128) and KMeansConfig(); it checks the tier's file
     contract, that scaler.joblib unpickles, the (2924, 16) latents, the 3
     rows of metrics.csv and both kernels' launches; it runs the full
     defaults under VAE_HMC_QUALITY_STRICT=1 and must read "ok" where
     ``vae_hmc_tpu_torch/QUALITY_GOLDENS.json`` certifies easy:gpu:2924;
  7. the hard tier, ``run_hard_pipeline`` (scripts 18 -> 22, tag
     "beta_test") at 2,924 tracks: 20 s clips (kernel 1 at (64, 1025, 862)),
     TF-IDF lyrics, the Beta-VAE (50 epochs at batch 256, "sum" reduction)
     and the AE baseline; the file contract, the 4 baseline rows and
     NMI/ARI/purity in range; then scripts 19 -> 20 -> 22 once more with
     HARD_CVAE on the port's synthetic-MiniLM embeddings of the 2,924 texts:
     the reference's fused width, 464.  The tier runs strict, as phase 6,
     against hard:gpu:2924.
  8. the real-data entry point: a WAV corpus of 390 manifest rows over the
     6 genres in a temporary directory (330 PCM16 mono at 22,050 Hz, 40
     PCM16 stereo at 44,100 Hz, 10 IEEE float32, clips of 0.5, 8 and 19 s,
     3 corrupt files and 4 missing paths, ~90% with lyrics files, half the
     paths with Windows separators); ``run-easy``, ``run-hard`` and
     ``run-medium`` through ``vae_hmc_tpu_torch.cli.main`` with the
     reference's defaults, one ``python -m vae_hmc_tpu_torch.cli run-hard``
     in a subprocess and one ``prepare-hard --synthetic-audio``, each of
     those two in a root of its own.  It checks that the native decoder
     loaded, the report rows (the 7 error rows, the hard tier's one
     too-short clip), 383 rows (382 in the hard tier), finite metrics,
     7 kernel 1 launches a tier, and that the easy tier's MFCC stats of the
     PCM16 rows equal the same quantized waveforms fed to
     ``ops.mfcc.mfcc_stats_batch`` directly; it logs each tier's decode
     seconds, stage seconds and peak device memory.
  9. the trainer's options on the card: (a) ``run-medium --synthetic 2924
     --fast --epochs 2`` through ``cli.main`` (the full ConvMMVaeConfig
     trained in bf16 with float32 master weights, 92 Adam steps), checking
     the file contract, 21 and 102 rows, finite (2924, 32) latents, a
     float32 checkpoint and a falling loss, and logging its train stage's
     ms a step beside phase 5's float32 one (2 epochs of 25: it reads an
     empty goldens file, as phase 5); (b) resume: the full-width
     ConvMMVAE on 2,924 synthetic standardized rows, 2 epochs straight
     against 1 + 1 resumed from ``train_state.ckpt`` under deterministic
     cuDNN, and the easy tier's DenseVaeConfig() on (2924, 80) rows, 4
     epochs against 2 + 2, each bit for bit, with the fit's ms a step in
     float32 (with and without deterministic cuDNN) and in bf16; (c) the
     STFT's FFT method against its DFT method at (64, 1025, 1,292) and
     (128, 1025, 646), within 1e-5 of the peak power, both timed.
 10. the parallel path (``vae_hmc_tpu_torch/parallel``) on ranks spawned
     on the one card (``torch.multiprocessing``, spawn; a ``file://`` store
     in a temporary directory, a 120 s process-group timeout, a join
     timeout; each rank returns its results and its own launch counts):
     (a) NCCL, world size 1, mesh (1, 1): ``synth_features_sharded``
     builds the 2,924 standardized (128, 646) rows through kernel 1, held
     to ``build_logmel`` within 1e-4; ``dp_fit`` of the full-width
     ConvMMVAE, 1 epoch under deterministic cuDNN, held to the
     single-process ``fit`` of the same weights and streams within 1e-6
     relative, and the same fit with cuDNN's default algorithms logged as
     the history's roundoff spread; ``train_conv_mm_vae(mesh=)``, KMeans
     restarts on its latents, and the dense and hard fits; (b) gloo with
     CUDA tensors, 2 ranks, mesh (2, 1): each rank stages its 1,462 rows
     (``stage_features_sharded``, kernel 1) and ``train_conv_mm_vae`` trains
     data parallel; (c) gloo, 4 ranks, mesh (2, 2): the same data and
     tensor parallel (the shard shapes checked), ``train_dense_vae``
     (``DenseVaeConfig()``, (2924, 80)) and ``train_hard_vae``
     (``HARD_CVAE``, 464 wide, 6-wide condition), 4 epochs each, against
     (a)'s; (b) and (c) each end in one sweep cell (KMeans(k=6), the
     silhouette from kernel 2's distances) on rank 0.  (a) also runs the
     split witness, (b)'s step in one process (each batch's rows in the
     two calls that (b)'s ranks make), and the fit with one initial weight
     moved 1 ulp up, for each of three weights.  These fits, (a)'s and the
     nondeterministic one differ in roundoff only; their largest pairwise
     gap, column by column, times 3 is the limit to which the conv
     histories of (b) and (c) are held to (a)'s, and (c)'s to the
     witness's; (b)'s is held to the witness within 5e-5 relative and
     1e-6, the dense and hard ones to (a)'s likewise.  Every rank's
     trained replica must equal rank 0's (parameter sums), and a planted
     fault, (b)'s fit with the gradient all-reduce skipped, must give
     replicas that differ and a history outside the roundoff limits
     against (a)'s and the witness's.  The latents must be
     (2924, 32), finite and the same on every rank, and KMeans restarts
     on (a)'s latents (n_init 10, padded to 12 on 4 ranks; 12 on 1 and 2)
     the same labels and inertia on 1, 2 and 4 ranks.  It logs ms a step,
     all-reduce bytes a step and the peak device memory of each rank, and
     kernel 1 and 2 launches by rank.
 11. the benchmark entry point: ``python -m vae_hmc_tpu_torch.cli bench`` in
     a subprocess, in parity mode and then under BENCH_FAST=1 (bf16), each
     at 2,924 tracks and 25 epochs (1,150 Adam steps) with
     VAE_HMC_QUALITY_STRICT=1.  It checks exit 0, that the last line's keys
     are those of the root bench.py's line (read from its AST by
     ``tests/torch_bench_keys``), 2,924 tracks, 25 epochs and the mode
     string, a MiniLM lyrics backend, finite values in range, a kernel
     smoke that starts with "ok", both kernels
     launched in the timed stages, and ``quality_drift`` "ok" where the
     port's goldens certify bench:gpu:2924:<mode> ("no-golden" elsewhere);
     it logs the stage seconds, tracks/s, and each headline column's gap
     to the JAX package's bench:tpu:2924:<mode> row (not held: the random
     streams and MiniLM's synthetic weights differ).
Each tier runs with the launch counters reset just before and read just
after, and fails unless its kernels were launched.  Phase 2 also holds
kernel 1 in the MFCC mode and on silent and zero-tailed rows at phase 8's
batches, and kernel 2 at (2924, 16), (2924, 80) and phase 8's shapes, to
their plain versions.
The third-to-last line is a JSON object with one entry per kernel (with
``parallel_launches``, by phase 10 part and rank, and ``bench_launches``,
phase 11's timed stages by mode); the card's name and
power limit follow it, and the last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without
the port beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet; dense, full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12          # fp32 outside the tensor cores

MAIN_TRACKS = 2924              # the medium tier's corpus
MAIN_EPOCHS = 1
MEL_FLAT = 128 * 646            # width of the mel-flat representation
DEVICE_BATCH = 128               # log-mel batch of the main path
MFCC_BATCH = 64                  # MFCC batch of the easy and hard tiers

# phase 8's WAV corpus: 390 manifest rows over the 6 genres; 383 decode
# (7 rows fail: 3 corrupt files, 4 missing paths), 382 in the hard tier
# (its 0.5 s clip is too short)
CORPUS_SEED = 42
CORPUS_KINDS = (("pcm16", 30.0, 330), ("stereo44k", 30.0, 40),
                ("float32", 30.0, 10), ("short", 0.5, 1), ("short", 8.0, 1),
                ("short", 19.0, 1), ("corrupt", 0.0, 3), ("missing", 0.0, 4))
FILE_BATCH = 64                  # the CLI's --device-batch default


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


@contextlib.contextmanager
def env_set(**values):
    """Set environment variables for the block, restoring them after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def no_goldens():
    """Point VAE_HMC_GOLDENS_PATH at an empty goldens file for the block: a
    tier run whose schedule is cut (goldens keys carry no epoch count) must
    read "no-golden", not drift against a full-schedule entry."""
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "empty_goldens.json"
        path.write_text("{}\n")
        with env_set(VAE_HMC_GOLDENS_PATH=str(path)):
            yield


def want_drift(key: str) -> str:
    """The status a strict run of `key` must read: "ok" where the port's
    goldens certify the key, else "no-golden"."""
    from vae_hmc_tpu_torch.core import goldens
    return "ok" if key in goldens.load_goldens() else "no-golden"


def check_close(what: str, got, want, atol: float, rtol: float = 0.0) -> float:
    """Fail unless |got - want| <= atol + rtol |want| everywhere (and got is
    finite where want is); -> max abs error."""
    if tuple(got.shape) != tuple(want.shape):
        fail(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = (got - want).abs()
    bad = ~(err <= atol + rtol * want.abs())
    if bool(bad.any()):
        fail(f"{what}: {int(bad.sum())} elements outside atol={atol} "
             f"rtol={rtol}; max abs err {float(err.max()):.3e}")
    max_err = float(err.max()) if err.numel() else 0.0
    log(f"  {what}: max abs err {max_err:.3e} (atol {atol}, rtol {rtol}) ok")
    return max_err


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `reps` calls, CUDA events around one
    replay of a CUDA graph that holds the `reps` calls, after warm-up: the
    host's launch cost drops out, which matters for calls of microseconds."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dist_bound(n: int, m: int, d: int, self_dist: bool):
    """Bound of the (n, d) x (m, d) distances.  For y = x, x is read once and
    the symmetric output needs only the n(n+1)/2 dot products with i <= j."""
    if self_dist:
        return bound(4.0 * (n * d + n * n), 1.0 * n * (n + 1) * d)
    return bound(4.0 * (n * d + m * d + n * m), 2.0 * n * m * d)


def phase_identify_and_build():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    print(smi, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}; device {torch.cuda.get_device_name(0)}")
    from vae_hmc_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    per_kernel = build.build()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in per_kernel.items())})")
    for name, text in build.BUILD_LOGS.items():
        for fn, regs, spills in ptxas_usage(text):
            log(f"  ptxas {name}.cu {fn}: {regs} registers, spill "
                f"{spills}")
    return smi


def ptxas_usage(text: str):
    """[(kernel, registers, spills)] from nvcc's -Xptxas -v output."""
    import re
    rows, fn, spills = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = f"{m.group(1)} B stores, {m.group(2)} B loads"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows.append((fn, int(m.group(1)), spills))
    return rows


def kernel_name(mangled: str) -> str:
    """The function's own name in an Itanium-mangled name: the last
    length-prefixed identifier that ends the nested name ('...14nameE...')."""
    import re
    name = mangled
    for m in re.finditer(r"\d+", mangled):
        n, start = int(m.group()), m.end()
        cand = mangled[start:start + n]
        if len(cand) == n and cand.isidentifier() and \
                mangled[start + n:start + n + 1] == "E":
            name = cand
    return name


def _spectrogram(n_tracks: int, cfg, dev):
    """(B, F, T) power spectrogram of the first n_tracks synthetic tracks."""
    from vae_hmc_tpu_torch.ops.stft import power_spectrogram
    from vae_hmc_tpu_torch.pipelines.sources import SyntheticSource
    src = SyntheticSource.make(n_tracks, seed=7)
    y, _, _ = src.waveforms(list(range(n_tracks)), cfg.duration_s, dev)
    return power_spectrogram(y, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                             power=getattr(cfg, "power", 2.0))


def corpus_plan() -> list:
    """Phase 8's corpus, row by row in manifest order (a seeded shuffle, so
    the odd rows fall in several batches): track_id, genre, kind, seconds,
    the lyrics text (about 90% of rows) and paths relative to --root, half
    written with Windows separators."""
    import numpy as np
    from vae_hmc_tpu_torch.pipelines import synthetic
    rng = np.random.default_rng(CORPUS_SEED)
    kinds = [(k, sec) for k, sec, n in CORPUS_KINDS for _ in range(n)]
    order = rng.permutation(len(kinds))
    has_text = rng.random(len(kinds)) < 0.9
    rows = []
    for pos, i in enumerate(order):
        kind, sec = kinds[i]
        tid = 300000 + 7 * pos
        genre = synthetic.GENRES[pos % len(synthetic.GENRES)]
        sep = "\\" if pos % 2 else "/"
        rows.append({
            "track_id": tid, "genre": genre, "kind": kind, "seconds": sec,
            "audio_path": f"audio{sep}{tid}.wav",
            "text_path": f"text{sep}{tid}.txt" if has_text[pos] else "",
            "text": (synthetic._lyrics_for(genre, tid, CORPUS_SEED, 0.2)
                     if has_text[pos] else None)})
    return rows


def script11_rows() -> int:
    """Rows of phase 4's lyrics representation: the main path's texts of
    at least TextEmbedConfig.min_chars characters (script 11 skips the
    others)."""
    from vae_hmc_tpu_torch.core.config import TextEmbedConfig
    from vae_hmc_tpu_torch.pipelines.sources import SyntheticSource
    src = SyntheticSource.make(MAIN_TRACKS, seed=42)     # run_core's corpus
    return sum(len((src.lyrics_text(i) or "").strip())
               >= TextEmbedConfig().min_chars for i in range(len(src)))


def phase_logmel(dev) -> dict:
    import torch
    from vae_hmc_tpu_torch.core.config import MelConfig
    from vae_hmc_tpu_torch.ops import mel as mel_ops
    from vae_hmc_tpu_torch.ops.kernels import build
    from vae_hmc_tpu_torch.ops.kernels.logmel import (
        cluster_occupancy, mel_db_standardize, mel_db_standardize_plain)

    log("kernel 1 mel_db_standardize against its plain version")
    max_err = 0.0
    cases = [
        ("B=16 full 15 s, top_db=80, standardize", MelConfig(), 16,
         dict(top_db=80.0, standardize=True), 1e-4),
        ("B=16 full 15 s, top_db=None, raw dB", MelConfig(), 16,
         dict(top_db=None, standardize=False), 1e-3),
        ("B=5 ragged 1 s, 32 mels, T=44", MelConfig(duration_s=1.0, n_mels=32),
         5, dict(top_db=80.0, standardize=True), 1e-4),
    ]
    for what, cfg, b, kw, atol in cases:
        spec = _spectrogram(b, cfg, dev)
        table = mel_ops.mel_table(cfg, dev)
        got = mel_db_standardize(spec, table, **kw)
        want = mel_db_standardize_plain(spec, table.fb, **kw)
        torch.cuda.synchronize()
        err = check_close(what, got, want, atol)
        if kw["standardize"]:
            max_err = max(max_err, err)

    # a non-finite sample stays non-finite (the feature driver drops its
    # row); the others keep their values
    cfg = MelConfig(duration_s=1.0, n_mels=32)
    spec = _spectrogram(4, cfg, dev)
    spec[2, 100, 5] = float("nan")
    table = mel_ops.mel_table(cfg, dev)
    got = mel_db_standardize(spec, table, top_db=80.0)
    finite = torch.isfinite(got).all(dim=2).all(dim=1).tolist()
    if finite != [True, True, False, True]:
        fail(f"NaN sample 2: per-sample finite flags {finite}")
    keep = torch.tensor([0, 1, 3], device=dev)
    check_close("NaN in sample 2: the other samples", got[keep],
                mel_db_standardize_plain(spec, table.fb, top_db=80.0)[keep],
                1e-4)
    log("  NaN in sample 2: its features are non-finite, the others finite")

    cfg = MelConfig()
    table = mel_ops.mel_table(cfg, dev)
    fb, weights = table.fb, table.weights
    kw = dict(top_db=mel_ops.effective_top_db(cfg), standardize=True)
    # the partial batches of the main path and of phase 9's CLI run
    for last in (MAIN_TRACKS % DEVICE_BATCH, MAIN_TRACKS % FILE_BATCH):
        spec = _spectrogram(last, cfg, dev)
        max_err = max(max_err, check_close(
            f"B={last} last batch of {MAIN_TRACKS} tracks",
            mel_db_standardize(spec, table, **kw),
            mel_db_standardize_plain(spec, fb, **kw), 1e-4))
    spec = _spectrogram(DEVICE_BATCH, cfg, dev)
    build.reset_launch_counts()
    got = mel_db_standardize(spec, table, **kw)
    per_call = build.launch_counts()["mel_db_standardize"]
    max_err = max(max_err, check_close(
        f"B={DEVICE_BATCH} main-path batch", got,
        mel_db_standardize_plain(spec, fb, **kw), 1e-4))
    b, f, t = spec.shape
    m = fb.shape[0]
    nnz = weights.numel()
    clusters = cluster_occupancy(m, f, t, nnz)
    log(f"  launches per call: {per_call} (one cluster launch of {b} "
        f"clusters x 8 blocks); cluster occupancy granted: {clusters} "
        f"clusters of 8 at once")
    ms = time_ms(lambda: mel_db_standardize(spec, table, **kw))
    plain_ms = time_ms(lambda: mel_db_standardize_plain(spec, fb, **kw))
    # yardstick: cuBLAS matmul(fb, spec) plus torch ops for dB and
    # standardize (no single PyTorch call computes this function)
    library_ms = time_ms(lambda: mel_ops.per_sample_standardize(
        mel_ops.power_to_db(torch.matmul(fb, spec), top_db=kw["top_db"])))
    gemm_ms = time_ms(lambda: torch.matmul(fb, spec))
    # spectrogram, band table, packed weights and features, each once
    bytes_moved = 4.0 * (b * f * t + 2 * m + nnz + b * m * t)
    flops_needed = 2.0 * nnz * b * t           # the filterbank's nonzeros
    bound_ms, bound_by = bound(bytes_moved, flops_needed)
    log(f"  timing at ({b}, {f}, {t}) x ({m}, {f}): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms (GEMM alone "
        f"{gemm_ms:.4f} ms), bound {bound_ms:.4f} ms by {bound_by} "
        f"(fb nnz {nnz} of {m * f}; dense GEMM would be "
        f"{2.0 * m * f * t * b / 1e9:.2f} GFLOP)")
    return {"name": "mel_db_standardize", "route": "cuda",
            "source": "vae_hmc_tpu_torch/csrc/logmel.cu",
            "replaces": "vae_hmc_tpu/ops/pallas/logmel_kernel.py:64",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "gemm_only_ms": gemm_ms,
            "launches_per_call": per_call, "cluster_occupancy": clusters,
            "shape": [b, f, t, m]}


def phase_logmel_mfcc(dev) -> dict:
    """Kernel 1 in the MFCC mode (ref 1.0, 80 dB floor, no standardize) at
    the easy and hard tiers' batches: (64, 1025, T) and the last batch of
    2,924 tracks, (44, 1025, T), for T = 1,292 (30 s) and 862 (20 s)."""
    import torch
    from vae_hmc_tpu_torch.core.config import MFCC_EASY, MFCC_HARD
    from vae_hmc_tpu_torch.ops import mel as mel_ops
    from vae_hmc_tpu_torch.ops.kernels import build
    from vae_hmc_tpu_torch.ops.kernels.logmel import (
        cluster_occupancy, mel_db_standardize, mel_db_standardize_plain)

    log("kernel 1 in the MFCC mode (ref_max=False, top_db=80, no "
        "standardize) at the easy and hard tiers' shapes")
    kw = dict(ref_max=False, top_db=80.0, standardize=False)
    max_err, rows = 0.0, []
    for tier, cfg in (("easy", MFCC_EASY), ("hard", MFCC_HARD)):
        table = mel_ops.mel_table(cfg, dev)
        fb, weights = table.fb, table.weights

        def kernel(spec):
            return mel_db_standardize(spec, table, **kw)

        for b in (MAIN_TRACKS % MFCC_BATCH, MFCC_BATCH):
            spec = _spectrogram(b, cfg, dev)
            build.reset_launch_counts()
            got = kernel(spec)
            per_call = build.launch_counts()["mel_db_standardize"]
            if per_call != 1:
                fail(f"kernel 1 counted {per_call} launches for one call")
            max_err = max(max_err, check_close(
                f"{tier} MFCC mode {tuple(spec.shape)}", got,
                mel_db_standardize_plain(spec, fb, **kw), 1e-3))
        # a non-finite sample stays non-finite in this mode too
        spec[1, 100, 5] = float("nan")
        got = kernel(spec)
        finite = torch.isfinite(got).all(dim=2).all(dim=1)
        if bool(finite[1]) or not bool(finite[[0, 2]].all()):
            fail(f"{tier} MFCC mode: NaN in sample 1 gives finite flags "
                 f"{finite[:3].tolist()}")
        spec = _spectrogram(MFCC_BATCH, cfg, dev)
        b, f, t = spec.shape
        m, nnz = fb.shape[0], weights.numel()
        clusters = cluster_occupancy(m, f, t, nnz)
        ms = time_ms(lambda: kernel(spec))
        plain_ms = time_ms(lambda: mel_db_standardize_plain(spec, fb, **kw))
        library_ms = time_ms(lambda: mel_ops.power_to_db(
            torch.matmul(fb, spec), ref_max=False, top_db=80.0))
        bound_ms, bound_by = bound(4.0 * (b * f * t + 2 * m + nnz + b * m * t),
                                   2.0 * nnz * b * t)
        log(f"  {tier}: NaN sample stays non-finite; cluster occupancy "
            f"granted at T = {t}: {clusters} clusters of 8 at once; timing at "
            f"({b}, {f}, {t}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms by "
            f"{bound_by} ({bound_ms / ms:.1%} of the bound)")
        rows.append({"tier": tier, "shape": [b, f, t, m], "ms": ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "cluster_occupancy": clusters})
        del spec
    torch.cuda.empty_cache()
    return {"mfcc_max_abs_err": max_err, "mfcc_rows": rows}


def phase_logmel_file_rows(dev) -> dict:
    """Kernel 1 on what a file-backed batch holds (phase 8): an all-zero row
    (a row that failed to decode; its mel slice is constant, max = amin,
    centred variance exactly 0, and standardize divides by 0 + eps), a row
    zero past 0.5 s and one zero past 8 s (short clips' padded tails), at
    phase 8's batches B = 64 and 6 and its three frame counts: T = 646
    standardized (medium), 1,292 and 862 in the MFCC mode (easy, hard).
    The tolerances are phase 2's: 1e-4 standardized, 1e-3 dB raw."""
    import torch
    from vae_hmc_tpu_torch.core.config import MFCC_EASY, MFCC_HARD, MelConfig
    from vae_hmc_tpu_torch.ops import mel as mel_ops
    from vae_hmc_tpu_torch.ops.kernels.logmel import (
        mel_db_standardize, mel_db_standardize_plain)
    from vae_hmc_tpu_torch.ops.stft import power_spectrogram
    from vae_hmc_tpu_torch.pipelines.sources import SyntheticSource

    log("kernel 1 on silent and zero-tailed rows at phase 8's batches")
    last = len(corpus_plan()) % FILE_BATCH
    src = SyntheticSource.make(FILE_BATCH, seed=9)
    max_err, rows = 0.0, []
    for tier, cfg, kw, atol in (
            ("medium", MelConfig(), dict(top_db=mel_ops.effective_top_db(
                MelConfig()), standardize=True), 1e-4),
            ("easy", MFCC_EASY, dict(ref_max=False, top_db=80.0,
                                     standardize=False), 1e-3),
            ("hard", MFCC_HARD, dict(ref_max=False, top_db=80.0,
                                     standardize=False), 1e-3)):
        table = mel_ops.mel_table(cfg, dev)
        fb, weights = table.fb, table.weights
        for b in (FILE_BATCH, last):
            y, _, _ = src.waveforms(list(range(b)), cfg.duration_s, dev)
            y[0] = 0.0
            y[1, int(0.5 * cfg.sample_rate):] = 0.0
            y[2, int(8.0 * cfg.sample_rate):] = 0.0
            spec = power_spectrogram(y, n_fft=cfg.n_fft,
                                     hop_length=cfg.hop_length)
            got = mel_db_standardize(spec, table, **kw)
            want = mel_db_standardize_plain(spec, fb, **kw)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                fail(f"{tier} {tuple(spec.shape)}: non-finite features from "
                     "silent or zero-tailed rows")
            max_err = max(max_err, check_close(
                f"{tier} silent/zero-tailed rows {tuple(spec.shape)}", got,
                want, atol))
            if b == last:
                ms = time_ms(lambda: mel_db_standardize(spec, table, **kw))
                plain_ms = time_ms(lambda: mel_db_standardize_plain(
                    spec, fb, **kw))
                # yardstick as in phase 2: cuBLAS matmul(fb, spec) + torch ops
                if kw["standardize"]:
                    library_ms = time_ms(lambda: mel_ops.per_sample_standardize(
                        mel_ops.power_to_db(torch.matmul(fb, spec),
                                            top_db=kw["top_db"])))
                else:
                    library_ms = time_ms(lambda: mel_ops.power_to_db(
                        torch.matmul(fb, spec), ref_max=False, top_db=80.0))
                m, f, t = fb.shape[0], spec.shape[1], spec.shape[2]
                nnz = weights.numel()
                bound_ms, bound_by = bound(
                    4.0 * (b * f * t + 2 * m + nnz + b * m * t),
                    2.0 * nnz * b * t)
                log(f"  timing at ({b}, {f}, {t}): kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
                    f"{bound_ms:.4f} ms by {bound_by}")
                rows.append({"tier": tier, "shape": [b, f, t, m], "ms": ms,
                             "plain_ms": plain_ms, "library_ms": library_ms,
                             "bound_ms": bound_ms, "bound_by": bound_by})
            del y, spec, got, want
    torch.cuda.empty_cache()
    return {"file_rows_max_abs_err": max_err, "file_rows": rows}


def file_dist_shapes(lyrics_rows: int) -> list:
    """Kernel 2's inputs in phase 8: (rows, width) of every representation
    it sees (easy latents and PCA(16) of 383 tracks, hard latents, PCA(32)
    and MFCC stats of 382, medium latents, mel-flat and lyrics), each also
    against 8 centroids."""
    ok = len(corpus_plan()) - sum(n for k, _, n in CORPUS_KINDS
                                  if k in ("corrupt", "missing"))
    return [(ok, 16), (ok - 1, 16), (ok - 1, 32), (ok - 1, 80), (ok, 80),
            (ok, 32), (ok, MEL_FLAT), (lyrics_rows, 384)]


def phase_distance(dev, lyrics_rows: int, file_shapes: list) -> dict:
    import torch
    from vae_hmc_tpu_torch.ops.kernels import build
    from vae_hmc_tpu_torch.ops.kernels.distance import (
        n_tiles, occupancy, pairwise_dists, pairwise_dists_plain,
        split_k_bounds)

    log("kernel 2 pairwise_dists against its plain version")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def centred(n, d):
        x = torch.randn((n, d), generator=gen, device=dev)
        return (x - x.mean(dim=0, keepdim=True)).contiguous()

    # every shape the main path and scripts 13/16 give kernel 2: the
    # silhouette / latents cache, the lyrics cache (script 11's rows), the
    # mel-flat cache, and the masked Davies-Bouldin's point -> centroid
    # and centroid self-distances (k = 6 in run_core, k <= 8 for kmeans and
    # ward in the sweep; DBSCAN's k follows the data, and every k <= 64 is
    # one tile column, as here)
    max_err = 0.0
    cases = [((MAIN_TRACKS, 32), None), ((MAIN_TRACKS, 32), 6),
             ((6, 32), None), ((MAIN_TRACKS, 32), 8), ((8, 32), None),
             ((lyrics_rows, 384), None), ((lyrics_rows, 384), 8),
             ((8, 384), None),
             ((MAIN_TRACKS, MEL_FLAT), None), ((MAIN_TRACKS, MEL_FLAT), 8),
             ((8, MEL_FLAT), None),
             ((256, MEL_FLAT), None), ((37, 17), None),
             # phases 6-7: latents and PCA(16), MFCC stats (80)
             ((MAIN_TRACKS, 16), None), ((MAIN_TRACKS, 80), None)]
    # phase 8: the file corpus's representations, self and x 8 centroids
    cases += [(shape, m) for shape in file_shapes for m in (None, 8)]
    for (n, d), m in cases:
        x = centred(n, d)
        y = None if m is None else centred(m, d)
        got = pairwise_dists(x, y)
        want = pairwise_dists_plain(x, y)
        torch.cuda.synchronize()
        what = f"({n}, {d}) " + ("self" if m is None else f"x ({m}, {d})")
        max_err = max(max_err, check_close(what, got, want, 1e-2, 1e-4))
        del x, y, got, want

    # split-K (mel-flat width): the same bits on every call
    xs = centred(70, 20000)
    first, second = pairwise_dists(xs), pairwise_dists(xs)
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        fail("kernel 2 split-K: two calls differ")
    log("  split-K (70, 20000) self: two calls bit-identical")

    sms_blocks = occupancy(dev)        # (SMs, tile blocks resident per SM)
    for (n, d), m in cases:
        xa, ya = centred(n, d), (None if m is None else centred(m, d))
        build.reset_launch_counts()
        pairwise_dists(xa, ya)
        count = build.launch_counts()["pairwise_dists"]
        slices = len(split_k_bounds(n_tiles(n, m or n, m is None), d,
                                    *sms_blocks))
        log(f"  launches per call at ({n}, {d}) x ({m or n}, {d}): counter "
            f"{count}, device launches {1 + (slices > 1)} ({slices} "
            f"d-slices; {sms_blocks[0]} SMs x {sms_blocks[1]} blocks)")
        if count != 1:
            fail(f"kernel 2 counted {count} launches for one call")

    x = centred(MAIN_TRACKS, 32)                # silhouette on the main path
    ms = time_ms(lambda: pairwise_dists(x), reps=200)
    plain_ms = time_ms(lambda: pairwise_dists_plain(x), reps=200)
    library_ms = time_ms(lambda: torch.cdist(x, x), reps=200)
    n, d = x.shape
    bound_ms, bound_by = dist_bound(n, n, d, self_dist=True)
    log(f"  timing at ({n}, {d}) self: kernel {ms:.5f} ms, plain "
        f"{plain_ms:.5f} ms, torch.cdist {library_ms:.5f} ms, bound "
        f"{bound_ms:.5f} ms by {bound_by}")
    # Davies-Bouldin's point -> centroid call (metrics/internal.py:129)
    c6 = centred(6, d)
    dbi_ms = time_ms(lambda: pairwise_dists(x, c6), reps=200)
    dbi_plain = time_ms(lambda: pairwise_dists_plain(x, c6), reps=200)
    dbi_library = time_ms(lambda: torch.cdist(x, c6), reps=200)
    dbi_bound, dbi_by = dist_bound(n, 6, d, self_dist=False)
    log(f"  timing at ({n}, {d}) x (6, {d}) (Davies-Bouldin): kernel "
        f"{dbi_ms:.5f} ms, plain {dbi_plain:.5f} ms, torch.cdist "
        f"{dbi_library:.5f} ms, bound {dbi_bound:.5f} ms by {dbi_by}")
    dbi_row = {"shape": [n, 6, d], "ms": dbi_ms, "plain_ms": dbi_plain,
               "library_ms": dbi_library, "bound_ms": dbi_bound,
               "bound_by": dbi_by}
    tier_rows = []
    for dt in (16, 80):                         # phases 6-7's silhouettes
        xt = centred(MAIN_TRACKS, dt)
        t_ms = time_ms(lambda: pairwise_dists(xt), reps=200)
        t_plain = time_ms(lambda: pairwise_dists_plain(xt), reps=200)
        t_lib = time_ms(lambda: torch.cdist(xt, xt), reps=200)
        t_bound, t_by = dist_bound(MAIN_TRACKS, MAIN_TRACKS, dt,
                                   self_dist=True)
        log(f"  timing at ({MAIN_TRACKS}, {dt}) self: kernel {t_ms:.5f} ms, "
            f"plain {t_plain:.5f} ms, torch.cdist {t_lib:.5f} ms, bound "
            f"{t_bound:.5f} ms by {t_by}")
        tier_rows.append({"shape": [MAIN_TRACKS, MAIN_TRACKS, dt], "ms": t_ms,
                          "plain_ms": t_plain, "library_ms": t_lib,
                          "bound_ms": t_bound, "bound_by": t_by})
    xf = centred(256, 82688)
    flat_ms = time_ms(lambda: pairwise_dists(xf), reps=10)
    flat_plain = time_ms(lambda: pairwise_dists_plain(xf), reps=10)
    flat_library = time_ms(lambda: torch.cdist(xf, xf), reps=10)
    flat_bound, flat_by = dist_bound(256, 256, 82688, self_dist=True)
    log(f"  timing at (256, 82688) self: kernel {flat_ms:.4f} ms, plain "
        f"{flat_plain:.4f} ms, torch.cdist {flat_library:.4f} ms, bound "
        f"{flat_bound:.4f} ms by {flat_by}")
    file_rows = []
    for n_f, d_f in sorted(set(file_shapes)):   # phase 8's caches, self
        xt = centred(n_f, d_f)
        reps = 10 if d_f > 1000 else 200
        t_ms = time_ms(lambda: pairwise_dists(xt), reps=reps)
        t_plain = time_ms(lambda: pairwise_dists_plain(xt), reps=reps)
        t_lib = time_ms(lambda: torch.cdist(xt, xt), reps=reps)
        t_bound, t_by = dist_bound(n_f, n_f, d_f, self_dist=True)
        log(f"  timing at ({n_f}, {d_f}) self: kernel {t_ms:.5f} ms, plain "
            f"{t_plain:.5f} ms, torch.cdist {t_lib:.5f} ms, bound "
            f"{t_bound:.5f} ms by {t_by}")
        file_rows.append({"shape": [n_f, n_f, d_f], "ms": t_ms,
                          "plain_ms": t_plain, "library_ms": t_lib,
                          "bound_ms": t_bound, "bound_by": t_by})
        del xt
    # the sweep's per-representation cache at the mel-flat width
    del xf
    xs = centred(MAIN_TRACKS, MEL_FLAT)
    cache_ms = time_ms(lambda: pairwise_dists(xs), reps=3, warmup=1)
    cache_plain = time_ms(lambda: pairwise_dists_plain(xs), reps=3, warmup=1)
    cache_library = time_ms(lambda: torch.cdist(xs, xs), reps=3, warmup=1)
    cache_bound, cache_by = dist_bound(MAIN_TRACKS, MAIN_TRACKS, MEL_FLAT,
                                       self_dist=True)
    log(f"  timing at ({MAIN_TRACKS}, {MEL_FLAT}) self: kernel {cache_ms:.4f} "
        f"ms, plain {cache_plain:.4f} ms, torch.cdist {cache_library:.4f} ms, "
        f"bound {cache_bound:.4f} ms by {cache_by} "
        f"({cache_bound / cache_ms:.1%} of the bound)")
    del xs
    torch.cuda.empty_cache()
    return {"name": "pairwise_dists", "route": "cuda",
            "source": "vae_hmc_tpu_torch/csrc/distance.cu",
            "replaces": "vae_hmc_tpu/ops/pallas/distance_kernel.py:71",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "shape": [n, n, d],
            "mel_flat_ms": flat_ms, "mel_flat_plain_ms": flat_plain,
            "mel_flat_library_ms": flat_library,
            "mel_flat_bound_ms": flat_bound,
            "sweep_cache_ms": cache_ms, "sweep_cache_plain_ms": cache_plain,
            "sweep_cache_library_ms": cache_library,
            "sweep_cache_bound_ms": cache_bound,
            "sweep_cache_shape": [MAIN_TRACKS, MAIN_TRACKS, MEL_FLAT],
            "dbi_row": dbi_row, "tier_rows": tier_rows,
            "file_rows": file_rows}


ADAM_STEPS = 5                   # phase 2: Adam steps held to the plain version
ADAM_LYRICS_DIMS = (("conv", 384), ("moonlight", 2048))


def time_loop_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `reps` calls in a loop between CUDA
    events, after warm-up (for updates that a CUDA graph cannot hold:
    torch's foreach Adam keeps its step count on the host)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_adam(dev) -> dict:
    """The fit's Adam kernel (``ops/kernels/adam.adam_step``) against its
    plain version on the card, torch's foreach ``opt.step()``, on the conv
    VAE's 32 full-width tensors (logvar_a's two without a gradient, as in
    the fit), with lyrics 384 wide (conv) and 2,048 (Moonlight): p, m and v
    of every tensor within 1e-6 of its largest magnitude after ADAM_STEPS
    steps of the same gradients, one launch a step; then kernel, plain and
    library (torch's fused Adam, a yardstick the port never calls) timed,
    beside the bound of 28 B a parameter at 3.35 TB/s."""
    import torch
    from vae_hmc_tpu_torch.core.config import ConvMMVaeConfig
    from vae_hmc_tpu_torch.models.api import build_conv_mm_vae
    from vae_hmc_tpu_torch.ops.kernels import build
    from vae_hmc_tpu_torch.ops.kernels.adam import adam_step

    log("Adam kernel adam_update against torch's foreach Adam")
    out = {}
    for what, lyrics_dim in ADAM_LYRICS_DIMS:
        named = list(build_conv_mm_vae(ConvMMVaeConfig(), 128, 646,
                                       lyrics_dim).named_parameters())
        lr = ConvMMVaeConfig().learning_rate
        copies = {}
        for side, kw in (("kernel", {}), ("plain", {"foreach": True}),
                         ("library", {"fused": True})):
            params = [p.detach().to(dev).requires_grad_(True)
                      for _, p in named]
            copies[side] = (params, torch.optim.Adam(params, lr=lr, **kw))
        gen = torch.Generator(device=dev).manual_seed(1)
        grads = [None if k.startswith("logvar_a.") else
                 1e-2 * torch.randn(p.shape, device=dev, generator=gen)
                 for k, p in named]
        del named
        n_upd = sum(p.numel() for p, g in zip(copies["kernel"][0], grads)
                    if g is not None)
        for params, _ in copies.values():
            for p, g in zip(params, grads):
                p.grad = g
        steps = {"kernel": lambda: adam_step(copies["kernel"][1]),
                 "plain": copies["plain"][1].step,
                 "library": copies["library"][1].step}
        build.reset_launch_counts()
        for _ in range(ADAM_STEPS):
            for side, fn in steps.items():
                fn()
            for g in grads:
                if g is not None:
                    g.mul_(-0.7)             # the next step's gradients
        torch.cuda.synchronize()
        launches = build.launch_counts()["adam_update"]
        if launches != ADAM_STEPS:
            fail(f"Adam ({what}): {launches} launches in {ADAM_STEPS} steps")
        worst = {"kernel": 0.0, "library": 0.0}
        plain_params, plain_opt = copies["plain"]
        for side in worst:
            params, opt = copies[side]
            for p, q, g in zip(params, plain_params, grads):
                if g is None:
                    if opt.state[p]:
                        fail(f"Adam ({what}, {side}): state for a tensor "
                             "without a gradient")
                    continue
                for key in (None, "exp_avg", "exp_avg_sq"):
                    got = p.detach() if key is None else opt.state[p][key]
                    want = (q.detach() if key is None
                            else plain_opt.state[q][key])
                    gap = float((got - want).abs().max() / want.abs().max())
                    worst[side] = max(worst[side], gap)
        log(f"  {what} ({len(grads)} tensors, {n_upd} updated parameters): "
            f"after {ADAM_STEPS} steps kernel - plain worst {worst['kernel']:.3e}"
            f" of a tensor's largest magnitude (library - plain "
            f"{worst['library']:.3e}); {launches} launches")
        if worst["kernel"] > 1e-6:
            fail(f"Adam ({what}): kernel off torch's foreach Adam by "
                 f"{worst['kernel']:.3e} of a tensor's largest magnitude")
        times = {side: time_loop_ms(fn) for side, fn in steps.items()}
        bound_ms = 28.0 * n_upd / HBM_BYTES_PER_S * 1e3
        log(f"  {what}: kernel {times['kernel']:.4f} ms, bound "
            f"{bound_ms:.4f} ms by bytes ({100 * bound_ms / times['kernel']:.1f}"
            f"%), plain {times['plain']:.4f} ms, library "
            f"{times['library']:.4f} ms")
        out[what] = {"ms": times["kernel"], "bound_ms": bound_ms,
                     "plain_ms": times["plain"],
                     "library_ms": times["library"],
                     "max_rel_err": worst["kernel"],
                     "library_max_rel_err": worst["library"],
                     "params": n_upd, "tensors": len(grads),
                     "launches_per_step": launches / ADAM_STEPS}
        del copies, grads, steps
        torch.cuda.empty_cache()
    conv = out["conv"]
    return {"name": "adam_update", "route": "cuda",
            "source": "vae_hmc_tpu_torch/csrc/adam.cu", "replaces": None,
            "max_rel_err": conv["max_rel_err"], "ms": conv["ms"],
            "plain_ms": conv["plain_ms"], "bound_ms": conv["bound_ms"],
            "bound_by": "bytes", "library_ms": conv["library_ms"],
            "shape": [conv["tensors"], conv["params"]], "moonlight": out[
                "moonlight"]}


DECONV_BATCHES = (64, 44)         # the fit's batch and its last step's rows
DECONV_TIMEOUT_S = 300           # phase 2: one deconv probe subprocess


def deconv_probe(mode: str) -> None:
    """Each of the full-width ConvMMVAE's three ConvTranspose2d(4, 2, 1)
    forwards alone at DECONV_BATCHES: ``F.conv_transpose2d`` against the
    decoder's phase form (``phase_conv_transpose2d``), each timed
    (``time_ms``) and held to ``F.conv_transpose2d`` in float64 on the
    card; cuDNN picks engines by its heuristic (`mode` "heuristic") or by
    timing them (`mode` "measured": the fit's ``measured_conv_engines``).
    torch keeps the plan a conv shape first ran for the whole process, so
    each mode runs in a process of its own (``phase_deconv``); prints one
    JSON line, a row a layer and batch."""
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, str(ROOT))
    from vae_hmc_tpu_torch.core.config import ConvMMVaeConfig
    from vae_hmc_tpu_torch.core.device import (measured_conv_engines,
                                               resolve_device)
    from vae_hmc_tpu_torch.models.api import build_conv_mm_vae
    from vae_hmc_tpu_torch.models.conv_mm_vae import phase_conv_transpose2d

    dev = resolve_device("cuda")
    model = build_conv_mm_vae(ConvMMVaeConfig(), 128, 646, 384).to(dev)
    (h, w), rows = model.enc_hw, []
    gen = torch.Generator(device=dev).manual_seed(19)
    with (measured_conv_engines() if mode == "measured"
          else contextlib.nullcontext()), torch.no_grad():
        for i, deconv in enumerate(model.dec_convs):
            wt, bias = deconv.weight, deconv.bias
            for b in DECONV_BATCHES:
                x = torch.randn((b, deconv.in_channels, h << i, w << i),
                                generator=gen, device=dev).relu_()
                want = F.conv_transpose2d(x.double(), wt.double(),
                                          bias.double(), stride=2, padding=1)
                fns = {"transposed": lambda: F.conv_transpose2d(
                           x, wt, bias, stride=2, padding=1),
                       "phase": lambda: phase_conv_transpose2d(x, wt, bias)}
                err = {k: float((fn().double() - want).abs().max())
                       for k, fn in fns.items()}
                ms = {k: time_ms(fn) for k, fn in fns.items()}
                flops = (2.0 * b * deconv.in_channels * deconv.out_channels
                         * 16 * x.shape[2] * x.shape[3])
                rows.append({"layer": i, "batch": b, "mode": mode,
                             "shape": list(x.shape), "gflop": flops / 1e9,
                             "ms": ms, "err": err,
                             "tflops": {k: flops / v / 1e9
                                        for k, v in ms.items()}})
    print(json.dumps(rows), flush=True)


def phase_deconv() -> list:
    """Phase 2's decoder probe: ``deconv_probe`` in a subprocess a mode;
    fails where the phase form leaves float64 by more than 4 times the
    transposed conv's own error.  -> the rows of both modes."""
    log("decoder ConvTranspose2d(4, 2, 1) forwards: transposed vs phase "
        "form, heuristic and measured engines")
    rows = []
    for mode in ("heuristic", "measured"):
        proc = subprocess.run(
            [sys.executable, "-c", "import chip_smoke; "
             f"chip_smoke.deconv_probe({mode!r})"], cwd=ROOT,
            capture_output=True, text=True, timeout=DECONV_TIMEOUT_S)
        if proc.returncode != 0:
            for line in proc.stderr.splitlines()[-30:]:
                log(f"  | {line}")
            fail(f"deconv probe ({mode}) exited {proc.returncode}")
        rows += json.loads(proc.stdout.strip().splitlines()[-1])
    for r in rows:
        ms, tf, err = r["ms"], r["tflops"], r["err"]
        log(f"  dec_convs.{r['layer']} {r['shape']} {r['mode']}: transposed "
            f"{ms['transposed']:.4f} ms ({tf['transposed']:.1f} TFLOP/s), "
            f"phase {ms['phase']:.4f} ms ({tf['phase']:.1f} TFLOP/s), "
            f"{r['gflop']:.2f} GFLOP; max abs err against float64 "
            f"{err['transposed']:.3e} / {err['phase']:.3e}")
        if not err["phase"] <= 4.0 * err["transposed"]:
            fail(f"dec_convs.{r['layer']} at batch {r['batch']} ({r['mode']})"
                 f": the phase form is {err['phase']:.3e} off float64, the "
                 f"transposed conv {err['transposed']:.3e}")
    return rows


def phase_main_path(dev):
    """-> (the kernels' launches in run_core, run_core's tensors, its
    corpus)."""
    import torch
    from vae_hmc_tpu_torch.ops.kernels import build
    from vae_hmc_tpu_torch.pipelines.bench_chain import run_core

    log(f"main path: run_core(n_tracks={MAIN_TRACKS}, epochs={MAIN_EPOCHS}) "
        "at full model width")
    torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launch_counts()
    res = run_core(n_tracks=MAIN_TRACKS, epochs=MAIN_EPOCHS, device=dev,
                   device_batch=DEVICE_BATCH)
    launches = build.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    for k in ("seconds_features", "seconds_lyrics", "seconds_train",
              "seconds_cluster_metrics", "seconds_total"):
        log(f"  {k}: {res[k]:.3f}")
    log(f"  feature shape {res['feature_shape']}, mu shape {res['mu_shape']}, "
        f"report ok {res['report_ok']}")
    log(f"  lyrics backend: {res['lyrics_backend']}")
    log(f"  loss per epoch: {[round(h['total'], 5) for h in res['history']]}")
    log(f"  final loss {res['train_final_loss']:.5f}, silhouette "
        f"{res['silhouette']:.5f}, davies_bouldin {res['davies_bouldin']:.5f}"
        f", ari_vs_genre {res['ari_vs_genre']:.5f}, kmeans inertia "
        f"{res['kmeans_inertia']:.5f} in {res['kmeans_n_iter']} iterations")
    log(f"  peak device memory {peak / 2**30:.3f} GiB")
    log(f"  kernels: {json.dumps(launches)}")

    if res["feature_shape"] != [MAIN_TRACKS, 128, 646, 1]:
        fail(f"feature shape {res['feature_shape']}")
    if res["mu_shape"] != [MAIN_TRACKS, 32] or res["report_ok"] != MAIN_TRACKS:
        fail(f"mu shape {res['mu_shape']}, report ok {res['report_ok']}")
    for k in ("train_final_loss", "silhouette", "davies_bouldin",
              "ari_vs_genre"):
        if not math.isfinite(res[k]):
            fail(f"{k} is not finite: {res[k]}")
    if not (-1.0 <= res["silhouette"] <= 1.0 and res["davies_bouldin"] > 0.0
            and -1.0 <= res["ari_vs_genre"] <= 1.0):
        fail("a clustering metric is outside its range")
    if not res["lyrics_backend"].startswith("minilm"):
        fail(f"lyrics backend {res['lyrics_backend']!r}, not MiniLM")
    if launches != res["launches"]:
        fail(f"launch counts {launches} != run_core's {res['launches']}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} was not launched on the main path")
    return launches, res["tensors"], res["source"]


# the JAX package's CSV headers of scripts 13 and 16
# (vae_hmc_tpu/pipelines/medium.py _HDR13, _HDR16)
HDR13 = ["representation", "algo", "params", "n_clusters_found", "n_noise",
         "silhouette", "davies_bouldin", "ari"]
HDR16 = ["representation", "algo", "params", "n_clusters_found", "n_noise",
         "noise_frac", "silhouette", "davies_bouldin", "ari", "score"]


def phase_medium_sweep(dev, tensors, source, lyrics_rows: int) -> dict:
    """Scripts 11, 13 and 16 on phase 3's tensors and corpus, into a
    temporary workspace."""
    import csv
    import tempfile
    import torch
    from vae_hmc_tpu_torch.core.config import Workspace
    from vae_hmc_tpu_torch.ops.kernels import build
    from vae_hmc_tpu_torch.pipelines.medium import scripts_11_13_16

    log("medium tier scripts 11, 13 and 16 on the main path's tensors")
    headers = {}
    with tempfile.TemporaryDirectory() as root:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        build.reset_launch_counts()
        out = scripts_11_13_16(source, Workspace(root), tensors["mu"],
                               tensors["features"], tensors["track_ids"],
                               device=dev)
        launches = build.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        for name in ("medium_clustering_metrics_all.csv",
                     "medium_full_sweep_metrics.csv",
                     "medium_full_sweep_best_by_representation.csv",
                     "medium_full_sweep_best_overall.csv"):
            path = Path(root) / "results" / name
            if not path.exists():
                fail(f"{name} was not written")
            with open(path, newline="") as f:
                headers[name] = next(csv.reader(f))
    rows13, rows16, sec = out["rows13"], out["rows16"], out["seconds"]

    log("  representations: " + ", ".join(
        f"{r.name} {tuple(r.x_dev.shape)}" for r in out["reps"])
        + f"; lyrics backend {out['lyrics_backend']}")
    log(f"  seconds: representations {sec['seconds_representations']:.3f}, "
        f"script 13 {sec['seconds_script13']:.3f}, script 16 "
        f"{sec['seconds_script16']:.3f}")
    log(f"  rows: script 13 {len(rows13)}, script 16 {len(rows16)}")
    log(f"  peak device memory {peak / 2**30:.3f} GiB")
    log(f"  kernels: {json.dumps(launches)}")
    for r in rows13:
        log(f"    13 {r['representation']:21s} {r['algo']:13s} "
            f"{r['params']:14s} n={r['n_clusters_found']} noise={r['n_noise']}"
            f" sil={r['silhouette']} dbi={r['davies_bouldin']} ari={r['ari']}")

    shapes = [tuple(r.x_dev.shape) for r in out["reps"]]
    if shapes != [(MAIN_TRACKS, 32), (MAIN_TRACKS, MEL_FLAT),
                  (lyrics_rows, 384)]:
        fail(f"representation shapes {shapes} are not those phase 2 checked")
    if len(rows13) != 21 or len(rows16) != 102:
        fail(f"{len(rows13)} suite rows and {len(rows16)} sweep rows, "
             "want 21 and 102")
    for r in rows13 + rows16:
        if r["algo"] == "dbscan":
            continue
        sil, dbi = r["silhouette"], r["davies_bouldin"]
        if not (sil is not None and math.isfinite(sil) and -1.0 <= sil <= 1.0
                and dbi is not None and dbi > 0.0 and r["ari"] is not None):
            fail(f"row {r} lacks a finite silhouette in [-1, 1], a DBI > 0 "
                 "or an ARI")
    for name, header in headers.items():
        want = HDR13 if name == "medium_clustering_metrics_all.csv" else HDR16
        if header != want:
            fail(f"{name} header {header} != {want}")
    if launches["pairwise_dists"] <= 0:
        fail("kernel 2 was not launched by scripts 13 and 16")
    return {**sec, "launches": launches, "peak_bytes": peak}


# the medium tier's file contract (the JAX package's
# tests/test_medium_pipeline.py list, script 14's files, the checkpoint,
# script 17's plots and the timing file); a figure is its .png or, without
# matplotlib, its data as .npz of the same stem
PIPELINE_FILES = [
    "data/audio_cnn_mel_X.npy", "data/audio_cnn_mel_track_ids.npy",
    "results/audio_cnn_mel_build_report.csv",
    "data/lyrics_embeddings.npy", "data/lyrics_track_ids.npy",
    "results/lyrics_embedding_report.csv",
    "results/vae_conv_mm_medium/train_log.csv",
    "results/vae_conv_mm_medium/ckpt_epoch_001.pt",
    "results/vae_conv_mm_medium/ckpt_epoch_001.pt.meta.json",
    "data/vae_mm_latents_mu.npy", "data/vae_mm_latents_track_ids.npy",
    "results/medium_clustering_metrics_all.csv",
    "results/medium_full_sweep_metrics.csv",
    "results/medium_full_sweep_best_by_representation.csv",
    "results/medium_full_sweep_best_overall.csv",
    "results/report_medium/best_filtered.csv",
    "results/report_medium/best_filtered_by_representation.csv",
    "results/report_medium/plot_silhouette.png",
    "results/report_medium/plot_davies_bouldin.png",
    "results/report_medium/plot_ari.png",
    "results/report_medium/dbscan_noise_vs_eps_baseline_lyrics_only.png",
    "results/report_medium/dbscan_clusters_vs_eps_baseline_mel_flat.png",
    "results/cluster_viz/vae_kmeans6_vae_mm_latents_mu_kmeans_pca_clusters.png",
    "results/cluster_viz/vae_kmeans6_vae_mm_latents_mu_kmeans_pca_truegenre.png",
    "results/cluster_viz/vae_kmeans6_vae_mm_latents_mu_kmeans_pca_summary.txt",
    "results/cluster_viz/side_by_side_medium.png",
    "results/cluster_viz/lyrics_dbscan_eps_sweep_clusters_medium.png",
    "results/cluster_viz/lyrics_dbscan_eps_sweep_noise_medium.png",
    "results/timing_medium.json",
]


def _finite_2d(what: str, xy, n: int) -> None:
    import numpy as np
    xy = np.asarray(xy)
    if xy.shape != (n, 2) or not np.isfinite(xy).all():
        fail(f"{what}: shape {xy.shape} (want ({n}, 2)) or non-finite")


def phase_viz_on_card(dev) -> None:
    """PCA(2) and t-SNE's perplexity-searched P on the card against the
    same functions on the CPU, for one small input."""
    import numpy as np
    import torch
    from vae_hmc_tpu_torch.ops.pca import PCA
    from vae_hmc_tpu_torch.viz import tsne
    log("PCA(2) and t-SNE's P on the card against the CPU")
    x = np.random.default_rng(11).normal(0, 1, (300, 40)).astype(np.float32)
    x[:, :3] *= (4.0, 3.0, 2.0)          # separated leading components
    got = PCA(2, device=dev).fit_transform(x).cpu()
    want = PCA(2, device="cpu").fit_transform(x)
    check_close("PCA(2) of (300, 40)", got, want, 1e-4)
    xt = torch.from_numpy(x)
    got = tsne._binary_search_perplexity(tsne.input_sq_dists(xt.to(dev)),
                                         30.0).cpu()
    want = tsne._binary_search_perplexity(tsne.input_sq_dists(xt), 30.0)
    check_close("t-SNE P of (300, 40), perplexity 30", got, want, 1e-5)


def phase_medium_pipeline(dev, lyrics_rows: int) -> dict:
    """run_medium_pipeline end to end at full width into a temporary
    workspace (scripts 10-17 with visualizations), then script 14 with
    t-SNE on its latents.  Its schedule is cut to 1 epoch, so it reads an
    empty goldens file (``no_goldens``) and must report "no-golden"."""
    import csv
    import dataclasses
    import tempfile
    import numpy as np
    from vae_hmc_tpu_torch.core.config import (ConvMMVaeConfig, MelConfig,
                                               SweepConfig, TextEmbedConfig,
                                               Workspace)
    from vae_hmc_tpu_torch.pipelines import medium
    from vae_hmc_tpu_torch.pipelines.sources import SyntheticSource

    log(f"medium tier end to end: run_medium_pipeline({MAIN_TRACKS} tracks, "
        f"{MAIN_EPOCHS} epoch) at full model width, with visualizations")
    source = SyntheticSource.make(MAIN_TRACKS, seed=42)      # run_core's corpus
    vae_cfg = dataclasses.replace(ConvMMVaeConfig(), epochs=MAIN_EPOCHS)
    with tempfile.TemporaryDirectory() as root, no_goldens():
        ws = Workspace(root)
        out, launches, wall, peak = _run_tier(
            dev, "run_medium_pipeline", lambda: medium.run_medium_pipeline(
                source, ws, MelConfig(), TextEmbedConfig(), vae_cfg,
                SweepConfig(), with_viz=True, device_batch=DEVICE_BATCH,
                write_mel_features=True, device=dev))
        timing = json.loads((ws.results / "timing_medium.json").read_text())

        log("script 14 with t-SNE on the latents (1,500 iterations)")
        genre_map = {int(t): str(g) for t, g in zip(source.track_ids,
                                                    source.genres)}
        viz_tsne, tsne_launches, tsne_s, _ = _run_tier(
            dev, "script 14 with t-SNE", lambda: medium.visualize_clustering(
                ws, ws.data / "vae_mm_latents_mu.npy",
                ws.data / "vae_mm_latents_track_ids.npy", genre_map,
                method="kmeans", n_clusters=6, proj="tsne", tag="vae_kmeans6",
                x_arr=out["train"]["latents"], ids_arr=out["train"]["ids"],
                yhat_arr=out["viz14"]["labels"], device=dev))

        kind = out["figures"]
        _check_files(root, PIPELINE_FILES + [
            "results/cluster_viz/vae_kmeans6_vae_mm_latents_mu_kmeans_tsne_"
            "clusters.png"], kind, "run_medium_pipeline")
        headers, lines = {}, {}
        for name in ("medium_clustering_metrics_all.csv",
                     "medium_full_sweep_metrics.csv",
                     "medium_full_sweep_best_by_representation.csv",
                     "medium_full_sweep_best_overall.csv",
                     "report_medium/best_filtered.csv",
                     "report_medium/best_filtered_by_representation.csv"):
            with open(ws.results / name, newline="") as f:
                rows = list(csv.reader(f))
            headers[name], lines[name] = rows[0], len(rows) - 1
        mel = np.load(ws.data / "audio_cnn_mel_X.npy", mmap_mode="r")
        mel_shape = tuple(mel.shape)
        del mel

    sec = timing["seconds"]
    log("  stage seconds (timing_medium.json; each stage ends in a "
        "synchronize): " + ", ".join(f"{k} {v:.3f}" for k, v in sec.items()))
    log(f"  total {timing['total_seconds']:.3f} s of stages, "
        f"{wall:.3f} s wall; script 14 with t-SNE {tsne_s:.3f} s")
    log(f"  figures written as {kind} (matplotlib "
        f"{'present' if kind == 'png' else 'not installed'})")
    log(f"  rows: script 13 {len(out['suite'])}, script 16 "
        f"{len(out['sweep'])}; quality drift {out['quality_drift']['status']}"
        f" ({out['quality_drift']['key']}); train loss "
        f"{out['train']['history'][-1]['total']:.5f}")

    if mel_shape != (MAIN_TRACKS, 1, 128, 646):
        fail(f"audio_cnn_mel_X.npy shape {mel_shape}")
    if len(out["suite"]) != 21 or len(out["sweep"]) != 102 or \
            lines["medium_clustering_metrics_all.csv"] != 21 or \
            lines["medium_full_sweep_metrics.csv"] != 102:
        fail(f"{len(out['suite'])} suite rows and {len(out['sweep'])} sweep "
             f"rows ({lines}), want 21 and 102")
    for name, header in headers.items():
        want = HDR13 if name == "medium_clustering_metrics_all.csv" else HDR16
        if header != want:
            fail(f"{name} header {header} != {want}")
    emb = out["viz15"]["embeddings"]
    for kind_, xys in emb.items():
        for xy, n, rep in zip(xys, (MAIN_TRACKS, MAIN_TRACKS, lyrics_rows),
                              ("latents", "mel-flat", "lyrics")):
            _finite_2d(f"script 15 {kind_.upper()} of the {rep}", xy, n)
    _finite_2d("script 14 PCA", out["viz14"]["xy"], MAIN_TRACKS)
    _finite_2d("script 14 t-SNE", viz_tsne["xy"], MAIN_TRACKS)
    if out["quality_drift"]["status"] != "no-golden":
        fail(f"quality drift with an empty goldens file: "
             f"{out['quality_drift']}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} was not launched by run_medium_pipeline")
    if tsne_launches["pairwise_dists"] <= 0:
        fail("t-SNE did not take its distances from kernel 2")
    return {"seconds": sec, "launches": launches, "peak_bytes": peak,
            "figures": kind, "tsne_seconds": tsne_s,
            "history": [h["total"] for h in out["train"]["history"]]}


# the easy tier's file contract (the JAX package's
# tests/test_easy_pipeline.py list, script 08's figure, the timing file); a
# figure is its .png or, without matplotlib, its data as .npz of the stem
EASY_FILES = [
    "results/vae_basic/latent_mu.npy", "results/vae_basic/track_ids.npy",
    "results/vae_basic/history.json", "results/vae_basic/train_config.json",
    "results/vae_basic/scaler.joblib",
    "results/vae_basic/mfcc_features_cache.npy",
    "results/vae_basic/vae_basic.pt",
    "results/kmeans_vae/labels_vae_kmeans.npy",
    "results/kmeans_vae/kmeans_vae_centers.npy",
    "results/kmeans_vae/track_ids.npy",
    "results/kmeans_vae/kmeans_vae_summary.json",
    "results/compare_metrics/metrics.csv",
    "results/compare_metrics/metrics_report.json",
    "results/compare_metrics/labels_pca_mfcc.npy",
    "results/compare_metrics/labels_pca_latents.npy",
    "results/viz_vae/plots/vae_umap.png", "results/timing_easy.json",
]


def _check_files(root, files, kind: str, what: str) -> None:
    for rel in files:
        path = Path(root) / rel
        if path.suffix == ".png" and kind == "npz":
            path = path.with_suffix(".npz")
        if not path.exists():
            fail(f"{what} did not write {rel}")


def _run_tier(dev, what: str, fn):
    """fn() with the launch counters and the peak memory reset just before
    and read just after (a synchronize ends it); -> (its result, launches,
    seconds, peak bytes)."""
    import torch
    from vae_hmc_tpu_torch.ops.kernels import build
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = build.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  {what}: {wall:.3f} s wall, kernels {json.dumps(launches)}, peak "
        f"device memory {peak / 2**30:.3f} GiB")
    return out, launches, wall, peak


def _log_stages(timing: dict, name: str) -> None:
    log(f"  stage seconds ({name}; each stage ends in a synchronize): "
        + ", ".join(f"{k} {v:.3f}" for k, v in timing["seconds"].items())
        + f"; total {timing['total_seconds']:.3f}")


def phase_easy_pipeline(dev) -> dict:
    """run_easy_pipeline at 2,924 tracks (scripts 06 -> 07 -> 08 with UMAP
    -> 09) with MFCC_EASY, the full DenseVaeConfig and KMeansConfig: the
    full defaults, under VAE_HMC_QUALITY_STRICT=1, so it must read "ok"
    where the port's goldens certify easy:gpu:2924."""
    import pickle
    import tempfile
    import numpy as np
    from vae_hmc_tpu_torch.core.config import (DENSE_VAE_EASY, MFCC_EASY,
                                               KMeansConfig, Workspace)
    from vae_hmc_tpu_torch.pipelines import easy
    from vae_hmc_tpu_torch.pipelines.sources import SyntheticSource

    log(f"easy tier end to end: run_easy_pipeline({MAIN_TRACKS} tracks, 30 s "
        f"clips, DenseVAE 80-256-256-16, {DENSE_VAE_EASY.epochs} epochs at "
        f"batch {DENSE_VAE_EASY.batch_size}), with UMAP")
    source = SyntheticSource.make(MAIN_TRACKS, seed=42)
    with tempfile.TemporaryDirectory() as root, \
            env_set(VAE_HMC_QUALITY_STRICT="1"):
        ws = Workspace(root)
        out, launches, wall, peak = _run_tier(
            dev, "run_easy_pipeline", lambda: easy.run_easy_pipeline(
                source, ws, MFCC_EASY, DENSE_VAE_EASY, KMeansConfig(),
                with_viz=True, device_batch=MFCC_BATCH, device=dev))
        kind = out["figures"]
        _check_files(root, EASY_FILES, kind, "run_easy_pipeline")
        with open(ws.results / "vae_basic/scaler.joblib", "rb") as f:
            scaler = pickle.load(f)
        mu = np.load(ws.results / "vae_basic/latent_mu.npy")
        lines = (ws.results / "compare_metrics/metrics.csv").read_text() \
            .strip().split("\n")
        timing = json.loads((ws.results / "timing_easy.json").read_text())
    _log_stages(timing, "timing_easy.json")
    hist = out["train"]["history"]
    log(f"  loss epoch 1 {hist[0]['total']:.5f} -> epoch {len(hist)} "
        f"{hist[-1]['total']:.5f}; quality drift "
        f"{out['quality_drift']['status']} ({out['quality_drift']['key']})")
    for r in out["compare"]["rows"]:
        log(f"    09 {r['method']:15s} {r['input']:22s} silhouette "
            f"{r['silhouette']:.5f} CH {r['calinski_harabasz']:.3f} "
            f"PCA variance {r['pca_variance']}")
    if scaler.mean_.shape != (80,) or mu.shape != (MAIN_TRACKS, 16) or \
            not np.isfinite(mu).all():
        fail(f"scaler mean {scaler.mean_.shape}, latent_mu {mu.shape} or "
             "not finite")
    if len(lines) != 4 or not lines[0].startswith(
            "method,input,input_dim,k,silhouette"):
        fail(f"metrics.csv: {lines}")
    for r in out["compare"]["rows"]:
        if not -1.0 <= r["silhouette"] <= 1.0:
            fail(f"script 09 row {r}: silhouette out of range")
    if out["quality_drift"]["status"] != want_drift(f"easy:gpu:{MAIN_TRACKS}"):
        fail(f"quality drift: {out['quality_drift']}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} was not launched by run_easy_pipeline")
    return {"seconds": timing["seconds"], "launches": launches,
            "peak_bytes": peak, "wall": wall}


# the hard tier's file contract: tests/test_hard_pipeline.py's list (tag
# "beta_test"), plus the timing file
HARD_FILES = [
    "data/hard/audio_mfcc_stats.npy", "data/hard/lyrics_emb.npy",
    "data/hard/track_ids.npy", "data/hard/genres.npy",
    "data/hard/genre_idx.npy", "data/hard/languages.npy",
    "data/hard/lang_idx.npy", "data/hard/hard_metadata.csv",
    "data/hard/build_info.json", "data/hard/latents_mu.npy",
    "data/hard/latents_mu_beta_test.npy",
    "models/hard/beta_vae_multimodal.pt",
    "results/hard/hard_metrics_vae_latents.json",
    "results/hard/hard_metrics_vae_latents_beta_test.json",
    "results/hard/cluster_composition_by_genre.csv",
    "results/hard/cluster_labels_kmeans.npy",
    "results/hard/cluster_distribution_genre_counts.csv",
    "results/hard/cluster_distribution_language_counts.csv",
    "results/hard/baseline_comparison.csv",
    "results/hard/plots/training_curve.png",
    "results/hard/plots/recon_examples.png",
    "results/hard/plots/latent_2d.npy",
    "results/hard/plots/latent_by_cluster.png",
    "results/hard/plots/latent_by_genre.png",
    "results/hard/plots/latent_by_language.png",
    "results/hard/plots/cluster_dist_over_genres.png",
    "results/hard/plots/cluster_dist_over_languages.png",
    "results/hard/plots/baseline_bars.png", "results/timing_hard.json",
]


def _check_hard_rows(rows, what: str) -> None:
    if len(rows) != 4:
        fail(f"{what}: {len(rows)} baseline rows, want 4")
    for r in rows:
        sil = r["silhouette"]
        if not (0.0 <= r["nmi"] <= 1.0 and -1.0 <= r["ari"] <= 1.0
                and 0.0 <= r["purity"] <= 1.0 and sil is not None
                and math.isfinite(sil) and -1.0 <= sil <= 1.0):
            fail(f"{what}: row {r} out of range")
        log(f"    22 {r['method']:40s} silhouette {sil:.5f} nmi "
            f"{r['nmi']:.5f} ari {r['ari']:.5f} purity {r['purity']:.5f}")


def phase_hard_pipeline(dev) -> dict:
    """run_hard_pipeline at 2,924 tracks (scripts 18 -> 19 -> 20 -> 21 ->
    22, tag "beta_test") with MFCC_HARD, TEXT_HARD (TF-IDF: no MiniLM
    checkpoint), the Beta-VAE HardVaeConfig() and AeConfig(); then scripts
    19 -> 20 -> 22 with HARD_CVAE on the same data but the port's
    synthetic-MiniLM embeddings of the texts as lyrics_emb.npy: the
    reference's fused width, 80 + 384 = 464.  The tier runs its full
    defaults under VAE_HMC_QUALITY_STRICT=1, so it must read "ok" where
    the port's goldens certify hard:gpu:2924."""
    import shutil
    import tempfile
    import numpy as np
    from vae_hmc_tpu_torch.core.config import (HARD_CVAE, MFCC_HARD, TEXT_HARD,
                                               AeConfig, HardVaeConfig,
                                               Workspace)
    from vae_hmc_tpu_torch.pipelines import hard
    from vae_hmc_tpu_torch.pipelines.sources import SyntheticSource
    from vae_hmc_tpu_torch.text import minilm

    vae_cfg = HardVaeConfig()
    log(f"hard tier end to end: run_hard_pipeline({MAIN_TRACKS} tracks, 20 s "
        f"clips, Beta-VAE beta {vae_cfg.beta}, {vae_cfg.epochs} epochs at "
        f"batch {vae_cfg.batch_size}, AE {AeConfig().epochs} epochs), with "
        "UMAP")
    source = SyntheticSource.make(MAIN_TRACKS, seed=42)
    with tempfile.TemporaryDirectory() as root:
        ws = Workspace(Path(root) / "beta")
        with env_set(VAE_HMC_QUALITY_STRICT="1"):
            out, launches, wall, peak = _run_tier(
                dev, "run_hard_pipeline", lambda: hard.run_hard_pipeline(
                    source, ws, MFCC_HARD, TEXT_HARD, vae_cfg, AeConfig(),
                    tag="beta_test", with_viz=True, device_batch=MFCC_BATCH,
                    device=dev))
        kind = out["figures"]
        _check_files(ws.root, HARD_FILES, kind, "run_hard_pipeline")
        info = json.loads((ws.data_hard / "build_info.json").read_text())
        metrics = json.loads((ws.results_hard /
                              "hard_metrics_vae_latents.json").read_text())
        timing = json.loads((ws.results / "timing_hard.json").read_text())
        _log_stages(timing, "timing_hard.json")
        log(f"  build_info: audio {info['audio_feature_shape']}, text "
            f"{info['text_feature_shape']} ({info['text_embedding_backend']})"
            f", languages {info['unique_languages']}")
        log(f"  script 20: {json.dumps(metrics)}; quality drift "
            f"{out['quality_drift']['status']} ({out['quality_drift']['key']})")
        if info["audio_feature_shape"] != [MAIN_TRACKS, 80]:
            fail(f"audio_mfcc_stats shape {info['audio_feature_shape']}")
        if not (0.0 <= metrics["nmi"] <= 1.0 and 0.0 <= metrics["purity"]
                <= 1.0 and -1.0 <= metrics["ari"] <= 1.0):
            fail(f"script 20 metrics out of range: {metrics}")
        _check_hard_rows(out["baselines"], "run_hard_pipeline")
        if out["quality_drift"]["status"] != want_drift(
                f"hard:gpu:{MAIN_TRACKS}"):
            fail(f"quality drift: {out['quality_drift']}")
        for name, count in launches.items():
            if count <= 0:
                fail(f"kernel {name} was not launched by run_hard_pipeline")

        log("hard tier scripts 19 -> 20 -> 22 with HARD_CVAE on synthetic-"
            "MiniLM lyrics embeddings (fused width 464)")
        ws2 = Workspace(Path(root) / "cvae")
        shutil.copytree(ws.data_hard, ws2.data_hard)
        texts = [source.lyrics_text(i) or "" for i in range(len(source))]
        ids = np.load(ws2.data_hard / "track_ids.npy")
        if not np.array_equal(ids, source.track_ids):
            fail("script 18 dropped rows; the MiniLM texts would not align")
        model, tok = minilm.synthetic_minilm(texts, device=dev)
        np.save(ws2.data_hard / "lyrics_emb.npy",
                minilm.encode_texts(model, tok, texts, batch_size=128))
        del model

        def cvae_chain():
            t = hard.train_hard(ws2, HARD_CVAE, tag="cvae", device=dev)
            c = hard.cluster_and_evaluate(ws2, seed=HARD_CVAE.seed,
                                          tag="cvae", device=dev)
            b = hard.compare_with_baselines(ws2, seed=HARD_CVAE.seed,
                                            tag="cvae", device=dev)
            return t, c, b

        (t2, c2, b2), cvae_launches, cvae_wall, cvae_peak = _run_tier(
            dev, "scripts 19/20/22 (CVAE)", cvae_chain)
        ckpt = Path(ws2.root) / "models/hard/cvae_multimodal.pt"
        meta = json.loads(ckpt.with_suffix(".pt.meta.json").read_text())
        for rel in ("models/hard/cvae_multimodal.pt",
                    "models/hard/cvae_multimodal_cvae.pt",
                    "data/hard/latents_mu_cvae.npy",
                    "results/hard/baseline_comparison_cvae.csv"):
            if not (Path(ws2.root) / rel).exists():
                fail(f"the CVAE chain did not write {rel}")
        mu = t2["latents"].cpu().numpy()
    log(f"  CVAE: input_dim {meta['input_dim']}, cond_dim {meta['cond_dim']},"
        f" loss epoch 1 {t2['history'][0]['total']:.3f} -> "
        f"{t2['history'][-1]['total']:.3f}; script 20: "
        f"{json.dumps(c2['metrics'])}")
    _check_hard_rows(b2, "the CVAE chain")
    if meta["input_dim"] != 464 or meta["cond_dim"] != 6 or \
            mu.shape != (MAIN_TRACKS, 16) or not np.isfinite(mu).all():
        fail(f"CVAE: meta {meta}, latents {mu.shape}")
    if cvae_launches["pairwise_dists"] <= 0:
        fail("kernel 2 was not launched by the CVAE chain")
    return {"seconds": timing["seconds"], "launches": launches,
            "peak_bytes": peak, "wall": wall,
            "cvae_launches": cvae_launches, "cvae_seconds": cvae_wall,
            "cvae_peak_bytes": cvae_peak}


def write_corpus(root: Path, rows: list) -> int:
    """Phase 8's WAV files (PCM16 or IEEE float32 RIFF/WAVE; waveforms from
    the genre recipes of ``pipelines.synthetic.waveform``), lyrics files and
    ``data/manifest.csv`` under `root`; -> bytes written."""
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from vae_hmc_tpu_torch.core.manifest import normalize_path, write_manifest
    from vae_hmc_tpu_torch.pipelines import synthetic

    def wav_bytes(y, sr, float32):
        data = (y.astype("<f4") if float32 else
                (np.clip(y, -1, 1) * 32767).astype("<i2")).tobytes()
        ch = 1 if y.ndim == 1 else y.shape[1]
        bits = 32 if float32 else 16
        fmt = ((3 if float32 else 1).to_bytes(2, "little")
               + ch.to_bytes(2, "little") + sr.to_bytes(4, "little")
               + (sr * ch * bits // 8).to_bytes(4, "little")
               + (ch * bits // 8).to_bytes(2, "little")
               + bits.to_bytes(2, "little"))
        body = (b"WAVE" + b"fmt " + (16).to_bytes(4, "little") + fmt
                + b"data" + len(data).to_bytes(4, "little") + data)
        return b"RIFF" + len(body).to_bytes(4, "little") + body

    def write(r) -> int:
        path = root / normalize_path(r["audio_path"])
        kind, tid, genre = r["kind"], r["track_id"], r["genre"]
        if kind == "missing":
            return 0
        if kind == "corrupt":
            blob = b"not a RIFF file " * 64
        elif kind == "stereo44k":
            y = synthetic.waveform(tid, genre, r["seconds"], CORPUS_SEED,
                                   44100)
            blob = wav_bytes(np.stack([y, 0.7 * np.roll(y, 441)], axis=1),
                             44100, False)
        else:
            y = synthetic.waveform(tid, genre, r["seconds"], CORPUS_SEED)
            blob = wav_bytes(y, 22050, kind == "float32")
        path.write_bytes(blob)
        return len(blob)

    for d in ("audio", "text", "data"):
        (root / d).mkdir(parents=True)
    for r in rows:
        if r["text"] is not None:
            (root / normalize_path(r["text_path"])).write_text(r["text"])
    with ThreadPoolExecutor(8) as pool:
        total = sum(pool.map(write, rows))
    write_manifest(root / "data" / "manifest.csv", [{
        "track_id": r["track_id"], "title": f"track {r['track_id']}",
        "artist": f"artist {r['track_id'] % 31}", "genre": r["genre"],
        "audio_path": r["audio_path"], "lyrics_path": r["text_path"],
        "lyrics_source": "genius" if r["text"] else "",
        "text_path_combined": r["text_path"],
        "text_source_combined": "genius" if r["text"] else "",
        "text_exists": str(r["text"] is not None)} for r in rows])
    return total


def _own_root(corpus: Path, root: Path) -> Path:
    """A workspace of its own over the corpus: audio/ and text/ linked, the
    manifest copied (so no run reuses another's feature cache)."""
    (root / "data").mkdir(parents=True)
    for d in ("audio", "text"):
        (root / d).symlink_to(corpus / d)
    (root / "data" / "manifest.csv").write_bytes(
        (corpus / "data" / "manifest.csv").read_bytes())
    return root


def phase_file_corpus(dev, lyrics_rows: int, file_shapes: list) -> dict:
    """Phase 8, the real-data entry point: write the WAV corpus; run
    ``run-easy``, ``run-hard`` and ``run-medium`` through
    ``vae_hmc_tpu_torch.cli.main`` on its manifest with the reference's
    defaults (40, 50 and 25 epochs), then ``python -m vae_hmc_tpu_torch.cli
    run-hard`` in a subprocess and ``prepare-hard --synthetic-audio`` on the
    same manifest, each of those two in a root of its own; check the report
    rows, row counts, metrics and launches; and hold the easy tier's MFCC
    stats of the PCM16 rows to the same quantized waveforms fed straight to
    ``ops.mfcc.mfcc_stats_batch`` in batches of the same composition."""
    import csv
    import tempfile
    import numpy as np
    import torch
    from vae_hmc_tpu_torch import cli
    from vae_hmc_tpu_torch.core.config import MFCC_EASY
    from vae_hmc_tpu_torch.io import native
    from vae_hmc_tpu_torch.ops.mfcc import mfcc_stats_batch
    from vae_hmc_tpu_torch.pipelines import features, sources, synthetic

    rows = corpus_plan()
    n_rows = len(rows)
    bad = {r["track_id"] for r in rows if r["kind"] in ("corrupt", "missing")}
    too_short = {r["track_id"] for r in rows
                 if r["kind"] != "missing" and 0 < r["seconds"] < 1.0}
    ok = n_rows - len(bad)
    batches = -(-n_rows // FILE_BATCH)
    lib = native.get_lib()
    log(f"phase 8: native audio library loaded from {Path(lib._name).name}")

    # decode seconds (the prefetch thread's host_waveforms calls) and the
    # build reports of every feature loop, read around the CLI calls
    decode, reports = [], []
    real_host = sources.FileSource.host_waveforms
    real_mfcc, real_mel = features.build_mfcc_stats, features.build_logmel

    def timed_host(self, idx, duration_s):
        t0 = time.perf_counter()
        out = real_host(self, idx, duration_s)
        decode.append(time.perf_counter() - t0)
        return out

    def reporting(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            reports.append(out[2].rows)
            return out
        return wrapped

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        corpus = Path(tmp) / "corpus"
        t0 = time.perf_counter()
        nbytes = write_corpus(corpus, rows)
        log(f"  corpus: {n_rows} manifest rows, {nbytes / 1e9:.3f} GB of WAV "
            f"written in {time.perf_counter() - t0:.2f} s; {ok} decode, "
            f"{lyrics_rows} with lyrics")
        argv = ["--manifest", "data/manifest.csv", "--root", str(corpus)]
        sources.FileSource.host_waveforms = timed_host
        features.build_mfcc_stats = reporting(real_mfcc)
        features.build_logmel = reporting(real_mel)
        try:
            for tier in ("easy", "hard", "medium"):
                decode.clear()
                reports.clear()
                rc, launches, wall, peak = _run_tier(
                    dev, f"cli run-{tier}", lambda: cli.main(
                        [f"run-{tier}", *argv]))
                timing = json.loads((corpus / "results" /
                                     f"timing_{tier}.json").read_text())
                _log_stages(timing, f"timing_{tier}.json")
                log(f"  run-{tier}: decode {sum(decode):.3f} s on the "
                    f"prefetch thread over {len(decode)} batches")
                if rc != 0:
                    fail(f"cli run-{tier} returned {rc}")
                if len(reports) != 1:
                    fail(f"run-{tier}: {len(reports)} feature loops")
                _check_report(reports[0], bad, too_short if tier == "hard"
                              else set(), f"run-{tier}")
                if launches["mel_db_standardize"] != batches or \
                        launches["pairwise_dists"] <= 0:
                    fail(f"run-{tier}: launches {launches}, want "
                         f"{batches} of kernel 1 and some of kernel 2")
                out[tier] = {"seconds": timing["seconds"], "launches":
                             launches, "peak_bytes": peak, "wall": wall,
                             "decode_seconds": sum(decode)}
        finally:
            sources.FileSource.host_waveforms = real_host
            features.build_mfcc_stats = real_mfcc
            features.build_logmel = real_mel

        _check_file_outputs(corpus, ok, lyrics_rows, file_shapes)

        # the easy tier's MFCC stats of the PCM16 rows against the same
        # quantized waveforms in batches of the same composition (the other
        # rows zeros: kernel 1 and the STFT treat each row alone)
        blob = np.load(corpus / "results/vae_basic/mfcc_features_cache.npy",
                       allow_pickle=True).item()
        pos = {int(t): i for i, t in enumerate(blob["track_ids"])}
        worst, n_cmp = 0.0, 0
        for start in range(0, n_rows, FILE_BATCH):
            chunk = rows[start:start + FILE_BATCH]
            y = np.zeros((len(chunk), MFCC_EASY.n_samples), np.float32)
            pcm = [i for i, r in enumerate(chunk) if r["kind"] == "pcm16"]
            for i in pcm:
                w = synthetic.waveform(chunk[i]["track_id"], chunk[i]["genre"],
                                       30.0, CORPUS_SEED)
                y[i] = (np.clip(w, -1, 1) * 32767).astype(np.int16) / \
                    np.float32(32768.0)
            want = mfcc_stats_batch(torch.from_numpy(y).to(dev),
                                    MFCC_EASY).cpu().numpy()
            for i in pcm:
                got = blob["X"][pos[chunk[i]["track_id"]]]
                err = np.abs(got - want[i])
                if not np.all(err <= 1e-3 + 1e-5 * np.abs(want[i])):
                    fail(f"track {chunk[i]['track_id']}: file-path MFCC stats "
                         f"differ from the in-memory path by {err.max():.3e}")
                worst = max(worst, float(err.max()))
                n_cmp += 1
        log(f"  MFCC stats of the {n_cmp} PCM16 rows, FileSource path vs "
            f"in-memory: max abs diff {worst:.3e} (atol 1e-3, rtol 1e-5)")
        if n_cmp != sum(r["kind"] == "pcm16" for r in rows):
            fail(f"compared {n_cmp} PCM16 rows")
        out["pcm16_max_abs_diff"] = worst

        # one run-hard in a subprocess, as a user types it
        sub_root = _own_root(corpus, Path(tmp) / "sub")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "vae_hmc_tpu_torch.cli", "run-hard",
             "--manifest", "data/manifest.csv", "--root", str(sub_root)],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        sub_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"python -m vae_hmc_tpu_torch.cli run-hard exited "
                 f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        metrics = json.loads(proc.stdout.strip().splitlines()[-1])
        ids = np.load(sub_root / "data/hard/track_ids.npy")
        log(f"  subprocess run-hard: {sub_s:.2f} s, {len(ids)} tracks, "
            f"script 20 {json.dumps(metrics)}")
        if len(ids) != ok - len(too_short) or not all(
                math.isfinite(float(v)) for v in metrics.values()
                if isinstance(v, (int, float))):
            fail(f"subprocess run-hard: {len(ids)} tracks, metrics {metrics}")
        out["subprocess_seconds"] = sub_s

        # prepare-hard --synthetic-audio: the manifest's rows, synthesized
        syn_root = _own_root(corpus, Path(tmp) / "synthetic_audio")
        rc, launches, wall, _ = _run_tier(
            dev, "cli prepare-hard --synthetic-audio", lambda: cli.main([
                "prepare-hard", "--synthetic-audio", "--manifest",
                "data/manifest.csv", "--root", str(syn_root)]))
        ids = np.load(syn_root / "data/hard/track_ids.npy")
        want_ids = [r["track_id"] for r in rows]
        if rc != 0 or list(ids) != want_ids:
            fail(f"prepare-hard --synthetic-audio: rc {rc}, {len(ids)} ids "
                 "(want every manifest row in order)")
        if launches["mel_db_standardize"] != batches:
            fail(f"prepare-hard --synthetic-audio: launches {launches}")
        with open(syn_root / "data/hard/hard_metadata.csv", newline="") as f:
            genres = [r["genre"] for r in csv.DictReader(f)]
        if genres != [r["genre"] for r in rows]:
            fail("prepare-hard --synthetic-audio: genres differ from the "
                 "manifest's")
        out["synthetic_audio"] = {"launches": launches, "wall": wall}
    return out


def _check_report(report_rows, bad: set, too_short: set, what: str) -> None:
    """The build report lists exactly the rows that failed to decode as
    errors (and, in the hard tier, the too-short clip as skipped)."""
    errors = {r[0] for r in report_rows if r[2] == "error"}
    skipped = {r[0] for r in report_rows if r[2] == "skipped"}
    log(f"  {what}: report {len(report_rows)} rows, {len(errors)} errors, "
        f"{len(skipped)} skipped; e.g. "
        + "; ".join(sorted({r[3].split(':')[0] for r in report_rows
                            if r[2] == 'error'})))
    if errors != bad or skipped != too_short:
        fail(f"{what}: error rows {sorted(errors)} (want {sorted(bad)}), "
             f"skipped {sorted(skipped)} (want {sorted(too_short)})")


def _check_file_outputs(corpus: Path, ok: int, lyrics_rows: int,
                        file_shapes: list) -> None:
    """Row counts, finite metrics, and representations of shapes phase 2
    checked kernel 2 at."""
    import csv
    import numpy as np
    d, res = corpus / "data", corpus / "results"
    reps = {
        "easy latents": np.load(res / "vae_basic/latent_mu.npy"),
        "hard latents": np.load(d / "hard/latents_mu.npy"),
        "hard MFCC stats": np.load(d / "hard/audio_mfcc_stats.npy"),
        "medium latents": np.load(d / "vae_mm_latents_mu.npy"),
        "medium lyrics": np.load(d / "lyrics_embeddings.npy"),
        "medium mel-flat": np.load(d / "audio_cnn_mel_X.npy", mmap_mode="r"),
    }
    want = {"easy latents": (ok, 16), "hard latents": (ok - 1, 16),
            "hard MFCC stats": (ok - 1, 80), "medium latents": (ok, 32),
            "medium lyrics": (lyrics_rows, 384),
            "medium mel-flat": (ok, MEL_FLAT)}
    for name, x in reps.items():
        shape = (x.shape[0], int(np.prod(x.shape[1:])))
        if shape != want[name] or shape not in file_shapes:
            fail(f"phase 8 {name}: shape {shape}, want {want[name]}, one "
                 "phase 2 checked")
        if name != "medium mel-flat" and not np.isfinite(x).all():
            fail(f"phase 8 {name}: not finite")
    log("  representations: " + ", ".join(
        f"{k} {tuple(v.shape)}" for k, v in reps.items()))
    del reps
    metrics = json.loads((res / "hard/hard_metrics_vae_latents.json")
                         .read_text())
    with open(res / "compare_metrics/metrics.csv", newline="") as f:
        easy_rows = list(csv.DictReader(f))
    with open(res / "medium_clustering_metrics_all.csv", newline="") as f:
        suite = list(csv.DictReader(f))
    with open(res / "hard/baseline_comparison.csv", newline="") as f:
        base = list(csv.DictReader(f))
    values = [metrics[k] for k in ("silhouette", "nmi", "ari", "purity")]
    values += [float(r[k]) for r in easy_rows
               for k in ("silhouette", "calinski_harabasz")]
    values += [float(r[k]) for r in suite if r["algo"] != "dbscan"
               for k in ("silhouette", "davies_bouldin", "ari")]
    values += [float(r[k]) for r in base
               for k in ("silhouette", "nmi", "ari", "purity")]
    if len(easy_rows) != 3 or len(suite) != 21 or len(base) != 4 or \
            not all(math.isfinite(v) for v in values):
        fail(f"phase 8 metrics: {len(easy_rows)} easy rows, {len(suite)} "
             f"suite rows, {len(base)} baselines, or a non-finite value")
    log(f"  metrics: hard {json.dumps(metrics)}; easy VAE silhouette "
        f"{float(easy_rows[0]['silhouette']):.5f}; medium kmeans6 on the "
        f"latents silhouette {float(suite[0]['silhouette']):.5f}")


FAST_EPOCHS = 2                  # phase 9's run-medium --fast


def _fit_timed(model, arrays, epochs: int, **kw):
    """models.train.fit with a synchronize at each end; -> (FitResult,
    seconds)."""
    import torch
    from vae_hmc_tpu_torch.models.train import fit
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit(model, arrays, epochs=epochs, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _assert_same_fit(what: str, a, b, ra, rb) -> None:
    """Fail unless two models' parameters and two histories are equal bit
    for bit."""
    import torch
    if ra.history != rb.history:
        fail(f"{what}: histories differ: {ra.history} vs {rb.history}")
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        if not torch.equal(x, y):
            fail(f"{what}: parameter {name} differs (max abs "
                 f"{float((x - y).abs().max()):.3e})")
    log(f"  {what}: parameters and history bit-identical")


def phase_fast_mode(dev, medium: dict) -> dict:
    """Phase 9 (a): ``run-medium --fast`` through ``cli.main`` at full
    width, 2,924 synthetic tracks and 2 epochs (92 Adam steps in bf16),
    with the launch counters reset just before and read just after; the
    file contract, float32 weights in the checkpoint, a falling loss;
    `medium` is phase 5's result, the float32 run of the same tier.  Its
    schedule is cut to 2 epochs, so it reads an empty goldens file
    (``no_goldens``)."""
    import csv
    import tempfile
    import numpy as np
    from vae_hmc_tpu_torch import cli

    steps = FAST_EPOCHS * -(-MAIN_TRACKS // 64)
    log(f"phase 9 (a): run-medium --synthetic {MAIN_TRACKS} --fast --epochs "
        f"{FAST_EPOCHS} through cli.main ({steps} bf16 Adam steps at full "
        "width)")
    with tempfile.TemporaryDirectory() as root, no_goldens():
        rc, launches, wall, peak = _run_tier(
            dev, "run-medium --fast", lambda: cli.main([
                "run-medium", "--synthetic", str(MAIN_TRACKS), "--fast",
                "--epochs", str(FAST_EPOCHS), "--root", root]))
        if rc != 0:
            fail(f"run-medium --fast exited {rc}")
        ws = Path(root)
        timing = json.loads((ws / "results/timing_medium.json").read_text())
        lines = {}
        for name in ("medium_clustering_metrics_all.csv",
                     "medium_full_sweep_metrics.csv"):
            with open(ws / "results" / name, newline="") as f:
                lines[name] = len(list(csv.reader(f))) - 1
        with open(ws / "results/vae_conv_mm_medium/train_log.csv",
                  newline="") as f:
            history = [float(r["loss"]) for r in csv.DictReader(f)]
        mu = np.load(ws / "data/vae_mm_latents_mu.npy")
        ckpt = ws / f"results/vae_conv_mm_medium/ckpt_epoch_{FAST_EPOCHS:03d}.pt"
        meta = json.loads(Path(str(ckpt) + ".meta.json").read_text())
        with np.load(ckpt) as z:
            dtypes = {z[k].dtype.name for k in z.files}
            n_arrays = len(z.files)
    _log_stages(timing, "timing_medium.json, --fast")
    train_s = timing["seconds"]["train_conv_mm"]
    medium_train_s = medium["seconds"]["train_conv_mm"]
    log(f"  train_conv_mm {train_s:.3f} s for {steps} bf16 steps and the "
        f"export: {1e3 * train_s / steps:.2f} ms a step; phase 5's float32 "
        f"stage {medium_train_s:.3f} s for {steps // FAST_EPOCHS} steps: "
        f"{1e3 * medium_train_s * FAST_EPOCHS / steps:.2f} ms a step")
    f32 = [round(h, 6) for h in medium["history"]]
    log(f"  loss per epoch: bf16 {history}, phase 5's float32 {f32}; "
        f"checkpoint {n_arrays} arrays of {sorted(dtypes)}, compute_dtype "
        f"{meta['config']['compute_dtype']!r}")
    if lines != {"medium_clustering_metrics_all.csv": 21,
                 "medium_full_sweep_metrics.csv": 102}:
        fail(f"run-medium --fast rows {lines}, want 21 and 102")
    if mu.shape != (MAIN_TRACKS, 32) or not np.isfinite(mu).all():
        fail(f"run-medium --fast latents {mu.shape}, or non-finite")
    if dtypes != {"float32"} or meta["config"]["compute_dtype"] != "bfloat16":
        fail(f"run-medium --fast checkpoint dtypes {dtypes}, compute_dtype "
             f"{meta['config']['compute_dtype']!r}")
    if len(history) != FAST_EPOCHS or not history[1] < history[0]:
        fail(f"run-medium --fast loss per epoch {history}: not falling")
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} was not launched by run-medium --fast")
    return {"seconds": timing["seconds"], "launches": launches,
            "peak_bytes": peak, "history": history,
            "ms_per_step": 1e3 * train_s / steps}


def phase_resume_on_card(dev) -> dict:
    """Phase 9 (b): a full-width ConvMMVAE on 2,924 synthetic standardized
    rows, 2 epochs straight against 1 epoch with a checkpoint and a
    resumed fit to 2, under deterministic cuDNN (the flag restored after);
    the easy tier's DenseVaeConfig() on (2924, 80) rows, 4 epochs against
    2 + 2.  Both must repeat bit for bit.  Also times one epoch of the
    conv fit in float32 with and without deterministic cuDNN and in
    bf16."""
    import tempfile
    import torch
    from vae_hmc_tpu_torch.core.config import ConvMMVaeConfig, DenseVaeConfig
    from vae_hmc_tpu_torch.models.api import build_conv_mm_vae
    from vae_hmc_tpu_torch.models.dense_vae import DenseVAE

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    x = torch.randn((MAIN_TRACKS, 128, 646, 1), generator=gen, device=dev)
    x = (x - x.mean(dim=(1, 2, 3), keepdim=True)) / x.std(
        dim=(1, 2, 3), keepdim=True)
    lyr = torch.randn((MAIN_TRACKS, 384), generator=gen, device=dev)
    mask = (torch.rand((MAIN_TRACKS, 1), generator=gen, device=dev)
            < 0.9).float()
    cfg = ConvMMVaeConfig()
    kw = dict(batch_size=cfg.batch_size, learning_rate=cfg.learning_rate,
              beta=cfg.beta, reduction=cfg.loss_reduction, seed=cfg.seed)
    steps = -(-MAIN_TRACKS // cfg.batch_size)

    def conv():
        return build_conv_mm_vae(cfg, 128, 646, 384).to(dev)

    log(f"phase 9 (b): resume on the card, full-width ConvMMVAE on "
        f"({MAIN_TRACKS}, 128, 646, 1) rows, {steps} steps an epoch")
    _, nondet_s = _fit_timed(conv(), (x, lyr, mask), 1, **kw)
    _, bf16_s = _fit_timed(conv(), (x, lyr, mask), 1, compute_dtype="bfloat16",
                           **kw)
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        straight = conv()
        rs, det_s = _fit_timed(straight, (x, lyr, mask), 2, **kw)
        with tempfile.TemporaryDirectory() as tmp:
            ck = dict(checkpoint_dir=tmp, checkpoint_every=1)
            _, saved_s = _fit_timed(conv(), (x, lyr, mask), 1, **ck, **kw)
            size = (Path(tmp) / "train_state.ckpt").stat().st_size
            resumed = conv()
            rr, resume_s = _fit_timed(resumed, (x, lyr, mask), 2, **ck, **kw)
    finally:
        torch.backends.cudnn.deterministic = flag
    log(f"  float32 fit: {1e3 * nondet_s / steps:.2f} ms a step (1 epoch, "
        f"cuDNN's default algorithms), {1e3 * det_s / (2 * steps):.2f} ms a "
        f"step (2 epochs, deterministic cuDNN); bf16 fit: "
        f"{1e3 * bf16_s / steps:.2f} ms a step (1 epoch)")
    save_s = saved_s - det_s / 2          # 1 epoch + 1 write
    log(f"  train_state.ckpt {size / 2**20:.1f} MiB: 1 epoch and a write "
        f"{saved_s:.3f} s (the write ~{save_s:.3f} s); the resumed fit "
        f"(read, 1 epoch, write) {resume_s:.3f} s (the read ~"
        f"{resume_s - saved_s:.3f} s)")
    log(f"  conv loss per epoch: {[h['total'] for h in rs.history]}")
    _assert_same_fit("conv 2 straight vs 1 + 1 resumed", straight, resumed,
                     rs, rr)
    del x, lyr, mask, straight, resumed
    torch.cuda.empty_cache()

    dcfg = DenseVaeConfig()
    xd = torch.randn((MAIN_TRACKS, 80), generator=gen, device=dev)
    dkw = dict(batch_size=dcfg.batch_size, learning_rate=dcfg.learning_rate,
               beta=dcfg.beta, reduction=dcfg.loss_reduction, seed=dcfg.seed)

    def dense():
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(dcfg.seed)
            return DenseVAE(80, tuple(dcfg.hidden_dims),
                            dcfg.latent_dim).to(dev)

    log("  dense: DenseVaeConfig() on (2924, 80) rows, 4 epochs against "
        "2 + 2 resumed")
    straight = dense()
    rs, _ = _fit_timed(straight, (xd,), 4, **dkw)
    with tempfile.TemporaryDirectory() as tmp:
        ck = dict(checkpoint_dir=tmp, checkpoint_every=2)
        _fit_timed(dense(), (xd,), 2, **ck, **dkw)
        resumed = dense()
        rr, _ = _fit_timed(resumed, (xd,), 4, **ck, **dkw)
    _assert_same_fit("dense 4 straight vs 2 + 2 resumed", straight, resumed,
                     rs, rr)
    return {"f32_ms_per_step": 1e3 * nondet_s / steps,
            "f32_deterministic_ms_per_step": 1e3 * det_s / (2 * steps),
            "bf16_ms_per_step": 1e3 * bf16_s / steps,
            "checkpoint_mib": size / 2**20}


def phase_stft_fft(dev) -> list:
    """Phase 9 (c): the STFT's FFT method (``torch.fft.rfft``, cuFFT)
    against its DFT method (two fp32 GEMMs) on the card at the easy tier's
    MFCC batch (64 x 30 s) and the medium batch (128 x 15 s): max |diff|
    within 1e-5 of the peak power; both timed by CUDA graph replays."""
    from vae_hmc_tpu_torch.core.config import MFCC_EASY, MelConfig
    from vae_hmc_tpu_torch.ops.stft import power_spectrogram
    from vae_hmc_tpu_torch.pipelines.sources import SyntheticSource

    log("phase 9 (c): power_spectrogram(method='fft') against 'dft'")
    rows = []
    for what, cfg, b in (("easy", MFCC_EASY, MFCC_BATCH),
                         ("medium", MelConfig(), DEVICE_BATCH)):
        y, _, _ = SyntheticSource.make(b, seed=5).waveforms(
            list(range(b)), cfg.duration_s, dev)

        def spec(method):
            return power_spectrogram(y, n_fft=cfg.n_fft,
                                     hop_length=cfg.hop_length, method=method)
        dft, fft = spec("dft"), spec("fft")
        peak = float(dft.max())
        err = float((fft - dft).abs().max())
        log(f"  {what} {tuple(dft.shape)}: max |fft - dft| {err:.3e}, "
            f"{err / peak:.3e} of the peak power {peak:.4e}")
        if not err <= 1e-5 * peak:
            fail(f"STFT fft vs dft at {tuple(dft.shape)}: {err / peak:.3e} "
                 "of the peak, want <= 1e-5")
        shape = list(dft.shape)
        del dft, fft
        dft_ms = time_ms(lambda: spec("dft"), reps=5, warmup=2)
        fft_ms = time_ms(lambda: spec("fft"), reps=5, warmup=2)
        log(f"  {what} {tuple(shape)}: dft {dft_ms:.4f} ms, fft {fft_ms:.4f} "
            f"ms a spectrogram")
        rows.append({"tier": what, "shape": shape, "rel_err": err / peak,
                     "dft_ms": dft_ms, "fft_ms": fft_ms})
        del y
    return rows


PARALLEL_TIMEOUT_S = 120        # phase 10: process-group timeout
PARALLEL_JOIN_S = 600           # phase 10: join timeout of one spawn
P10_RESTARTS = 12               # phase 10: KMeans n_init 10 padded on 4 ranks
# phase 10 (a): the weights moved 1 ulp up (the first element of each), one
# fit each, members of the roundoff ensemble
P10_NUDGED = ("dec_fc1.weight", "enc_convs.0.weight", "mu.bias")
P10_SPREAD_FACTOR = 3.0         # phase 10: conv limit, x the ensemble's spread


def _p10_inputs(dev):
    """Phase 10's inputs, made alike on every rank from one seed on the
    card: the synthetic corpus, lyrics embeddings and mask, the easy
    tier's (2924, 80) rows and the hard tier's HARD_CVAE rows (464 wide)
    with their 6-wide one-hot condition."""
    import torch
    from vae_hmc_tpu_torch.pipelines.sources import SyntheticSource
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    lyr = torch.randn((MAIN_TRACKS, 384), generator=gen, device=dev)
    mask = (torch.rand((MAIN_TRACKS, 1), generator=gen, device=dev)
            < 0.9).float()
    xd = torch.randn((MAIN_TRACKS, 80), generator=gen, device=dev)
    xh = torch.randn((MAIN_TRACKS, 464), generator=gen, device=dev)
    cond = torch.nn.functional.one_hot(torch.randint(
        0, 6, (MAIN_TRACKS,), generator=gen, device=dev), 6).float()
    return SyntheticSource.make(MAIN_TRACKS, seed=11), lyr, mask, xd, xh, cond


def _p10_mesh(shape):
    """This rank's mesh, deterministic cuDNN, and the first optimizer step
    taken (it imports torch._dynamo, seconds that no timing should see)."""
    import datetime
    import torch
    from vae_hmc_tpu_torch.parallel.mesh import make_mesh
    torch.backends.cudnn.deterministic = True
    mesh = make_mesh(shape=shape, device="cuda",
                     timeout=datetime.timedelta(seconds=PARALLEL_TIMEOUT_S))
    w = torch.nn.Parameter(torch.zeros(1, device=mesh.device))
    w.grad = torch.zeros_like(w)
    torch.optim.Adam([w]).step()
    return mesh


def _p10_timed(dev, fn):
    """fn() between synchronizes, with this rank's launch, byte and peak
    counters reset before -> (result, seconds, launches, bytes, peak)."""
    import torch
    from vae_hmc_tpu_torch.ops.kernels import build
    from vae_hmc_tpu_torch.parallel import collectives
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launch_counts()
    collectives.reset_byte_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, build.launch_counts(),
            collectives.byte_counts(), torch.cuda.max_memory_allocated(dev))


def _p10_dense_hard(mesh, xd, xh, cond) -> dict:
    """The easy tier's DenseVaeConfig() and the hard tier's HARD_CVAE, 4
    epochs each, on the mesh -> their histories."""
    from vae_hmc_tpu_torch.core.config import HARD_CVAE, DenseVaeConfig
    from vae_hmc_tpu_torch.models import api
    from dataclasses import replace
    _, dense, _ = api.train_dense_vae(xd, replace(DenseVaeConfig(), epochs=4),
                                      mesh=mesh)
    _, hard, _ = api.train_hard_vae(xh, replace(HARD_CVAE, epochs=4),
                                    cond=cond, mesh=mesh)
    return {"dense": dense, "hard": hard}


def _p10_split_fit(model, arrays, cfg, n_parts: int) -> list:
    """The step of a (n_parts, 1) mesh in one process, the witness of (b):
    each batch's rows split by the mesh's row ranges, each part's forward
    and backward run on its own (the per-call batch sizes of (b)'s ranks),
    the gradients summed by accumulation, one Adam step; the noise,
    permutation and loss are ``fit``'s.  -> the history of one epoch."""
    import torch
    from vae_hmc_tpu_torch.models.losses import elbo_loss_rows
    from vae_hmc_tpu_torch.models.train import (_NOISE_STREAM, _PERM_STREAM,
                                                _epoch_generator, _own_rows)
    from vae_hmc_tpu_torch.parallel.mesh import Mesh
    from vae_hmc_tpu_torch.parallel.multihost import process_row_range
    dev = arrays[0].device
    n, bsz = int(arrays[0].shape[0]), cfg.batch_size
    perm = torch.randperm(n, generator=_epoch_generator(cfg.seed, 0,
                                                        _PERM_STREAM))
    noise = _epoch_generator(cfg.seed, 0, _NOISE_STREAM, dev)
    parts = [process_row_range(n, mesh=Mesh(
        shape={"data": n_parts, "model": 1}, rank=r)) for r in range(n_parts)]
    rows = [_own_rows(perm, lo, hi, bsz, dev) for lo, hi in parts]
    totals = [torch.zeros(3, device=dev) for _ in parts]
    opt = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate)
    model.train()
    for i in range(-(-n // bsz)):
        b = min(bsz, n - i * bsz)
        eps = torch.randn((b, model.latent_dim), generator=noise, device=dev)
        opt.zero_grad(set_to_none=True)
        for (lo, hi), part, tot in zip(parts, rows, totals):
            local, pos = part(i)
            if not len(local):
                continue
            batch = [a[lo:hi][local] for a in arrays]
            xhat, mu, logvar = model(*batch, eps=eps.index_select(0, pos))
            loss, aux = elbo_loss_rows(xhat, batch[0], mu, logvar, cfg.beta,
                                       cfg.loss_reduction, b)
            loss.backward()
            tot += torch.stack([aux["total"], aux["recon"],
                                aux["kl"]]).detach() * b
        opt.step()
    avg = (sum(totals) / n).cpu().tolist()
    return [{"epoch": 1, "total": avg[0], "recon": avg[1], "kl": avg[2]}]


def _p10_nudged_fit(model, name: str, arrays, **kw) -> list:
    """(a)'s fit with the first element of parameter ``name`` moved 1 ulp
    up before it starts -> its history, a member of the roundoff
    ensemble."""
    import torch
    from vae_hmc_tpu_torch.models.train import fit
    with torch.no_grad():
        w = dict(model.named_parameters())[name].view(-1)
        w[0] = torch.nextafter(w[0], torch.full_like(w[0], math.inf))
    return fit(model, arrays, **kw).history


def p10_world_one(rank: int) -> dict:
    """Phase 10 (a), one rank under NCCL, mesh (1, 1): the medium corpus's
    standardized log-mel by synth_features_sharded (kernel 1) against
    build_logmel; dp_fit of the full-width ConvMMVAE, 1 epoch, against the
    single-process fit of the same weights and streams; the roundoff
    ensemble's other fits (nondeterministic cuDNN, the split witness, the
    P10_NUDGED fits); the same through train_conv_mm_vae(mesh=) (history
    and latents, the reference of (b) and (c)); KMeans restarts on its
    latents; the dense and hard fits."""
    import torch
    from vae_hmc_tpu_torch.core.config import ConvMMVaeConfig, MelConfig
    from vae_hmc_tpu_torch.models import api
    from vae_hmc_tpu_torch.models.train import encode_in_batches, fit
    from vae_hmc_tpu_torch.parallel.features_dp import synth_features_sharded
    from vae_hmc_tpu_torch.parallel.mesh import conv_mm_param_sharding
    from vae_hmc_tpu_torch.parallel.train_dp import (dp_fit,
                                                     kmeans_restarts_sharded)
    from vae_hmc_tpu_torch.pipelines.features import build_logmel
    mesh = _p10_mesh((1, 1))
    dev = mesh.device
    source, lyr, mask, xd, xh, cond = _p10_inputs(dev)
    mel = MelConfig()
    x, feat_s, feat_k, _, _ = _p10_timed(dev, lambda: synth_features_sharded(
        source, mel, mesh, device_batch=DEVICE_BATCH))
    ref, _, _ = build_logmel(source, mel, device_batch=DEVICE_BATCH,
                             device=dev)
    feat_err = float((x - ref).abs().max())
    del ref
    x = x[..., None]
    cfg = ConvMMVaeConfig(epochs=MAIN_EPOCHS)
    kw = dict(epochs=cfg.epochs, batch_size=cfg.batch_size,
              learning_rate=cfg.learning_rate, beta=cfg.beta,
              reduction=cfg.loss_reduction, seed=cfg.seed)
    model = api.build_conv_mm_vae(cfg, 128, 646, 384).to(dev)
    dp, dp_s, dp_k, dp_b, dp_peak = _p10_timed(dev, lambda: dp_fit(
        model, (x, lyr, mask), mesh, conv_mm_param_sharding(mesh, model),
        **kw))
    single, fit_s, _, _, _ = _p10_timed(dev, lambda: fit(
        api.build_conv_mm_vae(cfg, 128, 646, 384).to(dev), (x, lyr, mask),
        **kw))
    torch.backends.cudnn.deterministic = False    # the history's roundoff
    spread = fit(api.build_conv_mm_vae(cfg, 128, 646, 384).to(dev),
                 (x, lyr, mask), **kw)
    torch.backends.cudnn.deterministic = True
    split = _p10_split_fit(api.build_conv_mm_vae(cfg, 128, 646, 384).to(dev),
                           (x, lyr, mask), cfg, 2)
    nudged = {name: _p10_nudged_fit(api.build_conv_mm_vae(
        cfg, 128, 646, 384).to(dev), name, (x, lyr, mask), **kw)
        for name in P10_NUDGED}
    (_, history, mu), api_s, api_k, api_b, api_peak = _p10_timed(
        dev, lambda: api.train_conv_mm_vae(x, lyr, mask, cfg, mesh=mesh))
    model.eval()
    with torch.no_grad():
        mu_dp = encode_in_batches(lambda a, b, c: model.encode(a, b, c)[0],
                                  (x, lyr, mask), batch_size=256)
    labels, _, inertia = kmeans_restarts_sharded(mu, 6, P10_RESTARTS, mesh)
    return {"backend": mesh.backend, "feature_err": feat_err,
            "feature_shape": list(x.shape), "feature_s": feat_s,
            "feature_launches": feat_k, "dp_history": dp.history,
            "fit_history": single.history, "fit_s": fit_s,
            "spread_history": spread.history, "split_history": split,
            "nudged_histories": nudged,
            "dp_s": dp_s, "dp_bytes": dp_b,
            "dp_peak": dp_peak, "dp_launches": dp_k,
            "history": history, "api_s": api_s, "api_bytes": api_b,
            "api_peak": api_peak, "api_launches": api_k,
            "latents": mu.cpu().numpy(), "latents_dp_err": float(
                (mu - mu_dp).abs().max()),
            "labels": labels, "inertia": inertia,
            **_p10_dense_hard(mesh, xd, xh, cond)}


def _p10_digest(model) -> list:
    """Each parameter's float64 sum and absolute sum: equal on two ranks
    whose replicas are equal bit for bit, apart (almost surely) otherwise."""
    import torch
    with torch.no_grad():
        return [[float(p.double().sum()), float(p.double().abs().sum())]
                for p in model.parameters()]


def _p10_fault_fit(staged, lyr, mask, cfg, mesh) -> list:
    """A planted fault: the same data-parallel fit with the gradient
    all-reduce skipped (each rank steps on its own rows' gradients; the
    history's sums still reach every rank).  -> (its history, its
    replica's digest), which the checks of (b) must refuse."""
    from vae_hmc_tpu_torch.models import api
    from vae_hmc_tpu_torch.parallel import collectives
    real = collectives.all_reduce_grads
    collectives.all_reduce_grads = lambda params, group=None: None
    try:
        model, history, _ = api.train_conv_mm_vae(staged, lyr, mask, cfg,
                                                  mesh=mesh)
    finally:
        collectives.all_reduce_grads = real
    return history, _p10_digest(model)


def p10_ranks(rank: int, shape, latents_a) -> dict:
    """Phase 10 (b) and (c), one rank of a gloo group on the card: stage
    this rank's rows of the medium corpus (stage_features_sharded, kernel
    1), train_conv_mm_vae(mesh=) at full width for 1 epoch, the shard
    shapes of a (D, 2) mesh, KMeans restarts on (a)'s latents (and on this
    run's, for the sweep cell), the dense and hard fits, and on rank 0 one
    sweep cell's silhouette from kernel 2's distances."""
    import torch
    from vae_hmc_tpu_torch.core.config import ConvMMVaeConfig, MelConfig
    from vae_hmc_tpu_torch.metrics import internal
    from vae_hmc_tpu_torch.models import api
    from vae_hmc_tpu_torch.parallel.features_dp import synth_rows
    from vae_hmc_tpu_torch.parallel.mesh import (conv_mm_param_sharding,
                                                 gather_params, shard_params)
    from vae_hmc_tpu_torch.parallel.multihost import stage_features_sharded
    from vae_hmc_tpu_torch.parallel.train_dp import kmeans_restarts_sharded
    mesh = _p10_mesh(tuple(shape))
    dev = mesh.device
    source, lyr, mask, xd, xh, cond = _p10_inputs(dev)
    rows = synth_rows(source, MelConfig(), DEVICE_BATCH, "logmel", dev)
    staged, feat_s, feat_k, _, _ = _p10_timed(dev, lambda: (
        stage_features_sharded(lambda s, e: rows(s, e)[..., None],
                               MAIN_TRACKS, mesh, batch=MAIN_TRACKS)))
    cfg = ConvMMVaeConfig(epochs=MAIN_EPOCHS)
    shards = {}
    if mesh.shape["model"] > 1:
        model = api.build_conv_mm_vae(cfg, 128, 646, 384).to(dev)
        whole = {k: v.clone() for k, v in model.state_dict().items()}
        shard_params(model, conv_mm_param_sharding(mesh, model), mesh)
        shards = {k: list(v.shape) for k, v in model.state_dict().items()
                  if k.startswith(("enc_fc.", "dec_fc2."))}
        gather_params(model, mesh)
        for k, v in model.state_dict().items():
            if not torch.equal(v, whole[k]):
                raise RuntimeError(f"{k} changed through shard and gather")
        del model, whole
    (model, history, mu), api_s, api_k, api_b, api_peak = _p10_timed(
        dev, lambda: api.train_conv_mm_vae(staged, lyr, mask, cfg, mesh=mesh))
    digest = _p10_digest(model)
    del model
    span = [staged.start, staged.stop]
    fault = None
    if mesh.shape == {"data": 2, "model": 1}:
        fault = _p10_fault_fit(staged, lyr, mask, cfg, mesh)
    del staged
    # n_init 10 pads to P10_RESTARTS on 4 ranks; 2 ranks ask for those
    n_init = 10 if mesh.size == 4 else P10_RESTARTS
    labels_a, _, inertia_a = kmeans_restarts_sharded(latents_a, 6, n_init,
                                                     mesh)
    labels, _, _ = kmeans_restarts_sharded(mu, 6, 10, mesh)
    sweep_k, sil = {}, None
    if mesh.rank == 0:
        from vae_hmc_tpu_torch.ops.kernels import build
        build.reset_launch_counts()
        sil = internal.silhouette_from_dists_masked(
            internal.centered_euclidean_dists(mu), labels)
        sweep_k = build.launch_counts()
    return {"backend": mesh.backend, "mesh": dict(mesh.shape),
            "rows": span, "digest": digest, "fault": fault,
            "feature_s": feat_s, "feature_launches": feat_k,
            "shards": shards, "history": history, "api_s": api_s,
            "api_bytes": api_b, "api_peak": api_peak, "api_launches": api_k,
            "latents": mu.cpu().numpy(), "labels_a": labels_a,
            "inertia_a": inertia_a, "silhouette": sil,
            "sweep_launches": sweep_k,
            **_p10_dense_hard(mesh, xd, xh, cond)}


def _hist_gaps(got, want, rtol: float, atol: float, limits=None):
    """Two histories column by column -> (the largest absolute gap of each
    column, the first gap past atol + rtol |want| + the column's entry of
    ``limits`` or None)."""
    if [h["epoch"] for h in got] != [h["epoch"] for h in want]:
        return None, f"epochs {got} vs {want}"
    limits = limits or {}
    gaps, bad = {k: 0.0 for k in ("total", "recon", "kl")}, None
    for g, w in zip(got, want):
        for k in gaps:
            gap = abs(g[k] - w[k])
            gaps[k] = max(gaps[k], gap)
            lim = limits.get(k, 0.0)
            if bad is None and not gap <= atol + rtol * abs(w[k]) + lim:
                bad = (f"{k} {g[k]!r} vs {w[k]!r} (rtol {rtol}, atol "
                       f"{atol}, limit {lim!r})")
    return gaps, bad


def _hist_close(what: str, got, want, rtol: float, atol: float,
                limits=None) -> dict:
    """Fail unless two histories agree (``_hist_gaps``); -> the largest
    absolute gap of each column."""
    gaps, bad = _hist_gaps(got, want, rtol, atol, limits)
    if bad is not None:
        fail(f"{what}: {bad}")
    log(f"  {what}: histories agree, largest abs gaps {json.dumps(gaps)} "
        f"(rtol {rtol}, atol {atol}, limits {json.dumps(limits or {})})")
    return gaps


def _roundoff_limits(members: dict, factor: float) -> dict:
    """Histories of fits of the same model, data and streams that differ
    only in roundoff (the ensemble) -> each column's limit: ``factor`` x
    the largest gap between two members in any epoch."""
    hists = list(members.values())
    return {k: factor * max((abs(g[k] - w[k])
                             for i, one in enumerate(hists)
                             for other in hists[i + 1:]
                             for g, w in zip(one, other)), default=0.0)
            for k in ("total", "recon", "kl")}


def phase_parallel() -> dict:
    """Phase 10: the parallel path on spawned ranks of the one card, (a)
    NCCL at world size 1, (b) gloo with CUDA tensors on 2 ranks, mesh
    (2, 1), (c) gloo on 4 ranks, mesh (2, 2); each rank's results and
    kernel launch counts come back to this process."""
    import numpy as np
    sys.path.insert(0, str(ROOT))
    from tests.torch_dist_workers import run_ranks
    steps = -(-MAIN_TRACKS // 64)
    out = {}

    def spawn(what, world, backend, fn, *args):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            res = run_ranks(fn, world, tmp, *args, backend=backend,
                            device="cuda", timeout_s=PARALLEL_TIMEOUT_S,
                            join_s=PARALLEL_JOIN_S)
            log(f"  {what}: {world} rank(s) ({backend}) in "
                f"{time.perf_counter() - t0:.1f} s wall")
        return res

    log("phase 10 (a): NCCL, world size 1, mesh (1, 1)")
    (a,) = spawn("(a)", 1, "nccl", p10_world_one)
    if a["backend"] != "nccl":
        fail(f"phase 10 (a) ran on {a['backend']}, not NCCL")
    log(f"  synth_features_sharded {a['feature_shape']} in "
        f"{a['feature_s']:.3f} s, kernels {json.dumps(a['feature_launches'])}"
        f"; max |sharded - build_logmel| {a['feature_err']:.3e}")
    if not a["feature_err"] <= 1e-4:
        fail(f"phase 10 (a): sharded features off build_logmel by "
             f"{a['feature_err']:.3e} (> 1e-4)")
    _hist_close("(a) dp_fit vs fit", a["dp_history"], a["fit_history"],
                1e-6, 0.0)
    gaps = {k: max(abs(g[k] - w[k]) for g, w in zip(
        a["spread_history"], a["fit_history"])) for k in ("total", "recon",
                                                          "kl")}
    log(f"  (a) roundoff spread of the history: fit with cuDNN's default "
        f"(nondeterministic) algorithms against deterministic cuDNN, "
        f"largest abs gaps {json.dumps(gaps)}; fit {a['fit_history']}")
    out["spread"] = gaps
    gaps = {k: abs(a["split_history"][0][k] - a["history"][0][k])
            for k in ("total", "recon", "kl")}
    log(f"  (a) the split witness (each batch's rows in the two calls of "
        f"(b)'s ranks, one process) against (a): abs gaps "
        f"{json.dumps(gaps)}; witness {a['split_history']}")
    _hist_close("(a) train_conv_mm_vae(mesh) vs dp_fit", a["history"],
                a["dp_history"], 1e-6, 0.0)
    for name, hist in a["nudged_histories"].items():
        gaps = {k: abs(hist[0][k] - a["history"][0][k])
                for k in ("total", "recon", "kl")}
        log(f"  (a) {name} 1 ulp up against (a): abs gaps "
            f"{json.dumps(gaps)}")
    # The conv histories of (b) and (c) leave (a)'s by the fit's roundoff,
    # which one epoch amplifies: a 1-ulp nudge of one initial weight moves
    # the history as far as another split of the batch does.  The ensemble
    # of such fits measures it in this run; a parallel fit adds roundoff of
    # its own each step (the DP split, (c)'s TP sums), so its limit is
    # P10_SPREAD_FACTOR x the ensemble's largest pairwise gap.
    ensemble = {"(a)": a["history"], "nondeterministic cuDNN":
                a["spread_history"], "the split witness": a["split_history"],
                **{f"{name} 1 ulp up": hist
                   for name, hist in a["nudged_histories"].items()}}
    limits = _roundoff_limits(ensemble, P10_SPREAD_FACTOR)
    log(f"  (a) conv history limits, {P10_SPREAD_FACTOR} x the largest "
        f"pairwise gap of {len(ensemble)} fits that differ in roundoff "
        f"only: {json.dumps(limits)}")
    out["limits"] = limits
    log(f"  (a) dp_fit {1e3 * a['dp_s'] / steps:.2f} ms a step ({steps} "
        f"steps, deterministic cuDNN; the single-process fit "
        f"{1e3 * a['fit_s'] / steps:.2f}), all-reduce "
        f"{a['dp_bytes']['all_reduce'] / steps / 1e6:.1f} MB a step, peak "
        f"{a['dp_peak'] / 2**30:.3f} GiB; train_conv_mm_vae (fit and "
        f"export) {1e3 * a['api_s'] / steps:.2f} ms a step; latents "
        f"{a['latents'].shape}, |api - dp_fit| {a['latents_dp_err']:.3e}")
    out["a"] = a

    for part, world, shape in (("b", 2, (2, 1)), ("c", 4, (2, 2))):
        log(f"phase 10 ({part}): gloo with CUDA tensors, {world} ranks on "
            f"the one card, mesh {shape}")
        ranks = spawn(f"({part})", world, "gloo", p10_ranks, shape,
                      a["latents"])
        for rank, r in enumerate(ranks):
            k1 = r["feature_launches"]["mel_db_standardize"]
            log(f"  rank {rank}: staged rows {r['rows']} in "
                f"{r['feature_s']:.3f} s, "
                f"kernel 1 {k1} launch(es); train_conv_mm_vae "
                f"{1e3 * r['api_s'] / steps:.2f} ms a step (fit and export),"
                f" all-reduce {r['api_bytes']['all_reduce'] / steps / 1e6:.1f}"
                f" MB a step, peak {r['api_peak'] / 2**30:.3f} GiB")
            if k1 <= 0:
                fail(f"phase 10 ({part}): kernel 1 not launched on rank "
                     f"{rank}")
            if r["history"] != ranks[0]["history"]:
                fail(f"phase 10 ({part}): rank {rank}'s history differs")
            if not np.array_equal(r["latents"], ranks[0]["latents"]):
                fail(f"phase 10 ({part}): rank {rank}'s latents differ")
            if r["digest"] != ranks[0]["digest"]:
                fail(f"phase 10 ({part}): rank {rank}'s trained replica "
                     "differs from rank 0's")
            if not np.array_equal(r["labels_a"], a["labels"]) or \
                    r["inertia_a"] != a["inertia"]:
                fail(f"phase 10 ({part}): KMeans restarts on rank {rank} "
                     f"differ from world size 1 (inertia {r['inertia_a']} "
                     f"vs {a['inertia']})")
        r0 = ranks[0]
        if r0["latents"].shape != (MAIN_TRACKS, 32) or \
                not np.isfinite(r0["latents"]).all():
            fail(f"phase 10 ({part}): latents {r0['latents'].shape} or "
                 "non-finite")
        # (a) runs each batch in one call, (b) and (c) in a call a rank on
        # its rows; the split witness runs (b)'s calls in one process, so
        # (b) equals it to rounding, and (b) and (c) are held to (a) and (c)
        # to the witness within the measured roundoff limits.
        r0["gaps"] = _hist_close(f"({part}) conv vs (a)", r0["history"],
                                 a["history"], 0.0, 1e-6, limits)
        witness = ((5e-5, 1e-6, None) if part == "b"
                   else (0.0, 1e-6, limits))
        r0["witness_gaps"] = _hist_close(
            f"({part}) conv vs the split witness", r0["history"],
            a["split_history"], *witness)
        log(f"  ({part}) trained replicas equal on every rank (parameter "
            f"sums)")
        if part == "b":
            fault, _ = r0["fault"]
            if all(r["fault"][1] == r0["fault"][1] for r in ranks):
                fail("phase 10 (b): the replicas of a fit without the "
                     "gradient all-reduce pass as equal")
            log("  (b) planted fault (gradient all-reduce skipped) refused: "
                "the replicas differ")
            r0["fault_gaps"] = {}
            for what, want in (("the split witness", a["split_history"]),
                               ("(a)", a["history"])):
                gaps, bad = _hist_gaps(fault, want, 0.0, 1e-6, limits)
                r0["fault_gaps"][what] = gaps
                if bad is None:
                    fail(f"phase 10 (b): the planted fault's history passes "
                         f"the roundoff limits against {what} (gaps "
                         f"{json.dumps(gaps)})")
                log(f"  (b) planted fault's history against {what}: refused "
                    f"by the roundoff limits, largest abs gaps "
                    f"{json.dumps(gaps)}")
        log(f"  ({part}) KMeans(k=6) restarts on (a)'s latents: labels and "
            f"inertia {r0['inertia_a']:.6f} as at world size 1")
        if part == "c":
            want = {"enc_fc.weight": [256, 82944], "enc_fc.bias": [256],
                    "dec_fc2.weight": [82944, 256], "dec_fc2.bias": [82944]}
            for rank, r in enumerate(ranks):
                if r["shards"] != want:
                    fail(f"phase 10 (c): rank {rank} shards {r['shards']}")
            log(f"  (c) shards on every rank: {json.dumps(want)}")
            for name in ("dense", "hard"):
                _hist_close(f"(c) {name} vs (a)", r0[name], a[name], 5e-5,
                            1e-6)
        sil = r0["silhouette"]
        if not (math.isfinite(sil) and -1.0 <= sil <= 1.0):
            fail(f"phase 10 ({part}): sweep cell silhouette {sil}")
        if r0["sweep_launches"]["pairwise_dists"] <= 0:
            fail(f"phase 10 ({part}): kernel 2 not launched in the sweep "
                 "cell")
        log(f"  ({part}) sweep cell on rank 0: KMeans(k=6) silhouette "
            f"{sil:.5f} from kernel 2's distances "
            f"({r0['sweep_launches']['pairwise_dists']} launch(es))")
        out[part] = ranks
    return out


def parallel_launches(p10: dict, name: str) -> dict:
    """A kernel's launches by rank in phase 10's paths: (a) features, dp_fit
    and train_conv_mm_vae; (b) and (c) staging, train_conv_mm_vae and the
    sweep cell on rank 0."""
    a = p10["a"]
    return {"a": [a["feature_launches"][name] + a["dp_launches"][name]
                  + a["api_launches"][name]],
            **{part: [r["feature_launches"][name] + r["api_launches"][name]
                      + r["sweep_launches"].get(name, 0) for r in p10[part]]
               for part in ("b", "c")}}


BENCH_TIMEOUT_S = 900            # phase 11: one bench subprocess
BENCH_EPOCHS = 25                # phase 11: the bench's full schedule
BENCH_MODES = (("parity", "parity (f32 train)", {}),
               ("fast", "fast (bf16 train, NON-parity)", {"BENCH_FAST": "1"}))


def phase_bench() -> dict:
    """Phase 11: ``python -m vae_hmc_tpu_torch.cli bench`` in a subprocess,
    parity and then BENCH_FAST=1, at 2,924 tracks and 25 epochs with
    VAE_HMC_QUALITY_STRICT=1; -> {mode: {"launches", "result", "wall"}}."""
    from tests.torch_bench_keys import bench_keys
    from vae_hmc_tpu_torch.ops.kernels import build
    want_keys = bench_keys()
    jax_goldens = json.loads((ROOT / "QUALITY_GOLDENS.json").read_text())
    out = {}
    for mode, mode_str, extra in BENCH_MODES:
        log(f"phase 11 ({mode}): python -m vae_hmc_tpu_torch.cli bench "
            f"--n-tracks {MAIN_TRACKS}" + (" under BENCH_FAST=1" if extra
                                           else ""))
        env = {k: v for k, v in os.environ.items()
               if k not in ("BENCH_FAST", "VAE_HMC_GOLDENS_PATH")}
        env.update(VAE_HMC_QUALITY_STRICT="1", **extra)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "vae_hmc_tpu_torch.cli", "bench",
             "--n-tracks", str(MAIN_TRACKS)], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
        wall = time.perf_counter() - t0
        for line in proc.stderr.splitlines()[-30:]:
            log(f"  | {line}")
        if proc.returncode != 0:
            fail(f"phase 11 ({mode}): bench exited {proc.returncode}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        timed = next(json.loads(line.split(": ", 1)[1])
                     for line in proc.stderr.splitlines()
                     if line.startswith("[bench] timed stages: "))
        log(f"  {wall:.1f} s wall; {res['value']} tracks/s; stage seconds: "
            + ", ".join(f"{k} {res[k]}" for k in res
                        if k.startswith("seconds_")))
        if sorted(res) != sorted(want_keys):
            fail(f"phase 11 ({mode}): keys {sorted(res)} != bench.py's "
                 f"{sorted(want_keys)}")
        if res["n_tracks"] != MAIN_TRACKS or timed["epochs"] != BENCH_EPOCHS \
                or res["mode"] != mode_str:
            fail(f"phase 11 ({mode}): {res['n_tracks']} tracks, "
                 f"{timed['epochs']} epochs, mode {res['mode']!r}")
        if not res["lyrics_backend"].startswith("minilm"):
            fail(f"phase 11 ({mode}): lyrics backend {res['lyrics_backend']!r}")
        if not res["pallas_smoke"].startswith("ok"):
            fail(f"phase 11 ({mode}): kernel smoke {res['pallas_smoke']!r}")
        numbers = [res[k] for k in ("value", "vs_baseline", "train_final_loss",
                                    "silhouette", "davies_bouldin",
                                    "ari_vs_genre")] + \
            [res[k] for k in res if k.startswith("seconds_")]
        if not all(isinstance(v, (int, float)) and math.isfinite(v)
                   for v in numbers) or not (
                res["value"] > 0 and res["seconds_total"] > 0
                and -1.0 <= res["silhouette"] <= 1.0
                and res["davies_bouldin"] > 0.0
                and -1.0 <= res["ari_vs_genre"] <= 1.0):
            fail(f"phase 11 ({mode}): a value is not finite or out of range: "
                 f"{res}")
        drift = want_drift(f"bench:gpu:{MAIN_TRACKS}:{mode}")
        if res["quality_drift"] != drift:
            fail(f"phase 11 ({mode}): quality_drift "
                 f"{res['quality_drift']!r}, want {drift!r}")
        for name in build.LAUNCHES:
            if timed["launches"].get(name, 0) <= 0:
                fail(f"phase 11 ({mode}): kernel {name} was not launched in "
                     "the timed stages")
        jax_row = jax_goldens[f"bench:tpu:{MAIN_TRACKS}:{mode}"]["headline"]
        log(f"  quality {res['quality_drift']}; gaps to the JAX package's "
            f"bench:tpu:{MAIN_TRACKS}:{mode} row (logged, not held: the "
            "random streams and MiniLM's synthetic weights differ): "
            + ", ".join(f"{c} {res[c]} - {v} = {res[c] - v:+.5f}"
                        for c, v in sorted(jax_row.items())))
        out[mode] = {"launches": timed["launches"], "result": res,
                     "wall": wall}
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, str(ROOT))
    from vae_hmc_tpu_torch.core.device import resolve_device

    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    smi = phase_identify_and_build()
    lyrics_rows = script11_rows()
    file_lyrics = sum(r["text"] is not None for r in corpus_plan())
    file_shapes = file_dist_shapes(file_lyrics)
    kernels = [{**phase_logmel(dev), **phase_logmel_mfcc(dev),
                **phase_logmel_file_rows(dev)},
               phase_distance(dev, lyrics_rows, file_shapes), phase_adam(dev)]
    phase_deconv()
    launches, tensors, source = phase_main_path(dev)
    sweep = phase_medium_sweep(dev, tensors, source, lyrics_rows)
    del tensors, source
    torch.cuda.empty_cache()
    phase_viz_on_card(dev)
    pipeline = phase_medium_pipeline(dev, lyrics_rows)
    torch.cuda.empty_cache()
    easy_tier = phase_easy_pipeline(dev)
    hard_tier = phase_hard_pipeline(dev)
    torch.cuda.empty_cache()
    files = phase_file_corpus(dev, file_lyrics, file_shapes)
    torch.cuda.empty_cache()
    fast = phase_fast_mode(dev, pipeline)
    torch.cuda.empty_cache()
    phase_resume_on_card(dev)
    torch.cuda.empty_cache()
    phase_stft_fft(dev)
    torch.cuda.empty_cache()
    p10 = phase_parallel()
    bench = phase_bench()
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["sweep_launches"] = sweep["launches"][k["name"]]
        k["pipeline_launches"] = pipeline["launches"][k["name"]]
        k["easy_launches"] = easy_tier["launches"][k["name"]]
        k["hard_launches"] = hard_tier["launches"][k["name"]]
        k["cvae_launches"] = hard_tier["cvae_launches"][k["name"]]
        k["file_launches"] = {
            **{tier: files[tier]["launches"][k["name"]]
               for tier in ("easy", "hard", "medium")},
            "synthetic_audio": files["synthetic_audio"]["launches"][
                k["name"]]}
        k["fast_launches"] = fast["launches"][k["name"]]
        k["parallel_launches"] = parallel_launches(p10, k["name"])
        k["bench_launches"] = {mode: bench[mode]["launches"][k["name"]]
                               for mode in bench}
    log(f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
