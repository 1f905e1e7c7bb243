"""The main path end to end: ``bench.py`` stages 1-4 on the port.

  1. synthetic waveforms -> log-mel features (kernel 1);
  2. lyrics embeddings: the MiniLM transformer over every text by default
     (``lyrics_backend="minilm"``, as ``bench.py``), with the real
     checkpoint where ``text.embed.find_minilm_dir`` finds one
     (VAE_HMC_MINILM_DIR or the HF cache) and synthetic real-shaped
     weights otherwise; ``lyrics_backend="hashed"`` is the
     token-hash embedding (``BENCH_LYRICS=hashed``);
  3. conv multimodal VAE training and posterior-mean export;
  4. KMeans(k=6, n_init=10), then silhouette and Davies-Bouldin (kernel 2)
     and ARI against the synthetic genres.
Building MiniLM, moving it to the device and one warm-up batch run before
the timed stages, as in ``bench.py`` (model load is set-up).  Stage
boundaries synchronize the device, so each stage's seconds are its own;
each stage also runs inside a ``stage:<name>`` profiler range (free when no
profiler is on; tools/profile_chain.py reads them).  Returns the stage
seconds, the quality numbers, the lyrics backend, the kernels' launches
during the run, the tensors the run made (``"tensors"``: features,
lyrics embedding, ``mu``, genre codes, track ids) and its corpus
(``"source"``) for later stages (``pipelines.medium.scripts_11_13_16``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from vae_hmc_tpu_torch.cluster.kmeans import kmeans
from vae_hmc_tpu_torch.core.config import ConvMMVaeConfig, KMeansConfig, MelConfig
from vae_hmc_tpu_torch.core.device import resolve_device, synchronize
from vae_hmc_tpu_torch.metrics import external, internal
from vae_hmc_tpu_torch.models.api import train_conv_mm_vae
from vae_hmc_tpu_torch.ops.kernels import build
from vae_hmc_tpu_torch.pipelines import synthetic
from vae_hmc_tpu_torch.pipelines.features import build_logmel
from vae_hmc_tpu_torch.pipelines.sources import SyntheticSource
from vae_hmc_tpu_torch.text import embed, minilm

MINILM_BATCH = 128              # texts per MiniLM forward (bench.py's)


def _lyrics_encoder(backend: str, texts, dev):
    """-> (backend name, encode(texts) -> (N, 384) tensor on `dev`)."""
    if backend == "hashed":
        return "hashed", lambda t: torch.as_tensor(
            embed.hashed_embedding(t, 384), device=dev)
    if backend != "minilm":
        raise ValueError(f"lyrics_backend {backend!r}: 'minilm' or 'hashed'")
    mdir = embed.find_minilm_dir()
    if mdir is not None:
        model, tok = minilm.load_minilm(mdir, device=dev)
        name = "minilm-torch (real checkpoint)"
    else:
        model, tok = minilm.synthetic_minilm(texts, device=dev)
        name = "minilm-torch (synthetic real-shaped weights)"

    def encode(t):
        return minilm.encode_texts(model, tok, t, batch_size=MINILM_BATCH,
                                   to_host=False)

    encode(texts[:MINILM_BATCH])          # warm-up, outside the timed stages
    return name, encode


def run_core(n_tracks: int = 2924, epochs: int = 25, device="cuda",
             duration_s: float = 15.0, seed: int = 42,
             device_batch: int = 128, lyrics_backend: str = "minilm") -> Dict:
    dev = resolve_device(device)
    mel_cfg = MelConfig(duration_s=duration_s)
    vae_cfg = dataclasses.replace(ConvMMVaeConfig(), epochs=epochs, seed=seed)
    ds = synthetic.make_dataset(n_tracks, seed=seed, lyrics_coverage=0.9)
    texts = [ds.lyrics[i] or "" for i in range(n_tracks)]
    backend, encode_lyrics = _lyrics_encoder(lyrics_backend, texts, dev)
    synchronize(dev)
    launches0 = build.launch_counts()

    t0 = time.perf_counter()
    with record_function("stage:features"):
        source = SyntheticSource(ds, seed=seed)
        x_mel, ids, report = build_logmel(source, mel_cfg,
                                          device_batch=device_batch,
                                          device=dev)
        if len(ids) != n_tracks:
            # the lyrics/genre arrays below follow the full track list: a
            # dropped row would misalign every row after it
            bad = [r for r in report.rows if r[2] != "ok"][:5]
            raise RuntimeError(f"feature build dropped {n_tracks - len(ids)} "
                               f"rows: {bad}")
        x_mel = x_mel[..., None]                      # (N, n_mels, T, 1)
        synchronize(dev)
    t1 = time.perf_counter()

    with record_function("stage:lyrics"):
        has = np.asarray([1.0 if ds.lyrics[i] else 0.0
                          for i in range(n_tracks)], np.float32)
        lyr = encode_lyrics(texts) * torch.as_tensor(has, device=dev)[:, None]
        synchronize(dev)
    t2 = time.perf_counter()

    with record_function("stage:train"):
        _model, history, mu = train_conv_mm_vae(x_mel, lyr, has, vae_cfg,
                                                device=dev)
        synchronize(dev)
    t3 = time.perf_counter()

    with record_function("stage:cluster_metrics"):
        km = kmeans(mu, KMeansConfig(n_clusters=6, n_init=10, seed=seed),
                    device=dev)
        genre_idx = np.asarray([synthetic.GENRES.index(g) for g in ds.genres])
        sil = internal.silhouette(mu, km.labels, device=dev)
        dbi = internal.davies_bouldin(mu, km.labels, device=dev)
        ari = external.adjusted_rand_index(km.labels, genre_idx)
        synchronize(dev)
    t4 = time.perf_counter()

    launches = {k: v - launches0[k] for k, v in build.launch_counts().items()}
    return {
        "n_tracks": n_tracks,
        "epochs": epochs,
        "feature_shape": list(x_mel.shape),
        "mu_shape": list(mu.shape),
        "report_ok": report.ok_count(),
        "seconds_total": t4 - t0,
        "seconds_features": t1 - t0,
        "seconds_lyrics": t2 - t1,
        "seconds_train": t3 - t2,
        "seconds_cluster_metrics": t4 - t3,
        "lyrics_backend": backend,
        "train_final_loss": history[-1]["total"],
        "history": history,
        "kmeans_inertia": km.inertia,
        "kmeans_n_iter": km.n_iter,
        "silhouette": sil,
        "davies_bouldin": dbi,
        "ari_vs_genre": ari,
        "launches": launches,
        "device": str(dev),
        "tensors": {"features": x_mel, "lyrics_embedding": lyr, "mu": mu,
                    "genre_codes": genre_idx, "track_ids": ids},
        "source": source,
    }
