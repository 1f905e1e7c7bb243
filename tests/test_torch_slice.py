"""The port's main path as a whole, and the rules the port keeps.

  - run_core end to end on the CPU at 32 tracks, 1 s clips, 1 epoch, with
    the MiniLM lyrics backend, and with the hashed one;
  - the copied host code (dataset, synthesis recipes, hashed embedding,
    MelConfig) equals the JAX package's, and the torch ``synth_core`` at
    noise_lv = 0 matches the JAX one to atol 1e-5;
  - the feature driver's row-drop and ``BuildReport`` contract;
  - the device rule (default "cuda" raises without a GPU) and the import
    rule (no ``jax``, no ``vae_hmc_tpu`` in a process that imports every
    module of the port).
"""
import dataclasses
import math
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vae_hmc_tpu_torch
from vae_hmc_tpu.core.config import MelConfig as JMelConfig
from vae_hmc_tpu.pipelines import synthetic as jsyn
from vae_hmc_tpu.text.embed import hashed_embedding as jhashed
from vae_hmc_tpu_torch.core.config import MelConfig
from vae_hmc_tpu_torch.pipelines import synthetic as tsyn
from vae_hmc_tpu_torch.pipelines.bench_chain import run_core
from vae_hmc_tpu_torch.pipelines.features import build_logmel
from vae_hmc_tpu_torch.pipelines.sources import SyntheticSource
from vae_hmc_tpu_torch.text.embed import hashed_embedding

torch.manual_seed(0)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def test_run_core_on_cpu(tmp_path, monkeypatch):
    """The default lyrics backend: MiniLM, on synthetic real-shaped weights
    when no checkpoint directory is found."""
    monkeypatch.delenv("VAE_HMC_MINILM_DIR", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "no_hf_cache"))
    r = run_core(n_tracks=32, epochs=1, device="cpu", duration_s=1.0,
                 device_batch=16)
    assert r["feature_shape"] == [32, 128, 44, 1]
    assert r["mu_shape"] == [32, 32]
    assert r["report_ok"] == 32
    assert r["lyrics_backend"] == "minilm-torch (synthetic real-shaped weights)"
    assert r["launches"] == {"mel_db_standardize": 0, "pairwise_dists": 0}
    for k in ("train_final_loss", "silhouette", "davies_bouldin",
              "ari_vs_genre", "kmeans_inertia", "seconds_total"):
        assert math.isfinite(r[k]), k
    assert -1.0 <= r["silhouette"] <= 1.0 and r["davies_bouldin"] > 0.0
    assert len(r["history"]) == 1


def test_run_core_hashed_lyrics_backend():
    r = run_core(n_tracks=16, epochs=1, device="cpu", duration_s=0.5,
                 device_batch=16, lyrics_backend="hashed")
    assert r["lyrics_backend"] == "hashed"
    lyr = r["tensors"]["lyrics_embedding"]
    ds = tsyn.make_dataset(16, seed=42, lyrics_coverage=0.9)
    want = hashed_embedding([t or "" for t in ds.lyrics])
    want *= np.asarray([[1.0 if t else 0.0] for t in ds.lyrics], np.float32)
    np.testing.assert_array_equal(lyr.numpy(), want)
    assert math.isfinite(r["silhouette"])
    with pytest.raises(ValueError, match="lyrics_backend"):
        run_core(n_tracks=16, epochs=1, device="cpu", duration_s=0.5,
                 lyrics_backend="tfidf")


def test_run_core_returns_its_corpus():
    """The source run_core returns is the corpus of its own seed, so later
    stages score against the genres the run trained on."""
    r = run_core(n_tracks=16, epochs=1, device="cpu", duration_s=0.5,
                 device_batch=16, seed=5, lyrics_backend="hashed")
    ds = tsyn.make_dataset(16, seed=5, lyrics_coverage=0.9)
    src = r["source"]
    assert src.seed == 5 and src.ds.lyrics == ds.lyrics
    np.testing.assert_array_equal(src.track_ids, r["tensors"]["track_ids"])
    np.testing.assert_array_equal(
        r["tensors"]["genre_codes"],
        [tsyn.GENRES.index(g) for g in src.genres])


def test_dataset_and_recipes_copied_exactly():
    a, b = tsyn.make_dataset(40, seed=5), jsyn.make_dataset(40, seed=5)
    np.testing.assert_array_equal(a.track_ids, b.track_ids)
    np.testing.assert_array_equal(a.genres, b.genres)
    assert a.lyrics == b.lyrics
    pa = tsyn.synth_param_arrays(a, range(40), seed=5)
    pb = jsyn.synth_param_arrays(b, range(40), seed=5)
    for k in pb:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    np.testing.assert_array_equal(tsyn.waveform_batch(a, [0, 3], 0.1, 5),
                                  jsyn.waveform_batch(b, [0, 3], 0.1, 5))
    texts = [t or "" for t in a.lyrics[:10]] + ["", "Hello, World!"]
    np.testing.assert_array_equal(hashed_embedding(texts), jhashed(texts))
    assert dataclasses.asdict(MelConfig()) == dataclasses.asdict(JMelConfig())
    assert MelConfig().top_db == 80.0


def test_synth_core_matches_jax_without_noise():
    ds = tsyn.make_dataset(12, seed=1)
    p = tsyn.synth_param_arrays(ds, range(12), seed=1)
    p["noise_lv"][:] = 0.0
    n, sr = 22050, 22050
    ref = np.asarray(jsyn.synth_core(
        *(jnp.asarray(p[k]) for k in ("amps", "freqs", "phases", "am_rate",
                                      "am_phase", "noise_lv")),
        jax.random.PRNGKey(0), n, sr))
    ours = tsyn.synth_core(
        *(torch.from_numpy(p[k]) for k in ("amps", "freqs", "phases",
                                           "am_rate", "am_phase", "noise_lv")),
        torch.Generator().manual_seed(0), n, sr).numpy()
    assert ours.shape == (12, n)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_source_batches_are_reproducible():
    src = SyntheticSource.make(20, seed=3)
    a, lengths, errors = src.waveforms([4, 5, 6], 0.2, torch.device("cpu"))
    b, _, _ = src.waveforms([4, 5, 6], 0.2, torch.device("cpu"))
    assert a.shape == (3, 4410) and errors == [None] * 3
    np.testing.assert_array_equal(lengths, [4410] * 3)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(a.abs().max()) == pytest.approx(0.3, rel=1e-5)


class _FaultySource:
    """4 tracks: row 1 fails to decode, row 2 decodes to NaN."""
    track_ids = np.arange(10, 14)

    def __len__(self):
        return 4

    def waveforms(self, idx, duration_s, device):
        n = int(22050 * duration_s)
        rng = np.random.default_rng(0)
        y = torch.from_numpy(rng.normal(0, 0.1, (len(idx), n))
                             .astype(np.float32))
        errors = [None] * len(idx)
        for r, i in enumerate(idx):
            if i == 1:
                errors[r] = "DecodeError: bad header"
            if i == 2:
                y[r, 100] = float("nan")
        return y.to(device), np.full(len(idx), n), errors


def test_build_logmel_drops_bad_rows_and_reports_them():
    x, ids, report = build_logmel(_FaultySource(),
                                  MelConfig(duration_s=0.3, n_mels=16),
                                  device_batch=3, device="cpu")
    assert x.shape == (2, 16, 13)
    assert bool(torch.isfinite(x).all())
    np.testing.assert_array_equal(ids, [10, 13])
    assert report.rows == [
        (10, "synthetic://10", "ok", ""),
        (11, "synthetic://11", "error", "DecodeError: bad header"),
        (12, "synthetic://12", "error", "non_finite_features"),
        (13, "synthetic://13", "ok", "")]
    assert report.ok_count() == 2


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from vae_hmc_tpu_torch.cluster.kmeans import kmeans
    from vae_hmc_tpu_torch.core.device import resolve_device
    from vae_hmc_tpu_torch.metrics.internal import silhouette
    from vae_hmc_tpu_torch.models.api import train_conv_mm_vae
    from vae_hmc_tpu_torch.core.config import Workspace
    from vae_hmc_tpu_torch.ops.pca import PCA
    from vae_hmc_tpu_torch.pipelines.medium import run_medium_pipeline
    from vae_hmc_tpu_torch.viz.projections import reduce_2d
    from vae_hmc_tpu_torch.viz.tsne import tsne
    from vae_hmc_tpu_torch.viz.umap import umap_2d
    x = np.zeros((4, 2), np.float32)
    calls = [lambda: resolve_device(),
             lambda: run_core(n_tracks=4, epochs=1),
             lambda: build_logmel(SyntheticSource.make(2), MelConfig()),
             lambda: kmeans(x),
             lambda: silhouette(x, [0, 0, 1, 1]),
             lambda: train_conv_mm_vae(x, x, x[:, 0], None),
             lambda: PCA(1).fit(x),
             lambda: tsne(x),
             lambda: umap_2d(x),
             lambda: reduce_2d(x, "pca"),
             lambda: run_medium_pipeline(SyntheticSource.make(2),
                                         Workspace("unused"))]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_port_imports_no_jax():
    """Import every module of the port in a fresh interpreter; neither jax
    nor the JAX package (exact name or the 'vae_hmc_tpu.' prefix, which
    'vae_hmc_tpu_torch' does not match) may be loaded."""
    modules = [m.name for m in pkgutil.walk_packages(
        vae_hmc_tpu_torch.__path__, "vae_hmc_tpu_torch.")]
    assert "vae_hmc_tpu_torch.ops.kernels.logmel" in modules
    assert "vae_hmc_tpu_torch.pipelines.bench_chain" in modules
    assert "vae_hmc_tpu_torch.text.minilm" in modules
    assert "vae_hmc_tpu_torch.cluster.sweep" in modules
    for name in ("ops.pca", "ops.subspace", "viz.tsne", "viz.umap",
                 "viz.projections", "viz.plots", "core.goldens",
                 "core.profiling", "pipelines.medium", "cli", "io.audio",
                 "io.native", "io.staging", "core.manifest",
                 "pipelines.acquisition", "pipelines.parity",
                 "parallel.collectives", "parallel.mesh", "parallel.train_dp",
                 "parallel.features_dp", "parallel.multihost"):
        assert f"vae_hmc_tpu_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'vae_hmc_tpu')"
        " or m.startswith(('jax.', 'vae_hmc_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
