"""The port's hard tier end to end (``run_hard_pipeline``) on the CPU, and
its scripts 20 and 22 against the JAX package.

  - the runner at the JAX package's test size (tests/test_hard_pipeline.py:
    36 tracks, 2 s clips, hidden 32, latent 6, 3 epochs, tag "beta_test",
    with the visualizations) writes the same file set as the JAX package's
    runner given the same configs; build_info.json reads the same (shapes,
    classes, the TF-IDF backend: the synthetic lyrics are the same text);
    the JSON and CSV fields; the idempotent script 18; quality drift reads
    "no-golden" and extract_hard reads as the JAX package's;
  - scripts 20 and 22 fed the same input files in both packages (separated
    blobs per genre, so both k-means find one partition): k, NMI, ARI and
    purity within 1e-12, silhouette within 1e-6 of sklearn's and 5e-5 of
    the JAX package's (its distance diagonal keeps the f32 residue, parity
    rule 5 of ROADMAP.md), the composition rows equal
    up to a renaming of the clusters; script 22's AE row (a trained model,
    each package's own random init) only by name and range;
  - the CVAE variant trains on a condition one-hot, writes
    cvae_multimodal.pt and its tagged copy, and the JAX package's
    load_checkpoint reads it into a conditional Flax DenseVAE.
"""
import csv
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import silhouette_score

from vae_hmc_tpu.core import artifacts as jart
from vae_hmc_tpu.core import config as jconfig
from vae_hmc_tpu.core import goldens as jgoldens
from vae_hmc_tpu.models.dense_vae import DenseVAE as FlaxDenseVAE
from vae_hmc_tpu.pipelines import hard as jhard
from vae_hmc_tpu.pipelines.sources import SyntheticSource as JSyntheticSource
from vae_hmc_tpu_torch.core import goldens
from vae_hmc_tpu_torch.core.config import (AeConfig, HardVaeConfig,
                                           MfccConfig, TextEmbedConfig,
                                           Workspace)
from vae_hmc_tpu_torch.pipelines import hard
from vae_hmc_tpu_torch.pipelines.sources import SyntheticSource

torch.manual_seed(0)
torch.set_num_threads(1)

MFCC = dict(duration_s=2.0, min_duration_s=1.0)
VAE = dict(hidden_dim=32, latent_dim=6, epochs=3, batch_size=12, beta=4.0)
AE = dict(hidden_dim=32, latent_dim=6, epochs=3, batch_size=12)
# the JAX package's silhouette keeps the f32 residue of |x|^2 + |x|^2 - 2x.x
# on its distance diagonal (ROADMAP parity rule 5): 5e-6 to 1.2e-5 off
# sklearn on these blobs, where the port is within 1e-7
JAX_SIL = 5e-5
GENRES = ["Experimental", "Folk", "Hip-Hop", "International", "Pop", "Rock"]


def _files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


@pytest.fixture(scope="module")
def no_minilm(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("VAE_HMC_MINILM_DIR", raising=False)
        mp.setenv("HF_HOME", str(tmp_path_factory.mktemp("no_hf_cache")))
        yield


@pytest.fixture(scope="module")
def hard_run(tmp_path_factory, no_minilm):
    ws = Workspace(tmp_path_factory.mktemp("port_hard"))
    source = SyntheticSource.make(n_tracks=36, seed=2, lyrics_coverage=0.85)
    out = hard.run_hard_pipeline(source, ws, MfccConfig(**MFCC),
                                 TextEmbedConfig(), HardVaeConfig(**VAE),
                                 AeConfig(**AE), tag="beta_test",
                                 with_viz=True, device_batch=12,
                                 device="cpu")
    return ws, source, out


@pytest.fixture(scope="module")
def jax_hard_root(tmp_path_factory, no_minilm):
    ws = jconfig.Workspace(tmp_path_factory.mktemp("jax_hard"))
    jhard.run_hard_pipeline(
        JSyntheticSource.make(n_tracks=36, seed=2, lyrics_coverage=0.85), ws,
        jconfig.MfccConfig(**MFCC), jconfig.TextEmbedConfig(),
        jconfig.HardVaeConfig(**VAE), jconfig.AeConfig(**AE),
        tag="beta_test", with_viz=True, device_batch=12)
    return Path(ws.root)


def test_same_file_set_as_jax(hard_run, jax_hard_root):
    ws, _, out = hard_run
    files = _files(Path(ws.root))
    assert files == _files(jax_hard_root)
    for rel in ("models/hard/beta_vae_multimodal_beta_test.pt",
                "results/hard/plots/recon_examples_beta_test.png",
                "results/timing_hard.json"):
        assert rel in files
    assert out["figures"] == "png"
    assert set(out["timing"]["seconds"]) == {
        "prepare_features", "train_hard", "cluster_and_evaluate",
        "visualize_latents", "compare_with_baselines"}


def test_build_info_and_metadata_match_jax(hard_run, jax_hard_root):
    ws, _, _ = hard_run
    info = json.loads((ws.data_hard / "build_info.json").read_text())
    ref = json.loads((jax_hard_root / "data/hard/build_info.json")
                     .read_text())
    assert info == ref
    assert info["text_embedding_backend"] == "tfidf"
    assert info["audio_feature_shape"] == [36, 80]
    assert (ws.data_hard / "hard_metadata.csv").read_text() == \
        (jax_hard_root / "data/hard/hard_metadata.csv").read_text()
    for name in ("genres.npy", "languages.npy", "genre_idx.npy",
                 "lang_idx.npy", "track_ids.npy"):
        np.testing.assert_array_equal(
            np.load(ws.data_hard / name, allow_pickle=True),
            np.load(jax_hard_root / "data/hard" / name, allow_pickle=True))
    np.testing.assert_array_equal(
        np.load(ws.data_hard / "lyrics_emb.npy"),
        np.load(jax_hard_root / "data/hard/lyrics_emb.npy"))
    meta = json.loads((Path(ws.root) / "models/hard/"
                       "beta_vae_multimodal.pt.meta.json").read_text())
    assert meta == json.loads((jax_hard_root / "models/hard/"
                               "beta_vae_multimodal.pt.meta.json").read_text())


def test_metrics_json_and_csv_fields(hard_run, jax_hard_root):
    ws, _, out = hard_run
    m = json.loads((ws.results_hard / "hard_metrics_vae_latents.json")
                   .read_text())
    assert set(m) == {"feature_space", "k", "silhouette", "nmi", "ari",
                      "purity"}
    assert m["k"] == 6 and 0.0 <= m["purity"] <= 1.0 and \
        0.0 <= m["nmi"] <= 1.0 and -1.0 <= m["silhouette"] <= 1.0
    for name in ("cluster_composition_by_genre.csv",
                 "cluster_distribution_genre_counts.csv",
                 "cluster_distribution_language_counts.csv",
                 "baseline_comparison.csv"):
        with open(ws.results_hard / name, newline="") as f:
            ours = next(csv.reader(f))
        with open(jax_hard_root / "results/hard" / name, newline="") as f:
            assert ours == next(csv.reader(f)), name
    with open(ws.results_hard / "cluster_composition_by_genre.csv") as f:
        assert next(csv.reader(f)) == ["pred"] + GENRES
    methods = [r["method"] for r in out["baselines"]]
    assert methods == ["VAE/CVAE latents + KMeans",
                       "Direct spectral (MFCC stats) + KMeans",
                       "PCA(32) + KMeans (audio)",
                       "Autoencoder(z=6) + KMeans (fused)"]
    z = np.load(ws.data_hard / "latents_mu.npy")
    assert z.shape == (36, 6) and np.isfinite(z).all()
    np.testing.assert_array_equal(
        z, np.load(ws.data_hard / "latents_mu_beta_test.npy"))
    assert np.load(ws.results_hard / "plots/latent_2d.npy").shape == (36, 2)
    assert len(out["train"]["history"]) == 3


def test_idempotent_prepare(hard_run):
    ws, source, _ = hard_run
    again = hard.prepare_features(source, ws, device="cpu")
    assert again.get("skipped") is True
    assert again["info"]["num_tracks_kept"] == 36


def test_quality_drift_reads_no_golden(hard_run):
    ws, _, out = hard_run
    assert out["quality_drift"] == {"status": "no-golden",
                                    "key": "hard:cpu:36", "mismatches": []}
    observed = goldens.extract_hard(ws.results)
    assert observed == jgoldens.extract_hard(ws.results)
    assert len(observed) == 5


# -- scripts 20 and 22 on the same input files -------------------------------


def _hard_files(d: Path):
    rng = np.random.default_rng(31)
    y = np.repeat(np.arange(6), 12)
    rng.shuffle(y)
    n = len(y)
    audio = rng.normal(0, 1.0, (n, 80)) + 6.0 * rng.normal(0, 1, (6, 80))[y]
    text = rng.normal(0, 0.2, (n, 20)) + rng.normal(0, 1, (6, 20))[y]
    z = rng.normal(0, 0.3, (n, 6)) + 4.0 * rng.normal(0, 1, (6, 6))[y]
    langs = np.where(rng.random(n) < 0.8, "en", "none")
    d.mkdir(parents=True)
    np.save(d / "audio_mfcc_stats.npy", audio.astype(np.float32))
    np.save(d / "lyrics_emb.npy", text.astype(np.float32))
    np.save(d / "latents_mu.npy", z.astype(np.float32))
    np.save(d / "genre_idx.npy", y.astype(np.int64))
    np.save(d / "genres.npy", np.asarray([GENRES[i] for i in y], object))
    np.save(d / "languages.npy", np.asarray(langs, object))
    np.save(d / "lang_idx.npy", (langs == "none").astype(np.int64))


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_scripts_20_22_match_jax(tmp_path):
    ours, ref = Workspace(tmp_path / "o"), jconfig.Workspace(tmp_path / "j")
    _hard_files(ours.data_hard)
    shutil.copytree(Path(ours.root), Path(ref.root))
    c = hard.cluster_and_evaluate(ours, seed=7, tag="t", device="cpu")
    jc = jhard.cluster_and_evaluate(ref, seed=7, tag="t")
    m, jm = c["metrics"], jc["metrics"]
    assert m["k"] == jm["k"] == 6
    for k in ("nmi", "ari", "purity"):
        assert m[k] == pytest.approx(jm[k], abs=1e-12)
    z = np.load(ours.data_hard / "latents_mu.npy")
    assert m["silhouette"] == pytest.approx(
        silhouette_score(z, c["labels"]), abs=1e-6)
    assert m["silhouette"] == pytest.approx(jm["silhouette"], abs=JAX_SIL)
    rows = _rows(ours.results_hard / "cluster_composition_by_genre_t.csv")
    jrows = _rows(Path(ref.results_hard) / "cluster_composition_by_genre.csv")
    assert rows[0] == jrows[0] == ["pred"] + GENRES
    assert sorted(r[1:] for r in rows[1:]) == sorted(r[1:] for r in jrows[1:])

    hard.visualize_latents(ours, tag="t", device="cpu")
    assert _rows(ours.results_hard /
                 "cluster_distribution_language_counts.csv")[0] == \
        ["cluster", "en", "none"]

    ae = AeConfig(hidden_dim=32, latent_dim=6, epochs=3, batch_size=12)
    b = hard.compare_with_baselines(ours, ae_cfg=ae, seed=7, tag="t",
                                    device="cpu")
    jb = jhard.compare_with_baselines(
        ref, ae_cfg=jconfig.AeConfig(hidden_dim=32, latent_dim=6, epochs=3,
                                     batch_size=12), seed=7, tag="t")
    assert [r["method"] for r in b] == [r["method"] for r in jb]
    for r, jr in zip(b[:3], jb[:3]):
        for k in ("nmi", "ari", "purity"):
            assert r[k] == pytest.approx(jr[k], abs=1e-12), (r["method"], k)
        assert r["silhouette"] == pytest.approx(jr["silhouette"],
                                                abs=JAX_SIL)
    assert 0.0 <= b[3]["nmi"] <= 1.0 and -1.0 <= b[3]["silhouette"] <= 1.0
    assert _rows(ours.results_hard / "baseline_comparison_t.csv")[0] == \
        ["method", "silhouette", "nmi", "ari", "purity"]


def test_cvae_variant(tmp_path, no_minilm):
    ws = Workspace(tmp_path)
    source = SyntheticSource.make(n_tracks=24, seed=3)
    hard.prepare_features(source, ws, MfccConfig(duration_s=1.5,
                                                 min_duration_s=1.0),
                          TextEmbedConfig(), device_batch=12, device="cpu")
    cfg = HardVaeConfig(hidden_dim=32, latent_dim=4, epochs=2, batch_size=12,
                        use_cvae=True, cond_genre=True)
    out = hard.train_hard(ws, cfg, tag="cvae_t", device="cpu")
    path = Path(ws.root) / "models/hard/cvae_multimodal.pt"
    assert path.exists()
    assert (Path(ws.root) / "models/hard/cvae_multimodal_cvae_t.pt").exists()
    assert out["latents"].shape == (24, 4)
    assert out["model"].cond_dim == 6
    d = out["input_dim"]
    meta = json.loads(path.with_suffix(".pt.meta.json").read_text())
    assert meta["cond_dim"] == 6 and meta["use_cvae"] is True
    assert meta["input_dim"] == d
    flax = FlaxDenseVAE(input_dim=d, hidden_dims=(32, 32), latent_dim=4,
                        cond_dim=6)
    like = jax.jit(lambda k: flax.init(k, jnp.zeros((1, d)), k,
                                       jnp.zeros((1, 6))))(
        jax.random.PRNGKey(0))
    params, _ = jart.load_checkpoint(path, like=like)
    x = np.concatenate([np.load(ws.data_hard / "audio_mfcc_stats.npy"),
                        np.load(ws.data_hard / "lyrics_emb.npy")], axis=1)
    cond = np.eye(6, dtype=np.float32)[np.load(ws.data_hard /
                                               "genre_idx.npy")]
    mu, _ = flax.apply(params, x, cond, method=flax.encode)
    np.testing.assert_allclose(out["latents"].numpy(), np.asarray(mu),
                               rtol=1e-5, atol=1e-4)
