"""The port's medium tier end to end (``run_medium_pipeline``) on the CPU,
and its scripts 10, 12, 14 and 17 against the JAX package.

  - the runner at the JAX package's test size (tests/test_medium_pipeline.py:
    36 tracks, 1.5 s clips, 32 mels, 2 epochs, its SweepConfig) writes every
    file of that test's list, script 14's files, the checkpoint and
    timing_medium.json; CSV headers and row counts (21 from script 13, 24
    from script 16); train_log.csv; the (36, 1, 32, T) mel .npy; the
    quality-drift status reads "no-golden", and against a goldens file of
    its own rows ok, then drift, as the JAX package's check reads them;
  - script 17 fed the same sweep CSV as the JAX package's writes
    byte-identical best_filtered*.csv files;
  - script 14 with the same x and labels writes the same summary text;
  - BuildReport.save writes the JAX package's bytes;
  - script 12's checkpoint loads through the JAX package's
    load_checkpoint, and the Flax model with those params reproduces the
    port's forward at atol 1e-5 (and the port's own loader round-trips it);
  - script 15 from the files on disk (no shared RepData: kernel 2
    distances of each representation, UMAP from x) with matplotlib hidden
    writes its figures as .npz data.
"""
import json
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_hmc_tpu.core import artifacts as jart
from vae_hmc_tpu.core.config import ConvMMVaeConfig as JConvMMVaeConfig
from vae_hmc_tpu.core.config import Workspace as JWorkspace
from vae_hmc_tpu.core.config import asdict as jasdict
from vae_hmc_tpu.models.conv_mm_vae import ConvMMVAE as FlaxConvMMVAE
from vae_hmc_tpu.pipelines import features as jfeatures
from vae_hmc_tpu.pipelines import medium as jmedium
from vae_hmc_tpu_torch.core import artifacts
from vae_hmc_tpu_torch.core.config import (ConvMMVaeConfig, MelConfig,
                                           SweepConfig, TextEmbedConfig,
                                           Workspace)
from vae_hmc_tpu_torch.models.conv_mm_vae import ConvMMVAE
from vae_hmc_tpu_torch.models.convert import (conv_mm_vae_flax_params,
                                              conv_mm_vae_state_dict)
from vae_hmc_tpu_torch.pipelines import features, medium
from vae_hmc_tpu_torch.pipelines.sources import SyntheticSource

torch.manual_seed(0)
torch.set_num_threads(1)

MEL = MelConfig(duration_s=1.5, n_mels=32)          # T = 65
VAE = dict(epochs=2, batch_size=12, latent_dim=8, audio_fc_dim=32)
EXPECTED = [       # tests/test_medium_pipeline.py's list, then the port's
    "data/audio_cnn_mel_X.npy",
    "data/audio_cnn_mel_track_ids.npy",
    "results/audio_cnn_mel_build_report.csv",
    "data/lyrics_embeddings.npy",
    "data/lyrics_track_ids.npy",
    "results/lyrics_embedding_report.csv",
    "results/vae_conv_mm_medium/train_log.csv",
    "data/vae_mm_latents_mu.npy",
    "data/vae_mm_latents_track_ids.npy",
    "results/medium_clustering_metrics_all.csv",
    "results/medium_full_sweep_metrics.csv",
    "results/medium_full_sweep_best_by_representation.csv",
    "results/medium_full_sweep_best_overall.csv",
    "results/report_medium/best_filtered.csv",
    "results/report_medium/best_filtered_by_representation.csv",
    "results/cluster_viz/side_by_side_medium.png",
    "results/cluster_viz/lyrics_dbscan_eps_sweep_clusters_medium.png",
    "results/cluster_viz/lyrics_dbscan_eps_sweep_noise_medium.png",
    # script 14
    "results/cluster_viz/vae_kmeans6_vae_mm_latents_mu_kmeans_pca_clusters.png",
    "results/cluster_viz/vae_kmeans6_vae_mm_latents_mu_kmeans_pca_truegenre.png",
    "results/cluster_viz/vae_kmeans6_vae_mm_latents_mu_kmeans_pca_summary.txt",
    # script 12's checkpoint, script 17's plots, the runner's timing
    "results/vae_conv_mm_medium/ckpt_epoch_002.pt",
    "results/vae_conv_mm_medium/ckpt_epoch_002.pt.meta.json",
    "results/report_medium/plot_silhouette.png",
    "results/report_medium/dbscan_noise_vs_eps_vae_mm_latents.png",
    "results/timing_medium.json",
]
HDR13 = ("representation,algo,params,n_clusters_found,n_noise,silhouette,"
         "davies_bouldin,ari")
HDR16 = ("representation,algo,params,n_clusters_found,n_noise,noise_frac,"
         "silhouette,davies_bouldin,ari,score")


@pytest.fixture(scope="module")
def medium_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_medium")
    with pytest.MonkeyPatch.context() as mp:     # no MiniLM checkpoint
        mp.delenv("VAE_HMC_MINILM_DIR", raising=False)
        mp.setenv("HF_HOME", str(root / "no_hf_cache"))
        ws = Workspace(root / "ws")
        source = SyntheticSource.make(n_tracks=36, seed=1, lyrics_coverage=0.8)
        out = medium.run_medium_pipeline(
            source, ws, MEL, TextEmbedConfig(), ConvMMVaeConfig(**VAE),
            SweepConfig(ks=(4, 6), dbscan_eps=(0.5, 1.0),
                        dbscan_min_samples=(3, 5)),
            with_viz=True, device_batch=12, device="cpu")
    return ws, source, out


def _lines(path):
    return Path(path).read_text().strip().split("\n")


def test_medium_artifact_contract(medium_run):
    ws, _, out = medium_run
    for rel in EXPECTED:
        assert (Path(ws.root) / rel).exists(), f"missing artifact: {rel}"
    assert out["figures"] == "png"
    assert set(out["timing"]["seconds"]) == {
        "build_audio_features", "build_lyrics_embeddings", "train_conv_mm",
        "build_representations", "cluster_and_evaluate",
        "full_clustering_sweep", "report_tables_and_plots",
        "visualize_clustering", "side_by_side_and_dbscan_sweep",
        "train_artifact_join"}


def test_mel_feature_shape(medium_run):
    ws, _, out = medium_run
    x = np.load(Path(ws.root) / "data/audio_cnn_mel_X.npy")
    assert x.shape == (36, 1, 32, MEL.n_frames) and x.dtype == np.float32
    np.testing.assert_array_equal(x[:, 0], out["audio"]["x"].numpy())
    flat = x.reshape(36, -1)
    np.testing.assert_allclose(flat.mean(axis=1), 0.0, atol=1e-3)
    np.testing.assert_allclose(flat.std(axis=1), 1.0, atol=1e-2)


def test_csv_headers_and_row_counts(medium_run):
    ws, _, out = medium_run
    lines13 = _lines(ws.results / "medium_clustering_metrics_all.csv")
    lines16 = _lines(ws.results / "medium_full_sweep_metrics.csv")
    assert lines13[0] == HDR13 and len(lines13) == 22       # 21 rows
    assert lines16[0] == HDR16 and len(lines16) == 25       # 24 rows
    assert len(out["suite"]) == 21 and len(out["sweep"]) == 24
    for name in ("medium_full_sweep_best_by_representation.csv",
                 "medium_full_sweep_best_overall.csv",
                 "report_medium/best_filtered.csv"):
        assert _lines(ws.results / name)[0] == HDR16
    assert len(_lines(ws.results /
                      "medium_full_sweep_best_by_representation.csv")) == 4


def test_train_log_latents_and_mask(medium_run):
    ws, _, out = medium_run
    lines = _lines(ws.results / "vae_conv_mm_medium/train_log.csv")
    assert lines[0] == "epoch,loss,recon,kl" and len(lines) == 3
    mu = np.load(ws.data / "vae_mm_latents_mu.npy")
    assert mu.shape == (36, 8) and np.isfinite(mu).all()
    np.testing.assert_array_equal(mu, out["train"]["latents"].numpy())
    np.testing.assert_array_equal(
        np.load(ws.data / "vae_mm_latents_track_ids.npy"), out["train"]["ids"])
    mask = out["train"]["lyrics_mask"]
    l_ids = np.load(ws.data / "lyrics_track_ids.npy")
    assert mask.sum() == len(l_ids) and set(np.asarray(mask)) <= {0.0, 1.0}


def test_quality_drift_reads_no_golden(medium_run):
    _, _, out = medium_run
    assert out["quality_drift"] == {"status": "no-golden",
                                    "key": "medium:cpu:36", "mismatches": []}


def test_goldens_check_matches_jax(medium_run, tmp_path, monkeypatch):
    """A goldens file holding this run's own rows reads ok; one moved value
    reads drift (and raises under VAE_HMC_QUALITY_STRICT=1), as in the JAX
    package given the same rows and file."""
    from vae_hmc_tpu.core import goldens as jgoldens
    from vae_hmc_tpu_torch.core import goldens
    ws, _, _ = medium_run
    observed = goldens.extract_medium(ws.results)
    assert observed == jgoldens.extract_medium(ws.results)
    assert len(observed) == 21
    path = tmp_path / "goldens.json"
    entry = {k: dict(v) for k, v in observed.items()}
    path.write_text(json.dumps({"medium:cpu:36": entry}))
    monkeypatch.setenv("VAE_HMC_GOLDENS_PATH", str(path))
    assert goldens.check_tier("medium", ws.results, 36, "cpu")["status"] == "ok"
    assert goldens.check_tier("medium", ws.results, 36, "cuda")["status"] == \
        "no-golden"
    first = next(iter(entry))
    entry[first]["n_noise"] = 99
    path.write_text(json.dumps({"medium:cpu:36": entry}))
    ours = goldens.check("medium:cpu:36", observed)
    assert ours == jgoldens.check("medium:cpu:36", observed)
    assert ours["status"] == "drift" and len(ours["mismatches"]) == 1
    monkeypatch.setenv("VAE_HMC_QUALITY_STRICT", "1")
    with pytest.raises(RuntimeError, match="quality drift"):
        goldens.check_tier("medium", ws.results, 36, "cpu", quiet=True)


def test_viz_embeddings(medium_run):
    ws, _, out = medium_run
    n_lyr = len(np.load(ws.data / "lyrics_track_ids.npy"))
    emb = out["viz15"]["embeddings"]
    for kind in ("pca", "umap"):
        assert [e.shape for e in emb[kind]] == [(36, 2), (36, 2), (n_lyr, 2)]
        assert all(np.isfinite(e).all() for e in emb[kind])
    assert out["viz14"]["xy"].shape == (36, 2)


def test_report_matches_jax(medium_run, tmp_path):
    """Script 17 on one sweep CSV in both packages: the same filtered
    tables, byte for byte."""
    ws, _, _ = medium_run
    ours, ref = Workspace(tmp_path / "o"), JWorkspace(tmp_path / "j")
    for w in (ours, ref):
        w.results.mkdir(parents=True)
        shutil.copy(ws.results / "medium_full_sweep_metrics.csv", w.results)
    medium.report_tables_and_plots(ours)
    jmedium.report_tables_and_plots(ref)
    for name in ("best_filtered.csv", "best_filtered_by_representation.csv"):
        a = (ours.results / "report_medium" / name).read_bytes()
        assert a == (ref.results / "report_medium" / name).read_bytes()
        assert len(a.splitlines()) > 1


@pytest.mark.parametrize("method", ["kmeans", "dbscan"])
def test_visualize_clustering_summary_matches_jax(medium_run, tmp_path,
                                                  method):
    ws, source, _ = medium_run
    x = np.load(ws.data / "vae_mm_latents_mu.npy")
    ids = np.load(ws.data / "vae_mm_latents_track_ids.npy")
    yhat = np.where(np.arange(36) % 7 == 0, -1, np.arange(36) % 3)
    genre_map = {int(t): str(g) for t, g in zip(source.track_ids,
                                                source.genres)}
    rp, ip = Path("data/vae_mm_latents_mu.npy"), Path("data/ids.npy")
    kw = dict(method=method, n_clusters=6, proj="pca", tag="cmp", x_arr=x,
              ids_arr=ids, yhat_arr=yhat)
    ours = medium.visualize_clustering(Workspace(tmp_path / "o"), rp, ip,
                                       genre_map, device="cpu", **kw)
    medium.visualize_clustering(Workspace(tmp_path / "t"), rp, ip, genre_map,
                                device="cpu", **{**kw, "x_arr":
                                                 torch.from_numpy(x)})
    jmedium.visualize_clustering(JWorkspace(tmp_path / "j"), rp, ip,
                                 genre_map, **kw)
    name = f"cmp_vae_mm_latents_mu_{method}_pca_summary.txt"
    text = (tmp_path / "o/results/cluster_viz" / name).read_text()
    assert text == (tmp_path / "j/results/cluster_viz" / name).read_text()
    assert text == (tmp_path / "t/results/cluster_viz" / name).read_text()
    assert ("n_noise=6" in text) and ("eps=0.6" in text) == (method == "dbscan")
    assert ours["clusters_png"].exists() and ours["truegenre_png"].exists()
    np.testing.assert_array_equal(ours["labels"], yhat)


def test_build_report_save_matches_jax(medium_run, tmp_path):
    _, _, out = medium_run
    rows = list(out["audio"]["report"].rows) + [
        (7, "/a,b/c.mp3", "error", 'DecodeError: "bad" header')]
    a = features.BuildReport(rows).save(tmp_path / "o.csv").read_bytes()
    b = jfeatures.BuildReport(rows).save(tmp_path / "j.csv").read_bytes()
    assert a == b and len(a.splitlines()) == 38


def test_checkpoint_loads_into_the_jax_package(medium_run):
    ws, _, out = medium_run
    model = out["train"]["model"]
    path = ws.results / "vae_conv_mm_medium/ckpt_epoch_002.pt"
    t = MEL.n_frames
    flax = FlaxConvMMVAE(n_mels=32, n_frames=t, fc_dim=32, latent_dim=8,
                         lyrics_dim=384)
    like = jax.jit(lambda k: flax.init(
        k, jnp.zeros((1, 32, t, 1)), jnp.zeros((1, 384)), jnp.zeros((1, 1)),
        k))(jax.random.PRNGKey(0))
    params, meta = jart.load_checkpoint(path, like=like)
    assert meta == json.loads(json.dumps({
        "config": jasdict(JConvMMVaeConfig(**VAE)), "epoch": 2,
        "input_shape": [36, 1, 32, t]}))
    rng = np.random.default_rng(9)
    x = rng.standard_normal((5, 32, t, 1)).astype(np.float32)
    lyr = rng.standard_normal((5, 384)).astype(np.float32)
    m = np.array([[1.0], [0.0], [1.0], [1.0], [0.0]], np.float32)
    eps = rng.standard_normal((5, 8)).astype(np.float32)
    mu, lv = flax.apply(params, x, lyr, m, method=flax.encode)
    xhat = flax.apply(params, mu + eps * jnp.exp(0.5 * lv),
                      method=flax.decode)
    with torch.no_grad():
        txhat, tmu, tlv = model(*(torch.from_numpy(a) for a in (x, lyr, m)),
                                eps=torch.from_numpy(eps))
    for got, want in ((txhat, xhat), (tmu, mu), (tlv, lv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    # the port's own reader: back into a fresh module, bit for bit
    like_np = {"params": conv_mm_vae_flax_params(model.state_dict(),
                                                 model.enc_hw)}
    loaded, meta2 = artifacts.load_checkpoint(path, like=like_np)
    assert meta2 == meta
    fresh = ConvMMVAE(n_mels=32, n_frames=t, fc_dim=32, latent_dim=8)
    fresh.load_state_dict(conv_mm_vae_state_dict(loaded["params"],
                                                 fresh.enc_hw))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
    flat, _ = artifacts.load_checkpoint(path)
    assert "params/enc_conv1/kernel" in flat and len(flat) == 32  # 16 layers
    with pytest.raises(KeyError, match="missing param"):
        artifacts.load_checkpoint(path, like={"params": {"nope": {"kernel":
                                                                   0.0}}})


def test_script15_from_files_without_matplotlib(medium_run, monkeypatch):
    """Script 15 reading the representations back from disk (no RepData:
    k-means, DBSCAN and UMAP from x) with matplotlib hidden."""
    ws, _, _ = medium_run
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    out = medium.side_by_side_and_dbscan_sweep(ws, tag="nompl", device="cpu")
    d = ws.results / "cluster_viz"
    assert out["side_by_side"] == d / "side_by_side_nompl.npz"
    assert out["sweep_clusters"] == \
        d / "lyrics_dbscan_eps_sweep_clusters_nompl.npz"
    assert not (d / "side_by_side_nompl.png").exists()
    with np.load(out["sweep_noise"]) as data:
        assert len(data["y"]) == 7 and str(data["xlabel"]) == "DBSCAN eps"
    with np.load(out["side_by_side"]) as data:
        for i in range(3):
            for j in range(2):
                assert data[f"xy_{i}_{j}"].shape[1] == 2
                assert np.isfinite(data[f"xy_{i}_{j}"]).all()
        assert str(data["title_2_1"]) == \
            "Lyrics + DBSCAN(eps=0.4) | UMAP (noise likely)"
