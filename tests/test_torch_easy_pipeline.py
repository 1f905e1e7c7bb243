"""The port's easy tier end to end (``run_easy_pipeline``) on the CPU, and
its scripts 07 and 09 against the JAX package.

  - the runner at the JAX package's test size (tests/test_easy_pipeline.py:
    48 tracks, 2 s clips, latent 8, 6 epochs, k = 6) writes the same file
    set as the JAX package's runner given the same configs, with the
    visualization; CSV header and rows, the JSON files' fields,
    history.json; scaler.joblib unpickles (pickle and joblib); the
    checkpoint loads through the JAX package's load_checkpoint and the Flax
    model reproduces the port's forward at atol 1e-5; the quality-drift
    status reads "no-golden" and extract_easy reads as the JAX package's;
  - scripts 07 and 09 fed the same input files in both packages (six
    separated blobs, so both k-means find one partition): labels equal up
    to a renaming, centres within 1e-4, silhouette within 1e-5,
    Calinski-Harabasz within rtol 1e-4, explained variance within 1e-5;
  - script 09 with matplotlib hidden writes its figures as .npz data.
"""
import json
import pickle
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import joblib
import numpy as np
import pytest
import torch

from vae_hmc_tpu.core import artifacts as jart
from vae_hmc_tpu.core import config as jconfig
from vae_hmc_tpu.core import goldens as jgoldens
from vae_hmc_tpu.models.dense_vae import DenseVAE as FlaxDenseVAE
from vae_hmc_tpu.pipelines import easy as jeasy
from vae_hmc_tpu.pipelines.sources import SyntheticSource as JSyntheticSource
from vae_hmc_tpu_torch.core import goldens
from vae_hmc_tpu_torch.core.config import (DenseVaeConfig, KMeansConfig,
                                           MfccConfig, Workspace, asdict)
from vae_hmc_tpu_torch.metrics.external import adjusted_rand_index
from vae_hmc_tpu_torch.ops.scaler import StandardScaler
from vae_hmc_tpu_torch.pipelines import easy
from vae_hmc_tpu_torch.pipelines.sources import SyntheticSource

torch.manual_seed(0)
torch.set_num_threads(1)

MFCC = dict(duration_s=2.0)
VAE = dict(latent_dim=8, epochs=6, batch_size=16)
KM = dict(n_clusters=6, n_init=4)
HEADER = ("method,input,input_dim,k,silhouette,calinski_harabasz,"
          "pca_variance")


def _files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


@pytest.fixture(scope="module")
def easy_run(tmp_path_factory):
    ws = Workspace(tmp_path_factory.mktemp("port_easy"))
    source = SyntheticSource.make(n_tracks=48, seed=0)
    out = easy.run_easy_pipeline(source, ws, MfccConfig(**MFCC),
                                 DenseVaeConfig(**VAE), KMeansConfig(**KM),
                                 with_viz=True, device_batch=16, device="cpu")
    return ws, source, out


@pytest.fixture(scope="module")
def jax_easy_root(tmp_path_factory):
    ws = jconfig.Workspace(tmp_path_factory.mktemp("jax_easy"))
    jeasy.run_easy_pipeline(JSyntheticSource.make(n_tracks=48, seed=0), ws,
                            jconfig.MfccConfig(**MFCC),
                            jconfig.DenseVaeConfig(**VAE),
                            jconfig.KMeansConfig(**KM), with_viz=True,
                            device_batch=16)
    return Path(ws.root)


def test_same_file_set_as_jax(easy_run, jax_easy_root):
    ws, _, out = easy_run
    assert _files(Path(ws.root)) == _files(jax_easy_root)
    assert "results/viz_vae/plots/vae_umap.png" in _files(Path(ws.root))
    assert out["figures"] == "png"
    assert set(out["timing"]["seconds"]) == {
        "train_basic_vae", "cluster_easy", "visualize_easy",
        "compare_pca_baseline"}


def test_json_fields_match_jax(easy_run, jax_easy_root):
    ws, _, _ = easy_run
    for rel in ("results/vae_basic/train_config.json",
                "results/vae_basic/history.json",
                "results/kmeans_vae/kmeans_vae_summary.json",
                "results/compare_metrics/metrics_report.json",
                "results/vae_basic/vae_basic.pt.meta.json",
                "results/timing_easy.json"):
        ours = json.loads((Path(ws.root) / rel).read_text())
        ref = json.loads((jax_easy_root / rel).read_text())
        assert set(ours) == set(ref), rel
    cfg = json.loads((ws.results / "vae_basic/train_config.json").read_text())
    ref = json.loads((jax_easy_root /
                      "results/vae_basic/train_config.json").read_text())
    assert {k: v for k, v in cfg.items() if k != "out_dir"} == \
        {k: v for k, v in ref.items() if k != "out_dir"}
    meta = json.loads((ws.results / "vae_basic/vae_basic.pt.meta.json")
                      .read_text())
    assert meta == json.loads((jax_easy_root / "results/vae_basic/"
                               "vae_basic.pt.meta.json").read_text())


def test_shapes_history_and_summary(easy_run):
    ws, source, out = easy_run
    z = np.load(ws.results / "vae_basic/latent_mu.npy")
    ids = np.load(ws.results / "vae_basic/track_ids.npy")
    labels = np.load(ws.results / "kmeans_vae/labels_vae_kmeans.npy")
    assert z.shape == (48, 8) and z.dtype == np.float32 and \
        np.isfinite(z).all()
    np.testing.assert_array_equal(z, out["train"]["latents"].numpy())
    assert labels.shape == (48,) and labels.dtype == np.int64
    assert set(ids) == set(int(t) for t in source.track_ids)
    hist = json.loads((ws.results / "vae_basic/history.json").read_text())
    assert list(hist) == ["epoch", "total", "recon", "kl"]
    assert hist["epoch"] == list(range(1, 7))
    assert hist["total"][-1] < hist["total"][0]
    summ = json.loads((ws.results / "kmeans_vae/kmeans_vae_summary.json")
                      .read_text())
    assert sum(summ["label_distribution"].values()) == 48
    assert summ["vae_latent_shape"] == [48, 8]
    blob = np.load(ws.results / "vae_basic/mfcc_features_cache.npy",
                   allow_pickle=True).item()
    assert blob["X"].shape == (48, 80) and blob["X"].dtype == np.float32
    np.testing.assert_array_equal(blob["track_ids"], ids)
    assert out["train"]["report"].ok_count() == 48


def test_metrics_csv(easy_run):
    ws, _, _ = easy_run
    lines = (ws.results / "compare_metrics/metrics.csv").read_text() \
        .strip().split("\n")
    assert lines[0] == HEADER and len(lines) == 4
    assert [ln.split(",")[0] for ln in lines[1:]] == [
        "VAE+KMeans", "PCA(8)+KMeans", "PCA(8)+KMeans"]
    assert lines[2].split(",")[1] == "MFCC features (80D)"
    for ln in lines[1:]:
        sil = float(ln.split(",")[4])
        assert np.isfinite(sil) and -1.0 <= sil <= 1.0


def test_scaler_joblib_unpickles(easy_run):
    ws, _, _ = easy_run
    path = ws.results / "vae_basic/scaler.joblib"
    with open(path, "rb") as f:
        scaler = pickle.load(f)
    assert isinstance(scaler, StandardScaler)
    assert isinstance(joblib.load(path), StandardScaler)
    x = np.load(ws.results / "vae_basic/mfcc_features_cache.npy",
                allow_pickle=True).item()["X"]
    want = StandardScaler().fit(x)
    np.testing.assert_array_equal(scaler.mean_, want.mean_)
    np.testing.assert_array_equal(scaler.scale_, want.scale_)


def test_checkpoint_loads_into_the_jax_package(easy_run):
    ws, _, out = easy_run
    model = out["train"]["model"]
    flax = FlaxDenseVAE(input_dim=80, hidden_dims=(256, 256), latent_dim=8)
    like = jax.jit(lambda k: flax.init(k, jnp.zeros((1, 80)), k))(
        jax.random.PRNGKey(0))
    params, meta = jart.load_checkpoint(ws.results / "vae_basic/vae_basic.pt",
                                        like=like)
    want_cfg = asdict(DenseVaeConfig(**{**VAE, "input_dim": 80}))
    assert meta == json.loads(json.dumps({"config": want_cfg}))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 80)).astype(np.float32)
    eps = rng.standard_normal((5, 8)).astype(np.float32)
    mu, lv = flax.apply(params, x, method=flax.encode)
    xhat = flax.apply(params, mu + eps * jnp.exp(0.5 * lv),
                      method=flax.decode)
    with torch.no_grad():
        got = model(torch.from_numpy(x), eps=torch.from_numpy(eps))
    for g, w in zip(got, (xhat, mu, lv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_quality_drift_reads_no_golden(easy_run):
    ws, _, out = easy_run
    assert out["quality_drift"] == {"status": "no-golden",
                                    "key": "easy:cpu:48", "mismatches": []}
    observed = goldens.extract_easy(ws.results)
    assert observed == jgoldens.extract_easy(ws.results)
    assert len(observed) == 3


# -- scripts 07 and 09 on the same input files -------------------------------


def _blob_files(ws_root: Path):
    """latent_mu (60, 8), track ids and the MFCC cache (60, 80): six
    separated blobs, as script 06 would leave them."""
    rng = np.random.default_rng(21)
    lab = np.repeat(np.arange(6), 10)
    z = (rng.normal(0, 0.3, (60, 8)) + 4.0 * rng.normal(0, 1, (6, 8))[lab])
    x = (rng.normal(0, 1.0, (60, 80)) + 6.0 * rng.normal(0, 1, (6, 80))[lab])
    ids = np.arange(9000, 9060, dtype=np.int64)
    out = ws_root / "results" / "vae_basic"
    out.mkdir(parents=True)
    np.save(out / "latent_mu.npy", z.astype(np.float32))
    np.save(out / "track_ids.npy", ids)
    np.save(out / "mfcc_features_cache.npy",
            {"X": x.astype(np.float32), "track_ids": ids}, allow_pickle=True)


def _match_rows(a, b):
    """b's rows reordered to a's by nearest neighbour (a permutation)."""
    order = [int(np.argmin(np.linalg.norm(b - r, axis=1))) for r in a]
    assert sorted(order) == list(range(len(a)))
    return b[order]


@pytest.fixture
def same_inputs(tmp_path):
    ours, ref = Workspace(tmp_path / "o"), jconfig.Workspace(tmp_path / "j")
    _blob_files(Path(ours.root))
    shutil.copytree(Path(ours.root), Path(ref.root))
    return ours, ref


def test_scripts_07_09_match_jax(same_inputs):
    ours, ref = same_inputs
    km, jkm = KMeansConfig(**KM), jconfig.KMeansConfig(**KM)
    c = easy.cluster_easy(ours, km, device="cpu")
    jc = jeasy.cluster_easy(ref, jkm)
    assert adjusted_rand_index(c["labels"], jc["labels"]) == 1.0
    np.testing.assert_allclose(_match_rows(jc["centers"], c["centers"]),
                               jc["centers"], atol=1e-4)
    s, js = c["summary"], jc["summary"]
    assert s["vae_latent_shape"] == js["vae_latent_shape"] == [60, 8]
    assert sorted(s["label_distribution"].values()) == \
        sorted(js["label_distribution"].values())
    assert {k: v for k, v in s["config"].items() if "dir" not in k} == \
        {k: v for k, v in js["config"].items() if "dir" not in k}

    m = easy.compare_pca_baseline(ours, km, device="cpu")
    jm = jeasy.compare_pca_baseline(ref, jkm)
    assert len(m["rows"]) == len(jm["rows"]) == 3
    for r, jr in zip(m["rows"], jm["rows"]):
        for k in ("method", "input", "input_dim", "k"):
            assert r[k] == jr[k]
        assert r["silhouette"] == pytest.approx(jr["silhouette"], abs=1e-5)
        assert r["calinski_harabasz"] == pytest.approx(
            jr["calinski_harabasz"], rel=1e-4)
        if r["pca_variance"] == "":
            assert jr["pca_variance"] == ""
        else:
            assert r["pca_variance"] == pytest.approx(jr["pca_variance"],
                                                      abs=1e-5)
    d, jd = ours.results / "compare_metrics", Path(ref.results) / \
        "compare_metrics"
    for name in ("labels_pca_mfcc.npy", "labels_pca_latents.npy"):
        assert adjusted_rand_index(np.load(d / name), np.load(jd / name)) == 1
    assert (d / "metrics.csv").read_text().split("\n")[0] == HEADER
    assert set(json.loads((d / "metrics_report.json").read_text())) == set(
        json.loads((jd / "metrics_report.json").read_text()))


def test_script_09_without_matplotlib(same_inputs, monkeypatch, capsys):
    ours, _ = same_inputs
    easy.cluster_easy(ours, KMeansConfig(**KM), device="cpu")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    easy.compare_pca_baseline(ours, KMeansConfig(**KM), device="cpu")
    plots = ours.results / "compare_metrics" / "plots"
    for stem in ("pca_variance_mfcc", "pca_variance_latents"):
        assert not (plots / f"{stem}.png").exists()
        with np.load(plots / f"{stem}.npz") as data:
            assert len(data["explained_ratio"]) == 8
    text = capsys.readouterr().out
    assert "COMPARISON RESULTS (VAE vs PCA on MFCC features):" in text
    assert "KEY FINDINGS:" in text
