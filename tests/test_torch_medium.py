"""The port's medium-tier stages 11, 13 and 16 against the JAX package.

  - the copied artifact writers and id alignment give the same bytes and
    arrays;
  - script 11 (``build_lyrics_embeddings``) writes the same files;
  - scripts 13 and 16 (``cluster_and_evaluate``, ``full_clustering_sweep``)
    write CSV files that parse to the same headers and rows, metrics within
    atol 1e-4 (the JAX reference with its distance diagonal set to 0,
    ROADMAP parity rule 5; see tests/test_torch_cluster_sweep.py);
  - ``run_core`` with the MiniLM backend on a test-written checkpoint, and
    its tensors and corpus feeding scripts 11, 13 and 16
    (``scripts_11_13_16``) as ``chip_smoke.py`` does, at a tiny size on
    the CPU.
"""
import csv
import math

import numpy as np
import pytest
import torch

from tests import torch_sweep_data as sweep_data
from tests.test_torch_cluster_sweep import _jax_reps
from vae_hmc_tpu.core import align as jalign
from vae_hmc_tpu.core import artifacts as jart
from vae_hmc_tpu.core.config import SweepConfig as JSweepConfig
from vae_hmc_tpu.core.config import Workspace as JWorkspace
from vae_hmc_tpu.pipelines import medium as jmedium
from vae_hmc_tpu.pipelines.sources import SyntheticSource as JSource
from vae_hmc_tpu_torch.core import align, artifacts
from vae_hmc_tpu_torch.core.config import SweepConfig, Workspace
from vae_hmc_tpu_torch.pipelines import medium
from vae_hmc_tpu_torch.pipelines.sources import SyntheticSource

torch.manual_seed(0)
torch.set_num_threads(1)

METRICS = {"silhouette", "davies_bouldin", "ari", "noise_frac", "score"}
CSV13 = ("medium_clustering_metrics_all.csv",)
CSV16 = ("medium_full_sweep_metrics.csv",
         "medium_full_sweep_best_by_representation.csv",
         "medium_full_sweep_best_overall.csv")


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def assert_csv_match(ours, ref):
    h, rows = _read_csv(ours)
    jh, jrows = _read_csv(ref)
    assert h == jh
    assert len(rows) == len(jrows)
    for r, j in zip(rows, jrows):
        for col, a, b in zip(h, r, j):
            if col in METRICS and a and b:
                assert float(a) == pytest.approx(float(b), abs=1e-4), (col, r, j)
            else:
                assert a == b, (col, r, j)


def test_artifact_writers_and_alignment_match_jax(tmp_path):
    rows = [[1, "a,b", 0.1, None], [2, 'say "hi"', np.float32(2.5), ""]]
    for tag in (None, "t1"):
        ours = artifacts.save_csv_rows(tmp_path / "o" / "x.csv",
                                       ["id", "s", "v", "e"], rows, tag=tag)
        ref = jart.save_csv_rows(tmp_path / "j" / "x.csv",
                                 ["id", "s", "v", "e"], rows, tag=tag)
        assert ours.read_bytes() == ref.read_bytes()
    assert (tmp_path / "o" / "x_t1.csv").read_bytes() == \
        (tmp_path / "j" / "x_t1.csv").read_bytes()
    assert artifacts.tagged_path("r/a.json", "b") == jart.tagged_path("r/a.json",
                                                                      "b")
    obj = {"n": np.int64(3), "f": np.float32(0.5), "a": np.arange(3)}
    assert artifacts.save_json(tmp_path / "o.json", obj).read_text() == \
        jart.save_json(tmp_path / "j.json", obj).read_text()
    artifacts.save_npy(tmp_path / "x.npy", np.arange(4.0), tag="k")
    np.save(tmp_path / "ids.npy", np.arange(3))
    with pytest.raises(ValueError, match="row mismatch"):
        artifacts.load_features(tmp_path / "x_k.npy", tmp_path / "ids.npy")
    primary = np.array([5, 3, "7", 9], dtype=object)
    secondary = np.array(["3", 7, 11])
    emb = np.arange(6.0).reshape(3, 2)
    for a, b in zip(align.align_secondary_to_primary(primary, secondary, emb),
                    jalign.align_secondary_to_primary(primary, secondary, emb)):
        np.testing.assert_array_equal(a, b)
    gmap = {3: "Rock", 7: "Pop"}
    np.testing.assert_array_equal(align.labels_for_ids(primary, gmap),
                                  jalign.labels_for_ids(primary, gmap))
    for a, b in zip(align.encode_labels(["b", "a", "b"]),
                    jalign.encode_labels(["b", "a", "b"])):
        np.testing.assert_array_equal(a, b)


def test_build_lyrics_embeddings_matches_jax(tmp_path, monkeypatch):
    """No MiniLM checkpoint anywhere: both packages take the hashed
    backend and write the same script-11 files."""
    monkeypatch.delenv("VAE_HMC_MINILM_DIR", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "no_hf_cache"))
    ws, jws = Workspace(tmp_path / "o"), JWorkspace(tmp_path / "j")
    ours = medium.build_lyrics_embeddings(SyntheticSource.make(60, seed=4),
                                          ws, device="cpu")
    ref = jmedium.build_lyrics_embeddings(JSource.make(60, seed=4), jws)
    assert ours["backend"] == ref["backend"] == "hashed"
    assert 0 < len(ours["ids"]) < 60          # short and missing texts skipped
    for name in ("lyrics_embeddings.npy", "lyrics_track_ids.npy"):
        np.testing.assert_array_equal(np.load(ws.data / name),
                                      np.load(jws.data / name))
    name = "lyrics_embedding_report.csv"
    assert (ws.results / name).read_bytes() == (jws.results / name).read_bytes()


@pytest.fixture(scope="module")
def csv_runs(tmp_path_factory):
    """Scripts 13 and 16 in both packages.  The port reads script 13's
    representations from .npy files (``_load_reps``) and shares them with
    script 16, as the pipeline chains them; the JAX package gets its
    RepData with the parity-rule-5 diagonal."""
    arrays, genre_map = sweep_data.reps_data()
    root = tmp_path_factory.mktemp("medium")
    ws, jws = Workspace(root / "o"), JWorkspace(root / "j")
    files = {"vae_mm_latents": ("vae_mm_latents_mu.npy",
                                "vae_mm_latents_track_ids.npy"),
             "baseline_mel_flat": ("audio_cnn_mel_X.npy",
                                   "audio_cnn_mel_track_ids.npy"),
             "baseline_lyrics_only": ("lyrics_embeddings.npy",
                                      "lyrics_track_ids.npy")}
    for name, (xf, idf) in files.items():
        x, ids = arrays[name]
        artifacts.save_npy(ws.data / xf, x)
        artifacts.save_npy(ws.data / idf, ids)
    reps = medium._load_reps(ws, genre_map, device="cpu")
    rows13 = medium.cluster_and_evaluate(ws, genre_map, 6, reps=reps)
    rows16 = medium.full_clustering_sweep(ws, genre_map, SweepConfig(),
                                          reps=reps)
    jreps = _jax_reps(arrays, genre_map)
    jmedium.cluster_and_evaluate(jws, genre_map, 6, reps=jreps)
    jmedium.full_clustering_sweep(jws, genre_map, JSweepConfig(), reps=jreps)
    return ws, jws, rows13, rows16


def assert_ranked_csv_match(ours, ref, all_rows, one_per_rep):
    """A file sorted by score: the scores agree position by position within
    atol 1e-4.  Rows whose scores tie within that tolerance (a perfect
    partition found by kmeans, ward and DBSCAN alike) may come in either
    order, and a tie at the top-20 cut may admit either cell, so each row
    must equal the row of its cell in `all_rows`, which assert_csv_match
    holds to the JAX package in order."""
    h, rows = _read_csv(ours)
    jh, jrows = _read_csv(ref)
    assert h == jh
    assert len(rows) == len(jrows)
    col = h.index("score")
    for r, j in zip(rows, jrows):
        assert float(r[col]) == pytest.approx(float(j[col]), abs=1e-4), (r, j)
    by_cell = {tuple(r[:3]): r for r in _read_csv(all_rows)[1]}
    for r in rows:
        assert r == by_cell[tuple(r[:3])]
    if one_per_rep:
        assert sorted(r[0] for r in rows) == sorted(j[0] for j in jrows)


@pytest.mark.parametrize("name", CSV13 + CSV16)
def test_csv_files_match_jax(csv_runs, name):
    ws, jws, rows13, rows16 = csv_runs
    assert len(rows13) == 21 and len(rows16) == 102
    if name in CSV16[1:]:
        assert_ranked_csv_match(ws.results / name, jws.results / name,
                                ws.results / CSV16[0],
                                one_per_rep=name == CSV16[1])
    else:
        assert_csv_match(ws.results / name, jws.results / name)


def test_pca_dim_is_not_ported_yet():
    """ops/pca is ported now: pca_dim reduces the representation (held to
    the JAX package in tests/test_torch_pca.py), and the name stays."""
    x = np.random.default_rng(0).normal(0, 1, (4, 3)).astype(np.float32)
    rep = medium._build_rep("r", x, np.arange(4), None, False, pca_dim=2,
                            device="cpu")
    assert tuple(rep.x_dev.shape) == (4, 2)
    assert tuple(rep.dists_dev.shape) == (4, 4)


def test_build_rep_standardizes_as_jax():
    arrays, genre_map = sweep_data.reps_data()
    x, ids = arrays["baseline_lyrics_only"]
    ref = jmedium._build_rep("r", x, ids, genre_map, standardize=True)
    for inp in (x, torch.from_numpy(x)):
        rep = medium._build_rep("r", inp, ids, genre_map, standardize=True,
                                device="cpu")
        np.testing.assert_allclose(rep.x_dev.numpy(), np.asarray(ref.x_dev),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(rep.y_true, ref.y_true)


def test_run_core_minilm_checkpoint_then_scripts_13_and_16(
        tmp_path, monkeypatch):
    """run_core's lyrics stage on a MiniLM checkpoint found through
    VAE_HMC_MINILM_DIR, then its tensors and corpus through scripts 11, 13
    and 16."""
    from tests.test_torch_minilm import _hf_state_dict, _write_checkpoint
    from vae_hmc_tpu_torch.pipelines.bench_chain import run_core
    from vae_hmc_tpu_torch.text.minilm import MiniLMConfig, corpus_vocab
    n = 40
    src = SyntheticSource.make(n, seed=42)
    # the checkpoint's vocab holds the corpus words, so texts embed apart
    cfg = MiniLMConfig()
    vocab = list(corpus_vocab([src.lyrics_text(i) or "" for i in range(n)],
                              cfg.vocab_size))
    vocab += [f"v{i}" for i in range(cfg.vocab_size - len(vocab))]
    ckpt = _write_checkpoint(tmp_path / "ckpt",
                             _hf_state_dict(cfg, np.random.default_rng(2)),
                             "pytorch_model.bin", vocab)
    monkeypatch.setenv("VAE_HMC_MINILM_DIR", str(ckpt))
    r = run_core(n_tracks=n, epochs=1, device="cpu", duration_s=1.0,
                 device_batch=16)
    assert r["lyrics_backend"] == "minilm-torch (real checkpoint)"
    t = r["tensors"]
    assert tuple(t["features"].shape) == (n, 128, 44, 1)
    assert tuple(t["lyrics_embedding"].shape) == (n, 384)
    assert tuple(t["mu"].shape) == (n, 32) and len(t["genre_codes"]) == n
    norms = torch.linalg.vector_norm(t["lyrics_embedding"], dim=1)
    has = norms > 0                         # tracks without lyrics are zeros
    torch.testing.assert_close(norms[has], torch.ones(int(has.sum())))
    assert math.isfinite(r["seconds_lyrics"])

    ws = Workspace(tmp_path / "ws")
    out = medium.scripts_11_13_16(r["source"], ws, t["mu"], t["features"],
                                  t["track_ids"], device="cpu")
    assert out["lyrics_backend"] == "minilm"
    reps, rows13, rows16 = out["reps"], out["rows13"], out["rows16"]
    assert [rep.name for rep in reps] == ["vae_mm_latents",
                                          "baseline_mel_flat",
                                          "baseline_lyrics_only"]
    assert reps[1].x_dev.shape == (n, 128 * 44)
    genre_map = {int(i): str(g) for i, g in zip(src.track_ids, src.genres)}
    for rep in reps:                 # genres of run_core's own corpus
        ids = t["track_ids"] if rep.name != "baseline_lyrics_only" else \
            np.load(ws.data / "lyrics_track_ids.npy")
        np.testing.assert_array_equal(rep.y_true,
                                      [genre_map[int(i)] for i in ids])
    assert sorted(out["seconds"]) == ["seconds_representations",
                                      "seconds_script13", "seconds_script16",
                                      "seconds_total"]
    assert len(rows13) == 21 and len(rows16) == 102
    for r in rows13 + rows16:
        if r["algo"] != "dbscan":
            assert -1.0 <= r["silhouette"] <= 1.0 and r["davies_bouldin"] > 0
            assert r["ari"] is not None
    for name in CSV13 + CSV16:
        assert (ws.results / name).exists()
