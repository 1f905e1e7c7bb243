"""``python -m vae_hmc_tpu_torch.cli`` against ``vae_hmc_tpu.cli``: the same
subcommands, flags and defaults (``--device`` the only addition), the same
files from ``prepare-hard`` and ``train-basic-vae`` on a WAV corpus, and
the device rule and the two commands not ported yet."""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_audio_data import corpus_rows
from vae_hmc_tpu import cli as jcli
from vae_hmc_tpu.pipelines import features as jfeatures
from vae_hmc_tpu_torch import cli as tcli
from vae_hmc_tpu_torch.core.manifest import write_manifest
from vae_hmc_tpu_torch.pipelines import features as tfeatures

ROOT = Path(__file__).resolve().parents[1]


class _Captured(Exception):
    pass


def _jax_parser(monkeypatch) -> argparse.ArgumentParser:
    """The JAX CLI builds its parser inside main(): catch it at parse."""
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Captured

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Captured):
        jcli.main(["bench"])
    monkeypatch.undo()
    return seen["parser"]


def _surface(parser: argparse.ArgumentParser):
    """{subcommand: {flag: (dest, default, type, choices, required, nargs,
    action)}}."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    out = {}
    for name, p in sub.choices.items():
        flags = {}
        for a in p._actions:
            if isinstance(a, argparse._HelpAction):
                continue
            for opt in a.option_strings:
                flags[opt] = (a.dest, a.default, a.type, a.choices,
                              a.required, a.nargs, type(a).__name__)
        out[name] = flags
    return out


def test_parser_surface_matches_jax(monkeypatch):
    want = _surface(_jax_parser(monkeypatch))
    got = _surface(tcli.build_parser())
    assert len(want) == 28 and sorted(got) == sorted(want)
    for cmd, flags in got.items():
        assert flags.pop("--device") == ("device", "cuda", str, None, False,
                                         None, "_StoreAction"), cmd
        assert flags == want[cmd], cmd


def test_help_lists_the_same_subcommands(capsys):
    with pytest.raises(SystemExit):
        jcli.main(["--help"])
    jhelp = capsys.readouterr().out
    out = subprocess.run([sys.executable, "-m", "vae_hmc_tpu_torch.cli",
                          "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr

    def commands(text):
        line = next(ln for ln in text.splitlines() if ln.strip().startswith("{"))
        return line.strip().strip("{}").split(",")

    assert commands(out.stdout) == commands(jhelp)
    assert len(commands(out.stdout)) == 28


def test_cuda_by_default_raises_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        tcli.main(["run-hard", "--synthetic", "6", "--root", str(tmp_path)])
    assert not (tmp_path / "data").exists()


def test_bench_and_fast_exit_non_zero(capsys, tmp_path):
    """bench exits non-zero until the port has a benchmark.  (Its other
    half, run-medium --fast, now trains in bf16:
    test_run_medium_fast_trains_bf16_with_float32_weights.)"""
    assert tcli.main(["bench"]) != 0
    assert "Queue 1 item 2" in capsys.readouterr().err
    assert not (tmp_path / "data").exists()


def test_run_medium_fast_trains_bf16_with_float32_weights(capsys, tmp_path):
    """run-medium --fast: the whole tier at a tiny size with the conv VAE
    trained in bf16 (the config says so), the NON-PARITY warning on
    stderr, float32 master weights in the checkpoint, the file contract."""
    assert tcli.main(["run-medium", "--fast", "--device", "cpu",
                      "--synthetic", "6", "--duration", "1.0", "--epochs",
                      "2", "--root", str(tmp_path)]) == 0
    out = capsys.readouterr()
    assert "NON-PARITY" in out.err and "--fast" in out.err
    assert "medium pipeline complete" in out.out
    res = tmp_path / "results"
    for rel in ("data/audio_cnn_mel_X.npy", "data/lyrics_embeddings.npy",
                "results/timing_medium.json",
                "results/report_medium/best_filtered.csv"):
        assert (tmp_path / rel).exists(), rel
    assert len((res / "medium_clustering_metrics_all.csv").read_text()
               .strip().split("\n")) == 22
    assert len((res / "medium_full_sweep_metrics.csv").read_text()
               .strip().split("\n")) == 103
    log = (res / "vae_conv_mm_medium/train_log.csv").read_text().split()
    assert log[0] == "epoch,loss,recon,kl" and len(log) == 3
    mu = np.load(tmp_path / "data/vae_mm_latents_mu.npy")
    assert mu.shape == (6, 32) and mu.dtype == np.float32
    assert np.isfinite(mu).all()
    ckpt = res / "vae_conv_mm_medium/ckpt_epoch_002.pt"
    meta = json.loads(Path(str(ckpt) + ".meta.json").read_text())
    assert meta["config"]["compute_dtype"] == "bfloat16"
    with np.load(ckpt) as z:
        assert len(z.files) == 32
        assert {z[k].dtype for k in z.files} == {np.dtype(np.float32)}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_corpus")
    write_manifest(root / "data" / "manifest.csv",
                   corpus_rows(root, seconds=1.5, short={3: 0.6}))
    return root


def _link_corpus(corpus: Path, ws: Path) -> Path:
    """A workspace of its own: the corpus's audio and text linked, its
    manifest copied (outputs land in ws/data and ws/results)."""
    (ws / "data").mkdir(parents=True)
    for d in ("audio", "text"):
        (ws / d).symlink_to(corpus / d)
    (ws / "data" / "manifest.csv").write_bytes(
        (corpus / "data" / "manifest.csv").read_bytes())
    return ws


def _spy(monkeypatch, module, reports):
    real = module.build_mfcc_stats

    def spy(*a, **k):
        out = real(*a, **k)
        reports.append(out[2].rows)
        return out

    monkeypatch.setattr(module, "build_mfcc_stats", spy)


def _run_both(monkeypatch, corpus, tmp_path, argv):
    """argv through both CLIs, each in its own workspace that links the
    corpus; -> (port root, JAX root, port reports, JAX reports)."""
    monkeypatch.setenv("VAE_HMC_NO_COMPILE_CACHE", "1")
    roots, reports = [], []
    for name, cli, module, extra in (
            ("port", tcli, tfeatures, ["--device", "cpu"]),
            ("jax", jcli, jfeatures, [])):
        rep = []
        _spy(monkeypatch, module, rep)
        ws = _link_corpus(corpus, tmp_path / name)
        assert cli.main([*argv, "--root", str(ws), "--manifest",
                         "data/manifest.csv", *extra]) == 0
        roots.append(ws)
        # audio paths relative to the workspace, which differs
        reports.append([[(t, p.replace(str(ws), "<root>"), s, r)
                         for t, p, s, r in rows] for rows in rep])
    return roots[0], roots[1], reports[0], reports[1]


def test_prepare_hard_matches_jax_cli(monkeypatch, corpus, tmp_path):
    t, j, trep, jrep = _run_both(monkeypatch, corpus, tmp_path, [
        "prepare-hard", "--duration", "1.5", "--device-batch", "5"])
    assert trep == jrep and len(trep) == 1
    assert trep[0][1][1] == "<root>/audio/501.wav"      # a "\\" path
    status = {r[0]: r[2] for r in trep[0]}
    assert status[999] == "error" and status[503] == "skipped"
    td, jd = t / "data" / "hard", j / "data" / "hard"
    np.testing.assert_array_equal(np.load(td / "track_ids.npy"),
                                  np.load(jd / "track_ids.npy"))
    assert len(np.load(td / "track_ids.npy")) == 11
    np.testing.assert_allclose(np.load(td / "audio_mfcc_stats.npy"),
                               np.load(jd / "audio_mfcc_stats.npy"),
                               atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(np.load(td / "lyrics_emb.npy"),
                               np.load(jd / "lyrics_emb.npy"), atol=1e-6)
    assert (td / "hard_metadata.csv").read_bytes() == \
        (jd / "hard_metadata.csv").read_bytes()
    assert json.loads((td / "build_info.json").read_text()) == \
        json.loads((jd / "build_info.json").read_text())


def test_train_basic_vae_matches_jax_cli(monkeypatch, corpus, tmp_path):
    t, j, trep, jrep = _run_both(monkeypatch, corpus, tmp_path, [
        "train-basic-vae", "--duration", "1.0", "--epochs", "2",
        "--batch-size", "6", "--latent-dim", "4", "--device-batch", "8"])
    assert trep == jrep and len(trep) == 1
    blob_t = np.load(t / "results/vae_basic/mfcc_features_cache.npy",
                     allow_pickle=True).item()
    blob_j = np.load(j / "results/vae_basic/mfcc_features_cache.npy",
                     allow_pickle=True).item()
    np.testing.assert_array_equal(blob_t["track_ids"], blob_j["track_ids"])
    assert blob_t["X"].shape == (12, 80)
    np.testing.assert_allclose(blob_t["X"], blob_j["X"], atol=1e-3, rtol=1e-5)
    mu = np.load(t / "results/vae_basic/latent_mu.npy")
    assert mu.shape == (12, 4) and np.isfinite(mu).all()


def test_synthetic_audio_source_keeps_manifest_rows(monkeypatch, corpus,
                                                    tmp_path):
    """--synthetic-audio: the manifest's ids, genres and text coverage with
    synthesized waveforms (no decode errors: every row is kept)."""
    t, j, trep, jrep = _run_both(monkeypatch, corpus, tmp_path, [
        "prepare-hard", "--synthetic-audio", "--duration", "1.5",
        "--device-batch", "8"])
    assert trep == jrep
    td, jd = t / "data" / "hard", j / "data" / "hard"
    for name in ("track_ids.npy", "genre_idx.npy", "lang_idx.npy"):
        np.testing.assert_array_equal(np.load(td / name), np.load(jd / name))
    assert len(np.load(td / "track_ids.npy")) == 13
    assert (td / "hard_metadata.csv").read_bytes() == \
        (jd / "hard_metadata.csv").read_bytes()
