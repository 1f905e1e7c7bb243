"""The port's benchmark entry point (``vae_hmc_tpu_torch.bench``), its goldens
and its tracing against the JAX package's ``bench.py``,
``core.goldens`` and ``tools/update_goldens.py``:

  - the JSON line has exactly the keys of the root bench.py's line, in its
    order (read from its AST by ``tests/torch_bench_keys``: importing
    bench.py would import JAX and enable its compile cache) and bench.py's
    mode strings;
  - ``extract_bench``, ``golden_key`` and ``check`` agree with the JAX
    package's on the same inputs (``ok``, ``drift`` past ``_rtol``,
    ``no-golden``, strict mode);
  - ``run_bench`` at 16 tracks, 1 epoch and 0.5 s clips for both lyrics
    backends and in the fast (bf16) mode;
  - ``tools/update_goldens`` writes an entry that ``check`` reads back ok,
    ``tools/certify_goldens`` applies the exact / band / no-entry rule and
    ``tools/cudnn_witness`` starts its runs under deterministic cuDNN;
  - ``core.profiling.device_trace`` writes a trace that holds an
    ``annotate`` range and a StageTimer stage.
"""
import ast
import functools
import json
import math
from pathlib import Path

import pytest
import torch

from tests.torch_bench_keys import bench_keys
from vae_hmc_tpu.core import goldens as jgoldens
from vae_hmc_tpu_torch import bench as tbench
from vae_hmc_tpu_torch.core import goldens
from vae_hmc_tpu_torch.core.profiling import StageTimer, annotate, device_trace
from vae_hmc_tpu_torch.pipelines import bench_chain
from vae_hmc_tpu_torch.tools import (certify_goldens, cudnn_witness,
                                     update_goldens)

ROOT = Path(__file__).resolve().parents[1]
RESULT = {"metric": "m", "n_tracks": 16, "train_final_loss": 0.4022,
          "silhouette": 0.44593, "davies_bouldin": 0.76893,
          "ari_vs_genre": 0.31527, "mode": "parity (f32 train)",
          "device": "cpu"}


def _bench_py():
    return ast.parse((ROOT / "bench.py").read_text())


def bench_py_modes() -> dict:
    """bench.py's `mode = "fast ..." if fast else "parity ..."`."""
    for node in ast.walk(_bench_py()):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == "mode" and \
                isinstance(node.value, ast.IfExp):
            return {True: node.value.body.value,
                    False: node.value.orelse.value}
    raise AssertionError("bench.py assigns no mode")


@pytest.fixture
def goldens_file(tmp_path, monkeypatch):
    path = tmp_path / "goldens.json"
    path.write_text("{}\n")
    monkeypatch.setenv("VAE_HMC_GOLDENS_PATH", str(path))
    monkeypatch.delenv("VAE_HMC_QUALITY_STRICT", raising=False)
    return path


def test_bench_py_key_set_is_read_from_its_ast():
    """The reader of the root bench.py's keys that chip_smoke.py phase 11
    shares."""
    keys = bench_keys()
    assert len(keys) == len(set(keys)) == 19
    assert keys[0] == "metric" and keys[-1] == "quality_drift"
    assert "pallas_smoke" in keys
    assert bench_py_modes() == tbench.MODES


def test_extract_bench_matches_jax():
    assert goldens.extract_bench(RESULT) == jgoldens.extract_bench(RESULT)
    partial = {"silhouette": "0.5", "davies_bouldin": None}
    assert goldens.extract_bench(partial) == jgoldens.extract_bench(partial)


@pytest.mark.parametrize("tier,mode", [("bench", "parity"), ("bench", "fast"),
                                       ("medium", "")])
def test_golden_key_matches_jax(tier, mode):
    assert goldens.golden_key(tier, 16, "cpu", mode) == \
        jgoldens.golden_key(tier, 16, mode)
    assert goldens.golden_key(tier, 16, "cuda", mode).split(":")[1] == "gpu"


def test_goldens_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("VAE_HMC_GOLDENS_PATH", raising=False)
    path = goldens.goldens_path()
    assert path == ROOT / "vae_hmc_tpu_torch" / "QUALITY_GOLDENS.json"
    assert all(":gpu:" in k for k in goldens.load_goldens(path)
               if not k.startswith("_"))


def test_check_reads_ok_drift_and_no_golden(goldens_file, monkeypatch):
    observed = goldens.extract_bench(RESULT)
    entry = {**observed, "_rtol": 1e-3}
    goldens_file.write_text(json.dumps({"bench:cpu:16:parity": entry}))
    near = goldens.extract_bench({**RESULT, "silhouette": 0.44593 * 1.0005})
    far = goldens.extract_bench({**RESULT, "silhouette": 0.44593 * 1.002})
    for obs, status in ((observed, "ok"), (near, "ok"), (far, "drift")):
        got = goldens.check("bench:cpu:16:parity", obs)
        assert got == jgoldens.check("bench:cpu:16:parity", obs)
        assert got["status"] == status
    assert goldens.check("bench:cpu:16:fast", observed)["status"] == \
        "no-golden"
    monkeypatch.setenv("VAE_HMC_QUALITY_STRICT", "1")
    with pytest.raises(RuntimeError, match="quality drift"):
        goldens.check("bench:cpu:16:parity", far)
    assert goldens.check("bench:cpu:16:parity", near)["status"] == "ok"


@pytest.mark.parametrize("backend,fast", [("hashed", False),
                                          ("minilm", False), ("minilm", True)])
def test_run_bench_small(goldens_file, tmp_path, monkeypatch, backend, fast):
    monkeypatch.delenv("VAE_HMC_MINILM_DIR", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "no_hf_cache"))
    seen = {}
    train = bench_chain.train_conv_mm_vae

    def spy(x, lyr, has, cfg, **kw):
        seen["cfg"] = cfg
        return train(x, lyr, has, cfg, **kw)

    monkeypatch.setattr(bench_chain, "train_conv_mm_vae", spy)
    r = tbench.run_bench(n_tracks=16, epochs=1, duration_s=0.5, device="cpu",
                         fast=fast, lyrics_backend=backend)
    assert list(r) == bench_keys()
    assert r["n_tracks"] == 16 and r["unit"] == "tracks/sec"
    assert r["mode"] == bench_py_modes()[fast]
    assert seen["cfg"].compute_dtype == ("bfloat16" if fast else "float32")
    assert seen["cfg"].epochs == 1 and seen["cfg"].seed == 42
    assert r["pallas_smoke"] == "skipped (cpu)" and r["device"] == "cpu"
    assert r["lyrics_backend"] == (
        "hashed" if backend == "hashed"
        else "minilm-torch (synthetic real-shaped weights)")
    assert r["quality_drift"] == "no-golden"
    for k in ("value", "vs_baseline", "seconds_total", "train_final_loss",
              "silhouette", "davies_bouldin", "ari_vs_genre"):
        assert math.isfinite(r[k]), k
    assert abs(r["vs_baseline"] - r["value"] / 5.0) <= 0.01
    assert -1.0 <= r["silhouette"] <= 1.0 and r["davies_bouldin"] > 0.0


def test_run_bench_reads_its_golden(goldens_file, monkeypatch):
    """A certified entry makes the same run read ok, a moved one drift (and
    strict mode raise)."""
    run = functools.partial(tbench.run_bench, n_tracks=16, epochs=1,
                            duration_s=0.5, device="cpu",
                            lyrics_backend="hashed")
    first = run()
    # a band: CPU reductions need not repeat bit for bit between runs
    goldens_file.write_text(json.dumps({"bench:cpu:16:parity": {
        **goldens.extract_bench(first), "_rtol": 1e-3}}))
    assert run()["quality_drift"] == "ok"
    moved = goldens.extract_bench({**first, "silhouette": 2.0})
    goldens_file.write_text(json.dumps({"bench:cpu:16:parity": {
        **moved, "_rtol": 1e-3}}))
    assert run()["quality_drift"].startswith("drift: headline.silhouette")
    monkeypatch.setenv("VAE_HMC_QUALITY_STRICT", "1")
    with pytest.raises(RuntimeError, match="quality drift"):
        run()


def test_run_bench_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbench.run_bench(n_tracks=16)


def _easy_results(root: Path) -> Path:
    """A results/ dir with compare_metrics/metrics.csv of 2 rows."""
    path = root / "results" / "compare_metrics" / "metrics.csv"
    path.parent.mkdir(parents=True)
    path.write_text("method,input,input_dim,k,silhouette,calinski_harabasz,"
                    "pca_variance\n"
                    "VAE+KMeans,VAE latents,16,5,0.25,408.3,\n"
                    "PCA(16)+KMeans,MFCC features (80D),80,5,0.3265,580.9,"
                    "0.8514\n")
    return root / "results"


@pytest.mark.parametrize("rtol", [None, 2e-3])
@pytest.mark.parametrize("source", ["bench", "bench-card", "tier"])
def test_update_goldens_writes_what_check_reads(goldens_file, tmp_path,
                                                capsys, source, rtol):
    """A bench key's platform comes from the line's ``device``: "cpu" or
    the card's name."""
    extra = [] if rtol is None else ["--rtol", str(rtol)]
    if source.startswith("bench"):
        card = source == "bench-card"
        result = {**RESULT, "device": "NVIDIA H100 80GB HBM3"} if card \
            else RESULT
        line = tmp_path / "bench.json"
        line.write_text("[progress]\n" + json.dumps(result) + "\n")
        args = ["--bench", str(line)]
        key = f"bench:{'gpu' if card else 'cpu'}:16:parity"
        observed = goldens.extract_bench(result)
    else:
        results = _easy_results(tmp_path)
        args = ["--tier", "easy", "--results", str(results), "--n", "2924"]
        key, observed = "easy:gpu:2924", goldens.extract_easy(results)
    assert update_goldens.main(args + extra + ["--dry-run"]) == 0
    assert json.loads(goldens_file.read_text()) == {}
    assert update_goldens.main(args + extra) == 0
    assert f"[{key}]" in capsys.readouterr().out
    entry = json.loads(goldens_file.read_text())[key]
    assert entry.get("_rtol") == rtol
    assert {k: v for k, v in entry.items() if k != "_rtol"} == observed
    assert goldens.check(key, observed)["status"] == "ok"
    assert jgoldens.check(key, observed)["status"] == "ok"


def test_device_trace_holds_annotate_ranges(tmp_path):
    timer = StageTimer()
    with device_trace(tmp_path / "trace") as prof:
        with annotate("bench:probe"):
            torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
        with timer.stage("probe_stage"):
            torch.ones(8).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"bench:probe", "vae:stage.probe_stage"} <= names
    traces = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert {"bench:probe", "vae:stage.probe_stage"} <= {e.get("name")
                                                     for e in events}


def test_cudnn_witness_launcher_sets_the_flag_and_runs_the_cli(monkeypatch):
    """tools/cudnn_witness starts the CLI with deterministic cuDNN and
    cuDNN's autotuner off, through certify_goldens's runs."""
    import runpy
    seen = {}

    def run_module(name, run_name, alter_sys):
        seen.update(name=name, run_name=run_name, alter_sys=alter_sys,
                    deterministic=torch.backends.cudnn.deterministic,
                    benchmark=torch.backends.cudnn.benchmark)

    monkeypatch.setattr(runpy, "run_module", run_module)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    flag, code = cudnn_witness.LAUNCHER
    assert flag == "-c"
    exec(code, {})
    assert seen == {"name": "vae_hmc_tpu_torch.cli", "run_name": "__main__",
                    "alter_sys": True, "deterministic": True,
                    "benchmark": False}
    assert certify_goldens._command("medium", Path("w"),
                                    cudnn_witness.LAUNCHER)[1:] == [
        "-c", code, "run-medium", "--synthetic", "2924", "--root", "w"]


@pytest.mark.parametrize("silhouettes,verdict,rtol", [
    ((0.4, 0.4, 0.4), "exact", None),
    ((0.4, 0.4004, 0.4002), "band", 2e-3),
    ((0.4, 0.5, 0.45), "not certified", None)])
def test_certify_rule(silhouettes, verdict, rtol):
    """tools/certify_goldens: all runs equal -> exact; a widest relative
    spread of at most 1% -> a band of twice it; wider -> no entry."""
    runs = [{"observed": goldens.extract_bench({**RESULT, "silhouette": v}),
             "seconds": 1.0, "stages": {}} for v in silhouettes]
    s = certify_goldens.summarize(runs)
    assert s["verdict"] == verdict and s["runs"] == 3
    if rtol is None:
        assert s["rtol"] is None
    else:
        assert s["rtol"] == pytest.approx(rtol, rel=1e-3)
    if verdict != "exact":          # the median run, nearest every column
        assert s["widest_cell"] == "headline.silhouette"
        assert s["certify_from_run"] == sorted(
            range(3), key=lambda i: silhouettes[i])[1]
