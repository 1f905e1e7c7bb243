"""One run of one cell: set-up, warm-up, the measured window, the traced
window's reading, the check of the outputs, and the result line.

The window runs the cell's job back to back.  A job starts only while the
mean job time so far says it ends by ``--seconds``; at least one runs.
The rate (each end-to-end metric in tracks/s) is the tracks of all
jobs over the wall time from the first job's start to the last job's end,
which ends in a synchronize.
``setup_s`` is the time from the process's first statement to the
window's start: imports, the kernels' build or load, the corpus and
weights on the device, and the warm-up of the cell's own shapes.
With ``trace=True`` the same window runs under ``torch.profiler`` and the
per-layer metrics are read from it, the spans and the job records.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch.profiler import record_function

from benchmark import imports, spec, trace as trace_mod

CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "TRITON_CACHE_DIR": "build/triton",
              "TORCHINDUCTOR_CACHE_DIR": "build/inductor"}
# the program's lookups that would reach outside the run's inputs
UNSET = ("VAE_HMC_MINILM_DIR", "VAE_HMC_QUALITY_STRICT",
         "VAE_HMC_GOLDENS_PATH", "BENCH_FAST", "BENCH_LYRICS",
         "BENCH_N_TRACKS")


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def prepare_environment(root: Path) -> None:
    """Caches at fixed paths inside the checkout; nothing from the caller's
    environment that changes what the program computes."""
    for key, rel in CACHE_DIRS.items():
        path = root / rel
        path.mkdir(parents=True, exist_ok=True)
        os.environ[key] = str(path)
    for key in UNSET:
        os.environ.pop(key, None)
    # MiniLM is the benchmark's own; the program finds no checkpoint
    os.environ["HF_HOME"] = str(root / "build" / "no_hf_home")


def card_line(dev: torch.device) -> str:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable ({e})"
    return f"{torch.cuda.get_device_name(dev)}; nvidia-smi: {smi}"


@dataclass
class Run:
    """What the per-layer metrics read."""
    cell: str
    dtype: str
    jobs: List[dict]
    window_s: float
    peak_bytes: int
    trace: Optional[trace_mod.Trace] = None


class Spans:
    """Benchmark spans of one device: a ``record_function`` range each,
    whose host seconds add to ``seconds[name]``; a stage ends in a
    synchronize."""

    def __init__(self, dev: torch.device):
        self.dev = dev

    @contextlib.contextmanager
    def stage(self, name: str, seconds: Dict[str, float]):
        with record_function(trace_mod.SPAN_PREFIX + name):
            t0 = time.perf_counter()
            yield
            _sync(self.dev)
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(job, seconds: float, dev: torch.device, spans: Spans):
    """The jobs of one window -> (records, window seconds)."""
    records: List[dict] = []
    with record_function(trace_mod.SPAN_PREFIX + trace_mod.WINDOW):
        _sync(dev)
        t0 = time.perf_counter()
        while True:
            t_job = time.perf_counter()
            records.append(job.run(spans))
            records[-1]["seconds"] = time.perf_counter() - t_job
            elapsed = time.perf_counter() - t0
            if elapsed + elapsed / len(records) > seconds:
                break
        _sync(dev)
        window_s = time.perf_counter() - t0
    return records, window_s


def end_to_end(metrics: List[dict], rate: float, setup_s: float
               ) -> Dict[str, dict]:
    """The cell's end-to-end metrics: ``setup_s``, and its rate of tracks
    (the one metric in tracks/s: cells whose runs spread alike share one,
    so each keeps a bound fit to its spread)."""
    out = {}
    for m in metrics:
        if m["name"] == "setup_s":
            out[m["name"]] = {"value": setup_s, "unit": m["unit"]}
        elif m["unit"] == "tracks/s":
            out[m["name"]] = {"value": rate, "unit": m["unit"]}
        else:
            raise ValueError(f"no reading for end-to-end metric {m['name']}")
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             dev: torch.device, t_start: float) -> Optional[dict]:
    """One run; -> the result dict, or None where a forbidden module was
    loaded (named on stderr)."""
    job = spec.job_module(cell.job).Job(cell.config, cell.workload, seed,
                                        dev)
    job.warm()
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")
    peak_setup = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    spans = Spans(dev)
    tr = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            records, window_s = window(job, seconds, dev, spans)
        tr = trace_mod.from_profiler(prof)
    else:
        records, window_s = window(job, seconds, dev, spans)
    peak_window = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    tracks = sum(r["tracks"] for r in records)
    log(f"window: {len(records)} jobs, {tracks} tracks in {window_s:.4f} s;"
        f" job seconds {[round(r['seconds'], 3) for r in records]};"
        " mean stage seconds " + json.dumps({
            k: sum(r["stages"].get(k, 0.0) for r in records) / len(records)
            for k in records[-1]["stages"]}))
    log("stage seconds by job: " + json.dumps(
        [{k: round(v, 3) for k, v in r["stages"].items()} for r in records]))
    found = imports.forbidden_loaded()
    if found:
        log(f"forbidden modules loaded: {found}")
        return None

    run = Run(cell=cell.name, dtype=cell.config["precision"], jobs=records,
              window_s=window_s, peak_bytes=peak_window, trace=tr)
    if trace:
        metrics = spec.read_metrics(cell.per_layer, run)
    else:
        metrics = end_to_end(cell.end_to_end, tracks / window_s, setup_s)
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": 1,
              "memory_peak_bytes": int(max(peak_setup, peak_window))}
    if tr is not None:
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s

    job.release()
    checks = job.check()
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    result = {"correct": correct, "attempted": len(records), "failed": 0,
              "metrics": metrics, "device": device}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs only on the card")
        return 2
    cell = spec.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    prepare_environment(spec.ROOT)
    dev = torch.device("cuda", 0)
    log(f"cell {cell.name}, seed {args.seed}, {args.seconds} s, "
        f"trace {args.trace}; card: {card_line(dev)}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev,
                      t_start)
    if result is None:
        return 3
    checks = result["checks"]
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr,
              flush=True)
    return 0
