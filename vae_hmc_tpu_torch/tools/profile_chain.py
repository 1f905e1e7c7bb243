"""Where the time goes on the GPU: the main path and the three tiers.

    python -m vae_hmc_tpu_torch.tools.profile_chain

Runs ``run_core`` (the medium tier's 2,924 tracks, 1 epoch, MiniLM
lyrics on synthetic real-shaped weights, as ``chip_smoke.py`` phase 3) once
to warm up (library loads, cuDNN heuristics, the kernels' build, the first
optimizer's imports) and prints its stage seconds, the cold ones; then runs it again
under ``torch.profiler`` with CPU and CUDA activity and prints, for that
warm run: the stage seconds; host ops by self time; each stage's device
time (the device activity inside its ``vae:stage.*`` span); the device
time of the copies the profiler draws for the program's innermost ranges
(``vae:model.deconv``: the decoder's phase-form deconv forwards); the
device's busy time and idle share over the run; and device time by
kernel.  Then, with the same breakdown, the medium tier's scripts 11, 13
and 16 on that run's tensors (``pipelines.medium.scripts_11_13_16``, as
``chip_smoke.py`` phase 4); and the whole medium tier, ``run_medium_pipeline`` at the same
size (as ``chip_smoke.py`` phase 5), by the stages of its
``timing_medium.json``, with its peak device memory.  Then the easy and
hard tiers, ``run_easy_pipeline`` and ``run_hard_pipeline`` at 2,924
tracks with their full configs (as ``chip_smoke.py`` phases 6 and 7: the
first run of each tier in the process, after the parts before it), with
the same breakdown by the stages of ``timing_easy.json`` and
``timing_hard.json``.  Needs a GPU.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import tempfile

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vae_hmc_tpu_torch.core import profiling
from vae_hmc_tpu_torch.core.config import ConvMMVaeConfig, Workspace
from vae_hmc_tpu_torch.core.device import resolve_device
from vae_hmc_tpu_torch.ops.kernels import build
from vae_hmc_tpu_torch.pipelines import easy, hard, medium
from vae_hmc_tpu_torch.pipelines.bench_chain import run_core
from vae_hmc_tpu_torch.pipelines.sources import SyntheticSource

N_TRACKS = 2924
EPOCHS = 1
TOP = 25                     # rows of each ranking
# device functions of csrc/logmel.cu and csrc/distance.cu
PORT_KERNELS = ("mel_db_cluster", "pairwise_tile", "reduce_slices")
STAGE_SPAN = profiling.SPAN_PREFIX + "stage."    # StageTimer's spans
STAGE_KEYS = ("seconds_features", "seconds_lyrics", "seconds_train",
              "seconds_cluster_metrics", "seconds_total")


def _union_us(intervals, lo=float("-inf"), hi=float("inf")) -> float:
    """Length of the union of sorted (start, end) intervals within [lo, hi]."""
    total, end = 0.0, lo
    for s, e in intervals:
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
        end = max(end, e)
    return total


def main() -> None:
    dev = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    _core_and_scripts_11_13_16(dev)
    _profile_tier(dev, "medium", lambda ws: medium.run_medium_pipeline(
        SyntheticSource.make(N_TRACKS, seed=42), ws,
        vae_cfg=dataclasses.replace(ConvMMVaeConfig(), epochs=EPOCHS),
        device_batch=128, device=dev))
    _profile_tier(dev, "easy", lambda ws: easy.run_easy_pipeline(
        SyntheticSource.make(N_TRACKS, seed=42), ws, device=dev))
    _profile_tier(dev, "hard", lambda ws: hard.run_hard_pipeline(
        SyntheticSource.make(N_TRACKS, seed=42), ws, device=dev))


def _core_and_scripts_11_13_16(dev) -> None:
    cold = run_core(n_tracks=N_TRACKS, epochs=EPOCHS, device=dev)
    print("warm-up (cold) run:", json.dumps({k: cold[k] for k in STAGE_KEYS}))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run_core(n_tracks=N_TRACKS, epochs=EPOCHS, device=dev)
    _report(prof, {k: res[k] for k in STAGE_KEYS}, res["launches"],
            res["seconds_total"], TOP)
    with tempfile.TemporaryDirectory() as root, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        build.reset_launch_counts()
        t = res["tensors"]
        out = medium.scripts_11_13_16(res["source"], Workspace(root), t["mu"],
                                      t["features"], t["track_ids"],
                                      device=dev)
    _report(prof, out["seconds"], build.launch_counts(),
            out["seconds"]["seconds_total"], TOP)


def _profile_tier(dev, name: str, run) -> None:
    """run(workspace) -> the tier runner's result, under the profiler, into
    a temporary workspace; its peak device memory and the breakdown."""
    torch.cuda.empty_cache()      # the earlier parts' tensors are released
    with tempfile.TemporaryDirectory() as root, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        out = run(Workspace(root))
    print(f"run_{name}_pipeline: peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    _report(prof, out["timing"]["seconds"], build.launch_counts(),
            out["timing"]["total_seconds"], TOP)


def _report(prof, seconds, launches, wall_s: float, top: int) -> None:
    print("profiled run:", json.dumps(seconds))
    print("launches:", json.dumps(launches))
    print("host ops by self time:")
    for e in _host_ops(prof.key_averages())[:top]:
        print(f"  {e.self_cpu_time_total / 1e3:10.3f} ms  {e.count:6d} calls  "
              f"{e.key[:100]}")

    events = prof.events()
    dev_events = _device_events(events)
    dev_iv = sorted((e.time_range.start, e.time_range.end)
                    for e in dev_events)
    # a stage's device time is the device activity inside its wall window
    # (each stage ends with a synchronize; backward kernels are launched from
    # autograd's own thread, so they are not children of the stage range)
    for e in events:
        if (e.name.startswith(STAGE_SPAN)
                and e.device_type != DeviceType.CUDA):
            lo, hi = e.time_range.start, e.time_range.end
            print(f"{e.name}: wall {(hi - lo) / 1e3:.3f} ms, device busy "
                  f"{_union_us(dev_iv, lo, hi) / 1e3:.3f} ms")
    print("device copies of the program's ranges (innermost range a launch):")
    for name, (t, n) in sorted(_range_copies(events).items(),
                               key=lambda kv: -kv[1][0]):
        print(f"  {t / 1e3:10.3f} ms  {n:6d} copies  {name}")
    busy_us = _union_us(dev_iv)
    wall_us = wall_s * 1e6
    print(f"device busy {busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
          f"wall: idle share {1.0 - busy_us / wall_us:.4f}")
    by_name = {}
    for e in dev_events:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :top]:
        print(f"  {t / 1e3:10.3f} ms  {n:6d} calls  {name[:110]}")
    print("this package's CUDA kernels:")
    for name, (t, n) in sorted(by_name.items()):
        if any(k in name for k in PORT_KERNELS):
            print(f"  {t / 1e3:10.3f} ms  {n:6d} calls  {name[:110]}")


def _host_ops(averages) -> list:
    """The host ops of `averages` with self time, the most first; not the
    program's ranges (``vae:*``), which are no ops."""
    host = [e for e in averages if e.self_cpu_time_total > 0
            and not e.key.startswith(profiling.SPAN_PREFIX)]
    return sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)


def _range_copies(events) -> dict:
    """{name: (device us, copies)} of the copies the profiler draws on the
    device timeline for the program's ranges (``vae:*``).  It draws one only
    for the innermost range open around a launch, so a range with ranges
    inside (``fit.step``) counts only its own launches, and one with none
    (``model.deconv``) all of them."""
    drawn = {}
    for e in events:
        if (e.device_type == DeviceType.CUDA
                and e.name.startswith(profiling.SPAN_PREFIX)):
            t, n = drawn.get(e.name, (0.0, 0))
            drawn[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    return drawn


def _device_events(events) -> list:
    """Device activity: kernels, copies and fills.  Not the copies the
    profiler draws on the device timeline of host ranges (the program's
    ``vae:*``, the optimizer's), which carry a host event's name
    and span the kernels launched inside the range and the gaps between
    them; nor the launch queue's "Command Buffer Full"."""
    host = {e.name for e in events if e.device_type != DeviceType.CUDA}
    return [e for e in events if e.device_type == DeviceType.CUDA
            and e.name not in host and e.name != "Command Buffer Full"]


if __name__ == "__main__":
    main()
