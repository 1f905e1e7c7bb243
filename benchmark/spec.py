"""Finding a cell's pieces by name.

``BENCHMARK.json`` (at the checkout's root) lists the cells, their
configurations and the metrics.  Everything else is found by name:

- the cell's traffic and checks: ``benchmark/workloads/<cell>.json``, which
  names its ``job`` kind, its ``traffic`` parameters and the ``limits`` of
  the numbers its check compares;
- the configuration: the ``file`` that ``BENCHMARK.json`` gives it;
- the job kind: the module ``benchmark.jobs.<job>``;
- a per-layer metric: the file ``benchmark/metrics/<metric>.py``, whose
  ``read(run)`` returns the value, or None where it finds nothing to read
  (a quantity that moves another end-to-end metric in another cell has a
  name of its own there, as ``train_s.dp4`` would).

A cell, configuration or metric is added by adding its files and its
entries in ``BENCHMARK.json``; no existing file changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict                 # the configuration file's contents
    workload: dict               # workloads/<cell>.json
    end_to_end: List[dict]       # the cell's end-to-end metrics
    per_layer: List[dict]        # the cell's per-layer metrics

    @property
    def job(self) -> str:
        return self.workload["job"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, bench_dir: Path = HERE) -> Cell:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {sorted(cells)})")
    entry = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"]).read_text())
    workload = json.loads((bench_dir / "workloads" / f"{name}.json")
                          .read_text())
    if workload["config"] != entry["config"]:
        raise ValueError(f"{name}: workload file names config "
                         f"{workload['config']!r}, BENCHMARK.json "
                         f"{entry['config']!r}")
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                workload=workload,
                end_to_end=[m for m in manifest["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in manifest["per_layer"]
                           if _reports(m, name)])


def job_module(job: str):
    return importlib.import_module(f"benchmark.jobs.{job}")


def metric_reader(metric: str) -> Callable[[object], Optional[float]]:
    """``read`` of ``metrics/<metric>.py``, loaded from its file (a name
    may hold dots, as ``train_s.dp4``)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(metrics: List[dict], run) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of each metric whose reader found
    something to read."""
    out = {}
    for m in metrics:
        value = metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
