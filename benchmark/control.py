"""The control and the planted faults of a cell, at the cell's own size.

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...]

For each seed, one JSON line of the readings that the cell's check would
give (see the job module's ``control_readings``): the plain reference in
TF32 put in the program's place, and each fault the cell can have.  The
benchmark's own runs never run this; it sets the upper readings that the
limits in ``workloads/<cell>.json`` lie under.  Runs only on the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import harness, spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("no CUDA device: the control runs only on the card")
        return 2
    cell = spec.load_cell(args.workload)
    harness.prepare_environment(spec.ROOT)
    dev = torch.device("cuda", 0)
    harness.log(f"control of {cell.name}; card: {harness.card_line(dev)}")
    job = spec.job_module(cell.job)
    for seed in args.seeds:
        t0 = time.perf_counter()
        readings = job.control_readings(cell.config, seed, dev)
        print(json.dumps({"cell": cell.name, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "readings": readings}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
