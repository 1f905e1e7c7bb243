"""Repeated timings of kernel 2, to tell a slow reading from noise.

    python -m vae_hmc_tpu_torch.tools.kernel2_repeat [--phases 3] [--readings 20]

Run from the repository's root (it imports ``chip_smoke``).  Builds the
kernels, runs ``chip_smoke.py``'s phase 2 (kernel 2 against its plain
version at every main-path shape, then its timings) `phases` times in one
process, and then takes `readings` more timings of the split-d path at
(256, 82,688) alone, each ``chip_smoke.time_ms``'s replay of a CUDA graph
of 10 calls: one after a (2924, 32) ``torch.cdist`` timing, as in phase 2,
and one straight after the previous reading.  The last line is one JSON
object of every reading.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import json

import torch

import chip_smoke
from vae_hmc_tpu_torch.ops.kernels.distance import pairwise_dists


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", type=int, default=3)
    ap.add_argument("--readings", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    chip_smoke.phase_identify_and_build()
    rows = chip_smoke.script11_rows()
    phase2 = []
    for _ in range(args.phases):
        r = chip_smoke.phase_distance(dev, rows)
        phase2.append({k: r[k] for k in ("ms", "mel_flat_ms",
                                          "sweep_cache_ms")})
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    xf = torch.randn((256, 82688), generator=gen, device=dev)
    xf = (xf - xf.mean(dim=0, keepdim=True)).contiguous()
    xs = torch.randn((2924, 32), generator=gen, device=dev)
    after_cdist, back_to_back = [], []
    for _ in range(args.readings):
        chip_smoke.time_ms(lambda: torch.cdist(xs, xs), reps=200)
        after_cdist.append(chip_smoke.time_ms(lambda: pairwise_dists(xf),
                                              reps=10))
        back_to_back.append(chip_smoke.time_ms(lambda: pairwise_dists(xf),
                                               reps=10))
    for name, vals in (("after cdist", after_cdist),
                       ("back to back", back_to_back)):
        print(f"split path (256, 82688), {name}: "
              + " ".join(f"{v:.4f}" for v in vals), flush=True)
    print(json.dumps({"phase2": phase2, "split_after_cdist_ms": after_cdist,
                      "split_back_to_back_ms": back_to_back}), flush=True)


if __name__ == "__main__":
    main()
