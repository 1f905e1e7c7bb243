"""How far UMAP's sparse spectral init moves under last-bit changes, on the
CPU and on the GPU: the readings behind the limits of
``tests/test_torch_cuda.py::test_umap_on_gpu``.

    python -m vae_hmc_tpu_torch.tools.umap_init_spread [--repeats 20]

The input is that test's 4 x 1 rectangle (120 points, k = 10, a fixed
(120, 10) start block).  Printed, each as the largest absolute difference:

  * CPU: the init after every edge weight is moved by one ulp (all up, all
    down, and random halves up) against the init of the unmoved weights;
  * GPU: kernel 2's distances against the plain version's on the CPU;
  * GPU: the graph stages (kNN distances, rho, sigma, edge weights) from
    the CPU's distance matrix, and from kernel 2's, against the CPU's;
  * GPU: the init from the CPU's edge list, and the init of the card's own
    chain (kernel 2 -> kNN -> edge list -> init), each run `repeats` times
    (``index_add_``'s atomics add in a new order each run), against the
    CPU's init, and the spread of the card's runs among themselves.

The last line is one JSON object of the maxima.  The GPU readings need a
CUDA device; without one only the CPU's are printed.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from vae_hmc_tpu_torch.metrics.internal import center
from vae_hmc_tpu_torch.ops.kernels.distance import (pairwise_dists,
                                                    pairwise_dists_plain)
from vae_hmc_tpu_torch.viz import umap

N, K = 120, 10


def rectangle():
    """(x (120, 4), q0 (120, 10)) as in the test: a 4 x 1 rectangle plus two
    small noise dimensions, and the start block."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(0, 1, (N, 2)) * [4.0, 1.0],
                        0.05 * rng.normal(0, 1, (N, 2))], axis=1)
    q0 = rng.normal(0, 1, (N, K))
    return (torch.from_numpy(x.astype(np.float32)),
            torch.from_numpy(q0.astype(np.float32)))


def stages(d: torch.Tensor):
    """(N, N) distances -> [knn_d, knn_i, rho, sigma, heads, tails, w]."""
    knn_d, knn_i = umap._knn_from_dists(d, K)
    rho, sigma = umap._smooth_knn(knn_d)
    return [knn_d, knn_i, rho, sigma, *umap._edge_weights(knn_d, knn_i, rho,
                                                          sigma)]


def init(h, t, w, q0) -> torch.Tensor:
    return umap._spectral_init_sparse(h, t, w, N, q0=q0.to(w)).cpu()


def signed_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| with each column's sign matched to want's."""
    got = got * torch.sign(torch.sum(got * want, dim=0))
    return float((got - want).abs().max())


def max_gap(got, want) -> float:
    return float((got.cpu().double() - want.cpu().double()).abs().max())


def nudged(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """w with the positive weights under `mask` moved up by one ulp."""
    up = torch.nextafter(w, torch.full_like(w, float("inf")))
    return torch.where(mask & (w > 0), up, w)


def cpu_readings(x, q0) -> dict:
    s = stages(pairwise_dists_plain(center(x, x.device)))
    h, t, w = s[4:]
    base = init(h, t, w, q0)
    moves = {"all_up": signed_gap(init(h, t, nudged(w, w > 0), q0), base)}
    down = torch.nextafter(w, torch.zeros_like(w))
    moves["all_down"] = signed_gap(init(h, t, torch.where(w > 0, down, w),
                                        q0), base)
    for seed in range(8):
        g = torch.Generator().manual_seed(seed)
        mask = torch.rand(w.shape, generator=g) < 0.5
        moves[f"half_up_{seed}"] = signed_gap(init(h, t, nudged(w, mask), q0),
                                              base)
    return {"stages": s, "init": base, "ulp_moves": moves}


def gpu_readings(x, q0, cpu: dict, repeats: int) -> dict:
    dev = torch.device("cuda")
    xc = center(x.to(dev), dev)
    d_gpu = pairwise_dists(xc)
    d_cpu = pairwise_dists_plain(center(x, x.device))
    out = {"kernel2_vs_plain": max_gap(d_gpu, d_cpu)}
    names = ("knn_d", "knn_i", "rho", "sigma", "heads", "tails", "w")
    for label, d in (("same_d", d_cpu.to(dev)), ("own_d", d_gpu)):
        for name, got, want in zip(names, stages(d), cpu["stages"]):
            key = f"{label}_{name}"
            out[key] = (bool(torch.equal(got.cpu(), want))
                        if want.dtype == torch.int64 else max_gap(got, want))
    h, t, w = (v.to(dev) for v in cpu["stages"][4:])
    from_cpu_edges = [init(h, t, w, q0) for _ in range(repeats)]
    own = []
    for _ in range(repeats):
        s = stages(pairwise_dists(center(x.to(dev), dev)))
        own.append(init(*s[4:], q0))
    for label, runs in (("init_cpu_edges", from_cpu_edges),
                        ("init_own_chain", own)):
        gaps = [signed_gap(r, cpu["init"]) for r in runs]
        out[f"{label}_vs_cpu"] = gaps
        out[f"{label}_spread"] = max(signed_gap(r, runs[0]) for r in runs)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args()
    x, q0 = rectangle()
    cpu = cpu_readings(x, q0)
    summary = {"cpu_ulp_moves": cpu["ulp_moves"],
               "cpu_ulp_move_max": max(cpu["ulp_moves"].values())}
    print("CPU, init after one-ulp moves of the edge weights:",
          json.dumps(cpu["ulp_moves"]), flush=True)
    if torch.cuda.is_available():
        g = gpu_readings(x, q0, cpu, args.repeats)
        for key, val in g.items():
            print(f"GPU {key}: {val}", flush=True)
        summary.update({k: (max(v) if isinstance(v, list) else v)
                        for k, v in g.items()})
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
