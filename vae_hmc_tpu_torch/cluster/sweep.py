"""Clustering suite and full sweep, reference scripts 13 and 16 (port
of ``vae_hmc_tpu.cluster.sweep``).

Each representation's (N, N) euclidean distance matrix is computed ONCE by
kernel 2 on the device and shared by
  - every DBSCAN cell (epsilon-graph thresholding),
  - every silhouette evaluation,
  - the ward linkage (through one host copy),
instead of being recomputed inside sklearn for each of the 102 cells
(reference scripts/16:159-244).  Row schema and scoring match the
reference CSVs exactly:
  13: sil + ari - 0.2*dbi ranking (13:226-231);
  16: conservative score sil + ari - 0.2*dbi - 0.8*noise_frac (16:109-117).
A cell whose labels cannot be scored (fewer than 2 clusters, or fewer than
3 kept points for silhouette: where sklearn raises) gets None; any other
error, a kernel's or CUDA's included, propagates.
"""
from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from vae_hmc_tpu_torch.cluster.agglomerative import (cut_tree_n_clusters,
                                                     ward_linkage_from_sq_dists)
from vae_hmc_tpu_torch.cluster.dbscan import dbscan_sweep_from_dists_device
from vae_hmc_tpu_torch.cluster.kmeans import kmeans
from vae_hmc_tpu_torch.core.config import KMeansConfig
from vae_hmc_tpu_torch.core.device import resolve_device
from vae_hmc_tpu_torch.metrics import internal
from vae_hmc_tpu_torch.metrics.safe import (n_effective_clusters,
                                            noise_fraction, safe_ari)
from vae_hmc_tpu_torch.ops.kernels.distance import pairwise_dists


# host work of the sweep (distance copies, ward linkages); FIFO, so a task
# only ever waits on one submitted before it
_POOL = ThreadPoolExecutor(max_workers=8, thread_name_prefix="sweep")


def _host_copy(t: torch.Tensor) -> Future:
    """Fetch `t` to the host on a thread.  An event recorded on the
    producer's stream orders the copy after the kernel that wrote `t`,
    whatever stream the thread's copy runs on."""
    if t.device.type != "cuda":
        return _POOL.submit(t.numpy)
    done = torch.cuda.Event()
    done.record()

    def fetch() -> np.ndarray:
        done.synchronize()
        return t.cpu().numpy()

    return _POOL.submit(fetch)


@dataclass
class RepData:
    """A representation prepared for sweeping: features + cached distances.

    Everything expensive is computed once and shared across every sweep cell
    (and across scripts 13 and 16 when the pipeline threads the same RepData
    through both):
      - `x_dev`: the (N, d) features on the device (every kmeans cell);
      - `xc_dev`: the same, mean-centred once (every Davies-Bouldin cell);
      - `dists_dev`: the (N, N) distances of `xc_dev`, one kernel 2 launch
        (silhouettes and the DBSCAN epsilon-graphs read it in place);
      - `dists`: its host copy, fetched on a thread at build time so the
        fetch overlaps the device cells — only the ward NN-chain needs it;
      - `ward_merges()`: the (N-1, 4) ward linkage, computed once on a
        thread and cut at every k (the reference re-runs the full linkage
        per k, scripts/16:201);
      - `kmeans_labels()`: memoized per (k, n_init, seed)."""

    name: str
    y_true: Optional[np.ndarray]        # (N,) genre strings or None
    x_dev: torch.Tensor
    xc_dev: torch.Tensor
    dists_dev: torch.Tensor
    _dists_task: Future
    _ward_task: Optional[Future] = None
    _kmeans_cache: Dict = field(default_factory=dict)

    @classmethod
    def build(cls, name: str, x, y_true: Optional[np.ndarray],
              device="cuda") -> "RepData":
        """x: host numpy or a tensor; a tensor stays on its own device."""
        dev = x.device if isinstance(x, torch.Tensor) else resolve_device(device)
        x_dev = torch.as_tensor(x, dtype=torch.float32, device=dev)
        x_dev = x_dev.reshape(x_dev.shape[0], -1)
        xc = internal.center(x_dev, dev)
        d = pairwise_dists(xc)
        return cls(name=name, y_true=y_true, x_dev=x_dev, xc_dev=xc,
                   dists_dev=d, _dists_task=_host_copy(d))

    @property
    def n(self) -> int:
        return int(self.x_dev.shape[0])

    @property
    def dists(self) -> np.ndarray:
        """(N, N) euclidean distances on the host (the prefetched copy)."""
        return self._dists_task.result()

    def ward_prefetch(self) -> None:
        """Start the ward linkage on a thread.  The C++ NN-chain releases
        the GIL, so the host work overlaps the device cells that the sweep
        launches meanwhile; ward_merges() waits for it."""
        if self._ward_task is None:
            self._ward_task = _POOL.submit(lambda: ward_linkage_from_sq_dists(
                self.dists.astype(np.float64) ** 2))

    def ward_merges(self) -> np.ndarray:
        """Ward linkage (scipy format), computed once per representation."""
        self.ward_prefetch()
        return self._ward_task.result()

    def kmeans_labels(self, k: int, n_init: int = 10,
                      seed: int = 42) -> np.ndarray:
        """KMeans labels on x_dev, memoized per (k, n_init, seed): scripts 13
        and 16 cluster the same representation at the same (k=6, n_init=10,
        seed=42) cell, which the reference re-fits in each script."""
        key = (int(k), int(n_init), int(seed))
        if key not in self._kmeans_cache:
            self._kmeans_cache[key] = kmeans(
                self.x_dev, KMeansConfig(n_clusters=int(k), n_init=n_init,
                                         seed=seed),
                device=self.x_dev.device).labels
        return self._kmeans_cache[key]


def _sil(rep: RepData, yhat: np.ndarray) -> Optional[torch.Tensor]:
    """Masked silhouette from the cached distances (noise carries zero
    weight), as a 0-d device tensor fetched later by finalize_rows."""
    lk = yhat[yhat != -1]
    if len(np.unique(lk)) < 2 or len(lk) < 3:
        return None
    return internal.silhouette_from_dists_masked(rep.dists_dev, yhat,
                                                 lazy=True)


def _dbi(rep: RepData, yhat: np.ndarray) -> Optional[torch.Tensor]:
    """Masked Davies-Bouldin on the cached centred features (no per-cell
    upload or centring of the (N, 82,688) mel-flat representation)."""
    if len(np.unique(yhat[yhat != -1])) < 2:
        return None
    return internal.davies_bouldin_masked(rep.xc_dev, yhat, lazy=True,
                                          centred=True)


def finalize_rows(rows: List[Dict]) -> List[Dict]:
    """Resolve the deferred device metric scalars with ONE host transfer
    and fill the conservative scores that depend on them."""
    pend = [(i, key) for i, r in enumerate(rows)
            for key in ("silhouette", "davies_bouldin")
            if isinstance(r.get(key), torch.Tensor)]
    if pend:
        vals = torch.stack([rows[i][key] for i, key in pend]).cpu().tolist()
        for (i, key), v in zip(pend, vals):
            rows[i][key] = float(v)
    for r in rows:
        if "noise_frac" in r and r.get("score") is None:
            r["score"] = conservative_score(r["silhouette"],
                                            r["davies_bouldin"], r["ari"],
                                            r["noise_frac"])
    return rows


def evaluate_cell(rep: RepData, algo: str, params: str,
                  yhat: np.ndarray, with_noise_frac: bool) -> Dict:
    yhat = np.asarray(yhat)
    sil = _sil(rep, yhat)
    dbi = _dbi(rep, yhat)
    ari = safe_ari(rep.y_true, yhat) if rep.y_true is not None else None
    row = {
        "representation": rep.name,
        "algo": algo,
        "params": params,
        "n_clusters_found": (len(np.unique(yhat))
                             if algo in ("kmeans", "agglomerative")
                             else n_effective_clusters(yhat)),
        "n_noise": int(np.sum(yhat == -1)),
        "silhouette": sil,
        "davies_bouldin": dbi,
        "ari": ari,
    }
    if with_noise_frac:
        row["noise_frac"] = noise_fraction(yhat)
        # sil/dbi may be deferred device scalars; the score is then filled
        # by finalize_rows after the one bulk fetch
        row["score"] = (None if any(isinstance(v, torch.Tensor)
                                    for v in (sil, dbi))
                        else conservative_score(sil, dbi, ari,
                                                row["noise_frac"]))
    return row


def conservative_score(sil, dbi, ari, noise_frac) -> float:
    """Reference scripts/16:109-117."""
    sil_v = sil if sil is not None else -1.0
    dbi_v = dbi if dbi is not None else 10.0
    ari_v = ari if ari is not None else 0.0
    return float(sil_v) + float(ari_v) - 0.2 * float(dbi_v) - 0.8 * float(noise_frac)


def heuristic_score(row: Dict) -> float:
    """Reference scripts/13:226-231 ranking."""
    sil = row["silhouette"] if row["silhouette"] is not None else -1.0
    dbi = row["davies_bouldin"] if row["davies_bouldin"] is not None else 10.0
    ari = row["ari"] if row["ari"] is not None else 0.0
    return float(sil) + float(ari) - 0.2 * float(dbi)


def cluster_suite(rep: RepData, n_clusters: int,
                  dbscan_eps: Sequence[float] = (0.4, 0.6, 0.8, 1.0, 1.2),
                  dbscan_min_samples: int = 5,
                  kmeans_n_init: int = 10, seed: int = 42) -> List[Dict]:
    """Reference scripts/13:116-151 run_cluster_suite."""
    rep.ward_prefetch()
    rows = [evaluate_cell(rep, "kmeans", f"k={n_clusters}",
                          rep.kmeans_labels(n_clusters, kmeans_n_init, seed),
                          with_noise_frac=False)]
    ag = cut_tree_n_clusters(rep.ward_merges(), rep.n, n_clusters)
    rows.append(evaluate_cell(rep, "agglomerative", f"k={n_clusters},ward",
                              ag, with_noise_frac=False))
    grid = dbscan_sweep_from_dists_device(rep.dists_dev, dbscan_eps,
                                          [dbscan_min_samples])
    for eps in dbscan_eps:
        yhat = grid[(float(eps), int(dbscan_min_samples))]
        rows.append(evaluate_cell(
            rep, "dbscan", f"eps={eps},min={dbscan_min_samples}", yhat,
            with_noise_frac=False))
    return finalize_rows(rows)


def full_sweep(rep: RepData,
               ks: Sequence[int] = (4, 5, 6, 7, 8),
               eps_values: Sequence[float] = (0.3, 0.4, 0.5, 0.6, 0.7, 0.8,
                                              0.9, 1.0),
               min_samples_values: Sequence[int] = (3, 5, 8),
               kmeans_n_init: int = 10, seed: int = 42) -> List[Dict]:
    """Reference scripts/16:159-244: per representation,
    (k x {kmeans, agglomerative}) + (eps x min_samples) DBSCAN grid."""
    rep.ward_prefetch()
    rows = []
    for k in ks:
        rows.append(evaluate_cell(rep, "kmeans", f"k={k}",
                                  rep.kmeans_labels(k, kmeans_n_init, seed),
                                  with_noise_frac=True))
        ag = cut_tree_n_clusters(rep.ward_merges(), rep.n, k)
        rows.append(evaluate_cell(rep, "agglomerative", f"k={k},ward", ag,
                                  with_noise_frac=True))
    grid = dbscan_sweep_from_dists_device(rep.dists_dev, eps_values,
                                          min_samples_values)
    for eps in eps_values:
        for ms in min_samples_values:
            yhat = grid[(float(eps), int(ms))]
            rows.append(evaluate_cell(rep, "dbscan", f"eps={eps},min={ms}",
                                      yhat, with_noise_frac=True))
    return finalize_rows(rows)
