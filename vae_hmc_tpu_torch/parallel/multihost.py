"""Process groups, meshes over every rank, and row-sharded staging (port of
``vae_hmc_tpu.parallel.multihost``).

The JAX package runs one process per host and assembles global arrays from
per-process shards.  The port runs one process per device (``torchrun``
starts them), and a P('data') ``jax.Array`` has no torch counterpart: each
data index of the mesh owns a contiguous row range, its ranks hold only
those rows on their device, and a ``ShardedRows`` carries them with their
place in the whole.

  - ``init_distributed`` brings up the process group from explicit
    arguments or ``torchrun``'s environment;
  - ``global_mesh`` lays the ('data', 'model') mesh over every rank so that
    each mesh row (the tensor-parallel group) stays on one node;
  - ``padded_rows`` / ``process_row_range`` are the JAX package's row
    arithmetic: ceil-split shards of the row count padded to a multiple of
    the 'data' axis, clamped to the true count;
  - ``stage_features_sharded`` / ``global_batch_from_local`` stage only
    this rank's rows.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from vae_hmc_tpu_torch.core.device import resolve_device
from vae_hmc_tpu_torch.parallel import collectives as col
from vae_hmc_tpu_torch.parallel.mesh import Mesh, make_mesh

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")


@dataclass
class ShardedRows:
    """Rows [start, stop) of an (n_global, ...) array, held by this rank
    (`local`, on its device)."""

    local: torch.Tensor
    start: int
    stop: int
    n_global: int


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None, device="cuda",
                     timeout: datetime.timedelta =
                     datetime.timedelta(seconds=600)) -> int:
    """Initialize the process group; returns the world size.

    With no arguments and without torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR): a no-op (one process, world 1).
    Safe to call twice.  `backend` defaults to "nccl", which needs
    device="cuda"; pass "gloo" for the CPU, or for several ranks on one
    card.  For CUDA the rank's device is cuda:LOCAL_RANK (without the
    variable: the rank modulo the visible devices).  `timeout` bounds every
    collective, so a rank that misses one fails instead of hanging."""
    if col.active():
        return dist.get_world_size()
    env = all(k in os.environ for k in _TORCHRUN_ENV)
    if init_method is None and world_size is None and rank is None and not env:
        return 1
    backend = backend or "nccl"
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs device='cuda'; pass "
                         "backend='gloo' for the CPU")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   (rank or 0) % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank,
                            timeout=timeout)
    return dist.get_world_size()


def global_mesh(model_parallel: int = 1, device="cuda",
                timeout: Optional[datetime.timedelta] = None) -> Mesh:
    """('data', 'model') mesh over every rank, node-aware: each mesh row
    (one data index, the M = model_parallel ranks of a tensor-parallel
    group) is M consecutive ranks, which torchrun places on one node
    (LOCAL_WORLD_SIZE ranks a node), so tensor-parallel collectives never
    leave a node and only the 'data' axis's gradient sums cross nodes."""
    world = dist.get_world_size() if col.active() else 1
    if world % model_parallel:
        raise ValueError(f"{world} devices not divisible by "
                         f"model_parallel={model_parallel}")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world > local and (model_parallel > local or local % model_parallel):
        raise ValueError(
            f"model_parallel={model_parallel} spans nodes ({local} ranks a "
            "node): TP collectives would cross nodes; shrink it or widen "
            "the node")
    return make_mesh(shape=(world // model_parallel, model_parallel),
                     device=device, timeout=timeout)


def padded_rows(n_rows: int, mesh: Mesh) -> int:
    """Smallest row count >= n_rows divisible by the mesh's 'data' axis."""
    n_data = int(mesh.shape.get("data", 1))
    return -(-n_rows // n_data) * n_data


def process_row_range(n_rows: int, process_id: Optional[int] = None,
                      process_count: Optional[int] = None,
                      mesh: Optional[Mesh] = None) -> Tuple[int, int]:
    """[start, stop) valid row range of rank `process_id` (default: this
    rank).

    With `mesh`: the P('data') shard of its data index over the padded row
    count (ceil-split), clamped to n_rows; the ranks of one data index (its
    tensor-parallel group) share it.  Without: divmod balancing over
    `process_count` ranks (default: the world size)."""
    if mesh is not None:
        pid = mesh.rank if process_id is None else process_id
        per = padded_rows(n_rows, mesh) // mesh.shape["data"]
        d = pid // mesh.shape["model"]
        return min(d * per, n_rows), min((d + 1) * per, n_rows)
    pid = ((dist.get_rank() if col.active() else 0) if process_id is None
           else process_id)
    pc = ((dist.get_world_size() if col.active() else 1)
          if process_count is None else process_count)
    base, extra = divmod(n_rows, pc)
    start = pid * base + min(pid, extra)
    return start, start + base + (1 if pid < extra else 0)


def shard_rows(a, mesh: Mesh, n_rows: Optional[int] = None) -> ShardedRows:
    """This rank's rows of a full array (numpy or a tensor, rows beyond
    n_rows ignored) on the mesh's device; a ShardedRows moves there."""
    if isinstance(a, ShardedRows):
        return ShardedRows(a.local.to(mesh.device), a.start, a.stop,
                           a.n_global)
    n = int(a.shape[0]) if n_rows is None else int(n_rows)
    start, stop = process_row_range(n, mesh=mesh)
    return ShardedRows(torch.as_tensor(a[start:stop], device=mesh.device),
                       start, stop, n)


def global_batch_from_local(local_rows, mesh: Mesh,
                            n_global_rows: int) -> ShardedRows:
    """This rank's `process_row_range(n_global_rows, mesh=mesh)` slice of
    an (n_global_rows, ...) array, staged by this rank alone (numpy or a
    tensor) -> ShardedRows on the mesh's device.  No rank ever holds the
    whole corpus."""
    start, stop = process_row_range(n_global_rows, mesh=mesh)
    if local_rows.shape[0] != stop - start:
        raise ValueError(
            f"rank {mesh.rank} staged {local_rows.shape[0]} rows but its "
            f"sharded range is {(start, stop)}: stage with "
            "process_row_range(n, mesh=mesh)")
    return ShardedRows(torch.as_tensor(local_rows, device=mesh.device),
                       start, stop, n_global_rows)


def stage_features_sharded(source_rows_fn: Callable, n_rows: int, mesh: Mesh,
                           batch: int = 256,
                           feature_dims: Optional[Tuple[int, ...]] = None
                           ) -> ShardedRows:
    """Row-sharded feature staging: `source_rows_fn(start, stop)` produces
    feature rows [start, stop) (numpy or a tensor); this rank walks only
    its own range in `batch`-row chunks.  `feature_dims` (the per-row
    trailing shape) is needed only when the rank's range is empty."""
    start, stop = process_row_range(n_rows, mesh=mesh)
    chunks = [torch.as_tensor(source_rows_fn(s, min(s + batch, stop)),
                              device=mesh.device)
              for s in range(start, stop, batch)]
    if chunks:
        local = torch.cat(chunks) if len(chunks) > 1 else chunks[0]
    elif feature_dims is not None:
        local = torch.zeros((0,) + tuple(feature_dims), dtype=torch.float32,
                            device=mesh.device)
    else:
        raise ValueError(
            f"rank {mesh.rank} stages no rows for n_rows={n_rows}; pass "
            "feature_dims so the empty shard has the right rank")
    return global_batch_from_local(local, mesh, n_rows)
