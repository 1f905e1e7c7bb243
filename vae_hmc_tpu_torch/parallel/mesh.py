"""Device mesh and sharding rules (port of ``vae_hmc_tpu.parallel.mesh``).

A mesh is a ('data', 'model') grid over the ranks of an initialized
``torch.distributed`` process group, one process per device as ``torchrun``
starts them; rank r sits at data index r // M and model index r % M, so a
mesh row (one data index, every model index) is M consecutive ranks:
  - 'data'  : data parallelism over the batch.  Each data index owns a
              contiguous row range (``multihost.process_row_range``), its
              ranks hold only those rows, and gradients are summed over the
              'data' group (``models/train.fit``);
  - 'model' : tensor parallelism of the one genuinely large matmul pair, the
              conv VAE's flattened conv features <-> 256-d FC (165,888 x 256
              at full mel resolution), and the restarts of
              ``train_dp.kmeans_restarts_sharded`` over every rank.

Without a process group a mesh is (1, 1) and the same code runs, each
collective the identity (``parallel/collectives``).  The JAX package's
``jax.sharding.Mesh`` / ``NamedSharding`` have no torch counterpart; the
port keeps its own ``Mesh`` dataclass and ``Sharding`` spec.

Tensor parallelism (``shard_params``) swaps the sharded ``nn.Linear``
layers for Megatron-style ones:
  - weight sharded on dim 1 (``enc_fc``, on its inputs): row-parallel, the
    rank's slice of the input features, partial products summed over
    'model', the replicated bias added after the sum;
  - weight (and bias) sharded on dim 0 (``dec_fc2``, on its outputs):
    column-parallel, the rank's slice of the outputs gathered over 'model'.
The port flattens the conv features NCHW, the JAX package NHWC, so the
shards partition the same function in a different order of the 165,888
features: each rank holds a run of channels here, of rows there.
Only the shards stay on the device through the fit; ``gather_params`` puts
new full layers back, with the trained weights.
"""
from __future__ import annotations

import datetime
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from vae_hmc_tpu_torch.core.device import resolve_device
from vae_hmc_tpu_torch.parallel import collectives as col


@dataclass
class Mesh:
    """A ('data', 'model') grid over the ranks; `rank` is this process's
    global rank, `device` its device; the groups are this rank's ('data':
    the ranks of its model index, 'model': the ranks of its data index;
    None: every rank, or no process group)."""

    shape: Dict[str, int]
    rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    backend: Optional[str] = None
    data_group: Any = None
    model_group: Any = None

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    @property
    def data_index(self) -> int:
        return self.rank // self.shape["model"]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape["model"]


@dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on a mesh (a PartitionSpec of one axis):
    axis None: replicated on every rank; "data": dim `dim` split into the
    data indices' row ranges; "model": dim `dim` split evenly over the
    'model' axis."""

    axis: Optional[str] = None
    dim: int = 0


def _rank_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _group(ranks, world: int, timeout: Optional[datetime.timedelta]):
    """Every rank creates every group, in the same order; the whole world
    is the default group (None)."""
    if len(ranks) == world:
        return None
    return dist.new_group(list(ranks), timeout=timeout)


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Tuple[int, int]] = None, device="cuda",
              timeout: Optional[datetime.timedelta] = None) -> Mesh:
    """2-D ('data', 'model') mesh over the process group's ranks (n_devices
    must be their number).  shape=None picks (n, 1), or (n//2, 2) when n is
    even and >= 4 so the TP axis is exercised.  `device`: this rank's
    device ("cuda" means the current CUDA device, which
    ``multihost.init_distributed`` sets).  `timeout`: the sub-groups'
    (None: torch's default for new groups); every rank must call this, as
    each creates every sub-group."""
    world = dist.get_world_size() if col.active() else 1
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"make_mesh({n}): the process group has {world} "
                         "rank(s), one per device")
    if shape is None:
        shape = (n // 2, 2) if (n % 2 == 0 and n >= 4) else (n, 1)
    d, m = (int(s) for s in shape)
    if d * m != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    dev = _rank_device(device)
    mesh = Mesh(shape={"data": d, "model": m}, device=dev)
    if not col.active():
        return mesh
    mesh.rank = dist.get_rank()
    mesh.backend = str(dist.get_backend())
    if mesh.backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the NCCL backend needs CUDA devices, not {dev}")
    data_groups = [_group([i * m + j for i in range(d)], world, timeout)
                   for j in range(m)]
    model_groups = [_group([i * m + j for j in range(m)], world, timeout)
                    for i in range(d)]
    mesh.data_group = data_groups[mesh.model_index]
    mesh.model_group = model_groups[mesh.data_index]
    return mesh


def replicate(mesh: Mesh) -> Sharding:
    return Sharding()


def batch_sharding(mesh: Mesh) -> Sharding:
    """Batch axis over 'data' (and nothing over 'model')."""
    return Sharding("data", 0)


def conv_mm_param_sharding(mesh: Mesh, model: nn.Module
                           ) -> Dict[str, Sharding]:
    """Sharding of every ConvMMVAE parameter by name: the two giant FC
    layers tensor-sharded along their flat-features dimension, the rest
    replicated.

      enc_fc.weight  (fc_dim, flat) -> Sharding("model", 1)  (row-parallel)
      dec_fc2.weight (flat, fc_dim) -> Sharding("model", 0)  (column-parallel)
      dec_fc2.bias   (flat,)        -> Sharding("model", 0)
    """
    rules = {"enc_fc.weight": Sharding("model", 1),
             "dec_fc2.weight": Sharding("model", 0),
             "dec_fc2.bias": Sharding("model", 0)}
    return {name: rules.get(name, Sharding())
            for name, _ in model.named_parameters()}


def _linear(weight: torch.Tensor, bias: torch.Tensor) -> nn.Linear:
    """An nn.Linear holding `weight` and `bias` (no initialization)."""
    layer = nn.Linear(weight.shape[1], weight.shape[0], device="meta")
    layer.weight = nn.Parameter(weight)
    layer.bias = nn.Parameter(bias)
    return layer


class _RowParallelLinear(nn.Module):
    """nn.Linear with its weight sharded on the inputs (dim 1) over
    'model'; the replicated bias is added after the sum."""

    def __init__(self, full: nn.Linear, mesh: Mesh):
        super().__init__()
        self.group = mesh.model_group
        self.shard = (mesh.model_index, mesh.shape["model"])
        self.weight = nn.Parameter(col.shard_of(full.weight.detach(), 1,
                                                *self.shard))
        self.bias = nn.Parameter(full.bias.detach().clone())

    def forward(self, x):
        xs = col.ScatterToModel.apply(x, self.group, *self.shard)
        return col.ReduceFromModel.apply(F.linear(xs, self.weight),
                                         self.group) + self.bias

    @torch.no_grad()
    def gathered(self) -> nn.Linear:
        return _linear(col.gather_shards(self.weight, 1, self.group,
                                         *self.shard), self.bias.clone())


class _ColumnParallelLinear(nn.Module):
    """nn.Linear with its weight and bias sharded on the outputs (dim 0)
    over 'model'."""

    def __init__(self, full: nn.Linear, mesh: Mesh):
        super().__init__()
        self.group = mesh.model_group
        self.shard = (mesh.model_index, mesh.shape["model"])
        self.weight = nn.Parameter(col.shard_of(full.weight.detach(), 0,
                                                *self.shard))
        self.bias = nn.Parameter(col.shard_of(full.bias.detach(), 0,
                                              *self.shard))

    def forward(self, h):
        h = col.CopyToModel.apply(h, self.group)
        return col.GatherFromModel.apply(F.linear(h, self.weight, self.bias),
                                         self.group, *self.shard)

    @torch.no_grad()
    def gathered(self) -> nn.Linear:
        return _linear(*(col.gather_shards(p, 0, self.group, *self.shard)
                         for p in (self.weight, self.bias)))


_TP_LAYERS = (_RowParallelLinear, _ColumnParallelLinear)


def _parent(model: nn.Module, name: str):
    parent, _, child = name.rpartition(".")
    return (model.get_submodule(parent) if parent else model), child


def shard_params(model: nn.Module, shardings: Dict[str, Sharding],
                 mesh: Mesh) -> nn.Module:
    """Tensor-shard `model` in place over the mesh's 'model' axis: each
    nn.Linear whose weight `shardings` splits over "model" becomes a
    row-parallel (dim 1) or column-parallel (dim 0, with its bias) layer
    holding this rank's shard; replicated parameters stay as they are.
    A 'model' axis of 1 leaves the model whole.  -> model."""
    m = mesh.shape["model"]
    if m == 1:
        return model
    for name, spec in shardings.items():
        if spec.axis not in (None, "model"):
            raise ValueError(f"{name}: parameters shard over 'model' only, "
                             f"not {spec.axis!r}")
    for name, layer in list(model.named_modules()):
        if not isinstance(layer, nn.Linear):
            continue
        w = shardings.get(f"{name}.weight", Sharding())
        b = shardings.get(f"{name}.bias", Sharding())
        if w.axis is None and b.axis is None:
            continue
        if layer.weight.shape[w.dim] % m:
            raise ValueError(f"{name}.weight {tuple(layer.weight.shape)}: "
                             f"dim {w.dim} does not split {m} ways")
        if w.dim == 1 and b.axis is None:
            tp = _RowParallelLinear(layer, mesh)
        elif w.dim == 0 and b == w:
            tp = _ColumnParallelLinear(layer, mesh)
        else:
            raise ValueError(f"{name}: no tensor-parallel layer for weight "
                             f"{w} and bias {b}")
        parent, child = _parent(model, name)
        setattr(parent, child, tp)
    return model


def gather_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """``shard_params`` undone: every tensor-parallel layer's shards are
    gathered over 'model' into a full nn.Linear, which takes its place, on
    every rank.  -> model."""
    for name, layer in list(model.named_modules()):
        if isinstance(layer, _TP_LAYERS):
            parent, child = _parent(model, name)
            setattr(parent, child, layer.gathered())
    return model
