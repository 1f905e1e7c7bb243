"""Collectives of the parallel path, on ``torch.distributed``.

The JAX package has no counterpart: XLA inserts its collectives from
sharding annotations.  Here each collective is an explicit call, and a rank
that skips one stalls its group until the process group's timeout.

The hot path uses two collectives only, ``all_reduce`` (sum) and
``broadcast``, on device tensors: the two that NCCL and gloo both run on
CUDA tensors, so one code path runs under either backend.  An all-gather is
an ``all_reduce`` over a zero-filled full buffer into which each rank has
written its own slice (``all_gather_rows``, ``gather_shards``); every other
element of the sum is an exact zero, so the result is the concatenation bit
for bit.

Without an initialized process group every collective is the identity:
that is the one-device case of the same program, a (1, 1) mesh.

The four ``torch.autograd.Function``s are the Megatron-style tensor-parallel
seams over the 'model' group (``parallel/mesh`` builds the layers from
them):
  - copy-to-model: forward identity, backward all-reduce;
  - reduce-from-model: forward all-reduce, backward identity;
  - scatter-to-model: forward this rank's slice of the last dim, backward
    the gather of the slices' gradients;
  - gather-from-model: forward the gather of the slices along the last dim,
    backward this rank's slice of the gradient.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

# bytes this process passed to each collective since the last reset (what
# chip_smoke.py phase 10 reads as the all-reduce bytes a step)
BYTES = {"all_reduce": 0, "broadcast": 0}


def reset_byte_counts() -> None:
    for k in BYTES:
        BYTES[k] = 0


def byte_counts() -> dict:
    return dict(BYTES)


def active() -> bool:
    """True when a process group is initialized (the collectives run)."""
    return dist.is_available() and dist.is_initialized()


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` in place over `group` (None: every rank); -> `t`."""
    if active():
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        BYTES["all_reduce"] += t.numel() * t.element_size()
    return t


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """`t` from global rank `src` to every rank of `group`, in place."""
    if active():
        dist.broadcast(t, src=src, group=group)
        BYTES["broadcast"] += t.numel() * t.element_size()
    return t


def all_gather_rows(local: torch.Tensor, start: int, n_rows: int,
                    group=None) -> torch.Tensor:
    """Rows [start, start + len(local)) of an (n_rows, ...) tensor from each
    rank of `group` -> the whole tensor on every rank (the ranks' ranges
    partition [0, n_rows))."""
    buf = local.new_zeros((n_rows,) + tuple(local.shape[1:]))
    buf[start:start + local.shape[0]] = local
    return all_reduce_sum(buf, group)


def barrier(device: torch.device, group=None) -> None:
    """Wait until every rank of `group` got here (an all-reduce of one
    element, read back on the host)."""
    flag = torch.zeros(1, device=device)
    all_reduce_sum(flag, group)
    flag.item()


def all_reduce_grads(params: Sequence[torch.nn.Parameter], group=None) -> None:
    """Sum the gradients of `params` over `group` in one all-reduce of
    their concatenation (a parameter without a gradient counts as zeros)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if not active():
        return
    grads = [p.grad for p in params]
    flat = torch._utils._flatten_dense_tensors(grads)
    all_reduce_sum(flat, group)
    for g, s in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
        g.copy_(s)


def shard_of(x: torch.Tensor, dim: int, index: int, size: int
             ) -> torch.Tensor:
    """Shard `index` of `size` even shards of `x` along `dim` (a copy)."""
    w = x.shape[dim] // size
    return x.narrow(dim, index * w, w).contiguous()


def gather_shards(x: torch.Tensor, dim: int, group, index: int, size: int
                  ) -> torch.Tensor:
    """``shard_of`` undone: every rank's shard `x` along `dim` -> the whole
    tensor on every rank of `group`."""
    w = x.shape[dim]
    full = list(x.shape)
    full[dim] = w * size
    buf = x.new_zeros(full)
    buf.narrow(dim, index * w, w).copy_(x)
    return all_reduce_sum(buf, group)


class CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous().clone(), ctx.group), None


class ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, size):
        ctx.args = (group, index, size)
        return shard_of(x, -1, index, size)

    @staticmethod
    def backward(ctx, grad):
        return (gather_shards(grad.contiguous(), -1, *ctx.args),
                None, None, None)


class GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, size):
        ctx.args = (index, size)
        return gather_shards(x.contiguous(), -1, group, index, size)

    @staticmethod
    def backward(ctx, grad):
        return shard_of(grad, -1, *ctx.args), None, None, None
