"""VAE trainer and latent export (port of ``vae_hmc_tpu.models.train``
``fit`` and ``encode_in_batches``), on one device or on a mesh.

Same schedule as the JAX fused trainer: one permutation per epoch, the full
batches, then one remainder step whose metrics weigh ``rem`` rows in the
history (DataLoader drop_last=False semantics of the reference), the
``_beta_at`` KL warm-up, Adam with optax's defaults.  Per-step metrics stay
on the device and are fetched once per epoch.

Random streams: each epoch's come from ``(seed, epoch)`` alone, as the JAX
package's ``fold_in(root, epoch)`` (``vae_hmc_tpu/models/train.py:668-669``):
a CPU generator for the permutation and a generator on the device for the
reparameterization noise.  A fit is thus a function of its seed, never of
torch's global generator, and a run resumed at epoch e draws what the
uninterrupted run drew there.  The values are torch's, not threefry's;
tests inject the JAX side's through ``perms`` and ``eps_fn``.

``compute_dtype="bfloat16"`` is the JAX package's mixed precision
(``_make_step``): float32 parameters and inputs are cast to bf16 at the
call boundary, the model's outputs back to float32 for the loss, whose
target stays float32; Adam updates the float32 parameters with float32
moments.  ``checkpoint_dir`` keeps ``train_state.ckpt`` in the JAX
package's layout of (Flax params, optax Adam state), so either package
resumes the other's.

``mesh=`` (``parallel/mesh``) trains the same steps data-parallel, and
tensor-parallel where ``param_shardings`` splits a layer over 'model';
without one, the step is the same code on a (1, 1) mesh of this process
alone, which runs no collective (a process group, if any, belongs to
the caller's meshes).  The JAX package gets step equivalence from SPMD
by construction; here it is built by hand, with no exchange of rows
between ranks:
  - each data index owns a contiguous row range
    (``parallel/multihost.process_row_range``), and its ranks hold only
    those rows; every rank draws the same permutation and the same noise
    of each whole batch, and runs forward and backward on the batch's rows
    it owns, with their noise;
  - the loss terms are sums over those rows divided by the whole batch's
    normalizer (``losses.elbo_loss_rows``, ``mse_rows``), so the gradients
    summed over the 'data' group (one all-reduce a step) are the whole
    batch's, and Adam takes the same step on every rank;
  - a rank that owns no row of a batch enters the all-reduce with zero
    gradients; the per-epoch history sums are all-reduced the same way.
That is the JAX package's step up to the order of reduction.  Checkpoint
options are refused on a mesh, as the JAX package's ``dp_fit`` passes
none.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from vae_hmc_tpu_torch.core import artifacts
from vae_hmc_tpu_torch.models.convert import flax_params, module_tensors
from vae_hmc_tpu_torch.models.losses import elbo_loss_rows, mse_rows
from vae_hmc_tpu_torch.parallel import collectives
from vae_hmc_tpu_torch.parallel.mesh import Mesh, gather_params, shard_params
from vae_hmc_tpu_torch.parallel.multihost import (ShardedRows,
                                                  process_row_range,
                                                  shard_rows)

_PERM_STREAM, _NOISE_STREAM = 0, 1
_CAST = {"float32": None, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


@dataclass
class FitResult:
    history: List[Dict[str, float]]     # one row per epoch


def _beta_at(beta: float, epoch: int, anneal_epochs: int) -> float:
    if anneal_epochs and anneal_epochs > 0:
        return beta * min(1.0, (epoch + 1) / anneal_epochs)
    return beta


def _epoch_generator(seed: int, epoch: int, stream: int,
                    device="cpu") -> torch.Generator:
    """The generator of one epoch's stream (permutation or noise), seeded
    from (seed, epoch, stream) alone."""
    state = np.random.SeedSequence([seed, epoch, stream]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _train_state_tree(model: torch.nn.Module,
                     opt: torch.optim.Adam) -> Dict:
    """(params, opt_state) as the JAX package's ``save_checkpoint`` keys
    them: ``0/params/<flax path>`` and ``1/0/{count,mu,nu}/params/...``
    (optax's ScaleByAdamState), numpy arrays in Flax layouts."""
    named = dict(model.named_parameters())
    states = [opt.state.get(p, {}) for p in named.values()]
    count = int(states[0]["step"]) if states[0] else 0

    def moments(key):
        return flax_params(model, {
            n: st[key] if st else torch.zeros_like(p)
            for (n, p), st in zip(named.items(), states)})
    return {"0": {"params": flax_params(model, named)},
            "1": {"0": {"count": np.asarray(count, np.int32),
                        "mu": {"params": moments("exp_avg")},
                        "nu": {"params": moments("exp_avg_sq")}}}}


def _load_train_state(model: torch.nn.Module, opt: torch.optim.Adam,
                     tree: Dict) -> None:
    """``_train_state_tree`` run backwards: the weights into `model`, count
    and moments into `opt`'s state."""
    named = dict(model.named_parameters())
    adam = tree["1"]["0"]
    weights = module_tensors(model, tree["0"]["params"])
    mu = module_tensors(model, adam["mu"]["params"])
    nu = module_tensors(model, adam["nu"]["params"])
    step = float(adam["count"])
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(weights[name])
            opt.state[p] = {
                "step": torch.tensor(step, dtype=torch.float32),
                "exp_avg": mu[name].to(p.device).contiguous(),
                "exp_avg_sq": nu[name].to(p.device).contiguous()}


def _own_rows(perm: torch.Tensor, start: int, stop: int, batch_size: int,
              dev: torch.device) -> Callable:
    """An epoch's batches as one rank of a mesh sees them: -> rows(i), step
    i's (local indices of the rows in [start, stop), their positions in
    the batch), both on `dev`, sliced out of per-epoch tensors copied to
    the device once, so no step waits on the device for its indices.
    `perm` (CPU) is the epoch's permutation."""
    at = torch.nonzero((perm >= start) & (perm < stop)).squeeze(1)
    local = (perm[at] - start).to(dev)
    pos = (at % batch_size).to(dev)
    cuts = torch.searchsorted(at, torch.arange(
        0, len(perm) + batch_size, batch_size)).tolist()
    return lambda i: (local[cuts[i]:cuts[i + 1]], pos[cuts[i]:cuts[i + 1]])


def fit(model: torch.nn.Module, arrays: Sequence[torch.Tensor], *,
        epochs: int, batch_size: int, learning_rate: float,
        beta: float = 1.0, reduction: str = "mean", seed: int = 42,
        kl_anneal_epochs: int = 0, variational: bool = True,
        log_every: int = 1, verbose: bool = False,
        checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
        resume: bool = True, compute_dtype: Optional[str] = None,
        perms: Optional[Sequence[np.ndarray]] = None,
        eps_fn: Optional[Callable[[int, int], torch.Tensor]] = None,
        mesh=None, param_shardings: Optional[Dict] = None,
        n_rows: Optional[int] = None) -> FitResult:
    """Train `model` in place on row-aligned `arrays` (arrays[0] is the
    reconstruction target; every array goes to the model, as the CVAE's
    condition does; all live on the model's device).

    variational=True: `model(*batch, eps=..., generator=...)` ->
    (xhat, mu, logvar) and the ELBO of `reduction`.  variational=False (the
    AE baseline): `model(*batch)` -> (xhat, ...) and the MSE mean, with
    kl = 0 in the history (``vae_hmc_tpu/models/train.py:228-231``).
    compute_dtype: None or "float32" (parity mode), "bfloat16" or "bf16".
    checkpoint_dir: write ``train_state.ckpt`` every `checkpoint_every`
    epochs (metadata {"epoch", "history"}); with `resume`, an existing file
    is loaded and training continues at its epoch, its history rows first.
    verbose prints an ``[epoch ...]`` line every `log_every` epochs and at
    the last.  `perms[e]` replaces epoch e's permutation and
    `eps_fn(epoch, step)` the reparameterization noise of a step, the whole
    batch's on a mesh too (test hooks).
    mesh: train on a ``parallel.mesh.Mesh`` (the model on its device;
    arrays full, every rank the same, or this rank's ``ShardedRows``, which
    need `n_rows`); `param_shardings` ({name: Sharding}, e.g.
    ``conv_mm_param_sharding``) tensor-shards layers over 'model' for the
    fit, gathered back into `model` on every rank at its end.  n_rows: the
    valid rows (arrays may hold more)."""
    if compute_dtype is not None and compute_dtype not in _CAST:
        raise ValueError(f"compute_dtype must be one of {sorted(_CAST)}, "
                         f"got {compute_dtype!r}")
    if isinstance(arrays[0], ShardedRows):
        if n_rows is None:
            raise ValueError(
                "arrays[0] is ShardedRows: this rank's rows only; pass "
                "n_rows=<valid row count> explicitly")
        if mesh is None:
            raise ValueError("ShardedRows need the mesh they were staged for")
    on_mesh = mesh is not None
    if on_mesh and checkpoint_dir is not None:
        raise ValueError("fit on a mesh has no checkpoint options (the JAX "
                         "package's dp_fit passes none)")
    if not on_mesh:     # one device: a (1, 1) mesh of this process alone
        mesh = Mesh(shape={"data": 1, "model": 1}, device=arrays[0].device)
    cast = _CAST.get(compute_dtype)
    n = int(arrays[0].shape[0]) if n_rows is None else int(n_rows)
    n_full, rem = divmod(n, batch_size)
    rows = [shard_rows(a, mesh, n) for a in arrays]
    start, stop = rows[0].start, rows[0].stop
    want = process_row_range(n, mesh=mesh)
    if any((r.start, r.stop, r.n_global) != (*want, n) for r in rows):
        raise ValueError(f"rows {[(r.start, r.stop) for r in rows]} of "
                         f"{n}: this rank's range is {want}")
    arrays = [r.local for r in rows]
    if param_shardings is not None:
        shard_params(model, param_shardings, mesh)
    dev = arrays[0].device
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate)
    model.train()

    def forward(batch, **kw):
        if cast is None:
            return model(*batch, **kw)
        params = {k: p.to(cast) if p.dtype == torch.float32 else p
                  for k, p in model.named_parameters()}
        batch = tuple(b.to(cast) if b.dtype == torch.float32 else b
                      for b in batch)
        out = torch.func.functional_call(model, params, batch, kw)
        return tuple(o.float() for o in out)

    params = list(model.parameters())
    noise_dtype = cast or torch.float32

    def step(rows, b, epoch, i, beta_now, noise):
        """One step of a batch of `b` rows: `rows` (this rank's rows of it:
        local indices and positions in the batch, from ``_own_rows``)
        trained with their noise; -> this rank's partial (total, recon,
        kl)."""
        local, pos = rows
        opt.zero_grad(set_to_none=True)
        aux = torch.zeros(3, dtype=torch.float32, device=dev)
        if variational:
            eps = (eps_fn(epoch, i) if eps_fn is not None else torch.randn(
                (b, model.latent_dim), generator=noise, dtype=noise_dtype,
                device=dev))
            eps = eps.to(dev).index_select(0, pos)
        if len(local):
            batch = [a[local] for a in arrays]
            if variational:
                xhat, mu, logvar = forward(batch, eps=eps)
                loss, parts = elbo_loss_rows(xhat, batch[0], mu, logvar,
                                             beta_now, reduction, b)
                aux = torch.stack([parts["total"], parts["recon"],
                                   parts["kl"]]).detach()
            else:
                loss = mse_rows(forward(batch)[0], batch[0], b)
                aux = torch.stack([loss, loss, torch.zeros_like(loss)]
                                  ).detach()
            loss.backward()
        if on_mesh:
            collectives.all_reduce_grads(params, mesh.data_group)
        opt.step()
        return aux

    history: List[Dict[str, float]] = []
    start_epoch = 0
    ckpt_path = None
    if checkpoint_dir is not None:
        ckpt_path = Path(checkpoint_dir) / "train_state.ckpt"
        if resume and ckpt_path.exists():
            tree, meta = artifacts.load_checkpoint(
                ckpt_path, like=_train_state_tree(model, opt))
            _load_train_state(model, opt, tree)
            start_epoch = int(meta.get("epoch", 0))
            history = list(meta.get("history", []))

    for epoch in range(start_epoch, epochs):
        perm = (torch.as_tensor(np.asarray(perms[epoch]), dtype=torch.int64)
                if perms is not None else torch.randperm(
                    n, generator=_epoch_generator(seed, epoch, _PERM_STREAM)))
        noise = (_epoch_generator(seed, epoch, _NOISE_STREAM, dev)
                 if variational and eps_fn is None else None)
        beta_now = _beta_at(beta, epoch, kl_anneal_epochs)
        totals = torch.zeros(3, dtype=torch.float32, device=dev)
        rows = _own_rows(perm, start, stop, batch_size, dev)
        for i in range(n_full + bool(rem)):
            b = batch_size if i < n_full else rem
            totals += step(rows(i), b, epoch, i, beta_now, noise) * b
        if on_mesh:
            collectives.all_reduce_sum(totals, mesh.data_group)
        avg = (totals / n).cpu().numpy()                 # one fetch per epoch
        row = {"epoch": epoch + 1, "total": float(avg[0]),
               "recon": float(avg[1]), "kl": float(avg[2])}
        history.append(row)
        if verbose and mesh.rank == 0 and (
                (log_every and epoch % log_every == 0) or epoch == epochs - 1):
            print(f"[epoch {epoch + 1:3d}/{epochs}] "
                  f"total {row['total']:.4f} recon {row['recon']:.4f} "
                  f"kl {row['kl']:.4f}")
        if (ckpt_path is not None and checkpoint_every
                and (epoch + 1) % checkpoint_every == 0):
            artifacts.save_checkpoint(
                ckpt_path, _train_state_tree(model, opt),
                metadata={"epoch": epoch + 1, "history": history})
    if param_shardings is not None:
        gather_params(model, mesh)
    return FitResult(history=history)


@torch.no_grad()
def encode_in_batches(encode_fn: Callable, arrays: Sequence[torch.Tensor],
                      batch_size: int = 512) -> torch.Tensor:
    """Posterior-mean export over all rows (reference scripts/12:289-309):
    `encode_fn(*batch)` per contiguous batch, concatenated on the device."""
    n = int(arrays[0].shape[0])
    return torch.cat([encode_fn(*(a[s:s + batch_size] for a in arrays))
                      for s in range(0, n, batch_size)], dim=0)
