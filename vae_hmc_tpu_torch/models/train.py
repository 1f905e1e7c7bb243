"""VAE trainer and latent export (port of ``vae_hmc_tpu.models.train``
``fit`` and ``encode_in_batches``, single device).

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
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from vae_hmc_tpu_torch.core import artifacts
from vae_hmc_tpu_torch.models.convert import flax_params, module_tensors
from vae_hmc_tpu_torch.models.losses import elbo_loss

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


def fit(model: torch.nn.Module, arrays: Sequence[torch.Tensor], *,
        epochs: int, batch_size: int, learning_rate: float,
        beta: float = 1.0, reduction: str = "mean", seed: int = 42,
        kl_anneal_epochs: int = 0, variational: bool = True,
        log_every: int = 1, verbose: bool = False,
        checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
        resume: bool = True, compute_dtype: Optional[str] = None,
        perms: Optional[Sequence[np.ndarray]] = None,
        eps_fn: Optional[Callable[[int, int], torch.Tensor]] = None
        ) -> FitResult:
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
    `eps_fn(epoch, step)` the reparameterization noise of a step (test
    hooks)."""
    if compute_dtype is not None and compute_dtype not in _CAST:
        raise ValueError(f"compute_dtype must be one of {sorted(_CAST)}, "
                         f"got {compute_dtype!r}")
    cast = _CAST.get(compute_dtype)
    n = int(arrays[0].shape[0])
    dev = arrays[0].device
    n_full, rem = divmod(n, batch_size)
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

    def step(idx, epoch, i, beta_now, noise):
        batch = [a[idx] for a in arrays]
        if variational:
            eps = None if eps_fn is None else eps_fn(epoch, i)
            xhat, mu, logvar = forward(batch, eps=eps, generator=noise)
            loss, aux = elbo_loss(xhat, batch[0], mu, logvar, beta_now,
                                  reduction)
        else:
            loss = torch.mean((forward(batch)[0] - batch[0]) ** 2)
            aux = {"total": loss, "recon": loss, "kl": torch.zeros_like(loss)}
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return torch.stack([aux["total"], aux["recon"], aux["kl"]]).detach()

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
        perm = perm.to(dev)
        noise = (_epoch_generator(seed, epoch, _NOISE_STREAM, dev)
                 if variational and eps_fn is None else None)
        beta_now = _beta_at(beta, epoch, kl_anneal_epochs)
        totals = torch.zeros(3, dtype=torch.float32, device=dev)
        for i in range(n_full):
            idx = perm[i * batch_size:(i + 1) * batch_size]
            totals += step(idx, epoch, i, beta_now, noise) * batch_size
        if rem:
            totals += step(perm[n_full * batch_size:], epoch, n_full,
                           beta_now, noise) * rem
        avg = (totals / n).cpu().numpy()                 # one fetch per epoch
        row = {"epoch": epoch + 1, "total": float(avg[0]),
               "recon": float(avg[1]), "kl": float(avg[2])}
        history.append(row)
        if verbose and ((log_every and epoch % log_every == 0)
                        or epoch == epochs - 1):
            print(f"[epoch {epoch + 1:3d}/{epochs}] "
                  f"total {row['total']:.4f} recon {row['recon']:.4f} "
                  f"kl {row['kl']:.4f}")
        if (ckpt_path is not None and checkpoint_every
                and (epoch + 1) % checkpoint_every == 0):
            artifacts.save_checkpoint(
                ckpt_path, _train_state_tree(model, opt),
                metadata={"epoch": epoch + 1, "history": history})
    return FitResult(history=history)


@torch.no_grad()
def encode_in_batches(encode_fn: Callable, arrays: Sequence[torch.Tensor],
                      batch_size: int = 512) -> torch.Tensor:
    """Posterior-mean export over all rows (reference scripts/12:289-309):
    `encode_fn(*batch)` per contiguous batch, concatenated on the device."""
    n = int(arrays[0].shape[0])
    return torch.cat([encode_fn(*(a[s:s + batch_size] for a in arrays))
                      for s in range(0, n, batch_size)], dim=0)
