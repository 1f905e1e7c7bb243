"""What the program's fit does, read from the model it trains, and the
numbers the check compares of it.

``FitCapture`` hooks one model (never a global hook): its parameters'
gradients in the first step, its first three training outputs, its
parameters after three steps, and the count of training steps (forward
calls in training mode; the export calls ``encode`` in eval mode).  As the
fit's ``eps_fn`` it hands on the benchmark's noise.
"""
from __future__ import annotations

import math
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import conv_vae as ref_vae


class FitCapture:
    def __init__(self, model: torch.nn.Module,
                 noise: Optional[Callable] = None):
        self.params = dict(model.named_parameters())
        self.noise = noise
        self.steps = 0
        self.grad0: Dict[str, torch.Tensor] = {}
        self.after3: Dict[str, torch.Tensor] = {}
        self.outputs: List[tuple] = []
        self._grads = [p.register_hook(self._hook(k))
                       for k, p in self.params.items()]
        self._pre = model.register_forward_pre_hook(self._step)
        self._post = model.register_forward_hook(self._forward)

    def _hook(self, name):
        def hook(g):
            self.grad0[name] = g.detach().clone()
        return hook

    def _step(self, module, args):
        if not module.training:
            return
        self.steps += 1
        if self.steps == 2:
            for h in self._grads:
                h.remove()
            self._grads = []
        elif self.steps == 4:
            self.after3 = self._now()

    def _forward(self, module, args, out):
        if module.training and len(self.outputs) < 3:
            self.outputs.append(tuple(o.detach().clone() for o in out))

    def _now(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach().clone() for k, p in self.params.items()}

    def __call__(self, epoch: int, step: int) -> torch.Tensor:
        return self.noise(epoch, step)

    def close(self) -> dict:
        """Removes the hooks; -> {"steps", "grad0", "after3", "outputs",
        "final"} (after3 is the final state where the fit took three steps
        or fewer)."""
        for h in self._grads + [self._pre, self._post]:
            h.remove()
        self._grads = []
        final = self._now()
        return {"steps": self.steps, "grad0": self.grad0,
                "after3": self.after3 or final, "outputs": self.outputs,
                "final": final}


def steps_per_epoch(n: int, batch: int) -> int:
    return -(-n // batch)


def first_step_numbers(prog: dict, ref: dict, w0: Dict[str, torch.Tensor],
                       tag: str = "") -> Dict[str, float]:
    """grad0 and delta3 (each the worst leaf's gap of norms, against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger) and loss3 (the worst relative gap of the first three steps'
    losses).  Leaves whose reference gradient is under a thousandth of the
    median leaf's are left out of grad0 and delta3: they move under Adam by
    round-off alone.  The worst leaves are named on stderr."""
    g_ref = ref_vae.leaf_norms(ref["grad0"])
    med = float(np.median(list(g_ref.values())))
    skip = [k for k, v in g_ref.items() if v < 1e-3 * med]
    zero = {k: 0.0 for k in g_ref}
    g_prog = {**zero, **ref_vae.leaf_norms(prog["grad0"])}
    d_ref = ref_vae.leaf_norms({k: v - w0[k]
                                for k, v in ref["after3"].items()})
    d_prog = ref_vae.leaf_norms({k: v - w0[k]
                                 for k, v in prog["after3"].items()})
    grad0, g_leaf = ref_vae.worst_leaf_gap(g_prog, g_ref, skip)
    delta3, d_leaf = ref_vae.worst_leaf_gap({**zero, **d_prog}, d_ref, skip)
    losses = prog["losses"]
    loss3 = (max(abs(p - r) / abs(r) for p, r in zip(losses, ref["losses"]))
             if len(losses) == 3 else math.inf)
    print(f"[bench] worst leaves{tag}: grad0 {g_leaf}, delta3 {d_leaf}",
          file=sys.stderr, flush=True)
    return {"grad0": grad0, "delta3": delta3, "loss3": loss3}
