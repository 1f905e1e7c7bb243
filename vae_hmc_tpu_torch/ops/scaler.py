"""StandardScaler-equivalent feature normalization (port of
``vae_hmc_tpu.ops.scaler``).

sklearn.preprocessing.StandardScaler semantics (population std, ddof=0;
zero-variance columns left unscaled via std->1).  The statistics are fitted
in float64 on the host and kept as numpy; transform runs on the device and
returns a float32 tensor there.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from vae_hmc_tpu_torch.core.device import resolve_device


@dataclass
class StandardScaler:
    mean_: Optional[np.ndarray] = None
    scale_: Optional[np.ndarray] = None

    def fit(self, x) -> "StandardScaler":
        x = np.asarray(x, dtype=np.float64)
        self.mean_ = x.mean(axis=0)
        std = x.std(axis=0)               # ddof=0, sklearn default
        std[std == 0.0] = 1.0             # sklearn _handle_zeros_in_scale
        self.scale_ = std
        return self

    def transform(self, x, device="cuda") -> torch.Tensor:
        if self.mean_ is None:
            raise RuntimeError("scaler not fitted")
        dev = resolve_device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        return (t(x) - t(self.mean_)) / t(self.scale_)

    def fit_transform(self, x, device="cuda") -> torch.Tensor:
        return self.fit(x).transform(x, device)

    def save(self, path: Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, mean=self.mean_, scale=self.scale_)
        return path

    @classmethod
    def load(cls, path: Path) -> "StandardScaler":
        d = np.load(path)
        return cls(mean_=d["mean"], scale_=d["scale"])


def standardize(x, device="cuda") -> torch.Tensor:
    """One-shot fit_transform returning a float32 tensor.  A tensor is
    standardized on its own device (float32 statistics, the same
    semantics); host numpy goes through ``StandardScaler`` (float64
    statistics) to `device`."""
    if isinstance(x, torch.Tensor):
        mean = torch.mean(x, dim=0)
        std = torch.std(x, dim=0, correction=0)
        return (x - mean) / torch.where(std == 0.0, 1.0, std)
    return StandardScaler().fit_transform(x, device)
