"""Log-mel feature extraction driver (port of
``vae_hmc_tpu.pipelines.features.build_logmel``).

Per device batch: the source synthesizes (or stages) waveforms on the
device, kernel 1 (``ops.kernels.logmel``) turns them into standardized
log-mel images, and the per-track finite flags stay on the device until one
fetch after the loop.  Rows with decode errors or non-finite features are
dropped and reported in the ``BuildReport`` rows contract
``(track_id, audio_path, status, reason)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from vae_hmc_tpu_torch.core.artifacts import save_csv_rows
from vae_hmc_tpu_torch.core.config import MelConfig
from vae_hmc_tpu_torch.core.device import resolve_device
from vae_hmc_tpu_torch.ops.kernels.logmel import logmel_standardized


@dataclass
class BuildReport:
    rows: List[Tuple]                    # (track_id, audio_path, status, reason)

    def ok_count(self) -> int:
        return sum(1 for r in self.rows if r[2] == "ok")

    def save(self, path: Path) -> Path:
        return save_csv_rows(path, ["track_id", "audio_path", "status", "reason"],
                             self.rows)


def build_logmel(source, cfg: MelConfig, device_batch: int = 128,
                 device="cuda") -> Tuple[torch.Tensor, np.ndarray, BuildReport]:
    """-> (X (N_ok, n_mels, T) float32 on `device`, track_ids (N_ok,), report).

    Reproduces reference scripts/10: fixed-length clips, log-mel dB with
    per-sample ref=max and the top_db floor, per-sample standardization;
    T = 1 + n_samples // hop."""
    dev = resolve_device(device)
    n = len(source)
    paths = getattr(source, "paths", None)

    def _pstr(i):
        return (str(paths[i]) if paths is not None
                else f"synthetic://{int(source.track_ids[i])}")

    feats, finite_parts, meta = [], [], []   # meta: (tid, pstr, err-or-None)
    for start in range(0, n, device_batch):
        idx = list(range(start, min(start + device_batch, n)))
        batch, _lengths, errors = source.waveforms(idx, cfg.duration_s, dev)
        x = logmel_standardized(batch, cfg)
        keep = [r for r, e in enumerate(errors) if e is None]
        if len(keep) != len(idx):
            x = x[torch.as_tensor(keep, device=dev)]
        if keep:
            finite_parts.append(torch.isfinite(x).all(dim=2).all(dim=1))
            feats.append(x)
        meta.extend((int(source.track_ids[i]), _pstr(i), errors[r])
                    for r, i in enumerate(idx))
    if not feats:
        raise RuntimeError("no tracks produced features")
    finite = torch.cat(finite_parts).cpu().numpy()          # one small fetch
    ids, rows, keep_pos = [], [], []
    p = 0                        # position among the non-error rows
    for tid, pstr, err in meta:
        if err is not None:
            rows.append((tid, pstr, "error", err))
            continue
        if not finite[p]:
            rows.append((tid, pstr, "error", "non_finite_features"))
        else:
            keep_pos.append(p)
            ids.append(tid)
            rows.append((tid, pstr, "ok", ""))
        p += 1
    if not keep_pos:
        raise RuntimeError("no tracks produced features")
    X = feats[0] if len(feats) == 1 else torch.cat(feats, dim=0)
    if len(keep_pos) != p:
        X = X[torch.as_tensor(keep_pos, device=dev)]
    return X, np.asarray(ids, dtype=np.int64), BuildReport(rows)
