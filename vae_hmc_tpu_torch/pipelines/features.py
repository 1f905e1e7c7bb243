"""Feature extraction loops (port of ``vae_hmc_tpu.pipelines.features``
``build_mfcc_stats`` and ``build_logmel``).

Per device batch: kernel 1 (``ops.kernels.logmel``) turns the waveforms into
standardized log-mel images or, in its MFCC mode, the dB mel spectrogram
that ``ops.mfcc`` turns into MFCC stats; per-batch results stay on the
device until one fetch after the loop.  Where the waveforms come from:

  - a file-backed source (one with ``host_waveforms``, i.e. ``FileSource``)
    decodes each batch on a ``io.staging.prefetch_batches`` thread while the
    device works on the one before, as the JAX loops do; the host batch is
    copied through page-locked memory (``io.staging.to_device``);
  - ``SyntheticSource`` synthesizes each batch on the device.

Rows with decode errors, too-short clips (hard preset) or non-finite
features are dropped and reported in the ``BuildReport`` rows contract
``(track_id, audio_path, status, reason)``.  The JAX package's fused
synth -> feature scan programs are not ported: they cut TPU dispatches, and
the port's source synthesizes each batch on the device already.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vae_hmc_tpu_torch.core.artifacts import save_csv_rows
from vae_hmc_tpu_torch.core.config import MelConfig, MfccConfig
from vae_hmc_tpu_torch.core.device import resolve_device
from vae_hmc_tpu_torch.io.staging import (batched_indices, prefetch_batches,
                                          to_device)
from vae_hmc_tpu_torch.ops.kernels.logmel import logmel_standardized
from vae_hmc_tpu_torch.ops.mfcc import mfcc_stats_batch
from vae_hmc_tpu_torch.ops.stft import pad_with_reflect_tail


@dataclass
class BuildReport:
    rows: List[Tuple]                    # (track_id, audio_path, status, reason)

    def ok_count(self) -> int:
        return sum(1 for r in self.rows if r[2] == "ok")

    def save(self, path: Path) -> Path:
        return save_csv_rows(path, ["track_id", "audio_path", "status", "reason"],
                             self.rows)


def _path_str(source, i: int) -> str:
    paths = getattr(source, "paths", None)
    return (str(paths[i]) if paths is not None
            else f"synthetic://{int(source.track_ids[i])}")


def _waveform_batches(source, duration_s: float, device_batch: int,
                      dev: torch.device
                      ) -> Iterator[Tuple[Sequence[int], object, np.ndarray,
                                          List[Optional[str]]]]:
    """Yield (idx, batch, lengths, errors) per device batch: `batch` is the
    host numpy batch of a file-backed source, decoded ahead on a prefetch
    thread (ctypes releases the GIL while the native decoder runs), or the
    tensor that a synthetic source made on `dev`."""
    batches = batched_indices(len(source), device_batch)
    if hasattr(source, "host_waveforms"):
        for idx, (batch, lengths, errors) in prefetch_batches(
                lambda ix: source.host_waveforms(ix, duration_s), batches):
            yield idx, batch, lengths, errors
    else:
        for idx in batches:
            yield (idx, *source.waveforms(idx, duration_s, dev))


def _on_device(batch, dev: torch.device) -> torch.Tensor:
    return (batch if isinstance(batch, torch.Tensor)
            else to_device(batch, dev))


def build_mfcc_stats(source, cfg: MfccConfig, device_batch: int = 64,
                     strict: bool = False, device="cuda"
                     ) -> Tuple[np.ndarray, np.ndarray, BuildReport]:
    """-> (X (N_ok, 2*n_mfcc) float32 on the host, track_ids (N_ok,), report).

    Easy preset (fixed-length pad, reference 06:56-89): every track padded /
    trimmed to duration_s, stats over all frames.
    Hard preset (min_duration_s > 0, reference 18:73-97): tracks shorter
    than min_duration are skipped; a batch holding a short clip is staged on
    the host with its reflect tail (``ops.stft.pad_with_reflect_tail``) and
    its stats are masked to the true frame counts.  The stats of every batch
    stay on the device and cross to the host in one fetch after the loop."""
    dev = resolve_device(device)
    masked = cfg.min_duration_s > 0
    min_len = int(cfg.sample_rate * cfg.min_duration_s)
    f_parts, meta = [], []            # meta: (tid, pstr, err, length)
    for idx, batch, lengths, errors in _waveform_batches(
            source, cfg.duration_s, device_batch, dev):
        if strict:
            for r, e in enumerate(errors):
                if e is not None:
                    raise RuntimeError(
                        f"track {int(source.track_ids[idx[r]])}: {e}")
        if masked and int(np.min(lengths)) < cfg.n_samples:
            # keep true lengths: short clips are NOT padded into the stats
            # (reference 18:88 loads duration<=20 s at true length); the
            # reflect tail makes boundary frames exact (see ops.stft).  A
            # file-backed batch is staged from the host batch it came as.
            host = (batch.cpu().numpy() if isinstance(batch, torch.Tensor)
                    else batch)
            staged = np.stack([
                pad_with_reflect_tail(host[r, :max(int(lengths[r]), 2)],
                                      cfg.n_samples, cfg.n_fft)
                for r in range(len(idx))])
            f = mfcc_stats_batch(to_device(staged, dev), cfg,
                                 lengths=torch.as_tensor(lengths, device=dev))
        else:
            # all clips full-length: masked stats == plain stats
            f = mfcc_stats_batch(_on_device(batch, dev), cfg)
        f_parts.append(f)
        meta.extend((int(source.track_ids[i]), _path_str(source, i),
                     errors[r], int(lengths[r])) for r, i in enumerate(idx))
    if not f_parts:
        raise RuntimeError("no tracks produced features")
    f_all = torch.cat(f_parts).cpu().numpy()                 # one fetch
    feats, ids, rows = [], [], []
    for r, (tid, pstr, err, length) in enumerate(meta):
        if err is not None:
            rows.append((tid, pstr, "error", err))
            continue
        if masked and length < min_len:            # <1 s skip (ref 18:88)
            rows.append((tid, pstr, "skipped", "too_short"))
            continue
        if not np.all(np.isfinite(f_all[r])):
            rows.append((tid, pstr, "error", "non_finite_features"))
            continue
        feats.append(f_all[r])
        ids.append(tid)
        rows.append((tid, pstr, "ok", ""))
    if not feats:
        raise RuntimeError("no tracks produced features")
    return (np.stack(feats).astype(np.float32),
            np.asarray(ids, dtype=np.int64), BuildReport(rows))


def build_logmel(source, cfg: MelConfig, device_batch: int = 128,
                 device="cuda") -> Tuple[torch.Tensor, np.ndarray, BuildReport]:
    """-> (X (N_ok, n_mels, T) float32 on `device`, track_ids (N_ok,), report).

    Reproduces reference scripts/10: fixed-length clips, log-mel dB with
    per-sample ref=max and the top_db floor, per-sample standardization;
    T = 1 + n_samples // hop."""
    dev = resolve_device(device)
    feats, finite_parts, meta = [], [], []   # meta: (tid, pstr, err-or-None)
    for idx, batch, _lengths, errors in _waveform_batches(
            source, cfg.duration_s, device_batch, dev):
        x = logmel_standardized(_on_device(batch, dev), cfg)
        keep = [r for r, e in enumerate(errors) if e is None]
        if len(keep) != len(idx):
            x = x[torch.as_tensor(keep, device=dev)]
        if keep:
            finite_parts.append(torch.isfinite(x).all(dim=2).all(dim=1))
            feats.append(x)
        meta.extend((int(source.track_ids[i]), _path_str(source, i),
                     errors[r]) for r, i in enumerate(idx))
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
