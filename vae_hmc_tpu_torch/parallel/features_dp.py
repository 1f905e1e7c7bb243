"""Data-parallel feature extraction over a mesh (port of
``vae_hmc_tpu.parallel.features_dp``).

The feature layer is embarrassingly parallel over tracks: every output row
depends only on its own waveform.  Each data index of the mesh computes
its share of the rows through kernel 1 (``ops/kernels/logmel``; the plain
version for CPU tensors), and the shares are gathered over 'data'
(``collectives.all_gather_rows``), so every rank returns the full (B, ...)
result.  As in the JAX package the rows are zero-padded to a multiple of
the 'data' axis, every data index computes the same number of rows, and the
padding rows are sliced off.

``synth_features_sharded`` builds a synthetic source's features through
the existing per-batch path (``pipelines/features``), with no fused scan:
each rank computes the device batches of the whole corpus's batch grid
that hold its rows, so its rows are the single-device build's bit for bit
(a synthetic batch's noise is seeded by its first row).
"""
from __future__ import annotations

from typing import Callable

import torch

from vae_hmc_tpu_torch.ops import mel as mel_ops
from vae_hmc_tpu_torch.ops.kernels.logmel import (logmel_standardized,
                                                  mel_db_standardize)
from vae_hmc_tpu_torch.ops.mfcc import mfcc_stats_batch
from vae_hmc_tpu_torch.ops.stft import power_spectrogram
from vae_hmc_tpu_torch.parallel import collectives
from vae_hmc_tpu_torch.parallel.multihost import (padded_rows,
                                                  process_row_range)


def _padded(a: torch.Tensor, n: int, fill) -> torch.Tensor:
    if a.shape[0] == n:
        return a
    pad = a.new_full((n - a.shape[0],) + tuple(a.shape[1:]), fill)
    return torch.cat([a, pad])


def sharded_batch_apply(fn: Callable, mesh, y, *extra) -> torch.Tensor:
    """Run the per-row feature program ``fn(y, *extra)`` with the rows
    split over `mesh`'s 'data' axis: `y` and every array in `extra` share
    the leading batch dim and are the same on every rank; rows are
    zero-padded to the data-axis multiple, each data index runs its share
    on the mesh's device, and the result is gathered and sliced back to the
    true row count on every rank.  ``fn`` must be row-independent (true of
    every op in ops/mel, ops/mfcc and kernel 1).  Only the rank's share
    of each array moves to the device."""
    b = int(y.shape[0])
    n = padded_rows(b, mesh)
    per = n // mesh.shape["data"]
    lo = mesh.data_index * per
    share = [_padded(torch.as_tensor(a[lo:lo + per], device=mesh.device),
                     per, 0) for a in (y,) + extra]
    out = fn(*share)
    return collectives.all_gather_rows(out, lo, n, mesh.data_group)[:b]


def _logmel_raw(y: torch.Tensor, cfg) -> torch.Tensor:
    """(B, n_samples) -> log-mel dB (B, n_mels, T) through kernel 1: ref
    max or 1.0 and the top_db floor of `cfg`, no standardization."""
    spec = power_spectrogram(y, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                             power=cfg.power)
    return mel_db_standardize(
        spec, mel_ops.mel_table(cfg, y.device), ref_max=cfg.ref_max,
        top_db=mel_ops.effective_top_db(cfg), standardize=False)


def logmel_batch_sharded(y, cfg, mesh) -> torch.Tensor:
    """Sharded ``ops.mel.logmel_batch``: (B, n_samples) -> (B, n_mels, T)
    dB with rows split over 'data', through kernel 1."""
    return sharded_batch_apply(lambda a: _logmel_raw(a, cfg), mesh,
                               torch.as_tensor(y, dtype=torch.float32))


def mfcc_stats_batch_sharded(y, cfg, mesh, lengths=None) -> torch.Tensor:
    """Sharded ``ops.mfcc.mfcc_stats_batch``: (B, n_samples) ->
    (B, 2*n_mfcc), through kernel 1's MFCC mode.  ``lengths`` (true sample
    counts, the hard preset's masked stats) shard alongside the rows;
    padding rows get length ``cfg.n_samples`` so their (discarded) stats
    stay finite."""
    y = torch.as_tensor(y, dtype=torch.float32)
    if lengths is None:
        return sharded_batch_apply(lambda a: mfcc_stats_batch(a, cfg), mesh,
                                   y)
    n = padded_rows(int(y.shape[0]), mesh)
    lengths = _padded(torch.as_tensor(lengths), n, cfg.n_samples)
    return sharded_batch_apply(
        lambda a, ln: mfcc_stats_batch(a, cfg, lengths=ln), mesh, y,
        lengths)


def synth_rows(source, cfg, device_batch: int, kind: str,
               device) -> Callable[[int, int], torch.Tensor]:
    """-> rows_fn(start, stop): features of the source's rows [start, stop)
    on `device`, computed per device batch of the whole corpus's batch grid
    ([i * device_batch, (i + 1) * device_batch)), as the single-device
    build computes them: standardized log-mel (kind="logmel", kernel 1) or
    MFCC stats (kind="mfcc", kernel 1's MFCC mode)."""
    feature = {"logmel": logmel_standardized,
               "mfcc": mfcc_stats_batch}[kind]

    def rows_fn(start: int, stop: int) -> torch.Tensor:
        parts = []
        first = start // device_batch * device_batch
        for lo in range(first, stop, device_batch):
            hi = min(lo + device_batch, len(source))
            y, _, _ = source.waveforms(list(range(lo, hi)), cfg.duration_s,
                                       device)
            parts.append(feature(y, cfg)[max(start, lo) - lo:stop - lo])
        return torch.cat(parts) if len(parts) > 1 else parts[0]
    return rows_fn


def synth_features_sharded(source, cfg, mesh, device_batch: int = 128,
                           kind: str = "logmel") -> torch.Tensor:
    """The counterpart of ``synth_features_fused_sharded``: a synthetic
    source's features with the rows split over 'data', each rank building
    its own rows through the per-batch path (``synth_rows``), gathered on
    every rank.  -> (N, n_mels, T) for kind="logmel" (standardized, as
    ``pipelines/features.build_logmel``), (N, 2*n_mfcc) for kind="mfcc"."""
    n = len(source)
    start, stop = process_row_range(n, mesh=mesh)
    tail = ((cfg.n_mels, cfg.n_frames) if kind == "logmel"
            else (2 * cfg.n_mfcc,))
    local = (synth_rows(source, cfg, device_batch, kind, mesh.device)(
        start, stop) if stop > start else torch.zeros(
            (0,) + tail, device=mesh.device))
    return collectives.all_gather_rows(local, start, n, mesh.data_group)
