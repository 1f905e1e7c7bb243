"""Data sources feeding the feature pipelines (port of
``vae_hmc_tpu.pipelines.sources``).

A source abstracts where waveforms and lyrics come from.  Implementations:

  - SyntheticSource: deterministic genre-structured signals; the per-track
    recipe parameters (~16 floats) are made on the host and the
    sample-level synthesis runs on the device (``synthetic.synth_core``);
  - FileSource: decodes the audio files a manifest lists through
    ``io.audio`` (the port's native decoder for wav and mp3), keeping the
    reference's skip-on-error policy (scripts/10:131-174): a row that fails
    to decode carries its error string and stays zeros.  Its host batches
    come from ``host_waveforms``, which the feature loops call on a
    prefetch thread (``io.staging``) while the device works.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vae_hmc_tpu_torch.pipelines import synthetic


class Source:
    """Interface: ids/genres/lyrics + batched waveform access."""

    track_ids: np.ndarray
    genres: np.ndarray
    sample_rate: int = 22050

    def __len__(self):
        return len(self.track_ids)

    def lyrics_text(self, i: int) -> Optional[str]:
        raise NotImplementedError

    def waveforms(self, idx: Sequence[int], duration_s: float,
                  device: torch.device
                  ) -> Tuple[torch.Tensor, np.ndarray, List[Optional[str]]]:
        """-> (batch (B, n_samples) float32 on `device`, zero-padded; true
        sample lengths (B,) int32; per-row error strings or None)."""
        raise NotImplementedError


@dataclass
class SyntheticSource(Source):
    ds: synthetic.SyntheticDataset
    seed: int = 42

    def __post_init__(self):
        self.track_ids = self.ds.track_ids
        self.genres = self.ds.genres
        self.sample_rate = self.ds.sample_rate

    def lyrics_text(self, i: int) -> Optional[str]:
        return self.ds.lyrics[i]

    def waveforms(self, idx, duration_s, device):
        """The noise generator is seeded from (seed, first row), so a batch
        regenerates identically whatever batches came before it."""
        n = int(round(self.sample_rate * duration_s))
        p = synthetic.synth_param_arrays(self.ds, idx, self.seed)
        t = {k: torch.from_numpy(v).to(device) for k, v in p.items()}
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed * 1000003 + int(idx[0]))
        batch = synthetic.synth_core(
            t["amps"], t["freqs"], t["phases"], t["am_rate"], t["am_phase"],
            t["noise_lv"], gen, n, self.sample_rate)
        lengths = np.full(len(idx), n, dtype=np.int32)
        return batch, lengths, [None] * len(idx)

    @classmethod
    def make(cls, n_tracks: int = 2924, seed: int = 42,
             lyrics_coverage: float = 0.9) -> "SyntheticSource":
        return cls(synthetic.make_dataset(n_tracks, seed, lyrics_coverage),
                   seed=seed)


@dataclass
class FileSource(Source):
    """Audio-file-backed source (manifest rows with audio_path).  The rows
    of a batch decode on up to 8 threads at once (the native decoder
    releases the GIL); each row is decoded alone, so the batch does not
    depend on the number of threads."""

    ids: np.ndarray
    genre_arr: np.ndarray
    paths: List[Path]
    texts: List[Optional[str]]
    sample_rate: int = 22050

    def __post_init__(self):
        self.track_ids = self.ids
        self.genres = self.genre_arr

    def lyrics_text(self, i: int) -> Optional[str]:
        return self.texts[i]

    def host_waveforms(self, idx: Sequence[int], duration_s: float
                       ) -> Tuple[np.ndarray, np.ndarray, List[Optional[str]]]:
        """-> (batch (B, n_samples) float32 numpy, zero-padded; true sample
        lengths (B,) int32; per-row error strings or None).  Loads the
        native library first, so a failed build raises here instead of
        sending every row through the reference's slower fallbacks."""
        from vae_hmc_tpu_torch.io import native
        from vae_hmc_tpu_torch.io.audio import load_audio

        native.get_lib()
        target = int(round(self.sample_rate * duration_s))
        out = np.zeros((len(idx), target), dtype=np.float32)
        lengths = np.zeros(len(idx), dtype=np.int32)
        errors: List[Optional[str]] = [None] * len(idx)

        def decode(row: int) -> None:
            try:
                y = load_audio(self.paths[idx[row]], self.sample_rate,
                               max_duration_s=duration_s)
                n = min(len(y), target)
                out[row, :n] = y[:n]
                lengths[row] = n
            except Exception as e:  # skip-and-record (ref 10:167-174)
                errors[row] = f"{type(e).__name__}: {e}"

        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)
                                ) as pool:
            for f in [pool.submit(decode, r) for r in range(len(idx))]:
                f.result()
        return out, lengths, errors

    def waveforms(self, idx, duration_s, device):
        from vae_hmc_tpu_torch.io.staging import to_device

        batch, lengths, errors = self.host_waveforms(idx, duration_s)
        return to_device(batch, device), lengths, errors

    @classmethod
    def from_manifest(cls, manifest, root: Optional[Path] = None,
                      sample_rate: int = 22050) -> "FileSource":
        texts: List[Optional[str]] = []
        for p in manifest.text_paths(root):
            if p is not None and Path(p).exists():
                texts.append(Path(p).read_text(encoding="utf-8",
                                               errors="replace"))
            else:
                texts.append(None)
        return cls(ids=manifest.track_ids, genre_arr=manifest.genres,
                   paths=manifest.audio_paths(root), texts=texts,
                   sample_rate=sample_rate)
