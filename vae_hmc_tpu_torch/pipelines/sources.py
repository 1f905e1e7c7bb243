"""Data sources feeding the feature pipeline (port of
``vae_hmc_tpu.pipelines.sources``; ``SyntheticSource`` only).

A source yields waveform batches on the requested device: here the
per-track recipe parameters (~16 floats) are made on the host and the
sample-level synthesis runs on the device (``synthetic.synth_core``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vae_hmc_tpu_torch.pipelines import synthetic


@dataclass
class SyntheticSource:
    ds: synthetic.SyntheticDataset
    seed: int = 42

    def __post_init__(self):
        self.track_ids = self.ds.track_ids
        self.genres = self.ds.genres
        self.sample_rate = self.ds.sample_rate

    def __len__(self):
        return len(self.track_ids)

    def lyrics_text(self, i: int) -> Optional[str]:
        return self.ds.lyrics[i]

    def waveforms(self, idx: Sequence[int], duration_s: float,
                  device: torch.device
                  ) -> Tuple[torch.Tensor, np.ndarray, List[Optional[str]]]:
        """-> (batch (B, n_samples) float32 on `device`, true lengths (B,),
        per-row error strings or None).

        The noise generator is seeded from (seed, first row), so a batch
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
