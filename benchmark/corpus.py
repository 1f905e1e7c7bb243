"""The benchmark's corpus: genre-structured waveforms, track ids, genres and
lyric texts, all made from the run's seed.

A rewrite of the port's synthetic generator (``pipelines/synthetic.py``),
frozen here so that a change to the program cannot move the yardstick.
Each of the six FMA-small genres has its own audio recipe (f0 register,
number of harmonics, harmonic decay, noise floor, amplitude-modulation
rate) and its own lyric vocabulary, so the clustering chain has structure
to find.  The waveforms are made on the device in blocks of rows from one
``torch.Generator``; the small per-track tables come from a numpy
generator.  The same seed gives the same corpus.

``BenchSource`` serves the corpus through the interface the port's feature
loops read (``__len__``, ``track_ids``, ``genres``, ``sample_rate``,
``lyrics_text``, ``waveforms``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

GENRES = ("Experimental", "Folk", "Hip-Hop", "International", "Pop", "Rock")
# (f0 low Hz, f0 high Hz, harmonics, harmonic decay, noise level, AM Hz)
RECIPES = {
    "Experimental": (200.0, 900.0, 7, 0.9, 0.30, 0.3),
    "Folk": (196.0, 392.0, 5, 0.5, 0.05, 1.0),
    "Hip-Hop": (65.0, 130.0, 2, 0.4, 0.15, 2.0),
    "International": (55.0, 110.0, 3, 0.3, 0.02, 4.0),
    "Pop": (262.0, 523.0, 4, 0.45, 0.04, 1.5),
    "Rock": (110.0, 220.0, 6, 0.7, 0.12, 2.5),
}
VOCAB = {
    "Experimental": "texture drift static field shape silence granular hiss "
                    "form",
    "Folk": "river mountain home winter road heart wooden child morning land",
    "Hip-Hop": "street flow hustle city block mic rhyme crown chain game",
    "International": "night lights neon pulse machine dance floor glow echo "
                     "wire",
    "Pop": "love baby heart tonight forever dance shine dream kiss stay",
    "Rock": "fire road thunder midnight engine scream wild steel run blood",
}
WORDS_PER_TEXT = 60
MAX_HARMONICS = max(r[2] for r in RECIPES.values())
SEED_MASK = (1 << 63) - 1
BLOCK_ROWS = 256


@dataclass
class Corpus:
    track_ids: np.ndarray            # (N,) int64
    genres: np.ndarray               # (N,) str
    genre_idx: np.ndarray            # (N,) int64, index into GENRES
    has_lyrics: np.ndarray           # (N,) bool
    texts: List[Optional[str]]       # None where a track has no lyrics
    waveforms: torch.Tensor          # (N, n_samples) float32 on the device
    sample_rate: int

    def head(self, n: int) -> "Corpus":
        """The first `n` tracks (a view of the waveforms)."""
        return Corpus(track_ids=self.track_ids[:n], genres=self.genres[:n],
                      genre_idx=self.genre_idx[:n],
                      has_lyrics=self.has_lyrics[:n], texts=self.texts[:n],
                      waveforms=self.waveforms[:n],
                      sample_rate=self.sample_rate)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed & SEED_MASK, stream])


def make_corpus(n_tracks: int, duration_s: float, sample_rate: int,
                lyrics_coverage: float, seed: int,
                device: torch.device) -> Corpus:
    """The whole corpus of one run, its waveforms on `device`."""
    rng = _rng(seed, 0)
    genre_idx = rng.permutation(np.arange(n_tracks) % len(GENRES))
    genres = np.asarray([GENRES[g] for g in genre_idx])
    has_lyrics = rng.random(n_tracks) < lyrics_coverage
    draws = rng.random((n_tracks, WORDS_PER_TEXT))
    vocab = [VOCAB[g].split() for g in GENRES]
    texts = []
    for i in range(n_tracks):
        words = vocab[genre_idx[i]]
        texts.append(" ".join(words[int(u * len(words))] for u in draws[i])
                     if has_lyrics[i] else None)

    table = np.asarray([RECIPES[g] for g in GENRES], np.float64)[genre_idx]
    f0 = table[:, 0] + (table[:, 1] - table[:, 0]) * rng.random(n_tracks)
    h = np.arange(MAX_HARMONICS)[None, :]
    on = h < table[:, 2:3]
    amps = np.where(on, table[:, 3:4] ** h, 0.0)
    freqs = f0[:, None] * (h + 1)
    phases = 2 * np.pi * rng.random((n_tracks, MAX_HARMONICS))
    am = table[:, 5:6]
    am_phase = 2 * np.pi * rng.random((n_tracks, 1))
    noise = table[:, 4:5]

    def dev32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    amps, freqs, phases, am, am_phase, noise = map(
        dev32, (amps, freqs, phases, am, am_phase, noise))
    n = int(round(sample_rate * duration_s))
    t = torch.arange(n, dtype=torch.float32, device=device) / sample_rate
    gen = torch.Generator(device=device)
    gen.manual_seed(int(_rng(seed, 1).integers(0, 2 ** 62)))
    out = torch.empty((n_tracks, n), dtype=torch.float32, device=device)
    two_pi = 2 * math.pi
    for s in range(0, n_tracks, BLOCK_ROWS):
        e = min(s + BLOCK_ROWS, n_tracks)
        sig = torch.randn((e - s, n), generator=gen, device=device)
        sig.mul_(noise[s:e])
        for k in range(MAX_HARMONICS):
            sig.add_(amps[s:e, k:k + 1] * torch.sin(
                two_pi * freqs[s:e, k:k + 1] * t + phases[s:e, k:k + 1]))
        sig.mul_(1.0 + 0.5 * torch.sin(two_pi * am[s:e] * t
                                       + am_phase[s:e]))
        peak = torch.amax(sig.abs(), dim=1, keepdim=True) + 1e-9
        out[s:e] = sig * (0.3 / peak)
    return Corpus(track_ids=np.arange(100000, 100000 + n_tracks,
                                      dtype=np.int64),
                  genres=genres, genre_idx=genre_idx.astype(np.int64),
                  has_lyrics=has_lyrics, texts=texts, waveforms=out,
                  sample_rate=sample_rate)


def lyric_vocab() -> dict:
    """WordPiece vocabulary of the corpus: the four special tokens, then
    every lyric word whole, in a fixed order."""
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3}
    for g in GENRES:
        for w in VOCAB[g].split():
            vocab.setdefault(w, len(vocab))
    return vocab


class BenchSource:
    """The corpus as a source of the port's feature loops.  ``waveforms``
    returns a view of the device-resident corpus: nothing is made per
    batch."""

    def __init__(self, corpus: Corpus):
        self.corpus = corpus
        self.track_ids = corpus.track_ids
        self.genres = corpus.genres
        self.sample_rate = corpus.sample_rate

    def __len__(self) -> int:
        return len(self.track_ids)

    def lyrics_text(self, i: int) -> Optional[str]:
        return self.corpus.texts[i]

    def waveforms(self, idx: Sequence[int], duration_s: float,
                  device: torch.device):
        n = int(round(self.sample_rate * duration_s))
        wave = self.corpus.waveforms
        if n > wave.shape[1]:
            raise ValueError(f"{duration_s} s asked of a corpus of "
                             f"{wave.shape[1] / self.sample_rate} s clips")
        idx = list(idx)
        if idx != list(range(idx[0], idx[0] + len(idx))):
            raise ValueError("BenchSource serves contiguous batches of rows")
        batch = wave[idx[0]:idx[0] + len(idx), :n].to(device)
        return (batch, np.full(len(idx), n, dtype=np.int32),
                [None] * len(idx))
