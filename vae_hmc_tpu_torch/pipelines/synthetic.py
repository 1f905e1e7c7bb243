"""Deterministic synthetic dataset: genre-structured waveforms + lyrics.

Copy of ``vae_hmc_tpu.pipelines.synthetic`` (the numpy parts verbatim) with
the device synthesis body ``synth_core`` rewritten in torch.  Each genre is
a distinct audio recipe (f0 register, harmonic decay, noise floor, AM rate),
so the features are clusterable and the VAE -> KMeans -> metrics chain
gives non-degenerate scores.  Generation is keyed by (seed, track_id).

The noise term cannot match the JAX package (threefry vs Philox); with
``noise_lv = 0`` the torch synthesis equals the JAX one to f32 roundoff
(tests/test_torch_slice.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

GENRES = ("Experimental", "Folk", "Hip-Hop", "International", "Pop", "Rock")
# distinct per-genre audio recipes: (f0 range, n harmonics, harmonic decay,
# noise level, AM rate Hz)
_RECIPES = {
    "International": ((55.0, 110.0), 3, 0.3, 0.02, 4.0),
    "Experimental": ((200.0, 900.0), 7, 0.9, 0.30, 0.3),
    "Folk":         ((196.0, 392.0), 5, 0.5, 0.05, 1.0),
    "Hip-Hop":      ((65.0, 130.0), 2, 0.4, 0.15, 2.0),
    "Pop":          ((262.0, 523.0), 4, 0.45, 0.04, 1.5),
    "Rock":         ((110.0, 220.0), 6, 0.7, 0.12, 2.5),
}

_LYRIC_VOCAB = {
    "International": "night lights neon pulse machine dance floor glow echo wire",
    "Experimental": "texture drift static field shape silence granular hiss form",
    "Folk": "river mountain home winter road heart wooden child morning land",
    "Hip-Hop": "street flow hustle city block mic rhyme crown chain game",
    "Pop": "love baby heart tonight forever dance shine dream kiss stay",
    "Rock": "fire road thunder midnight engine scream wild steel run blood",
}


@dataclass
class SyntheticDataset:
    track_ids: np.ndarray            # (N,) int64
    genres: np.ndarray               # (N,) str
    titles: List[str]
    artists: List[str]
    has_lyrics: np.ndarray           # (N,) bool (some tracks missing text)
    lyrics: List[Optional[str]]
    sample_rate: int = 22050
    # per-row text provenance ("whisper"/"genius"/"both"/""), set by
    # dataset_from_manifest
    text_sources: Optional[List[str]] = None

    def __len__(self):
        return len(self.track_ids)


def make_dataset(n_tracks: int = 2924, seed: int = 42,
                 lyrics_coverage: float = 0.9,
                 genres: Sequence[str] = GENRES) -> SyntheticDataset:
    rng = np.random.default_rng(seed)
    g = np.asarray([genres[i % len(genres)] for i in range(n_tracks)])
    rng.shuffle(g)
    track_ids = np.arange(100000, 100000 + n_tracks, dtype=np.int64)
    has_lyrics = rng.random(n_tracks) < lyrics_coverage
    lyrics: List[Optional[str]] = [
        _lyrics_for(g[i], int(track_ids[i]), seed) if has_lyrics[i] else None
        for i in range(n_tracks)]
    titles = [f"track {int(t)}" for t in track_ids]
    artists = [f"artist {int(t) % 97}" for t in track_ids]
    return SyntheticDataset(track_ids=track_ids, genres=g, titles=titles,
                            artists=artists, has_lyrics=has_lyrics,
                            lyrics=lyrics)


def _recipe_genre(genre: str) -> str:
    """Map an arbitrary genre string onto a recipe key: exact match for the
    six FMA-small genres, else a stable hash pick."""
    g = str(genre)
    if g in _RECIPES:
        return g
    keys = sorted(_RECIPES)
    return keys[sum(g.encode()) % len(keys)]


# words that appear in songs of EVERY genre: the manifest-backed source
# mixes these in so the lyrics representation is not perfectly separable
_SHARED_VOCAB = ("yeah time know way day eyes light world feel life gone "
                 "never always one say take hold fall").split()


def _lyrics_for(genre: str, track_id: int, seed: int,
                shared_frac: float = 0.0) -> str:
    """Deterministic genre-vocab lyric text keyed by (seed, track_id).

    shared_frac > 0 mixes in cross-genre words at that rate (used by
    dataset_from_manifest); make_dataset keeps shared_frac = 0, whose draws
    are those of the plain per-genre text."""
    vocab = _LYRIC_VOCAB[_recipe_genre(genre)].split()
    r = np.random.default_rng(seed * 1000003 + int(track_id))
    words = r.choice(vocab, size=60, replace=True)
    if shared_frac > 0.0:
        mix = r.random(60) < shared_frac
        shared = r.choice(np.asarray(_SHARED_VOCAB), size=60, replace=True)
        words = np.where(mix, shared, words)
    return " ".join(words)


def dataset_from_manifest(manifest_path, seed: int = 42) -> SyntheticDataset:
    """SyntheticDataset driven by a REAL manifest: its track ids, genres
    (skew included), titles, artists and text coverage, with synthetic
    waveforms (per-genre recipes keyed by the real track_id) and lyric
    texts (genre vocab, rows with text only).  Whisper-sourced rows get
    more cross-genre words than curated genius lyrics."""
    from vae_hmc_tpu_torch.core.manifest import read_manifest

    m = read_manifest(manifest_path, required=("track_id", "genre"))
    track_ids = m.track_ids
    genres = m.genres
    titles = [r.get("title", f"track {r['track_id']}") for r in m.rows]
    artists = [r.get("artist", "unknown") for r in m.rows]
    # text_exists column when present (reference 05:46-48); otherwise any
    # text path counts as coverage
    has = []
    for r in m.rows:
        te = r.get("text_exists")
        if te is not None and te != "":
            has.append(str(te).strip().lower() == "true")
        else:
            has.append(bool(r.get("text_path_combined")
                            or r.get("lyrics_path")))
    has_lyrics = np.asarray(has, dtype=bool)
    sources = [r.get("text_source_combined", r.get("lyrics_source", ""))
               for r in m.rows]
    frac = {"whisper": 0.45, "both": 0.3}
    lyrics: List[Optional[str]] = [
        _lyrics_for(genres[i], int(track_ids[i]), seed,
                    shared_frac=frac.get(sources[i], 0.2))
        if has_lyrics[i] else None
        for i in range(len(m))
    ]
    return SyntheticDataset(track_ids=track_ids, genres=genres, titles=titles,
                            artists=artists, has_lyrics=has_lyrics,
                            lyrics=lyrics, text_sources=sources)


def waveform(track_id: int, genre: str, duration_s: float, seed: int = 42,
             sample_rate: int = 22050) -> np.ndarray:
    """Deterministic per-track waveform from the genre recipe (host numpy)."""
    (f_lo, f_hi), n_harm, decay, noise, am = _RECIPES[_recipe_genre(genre)]
    r = np.random.default_rng(seed * 7 + int(track_id))
    n = int(round(sample_rate * duration_s))
    t = np.arange(n, dtype=np.float64) / sample_rate
    f0 = r.uniform(f_lo, f_hi)
    sig = np.zeros(n)
    for h in range(1, n_harm + 1):
        amp = decay ** (h - 1)
        sig += amp * np.sin(2 * np.pi * f0 * h * t + r.uniform(0, 2 * np.pi))
    sig *= 1.0 + 0.5 * np.sin(2 * np.pi * am * t + r.uniform(0, 2 * np.pi))
    sig += noise * r.standard_normal(n)
    sig *= 0.3 / (np.max(np.abs(sig)) + 1e-9)
    return sig.astype(np.float32)


def waveform_batch(ds: SyntheticDataset, idx: Sequence[int],
                   duration_s: float, seed: int = 42) -> np.ndarray:
    return np.stack([
        waveform(int(ds.track_ids[i]), str(ds.genres[i]), duration_s, seed,
                 ds.sample_rate)
        for i in idx
    ])


def synth_param_arrays(ds: SyntheticDataset, idx: Sequence[int],
                       seed: int = 42) -> Dict[str, np.ndarray]:
    """Per-track synthesis parameters as small host arrays (~16 floats per
    track): the host side of device synthesis, same numpy RNG recipe as
    waveform()."""
    max_h = max(r[1] for r in _RECIPES.values())
    b = len(idx)
    p = {k: np.zeros((b, max_h), np.float32)
         for k in ("amps", "freqs", "phases")}
    for k in ("am_rate", "am_phase", "noise_lv"):
        p[k] = np.zeros((b, 1), np.float32)
    for row, i in enumerate(idx):
        (f_lo, f_hi), n_harm, decay, noise, am = _RECIPES[_recipe_genre(ds.genres[i])]
        r = np.random.default_rng(seed * 7 + int(ds.track_ids[i]))
        f0 = r.uniform(f_lo, f_hi)
        for h in range(n_harm):
            p["amps"][row, h] = decay ** h
            p["freqs"][row, h] = f0 * (h + 1)
            p["phases"][row, h] = r.uniform(0, 2 * np.pi)
        p["am_rate"][row, 0] = am
        p["am_phase"][row, 0] = r.uniform(0, 2 * np.pi)
        p["noise_lv"][row, 0] = noise
    return p


def synth_core(amps, freqs, phases, am_rate, am_phase, noise_lv,
               generator: torch.Generator, n: int,
               sample_rate: int) -> torch.Tensor:
    """Device synthesis body: (B, H) / (B, 1) float32 tensors -> (B, n).

    Same op order as the JAX ``synth_core`` (``2*pi*f*t + phase`` per
    harmonic, accumulated at (B, n)); the Gaussian noise comes from
    ``generator``, which must live on the tensors' device.
    """
    dev = amps.device
    two_pi = 2 * math.pi
    t = torch.arange(n, dtype=torch.float32, device=dev) / sample_rate
    sig = torch.zeros((amps.shape[0], n), dtype=torch.float32, device=dev)
    for h in range(amps.shape[1]):
        sig = sig + amps[:, h:h + 1] * torch.sin(
            two_pi * freqs[:, h:h + 1] * t[None, :] + phases[:, h:h + 1])
    sig = sig * (1.0 + 0.5 * torch.sin(two_pi * am_rate * t[None, :]
                                       + am_phase))
    noise = torch.randn(sig.shape, generator=generator, dtype=torch.float32,
                        device=dev)
    sig = sig + noise_lv * noise
    peak = torch.amax(torch.abs(sig), dim=1, keepdim=True) + 1e-9
    return sig * (0.3 / peak)
