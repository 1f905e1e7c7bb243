"""Manifest reading / validation (copy of ``vae_hmc_tpu.core.manifest``).

The canonical manifest is `data/fma_manifest_combined_text_only_clean.csv`
(reference scripts/05:53-57): 2,924 rows x columns
[track_id, title, artist, genre, audio_path, lyrics_path, lyrics_source,
 lyrics_path_genius, lyrics_path_whisper, text_path_combined,
 text_source_combined, text_exists].

Paths inside were produced on Windows (`data\\fma_small\\...`); we normalize
separators on read.  Required-column validation mirrors the reference's
guards (scripts/10:28-31, 11:50-51, 18:137-138).
"""
from __future__ import annotations

import csv
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class Manifest:
    rows: List[Dict[str, str]]
    path: Optional[Path] = None

    def __len__(self) -> int:
        return len(self.rows)

    def column(self, name: str) -> List[str]:
        return [r.get(name, "") for r in self.rows]

    @property
    def track_ids(self) -> np.ndarray:
        return np.asarray([int(r["track_id"]) for r in self.rows], dtype=np.int64)

    @property
    def genres(self) -> np.ndarray:
        return np.asarray([r.get("genre", "unknown") for r in self.rows])

    def genre_map(self) -> Dict[int, str]:
        """track_id -> genre (reference scripts/16:13-32 `load_label_map`)."""
        return {int(r["track_id"]): r.get("genre", "unknown") for r in self.rows}

    def audio_paths(self, root: Optional[Path] = None) -> List[Path]:
        out = []
        for r in self.rows:
            p = normalize_path(r.get("audio_path", ""))
            out.append(Path(root) / p if root is not None else Path(p))
        return out

    def text_paths(self, root: Optional[Path] = None) -> List[Optional[Path]]:
        out: List[Optional[Path]] = []
        for r in self.rows:
            raw = r.get("text_path_combined") or r.get("lyrics_path") or ""
            if not raw:
                out.append(None)
                continue
            p = normalize_path(raw)
            out.append(Path(root) / p if root is not None else Path(p))
        return out

    def filter_existing_audio(self, root: Optional[Path] = None) -> "Manifest":
        """Keep rows whose audio file exists (reference scripts/06:259-268)."""
        keep = []
        for r, p in zip(self.rows, self.audio_paths(root)):
            if p.exists():
                keep.append(r)
        return Manifest(keep, self.path)


def normalize_path(p: str) -> str:
    return p.replace("\\", "/").strip()


def read_manifest(path: Path, required: Sequence[str] = ("track_id",)) -> Manifest:
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"manifest not found: {path}")
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        rows = [dict(r) for r in reader]
        fields = reader.fieldnames or []
    missing = [c for c in required if c not in fields]
    if missing:
        raise ValueError(f"manifest {path} missing required columns: {missing}")
    return Manifest(rows, path)


def write_manifest(path: Path, rows: List[Dict[str, str]],
                   fieldnames: Optional[Sequence[str]] = None) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if fieldnames is None:
        fieldnames = list(rows[0].keys()) if rows else ["track_id"]
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames, extrasaction="ignore")
        w.writeheader()
        for r in rows:
            w.writerow(r)
    return path


def validate_balanced(manifest: Manifest, per_genre: int, n_genres: int) -> None:
    """Balanced-manifest invariant (reference scripts/01:124-131)."""
    genres, counts = np.unique(manifest.genres, return_counts=True)
    if len(genres) != n_genres:
        raise ValueError(f"expected {n_genres} genres, got {len(genres)}: {genres}")
    bad = {g: int(c) for g, c in zip(genres, counts) if c != per_genre}
    if bad:
        raise ValueError(f"unbalanced genres (want {per_genre} each): {bad}")
