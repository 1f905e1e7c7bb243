"""Data acquisition host pipelines, reference scripts 00-05 (port of
``vae_hmc_tpu.pipelines.acquisition``, host code copied as it is).

These stages run entirely on the host (network and file wrangling, no
device work) and reproduce the reference's behavior with the external effects behind
pluggable callables so everything is testable offline:

  00 download_fma        — stream + extract fma_small.zip / fma_metadata.zip,
                           idempotent by size check (00:22-24), post-extract
                           verification (00:66-74);
  01 build_manifest      — balanced top-N-genre manifest from the
                           multi-header tracks.csv, deterministic shuffle
                           seed 42, skip-missing-mp3 (01:84-116), exact
                           balance validation (01:124-131);
  02 fetch_lyrics        — provider chain (Genius then LRCLIB, 02:189-202)
                           with query normalization (02:60-68), min-80-chars
                           filter (02:44), rate-limit sleep (02:43),
                           resume-by-existing-file (02:182-184);
  03 fetch_transcriptions— Whisper ASR for rows without genius lyrics
                           (03:60-62), disk scan by track id (03:66-78),
                           --dry-run audit (03:81-96);
  04 combine_manifests   — merge genius+whisper text per track, concat mode
                           joins with '\\n\\n---\\n\\n' (04:129-138), whisper
                           fallback by filename-regex id map (04:34-49);
  05 clean_manifest      — NaN->'' normalization + text_exists disk check
                           (05:9-57), writing the canonical clean manifests.
"""
from __future__ import annotations

import re
import time
import zipfile
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from vae_hmc_tpu_torch.core.config import Workspace
from vae_hmc_tpu_torch.core.manifest import (Manifest, read_manifest,
                                       validate_balanced, write_manifest)

FMA_SMALL_URL = "https://os.unil.cloud.switch.ch/fma/fma_small.zip"
FMA_METADATA_URL = "https://os.unil.cloud.switch.ch/fma/fma_metadata.zip"


# ---------------------------------------------------------------------------
# 00: download + extract
# ---------------------------------------------------------------------------


def download_fma(ws: Workspace,
                 urls: Sequence[Tuple[str, str]] = (
                     (FMA_SMALL_URL, "fma_small.zip"),
                     (FMA_METADATA_URL, "fma_metadata.zip")),
                 downloader: Optional[Callable[[str, Path], None]] = None,
                 extract: bool = True) -> Dict:
    """Idempotent download (skip when the local file already has the remote
    size, ref 00:22-24) + extraction + verification."""
    ws.data.mkdir(parents=True, exist_ok=True)
    out = {}
    for url, name in urls:
        dest = ws.data / name
        if downloader is not None:
            downloader(url, dest)
        else:
            _urllib_download(url, dest)
        if extract:
            with zipfile.ZipFile(dest) as z:
                z.extractall(ws.data)
        out[name] = dest
    verify = {
        "tracks_csv": _find_file(ws.data, "tracks.csv") is not None,
        "genres_csv": _find_file(ws.data, "genres.csv") is not None,
        "n_mp3": len(list(ws.data.rglob("*.mp3"))),
    }
    out["verify"] = verify
    return out


def _urllib_download(url: str, dest: Path, chunk: int = 1 << 20) -> None:
    import urllib.request

    req = urllib.request.Request(url, method="HEAD")
    with urllib.request.urlopen(req) as r:
        remote_size = int(r.headers.get("Content-Length", "0"))
    if dest.exists() and remote_size and dest.stat().st_size == remote_size:
        return                                   # idempotent skip
    with urllib.request.urlopen(url) as r, open(dest, "wb") as f:
        while True:
            buf = r.read(chunk)
            if not buf:
                break
            f.write(buf)


def _find_file(root: Path, name: str) -> Optional[Path]:
    for p in root.rglob(name):
        return p
    return None


# ---------------------------------------------------------------------------
# 01: balanced manifest
# ---------------------------------------------------------------------------


def build_audio_path(audio_root: Path, track_id: int) -> Path:
    tid = f"{int(track_id):06d}"
    return Path(audio_root) / tid[:3] / f"{tid}.mp3"


def build_manifest(ws: Workspace, total_tracks: int = 3000,
                   n_genres: int = 6, seed: int = 42,
                   tracks_csv: Optional[Path] = None,
                   audio_root: Optional[Path] = None,
                   require_audio: bool = True,
                   out_name: str = "fma_manifest_3k_6genres.csv") -> Manifest:
    import pandas as pd

    if total_tracks % n_genres != 0:
        raise ValueError("total_tracks must divide evenly by n_genres")
    tracks_csv = Path(tracks_csv) if tracks_csv else _find_file(
        ws.data, "tracks.csv")
    if tracks_csv is None:
        raise FileNotFoundError("tracks.csv not found under data/")
    if audio_root is None:
        cand = ws.data / "fma_small"
        audio_root = cand / "fma_small" if (cand / "fma_small").exists() else cand

    tracks = pd.read_csv(tracks_csv, index_col=0, header=[0, 1])
    df = tracks[tracks[("set", "subset")] == "small"].copy()
    df = df[[("track", "title"), ("artist", "name"), ("track", "genre_top")]]
    df.columns = ["title", "artist", "genre_top"]
    df = df.dropna(subset=["title", "artist", "genre_top"])
    df = df[df["title"].apply(lambda x: isinstance(x, str))]
    df = df[df["artist"].apply(lambda x: isinstance(x, str))]
    df["genre_top"] = df["genre_top"].astype(str).str.strip()

    top_genres = df["genre_top"].value_counts().head(n_genres).index.tolist()
    df = df[df["genre_top"].isin(top_genres)]
    per_genre = total_tracks // n_genres

    rows: List[Dict] = []
    for g in top_genres:
        gdf = df[df["genre_top"] == g].sample(frac=1.0, random_state=seed)
        picked = 0
        for track_id, r in gdf.iterrows():
            tid = int(track_id)
            audio_path = build_audio_path(audio_root, tid)
            if require_audio and not audio_path.exists():
                continue
            rows.append({
                "track_id": tid, "title": r["title"].strip(),
                "artist": r["artist"].strip(), "genre": g,
                "audio_path": str(audio_path),
                "lyrics_path": "", "lyrics_source": "",
            })
            picked += 1
            if picked >= per_genre:
                break
        if picked < per_genre:
            raise RuntimeError(
                f"genre {g!r}: only {picked}/{per_genre} usable tracks")
    import pandas as pd
    out_df = pd.DataFrame(rows).sample(frac=1.0, random_state=seed
                                       ).reset_index(drop=True)
    out_path = ws.data / out_name
    out_df.to_csv(out_path, index=False)
    manifest = read_manifest(out_path)
    validate_balanced(manifest, per_genre, n_genres)
    return manifest


# ---------------------------------------------------------------------------
# 02: lyrics fetch (provider chain)
# ---------------------------------------------------------------------------


def normalize_query(s: str) -> str:
    """Strip (...) / [...] noise (ref 02:60-68)."""
    s = str(s).strip()
    s = re.sub(r"\s*\(.*?\)\s*", " ", s)
    s = re.sub(r"\s*\[.*?\]\s*", " ", s)
    return re.sub(r"\s+", " ", s).strip()


def safe_filename(s: str) -> str:
    """(ref 02:54-57)"""
    s = re.sub(r"[^\w\-_\. ]", "_", s, flags=re.UNICODE)
    s = re.sub(r"\s+", " ", s).strip()
    return (s[:150] if s else "unknown") + ".txt"


FetchFn = Callable[[str, str], Optional[str]]   # (artist, title) -> text


def fetch_lyrics(ws: Workspace, manifest_path: Optional[Path] = None,
                 fetchers: Optional[Sequence[Tuple[str, FetchFn]]] = None,
                 sleep_seconds: float = 0.45, min_chars: int = 80,
                 max_to_process: Optional[int] = 1000,
                 overwrite: bool = False) -> Dict:
    """Provider chain per row; saves data/lyrics/<artist - title _id_>.txt and
    updates manifest lyrics_path / lyrics_source.  Resume semantics: rows
    whose lyrics_path already exists are skipped (ref 02:182-184)."""
    manifest_path = Path(manifest_path) if manifest_path else (
        ws.data / "fma_manifest_3k_6genres.csv")
    m = read_manifest(manifest_path, required=("track_id", "title", "artist"))
    if fetchers is None:
        fetchers = default_lyrics_fetchers()
    lyrics_dir = ws.data / "lyrics"
    lyrics_dir.mkdir(parents=True, exist_ok=True)

    processed = fetched = 0
    for row in m.rows:
        if max_to_process is not None and processed >= max_to_process:
            break
        existing = row.get("lyrics_path", "")
        if existing and Path(existing).exists() and not overwrite:
            continue
        processed += 1
        artist = normalize_query(row.get("artist", ""))
        title = normalize_query(row.get("title", ""))
        text = source = None
        for name, fn in fetchers:
            try:
                t = fn(artist, title)
            except Exception:
                t = None
            if t and len(t.strip()) >= min_chars:
                text, source = t.strip(), name
                break
        if text:
            fname = safe_filename(f"{row['artist']} - {row['title']} "
                                  f"_{row['track_id']}_")
            p = lyrics_dir / fname
            p.write_text(text, encoding="utf-8")
            row["lyrics_path"] = str(p)
            row["lyrics_source"] = source
            fetched += 1
        if sleep_seconds:
            time.sleep(sleep_seconds)
    write_manifest(manifest_path, m.rows)
    return {"processed": processed, "fetched": fetched}


def _load_dotenv_token(name: str) -> Optional[str]:
    """Minimal .env reader (the reference loads GENIUS_ACCESS_TOKEN via
    python-dotenv, 02:143-144); env var wins over the file."""
    import os
    if os.environ.get(name):
        return os.environ[name]
    p = Path(".env")
    if p.exists():
        for line in p.read_text().splitlines():
            line = line.strip()
            if line.startswith(f"{name}="):
                return line.split("=", 1)[1].strip().strip("'\"")
    return None


def default_lyrics_fetchers() -> List[Tuple[str, FetchFn]]:
    """Genius (needs GENIUS_ACCESS_TOKEN) then LRCLIB, like ref 02:189-202.
    Both are optional imports; absent providers are skipped."""
    out: List[Tuple[str, FetchFn]] = []
    try:
        import lyricsgenius

        token = _load_dotenv_token("GENIUS_ACCESS_TOKEN")
        if token:
            genius = lyricsgenius.Genius(token, timeout=15, retries=2)

            def _genius(artist, title):
                song = genius.search_song(title=title, artist=artist)
                return song.lyrics.strip() if song and song.lyrics else None

            out.append(("genius", _genius))
    except ImportError:
        pass
    try:
        from lrclib import LrcLibAPI

        api = LrcLibAPI(user_agent="vae-hmc-lyrics-fetcher/1.0")

        def _lrclib(artist, title):
            res = api.get_lyrics(track_name=title, artist_name=artist)
            if isinstance(res, dict):
                text = (res.get("plainLyrics") or "").strip()
                if text:
                    return text
                synced = (res.get("syncedLyrics") or "").strip()
                if synced:
                    return re.sub(r"\[\d+:\d+(?:\.\d+)?\]\s*", "",
                                  synced).strip()
            return None

        out.append(("lrclib", _lrclib))
    except ImportError:
        pass
    return out


# ---------------------------------------------------------------------------
# 03: transcriptions
# ---------------------------------------------------------------------------


TranscribeFn = Callable[[Path], str]


def fetch_transcriptions(ws: Workspace, manifest_path: Optional[Path] = None,
                         transcriber: Optional[TranscribeFn] = None,
                         dry_run: bool = False,
                         limit: Optional[int] = None) -> Dict:
    """ASR for rows whose lyrics_source != 'genius' (ref 03:60-62).  The mp3
    is located by scanning the audio tree for the zero-padded id (03:66-78).
    dry_run audits manifest-vs-disk without transcribing (03:81-96)."""
    manifest_path = Path(manifest_path) if manifest_path else (
        ws.data / "fma_manifest_3k_6genres.csv")
    m = read_manifest(manifest_path, required=("track_id",))
    id_to_mp3: Dict[int, Path] = {}
    for p in ws.data.rglob("*.mp3"):
        mm = re.match(r"(\d+)$", p.stem)
        if mm:
            id_to_mp3.setdefault(int(mm.group(1)), p)

    todo = [r for r in m.rows
            if (r.get("lyrics_source", "") or "").lower() != "genius"]
    found = [r for r in todo if int(r["track_id"]) in id_to_mp3]
    if dry_run:
        return {"rows_needing_transcription": len(todo),
                "audio_found": len(found),
                "audio_missing": len(todo) - len(found)}
    if transcriber is None:
        transcriber = default_whisper_transcriber()
    out_dir = ws.data / "whisper_transcriptions"
    out_dir.mkdir(parents=True, exist_ok=True)
    done = 0
    for r in found[: limit if limit else None]:
        tid = int(r["track_id"])
        text = transcriber(id_to_mp3[tid])
        if not text:
            continue
        fname = safe_filename(f"{r.get('artist', '')} - "
                              f"{r.get('title', '')} {tid}")
        p = out_dir / fname
        p.write_text(text, encoding="utf-8")
        r["lyrics_path"] = str(p)
        r["lyrics_source"] = "whisper"
        done += 1
    write_manifest(manifest_path, m.rows)
    return {"transcribed": done, "audio_found": len(found)}


def default_whisper_transcriber() -> TranscribeFn:
    """openai-whisper 'turbo' (ref 03:15); optional heavy dependency."""
    import whisper  # raises ImportError when absent — caller supplies a stub

    model = whisper.load_model("turbo")

    def _fn(path: Path) -> str:
        audio = whisper.load_audio(str(path))
        audio = whisper.pad_or_trim(audio)
        result = model.transcribe(audio)
        return (result.get("text") or "").strip()

    return _fn


# ---------------------------------------------------------------------------
# 04: combine genius + whisper text
# ---------------------------------------------------------------------------


def build_whisper_map(folder: Path) -> Dict[int, Path]:
    """track_id -> transcript path by filename regex (ref 04:34-49)."""
    mapping: Dict[int, Path] = {}
    if not Path(folder).exists():
        return mapping
    for p in Path(folder).rglob("*.txt"):
        mm = re.search(r"\b(\d{3,7})\b", p.stem)
        if mm:
            mapping.setdefault(int(mm.group(1)), p)
    return mapping


def _safe_name_combined(s: str) -> str:
    s = re.sub(r"[^\w\-_\. ()]", "_", s, flags=re.UNICODE)
    s = re.sub(r"\s+", " ", s).strip()
    return s[:160] if s else "unknown"


def combine_manifests(ws: Workspace, manifest_path: Optional[Path] = None,
                      mode: str = "concat_both") -> Dict:
    """Merge per-track genius + whisper text into data/lyrics_combined and
    write fma_manifest_combined.csv + text-only subset (ref 04:52-165)."""
    manifest_path = Path(manifest_path) if manifest_path else (
        ws.data / "fma_manifest_3k_6genres.csv")
    m = read_manifest(manifest_path, required=("track_id",))
    whisper_map = build_whisper_map(ws.data / "whisper_transcriptions")
    out_dir = ws.data / "lyrics_combined"
    out_dir.mkdir(parents=True, exist_ok=True)

    counts = {"any": 0, "both": 0, "genius": 0, "whisper": 0}
    for row in m.rows:
        tid = int(row["track_id"])
        source = (row.get("lyrics_source", "") or "").lower()
        path_str = row.get("lyrics_path", "") or ""
        genius_path = Path(path_str) if source == "genius" and path_str else None
        whisper_path = Path(path_str) if source == "whisper" and path_str else None
        if whisper_path is None:
            whisper_path = whisper_map.get(tid)
        g_ok = genius_path is not None and genius_path.exists()
        w_ok = whisper_path is not None and whisper_path.exists()
        row["lyrics_path_genius"] = str(genius_path) if g_ok else ""
        row["lyrics_path_whisper"] = str(whisper_path) if w_ok else ""
        counts["genius"] += int(g_ok)
        counts["whisper"] += int(w_ok)

        texts, sources = [], []
        if g_ok:
            texts.append(genius_path.read_text(encoding="utf-8",
                                               errors="replace").strip())
            sources.append("genius")
        if w_ok and (mode == "concat_both" or not g_ok):
            texts.append(whisper_path.read_text(encoding="utf-8",
                                                errors="replace").strip())
            sources.append("whisper")
        if not texts:
            row["text_path_combined"] = ""
            row["text_source_combined"] = ""
            continue
        counts["any"] += 1
        if len(sources) == 2:
            counts["both"] += 1
        combined = "\n\n---\n\n".join(texts)     # ref 04:129-138
        fname = _safe_name_combined(
            f"{row.get('artist', '')} - {row.get('title', '')} ({tid})") + ".txt"
        p = out_dir / fname
        p.write_text(combined, encoding="utf-8")
        row["text_path_combined"] = str(p)
        row["text_source_combined"] = "+".join(sources)

    fields = list(m.rows[0].keys())
    write_manifest(ws.data / "fma_manifest_combined.csv", m.rows, fields)
    text_only = [r for r in m.rows if r["text_path_combined"]]
    write_manifest(ws.data / "fma_manifest_combined_text_only.csv",
                   text_only, fields)
    return counts


# ---------------------------------------------------------------------------
# 05: clean manifest
# ---------------------------------------------------------------------------


def clean_manifest(ws: Workspace,
                   manifest_path: Optional[Path] = None) -> Manifest:
    """NaN->'' normalization + text_exists disk check; writes the canonical
    `_clean` manifests everything downstream consumes (ref 05:9-57)."""
    manifest_path = Path(manifest_path) if manifest_path else (
        ws.data / "fma_manifest_combined.csv")
    m = read_manifest(manifest_path, required=("track_id",))
    for row in m.rows:
        for k, v in list(row.items()):
            if v is None or (isinstance(v, str)
                             and v.strip().lower() in ("nan", "none")):
                row[k] = ""
        p = row.get("text_path_combined", "")
        row["text_exists"] = str(bool(p and Path(p).exists()))
    fields = list(m.rows[0].keys())
    write_manifest(ws.data / "fma_manifest_combined_clean.csv", m.rows, fields)
    clean_rows = [r for r in m.rows if r["text_exists"] == "True"]
    out = ws.data / "fma_manifest_combined_text_only_clean.csv"
    write_manifest(out, clean_rows, fields)
    return read_manifest(out)
