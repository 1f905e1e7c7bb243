"""Acquisition stages 00-05 in the port against the JAX package: with the
same stubbed downloader, lyrics providers and transcriber (nothing is
downloaded), both write byte-identical manifests and text files
(mirrors tests/test_acquisition.py)."""
import sys
import types
import zipfile
from pathlib import Path

import pytest

from tests.test_acquisition import _fake_fma_tree
from vae_hmc_tpu.core.config import Workspace as JWorkspace
from vae_hmc_tpu.pipelines import acquisition as jacq
from vae_hmc_tpu_torch.core.config import Workspace as TWorkspace
from vae_hmc_tpu_torch.core.manifest import read_manifest
from vae_hmc_tpu_torch.pipelines import acquisition as tacq


def _tree_bytes(root: Path):
    """{relative path: bytes} of every file under root/data, with the
    workspace root in file contents made relative (paths are absolute)."""
    out = {}
    for p in sorted((root / "data").rglob("*")):
        if p.is_file():
            out[str(p.relative_to(root))] = p.read_bytes().replace(
                str(root).encode(), b"<root>")
    return out


def _both(tmp_path, steps):
    """Run steps(ws, acq) for the port and the JAX package, each on its own
    fake FMA tree; -> (port root, JAX root, port results, JAX results)."""
    out = []
    for name, ws_cls, acq in (("port", TWorkspace, tacq),
                              ("jax", JWorkspace, jacq)):
        root = tmp_path / name
        _fake_fma_tree(root)
        out.append((root, steps(ws_cls(root), acq)))
    (tr, tres), (jr, jres) = out
    return tr, jr, tres, jres


def test_scripts_01_to_05_write_identical_files(tmp_path):
    def steps(ws, acq):
        res = [len(acq.build_manifest(ws, total_tracks=9, n_genres=3,
                                      seed=42))]
        res.append(acq.fetch_lyrics(
            ws, fetchers=[("genius", lambda a, t: None if t.endswith("0")
                           else f"g {a} {t} " * 20),
                          ("lrclib", lambda a, t: "short")],
            sleep_seconds=0.0, max_to_process=6))
        res.append(acq.fetch_transcriptions(ws, dry_run=True))
        res.append(acq.fetch_transcriptions(
            ws, transcriber=lambda p: f"transcript of {p.stem} " * 10,
            limit=4))
        m = read_manifest(ws.data / "fma_manifest_3k_6genres.csv")
        genius = next(r for r in m.rows if r["lyrics_source"] == "genius")
        (ws.data / "whisper_transcriptions" /
         f"extra {genius['track_id']}.txt").write_text("w2 " * 50)
        res.append(acq.combine_manifests(ws))
        res.append(acq.combine_manifests(ws, mode="genius_first"))
        res.append(len(acq.clean_manifest(ws)))
        return res

    t, j, tres, jres = _both(tmp_path, steps)
    assert tres == jres
    assert tres[0] == 9 and tres[1]["fetched"] > 0 and tres[3]["transcribed"]
    tb, jb = _tree_bytes(t), _tree_bytes(j)
    assert sorted(tb) == sorted(jb)
    for name in tb:
        assert tb[name] == jb[name], name
    assert any(n.endswith("fma_manifest_combined_text_only_clean.csv")
               for n in tb)
    assert any("lyrics_combined" in n for n in tb)


def test_fetch_lyrics_resume_and_min_chars(tmp_path):
    def steps(ws, acq):
        acq.build_manifest(ws, total_tracks=9, n_genres=3, seed=42)
        calls = []
        res = [acq.fetch_lyrics(ws, fetchers=[("x", lambda a, t: "short")],
                                sleep_seconds=0.0)]

        def provider(artist, title):
            calls.append(title)
            return f"la la la {title} " * 10

        res.append(acq.fetch_lyrics(ws, fetchers=[("lrclib", provider)],
                                    sleep_seconds=0.0))
        res.append(acq.fetch_lyrics(ws, fetchers=[("lrclib", provider)],
                                    sleep_seconds=0.0))
        return res + [len(calls)]

    t, j, tres, jres = _both(tmp_path, steps)
    assert tres == jres
    assert tres[0]["fetched"] == 0 and tres[1]["fetched"] == 9
    assert tres[2]["processed"] == 0 and tres[3] == 9      # resumed


def test_download_fma_with_a_stub_downloader(tmp_path):
    def steps(ws, acq):
        def downloader(url, dest):
            with zipfile.ZipFile(dest, "w") as z:
                z.writestr(f"{Path(url).stem}/tracks.csv", "track_id\n1\n")
                z.writestr(f"{Path(url).stem}/000/000002.mp3", b"\x00")
        out = acq.download_fma(ws, downloader=downloader)
        return out["verify"]

    t, j, tres, jres = _both(tmp_path, steps)
    assert tres == jres and tres["tracks_csv"] and tres["n_mp3"] >= 2


def test_helpers_match():
    for s in ("Song (Live) [Remix]", "  a   b  ", "x (y) z"):
        assert tacq.normalize_query(s) == jacq.normalize_query(s)
    for s in ("AC/DC - Back: In Black _12_", "", "ü ñ"):
        assert tacq.safe_filename(s) == jacq.safe_filename(s)
    assert tacq.build_audio_path(Path("r"), 2) == \
        jacq.build_audio_path(Path("r"), 2)
    assert tacq.FMA_SMALL_URL == jacq.FMA_SMALL_URL


def test_default_whisper_transcriber_glue(monkeypatch, tmp_path):
    calls = {}

    class _Model:
        def transcribe(self, audio):
            return {"text": "  hello from whisper  "}

    fake = types.ModuleType("whisper")
    fake.load_model = lambda name: calls.setdefault("model", name) and _Model()
    fake.load_audio = lambda p: calls.setdefault("loaded", p) and [0.0] * 10
    fake.pad_or_trim = lambda a: a
    monkeypatch.setitem(sys.modules, "whisper", fake)
    fn = tacq.default_whisper_transcriber()
    assert calls["model"] == "turbo"
    wav = tmp_path / "123.wav"
    wav.write_bytes(b"")
    assert fn(wav) == "hello from whisper"
    assert calls["loaded"] == str(wav)


def test_default_lyrics_fetchers_skip_missing_providers(monkeypatch):
    for mod in ("lyricsgenius", "lrclib"):
        monkeypatch.setitem(sys.modules, mod, None)     # ImportError
    assert tacq.default_lyrics_fetchers() == []
    with pytest.raises(ImportError):
        import lrclib  # noqa: F401
