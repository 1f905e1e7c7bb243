"""Manifests, FileSource and dataset_from_manifest in the port against the
JAX package, on a 13-row WAV corpus (12 tracks and one corrupt file, as
tests/test_file_source_e2e.py builds it), and the feature loops from a
FileSource on the CPU against the JAX package's."""
import numpy as np
import pytest
import torch

from tests.torch_audio_data import corpus_rows
from vae_hmc_tpu.core import manifest as jman
from vae_hmc_tpu.core.config import MelConfig as JMelConfig
from vae_hmc_tpu.core.config import MfccConfig as JMfccConfig
from vae_hmc_tpu.pipelines import features as jfeatures
from vae_hmc_tpu.pipelines import sources as jsources
from vae_hmc_tpu.pipelines import synthetic as jsynth
from vae_hmc_tpu_torch.core import manifest as tman
from vae_hmc_tpu_torch.core.config import MelConfig, MfccConfig
from vae_hmc_tpu_torch.pipelines import features as tfeatures
from vae_hmc_tpu_torch.pipelines import sources as tsources
from vae_hmc_tpu_torch.pipelines import synthetic as tsynth

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(root, manifest path): the 13-row corpus, row 3 a 0.6 s clip."""
    root = tmp_path_factory.mktemp("torch_corpus")
    rows = corpus_rows(root, seconds=1.5, short={3: 0.6})
    mp = root / "manifest.csv"
    tman.write_manifest(mp, rows)
    return root, mp


def _sources(root, mp):
    t = tsources.FileSource.from_manifest(tman.read_manifest(mp), root=root)
    j = jsources.FileSource.from_manifest(jman.read_manifest(mp), root=root)
    return t, j


def test_manifest_matches_jax(corpus, tmp_path):
    root, mp = corpus
    t, j = tman.read_manifest(mp), jman.read_manifest(mp)
    np.testing.assert_array_equal(t.track_ids, j.track_ids)
    np.testing.assert_array_equal(t.genres, j.genres)
    assert t.genre_map() == j.genre_map()
    assert t.audio_paths(root) == j.audio_paths(root)
    assert t.text_paths(root) == j.text_paths(root)
    assert all("\\" not in str(p) for p in t.audio_paths(root))
    assert len(t.filter_existing_audio(root)) == 13
    assert len(t.filter_existing_audio()) == len(j.filter_existing_audio())
    assert tman.normalize_path(" a\\b\\c.wav ") == "a/b/c.wav"
    with pytest.raises(ValueError, match="missing required columns"):
        tman.read_manifest(mp, required=("track_id", "nope"))
    with pytest.raises(FileNotFoundError):
        tman.read_manifest(tmp_path / "absent.csv")
    a, b = tmp_path / "t.csv", tmp_path / "j.csv"
    tman.write_manifest(a, t.rows)
    jman.write_manifest(b, j.rows)
    assert a.read_bytes() == b.read_bytes()
    bal = tman.Manifest([{"track_id": str(i), "genre": "ab"[i % 2]}
                         for i in range(6)])
    tman.validate_balanced(bal, 3, 2)
    for per, n in ((2, 2), (3, 3)):
        with pytest.raises(ValueError):
            tman.validate_balanced(bal, per, n)


def test_file_source_batches_match_jax(corpus):
    root, mp = corpus
    t, j = _sources(root, mp)
    assert len(t) == len(j) == 13
    for i in range(13):
        assert t.lyrics_text(i) == j.lyrics_text(i)
    assert t.lyrics_text(12) is None
    for idx, dur in (([0, 1, 2, 3, 4, 5, 6, 7], 1.0), ([8, 9, 10, 11, 12], 1.0),
                     ([12, 3, 0], 2.0)):
        tb, tl, te = t.host_waveforms(idx, dur)
        jb, jl, je = j.waveforms(idx, dur)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tl, jl)
        assert te == je
        assert tb.dtype == np.float32 and tl.dtype == np.int32
    # the corrupt row: an error string, zeros, length 0
    _, lengths, errors = t.host_waveforms([12], 1.0)
    assert lengths[0] == 0 and errors[0].startswith("Error: ")
    # the device method returns the same batch as a tensor
    batch, lengths, errors = t.waveforms([0, 12, 3], 1.0, CPU)
    hb, hl, he = t.host_waveforms([0, 12, 3], 1.0)
    assert isinstance(batch, torch.Tensor) and batch.device == CPU
    np.testing.assert_array_equal(batch.numpy(), hb)
    assert list(lengths) == list(hl) == [22050, 0, int(0.6 * 22050)]


def test_file_source_raises_when_the_decoder_cannot_build(corpus, monkeypatch):
    from vae_hmc_tpu_torch.io import native

    def broken():
        raise RuntimeError("audioio build failed:\nno g++")

    monkeypatch.setattr(native, "get_lib", broken)
    t, _ = _sources(*corpus)
    with pytest.raises(RuntimeError, match="audioio build failed"):
        t.host_waveforms([0, 1], 1.0)


@pytest.mark.parametrize("hard", [False, True])
def test_build_mfcc_stats_from_files_matches_jax(corpus, hard):
    """The easy preset (fixed-length pad) and the hard preset's masked path
    (row 3 is a 0.6 s clip: masked stats in a batch that is staged on the
    host; min_duration 0.7 s skips it in the hard preset, 0.5 keeps it)."""
    root, mp = corpus
    t, j = _sources(root, mp)
    kw = dict(duration_s=1.0, min_duration_s=0.5) if hard else dict(
        duration_s=1.0)
    for min_d in ((0.5, 0.7) if hard else (0.0,)):
        if hard:
            kw["min_duration_s"] = min_d
        tx, tids, trep = tfeatures.build_mfcc_stats(t, MfccConfig(**kw),
                                                    device_batch=5, device=CPU)
        jx, jids, jrep = jfeatures.build_mfcc_stats(j, JMfccConfig(**kw),
                                                    device_batch=5)
        np.testing.assert_array_equal(tids, jids)
        assert trep.rows == jrep.rows
        np.testing.assert_allclose(tx, np.asarray(jx), atol=1e-3, rtol=1e-5)
    statuses = {r[0]: r[2] for r in trep.rows}
    assert statuses[999] == "error"
    assert statuses[503] == ("skipped" if hard else "ok")


def test_build_logmel_from_files_matches_jax(corpus):
    root, mp = corpus
    t, j = _sources(root, mp)
    cfg = dict(duration_s=1.0, n_mels=32)
    tx, tids, trep = tfeatures.build_logmel(t, MelConfig(**cfg),
                                            device_batch=5, device=CPU)
    jx, jids, jrep = jfeatures.build_logmel(j, JMelConfig(**cfg),
                                            device_batch=5)
    np.testing.assert_array_equal(tids, jids)
    assert trep.rows == jrep.rows
    assert tx.shape == (12, 32, 44)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx)[:, 0], atol=1e-4,
                               rtol=1e-5)


def test_feature_loop_decodes_ahead_on_a_thread(corpus, monkeypatch):
    """File batches are decoded by prefetch_batches' thread, not the caller's:
    the loop consumes batch i while batch i+1 is decoded."""
    import threading

    root, mp = corpus
    t, _ = _sources(root, mp)
    threads = []
    host = t.host_waveforms

    def spy(idx, dur):
        threads.append(threading.current_thread())
        return host(idx, dur)

    monkeypatch.setattr(t, "host_waveforms", spy)
    tfeatures.build_mfcc_stats(t, MfccConfig(duration_s=1.0), device_batch=4,
                               device=CPU)
    assert len(threads) == 4
    assert all(th is not threading.main_thread() for th in threads)


def test_dataset_from_manifest_matches_jax(corpus, tmp_path):
    root, mp = corpus
    rows = tman.read_manifest(mp).rows
    for i, r in enumerate(rows):           # a mix of text sources
        r["text_source_combined"] = ("whisper", "genius", "both", "")[i % 4]
    rows[1]["text_exists"] = ""            # coverage from the text path
    rows[2]["text_exists"] = "False"
    p = tmp_path / "m.csv"
    tman.write_manifest(p, rows)
    t = tsynth.dataset_from_manifest(p, seed=7)
    j = jsynth.dataset_from_manifest(p, seed=7)
    np.testing.assert_array_equal(t.track_ids, j.track_ids)
    np.testing.assert_array_equal(t.genres, j.genres)
    np.testing.assert_array_equal(t.has_lyrics, j.has_lyrics)
    assert t.lyrics == j.lyrics and t.titles == j.titles
    assert t.artists == j.artists and t.text_sources == j.text_sources
    assert t.lyrics[2] is None and t.lyrics[1] is not None
    idx = list(range(len(t)))
    tp = tsynth.synth_param_arrays(t, idx, 7)
    jp = jsynth.synth_param_arrays(j, idx, 7)
    assert tp.keys() == jp.keys()
    for k in tp:
        np.testing.assert_array_equal(tp[k], jp[k])


@pytest.mark.parametrize("shared_frac", [0.0, 0.2, 0.45])
def test_lyrics_for_matches_jax(shared_frac):
    for genre, tid in (("Rock", 500), ("Pop", 123456), ("Jazz", 7)):
        assert tsynth._lyrics_for(genre, tid, 42, shared_frac) == \
            jsynth._lyrics_for(genre, tid, 42, shared_frac)
    # make_dataset's texts are unchanged (shared_frac 0)
    assert tsynth.make_dataset(40).lyrics == jsynth.make_dataset(40).lyrics
