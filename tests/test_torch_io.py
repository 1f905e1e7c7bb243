"""The port's audio IO against the JAX package's: the native decoder and
resampler (the same C++ source and g++ flags: equal bit for bit), the
python/scipy branch of ``io.audio``, mp3 through libmpg123, and the host
staging prefetcher."""
import time
from pathlib import Path

import numpy as np
import pytest

from tests.torch_audio_data import tone, write_wav
from vae_hmc_tpu.io import audio as jaudio
from vae_hmc_tpu.io import native as jnative
from vae_hmc_tpu_torch.io import audio as taudio
from vae_hmc_tpu_torch.io import native as tnative
from vae_hmc_tpu_torch.io.staging import (batched_indices, prefetch_batches,
                                          to_device)
from vae_hmc_tpu_torch.ops.kernels.build import BUILD_DIR


@pytest.fixture(scope="module")
def jax_native():
    try:
        jnative.get_lib()
    except Exception as e:      # the JAX package's own build, not the port's
        pytest.skip(f"the JAX package's native audio build failed: {e}")
    return jnative


def test_library_built_from_the_port_source_into_build_dir():
    lib = tnative.get_lib()
    path = Path(lib._name)
    assert path.parent == BUILD_DIR
    assert path.name.startswith("libaudioio-") and path.suffix == ".so"
    assert "vae_hmc_tpu/" not in str(path)
    assert tnative.get_lib() is lib


def test_failed_build_raises_every_call(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_SRC", bad)
    for _ in range(2):          # nothing remembers the failure
        with pytest.raises(RuntimeError, match="audioio build failed"):
            tnative.get_lib()


@pytest.mark.parametrize("encoding", ["pcm16", "pcm24", "pcm32", "float32",
                                      "float64"])
@pytest.mark.parametrize("sr,channels", [(22050, 1), (8000, 1), (44100, 2),
                                         (8000, 2)])
def test_native_wav_decode_bit_identical(tmp_path, jax_native, encoding, sr,
                                         channels):
    y = tone(0.4, sr, 440.0, seed=sr + channels, channels=channels)
    p = write_wav(tmp_path / f"x.wav", y, sr, encoding)
    for max_s in (None, 0.25):
        got = tnative.load_wav_native(p, 22050, max_s)
        want = jax_native.load_wav_native(p, 22050, max_s)
        assert got.dtype == np.float32 and len(got) > 0
        np.testing.assert_array_equal(got, want)
        # and through the container dispatch
        np.testing.assert_array_equal(taudio.load_audio(p, 22050, max_s),
                                      jaudio.load_audio(p, 22050, max_s))


@pytest.mark.parametrize("in_sr,out_sr", [(44100, 22050), (8000, 22050),
                                          (22050, 16000)])
def test_resample_bit_identical(jax_native, in_sr, out_sr):
    y = tone(0.3, in_sr, 1000.0, seed=3).astype(np.float32)
    got = tnative.resample_native(y, in_sr, out_sr)
    np.testing.assert_array_equal(got, jax_native.resample_native(
        y, in_sr, out_sr))
    np.testing.assert_array_equal(taudio.resample(y, in_sr, out_sr), got)


def test_python_wav_branch_matches(tmp_path, jax_native):
    """8-bit PCM is not a native encoding: both packages fall back to the
    stdlib wave module (+ the native resampler) with the same numbers; the
    python reader equals the JAX package's on 16-bit stereo at 44.1 kHz."""
    y = tone(0.3, 11025, 330.0, seed=5)
    p8 = write_wav(tmp_path / "u8.wav", y, 11025, "pcm8")
    with pytest.raises(IOError):
        tnative.load_wav_native(p8, 22050)
    got = taudio.load_audio(p8, 22050, 0.2)
    assert got.shape == (4410,)
    np.testing.assert_array_equal(got, jaudio.load_audio(p8, 22050, 0.2))
    p16 = write_wav(tmp_path / "s16.wav", tone(0.3, 44100, 330.0, channels=2),
                    44100)
    np.testing.assert_array_equal(
        taudio._load_wav_python(p16, 22050, None),
        jaudio._load_wav_python(p16, 22050, None))


def test_scipy_resample_branch_matches(monkeypatch, jax_native):
    """Where the native call fails, both packages resample with scipy's
    polyphase filter, and agree; its numbers are not the windowed sinc's."""
    y = tone(0.3, 44100, 700.0, seed=9).astype(np.float32)
    native_out = taudio.resample(y, 44100, 22050)

    def unavailable(*a, **k):
        raise RuntimeError("native library unavailable")

    monkeypatch.setattr(tnative, "resample_native", unavailable)
    monkeypatch.setattr(jnative, "resample_native", unavailable)
    got = taudio.resample(y, 44100, 22050)
    np.testing.assert_array_equal(got, jaudio.resample(y, 44100, 22050))
    assert got.shape == native_out.shape
    assert not np.array_equal(got, native_out)
    np.testing.assert_allclose(got[200:-200], native_out[200:-200],
                               atol=2e-2)


def test_decode_errors_match(tmp_path, jax_native):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav at all")
    missing = tmp_path / "missing.wav"
    other = tmp_path / "clip.xyz"
    other.write_bytes(b"\x00" * 64)
    for p in (bad, missing, other):
        errs = []
        for load in (taudio.load_audio, jaudio.load_audio):
            with pytest.raises(Exception) as e:
                load(p, 22050, 1.0)
            errs.append((type(e.value).__name__,
                         str(e.value).replace(str(tmp_path), "")))
        assert errs[0] == errs[1]


def _codecs():
    from tests.test_mp3_native import _find_lame, _mpg123_available
    return _find_lame() is not None and _mpg123_available()


def test_mp3_roundtrip_matches_jax(tmp_path, jax_native):
    if not _codecs():
        pytest.skip("libmp3lame/libmpg123 not on this host")
    from tests.test_mp3_native import _encode_mp3

    sr = 22050
    t = np.arange(sr) / sr
    y = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    p = tmp_path / "tone.mp3"
    _encode_mp3(p, y, sr)
    got = taudio.load_audio(p, sr, 0.8)
    np.testing.assert_array_equal(got, jaudio.load_audio(p, sr, 0.8))
    np.testing.assert_array_equal(got, tnative.load_mp3_native(p, sr, 0.8))
    assert abs(len(got) - int(0.8 * sr)) <= 1
    # the tone survives the lossy round trip: dominant bin at 440 Hz
    spec = np.abs(np.fft.rfft(got[2000:16000]))
    f = np.fft.rfftfreq(14000, 1 / sr)[np.argmax(spec)]
    assert abs(f - 440.0) < 5.0


# ---- staging ----


def test_batched_indices():
    assert batched_indices(10, 4) == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]


def test_prefetch_order_and_completeness():
    batches = batched_indices(23, 5)
    seen = list(prefetch_batches(lambda ix: sum(ix), batches, depth=3))
    assert [idx for idx, _ in seen] == batches
    assert [v for _, v in seen] == [sum(b) for b in batches]


def test_prefetch_overlaps_producer_and_consumer():
    def slow_produce(ix):
        time.sleep(0.05)
        return ix

    batches = batched_indices(40, 5)          # 8 batches x 50 ms = 400 ms
    t0 = time.perf_counter()
    for _ in prefetch_batches(slow_produce, batches, depth=2):
        time.sleep(0.05)                      # consumer also 50 ms/batch
    elapsed = time.perf_counter() - t0
    # serial would be ~0.8 s; overlapped ~0.45 s
    assert elapsed < 0.7, f"no overlap: {elapsed:.2f}s"


def test_prefetch_propagates_exceptions():
    def boom(ix):
        if ix[0] >= 5:
            raise ValueError("decode failed")
        return ix

    with pytest.raises(ValueError, match="decode failed"):
        list(prefetch_batches(boom, batched_indices(10, 5)))


def test_to_device_on_cpu_keeps_values():
    import torch
    x = np.arange(12, dtype=np.float32).reshape(3, 4)[:, ::2]
    t = to_device(x, torch.device("cpu"))
    assert t.device.type == "cpu" and t.is_contiguous()
    np.testing.assert_array_equal(t.numpy(), x)
