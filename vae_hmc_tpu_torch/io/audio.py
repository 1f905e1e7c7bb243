"""Host audio decode, the librosa.load replacement feeding device staging
(port of ``vae_hmc_tpu.io.audio``, the same dispatch and numbers).

Dispatch per container:
  - .wav           -> native C++ decoder + windowed-sinc resampler
                      (``io/native/audioio.cpp``); on a native decode
                      error, the stdlib wave module + ``resample``;
  - .mp3/.mp2/.mp1 -> in-process MPEG decode through the native layer
                      (libmpg123 dlopen'd by audioio.cpp, no per-file
                      subprocess); the ffmpeg pipe when libmpg123 is absent
                      or the native decode fails, and the native error when
                      ffmpeg cannot run either;
  - others         -> ffmpeg subprocess piping raw float32 PCM.

Semantics match librosa.load(sr=..., mono=True, duration=...): mono
downmix by channel mean, band-limited resample, optional duration cap.

As in the JAX package, ``resample`` takes scipy's polyphase filter when the
native call fails; those numbers differ from the windowed sinc, so the
file-backed source (``pipelines.sources.FileSource``) loads the native
library before it decodes and raises when it cannot be built.
"""
from __future__ import annotations

import shutil
import subprocess
import wave
from pathlib import Path
from typing import Optional

import numpy as np

from vae_hmc_tpu_torch.io import native


def load_audio(path: Path, target_sr: int = 22050,
               max_duration_s: Optional[float] = None) -> np.ndarray:
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".wav":
        try:
            return native.load_wav_native(path, target_sr, max_duration_s)
        except Exception:
            return _load_wav_python(path, target_sr, max_duration_s)
    native_err: Optional[Exception] = None
    if suffix in (".mp3", ".mp2", ".mp1"):
        try:
            return native.load_mp3_native(path, target_sr, max_duration_s)
        except IOError as e:
            # the FILE failed to decode: ffmpeg gives a second opinion, but
            # if it cannot run either, THIS error is the one to surface
            native_err = e
        except Exception:
            pass        # no libmpg123 / no native library -> ffmpeg below
    try:
        return _load_via_ffmpeg(path, target_sr, max_duration_s)
    except IOError as fe:
        if native_err is not None:
            raise native_err from fe
        raise


def _load_wav_python(path: Path, target_sr: int,
                     max_duration_s: Optional[float]) -> np.ndarray:
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        width = w.getsampwidth()
        n = w.getnframes()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
             - 128.0) / 128.0
    else:
        raise IOError(f"unsupported wav sample width {width} in {path}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    y = resample(x, sr, target_sr)
    if max_duration_s is not None:
        y = y[: int(target_sr * max_duration_s)]
    return y


def resample(y: np.ndarray, in_sr: int, out_sr: int) -> np.ndarray:
    """Band-limited resample: the native windowed sinc, scipy's polyphase
    filter (``scipy.signal.resample_poly``) when the native call fails."""
    if in_sr == out_sr:
        return np.asarray(y, dtype=np.float32)
    try:
        return native.resample_native(y, in_sr, out_sr)
    except Exception:
        from math import gcd

        import scipy.signal
        g = gcd(in_sr, out_sr)
        return scipy.signal.resample_poly(
            np.asarray(y, dtype=np.float64), out_sr // g, in_sr // g
        ).astype(np.float32)


def _load_via_ffmpeg(path: Path, target_sr: int,
                     max_duration_s: Optional[float]) -> np.ndarray:
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise IOError(
            f"cannot decode {path.suffix} file {path}: ffmpeg not found "
            "(install ffmpeg, or convert the corpus to wav)")
    cmd = [ffmpeg, "-v", "error", "-i", str(path)]
    if max_duration_s is not None:
        cmd += ["-t", str(max_duration_s)]
    cmd += ["-f", "f32le", "-ac", "1", "-ar", str(target_sr), "pipe:1"]
    proc = subprocess.run(cmd, capture_output=True)
    if proc.returncode != 0:
        raise IOError(f"ffmpeg decode failed for {path}: "
                      f"{proc.stderr.decode(errors='replace')[:200]}")
    return np.frombuffer(proc.stdout, dtype=np.float32).copy()
