"""ctypes bindings of the port's native audio library (``audioio.cpp``),
built at first use (port of ``vae_hmc_tpu.io.native``).

``audioio.cpp`` is the port's own copy of the JAX package's source (only
comments differ), compiled with the same ``g++ -O3 -shared -fPIC
-std=c++17 ... -ldl`` into the git-ignored
``build/torch_kernels/libaudioio-<source hash>.so`` (``ops.kernels.build.
gxx_library``), never into the package; the JAX package's ``_audioio.so``
is never loaded.  So a decode or resample here equals the JAX package's bit
for bit.  A failed build raises with g++'s output every time ``get_lib`` is
called: unlike the JAX package, nothing remembers the failure.  ctypes
releases the GIL during each call, so decoders on threads run in parallel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

from vae_hmc_tpu_torch.ops.kernels.build import gxx_library

_SRC = Path(__file__).parent / "audioio.cpp"


class NativeDecoderUnavailable(RuntimeError):
    """The native layer exists but the codec library (libmpg123) is not on
    this host: callers fall back to another decoder.  Distinct from
    IOError, which means the FILE failed to decode."""


def _bind(lib: ctypes.CDLL) -> None:
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.audioio_load_wav.restype = ctypes.c_int
    lib.audioio_load_wav.argtypes = [
        ctypes.c_char_p, ctypes.c_int, f32p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long)]
    lib.audioio_resample.restype = ctypes.c_int
    lib.audioio_resample.argtypes = [
        f32p, ctypes.c_long, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long)]
    lib.audioio_load_mp3.restype = ctypes.c_int
    lib.audioio_load_mp3.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_double, f32p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long)]


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if g++ fails."""
    return gxx_library(_SRC, "audioio", _bind, link=("-ldl",))


def _capacity(target_sr: int, max_seconds: Optional[float]) -> int:
    # a header peek would need another call: oversize generously
    return (int(target_sr * (max_seconds + 1.0)) if max_seconds
            else target_sr * 60 * 30)


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_wav_native(path: Path, target_sr: int,
                    max_seconds: Optional[float] = None) -> np.ndarray:
    lib = get_lib()
    cap = _capacity(target_sr, max_seconds)
    out = np.zeros(cap, dtype=np.float32)
    n = ctypes.c_long(0)
    rc = lib.audioio_load_wav(str(path).encode(), target_sr, _f32p(out), cap,
                              ctypes.byref(n))
    if rc != 0:
        raise IOError(f"native wav load failed rc={rc} for {path}")
    y = out[: n.value].copy()
    if max_seconds is not None:
        y = y[: int(target_sr * max_seconds)]
    return y


def load_mp3_native(path: Path, target_sr: int,
                    max_seconds: Optional[float] = None) -> np.ndarray:
    """In-process MPEG audio decode (libmpg123 dlopen'd by the C++ layer).
    rc=-20 means libmpg123 is not on this host; the caller
    (io.audio.load_audio) then falls back to the ffmpeg pipe."""
    lib = get_lib()
    cap = _capacity(target_sr, max_seconds)
    out = np.zeros(cap, dtype=np.float32)
    n = ctypes.c_long(0)
    rc = lib.audioio_load_mp3(str(path).encode(), target_sr,
                              float(max_seconds) if max_seconds else -1.0,
                              _f32p(out), cap, ctypes.byref(n))
    if rc == -20:
        raise NativeDecoderUnavailable(f"libmpg123 not found on this host "
                                       f"(rc={rc})")
    if rc != 0:
        raise IOError(f"native mp3 load failed rc={rc} for {path}")
    y = out[: n.value].copy()
    if max_seconds is not None:
        y = y[: int(target_sr * max_seconds)]
    return y


def resample_native(y: np.ndarray, in_sr: int, out_sr: int) -> np.ndarray:
    lib = get_lib()
    y = np.ascontiguousarray(y, dtype=np.float32)
    cap = int(len(y) * (out_sr / in_sr)) + 16
    out = np.zeros(cap, dtype=np.float32)
    n = ctypes.c_long(0)
    rc = lib.audioio_resample(_f32p(y), len(y), in_sr, out_sr, _f32p(out),
                              cap, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"native resample failed rc={rc}")
    return out[: n.value].copy()
