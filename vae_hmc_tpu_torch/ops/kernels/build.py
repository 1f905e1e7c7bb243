"""Build and load the hand-written CUDA kernels; count their launches;
build the port's host C++ libraries.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with ctypes (no PyTorch headers, so a
build takes seconds).  Libraries are named by a hash of their source, so an
edited source is rebuilt and a stale library is never loaded.  ``build()``
starts one ``nvcc`` per source, all at once.

``gxx_library`` compiles a host C++ source (the ward NN-chain, the audio
decoder) with ``g++`` the same way: hash-named under ``BUILD_DIR``, never
into the package, raising with g++'s output when the build fails.

Nothing here runs at import: the CPU tests import every module, and this
package's CPU path never needs ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Sequence

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
KERNELS = ("logmel", "distance")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches per wrapper since the last reset (a wrapper adds one where it
# launches its kernel, and nowhere else)
LAUNCHES: Dict[str, int] = {"mel_db_standardize": 0, "pairwise_dists": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}     # name -> nvcc output (ptxas register use)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (all by default) that are not built yet,
    one nvcc process per source, all started together.  -> {name: seconds}
    for the ones compiled.  Raises with nvcc's output if any fails."""
    names = tuple(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({err}: {msg})")


GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_GXX_LIBS: Dict[Path, ctypes.CDLL] = {}
_gxx_lock = threading.Lock()     # sweeps and decoders load from threads


def gxx_library(src: Path, stem: str,
                bind: Callable[[ctypes.CDLL], None],
                link: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of the host C++ source `src`: ``g++ GXX_FLAGS src
    -o BUILD_DIR/lib<stem>-<hash of source and flags>.so <link>`` at first
    use (written to a temporary name, then renamed, so processes that
    build at once never load half a file), then ``bind(lib)`` to declare
    its argtypes.  A failed build raises with g++'s output, on every call:
    nothing remembers a failure."""
    cmd_tail = (*GXX_FLAGS, "|", *link)
    digest = hashlib.sha256(Path(src).read_bytes()
                            + " ".join(cmd_tail).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"lib{stem}-{digest}.so"
    with _gxx_lock:
        lib = _GXX_LIBS.get(path)
        if lib is None:
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run(
                    ["g++", *GXX_FLAGS, str(src), "-o", str(tmp), *link],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"{stem} build failed:\n{proc.stderr}")
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
            bind(lib)
            _GXX_LIBS[path] = lib
        return lib
