"""WAV files and a small manifest corpus for the port's IO tests (numpy
only: tests/test_torch_cuda.py imports it on a machine without JAX)."""
from pathlib import Path
from typing import Dict, List

import numpy as np

# (WAVE format tag, bits) per encoding: 1 = integer PCM, 3 = IEEE float
ENCODINGS = {"pcm16": (1, 16), "pcm24": (1, 24), "pcm32": (1, 32),
             "float32": (3, 32), "float64": (3, 64), "pcm8": (1, 8)}


def encode(y: np.ndarray, encoding: str) -> bytes:
    """(n,) or (n, channels) float samples in [-1, 1] -> interleaved bytes."""
    y = np.clip(np.asarray(y, dtype=np.float64), -1.0, 1.0)
    if encoding == "pcm8":
        return (np.round(y * 127.0) + 128).astype(np.uint8).tobytes()
    if encoding == "pcm16":
        return (y * 32767).astype("<i2").tobytes()
    if encoding == "pcm24":
        v = (y * 8388607).astype("<i4")
        b = v.view(np.uint8).reshape(-1, 4)[:, :3]
        return np.ascontiguousarray(b).tobytes()
    if encoding == "pcm32":
        return (y * 2147483647).astype("<i4").tobytes()
    if encoding == "float32":
        return y.astype("<f4").tobytes()
    if encoding == "float64":
        return y.astype("<f8").tobytes()
    raise ValueError(encoding)


def write_wav(path: Path, y: np.ndarray, sr: int,
              encoding: str = "pcm16") -> Path:
    """RIFF/WAVE writer for every encoding the native decoder reads."""
    y = np.asarray(y)
    channels = 1 if y.ndim == 1 else y.shape[1]
    fmt, bits = ENCODINGS[encoding]
    data = encode(y, encoding)
    block = channels * bits // 8
    header = (b"fmt " + (16).to_bytes(4, "little")
              + fmt.to_bytes(2, "little") + channels.to_bytes(2, "little")
              + sr.to_bytes(4, "little") + (sr * block).to_bytes(4, "little")
              + block.to_bytes(2, "little") + bits.to_bytes(2, "little"))
    body = (b"WAVE" + header + b"data" + len(data).to_bytes(4, "little")
            + data)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"RIFF" + len(body).to_bytes(4, "little") + body)
    return path


def tone(seconds: float, sr: int, f0: float, seed: int = 0,
         channels: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(round(sr * seconds))) / sr
    y = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.02 * rng.standard_normal(len(t))
    if channels == 1:
        return y
    return np.stack([y, 0.5 * y[::-1]], axis=1)


def corpus_rows(root: Path, seconds: float = 1.5,
                short: Dict[int, float] = None) -> List[Dict[str, str]]:
    """12 PCM16 22,050 Hz tracks over 3 "genres" (tone registers) with
    lyrics files, then one corrupt file (not RIFF): the corpus of the JAX
    package's tests/test_file_source_e2e.py.  `short` maps a row to a
    shorter duration in seconds.  Half the paths are written with Windows
    separators, relative to `root`."""
    sr = 22050
    short = short or {}
    rows = []
    for i in range(12):
        tid = 500 + i
        y = tone(short.get(i, seconds), sr, [220.0, 440.0, 880.0][i % 3],
                 seed=i)
        write_wav(root / "audio" / f"{tid}.wav", y, sr)
        txt = root / "text" / f"{tid}.txt"
        txt.parent.mkdir(parents=True, exist_ok=True)
        txt.write_text(f"lyrics for track {tid} la la " * 5)
        sep = "\\" if i % 2 else "/"
        rows.append({"track_id": str(tid), "title": f"t{tid}",
                     "artist": "a", "genre": ["Rock", "Pop", "Folk"][i % 3],
                     "audio_path": f"audio{sep}{tid}.wav",
                     "lyrics_path": f"text{sep}{tid}.txt",
                     "text_path_combined": f"text{sep}{tid}.txt",
                     "text_exists": "True"})
    (root / "audio" / "999.wav").write_bytes(b"not a wav at all")
    rows.append({"track_id": "999", "title": "bad", "artist": "a",
                 "genre": "Rock", "audio_path": "audio/999.wav",
                 "lyrics_path": "", "text_path_combined": "",
                 "text_exists": "False"})
    return rows
