"""Operations and bytes from shapes, and the card's peaks.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 3.35 TB/s of HBM; 495 TFLOP/s for float32-class work, the TF32
tensor-core rate, which no float32-accurate implementation (3xTF32
splitting included) can beat; 989 TFLOP/s for bf16.

A kernel's bound counts each input byte read once and each output byte
written once, and the operations its result needs: ``bound_s`` is the
larger of bytes / bandwidth and operations / peak.  A model's FLOPs are
2 x multiply-adds of its forward pass; a training step is 3 x forward
(forward, gradient of the activations, gradient of the weights).
"""
from __future__ import annotations

from typing import Dict

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}


def bound_s(ops: float, nbytes: float, dtype: str = "float32") -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype])


# -- kernel 1: mel filterbank -> dB -> floor -> (standardize) ---------------

def logmel_launch(batch: int, n_freq: int, n_frames: int, n_mels: int,
                  nnz: int, standardize: bool) -> Dict[str, float]:
    """One launch over a (batch, n_freq, n_frames) power spectrogram with a
    filterbank of `nnz` nonzero weights.  Operations: a multiply-add per
    nonzero weight and frame, then per output element a log and the
    floor's max (2), and for the standardization a mean, a variance and
    the scaling (4)."""
    out = batch * n_mels * n_frames
    ops = 2.0 * nnz * n_frames * batch + out * (6 if standardize else 2)
    nbytes = 4.0 * (batch * n_freq * n_frames + out + nnz) + 8.0 * n_mels
    return {"ops": ops, "bytes": nbytes}


# -- kernel 2: pairwise euclidean distances ----------------------------------

def distance_launch(n: int, m: int, d: int, self_dist: bool
                    ) -> Dict[str, float]:
    """(n, d) x (m, d) -> (n, m).  With y = x the pairs i <= j are counted
    once (the output is symmetric); a pair costs a multiply-add per column
    and a row norm costs one per column."""
    pairs = n * (n + 1) / 2 if self_dist else n * m
    rows = n if self_dist else n + m
    ops = 2.0 * d * pairs + 2.0 * d * rows + 3.0 * pairs
    nbytes = 4.0 * (rows * d + n * m)
    return {"ops": ops, "bytes": nbytes}


# -- model FLOPs ---------------------------------------------------------------

def _conv_out(n: int) -> int:
    return (n + 2 - 3) // 2 + 1


def conv_vae_forward(vae: dict, n_mels: int, n_frames: int) -> Dict[str, float]:
    """FLOPs of one sample's forward: {"encoder", "decoder"}."""
    ch = list(vae["audio_channels"])
    h, w, cin = n_mels, n_frames, 1
    enc = 0.0
    for c in ch:
        h, w = _conv_out(h), _conv_out(w)
        enc += 2.0 * h * w * c * cin * 9
        cin = c
    flat = h * w * ch[-1]
    fc, lat, a_lat = vae["audio_fc_dim"], vae["latent_dim"], \
        vae["audio_latent_dim"]
    l1, l2 = vae["lyrics_hidden"]
    enc += 2.0 * (flat * fc + 2 * fc * a_lat + vae["lyrics_dim"] * l1
                  + l1 * l2 + (a_lat + l2 + 1) * 256 + 2 * 256 * lat)
    dec = 2.0 * (lat * 256 + 256 * flat)
    dch = list(reversed(ch[:-1])) + [1]
    cin = ch[-1]
    for c in dch:
        dec += 2.0 * h * w * cin * c * 16      # each input pixel x 4x4 taps
        h, w, cin = 2 * h, 2 * w, c
    return {"encoder": enc, "decoder": dec}


def dense_forward(dims) -> float:
    """FLOPs of one sample through linear layers of widths dims[0] -> ..."""
    return 2.0 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def minilm_token(cfg: dict, seq: int) -> float:
    """FLOPs of one token through the encoder in a sequence of `seq`."""
    h, f = cfg["hidden_size"], cfg["intermediate_size"]
    per_layer = 2.0 * (4 * h * h + 2 * h * f) + 2.0 * 2 * seq * h
    return cfg["num_hidden_layers"] * per_layer
