"""Model weights made from the run's seed, on the device, in one draw a model.

Each model is a list of leaves (name, shape, kind).  One ``torch.rand`` or
``torch.randn`` fills a flat buffer for all leaves; each leaf is a slice of
it, scaled by its kind.  The benchmark hands the same leaves to the program
and to the plain reference.

- ``minilm_leaves``: all-MiniLM-L6-v2's leaves under their HuggingFace
  names, at the published shapes; dense and embedding leaves N(0, 0.02)
  (BERT's initializer), LayerNorm scales 1 + N(0, 0.02), biases N(0, 0.02).
- ``conv_vae_leaves``: the conv multimodal VAE of reference script 12
  (names of the port's module, which are the Flax module's); every leaf
  U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = inputs x kernel area.
"""
from __future__ import annotations

import json
import math
import struct
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

Leaf = Tuple[str, Tuple[int, ...], float]      # (name, shape, scale)


def _seed(seed: int, stream: int) -> int:
    return int(np.random.default_rng([seed & ((1 << 63) - 1), stream])
               .integers(0, 2 ** 62))


def minilm_leaves(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    h, f = cfg["hidden_size"], cfg["intermediate_size"]
    out = [("embeddings.word_embeddings.weight", (cfg["vocab_size"], h), "w"),
           ("embeddings.position_embeddings.weight",
            (cfg["max_position_embeddings"], h), "w"),
           ("embeddings.token_type_embeddings.weight",
            (cfg["type_vocab_size"], h), "w"),
           ("embeddings.LayerNorm.weight", (h,), "ln"),
           ("embeddings.LayerNorm.bias", (h,), "w")]
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        for name, shape in (
                ("attention.self.query", (h, h)),
                ("attention.self.key", (h, h)),
                ("attention.self.value", (h, h)),
                ("attention.output.dense", (h, h)),
                ("intermediate.dense", (f, h)),
                ("output.dense", (h, f))):
            out.append((p + name + ".weight", shape, "w"))
            out.append((p + name + ".bias", (shape[0],), "w"))
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            out.append((p + ln + ".weight", (h,), "ln"))
            out.append((p + ln + ".bias", (h,), "w"))
    return out


def minilm_weights(cfg: dict, seed: int,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    leaves = minilm_leaves(cfg)
    total = sum(math.prod(s) for _, s, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, 10))
    flat = torch.randn(total, generator=gen, device=device).mul_(
        cfg["initializer_range"])
    out, at = {}, 0
    for name, shape, kind in leaves:
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape)
        if kind == "ln":
            leaf.add_(1.0)
        out[name] = leaf
        at += n
    return out


def write_minilm_checkpoint(path: Path, w: Dict[str, torch.Tensor],
                            vocab: Dict[str, int]) -> Path:
    """`w` and `vocab` as a HuggingFace checkpoint folder:
    ``model.safetensors`` (an 8-byte little-endian header length, a JSON
    header of each tensor's dtype, shape and byte range, then the float32
    data) and ``vocab.txt`` (one token a line, in id order).  -> the
    folder."""
    path.mkdir(parents=True, exist_ok=True)
    header, blobs, at = {}, [], 0
    for name, t in w.items():
        raw = t.detach().to("cpu", torch.float32).contiguous().numpy()
        raw = raw.tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [at, at + len(raw)]}
        blobs.append(raw)
        at += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path / "model.safetensors", "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
    (path / "vocab.txt").write_text(
        "".join(tok + "\n" for tok in sorted(vocab, key=vocab.get)),
        encoding="utf-8")
    return path


def conv_out(n: int) -> int:
    return (n + 2 - 3) // 2 + 1


def conv_vae_leaves(vae: dict, n_mels: int, n_frames: int
                    ) -> List[Leaf]:
    """(name, shape, bound) of every leaf of the conv multimodal VAE."""
    ch = list(vae["audio_channels"])
    h, w = n_mels, n_frames
    for _ in ch:
        h, w = conv_out(h), conv_out(w)
    flat = h * w * ch[-1]
    fc, lat, lyr = vae["audio_fc_dim"], vae["latent_dim"], vae["lyrics_dim"]
    lh = list(vae["lyrics_hidden"])
    leaves: List[Leaf] = []

    def add(name, wshape, bshape, fan_in):
        b = 1.0 / math.sqrt(fan_in)
        leaves.append((name + ".weight", wshape, b))
        leaves.append((name + ".bias", bshape, b))

    for i, (cin, cout) in enumerate(zip([1] + ch[:-1], ch)):
        add(f"enc_convs.{i}", (cout, cin, 3, 3), (cout,), cin * 9)
    add("enc_fc", (fc, flat), (fc,), flat)
    add("mu_a", (vae["audio_latent_dim"], fc), (vae["audio_latent_dim"],), fc)
    add("logvar_a", (vae["audio_latent_dim"], fc),
        (vae["audio_latent_dim"],), fc)
    add("lyr1", (lh[0], lyr), (lh[0],), lyr)
    add("lyr2", (lh[1], lh[0]), (lh[1],), lh[0])
    fuse_in = vae["audio_latent_dim"] + lh[1] + 1
    add("fuse", (256, fuse_in), (256,), fuse_in)
    add("mu", (lat, 256), (lat,), 256)
    add("logvar", (lat, 256), (lat,), 256)
    add("dec_fc1", (256, lat), (256,), lat)
    add("dec_fc2", (flat, 256), (flat,), 256)
    dch = list(reversed(ch[:-1])) + [1]
    for i, (cin, cout) in enumerate(zip([ch[-1]] + dch[:-1], dch)):
        add(f"dec_convs.{i}", (cin, cout, 4, 4), (cout,), cin * 16)
    return leaves


def conv_vae_weights(vae: dict, n_mels: int, n_frames: int, seed: int,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    leaves = conv_vae_leaves(vae, n_mels, n_frames)
    total = sum(math.prod(s) for _, s, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, 20))
    flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, shape, bound in leaves:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(bound)
        at += n
    return out


def epoch_perms(n: int, epochs: int, seed: int,
                stream: int = 30) -> List[np.ndarray]:
    """One row order per epoch (a fit of its own takes a `stream` of its
    own)."""
    rng = np.random.default_rng([seed & ((1 << 63) - 1), stream])
    return [rng.permutation(n) for _ in range(epochs)]


class StepNoise:
    """The reparameterization noise of each training step: (batch, latent)
    standard normals from a device generator that is reseeded at the start
    of every epoch, so epoch e's draws depend on (seed, e) alone."""

    def __init__(self, seed: int, batch: int, latent: int,
                 device: torch.device):
        self.seed, self.shape, self.device = seed, (batch, latent), device
        self.gen = torch.Generator(device=device)

    def __call__(self, epoch: int, step: int) -> torch.Tensor:
        if step == 0:
            self.gen.manual_seed(_seed(self.seed, 1000 + epoch))
        return torch.randn(self.shape, generator=self.gen, device=self.device)


def dense_weights(layers: List[Tuple[str, int, int]], seed: int, stream: int,
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """Linear leaves {name}.weight (out, in) and {name}.bias, each
    U(-1/sqrt(in), 1/sqrt(in)), from one draw."""
    total = sum(o * i + o for _, i, o in layers)
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, stream))
    flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, i, o in layers:
        b = 1.0 / math.sqrt(i)
        out[name + ".weight"] = flat[at:at + o * i].view(o, i).mul_(b)
        at += o * i
        out[name + ".bias"] = flat[at:at + o].mul_(b)
        at += o
    return out
