"""Tiny cells for the CPU tests: the published configurations with their
scale cut to seconds of CPU time (few tracks, short clips, one MiniLM
layer, narrow mels), and a throwaway cell built from them."""
from __future__ import annotations

import copy
import json
from pathlib import Path

from benchmark import spec

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]


def conv_config() -> dict:
    cfg = json.loads((ROOT / "benchmark/configs/conv_mm_vae.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["n_tracks"] = 24
    cfg["mel"].update(duration_s=0.5, n_mels=32, n_fft=256, hop_length=128)
    cfg["vae"].update(in_mels=32, in_frames=87, epochs=2, batch_size=4,
                      audio_fc_dim=16)
    cfg["minilm"].update(num_hidden_layers=1, vocab_size=80,
                         max_position_embeddings=128, batch_size=8)
    cfg["kmeans"].update(n_init=2)
    return cfg


def conv_cell() -> spec.Cell:
    wl = json.loads((ROOT / "benchmark/workloads/conv_mm_vae.f32_job.json")
                    .read_text())
    wl["traffic"]["device_batch"] = 8
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = "conv_mm_vae.f32_job"
    return spec.Cell(
        name=name, chips=1, config=conv_config(), workload=wl,
        end_to_end=[m for m in manifest["end_to_end"]
                    if spec._reports(m, name)],
        per_layer=[m for m in manifest["per_layer"]
                   if spec._reports(m, name)])


def hard_config() -> dict:
    cfg = json.loads((ROOT / "benchmark/configs/hard_beta_vae.json")
                     .read_text())
    cfg = copy.deepcopy(cfg)
    cfg["n_tracks"] = 48
    cfg["mfcc"].update(duration_s=1.5)
    cfg["vae"].update(epochs=2, batch_size=16)
    cfg["ae"].update(epochs=2, batch_size=16)
    # MiniLM at its published size: the program loads it from a checkpoint
    # with the published configuration
    cfg["text"].update(batch_size=8)
    return cfg


def hard_cell() -> spec.Cell:
    wl = json.loads((ROOT / "benchmark/workloads/hard_beta_vae.tier_job.json")
                    .read_text())
    wl["traffic"]["device_batch"] = 16
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = "hard_beta_vae.tier_job"
    return spec.Cell(
        name=name, chips=1, config=hard_config(), workload=wl,
        end_to_end=[m for m in manifest["end_to_end"]
                    if spec._reports(m, name)],
        per_layer=[m for m in manifest["per_layer"]
                   if spec._reports(m, name)])
