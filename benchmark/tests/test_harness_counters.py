"""The counters of operations and bytes against hand counts at small
shapes, and the models' FLOPs against torch's own FLOP counter."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counters
from benchmark.tests import tiny


def test_peaks():
    assert counters.bound_s(495e12, 0.0) == pytest.approx(1.0)
    assert counters.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert counters.bound_s(989e12, 0.0, "bfloat16") == pytest.approx(1.0)
    assert counters.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("args,ops,nbytes", [
    # 3 x 2 self: 6 pairs i <= j, 3 row norms, 3 ops a pair's epilogue
    ((3, 3, 2, True), 2 * 2 * 6 + 2 * 2 * 3 + 3 * 6, 4 * (3 * 2 + 9)),
    ((2, 3, 4, False), 2 * 4 * 6 + 2 * 4 * 5 + 3 * 6, 4 * (5 * 4 + 6)),
])
def test_distance(args, ops, nbytes):
    got = counters.distance_launch(*args)
    assert got == {"ops": ops, "bytes": nbytes}


def test_logmel():
    # batch 2, 5 bins, 3 frames, 4 mels, 6 nonzero weights, standardized
    got = counters.logmel_launch(2, 5, 3, 4, 6, True)
    assert got["ops"] == 2 * 6 * 3 * 2 + 24 * 6
    assert got["bytes"] == 4 * (2 * 5 * 3 + 24 + 6) + 8 * 4
    plain = counters.logmel_launch(2, 5, 3, 4, 6, False)
    assert plain["ops"] == 2 * 6 * 3 * 2 + 24 * 2


def test_conv_vae_forward_matches_torch_counter():
    from vae_hmc_tpu_torch.models.conv_mm_vae import ConvMMVAE

    cfg = tiny.conv_config()
    vae, mel = cfg["vae"], cfg["mel"]
    t = 1 + int(mel["sample_rate"] * mel["duration_s"]) // mel["hop_length"]
    model = ConvMMVAE(n_mels=mel["n_mels"], n_frames=t,
                      channels=tuple(vae["audio_channels"]),
                      fc_dim=vae["audio_fc_dim"],
                      latent_dim=vae["latent_dim"],
                      lyrics_dim=vae["lyrics_dim"])
    b = 3
    x = torch.randn(b, mel["n_mels"], t, 1)
    lyr, m = torch.randn(b, vae["lyrics_dim"]), torch.ones(b, 1)
    with FlopCounterMode(display=False) as fc:
        model(x, lyr, m, eps=torch.zeros(b, vae["latent_dim"]))
    want = counters.conv_vae_forward(vae, mel["n_mels"], t)
    assert want["encoder"] + want["decoder"] == pytest.approx(
        fc.get_total_flops() / b, rel=1e-12)
    with FlopCounterMode(display=False) as fc:
        model.encode(x, lyr, m)
    assert want["encoder"] == pytest.approx(fc.get_total_flops() / b,
                                            rel=1e-12)


def test_minilm_matches_torch_counter():
    from vae_hmc_tpu_torch.text import minilm

    mc = tiny.conv_config()["minilm"]
    model = minilm.MiniLM(minilm.MiniLMConfig(
        vocab_size=mc["vocab_size"], hidden=mc["hidden_size"],
        layers=mc["num_hidden_layers"], heads=mc["num_attention_heads"],
        intermediate=mc["intermediate_size"],
        max_pos=mc["max_position_embeddings"]))
    b, s = 2, 7
    ids = torch.randint(0, mc["vocab_size"], (b, s))
    with FlopCounterMode(display=False) as fc:
        model(ids, torch.ones(b, s))
    assert counters.minilm_token(mc, s) * b * s == pytest.approx(
        fc.get_total_flops(), rel=1e-12)


def test_dense_forward():
    assert counters.dense_forward((464, 256, 256, 16)) == 2 * (
        464 * 256 + 256 * 256 + 256 * 16)
