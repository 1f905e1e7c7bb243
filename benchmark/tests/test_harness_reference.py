"""The plain reference against the port at tiny sizes on the CPU, each to
float32 rounding: log-mel and MFCC stats, MiniLM (in memory and from the
checkpoint the hard job writes), the conv VAE's forward and loss, PCA, the
clustering numbers."""
import json

import numpy as np
import pytest
import torch

from benchmark import corpus, weights
from benchmark.reference import cluster, conv_vae, logmel, minilm, pca
from benchmark.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def small():
    cfg = tiny.conv_config()
    mel = cfg["mel"]
    c = corpus.make_corpus(6, mel["duration_s"], mel["sample_rate"], 0.9, 4,
                           CPU)
    return cfg, c


def test_logmel(small):
    from vae_hmc_tpu_torch.core.config import MelConfig
    from vae_hmc_tpu_torch.ops.kernels.logmel import logmel_standardized

    cfg, c = small
    want = logmel_standardized(c.waveforms, MelConfig(**cfg["mel"]))
    got = logmel.logmel(c.waveforms, cfg["mel"])
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 1e-4


def test_mfcc_stats(small):
    from vae_hmc_tpu_torch.core.config import MfccConfig
    from vae_hmc_tpu_torch.ops.mfcc import mfcc_stats_batch

    _, c = small
    m = {"sample_rate": 22050, "n_mfcc": 40, "n_fft": 2048,
         "hop_length": 512, "n_mels": 128, "fmin": 0.0, "fmax": None}
    y = c.waveforms.repeat(1, 4)
    want = mfcc_stats_batch(y, MfccConfig(duration_s=y.shape[1] / 22050))
    got = logmel.mfcc_stats(y, m)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def test_minilm(small):
    from vae_hmc_tpu_torch.text import minilm as port

    cfg, c = small
    mc = cfg["minilm"]
    w = weights.minilm_weights(mc, 9, CPU)
    pcfg = port.MiniLMConfig(
        vocab_size=mc["vocab_size"], hidden=mc["hidden_size"],
        layers=mc["num_hidden_layers"], heads=mc["num_attention_heads"],
        intermediate=mc["intermediate_size"],
        max_pos=mc["max_position_embeddings"])
    model = port.MiniLM(pcfg)
    model.load_state_dict(port.hf_to_state_dict(w, pcfg))
    vocab = corpus.lyric_vocab()
    texts = [t or "" for t in c.texts]
    want = port.encode_texts(model.eval(), port.WordPieceTokenizer(vocab),
                             texts, batch_size=4, to_host=False)
    got = minilm.embed(w, mc, texts, vocab, 256, 5)
    assert float((got - want).abs().max()) < 1e-5


def test_conv_vae_forward_and_loss(small):
    from vae_hmc_tpu_torch.models.conv_mm_vae import ConvMMVAE
    from vae_hmc_tpu_torch.models.losses import elbo_loss

    cfg, c = small
    vae, mel = cfg["vae"], cfg["mel"]
    t = 1 + int(mel["sample_rate"] * mel["duration_s"]) // mel["hop_length"]
    w = weights.conv_vae_weights(vae, mel["n_mels"], t, 2, CPU)
    model = ConvMMVAE(n_mels=mel["n_mels"], n_frames=t,
                      channels=tuple(vae["audio_channels"]),
                      fc_dim=vae["audio_fc_dim"],
                      latent_dim=vae["latent_dim"],
                      lyrics_dim=vae["lyrics_dim"])
    model.load_state_dict(w)
    x = logmel.logmel(c.waveforms, mel)[..., None]
    lyr, m = torch.randn(6, vae["lyrics_dim"]), torch.ones(6, 1)
    eps = torch.randn(6, vae["latent_dim"])
    xhat, mu, logvar = model(x, lyr, m, eps=eps)
    want, _ = elbo_loss(xhat, x, mu, logvar, vae["beta"], "mean")
    h, ww = mel["n_mels"], t
    for _ in vae["audio_channels"]:
        h, ww = weights.conv_out(h), weights.conv_out(ww)
    shape = (vae["audio_channels"][-1], h, ww, mel["n_mels"], t)
    got = conv_vae.loss(w, x, lyr, m, eps, vae["beta"], shape)
    assert float(abs(got - want).detach() / want.detach()) < 1e-6
    mu_ref = conv_vae.export(w, x, lyr, m)
    assert float((mu_ref - mu.detach()).abs().max()) < 1e-5


def test_clustering_numbers():
    from vae_hmc_tpu_torch.cluster.kmeans import kmeans
    from vae_hmc_tpu_torch.core.config import KMeansConfig
    from vae_hmc_tpu_torch.metrics import external, internal

    g = torch.Generator().manual_seed(0)
    centers = 6.0 * torch.randn(4, 5, generator=g)
    x = (centers.repeat_interleave(30, 0)
         + torch.randn(120, 5, generator=g))
    truth = np.repeat(np.arange(4), 30)
    km = kmeans(x, KMeansConfig(n_clusters=4, n_init=3, seed=1), device="cpu")
    lab, cen, inertia = cluster.kmeans(x.double(), 4, 3, 1)
    assert cluster.ari(km.labels, lab.numpy()) == 1.0
    assert inertia == pytest.approx(km.inertia, rel=1e-4)
    lab = torch.as_tensor(km.labels, dtype=torch.int64)
    x64 = x.double()
    assert cluster.assignment_excess(
        x64, torch.as_tensor(km.centers, dtype=torch.float64), lab) < 1e-6
    assert cluster.silhouette(x64, lab) == pytest.approx(
        internal.silhouette(x, km.labels, device="cpu"), abs=1e-5)
    assert cluster.davies_bouldin(x64, lab) == pytest.approx(
        internal.davies_bouldin(x, km.labels, device="cpu"), abs=1e-5)
    pred = (truth + (np.arange(120) % 7 == 0)) % 4
    assert cluster.ari(pred, truth) == pytest.approx(
        external.adjusted_rand_index(pred, truth), abs=1e-12)
    assert cluster.nmi(pred, truth) == pytest.approx(
        external.normalized_mutual_info(truth, pred), abs=1e-12)
    assert cluster.purity(pred, truth) == pytest.approx(
        external.purity(pred, truth), abs=1e-12)


def test_minilm_checkpoint_loads_in_the_port(tmp_path):
    from vae_hmc_tpu_torch.text import minilm as port

    mc = dict(json.loads((tiny.ROOT / "benchmark/configs/hard_beta_vae.json")
                         .read_text())["minilm"])
    w = weights.minilm_weights(mc, 3, CPU)
    vocab = corpus.lyric_vocab()
    path = weights.write_minilm_checkpoint(tmp_path / "minilm", w, vocab)
    model, tok = port.load_minilm(path, device="cpu")
    texts = ["fire road thunder", "", "love baby heart tonight"]
    want = port.encode_texts(model, tok, texts, batch_size=2, to_host=False)
    got = minilm.embed(w, mc, texts, vocab, mc["max_seq_length"], 2)
    assert float((got - want).abs().max()) < 1e-5


def test_pca_projection():
    from vae_hmc_tpu_torch.ops.pca import PCA

    g = torch.Generator().manual_seed(3)
    x = torch.randn(200, 12, generator=g) * torch.linspace(3.0, 0.2, 12)
    want = PCA(5, device="cpu").fit_transform(x)
    got = pca.project(x.double(), 5)
    assert pca.gram_gap(want.double(), got) < 1e-5
    assert pca.gram_gap(pca.project(x.double(), 4), got) > 1e-2


def test_knn_recall_and_inertia_excess():
    g = torch.Generator().manual_seed(4)
    x = torch.randn(120, 4, generator=g, dtype=torch.float64)
    assert cluster.knn_recall(x, 3.0 * x + 1.0, 5) == 1.0
    assert cluster.knn_recall(x, x[torch.randperm(120, generator=g)], 5) < 0.3
    lab, _c, _i = cluster.kmeans(x, 3, 4, 0)
    assert cluster.inertia_excess(x, lab, 3, 4, 0) == 0.0
    bad = torch.randint(0, 3, (120,), generator=g)
    assert cluster.inertia_excess(x, bad, 3, 4, 0) > 0.1
