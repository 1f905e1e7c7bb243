"""The port's MiniLM lyrics encoder against the JAX package's.

  - WordPiece ids and masks are identical on the synthetic corpus, and so
    is the corpus vocab of ``synthetic_minilm``;
  - the same Flax weights, carried across by ``models.convert``, give the
    same embeddings within atol 2e-5, at a tiny config (2 layers x 32 wide)
    and at the full all-MiniLM-L6-v2 shape; the port pads each batch to
    its own longest row, JAX every batch to 256;
  - ``load_minilm`` reads a test-written checkpoint as ``pytorch_model.bin``
    and as ``model.safetensors`` into the same weights, and at full size
    embeds as the JAX loader does;
  - ``synthetic_minilm`` draws from the Flax initializers' distributions;
  - ``embed_texts``'s backend chain, and ``run_core``'s lyrics stage
    finding its checkpoint through the same ``find_minilm_dir``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from vae_hmc_tpu.core import config as jconfig
from vae_hmc_tpu.pipelines import synthetic as jsyn
from vae_hmc_tpu.text import embed as jembed
from vae_hmc_tpu.text import minilm as jminilm
from vae_hmc_tpu_torch.core import config as tconfig
from vae_hmc_tpu_torch.models.convert import minilm_state_dict
from vae_hmc_tpu_torch.text import embed, minilm

torch.manual_seed(0)
torch.set_num_threads(1)

TINY = dict(hidden=32, layers=2, heads=4, intermediate=64)
LONG = " ".join(["love", "rain", "night", "unbelievable", "o'clock"] * 80)


@pytest.fixture(scope="module")
def corpus():
    ds = jsyn.make_dataset(40, seed=3, lyrics_coverage=0.9)
    return [t or "" for t in ds.lyrics] + [LONG, "Hello, WORLD!! 42",
                                           "x" * 120, "  "]


@pytest.fixture(scope="module")
def jax_full(corpus):
    """JAX synthetic_minilm(seed=7) at the real shape: (module, params, tok)."""
    return jminilm.synthetic_minilm(corpus, seed=7)


def test_config_copies():
    assert dataclasses.asdict(minilm.MiniLMConfig()) == dataclasses.asdict(
        jminilm.MiniLMConfig())
    for name in ("TextEmbedConfig", "SweepConfig", "Workspace"):
        assert dataclasses.asdict(getattr(tconfig, name)()) == \
            dataclasses.asdict(getattr(jconfig, name)()), name
    ws, jws = tconfig.Workspace("r"), jconfig.Workspace("r")
    assert (ws.data, ws.results, ws.manifest_clean()) == \
        (jws.data, jws.results, jws.manifest_clean())


def test_wordpiece_ids_and_masks_identical(corpus, jax_full):
    _, _, jtok = jax_full
    vocab = minilm.corpus_vocab(corpus, minilm.MiniLMConfig().vocab_size)
    assert vocab == jtok.vocab
    tok = minilm.WordPieceTokenizer(vocab, 256)
    for batch in (corpus[:7], corpus[7:], [LONG]):
        ids, mask = tok.encode_batch(batch)
        jids, jmask = jtok.encode_batch(batch)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(mask, jmask)
    # sub-word pieces, [UNK] and truncation on a hand vocab
    small = {t: i for i, t in enumerate(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "cat", "##s", "un",
         "##believ", "##able"])}
    texts = ["the cats", "unbelievable zzz", "THE cat! " * 20]
    np.testing.assert_array_equal(
        minilm.WordPieceTokenizer(small, 16).encode_batch(texts)[0],
        jminilm.WordPieceTokenizer(small, 16).encode_batch(texts)[0])


def _port_model(cfg, variables):
    model = minilm.MiniLM(cfg)
    model.load_state_dict(minilm_state_dict(variables))
    return model.eval()


def test_tiny_embeddings_match_jax(corpus):
    """Tiny config, Flax init carried across; JAX pads every batch to 256,
    the port each batch to its own longest row."""
    vocab = minilm.corpus_vocab(corpus, 30522)
    jcfg = jminilm.MiniLMConfig(**TINY)
    jmodel = jminilm.MiniLM(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(1), np.zeros((1, 4), np.int32),
                            np.ones((1, 4), np.float32))
    want = jminilm.encode_texts(jmodel, variables,
                                jminilm.WordPieceTokenizer(vocab, 256),
                                corpus, batch_size=8)
    model = _port_model(minilm.MiniLMConfig(**TINY), variables)
    got = minilm.encode_texts(model, minilm.WordPieceTokenizer(vocab, 256),
                              corpus, batch_size=5)
    assert got.shape == want.shape == (len(corpus), 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_full_size_embeddings_match_jax(corpus, jax_full):
    jmodel, variables, jtok = jax_full
    texts = [corpus[0], "a short song about the rain"]
    want = jminilm.encode_texts(jmodel, variables, jtok, texts, batch_size=2)
    model = _port_model(minilm.MiniLMConfig(), variables)
    tok = minilm.WordPieceTokenizer(dict(jtok.vocab), 256)
    got = minilm.encode_texts(model, tok, texts, batch_size=2)
    assert got.shape == (2, 384)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_synthetic_minilm_draws_flax_distributions(corpus, jax_full):
    _, variables, jtok = jax_full
    model, tok = minilm.synthetic_minilm(corpus, seed=7, device="cpu")
    assert tok.vocab == jtok.vocab and tok.max_len == 256
    ref = minilm_state_dict(variables)
    ours = model.state_dict()
    assert set(ours) == set(ref)
    for name, w in ours.items():
        r = ref[name]
        assert w.shape == r.shape, name
        if name.endswith("_ln.weight") or name.endswith("_ln.bias") or (
                name.endswith(".bias") and "ln" not in name):
            torch.testing.assert_close(w, r, rtol=0, atol=0, msg=name)
            continue
        rel = abs(float(w.std()) / float(r.std()) - 1.0)
        assert rel < (0.05 if w.numel() > 1000 else 0.25), (name, rel)
        if "emb" not in name:              # lecun_normal truncates at 2 std
            bound = 2.0 / np.sqrt(w.shape[1]) / 0.87962566103423978
            assert float(w.abs().max()) <= bound * (1 + 1e-6), name
    again, _ = minilm.synthetic_minilm(corpus, seed=7, device="cpu")
    torch.testing.assert_close(again.state_dict(), ours, rtol=0, atol=0)


def _hf_state_dict(cfg, rng):
    """Random weights in the HF BERT layout (dense weights (out, in)), with
    the pooler keys real checkpoints carry."""
    sd = {"embeddings.word_embeddings.weight": (cfg.vocab_size, cfg.hidden),
          "embeddings.position_embeddings.weight": (cfg.max_pos, cfg.hidden),
          "embeddings.token_type_embeddings.weight": (cfg.type_vocab,
                                                      cfg.hidden),
          "embeddings.LayerNorm.weight": (cfg.hidden,),
          "embeddings.LayerNorm.bias": (cfg.hidden,),
          "pooler.dense.weight": (cfg.hidden, cfg.hidden),
          "pooler.dense.bias": (cfg.hidden,)}
    for i in range(cfg.layers):
        p = f"encoder.layer.{i}."
        for name, (o, n_in) in {
                "attention.self.query": (cfg.hidden, cfg.hidden),
                "attention.self.key": (cfg.hidden, cfg.hidden),
                "attention.self.value": (cfg.hidden, cfg.hidden),
                "attention.output.dense": (cfg.hidden, cfg.hidden),
                "intermediate.dense": (cfg.intermediate, cfg.hidden),
                "output.dense": (cfg.hidden, cfg.intermediate)}.items():
            sd[p + name + ".weight"] = (o, n_in)
            sd[p + name + ".bias"] = (o,)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + name + ".weight"] = (cfg.hidden,)
            sd[p + name + ".bias"] = (cfg.hidden,)
    out = {}
    for k, shape in sd.items():
        mean = 1.0 if k.endswith("LayerNorm.weight") else 0.0
        out[k] = rng.normal(mean, 0.05, shape).astype(np.float32)
    return out


def _write_checkpoint(path, sd, fmt, vocab, prefix=""):
    path.mkdir(parents=True, exist_ok=True)
    sd = {prefix + k: v for k, v in sd.items()}
    if fmt == "model.safetensors":
        from safetensors.numpy import save_file
        save_file(sd, path / fmt)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path / fmt)
    (path / "vocab.txt").write_text("\n".join(vocab), encoding="utf-8")
    return path


VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "cat", "sat", "##s",
         "rain"] + [f"w{i}" for i in range(91)]


@pytest.mark.parametrize("fmt,prefix", [("pytorch_model.bin", ""),
                                        ("model.safetensors", "bert.")])
def test_load_minilm_reads_both_formats(tmp_path, fmt, prefix):
    if fmt == "model.safetensors":
        pytest.importorskip("safetensors")
    cfg = minilm.MiniLMConfig(vocab_size=len(VOCAB), max_pos=64, **TINY)
    sd = _hf_state_dict(cfg, np.random.default_rng(5))
    d = _write_checkpoint(tmp_path / "ckpt", sd, fmt, VOCAB, prefix)
    model, tok = minilm.load_minilm(d, cfg, device="cpu")
    assert tok.vocab["rain"] == 8 and tok.max_len == 256
    got = model.state_dict()
    assert got["tok_emb.weight"].numpy().tobytes() == \
        sd["embeddings.word_embeddings.weight"].tobytes()
    assert np.array_equal(got["layers.1.ff2.weight"].numpy(),
                          sd["encoder.layer.1.output.dense.weight"])
    assert np.array_equal(got["layers.0.att_ln.bias"].numpy(),
                          sd["encoder.layer.0.attention.output.LayerNorm.bias"])
    # the same weights through the other format, and the same embeddings
    other = "model.safetensors" if fmt == "pytorch_model.bin" else \
        "pytorch_model.bin"
    if other == "model.safetensors":
        pytest.importorskip("safetensors")
    model2, _ = minilm.load_minilm(
        _write_checkpoint(tmp_path / "other", sd, other, VOCAB), cfg,
        device="cpu")
    torch.testing.assert_close(model2.state_dict(), got, rtol=0, atol=0)
    texts = ["the cats sat", "rain"]
    np.testing.assert_array_equal(minilm.encode_texts(model, tok, texts),
                                  minilm.encode_texts(model2, tok, texts))


@pytest.fixture(scope="module")
def full_checkpoint(tmp_path_factory):
    cfg = minilm.MiniLMConfig()
    sd = _hf_state_dict(cfg, np.random.default_rng(11))
    vocab = VOCAB + [f"v{i}" for i in range(cfg.vocab_size - len(VOCAB))]
    return _write_checkpoint(tmp_path_factory.mktemp("full"), sd,
                             "pytorch_model.bin", vocab)


def test_load_minilm_full_size_matches_jax_loader(full_checkpoint):
    texts = ["the cats sat in the rain", "w3 w7 rain the", "zzz"]
    jmodel, jparams, jtok = jminilm.load_minilm(full_checkpoint)
    want = jminilm.encode_texts(jmodel, jparams, jtok, texts, batch_size=4)
    model, tok = minilm.load_minilm(full_checkpoint, device="cpu")
    np.testing.assert_allclose(minilm.encode_texts(model, tok, texts), want,
                               rtol=0, atol=2e-5)


def test_embed_texts_backend_chain(tmp_path, monkeypatch, full_checkpoint):
    monkeypatch.delenv("VAE_HMC_MINILM_DIR", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "no_hf_cache"))
    texts = ["the cats sat in the rain", "Hello, World!"]
    # no directory: TF-IDF, as the JAX package (same vectors; sklearn is
    # installed here, so both use its 318-word stop list)
    emb, backend = embed.embed_texts(texts, device="cpu")
    want, jbackend = jembed.embed_texts(texts)
    assert backend == jbackend == "tfidf"
    np.testing.assert_array_equal(emb, want)
    emb, backend = embed.embed_texts(texts, allow_tfidf=False, device="cpu")
    assert backend == "hashed"
    np.testing.assert_array_equal(emb, jembed.hashed_embedding(texts))
    # a found directory is used; the JAX package gives the same embeddings
    monkeypatch.setenv("VAE_HMC_MINILM_DIR", str(full_checkpoint))
    emb, backend = embed.embed_texts(texts, device="cpu")
    want, jbackend = jembed.embed_texts(texts)
    assert backend == jbackend == "minilm"
    np.testing.assert_allclose(emb, want, rtol=0, atol=2e-5)
    # a found directory that fails to load raises (no quiet fallback)
    broken = tmp_path / "broken"
    broken.mkdir()
    (broken / "vocab.txt").write_text("\n".join(VOCAB))
    with pytest.raises(FileNotFoundError):
        embed.embed_texts(texts, model_dir=broken, device="cpu")


def test_run_core_and_script_11_find_the_same_checkpoint(
        tmp_path, monkeypatch, full_checkpoint):
    """run_core's lyrics stage and embed_texts (script 11) look for weights
    through the one function find_minilm_dir: a checkpoint in the HF cache
    is found by both and embeds alike; without one, run_core takes
    synthetic weights and embed_texts the hashed backend."""
    from vae_hmc_tpu_torch.pipelines.bench_chain import _lyrics_encoder
    monkeypatch.delenv("VAE_HMC_MINILM_DIR", raising=False)
    texts = ["the cats sat in the rain", "Hello, World!"]
    monkeypatch.setenv("HF_HOME", str(tmp_path / "no_hf_cache"))
    assert embed.find_minilm_dir() is None
    name, _ = _lyrics_encoder("minilm", texts, torch.device("cpu"))
    assert name == "minilm-torch (synthetic real-shaped weights)"
    assert embed.embed_texts(texts, allow_tfidf=False,
                             device="cpu")[1] == "hashed"

    hf = tmp_path / "hf"
    model = tconfig.TextEmbedConfig().model_name.replace("/", "--")
    snaps = hf / "hub" / f"models--{model}" / "snapshots"
    snaps.mkdir(parents=True)
    (snaps / "0123abcd").symlink_to(full_checkpoint, target_is_directory=True)
    monkeypatch.setenv("HF_HOME", str(hf))
    assert embed.find_minilm_dir() == snaps / "0123abcd"
    name, encode = _lyrics_encoder("minilm", texts, torch.device("cpu"))
    assert name == "minilm-torch (real checkpoint)"
    emb, backend = embed.embed_texts(texts, device="cpu")
    assert backend == "minilm"
    np.testing.assert_allclose(encode(texts).numpy(), emb, rtol=0, atol=1e-6)
