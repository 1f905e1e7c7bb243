"""The MoE LM lyrics encoder (``text.moe_lm``, Moonlight-16B-A3B's layout)
at a small size on the CPU: against the plain float32 reference
(``benchmark/reference/moonlight.py``) on seeded random weights, padding,
causality, RoPE's layout, the router, the counters, the bf16 path, the
safetensors loader, the ``text.embed`` backend, and the conv VAE's fit at
Moonlight's 2,048-wide embeddings.  Imports no JAX."""
import json
import struct

import numpy as np
import pytest
import torch

from benchmark.reference import moonlight as ref
from vae_hmc_tpu_torch.core.config import MoeLMConfig
from vae_hmc_tpu_torch.text import embed, moe_lm

HF = dict(vocab_size=512, hidden_size=64, num_hidden_layers=3,
          num_attention_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8,
          v_head_dim=16, kv_lora_rank=32, intermediate_size=128,
          moe_intermediate_size=32, n_routed_experts=8,
          num_experts_per_tok=2, n_shared_experts=2, first_k_dense_replace=1,
          routed_scaling_factor=2.446, rope_theta=50000, rms_norm_eps=1e-5,
          max_position_embeddings=8192, q_lora_rank=None, n_group=1,
          topk_group=1, topk_method="noaux_tc", scoring_func="sigmoid",
          norm_topk_prob=True, hidden_act="silu",
          # weights whose attention scores are of order 1 at hidden 64, as
          # N(0, 0.02) gives at the published widths: RoPE then matters
          initializer_range=0.15)
CPU = torch.device("cpu")
SEED = 2 ** 31 + 5
LENGTHS = (5, 17, 9, 33, 1, 12, 40)


def _model(dtype="float32", seed=SEED, hf=HF):
    model = moe_lm.MoeLM(MoeLMConfig.from_hf(hf, dtype))
    for part in ref.parts(hf):
        moe_lm.load_hf(model, {
            n: ref.draw(seed, n, s, k, hf["initializer_range"], CPU,
                        getattr(torch, dtype))
            for n, s, k in ref.leaves(hf, part)})
    return model.eval()


def _seqs(lengths=LENGTHS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, HF["vocab_size"], n) for n in lengths]


def _reference(seqs, dtype="float32", fault=None):
    return ref.embed(lambda p: ref.part_weights(HF, SEED, p, CPU,
                                                getattr(torch, dtype)),
                     HF, seqs, CPU, fault)


@pytest.fixture(scope="module")
def model32():
    return _model()


def _hidden(model, seqs, max_batch_tokens=64):
    """Every layer's input and the final norm's, per real token (rows in
    the forward's order), and each MoE layer's router choice."""
    got = {"h": [], "choice": []}
    hooks = [layer.register_forward_pre_hook(
        lambda m, a: got["h"].append(a[0].clone()))
        for layer in model.layers]
    hooks.append(model.norm.register_forward_pre_hook(
        lambda m, a: got["h"].append(a[0].clone())))
    hooks += [layer.mlp.gate.register_forward_hook(
        lambda m, a, o: got["choice"].append(o[0].clone()))
        for layer in model.layers[HF["first_k_dense_replace"]:]]
    try:
        emb = moe_lm.encode_ids(model, seqs, max_batch_tokens)
    finally:
        for h in hooks:
            h.remove()
    return emb, got


def _reference_choices(seqs):
    """The reference's own router choice in each MoE layer, its tokens in
    the sequences' order (``reference.layer``'s steps, one at a time)."""
    eps, k = HF["rms_norm_eps"], HF["num_experts_per_tok"]
    table = ref.part_weights(HF, SEED, "embed", CPU, torch.float32)[
        "model.embed_tokens.weight"]
    hs = [table[torch.as_tensor(s)] for s in seqs]
    out = []
    for i in range(HF["num_hidden_layers"]):
        w = ref.part_weights(HF, SEED, i, CPU, torch.float32)
        p = f"model.layers.{i}."
        hs = [h + ref.mla(w, p + "self_attn.", HF,
                          ref.rms(h, w[p + "input_layernorm.weight"], eps))
              for h in hs]
        flat = torch.cat(hs)
        x = ref.rms(flat, w[p + "post_attention_layernorm.weight"], eps)
        if i < HF["first_k_dense_replace"]:
            y = ref.swiglu(w, p + "mlp.", x)
        else:
            scores = torch.sigmoid(ref.mm(x, w[p + "mlp.gate.weight"]))
            own, _ = ref.choose(
                scores, w[p + "mlp.gate.e_score_correction_bias"], k)
            out.append(own)
            y, _ = ref.moe(w, p + "mlp.", HF, x)
        hs = list((flat + y).split([len(h) for h in hs]))
    return out


def test_float32_forward_matches_reference(model32):
    """Within 1e-5 relative (float32 rounding in another order), and the
    routing identical: each MoE layer chooses, token by token, the experts
    the reference chooses by its own scores."""
    seqs = _seqs()
    emb, got = _hidden(model32, seqs, max_batch_tokens=10 ** 4)
    want = _reference(seqs)
    assert float((emb - want).norm() / want.norm()) < 1e-5
    torch.testing.assert_close(emb, want, rtol=1e-5, atol=1e-6)
    order = moe_lm.length_batches([len(s) for s in seqs], 10 ** 4)
    assert len(order) == 1
    for mine, theirs in zip(got["choice"], _reference_choices(seqs)):
        parts = dict(zip(order[0], mine.split([len(seqs[j])
                                               for j in order[0]])))
        mine = torch.cat([parts[j] for j in range(len(seqs))])
        assert torch.equal(mine.sort(-1).values, theirs.sort(-1).values)


def test_row_alone_equals_row_in_a_padded_batch(model32):
    seqs = _seqs()
    together = moe_lm.encode_ids(model32, seqs, 10 ** 4)
    for j in (0, 3, 4):
        alone = moe_lm.encode_ids(model32, [seqs[j]], 10 ** 4)
        torch.testing.assert_close(alone[0], together[j], rtol=1e-5,
                                   atol=1e-6)
    # forwards of every size: one row each up to all rows in one
    for cap in (40, 80, 10 ** 4):
        torch.testing.assert_close(moe_lm.encode_ids(model32, seqs, cap),
                                   together, rtol=1e-5, atol=1e-6)


def test_a_later_token_leaves_earlier_states_unchanged(model32):
    """Up to float32 rounding: the experts' GEMMs run over other token
    counts when later tokens route elsewhere, so the earlier states move in
    the last bits (under 1e-5 of their size) and the later ones by the
    change itself."""
    seq = _seqs((30,))[0]
    changed = seq.copy()
    changed[20:] = (changed[20:] + 7) % HF["vocab_size"]
    _, a = _hidden(model32, [seq])
    _, b = _hidden(model32, [changed])
    for ha, hb in zip(a["h"], b["h"]):
        scale = float(ha.abs().max())
        assert float((ha[:20] - hb[:20]).abs().max()) <= 1e-5 * scale
        assert float((ha[20:] - hb[20:]).abs().max()) > 1e-2 * scale


def test_rope_is_deepseeks_view_transpose_form():
    """The port's RoPE equals DeepSeek's apply_rotary_pos_emb (the
    reference's literal form), and its q . k equals that of the plain
    interleaved rotation of the pairs (2i, 2i+1)."""
    cfg = MoeLMConfig.from_hf(HF)
    d, n = cfg.qk_rope_dim, 50
    g = torch.Generator().manual_seed(3)
    q = torch.randn(n, 2, d, generator=g)
    k = torch.randn(n, 1, d, generator=g)
    pos = torch.arange(n) * 37
    cos, sin = moe_lm.rope_tables(cfg, pos)
    mine_q, mine_k = moe_lm.rope(q, cos, sin), moe_lm.rope(k, cos, sin)
    theirs = ref.rope(q.transpose(0, 1), pos, cfg.rope_theta).transpose(0, 1)
    torch.testing.assert_close(mine_q, theirs, rtol=0, atol=0)

    def interleaved(x):
        ang = pos[:, None].float() * cfg.rope_theta ** (
            -torch.arange(0, d, 2).float() / d)
        c, s = ang.cos()[:, None], ang.sin()[:, None]
        out = x.clone()
        out[..., 0::2] = x[..., 0::2] * c - x[..., 1::2] * s
        out[..., 1::2] = x[..., 1::2] * c + x[..., 0::2] * s
        return out

    dots = torch.einsum("ihd,jhd->hij", mine_q, mine_k.expand(n, 2, d))
    want = torch.einsum("ihd,jhd->hij", interleaved(q),
                        interleaved(k).expand(n, 2, d))
    torch.testing.assert_close(dots, want, rtol=1e-4, atol=1e-4)


def test_route_chooses_by_score_plus_bias_and_weighs_by_score():
    scores = torch.tensor([[0.9, 0.8, 0.7, 0.1],
                           [0.2, 0.6, 0.5, 0.4]])
    bias = torch.tensor([0.0, -0.5, 0.0, 0.7])
    idx, w = moe_lm.route(scores, bias, 2, 2.446)
    idx, order = idx.sort(-1)
    w = w.gather(1, order)
    # s + b: [0.9, 0.3, 0.7, 0.8] and [0.2, 0.1, 0.5, 1.1]
    assert idx.tolist() == [[0, 3], [2, 3]]
    want = torch.tensor([[0.9, 0.1], [0.5, 0.4]])
    want = want / want.sum(-1, keepdim=True) * 2.446
    torch.testing.assert_close(w, want)


def test_counters_sum_to_tokens_times_top_k(model32):
    seqs = _seqs()
    counters = moe_lm.LMCounters()
    moe_lm.encode_ids(model32, seqs, 64, counters=counters)
    moe_lm.encode_ids(model32, seqs[:2], 64, counters=counters)
    tokens = sum(LENGTHS) + sum(LENGTHS[:2])
    assert counters.tokens == tokens
    moe = HF["num_hidden_layers"] - HF["first_k_dense_replace"]
    assert all(c.shape == (moe, HF["n_routed_experts"])
               for c in counters.expert_slots)
    per_layer = sum(c for c in counters.expert_slots).sum(-1)
    assert per_layer.tolist() == [tokens * HF["num_experts_per_tok"]] * moe
    batches = [[LENGTHS[i] for i in b]
               for b in moe_lm.length_batches(list(LENGTHS), 64)] + \
        [[LENGTHS[i] for i in b]
         for b in moe_lm.length_batches(list(LENGTHS[:2]), 64)]
    assert counters.forwards == len(batches)
    assert counters.slots == sum(len(b) * max(b) for b in batches)
    assert counters.padded == counters.slots - tokens


def test_length_batches_cap_and_cover():
    lengths = [5, 17, 9, 33, 1, 12, 40, 40, 3]
    batches = moe_lm.length_batches(lengths, 64)
    assert sorted(i for b in batches for i in b) == list(range(len(lengths)))
    for b in batches:
        assert len(b) * max(lengths[i] for i in b) <= 64
        assert [lengths[i] for i in b] == sorted(
            (lengths[i] for i in b), reverse=True)
    with pytest.raises(ValueError):
        moe_lm.encode_ids(_model(), [np.arange(70) % 512], 64)


def test_warm_attention_visits_every_forward_shape(model32, monkeypatch):
    """``warm_attention`` runs the fused attention at each (rows, longest
    row) shape, dtype and width that ``encode_ids`` then runs."""
    lengths = [5, 17, 9, 33, 1, 12, 40, 40, 3]
    seen = []
    attend = moe_lm.attend

    def record(cfg, q, k, v, pad_src, rows, longest):
        seen.append((rows, longest, q.dtype, q.shape[-1], v.shape[-1]))
        return attend(cfg, q, k, v, pad_src, rows, longest)

    monkeypatch.setattr(moe_lm, "attend", record)
    moe_lm.warm_attention(model32, lengths, 64)
    warmed = set(seen)
    seen.clear()
    moe_lm.encode_ids(model32, _seqs(lengths), 64)
    assert set(seen) == warmed
    assert {w[:2] for w in warmed} == {
        (len(b), max(lengths[i] for i in b))
        for b in moe_lm.length_batches(lengths, 64)}


def test_bf16_path_within_its_bound_of_the_reference():
    """bf16 weights and GEMM inputs (unit roundoff u = 2^-8) against the
    float32 reference on the same bf16-drawn weights.  A token's path
    rounds about 30 GEMM inputs; independent errors add to about
    sqrt(30) u = 0.02 of a row's norm, and a router choice that flips at a
    near-tie moves its token further, so a unit row may move up to 0.05
    (2.5x that).  The float32 path reads under 1e-5 on the same inputs, so
    the bf16 path is what is measured."""
    seqs = _seqs()
    got = moe_lm.encode_ids(_model("bfloat16"), seqs, 64)
    want = _reference(seqs, "bfloat16")
    gap = (got - want).norm(dim=-1).max()
    assert 1e-4 < gap < 0.05, float(gap)
    f8 = _reference(seqs, "bfloat16", "fp8")
    assert (f8 - want).norm(dim=-1).max() > 0.05


def _write_safetensors(path, tensors):
    header, blobs, at = {}, [], 0
    names = {torch.bfloat16: "BF16", torch.float32: "F32"}
    for name, t in tensors.items():
        raw = t.contiguous().view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [at, at + len(raw)]}
        blobs.append(raw)
        at += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


def test_hf_to_state_dict_round_trips_a_safetensors_file(tmp_path):
    hf = {n: ref.draw(SEED, n, s, k, 0.02, CPU, torch.bfloat16)
          for part in ref.parts(HF) for n, s, k in ref.leaves(HF, part)}
    hf["lm_head.weight"] = torch.zeros(HF["vocab_size"], HF["hidden_size"],
                                       dtype=torch.bfloat16)
    names = sorted(hf)
    half = len(names) // 2
    _write_safetensors(tmp_path / "model-00001-of-00002.safetensors",
                       {n: hf[n] for n in names[:half]})
    _write_safetensors(tmp_path / "model-00002-of-00002.safetensors",
                       {n: hf[n] for n in names[half:]})
    (tmp_path / "config.json").write_text(json.dumps(HF))
    model = moe_lm.load_moe_lm(tmp_path, "bfloat16", device="cpu")
    params = dict(model.named_parameters())
    mapped = moe_lm.hf_to_state_dict(hf, model.cfg)
    assert set(mapped) == set(params)
    for k, v in mapped.items():
        assert torch.equal(params[k], v.to(params[k].dtype)), k
    e = 3
    p = "layers.1.mlp.experts."
    w = HF["moe_intermediate_size"]
    assert torch.equal(params[p + "gate_up"][e, :w],
                       hf[f"model.layers.1.mlp.experts.{e}.gate_proj.weight"])
    assert torch.equal(params[p + "gate_up"][e, w:],
                       hf[f"model.layers.1.mlp.experts.{e}.up_proj.weight"])
    assert torch.equal(params[p + "down"][e],
                       hf[f"model.layers.1.mlp.experts.{e}.down_proj.weight"])
    del hf["model.layers.2.mlp.experts.7.up_proj.weight"]
    with pytest.raises(KeyError):
        moe_lm.hf_to_state_dict(hf, model.cfg)


def test_embed_backend_takes_ids_and_names_the_tokenizer(model32):
    seqs = _seqs()
    texts = [f"lyric {i}" for i in range(len(seqs))]
    with pytest.raises(FileNotFoundError, match="tiktoken.model"):
        embed.embed_texts(texts, lm=model32)
    emb, backend = embed.embed_texts(texts, lm=model32, lm_ids=seqs)
    assert backend == "moe_lm" and emb.shape == (len(seqs), 64)
    np.testing.assert_allclose(
        emb, moe_lm.encode_ids(model32, seqs).numpy(), rtol=1e-5, atol=1e-6)


def test_conv_fit_takes_2048_wide_lyrics():
    from vae_hmc_tpu_torch.core.config import ConvMMVaeConfig
    from vae_hmc_tpu_torch.models.api import train_conv_mm_vae

    n, mels, frames = 10, 16, 24
    g = torch.Generator().manual_seed(1)
    x = torch.randn(n, mels, frames, 1, generator=g)
    lyr = torch.nn.functional.normalize(torch.randn(n, 2048, generator=g),
                                        dim=-1)
    has = np.array([1, 0] * 5, np.float32)
    cfg = ConvMMVaeConfig(in_mels=mels, in_frames=frames, lyrics_dim=2048,
                          audio_channels=(4, 8), audio_fc_dim=16,
                          epochs=1, batch_size=4)
    model, history, mu = train_conv_mm_vae(x, lyr * torch.as_tensor(
        has)[:, None], has, cfg, device="cpu")
    assert model.lyr1.in_features == 2048
    assert mu.shape == (n, cfg.latent_dim) and torch.isfinite(mu).all()
    assert len(history) == 1
