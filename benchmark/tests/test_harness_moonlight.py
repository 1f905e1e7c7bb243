"""The Moonlight cell at a tiny size on the CPU: a run through
``harness.run_cell`` reads ``correct`` true; each control planted in the
program (GEMM inputs in float8 e4m3, RoPE left out, the selection bias in
the combine weights, the routed scale dropped, the shared experts dropped)
reads ``correct`` false, and so does each of the conv job's faults of the
fit and the clustering (``test_harness_faults``); a traced run reads every
new metric.  On the card (``cuda``), the control at the published widths
fails a limit in each case."""
import copy
import json
import time

import pytest
import torch
import torch.nn.functional as F

from benchmark import harness, program_spans, spec
from benchmark.tests import test_harness_faults, tiny

CELL = "moonlight_mm_vae.lyrics_job"
TINY_LM = dict(vocab_size=512, hidden_size=64, num_hidden_layers=3,
               num_attention_heads=4, num_key_value_heads=4,
               qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
               kv_lora_rank=32, intermediate_size=128,
               moe_intermediate_size=32, n_routed_experts=8,
               num_experts_per_tok=2, n_shared_experts=2,
               # at hidden 64, N(0, 0.02) weights make scores ~0.02 and
               # attention uniform, so RoPE would not matter: weights of
               # the published model's score scale (about 1) instead
               initializer_range=0.15)


def tiny_cell() -> spec.Cell:
    cfg = json.loads((tiny.ROOT / "benchmark/configs/moonlight_mm_vae.json")
                     .read_text())
    conv = tiny.conv_config()
    # the published k-means (10 restarts): conv's tiny cell takes 2
    cfg.update(TINY_LM, n_tracks=conv["n_tracks"], mel=conv["mel"])
    # the encoder in float32: at this size bf16's routing flips move the
    # pooled rows by up to 0.2 (lm_emb), far past what they move at the
    # published widths; bf16 at a tiny size is tests/test_torch_moe_lm.py's
    cfg["torch_dtype"] = "float32"
    cfg["vae"] = dict(conv["vae"], lyrics_dim=TINY_LM["hidden_size"])
    wl = json.loads((tiny.ROOT / f"benchmark/workloads/{CELL}.json")
                    .read_text())
    wl = copy.deepcopy(wl)
    wl["traffic"].update(device_batch=8, max_batch_tokens=96,
                         length_median=16, length_min=4, length_max=40,
                         check_tracks=8, check_longest=2)
    manifest = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    return spec.Cell(
        name=CELL, chips=1, config=cfg, workload=wl,
        end_to_end=[m for m in manifest["end_to_end"]
                    if spec._reports(m, CELL)],
        per_layer=[m for m in manifest["per_layer"]
                   if spec._reports(m, CELL)])


def _run(trace=False):
    # conv's fault tests' seed: at this size the clustering numbers' limits,
    # set at the published size, fail some seeds' sound runs (dbi's float32
    # gap, k-means restarts; PERF.md section 7)
    return harness.run_cell(tiny_cell(), 21, 0.2, trace,
                            torch.device("cpu"), time.perf_counter())


def _fp8(monkeypatch):
    from vae_hmc_tpu_torch.text import moe_lm

    def q8(t):
        s = t.abs().max().clamp(min=1e-30) / 448.0
        return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s

    monkeypatch.setattr(moe_lm, "linear", lambda x, w: F.linear(
        q8(x.to(w.dtype)), q8(w)))


def _no_rope(monkeypatch):
    from vae_hmc_tpu_torch.text import moe_lm

    monkeypatch.setattr(moe_lm, "rope", lambda x, cos, sin: x.float())


def _route(monkeypatch, bias_in_combine=False, scaled=True):
    from vae_hmc_tpu_torch.text import moe_lm

    def route(scores, bias, top_k, scale):
        idx = torch.topk(scores + bias, top_k, dim=-1, sorted=False).indices
        w = (scores + bias if bias_in_combine else scores).gather(1, idx)
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return idx, w * scale if scaled else w

    monkeypatch.setattr(moe_lm, "route", route)


def _no_shared(monkeypatch):
    from vae_hmc_tpu_torch.text import moe_lm

    forward = moe_lm.MLP.forward

    def none_if_shared(self, x, pk=None):
        y = forward(self, x, pk)
        return torch.zeros_like(y) if self.down_proj.weight.shape[1] == \
            TINY_LM["moe_intermediate_size"] * TINY_LM["n_shared_experts"] \
            else y

    monkeypatch.setattr(moe_lm.MLP, "forward", none_if_shared)


CONTROLS = {"fp8": _fp8, "no_rope": _no_rope,
            "bias_in_combine": lambda mp: _route(mp, bias_in_combine=True),
            "no_scale": lambda mp: _route(mp, scaled=False),
            "no_shared": _no_shared}


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"] is True, res["checks"]
    assert {"lm_emb", "lm_layer", "lm_route", "grad0", "export"} <= set(
        res["checks"])


def test_choice_capture_lines_up_with_the_reference():
    """The sample rows' router choices that ``ChoiceCapture`` takes from
    the program's forwards, put in the sample's order, are the float32
    reference's own choices token for token, in every MoE layer."""
    from benchmark.jobs import moonlight_job
    from benchmark.reference import moonlight as ref_lm
    from vae_hmc_tpu_torch.core.config import MoeLMConfig
    from vae_hmc_tpu_torch.text import moe_lm

    cfg, cpu, seed = tiny_cell().config, torch.device("cpu"), 21
    model = moe_lm.MoeLM(MoeLMConfig.from_hf(cfg, "float32")).eval()
    moonlight_job.lm_weights(model, cfg, seed, cpu)
    gen = torch.Generator().manual_seed(3)
    lengths = torch.randint(1, 30, (12,), generator=gen).tolist()
    ids = [torch.randint(0, cfg["vocab_size"], (n,), generator=gen).numpy()
           for n in lengths]
    sample = [1, 4, 5, 9, 11]
    cap = moonlight_job.ChoiceCapture(lengths, 64, sample, cpu).open(model)
    moe_lm.encode_ids(model, ids, 64)
    follow = cap.close()
    own = {}
    ref_lm.embed(lambda p: ref_lm.part_weights(cfg, seed, p, cpu,
                                               torch.float32),
                 cfg, [ids[j] for j in sample], cpu, record=own)
    assert sorted(follow) == sorted(own) == list(
        range(1, cfg["num_hidden_layers"]))
    for i, mine in follow.items():
        assert torch.equal(mine.long().sort(-1).values,
                           own[i].sort(-1).values), i


@pytest.mark.parametrize("control", sorted(CONTROLS))
def test_control_is_not_correct(control, monkeypatch):
    CONTROLS[control](monkeypatch)
    res = _run()
    assert res["correct"] is False, (control, res["checks"])


@pytest.mark.parametrize("fault", sorted(test_harness_faults.FAULTS["conv"]))
def test_fit_and_cluster_fault_is_not_correct(fault, monkeypatch):
    plant, number = test_harness_faults.FAULTS["conv"][fault]
    plant(monkeypatch)
    res = _run()
    assert res["correct"] is False
    c = res["checks"][number]
    assert c["value"] > c["limit"], (fault, c)


def test_traced_run_reads_the_new_metrics(monkeypatch):
    """On the CPU no range has a device copy: the program's host ranges
    stand in for their copies, so the span readers have times to read."""
    from_profiler = program_spans.from_profiler

    def host_as_device(prof):
        prog = from_profiler(prof)
        prog.device = list(prog.host)
        return prog

    monkeypatch.setattr(program_spans, "from_profiler", host_as_device)
    res = _run(trace=True)
    new = {"lm_mfu", "experts_roofline", "moe_route_share", "pad_share",
           "mfu_mixed"}
    assert new <= set(res["metrics"]), sorted(res["metrics"])
    for name in new:
        assert 0 < res["metrics"][name]["value"] < 100, name
    # conv's readers of the shared stages and the fit's spans (the kernels'
    # rooflines read device kernels, which the CPU has not)
    shared = {"features_s", "cluster_s", "adam_ms", "step_ms_p99",
              "fit_idle_s"}
    assert shared <= set(res["metrics"]), sorted(res["metrics"])
    for name in shared:
        assert res["metrics"][name]["value"] >= 0, name


@pytest.mark.cuda
def test_controls_fail_a_limit_on_the_card():
    """At the published widths: the program's readings pass every limit of
    the cell's encoder numbers, and each control of
    ``reference/moonlight.FAULTS`` and the fit's reference in TF32 fails at
    least one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark.jobs import moonlight_job
    from benchmark.reference import moonlight as ref_lm

    cfg = json.loads((tiny.ROOT / "benchmark/configs/moonlight_mm_vae.json")
                     .read_text())
    limits = json.loads((tiny.ROOT / f"benchmark/workloads/{CELL}.json")
                        .read_text())["limits"]
    readings = moonlight_job.control_readings(cfg, 2 ** 31 + 3,
                                              torch.device("cuda", 0))
    assert all(v <= limits[k] for k, v in readings["sound"].items()), \
        readings["sound"]
    for fault in ref_lm.FAULTS + ("fit_tf32",):
        assert any(v > limits[k] for k, v in readings[fault].items()), \
            (fault, readings[fault])
