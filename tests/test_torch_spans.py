"""The port's own trace ranges (``core/profiling``): the ``vae:`` spans at
the layer boundaries of the conv job's path, the ``vae:stage.*`` spans of
``run_core``'s stages and the ``vae:sync.*`` ranges around each wait on
the device, read from a CPU profiler trace of tiny runs; and the off path,
which builds no range when no profiler runs."""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vae_hmc_tpu_torch.cluster import kmeans as kmeans_mod
from vae_hmc_tpu_torch.core import profiling
from vae_hmc_tpu_torch.core.config import KMeansConfig, MelConfig
from vae_hmc_tpu_torch.metrics import internal
from vae_hmc_tpu_torch.models.dense_vae import DenseVAE
from vae_hmc_tpu_torch.models.train import fit
from vae_hmc_tpu_torch.ops import mel
from vae_hmc_tpu_torch.ops.kernels.logmel import logmel_standardized
from vae_hmc_tpu_torch.pipelines import bench_chain
from vae_hmc_tpu_torch.text import minilm

P = profiling.SPAN_PREFIX
N, BATCH = 10, 4                      # three steps an epoch, the last of 2


def _ranges(run):
    """-> {name: [(start, end)]} of the program's ranges run traces."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    ranges = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(P):
            ranges.setdefault(ev.name().removeprefix(P), []).append(
                (ev.start_ns(), ev.end_ns()))
    return ranges, out


def _fit(epochs, **kw):
    torch.manual_seed(0)
    model = DenseVAE(6, (8,), 2)
    x = torch.randn(N, 6, generator=torch.Generator().manual_seed(1))
    return fit(model, (x,), epochs=epochs, batch_size=BATCH,
               learning_rate=1e-3, **kw)


def _inside(inner, outer):
    return all(any(s <= a and b <= e for s, e in outer) for a, b in inner)


@pytest.mark.parametrize("epochs", [1, 3])
def test_fit_spans(epochs):
    ranges, res = _ranges(lambda: _fit(epochs))
    steps = epochs * math.ceil(N / BATCH)
    assert len(res.history) == epochs
    assert len(ranges["fit"]) == 1
    assert len(ranges["fit.epoch"]) == epochs
    assert len(ranges["fit.step"]) == steps
    assert len(ranges["fit.update"]) == steps
    assert _inside(ranges["fit.update"], ranges["fit.step"])
    assert _inside(ranges["fit.step"] + ranges["fit.epoch"], ranges["fit"])
    assert len(ranges["sync.fit.history"]) == epochs
    # the epoch's row indices: two copies to the device, in its set-up
    assert len(ranges["sync.fit.rows"]) == 2 * epochs
    assert _inside(ranges["sync.fit.rows"], ranges["fit.epoch"])


def test_resumed_fit_counts_only_its_epochs(tmp_path):
    _fit(2, checkpoint_dir=str(tmp_path), checkpoint_every=1)
    ranges, res = _ranges(lambda: _fit(4, checkpoint_dir=str(tmp_path),
                                       checkpoint_every=1))
    assert [r["epoch"] for r in res.history] == [1, 2, 3, 4]
    assert len(ranges["fit.epoch"]) == 2
    assert len(ranges["fit.step"]) == 2 * math.ceil(N / BATCH)
    assert len(ranges["sync.fit.history"]) == 2


def _points(n=60, seed=3):
    g = np.random.default_rng(seed)
    centres = g.normal(size=(3, 4)) * 5.0
    return (centres[np.arange(n) % 3] + g.normal(size=(n, 4))).astype(
        np.float32)


@pytest.mark.parametrize("max_iter", [1, 2, 300])
def test_lloyd_waits_once_an_iteration(max_iter):
    x = torch.as_tensor(_points())
    gen = torch.Generator().manual_seed(5)
    centres = kmeans_mod._kmeanspp_init(x, 3, 4, gen)
    ranges, (_, _, _, n_iter) = _ranges(lambda: kmeans_mod._lloyd(
        x, centres, max_iter, kmeans_mod.tol_scaled(x, 1e-4)))
    # the loop runs until its slowest restart stops
    assert len(ranges["sync.kmeans.done"]) == int(n_iter.max())
    assert int(n_iter.max()) <= max_iter


def test_kmeans_spans():
    cfg = KMeansConfig(n_clusters=3, n_init=4, seed=5)
    ranges, res = _ranges(lambda: kmeans_mod.kmeans(_points(), cfg,
                                                    device="cpu"))
    for name in ("kmeans", "kmeans.init", "kmeans.lloyd",
                 "sync.kmeans.input"):
        assert len(ranges[name]) == 1, name
    assert len(ranges["sync.kmeans.done"]) >= res.n_iter
    assert len(ranges["sync.kmeans.result"]) == 4
    assert _inside(ranges["kmeans.init"] + ranges["kmeans.lloyd"]
                   + ranges["sync.kmeans.result"], ranges["kmeans"])
    # a tensor on the host marks the site too (on a card, its copy waits)
    ranges, _ = _ranges(lambda: kmeans_mod.kmeans(
        torch.as_tensor(_points()), cfg, device="cpu"))
    assert len(ranges["sync.kmeans.input"]) == 1


def test_as_tensor_opens_no_range_for_a_tensor_off_the_host():
    """A tensor already off the host is not copied from it: no sync range
    (a ``meta`` tensor stands in for one on the card)."""
    on_card = torch.empty(3, device="meta")
    ranges, out = _ranges(lambda: profiling.as_tensor(
        on_card, torch.device("meta"), "probe"))
    assert out.device.type == "meta"
    assert "sync.probe" not in ranges
    ranges, _ = _ranges(lambda: profiling.as_tensor(
        np.zeros(3), torch.device("meta"), "probe"))
    assert len(ranges["sync.probe"]) == 1


def test_metric_spans():
    x = _points()
    labels = np.arange(len(x)) % 3
    ranges, _ = _ranges(lambda: (internal.silhouette(x, labels, "cpu"),
                                 internal.davies_bouldin(x, labels, "cpu")))
    for name in ("metrics.silhouette", "metrics.davies_bouldin",
                 "sync.metrics.silhouette", "sync.metrics.davies_bouldin"):
        assert len(ranges[name]) == 1, name
    assert len(ranges["sync.metrics.labels"]) == 2
    assert len(ranges["sync.metrics.input"]) == 2


def test_run_core_times_each_stage_in_one_span(monkeypatch):
    """``run_core``'s four stages are one StageTimer's: a ``stage.<name>``
    span each, in order, and the result's seconds are the timer's."""
    timers = []

    class Kept(profiling.StageTimer):
        def __init__(self, device=None):
            super().__init__(device)
            timers.append(self)

    monkeypatch.setattr(bench_chain, "StageTimer", Kept)
    ranges, res = _ranges(lambda: bench_chain.run_core(
        n_tracks=16, epochs=1, device="cpu", duration_s=0.5,
        device_batch=8, lyrics_backend="hashed"))
    names = ["features", "lyrics", "train", "cluster_metrics"]
    assert sorted(k for k in ranges if k.startswith("stage.")) == sorted(
        "stage." + n for n in names)
    spans = [ranges["stage." + n] for n in names]
    assert all(len(s) == 1 for s in spans)
    assert all(a[0][1] <= b[0][0] for a, b in zip(spans, spans[1:]))
    assert _inside(ranges["sync.mel.table"], ranges["stage.features"])
    (timer,) = timers
    assert list(timer.stages) == names
    for n in names:
        assert res["seconds_" + n] == timer.stages[n]
    assert res["seconds_total"] == sum(timer.stages.values())


def test_mel_table_copies_each_of_its_three_tensors_in_a_sync_range():
    """A table is built with three copies to the device, each waited on in
    its own ``sync.mel.table`` range, on every call (nothing cached on the
    device), from a config or from a dense bank; one kernel 1 call on a
    batch builds one table."""
    cfg = MelConfig(n_mels=16, duration_s=0.5)
    for build in (lambda: mel.mel_table(cfg, "cpu"),
                  lambda: mel.MelTable.from_bank(
                      mel.mel_filterbank(cfg.sample_rate, cfg.n_fft, 16),
                      "cpu"),
                  lambda: logmel_standardized(torch.zeros(2, cfg.n_samples),
                                              cfg)):
        ranges, _ = _ranges(build)
        assert len(ranges["sync.mel.table"]) == 3


def _tiny_minilm(texts):
    cfg = minilm.MiniLMConfig(hidden=16, layers=1, heads=2, intermediate=32,
                              max_pos=64)
    return minilm.synthetic_minilm(texts, seed=7, cfg=cfg, device="cpu")


def test_minilm_spans():
    texts = [f"word{i % 5} other{i % 3} line" for i in range(10)]
    model, tok = _tiny_minilm(texts)
    ranges, emb = _ranges(lambda: minilm.encode_texts(model, tok, texts,
                                                      batch_size=4))
    assert emb.shape == (10, 16)
    batches = 3
    assert len(ranges["minilm.encode"]) == 1
    for name in ("minilm.tokenize", "sync.minilm.ids", "sync.minilm.mask"):
        assert len(ranges[name]) == batches, name
    assert len(ranges["sync.minilm.result"]) == 1


def _event(name, device, start, end):
    return SimpleNamespace(
        name=name, device_type=device,
        time_range=SimpleNamespace(start=start, end=end,
                                   elapsed_us=lambda: end - start))


def test_profile_chain_counts_no_range_copy_as_device_work():
    """``tools/profile_chain``'s device activity leaves out the copies the
    profiler draws on the device timeline of host ranges: a step's
    ``vae:fit.step`` copy spans its idle bubble, and counting it would make
    the bubble busy."""
    from torch.autograd import DeviceType

    from vae_hmc_tpu_torch.tools import profile_chain

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [_event(P + "stage.train", cpu, 0, 100),
              _event(P + "fit.step", cpu, 5, 60),
              _event("Optimizer.step#Adam.step", cpu, 40, 50),
              _event("aten::mm", cpu, 10, 20),
              _event(P + "stage.train", cuda, 10, 90),
              _event(P + "fit.step", cuda, 10, 80),
              _event("Optimizer.step#Adam.step", cuda, 60, 80),
              _event("Command Buffer Full", cuda, 20, 25),
              _event("gemm_kernel", cuda, 10, 30),
              _event("adam_kernel", cuda, 60, 80)]
    dev = profile_chain._device_events(events)
    assert [e.name for e in dev] == ["gemm_kernel", "adam_kernel"]
    busy = profile_chain._union_us(sorted(
        (e.time_range.start, e.time_range.end) for e in dev))
    assert busy == 40                   # the bubble 30-60 stays idle

    avg = [SimpleNamespace(key=k, self_cpu_time_total=t) for k, t in
           ((P + "stage.train", 5.0), (P + "fit.step", 9.0), ("aten::mm", 3.0),
            ("aten::add", 7.0), ("gemm_kernel", 0.0))]
    assert [e.key for e in profile_chain._host_ops(avg)] == [
        "aten::add", "aten::mm"]


def test_profile_chain_sums_the_device_copies_of_each_range():
    from torch.autograd import DeviceType

    from vae_hmc_tpu_torch.tools import profile_chain

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [_event(P + "model.deconv", cpu, 0, 10),
              _event(P + "model.deconv", cuda, 5, 25),
              _event(P + "model.deconv", cuda, 40, 46),
              _event(P + "fit.step", cuda, 0, 50),
              _event("Optimizer.step#Adam.step", cuda, 60, 80),
              _event("conv_kernel", cuda, 5, 25)]
    assert profile_chain._range_copies(events) == {
        P + "model.deconv": (26, 2), P + "fit.step": (50, 1)}


@pytest.mark.parametrize("on", [False, True])
def test_decoder_opens_model_deconv_on_the_phase_form_only(monkeypatch, on):
    """``vae:model.deconv`` is the range of a phase-form deconv forward: a
    ConvMMVAE forward opens one a deconv where the rule takes the phase
    form (switched on here for the CPU), none on the transposed path."""
    from vae_hmc_tpu_torch.models import conv_mm_vae as cmv

    if on:
        monkeypatch.setattr(cmv, "phase_deconv_engages",
                            lambda h, deconv: True)
    torch.manual_seed(0)
    model = cmv.ConvMMVAE(n_mels=16, n_frames=20, channels=(4, 8, 8),
                          fc_dim=8, latent_dim=2, lyrics_dim=6,
                          lyrics_proj_dim=4)
    x, lyr, m = torch.randn(2, 16, 20, 1), torch.randn(2, 6), torch.ones(2, 1)
    ranges, out = _ranges(lambda: model(x, lyr, m, eps=torch.zeros(2, 2)))
    assert out[0].shape == (2, 16, 20, 1)
    assert len(ranges.get("model.deconv", [])) == (3 if on else 0)


def test_off_path_builds_no_range(monkeypatch):
    """With no profiler running, spans are null contexts: the port's
    ``record_function`` is never called."""
    def refuse(name):
        raise AssertionError(f"range {name!r} built with no profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    res = _fit(2)
    assert len(res.history) == 2
    km = kmeans_mod.kmeans(_points(), KMeansConfig(n_clusters=3, n_init=2),
                           device="cpu")
    assert km.labels.shape == (60,)
    texts = ["a b c", "b c d", "c d e"]
    model, tok = _tiny_minilm(texts)
    assert minilm.encode_texts(model, tok, texts).shape == (3, 16)
    # under a profiler the same call builds the range
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="no profiler"):
            with profiling.span("probe"):
                pass
