"""The program's spans in the trace: ``program_spans`` reads them and
their device copies from the harness's profiler, the accepted readers read
what they read without them, the five readers that take them, and (on
the card) that every wait on the device falls in one ``sync.*`` span."""
import time
import traceback
import warnings
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import harness, program_spans, spec, trace
from benchmark.tests import tiny

ACCEPTED = ("features_s", "lyrics_s", "train_s", "cluster_s", "mfu",
            "logmel_roofline", "distance_roofline", "idle_share",
            "peak_mem_gib")
NEW = ("step_ms", "step_ms_p99", "adam_ms", "fit_idle_s", "host_syncs")


class Ev:
    """A profiler event as ``trace.from_profiler`` and
    ``program_spans.from_profiler`` read it."""

    def __init__(self, name, s, e, cuda=False, user=False, cid=0):
        self._v = (name, s, e, cuda, user, cid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def is_user_annotation(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


def _user(name, s, e, cid, drawn=None):
    """A host range and, where `drawn` = (s, e), its copy on the device."""
    out = [Ev(name, s, e, user=True, cid=cid)]
    if drawn:
        out.append(Ev(name, *drawn, cuda=True, user=True, cid=cid))
    return out


def _base_events():
    """A window of one job: four stages, kernel 1 twice, kernel 2 once,
    other kernels, and the optimizer's own range with its device copy."""
    ev = _user("bench:window", 0, 1000, 1)
    for cid, (name, s, e) in enumerate([("features", 0, 100),
                                         ("lyrics", 100, 200),
                                         ("train", 200, 900),
                                         ("cluster", 900, 1000)], 2):
        ev += _user("bench:" + name, s, e, cid)
    ev += [Ev("mel_db_cluster", 10, 40, cuda=True),
           Ev("mel_db_cluster", 50, 80, cuda=True),
           Ev("gemm", 120, 190, cuda=True),
           Ev("conv", 210, 600, cuda=True),
           Ev("multi_tensor_apply", 610, 640, cuda=True),
           Ev("conv", 650, 880, cuda=True),
           Ev("pairwise_tile", 910, 950, cuda=True),
           Ev("aten::mm", 120, 130)]
    ev += _user("Optimizer.step#Adam.step", 605, 612, 40, drawn=(610, 640))
    return ev


def _program_events():
    """The program's ranges of the same window: one fit of two steps,
    each update holding the optimizer's range (its device copy is drawn
    under the optimizer's name, as the profiler draws the innermost
    range's), a tokenization, two syncs."""
    ev = _user("vae:minilm.tokenize", 105, 118, 50)
    ev += _user("vae:fit", 205, 890, 51)
    ev += _user("vae:fit.epoch", 205, 208, 52)
    ev += _user("vae:sync.fit.rows", 206, 207, 53)
    ev += _user("vae:fit.step", 208, 612, 54, drawn=(210, 215))
    ev += _user("vae:fit.update", 604, 612, 55)
    ev += _user("vae:fit.step", 613, 700, 56, drawn=(650, 660))
    ev += _user("vae:fit.update", 690, 699, 57)
    ev += _user("Optimizer.step#Adam.step", 691, 698, 58, drawn=(870, 880))
    ev += _user("vae:sync.fit.history", 700, 885, 59)
    ev += _user("stage:probe", 901, 902, 60)
    return ev


def _jobs():
    bound = {"ops": 1.0, "bytes": 4.0}
    return [{"tracks": 10, "flops": 1e9, "seconds": 1.0,
             "stages": {"features": 0.1, "lyrics": 0.1, "train": 0.7,
                        "cluster": 0.1},
             "launches": {"logmel": [bound, bound], "distance": [bound]}}]


def _run(tr, jobs=None):
    return harness.Run(cell="conv_mm_vae.f32_job", dtype="float32",
                       jobs=jobs or _jobs(), window_s=tr.window_s,
                       peak_bytes=2 ** 30, trace=tr)


def _read(name, run):
    return spec.metric_reader(name)(run)


def test_prefix_is_the_programs():
    from vae_hmc_tpu_torch.core import profiling

    assert program_spans.PREFIX == profiling.SPAN_PREFIX


def _with_program(events):
    """A run of the trace of `events`, carrying the program's ranges read
    from the same events."""
    run = _run(trace.from_profiler(_prof(events)))
    run.program = program_spans.from_profiler(_prof(events))
    return run


def test_accepted_readers_unchanged_by_program_spans():
    plain = _with_program(_base_events())
    traced = _with_program(_base_events() + _program_events())
    assert plain.program.host == plain.program.device == []
    assert traced.trace.device == plain.trace.device
    assert traced.trace.spans == plain.trace.spans
    assert traced.trace.busy_s() == plain.trace.busy_s()
    assert traced.trace.top_ops() == plain.trace.top_ops()
    assert traced.trace.idle_gaps() == plain.trace.idle_gaps()
    for name in ACCEPTED:
        assert _read(name, traced) == _read(name, plain), name
    # the parent's trace has no program span: the new readers find nothing
    for name in NEW:
        assert _read(name, plain) is None, name


def test_device_copies_span_nested_ranges():
    prog = program_spans.from_profiler(
        _prof(_base_events() + _program_events()))
    assert prog.window == (0, 1000)
    copies = {}
    for s, e, name in prog.device:
        copies.setdefault(name, []).append((s, e))
    # an update's copy is the optimizer range's inside it; a step's spans
    # its own and its update's
    assert copies["fit.update"] == [(610, 640), (870, 880)]
    assert copies["fit.step"] == [(210, 640), (650, 880)]
    assert copies["fit"] == [(210, 880)]
    assert "sync.fit.rows" not in copies          # launched nothing
    # the tier runners' stage ranges are not the program's spans
    assert "stage:probe" not in {n for _, _, n in prog.host}


def _hand_run(update_ends, n_steps, fits=((0, 500), (500, 1000)),
              jobs=None):
    """Two fits; steps spread evenly over them; one update copy ending at
    each of `update_ends`, 2 units long; syncs and busy device time."""
    host, drawn = [], []
    per = n_steps // len(fits)
    for f0, f1 in fits:
        host.append((f0, f1, "fit"))
        width = (f1 - f0) // per
        for k in range(per):
            host.append((f0 + k * width, f0 + (k + 1) * width - 1,
                         "fit.step"))
    for e in update_ends:
        drawn.append((e - 2, e, "fit.update"))
    host += [(10, 11, "sync.fit.history"), (600, 601, "sync.kmeans.done"),
             (700, 702, "sync.kmeans.done")]
    device = [(0, 100, "k"), (150, 500, "k"), (520, 1000, "k")]
    run = _run(trace.Trace(window=(0, 1000), device=device,
                           spans=[(0, 1000, "window")]), jobs=jobs)
    run.program = program_spans.Program(window=(0, 1000), host=host,
                                        device=drawn)
    return run


def test_step_readers_exact():
    ends = [10, 30, 60, 100, 510, 520, 540, 600]      # two fits of four
    run = _hand_run(ends, 8, jobs=_jobs() * 2)
    # steps of 20, 30, 40 and 10, 20, 60 ns (each fit's first left out):
    # median 25 ns; 99th percentile 40 + 0.95 x 20 = 59 ns
    assert _read("step_ms", run) == pytest.approx(25e-6)
    assert _read("step_ms_p99", run) == pytest.approx(59e-6)
    assert _read("adam_ms", run) == pytest.approx(2e-6)
    # idle while a fit is open: 100-150 and 500-520, over two jobs
    assert _read("fit_idle_s", run) == pytest.approx(70e-9 / 2)
    assert _read("host_syncs", run) == 1.5


@pytest.mark.parametrize("ends", [[10, 30, 60], [10, 30, 60, 100, 510, 520,
                                                 540, 600, 700]])
def test_step_readers_none_when_counts_differ(ends):
    run = _hand_run(ends, 8)
    assert _read("step_ms", run) is None
    assert _read("step_ms_p99", run) is None
    assert _read("adam_ms", run) is not None           # the copies' own


def test_readers_find_the_profiler_of_the_run():
    """Outside the harness: a run's program ranges are those of the
    profiler in a calling frame whose window is the run's, and no other's."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.SPAN_PREFIX + trace.WINDOW):
            for site in ("a", "b", "b"):
                with record_function(f"{program_spans.PREFIX}sync.{site}"):
                    pass
    tr = trace.from_profiler(prof)
    assert _read("host_syncs", _run(tr)) == 3.0
    other = trace.Trace(window=(tr.window[0], tr.window[1] + 1),
                        spans=[(*tr.window, trace.WINDOW)])
    assert _read("host_syncs", _run(other)) is None
    assert _read("step_ms", _run(tr)) is None       # no step, no copy


def test_readers_read_a_traced_harness_run():
    """The tiny cell's traced run on the CPU: the readers find the
    harness's profiler; the host's waits are counted, and the step
    readers read nothing without the device's copies."""
    cell = tiny.conv_cell()
    res = harness.run_cell(cell, 11, 0.2, True, torch.device("cpu"),
                           time.perf_counter())
    metrics = res["metrics"]
    assert metrics["host_syncs"]["value"] > 0
    assert metrics["fit_idle_s"]["value"] > 0
    assert not {"step_ms", "step_ms_p99", "adam_ms"} & set(metrics)


@pytest.mark.cuda
def test_every_device_wait_is_one_sync_span():
    """The conv job's path at a tiny size on the card, under torch's sync
    debug mode and the profiler: each synchronizing call torch reports
    (a fetch, a Python number, a pageable copy to the device) falls in a
    ``sync.*`` span of its own, and every such span holds one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark import corpus as corpus_mod
    from benchmark.jobs import conv_job
    from vae_hmc_tpu_torch.cluster.kmeans import kmeans
    from vae_hmc_tpu_torch.metrics import internal
    from vae_hmc_tpu_torch.models.api import train_conv_mm_vae
    from vae_hmc_tpu_torch.pipelines.features import build_logmel
    from vae_hmc_tpu_torch.text import minilm

    dev = torch.device("cuda", 0)
    cell = tiny.conv_cell()
    job = conv_job.Job(cell.config, cell.workload, 3, dev)
    inp = job.inp

    def path():
        x, _, _ = build_logmel(corpus_mod.BenchSource(inp.corpus),
                               job.mel_cfg, device_batch=8, device=dev)
        lyr = minilm.encode_texts(job.text_model, job.tok, inp.texts,
                                  batch_size=8, to_host=False)
        # the model on the card, as the job gives it
        job.model.load_state_dict(inp.w0)
        _, _, mu = train_conv_mm_vae(x[..., None], lyr, inp.has,
                                     job.vae_cfg, device=dev,
                                     model=job.model)
        km = kmeans(mu, job.km_cfg, device=dev)
        internal.silhouette(mu, km.labels, device=dev)
        internal.davies_bouldin(mu, km.labels, device=dev)

    path()                                 # first calls: lazy set-up
    torch.cuda.synchronize()
    where, armed = [], []          # setting the mode warns once itself

    def mark(message, *args, **kw):
        if armed and "synchroniz" in str(message):
            with record_function("sync_warning"):
                pass
            where.append("".join(traceback.format_stack(limit=14)[:-1]))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = mark
            torch.cuda.set_sync_debug_mode("warn")
            armed.append(True)
            try:
                path()
            finally:
                armed.clear()
                torch.cuda.set_sync_debug_mode(0)
    marks, syncs = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            continue
        if ev.name() == "sync_warning":
            marks.append(ev.start_ns())
        elif ev.name().startswith(program_spans.PREFIX + "sync."):
            syncs.append((ev.start_ns(), ev.end_ns(), ev.name()))
    marks.sort()
    assert marks and len(marks) == len(where)
    held = {s: [m for m in marks if s[0] <= m <= s[1]] for s in syncs}
    outside = [w for m, w in zip(marks, where)
               if not any(s[0] <= m <= s[1] for s in syncs)]
    assert not outside, "waits outside a sync span:\n" + "\n".join(outside)
    assert all(len(v) == 1 for v in held.values()), sorted(
        {s[2] for s, v in held.items() if len(v) != 1})
    assert len(marks) == len(syncs)
    names = {s[2].removeprefix(program_spans.PREFIX) for s in syncs}
    assert {"sync.fit.history", "sync.fit.rows", "sync.kmeans.done",
            "sync.kmeans.result", "sync.minilm.ids", "sync.mel.table",
            "sync.train.stage_in", "sync.metrics.silhouette"} <= names
