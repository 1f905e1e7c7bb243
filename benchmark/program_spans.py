"""The port's own ranges in a traced window, for the readers of
``step_ms``, ``step_ms_p99``, ``adam_ms``, ``fit_idle_s`` and
``host_syncs``.

While a profiler runs, the port opens a ``vae:<name>`` range at each layer
boundary and a ``vae:sync.<site>`` range around each call that makes the
host wait on the device (``core.profiling.span``/``sync``).  ``trace.Trace``
keeps the benchmark's spans and the device's activity and none of these, so
they are read here from the same finished profiler (``of_run``), on the
same clock.  A trace of a port that opens no such range reads empty, and
the readers then find nothing to read.
"""
from __future__ import annotations

import bisect
import sys
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from benchmark import trace as trace_mod

# the port's core.profiling.SPAN_PREFIX, written out: the reader also reads
# traces of ports older than that constant
PREFIX = "vae:"

Span = Tuple[int, int, str]


@dataclass
class Program:
    window: Tuple[int, int]                  # ns, the benchmark's window
    host: List[Span] = field(default_factory=list)     # prefix dropped
    device: List[Span] = field(default_factory=list)   # their device copies


def from_profiler(prof) -> Program:
    """The program's ranges of a finished ``torch.profiler.profile`` and
    their device copies.

    The profiler draws a copy on the device timeline only for the innermost
    range open around a launch (the optimizer's own ``Optimizer.step#...``
    range inside ``fit.update``), with the host range's correlation id; so
    a program range's device copy here is the hull of the drawn copies of
    itself and of the ranges opened inside it."""
    from torch.autograd import DeviceType

    host, drawn, user, windows = [], [], {}, []
    window_name = trace_mod.SPAN_PREFIX + trace_mod.WINDOW
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if ev.is_user_annotation():
                drawn.append((ev.correlation_id(), name, ev.start_ns(),
                              ev.end_ns()))
            continue
        if ev.is_user_annotation():
            user[(name, ev.correlation_id())] = (ev.start_ns(), ev.end_ns())
        if name.startswith(PREFIX):
            host.append((ev.start_ns(), ev.end_ns(),
                         name.removeprefix(PREFIX)))
        elif name == window_name:
            windows.append((ev.start_ns(), ev.end_ns()))
    copies = [(*user[(n, c)], s, e) for c, n, s, e in drawn
              if (n, c) in user]
    return Program(window=windows[0] if len(windows) == 1 else (0, 0),
                   host=host, device=device_copies(host, copies))


def device_copies(ranges: List[Span], copies: List[Tuple[int, int, int, int]]
                  ) -> List[Span]:
    """The device copy of each host range in `ranges` that launched device
    work: from the first start to the last end of the drawn `copies`
    (host start, host end, device start, device end) of the ranges that
    lie inside it."""
    copies = sorted(copies)
    starts = [c[0] for c in copies]
    out = []
    for s, e, name in ranges:
        inside = [c for c in copies[bisect.bisect_left(starts, s):
                                    bisect.bisect_left(starts, e)]
                  if c[1] <= e]
        if inside:
            out.append((min(c[2] for c in inside),
                        max(c[3] for c in inside), name))
    return out


_last: list = []          # [trace, Program]: the five readers share one read


def of_run(run) -> Optional[Program]:
    """The program's ranges of a traced run: its ``program`` where it
    carries one, else those of the profiler that ``run.trace`` was read
    from.  The harness hands a reader the run alone, and keeps that
    profiler as a local of the frame that calls the readers, so it is
    looked for among the callers' locals and taken only where its window
    is ``run.trace``'s.  None without a trace or such a profiler."""
    if run.trace is None:
        return None
    given = getattr(run, "program", None)
    if given is not None:
        return given
    if _last and _last[0] is run.trace:
        return _last[1]
    prog = None
    for prof in _profilers():
        found = from_profiler(prof)
        if found.window == run.trace.window:
            prog = found
            break
    _last[:] = [run.trace, prog]
    return prog


def _profilers():
    import torch

    frame = sys._getframe(1)
    while frame is not None:
        for value in list(frame.f_locals.values()):
            if isinstance(value, torch.profiler.profile):
                yield value
        frame = frame.f_back


def spans(run, name: str, device: bool = False) -> List[Span]:
    """The window's program ranges `name` (host, or their device copies),
    sorted."""
    prog = of_run(run)
    if prog is None:
        return []
    return sorted(s for s in (prog.device if device else prog.host)
                  if s[2] == name)


def step_seconds(run) -> Optional[List[float]]:
    """Device seconds of each training step but a fit's first: from the
    previous step's ``fit.update`` device end to its own.  The k-th device
    copy is the k-th ``fit.step``'s (one stream runs them in order).  None
    where the trace has no step, or the copies and the steps differ in
    number."""
    steps = spans(run, "fit.step")
    ends = [e for _, e, _ in spans(run, "fit.update", device=True)]
    if not steps or len(ends) != len(steps):
        return None
    out = []
    for f0, f1, _ in spans(run, "fit"):
        mine = [e for (s, _, _), e in zip(steps, ends) if f0 <= s < f1]
        out += [(b - a) * 1e-9 for a, b in zip(mine, mine[1:])]
    return out or None
