"""Reading a ``torch.profiler`` trace of the measured window.

From the profiler's events: the device's busy time (the union of the
intervals in which a kernel, copy or fill ran), the device time of each
kernel by name, and the idle gaps between device activity, each named by
the innermost benchmark span (a ``record_function`` range whose name
starts with ``SPAN_PREFIX``) open on the host at the gap's start.  The
idle arithmetic is the one of the port's ``tools/profile_chain.py``.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

SPAN_PREFIX = "bench:"
WINDOW = "window"


@dataclass
class Trace:
    window: Tuple[int, int]                       # ns, host clock of the trace
    device: List[Tuple[int, int, str]] = field(default_factory=list)
    spans: List[Tuple[int, int, str]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of device activity inside the window, sorted."""
        lo, hi = self.window
        merged: List[List[int]] = []
        for s, e, _ in sorted(self.device):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernel_s(self, match: str) -> float:
        """Summed device seconds of the kernels whose name contains
        `match`."""
        return sum(e - s for s, e, n in self.device if match in n) * 1e-9

    def kernel_count(self, match: str) -> int:
        return sum(1 for _, _, n in self.device if match in n)

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, int] = defaultdict(int)
        for s, e, name in self.device:
            by[name[:120]] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-9] for k, v in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle seconds by the innermost benchmark span open when each gap
        began, the largest first."""
        lo, hi = self.window
        busy = self.busy_intervals()
        gaps, t = [], lo
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        spans = sorted(self.spans)
        starts = [s for s, _, _ in spans]
        by: Dict[str, int] = defaultdict(int)
        for g0, g1 in gaps:
            name, best = WINDOW, None
            i = bisect.bisect_right(starts, g0)
            for s, e, nm in reversed(spans[max(0, i - 64):i]):
                if s <= g0 < e and (best is None or s > best):
                    name, best = nm, s
            by[name] += g1 - g0
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-9] for k, v in top]


def from_profiler(prof) -> Trace:
    """A ``Trace`` of a finished ``torch.profiler.profile``, its window the
    benchmark span ``WINDOW``.  Device events are those on the CUDA
    device, less the copies of host ranges (``record_function``, such as
    the optimizer's) that the profiler draws on the device's timeline and
    that carry a host event's name; spans are the host ranges of the
    benchmark (``SPAN_PREFIX``, the prefix dropped)."""
    from torch.autograd import DeviceType

    device, spans, host_names = [], [], set()
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            device.append((ev.start_ns(), ev.end_ns(), name))
            continue
        host_names.add(name)
        if name.startswith(SPAN_PREFIX):
            spans.append((ev.start_ns(), ev.end_ns(),
                          name.removeprefix(SPAN_PREFIX)))
    # a host range's copy on the device timeline carries the range's name
    device = [d for d in device if d[2] not in host_names]
    windows = [(s, e) for s, e, n in spans if n == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"trace holds {len(windows)} '{WINDOW}' spans")
    return Trace(window=windows[0], device=device, spans=spans)
