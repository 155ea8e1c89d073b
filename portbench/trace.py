"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over a
steady part of the window, reduced to what the readers need.

  busy_s     the union of the device's operation intervals (kernels,
             copies, sets; those inside a replayed CUDA graph too) within
             the traced span: time in which an operation ran, not the sum
             of their times;
  window_s   the span's length, from the benchmark's own marker
             (``record_function``) around it;
  by_name    summed device seconds and launches per operation name;
  gaps       the stretches with no device operation, each named by the
             innermost host event running at its middle.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from . import stats

MARK = "portbench.traced_span"


@dataclasses.dataclass
class Trace:
    busy_s: float
    window_s: float
    by_name: Dict[str, Tuple[float, int]]     # name -> (seconds, count)
    idle_gaps: List[Tuple[str, float]]        # (host activity, seconds)
    work: dict                                # what the span held (calls, ...)

    def device_seconds(self, pattern) -> Tuple[float, int]:
        """Summed seconds and count of the device operations whose name
        ``pattern(name)`` accepts."""
        s, n = 0.0, 0
        for name, (sec, cnt) in self.by_name.items():
            if pattern(name):
                s += sec
                n += cnt
        return s, n

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:10]
        return {"device_ops": [[name, sec] for name, (sec, _) in ops],
                "idle_gaps": [[name, sec] for name, sec in self.idle_gaps[:10]]}


class Span:
    """Start and stop the profiler around part of a window (the device
    synced at both ends, so the span holds whole operations)."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.mark = None
        self.work: dict = {}
        self.t1 = None

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 is None

    def warm(self) -> None:
        """Start and stop the profiler once on a small operation (set-up:
        the first start in a process initialises the tracer for seconds)."""
        import torch

        self.start()
        torch.ones(8, device=self.device).sum()
        self.stop()
        self.prof = self.mark = self.t1 = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.mark = record_function(MARK)
        self.mark.__enter__()

    def stop(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self.mark.__exit__(None, None, None)
        self.prof.stop()

    def reduce(self) -> Optional[Trace]:
        if self.prof is None or self.t1 is None:
            return None
        return reduce_events(self.prof.events(), self.work)


def reduce_events(events, work: dict) -> Optional[Trace]:
    """A ``Trace`` from profiler events; None when the span held no
    device operation (a CPU run)."""
    from torch.autograd import DeviceType

    lo = hi = None
    host = []
    dev = []
    for ev in events:
        tr = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            # a ``record_function`` range also shows on the device's
            # timeline; it is a label, not an operation
            if not (getattr(ev, "is_user_annotation", False)
                    or ev.name.startswith("portbench.")):
                dev.append((tr.start, tr.end, ev.name))
        elif ev.device_type == DeviceType.CPU:
            if ev.name == MARK:
                lo, hi = tr.start, tr.end
            else:
                host.append((tr.start, tr.end, ev.name))
    if lo is None or not dev:
        return None
    intervals = [(s, e) for s, e, _ in dev if e > lo and s < hi]
    if not intervals:
        return None
    by_name: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    for s, e, name in dev:
        if e > lo and s < hi:
            by_name[name][0] += (min(e, hi) - max(s, lo)) * 1e-6
            by_name[name][1] += 1
    busy = stats.union_length(intervals, lo, hi) * 1e-6
    idle = defaultdict(float)
    for (s, e), name in zip(*_name_gaps(stats.gaps(intervals, lo, hi),
                                        host)):
        idle[name] += (e - s) * 1e-6
    return Trace(busy, (hi - lo) * 1e-6,
                 {k: (v[0], v[1]) for k, v in by_name.items()},
                 sorted(idle.items(), key=lambda kv: -kv[1]), dict(work))


def _name_gaps(gaps: List[Tuple[float, float]],
               host: List[Tuple[float, float, str]]):
    """(gaps in order of their middles, the name of the host event
    running at each middle that started last: the innermost of nested
    events)."""
    import heapq

    gaps = sorted(gaps, key=lambda g: g[0] + g[1])
    host = sorted(host)
    names, live, at = [], [], 0
    for s, e in gaps:
        mid = 0.5 * (s + e)
        while at < len(host) and host[at][0] <= mid:
            hs, he, name = host[at]
            heapq.heappush(live, (-hs, he, name))
            at += 1
        while live and live[0][1] < mid:
            heapq.heappop(live)
        names.append(live[0][2] if live else "no traced host event")
    return gaps, names
