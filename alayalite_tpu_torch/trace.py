"""Spans of the port's host code, on the profiler's clock.

``with trace.span("alaya.engine.batch_search", topk=10):`` records one
span: its name, an id, the id of the span open around it on the same
thread (its parent, 0 for none), the thread, its start and end
(``time.perf_counter_ns``) and small attributes (rows, a bucket, a graph's
name, a cache hit). Spans go into a bounded buffer (the newest
``MAX_SPANS``); ``spans()`` reads it, ``clear()`` empties it and
``summary()`` gives each name's count, total and self milliseconds (self:
the span's time less what its child spans cover).

Spans are recorded only while they are asked for: after ``enable()``
(until ``disable()``), and while a ``torch.profiler`` profile records.
Off, ``span`` checks two flags and returns a shared null context. While
the profiler records, each span also opens a profiler event of its name,
so it lands on the profiler's host timeline beside the CUDA runtime calls
and the device operations; ``offset_us(events)`` maps the spans' own
clock onto that timeline. Every name starts with ``PREFIX``, which tells
the program's events from ``aten::`` operators and runtime calls.

Spans mark host boundaries only: none sits inside a function that
``index/captured.py`` captures (its Python runs once, at the capture),
and none touches a graph's key.

The spans of a batch search (the path of ``IndexEngine
.batch_search_with_distance``; the raw graph path has the root, the two
copies and the replays, the flat path the root, the two copies and the
scan):

  alaya.engine.batch_search   the call (topk, ef, rows, the space's
                              quantization, the vectors' width dim, the
                              pool width searched, a block space's
                              code_dim)
    alaya.engine.queries_in   the queries to float32 on the device
    alaya.search.seed_sample  the seed scan's sample (hit: cached)
    alaya.search.pad          the batch padded to its slices (rows,
                              slice_rows, slices)
    alaya.captured.replay     one slice's replay (graph, bucket, rows, hit)
      alaya.captured.capture  a missed key's warm-up and capture (graph)
    alaya.search.concat       the slices' answers joined (rows)
    alaya.flat.scan           a flat index's tiled scan, eager (mode, the
                              slab's rows, queries, tiles scored)
    alaya.engine.answers_out  the answers to numpy (waits for the card)
"""

from __future__ import annotations

import collections
import itertools
import statistics
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

PREFIX = "alaya."
MAX_SPANS = 32768

# the profiler's lean host event (a host range with no label on the
# device's timeline; on an H100's host 4.7 us a span under the profiler
# against record_function's 10.5); ``record_function`` on a torch without it
_EVENT = (getattr(getattr(torch._C, "_profiler", None),
                  "_RecordFunctionFast", None)
          or _profiler.record_function)

_enabled = False
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_tls = threading.local()


class Span(NamedTuple):
    name: str
    id: int
    parent: int          # the enclosing span's id on this thread, 0: none
    thread: int
    start_ns: int        # time.perf_counter_ns()
    end_ns: int
    attrs: dict
    profiled: bool       # a profiler event was opened for it

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL = _Null()


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class _Open:
    """A span being recorded: a context manager."""

    __slots__ = ("name", "attrs", "id", "parent", "event", "t0")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> None:
        """Attributes known only inside the span (a hit, the rows)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else 0
        self.id = next(_ids)
        stack.append(self.id)
        self.event = None
        if _profiler._is_profiler_enabled:
            self.event = _EVENT(self.name)
            self.event.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.event is not None:
            self.event.__exit__(None, None, None)
        _stack().pop()
        _spans.append(Span(self.name, self.id, self.parent,
                           threading.get_ident(), self.t0, t1, self.attrs,
                           self.event is not None))
        return False


def span(name: str, **attrs):
    """A context manager that records the span ``name`` while recording
    is on (``enable()``, or a profiler recording), else a shared null
    one. ``.set(**attrs)`` adds attributes from inside."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NULL
    return _Open(name, attrs)


def enable() -> None:
    """Record spans from now on, profiler or not."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record spans only while a profiler records."""
    global _enabled
    _enabled = False


def spans() -> List[Span]:
    """The recorded spans, oldest first (at most ``MAX_SPANS``)."""
    return list(_spans)


def clear() -> None:
    _spans.clear()


def summary(recorded: Optional[List[Span]] = None) -> Dict[str, dict]:
    """{name: {"count", "total_ms", "self_ms"}} over ``recorded`` (default:
    the buffer). Self time is a span's time less its child spans' (the
    children of one thread run one after another inside their parent)."""
    recorded = spans() if recorded is None else recorded
    child_ns: Dict[int, int] = collections.defaultdict(int)
    for s in recorded:
        if s.parent:
            child_ns[s.parent] += s.end_ns - s.start_ns
    out: Dict[str, dict] = {}
    for s in recorded:
        row = out.setdefault(s.name, {"count": 0, "total_ms": 0.0,
                                      "self_ms": 0.0})
        row["count"] += 1
        row["total_ms"] += s.ms
        row["self_ms"] += s.ms - child_ns.get(s.id, 0) * 1e-6
    return out


def offset_us(events, recorded: Optional[List[Span]] = None
              ) -> Optional[float]:
    """Microseconds to add to a span's ``start_ns / 1e3`` (or end) to place
    it on the timeline of ``events`` (a profile's ``events()``, whose
    ``time_range`` is in µs from the trace's start); None where no span
    of ``recorded`` (default: the buffer) has its event there. The spans
    opened under the profile are the newest profiled ones: each name's
    last n spans are paired with its n events, in order, and the median
    difference of their starts is taken."""
    recorded = spans() if recorded is None else recorded
    mine: Dict[str, list] = collections.defaultdict(list)
    for s in recorded:
        if s.profiled:
            mine[s.name].append(s.start_ns * 1e-3)
    theirs: Dict[str, list] = collections.defaultdict(list)
    for ev in events:
        if ev.name in mine:
            theirs[ev.name].append(ev.time_range.start)
    diffs = []
    for name, starts in theirs.items():
        n = min(len(starts), len(mine[name]))
        diffs += [e - s for e, s in zip(sorted(starts)[-n:],
                                        sorted(mine[name])[-n:])]
    return statistics.median(diffs) if diffs else None
