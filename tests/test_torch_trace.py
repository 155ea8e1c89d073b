"""The port's span recorder (``alayalite_tpu_torch.trace``).

On the CPU: off, a span records nothing and opens no profiler event; on
(``enable()``, or a ``torch.profiler`` profile recording) spans nest per
thread, the buffer keeps its bound, each span lands on the profiler's
timeline within 50 µs of its own clock through ``offset_us``, and one
``batch_search`` on a small bsq8 index records its spans in the order the
call runs them.

With a CUDA device (``python -m pytest --noconftest -m gpu
tests/test_torch_trace.py``) a warmed 10,000-query search records three
replays that hit their graphs, and no capture.
"""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from alayalite_tpu_torch import trace

torch.set_num_threads(2)

BATCH_SPANS = ["alaya.engine.queries_in", "alaya.search.seed_sample",
               "alaya.search.pad", "alaya.search.concat",
               "alaya.engine.answers_out"]


@pytest.fixture(autouse=True)
def fresh():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def _no_event(*a, **k):
    raise AssertionError("a profiler event was opened")


def test_off_records_nothing_and_opens_no_event(monkeypatch):
    monkeypatch.setattr(trace, "_EVENT", _no_event)
    monkeypatch.setattr(torch.profiler, "record_function", _no_event)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _no_event)
    with trace.span("alaya.test", rows=3) as s:
        s.set(hit=True)
    assert trace.span("alaya.a") is trace.span("alaya.b")   # one null
    assert trace.spans() == []
    trace.enable()
    with trace.span("alaya.test"):        # on, but no profiler: no event
        pass
    assert [s.profiled for s in trace.spans()] == [False]


@pytest.mark.parametrize("switch", ["enable", "profiler"])
def test_spans_record_while_asked(switch):
    if switch == "enable":
        trace.enable()
        with trace.span("alaya.on", rows=2) as s:
            s.set(hit=False)
        trace.disable()
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span("alaya.on", rows=2) as s:
                s.set(hit=False)
    with trace.span("alaya.off"):
        pass
    (got,) = trace.spans()
    assert (got.name, got.parent, got.attrs) == ("alaya.on", 0,
                                                 {"rows": 2, "hit": False})
    assert got.profiled == (switch == "profiler")
    assert got.end_ns >= got.start_ns


def test_parents_nest_per_thread():
    trace.enable()
    barrier = threading.Barrier(2, timeout=10)

    def worker(tag):
        with trace.span(f"alaya.{tag}.outer"):
            barrier.wait()            # both outers open at once
            with trace.span(f"alaya.{tag}.inner"):
                barrier.wait()
                with trace.span(f"alaya.{tag}.leaf"):
                    pass

    threads = [threading.Thread(target=worker, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    by_name = {s.name: s for s in trace.spans()}
    assert len(by_name) == 6
    for tag in "ab":
        outer, inner, leaf = (by_name[f"alaya.{tag}.{n}"]
                              for n in ("outer", "inner", "leaf"))
        assert outer.parent == 0
        assert inner.parent == outer.id and leaf.parent == inner.id
        assert outer.thread == inner.thread == leaf.thread
    assert by_name["alaya.a.outer"].thread != by_name["alaya.b.outer"].thread


def test_buffer_keeps_its_bound():
    trace.enable()
    for i in range(trace.MAX_SPANS + 3):
        with trace.span("alaya.n", i=i):
            pass
    got = trace.spans()
    assert len(got) == trace.MAX_SPANS
    assert got[0].attrs["i"] == 3 and got[-1].attrs["i"] == trace.MAX_SPANS + 2
    trace.clear()
    assert trace.spans() == []


def test_summary_self_time_leaves_children_out():
    S = trace.Span
    spans = [S("alaya.child", 2, 1, 7, 10_000_000, 13_000_000, {}, False),
             S("alaya.child", 3, 1, 7, 14_000_000, 15_000_000, {}, False),
             S("alaya.root", 1, 0, 7, 9_000_000, 20_000_000, {}, False)]
    got = trace.summary(spans)
    assert got["alaya.root"] == pytest.approx(
        {"count": 1, "total_ms": 11.0, "self_ms": 7.0})
    assert got["alaya.child"] == pytest.approx(
        {"count": 2, "total_ms": 4.0, "self_ms": 4.0})


def test_profiler_event_is_the_lean_one_where_torch_has_it():
    lean = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    assert trace._EVENT is (lean or torch.autograd.profiler.record_function)


@pytest.mark.parametrize("event", ["as resolved", "record_function"])
def test_spans_land_on_the_profilers_clock(event, monkeypatch):
    if event == "record_function":     # a torch without the lean event
        monkeypatch.setattr(trace, "_EVENT",
                            torch.autograd.profiler.record_function)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("alaya.warm"):   # an event class's first use is slow
            pass
        for i in range(20):
            with trace.span("alaya.outer"):
                torch.ones(64).sum()
                with trace.span("alaya.inner"):
                    torch.ones(64).sum()
    events = {}
    for ev in prof.events():
        if ev.name.startswith(trace.PREFIX):
            events.setdefault(ev.name, []).append(ev)
    off = trace.offset_us(prof.events())
    assert off is not None
    for name in ("alaya.outer", "alaya.inner"):
        mine = sorted((s for s in trace.spans() if s.name == name),
                      key=lambda s: s.start_ns)
        theirs = sorted(events[name], key=lambda e: e.time_range.start)
        assert len(mine) == len(theirs) == 20
        for s, e in zip(mine, theirs):
            assert abs(e.time_range.start - (s.start_ns * 1e-3 + off)) < 50
            assert abs(e.time_range.end - (s.end_ns * 1e-3 + off)) < 50


def _small_bsq8(device):
    from alayalite_tpu_torch import Client

    x = np.random.default_rng(3).normal(size=(1000, 32)).astype(np.float32)
    idx = Client(device=device).create_index(
        "t", quantization_type="bsq8", capacity=1000, max_nbrs=16)
    idx.fit(x)
    return idx, x


def test_batch_search_spans_in_call_order():
    """One ``batch_search`` under the profiler: the root holds the
    queries' upload, the seed sample (a hit: the warm-up drew it), the
    padding, the join and the answers' download, in that order, on the
    spans' clock and on the profiler's."""
    idx, x = _small_bsq8("cpu")
    idx.batch_search(x[:50], 10, ef_search=32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        idx.batch_search(x[:50], 10, ef_search=32)
    spans = trace.spans()
    (root,) = [s for s in spans if s.name == "alaya.engine.batch_search"]
    assert root.attrs == {"topk": 10, "ef": 32, "rows": 50, "space": "bsq8",
                          "pool": 32, "dim": 32, "code_dim": 128}
    kids = sorted((s for s in spans if s.parent == root.id),
                  key=lambda s: s.start_ns)
    assert [s.name for s in kids] == BATCH_SPANS
    assert len(spans) == 1 + len(BATCH_SPANS)
    assert kids[1].attrs == {"hit": True}
    assert kids[2].attrs == {"rows": 64, "slice_rows": 64, "slices": 1}
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns
    events = sorted((e for e in prof.events()
                     if e.name.startswith(trace.PREFIX)),
                    key=lambda e: e.time_range.start)
    assert [e.name for e in events] == ["alaya.engine.batch_search",
                                        *BATCH_SPANS]
    outer = events[0].time_range
    assert all(outer.start <= e.time_range.start
               and e.time_range.end <= outer.end for e in events[1:])


@pytest.mark.gpu
def test_cuda_warm_search_replays_three_hits():
    """10,000 queries (3 slices of 4,096) after a warm-up: three replay
    spans that hit their graph (bucket 4,096), no capture span, and no
    capture counted."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from alayalite_tpu_torch.index import captured
    from alayalite_tpu_torch.utils.datasets import random_dataset

    from alayalite_tpu_torch import Client

    ds = random_dataset(n=20_000, dim=64, n_queries=10_000, seed=13)
    idx = Client().create_index("g", index_type="hnsw",
                                quantization_type="bsq8", capacity=20_000)
    idx.fit(ds.data)
    want = idx.batch_search(ds.queries, 10, ef_search=64)
    captures = captured.stats["captures"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got = idx.batch_search(ds.queries, 10, ef_search=64)
    assert np.array_equal(got, want)
    assert captured.stats["captures"] == captures
    spans = trace.spans()
    names = [s.name for s in spans]
    assert "alaya.captured.capture" not in names
    replays = [s for s in spans if s.name == "alaya.captured.replay"]
    assert len(replays) == 3
    assert all(s.attrs == {"graph": "block_slice", "rows": 4096,
                           "hit": True, "bucket": 4096} for s in replays)
    (root,) = [s for s in spans if s.name == "alaya.engine.batch_search"]
    assert all(s.parent == root.id for s in replays)
