"""The readers of the program's spans on synthetic profiler events: each
idle gap goes to the innermost ``alaya.`` span at its middle."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import spec, trace
from portbench.metrics import _program_spans as ps

CPU = DeviceType.CPU


def ev(name, start, end, dev=DeviceType.CUDA, annotation=False):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation)


# window [0, 100) µs, two calls. Device busy [10, 30), [50, 60), [75, 90).
# Gaps: [0, 10) mid 5: no program span (the benchmark's loop);
# [30, 50) mid 40: inside the replay, and inside cudaGraphLaunch, which
# started later but is no program span; [60, 75) mid 67.5: inside the
# root only (the call's own code); [90, 100) mid 95: answers_out.
EVENTS = [
    ev(trace.MARK, 0, 100, CPU),
    ev("portbench.batch_search", 8, 99, CPU),
    ev("portbench.batch_search", 8, 99, annotation=True),   # a label
    ev("alaya.engine.batch_search", 9, 98, CPU),
    ev("alaya.engine.queries_in", 9, 12, CPU),
    ev("alaya.captured.replay", 31, 45, CPU),
    ev("cudaGraphLaunch", 35, 44, CPU),
    ev("aten::empty_strided", 66, 69, CPU),
    ev("alaya.engine.answers_out", 88, 98, CPU),
    ev("kernel_a", 10, 30), ev("kernel_b", 50, 60), ev("kernel_c", 75, 90),
]


def fake_run(events, calls=2):
    tr = trace.reduce_events(events, {"calls": calls})
    return SimpleNamespace(
        probes={}, info={}, trace_result=tr,
        span=SimpleNamespace(prof=SimpleNamespace(events=lambda: events),
                             t1=1.0))


def test_gap_goes_to_the_innermost_program_span():
    idle = ps.idle_from_events(EVENTS)
    assert idle == pytest.approx({
        None: 10e-6,                                  # outside the program
        "alaya.captured.replay": 20e-6,               # not cudaGraphLaunch
        "alaya.engine.batch_search": 15e-6,           # not aten::empty_strided
        "alaya.engine.answers_out": 10e-6})
    # the parts add up to the trace's own idle
    tr = trace.reduce_events(EVENTS, {})
    assert sum(idle.values()) == pytest.approx(tr.window_s - tr.busy_s)


@pytest.mark.parametrize("metric,want", [
    ("engine.idle_ms_per_call", 25e-3 / 2)])     # not the replay's 20e-3
def test_idle_readers_split_by_layer(metric, want):
    assert spec.reader(metric).read(fake_run(EVENTS)) == pytest.approx(want)


@pytest.mark.parametrize("case", ["cpu rehearsal", "no program span",
                                  "untraced run"])
def test_readers_read_nothing_without_both(case):
    events = {"cpu rehearsal": [e for e in EVENTS if e.device_type == CPU],
              "no program span": [e for e in EVENTS
                                  if not e.name.startswith("alaya.")],
              "untraced run": EVENTS}[case]
    run = fake_run(events)
    if case == "untraced run":
        run.span = None
    else:
        assert ps.idle_from_events(events) is None
    assert spec.reader("engine.idle_ms_per_call").read(run) is None


def test_replay_probe_reads_the_programs_spans():
    """The traced span's spans go to the info line; the replay's host ms
    is read from the probe's own calls, recorded with the profiler off."""
    import time

    from alayalite_tpu_torch import trace as program_trace

    def call():
        with program_trace.span("alaya.engine.batch_search"):
            with program_trace.span("alaya.captured.replay"):
                time.sleep(0.002)

    reader = spec.reader("captured.replay_host_ms")
    run = fake_run(EVENTS)
    run.loop = SimpleNamespace(call=call)
    program_trace.clear()
    reader.probe(run)                      # nothing traced: nothing read
    assert reader.read(run) is None and "program_spans" not in run.info
    program_trace.enable()                 # as a traced span records them
    try:
        for _ in range(3):
            with program_trace.span("alaya.engine.batch_search"):
                with program_trace.span("alaya.captured.replay"):
                    pass
    finally:
        program_trace.disable()
    reader.probe(run)
    assert not program_trace._enabled and program_trace.spans() == []
    assert reader.read(run) >= 2.0         # the probe's calls, not the 3
    info = run.info["program_spans"]
    assert info["summary"]["alaya.captured.replay"]["count"] == 3
    assert info["plain_calls"] == reader.PLAIN_CALLS
    assert (info["plain_summary"]["alaya.captured.replay"]["count"]
            == reader.PLAIN_CALLS)
    assert info["idle_outside_s"] == pytest.approx(10e-6)
    assert info["idle_s"]["alaya.captured.replay"] == pytest.approx(20e-6)
    assert info["calls"] == 2
