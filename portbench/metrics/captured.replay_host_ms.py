"""captured.replay_host_ms (ms): the mean host duration of an
``alaya.captured.replay`` span (the lock, the copy-in, ``cudaGraphLaunch``
and the outputs' clones of one replay), read with the profiler off: after
the window the probe turns the program's spans on (``trace.enable()``),
makes ``PLAIN_CALLS`` of the cell's own calls and turns them off again.
Under the profiler a replay's host span reads ~10× longer (CUPTI's cost
a graph node), which is not the program's.

The probe also puts the program's spans in the run's info line
(``program_spans``): ``trace.summary()`` of the traced span, the idle
seconds charged to each span's name there (the captured layer's
included), the idle under no program span (the benchmark's own loop) and
the calls they are over; and the summary of the plain calls."""

from portbench.metrics._program_spans import idle_by_span

PLAIN_CALLS = 20


def probe(run):
    try:
        from alayalite_tpu_torch import trace
    except ImportError:          # a program without the recorder
        return
    traced = trace.spans()
    if not traced:
        return
    out = {"summary": trace.summary(traced)}
    idle = idle_by_span(run)
    if idle is not None:
        out["idle_s"] = {k: v for k, v in idle.items() if k is not None}
        out["idle_outside_s"] = idle.get(None, 0.0)
        out["calls"] = (run.trace_result.work.get("calls")
                        if run.trace_result is not None else None)
    trace.clear()
    trace.enable()
    try:
        for _ in range(PLAIN_CALLS):
            run.loop.call()
    finally:
        trace.disable()
    plain = trace.spans()
    trace.clear()
    replays = [s.ms for s in plain if s.name == "alaya.captured.replay"]
    if replays:
        run.probes["replay_host_ms"] = sum(replays) / len(replays)
    out["plain_calls"] = PLAIN_CALLS
    out["plain_summary"] = trace.summary(plain)
    run.info["program_spans"] = out


def read(run):
    return run.probes.get("replay_host_ms")
