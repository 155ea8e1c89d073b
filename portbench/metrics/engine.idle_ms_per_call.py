"""engine.idle_ms_per_call (ms/call): device idle in the traced span
whose middle falls inside a program span other than the captured layer's
(``alaya.engine.*``, ``alaya.search.*``: the queries' upload, the seed
sample, the padding, the slices' join, the answers' download, the call's
own code), over the calls the span held."""

from portbench.metrics._program_spans import idle_by_span


def read(run):
    idle = idle_by_span(run)
    tr = run.trace_result
    if idle is None or tr is None or not tr.work.get("calls"):
        return None
    s = sum(sec for name, sec in idle.items()
            if name is not None and not name.startswith("alaya.captured."))
    return s * 1e3 / tr.work["calls"]
