"""The program's own spans (``alayalite_tpu_torch.trace``, names
``alaya.*``) against the traced span's device trace: each stretch in which
no device operation ran is charged to the innermost program span running
on the host at its middle, or to no program span (the benchmark's own
loop). It is ``portbench/trace.py``'s reduction of the profile given the
program's host events alone, so an ``aten::`` operator or a runtime call
inside a span does not take the gap from it.

A program without spans (one older than the recorder) leaves the profile
without ``alaya.`` events: the readers then return None, as they do
without a device trace (the CPU rehearsal)."""

from __future__ import annotations

from typing import Dict, Optional

from portbench.trace import MARK, reduce_events

PREFIX = "alaya."


def idle_from_events(events) -> Optional[Dict[Optional[str], float]]:
    """{innermost program span's name at a gap's middle, None for no
    program span: idle seconds} in the traced span of ``events``; None
    without a device operation or without any program event."""
    from torch.autograd import DeviceType

    kept = [ev for ev in events if ev.device_type != DeviceType.CPU
            or ev.name == MARK or ev.name.startswith(PREFIX)]
    if not any(ev.device_type == DeviceType.CPU
               and ev.name.startswith(PREFIX) for ev in kept):
        return None
    tr = reduce_events(kept, {})
    if tr is None:
        return None
    return {(name if name.startswith(PREFIX) else None): sec
            for name, sec in tr.idle_gaps}


def idle_by_span(run) -> Optional[Dict[Optional[str], float]]:
    """``idle_from_events`` of the run's traced span, read once a run."""
    if "program_idle_s" not in run.probes:
        span = run.span
        run.probes["program_idle_s"] = (
            idle_from_events(span.prof.events())
            if span is not None and span.prof is not None
            and span.t1 is not None else None)
    return run.probes["program_idle_s"]
