"""What every traffic kind shares. A mix file (``traffic/<mix>.json``)
names its ``kind`` and the parameters that define the mix (rates, batch
rows, capacity); the kind is ``traffic/<kind>.py``, found by name
(``spec.traffic_kind``), whose ``Traffic`` class drives the program:

  closed_batch   one client calls ``Index.batch_search`` on every query of
                 the configuration, top k at the configuration's ef, again
                 and again (ann-benchmarks' batch mode);
  open_loop      one generator thread submits single queries to a
                 ``SearchServer`` on a Poisson schedule at a fixed rate
                 (optionally in on/off bursts), each timed from its due
                 time to its result;
  ingest         closed loop of ``Index.insert`` of a batch of new rows
                 drawn from the data's clusters, then ``Index.remove`` of
                 as many of the oldest rows still live.

A kind subclasses ``Loop``: ``warm`` (set-up: every shape the window will
use), the ``window``, ``collect`` (while the program is alive: what the
judge needs from it), ``judge`` (after the program is freed, with the
reference), and for the control ``simulate`` and ``set_control_answers``.

How the harness warms, traces and judges is the same for every mix and
lives here, not in a mix file.
"""

from __future__ import annotations

import torch

from . import data as data_mod

WARM_CALLS = 2          # calls of each batch shape before the window
JUDGE_CALLS = 8         # distinct answer arrays of a closed loop judged
TRACE_LEAD_S = 1.0      # the traced span starts this far into the window
TRACE_SPAN_S = 2.0      # and lasts this long
DRAIN_S = 60.0          # an answer is waited for this long past the close
WARM_CYCLES = 1         # compaction cycles an ingest loop runs in set-up
JUDGE_NEW_ROWS = 1000   # the window's inserted rows searched by own vector


def label(run, name):
    """A marker of the benchmark's own around a call into the program, in
    traced runs only."""
    if run.span is None:
        return _NULL
    from torch.profiler import record_function

    return record_function(name)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class Loop:
    def __init__(self, run, idx, data: data_mod.Data):
        self.run = run
        self.idx = idx
        self.data = data
        self.t = run.cell.traffic
        self.k = int(run.cell.config["search"]["topk"])
        self.ef = int(run.cell.config["search"]["ef"])
        self.metric = str(run.cell.config["index"].get("metric", "l2"))
        self.dev = run.device
        self.nq = data.queries.shape[0]

    # the reference's inputs (overridden by ingest)
    def live_rows(self):
        """(live vectors [L, D] in the benchmark's copy, live_pos [C],
        store [C, D])."""
        base = self.data.base
        pos = torch.arange(base.shape[0], device=base.device)
        return base, pos, base

    def judged_queries(self):
        return self.data.queries
