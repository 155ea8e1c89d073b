"""closed_batch: one client calls ``Index.batch_search`` on every query of
the configuration, top k at its ef, again and again (ann-benchmarks'
batch mode). Every call's answers are kept; at most ``JUDGE_CALLS``
distinct answer arrays are judged, each weighted by the calls that
returned it."""

import time
from typing import Dict, List

import numpy as np

from portbench import data as data_mod
from portbench import judge as judge_mod
from portbench.loops import (JUDGE_CALLS, TRACE_LEAD_S, TRACE_SPAN_S,
                             WARM_CALLS, Loop, label)


class Traffic(Loop):
    def warm(self):
        self.q_host = self.data.queries.cpu().numpy()
        for _ in range(WARM_CALLS):
            self.call()

    def call(self):
        return self.idx.batch_search(self.q_host, self.k, ef_search=self.ef)

    def window(self, seconds: float):
        run, span = self.run, self.run.span
        lead = TRACE_LEAD_S
        answers: List[np.ndarray] = []
        calls = 0
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            if now >= seconds:
                break
            if span is not None and span.prof is None and now >= lead:
                span.start()
                c0, lead = calls, time.perf_counter() - t0
            if (span is not None and span.active
                    and now >= lead + TRACE_SPAN_S):
                span.stop()
                span.work = {"calls": calls - c0,
                             "queries": (calls - c0) * self.nq}
            with label(run, "portbench.batch_search"):
                answers.append(self.call())
            calls += 1
        t1 = time.perf_counter()
        if span is not None and span.active:
            span.stop()
            span.work = {"calls": calls - c0,
                         "queries": (calls - c0) * self.nq}
        self.answers = answers
        return {"seconds": t1 - t0, "calls": calls,
                "answered": calls * self.nq, "attempted": calls * self.nq,
                "failed": 0}

    def collect(self):
        """Distinct answer arrays and how many calls returned each; at most
        ``JUDGE_CALLS`` of them judged, a sample drawn from the seed."""
        distinct: List[np.ndarray] = []
        counts: List[int] = []
        for a in self.answers:
            for j, d in enumerate(distinct):
                if np.array_equal(a, d):
                    counts[j] += 1
                    break
            else:
                distinct.append(a)
                counts.append(1)
        if len(distinct) > JUDGE_CALLS:
            pick = data_mod.rng(self.run.seed, data_mod.STREAM_JUDGE).choice(
                len(distinct), size=JUDGE_CALLS, replace=False)
            distinct = [distinct[i] for i in sorted(pick)]
            counts = [counts[i] for i in sorted(pick)]
        self.distinct, self.counts = distinct, counts
        self.run.info["distinct_answers"] = len(distinct)
        del self.answers

    def simulate(self):
        pass

    def set_control_answers(self, ids: np.ndarray):
        self.distinct, self.counts = [ids], [1]

    def judge(self, ref, x_live, live_pos, store) -> Dict[str, float]:
        out = {"bad_answers": 0.0, "order_gap": 0.0,
               "bad_kinds": {"missing": 0, "not_live": 0, "repeated": 0}}
        hits = total = 0.0
        qidx = np.arange(self.nq)
        for ids, n in zip(self.distinct, self.counts):
            r = judge_mod.answer_numbers(ids, qidx, self.data.queries, ref,
                                         live_pos, store, self.k,
                                         self.metric)
            out["bad_answers"] += r["bad_answers"] * n
            for kind, m in r["bad_kinds"].items():
                out["bad_kinds"][kind] += m * n
            out["order_gap"] = max(out["order_gap"], r["order_gap"])
            hits += r["recall10"] * n
            total += n
        out["recall10"] = hits / total
        return out
