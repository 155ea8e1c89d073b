"""open_loop: one generator thread submits single queries to a
``SearchServer(topk, ef, max_batch, timeout_us)`` on a seeded schedule at
the mix's ``rate_per_s`` (Poisson; with ``burst`` {"on_s", "off_s"} the
same mean rate in on/off bursts), each request timed from its due time to
its result. Set-up warms every batch bucket in ``warm_batches``. The
``--sweep`` mode runs one open loop a rate in one process (the knee)."""

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from portbench import data as data_mod
from portbench import judge as judge_mod
from portbench import stats
from portbench.loops import (DRAIN_S, TRACE_LEAD_S, TRACE_SPAN_S,
                             WARM_CALLS, Loop)
from portbench.trace import Span


class Traffic(Loop):
    def warm(self):
        from alayalite_tpu_torch.serving import SearchServer

        self.q_host = self.data.queries.cpu().numpy()
        # every batch bucket the server's batches can reach
        for b in self.t["warm_batches"]:
            for _ in range(WARM_CALLS):
                self.idx.batch_search(self.q_host[:b], self.k,
                                      ef_search=self.ef)
        self.server = SearchServer(self.idx, topk=self.k, ef=self.ef,
                                   max_batch=int(self.t["max_batch"]),
                                   timeout_us=int(self.t["timeout_us"]))
        for i in range(8):
            self.server.search(self.q_host[i])

    def counters(self) -> dict:
        s = self.server
        return {"batches": s.batches, "queries": s.queries,
                "search_s": s.search_s}

    def open_loop(self, rate: float, seconds: float, seed: int,
                  span: Optional[Span] = None) -> dict:
        """Requests due in [0, seconds) at ``rate``; waits for each result
        up to ``DRAIN_S`` past the close."""
        r = data_mod.rng(seed, data_mod.STREAM_TRAFFIC)
        due = stats.schedule(rate, seconds, r, self.t.get("burst"))
        n = due.size
        qsel = np.resize(r.permutation(self.nq), n)
        sent = np.full(n, np.nan)
        done = np.full(n, np.nan)
        ids = np.full((n, self.k), -1, dtype=np.int64)
        finished = [0]
        q = self.q_host
        server, k = self.server, self.k

        # the loop keeps no future: each callback (on the dispatcher's
        # thread) stamps its request and copies its ids, so the heap the
        # interpreter's collector walks does not grow with the requests
        def callback(i):
            def finish(f):
                if f.exception() is None:
                    done[i] = time.perf_counter()
                    got = f.result()[0]
                    ids[i, :min(k, got.size)] = got[:k]
                finished[0] += 1
            return finish

        def generate(t0):
            for i in range(n):
                delay = t0 + due[i] - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                sent[i] = time.perf_counter()
                server.submit(q[qsel[i]]).add_done_callback(callback(i))

        t0 = time.perf_counter() + 0.01
        gen = threading.Thread(target=generate, args=(t0,), daemon=True)
        gen.start()
        if span is not None:
            time.sleep(max(0.0, t0 + TRACE_LEAD_S - time.perf_counter()))
            span.start()
            lo = time.perf_counter() - t0
            time.sleep(TRACE_SPAN_S)
            span.stop()
            hi = time.perf_counter() - t0
            span.work = {"requests": int(((due >= lo) & (due < hi)).sum())}
        deadline = t0 + seconds + DRAIN_S
        time.sleep(max(0.0, t0 + seconds / 2 - time.perf_counter()))
        half = int(np.isfinite(sent).sum()) - finished[0]
        gen.join(timeout=max(1.0, deadline - time.perf_counter()))
        if gen.is_alive():
            raise RuntimeError("the open loop's generator did not finish")
        backlog_close = n - finished[0]
        while finished[0] < n and time.perf_counter() < deadline:
            time.sleep(0.005)
        done_by_close = int((done <= t0 + seconds).sum())
        failed = int(np.isnan(done).sum())
        ids[np.isnan(done)] = -1            # never came: no answer
        lat = stats.latencies(t0 + due, done)
        late = sent - (t0 + due)
        return {"n": n, "due": due, "qsel": qsel, "ids": ids,
                "latency_s": lat, "lateness_s": late, "failed": failed,
                "completed_by_close": done_by_close,
                "backlog_half": half, "backlog_close": backlog_close}

    def window(self, seconds: float):
        rate = float(self.t["rate_per_s"])
        c0 = self.counters()
        res = self.open_loop(rate, seconds, self.run.seed, self.run.span)
        c1 = self.counters()
        self.res = res
        lat = res["latency_s"]
        info = self.run.info
        info["requests"] = res["n"]
        info["p50_ms"] = stats.percentile(lat, 50) * 1e3
        info["p99_ms"] = stats.percentile(lat, 99) * 1e3
        info["generator_late_p50_ms"] = stats.percentile(
            res["lateness_s"], 50) * 1e3
        info["generator_late_p95_ms"] = stats.percentile(
            res["lateness_s"], 95) * 1e3
        info["backlog_at_close"] = res["backlog_close"]
        return {"seconds": seconds, "answered": res["n"] - res["failed"],
                "attempted": res["n"], "failed": res["failed"],
                "latency_s": lat,
                "server": {k: c1[k] - c0[k] for k in c0}}

    def collect(self):
        self.server.close()
        self.server = None

    def simulate(self):
        self.res = {"qsel": np.arange(self.nq)}

    def set_control_answers(self, ids: np.ndarray):
        self.res["ids"] = ids

    def judge(self, ref, x_live, live_pos, store) -> Dict[str, float]:
        return judge_mod.answer_numbers(self.res["ids"], self.res["qsel"],
                                        self.data.queries, ref, live_pos,
                                        store, self.k, self.metric)

    def sweep(self, rates: List[float], seconds: float) -> List[dict]:
        """The knee sweep: one open loop a rate, in one process."""
        rows = []
        for j, rate in enumerate(rates):
            c0 = self.counters()
            res = self.open_loop(rate, seconds, self.run.seed + j)
            c1 = self.counters()
            lat = res["latency_s"]
            rows.append({
                "offered_per_s": res["n"] / seconds,
                "completed_per_s": res["completed_by_close"] / seconds,
                "backlog_half": res["backlog_half"],
                "backlog_close": res["backlog_close"],
                "p50_ms": stats.percentile(lat, 50) * 1e3,
                "p95_ms": stats.percentile(lat, 95) * 1e3,
                "p99_ms": stats.percentile(lat, 99) * 1e3,
                "late_p50_ms": stats.percentile(res["lateness_s"], 50) * 1e3,
                "late_p95_ms": stats.percentile(res["lateness_s"], 95) * 1e3,
                "mean_batch": (c1["queries"] - c0["queries"])
                / max(1, c1["batches"] - c0["batches"]),
                "failed": res["failed"]})
        return rows
