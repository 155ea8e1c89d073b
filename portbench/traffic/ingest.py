"""ingest: a closed loop of ``Index.insert`` of ``batch_rows`` new rows
drawn from the data's clusters by the seed, then ``Index.remove`` of as
many of the oldest rows still live, so the live size stays at the rows
fitted and ``remove`` compacts once a cycle. The index holds ``capacity``
ids; a run that reaches it fails. Set-up runs ``WARM_CYCLES`` cycles, so
the window starts on a cycle boundary. The judge searches the
configuration's queries and a sample of the window's new rows by their
own vectors on the index as the window left it, and reads a sample back.
The control simulates ``control_steps`` steps without an index."""

import time
from typing import Dict, List

import numpy as np
import torch

from portbench import data as data_mod
from portbench import judge as judge_mod
from portbench.loops import JUDGE_NEW_ROWS, WARM_CYCLES, Loop, label


class Traffic(Loop):
    def __init__(self, run, idx, data):
        super().__init__(run, idx, data)
        self.B = int(self.t["batch_rows"])
        self.n0 = data.base.shape[0]
        self.g = data_mod.generator(self.dev, run.seed, data_mod.STREAM_INSERT)
        cap = int(self.t["capacity"])
        # every id the index holds, oldest first; [head, tail) are live
        self.order = np.empty(cap, dtype=np.int64)
        self.order[:self.n0] = np.arange(self.n0)
        self.head, self.tail = 0, self.n0
        self.step_ids: List[np.ndarray] = []
        self.step_rows: List[torch.Tensor] = []
        self.remove_s: List[float] = []
        thr = float(run.cell.config["index"].get("compaction_threshold", 0.2))
        # Index.remove compacts once the tombstones since the last
        # compaction exceed thr of the live rows (the live count stays n0)
        self.cycle_steps = int(thr * self.n0 // self.B) + 1

    def step(self):
        rows = data_mod.new_rows(self.data, self.B, self.g)
        with label(self.run, "portbench.insert"):
            ids = np.asarray(self.idx.insert(rows.cpu().numpy()),
                             dtype=np.int64)
        self.step_rows.append(rows)
        self.step_ids.append(ids)
        self.order[self.tail:self.tail + ids.size] = ids
        self.tail += ids.size
        old = self.order[self.head:self.head + self.B]
        self.head += self.B
        t = time.perf_counter()
        with label(self.run, "portbench.remove"):
            self.idx.remove(old)
        self.remove_s.append(time.perf_counter() - t)

    def warm(self):
        steps = self.cycle_steps * WARM_CYCLES
        for _ in range(steps):
            self.step()
        self.run.info["cycle_steps"] = self.cycle_steps
        self.run.info["warm_remove_max_s"] = max(self.remove_s)

    def window(self, seconds: float):
        span = self.run.span
        s0 = len(self.step_ids)
        t0 = time.perf_counter()
        if span is not None:
            span.start()
        while time.perf_counter() - t0 < seconds:
            self.step()
            done = len(self.step_ids) - s0
            if span is not None and span.active and done >= self.cycle_steps:
                span.stop()
                span.work = {"steps": done, "rows": done * self.B}
        t1 = time.perf_counter()
        steps = len(self.step_ids) - s0
        if span is not None and span.active:
            span.stop()
            span.work = {"steps": steps, "rows": steps * self.B}
        rem = self.remove_s[s0:]
        slow = [r for r in rem if r > 10 * float(np.median(rem))]
        self.run.info["window_steps"] = steps
        self.run.info["compactions_seen"] = len(slow)
        self.run.info["compaction_s"] = slow
        self.window_first = s0
        return {"seconds": t1 - t0, "steps": steps,
                "rows_inserted": steps * self.B, "remove_s": sum(rem),
                "attempted": steps * self.B, "failed": 0}

    def collect(self):
        """While the index lives: read back a sample of the window's rows,
        and search for the configuration's queries and for the sampled
        rows' own vectors, as the window left the index."""
        cap = int(self.t["capacity"])
        self.bad_inserts = judge_mod.check_inserted(self.step_ids, self.n0,
                                                    cap)
        self._pick_new_rows(cap)
        host = self.new_vecs.cpu().numpy()
        mism = 0
        for j, i in enumerate(self.new_ids):
            if not np.array_equal(self.idx.get_data_by_id(int(i)), host[j]):
                mism += 1
        self.bad_inserts += mism
        self.run.info["readback_rows"] = int(self.new_ids.size)
        q = torch.cat([self.data.queries, self.new_vecs]).cpu().numpy()
        self.ids = np.asarray(self.idx.batch_search(q, self.k,
                                                    ef_search=self.ef))

    def _pick_new_rows(self, cap: int):
        """A sample, drawn from the seed, of the window's inserted rows
        still live: their ids and the vectors inserted."""
        live = self._live_mask(cap)
        win_ids = np.concatenate(self.step_ids[self.window_first:])
        win_rows = torch.cat(self.step_rows[self.window_first:])
        ok = (win_ids >= 0) & (win_ids < cap)
        still = np.zeros(win_ids.size, dtype=bool)
        still[ok] = live[win_ids[ok]]
        cand = np.flatnonzero(still)
        m = min(JUDGE_NEW_ROWS, cand.size)
        pick = np.sort(data_mod.rng(self.run.seed, data_mod.STREAM_JUDGE)
                       .choice(cand, size=m, replace=False))
        self.new_ids = win_ids[pick]
        self.new_vecs = win_rows[torch.as_tensor(pick, device=self.dev)]

    def _live_mask(self, cap: int) -> np.ndarray:
        live = np.zeros(cap, dtype=bool)
        live[self.order[self.head:self.tail]] = True
        return live

    def simulate(self):
        """The control's churn: the steps of a typical window with the
        ids the index hands out (the next free ones, in order) and no
        index; the new rows sampled as a run samples them."""
        nxt = self.n0
        for _ in range(int(self.t["control_steps"])):
            rows = data_mod.new_rows(self.data, self.B, self.g)
            ids = np.arange(nxt, nxt + self.B, dtype=np.int64)
            nxt += self.B
            self.step_rows.append(rows)
            self.step_ids.append(ids)
            self.order[self.tail:self.tail + self.B] = ids
            self.tail += self.B
            self.head += self.B
        self.window_first = 0
        self.bad_inserts = 0
        self._pick_new_rows(int(self.t["capacity"]))

    def set_control_answers(self, ids: np.ndarray):
        self.ids = ids

    def live_rows(self):
        cap = int(self.t["capacity"])
        store = torch.zeros((cap, self.data.base.shape[1]), device=self.dev)
        store[:self.n0] = self.data.base
        for ids, rows in zip(self.step_ids, self.step_rows):
            ok = (ids >= 0) & (ids < cap)
            store[torch.as_tensor(ids[ok], device=self.dev)] = \
                rows[torch.as_tensor(np.flatnonzero(ok), device=self.dev)]
        live = torch.as_tensor(self._live_mask(cap), device=self.dev)
        live_ids = torch.nonzero(live).reshape(-1)
        pos = torch.full((cap,), -1, dtype=torch.int64, device=self.dev)
        pos[live_ids] = torch.arange(live_ids.numel(), device=self.dev)
        return store[live_ids], pos, store

    def judged_queries(self):
        return torch.cat([self.data.queries, self.new_vecs])

    def judge(self, ref, x_live, live_pos, store) -> Dict[str, float]:
        q = self.judged_queries()
        nq = self.nq
        main = judge_mod.answer_numbers(self.ids[:nq], np.arange(nq), q, ref,
                                        live_pos, store, self.k, self.metric)
        new = judge_mod.answer_numbers(self.ids[nq:],
                                       np.arange(nq, q.shape[0]), q, ref,
                                       live_pos, store, self.k, self.metric)
        return {"bad_answers": main["bad_answers"] + new["bad_answers"],
                "bad_kinds": {k: main["bad_kinds"][k] + new["bad_kinds"][k]
                              for k in main["bad_kinds"]},
                "recall10": main["recall10"],
                "order_gap": max(main["order_gap"], new["order_gap"]),
                "bad_inserts": float(self.bad_inserts),
                "new_top1": judge_mod.new_top1(self.ids[nq:], self.new_ids)}
