"""What decides ``correct``: the answers the timed path returned, held
against the reference's exact neighbours over the live rows.

Numbers, each with its limit (``limits/<cell>.json`` and the
configuration's stated floors):

  bad_answers   answers with an id out of range, not live, twice in one
                row, or −1 while k live rows exist; requests that failed
                or never came. Exact: limit 0.
  recall10      recall@k of the answers against the exact top k. Limit
                from the readings (``limits/<cell>.json``: sound runs
                against a planted traversal fault), never under the floor
                the configuration states.
  order_gap     the widest step by which an answer's list goes down in
                exact (float64) distance from one id to the next, over the
                size of that query's distances (the larger of the
                reference's 1st and k-th, taken whole). The program
                re-ranks its pool in float32 (under 1e-5 here); an answer
                ordered by TF32 products, the control, steps back by
                ~1e-3. Limit from the two readings (PERF.md).

Distances are the configuration's metric (``reference.space``).

The churn cell adds (``judge_churn``):

  bad_inserts   insert ids that are not fresh, distinct and in range, and
                rows read back (``Index.get_data_by_id``) unequal to what
                was inserted. Exact: limit 0.
  new_top1      share of the window's inserted rows, still live, that a
                search for their own vector returns first. Its limit is the
                repo's stated floor after churn.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from .reference import Knn, exact_f64


@dataclasses.dataclass
class Compared:
    name: str
    value: float
    limit: float
    sense: str            # "<=" or ">=": the value must be on this side

    @property
    def ok(self) -> bool:
        if not np.isfinite(self.value):
            return False
        return (self.value <= self.limit if self.sense == "<="
                else self.value >= self.limit)

    def line(self) -> str:
        return (f"compared {self.name} {self.value!r} limit "
                f"{self.sense} {self.limit!r} {'ok' if self.ok else 'FAIL'}")

    def entry(self) -> dict:
        return {"value": self.value, "limit": f"{self.sense} {self.limit!r}"}


def answer_numbers(ids: np.ndarray, qidx: np.ndarray, queries: torch.Tensor,
                   ref: Knn, live_pos: torch.Tensor, store: torch.Tensor,
                   k: int, metric: str = "l2",
                   block: int = 8192) -> Dict[str, float]:
    """bad_answers, recall10 and order_gap of answers ``ids`` [R, k]
    (program ids; row r answers query ``qidx[r]``). ``live_pos`` [C] maps a
    program id to its position among the live rows the reference searched
    (−1: not live); ``store`` [C, D] holds the benchmark's copy of each
    id's vector."""
    dev = queries.device
    cap = live_pos.shape[0]
    n_live = int((live_pos >= 0).sum())
    bad = hits = 0
    kinds = {"missing": 0, "not_live": 0, "repeated": 0}
    gap = 0.0
    for lo in range(0, ids.shape[0], block):
        a = torch.as_tensor(ids[lo:lo + block].astype(np.int64), device=dev)
        qi = torch.as_tensor(qidx[lo:lo + block].astype(np.int64), device=dev)
        in_range = (a >= 0) & (a < cap)
        safe = torch.where(in_range, a, torch.zeros_like(a))
        pos = torch.where(in_range, live_pos[safe], torch.full_like(a, -1))
        missing = (a == -1) & (n_live >= k)
        wrong = (a != -1) & (pos < 0)
        srt = torch.sort(a, dim=1).values
        dup = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(1)
        bad += int((missing.any(1) | wrong.any(1) | dup).sum())
        kinds["missing"] += int(missing.any(1).sum())
        kinds["not_live"] += int(wrong.any(1).sum())
        kinds["repeated"] += int(dup.sum())
        ref_pos = ref.ids[qi]                                   # [b, k]
        hits += int((pos[:, :, None] == ref_pos[:, None, :])
                    .any(2).sum())
        d = exact_f64(queries[qi], store[safe], metric)          # [b, k]
        ok = pos >= 0
        step = torch.where(ok[:, :-1] & ok[:, 1:], d[:, :-1] - d[:, 1:],
                           torch.zeros_like(d[:, 1:]))
        scale = torch.maximum(ref.dists[qi, 0].abs(),
                              ref.dists[qi, k - 1].abs()).clamp(min=1e-12)
        gap = max(gap, float((step.clamp(min=0).max(1).values / scale)
                             .max()))
    return {"bad_answers": float(bad),
            "recall10": hits / float(ids.shape[0] * k),
            "order_gap": gap, "bad_kinds": kinds}


def recall_limit(limits: dict, recall_floor: float) -> float:
    """The cell's recall limit from its readings, never under the floor
    the configuration states (the floor alone where no reading set one)."""
    return max(float(limits.get("recall10", {}).get("limit", 0.0)),
               float(recall_floor))


def compared(numbers: Dict[str, float], limits: dict,
             recall_floor: float) -> List[Compared]:
    out = [Compared("bad_answers", numbers["bad_answers"], 0.0, "<="),
           Compared("recall10", numbers["recall10"],
                    recall_limit(limits, recall_floor), ">="),
           Compared("order_gap", numbers["order_gap"],
                    float(limits["order_gap"]["limit"]), "<=")]
    if "bad_inserts" in numbers:
        out.append(Compared("bad_inserts", numbers["bad_inserts"], 0.0,
                            "<="))
    if "new_top1" in numbers:
        out.append(Compared("new_top1", numbers["new_top1"],
                            float(limits["new_top1"]["limit"]), ">="))
    return out


def check_inserted(ids_per_step: List[np.ndarray], first_new: int,
                   capacity: int) -> int:
    """Insert ids that are −1, out of range, repeated, or below the first
    id the index could hand out (``first_new``, the rows fitted)."""
    if not ids_per_step:
        return 0
    ids = np.concatenate(ids_per_step).astype(np.int64)
    bad = int(((ids < first_new) | (ids >= capacity)).sum())
    ok = ids[(ids >= first_new) & (ids < capacity)]
    return bad + int(ok.size - np.unique(ok).size)


def new_top1(ids: np.ndarray, own: np.ndarray) -> Optional[float]:
    """Share of rows whose own id comes first in its answer."""
    if own.size == 0:
        return None
    return float((ids[:, 0] == own).mean())
