"""Recall / ground-truth helpers (numpy copy of ``alayalite_tpu/utils/evaluate.py``).

``calc_gt`` is exact brute force in float64 numpy, chunked over queries; it
is meant for the small inputs of tests and examples. Large ground truth is
computed on the device by the caller.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np


def calc_recall(results: Sequence[Sequence[int]], gt: Sequence[Sequence[int]],
                k: Optional[int] = None) -> float:
    """Mean |results ∩ gt| / k over queries."""
    results = np.asarray(results)
    gt = np.asarray(gt)
    if k is None:
        k = results.shape[1]
    total = 0.0
    for r, g in zip(results, gt):
        total += len(set(int(x) for x in r[:k]) & set(int(x) for x in g[:k]))
    return total / (len(results) * k)


def calc_gt(
    data: np.ndarray,
    queries: np.ndarray,
    topk: int,
    metric: str = "l2",
    deleted: Optional[Iterable[int]] = None,
    chunk: int = 1024,
) -> np.ndarray:
    """Exact top-k ids (l2: squared distance, ip: −q·x, cos: −cos),
    skipping ``deleted`` ids."""
    x = np.asarray(data, dtype=np.float64)
    q = np.asarray(queries, dtype=np.float64)
    if metric == "cos":
        x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
        metric = "ip"
    x_sq = (x * x).sum(1)
    out = np.empty((q.shape[0], topk), dtype=np.int32)
    dead = (None if deleted is None
            else np.asarray(list(deleted), dtype=np.int64))
    for lo in range(0, q.shape[0], chunk):
        qc = q[lo:lo + chunk]
        dot = qc @ x.T
        d = -dot if metric == "ip" else x_sq[None, :] - 2.0 * dot
        if dead is not None and dead.size:
            d[:, dead] = np.inf
        out[lo:lo + chunk] = np.argsort(d, axis=1, kind="stable")[:, :topk]
    return out
