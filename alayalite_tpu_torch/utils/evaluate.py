"""Recall / ground-truth helpers (port of ``alayalite_tpu/utils/evaluate.py``).

``calc_gt`` runs on the device, ``cuda`` unless the caller names another,
as every entry point of the port does: exact through
``ops.distance.exact_topk`` (the ``l2_tile`` kernel for l2), or with
``fast=True`` through ``flat_search_device`` (a bf16 coarse scan keeping
``max(256, 16·topk)`` candidates per query, then an f32 rerank; about
0.999 of the exact ids). With ``device="cpu"`` and without ``fast`` it is
exact brute force in float64 numpy, chunked over queries: the tests'
reference, independent of the port's kernels.
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
    fast: bool = False,
    device=None,
) -> np.ndarray:
    """Top-k ids (l2: squared distance, ip: −q·x, cos: −cos), skipping
    ``deleted`` ids: exact, or with ``fast`` the two-stage bf16 scan, on
    ``device`` (``cuda`` by default; float64 numpy for an exact
    ``device="cpu"``). ``data`` and ``queries`` may be device tensors on
    the device path."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if fast or dev.type != "cpu":
        return _calc_gt_device(data, queries, topk, metric, deleted, fast,
                               dev)
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


def _calc_gt_device(data, queries, topk: int, metric: str, deleted,
                    fast: bool, device) -> np.ndarray:
    import torch

    from ..ops.distance import (exact_topk, flat_search_device,
                                normalize_rows, sqnorms)

    dev = torch.device(device)

    def put(a):
        if isinstance(a, torch.Tensor):
            return a.to(dev, torch.float32)
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    x, q = put(data), put(queries)
    valid = None
    if deleted is not None:
        dead = np.asarray(list(deleted), dtype=np.int64)
        valid = torch.ones((x.shape[0],), dtype=torch.bool, device=dev)
        if dead.size:
            valid[torch.as_tensor(dead, device=dev)] = False
    if not fast:
        _, ids = exact_topk(q, x, topk, metric=metric, valid=valid)
        return ids.cpu().numpy()
    if metric == "cos":
        x, q, metric = normalize_rows(x), normalize_rows(q), "ip"
    _, ids = flat_search_device(q, x, sqnorms(x), valid, k=topk,
                                metric=metric,
                                tile_n=min(65536, max(x.shape[0], 1)),
                                rerank=max(256, 16 * topk))
    return ids.cpu().numpy()
