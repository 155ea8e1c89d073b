#!/usr/bin/env python3
"""Recall@10 and the insert's own top-1 of the 1-bit rabitq index of
``results/sift1m_frontier.json`` (``hnsw_rabitq_R32_efc200``), in either
package, on the same rows.

    python3 scripts/torch_rabitq_recall.py --n 100000 [--nq 1000]
        [--ef 48 64 96] [--insert 1000] [--device cpu] [--threads 4]
        [--save DIR] [--load DIR] [--paired DIR] [--build-seed S] [--stats]
        [--out FILE.json]

Fits ``hnsw`` + ``rabitq`` (max_nbrs 32, ef_construction 200, prune_alpha
1.0, seed_sample 4096, rabitq_ef_boost 4, beam_expand 8) on
``random_dataset(n x 128, n_queries=nq, seed 42, one cluster per 2000
rows)`` and prints the fit seconds and recall@10 against exact ground truth
at each ef, with the frontier's hop budget ``max(3, ef // 8)``. Then it
inserts ``--insert`` rows drawn from the data's clusters and reads each new
row's own top-1 at ef 64.

This script runs the port on ``--device``. The JAX package's reading on
the same rows: ``JAX_PLATFORMS=cpu python3 scripts/rabitq_recall_jax.py``
with the same arguments (on the CPU ``approx_max_k`` is exact, so the two
packages differ only in their builds). ``--save DIR``
writes the fitted index (before the insert); ``--load DIR`` searches an
index directory of either package instead of fitting, so the port can
search the JAX package's graph. ``--paired DIR`` also searches the index
in DIR on the same queries and reports, at each ef, the mean of the
per-query recall differences (this index minus DIR's) and its standard
error. ``--build-seed S`` sets the port's build seed (``index.qg.SEED``:
NN-Descent, the pools, the reverse edges, the extra entry points).
``--stats`` adds the graph's out-degree and the share of live rows
reachable from the entry points.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import deque

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = dict(index_type="hnsw", quantization_type="rabitq", max_nbrs=32,
              ef_construction=200, prune_alpha=1.0, seed_sample=4096,
              rabitq_ef_boost=4.0, beam_expand=8)


def cluster_rows(rng, n: int, n_base: int, dim: int) -> np.ndarray:
    """``n`` new rows from the clusters of random_dataset(n_base, dim,
    seed=42), which draws its centers first from that seed."""
    clusters = max(32, n_base // 2000)
    centers = (np.random.default_rng(42).normal(size=(clusters, dim))
               .astype(np.float32) * 4.0)
    return (centers[rng.integers(0, clusters, size=n)]
            + rng.normal(size=(n, dim)).astype(np.float32))


def host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def exact_gt(data: np.ndarray, queries: np.ndarray, k: int) -> np.ndarray:
    """Exact top-k ids by squared L2, float64 numpy, in query slices."""
    d64 = data.astype(np.float64)
    norms = (d64 * d64).sum(1)
    out = []
    for lo in range(0, queries.shape[0], 256):
        q = queries[lo:lo + 256].astype(np.float64)
        d = norms[None, :] - 2.0 * q @ d64.T
        part = np.argpartition(d, k, axis=1)[:, :k]
        order = np.argsort(np.take_along_axis(d, part, 1), axis=1,
                           kind="stable")
        out.append(np.take_along_axis(part, order, 1))
    return np.concatenate(out)


def graph_stats(nbrs: np.ndarray, eps: np.ndarray, n: int) -> dict:
    """Mean / min out-degree of the first n rows and the share of them a
    breadth-first walk from the entry points reaches."""
    nbrs = nbrs[:n]
    deg = (nbrs >= 0).sum(1)
    seen = np.zeros(n, bool)
    todo = deque(int(e) for e in np.unique(eps) if 0 <= e < n)
    for e in todo:
        seen[e] = True
    while todo:
        u = todo.popleft()
        for v in nbrs[u]:
            if 0 <= v < n and not seen[v]:
                seen[v] = True
                todo.append(int(v))
    return {"mean_degree": float(deg.mean()), "min_degree": int(deg.min()),
            "reachable": float(seen.mean())}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--nq", type=int, default=1000)
    p.add_argument("--ef", type=int, nargs="+", default=[48, 64, 96])
    p.add_argument("--insert", type=int, default=1000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--threads", type=int, default=0)
    p.add_argument("--save", default=None)
    p.add_argument("--load", default=None)
    p.add_argument("--paired", default=None)
    p.add_argument("--build-seed", type=int, default=None)
    p.add_argument("--stats", action="store_true")
    p.add_argument("--out", default=None)
    return p.parse_args(argv)


def per_query_recall(ids: np.ndarray, gt: np.ndarray) -> np.ndarray:
    return np.array([np.isin(a, b).sum() / b.size for a, b in zip(ids, gt)])


def run(args, impl: str, Index, IndexParams, random_dataset, calc_recall,
        kw: dict) -> dict:
    """Fit (or load), search at each ef, insert; print and return the
    readings. ``Index`` and the helpers are the package's under test."""
    ds = random_dataset(n=args.n, dim=128, n_queries=args.nq, seed=42,
                        clusters=max(32, args.n // 2000))
    gt = exact_gt(ds.data, ds.queries, 10)
    out = {"impl": impl, "n": args.n, "nq": args.nq, "recall": {}}
    t = time.time()
    if args.load:
        parent, name = os.path.split(os.path.abspath(args.load))
        idx = Index.load(parent, name, **kw)
        out["loaded"] = args.load
    else:
        idx = Index("rq", IndexParams(capacity=args.n + args.insert,
                                      **PARAMS), **kw)
        idx.fit(ds.data)
    out["fit_s"] = time.time() - t
    eng = idx._engine
    if args.save:
        eng.save(args.save)
    if args.stats:
        g = eng.graph
        out["graph"] = graph_stats(host(g.nbrs), host(g.eps), args.n)
    other = None
    if args.paired:
        parent, name = os.path.split(os.path.abspath(args.paired))
        other = Index.load(parent, name, **kw)
        out["paired"] = {"with": args.paired}
    for ef in args.ef:
        eng.params.search_iters = max(3, ef // 8)
        ids = np.asarray(idx.batch_search(ds.queries, 10, ef_search=ef))
        out["recall"][ef] = calc_recall(ids, gt)
        line = {"ef": ef, "recall": out["recall"][ef]}
        if other is not None:
            other._engine.params.search_iters = max(3, ef // 8)
            diff = (per_query_recall(ids, gt) - per_query_recall(
                np.asarray(other.batch_search(ds.queries, 10, ef_search=ef)),
                gt))
            line.update(mean_diff=float(diff.mean()),
                        stderr=float(diff.std(ddof=1) / np.sqrt(diff.size)))
            out["paired"][ef] = line
        print(json.dumps(line), flush=True)
    if args.insert:
        new = cluster_rows(np.random.default_rng(15), args.insert, args.n,
                           128).astype(np.float32)
        eng.params.search_iters = max(3, 64 // 8)
        t = time.time()
        new_ids = np.asarray(idx.insert(new))
        out["insert_s"] = time.time() - t
        own = np.asarray(idx.batch_search(new, 1, ef_search=64))[:, 0]
        out["insert_own_top1"] = float((own == new_ids).mean())
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


def main() -> int:
    args = parse_args()
    import torch

    if args.threads:
        torch.set_num_threads(args.threads)
    sys.path.insert(0, ROOT)
    from alayalite_tpu_torch import Index, IndexParams
    from alayalite_tpu_torch.index import qg

    if args.build_seed is not None:
        qg.SEED = args.build_seed
    from alayalite_tpu_torch.utils.datasets import random_dataset
    from alayalite_tpu_torch.utils.evaluate import calc_recall

    run(args, "torch", Index, IndexParams, random_dataset, calc_recall,
        {"device": args.device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
