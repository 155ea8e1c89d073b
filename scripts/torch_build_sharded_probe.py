#!/usr/bin/env python3
"""Recall@10 of the port's ring-rotating sharded build (``build_shards``)
against its long-edge slots, beside the single-device build.

    python3 scripts/torch_build_sharded_probe.py [--n 100000] [--dim 64]
        [--clusters 64] [--shards 8] [--variants 8:8 16:16 16:64]
        [--seeds 0 1 2] [--device cuda] [--out FILE.json]

Fits ``hnsw`` (max_nbrs 24, ef_construction 96: the index of
``results/sharded_build_100k.json``) on ``random_dataset(n x dim,
n_queries=1024, seed 42, clusters)`` with ``build_shards`` shards placed on
one device (``platforms.force_devices``), once for each long-slot variant
``N_LONG:LONG_DRAW`` (the nearest N_LONG of LONG_DRAW random rows; the JAX
package's pools hold 8 random rows, ``8:8``) and each build seed, then the
single-device control once. Prints the fit seconds, the build phases'
seconds and recall@10 at ef 48 / 64 / 96 against exact ground truth, with
the card line where the device is CUDA.

    python3 scripts/torch_build_sharded_probe.py --serve 4 --n 1000000
        --dim 128 --clusters 500

fits one ``serve_shards=4`` hnsw index with the defaults instead (the
sharded build, the host repair over the sharded slab, the seed sample)
and prints its fit seconds, phases, repair rounds and recall@10.

``--knn`` adds, for every sharded build, the NN-Descent rounds' changed
counts and the recall of the kNN rows the rounds leave (k 32) on 2,000
sampled rows against their exact 32 nearest.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EFS = (48, 64, 96)
PARAMS = dict(index_type="hnsw", max_nbrs=24, ef_construction=96)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--clusters", type=int, default=64)
    p.add_argument("--shards", type=int, default=8)
    p.add_argument("--variants", nargs="+", default=["8:8", "16:16", "16:64"])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--serve", type=int, default=0,
                   help="fit one serve_shards=N index with the defaults")
    p.add_argument("--knn", action="store_true",
                   help="report the NN-Descent rounds' kNN recall")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args()

    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import alayalite_tpu_torch.parallel.build_sharded as bs
    from alayalite_tpu_torch import Index, IndexParams
    from alayalite_tpu_torch.utils import platforms
    from alayalite_tpu_torch.utils.datasets import random_dataset
    from alayalite_tpu_torch.utils.evaluate import calc_recall
    from alayalite_tpu_torch.utils.timing import card_line

    dev = torch.device(args.device)
    card = card_line() if dev.type == "cuda" else "cpu"
    print(f"card: {card}", flush=True)
    ds = random_dataset(n=args.n, dim=args.dim, n_queries=1024, seed=42,
                        clusters=args.clusters, device="cpu")
    q = torch.as_tensor(ds.queries, device=dev)
    x = torch.as_tensor(ds.data, device=dev)
    d2 = (q * q).sum(1)[:, None] + (x * x).sum(1)[None] - 2.0 * q @ x.T
    gt = torch.topk(d2, 10, largest=False).indices.cpu().numpy()
    del q, x, d2
    knn = {}
    if args.knn:
        # the exact 32 nearest of 2,000 sampled rows, and a hook that keeps
        # the kNN rows the descent rounds hand to the pools
        x = torch.as_tensor(ds.data, device=dev)
        samp = np.random.default_rng(0).choice(args.n, 2000, replace=False)
        qs = x[torch.as_tensor(samp, device=dev)]
        d2 = ((qs * qs).sum(1)[:, None] + (x * x).sum(1)[None]
              - 2.0 * qs @ x.T)
        d2[torch.arange(2000, device=dev), torch.as_tensor(samp, device=dev)
           ] = float("inf")
        true = torch.topk(d2, 32, largest=False).indices.cpu().numpy()
        del x, qs, d2
        pools = bs.ShardedGraphBuilder._pools

        def keep_knn(self, dd, sq, ring, ki, *rest):
            rows = torch.cat([t.cpu() for t in ki]).numpy()[samp]
            knn["recall"] = float(np.mean([len(set(a) & set(b)) / 32
                                           for a, b in zip(rows, true)]))
            knn["changed"] = list(self.changed)
            return pools(self, dd, sq, ring, ki, *rest)

        bs.ShardedGraphBuilder._pools = keep_knn

    def fit_and_search(shards: int, **params) -> dict:
        params = params or dict(build_shards=shards, **PARAMS)
        t = time.time()
        with platforms.force_devices(shards, dev.type):
            idx = Index("probe", IndexParams(capacity=args.n, **params),
                        device=dev)
            idx.fit(ds.data)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            fit_s = time.time() - t
            rec = {ef: calc_recall(idx.batch_search(ds.queries, 10,
                                                    ef_search=ef), gt)
                   for ef in EFS}
        got = {"fit_s": fit_s, "phases": dict(idx._engine.build_timings),
               "repair_rounds": getattr(idx._engine, "repair_rounds", None),
               "recall": rec}
        if knn:
            got["knn"] = dict(knn)
            knn.clear()
        return got

    if args.serve:
        got = {"serve_shards": args.serve, "n": args.n,
               **fit_and_search(args.serve, index_type="hnsw",
                                serve_shards=args.serve)}
        print(json.dumps(got), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"card": card, "args": vars(args), "rows": [got]},
                          f, indent=1)
        return 0

    rows = []
    orig = bs.build_graph_sharded
    for variant in args.variants:
        bs.N_LONG, bs.LONG_DRAW = (int(v) for v in variant.split(":"))
        for seed in args.seeds:
            bs.build_graph_sharded = functools.partial(orig, seed=seed)
            got = {"variant": variant, "seed": seed,
                   **fit_and_search(args.shards)}
            rows.append(got)
            print(json.dumps(got), flush=True)
    bs.build_graph_sharded = orig
    single = {"variant": "single", **fit_and_search(1)}
    rows.append(single)
    print(json.dumps(single), flush=True)
    for variant in args.variants:
        got = np.array([[r["recall"][ef] for ef in EFS] for r in rows
                        if r["variant"] == variant])
        print(f"{variant}: recall@10 at ef {EFS} min {got.min(0).round(4)} "
              f"mean {got.mean(0).round(4)}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "args": vars(args), "rows": rows}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
