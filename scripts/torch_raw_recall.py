#!/usr/bin/env python3
"""Recall@10 of the port's default raw hnsw index on the data of the JAX
package's sweeps, for a reading beside ``scripts/sweep.py``'s.

    python3 scripts/torch_raw_recall.py --n 100000 [--nq 1000] [--ef 64]
        [--device cpu] [--threads 4] [--out FILE.json]

Fits ``hnsw`` with the defaults (max_nbrs 32, ef_construction 200,
prune_alpha 1.0) on ``random_dataset(n x 128, n_queries=nq, seed 42, one
cluster per 2000 rows)``, the data ``scripts/sweep.py --n N --nq NQ``
draws, and prints the fit seconds and recall@10 against exact ground truth
at each ef. The JAX reading on the same rows and queries:
``JAX_PLATFORMS=cpu python scripts/sweep.py --n N --dim 128 --index hnsw
--nq NQ --efs 64``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--nq", type=int, default=1000)
    p.add_argument("--ef", type=int, nargs="+", default=[64])
    p.add_argument("--device", default="cuda")
    p.add_argument("--threads", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args()

    import torch

    if args.threads:
        torch.set_num_threads(args.threads)
    sys.path.insert(0, ROOT)
    from alayalite_tpu_torch import Index, IndexParams
    from alayalite_tpu_torch.utils.datasets import random_dataset
    from alayalite_tpu_torch.utils.evaluate import calc_gt, calc_recall

    ds = random_dataset(n=args.n, dim=128, n_queries=args.nq, seed=42,
                        clusters=max(32, args.n // 2000))
    gt = calc_gt(ds.data, ds.queries, 10, device="cpu")
    idx = Index("raw", IndexParams(index_type="hnsw", capacity=args.n),
                device=args.device)
    t = time.time()
    idx.fit(ds.data)
    fit_s = time.time() - t
    out = {"n": args.n, "nq": args.nq, "device": args.device,
           "fit_s": fit_s, "phases": dict(idx._engine.build_timings),
           "recall": {}}
    for ef in args.ef:
        ids = idx.batch_search(ds.queries, 10, ef_search=ef)
        out["recall"][ef] = calc_recall(ids, gt)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
