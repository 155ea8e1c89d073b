#!/usr/bin/env python3
"""The flat exact search's ids on chip_smoke.py's data, written to a .npy, so
that two checkouts can be held against each other (a merge kernel that is
exact must leave them equal): ``python3 scripts/torch_flat_ids.py --out
A.npy [--root DIR]`` imports the port from DIR (default: this checkout),
fits a flat index on random_dataset(1M x 128, 8192 queries, seed 42, 500
clusters) and searches the queries, k = 10; ``--compare A.npy B.npy``
prints how many ids differ. Needs one CUDA device for the search.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, DIM, NQ, K = 1_000_000, 128, 8192, 10


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--compare", nargs=2, metavar="IDS.npy")
    args = ap.parse_args()
    if args.compare:
        a, b = (np.load(p) for p in args.compare)
        print(json.dumps({"shape": list(a.shape),
                          "differing_ids": int((a != b).sum())}))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_flat_ids: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from alayalite_tpu_torch import Client
    from alayalite_tpu_torch.utils.datasets import random_dataset

    ds = random_dataset(n=N, dim=DIM, n_queries=NQ, seed=42,
                        clusters=max(32, N // 2000))
    idx = Client().create_index("flat", index_type="flat",
                                quantization_type="sq8", capacity=N)
    idx.fit(ds.data)
    np.save(args.out, idx.batch_search(ds.queries, K))
    return 0


if __name__ == "__main__":
    sys.exit(main())
