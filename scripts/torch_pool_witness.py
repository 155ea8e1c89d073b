#!/usr/bin/env python3
"""Does the build's pool mode cost recall? ``python3 scripts/torch_pool_witness.py``.

Fits the main-path index (hnsw + bsq8, the headline parameters) on one GPU
at n = 300,000 x 128 twice per dataset: once with the candidate pools the
size gate picks there ("block": block searches that run ``block_diagdot``)
and once with the pools it picks below 250k rows ("beam": beam searches
over the bf16 raw vectors). The datasets are ``random_dataset(seed=42)``
with 32 clusters (the generator's default) and with one cluster per 2000
rows (bench.py's rule, 150 clusters here). Prints recall@10 of 8192
queries at ef 32, 64 and 128 against exact ground truth made on the card,
and the fit seconds; writes the table to build/torch_pool_witness.json.
Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, DIM, NQ, K = 300_000, 128, 8192, 10
EFS = (32, 64, 128)
HEADLINE = dict(index_type="hnsw", quantization_type="bsq8", max_nbrs=32,
                ef_construction=200, prune_alpha=1.2, seed_sample=16384,
                beam_expand=8, capacity=N)


def ground_truth(torch, data, queries):
    x_sq = (data * data).sum(1)
    out = []
    for lo in range(0, queries.shape[0], 1024):
        q = queries[lo:lo + 1024]
        d = x_sq[None, :] - 2.0 * (q @ data.T)
        out.append(torch.topk(d, K, dim=1, largest=False).indices)
    return torch.cat(out).cpu().numpy()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_pool_witness: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from alayalite_tpu_torch import IndexParams
    from alayalite_tpu_torch.index.engine import IndexEngine
    from alayalite_tpu_torch.index.qg import QGBuilder
    from alayalite_tpu_torch.spaces.bqg import BQGSpace
    from alayalite_tpu_torch.spaces.raw import RawSpace
    from alayalite_tpu_torch.utils.datasets import random_dataset
    from alayalite_tpu_torch.utils.evaluate import calc_recall

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    params = IndexParams(**HEADLINE)
    dev = torch.device("cuda")
    rows = []
    for clusters in (32, N // 2000):
        ds = random_dataset(n=N, dim=DIM, n_queries=NQ, seed=42,
                            clusters=clusters)
        x = torch.as_tensor(ds.data, device=dev)
        gt = ground_truth(torch, x, torch.as_tensor(ds.queries, device=dev))
        for mode in ("block", "beam"):
            torch.cuda.synchronize()
            t = time.time()
            raw = RawSpace.create(N, DIM, device=dev).fit(x)
            bqg = BQGSpace.create(N, DIM, degree=params.max_nbrs,
                                  device=dev).fit(x)
            builder = QGBuilder(r=params.max_nbrs,
                                ef=max(params.ef_construction, 128),
                                alpha=float(params.prune_alpha),
                                pool_mode=mode)
            graph, bqg = builder.build_graph(raw, bqg, N)
            torch.cuda.synchronize()
            fit_s = time.time() - t
            eng = IndexEngine(params, device=dev)
            eng.space, eng.search_space, eng.graph = raw, bqg, graph
            eng._fitted = True
            rec = {ef: calc_recall(eng.batch_search(ds.queries, K, ef=ef),
                                   gt) for ef in EFS}
            row = {"clusters": clusters, "pools": mode, "fit_s": fit_s,
                   "phases": dict(builder.timings), "recall": rec}
            rows.append(row)
            print(f"clusters={clusters} pools={mode}: fit {fit_s:.2f}s, "
                  + ", ".join(f"recall@10 ef={ef} {r:.4f}"
                              for ef, r in rec.items()), flush=True)
            del eng, raw, bqg, graph
        del x
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "torch_pool_witness.json"),
              "w") as f:
        json.dump({"card": card, "n": N, "dim": DIM, "queries": NQ,
                   "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
