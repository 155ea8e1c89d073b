#!/usr/bin/env python3
"""Why does the default raw hnsw index read lower recall at 1M rows?
``python3 scripts/torch_raw_probe.py [rows]`` (default 1,000,000).

Fits raw ``hnsw`` (quantization none, max_nbrs 32, ef_construction 200) on
one GPU over ``random_dataset(rows x 128, seed 42, one cluster per 2000
rows)`` with prune_alpha 1.0 (the default) and 1.2 (the bsq8 headline's),
and prints for each: fit seconds; the mean out-degree the prune leaves; how
far the overlay descent's seed lies from the query, as the median over
queries of seed distance / distance of the 10th true neighbour; recall@10
of 8192 queries at ef 32, 64, 96 and 128 with the default hop budget
(``search_iters`` 0 = max(8, ef / 8 + 4)) and with 24 and 48 hops. Writes
the table to build/torch_raw_probe.json. Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM, NQ, K = 128, 8192, 10
EFS = (32, 64, 96, 128)
ITERS = (0, 24, 48)


def ground_truth(torch, data, queries):
    """(ids [Q, K], squared l2 distances [Q, K]) of the exact neighbours."""
    x_sq = (data * data).sum(1)
    ids, dist = [], []
    for lo in range(0, queries.shape[0], 1024):
        q = queries[lo:lo + 1024]
        d = x_sq[None, :] - 2.0 * (q @ data.T) + (q * q).sum(1, keepdim=True)
        top = torch.topk(d, K, dim=1, largest=False)
        ids.append(top.indices)
        dist.append(top.values)
    return torch.cat(ids).cpu().numpy(), torch.cat(dist)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_raw_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from alayalite_tpu_torch import Client
    from alayalite_tpu_torch.index.search import graph_seeds
    from alayalite_tpu_torch.utils.datasets import random_dataset
    from alayalite_tpu_torch.utils.evaluate import calc_recall

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    ds = random_dataset(n=n, dim=DIM, n_queries=NQ, seed=42,
                        clusters=max(32, n // 2000))
    q_dev = torch.as_tensor(ds.queries, device=dev)
    gt, gt_d = ground_truth(torch, torch.as_tensor(ds.data, device=dev),
                            q_dev)
    report = {"card": card, "rows": n, "runs": {}}
    for alpha in (1.0, 1.2):
        idx = Client().create_index(f"a{alpha}", index_type="hnsw",
                                    capacity=n, prune_alpha=alpha)
        torch.cuda.synchronize()
        t = time.time()
        idx.fit(ds.data)
        torch.cuda.synchronize()
        eng = idx._engine
        run = {"fit_s": time.time() - t,
               "mean_degree": float((eng.graph.nbrs[:n] >= 0).sum(1).float()
                                    .mean()),
               "recall": {}}
        seeds = graph_seeds(eng.space, eng.graph.eps, eng.graph.overlay,
                            eng.space.prep_query(q_dev))[:, 0].long()
        seed_d = ((eng.space.data[seeds].float() - q_dev) ** 2).sum(1)
        run["seed_over_10th_nn_median"] = float(
            (seed_d / gt_d[:, K - 1].clamp_min(1e-12)).median())
        print(f"alpha {alpha}: fit {run['fit_s']:.1f}s, mean degree "
              f"{run['mean_degree']:.2f}, seed distance / 10th neighbour's "
              f"(median) {run['seed_over_10th_nn_median']:.2f}", flush=True)
        for iters in ITERS:
            eng.params.search_iters = iters
            for ef in EFS:
                idx.batch_search(ds.queries, K, ef_search=ef)     # warm-up
                torch.cuda.synchronize()
                t = time.time()
                ids = idx.batch_search(ds.queries, K, ef_search=ef)
                torch.cuda.synchronize()
                wall = time.time() - t
                rec = calc_recall(ids, gt)
                run["recall"][f"iters{iters}_ef{ef}"] = {
                    "recall": rec, "qps": NQ / wall}
                print(f"  hops {iters or 'default'} ef {ef}: recall@10 "
                      f"{rec:.4f}, {NQ / wall:.0f} QPS", flush=True)
        report["runs"][str(alpha)] = run
        del idx, eng
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "torch_raw_probe.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
