#!/usr/bin/env python3
"""A fit's seconds by phase, captured against uncaptured, on one GPU:
``python3 scripts/torch_fit_phases.py [--repeats 2]``.

Fits three indices on bench.py's synthetic SIFT1M stand-in
(``random_dataset(1,000,000, 128, seed 42, 500 clusters)``): hnsw + bsq8
with the repository's headline parameters (``chip_smoke.py`` phase 4), raw
hnsw with the defaults (phase 6c) and the frontier's 1-bit rabitq
(``hnsw_rabitq_R32_efc200``, phase 15). Each is fitted captured (every
build phase one replay a chunk, a round or a loop block, as the entry
point runs it) and uncaptured (inside ``captured.eager()``), in turns:
captured first on even repeats, uncaptured first on odd ones. For each fit
it prints one JSON line: seconds, seconds of each build phase (the
builder's ``build_timings``: knn, pools, prune, reverse_reprune, repair,
...), graphs captured and graphs held after the fit, memory allocated,
peak reserved and reserved after ``torch.cuda.empty_cache()`` (GiB, above
the reserved before the fit), and whether the adjacency equals that of
the other mode's fit of the same repeat. The kernels are built before the
first fit. Writes every line to build/torch_fit_phases.json. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, DIM, SPARE = 1_000_000, 128, 16_384
CONFIGS = {
    "bsq8": dict(index_type="hnsw", quantization_type="bsq8", max_nbrs=32,
                 ef_construction=200, prune_alpha=1.2, seed_sample=16384,
                 beam_expand=8),
    "raw_hnsw": dict(index_type="hnsw"),
    "rabitq": dict(index_type="hnsw", quantization_type="rabitq",
                   max_nbrs=32, ef_construction=200, prune_alpha=1.0,
                   seed_sample=4096, rabitq_ef_boost=4.0, beam_expand=8),
}


def fit_once(torch, name: str, data, capture: bool) -> dict:
    from alayalite_tpu_torch import Index, IndexParams
    from alayalite_tpu_torch.index import captured

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    idx = Index(name, IndexParams(**CONFIGS[name], capacity=N + SPARE))
    s0 = dict(captured.stats)
    t = time.time()
    with contextlib.nullcontext() if capture else captured.eager():
        idx._engine.fit(data, ef_construction=100)
    torch.cuda.synchronize()
    rep = {"index": name, "captured": capture, "seconds": time.time() - t,
           "phases": dict(idx._engine.build_timings),
           "graphs_captured": captured.stats["captures"] - s0["captures"],
           "capture_s": captured.stats["capture_s"] - s0["capture_s"],
           "graphs_held": captured.held(),
           "peak_reserved_gib": (torch.cuda.max_memory_reserved() - base)
           / 2**30}
    gc.collect()
    torch.cuda.empty_cache()
    rep.update(allocated_gib=torch.cuda.memory_allocated() / 2**30,
               held_reserved_gib=(torch.cuda.memory_reserved() - base)
               / 2**30)
    nbrs = idx._engine.graph.nbrs.clone()
    del idx
    return rep, nbrs


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fit_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from alayalite_tpu_torch.ops import _build
    from alayalite_tpu_torch.utils.datasets import random_dataset
    from alayalite_tpu_torch.utils.timing import card_line

    card = card_line()
    print(f"card: {card}", flush=True)
    _build.build()
    data = random_dataset(n=N, dim=DIM, n_queries=1, seed=42,
                          clusters=N // 2000).data
    lines = []
    for rep_i in range(args.repeats):
        for name in CONFIGS:
            order = (True, False) if rep_i % 2 == 0 else (False, True)
            graphs = {}
            for mode in order:
                rep, graphs[mode] = fit_once(torch, name, data, mode)
                rep.update(repeat=rep_i, card=card)
                if len(graphs) == 2:
                    rep["adjacency_equal_to_other_mode"] = bool(
                        torch.equal(graphs[True], graphs[False]))
                lines.append(rep)
                print(json.dumps(rep), flush=True)
            del graphs
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "torch_fit_phases.json"),
              "w") as f:
        json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
