#!/usr/bin/env python3
"""Recall of a benchmark cell's index at several ef, one fit a seed:

    python3 scripts/torch_cell_ef.py --workload gist-bsq8-batch \
        --seeds 11,12,13 [--efs 32,48,64,96,128] [--rehearse] [--out FILE]

For each seed the cell's data is made and its index fitted as
``portbench/run.py`` makes and fits them (same generator streams, same
parameters), the fit timed and its peak device memory read. Then every
query of the configuration is searched through ``Index.batch_search`` once
at each ef of ``--efs``, the index is freed, and each answer is judged by
``portbench/judge.py`` against ``portbench/reference.py``: ``recall10``,
``order_gap`` and ``bad_answers`` an ef, beside the SHA-256 of each
answer's ids and distances (two checkouts give the same bits where these
agree). One JSON line a seed on standard output (and appended to
``--out``). The ef rule of a configuration and the
search planted at half its ef read these lines; a benchmark run does not.

``--rehearse`` runs at the configuration's rehearsal sizes on the CPU.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def one_seed(workload: str, seed: int, efs, rehearse: bool) -> dict:
    from portbench import data as data_mod
    from portbench import judge, reference, spec
    from portbench import run as runmod

    cell = spec.cell(workload)
    if rehearse:
        runmod.rehearsal(cell)
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", 0)
    cfg = cell.config
    data = data_mod.make(cfg["data"], seed, device)
    k = int(cfg["search"]["topk"])
    metric = str(cfg["index"].get("metric", "l2"))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    idx = runmod.build_index(cell, device)
    idx.fit(data.base, ef_construction=int(cfg["fit"]["ef_construction"]))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out = {"workload": workload, "seed": seed,
           "fit_s": time.perf_counter() - t,
           "fit_phases_s": dict(idx._engine.build_timings)}
    if device.type == "cuda":
        out["fit_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    q_host = data.queries.cpu().numpy()
    answers = {}
    for ef in efs:
        idx.batch_search(q_host, k, ef_search=ef)          # warm the shape
        t = time.perf_counter()
        ids, dists = idx.batch_search_with_distance(q_host, k, ef_search=ef)
        out.setdefault("call_s", {})[ef] = time.perf_counter() - t
        out.setdefault("answers_sha256", {})[ef] = hashlib.sha256(
            ids.tobytes() + dists.tobytes()).hexdigest()
        answers[ef] = ids
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    del idx
    gc.collect()
    if device.type == "cuda":
        from alayalite_tpu_torch.index import captured

        captured.clear()
        torch.cuda.empty_cache()
    ref = reference.knn(data.base, data.queries, k, metric)
    live = torch.arange(data.base.shape[0], device=device)
    qidx = np.arange(q_host.shape[0])
    out["judged"] = {}
    for ef, ids in answers.items():
        r = judge.answer_numbers(ids, qidx, data.queries, ref, live,
                                 data.base, k, metric)
        out["judged"][ef] = {n: r[n] for n in ("recall10", "order_gap",
                                               "bad_answers")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--efs", default="32,48,64,96,128")
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not args.rehearse and not torch.cuda.is_available():
        print("no CUDA device (--rehearse runs on the CPU)", file=sys.stderr)
        return 2
    efs = [int(e) for e in args.efs.split(",")]
    for seed in args.seeds.split(","):
        line = json.dumps(one_seed(args.workload, int(seed), efs,
                                   args.rehearse))
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
