#!/usr/bin/env python3
"""Where the PyTorch port's time goes on one GPU: ``python3 scripts/torch_profile.py``.

Fits the main-path index (hnsw + bsq8, the headline parameters) on
bench.py's synthetic SIFT1M stand-in (1M x 128, seed 42, 500 clusters),
then traces with ``torch.profiler``:
  - one batch_search of 8192 queries at ef = 64,
  - one build-pool chunk: block_beam_search of 4096 rows at ef = 128,
    12 hops, seeded like the build's pools (scan seeds, the entry point,
    16 random nodes; the scan uses the search's sample),
  - one occlusion-prune chunk: 4096 rows x 160 candidates, alpha 1.2,
    through prune_all_dev as the build runs it (one replay of the chunk's
    captured graph), and the same chunk uncaptured (``captured.eager()``);
  - one insert batch: 4096 new rows drawn from the data's clusters through
    IndexEngine.insert (the search for their edges, the append, the
    re-selection and re-encoding of every touched row: the search's replay,
    the append and the connect step's replay), and one more batch
    uncaptured;
then, on the same fit:
  - one NN-Descent round of its kNN phase (k 32, 31 chunks of 32,991 rows,
    the [chunk, 148, 128] candidate gather a chunk) from the cluster init's
    rows, with the host's read of the round's change count;
  - the connectivity repair of the fit's adjacency as the fit left it
    before the repair (recorded during the fit), from a copy each call;
    both inside one ``captured.scope()`` (the warm-up call captures, the
    traced call replays). For a before / after reading, run each tree's
    own copy of this script;
then, on a raw hnsw index with the default parameters (no quantization;
the bsq8 index freed first) fitted on the same rows:
  - one batch_search of the 8192 queries at ef = 64 (overlay descent, beam
    over the f32 rows, exact re-score), and one pool chunk of its build:
    beam_search of 4096 rows at ef = 128 over the bf16 copy of the rows;
  - one raw insert batch: 4096 rows from the data's clusters through
    IndexEngine.insert (the neighbor search through the bsq8 shadow, packed
    by the warm-up batch; the append; fused_raw_connect's replay; the
    shadow's re-encode; the overlay link), and one more uncaptured;
then, on the 1-bit rabitq index of results/sift1m_frontier.json
(hnsw_rabitq_R32_efc200: max_nbrs 32, ef_construction 200, seed_sample
4096, rabitq_ef_boost 4, beam_expand 8) fitted on the same rows:
  - one batch_search of the 8192 queries at ef = 64 with the frontier's hop
    budget (8 hops; the pool 256 wide after the boost), each hop's
    estimate_many (the packed bits gathered and unpacked, one
    block_diagdot) and the 1-bit result pool;
  - one rabitq insert batch: 4096 rows from the data's clusters (the
    neighbor search, the append, the touched rows re-selected, one
    batched re-quantization);
then, on a flat index over the same rows:
  - one exact flat search of the 8192 queries, k = 10, and one fast-mode
    search, with the device time split into the l2_tile kernel, the top-k
    selection (torch.topk and the merge sorts) and the rest; beside it the
    time to write one [4096, 16384] f32 tile alone (``fill_``), times the
    number of tiles, as a measure of the tile write inside the kernel.
Every search, prune chunk and bsq8 / raw insert slice runs as its entry
point runs it: on the card one replay of a captured CUDA graph
(``index/captured.py``), so the warm-up call of a window captures and the
traced call replays; the kernels inside a replay are listed as any other.
For each window it prints the wall time, the summed device-kernel time and
its share of the wall (the rest is the device idle, waiting on the host),
the kernels with the most device time, and every launch of the port's own
kernels and of the concatenation kernel with its per-launch time. Writes
the tables to build/torch_profile.json. Needs a CUDA device.

``--windows`` picks groups of windows (default all): bsq8 (the search,
pool, prune and insert windows), knn_round, repair, raw, rabitq, flat.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, DIM, NQ, K = 1_000_000, 128, 8192, 10
SELECT = ("topk", "TopK", "radix", "Radix", "sort", "Sort")
# the port's own kernels (and the concatenation), listed in every window
# with their launches and per-launch device time, in the top rows or not
PORT = ("gather_rows_kernel", "pool_merge", "ring_probe", "sort_kv",
        "tile_topk", "l2_tile", "sq8_tile", "CatArray")


def trace(torch, name, fn, top=12) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()                                                   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    rows = []
    for ev in prof.key_averages():
        # device-side kernel events only: the aten ops that launched them
        # report the same time again
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        if dev_us > 0:
            rows.append((ev.key, dev_us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    dev_ms = sum(r[1] for r in rows)
    print(f"[{name}] wall {wall_ms:.3f} ms, device kernels {dev_ms:.3f} ms",
          flush=True)
    for key, ms, count in rows[:top]:
        print(f"  {ms:9.3f} ms {100 * ms / max(dev_ms, 1e-9):5.1f}% "
              f"x{count:<6d} {key[:90]}", flush=True)
    port = [{"name": k, "ms": m, "count": c, "ms_per_launch": m / c}
            for k, m, c in rows if any(p in k for p in PORT)]
    for r in port:
        print(f"  port: {r['ms']:9.3f} ms x{r['count']:<6d} "
              f"{r['ms_per_launch']:.4f} ms a launch  {r['name'][:70]}",
              flush=True)
    return {"wall_ms": wall_ms, "device_ms": dev_ms,
            "kernels": [{"name": k, "ms": m, "count": c}
                        for k, m, c in rows[:top]],
            "port_kernels": port, "split": split(rows)}


def uncaptured(fn):
    """``fn`` as a call that runs it inside ``captured.eager()``."""
    from alayalite_tpu_torch.index import captured

    def call():
        with captured.eager():
            return fn()
    return call


def split(rows) -> dict:
    """Device ms of the flat scan's parts: the l2_tile kernel, selection
    (top-k and sort kernels) and everything else."""
    out = {"l2_tile": 0.0, "select": 0.0, "other": 0.0}
    for key, ms, _ in rows:
        part = ("l2_tile" if "l2_tile" in key else
                "select" if any(s in key for s in SELECT) else "other")
        out[part] += ms
    return out


def flat_windows(torch, ds, dev) -> dict:
    from alayalite_tpu_torch import Index, IndexParams
    from alayalite_tpu_torch.utils.timing import cuda_ms

    out = {}
    q = torch.as_tensor(ds.queries, device=dev)
    for mode in ("exact", "fast"):
        idx = Index("flat", IndexParams(index_type="flat", flat_mode=mode,
                                        capacity=N))
        idx.fit(ds.data)
        res = trace(torch, f"flat {mode} search",
                    lambda: idx._engine._batch_search_impl(q, K))
        parts = res["split"]
        print("  split: " + ", ".join(
            f"{k} {v:.3f} ms ({100 * v / max(res['device_ms'], 1e-9):.1f}%)"
            for k, v in parts.items()), flush=True)
        out[mode] = res
        del idx
        torch.cuda.empty_cache()
    tile = torch.empty((4096, 16384), device=dev)
    tiles = -(-NQ // 4096) * -(-N // 16384)
    write_ms = cuda_ms(lambda: tile.fill_(0.0))
    out["tile_write"] = {"ms_per_tile": write_ms, "tiles": tiles,
                         "ms": write_ms * tiles}
    print(f"[flat exact] tile write alone: {write_ms:.4f} ms x {tiles} "
          f"tiles = {write_ms * tiles:.3f} ms", flush=True)
    return out


def churn_batches(n: int, count: int):
    """``count`` batches of 4096 rows from the data's own clusters
    (random_dataset draws its cluster centers first from the same seed)."""
    clusters = max(32, n // 2000)
    centers = (np.random.default_rng(42).normal(size=(clusters, DIM))
               .astype(np.float32) * 4.0)
    rng = np.random.default_rng(11)
    return iter([centers[rng.integers(0, clusters, size=4096)]
                 + rng.normal(size=(4096, DIM)).astype(np.float32)
                 for _ in range(count)])


def raw_windows(torch, ds, dev) -> dict:
    from alayalite_tpu_torch import Index, IndexParams
    from alayalite_tpu_torch.index.build_phases import bf16_pool_space
    from alayalite_tpu_torch.index.search import beam_search

    idx = Index("raw", IndexParams(index_type="hnsw", capacity=N + 4 * 4096))
    idx.fit(ds.data)
    eng = idx._engine
    out = {"fit_phases": eng.build_timings}
    q = torch.as_tensor(ds.queries, device=dev)
    out["search_ef64"] = trace(
        torch, "raw hnsw search ef=64",
        lambda: eng._batch_search_impl(q, K, 64), top=16)
    pool_space = bf16_pool_space(eng.space)
    rows = eng.space.data[:4096]
    seeds = torch.cat([eng.graph.eps[None, :1].expand(4096, -1),
                       torch.randint(0, N, (4096, 16), device=dev,
                                     dtype=torch.int32)], 1)
    out["pool_chunk"] = trace(
        torch, "raw build pool chunk",
        lambda: beam_search(pool_space, eng.graph.nbrs, seeds, rows, k=128,
                            ef=128, n_expand=8))
    del pool_space
    batches = churn_batches(N, 4)                      # warm-up, traced
    out["insert_batch"] = trace(torch, "raw insert batch (4096 rows)",
                                lambda: eng.insert(next(batches)), top=16)
    out["insert_batch_uncaptured"] = trace(
        torch, "raw insert batch (4096 rows), uncaptured",
        uncaptured(lambda: eng.insert(next(batches))), top=16)
    del idx, eng
    torch.cuda.empty_cache()
    return out


def rabitq_windows(torch, ds, dev) -> dict:
    from alayalite_tpu_torch import Index, IndexParams

    idx = Index("rq", IndexParams(
        index_type="hnsw", quantization_type="rabitq", max_nbrs=32,
        ef_construction=200, prune_alpha=1.0, seed_sample=4096,
        rabitq_ef_boost=4.0, beam_expand=8, search_iters=64 // 8,
        capacity=N + 2 * 4096))
    idx.fit(ds.data)
    eng = idx._engine
    out = {"fit_phases": eng.build_timings}
    q = torch.as_tensor(ds.queries, device=dev)
    out["search_ef64"] = trace(
        torch, "rabitq search ef=64 (8 hops)",
        lambda: eng._batch_search_impl(q, K, 64), top=16)
    batches = churn_batches(N, 2)                      # warm-up, traced
    out["insert_batch"] = trace(torch, "rabitq insert batch (4096 rows)",
                                lambda: eng.insert(next(batches)), top=16)
    del idx, eng
    torch.cuda.empty_cache()
    return out


def knn_round_window(torch, space, n: int) -> dict:
    """One NN-Descent round of the fit's kNN phase, from the cluster
    init's rows (a copy each call), as build_knn_graph runs it, with the
    host's read of the round's change count."""
    from alayalite_tpu_torch.index import captured
    from alayalite_tpu_torch.index import nndescent as nnd
    from alayalite_tpu_torch.index.build_phases import make_generator

    k = 32
    shape = nnd.round_shape(n, k, space.dim)
    n_chunks = -(-n // shape["chunk"])
    kd0, ki0 = nnd._init_cluster_knn(space, n, k, seed=0,
                                     chunk=shape["chunk"])
    gen = make_generator(space.device, 1)

    def one():
        _, _, changes = nnd.nnd_block(space, kd0.clone(), ki0.clone(), gen,
                                      rounds=1, **shape)
        return changes.tolist()

    with captured.scope():                  # the warm-up call captures
        res = trace(torch, f"NN-Descent round ({n_chunks} chunks of "
                    f"{shape['chunk']})", one, top=16)
    res["chunks"], res["chunk"] = n_chunks, shape["chunk"]
    return res


def repair_window(torch, space, nbrs0, ep: int) -> dict:
    """The fit's connectivity repair, from a copy of its input adjacency
    written into one buffer before each call (the captured loops key on
    it)."""
    from alayalite_tpu_torch.index import captured, repair_dev

    buf = torch.empty_like(nbrs0)

    def one():
        return repair_dev.repair_connectivity(space, buf.copy_(nbrs0), ep)

    with captured.scope():                  # the warm-up call captures
        return trace(torch, "connectivity repair", one, top=16)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", nargs="*",
                    default=["bsq8", "knn_round", "repair", "raw", "rabitq",
                             "flat"])
    windows = set(ap.parse_args().windows)

    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from alayalite_tpu_torch import Index, IndexParams
    from alayalite_tpu_torch.utils.datasets import random_dataset
    from alayalite_tpu_torch.utils.timing import card_line

    card = card_line()
    print(f"card: {card}", flush=True)
    ds = random_dataset(n=N, dim=DIM, n_queries=NQ, seed=42,
                        clusters=max(32, N // 2000))
    idx = Index("prof", IndexParams(
        index_type="hnsw", quantization_type="bsq8", max_nbrs=32,
        ef_construction=200, prune_alpha=1.2, seed_sample=16384,
        beam_expand=8, capacity=N + 5 * 4096))
    from alayalite_tpu_torch.index import qg

    real_repair, rec = qg.repair_connectivity, {}

    def recorder(space, nbrs, ep, **kw):
        rec["repair"] = (space, nbrs.clone(), ep)
        return real_repair(space, nbrs, ep, **kw)

    qg.repair_connectivity = recorder
    try:
        idx.fit(ds.data)
    finally:
        qg.repair_connectivity = real_repair
    eng = idx._engine
    out = {"card": card, "fit_phases": eng.build_timings}
    if "knn_round" in windows:
        out["knn_round"] = knn_round_window(torch, eng.space, N)
    if "repair" in windows:
        out["repair"] = repair_window(torch, *rec["repair"])
    del rec
    torch.cuda.empty_cache()
    if "bsq8" in windows:
        bsq8_windows(torch, idx, ds, out)
    dev = eng.device
    del idx, eng
    torch.cuda.empty_cache()
    if "raw" in windows:
        out["raw"] = raw_windows(torch, ds, dev)
    if "rabitq" in windows:
        out["rabitq"] = rabitq_windows(torch, ds, dev)
    if "flat" in windows:
        out["flat"] = flat_windows(torch, ds, dev)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "torch_profile.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    return 0


def bsq8_windows(torch, idx, ds, out: dict) -> None:
    """The bsq8 index's windows: search, pool chunk, prune chunk (captured
    and uncaptured), insert batch (captured and uncaptured)."""
    from alayalite_tpu_torch.index.build_phases import (make_generator,
                                                        prune_all_dev)
    from alayalite_tpu_torch.index.search import (block_beam_search,
                                                  scan_seeds)

    eng = idx._engine

    q = torch.as_tensor(ds.queries, device=eng.device)
    out["search_ef64"] = trace(
        torch, "search ef=64", lambda: eng._batch_search_impl(q, K, 64))

    bq, raw = eng.search_space, eng.space
    rows = bq.data[:4096]
    gen = make_generator(eng.device, 0)
    sample = eng._seed_scan_arrays()

    def pool_chunk():
        seeds = torch.cat([scan_seeds(rows, *sample),
                           eng.graph.eps[None, :1].expand(4096, -1),
                           torch.randint(0, N, (4096, 16), generator=gen,
                                         device=eng.device,
                                         dtype=torch.int32)], 1)
        return block_beam_search(bq, seeds, rows, k=128, ef=128,
                                 n_expand=8, max_iters=12)

    out["pool_chunk"] = trace(torch, "build pool chunk", pool_chunk)
    cand_d, cand_i = pool_chunk()
    cand_i = torch.cat([cand_i, eng.graph.nbrs[:4096]], 1)
    cand_d = torch.cat([cand_d, raw.gather_dists(
        rows, eng.graph.nbrs[:4096].clamp(min=0))], 1)
    out["prune_chunk"] = trace(
        torch, "prune chunk",
        lambda: prune_all_dev(raw, cand_d, cand_i, r=32, alpha=1.2))
    out["prune_chunk_uncaptured"] = trace(
        torch, "prune chunk, uncaptured",
        uncaptured(lambda: prune_all_dev(raw, cand_d, cand_i, r=32,
                                         alpha=1.2)))
    batches = churn_batches(N, 4)                      # warm-up, traced
    out["insert_batch"] = trace(torch, "insert batch (4096 rows)",
                                lambda: eng.insert(next(batches)), top=16)
    out["insert_batch_uncaptured"] = trace(
        torch, "insert batch (4096 rows), uncaptured",
        uncaptured(lambda: eng.insert(next(batches))), top=16)
    del eng, bq, raw, rows, cand_d, cand_i, q


if __name__ == "__main__":
    sys.exit(main())
