#!/usr/bin/env python3
"""Two choices of the port, timed both ways on one GPU:
``python3 scripts/torch_choice_probe.py [merge] [repair]`` (default: both).

merge   The hop's pool merge (``ops/topk.merge_topk_dedup``) is one launch
        of ``pool_merge``: pool and candidates sorted together as one padded
        list. The other form is two launches, ``sort_kv`` of the candidates
        then ``merge_kv`` with the pool, and the duplicate marking after
        them in eager PyTorch. On a raw hnsw index (defaults) and on the
        hnsw + bsq8 headline index over ``random_dataset(1M x 128, seed 42,
        500 clusters)`` the probe searches 8192 queries at ef 64 with the
        hop's merge as shipped, as two launches with the eager marking, and
        as two launches without any marking (not a valid search: the time a
        ``merge_kv`` that marked duplicates itself could not beat). Order
        one, two, bare, bare, two, one, three times over; for each form the
        median wall of the unprofiled calls, the device time and launches
        under ``torch.profiler``, and recall@10. It also counts the rows
        whose pool is not ascending when a hop's merge receives it (a
        marked duplicate is +inf in the middle of the pool): on those rows
        ``merge_kv``, which wants ascending operands, does not return the
        stable sort. Beside it the kernels alone at [4096, 64 + 256].
repair  ``repair_dev.repair_connectivity`` repairs a graph of any size on
        the device; the JAX package sends one of up to 200,000 rows to a
        host repair (numpy BFS, scipy components, one edge per unreached
        component from its nearest reached node). ``host_repair`` below is
        that route, kept here to be timed. For hnsw and nsg graphs of
        100,000 and 200,000 rows the probe takes the adjacency as the
        build hands it to the repair and times both routes on copies of
        it, three times each, alternating, the host route with its download
        and upload; it prints the unreached nodes before and after.
Writes build/torch_choice_probe.json. Needs a CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, DIM, NQ, K, EF = 1_000_000, 128, 8192, 10, 64
POOL_SHAPE = (4096, 64, 256)


def mark_duplicates(torch, sd, sp):
    """The duplicate marking of ``pool_sort.pool_merge_ref`` on a merged
    (distance, id * 2 + flag) row."""
    prev = torch.cat([torch.full_like(sp[..., :1], -3), sp[..., :-1]], dim=-1)
    dup = (sp == prev) & (sp >= 0) & torch.isfinite(sd)
    sd = torch.where(dup, torch.full_like(sd, float("inf")), sd)
    ids = torch.where(dup, torch.full_like(sp, -1), sp >> 1)
    return sd, ids, ((sp & 1) == 1) | dup


def two_launch_forms(torch):
    from alayalite_tpu_torch.ops.pool_sort import _pack, merge_kv, sort_kv

    def merged(d1, i1, f1, d2, i2, f2, k):
        sd2, sp2 = sort_kv(d2.contiguous(), _pack(i2, f2).contiguous())
        return merge_kv(d1.contiguous(), _pack(i1, f1).contiguous(), sd2,
                        sp2, k)

    def two(d1, i1, f1, d2, i2, f2, k):
        return mark_duplicates(torch, *merged(d1, i1, f1, d2, i2, f2, k))

    def bare(d1, i1, f1, d2, i2, f2, k):
        sd, sp = merged(d1, i1, f1, d2, i2, f2, k)
        return sd, sp >> 1, (sp & 1) == 1

    return two, bare


def merge_kernels_alone(torch, dev) -> dict:
    from alayalite_tpu_torch.ops.pool_sort import (_pack, merge_kv,
                                                   pool_merge, sort_kv)
    from alayalite_tpu_torch.utils.timing import cuda_ms

    B, L1, L2 = POOL_SHAPE
    rng = np.random.default_rng(4)
    d1 = torch.as_tensor(np.sort(rng.normal(size=(B, L1)), 1)
                         .astype(np.float32), device=dev)
    d2 = torch.as_tensor(rng.normal(size=(B, L2)).astype(np.float32),
                         device=dev)
    i1 = torch.as_tensor(rng.integers(0, 1 << 20, size=(B, L1))
                         .astype(np.int32), device=dev)
    i2 = torch.as_tensor(rng.integers(0, 1 << 20, size=(B, L2))
                         .astype(np.int32), device=dev)
    f1 = torch.zeros((B, L1), dtype=torch.bool, device=dev)
    f2 = torch.zeros((B, L2), dtype=torch.bool, device=dev)
    p1, p2 = _pack(i1, f1), _pack(i2, f2)
    two, _ = two_launch_forms(torch)

    def kernels_only():
        return merge_kv(d1, p1, *sort_kv(d2, p2), L1)

    forms = {"pool_merge": lambda: pool_merge(d1, i1, f1, d2, i2, f2, L1,
                                              True),
             "sort_kv_then_merge_kv": kernels_only,
             "two_launches_and_eager_marking":
                 lambda: two(d1, i1, f1, d2, i2, f2, L1)}
    out = {}
    for name, fn in forms.items():
        out[name] = {"ms": cuda_ms(fn), "ms_spin": cuda_ms(fn, spin=True)}
        print(f"  alone at {POOL_SHAPE}: {name} {out[name]['ms']:.4f} ms "
              f"({out[name]['ms_spin']:.4f} device alone)", flush=True)
    return out


def merge_probe(torch, dev, ds, gt) -> dict:
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from torch_profile import trace

    from alayalite_tpu_torch import Index, IndexParams
    from alayalite_tpu_torch.index import captured, search
    from alayalite_tpu_torch.utils.evaluate import calc_recall

    def use(fn):
        """The hop's merge as ``fn``; the captured search graphs are
        dropped, so the next search captures with it."""
        search.merge_topk_dedup = fn
        captured.clear()

    shipped = search.merge_topk_dedup
    two, bare = two_launch_forms(torch)
    forms = {"one": shipped, "two": two, "bare": bare}
    out = {"alone": merge_kernels_alone(torch, dev)}
    q = torch.as_tensor(ds.queries, device=dev)
    configs = {
        "raw_hnsw": IndexParams(index_type="hnsw", capacity=N),
        "hnsw_bsq8": IndexParams(
            index_type="hnsw", quantization_type="bsq8", max_nbrs=32,
            ef_construction=200, prune_alpha=1.2, seed_sample=16384,
            beam_expand=8, capacity=N)}
    for name, params in configs.items():
        idx = Index(name, params)
        idx.fit(ds.data)
        eng = idx._engine

        def run(capture=True):
            with contextlib.nullcontext() if capture else captured.eager():
                return eng._batch_search_impl(q, K, EF)

        # rows whose pool arrives out of order, over one search as shipped
        seen = {"rows": 0, "unsorted": 0, "merges": 0}

        def counting(d1, i1, f1, d2, i2, f2, k):
            seen["merges"] += 1
            seen["rows"] += d1.shape[0]
            seen["unsorted"] += int((d1[:, 1:] < d1[:, :-1]).any(1).sum())
            return shipped(d1, i1, f1, d2, i2, f2, k)

        use(counting)
        run(False)              # counting reads the pools on the host
        rep = {"pool_rows": seen["rows"], "merges": seen["merges"],
               "pool_rows_not_ascending": seen["unsorted"]}
        walls = {f: [] for f in forms}
        for _ in range(3):
            for form in ("one", "two", "bare", "bare", "two", "one"):
                use(forms[form])
                run()                                          # warm-up
                torch.cuda.synchronize()
                t = time.time()
                run()
                torch.cuda.synchronize()
                walls[form].append((time.time() - t) * 1e3)
        for form, fn in forms.items():
            use(fn)
            ids = run()[0].cpu().numpy()
            prof = trace(torch, f"{name} ef={EF}, merge form {form!r}", run,
                         top=6)
            rep[form] = {"wall_ms_median": float(np.median(walls[form])),
                         "wall_ms": walls[form],
                         "device_ms": prof["device_ms"],
                         "profiled_wall_ms": prof["wall_ms"],
                         "recall": calc_recall(ids, gt)}
        use(shipped)
        print(f"{name}: {rep['pool_rows_not_ascending']} of "
              f"{rep['pool_rows']} pool rows not ascending over "
              f"{rep['merges']} merges; " + "; ".join(
                  f"{f}: wall {rep[f]['wall_ms_median']:.2f} ms, device "
                  f"{rep[f]['device_ms']:.2f} ms, recall@10 "
                  f"{rep[f]['recall']:.4f}" for f in forms), flush=True)
        out[name] = rep
        del idx, eng
        torch.cuda.empty_cache()
    return out


def unreached(torch, nbrs, ep: int) -> int:
    from alayalite_tpu_torch.index.repair_dev import _expand_reached

    seed = torch.zeros(nbrs.shape[0], dtype=torch.bool, device=nbrs.device)
    seed[ep] = True
    return int((~_expand_reached(nbrs, seed)).sum())


def host_repair(torch, space, nbrs: np.ndarray, ep: int) -> np.ndarray:
    """The host route: reachability by a numpy frontier BFS, kept up as
    edges are added; per round one edge into each unreached component's
    representative from its nearest reached node (one exact scan on the
    device), into an empty slot or, in a full row, a slot from the end;
    until at most 0.02% of the nodes are unreached, checked by a BFS from
    scratch."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    from alayalite_tpu_torch.ops.distance import exact_topk

    n = nbrs.shape[0]

    def expand(reached, frontier):
        frontier = frontier[~reached[frontier]]
        reached[frontier] = True
        while frontier.size:
            nxt = nbrs[frontier].reshape(-1)
            nxt = np.unique(nxt[nxt >= 0])
            frontier = nxt[~reached[nxt]]
            reached[frontier] = True

    def representatives(members):
        local = np.full(n, -1, dtype=np.int32)
        local[members] = np.arange(members.size, dtype=np.int32)
        cols = local[np.clip(nbrs[members], 0, None)]
        ok = (nbrs[members] >= 0) & (cols >= 0)
        indptr = np.zeros(members.size + 1, dtype=np.int64)
        np.cumsum(ok.sum(axis=1), out=indptr[1:])
        m = csr_matrix((np.ones(int(ok.sum()), np.int8), cols[ok], indptr),
                       shape=(members.size, members.size))
        labels = connected_components(m, directed=False)[1]
        return members[np.unique(labels, return_index=True)[1]]

    start = np.array([ep], dtype=np.int64)
    reached = np.zeros(n, dtype=bool)
    expand(reached, start)
    data = space.data[:n].float()
    verified = True
    for rnd in range(24):
        missing = np.nonzero(~reached)[0]
        if missing.size <= int(2e-4 * n) and rnd > 0:
            if verified:
                break
            reached = np.zeros(n, dtype=bool)
            expand(reached, start)
            verified = True
            continue
        if missing.size == 0:
            break
        verified = False
        reps = representatives(missing)
        near = exact_topk(
            data[torch.as_tensor(reps, device=data.device).long()], data, 1,
            metric=space.metric,
            valid=torch.as_tensor(reached, device=data.device))[1]
        used: dict = {}
        for u, v in zip(reps.tolist(), near[:, 0].cpu().tolist()):
            empty = np.nonzero(nbrs[v] < 0)[0]
            if empty.size:
                nbrs[v, empty[0]] = u
            else:
                used[v] = used.get(v, 0) + 1
                nbrs[v, -(used[v] - 1) % nbrs.shape[1] - 1] = u
        expand(reached, reps.astype(np.int64))
    return nbrs


def repair_probe(torch, dev) -> dict:
    from alayalite_tpu_torch import Index, IndexParams
    from alayalite_tpu_torch.index import hnsw, repair_dev
    from alayalite_tpu_torch.utils.datasets import random_dataset

    repair = repair_dev.repair_connectivity
    out = {}
    for n in (100_000, 200_000):
        ds = random_dataset(n=n, dim=DIM, n_queries=16, seed=42,
                            clusters=max(32, n // 2000))
        for kind in ("hnsw", "nsg"):
            taken = {}

            def capture(space, nbrs, ep):
                taken.update(space=space, nbrs=nbrs.clone(), ep=ep)
                return repair(space, nbrs, ep)

            # hnsw binds the name when it is imported, nsg when it builds
            hnsw.repair_connectivity = capture
            repair_dev.repair_connectivity = capture
            try:
                idx = Index(kind, IndexParams(index_type=kind, capacity=n))
                idx.fit(ds.data)
            finally:
                hnsw.repair_connectivity = repair
                repair_dev.repair_connectivity = repair
            space, before, ep = taken["space"], taken["nbrs"], taken["ep"]

            def on_device():
                return repair(space, before.clone(), ep)

            def on_host():
                nbrs = before.clone()
                nbrs.copy_(torch.from_numpy(host_repair(
                    torch, space, nbrs.cpu().numpy().copy(), ep)))
                return nbrs

            rep = {"unreached_before": unreached(torch, before, ep),
                   "device_s": [], "host_s": []}
            for _ in range(3):
                for key, fn in (("device_s", on_device),
                                ("host_s", on_host)):
                    torch.cuda.synchronize()
                    t = time.time()
                    fixed = fn()
                    torch.cuda.synchronize()
                    rep[key].append(time.time() - t)
                    rep["unreached_after_" + key[:-2]] = unreached(
                        torch, fixed, ep)
            out[f"{kind}_{n}"] = rep
            print(f"repair {kind} {n} rows: {rep['unreached_before']} "
                  f"unreached; device "
                  + ", ".join(f"{s:.3f}" for s in rep["device_s"])
                  + f" s (leaves {rep['unreached_after_device']}), host "
                  + ", ".join(f"{s:.3f}" for s in rep["host_s"])
                  + f" s (leaves {rep['unreached_after_host']})", flush=True)
            del idx, space, before, taken
            torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_choice_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from alayalite_tpu_torch.utils.datasets import random_dataset
    from alayalite_tpu_torch.utils.timing import card_line

    parts = sys.argv[1:] or ["merge", "repair"]
    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    report = {"card": card}
    if "repair" in parts:
        report["repair"] = repair_probe(torch, dev)
    if "merge" in parts:
        ds = random_dataset(n=N, dim=DIM, n_queries=NQ, seed=42,
                            clusters=max(32, N // 2000))
        data = torch.as_tensor(ds.data, device=dev)
        x_sq = (data * data).sum(1)
        gt = torch.cat([
            torch.topk(x_sq[None, :] - 2.0 * (torch.as_tensor(
                ds.queries[lo:lo + 1024], device=dev) @ data.T), K, dim=1,
                largest=False).indices
            for lo in range(0, NQ, 1024)]).cpu().numpy()
        del data, x_sq
        torch.cuda.empty_cache()
        report["merge"] = merge_probe(torch, dev, ds, gt)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "torch_choice_probe.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
