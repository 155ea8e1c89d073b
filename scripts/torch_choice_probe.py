#!/usr/bin/env python3
"""One choice of the port, timed both ways on one GPU:
``python3 scripts/torch_choice_probe.py``.

``repair_dev.repair_connectivity`` repairs a graph of any size on the
device; the JAX package sends one of up to 200,000 rows to a host repair
(numpy BFS, scipy components, one edge per unreached component from its
nearest reached node). ``host_repair`` below is that route, kept here to be
timed. For hnsw and nsg graphs of 100,000 and 200,000 rows the probe takes
the adjacency as the build hands it to the repair and times both routes on
copies of it, three times each, alternating, the host route with its
download and upload; it prints the unreached nodes before and after.
Writes build/torch_choice_probe.json. Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 128


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

    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    report = {"card": card}
    report["repair"] = repair_probe(torch, dev)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "torch_choice_probe.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
