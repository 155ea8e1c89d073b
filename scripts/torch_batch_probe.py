#!/usr/bin/env python3
"""Does a query's answer depend on the batch it rides in, on the card?

    python3 scripts/torch_batch_probe.py [--n 200000] [--nq 8192]

On ``random_dataset(n x 128, n_queries=nq, seed 42, one cluster per 2000
rows)``, for batch splits of 512, 54 and 1 queries against one call of all
of them, prints the share of bit-equal outputs of the operations a search
runs for its exact distances (the row distances as a ``torch.bmm`` of the
gathered rows; as ``ops.distance.row_dots``, an elementwise product and a
sum; as ``ops.gather_dot``, the kernel the f32 searches take; the bf16
seed-scan ``torch.matmul``), their times at the hop's [4096, 256, 128]
(CUDA events, device time alone), then the share of equal result rows of
a raw hnsw and a bsq8 index (ef 64, k 10) searched in those splits and the
wall seconds of one search of all the queries, each with ``gather_dot``
and with ``index_select`` + ``torch.bmm`` in its place, in turns. Needs a
CUDA device; prints the card's name and power limit beside the numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from contextlib import contextmanager

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = (512, 54, 1)


def split_equal(full, fn, q, *rest, rows: int):
    """Share of bit-equal entries and of equal rows of ``fn`` over slices of
    ``rows`` queries against ``full``, the one-call output."""
    import torch

    parts = torch.cat([fn(q[lo:lo + rows], *(r[lo:lo + rows] for r in rest))
                       for lo in range(0, q.shape[0], rows)])
    same = parts == full
    return {"entries": float(same.float().mean()),
            "rows": float(same.all(1).float().mean())}


def bmm_dots(rows, q):
    import torch

    return torch.bmm(rows, q.unsqueeze(2)).squeeze(2)


def bmm_gather(data, ids, q, q_sq=None, x_sq=None):
    """``gather_dot``'s function through index_select and ``torch.bmm``."""
    import torch

    B, K = ids.shape
    safe = ids.clamp(0, data.shape[0] - 1).reshape(-1)
    dot = bmm_dots(data.index_select(0, safe).view(B, K, -1), q)
    if x_sq is None:
        return dot
    return torch.clamp(q_sq[:, None] + x_sq.index_select(0, safe).view(B, K)
                       - 2.0 * dot, min=0.0)


@contextmanager
def gather_as(fn):
    """Every space module's ``gather_dot`` replaced by ``fn``. The
    captured search graphs are dropped on the way in and out, so each form
    captures its own."""
    from alayalite_tpu_torch.index import captured
    from alayalite_tpu_torch.spaces import bqg, rabitq, raw

    mods = (bqg, rabitq, raw)
    saved = [m.gather_dot for m in mods]
    for m in mods:
        m.gather_dot = fn
    captured.clear()
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.gather_dot = f
        captured.clear()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=200_000)
    p.add_argument("--nq", type=int, default=8192)
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_batch_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from alayalite_tpu_torch import Index, IndexParams
    from alayalite_tpu_torch.ops.distance import row_dots
    from alayalite_tpu_torch.ops.gather_dot import gather_dot
    from alayalite_tpu_torch.spaces.raw import RawSpace
    from alayalite_tpu_torch.utils.datasets import random_dataset
    from alayalite_tpu_torch.utils.timing import card_line, cuda_ms

    dev = torch.device("cuda")
    ds = random_dataset(n=args.n, dim=128, n_queries=args.nq, seed=42,
                        clusters=max(32, args.n // 2000))
    sp = RawSpace.create(args.n, 128, device=dev).fit(
        torch.as_tensor(ds.data, device=dev))
    q = torch.as_tensor(ds.queries, device=dev)
    ids = torch.randint(0, args.n, (args.nq, 256), device=dev,
                        generator=torch.Generator(dev).manual_seed(1))

    def gathered(dots):
        def fn(qq, ii):
            rows = sp.data.index_select(0, ii.reshape(-1)).view(*ii.shape, -1)
            return dots(rows, qq)
        return fn

    sample = sp.data[:4096].to(torch.bfloat16)

    def seed_scan(qq):
        return torch.matmul(qq.to(torch.bfloat16), sample.T).float()

    def kernel(qq, ii):
        return gather_dot(sp.data, ii, qq)

    ops = {"bmm": (gathered(bmm_dots), (q, ids)),
           "row_dots": (gathered(row_dots), (q, ids)),
           "gather_dot": (kernel, (q, ids)),
           "seed_scan_matmul": (seed_scan, (q,))}
    out = {"card": card_line(), "n": args.n, "nq": args.nq, "ops": {},
           "ms_spin_4096x256x128": {}, "search": {}}
    for name, (fn, inputs) in ops.items():
        full = fn(*inputs)
        out["ops"][name] = {rows: split_equal(full, fn, *inputs, rows=rows)
                            for rows in SPLITS}
    hop_q, hop_ids = q[:4096], ids[:4096]
    for _ in range(2):                                        # in turns
        for name in ("bmm", "row_dots", "gather_dot"):
            fn = ops[name][0]
            out["ms_spin_4096x256x128"].setdefault(name, []).append(
                cuda_ms(lambda: fn(hop_q, hop_ids), spin=True))
    for name, kw in (("raw_hnsw", {}), ("bsq8", dict(quantization_type="bsq8",
                                                       max_nbrs=32))):
        idx = Index(name, IndexParams(capacity=args.n, **kw))
        idx.fit(ds.data)
        rep = out["search"][name] = {"wall_s": {}}
        for fn, label in ((gather_dot, "gather_dot"),
                          (bmm_gather, "bmm")):
            with gather_as(fn):
                full = idx.batch_search(ds.queries, 10, ef_search=64)
                rep[label] = {}
                for rows in SPLITS[:2]:
                    parts = np.concatenate([
                        idx.batch_search(ds.queries[lo:lo + rows], 10,
                                         ef_search=64)
                        for lo in range(0, args.nq, rows)])
                    rep[label][rows] = float((parts == full).all(1).mean())
        for _ in range(3):                                    # in turns
            for fn, label in ((gather_dot, "gather_dot"),
                              (bmm_gather, "bmm")):
                with gather_as(fn):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    idx.batch_search(ds.queries, 10, ef_search=64)
                    torch.cuda.synchronize()
                    rep["wall_s"].setdefault(label, []).append(
                        time.perf_counter() - t)
        del idx
        torch.cuda.empty_cache()
    print(json.dumps(out))
    print(out["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
