#!/usr/bin/env python3
"""seed_scan against the library chain it replaced and against variant
sources, at the block search's slice (4096 queries over a 16,384-point
sample, D 128, 8 seeds): ``python3 scripts/torch_seed_scan_probe.py
[--shape B,S,D,NSEED] [--variant NAME=FILE.cu ...] [--rounds N]``.

The library chain is what ``scan_seeds`` ran before the kernel: an f32
product of the bf16-rounded operands, ``sq − 2·dot``, ``torch.topk`` and
the id gather. Times are CUDA-event medians (``utils.timing.cuda_ms``):
``ms`` holds the host's launch latency, ``spin`` the device's time alone.
A variant is another source with the same entry points
(``alaya_seed_scan_splits``, ``alaya_seed_scan``), built by
``scripts/torch_nvcc_probe.py`` and held against the package's kernel on
the same inputs (the share of rows whose ids are equal). The package's
kernel, the chain and each variant are timed in turns, ``--rounds`` times.
Needs one CUDA device; prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (4096, 16384, 128, 8)


def variant_fn(torch, path: str, name: str, args):
    """(the variant's build report, a call of it on ``args``)."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from torch_nvcc_probe import compile_source

    from alayalite_tpu_torch.ops import _build

    built = compile_source(path, f"seed_scan_probe_{name}")
    lib = ctypes.CDLL(built.pop("library"))
    ll, i = ctypes.c_longlong, ctypes.c_int
    plan, scan = lib.alaya_seed_scan_splits, lib.alaya_seed_scan
    plan.argtypes = [ll, ll, ll, i, ctypes.POINTER(ctypes.c_int),
                     ctypes.c_void_p]
    scan.argtypes = [ctypes.c_void_p] * 7 + [ll, ll, ll, i, i, ctypes.c_void_p]
    plan.restype = scan.restype = ctypes.c_int
    q, ids, vecs, sq, nseed = args
    (B, D), S = q.shape, vecs.shape[0]
    splits = ctypes.c_int(0)
    _build.launch(plan, q.device, B, S, D, nseed, ctypes.byref(splits))
    width = 8 if nseed <= 8 else 16
    part_d = torch.empty((splits.value, B, width), dtype=torch.float32,
                         device=q.device)
    part_i = torch.empty_like(part_d, dtype=torch.int32)
    out = torch.empty((B, nseed), dtype=torch.int32, device=q.device)
    built["splits"] = splits.value

    def call():
        _build.launch(scan, q.device, q.data_ptr(), vecs.data_ptr(),
                      sq.data_ptr(), ids.data_ptr(), part_d.data_ptr(),
                      part_i.data_ptr(), out.data_ptr(), B, S, D, nseed,
                      int(D % 8 == 0))
        return out

    return built, call


def main() -> int:
    import torch

    sys.path.insert(0, ROOT)
    from chip_smoke import seed_scan_chain, seed_scan_inputs

    from alayalite_tpu_torch.ops.seed_scan import seed_scan
    from alayalite_tpu_torch.utils.timing import bound, card_line, cuda_ms

    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default=",".join(map(str, SHAPE)))
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=FILE.cu")
    ap.add_argument("--rounds", type=int, default=4)
    a = ap.parse_args()
    B, S, D, nseed = map(int, a.shape.split(","))
    q, ids, vecs, sq = seed_scan_inputs(torch, np.random.default_rng(19), B,
                                        S, D, torch.device("cuda"))
    args = (q, ids, vecs, sq, nseed)
    fns = {"kernel": lambda: seed_scan(*args),
           "library": lambda: seed_scan_chain(torch, *args)}
    report = {"card": card_line(), "shape": [B, S, D, nseed],
              **bound(B * D * 4 + S * D * 2 + S * 8 + B * nseed * 4,
                      2 * B * S * D, "bf16"), "variants": {}}
    want = seed_scan(*args)
    for spec in a.variant:
        name, path = spec.split("=", 1)
        built, call = variant_fn(torch, path, name, args)
        got = call()
        torch.cuda.synchronize()
        built["rows_equal"] = float((got == want).all(1).float().mean())
        report["variants"][name] = built
        fns[name] = call
    times = {k: {"ms": [], "spin": []} for k in fns}
    for _ in range(a.rounds):
        for k, fn in fns.items():
            times[k]["ms"].append(cuda_ms(fn))
            times[k]["spin"].append(cuda_ms(fn, spin=True))
    report["times"] = {k: {m: float(np.median(v)) for m, v in t.items()}
                       for k, t in times.items()}
    report["times_all"] = times
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
