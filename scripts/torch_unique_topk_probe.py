#!/usr/bin/env python3
"""unique_topk, the block search's final selection, against its plain
version and against the duplicate net and top k it replaced, at the 1-bit
search's slice (4096, 522, 10), bsq8's (4096, 64, 10) and the bsq8 fit's
pools (4096, 100, 100): ``python3 scripts/torch_unique_topk_probe.py
[--shape B,W,K ...] [--rounds N]``.

The rows are ``chip_smoke.unique_topk_inputs``' (a valid mask of 1M rows
where the path passes one, every shape but k = W). Times are CUDA-event
medians (``utils.timing.cuda_ms``): ``ms`` holds the host's launch latency,
``spin`` the device's time alone; ``prof`` is the kernel's own device time
a launch from ``torch.profiler`` over 50 launches. The three are timed in
turns, ``--rounds`` times; ``bound`` is the bytes that must move over the
card's 3.35 TB/s. Needs one CUDA device; prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ("4096,522,10", "4096,64,10", "4096,100,100")
PROF_LAUNCHES = 50


def profiled_ms(torch, fn) -> float:
    """Device ms a launch of the kernel named unique_topk, by the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROF_LAUNCHES):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if "unique_topk" in ev.key)
    return us / 1e3 / PROF_LAUNCHES


def main() -> int:
    import torch

    sys.path.insert(0, ROOT)
    from chip_smoke import (_same_bits, unique_topk_bytes, unique_topk_chain,
                            unique_topk_inputs)

    from alayalite_tpu_torch.ops.unique_topk import (unique_topk,
                                                     unique_topk_ref)
    from alayalite_tpu_torch.utils.timing import bound, card_line, cuda_ms

    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", action="append", default=None,
                    metavar="B,W,K")
    ap.add_argument("--rounds", type=int, default=4)
    a = ap.parse_args()
    dev = torch.device("cuda")
    report = {"card": card_line(), "at": {}}
    for spec in a.shape or SHAPES:
        B, W, k = map(int, spec.split(","))
        d, ids, valid = unique_topk_inputs(torch, np.random.default_rng(23),
                                           B, W, k, k < W, dev)
        args = (d, ids, k, valid)
        got = unique_topk(*args)
        want = unique_topk_chain(torch, *args)
        torch.cuda.synchronize()
        fns = {"kernel": lambda: unique_topk(*args),
               "plain": lambda: unique_topk_ref(*args),
               "chain": lambda: unique_topk_chain(torch, *args)}
        times = {n: {"ms": [], "spin": []} for n in fns}
        for _ in range(a.rounds):
            for n, fn in fns.items():
                times[n]["ms"].append(cuda_ms(fn))
                times[n]["spin"].append(cuda_ms(fn, spin=True))
        report["at"][spec] = {
            "valid": valid is not None,
            "equal_to_chain": _same_bits(got[0], want[0])
            and _same_bits(got[1], want[1]),
            **bound(unique_topk_bytes(B, W, k, valid), 0, "f32"),
            "prof": profiled_ms(torch, fns["kernel"]),
            "times": {n: {m: float(np.median(v)) for m, v in t.items()}
                      for n, t in times.items()},
            "times_all": times}
        torch.cuda.empty_cache()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
