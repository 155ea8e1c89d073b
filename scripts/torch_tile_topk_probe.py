#!/usr/bin/env python3
"""tile_topk, the flat scans' per-tile selection, against its plain version
and against the chain it replaced (select_smallest + merge_topk) at the exact
scan's tile (4096, 16384, 10), the fast scan's (4096, 65536, 40),
calc_gt's fast scan's (4096, 65536, 256), the last query slice's
(1808, 16384, 10) and find_medoid's (1, 16384, 1):
``python3 scripts/torch_tile_topk_probe.py [--shape Q,N,K ...] [--rounds N]
[--ptxas]``.

The tiles are ``chip_smoke.tile_topk_inputs``' (l2_tile of normal rows, a
running best from an earlier tile). Times are CUDA-event medians
(``utils.timing.cuda_ms``): ``ms`` holds the host's launch latency,
``spin`` the device's time alone; the kernel's spans include a copy of the
running best (``clone_spin``), since a launch updates it in place; ``prof``
is the kernel's own device time a launch from ``torch.profiler`` over 50
launches. The three are timed in turns, ``--rounds`` times; ``bound`` is
the tile's bytes over the card's 3.35 TB/s. ``--ptxas`` first compiles
``csrc/tile_topk.cu`` with ``-Xptxas -v`` and reports each kernel's
registers, spills and shared memory. Needs one CUDA device; prints one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ("4096,16384,10", "4096,65536,40", "4096,65536,256",
          "1808,16384,10", "1,16384,1")
PROF_LAUNCHES = 50


def ptxas() -> list:
    """The ptxas lines of each tile_topk kernel (registers, spills)."""
    from alayalite_tpu_torch.ops import _build

    out = os.path.join(ROOT, "build", "nvcc_probe", "libtile_topk_v.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
         str(_build.CSRC / "tile_topk.cu")], capture_output=True, text=True,
        check=True)
    return [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "ptxas" in ln]


def profiled_ms(torch, fn) -> float:
    """Device ms a launch of the kernel named tile_topk, by the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROF_LAUNCHES):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if "tile_topk" in ev.key)
    return us / 1e3 / PROF_LAUNCHES


def main() -> int:
    import torch

    sys.path.insert(0, ROOT)
    from chip_smoke import (_same_bits, tile_topk_bytes, tile_topk_chain,
                            tile_topk_inputs)

    from alayalite_tpu_torch.ops.tile_topk import tile_topk, tile_topk_ref
    from alayalite_tpu_torch.utils.timing import bound, card_line, cuda_ms

    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", action="append", default=None,
                    metavar="Q,N,K")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--ptxas", action="store_true")
    a = ap.parse_args()
    dev = torch.device("cuda")
    report = {"card": card_line(), "at": {}}
    if a.ptxas:
        report["ptxas"] = ptxas()
    for spec in a.shape or SHAPES:
        Q, n, k = map(int, spec.split(","))
        d, lo, bd, bi = tile_topk_inputs(torch, np.random.default_rng(27),
                                         Q, n, k, dev)
        got = tile_topk(d, lo, bd.clone(), bi.clone(), k)
        want = tile_topk_ref(d.cpu(), lo, bd.cpu(), bi.cpu(), k)
        torch.cuda.synchronize()
        fns = {"kernel": lambda: tile_topk(d, lo, bd.clone(), bi.clone(), k),
               "plain": lambda: tile_topk_ref(d, lo, bd, bi, k),
               "chain": lambda: tile_topk_chain(torch, d, lo, bd, bi, k)}
        times = {f: {"ms": [], "spin": []} for f in fns}
        for _ in range(a.rounds):
            for f, fn in fns.items():
                times[f]["ms"].append(cuda_ms(fn))
                times[f]["spin"].append(cuda_ms(fn, spin=True))
        report["at"][spec] = {
            "equal_to_plain": _same_bits(got[0].cpu(), want[0])
            and _same_bits(got[1].cpu(), want[1]),
            **bound(tile_topk_bytes(Q, n, k), 0, "f32"),
            "prof": profiled_ms(torch, fns["kernel"]),
            "clone_spin": cuda_ms(lambda: (bd.clone(), bi.clone()),
                                  spin=True),
            "times": {f: {m: float(np.median(v)) for m, v in t.items()}
                      for f, t in times.items()},
            "times_all": times}
        torch.cuda.empty_cache()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
