#!/usr/bin/env python3
"""gather_diagdot's entries, and block_diagdot, against earlier sources of
the same kernels, on one card in one process: ``python3
scripts/torch_gather_ab.py [--old DIR/alayalite_tpu_torch/csrc/gather_diagdot.cu
[--variant NAME=FILE.cu ...]] [--old-diagdot DIR/alayalite_tpu_torch/csrc/diagdot.cu]``.

The old source is one with the entry points ``alaya_gather_diagdot_direct``
and ``alaya_gather_diagdot_staged`` (the kernels before the rows / bulk
redesign; unpack an earlier commit with ``git archive`` into a directory
that .gitignore lists). It is built by ``scripts/torch_nvcc_probe.py`` and
held against the package's plain version. Shapes: the hop's (B 4096, M 8,
R 32, Dp 128 over 100,000 nodes) and the sq8 traversal's one-row blocks
(4096 x 256 over 100,000 x 128 codes). Device time alone
(``utils.timing.cuda_ms(spin=True)``) in four rounds, the old kernels first
and last in turn with the package's (old, new, new, old); the bound counts
each distinct block once. A variant is another source with the package's
entry points (``alaya_gather_diagdot_rows`` / ``_bulk``), built and timed
beside it (its rows entry, the dot alone and fused).

``--old-diagdot`` takes a source with ``alaya_block_diagdot`` (the kernel
before it moved onto gather_diagdot.cu's rows kernel: a block per (query,
64-row tile), qs staged in shared memory) and holds it and the package's
block_diagdot against the plain version at (4096, 256, 128) and at
(1000, 200, 96), (333, 77, 40) and (1, 256, 128), timed in the same four
alternating rounds beside an empty kernel's span (one fill of 16 floats),
with the byte bound. Needs one CUDA device; prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"hop": (100_000, 32, 128, 4096, 8),
          "r1": (100_000, 1, 128, 4096, 256)}
DIAGDOT_SHAPES = ((4096, 256, 128), (1000, 200, 96), (333, 77, 40),
                  (1, 256, 128))
ROUNDS = 4


def old_entries(path: str):
    """The old source's two entries as callables (codes, u, qs) -> out."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from torch_nvcc_probe import compile_source

    import torch

    from alayalite_tpu_torch.ops._build import launch

    built = compile_source(path, "gather_diagdot_old")
    lib = ctypes.CDLL(built.pop("library"))
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    direct = lib.alaya_gather_diagdot_direct
    staged = lib.alaya_gather_diagdot_staged
    direct.argtypes = [P] * 4 + [LL] * 4 + [I, P]
    staged.argtypes = [P] * 4 + [LL] * 4 + [I, I, P]
    direct.restype = staged.restype = ctypes.c_int

    def call(fn, flags):
        def run(codes, u, qs):
            B, M = u.shape
            _, R, Dp = codes.shape
            out = torch.empty((B, M * R), dtype=torch.float32,
                              device=codes.device)
            launch(fn, codes.device, codes.data_ptr(), u.data_ptr(),
                   qs.data_ptr(), out.data_ptr(), B, M, R, Dp, *flags(R, Dp))
            return out
        return run

    return built, {
        "old_direct": call(direct, lambda R, Dp: (int(Dp % 16 == 0),)),
        "old_staged": call(staged, lambda R, Dp: (int(R * Dp % 16 == 0),
                                                  int(Dp % 16 == 0)))}


def variant_entries(name: str, path: str, qconst, xsq, ids):
    """A variant source's rows entry as callables (codes, u, qs) -> out: the
    dot alone and with the estimate fused in."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from torch_nvcc_probe import compile_source

    import torch

    from alayalite_tpu_torch.ops._build import launch

    built = compile_source(path, f"gather_diagdot_{name}")
    fn = ctypes.CDLL(built.pop("library")).alaya_gather_diagdot_rows
    P, LL = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = ([P] * 4 + [LL] * 5 + [ctypes.c_int] + [P] * 4
                   + [ctypes.c_float, ctypes.c_int, P])
    fn.restype = ctypes.c_int

    def call(fused):
        def run(codes, u, qs):
            B, M = u.shape
            C, R, Dp = codes.shape
            out = torch.empty((B, M * R), dtype=torch.float32,
                              device=codes.device)
            nid = torch.empty((B, M * R), dtype=torch.int32,
                              device=codes.device)
            est = ((qconst.data_ptr(), xsq.data_ptr(), ids.data_ptr(),
                    nid.data_ptr(), 2.0, 1) if fused
                   else (None, None, None, None, 0.0, 0))
            launch(fn, codes.device, codes.data_ptr(), u.data_ptr(),
                   qs.data_ptr(), out.data_ptr(), C, B, M, R, Dp,
                   int(Dp % 16 == 0), *est)
            return out
        return run

    return built, {name: call(False), f"{name}_fused": call(True)}


def diagdot_ab(path: str) -> dict:
    """The old block_diagdot source against the package's, bit errors and
    spin times at DIAGDOT_SHAPES."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from torch_nvcc_probe import compile_source

    import torch

    from alayalite_tpu_torch.ops._build import launch
    from alayalite_tpu_torch.ops.diagdot import block_diagdot, block_diagdot_ref
    from alayalite_tpu_torch.utils.timing import bound, cuda_ms

    built = compile_source(path, "diagdot_old")
    fn = ctypes.CDLL(built.pop("library")).alaya_block_diagdot
    P, LL = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [P] * 3 + [LL] * 3 + [ctypes.c_int, P]
    fn.restype = ctypes.c_int

    def old(codes, qs):
        B, K, Dp = codes.shape
        out = torch.empty((B, K), dtype=torch.float32, device=codes.device)
        launch(fn, codes.device, codes.data_ptr(), qs.data_ptr(),
               out.data_ptr(), B, K, Dp,
               int(Dp % 16 == 0 and codes.data_ptr() % 16 == 0))
        return out

    fns = {"old": old, "package": block_diagdot}
    tiny = torch.zeros(16, device="cuda")
    report = {"old_build": built,
              "floor_ms": cuda_ms(lambda: tiny.zero_(), spin=True),
              "shapes": {}}
    rng = np.random.default_rng(5)
    for B, K, Dp in DIAGDOT_SHAPES:
        codes = torch.as_tensor(rng.integers(0, 256, size=(B, K, Dp),
                                             dtype=np.uint8), device="cuda")
        qs = torch.as_tensor(rng.normal(size=(B, Dp)).astype(np.float32),
                             device="cuda").to(torch.bfloat16)
        want = block_diagdot_ref(codes, qs)
        errs = {name: float((f(codes, qs) - want).abs().max())
                for name, f in fns.items()}
        spins = {name: [] for name in fns}
        for rnd in range(ROUNDS):
            for name in (list(fns) if rnd % 3 == 0 else list(fns)[::-1]):
                f = fns[name]
                spins[name].append(cuda_ms(lambda f=f: f(codes, qs),
                                           spin=True))
        b = bound(B * K * Dp + B * Dp * 2 + B * K * 4, 2 * B * K * Dp, "f32")
        report["shapes"][f"{B}x{K}x{Dp}"] = {
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "max_abs_err": errs, "tol": 1e-3 * float(want.abs().max()) + 1e-3,
            "spin_ms": spins,
            "spin_median_ms": {k: float(np.median(v))
                               for k, v in spins.items()}}
        del codes
        torch.cuda.empty_cache()
    return report


def gather_ab(args) -> dict:
    """The old gather_diagdot entries (and variants) against the package's
    at SHAPES."""
    import torch

    from alayalite_tpu_torch.ops.gather_diagdot import (VARIANTS,
                                                        gather_diagdot,
                                                        gather_diagdot_ref,
                                                        gather_estimate)
    from alayalite_tpu_torch.utils.timing import bound, cuda_ms

    built, old = old_entries(args.old)
    dev = torch.device("cuda")
    report = {"old_build": built, "shapes": {}}
    rng = np.random.default_rng(2)
    for at, (C, R, Dp, B, M) in SHAPES.items():
        codes = torch.as_tensor(rng.integers(0, 256, size=(C, R, Dp),
                                             dtype=np.uint8), device=dev)
        u = torch.as_tensor(rng.integers(0, C, size=(B, M)).astype(np.int32),
                            device=dev)
        u[: B // 8] = 0
        qs = torch.as_tensor(rng.normal(size=(B, Dp)).astype(np.float32),
                             device=dev).to(torch.bfloat16)
        qconst = torch.as_tensor(rng.normal(size=B).astype(np.float32) * 60,
                                 device=dev)
        xsq = torch.as_tensor(rng.random((C, R)).astype(np.float32) * 40,
                              device=dev)
        ids = torch.as_tensor(rng.integers(-1, C, size=(C, R))
                              .astype(np.int32), device=dev)
        fns = dict(old)
        for spec in args.variant:
            name, path = spec.split("=", 1)
            report.setdefault("variant_builds", {})[name], more = (
                variant_entries(name, path, qconst, xsq, ids))
            fns.update(more)
        for v in VARIANTS:
            fns[v] = functools.partial(gather_diagdot, variant=v)
            fns[f"{v}_fused"] = functools.partial(
                gather_estimate, qconst=qconst, coef=2.0, xsq=xsq,
                nbr_ids=ids, clamp=True, variant=v)
        want = gather_diagdot_ref(codes, u, qs)
        errs = {}
        for name, fn in fns.items():
            if name.endswith("_fused"):
                continue
            errs[name] = float((fn(codes, u, qs) - want).abs().max())
        distinct = int(torch.unique(u).numel())
        b = bound(distinct * R * Dp + B * Dp * 2 + B * M * R * 4 + B * M * 4,
                  2 * B * M * R * Dp, "f32")
        spins = {name: [] for name in fns}
        order = list(fns)
        for rnd in range(ROUNDS):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                fn = fns[name]
                spins[name].append(cuda_ms(lambda fn=fn: fn(codes, u, qs),
                                           spin=True))
        report["shapes"][at] = {
            "shape": [C, R, Dp, B, M], "distinct_nodes": distinct,
            "bound_ms": b["bound_ms"], "max_abs_err": errs,
            "spin_ms": spins,
            "spin_median_ms": {k: float(np.median(v))
                               for k, v in spins.items()}}
        del codes
        torch.cuda.empty_cache()
    return report


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", metavar="FILE.cu")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=FILE.cu")
    ap.add_argument("--old-diagdot", metavar="FILE.cu")
    args = ap.parse_args()
    if not (args.old or args.old_diagdot):
        ap.error("give --old, --old-diagdot or both")
    if not torch.cuda.is_available():
        print("torch_gather_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from alayalite_tpu_torch.utils.timing import card_line

    report = {"card": card_line()}
    if args.old_diagdot:
        report["block_diagdot"] = diagdot_ab(args.old_diagdot)
    if args.old:
        report.update(gather_ab(args))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
