#!/usr/bin/env python3
"""The pool's sort, merge and hash probe against variant sources, on one
card in one process: ``python3 scripts/torch_sort_ab.py [--variant
NAME=FILE.cu ...]``.

A variant is a source with any of the entry points ``alaya_sort_kv_warp``,
``alaya_pool_merge_warp`` (as in pool_sort.cu) and
``alaya_ring_probe_hash`` (as in ring_probe.cu), with the package's
signatures: an earlier commit's sources, unpacked by ``git archive`` into a
directory that .gitignore lists, hold the kernels before a redesign. It is
built by ``scripts/torch_nvcc_probe.py``; each entry it has is held bit for
bit against the plain version and timed against the package's kernel at
the paths' shapes: sort_kv at [4096, 256] with a payload and at
NN-Descent's [4096, 180] -> 32 and the search's [4096, 64] -> 10 with
positions; pool_merge (dedup, pools with an empty tail) at ef 64 and 128
against 256 candidates and at the fusion hop's 64 + 512; ring_probe at the
bsq8 search's 96 + 64 (a pop ring half -1, and a fresh one all -1), the
build pools' 96 + 128 and 96 + 200 and the raw walk's 96. Device time alone
(``utils.timing.cuda_ms(spin=True)``) in four rounds (package, variant,
variant, package), beside the same span around an empty kernel (one fill
of 16 floats), the floor of every such time. Needs one CUDA device; prints
one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SORTS = ((4096, 256, 256, True), (4096, 180, 32, False), (4096, 64, 10, False))
MERGES = ((4096, 64, 256), (4096, 128, 256), (4096, 64, 512))
PROBES = ((4096, 256, 96, 64, False), (4096, 256, 96, 64, True),
          (4096, 256, 96, 128, False), (4096, 256, 96, 200, False),
          (4096, 256, 96, 0, False))
ROUNDS = 4


def variant_entries(name: str, path: str) -> dict:
    """The variant's entries, each a callable with the package's own
    uncounted launch's arguments."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from torch_nvcc_probe import compile_source

    import torch

    from alayalite_tpu_torch.ops._build import launch

    lib = ctypes.CDLL(compile_source(path, name)["library"])
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    entries = {}

    def symbol(sym, argtypes):
        try:
            fn = getattr(lib, sym)
        except AttributeError:
            return None
        fn.argtypes = [*argtypes, P]
        fn.restype = ctypes.c_int
        return fn

    def ptr(t):
        return None if t is None else t.data_ptr()

    sort = symbol("alaya_sort_kv_warp", [P, P, P, P, P, LL, I, I, I])
    if sort is not None:
        def sort_kv(keys, pay, k, idx):
            B, K = keys.shape
            dev = keys.device
            ok = torch.empty((B, k), dtype=torch.float32, device=dev)
            op = (None if pay is None
                  else torch.empty((B, k), dtype=torch.int32, device=dev))
            oi = (torch.empty((B, k), dtype=torch.int64, device=dev)
                  if idx else None)
            launch(sort, dev, keys.data_ptr(), ptr(pay), ok.data_ptr(),
                   ptr(op), ptr(oi), B, K, k,
                   int(K % 4 == 0 and keys.data_ptr() % 16 == 0))
            return ok, op, oi
        entries["sort_kv"] = sort_kv
    merge = symbol("alaya_pool_merge_warp", [P] * 9 + [LL, I, I, I, I])
    if merge is not None:
        def pool_merge(d1, i1, f1, d2, i2, f2, k):
            B, L1 = d1.shape
            dev = d1.device
            od = torch.empty((B, k), dtype=torch.float32, device=dev)
            oi = torch.empty((B, k), dtype=torch.int32, device=dev)
            of = torch.empty((B, k), dtype=torch.bool, device=dev)
            launch(merge, dev, *(t.data_ptr() for t in (
                d1, i1, f1, d2, i2, f2, od, oi, of)), B, L1, d2.shape[1],
                k, 1)
            return od, oi, of
        entries["pool_merge"] = pool_merge
    probe = symbol("alaya_ring_probe_hash", [P, P, P, P, LL, I, I, I, I])
    if probe is not None:
        def ring_probe(nids, seen, seen2):
            B, K = nids.shape
            out = torch.empty((B, K), dtype=torch.bool, device=nids.device)
            launch(probe, nids.device, nids.data_ptr(), seen.data_ptr(),
                   ptr(seen2), out.data_ptr(), B, K, seen.shape[1],
                   0 if seen2 is None else seen2.shape[1],
                   int(K % 4 == 0 and nids.data_ptr() % 16 == 0))
            return out
        entries["ring_probe"] = ring_probe
    return entries


def same_bits(got, want) -> bool:
    import torch

    for g, w in zip(got, want):
        if g is None or w is None:     # an output the call did not ask for
            continue
        if w.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if g.shape != w.shape or not bool((g == w).all()):
            return False
    return True


def cases(torch, rng, dev):
    """(function, label, inputs, package call, plain call) at every shape."""
    from alayalite_tpu_torch.ops.pool_sort import (pool_merge, pool_merge_ref,
                                                   sort_kv_on, sort_kv_ref)
    from alayalite_tpu_torch.ops.ring_probe import (ring_probe_on,
                                                    ring_probe_ref)

    for B, K, k, with_pay in SORTS:
        keys = np.round(rng.normal(size=(B, K)) * 8) / 8
        keys[rng.random((B, K)) < 0.3] = np.inf
        keys[rng.random((B, K)) < 0.01] = np.nan
        keys = torch.as_tensor(keys.astype(np.float32), device=dev)
        pay = (torch.as_tensor(rng.integers(-1, 1 << 30, (B, K))
                               .astype(np.int32), device=dev)
               if with_pay else None)
        args = (keys, pay, k, not with_pay)
        yield ("sort_kv", f"{K}->{k}", args,
               lambda a=args: sort_kv_on("warp", a[0], a[1], a[2], 1, a[3],
                                         counted=False),
               lambda a=args: sort_kv_ref(a[0], a[1], a[2], 1, True))
    for B, L1, L2 in MERGES:
        d1 = np.sort(np.round(rng.normal(size=(B, L1)) * 4) / 4, axis=1)
        tail = L1 // 3
        i1 = rng.integers(0, 1 << 30, size=(B, L1))
        d1[:, -tail:], i1[:, -tail:] = np.inf, -1
        d2 = np.round(rng.normal(size=(B, L2)) * 4) / 4
        i2 = rng.integers(-1, 50, size=(B, L2))
        d2[i2 < 0] = np.inf
        args = tuple(torch.as_tensor(a, device=dev) for a in (
            d1.astype(np.float32), i1.astype(np.int32),
            rng.random((B, L1)) < 0.5, d2.astype(np.float32),
            i2.astype(np.int32), np.zeros((B, L2), bool))) + (L1,)
        yield ("pool_merge", f"{L1}+{L2}", args,
               lambda a=args: pool_merge(*a, True),
               lambda a=args: pool_merge_ref(*a, True))
    for B, K, S, S2, fresh in PROBES:
        hi = 3 * (S + S2) + 8
        ring = rng.integers(0, hi, size=(B, S)).astype(np.int32)
        ring[:, : S if fresh else S // 2] = -1
        pool = rng.integers(0, hi, size=(B, S2)).astype(np.int32)
        pool[:, S2 - S2 // 4:] = -1
        nids = rng.integers(-1, hi, size=(B, K)).astype(np.int32)
        args = (torch.as_tensor(nids, device=dev),
                torch.as_tensor(ring, device=dev),
                torch.as_tensor(pool, device=dev) if S2 else None)
        label = f"{K}x{S}+{S2}" + (" fresh ring" if fresh else "")
        yield ("ring_probe", label, args,
               lambda a=args: ring_probe_on("hash", *a, counted=False),
               lambda a=args: ring_probe_ref(*a))


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--variant", action="append", default=[],
                        metavar="NAME=FILE.cu")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_sort_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from alayalite_tpu_torch.ops import _build
    from alayalite_tpu_torch.utils.timing import card_line, cuda_ms

    variants = dict(v.split("=", 1) for v in opts.variant)
    _build.build(["pool_sort", "ring_probe"])
    entries = {name: variant_entries(name, path)
               for name, path in variants.items()}
    rng = np.random.default_rng(0)
    report = {"card": card_line(), "results": {}}
    print(report["card"], flush=True)
    # what an event span around one launch reads for an empty kernel: the
    # floor of every spin time below
    tiny = torch.zeros(16, device="cuda")
    report["floor_ms"] = cuda_ms(lambda: tiny.zero_(), spin=True)
    print(f"floor: one 16-element fill {report['floor_ms']:.4f} ms (device "
          f"alone)", flush=True)
    for fn, label, args, package, plain in cases(torch, rng, "cuda"):
        want = plain()
        got = package()
        torch.cuda.synchronize()
        if not same_bits(got if fn != "ring_probe" else (got,),
                         want if fn != "ring_probe" else (want,)):
            raise AssertionError(f"the package's {fn} differs at {label}")
        for name, ent in entries.items():
            if fn not in ent:
                continue
            call = (lambda e=ent[fn], a=args: e(*a))
            out = call()
            torch.cuda.synchronize()
            if not same_bits(out if fn != "ring_probe" else (out,),
                             want if fn != "ring_probe" else (want,)):
                raise AssertionError(f"{name}'s {fn} differs at {label}")
            times = {"package": [], name: []}
            for r in range(ROUNDS):
                order = (("package", package), (name, call))
                for who, f in (order if r % 3 == 0 else order[::-1]):
                    times[who].append(cuda_ms(f, spin=True))
            rep = {k: float(np.median(v)) for k, v in times.items()}
            report["results"][f"{fn} {label} / {name}"] = {
                **rep, "rounds": times}
            print(f"{fn} {label}: package {rep['package']:.4f} ms, {name} "
                  f"{rep[name]:.4f} ms (device alone, median of "
                  f"{ROUNDS} rounds; equal bits)", flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
