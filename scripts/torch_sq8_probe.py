#!/usr/bin/env python3
"""sq8_tile against the one PyTorch call that computes the same product
with the same f32 output, both timed two ways, at the distance-tile bench
shape 4096 x 65536 x 128: ``python3 scripts/torch_sq8_probe.py
[--shape Q,N,D] [--variant NAME=FILE.cu ...]``.

``ms`` (CUDA events around one call) holds the host's time to reach the
first kernel, ``spin`` the device's time alone (utils.timing.cuda_ms); the
host microseconds per call are the wall time of one unsynchronised call
(median of 21). The library route is chip_smoke.py's ``library_f32_ms``:
bf16(q * scale) and the decoded codes, then ``torch.mm`` with
``out_dtype=float32``; the product alone is timed too. Four rounds in
turns (kernel, library, then each variant).

A variant is another source with the same entry point (``alaya_sq8_tile``),
built by ``scripts/torch_nvcc_probe.py`` (its seconds, warnings and HGMMA
count are reported) and held against the package's kernel on the same
inputs (``max_abs_diff``). Needs one CUDA device; prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (4096, 65536, 128)
ROUNDS = 4


def host_us(torch, fn, reps: int = 21) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times) * 1e6)


def variant_fn(torch, path: str, name: str, q, codes, dmin, scale):
    """(the variant's build report, a call of it on the inputs)."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from torch_nvcc_probe import compile_source

    from alayalite_tpu_torch.ops import _build

    built = compile_source(path, f"sq8_probe_{name}")
    fn = ctypes.CDLL(built.pop("library")).alaya_sq8_tile
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    (Q, D), N = q.shape, codes.shape[0]
    out = torch.empty((Q, N), dtype=torch.float32, device=q.device)
    xsq = torch.empty(N, dtype=torch.float32, device=q.device)
    vec = int(D % 16 == 0)

    def call():
        _build.launch(fn, q.device, q.data_ptr(), codes.data_ptr(),
                      dmin.data_ptr(), scale.data_ptr(), xsq.data_ptr(),
                      out.data_ptr(), Q, N, D, vec)
        return out

    return built, call


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default=",".join(map(str, SHAPE)))
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=FILE.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sq8_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from alayalite_tpu_torch.ops.sq8_tile import sq8_tile
    from alayalite_tpu_torch.utils.timing import card_line, cuda_ms

    Q, N, D = (int(v) for v in args.shape.split(","))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.normal(size=(Q, D)).astype(np.float32), device=dev)
    codes = torch.as_tensor(rng.integers(0, 256, size=(N, D), dtype=np.uint8),
                            device=dev)
    dmin = torch.as_tensor(rng.normal(size=D).astype(np.float32) - 4.0,
                           device=dev)
    scale = torch.as_tensor(rng.uniform(0.01, 0.05, size=D).astype(np.float32),
                            device=dev)
    qs = (q * scale).to(torch.bfloat16)
    cf = (codes.to(torch.int16) - 128).to(torch.bfloat16)

    def kernel():
        return sq8_tile(q, codes, dmin, scale)

    def library():
        return torch.mm((q * scale).to(torch.bfloat16),
                        (codes.to(torch.int16) - 128).to(torch.bfloat16).T,
                        out_dtype=torch.float32)

    def product():
        return torch.mm(qs, cf.T, out_dtype=torch.float32)

    variants = {}
    want = kernel()
    for spec in args.variant:
        name, path = spec.split("=", 1)
        built, call = variant_fn(torch, path, name, q, codes, dmin, scale)
        got = call()
        torch.cuda.synchronize()
        built["max_abs_diff"] = float((got - want).abs().max())
        variants[name] = (built, call)
    del want
    rounds = []
    for _ in range(ROUNDS):
        r = {"kernel_ms": cuda_ms(kernel),
             "kernel_spin": cuda_ms(kernel, spin=True),
             "library_ms": cuda_ms(library),
             "library_spin": cuda_ms(library, spin=True),
             "product_spin": cuda_ms(product, spin=True)}
        for name, (_, call) in variants.items():
            r[f"{name}_ms"] = cuda_ms(call)
            r[f"{name}_spin"] = cuda_ms(call, spin=True)
        rounds.append(r)
    out = {"card": card_line(), "shape": [Q, N, D], "rounds": rounds,
           "kernel_host_us": host_us(torch, kernel),
           "library_host_us": host_us(torch, library),
           "variants": {name: built for name, (built, _) in variants.items()}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
