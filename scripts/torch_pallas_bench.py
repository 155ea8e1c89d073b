#!/usr/bin/env python3
"""The distance tiles on one GPU: ``python3 scripts/torch_pallas_bench.py``.

Counterpart of scripts/pallas_bench.py, the JAX package's entry point for
its two distance-tile kernels. At Q = 4096, N = 65,536, D = 128 (random
normal rows, seed 0) it times with CUDA events (median of 25 after 3
warm-up calls):
  - ``l2_tile`` (csrc/l2_tile.cu) against the float32 ``torch.matmul``
    product alone (TF32 off) and against the bf16 product + l2 epilogue of
    fast mode's coarse scan (``pairwise(..., compute_dtype=bfloat16)``);
  - ``sq8_tile`` (csrc/sq8_tile.cu) on the codes of an ``SQSpace`` fit of
    the same rows, against the bf16 ``torch.matmul`` of the decoded codes;
  - each of them followed by a top-40 selection (``torch.topk``).
Each kernel is also held against its plain version (tolerance
1e-4 * max|ref| + 1e-3). Prints one line per measurement and the card's
name and power limit; writes build/torch_pallas_bench.json. Needs a CUDA
device.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q, N, D, SEL = 4096, 65536, 128, 40


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_pallas_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from alayalite_tpu_torch.device import resolve_device
    from alayalite_tpu_torch.ops.distance import pairwise
    from alayalite_tpu_torch.ops.l2_tile import l2_tile, l2_tile_ref
    from alayalite_tpu_torch.ops.sq8_tile import sq8_tile, sq8_tile_ref
    from alayalite_tpu_torch.spaces.sq import SQSpace
    from alayalite_tpu_torch.utils.timing import bound, card_line, cuda_ms

    dev = resolve_device(None)
    card = card_line()
    print(f"card: {card}", flush=True)
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.normal(size=(Q, D)).astype(np.float32), device=dev)
    x = torch.as_tensor(rng.normal(size=(N, D)).astype(np.float32), device=dev)
    sp = SQSpace.create(N, D, device=dev).fit(x)
    codes, dmin, scale = sp.codes, sp.dmin, sp.scale

    def topk(d):
        return torch.topk(d, SEL, dim=1, largest=False)

    def qs_cf():
        return ((q * scale).to(torch.bfloat16),
                (codes.to(torch.int16) - 128).to(torch.bfloat16))

    def lib_sq8():
        a, b = qs_cf()
        return torch.matmul(a, b.T)

    out = {"card": card, "shape": [Q, N, D], "select": SEL}
    for name, got, ref in (
            ("l2_tile", lambda: l2_tile(q, x), lambda: l2_tile_ref(q, x)),
            ("sq8_tile", lambda: sq8_tile(q, codes, dmin, scale),
             lambda: sq8_tile_ref(q, codes, dmin, scale))):
        a, b = got(), ref()
        torch.cuda.synchronize()
        err = float((a - b).abs().max())
        tol = 1e-4 * float(b.abs().max()) + 1e-3
        print(f"{name}: max_abs_err {err:.3e} (tol {tol:.3e})", flush=True)
        if not err <= tol:
            raise AssertionError(f"{name} disagrees with its plain version")
        out[f"{name}_max_abs_err"] = err
        del a, b

    cases = {
        "l2_tile": lambda: l2_tile(q, x),
        "matmul_f32": lambda: torch.matmul(q, x.T),
        "bf16_product_epilogue": lambda: pairwise(
            q, x, compute_dtype=torch.bfloat16),
        "sq8_tile": lambda: sq8_tile(q, codes, dmin, scale),
        "matmul_bf16_decoded": lib_sq8,
        "l2_tile+top40": lambda: topk(l2_tile(q, x)),
        "bf16_product_epilogue+top40": lambda: topk(pairwise(
            q, x, compute_dtype=torch.bfloat16)),
        "sq8_tile+top40": lambda: topk(sq8_tile(q, codes, dmin, scale)),
    }
    flops = 2 * Q * N * D
    out["ms"] = {}
    for name, fn in cases.items():
        ms = cuda_ms(fn)
        out["ms"][name] = ms
        print(f"{name:30s} {ms:9.4f} ms  ({flops / ms / 1e9:6.1f} "
              f"TFLOP/s of the product)", flush=True)
    out["l2_tile_bound"] = bound((Q * D + N * D + Q * N) * 4,
                                 flops + 3 * Q * N, "f32")
    out["sq8_tile_bound"] = bound(Q * D * 4 + N * D + 2 * D * 4 + Q * N * 4,
                                  flops + 3 * Q * N, "bf16")
    for name in ("l2_tile", "sq8_tile"):
        b = out[f"{name}_bound"]
        print(f"{name} bound {b['bound_ms']:.4f} ms ({b['bound_by']}; bytes "
              f"{b['bytes_ms']:.4f} ms, operations {b['ops_ms']:.4f} ms)",
              flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "torch_pallas_bench.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
