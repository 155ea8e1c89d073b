#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on a GPU: ``python3 chip_smoke.py``.

Needs one CUDA device and nvcc. Phases, in order; any failure raises and
the script exits non-zero:
  1. card      nvidia-smi name and power limit, torch device name;
  2. build     every CUDA source of the port, one nvcc each, in parallel;
  3. kernels   each kernel against its plain PyTorch version on the card
               at the main-path shape and at ragged shapes, with CUDA-event
               times of the kernel, the plain version and a library call;
  4. fit       Client().create_index(hnsw + bsq8, the repository's
               headline parameters) and fit on bench.py's data,
               random_dataset(1M x 128, seed 42, 500 clusters), with
               per-phase seconds and kernel launches;
  5. search    batch_search of 8192 queries at ef 32 and 64, k = 10,
               recall@10 against exact ground truth computed here on the
               card, wall QPS and kernel launches; fails below 0.95 at
               ef = 64;
  6. small     a 2000 x 32 index searched on the card and with the plain
               versions on the CPU must agree.
The kernels line and the card line come before the last line, which is
{"ok": true, "device": {...}}. A copy of the numbers goes to
build/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N, DIM, NQ, K = 1_000_000, 128, 8192, 10
EFS = (32, 64)
RECALL_FLOOR = 0.95
MAIN_SHAPE = (4096, 256, 128)        # search qchunk / build pool chunk x M*R x Dp
CHECK_SHAPES = (MAIN_SHAPE, (1000, 200, 96), (333, 77, 40))
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
FP32_OPS_PER_S = 67e12               # H100 SXM float32 off the tensor cores:
                                     # the kernel's FMAs run on the CUDA cores


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 3, reps: int = 25) -> float:
    """Median milliseconds of ``fn`` between CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check_diagdot(torch, dev) -> dict:
    from alayalite_tpu_torch.ops.diagdot import block_diagdot, block_diagdot_ref

    result = {}
    rng = np.random.default_rng(0)
    for shape in CHECK_SHAPES:
        B, Kr, Dp = shape
        codes = torch.as_tensor(rng.integers(0, 256, size=shape,
                                             dtype=np.uint8), device=dev)
        qs = torch.as_tensor(rng.normal(size=(B, Dp)).astype(np.float32),
                             device=dev).to(torch.bfloat16)
        got = block_diagdot(codes, qs)
        torch.cuda.synchronize()
        want = block_diagdot_ref(codes, qs)
        err = float((got - want).abs().max())
        tol = 1e-3 * float(want.abs().max()) + 1e-3
        log(f"kernel block_diagdot {shape}: max_abs_err={err:.3e} "
            f"(tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"block_diagdot disagrees at {shape}: "
                                 f"{err} > {tol}")
        if shape != MAIN_SHAPE:
            continue
        ms = cuda_ms(lambda: block_diagdot(codes, qs))
        plain_ms = cuda_ms(lambda: block_diagdot_ref(codes, qs))
        library_ms = cuda_ms(lambda: torch.bmm(
            (codes.to(torch.int16) - 128).to(torch.bfloat16),
            qs.unsqueeze(2)))
        nbytes = B * Kr * Dp + B * Dp * 2 + B * Kr * 4
        ops = 2 * B * Kr * Dp
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "library_ms": library_ms,
                  "bound_ms": max(bytes_ms, ops_ms),
                  "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                  "bytes": nbytes, "shape": list(shape)}
        log(f"kernel block_diagdot {shape}: {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library bmm {library_ms:.4f} ms, bound "
            f"{result['bound_ms']:.4f} ms ({nbytes} bytes)")
    return result


def ground_truth(torch, data, queries, k: int) -> np.ndarray:
    """Exact l2 top-k on the card, chunked float32 matmuls."""
    x_sq = (data * data).sum(1)
    out = []
    for lo in range(0, queries.shape[0], 1024):
        q = queries[lo:lo + 1024]
        d = x_sq[None, :] - 2.0 * (q @ data.T)
        out.append(torch.topk(d, k, dim=1, largest=False).indices)
    return torch.cat(out).cpu().numpy()


def small_agreement(torch) -> dict:
    """Same index searched through the kernel and through the plain
    versions on the CPU: the results must agree."""
    import tempfile

    from alayalite_tpu_torch import Index, IndexParams
    from alayalite_tpu_torch.utils.datasets import random_dataset
    from alayalite_tpu_torch.utils.evaluate import calc_gt, calc_recall

    ds = random_dataset(n=2000, dim=32, n_queries=256, seed=3)
    gt = calc_gt(ds.data, ds.queries, K)
    gpu = Index("small", IndexParams(quantization_type="bsq8", capacity=2000,
                                     max_nbrs=16, ef_construction=64))
    gpu.fit(ds.data)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        gpu.save(os.path.join(tmp, "small"))
        cpu = Index.load(tmp, "small", device="cpu")
    ids_g, d_g = gpu.batch_search_with_distance(ds.queries, K, ef_search=64)
    ids_c, d_c = cpu.batch_search_with_distance(ds.queries, K, ef_search=64)
    same = float((ids_g == ids_c).mean())
    rec_g, rec_c = calc_recall(ids_g, gt), calc_recall(ids_c, gt)
    log(f"small: recall gpu {rec_g:.4f} cpu {rec_c:.4f}, same ids {same:.4f}")
    if not (np.isfinite(d_g).all() and same >= 0.98
            and abs(rec_g - rec_c) <= 0.01 and rec_g >= 0.9):
        raise AssertionError("GPU and CPU searches of one index disagree")
    return {"recall_gpu": rec_g, "recall_cpu": rec_c, "same_ids": same}


def main() -> int:
    t_start = time.time()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from alayalite_tpu_torch import Client
    from alayalite_tpu_torch.device import resolve_device
    from alayalite_tpu_torch.ops import _build
    from alayalite_tpu_torch.ops.diagdot import block_diagdot
    from alayalite_tpu_torch.utils.datasets import random_dataset
    from alayalite_tpu_torch.utils.evaluate import calc_recall

    dev = resolve_device(None)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {name}")
    report = {"card": card, "device_name": name}

    t = time.time()
    built = _build.build()
    report["build_s"] = time.time() - t
    log(f"build: {sorted(built)} in {report['build_s']:.2f}s")

    report["block_diagdot"] = check_diagdot(torch, dev)

    t = time.time()
    # bench.py's synthetic SIFT1M stand-in: one cluster per 2000 rows
    ds = random_dataset(n=N, dim=DIM, n_queries=NQ, seed=42,
                        clusters=max(32, N // 2000))
    log(f"data: {N}x{DIM}, {NQ} queries in {time.time() - t:.1f}s")
    client = Client()
    idx = client.create_index("smoke", index_type="hnsw",
                              quantization_type="bsq8", max_nbrs=32,
                              ef_construction=200, prune_alpha=1.2,
                              seed_sample=16384, beam_expand=8, capacity=N)
    block_diagdot.launches = 0
    torch.cuda.synchronize()
    t = time.time()
    idx.fit(ds.data)
    torch.cuda.synchronize()
    fit_s = time.time() - t
    fit_launches = block_diagdot.launches
    timings = idx._engine.build_timings
    log(f"fit: {fit_s:.2f}s, phases "
        + ", ".join(f"{k}={v:.2f}s" for k, v in timings.items())
        + f", block_diagdot launches {fit_launches}, peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if fit_launches <= 0:
        raise AssertionError("the fit launched block_diagdot no time")
    report["fit"] = {"seconds": fit_s, "phases": timings,
                     "launches": fit_launches}

    t = time.time()
    xd = torch.as_tensor(ds.data, device=dev)
    qd = torch.as_tensor(ds.queries, device=dev)
    gt = ground_truth(torch, xd, qd, K)
    del xd
    log(f"ground truth: {time.time() - t:.2f}s")

    report["search"] = {}
    search_launches = 0
    for ef in EFS:
        idx.batch_search(ds.queries, K, ef_search=ef)            # warm-up
        block_diagdot.launches = 0
        torch.cuda.synchronize()
        t = time.time()
        ids, dist = idx.batch_search_with_distance(ds.queries, K,
                                                   ef_search=ef)
        torch.cuda.synchronize()
        wall = time.time() - t
        launches = block_diagdot.launches
        search_launches += launches
        if ids.shape != (NQ, K) or not np.isfinite(dist).all() or (
                ids < 0).any() or (ids >= N).any():
            raise AssertionError(f"malformed search result at ef={ef}")
        rec = calc_recall(ids, gt)
        log(f"search ef={ef}: recall@10 {rec:.4f}, {NQ / wall:.1f} QPS "
            f"(wall {wall:.3f}s), block_diagdot launches {launches}")
        if launches <= 0:
            raise AssertionError("the search launched block_diagdot no time")
        report["search"][ef] = {"recall": rec, "qps": NQ / wall,
                                "wall_s": wall, "launches": launches}
    if report["search"][64]["recall"] < RECALL_FLOOR:
        raise AssertionError(f"recall@10 at ef=64 below {RECALL_FLOOR}")

    report["small"] = small_agreement(torch)
    report["total_s"] = time.time() - t_start

    kd = report["block_diagdot"]
    kernels = {"kernels": [{
        "name": "block_diagdot", "route": "cuda",
        "source": "alayalite_tpu_torch/csrc/diagdot.cu",
        "replaces": "alayalite_tpu/ops/pallas_block.py:46",
        "launches": fit_launches + search_launches,
        "max_abs_err": kd["max_abs_err"], "ms": kd["ms"],
        "plain_ms": kd["plain_ms"], "bound_ms": kd["bound_ms"],
        "bound_by": kd["bound_by"], "library_ms": kd["library_ms"]}]}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump({**report, **kernels}, f, indent=1)
    log(f"total: {report['total_s']:.1f}s")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
