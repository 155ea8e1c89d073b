#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on a GPU: ``python3 chip_smoke.py``.

Needs one CUDA device and nvcc. Phases, in order; any failure raises and
the script exits non-zero:
  1. card      nvidia-smi name and power limit, torch device name;
  2. build     every CUDA source of the port, one nvcc each, in parallel;
  3. kernels   block_diagdot against its plain PyTorch version on the card
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
The bsq8 index is freed, then the flat path runs on the same data:
  7. tiles     l2_tile and sq8_tile against their plain versions at the flat
               scan's tile (4096 x 16384 x 128, l2), at 4096 x 65536 x 128
               and at ragged shapes, with times, bounds and library calls;
  8. flat      Client().create_index(flat + sq8) fitted on the 1M rows; one
               exact search of the 8192 queries, k = 10: recall@10 against
               the ground truth of phase 5 (fails below 0.999), returned
               distances against direct f32 distances, wall QPS, l2_tile
               launches (fails at 0);
  9. fast      a flat index with flat_mode="fast": recall@10 (fails below
               0.99), wall QPS;
 10. upkeep    remove 10,000 ids and search again (none may come back);
               insert 1,000 new rows (each must be its own top-1);
 11. sq8       sq8_tile on the flat index's fitted codes (the first 65,536
               rows, 4096 queries) against its plain version and against
               the exact distance to the decoded rows.
The kernels line and the card line come before the last line, which is
{"ok": true, "device": {...}}. A copy of the numbers goes to
build/chip_smoke.json.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N, DIM, NQ, K = 1_000_000, 128, 8192, 10
EFS = (32, 64)
RECALL_FLOOR = 0.95
FLAT_EXACT_FLOOR, FLAT_FAST_FLOOR = 0.999, 0.99
MAIN_SHAPE = (4096, 256, 128)        # search qchunk / build pool chunk x M*R x Dp
CHECK_SHAPES = (MAIN_SHAPE, (1000, 200, 96), (333, 77, 40))
L2_MAIN = (4096, 16384, 128)         # flat exact scan: qchunk x tile_n x D
SQ8_MAIN = (4096, 65536, 128)        # distance-tile bench shape
TILE_SHAPES = {"l2_tile": (L2_MAIN, SQ8_MAIN, (1000, 3000, 96),
                           (333, 777, 40)),
               "sq8_tile": (SQ8_MAIN, (1000, 3000, 96), (333, 777, 40))}
N_REMOVE, N_INSERT = 10_000, 1_000


def log(msg: str) -> None:
    print(msg, flush=True)


def tolerance(want) -> float:
    return 1e-4 * float(want.abs().max()) + 1e-3


def check_diagdot(torch, dev) -> dict:
    from alayalite_tpu_torch.ops.diagdot import block_diagdot, block_diagdot_ref
    from alayalite_tpu_torch.utils.timing import bound, cuda_ms

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
        # the FMAs run on the CUDA cores
        b = bound(B * Kr * Dp + B * Dp * 2 + B * Kr * 4, 2 * B * Kr * Dp,
                  "f32")
        result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "library_ms": library_ms, **b, "shape": list(shape)}
        log(f"kernel block_diagdot {shape}: {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library bmm {library_ms:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bytes']} bytes)")
    return result


def check_tiles(torch, dev) -> dict:
    """l2_tile and sq8_tile against their plain versions; times, bounds and
    library calls at each kernel's first shape."""
    from alayalite_tpu_torch.ops.l2_tile import l2_tile, l2_tile_ref
    from alayalite_tpu_torch.ops.sq8_tile import sq8_tile, sq8_tile_ref
    from alayalite_tpu_torch.utils.timing import bound, cuda_ms

    rng = np.random.default_rng(1)
    out = {}
    for name, shapes in TILE_SHAPES.items():
        out[name] = {"errors": {}}
        for Q, Nx, D in shapes:
            q = torch.as_tensor(rng.normal(size=(Q, D)).astype(np.float32),
                                device=dev)
            if name == "l2_tile":
                x = torch.as_tensor(rng.normal(size=(Nx, D)).astype(
                    np.float32) * 3.0, device=dev)
                args, kern, ref = (q, x), l2_tile, l2_tile_ref
                nbytes = (Q * D + Nx * D + Q * Nx) * 4
                kind = "f32"

                def library(q=q, x=x):
                    return torch.matmul(q, x.T)
            else:
                codes = torch.as_tensor(rng.integers(0, 256, size=(Nx, D),
                                                     dtype=np.uint8),
                                        device=dev)
                dmin = torch.as_tensor(rng.normal(size=D).astype(np.float32)
                                       - 4.0, device=dev)
                scale = torch.as_tensor(rng.uniform(0.01, 0.05, size=D)
                                        .astype(np.float32), device=dev)
                args, kern, ref = (q, codes, dmin, scale), sq8_tile, sq8_tile_ref
                nbytes = Q * D * 4 + Nx * D + 2 * D * 4 + Q * Nx * 4
                kind = "bf16"       # the TPU kernel's bf16 product

                def library(q=q, codes=codes, scale=scale):
                    return torch.matmul(
                        (q * scale).to(torch.bfloat16),
                        (codes.to(torch.int16) - 128).to(torch.bfloat16).T)
            got = kern(*args)
            torch.cuda.synchronize()
            want = ref(*args)
            err, tol = float((got - want).abs().max()), tolerance(want)
            del got, want
            log(f"kernel {name} {(Q, Nx, D)}: max_abs_err={err:.3e} "
                f"(tol {tol:.3e})")
            if not err <= tol:
                raise AssertionError(f"{name} disagrees at {(Q, Nx, D)}: "
                                     f"{err} > {tol}")
            out[name]["errors"][str((Q, Nx, D))] = err
            if (Q, Nx, D) != shapes[0]:
                continue
            b = bound(nbytes, 2 * Q * Nx * D + 3 * Q * Nx, kind)
            times = {"ms": cuda_ms(lambda: kern(*args)),
                     "plain_ms": cuda_ms(lambda: ref(*args)),
                     "library_ms": cuda_ms(library)}
            out[name].update(max_abs_err=err, shape=[Q, Nx, D], **b, **times)
            log(f"kernel {name} {(Q, Nx, D)}: {times['ms']:.4f} ms, plain "
                f"{times['plain_ms']:.4f} ms, library {times['library_ms']:.4f}"
                f" ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
            torch.cuda.empty_cache()
    return out


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


def timed_search(torch, idx, queries, k: int, counters, **kw):
    """One warm-up call, then the counters set to 0 and one synchronised
    call: (ids, dists, wall seconds, {counter: launches})."""
    idx.batch_search(queries, k, **kw)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t = time.time()
    ids, dist = idx.batch_search_with_distance(queries, k, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t
    return ids, dist, wall, {c.__name__: c.launches for c in counters}


def check_result(ids, dist, n_rows: int, what: str) -> None:
    if ids.shape[1] != K or not np.isfinite(dist).all() or (
            ids < 0).any() or (ids >= n_rows).any():
        raise AssertionError(f"malformed search result: {what}")


def flat_phases(torch, dev, ds, gt) -> dict:
    """Phases 8-11 on the 1M rows: exact and fast flat search, removes and
    inserts, sq8_tile on the fitted codes."""
    from alayalite_tpu_torch import Client
    from alayalite_tpu_torch.ops.l2_tile import l2_tile
    from alayalite_tpu_torch.ops.sq8_tile import sq8_tile, sq8_tile_ref
    from alayalite_tpu_torch.utils.evaluate import calc_recall

    client = Client()
    rep = {}
    idx = client.create_index("flat", index_type="flat",
                              quantization_type="sq8", capacity=N + N_INSERT)
    l2_tile.launches = 0
    torch.cuda.synchronize()
    t = time.time()
    idx.fit(ds.data)
    torch.cuda.synchronize()
    rep["fit_s"] = time.time() - t
    ids, dist, wall, launches = timed_search(torch, idx, ds.queries, K,
                                             (l2_tile,))
    check_result(ids, dist, N, "flat exact")
    rec = calc_recall(ids, gt)
    # direct f32 distances of the returned ids. The index's expansion
    # |q|² + |x|² − 2 q·x rounds sums of D terms near |q|² + |x|² (~4,400
    # here), so its error scales with that magnitude, not with the
    # distance: allowed 1e-4·d + 2·sqrt(D)·eps·(|q|² + |x|²)
    xd = torch.as_tensor(ds.data, device=dev)
    qd = torch.as_tensor(ds.queries, device=dev)
    rows = xd[torch.as_tensor(ids, device=dev).long()]
    ref = ((rows - qd[:, None, :]) ** 2).sum(-1)
    ulps = float(torch.finfo(torch.float32).eps) * (
        (qd * qd).sum(1)[:, None] + (rows * rows).sum(-1))
    err = (torch.as_tensor(dist, device=dev) - ref).abs()
    bad = int((err > 1e-4 * ref + 2 * DIM ** 0.5 * ulps).sum())
    worst = float((err / ulps).max())
    del rows, ref, ulps, err
    rep["exact"] = {"recall": rec, "qps": NQ / wall, "wall_s": wall,
                    "l2_tile_launches": launches["l2_tile"],
                    "distance_mismatches": bad,
                    "worst_error_in_eps_of_norms": worst}
    log(f"flat exact: fit {rep['fit_s']:.2f}s, recall@10 {rec:.5f}, "
        f"{NQ / wall:.1f} QPS (wall {wall:.3f}s), l2_tile launches "
        f"{launches['l2_tile']}, distance mismatches {bad} (worst error "
        f"{worst:.2f} eps·(|q|² + |x|²))")
    if launches["l2_tile"] <= 0:
        raise AssertionError("the flat exact search launched l2_tile no time")
    if rec < FLAT_EXACT_FLOOR or bad:
        raise AssertionError("flat exact search is not exact")

    fast = client.create_index("flat_fast", index_type="flat",
                               flat_mode="fast", capacity=N)
    fast.fit(ds.data)
    ids_f, dist_f, wall_f, _ = timed_search(torch, fast, ds.queries, K, ())
    check_result(ids_f, dist_f, N, "flat fast")
    rec_f = calc_recall(ids_f, gt)
    rep["fast"] = {"recall": rec_f, "qps": NQ / wall_f, "wall_s": wall_f}
    log(f"flat fast: recall@10 {rec_f:.5f}, {NQ / wall_f:.1f} QPS "
        f"(wall {wall_f:.3f}s)")
    del fast
    if rec_f < FLAT_FAST_FLOOR:
        raise AssertionError(f"flat fast recall below {FLAT_FAST_FLOOR}")

    rng = np.random.default_rng(7)
    dead = rng.choice(N, size=N_REMOVE, replace=False).astype(np.int32)
    idx.remove(dead)
    ids_r = idx.batch_search(ds.queries, K)
    back = int(np.isin(ids_r, dead).sum())
    new = (rng.normal(size=(N_INSERT, DIM)) * 4.0).astype(np.float32)
    new_ids = idx.insert(new)
    top1 = idx.batch_search(new, 1)[:, 0]
    own = float((top1 == new_ids).mean())
    rep["upkeep"] = {"removed_returned": back, "inserted_own_top1": own,
                     "new_ids": [int(new_ids.min()), int(new_ids.max())]}
    log(f"upkeep: {back} of {N_REMOVE} removed ids returned; inserted rows "
        f"{new_ids.min()}..{new_ids.max()} own top-1 share {own:.4f}")
    if back or own < 1.0:
        raise AssertionError("removes or inserts of the flat index failed")

    sp = idx._engine.search_space
    q = qd[:SQ8_MAIN[0]].contiguous()
    codes = sp.codes[:SQ8_MAIN[1]]
    sq8_tile.launches = 0
    got = sq8_tile(q, codes, sp.dmin, sp.scale)
    torch.topk(got, 40, dim=1, largest=False)
    torch.cuda.synchronize()
    sq8_launches = sq8_tile.launches
    want = sq8_tile_ref(q, codes, sp.dmin, sp.scale)
    err, tol = float((got - want).abs().max()), tolerance(want)
    del want
    # against the exact distance to the decoded rows: rounding q∘scale to
    # bf16 (relative 2^-8) moves 2·q·x̂ by at most 2^-7·|q∘scale|·|c − 128|ᵀ,
    # plus f32 rounding of both expansions near |q|² + |x̂|²
    dec = sp.decode(torch.arange(SQ8_MAIN[1], device=dev))
    norms = (q * q).sum(1)[:, None] + (dec * dec).sum(1)[None, :]
    exact = norms - 2.0 * (q @ dec.T)
    off = (got - exact).abs()
    allowed = (2.0 ** -7 * ((q * sp.scale).abs()
                            @ (codes.float() - 128.0).abs().T)
               + 4 * DIM ** 0.5 * float(torch.finfo(torch.float32).eps)
               * norms)
    excess = float((off - allowed).max())
    loose = float((off > 3e-2 * exact.abs() + 2.0).float().mean())
    del dec, norms, exact, off, allowed
    rep["sq8"] = {"launches": sq8_launches, "max_abs_err": err,
                  "decoded_excess": excess,
                  "share_outside_rtol3e-2_atol2": loose}
    log(f"sq8 on fitted codes {SQ8_MAIN}: launches {sq8_launches}, "
        f"max_abs_err {err:.3e} (tol {tol:.3e}); against decoded rows "
        f"{'within' if excess <= 0 else 'outside'} the bf16 rounding bound "
        f"(max excess {excess:.3e}), share outside rtol 3e-2 / atol 2.0 "
        f"{loose:.2e}")
    if sq8_launches <= 0 or not err <= tol or excess > 0:
        raise AssertionError("sq8_tile on the fitted codes failed")
    return rep


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
    from alayalite_tpu_torch.ops.l2_tile import l2_tile
    from alayalite_tpu_torch.ops.sq8_tile import sq8_tile
    from alayalite_tpu_torch.utils.datasets import random_dataset
    from alayalite_tpu_torch.utils.evaluate import calc_recall
    from alayalite_tpu_torch.utils.timing import card_line

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
    block_diagdot.launches = l2_tile.launches = sq8_tile.launches = 0
    torch.cuda.synchronize()
    t = time.time()
    idx.fit(ds.data)
    torch.cuda.synchronize()
    fit_s = time.time() - t
    fit_launches = block_diagdot.launches
    timings = idx._engine.build_timings
    log(f"fit: {fit_s:.2f}s, phases "
        + ", ".join(f"{k}={v:.2f}s" for k, v in timings.items())
        + f", block_diagdot launches {fit_launches}, l2_tile launches "
        f"{l2_tile.launches} (find_medoid), peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if fit_launches <= 0:
        raise AssertionError("the fit launched block_diagdot no time")
    report["fit"] = {"seconds": fit_s, "phases": timings,
                     "launches": fit_launches,
                     "l2_tile_launches": l2_tile.launches}

    t = time.time()
    xd = torch.as_tensor(ds.data, device=dev)
    qd = torch.as_tensor(ds.queries, device=dev)
    gt = ground_truth(torch, xd, qd, K)
    del xd, qd
    log(f"ground truth: {time.time() - t:.2f}s")

    report["search"] = {}
    search_launches = 0
    for ef in EFS:
        ids, dist, wall, launches = timed_search(
            torch, idx, ds.queries, K, (block_diagdot,), ef_search=ef)
        launches = launches["block_diagdot"]
        search_launches += launches
        check_result(ids, dist, N, f"bsq8 ef={ef}")
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
    del idx, client
    gc.collect()
    torch.cuda.empty_cache()

    report["tiles"] = check_tiles(torch, dev)
    report["flat"] = flat_phases(torch, dev, ds, gt)
    report["total_s"] = time.time() - t_start

    def row(name, source, replaces, launches, nums):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                **{k: nums[k] for k in keys}}

    kernels = {"kernels": [
        row("block_diagdot", "alayalite_tpu_torch/csrc/diagdot.cu",
            "alayalite_tpu/ops/pallas_block.py:46",
            fit_launches + search_launches, report["block_diagdot"]),
        row("l2_tile", "alayalite_tpu_torch/csrc/l2_tile.cu",
            "alayalite_tpu/ops/pallas_distance.py:43",
            report["flat"]["exact"]["l2_tile_launches"],
            report["tiles"]["l2_tile"]),
        row("sq8_tile", "alayalite_tpu_torch/csrc/sq8_tile.cu",
            "alayalite_tpu/ops/pallas_distance.py:91",
            report["flat"]["sq8"]["launches"], report["tiles"]["sq8_tile"]),
    ]}
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
