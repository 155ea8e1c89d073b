#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on a GPU: ``python3 chip_smoke.py``.

Needs one CUDA device and nvcc. Phases, in order; any failure raises and
the script exits non-zero:
  1. card      nvidia-smi name and power limit, torch device name;
  2. build     every CUDA source of the port, one nvcc each, in parallel,
               each one's seconds and compiler warnings logged; sq8_tile's
               SASS must hold HGMMA (cuobjdump -sass);
  3. kernels   block_diagdot (gather_diagdot.cu's rows kernel with no index
               to read; also one query, K of 13, Dp 40 and 96, qs or codes
               off a 16-byte boundary), gather_diagdot (its rows and bulk entries,
               at the hop's shape, the sq8 traversal's R = 1, Dp % 16 != 0;
               bulk must raise where it does not take the codes),
               gather_estimate (the same entries with estimate_many's
               epilogue fused in: est bit for bit against the PyTorch
               epilogue on the entry's own dot, ids exactly, L2 and IP)
               against their plain PyTorch versions on the card at the
               main-path shapes and at ragged shapes, with CUDA-event times
               of the kernel, the plain version and a library route ("ms"
               holds the host's launch latency, as every earlier number
               does; "ms_spin" is the device's time alone); ring_probe's two
               kernels ("hash", a table per query in shared memory; "scan")
               and its routed call against the plain version, bit for bit,
               at the paths' shapes (the bsq8 search's pop ring 96 + pool
               64, the build pools' 96 + 128 and 96 + 200, the raw ring
               walk's 96, the fusion hop's 512 ids), ragged shapes and ids
               that break a hash table (INT_MIN, INT_MAX, -1, rows of one
               id, one seen entry, a width past the hash kernel's), the
               routed call and both kernels timed at every path shape, its
               bound from the bytes it moves and the hash's own O(K + S)
               work (the scan's O(K * S) compares kept beside it); then the
               pool's sort and merge: sort_kv (rows, columns, keys only;
               its warp route and its network, both bit for bit and timed
               at [4096, 256] with a payload, NN-Descent's 180 -> 32 and
               the search's 64 -> 10, keys with NaN, both zeros, +inf),
               merge_kv (a merge path, on NaN, both zeros, +-inf and ties
               across the operands; timed at 64 + 64 and at the paths'
               10 + 10 -> 10, 40 + 40 -> 40 and 1 + 1 -> 1 beside an empty
               kernel's event span), pool_merge (the hop's merge_topk_dedup, on ties,
               duplicates, +inf / -1 slots, both zeros, negative keys, and
               on pools with dedup's holes, which are not ascending; both
               of its kernels, the warp route and the shared-memory network
               for lists past pool_sort.WARP_LIST; timed at ef 32, 64 and
               128 against 256 candidates and at the fusion index's 64 +
               512 beside the network; its launches on the paths are
               counted by kernel, phase by phase, as pool_merge[warp] and
               pool_merge[network]) and
               roll_n (both of its kernels: the warp route for rows of 32·W
               words and the shared-memory one, timed beside one torch.roll
               by the summed shift), each bit for bit against its plain
               version at the hop's shapes and at ragged ones; and an sq8
               space's gather_dists (gather_diagdot on one-row blocks)
               against index_select + bmm written out here, timed at the
               hop's shape with the kernel's own time beside it;
  4. fit       Client().create_index(hnsw + bsq8, the repository's
               headline parameters, capacity 1M + 16,384) and fit on
               bench.py's data, random_dataset(1M x 128, seed 42, 500
               clusters), with per-phase seconds and kernel launches;
               then gather_diagdot and gather_estimate (both entries)
               against their plain versions on the fitted index's own code
               tensor, norms and ids, at node ids up to num - 1, whose byte
               offsets pass 2^31; every CUDA kernel one estimate_many call
               launches, counted by torch.profiler (fails unless one); the
               concatenation kernels a block hop launches, counted by
               torch.profiler (fails unless one a hop: the pop ring's
               shift; the stale check takes the pop ring and the pool as
               two operands);
  5. search    batch_search of 8192 queries at ef 32 and 64, k = 10,
               recall@10 against exact ground truth computed here on the
               card, wall QPS and kernel launches; fails below 0.95 at
               ef = 64, and unless every hop launched gather_estimate once;
  6. small     a 2000 x 32 index searched on the card and with the plain
               versions on the CPU must agree;
  6b. churn    on the 1M index: remove 10,000 ids and search (none may come
               back); insert 8,192 new rows drawn from the data's clusters,
               in two batches of 4,096, with rows/s and launches; each new
               row must be its own top-1 at ef 64 (fails below 0.95);
               gather_diagdot again on the grown code tensor; the
               new nodes' encoded blocks are audited through estimate_for
               (block_diagdot) against the distance to the decoded codes;
               compact(), after which no live row's adjacency may hold a
               removed id; recall@10 against ground truth recomputed over
               the live rows (fails below 0.95 at ef 64).
The bsq8 index is freed, then the raw graph path runs:
  6c. raw      Client().create_index(hnsw, the default parameters: no
               quantization, max_nbrs 32, ef_construction 200, prune_alpha
               1.0) fitted on the 1M rows with per-phase seconds; 8192
               queries at ef 32, 64 and 128 with recall@10, wall QPS, host
               syncs of the overlay descent and launches of pool_merge,
               sort_kv, merge_kv and ring_probe (each must be launched in
               the fit and in the search; the launches of pool_merge,
               sort_kv and ring_probe are counted by kernel on every path,
               and every path launch of sort_kv must take "warp" and of
               ring_probe "hash"); save, load, and the same ids.
               With alpha 1.0 the prune leaves ~10 of 32 edges per node at
               this size and the walk starts from one descent seed, so
               recall@10 at ef 64 reads 0.917-0.921 here, under the 0.95
               the other indices are held to. At 100k rows the port agrees
               with the JAX package's sweep (results/sweep_hnsw_100k.json)
               within 0.002; no reading of the JAX package at 1M is at
               hand. The phase fails below 0.75 / 0.91 / 0.965 at ef 32 /
               64 / 128, just under what this index reads. The same index
               with the headline's prune_alpha 1.2 (as phase 4 uses) is
               fitted too and fails below 0.89 / 0.95 at ef 32 / 64.
               Raw churn on the loaded default index (capacity 1M +
               16,384): remove 10,000 random ids (none may come back),
               pack the insert's bsq8 shadow (seconds), insert 8,192 rows
               from the data's clusters in two batches of 4,096 through the
               shadow (rows/s and launches a batch; fails unless
               gather_estimate ran), own top-1 at ef 64 (fails below 0.95),
               compact (seconds; fails if a removed id is left in a live
               row or an overlay level, or an entry point is dead), recall@10
               over the live rows at ef 64 (fails below 0.90, 0.01 under the
               ef-64 floor above);
  6d. 100k     nsg, fusion and hnsw + sq8 on random_dataset(100,000 x 128,
               seed 42, 50 clusters), the data of the JAX package's 100k
               sweeps (scripts/sweep.py): fit, search, recall@10 (each
               fails below 0.95 at ef 64 and below a floor just under its
               own readings at ef 32); fusion (rows of 64, its inserts
               searched through a shadow of degree 64) and hnsw + sq8 (the
               sq8 traversal, gather_diagdot; no shadow) then churn:
               1,000 removes, 1,024 inserts, compact (own top-1 fails below
               0.95, recall@10 at ef 64 below 0.93; fusion must return the
               same ids after a save and load).
Then the flat path runs on the same data:
  7. tiles     l2_tile and sq8_tile against their plain versions at the flat
               scan's tile (4096 x 16384 x 128, l2), at 4096 x 65536 x 128
               and at ragged shapes (sq8 also D = 100 and 960), with times,
               bounds and library calls (sq8: the bf16-output product, and
               library_f32_ms, the same product with the kernel's f32
               output);
  8. flat      Client().create_index(flat + sq8) fitted on the 1M rows; one
               exact search of the 8192 queries, k = 10: recall@10 against
               the ground truth of phase 5 (fails below 0.999), returned
               distances against direct f32 distances, wall QPS, l2_tile
               and merge_kv launches (fails at 0);
  9. fast      a flat index with flat_mode="fast": recall@10 (fails below
               0.99), wall QPS, merge_kv launches (fails at 0);
 10. upkeep    remove 10,000 ids and search again (none may come back);
               insert 1,000 new rows (each must be its own top-1);
 11. sq8       sq8_tile on the flat index's fitted codes (the first 65,536
               rows, 4096 queries) against its plain version and against
               the exact distance to the decoded rows.
Then the SDK front door and RaBitQ:
 12. collection Client(url=<a directory under build/>), create_collection
               (the default raw hnsw, capacity 1M + 16,384): one insert of
               the 1M rows as items ("d{i}", a document, {"shard": i %
               500}), 8,192 new items from the data's clusters, an upsert
               of 1,024 ids with moved vectors, delete_by_filter of shard 7
               (2,000 rows); batch_query of the 8192 queries at ef 64:
               recall@10 against this script's ground_truth over the
               live rows on the card (fails below 0.90), no deleted id, every document its id's,
               the new items' own top-1 (fails below 0.95); each step's
               seconds, items/s and QPS; save_collection, then a fresh
               Client(url) must find it and return the same ids;
 13. reindex   a 100k-row collection on phase 6d's data, 1% deleted,
               reindex(): recall@10 at ef 64 (fails below 0.95);
 14. calc_gt   on the card at 1M x 8192, k 10, exact (l2_tile) and fast
               (bf16 scan, f32 rerank), seconds each; exact must hold
               ≥ 0.9999 of this script's ground_truth ids (ties aside),
               fast ≥ 0.999 of the exact ids;
 15. rabitq    the 1-bit index of results/sift1m_frontier.json
               (hnsw_rabitq_R32_efc200: max_nbrs 32, ef_construction 200,
               prune_alpha 1.0, seed_sample 4096, rabitq_ef_boost 4,
               beam_expand 8, hop budget max(3, ef // 8)) on the 1M rows:
               fit seconds by phase; recall@10 at ef 48 / 64 / 96 (floors
               0.01 under the JAX package's 0.9261 / 0.9493 / 0.9710);
               every search must launch block_diagdot once a hop; the hop's
               dot on the index's own blocks against block_diagdot_ref and
               the planes-apart form, timed; insert 4,096 rows (own top-1,
               fails below 0.95), remove 10,000 (none may come back),
               save/load (the same ids);
 16. rabitq2   the 2-bit index on phase 6d's data with the defaults:
               recall@10 at ef 96 (fails below 0.95), save/load.
A summary line (the end-to-end numbers of every phase), the kernels line
and the card line come before the last line, which is
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
# least recall@10 of the raw graph phases by ef: 0.95 at ef 64 where the
# index reaches it, elsewhere just under the readings of earlier runs
RAW_FLOORS = {"hnsw_1m": {32: 0.75, 64: 0.91, 128: 0.965},   # prune_alpha 1.0
              "hnsw_1m_alpha12": {32: 0.89, 64: RECALL_FLOOR},
              "nsg_100k": {32: 0.89, 64: RECALL_FLOOR},
              "fusion_100k": {32: 0.93, 64: RECALL_FLOOR},
              "hnsw_sq8_100k": {32: 0.90, 64: RECALL_FLOOR}}
FLAT_EXACT_FLOOR, FLAT_FAST_FLOOR = 0.999, 0.99
MAIN_SHAPE = (4096, 256, 128)        # search qchunk / build pool chunk x M*R x Dp
CHECK_SHAPES = (MAIN_SHAPE, (1000, 200, 96), (333, 77, 40))
# block_diagdot's odd shapes: one query, K not a multiple of a group's 8
# rows, Dp 40 and 96 (byte loads), each also with qs and with codes one
# element past a 16-byte boundary (byte loads at any Dp)
DIAGDOT_ODD = ((1, 256, 128), (7, 13, 128), (333, 77, 96), (1, 5, 40))
L2_MAIN = (4096, 16384, 128)         # flat exact scan: qchunk x tile_n x D
SQ8_MAIN = (4096, 65536, 128)        # distance-tile bench shape
TILE_SHAPES = {"l2_tile": (L2_MAIN, SQ8_MAIN, (1000, 3000, 96),
                           (333, 777, 40)),
               "sq8_tile": (SQ8_MAIN, (1000, 3000, 96), (333, 777, 40),
                            (97, 1000, 100), (130, 333, 960))}
N_REMOVE, N_INSERT = 10_000, 1_000
SPARE = 16_384                       # bsq8 capacity past the fitted rows
CHURN_INSERT, CHURN_BATCH = 8_192, 4_096
CHURN_FLOOR = 0.95                   # own top-1 share and recall@10 at ef 64
# gather_diagdot: (nodes C, R, Dp, B, M); the main shape is the hop's, over
# codes for 100,000 nodes; R = 1 is the sq8 traversal's (4096 queries x 256
# ids over 100,000 x 128 codes viewed as one-row blocks)
GATHER_MAIN = (100_000, 32, 128, 4096, 8)
GATHER_R1 = (100_000, 1, 128, 4096, 256)
GATHER_SHAPES = (GATHER_MAIN, GATHER_R1, (5_000, 24, 96, 1000, 5),
                 (900, 7, 40, 333, 3), (5_000, 1, 100, 1000, 77))
# ring_probe: (B, K, S, S2) at the paths' shapes: the bsq8 search at ef 64
# (K = M*R 256; S the pop ring, 96; S2 the pool, 64) first, then the build
# pools at ef 128 and at ef_construction 200, the raw ring walk at ef 64
# (the pop ring alone) and the fusion hop (64 neighbors of 8 pops); then
# ragged shapes
PROBE_MAIN = (4096, 256, 96, 64)
PROBE_PATHS = (PROBE_MAIN, (4096, 256, 96, 128), (4096, 256, 96, 200),
               (4096, 256, 96, 0), (4096, 512, 96, 0))
PROBE_RAGGED = ((1000, 200, 77, 0), (333, 77, 1, 0), (1000, 77, 13, 5),
                (333, 300, 0, 37))
# the pool's sort and merge: the hop sorts [qchunk, ef + M*R]; the last
# ragged width passes pool_sort.WARP_LIST and takes sort_kv's network
SORT_MAIN = (4096, 256)
SORT_RAGGED = ((1, 1), (333, 77), (1000, 200), (333, 320), (1, 200),
               (1000, 77), (100, 1000))
# sort_kv's warp route against its network at the paths' shapes: (B, K, k,
# payload): the hop's width with a payload, NN-Descent's join (32 + 148 ->
# 32) and the search's final k (ef 64 -> 10), keys only with positions
SORT_PATHS = ((4096, 256, 256, True), (4096, 180, 32, False),
              (4096, 64, 10, False))
# merge_kv (B, L1, L2, k; ascending operands) timed: 64 + 64 and the paths'
# shapes, the exact flat scan's 10 + 10 -> 10 and the fast scan's coarse
# 40 + 40 -> 40 (4096-query slices), find_medoid's 1 + 1 -> 1; then shapes
# only checked
MERGE_TIMED = ((4096, 64, 64, 128), (4096, 10, 10, 10), (4096, 40, 40, 40),
               (1, 1, 1, 1))
MERGE_RAGGED = ((4096, 32, 32, 64), (333, 10, 100, 10), (1000, 100, 77, 177),
                (1, 1, 200, 1), (333, 7, 0, 7))
POOL_MAIN = (4096, 64, 256)                         # B, pool ef, M*R
# every (B, ef, M*R) the hops launch, k = ef: the searches at ef 32, 64,
# 128 and the build pools (ef 128) of both graph paths, and the fusion
# index's search at ef 64 (rows of 64 ids: M*R = 512)
POOL_HOP = ((4096, 32, 256), POOL_MAIN, (4096, 128, 256), (4096, 64, 512))
# ragged shapes; the last two pass pool_sort.WARP_LIST and take the
# shared-memory network
POOL_RAGGED = ((1000, 100, 256), (333, 10, 8), (1, 200, 77), (333, 128, 32),
               (1000, 10, 10), (333, 64, 2000), (100, 1500, 100))
ROLLS = (36, 144)
N_SMALL = 100_000                    # rows of phase 6d
# raw churn (phases 6c, 6d): (removes, inserts, rows a batch, floor of the
# new rows' own top-1 share, floor of recall@10 at ef 64 over the live
# rows). The default raw hnsw at 1M reads 0.917-0.921 before churn, so its
# floor is 0.90, 0.01 under phase 6c's ef-64 floor; the 100k indices' is
# 0.93
RAW_CHURN = {"hnsw_1m": (N_REMOVE, CHURN_INSERT, CHURN_BATCH, CHURN_FLOOR,
                         0.90),
             "small": (1_000, 1_024, 1_024, CHURN_FLOOR, 0.93)}
# the collection phase (12): 1M items in 500 shards (metadata {"shard": i %
# 500}), then 8,192 new items, an upsert of 1,024 ids with moved vectors,
# a delete_by_filter of shard 7 (2,000 rows); recall@10 floor at ef 64 over
# the live rows: the default raw hnsw reads 0.917-0.921 at 1M
COLLECTION_SHARDS, COLLECTION_DEAD_SHARD = 500, 7
COLLECTION_NEW, COLLECTION_UPSERT = 8_192, 1_024
COLLECTION_FLOOR = 0.90
REINDEX_DEAD, REINDEX_FLOOR = 0.01, 0.95     # phase 13, 100k rows
GT_EXACT_AGREEMENT = 0.9999                  # phase 14, ties aside
GT_FAST_AGREEMENT = 0.999                    # phase 14
# phase 15: the 1-bit rabitq of results/sift1m_frontier.json,
# hnsw_rabitq_R32_efc200 (hop budget max(3, ef // 8)); the JAX package read
# recall@10 0.9261 / 0.9493 / 0.9710 at ef 48 / 64 / 96 on this data, and
# each floor is 0.01 under its reading
RABITQ_PARAMS = dict(index_type="hnsw", quantization_type="rabitq",
                     max_nbrs=32, ef_construction=200, prune_alpha=1.0,
                     seed_sample=4096, rabitq_ef_boost=4.0, beam_expand=8)
RABITQ_FLOORS = {48: 0.9161, 64: 0.9393, 96: 0.9610}
RABITQ_INSERT, RABITQ_REMOVE = 4_096, 10_000
# phase 16: rabitq2 at 100k with the defaults; the JAX package's sweep
# read 0.9836 at ef 96 (results/sweep_rabitq2_100k.json)
RABITQ2_FLOORS = {96: 0.95}
NEW_PHASES = ("collection", "reindex", "calc_gt", "rabitq", "rabitq2")


def log(msg: str) -> None:
    print(msg, flush=True)


def tolerance(want) -> float:
    return 1e-4 * float(want.abs().max()) + 1e-3


def _shifted(torch, t):
    """A contiguous copy of ``t`` one element past its allocation's start,
    so that its base is not 16-byte aligned."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return flat[1:].view(t.shape).copy_(t)


def check_diagdot(torch, dev) -> dict:
    """block_diagdot (gather_diagdot.cu's rows kernel with the identity
    gather) against its plain version at every CHECK_SHAPES entry and at
    the odd shapes, aligned and not; times at the main shape."""
    from alayalite_tpu_torch.ops.diagdot import block_diagdot, block_diagdot_ref
    from alayalite_tpu_torch.utils.timing import bound, cuda_ms

    result = {}
    rng = np.random.default_rng(0)
    for shape in (*CHECK_SHAPES, *DIAGDOT_ODD):
        B, Kr, Dp = shape
        codes = torch.as_tensor(rng.integers(0, 256, size=shape,
                                             dtype=np.uint8), device=dev)
        qs = torch.as_tensor(rng.normal(size=(B, Dp)).astype(np.float32),
                             device=dev).to(torch.bfloat16)
        cases = {"aligned": (codes, qs)}
        if shape in DIAGDOT_ODD:
            cases.update({"qs unaligned": (codes, _shifted(torch, qs)),
                          "codes unaligned": (_shifted(torch, codes), qs)})
        want = block_diagdot_ref(codes, qs)
        tol = 1e-3 * float(want.abs().max()) + 1e-3
        errs = {}
        for what, (c, q) in cases.items():
            got = block_diagdot(c, q)
            torch.cuda.synchronize()
            err = errs[what] = float((got - want).abs().max())
            log(f"kernel block_diagdot {shape} {what}: max_abs_err={err:.3e} "
                f"(tol {tol:.3e})")
            if not err <= tol:
                raise AssertionError(f"block_diagdot disagrees at {shape} "
                                     f"({what}): {err} > {tol}")
        if shape != MAIN_SHAPE:
            continue
        err = errs["aligned"]
        ms = cuda_ms(lambda: block_diagdot(codes, qs))
        ms_spin = cuda_ms(lambda: block_diagdot(codes, qs), spin=True)
        plain_ms = cuda_ms(lambda: block_diagdot_ref(codes, qs))
        library_ms = cuda_ms(lambda: torch.bmm(
            (codes.to(torch.int16) - 128).to(torch.bfloat16),
            qs.unsqueeze(2)))
        # the FMAs run on the CUDA cores
        b = bound(B * Kr * Dp + B * Dp * 2 + B * Kr * 4, 2 * B * Kr * Dp,
                  "f32")
        result = {"max_abs_err": err, "ms": ms, "ms_spin": ms_spin,
                  "plain_ms": plain_ms,
                  "library_ms": library_ms, **b, "shape": list(shape)}
        log(f"kernel block_diagdot {shape}: {ms:.4f} ms ({ms_spin:.4f} "
            f"device alone), plain "
            f"{plain_ms:.4f} ms, library bmm {library_ms:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bytes']} bytes)")
    return result


def estimate_inputs(torch, rng, codes, B, dev):
    """qconst [B], xsq [C, R] with inf on -1 slots, nbr_ids [C, R]: the
    fused estimate's operands, as a bsq8 space holds them."""
    C, R, _ = codes.shape
    ids = rng.integers(-1, C, size=(C, R)).astype(np.int32)
    xsq = (rng.random((C, R)) * 40).astype(np.float32)
    xsq[ids < 0] = np.inf
    qconst = (rng.normal(size=B) * 60).astype(np.float32)
    return tuple(torch.as_tensor(a, device=dev) for a in (qconst, xsq, ids))


def snapshot_counts(*fns):
    """Calls, launches and launches by entry of wrappers, to be put back
    after launches that only compare a kernel with its plain version."""
    return [(f, f.calls, f.launches, dict(f.route_launches)) for f in fns]


def restore_counts(saved) -> None:
    for f, calls, n, routes in saved:
        f.calls, f.launches = calls, n
        f.route_launches.clear()
        f.route_launches.update(routes)


def check_estimate_bits(torch, codes, u, qs, est_args, variant, what):
    """The fused entry's (est, ids) against the PyTorch epilogue applied to
    the same entry's dot: bit for bit, L2 (coef 2, clamp) and IP (coef 1).
    Returns the largest difference of est from the plain version's."""
    from alayalite_tpu_torch.ops.gather_diagdot import (estimate_epilogue,
                                                        gather_diagdot,
                                                        gather_estimate,
                                                        gather_estimate_ref)

    qconst, xsq, ids = est_args
    worst = 0.0
    for coef, clamp in ((2.0, True), (1.0, False)):
        est, nid = gather_estimate(codes, u, qs, qconst, coef, xsq, ids,
                                   clamp, variant=variant)
        dot = gather_diagdot(codes, u, qs, variant=variant)
        torch.cuda.synchronize()
        want, want_ids = estimate_epilogue(dot, u, qconst, coef, xsq, ids,
                                           clamp)
        if not (torch.equal(nid, want_ids) and torch.equal(
                est.view(torch.int32), want.view(torch.int32))):
            raise AssertionError(f"gather_estimate[{variant}] differs from "
                                 f"the epilogue on its own dot: {what}")
        plain, _ = gather_estimate_ref(codes, u, qs, qconst, coef, xsq, ids,
                                       clamp)
        fin = torch.isfinite(plain)
        if not torch.equal(fin, torch.isfinite(est)):
            raise AssertionError(f"gather_estimate[{variant}]: inf slots "
                                 f"differ at {what}")
        worst = max(worst, float((est[fin] - plain[fin]).abs().max()))
    return worst


def check_gather(torch, dev) -> dict:
    """gather_diagdot (both entries) and gather_estimate (the fused
    estimate, both entries) against their plain versions; times, bounds and
    library routes at the main shapes: the hop's and the sq8 traversal's
    (R = 1)."""
    from alayalite_tpu_torch.ops.gather_diagdot import (
        VARIANTS, bulk_fits, gather_diagdot, gather_diagdot_ref,
        gather_estimate, gather_estimate_ref)
    from alayalite_tpu_torch.spaces.bqg import ESTIMATE_VARIANT
    from alayalite_tpu_torch.spaces.sq import GATHER_VARIANT
    from alayalite_tpu_torch.utils.timing import bound, cuda_ms

    rng = np.random.default_rng(2)
    out = {"gather_diagdot": {"errors": {}}, "gather_estimate": {"errors": {}}}
    saved = snapshot_counts(gather_diagdot, gather_estimate)
    for shape in GATHER_SHAPES:
        C, R, Dp, B, M = shape
        codes = torch.as_tensor(rng.integers(0, 256, size=(C, R, Dp),
                                             dtype=np.uint8), device=dev)
        u = torch.as_tensor(rng.integers(0, C, size=(B, M)).astype(np.int32),
                            device=dev)
        u[: B // 8] = 0              # inactive pops all read node 0's block
        qs = torch.as_tensor(rng.normal(size=(B, Dp)).astype(np.float32),
                             device=dev).to(torch.bfloat16)
        est_args = estimate_inputs(torch, rng, codes, B, dev)
        want = gather_diagdot_ref(codes, u, qs)
        tol = tolerance(want)
        errs, est_errs = {}, {}
        for variant in VARIANTS:
            if variant == "bulk" and not bulk_fits(codes):
                try:
                    gather_diagdot(codes, u, qs, variant=variant)
                except ValueError:
                    log(f"kernel gather_diagdot[bulk] {shape}: not taken "
                        f"(R*Dp % 16 = {R * Dp % 16}), raises")
                    continue
                raise AssertionError(f"gather_diagdot[bulk] took {shape}")
            got = gather_diagdot(codes, u, qs, variant=variant)
            torch.cuda.synchronize()
            errs[variant] = float((got - want).abs().max())
            est_errs[variant] = check_estimate_bits(
                torch, codes, u, qs, est_args, variant, str(shape))
            log(f"kernel gather_diagdot[{variant}] {shape}: max_abs_err="
                f"{errs[variant]:.3e} (tol {tol:.3e}); gather_estimate"
                f"[{variant}] equals the epilogue on its dot bit for bit, "
                f"est against the plain version {est_errs[variant]:.3e}")
            if not errs[variant] <= tol:
                raise AssertionError(f"gather_diagdot[{variant}] disagrees "
                                     f"at {shape}: {errs[variant]} > {tol}")
        out["gather_diagdot"]["errors"][str(shape)] = errs
        out["gather_estimate"]["errors"][str(shape)] = est_errs
        if shape not in (GATHER_MAIN, GATHER_R1):
            continue

        def library():
            g = codes.index_select(0, u.reshape(-1)).view(B, M * R, Dp)
            return torch.bmm((g.to(torch.int16) - 128).to(torch.bfloat16),
                             qs.unsqueeze(2))

        def dot_fn(v):
            return lambda: gather_diagdot(codes, u, qs, variant=v)

        def est_fn(v):
            return lambda: gather_estimate(codes, u, qs, *est_args[:1], 2.0,
                                           *est_args[1:], True, variant=v)

        # each distinct popped block is read once: the pops that share a
        # node (the inactive ones all name node 0) need its bytes once
        distinct = int(torch.unique(u).numel())
        dot_bytes = (distinct * R * Dp + B * Dp * 2 + B * M * R * 4
                     + B * M * 4)
        b_dot = bound(dot_bytes, 2 * B * M * R * Dp, "f32")
        # and the fused estimate: xsq and ids of each distinct row, qconst,
        # and the ids as a second output
        b_est = bound(dot_bytes + distinct * R * 8 + B * 4 + B * M * R * 4,
                      2 * B * M * R * Dp + 3 * B * M * R, "f32")
        rep = {"shape": list(shape), "distinct_nodes": distinct,
               "plain_ms": cuda_ms(lambda: gather_diagdot_ref(codes, u, qs)),
               "library_ms": cuda_ms(library), **b_dot}
        est_rep = {"shape": list(shape), "distinct_nodes": distinct,
                   "plain_ms": cuda_ms(lambda: gather_estimate_ref(
                       codes, u, qs, est_args[0], 2.0, est_args[1],
                       est_args[2], True)),
                   "library_ms": None, **b_est}
        for v in VARIANTS:
            if v not in errs:
                continue
            rep[f"{v}_ms"] = cuda_ms(dot_fn(v))
            rep[f"{v}_ms_spin"] = cuda_ms(dot_fn(v), spin=True)
            est_rep[f"{v}_ms"] = cuda_ms(est_fn(v))
            est_rep[f"{v}_ms_spin"] = cuda_ms(est_fn(v), spin=True)
        route = ESTIMATE_VARIANT if shape == GATHER_MAIN else GATHER_VARIANT
        rep.update(variant=route, max_abs_err=errs[route],
                   ms=rep[f"{route}_ms"], ms_spin=rep[f"{route}_ms_spin"])
        est_rep.update(variant=ESTIMATE_VARIANT,
                       max_abs_err=est_errs[ESTIMATE_VARIANT],
                       ms=est_rep[f"{ESTIMATE_VARIANT}_ms"],
                       ms_spin=est_rep[f"{ESTIMATE_VARIANT}_ms_spin"])
        key = "main" if shape == GATHER_MAIN else "r1"
        out["gather_diagdot"][key] = rep
        out["gather_estimate"][key] = est_rep
        times = ", ".join(
            f"{v} {rep[f'{v}_ms']:.4f} ms ({rep[f'{v}_ms_spin']:.4f} device "
            f"alone), fused {est_rep[f'{v}_ms']:.4f} "
            f"({est_rep[f'{v}_ms_spin']:.4f})" for v in VARIANTS if v in errs)
        log(f"kernel gather_diagdot {shape}: {times}; plain "
            f"{rep['plain_ms']:.4f} ms (fused {est_rep['plain_ms']:.4f}), "
            f"library index_select + bmm {rep['library_ms']:.4f} ms, bound "
            f"{b_dot['bound_ms']:.4f} ms (fused {b_est['bound_ms']:.4f}; "
            f"{distinct} distinct nodes of {B * M} pops)")
        del codes
        torch.cuda.empty_cache()
    restore_counts(saved)
    # the numbers at the shape each is launched at on the paths: the dot
    # alone by the sq8 traversal (R = 1), the fused estimate by the hop
    out["gather_diagdot"].update(out["gather_diagdot"]["r1"])
    out["gather_estimate"].update(out["gather_estimate"]["main"])

    return out


def _probe_rows(torch, rng, B, K, S, S2, dev):
    """A hop's operands: a pop ring whose older half is still -1, a pool
    with an empty (-1) tail, neighbor ids repeating both and each other,
    inactive pops' -1 ids."""
    hi = 3 * (S + S2) + 8
    ring = rng.integers(0, hi, size=(B, S)).astype(np.int32)
    ring[:, : S // 2] = -1
    pool = rng.integers(0, hi, size=(B, S2)).astype(np.int32)
    pool[:, S2 - S2 // 4:] = -1
    nids = rng.integers(-1, hi, size=(B, K)).astype(np.int32)
    nids[:, : K // 8] = nids[:, K // 8: 2 * (K // 8)]
    return (torch.as_tensor(nids, device=dev),
            torch.as_tensor(ring, device=dev),
            torch.as_tensor(pool, device=dev) if S2 else None)


def _probe_edges(torch, rng, dev):
    """Operands that break a hash table: INT_MIN, INT_MAX and -1 as ids and
    as seen entries, seen rows of one id, one seen entry, a seen width past
    the hash kernel's (scan only)."""
    from alayalite_tpu_torch.ops.ring_probe import HASH_SEEN

    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    B, K = 4096, 256
    nids = rng.integers(-1, 400, size=(B, K)).astype(np.int32)
    nids[:, :3] = (lo, hi, -1)
    seen = rng.integers(0, 60, size=(B, 160)).astype(np.int32)
    seen[0::2, :3] = (lo, hi, -1)
    seen[1::2, :3] = (lo + 1, hi - 1, -2)
    one = np.full((B, 160), 7, np.int32)
    one[1::3], one[2::3] = -1, lo
    wide = rng.integers(-1, 3 * HASH_SEEN, size=(333, HASH_SEEN + 5))
    t = [torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in (
        nids, seen[:, :96], seen[:, 96:], one[:, :96], one[:, 96:],
        seen[:, :1], wide[:, :1000].astype(np.int32),
        wide[:, 1000:].astype(np.int32),
        rng.integers(-1, 3 * HASH_SEEN, size=(333, 77)).astype(np.int32))]
    return [("int_extremes", t[0], t[1], t[2]),
            ("one_id_rows", t[0], t[3], t[4]),
            ("one_seen", t[0], t[5], None),
            ("past_hash_limit", t[8], t[6], t[7])]


def check_ring_probe(torch, dev) -> dict:
    """ring_probe's two kernels ("hash", "scan") and the wrapper's route
    against the plain version, bit for bit, at the paths' shapes, ragged
    shapes and on the ids that break a hash table; both kernels timed at
    every path shape, the plain version and the eager compare at the
    search's."""
    from alayalite_tpu_torch.ops.ring_probe import (HASH_SEEN, ring_probe,
                                                    ring_probe_on,
                                                    ring_probe_ref,
                                                    ring_probe_route)
    from alayalite_tpu_torch.utils.timing import bound, cuda_ms

    rng = np.random.default_rng(3)
    out = {"errors": {}, "at": {}}
    saved = snapshot_counts(ring_probe)
    cases = [(str(shape), *_probe_rows(torch, rng, *shape, dev))
             for shape in (*PROBE_PATHS, *PROBE_RAGGED)]
    for name, nids, seen, seen2 in cases + _probe_edges(torch, rng, dev):
        S2 = 0 if seen2 is None else seen2.shape[1]
        want = ring_probe_ref(nids, seen, seen2)
        wrong = {}
        for route in ("hash", "scan"):
            if route == "hash" and seen.shape[1] + S2 > HASH_SEEN:
                continue
            got = ring_probe_on(route, nids, seen, seen2, counted=False)
            torch.cuda.synchronize()
            wrong[route] = int((got != want).sum())
        got = ring_probe(nids, seen, seen2)
        torch.cuda.synchronize()
        route = ring_probe_route(seen.shape[1], S2)
        wrong[f"routed ({route})"] = int((got != want).sum())
        log(f"kernel ring_probe {name} ({tuple(nids.shape)} against "
            f"{seen.shape[1]} + {S2}): differing entries {wrong}, "
            f"{int(want.sum())} members of {want.numel()}")
        if any(wrong.values()) or got.dtype != torch.bool:
            raise AssertionError(f"ring_probe disagrees at {name}")
        out["errors"][name] = wrong
    restore_counts(saved)

    for shape in PROBE_PATHS:
        B, K, S, S2 = shape
        nids, seen, seen2 = _probe_rows(torch, rng, *shape, dev)
        if ring_probe_route(S, S2) != "hash":
            raise AssertionError(f"the path shape {shape} is not routed to "
                                 f"the hash kernel")

        def on(route, nids=nids, seen=seen, seen2=seen2):
            return lambda: ring_probe_on(route, nids, seen, seen2,
                                         counted=False)

        def routed(nids=nids, seen=seen, seen2=seen2):
            return ring_probe(nids, seen, seen2)

        # bytes: the ids and both seen rows read once, a byte written per
        # id; operations: the hash route's own work, a hash and a compare
        # per seen id inserted and per id probed, O(K + S + S2) a query, on
        # the CUDA cores. The scan's bound counts its compare and or per
        # (id, seen entry) pair, O(K * (S + S2)), and is kept beside it.
        w = S + S2
        nbytes = B * K * 4 + B * w * 4 + B * K
        rep = {"shape": list(shape), "route": "hash",
               **bound(nbytes, 2 * B * (K + w), "f32")}
        rep["scan_bound_ms"] = bound(nbytes, 2 * B * K * w, "f32")["bound_ms"]
        rep["ms"] = cuda_ms(routed)
        rep["ms_spin"] = cuda_ms(routed, spin=True)
        for route in ("hash", "scan"):
            rep[f"{route}_ms"] = cuda_ms(on(route))
            rep[f"{route}_ms_spin"] = cuda_ms(on(route), spin=True)
        if shape == PROBE_MAIN:
            cat = torch.cat([seen, seen2], dim=1)
            rep.update(
                plain_ms=cuda_ms(lambda: ring_probe_ref(nids, seen, seen2)),
                library_ms=cuda_ms(lambda: (nids[:, :, None]
                                            == cat[:, None, :]).any(2)),
                cat_ms_spin=cuda_ms(lambda: torch.cat([seen, seen2], dim=1),
                                    spin=True))
        out["at"][f"{K}x{S}+{S2}"] = rep
        log(f"kernel ring_probe {shape}: routed {rep['ms']:.4f} ms "
            f"({rep['ms_spin']:.4f} device alone), hash kernel "
            f"{rep['hash_ms']:.4f} ({rep['hash_ms_spin']:.4f}), scan kernel "
            f"{rep['scan_ms']:.4f} ({rep['scan_ms_spin']:.4f}), bound "
            f"{rep['bound_ms']:.4f} ms ({rep['bound_by']}; the scan's "
            f"compares {rep['scan_bound_ms']:.4f} ms)")
    restore_counts(saved)
    main = out["at"]["{1}x{2}+{3}".format(*PROBE_MAIN)]
    out.update(main, max_abs_err=0.0)
    log(f"kernel ring_probe {PROBE_MAIN}: plain {main['plain_ms']:.4f} ms, "
        f"eager compare + any over the concatenated rows "
        f"{main['library_ms']:.4f} ms, the concatenation the hop no longer "
        f"launches {main['cat_ms_spin']:.4f} ms device alone")
    return out


def check_gather_on_index(torch, sp, what: str) -> dict:
    """gather_diagdot (both entries) against its plain version, and
    gather_estimate (both entries) against the epilogue on its own dot, on
    the index's own code tensor [capacity, R, Dp], norms and ids, at the
    hop's B and M: node ids drawn over [0, num), the last rows of ``u``
    walking down from num - 1 (byte offsets past 2^31 at 1M x 32 x 128)
    and the first eighth naming node 0, as the hop's inactive pops do. The
    kernels' launch counts are left as they were."""
    from alayalite_tpu_torch.ops.gather_diagdot import (VARIANTS,
                                                        gather_diagdot,
                                                        gather_diagdot_ref,
                                                        gather_estimate)

    _, R, Dp, B, M = GATHER_MAIN
    num = sp.num
    rng = np.random.default_rng(5)
    u = rng.integers(0, num, size=(B, M)).astype(np.int32)
    u[: B // 8] = 0
    u[-64:] = (num - 1 - np.arange(64 * M)).reshape(64, M)
    codes = sp.nbr_codes
    dev = codes.device
    u = torch.as_tensor(u, device=dev)
    q = torch.as_tensor(rng.normal(size=(B, sp.dim)).astype(np.float32),
                        device=dev)
    _, qs, qconst = sp.query_ctx(q)
    top_offset = int(u.max()) * codes.shape[1] * codes.shape[2]
    if top_offset < 2 ** 31 and num >= N:
        raise AssertionError("the index check does not reach past 2^31")
    want = gather_diagdot_ref(codes, u, qs)
    tol = tolerance(want)
    saved = snapshot_counts(gather_diagdot, gather_estimate)
    errs, est_errs = {}, {}
    for variant in VARIANTS:
        got = gather_diagdot(codes, u, qs, variant=variant)
        torch.cuda.synchronize()
        errs[variant] = float((got - want).abs().max())
        est_errs[variant] = check_estimate_bits(
            torch, codes, u, qs, (qconst, sp.nbr_xsq, sp.nbr_ids), variant,
            f"the {what} index")
        log(f"kernel gather_diagdot[{variant}] on the {what} index's codes "
            f"{tuple(codes.shape)}, ids to {int(u.max())} (byte offset "
            f"{top_offset}): max_abs_err={errs[variant]:.3e} (tol {tol:.3e}); "
            f"gather_estimate[{variant}] equals the epilogue on its dot bit "
            f"for bit (est against the plain version {est_errs[variant]:.3e})")
        if not errs[variant] <= tol:
            raise AssertionError(f"gather_diagdot[{variant}] disagrees on "
                                 f"the {what} index: {errs[variant]} > {tol}")
    restore_counts(saved)
    return {"codes": list(codes.shape), "top_id": int(u.max()),
            "top_byte_offset": top_offset, "errors": errs,
            "estimate_errors_against_plain": est_errs}


def check_hgmma() -> dict:
    """sq8_tile's library must hold the tensor cores' warpgroup product:
    HGMMA instructions in the SASS cuobjdump prints."""
    import subprocess

    from alayalite_tpu_torch.ops import _build

    lib = _build.lib_path("sq8_tile")
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    n = sum(1 for line in sass.splitlines() if "HGMMA" in line)
    log(f"sq8_tile SASS ({lib.name}): {n} HGMMA instructions")
    if n == 0:
        raise AssertionError("sq8_tile's SASS holds no HGMMA")
    return {"hgmma_instructions": n, "library": lib.name}


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

                def library_f32(q=q, codes=codes, scale=scale):
                    # the same product with the kernel's f32 output
                    return torch.mm(
                        (q * scale).to(torch.bfloat16),
                        (codes.to(torch.int16) - 128).to(torch.bfloat16).T,
                        out_dtype=torch.float32)
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
                     "ms_spin": cuda_ms(lambda: kern(*args), spin=True),
                     "plain_ms": cuda_ms(lambda: ref(*args)),
                     "library_ms": cuda_ms(library)}
            f32 = ""
            if name == "sq8_tile":
                times["library_f32_ms"] = cuda_ms(library_f32)
                f32 = (f", the same with an f32 output "
                       f"{times['library_f32_ms']:.4f} ms")
            out[name].update(max_abs_err=err, shape=[Q, Nx, D], **b, **times)
            log(f"kernel {name} {(Q, Nx, D)}: {times['ms']:.4f} ms "
                f"({times['ms_spin']:.4f} device alone), plain "
                f"{times['plain_ms']:.4f} ms, library {times['library_ms']:.4f}"
                f" ms{f32}, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
            torch.cuda.empty_cache()
    return out


def _same_bits(got, want) -> bool:
    """Tensors equal bit for bit (a float compare would let -0.0 pass for
    +0.0); None only equals None."""
    import torch

    if got is None or want is None:
        return got is want
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return got.shape == want.shape and bool((got == want).all())


def _difference(got, want):
    """What a kernel's outputs at its timed shape differ by from the plain
    version's: (the largest |difference| over the float outputs where both
    are finite, the number of entries of any output whose bits differ)."""
    import torch

    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err, differing = 0.0, 0
    for g, w in zip(got, want):
        if g is None:
            continue
        if g.dtype == torch.float32:
            both = torch.isfinite(g) & torch.isfinite(w)
            if bool(both.any()):
                err = max(err, float((g[both] - w[both]).abs().max()))
            g, w = g.view(torch.int32), w.view(torch.int32)
        differing += int((g != w).sum())
    return err, differing


def _pool_rows(torch, rng, B, L1, L2, dev, holes=False):
    """A pool and candidates as the hop holds them: an ascending pool whose
    tail is empty (+inf, -1), candidates with ties against the pool,
    duplicate (distance, id) pairs, masked slots, both zeros, negative
    keys. With ``holes`` the pool is what a dedup merge leaves: (inf, -1,
    True) slots inside it with finite entries after them, so it is not
    ascending, and candidates repeating pool entries (keys, and ids)."""
    d1 = np.sort(np.round(rng.normal(size=(B, L1)) * 4) / 4, axis=1)
    d2 = np.round(rng.normal(size=(B, L2)) * 4) / 4
    d1, d2 = d1.astype(np.float32), d2.astype(np.float32)
    d1[d1 == 0] *= rng.choice([-1.0, 1.0], size=int((d1 == 0).sum()))
    i1 = rng.integers(0, 1 << 30, size=(B, L1)).astype(np.int32)
    i2 = rng.integers(-1, 50, size=(B, L2)).astype(np.int32)
    h = L2 // 2
    d2[:, h:2 * h], i2[:, h:2 * h] = d2[:, :h], i2[:, :h]
    d2[i2 < 0] = np.inf
    tail = max(1, L1 // 3)
    d1[:, -tail:], i1[:, -tail:] = np.inf, -1
    f1 = rng.random(size=(B, L1)) < 0.5
    f2 = np.zeros((B, L2), bool)
    if holes:
        hole = np.zeros((B, L1), bool)
        hole[:, 1:L1 - tail] = rng.random(size=(B, max(0, L1 - tail - 1))) < 0.25
        d1[hole], i1[hole], f1[hole] = np.inf, -1, True
        rep = rng.integers(0, max(1, L1 - tail), size=(B, L2 // 4))
        rows = np.arange(B)[:, None]
        d2[:, :L2 // 4] = d1[rows, rep]
        same = rng.random(size=rep.shape) < 0.5
        i2[:, :L2 // 4] = np.where(same, i1[rows, rep], i2[:, :L2 // 4])
    return [torch.as_tensor(a, device=dev) for a in (d1, i1, f1, d2, i2, f2)]


def _network_pool_merge(torch, args, k):
    """merge_topk_dedup through pool_sort.cu's shared-memory network, the
    design the hop ran before the warp kernel, launched directly so the two
    are timed in one run (pool_merge picks it only past WARP_LIST); not
    counted as a launch."""
    import ctypes

    from alayalite_tpu_torch.ops import pool_sort
    from alayalite_tpu_torch.ops._build import launch

    d1, i1, f1, d2, i2, f2 = args
    B, L1 = d1.shape
    od = torch.empty((B, k), dtype=torch.float32, device=d1.device)
    oi = torch.empty((B, k), dtype=torch.int32, device=d1.device)
    of = torch.empty((B, k), dtype=torch.bool, device=d1.device)
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = pool_sort._entry("alaya_pool_merge", [P] * 9 + [LL, I, I, I, I])
    launch(fn, d1.device, *(t.data_ptr() for t in (d1, i1, f1, d2, i2, f2,
                                                   od, oi, of)),
           B, L1, d2.shape[1], k, 1)
    return od, oi, of


def _shared_roll_n(torch, x, n):
    """roll_n through the shared-memory kernel at any width (the wrapper
    routes 32·W-word rows to the warp kernel)."""
    import ctypes

    from alayalite_tpu_torch.ops import pool_sort
    from alayalite_tpu_torch.ops._build import launch

    out = torch.empty_like(x)
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = pool_sort._entry("alaya_roll_n_shared", [P, P, LL, I, I], "roll_n")
    launch(fn, x.device, x.data_ptr(), out.data_ptr(), x.shape[0],
           x.shape[1], n)
    return out


def check_pool_sort(torch, dev) -> dict:
    """sort_kv, merge_kv, pool_merge and roll_n against their plain
    versions, bit for bit; times, bounds and the library route
    (torch.sort(stable=True) + gather) at the hop's shapes."""
    from alayalite_tpu_torch.ops.pool_sort import (merge_kv, merge_kv_ref,
                                                   pool_merge, pool_merge_ref,
                                                   pool_merge_route, roll_n,
                                                   roll_n_ref, roll_n_route,
                                                   sort_kv, sort_kv_on,
                                                   sort_kv_ref, sort_kv_route)
    from alayalite_tpu_torch.utils.timing import bound, cuda_ms

    rng = np.random.default_rng(4)
    out = {}

    def stages(n):                       # compare-exchanges of a sort of n
        p = 1 << max(0, int(n - 1).bit_length())
        lg = p.bit_length() - 1
        return (p // 2) * lg * (lg + 1) // 2

    def timed(fn, ref, lib, nbytes, ops, shape, **extra):
        # a compare and a select per compare-exchange, on the CUDA cores
        b = bound(nbytes, 2 * ops, "f32")
        err, differing = _difference(fn(), ref())
        rep = {"max_abs_err": err, "differing_entries": differing,
               "ms": cuda_ms(fn),
               "ms_spin": cuda_ms(fn, spin=True), "plain_ms": cuda_ms(ref),
               "library_ms": cuda_ms(lib), "shape": list(shape), **b, **extra}
        return rep

    def fail(name, shape):
        raise AssertionError(f"{name} differs from its plain version at "
                             f"{shape}")

    def sort_keys(B, Kw):
        """Keys with ties, both zeros, +inf and NaN."""
        keys = np.round(rng.normal(size=(B, Kw)) * 8) / 8
        keys[rng.random((B, Kw)) < 0.3] = np.inf
        keys[rng.random((B, Kw)) < 0.01] = np.nan
        keys[keys == 0] *= rng.choice([-1.0, 1.0], size=int((keys == 0).sum()))
        return torch.as_tensor(keys.astype(np.float32), device=dev)

    # ---- sort_kv: rows (the warp route up to WARP_LIST keys, the network
    # past it), columns (the network), keys only
    routes = dict(sort_kv.route_launches)
    for B, Kw in (SORT_MAIN, *SORT_RAGGED):
        keys = sort_keys(B, Kw)
        pay = torch.as_tensor(rng.integers(-1, 1 << 30, size=(B, Kw))
                              .astype(np.int32), device=dev)
        kt, pt = keys.T.contiguous(), pay.T.contiguous()
        for k in (Kw, max(1, Kw // 4)):
            cases = {"rows": (sort_kv(keys, pay, k=k, return_index=True),
                              sort_kv_ref(keys, pay, k, 1, True)),
                     "columns": (sort_kv(kt, pt, k=k, axis=0),
                                 sort_kv_ref(kt, pt, k, 0)),
                     "keys only": (sort_kv(keys, k=k),
                                   sort_kv_ref(keys, None, k))}
            torch.cuda.synchronize()
            for layout, (got, want) in cases.items():
                if not all(_same_bits(g, w) for g, w in zip(got, want)):
                    fail(f"sort_kv[{layout}]", (B, Kw, k))
        log(f"kernel sort_kv {(B, Kw)} (rows: {sort_kv_route(Kw)}): rows, "
            f"columns and keys only equal the plain version bit for bit")
        if (B, Kw) != SORT_MAIN:
            continue

        def library(keys=keys, pay=pay):
            sk, order = torch.sort(keys, dim=1, stable=True)
            return sk, torch.gather(pay, 1, order)

        ops = B * stages(Kw)
        out["sort_kv"] = timed(
            lambda: sort_kv(keys, pay), lambda: sort_kv_ref(keys, pay),
            library, 4 * B * Kw * 4, ops, (B, Kw), route=sort_kv_route(Kw),
            columns_ms=cuda_ms(lambda: sort_kv(kt, pt, axis=0)),
            columns_ms_spin=cuda_ms(lambda: sort_kv(kt, pt, axis=0),
                                    spin=True),
            keys_only_ms=cuda_ms(lambda: sort_kv(keys)),
            keys_only_ms_spin=cuda_ms(lambda: sort_kv(keys), spin=True),
            compare_exchanges=ops)
        r = out["sort_kv"]
        log(f"kernel sort_kv {(B, Kw)} with payload: {r['ms']:.4f} ms "
            f"({r['ms_spin']:.4f} device alone; columns "
            f"{r['columns_ms_spin']:.4f}, keys only "
            f"{r['keys_only_ms_spin']:.4f}), plain {r['plain_ms']:.4f} ms, "
            f"library sort + gather {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    ran = {r: sort_kv.route_launches[r] - routes[r] for r in routes}
    if min(ran.values()) <= 0:
        raise AssertionError(f"a sort_kv kernel was not held: {ran}")
    out["sort_kv"]["checked_route_launches"] = ran

    # the warp route against the network at the paths' shapes, both called
    # directly (uncounted), bit for bit against the plain version
    out["sort_kv"]["at"] = {}
    for B, Kw, k, with_pay in SORT_PATHS:
        keys = sort_keys(B, Kw)
        pay = (torch.as_tensor(rng.integers(-1, 1 << 30, size=(B, Kw))
                               .astype(np.int32), device=dev)
               if with_pay else None)
        want = sort_kv_ref(keys, pay, k, 1, True)
        if sort_kv_route(Kw) != "warp":
            raise AssertionError(f"sort_kv at {(B, Kw)} is not routed to "
                                 f"the warp kernel")

        def on(route, keys=keys, pay=pay, k=k, idx=not with_pay):
            return lambda: sort_kv_on(route, keys, pay, k, 1, idx,
                                      counted=False)

        for route in ("warp", "network"):
            got = sort_kv_on(route, keys, pay, k, 1, True, counted=False)
            torch.cuda.synchronize()
            if not all(_same_bits(g, w) for g, w in zip(got, want)):
                fail(f"sort_kv[{route}]", (B, Kw, k))

        def library(keys=keys, pay=pay, k=k):
            sk, order = torch.sort(keys, dim=1, stable=True)
            order = order[:, :k]
            return (sk[:, :k], None if pay is None
                    else torch.gather(pay, 1, order), order)

        # bytes: keys (and payload) read once; k keys, payloads or int64
        # positions written
        nbytes = B * Kw * (8 if with_pay else 4) + B * k * (8 if with_pay
                                                            else 12)
        rep = {"shape": [B, Kw, k], "payload": with_pay,
               "positions": not with_pay,
               **bound(nbytes, 2 * B * stages(Kw), "f32"),
               "plain_ms": cuda_ms(lambda keys=keys, pay=pay, k=k: sort_kv_ref(
                   keys, pay, k, 1, True)),
               "library_ms": cuda_ms(library)}
        for route in ("warp", "network"):
            rep[f"{route}_ms"] = cuda_ms(on(route))
            rep[f"{route}_ms_spin"] = cuda_ms(on(route), spin=True)
        out["sort_kv"]["at"][f"{Kw}->{k}"] = rep
        log(f"kernel sort_kv {(B, Kw)} -> {k} ({'payload' if with_pay else 'keys only, positions'}): "
            f"warp {rep['warp_ms']:.4f} ms ({rep['warp_ms_spin']:.4f} device "
            f"alone), network {rep['network_ms']:.4f} "
            f"({rep['network_ms_spin']:.4f}), both equal the plain version "
            f"bit for bit; plain {rep['plain_ms']:.4f} ms, library sort "
            f"{rep['library_ms']:.4f} ms, bound {rep['bound_ms']:.4f} ms "
            f"({rep['bound_by']})")
    main = out["sort_kv"]["at"][f"{SORT_MAIN[1]}->{SORT_MAIN[1]}"]
    out["sort_kv"].update(network_ms=main["network_ms"],
                          network_ms_spin=main["network_ms_spin"])

    # ---- merge_kv (ascending operands; keys with NaN, both zeros, +-inf
    # and ties within and across the operands), bit for bit at every shape
    # and k; timed at MERGE_TIMED beside an empty kernel's event span (one
    # fill of 16 floats), the floor of every spin time
    tiny = torch.zeros(16, device=dev)
    empty = cuda_ms(lambda: tiny.zero_(), spin=True)
    out["merge_kv"] = {"at": {}, "empty_kernel_ms_spin": empty}
    for B, L1, L2, k in (*MERGE_TIMED, *MERGE_RAGGED):
        lists = []
        for L in (L1, L2):
            keys = sort_keys(B, L)
            keys[torch.rand(keys.shape, device=dev) < 0.05] = -np.inf
            pay = torch.as_tensor(rng.integers(-1, 1 << 30, size=(B, L))
                                  .astype(np.int32), device=dev)
            lists.append(sort_kv_ref(keys, pay))
        a, b = lists
        for kk in sorted({k, L1 + L2, max(1, L1)}):
            got = merge_kv(*a, *b, kk)
            torch.cuda.synchronize()
            if not all(_same_bits(g, w)
                       for g, w in zip(got, merge_kv_ref(*a, *b, kk))):
                fail("merge_kv", (B, L1, L2, kk))
        log(f"kernel merge_kv {(B, L1, L2)}: equals the plain version bit "
            f"for bit at k = {sorted({k, L1 + L2, max(1, L1)})}")
        if (B, L1, L2, k) not in MERGE_TIMED:
            continue
        cat_d, cat_p = torch.cat([a[0], b[0]], 1), torch.cat([a[1], b[1]], 1)

        def library(cat_d=cat_d, cat_p=cat_p, k=k):
            sd, order = torch.sort(cat_d, dim=1, stable=True)
            return sd[:, :k], torch.gather(cat_p, 1, order[:, :k])

        # bytes: both lists' keys (the co-rank searches read them), the k
        # payloads taken, k keys and payloads written; operations: a compare
        # per probe, ceil(log2(min(L1, L2) + 1)) + 1 probes an output
        probes = min(L1, L2).bit_length() + 1
        rep = timed(lambda a=a, b=b, k=k: merge_kv(*a, *b, k),
                    lambda a=a, b=b, k=k: merge_kv_ref(*a, *b, k), library,
                    B * (L1 + L2) * 4 + B * k * 12, B * k * probes,
                    (B, L1, L2), k=k, empty_kernel_ms_spin=empty,
                    compares=B * k * probes)
        rep["spin_over_empty_kernel"] = rep["ms_spin"] / empty
        # one copy_ of the outputs' bytes (k keys and payloads a row, read
        # once and written once): what moving them alone reads in this span
        src = torch.empty(2 * B * k, dtype=torch.float32, device=dev)
        dst = torch.empty_like(src)
        rep["copy_ms_spin"] = cuda_ms(lambda: dst.copy_(src), spin=True)
        del src, dst
        out["merge_kv"]["at"][f"{L1}+{L2}->{k}"] = rep
        log(f"kernel merge_kv {(B, L1, L2)} -> {k}: {rep['ms']:.4f} ms "
            f"({rep['ms_spin']:.4f} device alone, "
            f"{rep['spin_over_empty_kernel']:.2f}x an empty kernel's "
            f"{empty:.4f}; a copy of the outputs' bytes "
            f"{rep['copy_ms_spin']:.4f}), plain {rep['plain_ms']:.4f} ms, library sort + "
            f"gather {rep['library_ms']:.4f} ms, bound {rep['bound_ms']:.4f} "
            f"ms ({rep['bound_by']})")
    out["merge_kv"].update(out["merge_kv"]["at"]["64+64->128"])

    # ---- pool_merge: merge_topk_dedup, merge_topk_with_flags, merge_topk;
    # pools ascending with an empty tail, and pools with dedup's holes
    routes = dict(pool_merge.route_launches)
    out["pool_merge"] = {"at": {}}
    for B, L1, L2 in (*POOL_HOP, *POOL_RAGGED):
        for holes in (False, True):
            args = _pool_rows(torch, rng, B, L1, L2, dev, holes)
            plain = [a for i, a in enumerate(args) if i not in (2, 5)]
            for k in (L1, max(1, L1 // 2), L1 + L2):
                cases = [(pool_merge(*args, k, True),
                          pool_merge_ref(*args, k, True)),
                         (pool_merge(*args, k), pool_merge_ref(*args, k)),
                         (pool_merge(plain[0], plain[1], None, plain[2],
                                     plain[3], None, k),
                          pool_merge_ref(plain[0], plain[1], None, plain[2],
                                         plain[3], None, k))]
                torch.cuda.synchronize()
                for got, want in cases:
                    if not all(_same_bits(g, w) for g, w in zip(got, want)):
                        fail("pool_merge", (B, L1, L2, k, holes))
        d1 = args[0]
        unsorted = int((d1[:, 1:] < d1[:, :-1]).any(1).sum())
        dups = int((pool_merge_ref(*args, L1, True)[1]
                    != pool_merge_ref(*args, L1)[1]).sum())
        log(f"kernel pool_merge {(B, L1, L2)} ({pool_merge_route(L1, L2, L1)}"
            f"): with and without dedup and without flags equal the plain "
            f"version bit for bit, on ascending pools and on pools with holes "
            f"({unsorted} of {B} rows not ascending, {dups} duplicates "
            f"neutralized)")
        if (B, L1, L2) not in POOL_HOP:
            continue
        if dups == 0 or (L1 > 2 and unsorted == 0):
            raise AssertionError("the pool_merge check holds no duplicate "
                                 "or no pool row that is not ascending")
        cat_d = torch.cat([args[0], args[3]], 1)
        cat_p = torch.cat([args[1] * 2 + args[2], args[4] * 2 + args[5]], 1)

        def library(cat_d=cat_d, cat_p=cat_p):
            sd, order = torch.sort(cat_d, dim=1, stable=True)
            return sd, torch.gather(cat_p, 1, order)

        def network(args=args, L1=L1):
            return _network_pool_merge(torch, args, L1)

        if not all(_same_bits(g, w) for g, w in
                   zip(network(), pool_merge_ref(*args, L1, True))):
            fail("pool_merge[network]", (B, L1, L2))
        # the warp kernel's compare-exchanges on these rows: the candidates
        # sorted, the pools that are not ascending sorted, one bitonic merge
        # of pow2(k) words
        m = 1 << (L1 - 1).bit_length()
        ops = (B * stages(L2) + unsorted * stages(L1)
               + B * (m // 2) * (m.bit_length() - 1))
        rep = timed(
            lambda args=args, L1=L1: pool_merge(*args, L1, True),
            lambda args=args, L1=L1: pool_merge_ref(*args, L1, True),
            library, B * (L1 + L2 + L1) * 9, ops, (B, L1, L2),
            compare_exchanges=ops, route=pool_merge_route(L1, L2, L1),
            network_ms=cuda_ms(network),
            network_ms_spin=cuda_ms(network, spin=True))
        out["pool_merge"]["at"][f"{L1}+{L2}"] = rep
        log(f"kernel pool_merge {(B, L1, L2)} k={L1} (merge_topk_dedup, "
            f"pools with holes): {rep['ms']:.4f} ms ({rep['ms_spin']:.4f} "
            f"device alone; the shared-memory network {rep['network_ms']:.4f}"
            f" / {rep['network_ms_spin']:.4f}), plain {rep['plain_ms']:.4f} "
            f"ms, library sort + gather of the packed row "
            f"{rep['library_ms']:.4f} ms, bound {rep['bound_ms']:.4f} ms "
            f"({rep['bound_by']})")
    ran = {r: pool_merge.route_launches[r] - routes[r] for r in routes}
    if min(ran.values()) <= 0:
        raise AssertionError(f"a pool_merge kernel was not held: {ran}")
    out["pool_merge"].update(out["pool_merge"]["at"]["64+256"])
    out["pool_merge"]["checked_route_launches"] = ran

    # ---- roll_n: both kernels, the width's own and the shared-memory one
    # called directly, bit for bit
    out["roll_n"] = {}
    routes = dict(roll_n.route_launches)
    for shape in (SORT_MAIN, (333, 77), (1, 1), (1000, 32), (333, 512)):
        x = torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                            device=dev)
        for n in (0, 1, *ROLLS):
            want = roll_n_ref(x, n)
            got = roll_n(x, n)
            torch.cuda.synchronize()
            if not (_same_bits(got, want)
                    and _same_bits(_shared_roll_n(torch, x, n), want)):
                fail("roll_n", (*shape, n))
        log(f"kernel roll_n {shape} ({roll_n_route(shape[1])}; and the "
            f"shared kernel): equal to the plain version bit for bit at n = "
            f"0, 1, {', '.join(map(str, ROLLS))}")
        if shape != SORT_MAIN:
            continue
        B, Kw = shape
        for n in ROLLS:
            total = sum(1 + j % 7 for j in range(n))

            def shared(n=n):
                return _shared_roll_n(torch, x, n)

            # one read and one write of a word per exchange step
            rep = timed(lambda n=n: roll_n(x, n), lambda n=n: roll_n_ref(x, n),
                        lambda: torch.roll(x, total, dims=1),
                        2 * B * Kw * 4, B * Kw * n // 2, shape, n=n,
                        route=roll_n_route(Kw), shared_ms=cuda_ms(shared),
                        shared_ms_spin=cuda_ms(shared, spin=True),
                        library_ms_spin=cuda_ms(
                            lambda: torch.roll(x, total, dims=1), spin=True))
            rep["ns_per_exchange_step_and_list"] = (
                rep["ms_spin"] * 1e6 / n / B)
            out["roll_n"][str(n)] = rep
            log(f"kernel roll_n {shape} n={n} ({rep['route']}): "
                f"{rep['ms']:.4f} ms ({rep['ms_spin']:.4f} device alone, "
                f"{rep['ns_per_exchange_step_and_list']:.4f} ns per step and "
                f"list), the shared kernel {rep['shared_ms']:.4f} "
                f"({rep['shared_ms_spin']:.4f}), plain {rep['plain_ms']:.4f} "
                f"ms, one torch.roll by the sum {rep['library_ms']:.4f} "
                f"({rep['library_ms_spin']:.4f}), bound "
                f"{rep['bound_ms']:.4f} ms ({rep['bound_by']})")
    ran = {r: roll_n.route_launches[r] - routes[r] for r in routes}
    if min(ran.values()) <= 0:
        raise AssertionError(f"a roll_n kernel was not held: {ran}")
    out["roll_n"].update(out["roll_n"][str(ROLLS[0])])
    return out


def check_sq8_gather(torch, dev) -> dict:
    """``SQSpace.gather_dists`` of an sq8 graph traversal at the hop's shape
    (4096 queries x 256 ids over 100,000 x 128 codes): on the card it goes
    through gather_diagdot on the codes as one-row blocks. Held against the
    library route for the same distances, written out here (index_select +
    decode + torch.bmm); both are timed."""
    from alayalite_tpu_torch.ops.gather_diagdot import gather_diagdot
    from alayalite_tpu_torch.spaces.sq import GATHER_VARIANT, SQSpace
    from alayalite_tpu_torch.utils.timing import cuda_ms

    rng = np.random.default_rng(6)
    x = torch.as_tensor((rng.normal(size=(N_SMALL, DIM)) * 2.0)
                        .astype(np.float32), device=dev)
    sp = SQSpace.create(N_SMALL, DIM, device=dev).fit(x)
    q = torch.as_tensor(rng.normal(size=(4096, DIM)).astype(np.float32),
                        device=dev)
    ids = torch.as_tensor(rng.integers(0, N_SMALL, size=(4096, 256))
                          .astype(np.int32), device=dev)

    def library():
        flat = ids.reshape(-1)
        qs = (q * sp.scale[None, :]).to(torch.bfloat16).float()
        cf = sp.codes.index_select(0, flat).float() - 128.0
        dot = torch.bmm(cf.view(4096, 256, -1), qs.unsqueeze(2)).squeeze(2)
        dot = dot + (q * (sp.dmin + 128.0 * sp.scale)[None, :]).sum(
            -1, keepdim=True)
        d = ((q * q).sum(-1, keepdim=True) - 2.0 * dot
             + sp.xhat_sq.index_select(0, flat).view(4096, 256))
        return torch.clamp(d, min=0.0)

    saved = snapshot_counts(gather_diagdot)
    launches = gather_diagdot.launches
    got = sp.gather_dists(q, ids)
    torch.cuda.synchronize()
    launched = gather_diagdot.launches - launches
    want = library()
    err, tol = float((got - want).abs().max()), tolerance(want)
    qs = (q * sp.scale[None, :]).to(torch.bfloat16).contiguous()
    codes = sp.codes.view(N_SMALL, 1, -1)

    def kernel():
        return gather_diagdot(codes, ids, qs, variant=GATHER_VARIANT)

    rep = {"max_abs_err": err, "launches_per_call": launched,
           "variant": GATHER_VARIANT,
           "kernel_ms": cuda_ms(lambda: sp.gather_dists(q, ids)),
           "kernel_ms_spin": cuda_ms(lambda: sp.gather_dists(q, ids),
                                     spin=True),
           "dot_ms": cuda_ms(kernel), "dot_ms_spin": cuda_ms(kernel,
                                                             spin=True),
           "bmm_ms": cuda_ms(library)}
    restore_counts(saved)
    log(f"sq8 gather_dists (4096, 256) over {N_SMALL} x {DIM} codes: "
        f"through gather_diagdot[{GATHER_VARIANT}] {rep['kernel_ms']:.4f} ms "
        f"({rep['kernel_ms_spin']:.4f} device alone; the kernel alone "
        f"{rep['dot_ms']:.4f} / {rep['dot_ms_spin']:.4f}; {launched} launch "
        f"per call), index_select + bmm {rep['bmm_ms']:.4f} ms, max_abs_err "
        f"{err:.3e} (tol {tol:.3e})")
    if launched != 1 or not err <= tol:
        raise AssertionError("sq8 gather_dists: no kernel launch, or it "
                             "disagrees with index_select + bmm")
    return rep


def ground_truth(torch, data, queries, k: int, dead=None) -> np.ndarray:
    """Exact l2 top-k on the card, chunked float32 matmuls; rows ``dead``
    are left out."""
    x_sq = (data * data).sum(1)
    if dead is not None:
        x_sq[dead] = float("inf")
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
    gt = calc_gt(ds.data, ds.queries, K, device="cpu")
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


def audit_blocks(torch, sp, vecs, node_ids) -> dict:
    """The encoded blocks of ``node_ids`` through ``estimate_for`` (gather +
    block_diagdot): each estimate, taken from the node's own vector, against
    the exact distance to the codes decoded from the stored grid. Rounding
    q∘scale to bf16 (relative 2⁻⁹) moves 2·(q∘s)·(c − 128) by at most
    2⁻⁸·|q∘s|·|c − 128|ᵀ; allowed twice that plus f32 rounding near
    |q|² + |x̂|²."""
    q = sp.prep_query(vecs)
    u = torch.as_tensor(node_ids.astype(np.int32), device=q.device)
    est, ids = sp.estimate_for(sp.query_ctx(q), u)
    ok = ids >= 0
    D = sp.dim
    c = sp.nbr_codes[u.long()][:, :, :D].float()               # [B, R, D]
    xhat = c * sp.scale + sp.dmin
    exact = ((xhat - q[:, None, :]) ** 2).sum(-1)
    allowed = (2.0 ** -7 * torch.einsum("bd,brd->br", (q * sp.scale).abs(),
                                        (c - 128.0).abs())
               + 1e-5 * ((q * q).sum(-1)[:, None] + (xhat * xhat).sum(-1)))
    excess = float(((est - exact).abs() - allowed)[ok].max())
    # and the decoded codes are the neighbors the row names: within half
    # a grid step per dim, except where a row inserted after the fit lies
    # outside the fitted grid and clips
    rows = sp.data[ids.clamp(min=0).long()]
    far = float((((xhat - rows).abs() / sp.scale)[ok] > 0.501).float().mean())
    return {"rows": int(ok.sum()), "estimate_excess": excess,
            "share_beyond_half_a_step": far}


def churn_phase(torch, dev, idx, ds, counters) -> dict:
    """Phase 6b on the fitted 1M bsq8 index."""
    from alayalite_tpu_torch.ops.diagdot import block_diagdot
    from alayalite_tpu_torch.utils.evaluate import calc_recall

    eng = idx._engine
    rng = np.random.default_rng(11)
    rep = {"launches": {c.__name__: 0 for c in counters}}

    def tally():
        for c in counters:
            rep["launches"][c.__name__] += c.launches
            c.launches = 0

    dead = rng.choice(N, size=N_REMOVE, replace=False).astype(np.int32)
    for c in counters:
        c.launches = 0
    idx.remove(dead)
    ids = idx.batch_search(ds.queries, K, ef_search=64)
    back = int(np.isin(ids, dead).sum())
    log(f"churn: {back} of {N_REMOVE} removed ids returned")
    if back:
        raise AssertionError("a removed id came back from the bsq8 search")

    # new rows from the data's own clusters: random_dataset draws its
    # centers first from the same seed
    clusters = max(32, N // 2000)
    centers = (np.random.default_rng(42).normal(size=(clusters, DIM))
               .astype(np.float32) * 4.0)
    new = (centers[rng.integers(0, clusters, size=CHURN_INSERT)]
           + rng.normal(size=(CHURN_INSERT, DIM)).astype(np.float32))
    new_ids, batches = [], []
    for lo in range(0, CHURN_INSERT, CHURN_BATCH):
        tally()
        torch.cuda.synchronize()
        t = time.time()
        new_ids.append(idx.insert(new[lo:lo + CHURN_BATCH]))
        torch.cuda.synchronize()
        wall = time.time() - t
        batches.append({"rows": CHURN_BATCH, "wall_s": wall,
                        "rows_per_s": CHURN_BATCH / wall,
                        "launches": {c.__name__: c.launches
                                     for c in counters}})
        log(f"churn: inserted {CHURN_BATCH} rows in {wall:.3f}s "
            f"({CHURN_BATCH / wall:.1f} rows/s), launches "
            f"{batches[-1]['launches']}")
    new_ids = np.concatenate(new_ids)
    rep["insert"] = batches
    if not (new_ids == np.arange(N, N + CHURN_INSERT)).all():
        raise AssertionError("inserted rows did not take the next slots")
    own = float((idx.batch_search(new, 1, ef_search=64)[:, 0]
                 == new_ids).mean())
    rep["own_top1"] = own
    log(f"churn: new rows found as their own top-1 at ef 64: {own:.4f}")
    if own < CHURN_FLOOR:
        raise AssertionError(f"own top-1 share below {CHURN_FLOOR}")

    tally()
    rep["gather_on_index"] = check_gather_on_index(torch, eng.search_space,
                                                   "grown")
    rep["audit"] = audit_blocks(torch, eng.search_space,
                                torch.as_tensor(new, device=dev), new_ids)
    rep["audit"]["block_diagdot_launches"] = block_diagdot.launches
    log(f"churn: block audit of {rep['audit']['rows']} encoded neighbors: "
        f"estimate within the bf16 bound by "
        f"{-rep['audit']['estimate_excess']:.3e}, share of decoded values "
        f"beyond half a grid step of the rows "
        f"{rep['audit']['share_beyond_half_a_step']:.2e}, block_diagdot "
        f"launches {block_diagdot.launches}")
    if (rep["audit"]["estimate_excess"] > 0 or block_diagdot.launches <= 0
            or rep["audit"]["share_beyond_half_a_step"] > 1e-4):
        raise AssertionError("the inserted nodes' blocks are not in step "
                             "with their rows")

    tally()
    torch.cuda.synchronize()
    t = time.time()
    eng.compact()
    torch.cuda.synchronize()
    rep["compact_s"] = time.time() - t
    n = eng.num
    dead_d = torch.as_tensor(dead.astype(np.int64), device=dev)
    mask = torch.zeros(eng.capacity, dtype=torch.bool, device=dev)
    mask[dead_d] = True
    nbrs = eng.graph.nbrs[:n]
    held = int((mask[nbrs.clamp(min=0).long()] & (nbrs >= 0)
                & ~mask[:n, None]).sum())
    synced = bool(torch.equal(eng.graph.nbrs, eng.search_space.nbr_ids))
    log(f"churn: compact {rep['compact_s']:.2f}s, {held} removed ids left in "
        f"live rows, adjacency and blocks in step: {synced}")
    if held or not synced:
        raise AssertionError("compact left removed ids in live rows")

    xd = torch.cat([torch.as_tensor(ds.data, device=dev),
                    torch.as_tensor(new, device=dev)])
    gt = ground_truth(torch, xd, torch.as_tensor(ds.queries, device=dev), K,
                      dead=dead_d)
    del xd
    ids, dist, wall, _ = timed_search(torch, idx, ds.queries, K, (),
                                      ef_search=64)
    check_result(ids, dist, n, "bsq8 after churn")
    rec = calc_recall(ids, gt)
    tally()
    rep.update(recall=rec, qps=NQ / wall, removed_returned=back,
               removed_in_live_rows=held)
    log(f"churn: recall@10 over the live rows at ef 64 {rec:.4f}, "
        f"{NQ / wall:.1f} QPS, launches {rep['launches']}")
    if rec < CHURN_FLOOR or np.isin(ids, dead).any():
        raise AssertionError(f"recall after churn below {CHURN_FLOOR}")
    return rep


POOL_KERNELS = ("pool_merge", "sort_kv", "merge_kv", "ring_probe")


class CallCount:
    """A wrapper's calls on any device, read and set to 0 like a launch
    count: beside gather_estimate's launches it counts the hops (one
    estimate_many call each)."""

    def __init__(self, fn, name: str):
        self._fn, self.__name__ = fn, name

    @property
    def launches(self) -> int:
        return self._fn.calls

    @launches.setter
    def launches(self, n: int) -> None:
        self._fn.calls = n


def estimate_kernels(torch, sp) -> dict:
    """Every CUDA kernel one ``BQGSpace.estimate_many`` call launches on the
    fitted index at the hop's B and M (torch.profiler, the port's kernels
    and PyTorch's alike): it must be one."""
    from torch.profiler import ProfilerActivity, profile

    from alayalite_tpu_torch.ops.gather_diagdot import gather_estimate

    _, _, _, B, M = GATHER_MAIN
    rng = np.random.default_rng(7)
    u = torch.as_tensor(rng.integers(0, sp.num, size=(B, M))
                        .astype(np.int32), device=sp.device)
    ctx = sp.query_ctx(torch.as_tensor(
        rng.normal(size=(B, sp.dim)).astype(np.float32), device=sp.device))
    saved = snapshot_counts(gather_estimate)
    sp.estimate_many(ctx, u)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sp.estimate_many(ctx, u)
        torch.cuda.synchronize()
    restore_counts(saved)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    log(f"estimate_many at ({B}, {M}): {len(names)} CUDA kernel(s) per call "
        f"({sorted(set(names))})")
    if len(names) != 1:
        raise AssertionError(f"estimate_many launched {len(names)} kernels, "
                             f"not one")
    return {"kernels_per_call": len(names), "names": sorted(set(names))}


class RouteCount:
    """A wrapper's launches through one of its kernels, read and set to 0
    like the wrapper's own count, so that every phase counts them where it
    counts the wrapper: pool_merge[warp], sort_kv[network], ring_probe[hash]
    and so on."""

    def __init__(self, fn, route: str):
        self._fn, self.route = fn, route
        self.__name__ = f"{fn.__name__}[{route}]"

    @property
    def launches(self) -> int:
        return self._fn.route_launches[self.route]

    @launches.setter
    def launches(self, n: int) -> None:
        self._fn.route_launches[self.route] = n


def route_counters(fn):
    return tuple(RouteCount(fn, r) for r in fn.route_launches)


def pool_counters():
    """The kernels a graph index can launch: the pool's three, the stale
    check, and (an sq8 traversal's gathered dot) gather_diagdot; then the
    launches by kernel of pool_merge, sort_kv and ring_probe."""
    from alayalite_tpu_torch.ops.gather_diagdot import gather_diagdot
    from alayalite_tpu_torch.ops.pool_sort import merge_kv, pool_merge, sort_kv
    from alayalite_tpu_torch.ops.ring_probe import ring_probe

    return (pool_merge, sort_kv, merge_kv, ring_probe, gather_diagdot,
            *route_counters(pool_merge), *route_counters(sort_kv),
            *route_counters(ring_probe))


def hop_cat_kernels(torch, sp) -> dict:
    """The concatenation kernels one block hop launches (torch.profiler,
    the port's kernels and PyTorch's alike), on the fitted index at the
    search's shape (4096 queries, ef 64, 8 pops): the difference between a
    search of 9 hops and one of 1, over the hops. It must be 1, the pop
    ring's shift: the stale check takes the pop ring and the pool as two
    operands and concatenates nothing."""
    from torch.profiler import ProfilerActivity, profile

    from alayalite_tpu_torch.index.search import block_beam_search
    from alayalite_tpu_torch.ops.gather_diagdot import gather_estimate
    from alayalite_tpu_torch.ops.ring_probe import ring_probe

    B = GATHER_MAIN[3]
    rng = np.random.default_rng(8)
    q = torch.as_tensor(rng.normal(size=(B, sp.dim)).astype(np.float32),
                        device=sp.device)
    seeds = torch.as_tensor(rng.integers(0, sp.num, size=(B, 1))
                            .astype(np.int32), device=sp.device)
    saved = snapshot_counts(gather_estimate, ring_probe)
    seen = {}
    for iters in (1, 9):
        block_beam_search(sp, seeds, q, k=K, ef=64, max_iters=iters,
                          n_expand=8)
        torch.cuda.synchronize()
        hops = gather_estimate.calls
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            block_beam_search(sp, seeds, q, k=K, ef=64, max_iters=iters,
                              n_expand=8)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        seen[iters] = {"hops": gather_estimate.calls - hops,
                       "cat_kernels": sum("Cat" in n for n in names),
                       "kernels": len(names)}
    restore_counts(saved)
    per_hop = ((seen[9]["cat_kernels"] - seen[1]["cat_kernels"])
               / (seen[9]["hops"] - seen[1]["hops"]))
    log(f"block hop: {per_hop:.2f} concatenation kernel(s) a hop (searches "
        f"of 1 and 9 hops: {seen})")
    if per_hop != 1:
        raise AssertionError(f"a block hop launches {per_hop} concatenation "
                             f"kernels, not the pop ring's one")
    return {"cat_kernels_per_hop": per_hop, "searches": seen}


def graph_index_phase(torch, dev, name, data, queries, gt, floors: dict,
                      save_load: bool, churn=None, **params) -> dict:
    """Fit a graph index through the client, search the queries at every ef
    of ``floors`` ({ef: least recall@10}); with ``save_load`` also
    save, load and search again (the ids must not change); then, where
    ``churn`` is given, ``churn(idx)`` on the (loaded) index. Launch counts
    are taken around the fit and around each search."""
    from alayalite_tpu_torch import Client
    from alayalite_tpu_torch.index.search import overlay_descend
    from alayalite_tpu_torch.utils.evaluate import calc_recall

    counters = pool_counters()
    n = data.shape[0]
    params.setdefault("capacity", n)
    idx = Client().create_index(name, **params)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.time()
    idx.fit(data)
    torch.cuda.synchronize()
    fit_s = time.time() - t
    rep = {"rows": n, "fit_s": fit_s,
           "fit_phases": dict(idx._engine.build_timings),
           "fit_launches": {c.__name__: c.launches for c in counters},
           "overlay_levels": len(idx._engine.graph.overlay),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "search": {}}
    log(f"{name}: fit {n} rows in {fit_s:.2f}s, phases "
        + ", ".join(f"{k}={v:.2f}s" for k, v in rep["fit_phases"].items())
        + f", launches {rep['fit_launches']}, {rep['overlay_levels']} overlay "
        f"levels, peak mem {rep['peak_mem_gib']:.2f} GiB")
    for ef in floors:
        syncs = overlay_descend.syncs
        ids, dist, wall, launches = timed_search(torch, idx, queries, K,
                                                 counters, ef_search=ef)
        # timed_search makes two calls: one warm-up, one timed
        syncs = (overlay_descend.syncs - syncs) // 2
        check_result(ids, dist, n, f"{name} ef={ef}")
        rec = calc_recall(ids, gt)
        rep["search"][ef] = {"recall": rec, "qps": queries.shape[0] / wall,
                             "wall_s": wall, "launches": launches,
                             "overlay_descend_syncs": syncs}
        log(f"{name} search ef={ef}: recall@10 {rec:.4f}, "
            f"{queries.shape[0] / wall:.1f} QPS (wall {wall:.3f}s), launches "
            f"{launches}, overlay descent host syncs {syncs}")
    for ef, floor in floors.items():
        if rep["search"][ef]["recall"] < floor:
            raise AssertionError(f"{name}: recall@10 at ef={ef} below {floor}")
    if save_load:
        idx, rep["save_s"], rep["load_s"] = save_and_load(torch, idx, name)
        again = idx.batch_search(queries, K, ef_search=ef)
        rep["same_ids_after_load"] = bool((again == ids).all())
        log(f"{name}: save {rep['save_s']:.2f}s, load {rep['load_s']:.2f}s, "
            f"same ids after load: {rep['same_ids_after_load']}")
        if not rep["same_ids_after_load"]:
            raise AssertionError(f"{name}: a loaded index answers differently")
    if churn is not None:
        rep["churn"] = churn(idx)
    return rep


def save_and_load(torch, idx, name):
    """The index saved under build/ and loaded back: (loaded index,
    save seconds, load seconds)."""
    import shutil
    import tempfile

    from alayalite_tpu_torch import Index

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    try:
        t = time.time()
        idx.save(os.path.join(tmp, name))
        save_s = time.time() - t
        t = time.time()
        back = Index.load(tmp, name, device=idx.device)
        torch.cuda.synchronize()
        return back, save_s, time.time() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def raw_churn(torch, dev, idx, name, data, queries, shape, shadow: bool,
              save_load: bool = False) -> dict:
    """Raw graph churn through Index: remove random ids (seed 11; none may
    come back), insert rows from the data's own clusters in batches (rows/s
    and launches a batch; with ``shadow`` the neighbor search goes through
    the bsq8 shadow, packed and timed first, and must launch
    gather_estimate), own top-1 at ef 64, compact (timed; then no removed
    id in a live row or an overlay level, every entry point live), recall@10
    at ef 64 over the live rows; with ``save_load`` the same ids after a
    save and load. ``shape``: a RAW_CHURN entry."""
    from alayalite_tpu_torch.ops.gather_diagdot import gather_estimate
    from alayalite_tpu_torch.utils.evaluate import calc_recall

    n_remove, n_insert, batch, own_floor, floor = shape
    eng = idx._engine
    n = eng.num
    counters = (*pool_counters(), gather_estimate)
    rep = {"launches": {c.__name__: 0 for c in counters}}

    def tally():
        for c in counters:
            rep["launches"][c.__name__] += c.launches
            c.launches = 0

    rng = np.random.default_rng(11)
    dead = rng.choice(n, size=n_remove, replace=False).astype(np.int32)
    for c in counters:
        c.launches = 0
    idx.remove(dead)
    ids = idx.batch_search(queries, K, ef_search=64)
    back = int(np.isin(ids, dead).sum())
    if back:
        raise AssertionError(f"{name}: a removed id came back")

    # new rows from the data's own clusters: random_dataset draws its
    # centers first from the same seed
    clusters = max(32, n // 2000)
    centers = (np.random.default_rng(42).normal(size=(clusters, DIM))
               .astype(np.float32) * 4.0)
    new = (centers[rng.integers(0, clusters, size=n_insert)]
           + rng.normal(size=(n_insert, DIM)).astype(np.float32))
    tally()
    if shadow:
        torch.cuda.synchronize()
        t = time.time()
        eng._ensure_ins_shadow()
        torch.cuda.synchronize()
        rep["shadow_pack_s"] = time.time() - t
        log(f"{name} churn: shadow packed {n} blocks of "
            f"{eng.graph.nbrs.shape[1]} in {rep['shadow_pack_s']:.3f}s")
    new_ids, batches = [], []
    for lo in range(0, n_insert, batch):
        tally()
        torch.cuda.synchronize()
        t = time.time()
        new_ids.append(idx.insert(new[lo:lo + batch]))
        torch.cuda.synchronize()
        wall = time.time() - t
        batches.append({"rows": batch, "wall_s": wall,
                        "rows_per_s": batch / wall,
                        "launches": {c.__name__: c.launches
                                     for c in counters}})
        log(f"{name} churn: inserted {batch} rows in {wall:.3f}s "
            f"({batch / wall:.1f} rows/s), launches "
            f"{batches[-1]['launches']}")
    tally()
    rep["insert"] = batches
    rep["shadow_used"] = eng._ins_shadow is not None
    new_ids = np.concatenate(new_ids)
    if not (new_ids == np.arange(n, n + n_insert)).all():
        raise AssertionError(f"{name}: inserted rows did not take the next "
                             "slots")
    if shadow and not (rep["shadow_used"] and min(
            b["launches"]["gather_estimate"] for b in batches) > 0):
        raise AssertionError(f"{name}: the insert search did not go through "
                             "the shadow's gather_estimate")
    own = float((idx.batch_search(new, 1, ef_search=64)[:, 0]
                 == new_ids).mean())
    rep["own_top1"] = own
    log(f"{name} churn: new rows found as their own top-1 at ef 64: "
        f"{own:.4f}")
    if own < own_floor:
        raise AssertionError(f"{name}: own top-1 share below {own_floor}")

    tally()
    torch.cuda.synchronize()
    t = time.time()
    eng.compact()
    torch.cuda.synchronize()
    rep["compact_s"] = time.time() - t
    n = eng.num
    dead_d = torch.as_tensor(dead.astype(np.int64), device=dev)
    mask = torch.zeros(eng.capacity, dtype=torch.bool, device=dev)
    mask[dead_d] = True
    nbrs = eng.graph.nbrs[:n]
    held = int((mask[nbrs.clamp(min=0).long()] & (nbrs >= 0)
                & ~mask[:n, None]).sum())
    in_overlay = sum(int(torch.isin(lvl.ids, dead_d).sum())
                     for lvl in eng.graph.overlay)
    dead_eps = int(mask[eng.graph.eps.long()].sum())
    log(f"{name} churn: compact {rep['compact_s']:.3f}s, removed ids left: "
        f"{held} in live rows, {in_overlay} in the overlay, {dead_eps} entry "
        f"points")
    if held or in_overlay or dead_eps:
        raise AssertionError(f"{name}: compact left removed ids behind")

    xd = torch.cat([torch.as_tensor(data, device=dev),
                    torch.as_tensor(new, device=dev)])
    gt = ground_truth(torch, xd, torch.as_tensor(queries, device=dev), K,
                      dead=dead_d)
    del xd
    ids, dist, wall, _ = timed_search(torch, idx, queries, K, (),
                                      ef_search=64)
    check_result(ids, dist, n, f"{name} after churn")
    rec = calc_recall(ids, gt)
    tally()
    rep.update(recall=rec, qps=queries.shape[0] / wall,
               removed_returned=back, removed_in_live_rows=held,
               removed_in_overlay=in_overlay)
    log(f"{name} churn: recall@10 over the live rows at ef 64 {rec:.4f}, "
        f"{queries.shape[0] / wall:.1f} QPS, launches {rep['launches']}")
    if rec < floor or np.isin(ids, dead).any():
        raise AssertionError(f"{name}: recall after churn below {floor}")
    if save_load:
        again, rep["save_s"], rep["load_s"] = save_and_load(torch, idx, name)
        same = again.batch_search(queries, K, ef_search=64)
        rep["same_ids_after_load"] = bool((same == ids).all())
        log(f"{name} churn: same ids after save and load: "
            f"{rep['same_ids_after_load']}")
        if not rep["same_ids_after_load"]:
            raise AssertionError(f"{name}: a loaded index answers "
                                 "differently after churn")
    return rep


def raw_graph_phases(torch, dev, ds, gt) -> dict:
    """Phases 6c and 6d."""
    rep = {"hnsw_1m": graph_index_phase(
        torch, dev, "raw_hnsw", ds.data, ds.queries, gt,
        RAW_FLOORS["hnsw_1m"], True,
        churn=lambda idx: raw_churn(torch, dev, idx, "raw_hnsw", ds.data,
                                    ds.queries, RAW_CHURN["hnsw_1m"],
                                    shadow=True),
        index_type="hnsw", capacity=N + SPARE)}
    gc.collect()
    torch.cuda.empty_cache()
    rep["hnsw_1m_alpha12"] = graph_index_phase(
        torch, dev, "raw_hnsw_alpha12", ds.data, ds.queries, gt,
        RAW_FLOORS["hnsw_1m_alpha12"], False, index_type="hnsw",
        prune_alpha=1.2)
    big = rep["hnsw_1m"]
    # the fit also merges sorted lists (the overlay's exact kNN); a search
    # sorts and merges pools only
    for where, counts, kernels in (
            ("fit", big["fit_launches"], POOL_KERNELS),
            *((f"search ef={ef}", big["search"][ef]["launches"],
               ("pool_merge", "sort_kv", "ring_probe")) for ef in EFS)):
        if min(counts[k] for k in kernels) <= 0:
            raise AssertionError(f"raw hnsw {where}: a pool kernel was "
                                 f"launched no time: {counts}")
    gc.collect()
    torch.cuda.empty_cache()
    from alayalite_tpu_torch.utils.datasets import random_dataset

    # one cluster per 2000 rows, as at 1M
    small = random_dataset(n=N_SMALL, dim=DIM, n_queries=NQ, seed=42,
                           clusters=max(32, N_SMALL // 2000))
    gt_small = ground_truth(torch, torch.as_tensor(small.data, device=dev),
                            torch.as_tensor(small.queries, device=dev), K)
    for name, params in (("nsg", dict(index_type="nsg")),
                         ("fusion", dict(index_type="fusion")),
                         ("hnsw_sq8", dict(index_type="hnsw",
                                           quantization_type="sq8"))):
        churn = None
        if name != "nsg":
            # fusion: rows of 64, searched through a shadow of that
            # degree (f32, ≥ 10,000 rows); hnsw + sq8: the sq8 traversal
            def churn(idx, name=name):
                return raw_churn(torch, dev, idx, name, small.data,
                                 small.queries, RAW_CHURN["small"],
                                 shadow=name == "fusion",
                                 save_load=name == "fusion")
            params["capacity"] = N_SMALL + RAW_CHURN["small"][1]
        rep[f"{name}_100k"] = graph_index_phase(
            torch, dev, name, small.data, small.queries, gt_small,
            RAW_FLOORS[f"{name}_100k"], False, churn=churn, **params)
        gc.collect()
        torch.cuda.empty_cache()
    if min(rep["hnsw_sq8_100k"]["search"][64]["launches"]["gather_diagdot"],
           rep["hnsw_sq8_100k"]["churn"]["launches"]["gather_diagdot"]) <= 0:
        raise AssertionError("the sq8 traversal launched gather_diagdot no "
                             "time")
    return rep



def flat_phases(torch, dev, ds, gt) -> dict:
    """Phases 8-11 on the 1M rows: exact and fast flat search, removes and
    inserts, sq8_tile on the fitted codes."""
    from alayalite_tpu_torch import Client
    from alayalite_tpu_torch.ops.l2_tile import l2_tile
    from alayalite_tpu_torch.ops.pool_sort import merge_kv
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
                                             (l2_tile, merge_kv))
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
                    "merge_kv_launches": launches["merge_kv"],
                    "distance_mismatches": bad,
                    "worst_error_in_eps_of_norms": worst}
    log(f"flat exact: fit {rep['fit_s']:.2f}s, recall@10 {rec:.5f}, "
        f"{NQ / wall:.1f} QPS (wall {wall:.3f}s), l2_tile launches "
        f"{launches['l2_tile']}, merge_kv launches {launches['merge_kv']}, "
        f"distance mismatches {bad} (worst error "
        f"{worst:.2f} eps·(|q|² + |x|²))")
    if min(launches.values()) <= 0:
        raise AssertionError(f"the flat exact search launched a kernel no "
                             f"time: {launches}")
    if rec < FLAT_EXACT_FLOOR or bad:
        raise AssertionError("flat exact search is not exact")

    fast = client.create_index("flat_fast", index_type="flat",
                               flat_mode="fast", capacity=N)
    fast.fit(ds.data)
    ids_f, dist_f, wall_f, fast_launches = timed_search(
        torch, fast, ds.queries, K, (merge_kv,))
    check_result(ids_f, dist_f, N, "flat fast")
    rec_f = calc_recall(ids_f, gt)
    rep["fast"] = {"recall": rec_f, "qps": NQ / wall_f, "wall_s": wall_f,
                   "merge_kv_launches": fast_launches["merge_kv"]}
    log(f"flat fast: recall@10 {rec_f:.5f}, {NQ / wall_f:.1f} QPS "
        f"(wall {wall_f:.3f}s), merge_kv launches {fast_launches['merge_kv']}")
    del fast
    if rec_f < FLAT_FAST_FLOOR or fast_launches["merge_kv"] <= 0:
        raise AssertionError(f"flat fast recall below {FLAT_FAST_FLOOR}, or "
                             f"no merge_kv launch")

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


# ---- the SDK front door and RaBitQ (phases 12-16) ----
def new_counters():
    """The kernels the SDK and rabitq phases can launch: the pool's three,
    the stale check, gather_diagdot, their launches by kernel, and the hop
    estimates (gather_estimate through a raw insert's shadow,
    block_diagdot on the rabitq hop), the distance tile."""
    from alayalite_tpu_torch.ops.diagdot import block_diagdot
    from alayalite_tpu_torch.ops.gather_diagdot import gather_estimate
    from alayalite_tpu_torch.ops.l2_tile import l2_tile

    return (*pool_counters(), gather_estimate, block_diagdot, l2_tile)


class Launches:
    """Launch counts over a phase's steps: ``zero()`` sets every count to
    0 just before a step, ``read(step)`` keeps its counts just after."""

    def __init__(self, counters):
        self.counters, self.steps = counters, {}

    def zero(self) -> None:
        for c in self.counters:
            c.launches = 0

    def read(self, step: str) -> dict:
        got = {c.__name__: c.launches for c in self.counters}
        self.steps[step] = got
        return got

    def total(self) -> dict:
        return {c.__name__: sum(s[c.__name__] for s in self.steps.values())
                for c in self.counters}


def synced(torch, fn):
    """(fn's result, wall seconds of fn up to a device sync)."""
    torch.cuda.synchronize()
    t = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t


def cluster_rows(rng, n: int, n_base: int) -> np.ndarray:
    """``n`` new rows drawn from the clusters of random_dataset(n_base, DIM,
    seed=42), which draws its centers first from that seed."""
    clusters = max(32, n_base // 2000)
    centers = (np.random.default_rng(42).normal(size=(clusters, DIM))
               .astype(np.float32) * 4.0)
    return (centers[rng.integers(0, clusters, size=n)]
            + rng.normal(size=(n, DIM)).astype(np.float32))


def live_ground_truth(torch, col, queries) -> list:
    """Exact top-K outer ids over a collection's live rows: this script's
    ``ground_truth`` over its index's stored rows, the rows of no live id
    left out."""
    space = col._index._engine.space
    n = space.num
    live = np.zeros(n, dtype=bool)
    live[np.fromiter(col._inner_outer, dtype=np.int64)] = True
    inner = ground_truth(
        torch, space.data[:n].float(),
        torch.as_tensor(queries, dtype=torch.float32, device=space.device),
        K, dead=torch.as_tensor(np.flatnonzero(~live), device=space.device))
    return [[col._inner_outer[i] for i in row] for row in inner.tolist()]


def outer_recall(ids, gt) -> float:
    return float(np.mean([len(set(r[:K]) & set(g)) / K
                          for r, g in zip(ids, gt)]))


def collection_phase(torch, ds) -> dict:
    """Phase 12: a 1M-row collection through Client(url): one insert of
    the 1M items, 8,192 new items, an upsert of 1,024 moved ids and a
    delete_by_filter of one shard (2,000 rows); 8,192 queries at ef 64
    against ground_truth over the live rows; save_collection, and a fresh
    Client(url) that finds it and answers with the same ids."""
    import shutil
    import tempfile

    from alayalite_tpu_torch import Client

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    launches = Launches(new_counters())
    rep = {"steps_s": {}}
    steps = rep["steps_s"]
    rng = np.random.default_rng(12)
    try:
        client = Client(url=root)
        col = client.create_collection("docs", capacity=N + SPARE)
        t = time.time()
        items = [(f"d{i}", f"document {i}", ds.data[i],
                  {"shard": i % COLLECTION_SHARDS}) for i in range(N)]
        steps["items"] = time.time() - t
        launches.zero()
        _, steps["insert_1m"] = synced(torch, lambda: col.insert(items))
        launches.read("insert_1m")
        del items
        new = cluster_rows(rng, COLLECTION_NEW, N)
        launches.zero()
        _, steps["insert_new"] = synced(torch, lambda: col.insert(
            [(f"n{i}", f"new {i}", new[i], {"shard": -1})
             for i in range(COLLECTION_NEW)]))
        launches.read("insert_new")
        moved = rng.choice(N, size=COLLECTION_UPSERT, replace=False)
        moved_to = cluster_rows(rng, COLLECTION_UPSERT, N)
        launches.zero()
        _, steps["upsert"] = synced(torch, lambda: col.upsert(
            [(f"d{i}", f"moved {i}", moved_to[k],
              {"shard": int(i) % COLLECTION_SHARDS})
             for k, i in enumerate(moved)]))
        launches.read("upsert")
        dead = {f"d{i}" for i in range(COLLECTION_DEAD_SHARD, N,
                                       COLLECTION_SHARDS)}
        launches.zero()
        _, steps["delete_by_filter"] = synced(torch, lambda: col.delete_by_filter(
            {"shard": COLLECTION_DEAD_SHARD}))
        launches.read("delete_by_filter")
        if any(d in col._outer_inner for d in dead) or len(col._cols["id"]) != (
                N + COLLECTION_NEW - len(dead)):
            raise AssertionError("delete_by_filter left rows of its shard")
        gt, steps["ground_truth_live"] = synced(
            torch, lambda: live_ground_truth(torch, col, ds.queries))
        col.batch_query(ds.queries, K, ef_search=64)      # warm-up
        launches.zero()
        res, steps["batch_query"] = synced(torch, lambda: col.batch_query(
            ds.queries, K, ef_search=64))
        launches.read("batch_query")
        moved_set = {f"d{i}" for i in moved}

        def doc_of(i):
            k = i[1:]
            if i[0] == "n":
                return f"new {k}"
            return f"moved {k}" if i in moved_set else f"document {k}"

        rep["recall"] = outer_recall(res["id"], gt)
        rep["deleted_returned"] = sum(i in dead for r in res["id"] for i in r)
        rep["wrong_documents"] = sum(
            doc != doc_of(i) for ri, rd in zip(res["id"], res["document"])
            for i, doc in zip(ri, rd))
        rep["short_rows"] = sum(len(r) != K for r in res["id"])
        own, _ = synced(torch, lambda: col.batch_query(new, 1, ef_search=64))
        rep["new_own_top1"] = float(np.mean(
            [r[:1] == [f"n{i}"] for i, r in enumerate(own["id"])]))
        rep["qps"] = NQ / steps["batch_query"]
        rep["insert_1m_items_per_s"] = N / steps["insert_1m"]
        rep["insert_new_items_per_s"] = COLLECTION_NEW / steps["insert_new"]
        _, steps["save_collection"] = synced(
            torch, lambda: client.save_collection("docs"))
        del col, client
        gc.collect()
        torch.cuda.empty_cache()
        again, steps["client_url_load"] = synced(torch, lambda: Client(url=root))
        if again.list_collections() != ["docs"]:
            raise AssertionError(f"Client(url) found {again.list_collections()}")
        res2 = again.get_collection("docs").batch_query(ds.queries, K,
                                                        ef_search=64)
        rep["same_ids_after_load"] = res2["id"] == res["id"]
        rep["launches"] = launches.steps
        log(f"collection 1M: recall@10 {rep['recall']:.4f} at ef 64, "
            f"{rep['qps']:.1f} QPS, insert {rep['insert_1m_items_per_s']:.1f} "
            f"items/s (1M), {rep['insert_new_items_per_s']:.1f} items/s "
            f"({COLLECTION_NEW} new), new items' own top-1 "
            f"{rep['new_own_top1']:.4f}, deleted returned "
            f"{rep['deleted_returned']}, wrong documents "
            f"{rep['wrong_documents']}, same ids after Client(url) "
            f"{rep['same_ids_after_load']}; seconds "
            + ", ".join(f"{k} {v:.2f}" for k, v in steps.items())
            + f"; launches {launches.steps}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if rep["recall"] < COLLECTION_FLOOR or rep["deleted_returned"] or (
            rep["wrong_documents"] or rep["short_rows"]
            or rep["new_own_top1"] < CHURN_FLOOR
            or not rep["same_ids_after_load"]):
        raise AssertionError(f"collection phase failed: {rep}")
    if launches.steps["batch_query"]["pool_merge"] <= 0 or launches.steps[
            "insert_new"]["gather_estimate"] <= 0:
        raise AssertionError("the collection's search or insert launched a "
                             f"kernel of its path no time: {launches.steps}")
    return rep


def reindex_phase(torch, small) -> dict:
    """Phase 13: a 100k-row collection (phase 6d's data), 1% of its rows
    deleted, reindex(): recall@10 at ef 64 over the live rows."""
    from alayalite_tpu_torch import Client

    launches = Launches(new_counters())
    n = small.data.shape[0]
    col = Client().create_collection("re", capacity=n)
    col.insert([(f"r{i}", f"doc {i}", small.data[i], {}) for i in range(n)])
    rng = np.random.default_rng(13)
    dead = [f"r{i}" for i in rng.choice(n, size=int(REINDEX_DEAD * n),
                                        replace=False)]
    col.delete_by_id(dead)
    launches.zero()
    _, reindex_s = synced(torch, col.reindex)
    launches.read("reindex")
    gt = live_ground_truth(torch, col, small.queries)
    launches.zero()
    res, wall = synced(torch, lambda: col.batch_query(small.queries, K,
                                                      ef_search=64))
    launches.read("batch_query")
    dead_set = set(dead)
    rep = {"rows": n - len(dead), "reindex_s": reindex_s,
           "recall": outer_recall(res["id"], gt), "qps": NQ / wall,
           "deleted_returned": sum(i in dead_set for r in res["id"]
                                   for i in r),
           "launches": launches.steps}
    log(f"reindex 100k: {len(dead)} deleted, reindex {reindex_s:.2f}s, "
        f"recall@10 {rep['recall']:.4f} at ef 64, {rep['qps']:.1f} QPS, "
        f"launches {launches.steps}")
    if rep["recall"] < REINDEX_FLOOR or rep["deleted_returned"]:
        raise AssertionError(f"reindex phase failed: {rep}")
    return rep


def calc_gt_phase(torch, dev, ds, gt) -> dict:
    """Phase 14: calc_gt on the card at 1M x 8192, k 10: exact (l2_tile)
    and fast (bf16 coarse scan, f32 rerank), seconds each; exact must hold
    ≥ GT_EXACT_AGREEMENT of this script's ``ground_truth`` ids ``gt`` (ties
    aside), fast ≥ GT_FAST_AGREEMENT of the exact ids."""
    from alayalite_tpu_torch.utils.evaluate import calc_gt, calc_recall

    launches = Launches(new_counters())
    x = torch.as_tensor(ds.data, device=dev)
    q = torch.as_tensor(ds.queries, device=dev)
    rep = {}
    for mode in ("exact", "fast"):
        calc_gt(x[:65536], q[:256], K, fast=mode == "fast", device=dev)
        launches.zero()
        rep[f"{mode}_ids"], rep[f"{mode}_s"] = synced(
            torch, lambda: calc_gt(x, q, K, fast=mode == "fast", device=dev))
        launches.read(mode)
    exact, fast = rep.pop("exact_ids"), rep.pop("fast_ids")
    rep["exact_vs_ground_truth"] = calc_recall(exact, gt)
    rep["agreement"] = calc_recall(fast, exact)
    rep["launches"] = launches.steps
    log(f"calc_gt 1M x {NQ}, k {K}: exact {rep['exact_s']:.3f}s (holds "
        f"{rep['exact_vs_ground_truth']:.5f} of ground_truth's ids), fast "
        f"{rep['fast_s']:.3f}s, fast agrees on {rep['agreement']:.5f} of the "
        f"exact ids; launches {launches.steps}")
    if rep["exact_vs_ground_truth"] < GT_EXACT_AGREEMENT:
        raise AssertionError("calc_gt exact holds "
                             f"{rep['exact_vs_ground_truth']} of the truth")
    if rep["agreement"] < GT_FAST_AGREEMENT:
        raise AssertionError(f"calc_gt fast agrees on {rep['agreement']}")
    if launches.steps["exact"]["l2_tile"] <= 0 or min(
            launches.steps[m]["merge_kv"] for m in ("exact", "fast")) <= 0:
        raise AssertionError("calc_gt launched l2_tile or merge_kv no time")
    return rep


def hop_dot_check(torch, sp, queries) -> dict:
    """The rabitq hop's binary dot on the fitted index's own blocks, at the
    hop's shape (4096 queries x 8 popped nodes x 32 neighbors, E 128):
    block_diagdot on the unpacked codes against block_diagdot_ref on the
    same codes and against binary_dot_ref (the JAX package's form: the bit
    planes apart); the kernel's times beside the whole estimate_many."""
    from alayalite_tpu_torch.ops.diagdot import block_diagdot, block_diagdot_ref
    from alayalite_tpu_torch.spaces.rabitq import binary_dot_ref, unpack_codes
    from alayalite_tpu_torch.utils.timing import bound, cuda_ms

    saved = block_diagdot.calls, block_diagdot.launches
    B, M = min(GATHER_MAIN[3], queries.shape[0]), GATHER_MAIN[4]
    rng = np.random.default_rng(14)
    q = sp.prep_query(torch.as_tensor(queries[:B], device=sp.device))
    u = torch.as_tensor(rng.integers(0, sp.num, size=(B, M))
                        .astype(np.int64), device=sp.device)
    ctx = sp.query_ctx(q)
    packed = sp.nbr_bits.index_select(0, u.reshape(-1)).view(B, M * 32, -1)
    codes = unpack_codes(packed, sp.bits)
    got = block_diagdot(codes, ctx[1])
    want = block_diagdot_ref(codes, ctx[1])
    jax_form = binary_dot_ref(packed, q @ sp.rot.T, sp.bits)
    torch.cuda.synchronize()
    tol = 1e-3 * float(want.abs().max()) + 1e-3
    rep = {"shape": list(codes.shape), "bits": sp.bits,
           "max_abs_err": float((got - want).abs().max()),
           "max_abs_err_jax_form": float((got - jax_form).abs().max()),
           "tol": tol,
           "ms_spin": cuda_ms(lambda: block_diagdot(codes, ctx[1]), spin=True),
           "plain_ms": cuda_ms(lambda: block_diagdot_ref(codes, ctx[1])),
           "estimate_many_ms_spin": cuda_ms(lambda: sp.estimate_many(ctx, u),
                                            spin=True),
           **bound(codes.numel() + ctx[1].numel() * 2 + got.numel() * 4,
                   2 * codes.numel(), "f32")}
    block_diagdot.calls, block_diagdot.launches = saved
    log(f"rabitq hop dot {rep['shape']} ({sp.bits} bit): block_diagdot "
        f"max_abs_err {rep['max_abs_err']:.3e} vs its plain version, "
        f"{rep['max_abs_err_jax_form']:.3e} vs the planes-apart form (tol "
        f"{tol:.3e}); {rep['ms_spin']:.4f} ms device alone (bound "
        f"{rep['bound_ms']:.4f}), the whole estimate_many "
        f"{rep['estimate_many_ms_spin']:.4f} ms")
    if not max(rep["max_abs_err"], rep["max_abs_err_jax_form"]) <= tol:
        raise AssertionError(f"the rabitq hop's dot disagrees: {rep}")
    return rep


def frontier_iters(ef: int) -> int:
    """The hop budget of results/sift1m_frontier.json (bench.py's)."""
    return max(3, ef // 8)


def rabitq_search(torch, idx, queries, gt, ef: int, launches, step: str,
                  budget=None):
    """One warm-up and one timed search at ``ef``, with the hop budget
    ``budget(ef)`` or the index's own: (recall, QPS, ids)."""
    from alayalite_tpu_torch.utils.evaluate import calc_recall

    if budget is not None:
        idx._engine.params.search_iters = budget(ef)
    idx.batch_search(queries, K, ef_search=ef)
    launches.zero()
    (ids, dist), wall = synced(torch, lambda: idx.batch_search_with_distance(
        queries, K, ef_search=ef))
    got = launches.read(step)
    check_result(ids, dist, idx._engine.space.num, step)
    if got["block_diagdot"] <= 0 or got["block_diagdot"] != got["ring_probe"]:
        raise AssertionError(f"{step}: the rabitq hop did not launch "
                             f"block_diagdot once a hop: {got}")
    return calc_recall(ids, gt), queries.shape[0] / wall, ids


def rabitq_phase(torch, name, data, queries, gt, floors: dict,
                 churn: bool, budget=None, **params) -> dict:
    """Phases 15 (1-bit at 1M: fit, the frontier's efs and hop budget, the
    hop's dot, insert, remove, save/load) and 16 (rabitq2 at 100k: fit,
    search with the default budget, save/load)."""
    from alayalite_tpu_torch import Client

    launches = Launches(new_counters())
    n = data.shape[0]
    idx = Client().create_index(name, capacity=n + (RABITQ_INSERT if churn
                                                   else 0), **params)
    torch.cuda.reset_peak_memory_stats()
    launches.zero()
    _, fit_s = synced(torch, lambda: idx.fit(data))
    launches.read("fit")
    rep = {"rows": n, "fit_s": fit_s,
           "fit_phases": dict(idx._engine.build_timings),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "search": {}}
    log(f"{name}: fit {n} rows in {fit_s:.2f}s, phases "
        + ", ".join(f"{k}={v:.2f}s" for k, v in rep["fit_phases"].items())
        + f", peak mem {rep['peak_mem_gib']:.2f} GiB")
    for ef in floors:
        rec, qps, ids = rabitq_search(torch, idx, queries, gt, ef, launches,
                                      f"search ef={ef}", budget)
        iters = idx._engine.params.search_iters
        rep["search"][ef] = {"recall": rec, "qps": qps, "iters": iters}
        log(f"{name} search ef={ef} (iters {iters or 'auto'}): recall@10 "
            f"{rec:.4f}, {qps:.1f} QPS, launches "
            f"{launches.steps[f'search ef={ef}']}")
    low = {ef: r["recall"] for ef, r in rep["search"].items()
           if r["recall"] < floors[ef]}
    if low:
        raise AssertionError(f"{name}: recall@10 below its floor at {low}")
    ef = max(floors)
    if churn:
        rep["hop_dot"] = hop_dot_check(torch, idx._engine.search_space,
                                       queries)
        rng = np.random.default_rng(15)
        new = cluster_rows(rng, RABITQ_INSERT, n)
        if budget is not None:
            idx._engine.params.search_iters = budget(64)
        launches.zero()
        new_ids, ins_s = synced(torch, lambda: idx.insert(new))
        launches.read("insert")
        own = idx.batch_search(new, 1, ef_search=64)[:, 0]
        rep["insert"] = {"rows": RABITQ_INSERT, "wall_s": ins_s,
                         "rows_per_s": RABITQ_INSERT / ins_s,
                         "own_top1": float((own == new_ids).mean())}
        dead = rng.choice(n, size=RABITQ_REMOVE, replace=False)
        _, rm_s = synced(torch, lambda: idx.remove(dead))
        rec, qps, ids = rabitq_search(torch, idx, queries, gt, 64, launches,
                                      "search after remove", budget)
        rep["remove"] = {"rows": RABITQ_REMOVE, "wall_s": rm_s,
                         "returned": int(np.isin(ids, dead).sum())}
        ef = 64
        log(f"{name}: insert {RABITQ_INSERT} rows in {ins_s:.2f}s "
            f"({rep['insert']['rows_per_s']:.1f} rows/s), own top-1 "
            f"{rep['insert']['own_top1']:.4f}, launches "
            f"{launches.steps['insert']}; remove {RABITQ_REMOVE} in "
            f"{rm_s:.2f}s, {rep['remove']['returned']} returned")
        if rep["insert"]["own_top1"] < CHURN_FLOOR or rep["remove"][
                "returned"]:
            raise AssertionError(f"{name} churn failed: {rep}")
    before = idx.batch_search(queries, K, ef_search=ef)
    back, rep["save_s"], rep["load_s"] = save_and_load(torch, idx, name)
    rep["same_ids_after_load"] = bool(
        (back.batch_search(queries, K, ef_search=ef) == before).all())
    log(f"{name}: save {rep['save_s']:.2f}s, load {rep['load_s']:.2f}s, same "
        f"ids after load: {rep['same_ids_after_load']}")
    if not rep["same_ids_after_load"]:
        raise AssertionError(f"{name}: a loaded index answers differently")
    rep["launches"] = launches.steps
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
    from alayalite_tpu_torch.ops.gather_diagdot import gather_estimate
    from alayalite_tpu_torch.ops.l2_tile import l2_tile
    from alayalite_tpu_torch.ops.pool_sort import pool_merge, sort_kv
    from alayalite_tpu_torch.ops.ring_probe import ring_probe
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
    report["build_seconds"] = dict(_build.build_seconds)
    log(f"build: {sorted(built)} in {report['build_s']:.2f}s, by source "
        + ", ".join(f"{k} {v:.2f}s" for k, v in
                    sorted(_build.build_seconds.items())))
    # ptxas C7520: wgmma serialized. A warning, but one that costs the
    # tensor cores their overlap, so it is logged and counted
    report["build_warnings"] = {
        k: [ln for ln in v.splitlines() if "warning" in ln]
        for k, v in _build.build_logs.items()}
    for k, lines in report["build_warnings"].items():
        for ln in lines:
            log(f"build warning ({k}): {ln}")
    report["sq8_sass"] = check_hgmma()

    report["block_diagdot"] = check_diagdot(torch, dev)
    report.update(check_gather(torch, dev))
    report["ring_probe"] = check_ring_probe(torch, dev)
    report.update(check_pool_sort(torch, dev))
    report["sq8_gather"] = check_sq8_gather(torch, dev)
    # the kernels of every block hop, and the hops (estimate_many calls)
    hop = (gather_estimate, ring_probe,
           CallCount(gather_estimate, "estimate_many_calls"))
    # pool_merge, sort_kv, merge_kv, and the launches by kernel of
    # pool_merge, sort_kv and ring_probe
    pool = (*pool_counters()[:3], *pool_counters()[5:])

    t = time.time()
    # bench.py's synthetic SIFT1M stand-in: one cluster per 2000 rows
    ds = random_dataset(n=N, dim=DIM, n_queries=NQ, seed=42,
                        clusters=max(32, N // 2000))
    log(f"data: {N}x{DIM}, {NQ} queries in {time.time() - t:.1f}s")
    client = Client()
    idx = client.create_index("smoke", index_type="hnsw",
                              quantization_type="bsq8", max_nbrs=32,
                              ef_construction=200, prune_alpha=1.2,
                              seed_sample=16384, beam_expand=8,
                              capacity=N + SPARE)
    for c in (block_diagdot, l2_tile, sq8_tile, *hop, *pool):
        c.launches = 0
    torch.cuda.synchronize()
    t = time.time()
    idx.fit(ds.data)
    torch.cuda.synchronize()
    fit_s = time.time() - t
    fit_launches = {c.__name__: c.launches for c in hop}
    # the pool kernels' launches on the bsq8 path, summed phase by phase
    bsq8_pool = {c.__name__: c.launches for c in pool}
    timings = idx._engine.build_timings
    log(f"fit: {fit_s:.2f}s, phases "
        + ", ".join(f"{k}={v:.2f}s" for k, v in timings.items())
        + f", launches {fit_launches}, l2_tile launches "
        f"{l2_tile.launches} (find_medoid), peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if min(fit_launches.values()) <= 0:
        raise AssertionError("the fit launched a hop kernel no time")
    report["fit"] = {"seconds": fit_s, "phases": timings,
                     "launches": {**fit_launches, **bsq8_pool},
                     "l2_tile_launches": l2_tile.launches}

    report["gather_on_index"] = {"fitted": check_gather_on_index(
        torch, idx._engine.search_space, "fitted")}
    report["estimate_many"] = estimate_kernels(torch,
                                               idx._engine.search_space)
    report["hop_cats"] = hop_cat_kernels(torch, idx._engine.search_space)

    t = time.time()
    xd = torch.as_tensor(ds.data, device=dev)
    qd = torch.as_tensor(ds.queries, device=dev)
    gt = ground_truth(torch, xd, qd, K)
    del xd, qd
    log(f"ground truth: {time.time() - t:.2f}s")

    report["search"] = {}
    search_launches = {c.__name__: 0 for c in hop}
    for ef in EFS:
        ids, dist, wall, launches = timed_search(
            torch, idx, ds.queries, K, (*hop, *pool), ef_search=ef)
        for c in pool:
            bsq8_pool[c.__name__] += launches[c.__name__]
        for kernel in search_launches:
            search_launches[kernel] += launches[kernel]
        check_result(ids, dist, N, f"bsq8 ef={ef}")
        rec = calc_recall(ids, gt)
        log(f"search ef={ef}: recall@10 {rec:.4f}, {NQ / wall:.1f} QPS "
            f"(wall {wall:.3f}s), launches {launches}")
        if min(launches[k] for k in (*search_launches, "pool_merge",
                                     "sort_kv")) <= 0:
            raise AssertionError("the search launched a hop kernel no time")
        if launches["gather_estimate"] != launches["estimate_many_calls"]:
            raise AssertionError("a hop's estimate_many did not launch "
                                 "gather_estimate exactly once")
        report["search"][ef] = {"recall": rec, "qps": NQ / wall,
                                "wall_s": wall, "launches": launches}
        report["estimate_many"][f"launches_per_hop_ef{ef}"] = (
            launches["gather_estimate"] / launches["estimate_many_calls"])
    if report["search"][64]["recall"] < RECALL_FLOOR:
        raise AssertionError(f"recall@10 at ef=64 below {RECALL_FLOOR}")

    report["small"] = small_agreement(torch)
    for c in pool:
        c.launches = 0
    report["churn"] = churn_phase(torch, dev, idx, ds,
                                  (*hop, block_diagdot))
    for c in pool:
        bsq8_pool[c.__name__] += c.launches
    del idx, client
    gc.collect()
    torch.cuda.empty_cache()

    report["raw"] = raw_graph_phases(torch, dev, ds, gt)

    report["tiles"] = check_tiles(torch, dev)
    report["flat"] = flat_phases(torch, dev, ds, gt)
    gc.collect()
    torch.cuda.empty_cache()

    report["collection"] = collection_phase(torch, ds)
    gc.collect()
    torch.cuda.empty_cache()
    # phase 6d's data
    small = random_dataset(n=N_SMALL, dim=DIM, n_queries=NQ, seed=42,
                           clusters=max(32, N_SMALL // 2000))
    report["reindex"] = reindex_phase(torch, small)
    report["calc_gt"] = calc_gt_phase(torch, dev, ds, gt)
    gc.collect()
    torch.cuda.empty_cache()
    report["rabitq"] = rabitq_phase(torch, "rabitq_1m", ds.data, ds.queries,
                                    gt, RABITQ_FLOORS, True, frontier_iters,
                                    **RABITQ_PARAMS)
    gc.collect()
    torch.cuda.empty_cache()
    gt_small = ground_truth(torch, torch.as_tensor(small.data, device=dev),
                            torch.as_tensor(small.queries, device=dev), K)
    report["rabitq2"] = rabitq_phase(
        torch, "rabitq2_100k", small.data, small.queries, gt_small,
        RABITQ2_FLOORS, False, index_type="hnsw", quantization_type="rabitq2")
    report["total_s"] = time.time() - t_start

    def row(name, source, replaces, launches, nums):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "ms_spin")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                **{k: nums[k] for k in keys}}

    churn_launches = report["churn"]["launches"]

    def raw_launches(kernel):
        """Launches on the raw graph path: the fits, their timed searches
        and the churns."""
        return sum(ph["fit_launches"].get(kernel, 0)
                   + sum(s["launches"].get(kernel, 0)
                         for s in ph["search"].values())
                   + ph.get("churn", {}).get("launches", {}).get(kernel, 0)
                   for ph in report["raw"].values())

    raw_churn_launches = {
        name: ph["churn"]["launches"] for name, ph in report["raw"].items()
        if "churn" in ph}

    def hop_launches(kernel):
        return (fit_launches[kernel] + search_launches[kernel]
                + churn_launches[kernel])

    def new_launches(kernel, phases=NEW_PHASES, steps=None):
        """Launches in the SDK and rabitq phases (12-16): every step, or
        the steps named ``steps``."""
        return sum(counts[kernel] for ph in phases
                   for step, counts in report[ph]["launches"].items()
                   if steps is None or step in steps)

    rabitq_searches = sum(new_launches(
        "block_diagdot", (ph,), [s for s in report[ph]["launches"]
                                 if s.startswith("search")])
        for ph in ("rabitq", "rabitq2"))

    def pool_row(name, replaces, launched_by, flat=0, **more):
        """``flat``: the kernel's launches on the flat path."""
        on_path = (bsq8_pool[name] + raw_launches(name) + flat
                   + new_launches(name))
        if on_path <= 0:
            raise AssertionError(f"{name} was launched no time on the paths")
        return {**row(name, "alayalite_tpu_torch/csrc/pool_sort.cu", replaces,
                      on_path, report[name]),
                "launches_bsq8_path": bsq8_pool[name],
                "launches_raw_path": raw_launches(name),
                "launches_raw_churn": {k: v[name] for k, v in
                                       raw_churn_launches.items()},
                "launches_sdk_rabitq": new_launches(name),
                "differing_entries": report[name]["differing_entries"],
                "launched_by": launched_by, **more}

    def launches_by_route(fn, total, path_route):
        """A wrapper's launches on the paths by kernel; they must add up to
        its launches, and every path shape must take ``path_route``."""
        by = {c.route: bsq8_pool[c.__name__] + raw_launches(c.__name__)
                  + new_launches(c.__name__) for c in route_counters(fn)}
        if sum(by.values()) != total:
            raise AssertionError(f"{fn.__name__}'s launches by kernel {by} "
                                 f"do not add up to its {total} launches")
        if path_route is not None and by[path_route] != total:
            raise AssertionError(f"a path shape took {fn.__name__}'s other "
                                 f"kernel: {by}")
        return by

    by_route = launches_by_route(
        pool_merge, bsq8_pool["pool_merge"] + raw_launches("pool_merge")
        + new_launches("pool_merge"), None)
    sort_routes = launches_by_route(
        sort_kv, bsq8_pool["sort_kv"] + raw_launches("sort_kv")
        + new_launches("sort_kv"), "warp")
    probe_launches = (hop_launches("ring_probe") + raw_launches("ring_probe")
                      + new_launches("ring_probe"))
    probe_routes = launches_by_route(ring_probe, probe_launches, "hash")
    gather, fused = report["gather_diagdot"], report["gather_estimate"]
    # merge_kv by path: find_medoid in the bsq8 fit (the rest of the bsq8
    # path launches it no time), the raw fits (find_medoid, the overlay's
    # exact kNN), the flat scans
    merge_paths = {
        "bsq8_fit_find_medoid": report["fit"]["launches"]["merge_kv"],
        "bsq8_search_and_churn": (bsq8_pool["merge_kv"]
                                  - report["fit"]["launches"]["merge_kv"]),
        "raw": raw_launches("merge_kv"),
        "flat_exact": report["flat"]["exact"]["merge_kv_launches"],
        "flat_fast": report["flat"]["fast"]["merge_kv_launches"],
        "calc_gt": new_launches("merge_kv", ("calc_gt",)),
        "sdk_and_rabitq_fits": new_launches("merge_kv", (
            "collection", "reindex", "rabitq", "rabitq2"))}
    log(f"merge_kv launches by path: {merge_paths}")

    def entries(rep):
        """Both entries' times at the hop's shape and at R = 1."""
        keys = ("rows_ms", "rows_ms_spin", "bulk_ms", "bulk_ms_spin",
                "bound_ms", "plain_ms", "shape", "distinct_nodes")
        return {at: {k: rep[at][k] for k in keys if k in rep[at]}
                for at in ("main", "r1")}

    kernels = {"kernels": [
        # the rabitq hop's binary dot (one launch a hop: Index.batch_search
        # and the insert's neighbor search), and the bsq8 churn phase's
        # block audit through BQGSpace.estimate_for
        {**row("block_diagdot", "alayalite_tpu_torch/csrc/gather_diagdot.cu",
               "alayalite_tpu/ops/pallas_block.py:64",
               churn_launches["block_diagdot"]
               + new_launches("block_diagdot"), report["block_diagdot"]),
         "entry": "alaya_block_diagdot (the rows kernel, identity gather)",
         "launched_by": "RaBitQSpace.estimate_many: the rabitq / rabitq2 "
                        "hop's binary dot over the unpacked codes, one "
                        "launch a hop (Index.batch_search, the insert's "
                        "neighbor search); BQGSpace.estimate_for in the "
                        "bsq8 churn phase's block audit",
         "launches_by_phase": {
             "bsq8_churn_audit": churn_launches["block_diagdot"],
             "rabitq_1m": new_launches("block_diagdot", ("rabitq",)),
             "rabitq2_100k": new_launches("block_diagdot", ("rabitq2",))},
         "launches_from_index_batch_search": rabitq_searches,
         "rabitq_hop": report["rabitq"]["hop_dot"]},
        # one source, two entry points (rows, bulk), each with the estimate
        # fused in or not. The dot alone is the sq8 traversal's (R = 1,
        # the numbers above); the hop launches the fused estimate
        {**row("gather_diagdot", "alayalite_tpu_torch/csrc/gather_diagdot.cu",
               "scripts/proto_dma_gather.py:93",
               raw_launches("gather_diagdot") + new_launches("gather_diagdot"),
               gather),
         "also_replaces": "scripts/proto_dma_gather2.py:124",
         "launched_by": "SQSpace.gather_dists: the sq8 traversal's dot",
         "variant": gather["variant"], "at": entries(gather)},
        {**row("gather_estimate", "alayalite_tpu_torch/csrc/gather_diagdot.cu",
               "scripts/proto_dma_gather.py:93",
               hop_launches("gather_estimate")
               + raw_launches("gather_estimate")
               + new_launches("gather_estimate"), fused),
         "also_replaces": "scripts/proto_dma_gather2.py:124",
         "launched_by": "BQGSpace.estimate_many: every block hop (fit pools, "
                        "search, insert, and a raw graph's insert through "
                        "its bsq8 shadow, the collection's inserts too), "
                        "one launch a hop",
         "launches_raw_churn": raw_launches("gather_estimate"),
         "launches_sdk": new_launches("gather_estimate"),
         "variant": fused["variant"], "at": entries(fused),
         "kernels_per_estimate_many": report["estimate_many"][
             "kernels_per_call"]},
        {**row("ring_probe", "alayalite_tpu_torch/csrc/ring_probe.cu",
               "scripts/proto_pallas_sort2.py:135", probe_launches,
               report["ring_probe"]),
         "launched_by": "block_beam_search (pop ring and pool as two "
                        "operands) and the raw beam's pop ring, every hop",
         "kernel_route": report["ring_probe"]["route"],
         "launches_by_route": probe_routes,
         "hash_ms": report["ring_probe"]["hash_ms"],
         "hash_ms_spin": report["ring_probe"]["hash_ms_spin"],
         "scan_ms": report["ring_probe"]["scan_ms"],
         "scan_ms_spin": report["ring_probe"]["scan_ms_spin"],
         "scan_bound_ms": report["ring_probe"]["scan_bound_ms"],
         "cat_kernels_per_block_hop": report["hop_cats"][
             "cat_kernels_per_hop"],
         "at": {shape: {k: rep[k] for k in (
             "ms", "ms_spin", "hash_ms", "hash_ms_spin", "scan_ms",
             "scan_ms_spin", "bound_ms", "bound_by", "scan_bound_ms")}
             for shape, rep in report["ring_probe"]["at"].items()}},
        pool_row("sort_kv", "scripts/proto_pallas_sort.py:139",
                 "ops/topk.topk_smallest: the k best of a pool at the end of "
                 "every beam search and exact re-score, the prune's "
                 "compaction, NN-Descent's joins",
                 also_replaces=["scripts/proto_pallas_sort2.py:135"],
                 kernel_route=report["sort_kv"]["route"],
                 launches_by_route=sort_routes,
                 **{k: report["sort_kv"][k] for k in (
                     "columns_ms", "columns_ms_spin", "keys_only_ms",
                     "keys_only_ms_spin", "network_ms", "network_ms_spin")},
                 at={shape: {k: rep[k] for k in (
                     "warp_ms", "warp_ms_spin", "network_ms",
                     "network_ms_spin", "plain_ms", "library_ms", "bound_ms")}
                     for shape, rep in report["sort_kv"]["at"].items()}),
        pool_row("merge_kv", "scripts/proto_pallas_sort.py:154",
                 "ops/distance.exact_topk: the per-tile [Q, k] + [Q, k] merge "
                 "of find_medoid, the overlay's exact kNN and the flat scans",
                 flat=sum(merge_paths[p] for p in ("flat_exact",
                                                   "flat_fast")),
                 launches_by_path=merge_paths,
                 empty_kernel_ms_spin=report["merge_kv"][
                     "empty_kernel_ms_spin"],
                 at={shape: {k: rep[k] for k in (
                     "k", "ms", "ms_spin", "spin_over_empty_kernel",
                     "copy_ms_spin", "plain_ms", "library_ms", "bound_ms",
                     "bound_by")}
                     for shape, rep in report["merge_kv"]["at"].items()}),
        pool_row("pool_merge", "scripts/proto_pallas_sort.py:139",
                 "ops/topk.merge_topk_dedup / merge_topk_with_flags / "
                 "merge_topk: the pool merge of every hop (raw and block)",
                 also_replaces=["scripts/proto_pallas_sort.py:154"],
                 kernel_route=report["pool_merge"]["route"],
                 launches_by_route=by_route,
                 network_ms=report["pool_merge"]["network_ms"],
                 network_ms_spin=report["pool_merge"]["network_ms_spin"],
                 at={shape: {k: rep[k] for k in (
                     "ms", "ms_spin", "plain_ms", "library_ms", "bound_ms",
                     "network_ms", "network_ms_spin", "route")}
                     for shape, rep in report["pool_merge"]["at"].items()}),
        # a calibration, as on the TPU: no path runs it
        {**row("roll_n", "alayalite_tpu_torch/csrc/roll_n.cu",
               "scripts/opt_hop2.py:132", 0, report["roll_n"]),
         "kernel_route": report["roll_n"]["route"],
         "shared_ms": report["roll_n"]["shared_ms"],
         "shared_ms_spin": report["roll_n"]["shared_ms_spin"],
         "library_ms_spin": report["roll_n"]["library_ms_spin"],
         "launched_by": "no path: it calibrates the cost of one exchange "
                        "step, as scripts/opt_hop2.py does on the TPU",
         "n": ROLLS[0],
         "differing_entries": report["roll_n"]["differing_entries"],
         "ns_per_exchange_step_and_list":
             report["roll_n"]["ns_per_exchange_step_and_list"],
         **{f"n{n}": {k: report["roll_n"][str(n)][k] for k in (
             "ms", "ms_spin", "plain_ms", "library_ms", "library_ms_spin",
             "shared_ms", "shared_ms_spin",
             "ns_per_exchange_step_and_list")} for n in ROLLS}},
        {**row("l2_tile", "alayalite_tpu_torch/csrc/l2_tile.cu",
               "alayalite_tpu/ops/pallas_distance.py:70",
               report["flat"]["exact"]["l2_tile_launches"]
               + new_launches("l2_tile"), report["tiles"]["l2_tile"]),
         "launches_by_path": {
             "flat_exact": report["flat"]["exact"]["l2_tile_launches"],
             "calc_gt": new_launches("l2_tile", ("calc_gt",)),
             "sdk_and_rabitq_fits": new_launches("l2_tile", (
                 "collection", "reindex", "rabitq", "rabitq2"))}},
        {**row("sq8_tile", "alayalite_tpu_torch/csrc/sq8_tile.cu",
               "alayalite_tpu/ops/pallas_distance.py:141",
               report["flat"]["sq8"]["launches"], report["tiles"]["sq8_tile"]),
         "library_f32_ms": report["tiles"]["sq8_tile"]["library_f32_ms"],
         "library_ms_is": "bf16 torch.matmul with a bf16 output; "
                          "library_f32_ms: torch.mm(..., out_dtype=float32)",
         "hgmma_instructions": report["sq8_sass"]["hgmma_instructions"]},
    ]}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump({**report, **kernels}, f, indent=1)
    log(f"total: {report['total_s']:.1f}s")
    churn = report["churn"]
    print(json.dumps({"summary": {
        "fit_s": fit_s, "fit_phases": timings, "fit_launches": fit_launches,
        "search": report["search"],
        "churn": {"insert": churn["insert"], "own_top1": churn["own_top1"],
                  "compact_s": churn["compact_s"], "recall": churn["recall"],
                  "qps": churn["qps"], "launches": churn_launches,
                  "removed_returned": churn["removed_returned"],
                  "removed_in_live_rows": churn["removed_in_live_rows"]},
        "raw": report["raw"], "sq8_gather": report["sq8_gather"],
        "estimate_many": report["estimate_many"],
        "bsq8_pool_launches": bsq8_pool,
        "flat": {k: report["flat"][k] for k in ("fit_s", "exact", "fast")},
        **{ph: report[ph] for ph in NEW_PHASES},
        "total_s": report["total_s"]}}))
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
