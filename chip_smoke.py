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
               pool_merge (the hop's merge_topk_dedup, on ties,
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
               hop's shape with the kernel's own time beside it; and
               seed_scan (the block search's seed scan) against its plain
               version at the slice's (4096, 16384, 128, 8), a served batch
               and ragged shapes (D 100, 960; nseed 1, 16), timed beside
               the library chain it replaced (library_ms); and
               unique_topk (the block search's final selection) bit for
               bit against its plain version at the paths' (B, W, k), timed
               at the 1-bit search's (4096, 522, 10) and bsq8's
               (4096, 64, 10) beside the duplicate net and top k it
               replaced (library_ms); and gather_dot (the exact
               re-scoring) against float64 distances at the paths' (B, K,
               D) and odd D, bit for bit its plain version (the chain it
               replaced) at D 128, a pair bit-equal in any batch and at
               K 8, timed at (4096, 512, 128) and (4096, 8, 128) over 1M
               rows beside the plain version and index_select + bmm
               (library_ms), against the bytes of its distinct rows; and
               tile_topk (the flat scans' per-tile selection) bit for bit
               against its plain version at the scans' (Q, n, k), into a
               running best from an earlier tile, timed at the exact
               scan's (4096, 16384, 10) and the fast scan's
               (4096, 65536, 40) beside select_smallest + merge_topk, the
               chain it replaced (library_ms), against the tile's bytes;
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
               sort_kv, tile_topk and ring_probe (each must be launched in
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
               and tile_topk launches (fails at 0);
  9. fast      a flat index with flat_mode="fast": recall@10 (fails below
               0.99), wall QPS, tile_topk launches (fails at 0);
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
Then serving, the service, flat + sq4, the native runtime and RAG, each
where its input stands:
 17. serving   (after phase 4's searches, before its churn) SearchServer
               (topk 10, ef 64, max_batch 1024, timeout 2 ms) on the 1M
               bsq8 index: an open loop (8 threads submit() the 8192
               queries, then the futures are read) and a closed loop (64
               threads x 128 blocking search() calls): QPS, p50 / p99
               latency, batches popped and their mean size, launches of
               gather_estimate, ring_probe and pool_merge (each must be >
               0), recall@10 (fails below 0.95, or, where a served row
               differs from one direct batch_search_with_distance, more
               than 0.002 from that call's), no failed request;
 18. service   (after phase 12, on the directory it saved) create_app(
               data_dir) behind the stdlib HTTP server on 127.0.0.1, port
               0: default mode, the queries as 16 requests of 512 vectors
               from 4 threads (the ids must be phase 12's), one request's
               time split into JSON decode, request model, search, join and
               JSON encode; ALAYALITE_BATCH_SERVING=1, 8192 single-vector
               requests from 64 threads (recall@10 over the live rows ≥
               0.90, every document its id's); then over HTTP an insert of
               1,000 items (own top-1 ≥ 0.95), an upsert of 100, a
               delete_by_id of 100 (none may come back), a delete_by_filter
               of one shard, save, and a 404 on a missing collection;
               requests/s, p50 / p99 latency and bytes a request by mode;
 19. flat_sq4  (after phase 11) flat + sq4 on the 1M rows: fit, the exact
               search of the raw rows (recall@10 ≥ 0.999, l2_tile
               launches > 0), 1,000 inserts (each its own top-1), 10,000
               removes (none may come back), save / load (the same ids and
               codes);
 20. native    (last) native.get_lib() must load; the 1M rows through
     + rag     save_fvecs, then load_fvecs (the native loader) must equal
               the numpy loader's array, seconds of each; 2,000 generated
               documents of ~2 kB cut by FixedSizeChunker, embedded by
               HashingEmbedding(dim=256), inserted into a cos collection;
               256 chunks' own texts queried, each its own top-1 (fails
               below 0.99); chunks/s embedded, items/s inserted; the
               fvecs file stays for phase 24.
 21. db_shards hnsw + bsq8 with phase 4's parameters and db_shards=4 on the
               1M rows through Client (4 shards of 250,000, per-shard fit
               seconds), the 8192 queries at ef 32 and 64 with the card's
               real device list (one card: the per-shard search and a host
               merge) and under force_devices(4, "cuda") (the mesh program
               db_sharded_block_search): recall@10 (floor 0.95 at ef 64 in
               both), QPS, launches of gather_estimate, ring_probe,
               pool_merge and unique_topk (each > 0); 8,192 inserted rows (ids
               past 1M, own top-1 ≥ 0.95, their blocks audited through
               block_diagdot), 10,000 removes (none may come back),
               compact, save / load (the same ids in both modes); then flat
               exact with db_shards=4 (recall ≥ 0.999, distances against
               direct f32 distances, the same ids in both modes, l2_tile
               launched);
 22. build_shards  results/sharded_build_100k.json's data (100k x 64, 64
               clusters) and index (hnsw, R 24, efc 96) with
               build_shards=8 under force_devices(8, "cuda"): seconds by
               build phase, recall@10 at ef 48 / 64 / 96 (floors 0.91 /
               0.94 / 0.96), the single-device control on the same data;
               sort_kv and pool_merge launched;
 23. serve_shards  phase 6d's data, hnsw with the defaults, serve_shards=4
               under force_devices(4, "cuda"): fit seconds (build phases,
               repair rounds with their unreached counts), recall@10 at ef
               64 / 96 (floor 0.90 at ef 96, and at most 0.02 under a
               single-device fit), each shard a quarter of the padded rows;
               ids 0-999 removed (none may come back, the last 1,000 rows
               still their own top-1), save / load (the same ids);
               ring_probe and pool_merge launched;
 24. multihost phase 20's fvecs file: probe_vecs, the 4 shards' ranged
               reads and load_vecs_global's blocks equal to the array,
               fit_shards_from_file into a flat db_shards=4 index (the ids
               of an array-fed fit), maybe_distributed_init with a one-rank
               NCCL group from ALAYA_* on 127.0.0.1, one all_gather of a
               device tensor, destroy_process_group.
Every search above runs captured: a query slice is one replay of a CUDA
graph (alayalite_tpu_torch/index/captured.py), the batch padded to the JAX
engine's buckets, the hop loops free of host syncs.
 25. captured  (on the indices of phases 4, 6c and 15, while they stand)
               the 8192 queries through IndexEngine._batch_search_impl on
               the card, captured and uncaptured (inside
               captured.eager()): the 1M bsq8 index at ef 32 / 64 / 96, one
               bsq8 build-pool chunk (4096 rows for their own pools at ef
               128, seeded as build_phases seeds them), the raw hnsw at ef
               64 (and its descent's steps by level) and the 1-bit rabitq
               at ef 64 (hop budget 8): ids and distances bit for bit
               (fails otherwise), the same launch counts in a replay as in
               an uncaptured call, wall ms median [min, max] of 7
               synchronised calls of each, the first (capturing) call's ms,
               graphs captured and capture seconds, host syncs a call
               counted by torch.cuda.set_sync_debug_mode (fails on one
               outside the descent's tests), reserved memory of each with
               no other graph held, the hop at which the early stop the
               loops made before would have ended each slice; then phase
               17's closed loop again over the captured index and an
               uncaptured one: QPS, p50 / p99, rows held to one direct call
               as in phase 17.
The build's prune phases and the bsq8 / raw inserts run captured too: a
prune, re-prune, fill or two-hop chunk is one replay (the chunk's row ids
an input), an insert slice (padded to its bucket) the search's replay, the
append and one replay of the connect step's in-place graph.
 26. captured  (after phase 25's bsq8 cases, and inside phase 6c) phase 4's
     build     bsq8 fit again with every phase uncaptured (inside
               captured.eager(); its build_timings beside phase 4's, graphs
               captured 0), its prune, re-prune and fill inputs recorded;
               one chunk of each and the whole prune_all_dev on them,
               captured against uncaptured: bit for bit (the whole prune
               also equal to the fit's), the same launch counts in a
               replay, wall ms median [min, max] of 7 calls, host syncs
               (fails on any), graphs, capture seconds and reserved memory;
               then one 4096-row insert slice into the 1M bsq8 index and
               one into the 1M raw hnsw through its shadow, from the same
               index state restored before every call: ids and every
               written tensor bit for bit, the same counts, wall ms, host
               syncs outside extend_overlay (fails on any but the raw
               path's copy of the new ids to the host) and inside it.
A fit's graphs live only as long as their phase (index/captured.py's
scope), and NN-Descent and the connectivity repair run captured too: a
round of NN-Descent, the cluster init's assign and score loops, each
LOOP_CHUNK block of the repair's BFS and label propagation, its attach and
its nearest-reached scan are one replay each.
 26.           (continued) after phase 4's captured fit and phase 26's
               uncaptured one: no graph of the fit held
               (captured.held()), memory allocated, memory reserved after
               torch.cuda.empty_cache() and peak reserved of each, above
               the reserved memory before it; fails unless the captured
               fit's reserved memory after empty_cache is within
               MEM_HELD_SLACK GiB of the uncaptured fit's and its peak
               within MEM_PEAK_SLACK GiB; the two fits' final adjacency and
               entry points bit for bit;
 27. captured  on phase 4's data, with phase 26's uncaptured fit's inputs:
     knn and   sort_kv at NN-Descent's chunk shape (its merge, [32992,
     repair    180] -> 32) against its plain version, bit for bit, timed;
               the kNN phase (build_knn_graph: the cluster init and 8
               rounds in two blocks of 4) and the repair of the fit's
               adjacency (from a copy of its input written into one
               buffer), each captured (inside one captured.scope(), as a
               fit phase runs it) against uncaptured from the same inputs
               and seeds: kNN ids and distances and the repaired adjacency
               bit for bit, a replay's launch counts equal to the
               uncaptured call's, wall ms median [min, max] of
               PHASE27_REPS calls each after the capturing one, graphs
               captured and capture seconds, host syncs a call counted by
               torch.cuda.set_sync_debug_mode (fails on any beyond the
               stated reads: one a block of rounds and the init's
               INIT_SYNCS; one a LOOP_CHUNK test and two a round of the
               repair), reserved memory.
 28. gist      (after phase 6b, before 6c) hnsw + bsq8 with phase 4's
               parameters at GIST1M's width, the judged cell
               gist-bsq8-batch's configuration: 1M x 960 rows of the
               stand-in mixture (500 centres) made on the card, 1,000
               held-out queries, fitted at ef_construction 100 (seconds,
               peak allocated, launches); gather_diagdot and
               gather_estimate against their plain versions on its own
               code tensor [1M, 32, 1024] at the cell's hop (1,024, 8);
               batch_search of the 1,000 queries at ef 96 (one 1,024-row
               slice): recall@10 against ground truth on the card (fails
               below 0.95), wall QPS, and each step's launches for one
               call (fails unless the slice launched seed_scan and
               unique_topk once, gather_dot twice, gather_estimate once a
               hop, and gather_estimate.code_bytes grew by 1,024 x 8 x 32
               x 1,024 a launch); the captured call's ids and distance
               bits equal an uncaptured one's (captured.eager()).
A summary line (the end-to-end numbers of every phase), the kernels line
and the card line come before the last line, which is
{"ok": true, "device": {...}}. A copy of the numbers goes to
build/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
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
# phase 4's index (bench.py's headline bsq8 config), fitted again
# uncaptured in phase 26
BSQ8_PARAMS = dict(index_type="hnsw", quantization_type="bsq8", max_nbrs=32,
                   ef_construction=200, prune_alpha=1.2, seed_sample=16384,
                   beam_expand=8, capacity=N + SPARE)
CHURN_INSERT, CHURN_BATCH = 8_192, 4_096
CHURN_FLOOR = 0.95                   # own top-1 share and recall@10 at ef 64
# gather_diagdot: (nodes C, R, Dp, B, M); the main shape is the hop's, over
# codes for 100,000 nodes; R = 1 is the sq8 traversal's (4096 queries x 256
# ids over 100,000 x 128 codes viewed as one-row blocks); the last is the
# hop of the 960-wide cell (gist-bsq8-batch: a 1,024-row slice, code rows
# of 1,024 bytes, gather_rows_kernel<4, true>)
GATHER_MAIN = (100_000, 32, 128, 4096, 8)
GATHER_R1 = (100_000, 1, 128, 4096, 256)
GATHER_GIST = (100_000, 32, 1024, 1024, 8)
GATHER_SHAPES = (GATHER_MAIN, GATHER_R1, (5_000, 24, 96, 1000, 5),
                 (900, 7, 40, 333, 3), (5_000, 1, 100, 1000, 77), GATHER_GIST)
GATHER_TIMED = {GATHER_MAIN: "main", GATHER_R1: "r1", GATHER_GIST: "gist"}
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
# phase 17: SearchServer on phase 4's 1M bsq8 index, before its churn:
# (a) an open loop of 8 producer threads submitting the 8192 queries, (b)
# a closed loop of 64 client threads x 128 blocking searches; where a
# served row differs from one direct call's, recall must stay within
# SERVE_RECALL_SLACK of that call's
SERVE = dict(topk=K, ef=64, max_batch=1024, timeout_us=2000)
SERVE_PRODUCERS, SERVE_CLIENTS, SERVE_CALLS = 8, 64, 128
SERVE_RECALL_SLACK = 0.002
# phase 18: the REST service on phase 12's directory: 16 requests of 512
# vectors from 4 threads (default mode), 8192 single-vector requests from
# 64 threads (ALAYALITE_BATCH_SERVING=1), then inserts of 1,000 items with
# int ids from SERVICE_ID0, an upsert of 100, delete_by_id of 100 and a
# delete_by_filter of one shard, all over HTTP
SERVICE_REQUESTS, SERVICE_THREADS, SERVICE_CLIENTS = 16, 4, 64
SERVICE_INSERT, SERVICE_UPSERT, SERVICE_DELETE = 1_000, 100, 100
SERVICE_ID0, SERVICE_DEAD_SHARD = 10_000_000, 11
# phase 19: flat + sq4 on the 1M rows (an exact scan of the raw rows)
FLAT_SQ4_INSERT, FLAT_SQ4_REMOVE = 1_000, 10_000
# phase 20: RAG: 2,000 generated documents of ~2 kB, FixedSizeChunker's
# defaults, HashingEmbedding(dim=256), a cos collection; 256 chunks' own
# texts queried, each its own top-1
RAG_DOCS, RAG_DOC_CHARS, RAG_DIM, RAG_QUERIES, RAG_FLOOR = (2_000, 2_000, 256,
                                                            256, 0.99)
# phase 21: hnsw + bsq8 with phase 4's parameters, db_shards=4 on the 1M
# rows (4 shards of 250,000), searched with the card's real device list (the
# per-shard search and a host merge) and under force_devices(4, "cuda") (the
# mesh program); recall@10 floor at ef 64 in both: phase 5's; then 8,192
# inserted rows (own top-1 floor CHURN_FLOOR), 10,000 removes, compact,
# save / load; then flat exact, db_shards=4
DB_SHARDS, DB_INSERT, DB_REMOVE = 4, 8_192, 10_000
# phase 22: results/sharded_build_100k.json's data and parameters; the JAX
# package read 0.9313 / 0.9641 / 0.9863 at ef 48 / 64 / 96 on its 8-virtual-
# CPU mesh, and the streams differ, so the floors sit under those
BUILD_SHARDS = 8
BUILD_DATA = dict(n=100_000, dim=64, n_queries=1024, seed=42, clusters=64)
BUILD_PARAMS = dict(index_type="hnsw", max_nbrs=24, ef_construction=96)
BUILD_FLOORS = {48: 0.91, 64: 0.94, 96: 0.96}
# phase 23: serve_shards=4 on phase 6d's data with the defaults; JAX's own
# bounds (tests/test_dist_graph.py): 0.90 at ef 96, and at most 0.02 under a
# single-device fit
SERVE_SHARDS, SERVE_EFS, SERVE_FLOOR, SERVE_SLACK = 4, (64, 96), 0.90, 0.02
SERVE_REMOVE = 1_000
MH_SHARDS = 4                        # phase 24: ranged reads and file fit
# phase 25: every search above runs captured (index/captured.py: a query
# slice is one replay of a CUDA graph, the batch padded to the JAX engine's
# buckets). Here each of the 1M bsq8 index at CAPTURE_EFS, one bsq8
# build-pool chunk (4096 rows at ef 128), the 1M raw hnsw at ef 64 and the
# 1M rabitq at ef 64 (the frontier's hop budget) runs captured and
# uncaptured (inside captured.eager()): ids and distances bit for bit,
# CAPTURE_REPS synchronised calls of each after the capturing one, host
# syncs a call (torch's sync debug mode), graphs and capture seconds, the
# reserved memory of each with no other graph held, the hop at which the
# early stop the loops made before would have ended each slice; then
# phase 17's closed loop again, captured and uncaptured
CAPTURE_EFS, CAPTURE_REPS = (32, 64, 96), 7
# phase 26: the build's prune phases and the bsq8 / raw inserts captured.
# Phase 4's bsq8 fit again with every phase uncaptured (its build_timings
# beside phase 4's), one prune, re-prune and fill chunk of its own inputs
# and its whole prune_all_dev, captured against uncaptured; one insert
# slice of INSERT_ROWS rows at ef INSERT_EF into the 1M bsq8 index (after
# phase 25) and into the 1M raw hnsw through its shadow (inside phase 6c,
# before its churn), each from the same index state restored before every
# call
INSERT_ROWS, INSERT_EF = 4_096, 100
# phase 26 (continued): a captured fit's memory against an uncaptured one:
# reserved after empty_cache (GiB) and peak reserved (GiB) slack
MEM_HELD_SLACK, MEM_PEAK_SLACK = 0.25, 2.0
# phase 27: NN-Descent as the bsq8 fit runs it (QGBuilder: k 32, 8 rounds
# above 100k rows, seed 0) and the repair of that fit, PHASE27_REPS
# synchronised calls of each mode after the capturing one
NND_K, NND_ITERS, PHASE27_REPS = 32, 8, 3
POOL_CHUNK, POOL_EF, POOL_RAND = 4096, 128, 16
SLICE11_PHASES = ("serving", "service", "flat_sq4", "native_rag")
SLICE12_PHASES = ("db_shards", "build_shards", "serve_shards", "multihost")
# seed_scan: (B, S, D, nseed): the bsq8 search's slice over its 16,384-point
# sample first, a served batch, ragged B and S, D 100 and 960, nseed 1 / 16,
# and the 960-wide cell's slice (timed too)
SEED_SCAN_SHAPES = ((4096, 16384, 128, 8), (52, 16384, 128, 8),
                    (333, 1000, 128, 8), (97, 1000, 100, 8),
                    (130, 2048, 960, 8), (513, 4096, 128, 1),
                    (515, 4096, 128, 16), (1024, 16384, 960, 8))
# unique_topk: (B, W, k, valid): the 1-bit search's slice (pool 512 + the
# result pool's 10) and bsq8's first, the timed two; the fit's pools (k = W
# = ef), the inserts' (k = r = 32), a served batch
UNIQUE_TOPK_SHAPES = ((4096, 522, 10, True), (4096, 64, 10, True),
                      (4096, 100, 100, False), (4096, 64, 32, True),
                      (52, 64, 10, True))
UNIQUE_TOPK_CAPACITY = 1_016_384
# tile_topk: (Q, n, k): the flat scan's full tile at top 10 and fast mode's
# coarse tile at 40, the timed two; calc_gt's fast coarse tile at 256
# (MAX_K), the last query slice, the ragged last tile of 1M rows,
# find_medoid's one query; n % 4 != 0
TILE_TOPK_SHAPES = ((4096, 16384, 10), (4096, 65536, 40), (4096, 65536, 256),
                    (1808, 16384, 10), (4096, 576, 10), (1, 16384, 1),
                    (333, 1001, 33), (257, 4099, 128))
# gather_dot: (B, K, D, C): the 1-bit search's final re-score and its hop
# over 1M rows first, timed; bsq8's final pool of a served batch, K under a
# group's rows, GIST's D, D split unevenly over the lanes, D with no
# 16-byte rows (word loads); the 960-wide cell's two (its slice's seeds and
# final pool at ef 96 over 1M x 960), timed
GATHER_DOT_GIST = ((1024, 8, 960, 1_000_000), (1024, 96, 960, 1_000_000))
GATHER_DOT_SHAPES = ((4096, 512, 128, 1_000_000), (4096, 8, 128, 1_000_000),
                     (52, 72, 128, 100_000), (7, 5, 96, 10_000),
                     (33, 3, 960, 10_000), (65, 17, 100, 10_000),
                     (19, 11, 98, 10_000), *GATHER_DOT_GIST)
GATHER_DOT_TIMED = (*GATHER_DOT_SHAPES[:2], *GATHER_DOT_GIST)
NEW_PHASES = ("collection", "reindex", "calc_gt", "rabitq", "rabitq2",
              *SLICE11_PHASES, *SLICE12_PHASES)


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
    library routes at the main shapes: the hop's, the sq8 traversal's
    (R = 1) and the 960-wide cell's hop."""
    from alayalite_tpu_torch.ops.gather_diagdot import (
        VARIANTS, bulk_fits, gather_diagdot, gather_diagdot_ref,
        gather_estimate, gather_estimate_ref)
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
        if shape not in GATHER_TIMED:
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
        # the spaces launch the "rows" entry (the wrappers' default)
        rep.update(variant="rows", max_abs_err=errs["rows"],
                   ms=rep["rows_ms"], ms_spin=rep["rows_ms_spin"])
        est_rep.update(variant="rows", max_abs_err=est_errs["rows"],
                       ms=est_rep["rows_ms"], ms_spin=est_rep["rows_ms_spin"])
        key = GATHER_TIMED[shape]
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


def check_gather_on_index(torch, sp, what: str, B: int = GATHER_MAIN[3],
                          M: int = GATHER_MAIN[4]) -> dict:
    """gather_diagdot (both entries) against its plain version, and
    gather_estimate (both entries) against the epilogue on its own dot, on
    the index's own code tensor [capacity, R, Dp], norms and ids, at the
    hop's B and M (the D 128 slice's by default): node ids drawn over [0, num), the last rows of ``u``
    walking down from num - 1 (byte offsets past 2^31 at 1M x 32 x 128)
    and the first eighth naming node 0, as the hop's inactive pops do. The
    kernels' launch counts are left as they were."""
    from alayalite_tpu_torch.ops.gather_diagdot import (VARIANTS,
                                                        gather_diagdot,
                                                        gather_diagdot_ref,
                                                        gather_estimate)

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


def seed_scan_inputs(torch, rng, B, S, D, dev):
    """Queries near points of a table and a sample of it as the engine
    draws one (sorted int32 ids, bf16 rows, norms): (q, ids, vecs, sq)."""
    from alayalite_tpu_torch.index.search import seed_sample_arrays

    table = rng.normal(size=(4 * S, D)).astype(np.float32)
    ids = torch.as_tensor(np.sort(rng.choice(4 * S, size=S, replace=False))
                          .astype(np.int32), device=dev)
    q = torch.as_tensor(table[rng.integers(0, 4 * S, size=B)]
                        + 0.3 * rng.normal(size=(B, D)).astype(np.float32),
                        device=dev)
    return (q, *seed_sample_arrays(torch.as_tensor(table, device=dev), ids,
                                   "l2"))


def seed_scan_chain(torch, q, ids, vecs, sq, nseed):
    """The library chain seed_scan replaced: an f32 product of the rounded
    operands, sq - 2 dot, torch.topk, the id gather."""
    dot = q.to(torch.bfloat16).float() @ vecs.float().T
    _, sel = torch.topk(sq[None, :] - 2.0 * dot, nseed, dim=1, largest=False)
    return ids[sel]


def check_seed_scan(torch, dev) -> dict:
    """seed_scan (csrc/seed_scan.cu) against its plain version at the
    block search's slice and at ragged shapes: each version's picks
    re-scored in float64 from the rounded values, the sorted scores within
    the bound of two f32 sums of D terms in different orders; times of the
    kernel, the plain version and the library chain it replaced at the
    main shape and at the 960-wide cell's slice."""
    from alayalite_tpu_torch.ops.seed_scan import seed_scan, seed_scan_ref
    from alayalite_tpu_torch.utils.timing import bound, cuda_ms

    rng = np.random.default_rng(19)
    out = {"errors": {}}
    for B, S, D, nseed in SEED_SCAN_SHAPES:
        q, ids, vecs, sq = seed_scan_inputs(torch, rng, B, S, D, dev)
        args = (q, ids, vecs, sq, nseed)
        got = seed_scan(*args)
        torch.cuda.synchronize()
        want = seed_scan_ref(*args)
        q64 = q.to(torch.bfloat16).double()

        def rescored(sel):
            pos = torch.searchsorted(ids, sel).long()
            return torch.sort(sq.double()[pos] - 2.0 * torch.einsum(
                "bd,bkd->bk", q64, vecs.double()[pos]), 1).values

        terms = (q64.abs() @ vecs.double().abs().T).max(1).values
        tol = 4 * D * 2.0 ** -24 * (sq.double().abs().max() + 2 * terms)
        err = (rescored(got) - rescored(want)).abs().max(1).values
        same = float((got == want).all(1).float().mean())
        log(f"kernel seed_scan {(B, S, D, nseed)}: max score gap "
            f"{float(err.max()):.3e} (tol {float(tol.min()):.3e}), rows "
            f"equal {same:.4f}")
        if not bool((err <= tol).all()):
            raise AssertionError(f"seed_scan disagrees at {(B, S, D, nseed)}")
        out["errors"][str((B, S, D, nseed))] = {"max_gap": float(err.max()),
                                               "rows_equal": same}
        if (B, S, D, nseed) not in (SEED_SCAN_SHAPES[0],
                                    SEED_SCAN_SHAPES[-1]):
            continue

        b = bound(B * D * 4 + S * D * 2 + S * 8 + B * nseed * 4,
                  2 * B * S * D, "bf16")
        times = {"ms": cuda_ms(lambda: seed_scan(*args)),
                 "ms_spin": cuda_ms(lambda: seed_scan(*args), spin=True),
                 "plain_ms": cuda_ms(lambda: seed_scan_ref(*args)),
                 "library_ms": cuda_ms(lambda: seed_scan_chain(torch, *args)),
                 "library_ms_spin": cuda_ms(
                     lambda: seed_scan_chain(torch, *args), spin=True)}
        at = dict(shape=[B, S, D, nseed], **b, **times)
        if D == 960:
            out["gist"] = at
        else:
            out.update(at)
        log(f"kernel seed_scan {(B, S, D, nseed)}: {times['ms']:.4f} ms "
            f"({times['ms_spin']:.4f} device alone), plain "
            f"{times['plain_ms']:.4f} ms, library chain "
            f"{times['library_ms']:.4f} ms ({times['library_ms_spin']:.4f}), "
            f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        torch.cuda.empty_cache()
    return out


def unique_topk_inputs(torch, rng, B, W, k, with_valid, dev):
    """A block search's final rows: a pool of ids of a 1M-row index with
    holes (-1) and a few live copies; where W > k, its last k columns a
    result pool of popped nodes, half of them also in the pool at the same
    distance; distances the exact re-score's, ties at one value in some
    rows; valid with 1% of the rows removed. (d, ids, valid or None)."""
    C = UNIQUE_TOPK_CAPACITY
    d = (rng.random((B, W)) * 4e4).astype(np.float32)
    ids = rng.integers(0, C, size=(B, W)).astype(np.int32)
    r = np.arange(B)
    P = W - k if W > k else W
    for _ in range(4):
        i, j = rng.integers(0, P, size=(2, B))
        ids[r, j], d[r, j] = ids[r, i], d[r, i]
    if W > k:
        src = rng.integers(0, P, size=(B, k))
        take = rng.random((B, k)) < 0.5
        ids[:, P:] = np.where(take, ids[r[:, None], src], ids[:, P:])
        d[:, P:] = np.where(take, d[r[:, None], src], d[:, P:])
    ids[rng.random((B, W)) < 0.05] = -1
    tie = rng.random(B) < 0.1
    d[tie, :3 * k] = 1000.0
    valid = None
    if with_valid:
        valid = torch.as_tensor(rng.random(C) > 0.01, device=dev)
    return (torch.as_tensor(d, device=dev), torch.as_tensor(ids, device=dev),
            valid)


def unique_topk_chain(torch, d, ids, k, valid):
    """The duplicate net and top k unique_topk replaced in the block
    search: the [B, W, W] compare, & the lower triangle, any; the mask,
    topk_smallest (sort_kv), the id gather."""
    from alayalite_tpu_torch.ops.topk import topk_smallest

    ok = ids >= 0
    if valid is not None:
        ok &= valid[ids.clamp(0, valid.shape[0] - 1).long()]
    W = ids.shape[1]
    tril = torch.tril(torch.ones((W, W), dtype=torch.bool, device=d.device),
                      -1)
    dup = ((ids[:, :, None] == ids[:, None, :]) & tril[None]).any(2)
    out_d, sel = topk_smallest(torch.where(ok & ~dup, d,
                                           torch.full_like(d, np.inf)), k)
    out_i = torch.gather(ids, 1, sel)
    return out_d, torch.where(torch.isfinite(out_d), out_i,
                              torch.full_like(out_i, -1))


def unique_topk_bytes(B, W, k, valid) -> int:
    """The bytes unique_topk must move: d and ids read once, a valid byte
    for each entry (at most the whole mask), the outputs written."""
    return B * W * 8 + B * k * 8 + (0 if valid is None
                                    else min(B * W, valid.shape[0]))


def check_unique_topk(torch, dev) -> dict:
    """unique_topk (csrc/unique_topk.cu) against its plain version on the
    CPU, bit for bit, at the paths' shapes; times of the kernel, the plain
    version and the chain it replaced at the two search slices."""
    from alayalite_tpu_torch.ops.unique_topk import (unique_topk,
                                                     unique_topk_ref)
    from alayalite_tpu_torch.utils.timing import bound, cuda_ms

    rng = np.random.default_rng(21)
    out = {"checked": [], "at": {}}
    for B, W, k, with_valid in UNIQUE_TOPK_SHAPES:
        d, ids, valid = unique_topk_inputs(torch, rng, B, W, k, with_valid,
                                           dev)
        got = unique_topk(d, ids, k, valid)
        torch.cuda.synchronize()
        want = unique_topk_ref(d.cpu(), ids.cpu(), k,
                               None if valid is None else valid.cpu())
        if not (_same_bits(got[0].cpu(), want[0])
                and _same_bits(got[1].cpu(), want[1])):
            raise AssertionError(f"unique_topk differs from its plain "
                                 f"version at {(B, W, k)}")
        out["checked"].append([B, W, k, with_valid])
        if (B, W, k, with_valid) not in UNIQUE_TOPK_SHAPES[:2]:
            continue
        args = (d, ids, k, valid)
        b = bound(unique_topk_bytes(B, W, k, valid), 0, "f32")
        times = {"ms": cuda_ms(lambda: unique_topk(*args)),
                 "ms_spin": cuda_ms(lambda: unique_topk(*args), spin=True),
                 "plain_ms": cuda_ms(lambda: unique_topk_ref(*args)),
                 "library_ms": cuda_ms(lambda: unique_topk_chain(torch,
                                                                 *args)),
                 "library_ms_spin": cuda_ms(
                     lambda: unique_topk_chain(torch, *args), spin=True)}
        out["at"][str((B, W, k))] = {**b, **times}
        log(f"kernel unique_topk {(B, W, k)}: {times['ms']:.4f} ms "
            f"({times['ms_spin']:.4f} device alone), plain "
            f"{times['plain_ms']:.4f} ms, the net + top k "
            f"{times['library_ms']:.4f} ms ({times['library_ms_spin']:.4f}), "
            f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        torch.cuda.empty_cache()
    return out


def tile_topk_inputs(torch, rng, Q, n, k, dev):
    """Two tiles as the flat scan scores them (l2_tile of normal queries
    against normal rows, D 128, a sixteenth of the rows repeated so that
    equal distances stand around a row's k-th place) and the running best
    after the first: (tile, lo, best_d, best_i), the second tile's
    columns from lo = n."""
    from alayalite_tpu_torch.ops.l2_tile import l2_tile
    from alayalite_tpu_torch.ops.tile_topk import tile_topk

    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
    q = torch.randn((Q, 128), device=dev, generator=g)
    tiles = []
    for _ in range(2):
        x = torch.randn((n, 128), device=dev, generator=g)
        src = torch.randint(0, n, (n // 16,), device=dev, generator=g)
        x[torch.randint(0, n, (n // 16,), device=dev, generator=g)] = x[src]
        tiles.append(l2_tile(q, x))
    best_d = torch.full((Q, k), np.inf, device=dev)
    best_i = torch.full((Q, k), -1, dtype=torch.int32, device=dev)
    tile_topk(tiles[0], 0, best_d, best_i, k)
    return tiles[1], n, best_d, best_i


def tile_topk_chain(torch, d, lo, best_d, best_i, k):
    """The selection tile_topk replaced in the flat scan: torch.topk's
    select, the two sorts and gathers (select_smallest), the id offset and
    the merge with the running best, here merge_topk (pool_merge's kernel,
    as tile_topk's wide route merges)."""
    from alayalite_tpu_torch.ops.topk import merge_topk, select_smallest

    d_t, sel = select_smallest(d, min(k, d.shape[1]))
    return merge_topk(best_d, best_i, d_t, sel.to(torch.int32) + lo, k)


def tile_topk_bytes(Q, n, k) -> int:
    """The bytes tile_topk must move: the tile read once, the running best
    read and written."""
    return Q * n * 4 + 2 * Q * k * 8


def check_tile_topk(torch, dev) -> dict:
    """tile_topk (csrc/tile_topk.cu) against its plain version on the CPU,
    bit for bit, at the flat scans' shapes, merging a tile into a running
    best that came from an earlier one (and, at the first shape, into an
    empty one); times of the kernel (the running best copied afresh before
    each launch, as the launch updates it in place), its plain version and
    the chain it replaced at the two timed shapes."""
    from alayalite_tpu_torch.ops.tile_topk import tile_topk, tile_topk_ref
    from alayalite_tpu_torch.utils.timing import bound, cuda_ms

    rng = np.random.default_rng(26)
    out = {"checked": [], "at": {}}
    for Q, n, k in TILE_TOPK_SHAPES:
        d, lo, bd, bi = tile_topk_inputs(torch, rng, Q, n, k, dev)
        starts = [(bd, bi)]
        if (Q, n, k) == TILE_TOPK_SHAPES[0]:
            starts.append((torch.full_like(bd, np.inf),
                           torch.full_like(bi, -1)))
        for sd, si in starts:
            want = tile_topk_ref(d.cpu(), lo, sd.cpu(), si.cpu(), k)
            got = tile_topk(d, lo, sd.clone(), si.clone(), k)
            torch.cuda.synchronize()
            if not (_same_bits(got[0].cpu(), want[0])
                    and _same_bits(got[1].cpu(), want[1])):
                raise AssertionError(f"tile_topk differs from its plain "
                                     f"version at {(Q, n, k)}")
        out["checked"].append([Q, n, k])
        if (Q, n, k) not in TILE_TOPK_SHAPES[:2]:
            continue

        def kernel(d=d, lo=lo, bd=bd, bi=bi, k=k):
            return tile_topk(d, lo, bd.clone(), bi.clone(), k)

        empty = (torch.full_like(bd, np.inf), torch.full_like(bi, -1))
        b = bound(tile_topk_bytes(Q, n, k), 0, "f32")
        times = {
            "ms": cuda_ms(kernel),
            "ms_spin": cuda_ms(kernel, spin=True),
            "first_tile_ms_spin": cuda_ms(
                lambda: tile_topk(d, lo, empty[0].clone(), empty[1].clone(),
                                  k), spin=True),
            "clone_ms_spin": cuda_ms(lambda: (bd.clone(), bi.clone()),
                                     spin=True),
            "plain_ms": cuda_ms(lambda: tile_topk_ref(d, lo, bd, bi, k)),
            "library_ms": cuda_ms(
                lambda: tile_topk_chain(torch, d, lo, bd, bi, k)),
            "library_ms_spin": cuda_ms(
                lambda: tile_topk_chain(torch, d, lo, bd, bi, k), spin=True)}
        out["at"][str((Q, n, k))] = {**b, **times}
        log(f"kernel tile_topk {(Q, n, k)}: {times['ms']:.4f} ms "
            f"({times['ms_spin']:.4f} device alone, of it "
            f"{times['clone_ms_spin']:.4f} the copy of the running best; "
            f"into an empty best {times['first_tile_ms_spin']:.4f}), plain "
            f"{times['plain_ms']:.4f} ms, select_smallest + merge_topk "
            f"{times['library_ms']:.4f} ms ({times['library_ms_spin']:.4f}), "
            f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        torch.cuda.empty_cache()
    out.update(out["at"][str(TILE_TOPK_SHAPES[0])], max_abs_err=0.0)
    return out


def gather_dot_inputs(torch, rng, B, K, D, C, dev):
    """An exact re-score's operands: C normal rows, their squared norms,
    B normal queries and theirs, ids uniform over the rows with 5% holes
    (-1, clamped to row 0 as the searches pass them). (data, ids i32, q,
    q_sq, x_sq)."""
    from alayalite_tpu_torch.ops.distance import sqnorms

    data = torch.randn((C, D), device=dev,
                       generator=torch.Generator(dev).manual_seed(int(
                           rng.integers(1 << 31))))
    q = torch.as_tensor(rng.normal(size=(B, D)).astype(np.float32),
                        device=dev)
    ids = rng.integers(0, C, size=(B, K)).astype(np.int32)
    ids[rng.random((B, K)) < 0.05] = -1
    return (data, torch.as_tensor(ids, device=dev), q, (q * q).sum(-1),
            sqnorms(data))


def gather_dot_bytes(B, K, D, ids) -> int:
    """The bytes gather_dot must move: each distinct row of ``ids`` and its
    squared norm once (a row that several queries read may come from L2),
    the ids, the queries and their norms read, the output written."""
    rows = ids.clamp(min=0).unique().numel()
    return rows * (D * 4 + 4) + B * K * 8 + B * (D * 4 + 4)


def gather_dot_library(data, ids, q, q_sq=None, x_sq=None):
    """gather_dot's function through one PyTorch product: index_select,
    bmm, the epilogue where q_sq and x_sq are given."""
    import torch

    B, K = ids.shape
    safe = ids.clamp(0, data.shape[0] - 1).reshape(-1)
    dot = torch.bmm(data.index_select(0, safe).view(B, K, -1),
                    q.unsqueeze(2)).squeeze(2)
    if x_sq is None:
        return dot
    return torch.clamp(q_sq[:, None] + x_sq.index_select(0, safe).view(B, K)
                       - 2.0 * dot, min=0.0)


def gather_dot_error(torch, got, data, ids, q) -> float:
    """The largest |got - d| over (|q|^2 + |x|^2), d the float64 distance
    from the same f32 operands (1024 queries at a time)."""
    worst = 0.0
    for lo in range(0, ids.shape[0], 1024):
        rows = data.double()[ids[lo:lo + 1024].long().clamp(0, data.shape[0]
                                                            - 1)]
        qd = q[lo:lo + 1024].double()
        scale = (qd * qd).sum(-1)[:, None] + (rows * rows).sum(-1)
        d = torch.clamp(scale - 2.0 * (rows * qd[:, None, :]).sum(-1), min=0)
        worst = max(worst, float(((got[lo:lo + 1024].double() - d).abs()
                                  / scale).max()))
    return worst


def check_gather_dot(torch, dev) -> dict:
    """gather_dot (csrc/gather_dot.cu) against float64 distances from the
    same operands (relative error <= 1e-5 of |q|^2 + |x|^2) at the paths'
    shapes, and bit for bit its plain version (the chain it replaced:
    index_select, row_dots, the epilogue) at D 128; one (query, row) pair
    bit-equal in slices of 54 queries and at K 8; times of the kernel, the
    plain version and index_select + bmm at the two search shapes of D 128
    and the 960-wide cell's two, against the bytes of the distinct rows."""
    from alayalite_tpu_torch.ops.gather_dot import gather_dot, gather_dot_ref
    from alayalite_tpu_torch.utils.timing import bound, cuda_ms

    rng = np.random.default_rng(31)
    out = {"checked": [], "at": {}}
    for B, K, D, C in GATHER_DOT_SHAPES:
        args = gather_dot_inputs(torch, rng, B, K, D, C, dev)
        got = gather_dot(*args)
        plain = gather_dot_ref(*args)
        torch.cuda.synchronize()
        err = gather_dot_error(torch, got, *args[:3])
        rep = {"rel_err": err, "max_abs_vs_plain": float(
            (got - plain).abs().max()), "bits_equal_plain": float(
                (got.view(torch.int32) == plain.view(torch.int32)).float()
                .mean())}
        if not err <= 1e-5:
            raise AssertionError(f"gather_dot at {(B, K, D)}: relative error "
                                 f"{err} against float64")
        if D == 128 and rep["bits_equal_plain"] != 1.0:
            raise AssertionError(f"gather_dot at {(B, K, D)}: "
                                 f"{rep['bits_equal_plain']} of the outputs "
                                 f"have the bits of the plain version")
        out["checked"].append([B, K, D, C, rep])
        if (B, K, D, C) not in GATHER_DOT_TIMED:
            continue
        data, ids, q, q_sq, x_sq = args
        parts = torch.cat([gather_dot(data, ids[lo:lo + 54], q[lo:lo + 54],
                                      q_sq[lo:lo + 54], x_sq)
                           for lo in range(0, B, 54)])
        head = gather_dot(data, ids[:, :8].contiguous(), q, q_sq, x_sq)
        if not (_same_bits(parts, got) and _same_bits(head, got[:, :8])):
            raise AssertionError(f"gather_dot at {(B, K, D)}: a pair's bits "
                                 f"depend on the batch or on K")
        times = {"ms": cuda_ms(lambda: gather_dot(*args)),
                 "ms_spin": cuda_ms(lambda: gather_dot(*args), spin=True),
                 "plain_ms": cuda_ms(lambda: gather_dot_ref(*args)),
                 "plain_ms_spin": cuda_ms(lambda: gather_dot_ref(*args),
                                          spin=True),
                 "library_ms": cuda_ms(
                     lambda: gather_dot_library(*args)),
                 "library_ms_spin": cuda_ms(
                     lambda: gather_dot_library(*args), spin=True)}
        b = bound(gather_dot_bytes(B, K, D, ids), 0, "f32")
        out["at"][str((B, K, D))] = {
            **rep, **b, **times,
            "spin_over_bound": times["ms_spin"] / b["bound_ms"]}
        log(f"kernel gather_dot {(B, K, D)} over {C} rows: {times['ms']:.4f} "
            f"ms ({times['ms_spin']:.4f} device alone), plain (the chain) "
            f"{times['plain_ms']:.4f} ms ({times['plain_ms_spin']:.4f}), "
            f"index_select + bmm "
            f"{times['library_ms']:.4f} ms, bound {b['bound_ms']:.4f} ms "
            f"(the distinct rows once), {times['ms_spin'] / b['bound_ms']:.2f}"
            f"x it; relative error {err:.2e}")
        del args, data, ids, q, got, plain, parts
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
    """sort_kv, pool_merge and roll_n against their plain
    versions, bit for bit; times, bounds and the library route
    (torch.sort(stable=True) + gather) at the hop's shapes."""
    from alayalite_tpu_torch.ops.pool_sort import (pool_merge, pool_merge_ref,
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
    from alayalite_tpu_torch.spaces.sq import SQSpace
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
        return gather_diagdot(codes, ids, qs, variant="rows")

    rep = {"max_abs_err": err, "launches_per_call": launched,
           "variant": "rows",
           "kernel_ms": cuda_ms(lambda: sp.gather_dists(q, ids)),
           "kernel_ms_spin": cuda_ms(lambda: sp.gather_dists(q, ids),
                                     spin=True),
           "dot_ms": cuda_ms(kernel), "dot_ms_spin": cuda_ms(kernel,
                                                             spin=True),
           "bmm_ms": cuda_ms(library)}
    restore_counts(saved)
    log(f"sq8 gather_dists (4096, 256) over {N_SMALL} x {DIM} codes: "
        f"through gather_diagdot[rows] {rep['kernel_ms']:.4f} ms "
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


# phase 28: the gist-bsq8-batch cell's configuration
GIST_N, GIST_DIM, GIST_NQ, GIST_CLUSTERS, GIST_EF = (1_000_000, 960, 1_000,
                                                     500, 96)


def gist_data(torch, dev, seed: int = 960):
    """The stand-in mixture at GIST1M's shape, made on the card: centres
    N(0, 1) x 4, each base row a centre plus N(0, 1) noise, the queries
    fresh points of the mixture (held out). (base, queries)."""
    g = torch.Generator(dev).manual_seed(seed)
    centers = 4.0 * torch.randn((GIST_CLUSTERS, GIST_DIM), generator=g,
                                device=dev)

    def mixture(rows):
        out = centers[torch.randint(0, GIST_CLUSTERS, (rows,), generator=g,
                                    device=dev)]
        return out.add_(torch.randn((rows, GIST_DIM), generator=g,
                                    device=dev))

    return mixture(GIST_N), mixture(GIST_NQ)


def gist_phase(torch, dev, counters) -> dict:
    """Phase 28: the 960-wide bsq8 index's fit, its hop on its own codes,
    and one call's launches step by step."""
    from alayalite_tpu_torch import Client
    from alayalite_tpu_torch.ops.gather_diagdot import gather_estimate
    from alayalite_tpu_torch.utils.evaluate import calc_recall

    base, qd = gist_data(torch, dev)
    gt = ground_truth(torch, base, qd, K)
    queries = qd.cpu().numpy()
    del qd
    idx = Client().create_index("gist", **dict(BSQ8_PARAMS,
                                                capacity=GIST_N))
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    idx.fit(base)
    torch.cuda.synchronize()
    rep = {"fit_s": time.time() - t,
           "fit_peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "fit_phases": dict(idx._engine.build_timings),
           "fit_launches": {c.__name__: c.launches for c in counters}}
    del base
    sp = idx._engine.search_space
    log(f"gist: fit of {GIST_N}x{GIST_DIM} in {rep['fit_s']:.2f}s, phases "
        + ", ".join(f"{k}={v:.2f}s" for k, v in rep["fit_phases"].items())
        + f", peak allocated {rep['fit_peak_allocated_bytes']} B, codes "
        f"{tuple(sp.nbr_codes.shape)}, launches {rep['fit_launches']}")
    if tuple(sp.nbr_codes.shape[1:]) != (32, 1024):
        raise AssertionError(f"the 960-wide index's code rows are "
                             f"{tuple(sp.nbr_codes.shape)}, not [32, 1024]")
    rep["gather_on_index"] = check_gather_on_index(torch, sp, "gist",
                                                   B=1024, M=8)
    ids, dist, wall, launches = timed_search(torch, idx, queries, K,
                                             counters, ef_search=GIST_EF)
    check_result(ids, dist, GIST_N, f"gist ef={GIST_EF}")
    rec = calc_recall(ids, gt)
    # one more (captured) call with the counter, and an uncaptured one
    cb, n = gather_estimate.code_bytes, gather_estimate.launches
    ids2, dist2 = idx.batch_search_with_distance(queries, K,
                                                 ef_search=GIST_EF)
    torch.cuda.synchronize()
    code_bytes = gather_estimate.code_bytes - cb
    est = gather_estimate.launches - n
    ids3, dist3 = Uncaptured(idx).batch_search_with_distance(queries, K,
                                                             GIST_EF)
    rep.update(recall=rec, qps=GIST_NQ / wall, wall_s=wall,
               launches=launches, code_bytes_per_call=code_bytes,
               replay_equals_uncaptured=bool(
                   _same_bits(torch.as_tensor(dist2), torch.as_tensor(dist3))
                   and np.array_equal(ids2, ids3)))
    log(f"gist: ef={GIST_EF} recall@10 {rec:.4f}, {rep['qps']:.1f} QPS "
        f"(wall {wall:.4f}s), launches {launches}, code bytes a call "
        f"{code_bytes}, replay bits equal the uncaptured call's: "
        f"{rep['replay_equals_uncaptured']}")
    if rec < RECALL_FLOOR:
        raise AssertionError(f"gist: recall@10 at ef={GIST_EF} below "
                             f"{RECALL_FLOOR}")
    if (launches["seed_scan"], launches["unique_topk"],
            launches["gather_dot"]) != (1, 1, 2):
        raise AssertionError(f"gist: one 1,024-row slice did not launch "
                             f"seed_scan and unique_topk once and gather_dot "
                             f"twice: {launches}")
    if launches["gather_estimate"] <= 0 or (
            launches["gather_estimate"] != launches["estimate_many_calls"]
            or min(launches[k] for k in ("pool_merge", "ring_probe")) <= 0):
        raise AssertionError(f"gist: a hop did not launch gather_estimate "
                             f"once, or the pool kernels not at all: "
                             f"{launches}")
    if est != launches["gather_estimate"] or (
            code_bytes != est * 1024 * 8 * 32 * 1024):
        raise AssertionError(f"gist: {est} launches addressed {code_bytes} "
                             f"code bytes, not 1024 x 8 x 32 x 1024 each")
    if not (rep["replay_equals_uncaptured"]
            and np.array_equal(ids, ids2) and _same_bits(
                torch.as_tensor(dist), torch.as_tensor(dist2))):
        raise AssertionError("gist: the captured slice's answers differ "
                             "from an uncaptured search's or between calls")
    return rep


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


POOL_KERNELS = ("pool_merge", "sort_kv", "tile_topk", "ring_probe")


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
    """A wrapper's launches through one of its kernels (or, with ``attr``
    "route_calls", its calls by route), read and set to 0 like the
    wrapper's own count, so that every phase counts them where it counts
    the wrapper: pool_merge[warp], sort_kv[network], ring_probe[hash],
    tile_topk[wide] and so on."""

    def __init__(self, fn, route: str, attr: str = "route_launches"):
        self._fn, self.route, self._attr = fn, route, attr
        self.__name__ = f"{fn.__name__}[{route}]"

    @property
    def launches(self) -> int:
        return getattr(self._fn, self._attr)[self.route]

    @launches.setter
    def launches(self, n: int) -> None:
        getattr(self._fn, self._attr)[self.route] = n


def route_counters(fn):
    return tuple(RouteCount(fn, r) for r in fn.route_launches)


def topk_wide():
    """tile_topk's calls through its wide route (k > MAX_K), which
    launches no tile_topk kernel: no path shape may take it."""
    from alayalite_tpu_torch.ops.tile_topk import tile_topk

    return RouteCount(tile_topk, "wide", "route_calls")


def pool_counters():
    """The kernels a graph index can launch: the pool's two, the exact
    scans' per-tile selection (find_medoid, the overlay's exact kNN), the
    stale check, and (an sq8 traversal's gathered dot) gather_diagdot; then
    the launches by kernel of pool_merge, sort_kv and ring_probe, and
    tile_topk's calls through its wide route."""
    from alayalite_tpu_torch.ops.gather_diagdot import gather_diagdot
    from alayalite_tpu_torch.ops.pool_sort import pool_merge, sort_kv
    from alayalite_tpu_torch.ops.ring_probe import ring_probe
    from alayalite_tpu_torch.ops.tile_topk import tile_topk

    return (pool_merge, sort_kv, tile_topk, ring_probe, gather_diagdot,
            *route_counters(pool_merge), *route_counters(sort_kv),
            *route_counters(ring_probe), topk_wide())


def hop_cat_kernels(torch, sp) -> dict:
    """The concatenation kernels one block hop launches (torch.profiler,
    the port's kernels and PyTorch's alike), on the fitted index at the
    search's shape (4096 queries, ef 64, 8 pops): the difference between a
    search of 9 hops and one of 1, over the hops. It must be 1, the pop
    ring's shift: the stale check takes the pop ring and the pool as two
    operands and concatenates nothing. The hops run uncaptured, so the
    profiler sees each launch."""
    from torch.profiler import ProfilerActivity, profile

    from alayalite_tpu_torch.index import captured
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
        with captured.eager():
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
                      save_load: bool, churn=None, captured=None,
                      **params) -> dict:
    """Fit a graph index through the client, search the queries at every ef
    of ``floors`` ({ef: least recall@10}); with ``save_load`` also
    save, load and search again (the ids must not change); then, where
    ``churn`` is given, ``churn(idx)`` on the (loaded) index; ``captured(
    idx)``, phase 25's cases, on the fitted index before either. Launch
    counts are taken around the fit and around each search."""
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
    if captured is not None:
        rep["captured"] = captured(idx)
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
              save_load: bool = False, before_insert=None) -> dict:
    """Raw graph churn through Index: remove random ids (seed 11; none may
    come back), insert rows from the data's own clusters in batches (rows/s
    and launches a batch; with ``shadow`` the neighbor search goes through
    the bsq8 shadow, packed and timed first, and must launch
    gather_estimate), own top-1 at ef 64, compact (timed; then no removed
    id in a live row or an overlay level, every entry point live), recall@10
    at ef 64 over the live rows; with ``save_load`` the same ids after a
    save and load; ``before_insert(idx)``, run after the shadow's pack, goes
    into "captured_insert" (its launches are not the churn's). ``shape``: a
    RAW_CHURN entry."""
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
    if before_insert is not None:
        rep["captured_insert"] = before_insert(idx)
        for c in counters:
            c.launches = 0
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
    """Phases 6c and 6d, and phase 25's raw hnsw case."""
    from alayalite_tpu_torch.utils.timing import card_line

    card = card_line()

    def captured(idx):
        qd = torch.as_tensor(ds.queries, device=dev)
        steps = descent_steps(torch, idx, qd)
        log(f"raw hnsw 1M: descent steps by level (one test a step, the "
            f"first 4096 queries): {steps}")
        return {**engine_case(torch, "raw hnsw 1M ef 64", idx, qd, 64, card,
                              raw=True), "descent_steps_by_level": steps}

    rep = {"hnsw_1m": graph_index_phase(
        torch, dev, "raw_hnsw", ds.data, ds.queries, gt,
        RAW_FLOORS["hnsw_1m"], True,
        churn=lambda idx: raw_churn(
            torch, dev, idx, "raw_hnsw", ds.data, ds.queries,
            RAW_CHURN["hnsw_1m"], shadow=True,
            before_insert=lambda idx: insert_case(
                torch, f"raw hnsw insert slice through the shadow "
                f"({INSERT_ROWS} rows)", idx._engine,
                insert_rows(N, INSERT_ROWS, 27), card)),
        captured=captured, index_type="hnsw", capacity=N + SPARE)}
    gc.collect()
    torch.cuda.empty_cache()
    rep["hnsw_1m_alpha12"] = graph_index_phase(
        torch, dev, "raw_hnsw_alpha12", ds.data, ds.queries, gt,
        RAW_FLOORS["hnsw_1m_alpha12"], False, index_type="hnsw",
        prune_alpha=1.2)
    big = rep["hnsw_1m"]
    # the fit also scans exactly (find_medoid, the overlay's exact kNN); a
    # search sorts and merges pools only
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
    from alayalite_tpu_torch.ops.sq8_tile import sq8_tile, sq8_tile_ref
    from alayalite_tpu_torch.ops.tile_topk import tile_topk
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
    wide = topk_wide()
    ids, dist, wall, launches = timed_search(torch, idx, ds.queries, K,
                                             (l2_tile, tile_topk, wide))
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
                    "tile_topk_launches": launches["tile_topk"],
                    "tile_topk_wide_calls": launches[wide.__name__],
                    "distance_mismatches": bad,
                    "worst_error_in_eps_of_norms": worst}
    log(f"flat exact: fit {rep['fit_s']:.2f}s, recall@10 {rec:.5f}, "
        f"{NQ / wall:.1f} QPS (wall {wall:.3f}s), l2_tile launches "
        f"{launches['l2_tile']}, tile_topk launches {launches['tile_topk']}, "
        f"distance mismatches {bad} (worst error "
        f"{worst:.2f} eps·(|q|² + |x|²))")
    if min(launches["l2_tile"], launches["tile_topk"]) <= 0:
        raise AssertionError(f"the flat exact search launched a kernel no "
                             f"time: {launches}")
    if rec < FLAT_EXACT_FLOOR or bad:
        raise AssertionError("flat exact search is not exact")

    fast = client.create_index("flat_fast", index_type="flat",
                               flat_mode="fast", capacity=N)
    fast.fit(ds.data)
    ids_f, dist_f, wall_f, fast_launches = timed_search(
        torch, fast, ds.queries, K, (tile_topk, wide))
    check_result(ids_f, dist_f, N, "flat fast")
    rec_f = calc_recall(ids_f, gt)
    rep["fast"] = {"recall": rec_f, "qps": NQ / wall_f, "wall_s": wall_f,
                   "tile_topk_launches": fast_launches["tile_topk"],
                   "tile_topk_wide_calls": fast_launches[wide.__name__]}
    log(f"flat fast: recall@10 {rec_f:.5f}, {NQ / wall_f:.1f} QPS "
        f"(wall {wall_f:.3f}s), tile_topk launches "
        f"{fast_launches['tile_topk']}")
    del fast
    if rec_f < FLAT_FAST_FLOOR or fast_launches["tile_topk"] <= 0:
        raise AssertionError(f"flat fast recall below {FLAT_FAST_FLOOR}, or "
                             f"no tile_topk launch")

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
    block_diagdot on the rabitq hop), the distance tile, the block
    search's final selection (unique_topk), the exact re-scoring
    (gather_dot)."""
    from alayalite_tpu_torch.ops.diagdot import block_diagdot
    from alayalite_tpu_torch.ops.gather_diagdot import gather_estimate
    from alayalite_tpu_torch.ops.gather_dot import gather_dot
    from alayalite_tpu_torch.ops.l2_tile import l2_tile

    from alayalite_tpu_torch.ops.unique_topk import unique_topk

    return (*pool_counters(), gather_estimate, block_diagdot, l2_tile,
            unique_topk, gather_dot)


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


def collection_phase(torch, ds, root: str):
    """Phase 12: a 1M-row collection through Client(url=root): one insert
    of the 1M items, 8,192 new items, an upsert of 1,024 moved ids and a
    delete_by_filter of one shard (2,000 rows); 8,192 queries at ef 64
    against ground_truth over the live rows; save_collection, and a fresh
    Client(url) that finds it and answers with the same ids. Returns the
    report and, for phase 18, which serves the saved directory, (the ids of
    the queries, their live ground truth, id -> its document)."""
    from alayalite_tpu_torch import Client

    launches = Launches(new_counters())
    rep = {"steps_s": {}}
    steps = rep["steps_s"]
    rng = np.random.default_rng(12)
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
    if rep["recall"] < COLLECTION_FLOOR or rep["deleted_returned"] or (
            rep["wrong_documents"] or rep["short_rows"]
            or rep["new_own_top1"] < CHURN_FLOOR
            or not rep["same_ids_after_load"]):
        raise AssertionError(f"collection phase failed: {rep}")
    if launches.steps["batch_query"]["pool_merge"] <= 0 or launches.steps[
            "insert_new"]["gather_estimate"] <= 0:
        raise AssertionError("the collection's search or insert launched a "
                             f"kernel of its path no time: {launches.steps}")
    return rep, (res["id"], gt, doc_of)


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
            launches.steps[m]["tile_topk"] for m in ("exact", "fast")) <= 0:
        raise AssertionError("calc_gt launched l2_tile or tile_topk no time")
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
    # the exact distances: a slice's seeds, each hop's popped nodes and the
    # final pool (18 a slice at ef 128), one gather_dot each
    if got["unique_topk"] <= 0 or got["gather_dot"] != (
            got["block_diagdot"] + 2 * got["unique_topk"]):
        raise AssertionError(f"{step}: the exact distances did not launch "
                             f"gather_dot once a hop and twice a slice: "
                             f"{got}")
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
        from alayalite_tpu_torch.utils.timing import card_line

        # phase 25's rabitq case, at ef 64 with the frontier's hop budget
        if budget is not None:
            idx._engine.params.search_iters = budget(64)
        rep["captured"] = engine_case(
            torch, "rabitq 1M ef 64", idx,
            torch.as_tensor(queries, device=idx._engine.device), 64,
            card_line())
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


def latency(seconds) -> dict:
    """p50 / p99 of per-request seconds, in ms."""
    a = np.asarray(seconds, dtype=np.float64) * 1e3
    return {"p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99))}


def run_threads(n: int, target) -> float:
    """``target(t)`` on ``n`` threads started together; wall seconds."""
    import threading

    threads = [threading.Thread(target=target, args=(t,)) for t in range(n)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return time.perf_counter() - t0


def serving_phase(torch, idx, queries, gt) -> dict:
    """Phase 17: SearchServer(topk 10, ef 64, max_batch 1024, 2 ms) over the
    fitted bsq8 index: an open loop (8 threads submit() every query, then
    the futures are read) and a closed loop (64 threads x 128 blocking
    search() calls). Each: QPS, p50 / p99 latency, batches popped and their
    mean size, the hop kernels' launches (each must be > 0), recall@10, and
    the share of rows equal to one direct batch_search_with_distance."""
    from alayalite_tpu_torch.serving import SearchServer
    from alayalite_tpu_torch.utils.evaluate import calc_recall

    nq = queries.shape[0]
    launches = Launches(new_counters())
    direct, _ = idx._engine.batch_search_with_distance(queries, K,
                                                       ef=SERVE["ef"])
    rep = {"config": dict(SERVE), "direct_recall": calc_recall(direct, gt)}
    server = SearchServer(idx, **SERVE)
    try:
        server.search(queries[0])                              # warm-up
        for mode in ("open_loop", "closed_loop"):
            ids = np.full((nq, K), -1, dtype=np.int64)
            lat = np.zeros(nq)
            errors = []
            b0, q0, s0 = server.batches, server.queries, server.search_s
            if mode == "open_loop":
                futs, sent, done = [None] * nq, np.zeros(nq), np.zeros(nq)

                def stamp(i):
                    return lambda f: done.__setitem__(i, time.perf_counter())

                def producer(p):
                    for i in range(p, nq, SERVE_PRODUCERS):
                        sent[i] = time.perf_counter()
                        futs[i] = server.submit(queries[i])
                        futs[i].add_done_callback(stamp(i))

                launches.zero()
                t0 = time.perf_counter()
                submit_s = run_threads(SERVE_PRODUCERS, producer)
                for i, f in enumerate(futs):
                    try:
                        ids[i] = f.result(timeout=600)[0]
                    except Exception as e:
                        errors.append(repr(e))
                wall = time.perf_counter() - t0
                lat = done - sent
            else:
                def client(c):
                    for i in range(c * SERVE_CALLS, (c + 1) * SERVE_CALLS):
                        t = time.perf_counter()
                        try:
                            ids[i] = server.search(queries[i])[0]
                        except Exception as e:
                            errors.append(repr(e))
                        lat[i] = time.perf_counter() - t

                launches.zero()
                submit_s = None
                wall = run_threads(SERVE_CLIENTS, client)
            got = launches.read(mode)
            batches = server.batches - b0
            search_s = server.search_s - s0
            same = float((ids == direct).all(1).mean())
            rec = calc_recall(ids, gt)
            # where a request's time goes: the dispatcher's searches (a
            # share of the wall), the rest queue wait and the host's
            # Python around the queue
            rep[mode] = {"qps": nq / wall, "wall_s": wall, **latency(lat),
                         "batches": batches,
                         "mean_batch": (server.queries - q0) / max(batches, 1),
                         "search_ms_per_batch": search_s / max(batches, 1)
                         * 1e3,
                         "search_share_of_wall": search_s / wall,
                         "submit_s": submit_s,
                         "recall": rec, "rows_equal_direct": same,
                         "errors": len(errors)}
            log(f"serving {mode}: {nq / wall:.1f} QPS, latency p50 "
                f"{rep[mode]['p50_ms']:.2f} ms p99 {rep[mode]['p99_ms']:.2f} "
                f"ms, {batches} batches of {rep[mode]['mean_batch']:.1f} on "
                f"average, {rep[mode]['search_ms_per_batch']:.2f} ms of search "
                f"a batch ({rep[mode]['search_share_of_wall']:.3f} of the "
                f"wall), submit {submit_s}, recall@10 {rec:.4f} (direct call "
                f"{rep['direct_recall']:.4f}), rows equal to the direct call "
                f"{same:.4f}, errors {len(errors)}, launches {got}")
            if errors:
                raise AssertionError(f"serving {mode}: failed requests "
                                     f"{errors[:3]}")
            if min(got[k] for k in ("gather_estimate", "pool_merge",
                                    "ring_probe")) <= 0:
                raise AssertionError(f"serving {mode}: a hop kernel was "
                                     f"launched no time: {got}")
            if rec < RECALL_FLOOR or (same < 1.0 and abs(
                    rec - rep["direct_recall"]) > SERVE_RECALL_SLACK):
                raise AssertionError(f"serving {mode}: recall@10 {rec} "
                                     f"(direct {rep['direct_recall']})")
    finally:
        server.close()
    rep["launches"] = launches.steps
    return rep


# ---- the captured search (phase 25) ----
def host_syncs(torch, fn):
    """(fn's result, the synchronizing CUDA calls it made): torch's sync
    debug mode warns "called a synchronizing CUDA operation" once for each
    (and once, on its first use, that it does not see every kind)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing CUDA operation" in str(w.message)
                    for w in caught)


def reserved_of(torch, fn):
    """(fn's result, peak reserved GiB over fn, GiB still reserved after it
    and an empty_cache), both above the reserved memory at the start, with
    no captured graph held before fn."""
    from alayalite_tpu_torch.index import captured

    captured.clear()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_reserved() - base
    gc.collect()
    torch.cuda.empty_cache()
    return out, peak / 2**30, (torch.cuda.memory_reserved() - base) / 2**30


def spread(ms) -> dict:
    return {"median_ms": float(np.median(ms)), "min_ms": float(min(ms)),
            "max_ms": float(max(ms)), "ms": [float(x) for x in ms]}


def stop_hops(torch, sp, seeds, q, k, ef, m, max_iters, nbrs=None):
    """(the hop after which no query of the slice had an unchecked entry,
    where the early stop the loops made before ended the loop; the hops the
    loop runs now). ``nbrs``: the raw beam over that adjacency, else the block
    beam."""
    from alayalite_tpu_torch.index import search as S

    L = max(ef, k)
    iters = S._default_iters(L, m, max_iters)
    if nbrs is None:
        ctx, state = S._block_start(sp, seeds, q, k, L, m, iters)
        res_pool = getattr(sp, "bits", 0) == 1

        def hop(state):
            return S._block_hop(sp, ctx, q, *state, m, L, k, res_pool)
    else:
        state = S._beam_start(sp, seeds, q, nbrs.shape[0], L, m, iters, True)

        def hop(state):
            return S._beam_hop(sp, nbrs, q, *state, m, L, True)
    for h in range(iters):
        if not bool(S._has_next(*state[1:4]).any()):
            return h, iters
        state = hop(state)
    return iters, iters


def as_mode(fn):
    """``fn`` as ``call(capture)``: ``fn()`` with the port's slices
    replayed where ``capture``, else inside ``captured.eager()``."""
    from alayalite_tpu_torch.index import captured

    def call(capture: bool):
        with contextlib.nullcontext() if capture else captured.eager():
            return fn()
    return call


def captured_case(torch, what: str, search, stops, card: str) -> dict:
    """One search of phase 25: ``search()`` -> (d or ids, ...) on the card,
    captured against uncaptured; ``stops()`` -> [(stop hop, hops)] a
    slice."""
    from alayalite_tpu_torch.index import captured
    from alayalite_tpu_torch.index.search import overlay_descend

    search = as_mode(search)
    launches = Launches(new_counters())
    want, peak_u, held_u = reserved_of(torch, lambda: search(False))
    s0 = dict(captured.stats)
    t = time.perf_counter()
    _, peak_c, held_c = reserved_of(torch, lambda: search(True))
    first_ms = (time.perf_counter() - t) * 1e3
    graphs = captured.stats["captures"] - s0["captures"]
    capture_s = captured.stats["capture_s"] - s0["capture_s"]
    launches.zero()
    got = search(True)
    launches.read("replay")
    launches.zero()
    search(False)
    launches.read("uncaptured")
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    if not same:
        raise AssertionError(f"captured {what}: a replay differs from the "
                             "uncaptured search")
    if launches.steps["replay"] != launches.steps["uncaptured"]:
        raise AssertionError(f"captured {what}: a replay's launch counts "
                             f"{launches.steps} differ from the uncaptured")
    times = {True: [], False: []}
    for _ in range(CAPTURE_REPS):
        for mode in (True, False):
            _, wall = synced(torch, lambda: search(mode))
            times[mode].append(wall * 1e3)
    syncs, descent = {}, {}
    for mode in (True, False):
        d0 = overlay_descend.syncs
        _, syncs[mode] = host_syncs(torch, lambda: search(mode))
        descent[mode] = overlay_descend.syncs - d0
    stop = stops()
    hop_syncs = {m: syncs[m] - descent[m] for m in (True, False)}
    rep = {"bit_equal": same, "captured": spread(times[True]),
           "uncaptured": spread(times[False]), "first_call_ms": first_ms,
           "graphs_captured": graphs, "capture_s": capture_s,
           "host_syncs_per_call": syncs[True],
           "host_syncs_per_call_uncaptured": syncs[False],
           "descent_syncs_per_call": descent[True],
           "hop_syncs_per_call": hop_syncs[True],
           "peak_reserved_gib": peak_c, "held_reserved_gib": held_c,
           "peak_reserved_gib_uncaptured": peak_u,
           "held_reserved_gib_uncaptured": held_u,
           "stop_hops": [h for h, _ in stop], "hops": stop[0][1],
           "wasted_hops": [n - h for h, n in stop],
           "launches_per_call": launches.steps["replay"], "card": card}
    log(f"captured {what}: bit-equal {same}; wall ms median "
        f"{rep['captured']['median_ms']:.3f} [{rep['captured']['min_ms']:.3f}"
        f", {rep['captured']['max_ms']:.3f}] captured against "
        f"{rep['uncaptured']['median_ms']:.3f} "
        f"[{rep['uncaptured']['min_ms']:.3f}, "
        f"{rep['uncaptured']['max_ms']:.3f}] uncaptured "
        f"({CAPTURE_REPS} calls each); first call {first_ms:.1f} ms with "
        f"{graphs} graph(s) captured in {capture_s:.3f} s; host syncs a call "
        f"{syncs[True]} ({descent[True]} of the descent, {hop_syncs[True]} "
        f"in the hops; uncaptured {syncs[False]}); reserved GiB peak "
        f"{peak_c:.3f} held {held_c:.3f} captured, peak {peak_u:.3f} held "
        f"{held_u:.3f} uncaptured; the early stop would have ended the "
        f"slices at hops {rep['stop_hops']} of {rep['hops']}; {card}")
    if hop_syncs[True] or hop_syncs[False]:
        raise AssertionError(f"captured {what}: a host sync outside the "
                             f"descent: {syncs}, descent {descent}")
    return rep


def engine_case(torch, what, idx, qd, ef, card, raw=False):
    """A whole batch through ``IndexEngine._batch_search_impl`` (device
    queries, device results), captured and not; stop hops by slice."""
    from alayalite_tpu_torch.index import captured
    from alayalite_tpu_torch.index.search import graph_seeds, scan_seeds

    eng = idx._engine
    p = eng.params
    k_ef = max(ef, K)
    if p.quantization_type.value == "rabitq":
        k_ef = max(k_ef, int(round(k_ef * p.rabitq_ef_boost)))

    def stops():
        out = []
        for lo in range(0, qd.shape[0], 4096):
            q = qd[lo:lo + 4096]
            if raw:
                g = eng.graph
                with captured.eager():
                    seeds = graph_seeds(eng.space, g.eps, g.overlay,
                                        eng.space.prep_query(q))
                out.append(stop_hops(torch, eng.space, seeds,
                                     eng.space.prep_query(q), K, k_ef,
                                     p.beam_expand, p.search_iters,
                                     nbrs=g.nbrs))
            else:
                sp = eng.search_space
                qp = sp.prep_query(q)
                seeds = scan_seeds(qp, *eng._seed_scan_arrays())
                out.append(stop_hops(torch, sp, seeds, qp, K, k_ef,
                                     p.beam_expand, p.search_iters))
        return out

    return captured_case(
        torch, what, lambda: eng._batch_search_impl(qd, K, ef),
        stops, card)


def pool_chunk_case(torch, idx, card) -> dict:
    """One build-pool chunk on the fitted bsq8 index's block space: the
    first POOL_CHUNK rows searched for their own pools at POOL_EF, seeded as
    build_phases._pool_seeds seeds them."""
    from alayalite_tpu_torch.index.build_phases import (_pool_seeds,
                                                        make_generator)
    from alayalite_tpu_torch.index.search import block_beam_search

    eng = idx._engine
    sp = eng.search_space
    rows = sp.data[:POOL_CHUNK]
    seeds = _pool_seeds(eng.graph.eps, rows, sp.num, POOL_RAND,
                        make_generator(sp.device, 25),
                        eng._seed_scan_arrays())
    m = eng.params.beam_expand
    return captured_case(
        torch, f"bsq8 pool chunk ({POOL_CHUNK} rows, ef {POOL_EF})",
        lambda: block_beam_search(sp, seeds, rows, k=POOL_EF, ef=POOL_EF,
                                  n_expand=m),
        lambda: [stop_hops(torch, sp, seeds, rows, POOL_EF, POOL_EF, m, 0)],
        card)


def descent_steps(torch, idx, qd) -> list:
    """The steps of each overlay level's descent for the first slice (one
    host test a step): what DESCENT_CHUNK is picked from."""
    from alayalite_tpu_torch.index import captured
    from alayalite_tpu_torch.index import search as S

    eng = idx._engine
    q = eng.space.prep_query(qd[:4096])
    overlay = eng.graph.overlay
    cur = torch.argmax((overlay[0].ids >= 0).to(torch.int8)).to(
        torch.int32).expand(q.shape[0])
    chunk, S.DESCENT_CHUNK = S.DESCENT_CHUNK, 1
    steps = []
    try:
        for lvl in overlay:
            s0 = S.overlay_descend.syncs
            with captured.eager():
                cur = S.overlay_descend(eng.space, lvl.ids, lvl.nbrs,
                                        lvl.down, cur, q)
            steps.append(S.overlay_descend.syncs - s0)
    finally:
        S.DESCENT_CHUNK = chunk
    return steps


class Uncaptured:
    """An index whose engine searches inside ``captured.eager()`` (on the
    thread that searches): the SearchServer of phase 25's uncaptured closed
    loop."""

    def __init__(self, idx):
        self._idx, self._engine = idx, self

    def get_dim(self):
        return self._idx.get_dim()

    def batch_search_with_distance(self, queries, topk, ef=100,
                                   num_threads=1):
        from alayalite_tpu_torch.index import captured

        eng = self._idx._engine
        with captured.eager():
            ids, d = eng._batch_search_impl(queries, topk, ef)
        return (ids.cpu().numpy().astype(eng._id_dtype, copy=False),
                d.cpu().numpy())


def closed_loop_case(torch, idx, queries, gt, card) -> dict:
    """Phase 17's closed loop (SERVE_CLIENTS threads x SERVE_CALLS blocking
    search() calls) over the captured index and over ``Uncaptured``: QPS,
    p50 / p99, batches, recall@10 and the rows equal to one direct call."""
    from alayalite_tpu_torch.serving import SearchServer
    from alayalite_tpu_torch.utils.evaluate import calc_recall

    nq = queries.shape[0]
    direct, _ = idx._engine.batch_search_with_distance(queries, K,
                                                       ef=SERVE["ef"])
    rep = {"card": card}
    for mode, target in (("captured", idx), ("uncaptured", Uncaptured(idx))):
        server = SearchServer(target, **SERVE)
        try:
            server.search(queries[0])                          # warm-up
            ids = np.full((nq, K), -1, dtype=np.int64)
            lat = np.zeros(nq)
            errors = []

            def client(c):
                for i in range(c * SERVE_CALLS, (c + 1) * SERVE_CALLS):
                    t = time.perf_counter()
                    try:
                        ids[i] = server.search(queries[i])[0]
                    except Exception as e:
                        errors.append(repr(e))
                    lat[i] = time.perf_counter() - t

            b0, q0 = server.batches, server.queries
            wall = run_threads(SERVE_CLIENTS, client)
            batches = server.batches - b0
        finally:
            server.close()
        same = float((ids == direct).all(1).mean())
        rec = calc_recall(ids, gt)
        rep[mode] = {"qps": nq / wall, "wall_s": wall, **latency(lat),
                     "batches": batches,
                     "mean_batch": (server.queries - q0) / max(batches, 1),
                     "recall": rec, "rows_equal_direct": same,
                     "errors": len(errors)}
        log(f"captured serving closed loop, {mode}: {nq / wall:.1f} QPS, "
            f"p50 {rep[mode]['p50_ms']:.2f} ms p99 {rep[mode]['p99_ms']:.2f} "
            f"ms, {batches} batches of {rep[mode]['mean_batch']:.1f}, recall "
            f"{rec:.4f}, rows equal to the direct call {same:.4f}; {card}")
        direct_rec = calc_recall(direct, gt)
        if errors or rec < RECALL_FLOOR or (same < 1.0 and abs(
                rec - direct_rec) > SERVE_RECALL_SLACK):
            raise AssertionError(f"captured serving {mode}: {rep[mode]} "
                                 f"(direct {direct_rec}), {errors[:3]}")
    return rep


# ---- the captured build phases and inserts (phase 26) ----
def replay_case(torch, what: str, call, card: str, restore=lambda: None,
                state=lambda: {}) -> dict:
    """One call of phase 26: ``call()`` -> a tuple of tensors, run
    after ``restore()`` (an insert: the index state it started from) and
    captured against uncaptured. The results and ``state()`` (the tensors
    the call wrote) bit for bit, the launch counts of a replay against an
    uncaptured call, CAPTURE_REPS synchronised calls of each, host syncs a
    call, graphs and capture seconds, reserved memory of each with no
    other graph held."""
    from alayalite_tpu_torch.index import captured

    call = as_mode(call)
    launches = Launches(new_counters())
    restore()
    launches.zero()
    want, peak_u, held_u = reserved_of(torch, lambda: call(False))
    launches.read("uncaptured")
    want_state = state()
    s0 = dict(captured.stats)
    restore()
    t = time.perf_counter()
    _, peak_c, held_c = reserved_of(torch, lambda: call(True))
    first_ms = (time.perf_counter() - t) * 1e3
    graphs = captured.stats["captures"] - s0["captures"]
    capture_s = captured.stats["capture_s"] - s0["capture_s"]
    restore()
    launches.zero()
    got = call(True)
    launches.read("replay")
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    got_state = state()
    differ = [k for k, v in want_state.items()
              if not torch.equal(got_state[k], v)]
    del got_state, want_state
    if not same or differ:
        raise AssertionError(f"captured {what}: a replay differs from the "
                             f"uncaptured call (results equal {same}, "
                             f"written tensors that differ {differ})")
    if launches.steps["replay"] != launches.steps["uncaptured"]:
        raise AssertionError(f"captured {what}: a replay's launch counts "
                             f"{launches.steps} differ from the uncaptured")
    times = {True: [], False: []}
    for _ in range(CAPTURE_REPS):
        for mode in (True, False):
            restore()
            _, wall = synced(torch, lambda: call(mode))
            times[mode].append(wall * 1e3)
    syncs = {}
    for mode in (True, False):
        restore()
        torch.cuda.synchronize()
        _, syncs[mode] = host_syncs(torch, lambda: call(mode))
    restore()
    rep = {"bit_equal": True, "captured": spread(times[True]),
           "uncaptured": spread(times[False]), "first_call_ms": first_ms,
           "graphs_captured": graphs, "capture_s": capture_s,
           "host_syncs_per_call": syncs[True],
           "host_syncs_per_call_uncaptured": syncs[False],
           "peak_reserved_gib": peak_c, "held_reserved_gib": held_c,
           "peak_reserved_gib_uncaptured": peak_u,
           "held_reserved_gib_uncaptured": held_u,
           "launches_per_call": launches.steps["replay"], "card": card}
    log(f"captured {what}: bit-equal True; wall ms median "
        f"{rep['captured']['median_ms']:.3f} [{rep['captured']['min_ms']:.3f}"
        f", {rep['captured']['max_ms']:.3f}] captured against "
        f"{rep['uncaptured']['median_ms']:.3f} "
        f"[{rep['uncaptured']['min_ms']:.3f}, "
        f"{rep['uncaptured']['max_ms']:.3f}] uncaptured ({CAPTURE_REPS} "
        f"calls each); first call {first_ms:.1f} ms with {graphs} graph(s) "
        f"captured in {capture_s:.3f} s; host syncs a call {syncs[True]} "
        f"(uncaptured {syncs[False]}); reserved GiB peak {peak_c:.3f} held "
        f"{held_c:.3f} captured, peak {peak_u:.3f} held {held_u:.3f} "
        f"uncaptured; launches a call {launches.steps['replay']}; {card}")
    return rep


def fit_memory_base(torch) -> int:
    """The reserved bytes before a fit, the cache emptied and the peak
    reset."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_reserved()


def fit_memory(torch, base: int, what: str) -> dict:
    """Just after a fit: the graphs held (none may be new), memory
    allocated, the peak reserved and the reserved after an empty_cache,
    each above ``base``, GiB."""
    from alayalite_tpu_torch.index import captured

    torch.cuda.synchronize()
    rep = {"peak_reserved_gib": (torch.cuda.max_memory_reserved() - base)
           / 2**30, "graphs_held": captured.held()}
    gc.collect()
    torch.cuda.empty_cache()
    rep.update(allocated_gib=torch.cuda.memory_allocated() / 2**30,
               held_reserved_gib=(torch.cuda.memory_reserved() - base)
               / 2**30)
    log(f"{what}: graphs held {rep['graphs_held']}, allocated "
        f"{rep['allocated_gib']:.3f} GiB, reserved after empty_cache "
        f"{rep['held_reserved_gib']:.3f} GiB, peak reserved "
        f"{rep['peak_reserved_gib']:.3f} GiB (above the reserved before it)")
    return rep


def moved(torch, x, dev, keep):
    """``x`` (tensors in tuples, lists and dicts) with every tensor on
    ``dev``, but the dataclass ``keep`` (the index's own space) as it
    is."""
    if x is keep:
        return x
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (tuple, list)):
        return type(x)(moved(torch, v, dev, keep) for v in x)
    if isinstance(x, dict):
        return {k: moved(torch, v, dev, keep) for k, v in x.items()}
    return x


def build_capture_phase(torch, ds, card, fitted, fitted_memory) -> tuple:
    """Phase 26, the build: phase 4's bsq8 fit again with every phase
    uncaptured, its prune, re-prune, fill and repair inputs recorded; its
    memory and final adjacency against phase 4's captured fit (``fitted``,
    ``fitted_memory``); then one chunk of each prune phase and the whole
    prune_all_dev on them, captured against uncaptured. Returns (the
    report, phase 27's inputs: the raw space, the adjacency before the
    repair and the entry point)."""
    from alayalite_tpu_torch import Client
    from alayalite_tpu_torch.index import build_phases as bp
    from alayalite_tpu_torch.index import captured, qg

    names = ("prune_all_dev", "reprune_with_reverse_dev", "fill_degree_dev",
             "repair_connectivity")
    real = {name: getattr(qg, name) for name in names}
    rec = {}

    def recorder(name):
        def call(*a, **kw):
            if name == "repair_connectivity":    # it writes in place
                rec[name] = (a[0], a[1].clone(), a[2])
                return real[name](*a, **kw)
            out = real[name](*a, **kw)
            rec[name] = (a, kw, out)
            return out
        return call

    idx = Client().create_index("uncaptured", **BSQ8_PARAMS)
    held_before = captured.held()
    for name in names:
        setattr(qg, name, recorder(name))
    try:
        base = fit_memory_base(torch)
        s0 = dict(captured.stats)
        with captured.eager():
            _, fit_s = synced(torch, lambda: idx._engine.fit(
                ds.data, ef_construction=100))
    finally:
        for name in names:
            setattr(qg, name, real[name])
    graphs = captured.stats["captures"] - s0["captures"]
    # the recorded inputs are not the fit's: on the host while its memory
    # is read
    rec = moved(torch, rec, torch.device("cpu"), idx._engine.space)
    memory = fit_memory(torch, base, "uncaptured bsq8 fit")
    rec = moved(torch, rec, idx._engine.device, idx._engine.space)
    rep = {"uncaptured_fit": {
        "seconds": fit_s, "phases": dict(idx._engine.build_timings),
        "peak_reserved_gib": memory["peak_reserved_gib"],
        "graphs_captured": graphs, "memory": memory}, "card": card}
    log(f"uncaptured bsq8 fit: {fit_s:.2f}s, phases "
        + ", ".join(f"{k}={v:.2f}s" for k, v in rep["uncaptured_fit"][
            "phases"].items())
        + f", peak reserved {rep['uncaptured_fit']['peak_reserved_gib']:.2f}"
        f" GiB, graphs captured {rep['uncaptured_fit']['graphs_captured']}")
    if graphs:
        raise AssertionError("the uncaptured fit captured a graph")
    if fitted_memory["graphs_held"] or memory["graphs_held"] != held_before:
        raise AssertionError(
            f"a fit left graphs held: captured fit "
            f"{fitted_memory['graphs_held']}, uncaptured fit "
            f"{memory['graphs_held']} (before it {held_before})")
    rep["memory"] = {
        "held_reserved_gib": [fitted_memory["held_reserved_gib"],
                              memory["held_reserved_gib"]],
        "peak_reserved_gib": [fitted_memory["peak_reserved_gib"],
                              memory["peak_reserved_gib"]],
        "allocated_gib": [fitted_memory["allocated_gib"],
                          memory["allocated_gib"]],
        "is": "[captured fit (phase 4), uncaptured fit]"}
    held_gap = (fitted_memory["held_reserved_gib"]
                - memory["held_reserved_gib"])
    peak_gap = (fitted_memory["peak_reserved_gib"]
                - memory["peak_reserved_gib"])
    log(f"fit memory, captured against uncaptured: reserved after "
        f"empty_cache {held_gap:+.3f} GiB (slack {MEM_HELD_SLACK}), peak "
        f"reserved {peak_gap:+.3f} GiB (slack {MEM_PEAK_SLACK}); {card}")
    if held_gap > MEM_HELD_SLACK or peak_gap > MEM_PEAK_SLACK:
        raise AssertionError(f"the captured fit holds {held_gap:.3f} GiB "
                             f"more after empty_cache, or peaks "
                             f"{peak_gap:.3f} GiB higher, than the "
                             f"uncaptured fit")
    ga, gb = fitted._engine.graph, idx._engine.graph
    same = (bool(torch.equal(ga.nbrs, gb.nbrs))
            and bool(torch.equal(ga.eps, gb.eps)))
    rep["final_adjacency_equal"] = same
    log(f"the captured fit's final adjacency and entry points equal the "
        f"uncaptured fit's: {same}")
    if not same:
        diff = int((ga.nbrs != gb.nbrs).any(1).sum())
        raise AssertionError(f"the captured fit's adjacency differs from "
                             f"the uncaptured fit's in {diff} rows")
    del idx, ga, gb
    gc.collect()
    torch.cuda.empty_cache()
    (sp, cd, ci), kw, pruned = rec["prune_all_dev"]
    (_, nbrs, rev), rkw, repruned = rec["reprune_with_reverse_dev"]
    (fnb, fcd, fci), fkw, _ = rec["fill_degree_dev"]
    r, alpha, chunk = kw["r"], kw["alpha"], kw["chunk"]
    c = min(chunk, ci.shape[0])
    rep["prune_chunk"] = replay_case(
        torch, f"prune chunk ({c} x {ci.shape[1]}, alpha {alpha})",
        lambda: (bp.prune_all_dev(sp, cd[:c], ci[:c], r=r, alpha=alpha,
                                  chunk=chunk),), card)
    rep["reprune_chunk"] = replay_case(
        torch, f"re-prune chunk ({c} x {nbrs.shape[1] + rev.shape[1]})",
        lambda: (bp.reprune_with_reverse_dev(
            sp, nbrs[:c], rev[:c], r=r, alpha=alpha, chunk=chunk),), card)
    rep["fill_chunk"] = replay_case(
        torch, f"fill chunk ({c} x {fnb.shape[1] + fci.shape[1]})",
        lambda: (bp.fill_degree_dev(fnb[:c], fcd[:c], fci[:c], r=r,
                                    chunk=chunk),), card)
    whole = {}
    prune = as_mode(lambda: bp.prune_all_dev(sp, cd, ci, r=r, alpha=alpha,
                                             chunk=chunk))
    for mode in (True, False):
        s0 = dict(captured.stats)
        ((out, wall), syncs), peak, held = reserved_of(
            torch, lambda: host_syncs(torch, lambda: synced(
                torch, lambda: prune(mode))))
        same = bool(torch.equal(out, pruned))
        whole["captured" if mode else "uncaptured"] = {
            "wall_s": wall, "host_syncs": syncs, "peak_reserved_gib": peak,
            "held_reserved_gib": held, "equal_to_the_fit": same,
            "graphs_captured": captured.stats["captures"] - s0["captures"],
            "capture_s": captured.stats["capture_s"] - s0["capture_s"]}
        del out
        if not same:
            raise AssertionError(f"prune_all_dev (capture {mode}) differs "
                                 "from the uncaptured fit's")
    whole["chunks"] = len(captured.chunk_starts(ci.shape[0], chunk)[0])
    rep["prune_all"] = whole
    log(f"prune_all_dev over {ci.shape[0]} rows ({whole['chunks']} chunks): "
        f"captured {whole['captured']['wall_s']:.3f}s "
        f"({whole['captured']['graphs_captured']} graph, "
        f"{whole['captured']['capture_s']:.3f}s to capture, host syncs "
        f"{whole['captured']['host_syncs']}, peak reserved "
        f"{whole['captured']['peak_reserved_gib']:.3f} GiB held "
        f"{whole['captured']['held_reserved_gib']:.3f}) against uncaptured "
        f"{whole['uncaptured']['wall_s']:.3f}s (host syncs "
        f"{whole['uncaptured']['host_syncs']}, peak reserved "
        f"{whole['uncaptured']['peak_reserved_gib']:.3f} GiB); both equal "
        f"to the uncaptured fit's; {card}")
    syncs = {k: rep[k]["host_syncs_per_call"] for k in (
        "prune_chunk", "reprune_chunk", "fill_chunk")}
    if any(syncs.values()) or whole["captured"]["host_syncs"]:
        raise AssertionError(f"a host sync inside a prune phase: {syncs}, "
                             f"whole {whole['captured']['host_syncs']}")
    handoff = rec["repair_connectivity"]
    del rec, sp, cd, ci, nbrs, rev, fnb, fcd, fci, pruned, repruned
    gc.collect()
    torch.cuda.empty_cache()
    return rep, handoff


# ---- NN-Descent and the repair captured (phase 27) ----
def sort_at_nnd_chunk(torch, dev, chunk: int, k: int) -> dict:
    """sort_kv's warp route at NN-Descent's merge shape ([chunk, k + 148]
    -> k, positions out: a sorted pool row, then the candidates with the
    dropped ones at +inf) against its plain version, bit for bit, timed
    beside the library's sort."""
    from alayalite_tpu_torch.ops.pool_sort import (sort_kv_on, sort_kv_ref,
                                                   sort_kv_route)
    from alayalite_tpu_torch.utils.timing import bound, cuda_ms

    rng = np.random.default_rng(27)
    width = k + 148
    pool = np.sort(rng.random((chunk, k)).astype(np.float32), axis=1)
    cand = rng.random((chunk, width - k)).astype(np.float32)
    cand[rng.random(cand.shape) < 0.3] = np.inf
    keys = torch.as_tensor(np.concatenate([pool, cand], 1), device=dev)
    if sort_kv_route(width) != "warp":
        raise AssertionError(f"sort_kv at {(chunk, width)} is not routed to "
                             "the warp kernel")

    def warp():
        return sort_kv_on("warp", keys, None, k, 1, True, counted=False)

    def plain():
        return sort_kv_ref(keys, None, k, 1, True)

    def library():
        sk, order = torch.sort(keys, dim=1, stable=True)
        return sk[:, :k], order[:, :k]

    if not all(_same_bits(g, w) for g, w in zip(warp(), plain())):
        raise AssertionError(f"sort_kv[warp] differs from its plain version "
                             f"at {(chunk, width, k)}")
    p = 1 << max(0, int(width - 1).bit_length())
    lg = p.bit_length() - 1
    rep = {"shape": [chunk, width, k], "route": "warp",
           **bound(chunk * width * 4 + chunk * k * 12,
                   2 * chunk * (p // 2) * lg * (lg + 1) // 2, "f32"),
           "ms": cuda_ms(warp), "ms_spin": cuda_ms(warp, spin=True),
           "plain_ms": cuda_ms(plain), "library_ms": cuda_ms(library)}
    log(f"kernel sort_kv at NN-Descent's merge {(chunk, width)} -> {k}: "
        f"warp {rep['ms']:.4f} ms ({rep['ms_spin']:.4f} device alone), "
        f"equal to the plain version bit for bit; plain "
        f"{rep['plain_ms']:.4f} ms, library sort {rep['library_ms']:.4f} ms, "
        f"bound {rep['bound_ms']:.4f} ms ({rep['bound_by']})")
    return rep


def scoped_case(torch, what: str, call, reads, card: str,
                restore=lambda: None) -> dict:
    """One case of phase 27: ``call()`` -> a tuple of tensors, after
    ``restore()``, captured inside one captured.scope() (the first call
    captures, as a fit phase does; later calls replay) against uncaptured:
    results bit for bit, a replay's launch counts against the uncaptured
    call's, wall ms of PHASE27_REPS calls each, host syncs of a call
    against the host reads the module states (``reads()``: its counter),
    graphs, capture seconds, peak and held reserved memory."""
    from alayalite_tpu_torch.index import captured

    call = as_mode(call)

    def counted(mode):
        r0 = reads()
        out, syncs = host_syncs(torch, lambda: call(mode))
        return out, syncs, reads() - r0

    launches = Launches(new_counters())
    restore()
    launches.zero()
    (want, syncs_u, reads_u), peak_u, held_u = reserved_of(
        torch, lambda: counted(False))
    launches.read("uncaptured")
    base = fit_memory_base(torch)
    s0 = dict(captured.stats)
    times = {True: [], False: []}
    with captured.scope():
        restore()
        (first, syncs_first, reads_first), first_s = synced(
            torch, lambda: counted(True))
        peak_c = (torch.cuda.max_memory_reserved() - base) / 2**30
        graphs = captured.stats["captures"] - s0["captures"]
        capture_s = captured.stats["capture_s"] - s0["capture_s"]
        restore()
        launches.zero()
        got, syncs_c, reads_c = counted(True)
        launches.read("replay")
        for _ in range(PHASE27_REPS):
            for mode in (True, False):
                restore()
                _, wall = synced(torch, lambda: call(mode))
                times[mode].append(wall * 1e3)
        restore()
    gc.collect()
    torch.cuda.empty_cache()
    held_c = (torch.cuda.memory_reserved() - base) / 2**30
    same = [all(bool(torch.equal(a, b)) for a, b in zip(x, want))
            for x in (first, got)]
    del first, got, want
    if not all(same):
        raise AssertionError(f"captured {what} differs from the uncaptured "
                             f"call (first call, replay: {same})")
    if launches.steps["replay"] != launches.steps["uncaptured"]:
        raise AssertionError(f"captured {what}: a replay's launch counts "
                             f"{launches.steps} differ from the uncaptured")
    syncs = {"first_call": [syncs_first, reads_first],
             "replay": [syncs_c, reads_c], "uncaptured": [syncs_u, reads_u]}
    if any(got > stated for got, stated in syncs.values()):
        raise AssertionError(f"captured {what}: host syncs beyond the "
                             f"stated reads ([syncs, stated]): {syncs}")
    rep = {"bit_equal": True, "captured": spread(times[True]),
           "uncaptured": spread(times[False]),
           "first_call_ms": first_s * 1e3, "graphs_captured": graphs,
           "capture_s": capture_s, "host_syncs_and_stated_reads": syncs,
           "peak_reserved_gib": peak_c, "held_reserved_gib": held_c,
           "peak_reserved_gib_uncaptured": peak_u,
           "held_reserved_gib_uncaptured": held_u,
           "launches_per_call": launches.steps["replay"], "card": card}
    log(f"captured {what}: bit-equal True; wall ms median "
        f"{rep['captured']['median_ms']:.2f} [{rep['captured']['min_ms']:.2f}"
        f", {rep['captured']['max_ms']:.2f}] captured (replays) against "
        f"{rep['uncaptured']['median_ms']:.2f} "
        f"[{rep['uncaptured']['min_ms']:.2f}, "
        f"{rep['uncaptured']['max_ms']:.2f}] uncaptured ({PHASE27_REPS} "
        f"calls each); first call {rep['first_call_ms']:.1f} ms with "
        f"{graphs} graph(s) captured in {capture_s:.3f} s; host syncs "
        f"[measured, stated] {syncs}; reserved GiB peak {peak_c:.3f} held "
        f"after the scope {held_c:.3f} captured, peak {peak_u:.3f} held "
        f"{held_u:.3f} uncaptured; launches a call "
        f"{launches.steps['replay']}; {card}")
    return rep


def knn_repair_phase(torch, sp, nbrs0, ep: int, card: str) -> dict:
    """Phase 27: sort_kv at NN-Descent's merge shape, then NN-Descent and
    the repair captured against uncaptured on phase 26's recorded inputs
    (``sp`` the 1M raw space, ``nbrs0`` the fit's adjacency before its
    repair, ``ep`` its entry point)."""
    from alayalite_tpu_torch.index import nndescent, repair_dev

    t = time.time()
    n = nbrs0.shape[0]
    shape = nndescent.round_shape(n, NND_K, sp.dim)
    rep = {"sort_kv_at_nnd_chunk": sort_at_nnd_chunk(
        torch, sp.device, shape["chunk"], NND_K), "round_shape": shape}
    knn_reads = nndescent.build_knn_graph

    rep["knn"] = scoped_case(
        torch, f"kNN phase (n {n}, k {NND_K}, {NND_ITERS} rounds, "
        f"{-(-n // shape['chunk'])} chunks of {shape['chunk']})",
        lambda: nndescent.build_knn_graph(sp, n, NND_K,
                                          max_iters=NND_ITERS, seed=0),
        lambda: knn_reads.syncs, card)
    buf = torch.empty_like(nbrs0)
    repair = repair_dev.repair_connectivity

    def call():
        return (repair(sp, buf, ep).clone(),)

    rep["repair"] = scoped_case(
        torch, f"repair ({n} x {nbrs0.shape[1]})", call,
        lambda: repair.syncs, card, restore=lambda: buf.copy_(nbrs0))
    del buf
    rep["phase_s"] = time.time() - t
    return rep


def insert_case(torch, what: str, eng, rows: np.ndarray, card: str) -> dict:
    """Phase 26, an insert: one slice of ``rows`` through the engine's
    slice method (device rows in, device ids out), captured against
    uncaptured from the same index state, restored before every call and
    at the end. Host syncs a call are counted outside ``extend_overlay``
    (host code in JAX too), whose own syncs are counted apart; the raw
    path may make one, the new ids' copy to the host."""
    import copy
    import warnings

    from alayalite_tpu_torch.index import overlay_update

    raw = eng.search_space is eng.space
    shadow = eng._ins_shadow

    def live() -> dict:
        out = {"nbrs": eng.graph.nbrs, "data": eng.space.data,
               "sq": eng.space.sq_norms, "valid": eng.space.valid}
        for name, sp in (("search", None if raw else eng.search_space),
                         ("shadow", shadow)):
            if sp is not None:
                for f in ("data", "sq_norms", "valid", "nbr_ids",
                          "nbr_codes", "nbr_xsq"):
                    t = getattr(sp, f)
                    if all(t is not v for v in out.values()):
                        out[f"{name}.{f}"] = t
        for li, lvl in enumerate(eng.graph.overlay):
            for f in ("ids", "nbrs", "down"):
                out[f"overlay{li}.{f}"] = getattr(lvl, f)
        return out

    saved = {k: v.clone() for k, v in live().items()}
    nums = (eng.space.num, eng.search_space.num,
            shadow.num if shadow is not None else None)
    rng = copy.deepcopy(eng._rng)

    def restore():
        for k, v in live().items():
            v.copy_(saved[k])
        eng.space.num, eng.search_space.num = nums[:2]
        if shadow is not None:
            shadow.num = nums[2]
        eng._rng = copy.deepcopy(rng)
        eng._insert_gen = None

    def state():
        return {k: v.clone() for k, v in live().items()}

    v = torch.as_tensor(rows, device=eng.device)
    slice_fn = eng._insert_raw_graph if raw else eng._insert_block_fused
    overlay_syncs = []
    real = overlay_update.extend_overlay

    def counted(*a, **kw):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = real(*a, **kw)
        overlay_syncs.append(sum("called a synchronizing CUDA operation"
                                 in str(w.message) for w in caught))
        return out

    overlay_update.extend_overlay = counted
    try:
        rep = replay_case(torch, what,
                          lambda: (slice_fn(v, INSERT_EF),),
                          card, restore, state)
    finally:
        overlay_update.extend_overlay = real
        restore()
        del saved
        gc.collect()
        torch.cuda.empty_cache()
    rep["extend_overlay_syncs_per_call"] = (overlay_syncs[-1] if overlay_syncs
                                            else 0)
    # the raw path copies the new ids to the host for extend_overlay, as
    # the JAX engine's raw insert does (alayalite_tpu/index/engine.py:482)
    rep["ids_copy_syncs"] = 1 if raw else 0
    log(f"captured {what}: host syncs in extend_overlay a call "
        f"{rep['extend_overlay_syncs_per_call']} (counted apart), the ids' "
        f"copy to the host {rep['ids_copy_syncs']}")
    if rep["host_syncs_per_call"] > rep["ids_copy_syncs"]:
        raise AssertionError(f"captured {what}: {rep['host_syncs_per_call']} "
                             "host syncs outside extend_overlay and the ids' "
                             "copy")
    return rep


def insert_rows(n_base: int, count: int, seed: int) -> np.ndarray:
    """``count`` rows from the data's own clusters (random_dataset draws
    its centers first from seed 42)."""
    clusters = max(32, n_base // 2000)
    centers = (np.random.default_rng(42).normal(size=(clusters, DIM))
               .astype(np.float32) * 4.0)
    rng = np.random.default_rng(seed)
    return (centers[rng.integers(0, clusters, size=count)]
            + rng.normal(size=(count, DIM)).astype(np.float32))


def http_connect(port: int):
    """A client connection to the service on 127.0.0.1, kept open across
    requests (HTTP/1.1)."""
    import http.client

    return http.client.HTTPConnection("127.0.0.1", port, timeout=600)


def http_post(conn, route: str, body: str):
    """(status, decoded response, seconds, response bytes) of one POST of a
    JSON body on ``conn``."""
    t = time.perf_counter()
    conn.request("POST", f"/api/v1/collection/{route}", body,
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    return resp.status, json.loads(data), time.perf_counter() - t, len(data)


def start_service(torch, root: str, batched: bool):
    """create_app on ``root`` (the default device) behind the stdlib HTTP
    server on 127.0.0.1, port 0, in a thread: (app, server, load seconds)."""
    import threading

    from alayalite_tpu_torch.service.app import create_app, make_server

    if batched:
        os.environ["ALAYALITE_BATCH_SERVING"] = "1"
    else:
        os.environ.pop("ALAYALITE_BATCH_SERVING", None)
    app, load_s = synced(torch, lambda: create_app(data_dir=root))
    os.environ.pop("ALAYALITE_BATCH_SERVING", None)
    if app.client.list_collections() != ["docs"]:
        raise AssertionError(f"create_app found "
                             f"{app.client.list_collections()}")
    srv = make_server(app, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return app, srv, load_s


def service_breakdown(torch, col, body: str) -> dict:
    """Where one default-mode query request's time goes, each step timed
    alone (median of 3): JSON decoding, the request model, the index search,
    the id -> document join, JSON encoding of the answer."""
    from alayalite_tpu_torch.service import models as m

    def med(fn):
        out, times = None, []
        for _ in range(3):
            out, dt = synced(torch, fn)
            times.append(dt)
        return out, float(np.median(times)) * 1e3

    payload, decode = med(lambda: json.loads(body))
    req, model = med(lambda: m.QueryCollectionRequest(**payload))
    qv = np.asarray(req.query_vector, dtype=np.float32)
    (ids, dists), search = med(lambda: col._index.batch_search_with_distance(
        qv, req.limit, req.ef_search))
    res, join = med(lambda: col._join_results(ids, dists))
    _, encode = med(lambda: json.dumps(res))
    return {"json_decode_ms": decode, "request_model_ms": model,
            "search_ms": search, "join_ms": join, "json_encode_ms": encode}


def service_phase(torch, root: str, want_ids, gt, doc_of, queries) -> dict:
    """Phase 18: phase 12's directory served over HTTP by create_app +
    the stdlib server. Default mode: the queries as 16 requests of 512
    vectors from 4 threads (the ids must be phase 12's). Batched mode
    (ALAYALITE_BATCH_SERVING=1): 8192 single-vector requests from 64
    threads (recall@10 over the live rows ≥ COLLECTION_FLOOR, every document
    its id's); then insert, upsert, delete_by_id, delete_by_filter, save and
    a missing collection, all over HTTP."""
    nq = queries.shape[0]
    launches = Launches(new_counters())
    rep = {"steps_s": {}}
    steps = rep["steps_s"]
    rows = nq // SERVICE_REQUESTS

    def query_body(vecs, limit=K):
        return json.dumps({"collection_name": "docs",
                           "query_vector": np.asarray(vecs).tolist(),
                           "limit": limit, "ef_search": 64})

    def serve_mode(mode, port, bodies, threads):
        out = [None] * len(bodies)
        lat, nbytes, errors = np.zeros(len(bodies)), np.zeros(len(bodies)), []

        def worker(w):
            conn = http_connect(port)
            for r in range(w, len(bodies), threads):
                try:
                    status, res, lat[r], nbytes[r] = http_post(conn, "query",
                                                               bodies[r])
                    if status != 200:
                        errors.append((status, res))
                    out[r] = res
                except Exception as e:
                    errors.append(repr(e))
            conn.close()

        launches.zero()
        wall = run_threads(threads, worker)
        got = launches.read(mode)
        if errors:
            raise AssertionError(f"service {mode}: failed requests "
                                 f"{errors[:3]}")
        ids = [row for res in out for row in res["id"]]
        docs = [row for res in out for row in res["document"]]
        rep[mode] = {"requests": len(bodies),
                     "requests_per_s": len(bodies) / wall,
                     "queries_per_s": nq / wall, "wall_s": wall,
                     **latency(lat),
                     "request_bytes": float(np.mean([len(b) for b in bodies])),
                     "response_bytes": float(nbytes.mean()),
                     "recall": outer_recall(ids, gt),
                     "wrong_documents": sum(
                         doc != doc_of(i) for ri, rd in zip(ids, docs)
                         for i, doc in zip(ri, rd))}
        log(f"service {mode}: {len(bodies)} requests from {threads} threads, "
            f"{rep[mode]['requests_per_s']:.1f} requests/s "
            f"({rep[mode]['queries_per_s']:.1f} queries/s), latency p50 "
            f"{rep[mode]['p50_ms']:.2f} ms p99 {rep[mode]['p99_ms']:.2f} ms, "
            f"{rep[mode]['request_bytes']:.0f} B a request, recall@10 "
            f"{rep[mode]['recall']:.4f}, wrong documents "
            f"{rep[mode]['wrong_documents']}, launches {got}")
        if got["pool_merge"] <= 0 or got["ring_probe"] <= 0:
            raise AssertionError(f"service {mode}: the search launched a "
                                 f"kernel of its path no time: {got}")
        return ids

    # default mode: requests serialized by the app's lock
    app, srv, steps["create_app_default"] = start_service(torch, root, False)
    bodies = [query_body(queries[r * rows:(r + 1) * rows])
              for r in range(SERVICE_REQUESTS)]
    warm = http_connect(srv.server_address[1])
    http_post(warm, "query", bodies[0])                          # warm-up
    warm.close()
    ids = serve_mode("default", srv.server_address[1], bodies,
                     SERVICE_THREADS)
    col = app.client.get_collection("docs")
    # phase 12 searched all the queries in one call: the searches sum each
    # distance in an order that does not depend on the batch
    # (ops.gather_dot), so the rows must be equal
    default = rep["default"]
    default["ids_equal_phase12"] = float(np.mean(
        [a == b for a, b in zip(ids, want_ids)]))
    rep["breakdown_one_request"] = service_breakdown(torch, col, bodies[0])
    log(f"service: one request of {rows} vectors, timed apart "
        f"{rep['breakdown_one_request']}; rows equal to phase 12's one "
        f"call {default['ids_equal_phase12']:.4f}")
    srv.shutdown()
    srv.server_close()
    del app, srv, col
    gc.collect()
    torch.cuda.empty_cache()
    if default["ids_equal_phase12"] < 1.0 or default["wrong_documents"]:
        raise AssertionError(f"service default mode: {default}")

    # batched mode: single-vector requests coalesce in one SearchServer
    app, srv, steps["create_app_batched"] = start_service(torch, root, True)
    port = srv.server_address[1]
    conn = http_connect(port)
    try:
        bodies = [query_body(queries[i:i + 1]) for i in range(nq)]
        http_post(conn, "query", bodies[0])                      # warm-up
        serve_mode("batched", port, bodies, SERVICE_CLIENTS)
        server = app._servers["docs"]
        rep["batched"].update(
            batches=server.batches,
            mean_batch=server.queries / server.batches,
            search_ms_per_batch=server.search_s / server.batches * 1e3,
            search_share_of_wall=server.search_s / rep["batched"]["wall_s"])
        log(f"service batched: {server.batches} batches of "
            f"{rep['batched']['mean_batch']:.1f} on average, "
            f"{rep['batched']['search_ms_per_batch']:.2f} ms of search a "
            f"batch ({rep['batched']['search_share_of_wall']:.3f} of the "
            f"wall)")
        if rep["batched"]["recall"] < COLLECTION_FLOOR or rep["batched"][
                "wrong_documents"]:
            raise AssertionError(f"service batched mode: {rep['batched']}")

        rng = np.random.default_rng(18)
        new = cluster_rows(rng, SERVICE_INSERT, N)
        new_ids = [SERVICE_ID0 + i for i in range(SERVICE_INSERT)]

        def step(name, route, payload, want=200):
            launches.zero()
            status, res, steps[name], _ = http_post(conn, route,
                                                    json.dumps(payload))
            launches.read(name)
            if status != want:
                raise AssertionError(f"service {name}: status {status} "
                                     f"{res}")
            return res

        step("insert", "insert", {"collection_name": "docs", "items": [
            [new_ids[i], f"svc {i}", new[i].tolist(), {"shard": -2}]
            for i in range(SERVICE_INSERT)]})
        res = step("insert_own_query", "query", json.loads(query_body(new, 1)))
        rep["insert_own_top1"] = float(np.mean(
            [r[:1] == [i] for r, i in zip(res["id"], new_ids)]))
        moved = cluster_rows(rng, SERVICE_UPSERT, N)
        step("upsert", "upsert", {"collection_name": "docs", "items": [
            [new_ids[i], f"svc moved {i}", moved[i].tolist(), {"shard": -2}]
            for i in range(SERVICE_UPSERT)]})
        res = step("upsert_query", "query", json.loads(query_body(moved, 1)))
        rep["upsert_own_documents"] = float(np.mean(
            [d[:1] == [f"svc moved {i}"] for i, d in enumerate(
                res["document"])]))
        gone = new_ids[SERVICE_UPSERT:SERVICE_UPSERT + SERVICE_DELETE]
        step("delete_by_id", "delete_by_id", {"collection_name": "docs",
                                              "ids": gone})
        res = step("delete_query", "query", json.loads(query_body(
            new[SERVICE_UPSERT:SERVICE_UPSERT + SERVICE_DELETE])))
        rep["deleted_returned"] = sum(i in set(gone) for r in res["id"]
                                      for i in r)
        step("delete_by_filter", "delete_by_filter", {
            "collection_name": "docs",
            "filter": {"shard": SERVICE_DEAD_SHARD}})
        col = app.client.get_collection("docs")
        rep["shard_rows_left"] = sum(
            md.get("shard") == SERVICE_DEAD_SHARD for md in col._cols["metadata"])
        step("save", "save", {"collection_name": "docs"})
        step("missing", "query", {"collection_name": "nope",
                                  "query_vector": [[0.0] * DIM], "limit": 1},
             want=404)
    finally:
        conn.close()
        srv.shutdown()
        srv.server_close()
        for s in list(app._servers.values()):
            s.close()
    rep["launches"] = launches.steps
    log(f"service mutations over HTTP: insert own top-1 "
        f"{rep['insert_own_top1']:.4f}, upserted documents "
        f"{rep['upsert_own_documents']:.4f}, deleted returned "
        f"{rep['deleted_returned']}, shard rows left "
        f"{rep['shard_rows_left']}; seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in steps.items()))
    if (rep["insert_own_top1"] < CHURN_FLOOR
            or rep["upsert_own_documents"] < CHURN_FLOOR
            or rep["deleted_returned"] or rep["shard_rows_left"]):
        raise AssertionError(f"service mutations failed: {rep}")
    if launches.steps["insert"]["gather_estimate"] <= 0:
        raise AssertionError("the service's insert launched its shadow "
                             "search no time")
    return rep


def flat_sq4_phase(torch, ds, gt) -> dict:
    """Phase 19: flat + sq4 on the 1M rows: fit, one exact search of the
    queries (the raw rows scanned through l2_tile; recall@10 ≥
    FLAT_EXACT_FLOOR), insert 1,000 rows (each its own top-1), remove
    10,000 (none may come back), save and load (the same ids and codes)."""
    from alayalite_tpu_torch import Client
    from alayalite_tpu_torch.utils.evaluate import calc_recall

    launches = Launches(new_counters())
    rng = np.random.default_rng(19)
    n = ds.data.shape[0]
    idx = Client().create_index("flat_sq4", index_type="flat",
                                quantization_type="sq4",
                                capacity=n + FLAT_SQ4_INSERT)
    launches.zero()
    _, fit_s = synced(torch, lambda: idx.fit(ds.data))
    launches.read("fit")
    idx.batch_search(ds.queries, K)
    launches.zero()
    (ids, dist), wall = synced(torch, lambda: idx.batch_search_with_distance(
        ds.queries, K))
    got = launches.read("search")
    check_result(ids, dist, n, "flat sq4")
    rep = {"fit_s": fit_s, "recall": calc_recall(ids, gt),
           "qps": ds.queries.shape[0] / wall, "search_wall_s": wall,
           "codes_bytes": int(idx._engine.search_space.codes.numel())}
    new = cluster_rows(rng, FLAT_SQ4_INSERT, n)
    launches.zero()
    new_ids, rep["insert_s"] = synced(torch, lambda: idx.insert(new))
    launches.read("insert")
    rep["own_top1"] = float((idx.batch_search(new, 1)[:, 0] == new_ids).mean())
    dead = rng.choice(n, size=FLAT_SQ4_REMOVE, replace=False)
    launches.zero()
    _, rep["remove_s"] = synced(torch, lambda: idx.remove(dead))
    after = idx.batch_search(ds.queries, K)
    launches.read("remove_search")
    rep["removed_returned"] = int(np.isin(after, dead).sum())
    back, rep["save_s"], rep["load_s"] = save_and_load(torch, idx, "flat_sq4")
    rep["same_ids_after_load"] = bool(
        (back.batch_search(ds.queries, K) == after).all())
    rep["same_codes_after_load"] = bool(torch.equal(
        back._engine.search_space.codes, idx._engine.search_space.codes))
    rep["launches"] = launches.steps
    log(f"flat sq4 1M: fit {fit_s:.2f}s, recall@10 {rep['recall']:.4f}, "
        f"{rep['qps']:.1f} QPS, insert own top-1 {rep['own_top1']:.4f}, "
        f"{rep['removed_returned']} removed returned, save "
        f"{rep['save_s']:.2f}s load {rep['load_s']:.2f}s, same ids "
        f"{rep['same_ids_after_load']}, same codes "
        f"{rep['same_codes_after_load']}; launches {launches.steps}")
    if (rep["recall"] < FLAT_EXACT_FLOOR or rep["own_top1"] < 0.999
            or rep["removed_returned"] or not rep["same_ids_after_load"]
            or not rep["same_codes_after_load"] or got["l2_tile"] <= 0):
        raise AssertionError(f"flat sq4 phase failed: {rep}")
    return rep


def rag_documents(rng, n: int, chars: int) -> list:
    """``n`` documents of about ``chars`` characters of random words."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["".join(rng.choice(letters, size=rng.integers(3, 11)))
             for _ in range(5000)]
    docs = []
    for _ in range(n):
        words = rng.choice(len(vocab), size=chars // 5)
        docs.append(" ".join(vocab[w] for w in words)[:chars])
    return docs


def native_rag_phase(torch, ds, path: str) -> dict:
    """Phase 20: the native runtime must load; the 1M x 128 rows written
    with save_fvecs to ``path`` (phase 24 reads it again) and read by
    load_fvecs (through the native loader) and by the numpy loader must be
    the same array. Then RAG: generated
    documents cut by FixedSizeChunker, embedded by HashingEmbedding,
    inserted into a cos collection on the card; chunks' own texts queried,
    each its own top-1 (RAG_FLOOR)."""
    from alayalite_tpu_torch import Client, native
    from alayalite_tpu_torch.rag import FixedSizeChunker, HashingEmbedding
    from alayalite_tpu_torch.utils import io as vio

    if native.get_lib() is None:
        raise AssertionError("the native library did not build or load")
    rep = {"native_lib": str(native.lib_path().relative_to(ROOT))}
    _, rep["save_fvecs_s"] = synced(torch, lambda: vio.save_fvecs(
        path, ds.data))
    nat, rep["load_fvecs_native_s"] = synced(torch, lambda: vio.load_fvecs(
        path))
    ref, rep["load_fvecs_numpy_s"] = synced(torch, lambda: vio._load_vecs(
        path, np.dtype(np.float32)))
    direct = native.load_vecs_native(path)
    rep["native_equals_numpy"] = bool(np.array_equal(nat, ref)
                                      and np.array_equal(direct, ref)
                                      and np.array_equal(ref, ds.data))
    rep["file_bytes"] = os.path.getsize(path)
    del nat, ref, direct
    log(f"native: {rep['native_lib']}; fvecs of {rep['file_bytes']} B: "
        f"save {rep['save_fvecs_s']:.2f}s, native load "
        f"{rep['load_fvecs_native_s']:.3f}s, numpy load "
        f"{rep['load_fvecs_numpy_s']:.3f}s, same array "
        f"{rep['native_equals_numpy']}")
    if not rep["native_equals_numpy"]:
        raise AssertionError("the native loader's array differs from numpy's")

    launches = Launches(new_counters())
    rng = np.random.default_rng(20)
    docs = rag_documents(rng, RAG_DOCS, RAG_DOC_CHARS)
    chunks, chunk_s = synced(torch, lambda: FixedSizeChunker().chunk_many(docs))
    emb = HashingEmbedding(dim=RAG_DIM)
    vecs, embed_s = synced(torch, lambda: emb.embed(chunks))
    col = Client().create_collection("rag", metric="cos",
                                     capacity=len(chunks))
    items = [(f"c{i}", c, vecs[i], {"doc": i}) for i, c in enumerate(chunks)]
    launches.zero()
    _, insert_s = synced(torch, lambda: col.insert(items))
    launches.read("insert")
    pick = rng.choice(len(chunks), size=RAG_QUERIES, replace=False)
    q = emb.embed([chunks[i] for i in pick])
    launches.zero()
    res, query_s = synced(torch, lambda: col.batch_query(q, 1, ef_search=64))
    got = launches.read("query")
    own = float(np.mean([r[:1] == [f"c{i}"] for r, i in zip(res["id"], pick)]))
    rep["rag"] = {"documents": RAG_DOCS, "chunks": len(chunks),
                  "chunk_s": chunk_s, "embed_s": embed_s,
                  "chunks_per_s_embedded": len(chunks) / embed_s,
                  "insert_s": insert_s,
                  "items_per_s_inserted": len(chunks) / insert_s,
                  "query_s": query_s, "own_top1": own}
    rep["launches"] = launches.steps
    log(f"rag: {RAG_DOCS} documents -> {len(chunks)} chunks in "
        f"{chunk_s:.2f}s, embedded at {len(chunks) / embed_s:.1f} chunks/s, "
        f"inserted at {len(chunks) / insert_s:.1f} items/s, own top-1 "
        f"{own:.4f} over {RAG_QUERIES} chunks; launches {launches.steps}")
    if own < RAG_FLOOR or got["pool_merge"] <= 0:
        raise AssertionError(f"rag phase failed: {rep['rag']}, {got}")
    return rep


# ---- multi-device on one card (phases 21-24) ----
def shard_modes(dev, n: int):
    """The two device lists of a sharded phase: the real one ("fallback":
    one card, so the per-shard search with a host merge) and ``n`` virtual
    copies of the card ("mesh")."""
    import contextlib

    from alayalite_tpu_torch.utils import platforms

    return {"fallback": contextlib.nullcontext,
            "mesh": lambda: platforms.force_devices(n, dev.type)}


def distance_mismatches(torch, dev, data, queries, ids, dist):
    """Returned distances against direct f32 distances of the returned
    rows: (mismatches, worst error in eps·(|q|² + |x|²)). The expansion
    |q|² + |x|² − 2 q·x rounds sums near |q|² + |x|², so the error scales
    with that magnitude: allowed 1e-4·d + 2·sqrt(D)·eps·(|q|² + |x|²)."""
    bad, worst = 0, 0.0
    xd = torch.as_tensor(data, device=dev)
    for lo in range(0, queries.shape[0], 1024):
        qd = torch.as_tensor(queries[lo:lo + 1024], device=dev)
        rows = xd[torch.as_tensor(ids[lo:lo + 1024], device=dev).long()]
        ref = ((rows - qd[:, None, :]) ** 2).sum(-1)
        ulps = float(torch.finfo(torch.float32).eps) * (
            (qd * qd).sum(1)[:, None] + (rows * rows).sum(-1))
        err = (torch.as_tensor(dist[lo:lo + 1024], device=dev) - ref).abs()
        bad += int((err > 1e-4 * ref + 2 * data.shape[1] ** 0.5 * ulps).sum())
        worst = max(worst, float((err / ulps).max()))
    return bad, worst


def sharded_searches(torch, dev, idx, queries, gt, efs, launches, step: str,
                     need=("gather_estimate", "ring_probe", "pool_merge",
                           "unique_topk")) -> tuple:
    """Each ef searched in both device modes (a warm-up call, then the
    counts set to 0 and one synchronised call): ({mode: {ef: numbers}},
    {mode: ids at the last ef}). Fails where a mode took the other path or
    a kernel of ``need`` was launched no time."""
    from alayalite_tpu_torch.utils.evaluate import calc_recall

    eng = idx._engine
    rep, last = {}, {}
    for mode, ctx in shard_modes(dev, eng.ndb).items():
        rep[mode] = {}
        with ctx():
            if (eng._mesh() is not None) != (mode == "mesh"):
                raise AssertionError(f"{step}: {mode} took the other path")
            for ef in efs:
                idx.batch_search(queries, K, ef_search=ef)
                launches.zero()
                (ids, dist), wall = synced(
                    torch, lambda: idx.batch_search_with_distance(
                        queries, K, ef_search=ef))
                got = launches.read(f"{step}_{mode}_ef{ef}")
                check_result(ids, dist, eng.capacity, f"{step} {mode} ef={ef}")
                rec = calc_recall(ids, gt)
                rep[mode][ef] = {"recall": rec, "wall_s": wall,
                                 "qps": queries.shape[0] / wall,
                                 "launches": {k: got[k] for k in need}}
                log(f"{step} {mode} ef={ef}: recall@10 {rec:.4f}, "
                    f"{queries.shape[0] / wall:.1f} QPS (wall {wall:.3f}s), "
                    f"launches {rep[mode][ef]['launches']}")
                if min(got[k] for k in need) <= 0:
                    raise AssertionError(f"{step} {mode}: a kernel was "
                                         f"launched no time: {got}")
                last[mode] = ids
    return rep, last


def db_shards_phase(torch, dev, ds, gt) -> dict:
    """Phase 21: hnsw + bsq8 (phase 4's parameters) with db_shards=4 on the
    1M rows through the Client, searched in both device modes at EFS; an
    insert of DB_INSERT rows from the data's clusters (new ids past the
    fitted rows, own top-1 at ef 64 ≥ CHURN_FLOOR, the new blocks audited
    through block_diagdot), DB_REMOVE removes (none may come back),
    compact, save / load (the same ids in both modes); then flat exact
    with db_shards=4 (recall ≥ FLAT_EXACT_FLOOR, distances against direct
    f32 distances, the same ids in both modes)."""
    from alayalite_tpu_torch import Client
    from alayalite_tpu_torch.utils.evaluate import calc_recall

    launches = Launches(new_counters())
    rng = np.random.default_rng(21)
    n = ds.data.shape[0]
    idx = Client(device=dev).create_index(
        "db4", index_type="hnsw", quantization_type="bsq8", max_nbrs=32,
        ef_construction=200, prune_alpha=1.2, seed_sample=16384,
        beam_expand=8, db_shards=DB_SHARDS, capacity=n + SPARE)
    launches.zero()
    _, fit_s = synced(torch, lambda: idx.fit(ds.data))
    launches.read("fit")
    eng = idx._engine
    rep = {"fit_s": fit_s, "shard_fit_s": list(eng.fit_seconds),
           "shard_rows": [sh.space.num for sh in eng.shards],
           "shard_capacity": [sh.space.capacity for sh in eng.shards]}
    log(f"db_shards: fit {n} rows over {DB_SHARDS} shards in {fit_s:.2f}s "
        f"(per shard {[round(x, 2) for x in rep['shard_fit_s']]}s, rows "
        f"{rep['shard_rows']}), launches {launches.steps['fit']}")
    rep["search"], _ = sharded_searches(torch, dev, idx, ds.queries, gt, EFS,
                                        launches, "bsq8")
    for mode, by_ef in rep["search"].items():
        if by_ef[64]["recall"] < RECALL_FLOOR:
            raise AssertionError(f"db_shards {mode}: recall@10 at ef 64 "
                                 f"below {RECALL_FLOOR}")

    new = cluster_rows(rng, DB_INSERT, n)
    launches.zero()
    new_ids, rep["insert_s"] = synced(torch, lambda: idx.insert(new))
    own = float((idx.batch_search(new, 1, ef_search=64)[:, 0]
                 == new_ids).mean())
    launches.read("insert")
    ss, ll = eng._gid_map.lookup(new_ids)
    s0 = ss == ss[0]
    launches.zero()
    rep["audit"] = audit_blocks(
        torch, eng.shards[int(ss[0])].search_space,
        torch.as_tensor(new[s0], device=dev), ll[s0])
    rep["audit"]["block_diagdot_launches"] = launches.read("audit")[
        "block_diagdot"]
    rep.update(own_top1=own, new_ids=[int(new_ids.min()),
                                      int(new_ids.max())])
    log(f"db_shards: inserted {DB_INSERT} rows in {rep['insert_s']:.2f}s as "
        f"ids {rep['new_ids']}, own top-1 {own:.4f}; block audit "
        f"{rep['audit']}")
    if (new_ids.min() < n or own < CHURN_FLOOR
            or rep["audit"]["estimate_excess"] > 0
            or rep["audit"]["block_diagdot_launches"] <= 0):
        raise AssertionError(f"db_shards insert failed: {rep}")

    dead = rng.choice(n, size=DB_REMOVE, replace=False)
    launches.zero()
    _, rep["remove_s"] = synced(torch, lambda: idx.remove(dead))
    _, rep["compact_s"] = synced(torch, eng.compact)
    launches.read("remove_compact")
    before = {}
    for mode, ctx in shard_modes(dev, DB_SHARDS).items():
        with ctx():
            before[mode] = idx.batch_search(ds.queries, K, ef_search=64)
    rep["removed_returned"] = {m: int(np.isin(i, dead).sum())
                               for m, i in before.items()}
    back, rep["save_s"], rep["load_s"] = save_and_load(torch, idx, "db4")
    rep["same_ids_after_load"] = {}
    for mode, ctx in shard_modes(dev, DB_SHARDS).items():
        with ctx():
            rep["same_ids_after_load"][mode] = bool(
                (back.batch_search(ds.queries, K, ef_search=64)
                 == before[mode]).all())
    log(f"db_shards: remove {rep['remove_s']:.2f}s, compact "
        f"{rep['compact_s']:.2f}s, removed ids returned "
        f"{rep['removed_returned']}, save {rep['save_s']:.2f}s, load "
        f"{rep['load_s']:.2f}s, same ids after load "
        f"{rep['same_ids_after_load']}")
    if (any(rep["removed_returned"].values())
            or not all(rep["same_ids_after_load"].values())):
        raise AssertionError(f"db_shards churn or save / load failed: {rep}")
    del idx, back, eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    flat = Client(device=dev).create_index("db4_flat", index_type="flat",
                                           db_shards=DB_SHARDS, capacity=n)
    launches.zero()
    _, rep["flat_fit_s"] = synced(torch, lambda: flat.fit(ds.data))
    launches.read("flat_fit")
    rep["flat"], ids = sharded_searches(torch, dev, flat, ds.queries, gt,
                                        (K,), launches, "flat",
                                        need=("l2_tile",))
    rep["flat_same_ids"] = bool((ids["fallback"] == ids["mesh"]).all())
    _, dist = flat.batch_search_with_distance(ds.queries, K)
    rep["flat_distance_mismatches"], rep["flat_worst_error_eps"] = (
        distance_mismatches(torch, dev, ds.data, ds.queries, ids["fallback"],
                            dist))
    log(f"db_shards flat: fit {rep['flat_fit_s']:.2f}s, same ids in both "
        f"modes {rep['flat_same_ids']}, distance mismatches "
        f"{rep['flat_distance_mismatches']} (worst "
        f"{rep['flat_worst_error_eps']:.2f} eps·(|q|² + |x|²))")
    if (min(r[K]["recall"] for r in rep["flat"].values()) < FLAT_EXACT_FLOOR
            or not rep["flat_same_ids"] or rep["flat_distance_mismatches"]):
        raise AssertionError(f"db_shards flat failed: {rep['flat']}")
    rep["launches"] = launches.steps
    return rep


def graph_recalls(torch, idx, queries, gt, efs, launches, step: str) -> dict:
    from alayalite_tpu_torch.utils.evaluate import calc_recall

    out = {}
    for ef in efs:
        idx.batch_search(queries, K, ef_search=ef)
        launches.zero()
        (ids, dist), wall = synced(torch, lambda: idx.batch_search_with_distance(
            queries, K, ef_search=ef))
        got = launches.read(f"{step}_ef{ef}")
        check_result(ids, dist, idx._engine.capacity, f"{step} ef={ef}")
        out[ef] = {"recall": calc_recall(ids, gt), "wall_s": wall,
                   "qps": queries.shape[0] / wall,
                   "launches": {k: got[k] for k in POOL_KERNELS}}
        log(f"{step} ef={ef}: recall@10 {out[ef]['recall']:.4f}, "
            f"{out[ef]['qps']:.1f} QPS, launches {out[ef]['launches']}")
    return out


def build_shards_phase(torch, dev) -> dict:
    """Phase 22: results/sharded_build_100k.json's data and index with
    build_shards=8 under force_devices(8, the card): build seconds by phase,
    recall@10 at ef 48 / 64 / 96 (BUILD_FLOORS), the single-device control
    on the same data; sort_kv launched by the build, pool_merge by the
    searches of the built graph."""
    from alayalite_tpu_torch import Client
    from alayalite_tpu_torch.utils import platforms
    from alayalite_tpu_torch.utils.datasets import random_dataset

    launches = Launches(new_counters())
    ds = random_dataset(**BUILD_DATA)
    gt = ground_truth(torch, torch.as_tensor(ds.data, device=dev),
                      torch.as_tensor(ds.queries, device=dev), K)
    n = ds.data.shape[0]
    rep = {}
    for name, shards in (("sharded", BUILD_SHARDS), ("single", 1)):
        with platforms.force_devices(shards, dev.type):
            idx = Client(device=dev).create_index(
                f"build_{name}", capacity=n, build_shards=shards,
                **BUILD_PARAMS)
            launches.zero()
            _, fit_s = synced(torch, lambda: idx.fit(ds.data))
            got = launches.read(f"{name}_fit")
            rep[name] = {"fit_s": fit_s,
                         "fit_phases": dict(idx._engine.build_timings),
                         "fit_launches": {k: got[k] for k in POOL_KERNELS}}
            log(f"build_shards {name}: fit {fit_s:.2f}s, phases "
                f"{rep[name]['fit_phases']}, launches "
                f"{rep[name]['fit_launches']}")
            rep[name]["search"] = graph_recalls(
                torch, idx, ds.queries, gt, BUILD_FLOORS, launches,
                f"build_{name}")
        del idx
    sharded = rep["sharded"]
    # the ring build's merges are sort-dedups (sort_kv), as the single
    # device NN-Descent's: it launches no pool_merge, which the searches of
    # the built graph launch on every hop; each is checked on its own run
    search_merges = sum(s["launches"]["pool_merge"]
                        for s in sharded["search"].values())
    if (any(sharded["search"][ef]["recall"] < f
            for ef, f in BUILD_FLOORS.items())
            or sharded["fit_launches"]["sort_kv"] <= 0
            or search_merges <= 0):
        raise AssertionError(f"build_shards phase failed: {rep}")
    rep["launches"] = launches.steps
    return rep


def serve_shards_phase(torch, dev, small) -> dict:
    """Phase 23: serve_shards=4 on phase 6d's data with the defaults under
    force_devices(4, the card): fit seconds (the sharded build's phases,
    the repair rounds and their unreached counts), recall@10 at SERVE_EFS
    against a single-device fit of the same parameters (SERVE_FLOOR,
    SERVE_SLACK), each shard holding a quarter of the padded rows; ids
    0..999 removed (none may come back, and the last 1,000 rows must still
    find themselves: the JAX package bounds ids by the live count and loses
    them); save / load (the same ids); ring_probe and pool_merge
    launched."""
    from alayalite_tpu_torch import Client
    from alayalite_tpu_torch.utils import platforms

    launches = Launches(new_counters())
    gt = ground_truth(torch, torch.as_tensor(small.data, device=dev),
                      torch.as_tensor(small.queries, device=dev), K)
    n = small.data.shape[0]
    rep = {}
    single = Client(device=dev).create_index("serve_single", capacity=n)
    launches.zero()
    _, rep["single_fit_s"] = synced(torch, lambda: single.fit(small.data))
    launches.read("single_fit")
    rep["single"] = graph_recalls(torch, single, small.queries, gt,
                                  SERVE_EFS, launches, "serve_single")
    del single
    with platforms.force_devices(SERVE_SHARDS, dev.type):
        idx = Client(device=dev).create_index(
            "serve4", capacity=n, serve_shards=SERVE_SHARDS)
        launches.zero()
        _, rep["fit_s"] = synced(torch, lambda: idx.fit(small.data))
        launches.read("fit")
        eng = idx._engine
        rep["fit_phases"] = dict(eng.build_timings)
        rep["repair_rounds_unreached_components"] = eng.repair_rounds
        rows = [x.shape[0] for x in eng._data_sh]
        rep["shard_rows"], rep["padded_rows"] = rows, eng._npad
        log(f"serve_shards: fit {rep['fit_s']:.2f}s, phases "
            f"{rep['fit_phases']}, repair rounds (unreached, components) "
            f"{eng.repair_rounds}, shard rows {rows} of {eng._npad}")
        rep["search"] = graph_recalls(torch, idx, small.queries, gt,
                                      SERVE_EFS, launches, "serve4")
        ef = SERVE_EFS[-1]
        dead = np.arange(SERVE_REMOVE)
        launches.zero()
        idx.remove(dead)
        after = idx.batch_search(small.queries, K, ef_search=ef)
        tail = idx.batch_search(small.data[n - SERVE_REMOVE:], 1,
                                ef_search=ef)[:, 0]
        launches.read("remove_search")
        rep["removed_returned"] = int(np.isin(after, dead).sum())
        rep["tail_own_top1"] = float(
            (tail == np.arange(n - SERVE_REMOVE, n)).mean())
        back, rep["save_s"], rep["load_s"] = save_and_load(torch, idx,
                                                           "serve4")
        rep["same_ids_after_load"] = bool(
            (back.batch_search(small.queries, K, ef_search=ef) == after).all())
        del back, idx, eng
    log(f"serve_shards: removed returned {rep['removed_returned']}, last "
        f"{SERVE_REMOVE} rows own top-1 {rep['tail_own_top1']:.4f}, save "
        f"{rep['save_s']:.2f}s load {rep['load_s']:.2f}s, same ids "
        f"{rep['same_ids_after_load']}")
    ef = SERVE_EFS[-1]
    got = rep["search"][ef]
    if (got["recall"] < SERVE_FLOOR
            or got["recall"] < rep["single"][ef]["recall"] - SERVE_SLACK
            or any(r != rows[0] or r * SERVE_SHARDS != rep["padded_rows"]
                   for r in rows)
            or rep["removed_returned"] or rep["tail_own_top1"] < CHURN_FLOOR
            or not rep["same_ids_after_load"]
            or min(got["launches"][k] for k in ("ring_probe", "pool_merge"))
            <= 0):
        raise AssertionError(f"serve_shards phase failed: {rep}")
    rep["launches"] = launches.steps
    return rep


def multihost_phase(torch, dev, ds, path: str) -> dict:
    """Phase 24 on phase 20's fvecs file of the 1M rows: probe_vecs, the
    ranged reads of the 4 shards' rows (equal to the array's), the padded
    per-shard blocks of load_vecs_global on 4 virtual copies of the card,
    fit_shards_from_file into a flat db_shards=4 index (its ids those of an
    array-fed fit), then maybe_distributed_init with a one-rank group from
    ALAYA_* on 127.0.0.1 (NCCL on the card), one all_gather of a device
    tensor, destroy_process_group."""
    import socket

    import torch.distributed as dist

    from alayalite_tpu_torch import Client
    from alayalite_tpu_torch.parallel import (fit_shards_from_file,
                                              load_vecs_global,
                                              load_vecs_rows,
                                              maybe_distributed_init,
                                              probe_vecs)
    from alayalite_tpu_torch.parallel.build_sharded import make_build_mesh
    from alayalite_tpu_torch.parallel.multihost import process_row_range
    from alayalite_tpu_torch.utils import platforms

    launches = Launches(new_counters())
    n = ds.data.shape[0]
    rep = {"probe": list(probe_vecs(path))}
    ranged, rep["ranged_read_s"] = synced(torch, lambda: [
        load_vecs_rows(path, *process_row_range(n, MH_SHARDS, s))
        for s in range(MH_SHARDS)])
    rep["ranged_equal"] = all(
        np.array_equal(r, ds.data[slice(*process_row_range(n, MH_SHARDS, s))])
        for s, r in enumerate(ranged))
    del ranged
    with platforms.force_devices(MH_SHARDS, dev.type):
        parts, n_file = load_vecs_global(path, make_build_mesh(MH_SHARDS))
    rows = -(-n // MH_SHARDS)
    rep["global_equal"] = bool(n_file == n and all(
        p.shape[0] == rows and p.device.type == dev.type for p in parts)
        and np.array_equal(torch.cat(parts).cpu().numpy()[:n], ds.data))
    del parts
    client = Client(device=dev)
    from_file = client.create_index("mh_file", index_type="flat",
                                    db_shards=MH_SHARDS, capacity=n)
    launches.zero()
    _, rep["file_fit_s"] = synced(torch, lambda: fit_shards_from_file(
        from_file._engine, path))
    ids_file = from_file.batch_search(ds.queries, K)
    launches.read("file_fit_search")
    del from_file
    from_array = client.create_index("mh_array", index_type="flat",
                                     db_shards=MH_SHARDS, capacity=n)
    from_array.fit(ds.data)
    rep["file_ids_equal"] = bool(
        (from_array.batch_search(ds.queries, K) == ids_file).all())
    del from_array
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = {"ALAYA_COORDINATOR": f"127.0.0.1:{port}",
           "ALAYA_NUM_PROCESSES": "1", "ALAYA_PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        started, rep["dist_init_s"] = synced(
            torch, lambda: maybe_distributed_init(timeout_s=120))
        rep["backend"] = dist.get_backend()
        x = torch.arange(4, dtype=torch.float32, device=dev)
        out = [torch.zeros_like(x)]
        dist.all_gather(out, x)
        rep["all_gather_equal"] = bool(started and torch.equal(out[0], x))
        dist.destroy_process_group()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    rep["launches"] = launches.steps
    log(f"multihost: probe {rep['probe']}, ranged reads equal "
        f"{rep['ranged_equal']} in {rep['ranged_read_s']:.2f}s, "
        f"load_vecs_global equal {rep['global_equal']}, file-fed fit "
        f"{rep['file_fit_s']:.2f}s with the array-fed ids "
        f"{rep['file_ids_equal']}, {rep['backend']} group in "
        f"{rep['dist_init_s']:.2f}s, all_gather equal "
        f"{rep['all_gather_equal']}")
    if not (rep["probe"] == [n, DIM] and rep["ranged_equal"]
            and rep["global_equal"] and rep["file_ids_equal"]
            and rep["all_gather_equal"]):
        raise AssertionError(f"multihost phase failed: {rep}")
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
    # the native host runtime (g++, build/native/): the serving queue and
    # the vecs loader of phases 17, 18 and 20; no silent numpy fallback
    from alayalite_tpu_torch import native

    lib, report["native_build_s"] = synced(torch, native.get_lib)
    if lib is None:
        raise AssertionError("the native library did not build or load")
    log(f"native: {native.lib_path().name} in {report['native_build_s']:.2f}s")

    report["block_diagdot"] = check_diagdot(torch, dev)
    report.update(check_gather(torch, dev))
    report["ring_probe"] = check_ring_probe(torch, dev)
    report.update(check_pool_sort(torch, dev))
    report["sq8_gather"] = check_sq8_gather(torch, dev)
    report["seed_scan"] = check_seed_scan(torch, dev)
    report["unique_topk"] = check_unique_topk(torch, dev)
    report["tile_topk"] = check_tile_topk(torch, dev)
    report["gather_dot"] = check_gather_dot(torch, dev)
    # the kernels of every block hop, and the hops (estimate_many calls)
    hop = (gather_estimate, ring_probe,
           CallCount(gather_estimate, "estimate_many_calls"))
    # pool_merge, sort_kv, tile_topk, the launches by kernel of pool_merge,
    # sort_kv and ring_probe, and tile_topk's wide route calls
    pool = (*pool_counters()[:3], *pool_counters()[5:])
    from alayalite_tpu_torch.ops.gather_dot import gather_dot
    from alayalite_tpu_torch.ops.seed_scan import seed_scan
    from alayalite_tpu_torch.ops.unique_topk import unique_topk

    t = time.time()
    # bench.py's synthetic SIFT1M stand-in: one cluster per 2000 rows
    ds = random_dataset(n=N, dim=DIM, n_queries=NQ, seed=42,
                        clusters=max(32, N // 2000))
    log(f"data: {N}x{DIM}, {NQ} queries in {time.time() - t:.1f}s")
    client = Client()
    idx = client.create_index("smoke", **BSQ8_PARAMS)
    for c in (block_diagdot, l2_tile, sq8_tile, *hop, *pool):
        c.launches = 0
    from alayalite_tpu_torch.index import captured

    base = fit_memory_base(torch)
    s0 = dict(captured.stats)
    t = time.time()
    idx.fit(ds.data)
    torch.cuda.synchronize()
    fit_s = time.time() - t
    fit_graphs = {"graphs_captured": captured.stats["captures"]
                  - s0["captures"],
                  "capture_s": captured.stats["capture_s"] - s0["capture_s"],
                  "peak_reserved_gib": torch.cuda.max_memory_reserved()
                  / 2**30,
                  "memory": fit_memory(torch, base, "captured bsq8 fit")}
    fit_launches = {c.__name__: c.launches for c in hop}
    # the pool kernels' launches on the bsq8 path, summed phase by phase
    bsq8_pool = {c.__name__: c.launches for c in pool}
    timings = idx._engine.build_timings
    log(f"fit: {fit_s:.2f}s, phases "
        + ", ".join(f"{k}={v:.2f}s" for k, v in timings.items())
        + f", launches {fit_launches}, l2_tile launches "
        f"{l2_tile.launches} (find_medoid), peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, peak reserved "
        f"{fit_graphs['peak_reserved_gib']:.2f} GiB, "
        f"{fit_graphs['graphs_captured']} graphs captured in "
        f"{fit_graphs['capture_s']:.3f} s")
    if min(fit_launches.values()) <= 0:
        raise AssertionError("the fit launched a hop kernel no time")
    report["fit"] = {"seconds": fit_s, "phases": timings, **fit_graphs,
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
            torch, idx, ds.queries, K, (*hop, *pool, unique_topk, gather_dot),
            ef_search=ef)
        for c in pool:
            bsq8_pool[c.__name__] += launches[c.__name__]
        for kernel in search_launches:
            search_launches[kernel] += launches[kernel]
        check_result(ids, dist, N, f"bsq8 ef={ef}")
        rec = calc_recall(ids, gt)
        log(f"search ef={ef}: recall@10 {rec:.4f}, {NQ / wall:.1f} QPS "
            f"(wall {wall:.3f}s), launches {launches}")
        # the final selection is unique_topk's: a block search sorts no
        # list with sort_kv
        if min(launches[k] for k in (*search_launches, "pool_merge",
                                     "unique_topk")) <= 0:
            raise AssertionError("the search launched a hop kernel no time")
        if launches["gather_estimate"] != launches["estimate_many_calls"]:
            raise AssertionError("a hop's estimate_many did not launch "
                                 "gather_estimate exactly once")
        # the exact distances of a slice's seeds and of its final pool
        if launches["gather_dot"] != 2 * launches["unique_topk"]:
            raise AssertionError(f"the exact distances did not launch "
                                 f"gather_dot twice a slice: {launches}")
        report["search"][ef] = {"recall": rec, "qps": NQ / wall,
                                "wall_s": wall, "launches": launches}
        report["estimate_many"][f"launches_per_hop_ef{ef}"] = (
            launches["gather_estimate"] / launches["estimate_many_calls"])
    if report["search"][64]["recall"] < RECALL_FLOOR:
        raise AssertionError(f"recall@10 at ef=64 below {RECALL_FLOOR}")
    # phase 25 on the 1M bsq8 index (its raw hnsw and rabitq cases run in
    # phases 6c and 15)
    qd = torch.as_tensor(ds.queries, device=dev)
    report["captured"] = {
        "bsq8": {ef: engine_case(torch, f"bsq8 1M ef {ef}", idx, qd, ef,
                                 card) for ef in CAPTURE_EFS},
        "bsq8_pool_chunk": pool_chunk_case(torch, idx, card)}
    del qd
    # phase 17 on the fitted index, before the churn of phase 6b
    report["serving"] = serving_phase(torch, idx, ds.queries, gt)
    report["captured"]["serving"] = closed_loop_case(torch, idx, ds.queries,
                                                     gt, card)
    # phase 26 on the fitted index, before the churn of phase 6b
    report["captured_build"], handoff = build_capture_phase(
        torch, ds, card, idx, report["fit"]["memory"])
    # phase 27 on phase 26's recorded inputs
    report["captured_knn_repair"] = knn_repair_phase(torch, *handoff, card)
    del handoff
    report["captured"]["bsq8_insert"] = insert_case(
        torch, f"bsq8 insert slice ({INSERT_ROWS} rows)", idx._engine,
        insert_rows(N, INSERT_ROWS, 26), card)

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
    report["gist"] = gist_phase(torch, dev, (*hop, *pool, unique_topk,
                                             gather_dot, seed_scan))
    gc.collect()
    torch.cuda.empty_cache()

    report["raw"] = raw_graph_phases(torch, dev, ds, gt)
    report["captured"]["raw_hnsw"] = report["raw"]["hnsw_1m"]["captured"]
    report["captured"]["raw_insert"] = report["raw"]["hnsw_1m"]["churn"][
        "captured_insert"]

    report["tiles"] = check_tiles(torch, dev)
    report["flat"] = flat_phases(torch, dev, ds, gt)
    gc.collect()
    torch.cuda.empty_cache()
    report["flat_sq4"] = flat_sq4_phase(torch, ds, gt)
    gc.collect()
    torch.cuda.empty_cache()

    # phase 18 serves the directory phase 12 saved
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    try:
        report["collection"], handoff = collection_phase(torch, ds, root)
        gc.collect()
        torch.cuda.empty_cache()
        report["service"] = service_phase(torch, root, *handoff, ds.queries)
        del handoff
    finally:
        shutil.rmtree(root, ignore_errors=True)
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
    report["captured"]["rabitq"] = report["rabitq"]["captured"]
    gc.collect()
    torch.cuda.empty_cache()
    gt_small = ground_truth(torch, torch.as_tensor(small.data, device=dev),
                            torch.as_tensor(small.queries, device=dev), K)
    report["rabitq2"] = rabitq_phase(
        torch, "rabitq2_100k", small.data, small.queries, gt_small,
        RABITQ2_FLOORS, False, index_type="hnsw", quantization_type="rabitq2")
    gc.collect()
    torch.cuda.empty_cache()
    # phase 24 reads the fvecs file phase 20 writes
    fvecs_dir = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    try:
        fvecs = os.path.join(fvecs_dir, "base.fvecs")
        report["native_rag"] = native_rag_phase(torch, ds, fvecs)
        for phase_name, phase in (
                ("db_shards", lambda: db_shards_phase(torch, dev, ds, gt)),
                ("build_shards", lambda: build_shards_phase(torch, dev)),
                ("serve_shards", lambda: serve_shards_phase(torch, dev,
                                                            small)),
                ("multihost", lambda: multihost_phase(torch, dev, ds,
                                                      fvecs))):
            gc.collect()
            torch.cuda.empty_cache()
            t = time.time()
            report[phase_name] = phase()
            report[phase_name]["phase_s"] = time.time() - t
            log(f"{phase_name}: phase {report[phase_name]['phase_s']:.1f}s")
    finally:
        shutil.rmtree(fvecs_dir, ignore_errors=True)
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
        """Launches in the SDK, rabitq, serving, service, flat + sq4 and
        RAG phases (12-20): every step, or the steps named ``steps``."""
        return sum(counts.get(kernel, 0) for ph in phases
                   for step, counts in report[ph]["launches"].items()
                   if steps is None or step in steps)

    def by_new_phase(kernel):
        """A kernel's launches in each of phases 17-24."""
        return {ph: new_launches(kernel, (ph,))
                for ph in (*SLICE11_PHASES, *SLICE12_PHASES)}

    sdk_rabitq = NEW_PHASES[:5]
    gather_dot_main = report["gather_dot"]["at"][str(GATHER_DOT_SHAPES[0][:3])]
    gather_dot_launches = (sum(r["launches"]["gather_dot"]
                               for r in report["search"].values())
                           + new_launches("gather_dot"))

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
                "launches_sdk_rabitq": new_launches(name, sdk_rabitq),
                "launches_by_new_phase": by_new_phase(name),
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
    # tile_topk by path: find_medoid in the bsq8 fit (the rest of the bsq8
    # path launches it no time), the raw fits (find_medoid, the overlay's
    # exact kNN), the flat scans
    topk_paths = {
        "bsq8_fit_find_medoid": report["fit"]["launches"]["tile_topk"],
        "bsq8_search_and_churn": (bsq8_pool["tile_topk"]
                                  - report["fit"]["launches"]["tile_topk"]),
        "raw": raw_launches("tile_topk"),
        "flat_exact": report["flat"]["exact"]["tile_topk_launches"],
        "flat_fast": report["flat"]["fast"]["tile_topk_launches"],
        "calc_gt": new_launches("tile_topk", ("calc_gt",)),
        "sdk_and_rabitq_fits": new_launches("tile_topk", (
            "collection", "reindex", "rabitq", "rabitq2")),
        **by_new_phase("tile_topk")}
    # its calls through the wide route, counted over the same phases
    wide = topk_wide().__name__
    topk_wide_paths = {
        "bsq8": bsq8_pool[wide], "raw": raw_launches(wide),
        "flat_exact": report["flat"]["exact"]["tile_topk_wide_calls"],
        "flat_fast": report["flat"]["fast"]["tile_topk_wide_calls"],
        "new_phases": new_launches(wide)}
    log(f"tile_topk launches by path: {topk_paths}; wide route calls "
        f"{topk_wide_paths}")
    if sum(topk_paths.values()) <= 0:
        raise AssertionError("tile_topk was launched no time on the paths")
    if sum(topk_wide_paths.values()):
        raise AssertionError(f"a path shape took tile_topk's wide route: "
                             f"{topk_wide_paths}")

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
         "launches_by_new_phase": by_new_phase("block_diagdot"),
         "launches_by_phase": {
             "bsq8_churn_audit": churn_launches["block_diagdot"],
             "rabitq_1m": new_launches("block_diagdot", ("rabitq",)),
             "rabitq2_100k": new_launches("block_diagdot", ("rabitq2",)),
             "db_shards_audit": new_launches("block_diagdot",
                                             ("db_shards",))},
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
         "launches_by_new_phase": by_new_phase("gather_diagdot"),
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
         "launches_sdk": new_launches("gather_estimate", sdk_rabitq),
         "launches_by_new_phase": by_new_phase("gather_estimate"),
         "variant": fused["variant"], "at": entries(fused),
         "kernels_per_estimate_many": report["estimate_many"][
             "kernels_per_call"]},
        # no Pallas kernel: the JAX package's gather_dists leaves the gather
        # and the product to XLA
        {**row("gather_dot", "alayalite_tpu_torch/csrc/gather_dot.cu",
               "alayalite_tpu/spaces/raw.py:138 (XLA, no Pallas kernel)",
               gather_dot_launches, {
                   **gather_dot_main,
                   "max_abs_err": gather_dot_main["max_abs_vs_plain"]}),
         "also_replaces": ["alayalite_tpu/spaces/bqg.py:264",
                           "alayalite_tpu/spaces/rabitq.py:356"],
         "launched_by": "the f32 spaces' gather_dists (RawSpace, BQGSpace, "
                        "RaBitQSpace: a block search's seeds and final pool, "
                        "the 1-bit hop's popped nodes, the raw beam, "
                        "exact_rescore, the fits' kNN, prune and repair, "
                        "the inserts), DistSlab.gather_dists, the flat fast "
                        "rerank",
         "launches_by_phase": {
             "bsq8_1m_search": sum(r["launches"]["gather_dot"]
                                   for r in report["search"].values()),
             "rabitq_1m_search": new_launches("gather_dot", ("rabitq",), [
                 s for s in report["rabitq"]["launches"]
                 if s.startswith("search")]),
             "rabitq2_100k_search": new_launches("gather_dot", ("rabitq2",), [
                 s for s in report["rabitq2"]["launches"]
                 if s.startswith("search")])},
         "launches_by_new_phase": by_new_phase("gather_dot"),
         "at": {shape: {k: rep[k] for k in (
             "ms", "ms_spin", "plain_ms", "plain_ms_spin",
             "library_ms", "library_ms_spin", "bound_ms", "bound_by",
             "spin_over_bound", "bits_equal_plain")}
             for shape, rep in report["gather_dot"]["at"].items()}},
        {**row("ring_probe", "alayalite_tpu_torch/csrc/ring_probe.cu",
               "scripts/proto_pallas_sort2.py:135", probe_launches,
               report["ring_probe"]),
         "launched_by": "block_beam_search (pop ring and pool as two "
                        "operands) and the raw beam's pop ring, every hop",
         "kernel_route": report["ring_probe"]["route"],
         "launches_by_route": probe_routes,
         "launches_by_new_phase": by_new_phase("ring_probe"),
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
                     for shape, rep in report["sort_kv"]["at"].items()},
                 at_nnd_chunk={k: report["captured_knn_repair"][
                     "sort_kv_at_nnd_chunk"][k] for k in (
                     "shape", "ms", "ms_spin", "plain_ms", "library_ms",
                     "bound_ms", "bound_by")}),
        {**row("tile_topk", "alayalite_tpu_torch/csrc/tile_topk.cu",
               "none: the JAX package leaves the per-tile top k to XLA "
               "(lax.top_k in alayalite_tpu/ops/distance.py "
               "_exact_topk_device)", sum(topk_paths.values()),
               report["tile_topk"]),
         "launched_by": "ops/distance._exact_topk_device: each tile of the "
                        "flat scans (exact and fast), exact_topk's callers "
                        "(find_medoid, the overlay's exact kNN, calc_gt) and "
                        "the sharded slab's scan",
         "launches_by_path": topk_paths,
         "wide_route_calls_by_path": topk_wide_paths,
         "checked": report["tile_topk"]["checked"],
         "at": report["tile_topk"]["at"]},
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
         "launches_by_new_phase": by_new_phase("roll_n"),
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
         "launches_by_new_phase": by_new_phase("l2_tile"),
         "launches_by_path": {
             "flat_exact": report["flat"]["exact"]["l2_tile_launches"],
             "calc_gt": new_launches("l2_tile", ("calc_gt",)),
             "sdk_and_rabitq_fits": new_launches("l2_tile", (
                 "collection", "reindex", "rabitq", "rabitq2"))}},
        {**row("sq8_tile", "alayalite_tpu_torch/csrc/sq8_tile.cu",
               "alayalite_tpu/ops/pallas_distance.py:141",
               report["flat"]["sq8"]["launches"], report["tiles"]["sq8_tile"]),
         "library_f32_ms": report["tiles"]["sq8_tile"]["library_f32_ms"],
         "launches_by_new_phase": by_new_phase("sq8_tile"),
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
        "seed_scan": report["seed_scan"],
        "unique_topk": report["unique_topk"],
        "tile_topk": report["tile_topk"],
        "gather_dot": report["gather_dot"],
        "estimate_many": report["estimate_many"],
        "bsq8_pool_launches": bsq8_pool,
        "flat": {k: report["flat"][k] for k in ("fit_s", "exact", "fast")},
        **{ph: report[ph] for ph in NEW_PHASES},
        "captured": report["captured"],
        "captured_build": report["captured_build"],
        "captured_knn_repair": report["captured_knn_repair"],
        "total_s": report["total_s"]}}))
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
