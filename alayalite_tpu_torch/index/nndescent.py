"""NN-Descent: batched k-NN-graph construction (port of ``index/nndescent.py``).

Each round, every node gathers a sample of its neighbors' neighbors, a
bounded reverse-edge sample and a few random nodes; one batched distance
evaluation scores them and a compare-matrix dedup + top-k merge updates the
node's kNN row. Chunks of a round run in order and update the kNN state in
place, so a later chunk sees the rows an earlier one improved, as in the
JAX package's in-jit ``fori_loop``. Rounds run in blocks of four, and the
host reads a block's ``changes[rounds]`` vector once, as JAX does; the
build stops when the last round of a block changed at most
``MIN_UPDATE_FRAC·n·k`` entries.

On the card each round is one replay of a captured CUDA graph
(``captured.run_inplace``: the kNN state goes in as an input, updated in
the graph's own buffers, the chunks unrolled in order inside the graph),
and the cluster init's assign and score loops are one replay each; the
random init's chunks are independent and go through ``run_chunks``. A
round's random numbers are drawn before its replay, from the round's
``torch.Generator``, into inputs of narrow dtypes (``sel2`` over all
chunks is ``n·s1·s2`` entries a round), so a captured and an uncaptured
round (under ``captured.eager()``) draw the same numbers and give the
same rows bit for bit.
Nothing in a round syncs with the host; the cluster init makes one sync,
the upload of its anchor ids (``INIT_SYNCS``). ``build_knn_graph.syncs``
counts these stated host reads.

Above ``cluster_init_min`` rows (100k, the JAX value) the rows start from
a cluster-local init instead of random ones; the gate is an argument so a
small input can drive that branch.
"""

from __future__ import annotations

import functools
import logging
import time
from typing import Tuple

import numpy as np
import torch

from ..ops.topk import topk_smallest
from . import captured
from .build_phases import make_generator, pick_proposals

log = logging.getLogger("alayalite_tpu_torch")

Tensor = torch.Tensor
FINF = float("inf")
INIT_SYNCS = 1             # the cluster init's host syncs: the anchors' upload
# rows a capture's warm-up runs where the chunk has no matrix product (whose
# kernel the shape picks): every kind of kernel of a chunk, without a
# chunk's temporaries in the ordinary pool beside the scope's
WARM_ROWS = 1024


def _dedup_merge_fast(pool_d, pool_i, cand_d, cand_i, k: int):
    """Merge candidates into pools dropping duplicates: a candidate is
    dropped if it repeats an earlier candidate or a pool id ([C, M, M] and
    [C, M, K] compares). Pool ids are unique on entry and exit."""
    M = cand_i.shape[1]
    tril = torch.tril(torch.ones((M, M), dtype=torch.bool,
                                 device=cand_i.device), -1)
    dup_earlier = ((cand_i[:, :, None] == cand_i[:, None, :])
                   & tril[None]).any(2)
    in_pool = (cand_i[:, :, None] == pool_i[:, None, :]).any(2)
    bad = (cand_i < 0) | dup_earlier | in_pool
    cand_d = torch.where(bad, torch.full_like(cand_d, FINF), cand_d)
    cand_i = torch.where(bad, torch.full_like(cand_i, -1), cand_i)
    nd, sel = topk_smallest(torch.cat([pool_d, cand_d], dim=1), k)
    ni = torch.gather(torch.cat([pool_i, cand_i], dim=1), 1, sel)
    return nd, torch.where(torch.isfinite(nd), ni, torch.full_like(ni, -1))


def _narrow(high: int) -> torch.dtype:
    return torch.uint8 if high <= 256 else torch.int32


def _draw_round(gen, n: int, k: int, s1: int, s2: int, s_rev: int,
                n_rand: int, n_chunks: int, chunk: int, dev):
    """One round's random numbers: forward-edge picks ``sel1`` and reverse
    slots ``slot`` [n, s1], second-hop picks ``sel2`` [n_chunks, chunk,
    s1, s2] and random nodes ``rand`` [n_chunks, chunk, n_rand] (each chunk
    its own, the overlapping tail chunk too, as JAX folds the chunk into
    its key)."""
    def draw(high, shape, dtype):
        return torch.randint(0, high, shape, generator=gen, device=dev,
                             dtype=dtype)

    return (draw(k, (n, s1), _narrow(k)), draw(s_rev, (n, s1), _narrow(s_rev)),
            draw(k, (n_chunks, chunk, s1, s2), _narrow(k)),
            draw(n, (n_chunks, chunk, n_rand), torch.int32))


def _nnd_reverse_sample(knn_i: Tensor, sel1: Tensor, slot: Tensor,
                        s_rev: int):
    """The ``sel1`` forward edges of every node (mid [N, s1]) and a bounded
    reverse-edge table rev [N, s_rev]: edge (i, j) proposes i at slot
    ``slot[i, j]`` of row ``mid[i, j]``. Where proposals collide one stays,
    chosen by ``pick_proposals`` (a fixed pseudo-random order; JAX's
    scatter leaves the choice open); −1 edges propose nothing. Fixed in
    shape, no host sync."""
    N = knn_i.shape[0]
    mid = torch.gather(knn_i, 1, sel1.long())                     # [N, s1]
    ok = mid >= 0
    rev = pick_proposals(mid.long() * s_rev + slot.long(), ok, N * s_rev)
    return mid, rev.view(N, s_rev)


def _nnd_round_chunk(space, knn_d, knn_i, mid, rev, sel2: Tensor,
                     rand: Tensor, lo: int, chunk: int) -> Tensor:
    """One join for nodes [lo, lo+chunk), updating knn_d/knn_i in place
    (``sel2`` [chunk, s1, s2] and ``rand`` [chunk, n_rand]: the chunk's
    draws). Returns the number of changed kNN entries (a device scalar)."""
    N, K = knn_i.shape
    mid_c = mid[lo:lo + chunk]
    C, s1 = mid_c.shape
    their = knn_i.index_select(
        0, torch.where(mid_c >= 0, mid_c, torch.zeros_like(mid_c)).reshape(-1)
    ).view(C, s1, K)
    hop2 = torch.gather(their, 2, sel2.long())
    hop2 = torch.where(mid_c[:, :, None] >= 0, hop2,
                       torch.full_like(hop2, -1)).reshape(C, -1)
    cand = torch.cat([hop2, rev[lo:lo + chunk], rand], dim=1)
    me = lo + torch.arange(C, dtype=torch.int32, device=knn_i.device)[:, None]
    cand = torch.where(cand == me, torch.full_like(cand, -1), cand)
    ok = cand >= 0
    qv = space.data[lo:lo + chunk].float()
    d = space.gather_dists(qv, torch.where(ok, cand, torch.zeros_like(cand)))
    d = torch.where(ok, d, torch.full_like(d, FINF))
    ki_c = knn_i[lo:lo + chunk]
    new_d, new_i = _dedup_merge_fast(knn_d[lo:lo + chunk], ki_c, d, cand, K)
    changed = (new_i != ki_c).sum()
    knn_d[lo:lo + chunk] = new_d
    knn_i[lo:lo + chunk] = new_i
    return changed


def _round_starts(n: int, chunk: int) -> list:
    """JAX's chunk starts of a round: ``min(ci·chunk, n − chunk)``."""
    return [min(ci * chunk, n - chunk) for ci in range(-(-n // chunk))]


def _nnd_round(space, s_rev: int, chunk: int, knn_d, knn_i, sel1, slot,
               sel2, rand):
    """One NN-Descent round over every chunk, in order, knn_d / knn_i
    updated in place: (knn_d, knn_i, changed entries)."""
    mid, rev = _nnd_reverse_sample(knn_i, sel1, slot, s_rev)
    changed = torch.zeros((), dtype=torch.int64, device=knn_i.device)
    for ci, lo in enumerate(_round_starts(knn_i.shape[0], chunk)):
        changed = changed + _nnd_round_chunk(space, knn_d, knn_i, mid, rev,
                                             sel2[ci], rand[ci], lo, chunk)
    return knn_d, knn_i, changed


def nnd_block(space, knn_d: Tensor, knn_i: Tensor, gen, rounds: int, s1: int,
              s2: int, s_rev: int, n_rand: int,
              chunk: int) -> Tuple[Tensor, Tensor, Tensor]:
    """``rounds`` NN-Descent rounds (JAX's ``_nnd_rounds_dev``), each round
    one replay on the card. Returns (knn_d, knn_i, changes [rounds] i64 on
    the device); the caller reads ``changes`` once."""
    n, k = knn_i.shape
    dev = knn_i.device
    starts = _round_starts(n, chunk)
    fn = functools.partial(_nnd_round, space, s_rev, chunk)
    changes = []
    for _ in range(rounds):
        draws = _draw_round(gen, n, k, s1, s2, s_rev, n_rand, len(starts),
                            chunk, dev)
        inputs = (knn_d, knn_i, *draws)

        def warm():
            # part of a chunk on scratch state: every kind of kernel
            w = min(chunk, WARM_ROWS)
            kd, ki = knn_d.clone(), knn_i.clone()
            mid, rev = _nnd_reverse_sample(ki, draws[0], draws[1], s_rev)
            _nnd_round_chunk(space, kd, ki, mid, rev, draws[2][0][:w],
                             draws[3][0][:w], starts[0], w)

        knn_d, knn_i, c = captured.run_inplace(
            "nnd_round", fn, inputs, inputs, reads=(space,),
            static=(s_rev, chunk), warm=warm)
        changes.append(c)
    return knn_d, knn_i, torch.stack(changes)


def _init_random_knn(space, n: int, k: int, gen, chunk: int):
    """Each row starts from ``k`` random nodes (itself moved to the next
    id), scored and deduplicated. The chunks are independent: on the card
    each is one replay (``captured.run_chunks``)."""
    cand = torch.randint(0, n, (n, k), generator=gen, device=space.device,
                         dtype=torch.int32)

    def one_chunk(rows, cc):
        cc = torch.where(cc == rows[:, None], (cc + 1) % n, cc)
        d = space.gather_dists(space.data[rows.long()].float(), cc)
        pd = torch.full(cc.shape, FINF, device=cc.device)
        return _dedup_merge_fast(pd, torch.full_like(cc, -1), d, cc, k)

    return captured.run_chunks("nnd_init_random", one_chunk, n, chunk,
                               (cand,), reads=(space,), static=(k,))


def _assign(space, n: int, chunk: int, a_vecs, a_sq):
    """Nearest anchor of every node (bf16 values, f32 products), chunk by
    chunk: [n] i32."""
    a_t = a_vecs.to(torch.bfloat16).float().T
    assign = torch.empty((n,), dtype=torch.int32, device=a_vecs.device)
    for lo in captured.chunk_starts(n, chunk)[0]:
        q = space.data[lo:lo + chunk].to(torch.bfloat16).float()
        # |q|² is constant per row: argmin of |a|² − 2 q·a
        assign[lo:lo + chunk] = torch.argmin(a_sq[None, :] - 2.0 * (q @ a_t),
                                             dim=1).to(torch.int32)
    return (assign,)


def _score_rows(space, n: int, k: int, lo: int, c: int, assign, order,
                counts, starts_c, pos, rand):
    """Init candidates of rows [lo, lo+c): ``k`` members of the row's own
    cluster (``pos`` picks them) ∪ ``k`` random nodes, scored and
    deduplicated. Returns (d, i) [c, k]."""
    a = assign[lo:lo + c].long()
    cnt = torch.clamp(counts[a], min=1)
    local = order[((starts_c[a][:, None] + pos[lo:lo + c] % cnt[:, None])
                   % n).long()]
    cc = torch.cat([local, rand[lo:lo + c]], dim=1)
    me = lo + torch.arange(c, dtype=torch.int32, device=cc.device)[:, None]
    cc = torch.where(cc == me, torch.full_like(cc, -1), cc)
    ok = cc >= 0
    d = space.gather_dists(space.data[lo:lo + c].float(),
                           torch.where(ok, cc, torch.zeros_like(cc)))
    d = torch.where(ok, d, torch.full_like(d, FINF))
    pd = torch.full((c, k), FINF, device=cc.device)
    pi = torch.full((c, k), -1, dtype=torch.int32, device=cc.device)
    return _dedup_merge_fast(pd, pi, d, cc, k)


def _score(space, n: int, k: int, chunk: int, *tables):
    """Every row's init candidates (``_score_rows``), chunk by chunk into
    (kd, ki) [n, k]."""
    kd = torch.empty((n, k), dtype=torch.float32, device=tables[0].device)
    ki = torch.empty((n, k), dtype=torch.int32, device=tables[0].device)
    for lo in captured.chunk_starts(n, chunk)[0]:
        kd[lo:lo + chunk], ki[lo:lo + chunk] = _score_rows(
            space, n, k, lo, chunk, *tables)
    return kd, ki


def _init_cluster_knn(space, n: int, k: int, seed: int, chunk: int):
    """Cluster-local init: random anchors → nearest anchor of every node
    (bf16 values, f32 products) → each node's row starts from k random
    members of its own cluster ∪ k random nodes. The assign and the score
    loops are one replay each on the card (JAX's ``_assign_all`` and
    ``_cluster_score_all``); the group-by between them (a stable sort and
    a fixed-size ``scatter_add_`` of the cluster sizes) stays on the
    device."""
    dev = space.device
    rng = np.random.default_rng(seed)
    n_anchors = int(min(max(256, n // 256), 16384))
    anchors = np.sort(rng.choice(n, size=n_anchors, replace=False))
    a_vecs = space.data[torch.as_tensor(anchors, device=dev)].float()
    build_knn_graph.syncs += INIT_SYNCS
    a_sq = (a_vecs * a_vecs).sum(-1)
    c = min(chunk, n)

    w = min(c, WARM_ROWS)

    def warm_assign():         # a whole chunk: the product's shape
        _assign(space, c, c, a_vecs, a_sq)

    (assign,) = captured.run_inplace(
        "nnd_assign", functools.partial(_assign, space, n, c),
        (a_vecs, a_sq), (a_vecs, a_sq), reads=(space,), static=(n, c),
        warm=warm_assign)
    order = torch.sort(assign, stable=True).indices.to(torch.int32)
    counts = torch.zeros((n_anchors,), dtype=torch.int32, device=dev)
    counts.scatter_add_(0, assign.long(), torch.ones_like(assign))
    starts_c = torch.cumsum(counts, 0, dtype=torch.int32) - counts

    gen = make_generator(dev, seed ^ 0x5EED)
    pos = torch.randint(0, 2**30, (n, k), generator=gen, device=dev,
                        dtype=torch.int32)
    rand = torch.randint(0, n, (n, k), generator=gen, device=dev,
                         dtype=torch.int32)
    tables = (assign, order, counts, starts_c, pos, rand)

    def warm_score():
        _score_rows(space, n, k, 0, w, *tables)

    return captured.run_inplace(
        "nnd_score", functools.partial(_score, space, n, k, c), tables,
        tables, reads=(space,), static=(n, k, c), warm=warm_score)


SAMPLE_RATE = 0.5          # forward-edge sample per round, as a share of k
MIN_UPDATE_FRAC = 0.001    # stop when a round changes ≤ this share of n·k
EXACT_THRESHOLD = 4096     # exact all-pairs kNN up to this many rows
BLOCK = 4                  # rounds between two host reads


def round_shape(n: int, k: int, dim: int) -> dict:
    """The sample sizes and the chunk of a round, as JAX sets them: the
    [chunk, s1·s2 + s_rev + n_rand, dim] f32 gather bounded to ~2.5 GB."""
    s1 = max(4, int(k * SAMPLE_RATE))
    s2 = max(4, int(k * SAMPLE_RATE) // 2)
    s_rev = max(8, k // 2)
    n_rand = 4
    m_width = s1 * s2 + s_rev + n_rand
    chunk = min(n, max(2048, int(2.5e9 / (m_width * dim * 4))))
    return dict(s1=s1, s2=s2, s_rev=s_rev, n_rand=n_rand, chunk=chunk)


def build_knn_graph(space, n: int, k: int, max_iters: int = 0, seed: int = 0,
                    cluster_init_min: int = 100_000) -> Tuple[Tensor, Tensor]:
    """Approximate kNN graph of the first ``n`` rows of ``space``:
    (dists [n, k] f32, ids [n, k] i32) on the space's device. Exact
    all-pairs search up to EXACT_THRESHOLD rows."""
    if max_iters <= 0:
        max_iters = (12 if n > 100_000
                     else max(12, int(np.log2(max(n, 2))) + 6))
    if n <= EXACT_THRESHOLD:
        from .knn import exact_knn

        return exact_knn(space.data[:n].float(), k, metric=space.metric)

    shape = round_shape(n, k, space.dim)
    t0 = time.time()
    if n > cluster_init_min:
        knn_d, knn_i = _init_cluster_knn(space, n, k, seed, shape["chunk"])
    else:
        knn_d, knn_i = _init_random_knn(space, n, k,
                                        make_generator(space.device, seed),
                                        chunk=shape["chunk"])
    gen = make_generator(space.device, seed + 1)
    it = 0
    while it < max_iters:
        rounds = min(BLOCK, max_iters - it)
        knn_d, knn_i, changes = nnd_block(space, knn_d, knn_i, gen, rounds,
                                          **shape)
        changes = changes.tolist()           # the block's one host read
        build_knn_graph.syncs += 1
        it += rounds
        log.info("nndescent rounds %d-%d: changed=%s (%.1fs)", it - rounds,
                 it - 1, changes, time.time() - t0)
        if changes[-1] <= MIN_UPDATE_FRAC * n * k:
            break
    return knn_d, knn_i


build_knn_graph.syncs = 0      # host reads stated: the init's and a block's
