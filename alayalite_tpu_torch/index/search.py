"""Batched lockstep beam search (port of part of ``index/search.py``).

B queries advance one hop per loop step. Per-query state:
  pool_d / pool_i / pool_c : the ef-wide best-first pool, kept sorted, with
                             the checked ("expanded") flag;
  popring                  : every node the loop can expand (M · max_iters
                             slots), so no node is expanded twice.
A query is done when its pool holds no unchecked entry. JAX's
``lax.while_loop`` stops once no query of the batch has one; the port runs
exactly ``max_iters`` hops with no test between them, so the loop never
waits for the host. A hop of a query with nothing left to expand is a no-op
(nothing is popped, every candidate is −1 / inf, the merge keeps the pool's
entries), and the pop ring holds M · max_iters pops, so no pop falls off
it: the extra hops change no result. The overlay descent keeps a test, one
per ``DESCENT_CHUNK`` steps.

On the card each slice (``block_search_device``: the seed scan and the
beam; ``graph_search_device``: each chunk of a level's descent, then the
beam and the re-score) is one replay of a captured CUDA graph
(``captured.run``), and the batch is padded to the JAX engine's buckets.

Ported: ``_pop_best_m``, ``beam_search`` in both visited modes ("ring":
the pop ring and the merge's dedup; "bitmask": an exact per-query bitset),
``overlay_descend``, ``graph_seeds`` and ``graph_search_device`` (the raw
graph query: overlay descent, beam, exact re-score), ``block_beam_search``
(with the 1-bit result pool of rabitq; the JAX package's
``rabitq_beam_search`` is this function), ``seed_sample_arrays``,
``scan_seeds`` and ``block_search_device``.
``scan_seeds`` takes the exact top-k where the JAX package takes
``lax.approx_max_k``: a superset of what the approximation can return, and
one reason result ids differ between the packages. On the card it is one
call of the hand-written ``ops/seed_scan`` kernel (bf16 products summed in
f32, ``sq − 2·dot`` and the exact top ``nseed`` in one pass that keeps the
scores on the SM; among equal scores the lower sample index first, as
``lax.top_k`` orders them). Every pool merge is
``ops/topk.merge_topk_dedup`` or ``merge_topk_with_flags``: on a CUDA tensor
the hand-written ``pool_merge`` kernel. The block search's final selection
(the first copy of each live id of the re-scored pools, then the k best) is
one call of the hand-written ``ops/unique_topk`` kernel, which reads each
row once and never builds the [B, W, W] compare of the duplicate net it
replaced; on the CPU its plain version, that net and ``topk_smallest``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import trace
from ..ops.distance import row_dots
from ..ops.ring_probe import ring_probe
from ..ops.seed_scan import seed_scan
from ..ops.topk import (merge_topk_dedup, merge_topk_with_flags,
                        topk_smallest)
from ..ops.unique_topk import unique_topk
from .captured import pad_rows, run, slice_rows

Tensor = torch.Tensor
FINF = float("inf")
# Steps of the overlay descent between two host tests of "any query still
# improving". The default raw hnsw at 1M x 128 (three levels) took 5, 8 and
# 5 steps, the test that ends a level included, over 4096 queries
# (chip_smoke.py phase 25, NVIDIA H100 80GB HBM3 at 700.00 W), so each level
# ends in one chunk; a step after a query converged is a no-op.
DESCENT_CHUNK = 8


def _inf_where_not(mask: Tensor, d: Tensor) -> Tensor:
    return torch.where(mask, d, torch.full_like(d, FINF))


def _neg1_where_not(mask: Tensor, i: Tensor) -> Tensor:
    return torch.where(mask, i, torch.full_like(i, -1))


def _has_next(pool_d: Tensor, pool_i: Tensor, pool_c: Tensor) -> Tensor:
    return (~pool_c) & (pool_i >= 0) & torch.isfinite(pool_d)


def _pop_best_m(pool_d: Tensor, pool_i: Tensor, pool_c: Tensor, m: int):
    """The M best unchecked pool entries without a sort: the pool is sorted
    ascending, so they are the first M unchecked slots (a cumsum rank).
    Returns (u [B, M] popped ids, 0 where none; active [B, M]; pool_c with
    the picks marked checked)."""
    unchecked = _has_next(pool_d, pool_i, pool_c)
    rank = torch.cumsum(unchecked.to(torch.int32), dim=1, dtype=torch.int32) - 1
    pick = unchecked & (rank < m)
    B = pool_i.shape[0]
    # picks scatter to their rank; everything else to a dropped column m
    slot = torch.where(pick, rank, torch.full_like(rank, m)).long()
    u = torch.zeros((B, m + 1), dtype=torch.int32, device=pool_i.device)
    u.scatter_(1, slot, torch.where(pick, pool_i, torch.zeros_like(pool_i)))
    active = torch.zeros((B, m + 1), dtype=torch.bool, device=pool_i.device)
    active.scatter_(1, slot, pick)
    return u[:, :m], active[:, :m], pool_c | pick


def _default_iters(L: int, M: int, max_iters: int) -> int:
    return max_iters if max_iters > 0 else max(8, L // M + 4)


def _popring_width(M: int, max_iters: int) -> int:
    return max(8, -(-(M * max_iters) // 8) * 8)


def _expand_popring(space, q, popring, pool_d, pool_i, pool_c, cand_ids,
                    ef: int):
    """Score the candidates not yet expanded (not in the pop ring) and
    merge them into the pool; duplicates collapse in the merge."""
    fresh = (cand_ids >= 0) & ~ring_probe(cand_ids.contiguous(), popring)
    d = _inf_where_not(fresh, space.gather_dists(
        q, torch.where(fresh, cand_ids, torch.zeros_like(cand_ids))))
    return merge_topk_dedup(pool_d, pool_i, pool_c, d,
                            _neg1_where_not(fresh, cand_ids),
                            torch.zeros_like(fresh), ef)


def _init_pool(B: int, L: int, device):
    return (torch.full((B, L), FINF, device=device),
            torch.full((B, L), -1, dtype=torch.int32, device=device),
            torch.zeros((B, L), dtype=torch.bool, device=device))


def _visited_probe_and_set(visited: Tensor, ids: Tensor):
    """Test-and-set ``ids`` [B, K] (−1 = skip) in the per-query bitmasks
    ``visited`` [B, W] (32 bits per int32 word), in place. Returns (fresh
    [B, K] bool aligned with a *sorted* copy of the ids, that copy).
    Duplicate ids within a row are dropped by the sort, so the scatter-add
    of single bits never carries."""
    ids_s = torch.sort(ids, dim=1).values
    prev = torch.cat([torch.full_like(ids_s[:, :1], -2), ids_s[:, :-1]], 1)
    ok = (ids_s >= 0) & (ids_s != prev)
    word = torch.where(ok, ids_s >> 5, torch.zeros_like(ids_s)).long()
    bit = torch.where(ok, torch.bitwise_left_shift(torch.ones_like(ids_s),
                                                   ids_s & 31),
                      torch.zeros_like(ids_s))
    fresh = ok & ((torch.gather(visited, 1, word) & bit) == 0)
    visited.scatter_add_(1, word, torch.where(fresh, bit,
                                              torch.zeros_like(bit)))
    return fresh, ids_s


def _expand(space, q, visited, pool_d, pool_i, pool_c, cand_ids, ef: int):
    """Probe the candidates against the bitmask, score the fresh ones and
    merge them into the pool."""
    fresh, ids_s = _visited_probe_and_set(visited, cand_ids)
    d = _inf_where_not(fresh, space.gather_dists(
        q, torch.where(fresh, ids_s, torch.zeros_like(ids_s))))
    return merge_topk_with_flags(pool_d, pool_i, pool_c, d,
                                 _neg1_where_not(fresh, ids_s),
                                 torch.zeros_like(fresh), ef)


def _beam_hop(space, nbrs, queries, visited, pool_d, pool_i, pool_c,
              M: int, L: int, ring: bool):
    """One hop of the raw beam: pop the M best unchecked, expand their
    adjacency rows. A query with nothing unchecked pops nothing and merges
    only −1 / inf candidates: its pool keeps its entries."""
    B = queries.shape[0]
    u, active, pool_c = _pop_best_m(pool_d, pool_i, pool_c, M)
    u_safe = torch.where(active, u, torch.zeros_like(u))
    nb = nbrs.index_select(0, u_safe.reshape(-1)).view(B, M, -1)
    nb = _neg1_where_not(active[:, :, None], nb).reshape(B, -1)
    if ring:
        visited = torch.cat([visited[:, M:], _neg1_where_not(active, u)], 1)
        expand = _expand_popring
    else:
        expand = _expand
    return (visited, *expand(space, queries, visited, pool_d, pool_i, pool_c,
                             nb, L))


def _beam_start(space, seeds: Tensor, queries: Tensor, C: int, L: int,
                M: int, max_iters: int, ring: bool):
    """The raw beam's state before its first hop: (visited, pool_d, pool_i,
    pool_c) with the seeds scored and merged."""
    B = queries.shape[0]
    dev = queries.device
    if ring:
        visited = torch.full((B, _popring_width(M, max_iters)), -1,
                             dtype=torch.int32, device=dev)
        expand = _expand_popring
    else:
        visited = torch.zeros((B, -(-C // 32)), dtype=torch.int32, device=dev)
        expand = _expand
    return (visited, *expand(space, queries, visited, *_init_pool(B, L, dev),
                             seeds, L))


def _beam_search(space, nbrs: Tensor, seeds: Tensor, queries: Tensor, k: int,
                 ef: int, max_iters: int, valid: Optional[Tensor],
                 n_expand: int, visited_mode: str) -> Tuple[Tensor, Tensor]:
    C = nbrs.shape[0]
    L = max(int(ef), int(k))
    M = max(1, int(n_expand))
    max_iters = _default_iters(L, M, max_iters)
    ring = visited_mode == "ring"
    state = _beam_start(space, seeds, queries, C, L, M, max_iters, ring)
    for _ in range(max_iters):
        state = _beam_hop(space, nbrs, queries, *state, M, L, ring)
    _, pool_d, pool_i, _ = state

    ok = pool_i >= 0
    if valid is not None:
        ok &= valid[pool_i.clamp(0, C - 1).long()]
    out_d, sel = topk_smallest(_inf_where_not(ok, pool_d), k)
    ids = torch.gather(pool_i, 1, sel)
    return out_d, _neg1_where_not(torch.isfinite(out_d), ids)


def beam_search(space, nbrs: Tensor, seeds: Tensor, queries: Tensor, k: int,
                ef: int, max_iters: int = 0, valid: Optional[Tensor] = None,
                n_expand: int = 1,
                visited_mode: str = "ring") -> Tuple[Tensor, Tensor]:
    """Beam search over a space with ``gather_dists`` and the adjacency
    ``nbrs`` [C, R]. ``valid`` [C] bool filters the results (tombstones:
    the walk still routes through removed nodes). ``visited_mode``: "ring"
    (the pop ring plus the merge's dedup, scatter-free) or "bitmask" (an
    exact bitset per query, [B, C / 32] words). Returns (dists [B, k] f32,
    ids [B, k] i32, −1 absent). On the card one replay of a captured
    graph."""
    if visited_mode not in ("ring", "bitmask"):
        raise ValueError(f"unknown visited_mode {visited_mode!r}")
    return run("beam_search",
               lambda s, q: _beam_search(space, nbrs, s, q, k, ef, max_iters,
                                         valid, n_expand, visited_mode),
               (seeds, queries), reads=(space, nbrs, valid),
               static=(k, ef, max_iters, n_expand, visited_mode))


def _descend_steps(space, level_ids: Tensor, level_nbrs: Tensor,
                   cur: Tensor, cur_d: Tensor, improved: Tensor,
                   queries: Tensor, steps: int):
    """``steps`` greedy steps: each query still improving moves to its best
    neighbor where that is closer. A step of a query that stopped
    improving leaves it where it is."""
    for _ in range(steps):
        nb_local = level_nbrs[cur.long()]                        # [B, R2]
        ok = nb_local >= 0
        gids = level_ids[torch.where(ok, nb_local,
                                     torch.zeros_like(nb_local)).long()]
        d = _inf_where_not(ok, space.gather_dists(queries, gids))
        best_d, j = d.min(dim=1)
        best_local = torch.gather(nb_local, 1, j[:, None])[:, 0]
        better = (best_d < cur_d) & improved
        cur = torch.where(better, best_local, cur)
        cur_d = torch.where(better, best_d, cur_d)
        improved = better
    return cur, cur_d, improved


def overlay_descend(space, level_ids: Tensor, level_nbrs: Tensor,
                    level_down: Tensor, start: Tensor,
                    queries: Tensor) -> Tensor:
    """Greedy descent within one overlay level, batched over queries: each
    query moves to its best neighbor while that improves. ``start`` [B]
    local indices; returns [B] local indices into the level below. The
    steps run in chunks of ``DESCENT_CHUNK`` (on the card each chunk a
    captured graph) with one host test (``any`` improved) after each;
    ``overlay_descend.syncs`` counts the tests."""
    reads = (space, level_ids, level_nbrs)

    def first(start, queries):
        cur_d = space.gather_dists(
            queries, level_ids[start.long()][:, None])[:, 0]
        return _descend_steps(space, level_ids, level_nbrs, start, cur_d,
                              torch.ones_like(start, dtype=torch.bool),
                              queries, DESCENT_CHUNK)

    def more(cur, cur_d, improved, queries):
        return _descend_steps(space, level_ids, level_nbrs, cur, cur_d,
                              improved, queries, DESCENT_CHUNK)

    cur, cur_d, improved = run("descend_first", first, (start, queries),
                               reads, (DESCENT_CHUNK,))
    while True:
        overlay_descend.syncs += 1
        if not bool(improved.any()):
            break
        cur, cur_d, improved = run("descend_more", more,
                                   (cur, cur_d, improved, queries), reads,
                                   (DESCENT_CHUNK,))
    return level_down[cur.long()]


overlay_descend.syncs = 0


def graph_seeds(space, eps: Tensor, overlay, queries: Tensor) -> Tensor:
    """Seed ids [B, S] for the beam: the overlay's greedy descent where the
    graph has one, else the stored entry points. The descent starts at the
    top level's first live slot (a removed slot has id −1); if the whole top
    level is dead, or the descent lands on no node, the first entry point
    stands in."""
    B = queries.shape[0]
    if len(overlay) == 0:
        return eps[None, :].expand(B, -1)
    top = overlay[0]
    live = top.ids >= 0
    start = torch.argmax(live.to(torch.int8)).to(torch.int32)
    cur = start.expand(B)
    for lvl in overlay:
        cur = overlay_descend(space, lvl.ids, lvl.nbrs, lvl.down, cur, queries)
    ok = live.any() & (cur >= 0)
    return torch.where(ok, cur, eps[0])[:, None]


def exact_rescore(space, q: Tensor, ids: Tensor, k: int):
    """Exact f32 distances of candidate ``ids`` [B, C] (−1 absent) to
    ``q`` [B, D] from the stored rows (full f32 products), then the ``k``
    best: the user-facing re-score; ``gather_dists`` only orders a walk."""
    ok = ids >= 0
    if space.data.dtype == torch.float32:
        # f32 rows: gather_dists is this product (one gather_dot, whose
        # clamp reads row 0 for a -1, as ``safe`` does)
        d = space.gather_dists(q, ids)
    else:
        safe = torch.where(ok, ids, torch.zeros_like(ids)).long()
        dot = row_dots(space.data[safe].float(), q)
        if space.metric == "ip":
            d = -dot
        else:
            q_sq = (q * q).sum(-1, keepdim=True)
            d = torch.clamp(q_sq + space.sq_norms[safe] - 2.0 * dot, min=0.0)
    out_d, sel = topk_smallest(_inf_where_not(ok, d), k)
    out_i = torch.gather(ids, 1, sel)
    return out_d, _neg1_where_not(torch.isfinite(out_d), out_i)


def graph_search_device(space, nbrs: Tensor, eps: Tensor, overlay,
                        q_all: Tensor, k: int, ef: int, max_iters: int = 0,
                        valid: Optional[Tensor] = None, n_expand: int = 8,
                        visited_mode: str = "ring", qchunk: int = 4096,
                        exact_rerank: bool = True) -> Tuple[Tensor, Tensor]:
    """The raw graph query over a batch padded as the JAX engine pads it
    (``captured.slice_rows``: slices of min(qchunk, bucket) rows, zero
    queries appended, their rows dropped): per slice the overlay descent,
    then the lockstep beam and (``exact_rerank``, for a space that stores
    the rows) the exact re-score of the k results as one captured graph."""
    if visited_mode not in ("ring", "bitmask"):
        raise ValueError(f"unknown visited_mode {visited_mode!r}")
    nq = q_all.shape[0]
    qchunk, b = slice_rows(nq, qchunk)
    q_all = pad_rows(q_all, b)

    def beam(seeds, q):
        d, i = _beam_search(space, nbrs, seeds, q, k, ef, max_iters, valid,
                            n_expand, visited_mode)
        return exact_rescore(space, q, i, k) if exact_rerank else (d, i)

    outs_d, outs_i = [], []
    for lo in range(0, b, qchunk):
        q = q_all[lo:lo + qchunk]
        seeds = graph_seeds(space, eps, overlay, q)
        d, i = run("graph_beam", beam, (seeds, q), (space, nbrs, valid),
                   (k, ef, max_iters, n_expand, visited_mode, exact_rerank))
        outs_d.append(d)
        outs_i.append(i)
    return torch.cat(outs_d)[:nq], torch.cat(outs_i)[:nq]


def _block_hop(space, ctx, queries, popring, pool_d, pool_i, pool_c, res_d,
               res_i, M: int, L: int, k: int, res_pool: bool):
    """One hop of the block beam: pop the M best unchecked, estimate their
    blocks' neighbors, drop the stale ones and merge the rest. A query with
    nothing unchecked pops nothing and merges only −1 / inf candidates: its
    pools keep their entries."""
    B = queries.shape[0]
    u, active, pool_c = _pop_best_m(pool_d, pool_i, pool_c, M)
    u_safe = torch.where(active, u, torch.zeros_like(u))
    popring = torch.cat([popring[:, M:], _neg1_where_not(active, u)], 1)
    if res_pool:
        du = space.gather_dists(queries, u_safe)               # [B, M]
        res_d, res_i, _ = merge_topk_dedup(
            res_d, res_i, torch.zeros_like(res_i, dtype=torch.bool),
            _inf_where_not(active, du), _neg1_where_not(active, u),
            torch.zeros_like(active), k)
        est, nids = space.estimate_many(ctx, u_safe, d_center=du)
    else:
        est, nids = space.estimate_many(ctx, u_safe)           # [B, M*R]
    R = nids.shape[1] // M
    nids = _neg1_where_not(active[:, :, None].expand(B, M, R).reshape(B, -1),
                           nids)
    # stale = already expanded (the pop ring) or already pooled
    stale = ring_probe(nids, popring, pool_i)
    fresh = (nids >= 0) & ~stale
    pool_d, pool_i, pool_c = merge_topk_dedup(
        pool_d, pool_i, pool_c, _inf_where_not(fresh, est),
        _neg1_where_not(fresh, nids), torch.zeros_like(fresh), L)
    return popring, pool_d, pool_i, pool_c, res_d, res_i


def _block_start(space, seeds: Tensor, queries: Tensor, k: int, L: int,
                 M: int, max_iters: int):
    """The block beam's query context and its state before the first hop:
    (popring, pool_d, pool_i, pool_c, res_d, res_i) with the seeds entered
    at their exact distances (duplicate seeds collapse in the merge)."""
    B = queries.shape[0]
    dev = queries.device
    popring = torch.full((B, _popring_width(M, max_iters)), -1,
                         dtype=torch.int32, device=dev)
    seed_ok = seeds >= 0
    d_seed = _inf_where_not(seed_ok, space.gather_dists(
        queries, torch.where(seed_ok, seeds, torch.zeros_like(seeds))))
    pool = merge_topk_dedup(
        *_init_pool(B, L, dev), d_seed, _neg1_where_not(seed_ok, seeds),
        torch.zeros_like(seed_ok), L)
    res_d = torch.full((B, int(k)), FINF, device=dev)
    res_i = torch.full((B, int(k)), -1, dtype=torch.int32, device=dev)
    return space.query_ctx(queries), (popring, *pool, res_d, res_i)


def _block_beam_search(space, seeds: Tensor, queries: Tensor, k: int,
                       ef: int, max_iters: int, valid: Optional[Tensor],
                       n_expand: int) -> Tuple[Tensor, Tensor]:
    L = max(int(ef), int(k))
    M = max(1, int(n_expand))
    max_iters = _default_iters(L, M, max_iters)
    res_pool = getattr(space, "bits", 0) == 1
    ctx, state = _block_start(space, seeds, queries, k, L, M, max_iters)
    for _ in range(max_iters):
        state = _block_hop(space, ctx, queries, *state, M, L, int(k),
                           res_pool)
    _, pool_d, pool_i, _, res_d, res_i = state

    # exact rerank of the whole pool (and the result pool's exact entries)
    d_exact = space.gather_dists(
        queries, torch.where(pool_i >= 0, pool_i, torch.zeros_like(pool_i)))
    if res_pool:
        pool_i = torch.cat([pool_i, res_i], 1)
        d_exact = torch.cat([d_exact, res_d], 1)
    # the first copy of each live id (against two live copies of one id in
    # the pool, and a popped node in both pools), then the k best
    return unique_topk(d_exact.contiguous(), pool_i.contiguous(), k, valid)


def block_beam_search(space, seeds: Tensor, queries: Tensor, k: int, ef: int,
                      max_iters: int = 0, valid: Optional[Tensor] = None,
                      n_expand: int = 1) -> Tuple[Tensor, Tensor]:
    """Beam search over a block space (BQGSpace, RaBitQSpace): each popped
    node's block is read by the space's ``estimate_many`` (bsq8: one
    ``gather_estimate`` launch a hop; rabitq: one ``block_diagdot``), which
    scores its neighbors with the block estimator, ``ring_probe`` drops the
    ones already expanded or pooled, and the final pool is re-ranked with
    exact raw distances: one ``unique_topk`` launch keeps the first copy
    of each live id (``valid``) and the k best. On the card one replay of a
    captured graph.

    A 1-bit space (``space.bits == 1``) also keeps the result pool: the
    exact distances of the popped nodes, which the estimator needs as its
    ``d_center`` anyway (gathered once a hop and handed to it), merge into
    a k-wide pool (one ``merge_topk_dedup`` of [B, k + M] a hop) that the
    final rerank unions in, so a true neighbor once popped cannot be lost
    to the estimates' noise."""
    return run("block_beam_search",
               lambda s, q: _block_beam_search(space, s, q, k, ef, max_iters,
                                               valid, n_expand),
               (seeds, queries), reads=(space, valid),
               static=(k, ef, max_iters, n_expand))


def seed_sample_arrays(data: Tensor, ids: Tensor, user_metric: str):
    """(ids, vecs bf16, sq_norms) for ``scan_seeds``. Under IP the order
    must be by −dot alone, so the norms are zero (cos keeps them: its data
    is normalized)."""
    vec = data[ids.long()].float()
    sq = (torch.zeros((vec.shape[0],), device=vec.device)
          if user_metric == "ip" else (vec * vec).sum(1))
    return ids, vec.to(torch.bfloat16), sq


def scan_seeds(q: Tensor, sample_ids: Tensor, sample_vecs: Tensor,
               sample_sq: Tensor, nseed: int = 8) -> Tensor:
    """Per-query entry points from one pass over a point sample: bf16
    values multiplied and summed in f32, then the exact ``nseed`` best by
    ``sq − 2·dot``, the lower sample index first among equal scores
    (``lax.top_k``'s order). On the card one call of the hand-written
    ``ops/seed_scan`` kernel, which never writes the [B, S] scores; on the
    CPU its plain version."""
    return seed_scan(q, sample_ids, sample_vecs, sample_sq, nseed)


def block_search_device(space, eps: Tensor, q_all: Tensor, k: int, ef: int,
                        max_iters: int = 0, valid: Optional[Tensor] = None,
                        n_expand: int = 8, qchunk: int = 4096,
                        seed_sample=None) -> Tuple[Tensor, Tensor]:
    """``block_beam_search`` over a query batch padded as the JAX engine
    pads it (``captured.slice_rows``), slice by slice; on the card each
    slice (the seed scan and the beam) is one replay of a captured graph.
    ``seed_sample`` = (ids, vecs bf16, sq_norms) enables the per-query seed
    scan; None starts every query from the shared entry points ``eps``."""
    nq = q_all.shape[0]
    qchunk, b = slice_rows(nq, qchunk)
    with trace.span("alaya.search.pad", rows=b, slice_rows=qchunk,
                    slices=b // qchunk):
        q_all = pad_rows(q_all, b)

    def one_slice(q):
        if seed_sample is not None:
            seeds = scan_seeds(q, *seed_sample)
        else:
            seeds = eps[None, :].expand(q.shape[0], -1)
        return _block_beam_search(space, seeds, q, k, ef, max_iters, valid,
                                  n_expand)

    outs_d, outs_i = [], []
    for lo in range(0, b, qchunk):
        d, i = run("block_slice", one_slice, (q_all[lo:lo + qchunk],),
                   (space, eps, valid, seed_sample),
                   (k, ef, max_iters, n_expand))
        outs_d.append(d)
        outs_i.append(i)
    with trace.span("alaya.search.concat", rows=nq):
        return torch.cat(outs_d)[:nq], torch.cat(outs_i)[:nq]
