"""Batched lockstep beam search (port of part of ``index/search.py``).

B queries advance one hop per loop step. Per-query state:
  pool_d / pool_i / pool_c : the ef-wide best-first pool, kept sorted, with
                             the checked ("expanded") flag;
  popring                  : every node the loop can expand (M · max_iters
                             slots), so no node is expanded twice.
A query is done when its pool holds no unchecked entry. ``lax.while_loop``
becomes a Python loop whose test (``any`` unchecked) is one host sync per
hop.

Ported: ``_pop_best_m``, ``beam_search`` in both visited modes ("ring":
the pop ring and the merge's dedup; "bitmask": an exact per-query bitset),
``overlay_descend``, ``graph_seeds`` and ``graph_search_device`` (the raw
graph query: overlay descent, beam, exact re-score), ``block_beam_search``
(with the 1-bit result pool of rabitq; the JAX package's
``rabitq_beam_search`` is this function), ``seed_sample_arrays``,
``scan_seeds`` and ``block_search_device``.
``scan_seeds`` takes the exact top-k where the JAX package takes
``lax.approx_max_k``: a superset of what the approximation can return, and
one reason result ids differ between the packages. Every pool merge is
``ops/topk.merge_topk_dedup`` or ``merge_topk_with_flags``: on a CUDA tensor
the hand-written ``pool_merge`` kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.ring_probe import ring_probe
from ..ops.topk import (merge_topk_dedup, merge_topk_with_flags,
                        topk_smallest)

Tensor = torch.Tensor
FINF = float("inf")


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


def beam_search(space, nbrs: Tensor, seeds: Tensor, queries: Tensor, k: int,
                ef: int, max_iters: int = 0, valid: Optional[Tensor] = None,
                n_expand: int = 1, visited_mode: str = "ring",
                ) -> Tuple[Tensor, Tensor]:
    """Beam search over a space with ``gather_dists`` and the adjacency
    ``nbrs`` [C, R]. ``valid`` [C] bool filters the results (tombstones:
    the walk still routes through removed nodes). ``visited_mode``: "ring"
    (the pop ring plus the merge's dedup, scatter-free) or "bitmask" (an
    exact bitset per query, [B, C / 32] words). Returns (dists [B, k] f32,
    ids [B, k] i32, −1 absent)."""
    if visited_mode not in ("ring", "bitmask"):
        raise ValueError(f"unknown visited_mode {visited_mode!r}")
    B = queries.shape[0]
    C = nbrs.shape[0]
    L = max(int(ef), int(k))
    M = max(1, int(n_expand))
    max_iters = _default_iters(L, M, max_iters)
    dev = queries.device
    if visited_mode == "ring":
        visited = torch.full((B, _popring_width(M, max_iters)), -1,
                             dtype=torch.int32, device=dev)
        expand = _expand_popring
    else:
        visited = torch.zeros((B, -(-C // 32)), dtype=torch.int32, device=dev)
        expand = _expand
    pool_d, pool_i, pool_c = expand(space, queries, visited,
                                    *_init_pool(B, L, dev), seeds, L)
    for _ in range(max_iters):
        if not bool(_has_next(pool_d, pool_i, pool_c).any()):
            break
        u, active, pool_c = _pop_best_m(pool_d, pool_i, pool_c, M)
        u_safe = torch.where(active, u, torch.zeros_like(u))
        nb = nbrs.index_select(0, u_safe.reshape(-1)).view(B, M, -1)
        nb = _neg1_where_not(active[:, :, None], nb).reshape(B, -1)
        if visited_mode == "ring":
            visited = torch.cat([visited[:, M:], _neg1_where_not(active, u)],
                                1)
        pool_d, pool_i, pool_c = expand(space, queries, visited, pool_d,
                                        pool_i, pool_c, nb, L)

    ok = pool_i >= 0
    if valid is not None:
        ok &= valid[pool_i.clamp(0, C - 1).long()]
    out_d, sel = topk_smallest(_inf_where_not(ok, pool_d), k)
    ids = torch.gather(pool_i, 1, sel)
    return out_d, _neg1_where_not(torch.isfinite(out_d), ids)


def overlay_descend(space, level_ids: Tensor, level_nbrs: Tensor,
                    level_down: Tensor, start: Tensor,
                    queries: Tensor) -> Tensor:
    """Greedy descent within one overlay level, batched over queries: each
    query moves to its best neighbor while that improves. ``start`` [B]
    local indices; returns [B] local indices into the level below. The
    loop's test (``any`` improved) is one host sync per step;
    ``overlay_descend.syncs`` counts them."""
    cur = start
    cur_d = space.gather_dists(
        queries, level_ids[cur.long()][:, None])[:, 0]
    improved = torch.ones_like(cur, dtype=torch.bool)
    while True:
        overlay_descend.syncs += 1
        if not bool(improved.any()):
            break
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
        cur = overlay_descend(space, lvl.ids, lvl.nbrs, lvl.down, cur,
                              queries)
    ok = live.any() & (cur >= 0)
    return torch.where(ok, cur, eps[0])[:, None]


def exact_rescore(space, q: Tensor, ids: Tensor, k: int):
    """Exact f32 distances of candidate ``ids`` [B, C] (−1 absent) to
    ``q`` [B, D] from the stored rows (full f32 products), then the ``k``
    best: the user-facing re-score; ``gather_dists`` only orders a walk."""
    ok = ids >= 0
    safe = torch.where(ok, ids, torch.zeros_like(ids)).long()
    dot = torch.bmm(space.data[safe].float(), q.unsqueeze(2)).squeeze(2)
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
    """The raw graph query over a batch in slices of ``qchunk``: overlay
    descent, lockstep beam, and (``exact_rerank``, for a space that stores
    the rows) the exact re-score of the k results."""
    outs_d, outs_i = [], []
    for lo in range(0, q_all.shape[0], qchunk):
        q = q_all[lo:lo + qchunk]
        seeds = graph_seeds(space, eps, overlay, q)
        d, i = beam_search(space, nbrs, seeds, q, k=k, ef=ef,
                           max_iters=max_iters, valid=valid,
                           n_expand=n_expand, visited_mode=visited_mode)
        if exact_rerank:
            d, i = exact_rescore(space, q, i, k)
        outs_d.append(d)
        outs_i.append(i)
    return torch.cat(outs_d), torch.cat(outs_i)


def block_beam_search(space, seeds: Tensor, queries: Tensor, k: int, ef: int,
                      max_iters: int = 0, valid: Optional[Tensor] = None,
                      n_expand: int = 1) -> Tuple[Tensor, Tensor]:
    """Beam search over a block space (BQGSpace, RaBitQSpace): each popped
    node's block is read by the space's ``estimate_many`` (bsq8: one
    ``gather_estimate`` launch a hop; rabitq: one ``block_diagdot``), which
    scores its neighbors with the block estimator, ``ring_probe`` drops the
    ones already expanded or pooled, and the final pool is re-ranked with
    exact raw distances.

    A 1-bit space (``space.bits == 1``) also keeps the result pool: the
    exact distances of the popped nodes, which the estimator needs as its
    ``d_center`` anyway (gathered once a hop and handed to it), merge into
    a k-wide pool (one ``merge_topk_dedup`` of [B, k + M] a hop) that the
    final rerank unions in, so a true neighbor once popped cannot be lost
    to the estimates' noise."""
    B = queries.shape[0]
    C = space.capacity
    L = max(int(ef), int(k))
    M = max(1, int(n_expand))
    max_iters = _default_iters(L, M, max_iters)
    dev = queries.device
    res_pool = getattr(space, "bits", 0) == 1
    ctx = space.query_ctx(queries)
    popring = torch.full((B, _popring_width(M, max_iters)), -1,
                         dtype=torch.int32, device=dev)

    # seeds enter with exact distances (duplicate seeds collapse in the merge)
    seed_ok = seeds >= 0
    d_seed = _inf_where_not(seed_ok, space.gather_dists(
        queries, torch.where(seed_ok, seeds, torch.zeros_like(seeds))))
    pool_d, pool_i, pool_c = merge_topk_dedup(
        *_init_pool(B, L, dev), d_seed, _neg1_where_not(seed_ok, seeds),
        torch.zeros_like(seed_ok), L)
    res_d = torch.full((B, int(k)), FINF, device=dev)
    res_i = torch.full((B, int(k)), -1, dtype=torch.int32, device=dev)

    for _ in range(max_iters):
        if not bool(_has_next(pool_d, pool_i, pool_c).any()):
            break
        u, active, pool_c = _pop_best_m(pool_d, pool_i, pool_c, M)
        u_safe = torch.where(active, u, torch.zeros_like(u))
        popring = torch.cat([popring[:, M:], _neg1_where_not(active, u)], 1)
        if res_pool:
            du = space.gather_dists(queries, u_safe)           # [B, M]
            res_d, res_i, _ = merge_topk_dedup(
                res_d, res_i, torch.zeros_like(res_i, dtype=torch.bool),
                _inf_where_not(active, du), _neg1_where_not(active, u),
                torch.zeros_like(active), int(k))
            est, nids = space.estimate_many(ctx, u_safe, d_center=du)
        else:
            est, nids = space.estimate_many(ctx, u_safe)       # [B, M*R]
        R = nids.shape[1] // M
        nids = _neg1_where_not(active.repeat_interleave(R, dim=1), nids)
        # stale = already expanded (the pop ring) or already pooled
        stale = ring_probe(nids, popring, pool_i)
        fresh = (nids >= 0) & ~stale
        pool_d, pool_i, pool_c = merge_topk_dedup(
            pool_d, pool_i, pool_c, _inf_where_not(fresh, est),
            _neg1_where_not(fresh, nids), torch.zeros_like(fresh), L)

    # exact rerank of the whole pool (and the result pool's exact entries)
    d_exact = space.gather_dists(
        queries, torch.where(pool_i >= 0, pool_i, torch.zeros_like(pool_i)))
    if res_pool:
        pool_i = torch.cat([pool_i, res_i], 1)
        d_exact = torch.cat([d_exact, res_d], 1)
    ok = pool_i >= 0
    if valid is not None:
        ok &= valid[pool_i.clamp(0, C - 1).long()]
    # safety net against two live copies of one id in the pool (and a
    # popped node in both pools)
    W = pool_i.shape[1]
    tril = torch.tril(torch.ones((W, W), dtype=torch.bool, device=dev), -1)
    dup = ((pool_i[:, :, None] == pool_i[:, None, :]) & tril[None]).any(2)
    out_d, sel = topk_smallest(_inf_where_not(ok & ~dup, d_exact), k)
    ids = torch.gather(pool_i, 1, sel)
    return out_d, _neg1_where_not(torch.isfinite(out_d), ids)


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
    values multiplied and summed in f32, then the exact ``nseed`` best."""
    dot = q.to(torch.bfloat16).float() @ sample_vecs.float().T    # [B, S]
    d = sample_sq[None, :] - 2.0 * dot
    _, sel = torch.topk(d, min(nseed, d.shape[1]), dim=1, largest=False)
    return sample_ids[sel]


def block_search_device(space, eps: Tensor, q_all: Tensor, k: int, ef: int,
                        max_iters: int = 0, valid: Optional[Tensor] = None,
                        n_expand: int = 8, qchunk: int = 4096,
                        seed_sample=None) -> Tuple[Tensor, Tensor]:
    """``block_beam_search`` over a query batch in slices of ``qchunk``.
    ``seed_sample`` = (ids, vecs bf16, sq_norms) enables the per-query seed
    scan; None starts every query from the shared entry points ``eps``."""
    outs_d, outs_i = [], []
    for lo in range(0, q_all.shape[0], qchunk):
        q = q_all[lo:lo + qchunk]
        if seed_sample is not None:
            seeds = scan_seeds(q, *seed_sample)
        else:
            seeds = eps[None, :].expand(q.shape[0], -1)
        d, i = block_beam_search(space, seeds, q, k=k, ef=ef,
                                 max_iters=max_iters, valid=valid,
                                 n_expand=n_expand)
        outs_d.append(d)
        outs_i.append(i)
    return torch.cat(outs_d), torch.cat(outs_i)
