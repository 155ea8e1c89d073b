"""Batched lockstep beam search (port of part of ``index/search.py``).

B queries advance one hop per loop step. Per-query state:
  pool_d / pool_i / pool_c : the ef-wide best-first pool, kept sorted, with
                             the checked ("expanded") flag;
  popring                  : every node the loop can expand (M · max_iters
                             slots), so no node is expanded twice.
A query is done when its pool holds no unchecked entry. ``lax.while_loop``
becomes a Python loop whose test (``any`` unchecked) is one host sync per
hop.

Ported: ``_pop_best_m``, ``beam_search`` in "ring" visited mode (the build's
raw pools), ``block_beam_search`` (without the 1-bit result pool, which only
rabitq uses), ``seed_sample_arrays``, ``scan_seeds`` and
``block_search_device``. ``scan_seeds`` takes the exact top-k where the JAX
package takes ``lax.approx_max_k``: a superset of what the approximation
can return, and one reason result ids differ between the packages. The raw
graph search (overlay descent, bitmask visited mode) waits in ROADMAP
queue 1, item 8.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.topk import merge_topk_dedup, topk_smallest

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
    stale = (cand_ids[:, :, None] == popring[:, None, :]).any(2)
    fresh = (cand_ids >= 0) & ~stale
    d = _inf_where_not(fresh, space.gather_dists(
        q, torch.where(fresh, cand_ids, torch.zeros_like(cand_ids))))
    return merge_topk_dedup(pool_d, pool_i, pool_c, d,
                            _neg1_where_not(fresh, cand_ids),
                            torch.zeros_like(fresh), ef)


def _init_pool(B: int, L: int, device):
    return (torch.full((B, L), FINF, device=device),
            torch.full((B, L), -1, dtype=torch.int32, device=device),
            torch.zeros((B, L), dtype=torch.bool, device=device))


def beam_search(space, nbrs: Tensor, seeds: Tensor, queries: Tensor, k: int,
                ef: int, max_iters: int = 0,
                n_expand: int = 1) -> Tuple[Tensor, Tensor]:
    """Beam search over a raw space and adjacency ``nbrs`` [C, R], "ring"
    visited mode. Returns (dists [B, k] f32, ids [B, k] i32, −1 absent)."""
    B = queries.shape[0]
    L = max(int(ef), int(k))
    M = max(1, int(n_expand))
    max_iters = _default_iters(L, M, max_iters)
    dev = queries.device
    popring = torch.full((B, _popring_width(M, max_iters)), -1,
                         dtype=torch.int32, device=dev)
    pool_d, pool_i, pool_c = _expand_popring(
        space, queries, popring, *_init_pool(B, L, dev), seeds, L)
    for _ in range(max_iters):
        if not bool(_has_next(pool_d, pool_i, pool_c).any()):
            break
        u, active, pool_c = _pop_best_m(pool_d, pool_i, pool_c, M)
        u_safe = torch.where(active, u, torch.zeros_like(u))
        nb = nbrs.index_select(0, u_safe.reshape(-1)).view(B, M, -1)
        nb = _neg1_where_not(active[:, :, None], nb).reshape(B, -1)
        popring = torch.cat([popring[:, M:], _neg1_where_not(active, u)], 1)
        pool_d, pool_i, pool_c = _expand_popring(
            space, queries, popring, pool_d, pool_i, pool_c, nb, L)

    out_d, sel = topk_smallest(_inf_where_not(pool_i >= 0, pool_d), k)
    ids = torch.gather(pool_i, 1, sel)
    return out_d, _neg1_where_not(torch.isfinite(out_d), ids)


def block_beam_search(space, seeds: Tensor, queries: Tensor, k: int, ef: int,
                      max_iters: int = 0, valid: Optional[Tensor] = None,
                      n_expand: int = 1) -> Tuple[Tensor, Tensor]:
    """Beam search over a block space (BQGSpace): each popped node costs one
    fat row gather, neighbors are scored by the block estimator, and the
    final pool is re-ranked with exact raw distances."""
    B = queries.shape[0]
    C = space.capacity
    L = max(int(ef), int(k))
    M = max(1, int(n_expand))
    max_iters = _default_iters(L, M, max_iters)
    dev = queries.device
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

    for _ in range(max_iters):
        if not bool(_has_next(pool_d, pool_i, pool_c).any()):
            break
        u, active, pool_c = _pop_best_m(pool_d, pool_i, pool_c, M)
        u_safe = torch.where(active, u, torch.zeros_like(u))
        popring = torch.cat([popring[:, M:], _neg1_where_not(active, u)], 1)
        est, nids = space.estimate_many(ctx, u_safe)           # [B, M*R]
        R = nids.shape[1] // M
        nids = _neg1_where_not(active.repeat_interleave(R, dim=1), nids)
        # stale = already expanded or already pooled; the [B, M*R, P+L]
        # compare is allocated per hop (~235 MB at B=4096, ef=128)
        seen = torch.cat([popring, pool_i], dim=1)
        stale = (nids[:, :, None] == seen[:, None, :]).any(2)
        fresh = (nids >= 0) & ~stale
        pool_d, pool_i, pool_c = merge_topk_dedup(
            pool_d, pool_i, pool_c, _inf_where_not(fresh, est),
            _neg1_where_not(fresh, nids), torch.zeros_like(fresh), L)

    # exact rerank of the whole pool
    ok = pool_i >= 0
    d_exact = space.gather_dists(
        queries, torch.where(ok, pool_i, torch.zeros_like(pool_i)))
    if valid is not None:
        ok &= valid[pool_i.clamp(0, C - 1).long()]
    # safety net against two live copies of one id in the pool
    tril = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev), -1)
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
