"""Top-k pool primitives for batched beam search (port of ``ops/topk.py``).

The pool is a fixed-width ``[B, L]`` row per query, merged with candidates
by one stable sort of the concatenated row. Stability is the tie rule the
searches rely on: among equal distances, entries of the first operand come
first. The sort is ``ops/pool_sort``: on a CUDA tensor the hand-written
kernels (``pool_merge`` for the three merges, ``sort_kv`` for
``topk_smallest``), on a CPU tensor their plain versions, with the same
values, ids and flags either way.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .pool_sort import pool_merge, sort_kv

Tensor = torch.Tensor


def topk_smallest(d: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """(values, indices) of the ``k`` smallest entries per row, ascending,
    lower index first among ties — the order ``lax.top_k(-d, k)`` gives."""
    lead = d.shape[:-1]
    vals, _, idx = sort_kv(d.reshape(-1, d.shape[-1]).contiguous(),
                           k=min(int(k), d.shape[-1]), return_index=True)
    return vals.view(*lead, -1), idx.view(*lead, -1)


def select_smallest(d: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``topk_smallest`` for wide rows, without a full sort: the ``k``
    entries ``torch.topk`` selects, ascending, lower index first among
    ties. Where several entries tie at the k-th place, which of them are
    kept is ``torch.topk``'s choice (``lax.top_k`` keeps the lower
    indices)."""
    vals, idx = torch.topk(d, k, dim=-1, largest=False, sorted=False)
    idx, order = torch.sort(idx, dim=-1)
    vals, order2 = torch.sort(torch.gather(vals, -1, order), dim=-1,
                              stable=True)
    return vals, torch.gather(idx, -1, order2)


def merge_topk(d1: Tensor, i1: Tensor, d2: Tensor, i2: Tensor,
               k: int) -> Tuple[Tensor, Tensor]:
    """Merge two batched candidate sets by smallest distance → top-k.
    d1 [B, L1], d2 [B, L2] → ([B, k], [B, k]) sorted ascending."""
    sd, ids, _ = pool_merge(d1.contiguous(), i1.contiguous(), None,
                            d2.contiguous(), i2.contiguous(), None, k)
    return sd, ids


def merge_topk_with_flags(d1, i1, f1, d2, i2, f2,
                          k: int) -> Tuple[Tensor, Tensor, Tensor]:
    """merge_topk carrying a per-entry bool flag (e.g. 'checked')."""
    return pool_merge(d1.contiguous(), i1.contiguous(), f1.contiguous(),
                      d2.contiguous(), i2.contiguous(), f2.contiguous(), k)


def merge_topk_dedup(d1, i1, f1, d2, i2, f2,
                     k: int) -> Tuple[Tensor, Tensor, Tensor]:
    """merge_topk_with_flags that also neutralizes duplicate ids.

    Duplicates carry identical (distance, id, flag) triples (within-hop
    candidates all come from the same estimate formula), so after the
    stable sort they are adjacent. The later copy becomes
    ``(inf, -1, checked)``: the pop skips it and the next merge sinks it."""
    return pool_merge(d1.contiguous(), i1.contiguous(), f1.contiguous(),
                      d2.contiguous(), i2.contiguous(), f2.contiguous(), k,
                      dedup=True)
