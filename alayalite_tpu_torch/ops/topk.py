"""Top-k pool primitives for batched beam search (port of ``ops/topk.py``).

The pool is a fixed-width ``[B, L]`` row per query, merged with candidates
by one stable sort of the concatenated row. Stability is the tie rule the
searches rely on: among equal distances, entries of the first operand come
first. Ids and the per-entry flag ride one int32 payload ``id*2 + flag``
(exact for every id ≥ −1: the arithmetic shift restores the sign).
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def topk_smallest(d: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """(values, indices) of the ``k`` smallest entries per row, ascending,
    lower index first among ties — the order ``lax.top_k(-d, k)`` gives."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


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


def _sorted_payload(d1, p1, d2, p2, k: int):
    cat_d = torch.cat([d1, d2], dim=-1)
    pay = torch.cat([p1, p2], dim=-1)
    sd, order = torch.sort(cat_d, dim=-1, stable=True)
    order = order[..., :k]
    return sd[..., :k], torch.gather(pay, -1, order)


def merge_topk(d1: Tensor, i1: Tensor, d2: Tensor, i2: Tensor,
               k: int) -> Tuple[Tensor, Tensor]:
    """Merge two batched candidate sets by smallest distance → top-k.
    d1 [B, L1], d2 [B, L2] → ([B, k], [B, k]) sorted ascending."""
    return _sorted_payload(d1, i1, d2, i2, k)


def _pack(i: Tensor, f: Tensor) -> Tensor:
    return i * 2 + f.to(torch.int32)


def merge_topk_with_flags(d1, i1, f1, d2, i2, f2,
                          k: int) -> Tuple[Tensor, Tensor, Tensor]:
    """merge_topk carrying a per-entry bool flag (e.g. 'checked')."""
    sd, sp = _sorted_payload(d1, _pack(i1, f1), d2, _pack(i2, f2), k)
    return sd, sp >> 1, (sp & 1) == 1


def merge_topk_dedup(d1, i1, f1, d2, i2, f2,
                     k: int) -> Tuple[Tensor, Tensor, Tensor]:
    """merge_topk_with_flags that also neutralizes duplicate ids.

    Duplicates carry identical (distance, id, flag) triples (within-hop
    candidates all come from the same estimate formula), so after the
    stable sort they are adjacent. The later copy becomes
    ``(inf, -1, checked)``: the pop skips it and the next merge sinks it."""
    sd, sp = _sorted_payload(d1, _pack(i1, f1), d2, _pack(i2, f2), k)
    prev = torch.cat([torch.full_like(sp[..., :1], -3), sp[..., :-1]], dim=-1)
    dup = (sp == prev) & (sp >= 0) & torch.isfinite(sd)
    sd = torch.where(dup, torch.full_like(sd, float("inf")), sd)
    ids = torch.where(dup, torch.full_like(sp, -1), sp >> 1)
    flags = ((sp & 1) == 1) | dup
    return sd, ids, flags
