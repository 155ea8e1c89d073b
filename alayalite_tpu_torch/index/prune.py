"""Batched edge selection under the occlusion (MRNG) rule (port of part of
``index/prune.py``).

For a chunk of nodes at once: walk each node's candidates in ascending
distance and keep candidate ``j`` unless some kept ``t`` is closer to it
than the node is (``d(t, j) < d(node, j)``). The candidate↔candidate
distances ``[C, M, M]`` come from one batched product; the greedy walk is a
Python loop over the M candidate ranks, vectorized across nodes.
"""

from __future__ import annotations

import torch

from ..ops.topk import topk_smallest

Tensor = torch.Tensor
FINF = float("inf")


def _sort_dedup(cand_d: Tensor, cand_i: Tensor):
    """Per row: drop duplicate ids (keep the closest), sort ascending."""
    d, order = torch.sort(cand_d, dim=1, stable=True)
    i = torch.gather(cand_i, 1, order)
    si, order_i = torch.sort(i, dim=1, stable=True)
    sd = torch.gather(d, 1, order_i)
    prev = torch.cat([torch.full_like(si[:, :1], -2), si[:, :-1]], dim=1)
    keep = (si >= 0) & (si != prev)
    sd = torch.where(keep, sd, torch.full_like(sd, FINF))
    si = torch.where(keep, si, torch.full_like(si, -1))
    sd, order = torch.sort(sd, dim=1, stable=True)
    return sd, torch.gather(si, 1, order)


def occlusion_prune_chunk(space, cand_d: Tensor, cand_i: Tensor, r: int,
                          alpha: float = 1.0, bf16: bool = True) -> Tensor:
    """Select ≤ r edges per node under the occlusion rule. Returns [C, r]
    i32, −1 padded. With ``bf16`` candidate pairs are scored from bf16
    vectors (products and sums in f32), what the JAX package's builders
    ask for: pair distances only gate selection; the insert's choice of
    batch mates scores them in f32, as there.

    Two rules carried over from the JAX package:
      - the threshold for alpha ≠ 1 is d_j / alpha where d_j ≥ 0 and
        d_j · alpha where d_j < 0 (the −IP convention goes negative; both
        shrink the occluded region as alpha grows);
      - two passes: alpha = 1 first (the diverse backbone), then alpha only
        fills rows that still have room.
    """
    C, M = cand_i.shape
    cand_d, cand_i = _sort_dedup(cand_d, cand_i)
    valid = cand_i >= 0
    safe = torch.where(valid, cand_i, torch.zeros_like(cand_i)).reshape(-1)
    vecs = space.data.index_select(0, safe).view(C, M, -1)
    vecs = vecs.to(torch.bfloat16).float() if bf16 else vecs.float()
    dots = torch.bmm(vecs, vecs.transpose(1, 2))                    # [C, M, M]
    if space.metric == "ip":
        pair_d = -dots
    else:
        sq = space.sq_norms.index_select(0, safe).view(C, M)
        pair_d = torch.clamp(sq[:, :, None] + sq[:, None, :] - 2.0 * dots,
                             min=0.0)
    # pair_t[:, j, :] == pair_d[:, :, j], contiguous per step
    pair_t = pair_d.transpose(1, 2).contiguous()
    del dots, pair_d, vecs
    return occlude_greedy(cand_d, cand_i, pair_t, r, alpha)


def occlude_greedy(cand_d: Tensor, cand_i: Tensor, pair_t: Tensor, r: int,
                   alpha: float = 1.0) -> Tensor:
    """The occlusion rule's greedy walk over candidates sorted ascending
    (ids −1 / inf padded) with their pair distances ``pair_t`` [C, M, M]
    (``pair_t[:, j, t]`` = d(t, j)). Returns [C, r] i32, −1 padded."""
    C, M = cand_i.shape
    valid = cand_i >= 0
    usable = valid & torch.isfinite(cand_d)

    selected = torch.zeros((C, M), dtype=torch.bool, device=cand_d.device)
    count = torch.zeros((C,), dtype=torch.int32, device=cand_d.device)
    passes = [1.0] if alpha == 1.0 else [1.0, float(alpha)]
    for a in passes:
        if a == 1.0:
            thr = cand_d
        else:
            thr = cand_d * torch.where(cand_d >= 0,
                                       torch.full_like(cand_d, 1.0 / a),
                                       torch.full_like(cand_d, a))
        for j in range(M):
            occ = (selected & (pair_t[:, j, :] < thr[:, j:j + 1])).any(1)
            take = usable[:, j] & ~occ & (count < r) & ~selected[:, j]
            selected[:, j] |= take
            count += take.to(torch.int32)

    # compact the selected ids to the left, −1 pad
    sel_d = torch.where(selected, cand_d, torch.full_like(cand_d, FINF))
    _, order = topk_smallest(sel_d, r)
    return torch.gather(torch.where(selected, cand_i,
                                    torch.full_like(cand_i, -1)), 1, order)
