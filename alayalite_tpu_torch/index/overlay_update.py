"""Online maintenance of the overlay hierarchy (port of
``index/overlay_update.py``).

  - ``extend_overlay``: each inserted node draws a level with
    P(level ≥ l) = R^−l (hnswlib's ``get_random_level``) and is linked into
    every overlay level up to it, bottom-up: it takes a free slot, gets its
    r2 nearest occupants of the level as its row, and each of those rows
    takes it back (a hole if the row has one, else in place of the row's
    farthest edge if the new node is closer: hnswlib's shrink on overflow).
    Levels are padded at build time, so linking fills slots and never grows
    a level; a full level drops the overflow, which stays base-layer only.
  - ``strip_overlay``: removed nodes leave every level at compaction.

The JAX package runs the link as one jitted program (``_extend_overlay_dev``)
with the reverse patch as a ``lax.scan`` over every (member, edge) pair.
Here the levels are written in place, and the patch runs one step per rank
within a row: pairs that hit different rows touch disjoint state, so only
the pairs of one row must run in their (member, edge) order, and the loop
runs as many times as the most pairs any one row receives, each step
vectorized across rows. The host path of the JAX package and its
``ALAYA_OVERLAY_HOST`` switch are left out; the device edition is the one
that runs by default there.
"""

from __future__ import annotations

import numpy as np
import torch

from .graph import Graph, OverlayLevel

Tensor = torch.Tensor
FINF = float("inf")


def draw_levels(rng: np.random.Generator, count: int, r: int,
                max_level: int) -> np.ndarray:
    """floor(−ln U / ln R), capped at the hierarchy's depth: the JAX
    package's draw, the same numbers from the same generator state."""
    ratio = max(2, int(r))
    u = rng.uniform(low=np.finfo(np.float64).tiny, size=count)
    lv = np.floor(-np.log(u) / np.log(ratio)).astype(np.int64)
    return np.minimum(lv, max_level).astype(np.int32)


def extend_overlay(graph: Graph, space, new_ids, rng: np.random.Generator,
                   r: int) -> None:
    """Draw levels for ``new_ids`` (−1 ignored) and link the nodes with a
    level ≥ 1 into the overlay, in place."""
    depth = len(graph.overlay)
    new_ids = np.asarray(new_ids, dtype=np.int32)
    new_ids = new_ids[new_ids >= 0]
    if depth == 0 or new_ids.size == 0:
        return
    lv = draw_levels(rng, new_ids.size, r, depth)
    if not (lv >= 1).any():
        return
    dev = graph.overlay[0].ids.device
    link_overlay(graph.overlay, space,
                 torch.as_tensor(new_ids[lv >= 1], device=dev),
                 torch.as_tensor(lv[lv >= 1], device=dev))


def _dists(space, ids: Tensor, vecs: Tensor, sq: Tensor) -> Tensor:
    """Distances from each of ``vecs`` [G, D] (squared norms ``sq``) to the
    rows ``ids`` [G, K] of the space, in the order of operations the JAX
    program uses."""
    rv = space.data[ids.long()].float()                           # [G, K, D]
    dot = torch.bmm(rv, vecs.unsqueeze(2)).squeeze(2)
    if space.metric == "ip":
        return -dot
    return torch.clamp(space.sq_norms[ids.long()] + sq[:, None] - 2.0 * dot,
                       min=0.0)


def link_overlay(overlay, space, up: Tensor, lv_up: Tensor) -> None:
    """Link the nodes ``up`` [M] (global ids, levels ``lv_up`` ≥ 1) into
    ``overlay`` (top level first), writing each level's tensors in place.

    Per level, bottom-up: the members that reach it (and were placed one
    level below) take the free slots in ascending slot order, in member
    order; each takes as its row its r2 nearest occupants from before the
    batch (ascending, lower slot first among ties); then every (member,
    edge) pair patches the edge's row, in (member, edge) order per row:
    the first hole gets the member, else the row's farthest entry (the
    first of equals) is replaced if the member is closer, judged on the
    row as the earlier pairs left it."""
    depth = len(overlay)
    dev = up.device
    g = up.long()
    qv = space.data[g].float()                                   # [M, D]
    qsq = (space.sq_norms[g] if space.metric != "ip"
           else torch.zeros(g.shape, device=dev))
    M = up.shape[0]
    below_slot = torch.full((M,), -1, dtype=torch.int32, device=dev)
    for li in range(depth - 1, -1, -1):
        L = overlay[li]
        cl, r2 = L.nbrs.shape
        elig = lv_up >= depth - li
        if li < depth - 1:
            elig &= below_slot >= 0       # only nodes placed one level below
        occ = L.ids >= 0                                          # pre-batch
        rank = torch.cumsum(elig.to(torch.int32), 0) - 1
        take = elig & (rank < (~occ).sum())
        free_asc = torch.sort(occ.to(torch.int8), stable=True).indices
        slot = torch.where(take, free_asc[rank.clamp(0, cl - 1)],
                           torch.full_like(rank, -1)).to(torch.int32)

        # member -> pre-batch occupant distances, one product
        lg = torch.where(occ, L.ids, torch.zeros_like(L.ids)).long()
        dots = qv @ space.data[lg].float().T                      # [M, cl]
        if space.metric == "ip":
            d = -dots
        else:
            d = torch.clamp(qsq[:, None] + space.sq_norms[lg][None, :]
                            - 2.0 * dots, min=0.0)
        d = torch.where(occ[None, :] & take[:, None], d,
                        torch.full_like(d, FINF))
        k = min(r2, cl)
        dsel, sel = torch.sort(d, dim=1, stable=True)
        dsel, sel = dsel[:, :k], sel[:, :k].to(torch.int32)
        sel = torch.where(torch.isfinite(dsel), sel, torch.full_like(sel, -1))
        if k < r2:
            sel = torch.nn.functional.pad(sel, (0, r2 - k), value=-1)
            dsel = torch.nn.functional.pad(dsel, (0, r2 - k), value=FINF)

        placed = torch.nonzero(take).reshape(-1)
        s = slot[placed].long()
        L.ids[s] = up[placed].to(L.ids.dtype)
        L.nbrs[s] = sel[placed]
        L.down[s] = (up if li == depth - 1 else below_slot)[placed].to(
            L.down.dtype)
        _reverse_patch(L, space, sel, dsel, take, slot)
        below_slot = slot


def _reverse_patch(L: OverlayLevel, space, sel: Tensor, dsel: Tensor,
                   take: Tensor, slot: Tensor) -> None:
    """Offer each placed member to the rows of its edges (see
    ``link_overlay``): pairs grouped by row, one vectorized step per rank
    within a row."""
    M, r2 = sel.shape
    dev = sel.device
    ok = (sel >= 0) & take[:, None]
    pm = torch.arange(M, device=dev)[:, None].expand(M, r2)[ok]
    pj = torch.arange(r2, device=dev)[None, :].expand(M, r2)[ok]
    pc = sel[ok].long()                     # pairs in (member, edge) order
    if pc.numel() == 0:
        return
    pc, order = torch.sort(pc, stable=True)
    pm, pj = pm[order], pj[order]
    pos = torch.arange(pc.numel(), device=dev)
    first = torch.ones_like(pc, dtype=torch.bool)
    first[1:] = pc[1:] != pc[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    rank, order = torch.sort(rank, stable=True)
    pc, pm, pj = pc[order], pm[order], pj[order]
    counts = torch.bincount(rank).tolist()
    cgid = L.ids[pc].long()                 # pre-batch occupants
    cvec = space.data[cgid].float()
    csq = (space.sq_norms[cgid] if space.metric != "ip"
           else torch.zeros(cgid.shape, device=dev))
    dnew = dsel[pm, pj]
    lo = 0
    for cnt in counts:
        c = pc[lo:lo + cnt]
        row = L.nbrs[c]                                            # [G, r2]
        holes = row < 0
        has_hole = holes.any(1)
        hole_idx = torch.argmax(holes.to(torch.int8), 1)
        rgid = L.ids[row.clamp(min=0).long()]        # placed members too
        rd = _dists(space, rgid, cvec[lo:lo + cnt], csq[lo:lo + cnt])
        rd = torch.where(row >= 0, rd, torch.full_like(rd, -FINF))
        worst = torch.argmax(rd, 1)
        repl = ~has_hole & (dnew[lo:lo + cnt]
                            < torch.gather(rd, 1, worst[:, None])[:, 0])
        idx = torch.where(has_hole, hole_idx, worst)
        write = has_hole | repl
        cur = row.gather(1, idx[:, None])[:, 0]
        L.nbrs[c, idx] = torch.where(write, slot[pm[lo:lo + cnt]], cur)
        lo += cnt


def strip_overlay(graph: Graph, removed) -> None:
    """Drop removed nodes from the overlay levels, in place: their slots
    become free (id −1) and local edges to them become −1. ``down`` entries
    through removed slots are left as they are (a removed node still
    routes, as in the base layer)."""
    if len(graph.overlay) == 0:
        return
    dev = graph.overlay[0].ids.device
    rem = torch.as_tensor(np.asarray(removed, dtype=np.int64), device=dev)
    for lvl in graph.overlay:
        dead = torch.isin(lvl.ids, rem)
        if not bool(dead.any()):
            continue
        nb = lvl.nbrs
        lvl.nbrs.masked_fill_((nb >= 0) & dead[nb.clamp(min=0).long()], -1)
        lvl.ids.masked_fill_(dead, -1)
