"""Online insert: ``fused_block_insert`` for block (bsq8) indices and
``fused_raw_connect`` for raw graphs (port of ``index/fused_insert.py``).

One bsq8 batch runs the whole insert-and-update pipeline on the device:

  1. beam-search each new vector's top-R edges (block estimates + exact
     rerank), over the nodes that exist before the batch;
  2. append the raw vectors at the bump pointer; the new rows are the exact
     top-R of [searched edges ∪ up to 4 nearest batch mates]; encode their
     packed blocks;
  3. bounded reverse table ``[C, w]``: which new nodes point at each
     touched node (slot ``slot_rand[b, j]`` of the edge's row; where
     proposals collide the last in (b, j) order stays);
  4. re-select and re-encode every touched node's block: candidates =
     its current edges ∪ the new sources pointing at it, top-R by exact
     distance.

The JAX function is one jitted program over donated buffers, padded to a
bucket size. Here the batch is padded the same way by the caller, every
step is fixed in shape (no boolean-mask indexing, no ``torch.unique``, so
no host sync), and the adjacency and the space are written in place: on
the card step 1 is one replay of the search's captured graph, the append
one eager copy, and steps 2-4 one replay of an in-place graph
(``captured.run_inplace``). The touched set is the ``[B·R]`` list with
repeats and −1, as JAX's: every repeat computes its row from the one
snapshot after step 2, so repeats write identical rows. A masked entry (a
padded row, a row past the capacity, a −1 edge) writes no real row: it
repeats a kept entry's write (``raw.put_rows``), where JAX aims it at a
dropped index. Random draws (``slot_rand``) are the caller's inputs.

``fused_raw_connect`` links a batch already searched and appended into a
raw graph's adjacency; see its docstring.
"""

from __future__ import annotations

import torch

from ..ops.topk import select_smallest
from ..spaces import bqg
from ..spaces.raw import put_rows
from . import captured
from .prune import _sort_dedup, occlusion_prune_chunk
from .search import block_search_device

Tensor = torch.Tensor
FINF = float("inf")
MATES = 4             # within-batch candidates per new row
TOUCHED_CHUNK = 8192  # touched rows per step of the re-selection


def _bqg_exact_dists(space, q: Tensor, ids: Tensor) -> Tensor:
    """Exact distances from q [T, D] to ids [T, K], inf on −1 slots."""
    d = space.gather_dists(q, ids.clamp(min=0))
    return torch.where(ids >= 0, d, torch.full_like(d, FINF))


def _batch_mates(space, v: Tensor, new_ids: Tensor):
    """Each new row's ``MATES`` nearest rows of its own batch: (distances
    [B, kb], ids [B, kb], −1 where there is none). The search of step 1
    cannot return same-batch nodes; without these edges a batch of outliers
    forms an island no search reaches. The cap keeps a batch that lands in
    one tight region from crowding the searched edges out of the row."""
    B = v.shape[0]
    ok = new_ids >= 0
    dot = v @ v.T
    if space.metric == "ip":
        pin = -dot
    else:
        vsq = (v * v).sum(-1)
        pin = torch.clamp(vsq[:, None] + vsq[None, :] - 2.0 * dot, min=0.0)
    bad = ~ok[None, :] | ~ok[:, None] | torch.eye(B, dtype=torch.bool,
                                                  device=v.device)
    pin = torch.where(bad, torch.full_like(pin, FINF), pin)
    d_in, sel = select_smallest(pin, min(MATES, B))
    ids = torch.where(torch.isfinite(d_in), new_ids[sel],
                      torch.full_like(sel, -1, dtype=torch.int32))
    return d_in, ids


def fused_block_insert(space, graph_nbrs: Tensor, eps: Tensor, vecs: Tensor,
                       count: int, slot_rand: Tensor, seed_sample, r: int,
                       w: int, ef: int, iters: int, m: int) -> Tensor:
    """Insert the first ``count`` rows of ``vecs`` [B, D] (the rest is the
    bucket's padding) into the block space and the adjacency
    ``graph_nbrs`` [C, R], both updated in place. ``slot_rand`` [B, r]
    (ints in [0, w)) are the reverse table's slots, drawn by the caller.
    Returns the new ids [B] i32, −1 for padding and where the capacity was
    exhausted."""
    B = vecs.shape[0]
    v = space.prep_query(vecs)

    # 1. edges for the new nodes, among the nodes that exist already
    d_nb, ids_nb = block_search_device(
        space, eps, v, k=r, ef=max(ef, r), max_iters=iters, valid=space.valid,
        n_expand=m, qchunk=B, seed_sample=seed_sample)

    # 2a. append at the bump pointer (insert_raw normalizes under cos)
    new_ids = space.insert_raw(vecs[:count])
    if count < B:
        new_ids = torch.cat([new_ids, torch.full(
            (B - count,), -1, dtype=torch.int32, device=vecs.device)])

    # 2b-4 in place
    def connect(v, new_ids, d_nb, ids_nb, slot_rand):
        _block_connect(space, graph_nbrs, v, new_ids, d_nb, ids_nb,
                       slot_rand, r, w)
        return ()

    inputs = (v, new_ids, d_nb, ids_nb, slot_rand)
    captured.run_inplace(
        "block_connect", connect, inputs,
        (v, torch.full_like(new_ids, -1), d_nb, ids_nb, slot_rand),
        writes=(space, graph_nbrs),
        static=(r, w, MATES, TOUCHED_CHUNK, bqg.ENCODE_CHUNK))
    return new_ids


def _block_connect(space, graph_nbrs: Tensor, v: Tensor, new_ids: Tensor,
                   d_nb: Tensor, ids_nb: Tensor, slot_rand: Tensor, r: int,
                   w: int) -> None:
    """Steps 2b-4 of ``fused_block_insert`` over the appended rows
    ``new_ids`` (−1 masked), in place."""
    B = v.shape[0]
    C = space.capacity
    dev = v.device
    ok = new_ids >= 0
    d_in, batch_ids = _batch_mates(space, v, new_ids)
    cand = torch.cat([ids_nb, batch_ids], dim=1)
    cand_d = torch.cat([torch.where(ids_nb >= 0, d_nb,
                                    torch.full_like(d_nb, FINF)), d_in], dim=1)
    _, sorted_ids = _sort_dedup(cand_d, cand)
    rows_new = torch.where(ok[:, None], sorted_ids[:, :r],
                           torch.full_like(sorted_ids[:, :r], -1))
    space.set_neighbor_rows(new_ids, rows_new)
    put_rows(graph_nbrs, new_ids, rows_new, ok)

    # 3. bounded reverse table; the last proposal in (b, j) order wins
    real = (rows_new >= 0).reshape(-1)
    dst = rows_new.reshape(-1).long()
    rev = _reverse_table(dst, real, slot_rand, new_ids, C, w)

    # 4. re-select every touched row from one snapshot, then write
    touched = torch.where(real, dst, torch.full_like(dst, -1))
    t_safe = torch.where(real, dst, torch.zeros_like(dst))
    rows_t = torch.empty((B * r, r), dtype=torch.int32, device=dev)
    for lo in range(0, B * r, TOUCHED_CHUNK):
        t = t_safe[lo:lo + TOUCHED_CHUNK]
        cand = torch.cat([space.nbr_ids[t], rev[t]], dim=1)
        cand = torch.where(cand == t[:, None], torch.full_like(cand, -1),
                           cand)                               # no self-loop
        cd = _bqg_exact_dists(space, space.data[t], cand)
        rows_t[lo:lo + TOUCHED_CHUNK] = _sort_dedup(cd, cand)[1][:, :r]
    space.set_neighbor_rows(touched, rows_t)
    put_rows(graph_nbrs, touched, rows_t, real)


def _reverse_table(dst: Tensor, real: Tensor, slot_rand: Tensor,
                   new_ids: Tensor, C: int, w: int) -> Tensor:
    """The bounded reverse table [C, w]: entry e = (b, j) of the flat
    edge list proposes new node b at slot ``slot_rand[b, j]`` of row
    ``dst[e]``; where proposals collide the last in (b, j) order stays
    (a scatter of the positions' maximum, so the result does not depend
    on the order of the writes). Masked entries land in a scratch cell."""
    n_e = dst.shape[0]
    B = new_ids.shape[0]
    cell = torch.where(real, dst * w + slot_rand.reshape(-1).long(),
                       torch.full_like(dst, C * w))
    pos = torch.arange(n_e, device=dst.device)
    win = torch.full((C * w + 1,), -1, dtype=torch.int64, device=dst.device)
    win.scatter_reduce_(0, cell, torch.where(real, pos, -1), reduce="amax")
    win = win[:C * w]
    src = new_ids[:, None].expand(B, n_e // B).reshape(-1)
    return torch.where(win >= 0, src[win.clamp(min=0)],
                       torch.full_like(win, -1, dtype=torch.int32)).view(C, w)


def _reprune_rows(space, graph_nbrs: Tensor, rev: Tensor, t: Tensor,
                  row_w: int, alpha: float) -> Tensor:
    """The connect's re-selection of the rows ``t`` [T] (all valid ids):
    candidates = current row ∪ reverse reservoir, the parallel occlusion
    rule over one bf16 gather, then the fill by unselected current edges
    in distance order. Returns [T, row_w] i32, −1 padded."""
    T = t.shape[0]
    dev = t.device
    cand = torch.cat([graph_nbrs[t], rev[t]], dim=1)              # [T, M]
    mm = cand.shape[1]
    safe = cand.clamp(min=0).long()
    vecs = space.data[safe].to(torch.bfloat16)                     # [T, M, D]
    q = space.data[t].to(torch.bfloat16).float()
    # products of the bf16 values, summed in f32
    dot = torch.bmm(vecs.float(), q.unsqueeze(2)).squeeze(2)
    d = (-dot if space.metric == "ip" else torch.clamp(
        space.sq_norms[t][:, None] + space.sq_norms[safe] - 2.0 * dot,
        min=0.0))
    d = torch.where((cand >= 0) & (cand != t[:, None]), d,
                    torch.full_like(d, FINF))
    d_s, ord_c = torch.sort(d, dim=1, stable=True)                # sort 1
    cand_s = torch.gather(cand, 1, ord_c)
    nearer = torch.triu(torch.ones((mm, mm), dtype=torch.bool, device=dev),
                        diagonal=1)[None]                          # i < j
    dup = ((cand_s[:, None, :] == cand_s[:, :, None]) & nearer).any(1)
    cand_s = torch.where(dup, torch.full_like(cand_s, -1), cand_s)
    d_s = torch.where(dup, torch.full_like(d_s, FINF), d_s)
    vs = torch.gather(vecs, 1, ord_c[:, :, None].expand(-1, -1,
                                                        vecs.shape[2]))
    vs = vs.float()
    dots = torch.bmm(vs, vs.transpose(1, 2))                       # [T, M, M]
    del vs
    if space.metric == "ip":
        pair_d = dots.neg_()
    else:
        sq_s = torch.gather(space.sq_norms[safe], 1, ord_c)
        pair_d = torch.clamp(sq_s[:, :, None] + sq_s[:, None, :]
                             - 2.0 * dots, min=0.0)
    del dots
    thr = (d_s if alpha == 1.0 else
           d_s * torch.where(d_s >= 0, torch.full_like(d_s, 1.0 / alpha),
                             torch.full_like(d_s, alpha)))
    occ = (nearer & (cand_s >= 0)[:, :, None]
           & (pair_d < thr[:, None, :])).any(1)
    del pair_d
    fin = torch.isfinite(d_s) & (cand_s >= 0)
    selected = fin & ~occ
    was_cur = ord_c < row_w
    prio = torch.where(selected, torch.zeros_like(ord_c),
                       torch.where(was_cur & fin, torch.ones_like(ord_c),
                                   torch.full_like(ord_c, 2)))
    key = prio * mm + torch.arange(mm, device=dev)[None, :]
    ord2 = torch.sort(key, dim=1).indices[:, :row_w]               # sort 2
    out = torch.gather(cand_s, 1, ord2)
    return torch.where(torch.gather(prio, 1, ord2) < 2, out,
                       torch.full_like(out, -1))


def fused_raw_connect(space, graph_nbrs: Tensor, new_ids: Tensor,
                      new_rows: Tensor, slot_rand: Tensor, row_w: int,
                      alpha: float = 1.0, chunk: int = TOUCHED_CHUNK,
                      w: int = 16) -> Tensor:
    """Link a batch into a raw graph's adjacency ``graph_nbrs`` [C, row_w],
    in place. ``space`` holds the batch's rows already (slots ``new_ids``
    [B], −1 for padding and rows that did not fit); ``new_rows`` [B, r] are
    the edges the search found for them, among the nodes from before the
    batch; ``slot_rand`` [B, row_w] (ints in [0, w)) are the reverse
    table's slots, drawn by the caller. Returns the touched rows [B·row_w]
    i32, with repeats, −1 where the new row had no edge.

      1. each new row = up to 4 batch mates (its r nearest batch mates,
         thinned by the occlusion rule, f32 pairs) ahead of the searched
         edges, cut to row_w;
      2. a bounded reverse table [C, w]: new row b's edge j proposes b at
         slot ``slot_rand[b, j]`` of the edge's row; where proposals
         collide the last in (b, j) order stays;
      3. every touched row is re-selected from current row ∪ reservoir
         under the parallel occlusion rule (j is dropped where some
         nearer candidate i has alpha-scaled d(i, j) < d(row, j); one bf16
         gather feeds both distances), and the rule's over-prune is filled
         back with the unselected current edges in distance order, so a
         row keeps its degree.

    Every touched row is computed from the adjacency after step 1 before
    any of them is written, so repeated rows write identical rows. The
    touched rows go in slices of ``chunk`` to bound the [chunk, M, M] pair
    tensor, M = row_w + w. Fixed in shape, no host sync; on the card one
    replay of an in-place graph (``captured.run_inplace``). The JAX
    package's sequential
    prune (``ALAYA_CONNECT_PRUNE=seq``) is left out: the parallel rule is
    its default."""
    def connect(new_ids, new_rows, slot_rand):
        return (_raw_connect(space, graph_nbrs, new_ids, new_rows, slot_rand,
                             row_w, alpha, chunk, w),)

    return captured.run_inplace(
        "raw_connect", connect, (new_ids, new_rows, slot_rand),
        (torch.full_like(new_ids, -1), new_rows, slot_rand),
        writes=(graph_nbrs,), reads=(space,),
        static=(row_w, float(alpha), chunk, w, MATES))[0]


def _raw_connect(space, graph_nbrs: Tensor, new_ids: Tensor,
                 new_rows: Tensor, slot_rand: Tensor, row_w: int,
                 alpha: float, chunk: int, w: int) -> Tensor:
    B = new_ids.shape[0]
    C = graph_nbrs.shape[0]
    dev = new_ids.device
    ok = new_ids >= 0
    safe_n = torch.where(ok, new_ids, torch.zeros_like(new_ids)).long()
    vnew = space.data[safe_n].float()                              # [B, D]
    dot = vnew @ vnew.T
    if space.metric == "ip":
        pin = -dot
    else:
        sqn = space.sq_norms[safe_n]
        pin = torch.clamp(sqn[:, None] + sqn[None, :] - 2.0 * dot, min=0.0)
    bad = (~ok[None, :] | ~ok[:, None]
           | torch.eye(B, dtype=torch.bool, device=dev))
    pin = torch.where(bad, torch.full_like(pin, FINF), pin)
    kb = min(new_rows.shape[1], B)
    d_in, sel_in = torch.sort(pin, dim=1, stable=True)
    d_in, sel_in = d_in[:, :kb], sel_in[:, :kb]
    mates = torch.where(torch.isfinite(d_in), new_ids[sel_in],
                        torch.full_like(sel_in, -1, dtype=torch.int32))
    rows_m = occlusion_prune_chunk(space, d_in, mates, r=min(MATES, kb),
                                   alpha=alpha, bf16=False)
    cat = torch.cat([rows_m, new_rows.to(torch.int32)], dim=1)
    if cat.shape[1] < row_w:                 # fusion rows are 2·max_nbrs
        cat = torch.nn.functional.pad(cat, (0, row_w - cat.shape[1]),
                                      value=-1)
    order = torch.sort((cat < 0).to(torch.int8), dim=1, stable=True).indices
    rows = torch.gather(cat, 1, order[:, :row_w])
    rows = torch.where(ok[:, None], rows, torch.full_like(rows, -1))
    put_rows(graph_nbrs, new_ids, rows, ok)

    # 2. reverse reservoir; the last proposal in (b, j) order wins a slot
    real = (rows >= 0).reshape(-1)
    dst = rows.reshape(-1).long()
    rev = _reverse_table(dst, real, slot_rand, new_ids, C, w)

    # 3. re-select every touched row from one snapshot, then write
    touched = torch.where(real, dst, torch.full_like(dst, -1))
    t_safe = torch.where(real, dst, torch.zeros_like(dst))
    out = torch.empty((B * row_w, row_w), dtype=torch.int32, device=dev)
    for lo in range(0, B * row_w, chunk):
        out[lo:lo + chunk] = _reprune_rows(space, graph_nbrs, rev,
                                           t_safe[lo:lo + chunk], row_w,
                                           alpha)
    put_rows(graph_nbrs, touched, out, real)
    return touched.to(torch.int32)
