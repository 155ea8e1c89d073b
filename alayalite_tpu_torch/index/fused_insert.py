"""Online insert: ``fused_block_insert`` for block (bsq8) indices and
``fused_raw_connect`` for raw graphs (port of ``index/fused_insert.py``).

One bsq8 batch runs the whole insert-and-update pipeline on the device:

  1. beam-search each new vector's top-R edges (block estimates + exact
     rerank), over the nodes that exist before the batch;
  2. append the raw vectors at the bump pointer; the new rows are the exact
     top-R of [searched edges ∪ up to 4 nearest batch mates]; encode their
     packed blocks;
  3. bounded reverse table ``[C, w]``: which new nodes point at each
     touched node (random slot per edge; colliding writes keep an
     unspecified one, a reservoir);
  4. re-select and re-encode every touched node's block: candidates =
     its current edges ∪ the new sources pointing at it, top-R by exact
     distance.

The JAX function is one jitted program over donated buffers, padded to a
bucket size; here the steps are plain tensor code that updates the space
and the adjacency in place, on batches of any size. Rows that do not fit
the capacity are dropped before every scatter (the JAX program aims their
masked writes at slot 0). Every candidate of step 4 is computed from the
state after step 2, before any step-4 write.

``fused_raw_connect`` links a batch already searched and appended into a
raw graph's adjacency; see its docstring.
"""

from __future__ import annotations

import torch

from ..ops.topk import select_smallest
from .prune import _sort_dedup, occlusion_prune_chunk
from .search import block_beam_search, scan_seeds

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
                       gen: torch.Generator, seed_sample, r: int, w: int,
                       ef: int, iters: int, m: int) -> Tensor:
    """Insert ``vecs`` [B, D] into the block space and the adjacency
    ``graph_nbrs`` [C, R], both updated in place. ``gen`` draws the
    reverse table's slots. Returns the new ids [B] i32, −1 where the
    capacity was exhausted."""
    B = vecs.shape[0]
    C = space.capacity
    dev = vecs.device
    v = space.prep_query(vecs)

    # 1. edges for the new nodes, among the nodes that exist already
    if seed_sample is not None:
        seeds = scan_seeds(v, *seed_sample)
    else:
        seeds = eps[None, :].expand(B, -1).contiguous()
    d_nb, ids_nb = block_beam_search(space, seeds, v, k=r, ef=max(ef, r),
                                     max_iters=iters, valid=space.valid,
                                     n_expand=m)

    # 2. append (insert_raw normalizes under cos itself)
    new_ids = space.insert_raw(vecs)
    ok = new_ids >= 0
    d_in, batch_ids = _batch_mates(space, v, new_ids)
    cand = torch.cat([ids_nb, batch_ids], dim=1)
    cand_d = torch.cat([torch.where(ids_nb >= 0, d_nb,
                                    torch.full_like(d_nb, FINF)), d_in], dim=1)
    _, sorted_ids = _sort_dedup(cand_d, cand)
    rows_new = sorted_ids[ok][:, :r]
    slots = new_ids[ok].long()
    space.set_neighbor_rows(slots, rows_new)
    graph_nbrs[slots] = space.nbr_ids[slots]

    # 3. bounded reverse table
    real = rows_new >= 0
    dst = rows_new[real].long()
    src = new_ids[ok][:, None].expand(-1, r)[real]
    slot_rand = torch.randint(0, w, (B, r), generator=gen, device=dev)
    rev = torch.full((C, w), -1, dtype=torch.int32, device=dev)
    rev[dst, slot_rand[ok][real]] = src

    # 4. re-select every touched row from one snapshot, then write
    touched = torch.unique(dst)
    rows_t = torch.empty((touched.shape[0], r), dtype=torch.int32, device=dev)
    for lo in range(0, touched.shape[0], TOUCHED_CHUNK):
        t = touched[lo:lo + TOUCHED_CHUNK]
        cand = torch.cat([space.nbr_ids[t], rev[t]], dim=1)
        cand = torch.where(cand == t[:, None], torch.full_like(cand, -1),
                           cand)                               # no self-loop
        cd = _bqg_exact_dists(space, space.data[t], cand)
        rows_t[lo:lo + TOUCHED_CHUNK] = _sort_dedup(cd, cand)[1][:, :r]
    space.set_neighbor_rows(touched, rows_t)
    graph_nbrs[touched] = rows_t
    return new_ids


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
    [B], −1 for rows that did not fit); ``new_rows`` [B, r] are the edges
    the search found for them, among the nodes from before the batch;
    ``slot_rand`` [B, row_w] (ints in [0, w)) are the reverse table's
    slots, drawn by the caller. Returns the touched rows [B·row_w] i32,
    with repeats, −1 where the new row had no edge.

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
    tensor, M = row_w + w. The JAX package's sequential prune
    (``ALAYA_CONNECT_PRUNE=seq``) is left out: the parallel rule is its
    default."""
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
    graph_nbrs[new_ids[ok].long()] = rows[ok]

    # 2. reverse reservoir; the last proposal in (b, j) order wins a slot
    real = (rows >= 0).reshape(-1)
    dst = rows.reshape(-1).long()
    cell = dst * w + slot_rand.reshape(-1).long()
    pos = torch.arange(B * row_w, device=dev)
    win = torch.full((C * w,), -1, dtype=torch.int64, device=dev)
    win.scatter_reduce_(0, cell[real], pos[real], reduce="amax")
    src = new_ids[:, None].expand(B, row_w).reshape(-1)
    has = win >= 0
    rev = torch.full((C * w,), -1, dtype=torch.int32, device=dev)
    rev[has] = src[win[has]]
    rev = rev.view(C, w)
    del win, has

    # 3. re-select every touched row from one snapshot, then write
    touched = torch.where(real, dst, torch.full_like(dst, -1))
    t_all = dst[real]
    out = torch.empty((t_all.shape[0], row_w), dtype=torch.int32,
                      device=dev)
    for lo in range(0, t_all.shape[0], chunk):
        out[lo:lo + chunk] = _reprune_rows(space, graph_nbrs, rev,
                                           t_all[lo:lo + chunk], row_w,
                                           alpha)
    graph_nbrs[t_all] = out
    return touched.to(torch.int32)
