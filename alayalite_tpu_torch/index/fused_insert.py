"""Online insert for block (bsq8) indices (port of ``fused_block_insert`` in
``index/fused_insert.py``).

One batch runs the whole insert-and-update pipeline on the device:

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
state after step 2, before any step-4 write. ``fused_raw_connect`` (raw
graphs) waits in ROADMAP queue 1, item 8.
"""

from __future__ import annotations

import torch

from ..ops.topk import select_smallest
from .prune import _sort_dedup
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
