"""Device-resident connectivity repair (port of ``index/repair_dev.py``).

Every node must be reachable from the entry point. Each round:
- reachability : push-BFS from the entry point along the adjacency,
- components   : min-label propagation with pointer jumping over the
                 unreached subgraph (edges taken as undirected),
- attach       : each component's representative gets one edge from its
                 nearest reached node, written into that node's preferred
                 slot (empty slots first, then occupied slots from the
                 row's end; slots holding an earlier round's bridge last).

On the card each ``LOOP_CHUNK`` block of the BFS and of the label
propagation is one replay of a captured CUDA graph (``captured.
run_inplace``: the loop's state goes in as an input and comes back
updated), the host testing once a block as JAX's ``lax.while_loop`` tests
on the device; the attach is one fixed-shape replay (JAX's donated
``_attach_dev``) and the nearest-reached scan one replay over its tiles.
The round loop reads ``missing`` and ``n_comp`` on the host, as JAX does:
so a repair makes one host sync a ``LOOP_CHUNK`` test and two a round
(``repair_connectivity.syncs`` counts them).

Difference from the JAX package: ``repair_connectivity`` there takes this
device path only above 200k rows and repairs smaller graphs on the host
(``nsg._attach_unreached``, scipy components). The port takes the device
path at every n: on an H100 it repairs hnsw and nsg graphs of 100,000 and
200,000 rows several times faster than the host route with its download
and upload, and both end under the same tolerance
(``scripts/torch_choice_probe.py repair``).
"""

from __future__ import annotations

import functools
import logging

import torch

from . import captured

log = logging.getLogger("alayalite_tpu_torch")

Tensor = torch.Tensor
REP_CAP = 8192  # components attached per round (the rest next round)
# Steps of the reachability BFS and of the label propagation between two
# host tests (JAX runs both as lax.while_loops on the device). A step past
# the fixpoint changes nothing, so the chunk only adds work, never a change.
LOOP_CHUNK = 8


def _expand_steps(nbrs: Tensor, steps: int, reached: Tensor,
                  frontier: Tensor):
    """``steps`` push-BFS steps along ``nbrs`` rows, ``reached`` and
    ``frontier`` updated in place; only rows reached in the last step push
    their edges. Each step scatters every edge (an edge that does not push
    adds 0 to its own row's count), fixed in shape. Returns (reached,
    frontier, whether the frontier is not empty)."""
    n = nbrs.shape[0]
    edge = nbrs >= 0
    rows = torch.arange(n, device=nbrs.device)[:, None].expand_as(nbrs)
    tgt = torch.where(edge, nbrs.long(), rows).reshape(-1)
    for _ in range(steps):
        push = (frontier[:, None] & edge).reshape(-1).int()
        hit = torch.zeros(n, dtype=torch.int32, device=nbrs.device)
        hit = hit.scatter_add_(0, tgt, push) > 0
        torch.logical_and(hit, ~reached, out=frontier)
        reached |= hit
    return reached, frontier, frontier.any()


def _expand_reached(nbrs: Tensor, reached: Tensor) -> Tensor:
    """Grow ``reached`` to the directed-BFS fixpoint along ``nbrs`` rows
    (a new tensor): blocks of ``LOOP_CHUNK`` steps, one replay each on the
    card (its warm-up one step on scratch state), the host testing the
    frontier after each."""
    state = (reached.clone(), reached.clone())
    more = True
    while more:
        *state, more = captured.run_inplace(
            "repair_expand",
            functools.partial(_expand_steps, nbrs, LOOP_CHUNK), state, state,
            reads=(nbrs,), static=(LOOP_CHUNK,),
            warm=lambda: _expand_steps(nbrs, 1, *(x.clone() for x in state)))
        more = bool(more)
        repair_connectivity.syncs += 1
    return state[0]


def _label_steps(nbrs: Tensor, steps: int, mask: Tensor, labels: Tensor):
    """``steps`` label-propagation steps over the subgraph induced by
    ``mask``, ``labels`` updated in place: (labels, whether the last step
    moved any)."""
    n = nbrs.shape[0]
    dev = nbrs.device
    mask_ext = torch.cat([mask, torch.zeros(1, dtype=torch.bool, device=dev)])
    safe = torch.where(nbrs >= 0, nbrs, torch.full_like(nbrs, n)).long()
    edge_ok = mask[:, None] & mask_ext[safe]
    tgt = torch.where(edge_ok, safe, torch.full_like(safe, n))
    nfill = torch.full((1,), n, dtype=torch.int32, device=dev)
    for _ in range(steps):
        new, changed = _label_step(labels, mask, edge_ok, tgt, nfill)
        labels.copy_(new)
    return labels, changed


def _component_labels(nbrs: Tensor, mask: Tensor) -> Tensor:
    """Min-label connected components of the subgraph induced by ``mask``
    (edges undirected). Returns int32 labels, the smallest member id of
    each component, n where ~mask. Blocks of ``LOOP_CHUNK`` steps, one
    replay each on the card (its warm-up one step on scratch labels), the
    host testing after each."""
    n = nbrs.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=nbrs.device)
    labels = torch.where(mask, iota, torch.full_like(iota, n))
    changed = True
    while changed:
        labels, changed = captured.run_inplace(
            "repair_labels",
            functools.partial(_label_steps, nbrs, LOOP_CHUNK),
            (mask, labels), (mask, labels), reads=(nbrs,),
            static=(LOOP_CHUNK,),
            warm=lambda: _label_steps(nbrs, 1, mask, labels.clone()))
        changed = bool(changed)
        repair_connectivity.syncs += 1
    return labels


def _label_step(labels, mask, edge_ok, tgt, nfill):
    """One pull / push / pointer-jump step: (labels, whether any moved).
    At the fixpoint it returns its input."""
    n = labels.shape[0]
    lab_ext = torch.cat([labels, nfill])
    # pull along out-edges
    pulled = torch.where(edge_ok, lab_ext[tgt],
                         torch.full_like(tgt, n, dtype=torch.int32)).amin(1)
    new = torch.minimum(labels, pulled)
    # push along out-edges (the reverse direction)
    pushed = torch.full((n + 1,), n, dtype=torch.int32, device=labels.device)
    pushed.scatter_reduce_(0, tgt.reshape(-1),
                           new[:, None].expand_as(tgt).reshape(-1),
                           reduce="amin")
    new = torch.minimum(new, pushed[:n])
    # pointer jumping: labels name member nodes, so chase them
    lab_ext = torch.cat([new, nfill])
    new = torch.minimum(new, lab_ext[new.long()])
    new = torch.where(mask, new, torch.full_like(new, n))
    return new, (new != labels).any()


def _representatives(labels: Tensor, mask: Tensor) -> Tensor:
    """Up to REP_CAP component representatives (nodes whose id is their
    label), ascending, padded with n."""
    n = labels.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=labels.device)
    score = torch.where(mask & (labels == iota), iota,
                        torch.full_like(iota, n))
    vals, _ = torch.topk(score, min(REP_CAP, n), largest=False, sorted=True)
    return vals


def _attach_writes(nbrs: Tensor, reps: Tensor, srcs: Tensor,
                   protected: Tensor):
    """Write edge src→rep for every valid (rep, src) pair into ``nbrs``,
    and mark its slot in ``protected``, both in place. The k-th pair of a
    src takes the row's k-th preferred slot: unprotected empty slots in
    position order, then unprotected occupied slots from the row's end
    (rows are distance-sorted, so overflow replaces the worst edge), then
    protected slots (earlier bridges). Fixed in shape, as
    ``spaces/raw.put_rows``: of the writes to one slot the last in pair
    order lands, and every other entry (an invalid pair, a write that
    lands earlier) repeats that of the first landing one, or writes slot
    (0, 0)'s own values where none lands. Returns (protected,)."""
    n, r = nbrs.shape
    k = reps.shape[0]
    dev = nbrs.device
    valid = (reps < n) & (srcs >= 0)
    big = torch.full_like(srcs, torch.iinfo(torch.int32).max)
    order = torch.sort(torch.where(valid, srcs, big), stable=True).indices
    s, u, v = srcs[order], reps[order], valid[order]
    idx = torch.arange(k, dtype=torch.int32, device=dev)
    new_group = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           s[1:] != s[:-1]])
    group_start = torch.cummax(torch.where(new_group, idx,
                                           torch.zeros_like(idx)), 0).values
    rank = idx - group_start
    s_safe = torch.where(v, s, torch.zeros_like(s)).long()
    rows = nbrs[s_safe]
    prot = protected[s_safe]
    col = torch.arange(r, dtype=torch.int32, device=dev)[None, :]
    pref_key = torch.where(rows < 0, col, 3 * r - 1 - col)
    pref_key = torch.where(prot, 4 * r + col, pref_key)
    perm = torch.sort(pref_key, dim=1, stable=True).indices
    slot = perm[idx.long(), (rank % r).long()]
    cell = torch.where(v, s_safe * r + slot, torch.full_like(s_safe, n * r))
    cs, oc = torch.sort(cell, stable=True)
    last = torch.cat([cs[1:] != cs[:-1],
                      torch.ones(1, dtype=torch.bool, device=dev)])
    lands = torch.zeros_like(v).scatter_(0, oc, last & (cs < n * r))
    first = torch.argmax(lands.to(torch.int32))      # 0 where none lands
    src = torch.where(lands, idx.long(), first)
    ok = lands[src]                # all True, or all False if none lands
    zero = torch.zeros_like(src)
    row_t = torch.where(ok, s_safe[src], zero)
    slot_t = torch.where(ok, slot[src], zero)
    nbrs.index_put_((row_t, slot_t), torch.where(ok, u[src], nbrs[0, 0]))
    protected.index_put_((row_t, slot_t), ok | protected[0, 0])
    return (protected,)


def _attach(nbrs: Tensor, reps: Tensor, srcs: Tensor,
            protected: Tensor) -> Tensor:
    """``_attach_writes`` as one replay on the card (``nbrs`` written in
    place; the warm-up runs on pairs that are all invalid, which write
    nothing new). Returns the updated ``protected``."""
    idle = (torch.full_like(reps, nbrs.shape[0]), srcs, protected)
    return captured.run_inplace(
        "repair_attach", functools.partial(_attach_writes, nbrs),
        (reps, srcs, protected), idle, writes=(nbrs,))[0]


def _nearest_scan(data: Tensor, sq: Tensor, tile: int, metric: str,
                  qs: Tensor, valid: Tensor) -> tuple:
    """Nearest valid row of ``data`` for each query, scanned in tiles
    (bf16 values, f32 products: repair only needs a near reached node)."""
    n = data.shape[0]
    qb = qs.to(torch.bfloat16).float()
    best_d = torch.full((qs.shape[0],), float("inf"), device=qs.device)
    best_i = torch.zeros((qs.shape[0],), dtype=torch.int32, device=qs.device)
    for lo in range(0, n, tile):
        dot = qb @ data[lo:lo + tile].to(torch.bfloat16).float().T
        d = -dot if metric == "ip" else sq[None, lo:lo + tile] - 2.0 * dot
        d = torch.where(valid[None, lo:lo + tile], d,
                        torch.full_like(d, float("inf")))
        dm, j = d.min(1)
        upd = dm < best_d
        best_d = torch.where(upd, dm, best_d)
        best_i = torch.where(upd, (lo + j).to(torch.int32), best_i)
    return (best_i,)


def _nearest_valid(qs: Tensor, data: Tensor, sq: Tensor, valid: Tensor,
                   tile: int, metric: str) -> Tensor:
    """``_nearest_scan`` over every tile, one replay on the card (its
    warm-up scans one tile)."""
    def warm():
        _nearest_scan(data[:tile], sq[:tile], tile, metric, qs, valid[:tile])

    return captured.run_inplace(
        "repair_nearest",
        functools.partial(_nearest_scan, data, sq, tile, metric),
        (qs, valid), (qs, valid), reads=(data, sq), static=(tile, metric),
        warm=warm)[0]


def repair_connectivity(space, nbrs: Tensor, ep: int, max_rounds: int = 24,
                        tol: float = 2e-4) -> Tensor:
    """Repair ``nbrs`` [n, r] (updated in place and returned) until at most
    ``tol·n`` nodes are unreachable from ``ep``, verified by a BFS from
    scratch."""
    n = nbrs.shape[0]
    # fixed in shape: an element write from a Python value would copy it
    # from the host and sync
    seed = torch.arange(n, device=nbrs.device) == int(ep)
    reached = _expand_reached(nbrs, seed)
    protected = torch.zeros(nbrs.shape, dtype=torch.bool, device=nbrs.device)
    data_n, norms_n = space.data[:n], space.sq_norms[:n]
    verified = True
    for rnd in range(max_rounds):
        missing = int((~reached).sum())
        repair_connectivity.syncs += 1
        if missing <= max(0, int(tol * n)) and rnd > 0:
            if verified:
                break
            reached = _expand_reached(nbrs, seed)
            verified = True
            continue
        if missing == 0:
            break
        verified = False
        mask = ~reached
        reps = _representatives(_component_labels(nbrs, mask), mask)
        n_comp = int((reps < n).sum())
        repair_connectivity.syncs += 1
        log.info("attach round %d: %d unreached in %d components", rnd,
                 missing, n_comp)
        if n_comp == 0:
            break
        qs = space.data[torch.clamp(reps, max=n - 1).long()].float()
        srcs = _nearest_valid(qs, data_n, norms_n, reached,
                              tile=min(16384, n), metric=space.metric)
        protected = _attach(nbrs, reps, srcs, protected)
        reached = _expand_reached(nbrs, reached)
    return nbrs


repair_connectivity.syncs = 0  # host reads stated: a loop test, a round's two
