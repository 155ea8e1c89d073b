"""Device-resident connectivity repair (port of ``index/repair_dev.py``).

Every node must be reachable from the entry point. Each round:
- reachability : push-BFS from the entry point along the adjacency,
- components   : min-label propagation with pointer jumping over the
                 unreached subgraph (edges taken as undirected),
- attach       : each component's representative gets one edge from its
                 nearest reached node, written into that node's preferred
                 slot (empty slots first, then occupied slots from the
                 row's end; slots holding an earlier round's bridge last).

Difference from the JAX package: ``repair_connectivity`` there takes this
device path only above 200k rows and repairs smaller graphs on the host
(``nsg._attach_unreached``, scipy components). The port takes the device
path at every n; the host path waits in ROADMAP beside the NSG builder.
"""

from __future__ import annotations

import logging

import torch

log = logging.getLogger("alayalite_tpu_torch")

Tensor = torch.Tensor
REP_CAP = 8192  # components attached per round (the rest next round)


def _expand_reached(nbrs: Tensor, reached: Tensor) -> Tensor:
    """Grow ``reached`` to the directed-BFS fixpoint along ``nbrs`` rows;
    only rows reached in the last pass push their edges."""
    reached = reached.clone()
    frontier = reached.clone()
    while bool(frontier.any()):
        tgt = nbrs[frontier]
        tgt = tgt[tgt >= 0].long()
        hit = torch.zeros_like(reached)
        hit[tgt] = True
        frontier = hit & ~reached
        reached |= hit
    return reached


def _component_labels(nbrs: Tensor, mask: Tensor) -> Tensor:
    """Min-label connected components of the subgraph induced by ``mask``
    (edges undirected). Returns int32 labels, the smallest member id of
    each component, n where ~mask."""
    n = nbrs.shape[0]
    dev = nbrs.device
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    mask_ext = torch.cat([mask, torch.zeros(1, dtype=torch.bool, device=dev)])
    safe = torch.where(nbrs >= 0, nbrs, torch.full_like(nbrs, n)).long()
    edge_ok = mask[:, None] & mask_ext[safe]
    tgt = torch.where(edge_ok, safe, torch.full_like(safe, n))
    nfill = torch.full((1,), n, dtype=torch.int32, device=dev)
    labels = torch.where(mask, iota, torch.full_like(iota, n))
    while True:
        lab_ext = torch.cat([labels, nfill])
        # pull along out-edges
        pulled = torch.where(edge_ok, lab_ext[tgt],
                             torch.full_like(tgt, n, dtype=torch.int32)
                             ).amin(1)
        new = torch.minimum(labels, pulled)
        # push along out-edges (the reverse direction)
        pushed = torch.full((n + 1,), n, dtype=torch.int32, device=dev)
        pushed.scatter_reduce_(0, tgt.reshape(-1),
                               new[:, None].expand_as(tgt).reshape(-1),
                               reduce="amin")
        new = torch.minimum(new, pushed[:n])
        # pointer jumping: labels name member nodes, so chase them
        lab_ext = torch.cat([new, nfill])
        new = torch.minimum(new, lab_ext[new.long()])
        new = torch.where(mask, new, torch.full_like(new, n))
        if not bool((new != labels).any()):
            return new
        labels = new


def _representatives(labels: Tensor, mask: Tensor) -> Tensor:
    """Up to REP_CAP component representatives (nodes whose id is their
    label), ascending, padded with n."""
    n = labels.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=labels.device)
    score = torch.where(mask & (labels == iota), iota,
                        torch.full_like(iota, n))
    vals, _ = torch.topk(score, min(REP_CAP, n), largest=False, sorted=True)
    return vals


def _attach(nbrs: Tensor, reps: Tensor, srcs: Tensor,
            protected: Tensor) -> None:
    """Write edge src→rep for every valid (rep, src) pair, in place. The
    k-th pair of a src takes the row's k-th preferred slot: unprotected
    empty slots in position order, then unprotected occupied slots from
    the row's end (rows are distance-sorted, so overflow replaces the
    worst edge), then protected slots (earlier bridges)."""
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
    nbrs[s[v].long(), slot[v]] = u[v]
    protected[s[v].long(), slot[v]] = True


def _nearest_valid(qs: Tensor, data: Tensor, sq: Tensor, valid: Tensor,
                   tile: int, metric: str) -> Tensor:
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
    return best_i


def repair_connectivity(space, nbrs: Tensor, ep: int, max_rounds: int = 24,
                        tol: float = 2e-4) -> Tensor:
    """Repair ``nbrs`` [n, r] (updated in place and returned) until at most
    ``tol·n`` nodes are unreachable from ``ep``, verified by a BFS from
    scratch."""
    n = nbrs.shape[0]
    seed = torch.zeros(n, dtype=torch.bool, device=nbrs.device)
    seed[ep] = True
    reached = _expand_reached(nbrs, seed)
    protected = torch.zeros(nbrs.shape, dtype=torch.bool, device=nbrs.device)
    data_n, norms_n = space.data[:n], space.sq_norms[:n]
    verified = True
    for rnd in range(max_rounds):
        missing = int((~reached).sum())
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
        log.info("attach round %d: %d unreached in %d components", rnd,
                 missing, n_comp)
        if n_comp == 0:
            break
        qs = space.data[torch.clamp(reps, max=n - 1).long()].float()
        srcs = _nearest_valid(qs, data_n, norms_n, reached,
                              tile=min(16384, n), metric=space.metric)
        _attach(nbrs, reps, srcs, protected)
        reached = _expand_reached(nbrs, reached)
    return nbrs
