"""NSG builder: batched MRNG graph construction (port of ``index/nsg.py``).

Every phase runs on the device (``build_phases``):
  candidates : lockstep beam search of all nodes' own vectors over the kNN
               graph from the medoid, unioned with the kNN rows, cut to c;
  prune      : occlusion (MRNG) prune;
  reverse    : bounded reverse-edge scatter + batched re-prune;
  repair     : one edge per unreached component (``repair_dev``).

The host repair of the JAX package (``_attach_unreached`` with its numpy
BFS and scipy components) is kept for the serve-sharded graph
(``parallel.dist_graph``), whose nearest-reached scan runs over the sharded
slab, so the full slab never lands on one device; every other build
repairs on the device.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.distance import exact_topk
from .graph import Graph

log = logging.getLogger("alayalite_tpu_torch")


def find_medoid(space, n: int) -> int:
    """Entry point = node nearest the dataset centroid."""
    data = space.data[:n].float()
    mean = data.mean(0, keepdim=True)
    _, ids = exact_topk(mean, data, 1, metric=space.metric)
    return int(ids[0, 0])


def _components_of(nbrs: np.ndarray, members: np.ndarray) -> np.ndarray:
    """Representative node of each connected component of the subgraph
    induced by ``members`` (edges taken as undirected), through scipy's
    ``connected_components`` (the BFS below where scipy is absent)."""
    members = np.asarray(members, dtype=np.int64)
    try:
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import connected_components
    except Exception:
        return _components_of_bfs(nbrs, members)
    local = np.full(nbrs.shape[0], -1, dtype=np.int32)
    local[members] = np.arange(members.size, dtype=np.int32)
    # CSR straight from the dense [m, R] rows (already row-major)
    rows = local[np.clip(nbrs[members], 0, None)]
    valid = (nbrs[members] >= 0) & (rows >= 0)
    indptr = np.zeros(members.size + 1, dtype=np.int64)
    np.cumsum(valid.sum(axis=1), out=indptr[1:])
    indices = rows[valid].astype(np.int32)
    m = csr_matrix((np.ones(indices.size, np.int8), indices, indptr),
                   shape=(members.size, members.size))
    _, labels = connected_components(m, directed=False)
    first = np.unique(labels, return_index=True)[1]
    return members[first].astype(np.int32)


def _components_of_bfs(nbrs: np.ndarray, members: np.ndarray) -> np.ndarray:
    """``_components_of`` without scipy: a frontier BFS from each unvisited
    member along out-edges only, so it may split what scipy's undirected
    labeling joins and return more representatives (each gets its repair
    edge)."""
    member_set = np.zeros(nbrs.shape[0], dtype=bool)
    member_set[members] = True
    unvisited = set(np.asarray(members).tolist())
    reps = []
    while unvisited:
        start = unvisited.pop()
        reps.append(start)
        frontier = [start]
        while frontier:
            rows = nbrs[np.asarray(frontier, dtype=np.int64)].reshape(-1)
            rows = rows[rows >= 0]
            nxt = [x for x in np.unique(rows).tolist()
                   if member_set[x] and x in unvisited]
            for x in nxt:
                unvisited.discard(x)
            frontier = nxt
    return np.asarray(reps, dtype=np.int32)


def _expand_reached(nbrs: np.ndarray, reached: np.ndarray,
                    frontier: np.ndarray) -> None:
    """Grow ``reached`` in place by a numpy frontier BFS from
    ``frontier``."""
    frontier = frontier[~reached[frontier]]
    reached[frontier] = True
    while frontier.size:
        nxt = np.unique(nbrs[frontier].reshape(-1))
        nxt = nxt[nxt >= 0]
        nxt = nxt[~reached[nxt]]
        reached[nxt] = True
        frontier = nxt


def _attach_unreached(nbrs: np.ndarray, ep: int, nearest_fn,
                      rounds: Optional[list] = None) -> np.ndarray:
    """Host connectivity repair: BFS from ``ep``, then ONE edge per
    unreached component, from its representative's nearest reached node,
    so each round shrinks the unreached set. Reachability grows
    incrementally from the attached components; a full BFS re-verifies
    before convergence is accepted (slot rotation can clobber an earlier
    repair edge). Stops once at most 0.02% of the rows are unreached.

    ``nearest_fn(rep_ids [Rb] i32, reached [n] bool) -> src ids [Rb]`` is
    the nearest-reached scan (``parallel.dist_graph`` scans its sharded
    slab; the JAX package's scan of a whole space has no caller here).
    ``rounds``, where given, gets (unreached rows, components) of every
    repair round."""
    n = nbrs.shape[0]
    reached = np.zeros(n, dtype=bool)
    _expand_reached(nbrs, reached, np.array([ep], dtype=np.int64))
    verified = True
    for _round in range(24):
        missing = np.nonzero(~reached)[0]
        if missing.size <= max(0, int(2e-4 * n)) and _round > 0:
            if verified:
                break
            reached = np.zeros(n, dtype=bool)
            _expand_reached(nbrs, reached, np.array([ep], dtype=np.int64))
            verified = True
            continue
        if missing.size == 0:
            break
        verified = False
        reps = _components_of(nbrs, missing)
        log.info("attach round %d: %d unreached in %d components",
                 _round, missing.size, reps.size)
        srcs = np.asarray(nearest_fn(reps, reached))
        used: dict = {}
        attached = []
        for u, v in zip(reps.tolist(), srcs.tolist()):
            if v < 0:
                continue
            row = nbrs[v]
            empt = np.nonzero(row < 0)[0]
            if empt.size:
                nbrs[v, empt[0]] = u
            else:
                # rotate through distinct slots per source node so repair
                # edges added for other components this round survive
                slot = used.get(v, 0)
                used[v] = slot + 1
                nbrs[v, -1 - (slot % nbrs.shape[1])] = u
            attached.append(u)
        if attached:
            _expand_reached(nbrs, reached,
                            np.asarray(attached, dtype=np.int64))
        if rounds is not None:
            rounds.append((int(missing.size), int(reps.size)))
    return nbrs


@dataclasses.dataclass
class NSGBuilder:
    """r = max degree, l = search width of the candidate pools, c =
    candidate cut."""

    r: int = 32
    l: int = 100
    c: int = 128
    knn_k: int = 32
    alpha: float = 1.0
    chunk: int = 4096
    nnd_iters: int = 0  # 0 = auto (~log2 n rounds)
    seed: int = 0
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)

    def build_graph(self, space, n: Optional[int] = None) -> Graph:
        """The graph over the first n rows of ``space``."""
        from .build_phases import (PhaseTimer, make_generator, prune_all_dev,
                                   reprune_with_reverse_dev,
                                   reverse_edges_dev, search_pool_dev)
        from .nndescent import build_knn_graph
        from .repair_dev import repair_connectivity

        if self.c <= self.r:
            # the reverse-edge table is c − r wide: fail before the kNN and
            # pool work, not inside the slot draw
            raise ValueError(
                f"NSGBuilder requires c > r (candidate cut wider than the "
                f"degree); got c={self.c}, r={self.r}")
        if n is None:
            n = space.num
        self.timings = {}
        with PhaseTimer(space.device, "nsg", self.timings) as phase:
            knn_d, knn_i = build_knn_graph(space, n, self.knn_k,
                                           max_iters=self.nnd_iters,
                                           seed=self.seed)
            phase("knn")
            ep = find_medoid(space, n)
            pool_d, pool_i = search_pool_dev(space, knn_i, np.array([ep]),
                                             ef=self.l, n=n, chunk=self.chunk,
                                             seed=self.seed)
            cand_i = torch.cat([pool_i, knn_i], dim=1)[:, :self.c]
            cand_d = torch.cat([pool_d, knn_d], dim=1)[:, :self.c]
            del pool_d, pool_i, knn_d, knn_i
            phase("pools")
            nbrs = prune_all_dev(space, cand_d, cand_i, r=self.r,
                                 alpha=self.alpha, chunk=self.chunk)
            del cand_d, cand_i
            phase("prune")
            rev = reverse_edges_dev(nbrs, make_generator(space.device,
                                                         self.seed + 3),
                                    width=self.c - self.r)
            nbrs = reprune_with_reverse_dev(space, nbrs, rev, r=self.r,
                                            alpha=self.alpha, chunk=self.chunk)
            del rev
            phase("reverse_reprune")
            nbrs = repair_connectivity(space, nbrs, ep)
            phase("repair")
        # the medoid first (NSG semantics), then spread extras, so queries
        # that land in a part linked only by thin repair chains converge
        rng = np.random.default_rng(self.seed + 17)
        extra = rng.integers(0, n, size=7).astype(np.int32)
        log.info("nsg build: n=%d r=%d l=%d", n, self.r, self.l)
        return Graph.from_rows(nbrs, eps=np.concatenate([[ep], extra]),
                               capacity=space.capacity)
