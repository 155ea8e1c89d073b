"""HNSW-analog builder: batched base layer + sampled overlay hierarchy
(port of ``index/hnsw.py``).

  base layer : kNN graph (NN-Descent / exact) → beam-search candidate pools
               over a bf16 copy of the rows → batched occlusion prune →
               reverse edges + re-prune (→ degree fill under IP) →
               connectivity repair;
  overlay    : nodes sampled with the layer occupancy of HNSW
               (P(level ≥ l) = R^−l) get per-level exact kNN subgraphs.

The level members come from ``np.random.default_rng(seed)`` exactly as in
the JAX package, so for the same n, r and seed the levels hold the same
node sets. The JAX package's environment switch ALAYA_HNSW_POOLS is fixed
at its default (pools on). Each phase ends in a device sync and its seconds
go into ``timings``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from .build_phases import (PhaseTimer, bf16_pool_space, fill_degree_dev, make_generator,
                           prune_all_dev, reprune_with_reverse_dev,
                           reverse_edges_dev, search_pool_dev)
from .graph import Graph, OverlayLevel
from .knn import exact_knn
from .nndescent import build_knn_graph
from .repair_dev import repair_connectivity

log = logging.getLogger("alayalite_tpu_torch")


def _build_overlay(space, n: int, r: int, rng: np.random.Generator):
    """Sample the layer hierarchy and build per-level exact kNN subgraphs.
    Returns (levels, top level first; the global id of the top level's
    first node, or None when n is too small for a level).

    Each level is padded to a slot count scaled by the unused capacity
    (ids / down = −1), the room the JAX package leaves for online inserts;
    ``overlay_descend`` never reads a padded slot, since no occupied row
    points at one."""
    r2 = max(2, r // 2)
    members: List[np.ndarray] = []
    cur = np.arange(n, dtype=np.int32)
    while cur.size > max(2 * r, 64):
        size = max(1, cur.size // max(2, r))
        cur = np.sort(rng.choice(cur, size=size, replace=False))
        members.append(cur)
    if not members:
        return (), None
    members = members[::-1]                       # top level first
    grow = max(1.0, space.capacity / max(n, 1))
    dev = space.device
    levels = []
    for li, ids in enumerate(members):
        k = min(r2, ids.size - 1)
        nbrs_local = np.full((ids.size, r2), -1, dtype=np.int32)
        if k > 0:
            vecs = space.data[torch.as_tensor(ids, device=dev).long()].float()
            _, knn_local = exact_knn(vecs, k, metric=space.metric)
            nbrs_local[:, :k] = knn_local.cpu().numpy()
        if li + 1 < len(members):
            down = np.searchsorted(members[li + 1], ids).astype(np.int32)
        else:
            down = ids.astype(np.int32)    # bottom level: the global ids
        pad = -(-int(np.ceil(ids.size * grow)) // 8) * 8 - ids.size
        if pad > 0:
            ids = np.concatenate([ids, np.full(pad, -1, np.int32)])
            nbrs_local = np.concatenate(
                [nbrs_local, np.full((pad, r2), -1, np.int32)], axis=0)
            down = np.concatenate([down, np.full(pad, -1, np.int32)])
        levels.append(OverlayLevel(
            ids=torch.as_tensor(ids.astype(np.int32), device=dev),
            nbrs=torch.as_tensor(nbrs_local, device=dev),
            down=torch.as_tensor(down, device=dev)))
    return tuple(levels), int(members[0][0])


@dataclasses.dataclass
class HNSWBuilder:
    """r = max_nbrs (base-layer degree), l = ef_construction."""

    r: int = 32
    l: int = 200
    knn_k: int = 32
    alpha: float = 1.0
    chunk: int = 4096
    nnd_iters: int = 0  # 0 = auto (~log2 n rounds)
    seed: int = 0
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)

    def build_graph(self, space, n: Optional[int] = None) -> Graph:
        if n is None:
            n = space.num
        self.timings = {}
        phase = PhaseTimer(space.device, "hnsw", self.timings)
        rng = np.random.default_rng(self.seed)

        knn_d, knn_i = build_knn_graph(space, n, self.knn_k,
                                       max_iters=self.nnd_iters,
                                       seed=self.seed)
        phase("knn")
        overlay, top_global = _build_overlay(space, n, self.r, rng)
        ep = top_global if top_global is not None else 0
        phase("overlay")

        # at dim >= 512 ef-64 pools in chunks of 2048 keep the beam's
        # gathered rows near 1 GB beside the f32 rows and their bf16 copy
        hidim = space.dim >= 512
        ef = min(self.l, 64 if hidim else 128)
        pchunk = min(self.chunk, 2048) if hidim else self.chunk
        pool_d, pool_i = search_pool_dev(
            bf16_pool_space(space), knn_i, np.array([ep]), ef=ef, n=n,
            chunk=pchunk, seed=self.seed)
        cand_i = torch.cat([pool_i, knn_i], dim=1)
        cand_d = torch.cat([pool_d, knn_d], dim=1)
        del pool_d, pool_i, knn_d, knn_i
        phase("pools")

        nbrs = prune_all_dev(space, cand_d, cand_i, r=self.r,
                             alpha=self.alpha, chunk=self.chunk)
        phase("prune")
        rev = reverse_edges_dev(nbrs, make_generator(space.device,
                                                     self.seed + 3),
                                width=2 * self.r)
        nbrs = reprune_with_reverse_dev(space, nbrs, rev, r=self.r,
                                        alpha=self.alpha, chunk=self.chunk)
        del rev
        if space.user_metric == "ip":
            # under IP the occlusion rule collapses rows toward high-norm
            # hubs and leaves nodes without in-edges; pad rows back to r
            # with their nearest unused candidates. Under l2 / cos the
            # occluded rows are navigable as they are.
            nbrs = fill_degree_dev(nbrs, cand_d, cand_i, r=self.r,
                                   chunk=self.chunk)
        del cand_d, cand_i
        phase("reverse_reprune")
        nbrs = repair_connectivity(space, nbrs, ep)
        phase("repair")
        extra = rng.integers(0, n, size=7).astype(np.int32)
        log.info("hnsw build: n=%d r=%d l=%d levels=%d", n, self.r, self.l,
                 len(overlay))
        return Graph.from_rows(nbrs, eps=np.concatenate([[ep], extra]),
                               capacity=space.capacity, overlay=overlay)
