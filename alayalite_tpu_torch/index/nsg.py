"""NSG builder: batched MRNG graph construction (port of ``index/nsg.py``).

Every phase runs on the device (``build_phases``):
  candidates : lockstep beam search of all nodes' own vectors over the kNN
               graph from the medoid, unioned with the kNN rows, cut to c;
  prune      : occlusion (MRNG) prune;
  reverse    : bounded reverse-edge scatter + batched re-prune;
  repair     : one edge per unreached component (``repair_dev``).
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
        phase = PhaseTimer(space.device, "nsg", self.timings)
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
