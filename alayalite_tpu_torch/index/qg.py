"""QG builder: fixed-degree graph + block-SQ8 neighbor blocks (port of
``index/qg.py``).

kNN graph (NN-Descent) → medoid entry point → candidate pools → occlusion
prune → reverse edges + re-prune → degree fill → connectivity repair →
neighbor-block encode. The pools come from beam searches over a bf16 copy
of the raw space below 250k rows ("beam") and from block searches over an
interim block space packed from the kNN rows from 250k up ("block"), which
runs ``gather_estimate`` and ``ring_probe`` on every hop. ``pool_mode``
forces one of the two.

The JAX package's environment switches (ALAYA_POOL_MODE, ALAYA_POOL_ITERS,
ALAYA_POOL_CHUNK, ALAYA_POOL_BF16, ALAYA_PRUNE_BF16, ALAYA_PRUNE_MCAP,
ALAYA_REPAIR, ALAYA_BUILD_SYNC, ...) are not copied: their defaults are
fixed here. Each phase ends in a device sync and its seconds go into
``timings``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .build_phases import (PhaseTimer, bf16_pool_space, block_pool_dev,
                           fill_degree_dev, make_generator, prune_all_dev,
                           reprune_with_reverse_dev, reverse_edges_dev,
                           search_pool_dev)
from .graph import Graph
from .nndescent import build_knn_graph
from .nsg import find_medoid
from .repair_dev import repair_connectivity
from .search import seed_sample_arrays

BLOCK_POOL_MIN_ROWS = 250_000
KNN_K = 32          # kNN graph width
CHUNK = 4096        # rows per phase chunk
POOL_SCAN = 4096    # seed-scan sample for the pools
POOL_ITERS = 12     # scan-seeded pool beams start 2-4 hops closer
SEED = 0


@dataclasses.dataclass
class QGBuilder:
    r: int = 32
    ef: int = 128
    alpha: float = 1.0      # occlusion slack (params.prune_alpha)
    pool_mode: str = ""     # "" = by size; "beam" | "block"
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)

    def build_graph(self, raw_space, bqg_space, n: Optional[int] = None):
        """Returns (Graph with eps, BQGSpace with encoded blocks)."""
        if n is None:
            n = raw_space.num
        if self.r != bqg_space.degree:
            raise ValueError("block degree must match the space's width")
        if self.pool_mode not in ("", "beam", "block"):
            raise NotImplementedError(
                f"pool_mode={self.pool_mode!r} is not ported "
                "(ROADMAP queue 1, item 5 ports 'beam' and 'block')")
        dev = raw_space.device
        self.timings = {}
        phase = PhaseTimer(dev, "qg", self.timings)

        # above 100k rows, 8 rounds: scan-seeded pools clean up the
        # residual kNN noise
        knn_d, knn_i = build_knn_graph(raw_space, n, KNN_K,
                                       max_iters=8 if n > 100_000 else 0,
                                       seed=SEED)
        phase("knn")
        ep = find_medoid(raw_space, n)
        pool_mode = self.pool_mode or (
            "block" if n >= BLOCK_POOL_MIN_ROWS else "beam")

        sample, pool_iters = None, 0
        if n >= 4 * 128:
            pool_iters = POOL_ITERS
            s = min(POOL_SCAN, (n // 128) * 128)
            rng = np.random.default_rng(SEED + 5)
            sids = torch.as_tensor(np.sort(rng.choice(n, size=s,
                                                      replace=False))
                                   .astype(np.int32), device=dev)
            sample = seed_sample_arrays(raw_space.data, sids,
                                        raw_space.user_metric)
        # pool width caps at 128: wider pools only pad the per-hop sort
        pool_ef = min(self.ef, 128)
        if pool_mode == "block":
            # interim blocks from the kNN rows; the final encode below
            # rewrites them from the real adjacency in the same buffer
            bqg_space.update_neighbors(knn_i, chunk=CHUNK)
            phase("interim_pack")
            pool_d, pool_i = block_pool_dev(
                bqg_space, np.array([ep]), ef=pool_ef, n=n, chunk=CHUNK,
                seed=SEED, max_iters=pool_iters, seed_sample=sample)
        else:
            pool_d, pool_i = search_pool_dev(
                bf16_pool_space(raw_space), knn_i, np.array([ep]),
                ef=pool_ef, n=n, chunk=CHUNK, seed=SEED,
                max_iters=pool_iters, seed_sample=sample)
        cand_i = torch.cat([pool_i, knn_i], dim=1)
        cand_d = torch.cat([pool_d, knn_d], dim=1)
        del pool_d, pool_i, knn_d, knn_i, sample
        phase(f"pools_{pool_mode}")

        nbrs = prune_all_dev(raw_space, cand_d, cand_i, r=self.r,
                             alpha=self.alpha, chunk=CHUNK)
        phase("prune")
        rev = reverse_edges_dev(nbrs, make_generator(dev, SEED + 3),
                                width=2 * self.r)
        nbrs = reprune_with_reverse_dev(raw_space, nbrs, rev, r=self.r,
                                        alpha=self.alpha, chunk=CHUNK)
        del rev
        phase("reverse_reprune")
        nbrs = fill_degree_dev(nbrs, cand_d, cand_i, r=self.r,
                               chunk=CHUNK)
        del cand_d, cand_i
        phase("fill")
        nbrs = repair_connectivity(raw_space, nbrs, ep)
        phase("repair")
        bqg_space.update_neighbors(nbrs, chunk=CHUNK)
        rng = np.random.default_rng(SEED + 17)
        extra = rng.integers(0, n, size=7).astype(np.int32)
        graph = Graph.from_rows(nbrs, eps=np.concatenate([[ep], extra]),
                                capacity=raw_space.capacity)
        phase("encode")
        return graph, bqg_space
