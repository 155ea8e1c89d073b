"""FusionGraph builder: union of the HNSW and NSG edge sets (port of
``index/fusion.py``).

Builds the primary (HNSW) and the secondary (NSG) graph, unions each node's
edge lists (duplicates dropped, primary first) into rows of width 2R, and
keeps the overlay and the entry points of the primary.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .graph import Graph
from .hnsw import HNSWBuilder
from .nsg import NSGBuilder


def _union_rows(a: torch.Tensor, b: torch.Tensor, width: int) -> torch.Tensor:
    """Per-row ordered union of two −1-padded id lists, −1 padded to
    ``width``: the first occurrence of every id, in the order of [a ‖ b]."""
    cat = torch.cat([a, b], dim=1)
    s, order = torch.sort(cat, dim=1, stable=True)
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    first &= s >= 0
    keep = torch.zeros_like(first).scatter_(1, order, first)
    compact = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    vals = torch.gather(torch.where(keep, cat, torch.full_like(cat, -1)), 1,
                        compact)[:, :width]
    if vals.shape[1] < width:
        vals = torch.nn.functional.pad(vals, (0, width - vals.shape[1]),
                                       value=-1)
    return vals.to(torch.int32)


@dataclasses.dataclass
class FusionGraphBuilder:
    r: int = 32
    l: int = 200
    chunk: int = 4096
    alpha: float = 1.0
    seed: int = 0
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)

    def build_graph(self, space, n: Optional[int] = None) -> Graph:
        if n is None:
            n = space.num
        hnsw = HNSWBuilder(r=self.r, l=self.l, chunk=self.chunk,
                           alpha=self.alpha, seed=self.seed)
        nsg = NSGBuilder(r=self.r, l=max(self.l // 2, 64), chunk=self.chunk,
                         alpha=self.alpha, seed=self.seed)
        primary = hnsw.build_graph(space, n)
        secondary = nsg.build_graph(space, n)
        self.timings = {**{f"hnsw_{k}": v for k, v in hnsw.timings.items()},
                        **{f"nsg_{k}": v for k, v in nsg.timings.items()}}
        union = _union_rows(primary.nbrs[:n], secondary.nbrs[:n], 2 * self.r)
        return Graph.from_rows(union, eps=primary.eps.cpu().numpy(),
                               capacity=space.capacity,
                               overlay=primary.overlay)
