"""Graph index structure (port of ``index/graph.py``).

``nbrs`` is a dense int32 ``[capacity, R]`` adjacency (−1 padded) and
``eps`` the entry points. A QG (block) graph has no overlay levels; loading
a graph that has them (raw HNSW) waits in ROADMAP queue 1, item 8.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class Graph:
    nbrs: torch.Tensor   # [capacity, R] int32, -1 padded
    eps: torch.Tensor    # [E] int32 entry points, -1 padded

    @property
    def capacity(self) -> int:
        return self.nbrs.shape[0]

    @property
    def max_nbrs(self) -> int:
        return self.nbrs.shape[1]

    @staticmethod
    def from_rows(nbrs: torch.Tensor, eps, capacity: Optional[int] = None
                  ) -> "Graph":
        """Adjacency rows for the first n nodes, padded with −1 rows up to
        ``capacity``, on the rows' device."""
        nb = nbrs.to(torch.int32)
        if capacity is not None and capacity > nb.shape[0]:
            nb = torch.nn.functional.pad(
                nb, (0, 0, 0, capacity - nb.shape[0]), value=-1)
        ep = torch.as_tensor(np.asarray(eps, dtype=np.int32),
                             device=nb.device)
        return Graph(nbrs=nb, eps=ep)

    # ---- persistence (the JAX package's npz keys) ----
    def save_arrays(self) -> dict:
        return {"nbrs": self.nbrs.cpu().numpy(),
                "eps": self.eps.cpu().numpy(),
                "n_overlay": 0}

    @staticmethod
    def load_arrays(d: dict, device: torch.device = torch.device("cpu")
                    ) -> "Graph":
        if int(d["n_overlay"]) != 0:
            raise NotImplementedError(
                "graphs with overlay levels (raw hnsw) are not ported yet "
                "(ROADMAP queue 1, item 8)")
        return Graph(
            nbrs=torch.tensor(np.asarray(d["nbrs"], np.int32),
                              device=device),
            eps=torch.tensor(np.asarray(d["eps"], np.int32), device=device))
