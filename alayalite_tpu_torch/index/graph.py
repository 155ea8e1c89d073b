"""Graph index structure (port of ``index/graph.py``).

``nbrs`` is a dense int32 ``[capacity, R]`` adjacency (−1 padded) and
``eps`` the entry points. The overlay (raw HNSW graphs; a QG block graph
has none) is a tuple of per-level dense subgraphs, top level first, with
*local* neighbor indices and a ``down`` map into the level below, so the
greedy descent of ``search.graph_seeds`` is a gather per step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class OverlayLevel:
    ids: torch.Tensor    # [Nl] int32: global node id of each local slot
    nbrs: torch.Tensor   # [Nl, R2] int32: local indices within the level
    down: torch.Tensor   # [Nl] int32: local index of the same node one level
                         # below (last overlay level: the global id itself)

    @property
    def size(self) -> int:
        return self.ids.shape[0]


@dataclasses.dataclass
class Graph:
    nbrs: torch.Tensor   # [capacity, R] int32, -1 padded
    eps: torch.Tensor    # [E] int32 entry points, -1 padded
    overlay: Tuple[OverlayLevel, ...] = ()

    @property
    def capacity(self) -> int:
        return self.nbrs.shape[0]

    @property
    def max_nbrs(self) -> int:
        return self.nbrs.shape[1]

    @staticmethod
    def from_rows(nbrs: torch.Tensor, eps, capacity: Optional[int] = None,
                  overlay: Tuple[OverlayLevel, ...] = ()) -> "Graph":
        """Adjacency rows for the first n nodes, padded with −1 rows up to
        ``capacity``, on the rows' device."""
        nb = nbrs.to(torch.int32)
        if capacity is not None and capacity > nb.shape[0]:
            nb = torch.nn.functional.pad(
                nb, (0, 0, 0, capacity - nb.shape[0]), value=-1)
        ep = torch.as_tensor(np.asarray(eps, dtype=np.int32),
                             device=nb.device)
        return Graph(nbrs=nb, eps=ep, overlay=tuple(overlay))

    # ---- persistence (the JAX package's npz keys) ----
    def save_arrays(self) -> dict:
        out = {"nbrs": self.nbrs.cpu().numpy(),
               "eps": self.eps.cpu().numpy(),
               "n_overlay": len(self.overlay)}
        for li, lvl in enumerate(self.overlay):
            out[f"ov{li}_ids"] = lvl.ids.cpu().numpy()
            out[f"ov{li}_nbrs"] = lvl.nbrs.cpu().numpy()
            out[f"ov{li}_down"] = lvl.down.cpu().numpy()
        return out

    @staticmethod
    def load_arrays(d: dict, device: torch.device = torch.device("cpu")
                    ) -> "Graph":
        def t(key):
            return torch.tensor(np.asarray(d[key], np.int32), device=device)

        overlay = tuple(
            OverlayLevel(ids=t(f"ov{li}_ids"), nbrs=t(f"ov{li}_nbrs"),
                         down=t(f"ov{li}_down"))
            for li in range(int(d["n_overlay"])))
        return Graph(nbrs=t("nbrs"), eps=t("eps"), overlay=overlay)
