"""Exact k-NN graph (port of ``index/knn.py``): the all-pairs branch of
``build_knn_graph`` for small n."""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.distance import exact_topk


def exact_knn(data: torch.Tensor, k: int, metric: str = "l2"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest neighbors of every row against all rows, self
    excluded. Returns (dists [N, k] f32, ids [N, k] i32; inf / −1 pad)."""
    n = data.shape[0]
    kk = min(k + 1, n)
    d, i = exact_topk(data, data, kk, metric=metric)
    self_ids = torch.arange(n, dtype=torch.int32, device=data.device)
    not_self = i != self_ids[:, None]
    # stable-compact the non-self entries to the left, then take k
    order = torch.sort((~not_self).to(torch.int8), dim=1, stable=True).indices
    i_c = torch.gather(i, 1, order)
    d_c = torch.gather(d, 1, order)
    m_c = torch.gather(not_self, 1, order)
    take = min(k, kk)
    out_d = torch.full((n, k), float("inf"), device=data.device)
    out_i = torch.full((n, k), -1, dtype=torch.int32, device=data.device)
    out_i[:, :take] = torch.where(m_c[:, :take], i_c[:, :take],
                                  torch.full_like(i_c[:, :take], -1))
    out_d[:, :take] = torch.where(m_c[:, :take], d_c[:, :take],
                                  torch.full_like(d_c[:, :take], float("inf")))
    return out_d, out_i
