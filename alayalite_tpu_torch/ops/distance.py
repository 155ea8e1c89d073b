"""Dense distance helpers (port of part of ``ops/distance.py``).

Distance conventions match the JAX package:
  l2  → squared euclidean
  ip  → negative inner product
  cos → negative cosine (normalize, then ip)

The products here are plain float32 ``torch.matmul`` (TF32 off, see
``device.py``); the JAX package likewise leaves them to XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .topk import topk_smallest

FINF = float("inf")


def sqnorms(x: torch.Tensor) -> torch.Tensor:
    """Per-row squared L2 norms, f32."""
    xf = x.float()
    return (xf * xf).sum(-1)


def normalize_rows(x: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    n = torch.sqrt((x.float() ** 2).sum(-1, keepdim=True))
    return (x / torch.clamp(n, min=eps)).to(x.dtype)


def exact_topk(
    queries: torch.Tensor,
    base: torch.Tensor,
    k: int,
    metric: str = "l2",
    valid: Optional[torch.Tensor] = None,
    tile_n: int = 16384,
    qchunk: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``base`` rows for each query, scanning ``base`` in
    tiles of ``tile_n`` rows and the queries in chunks of ``qchunk`` so the
    distance tile stays bounded. Returns (dists [Q, k] f32, ids [Q, k] i32,
    −1 where fewer than k valid rows)."""
    q = queries.float()
    x = base.float()
    if metric == "cos":
        q, x, metric = normalize_rows(q), normalize_rows(x), "ip"
    n = x.shape[0]
    x_sq = sqnorms(x)
    out_d, out_i = [], []
    for qlo in range(0, q.shape[0], qchunk):
        qc = q[qlo:qlo + qchunk]
        q_sq = sqnorms(qc)
        best_d = torch.full((qc.shape[0], 0), FINF, device=q.device)
        best_i = torch.full((qc.shape[0], 0), -1, dtype=torch.int32,
                            device=q.device)
        for lo in range(0, n, tile_n):
            dot = qc @ x[lo:lo + tile_n].T
            if metric == "ip":
                d = -dot
            else:
                d = torch.clamp(q_sq[:, None] + x_sq[None, lo:lo + tile_n]
                                - 2.0 * dot, min=0.0)
            if valid is not None:
                d = torch.where(valid[None, lo:lo + tile_n], d,
                                torch.full_like(d, FINF))
            ids = torch.arange(lo, lo + d.shape[1], dtype=torch.int32,
                               device=q.device)
            best_d = torch.cat([best_d, d], dim=1)
            best_i = torch.cat([best_i, ids.expand(d.shape[0], -1)], dim=1)
            kk = min(k, best_d.shape[1])
            best_d, sel = topk_smallest(best_d, kk)
            best_i = torch.gather(best_i, 1, sel)
        if best_d.shape[1] < k:
            pad = k - best_d.shape[1]
            best_d = torch.nn.functional.pad(best_d, (0, pad), value=FINF)
            best_i = torch.nn.functional.pad(best_i, (0, pad), value=-1)
        best_i = torch.where(torch.isfinite(best_d), best_i,
                             torch.full_like(best_i, -1))
        out_d.append(best_d)
        out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i)
