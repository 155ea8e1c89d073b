"""Dense distances and the flat scans (port of ``ops/distance.py``).

Distance conventions match the JAX package:
  l2  → squared euclidean
  ip  → negative inner product
  cos → negative cosine (normalize, then ip)

``pairwise`` in float32 l2 is the hand-written tile ``l2_tile``
(``csrc/l2_tile.cu`` on a CUDA tensor). ip is a plain float32
``torch.matmul`` (TF32 off, see ``device.py``), as the JAX package leaves
that product to XLA. With ``compute_dtype=torch.bfloat16`` it is fast
mode's coarse scan: a bf16 product with float32 output, then the l2
epilogue.

The scans select ``k`` within each tile of rows, then merge the k-wide
results; the ``[Q, tile]`` matrix is never concatenated. Tie rule: among
equal distances the lower id comes first, except that where several rows
of one tile tie at its k-th place, the rows ``torch.topk`` keeps are taken
(the JAX package keeps the lower ids). Fast mode's coarse selection is an
exact ``torch.topk`` where the JAX package takes ``approx_max_k``, so the
port's coarse set holds every candidate the approximation could find.

``counters`` counts the tiled scans' work (``ScanCounters``), carried by
``index/captured.py`` beside the kernels' launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .l2_tile import l2_tile
from .pool_sort import merge_kv
from .topk import select_smallest, topk_smallest

FINF = float("inf")
Tensor = torch.Tensor


class ScanCounters:
    """What the tiled scans (``_exact_topk_device``: the flat index's
    exact and fast scans, ``exact_topk``'s callers, the sharded slab's
    scan) did, as Python integers that ``index/captured.py`` keeps as it
    keeps the kernels' ``.launches``.

      pairs       (query, row) distances scored: Σ Q · N over the tiles
                  (``pairwise``: ``l2_tile`` for f32 l2)
      tiles       tiles of rows scored
      candidates  each tile's selection merged into the running best
                  (``merge_kv``): Σ Q · min(k, N)
    """

    FIELDS = ("pairs", "tiles", "candidates")

    def __init__(self):
        self.pairs = self.tiles = self.candidates = 0


counters = ScanCounters()


def sqnorms(x: Tensor) -> Tensor:
    """Per-row squared L2 norms, f32."""
    xf = x.float()
    return (xf * xf).sum(-1)


def normalize_rows(x: Tensor, eps: float = 1e-30) -> Tensor:
    n = torch.sqrt((x.float() ** 2).sum(-1, keepdim=True))
    return (x / torch.clamp(n, min=eps)).to(x.dtype)


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _bf16_dot(q: Tensor, x: Tensor) -> Tensor:
    """q·xᵀ of the bf16-rounded operands, float32 output."""
    qb, xb = q.to(torch.bfloat16), x.to(torch.bfloat16)
    if qb.device.type == "cuda":
        return torch.mm(qb, xb.T, out_dtype=torch.float32)
    # the CPU has no bf16 product with f32 output; every bf16 x bf16
    # product is exact in f32, so this gives the same values
    return qb.float() @ xb.float().T


def pairwise(q: Tensor, x: Tensor, metric: str = "l2",
             x_sq: Optional[Tensor] = None, q_sq: Optional[Tensor] = None,
             compute_dtype: Optional[torch.dtype] = None) -> Tensor:
    """Dense [Q, N] distance matrix. ``metric``: 'l2' | 'ip' | 'cos'.

    For 'cos' the inputs are normalized here; spaces that pre-normalize
    pass metric='ip'. ``x_sq`` / ``q_sq`` are read by the bf16 l2
    epilogue only (the f32 tile computes both norms itself)."""
    if metric == "cos":
        q, x, metric = normalize_rows(q), normalize_rows(x), "ip"
        x_sq = q_sq = None
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    if compute_dtype is None:
        if metric == "l2":
            return l2_tile(q.float().contiguous(), x.float().contiguous())
        return -(q.float() @ x.float().T)
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"unsupported compute_dtype {compute_dtype}")
    d = _bf16_dot(q, x)
    if metric == "ip":
        return d.neg_()
    x_sq = sqnorms(x) if x_sq is None else x_sq
    q_sq = sqnorms(q) if q_sq is None else q_sq
    return d.mul_(-2.0).add_(q_sq[:, None]).add_(x_sq[None, :]).clamp_(
        min=0.0)


def _masked_tiles(valid: Optional[Tensor], n: int, tile_n: int) -> set:
    """Indices of the row tiles that hold a row with ``valid`` False (one
    small transfer to the host, so tiles without one skip the mask pass)."""
    if valid is None:
        return set()
    dead = ~valid[:n]
    pad = _round_up(n, tile_n) - n
    dead = torch.nn.functional.pad(dead, (0, pad)).view(-1, tile_n)
    return set(torch.nonzero(dead.any(1)).flatten().tolist())


def _exact_topk_device(q: Tensor, x: Tensor, x_sq: Optional[Tensor],
                       valid: Optional[Tensor], k: int, metric: str,
                       tile_n: int, bf16: bool) -> Tuple[Tensor, Tensor]:
    """The ``k`` smallest of ``pairwise(q, x)`` per query, scanning ``x``
    in tiles of ``tile_n`` rows: select ``k`` within the tile, then merge
    ``[Q, 2k]`` with the running best (stable, so earlier tiles, which hold
    the lower ids, win ties). ``valid`` (bool [N] or None) masks rows to
    inf. Returns (d [Q, k] f32, ids [Q, k] i32), inf / −1 where fewer than
    ``k`` rows are valid."""
    Q, n = q.shape[0], x.shape[0]
    cdt = torch.bfloat16 if bf16 else None
    q_sq = sqnorms(q) if bf16 and metric == "l2" else None
    best_d = torch.full((Q, k), FINF, device=q.device)
    best_i = torch.full((Q, k), -1, dtype=torch.int32, device=q.device)
    masked = _masked_tiles(valid, n, tile_n)
    for t, lo in enumerate(range(0, n, tile_n)):
        hi = min(lo + tile_n, n)
        d = pairwise(q, x[lo:hi], metric=metric,
                     x_sq=None if x_sq is None else x_sq[lo:hi], q_sq=q_sq,
                     compute_dtype=cdt)
        if t in masked:
            d.masked_fill_(~valid[lo:hi], FINF)
        d_t, sel = select_smallest(d, min(k, hi - lo))
        counters.pairs += Q * (hi - lo)
        counters.tiles += 1
        counters.candidates += Q * min(k, hi - lo)
        # both lists are ascending: the merge network, not a sort
        best_d, best_i = merge_kv(best_d, best_i, d_t.contiguous(),
                                  sel.to(torch.int32) + lo, k)
    best_i = torch.where(torch.isfinite(best_d), best_i,
                         torch.full_like(best_i, -1))
    return best_d, best_i


def row_dots(rows: Tensor, q: Tensor) -> Tensor:
    """Σ_d rows[b, k, d]·q[b, d] → f32 [B, K], for rows gathered for this
    call (overwritten on a CUDA device). There it is an elementwise product
    and a sum over the last axis, whose order does not depend on B or K:
    ``torch.bmm`` picks its kernel, and with it the order of the sums, by
    shape, so a query's distances, and at times its result, would depend
    on the batch it rides in (``scripts/torch_batch_probe.py``). On the CPU
    it is ``torch.bmm``, whose results did not depend on the batch there."""
    if rows.is_cuda:
        return rows.mul_(q.unsqueeze(1)).sum(-1)
    return torch.bmm(rows, q.unsqueeze(2)).squeeze(2)


def _rerank_device(q: Tensor, x: Tensor, x_sq: Optional[Tensor],
                   cand: Tensor, k: int, metric: str
                   ) -> Tuple[Tensor, Tensor]:
    """Full-precision distances for pre-selected candidate ids [Q, C]
    (−1 allowed; f32 rows through one ``gather_dot``), then the ``k``
    smallest, lower position first among ties."""
    if cand.shape[1] < k:
        cand = torch.nn.functional.pad(cand, (0, k - cand.shape[1]),
                                       value=-1)
    if x.dtype == torch.float32:
        from .gather_dot import gather_dot

        cand, q = cand.contiguous(), q.float().contiguous()
        d = (-gather_dot(x, cand, q) if metric == "ip"
             else gather_dot(x, cand, q, sqnorms(q), x_sq))
    else:
        safe = cand.clamp(min=0).long()
        dot = row_dots(x[safe].float(), q.float())
        if metric == "ip":
            d = -dot
        else:
            d = torch.clamp(sqnorms(q)[:, None] + x_sq[safe] - 2.0 * dot,
                            min=0.0)
    d = torch.where(cand >= 0, d, torch.full_like(d, FINF))
    d, sel = topk_smallest(d, k)
    ids = torch.gather(cand, 1, sel)
    return d, torch.where(torch.isfinite(d), ids, torch.full_like(ids, -1))


def exact_topk(queries: Tensor, base: Tensor, k: int, metric: str = "l2",
               valid: Optional[Tensor] = None, tile_n: int = 16384,
               qchunk: int = 4096) -> Tuple[Tensor, Tensor]:
    """Exact top-k of ``base`` rows for each query, scanning ``base`` in
    tiles of ``tile_n`` rows and the queries in slices of ``qchunk`` so the
    distance tile stays bounded (4096 x 16384 f32 = 268 MB). The two-stage
    bf16 scan is ``flat_search_device``. Returns (dists [Q, k] f32,
    ids [Q, k] i32, −1 where fewer than k valid rows)."""
    q = queries.float()
    x = base.float()
    if metric == "cos":
        q, x, metric = normalize_rows(q), normalize_rows(x), "ip"
    out_d, out_i = [], []
    for lo in range(0, q.shape[0], qchunk):
        d, i = _exact_topk_device(q[lo:lo + qchunk], x, None, valid, int(k),
                                  metric, tile_n, bf16=False)
        out_d.append(d)
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)


def flat_search_device(q_all: Tensor, x: Tensor, x_sq: Tensor,
                       valid: Optional[Tensor], k: int, metric: str,
                       tile_n: int = 65536, rerank: int = 40,
                       qchunk: int = 4096) -> Tuple[Tensor, Tensor]:
    """The two-stage flat search (bf16 coarse scan + exact selection of
    ``max(k, rerank)`` candidates + f32 rerank), query slice by query
    slice. ``x`` f32 [N, D] (normalized for cos, ``metric`` then 'ip'),
    ``x_sq`` its squared norms."""
    coarse_k = min(max(k, rerank), min(tile_n, x.shape[0]))
    out_d, out_i = [], []
    for lo in range(0, q_all.shape[0], qchunk):
        q = q_all[lo:lo + qchunk].float()
        _, i = _exact_topk_device(q, x, x_sq, valid, coarse_k, metric,
                                  tile_n, bf16=True)
        d, i = _rerank_device(q, x, x_sq, i, k, metric)
        out_d.append(d)
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)
