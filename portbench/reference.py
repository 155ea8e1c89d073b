"""The plain reference: exact k nearest neighbours in plain PyTorch, under
the configuration's metric, and its control, the same search in TF32.

It imports nothing of the program and takes nothing the program made: it
is handed the benchmark's own copy of the vectors and the live set it
worked out itself. TF32 is off for its products. A block of queries is
scored against every live row in float32 (``torch.mm``), the ``SHORTLIST``
best kept, and those re-scored in float64: float32's rounding of the
scores is ~1e-6 of their scale (``Space.scale``), far less than the gap
between a 10th and a 64th neighbour, so the float64 top k of the
shortlist is the exact top k. A query whose k-th float64 distance comes
within ``MARGIN`` of the scale of the shortlist's last float32 distance
is scored again against every row in float64.

Metrics (``index.metric`` of the configuration, the program's names):

  l2    Σ (x − q)²                  (ann-benchmarks' euclidean sets)
  cos   1 − q·x / (‖q‖ ‖x‖)         (its angular sets)

Any other name, the program's ``ip`` among them, is refused (``space``):
a configuration whose metric the reference does not compute cannot be
judged.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

SHORTLIST = 64
MARGIN = 2.5e-4       # of the scale; float32's rounding is ~1e-6 of it
QUERY_BLOCK = 1024


@dataclasses.dataclass
class Knn:
    ids: torch.Tensor     # [Q, k] int64, positions in the live rows
    dists: torch.Tensor   # [Q, k] float64, ascending


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for float32 products on or off inside the block."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away):
    what the tensor cores read of an operand. The control uses it on the
    CPU, which has no TF32 products."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Space:
    """One metric: its float32 scores for the shortlist, its float64
    distances, and the scale of a query's scores."""

    def prepare(self, x: torch.Tensor):
        """(the rows as the products read them, a per-row statistic the
        scores need)."""
        raise NotImplementedError

    def scores(self, q, stat, dot) -> torch.Tensor:
        """float32 distances [B, N] from the products ``dot`` = q·xᵀ."""
        raise NotImplementedError

    def scale(self, q, stat) -> torch.Tensor:
        """[B]: the size of a query's scores, which float32's rounding is
        a fraction of."""
        raise NotImplementedError

    def exact(self, q, rows) -> torch.Tensor:
        """float64 distances: q [B, D], rows [B, K, D] → [B, K]."""
        raise NotImplementedError


class L2(Space):
    def prepare(self, x):
        return x, (x * x).sum(1)

    def scores(self, q, x_sq, dot):
        return (q * q).sum(1, keepdim=True) + x_sq[None, :] - 2.0 * dot

    def scale(self, q, x_sq):
        return (q * q).sum(1) + x_sq.max()

    def exact(self, q, rows):
        diff = rows.double() - q.double()[:, None, :]
        return (diff * diff).sum(-1)


class Cos(Space):
    def prepare(self, x):
        return x / x.norm(dim=1, keepdim=True).clamp(min=1e-30), None

    def scores(self, q, _, dot):
        return 1.0 - dot / q.norm(dim=1, keepdim=True).clamp(min=1e-30)

    def scale(self, q, _):
        return torch.ones(q.shape[0], dtype=q.dtype, device=q.device)

    def exact(self, q, rows):
        q64, r64 = q.double(), rows.double()
        dot = (r64 * q64[:, None, :]).sum(-1)
        norm = r64.norm(dim=-1) * q64.norm(dim=-1)[:, None]
        return 1.0 - dot / norm.clamp(min=1e-300)


SPACES = {"l2": L2(), "cos": Cos()}


def space(metric: str) -> Space:
    """The reference's space for the program's metric name."""
    try:
        return SPACES[str(metric).lower()]
    except KeyError:
        raise ValueError(f"the reference computes no metric {metric!r}; "
                         f"one of {sorted(SPACES)}") from None


def exact_f64(q: torch.Tensor, rows: torch.Tensor,
              metric: str = "l2") -> torch.Tensor:
    """float64 distances under ``metric``: q [B, D], rows [B, K, D] →
    [B, K]."""
    return space(metric).exact(q, rows)


def _products(q, x, emulate_tf32: bool) -> torch.Tensor:
    if emulate_tf32:
        return round_tf32(q) @ round_tf32(x).T
    return q @ x.T


def knn(x: torch.Tensor, queries: torch.Tensor, k: int,
        metric: str = "l2") -> Knn:
    """Exact top ``k`` of ``queries`` over the rows ``x`` [N, D]."""
    sp = space(metric)
    out_i, out_d = [], []
    with tf32(False):
        xp, stat = sp.prepare(x)
        for lo in range(0, queries.shape[0], QUERY_BLOCK):
            q = queries[lo:lo + QUERY_BLOCK]
            s = sp.scores(q, stat, _products(q, xp, False))
            m = min(SHORTLIST, x.shape[0])
            s32, cand = torch.topk(s, m, dim=1, largest=False)
            d64 = sp.exact(q, x[cand])
            d64, order = torch.sort(d64, dim=1, stable=True)
            cand = torch.gather(cand, 1, order)
            margin = MARGIN * sp.scale(q, stat)
            close = d64[:, min(k, m) - 1] > s32[:, -1] - margin
            if m < x.shape[0] and bool(close.any()):
                for r in torch.nonzero(close).reshape(-1).tolist():
                    full = sp.exact(q[r:r + 1], x[None])[0]
                    dr, ir = torch.sort(full, stable=True)
                    d64[r], cand[r] = dr[:m], ir[:m]
            out_i.append(cand[:, :k])
            out_d.append(d64[:, :k])
    return Knn(torch.cat(out_i), torch.cat(out_d))


def knn_tf32(x: torch.Tensor, queries: torch.Tensor, k: int,
             metric: str = "l2") -> Knn:
    """The control: the same search with every product in TF32 (the
    tensor cores on a CUDA device, the rounding emulated on the CPU),
    the top ``k`` ordered by those distances."""
    sp = space(metric)
    out_i, out_d = [], []
    emulate = x.device.type != "cuda"
    with tf32(True):
        xp, stat = sp.prepare(x)
        for lo in range(0, queries.shape[0], QUERY_BLOCK):
            q = queries[lo:lo + QUERY_BLOCK]
            s = sp.scores(q, stat, _products(q, xp, emulate))
            d, i = torch.topk(s, min(k, x.shape[0]), dim=1, largest=False)
            out_i.append(i)
            out_d.append(d.double())
    return Knn(torch.cat(out_i), torch.cat(out_d))
