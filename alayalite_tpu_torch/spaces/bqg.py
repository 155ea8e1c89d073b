"""Block-SQ8 quantized graph space (port of ``spaces/bqg.py``).

Each node owns one fat row: its R neighbor ids, their SQ8 codes
``[R, Dp]`` and their reconstruction norms, so expanding M nodes costs M
row gathers per query per hop. Quantization is a per-dim global min/max
grid; the distance factors as

    d² = (|q|² − 2 q·(m + 128 s)) − 2 (q∘s)·(c − 128) + |x̂|²

and the middle term is taken by ``ops.gather_diagdot.gather_estimate`` on
the hop (``estimate_many``: one kernel reads the popped nodes' blocks, the
norms and the ids, and writes the estimates) and by
``ops.diagdot.block_diagdot`` on blocks already gathered (``estimate_for``).
IP uses dot coefficient 1 and stores |x̂|² as 0; COS is normalize-then-L2.
Codes are padded from D to Dp (a multiple of 128) with the centre byte 128,
so pads add 0 to the dot; −1 neighbor slots carry |x̂|² = inf.

``fit``, ``insert_raw``, ``set_neighbor_rows`` and ``remove`` update the
tensors in place (the JAX package returns a new pytree). The grid
(dmin/scale) stays fixed after ``fit``: inserted rows outside it clip in
their codes, which costs estimate accuracy only; the rerank is exact.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..ops.diagdot import block_diagdot
from ..ops.distance import normalize_rows
from ..ops.gather_diagdot import gather_estimate
from .raw import bump_slots, tombstone

Tensor = torch.Tensor

# The gather_estimate entry that estimate_many launches. At the hop's shape
# (B 4096, M 8, R 32, Dp 128, codes of 100,000 nodes) chip_smoke.py timed
# rows at 0.0631 ms and bulk at 0.1373 ms of device time, the dot alone
# 0.0546 and 0.1001, on an NVIDIA H100 80GB HBM3 at its 700.00 W power
# limit (bound 0.0322 ms for the dot alone): bulk's persistent blocks walk
# their items one after another (wait, compute, barrier, next copy), rows
# keeps 24 warps an SM with 8 loads in flight each.
ESTIMATE_VARIANT = "rows"
ENCODE_CHUNK = 8192   # rows per step of set_neighbor_rows' encode


@dataclasses.dataclass
class BQGSpace:
    data: Tensor        # [C, D] f32 raw vectors (exact rerank path)
    sq_norms: Tensor    # [C] f32
    dmin: Tensor        # [D] f32
    scale: Tensor       # [D] f32
    nbr_ids: Tensor     # [C, R] i32 (-1 pad)
    nbr_codes: Tensor   # [C, R, Dp] u8; 0 rows until the first encode
    nbr_xsq: Tensor     # [C, R] f32
    valid: Tensor       # [C] bool
    num: int
    metric: str = "l2"       # compute metric: 'l2' | 'ip'
    user_metric: str = "l2"  # as requested: 'l2' | 'ip' | 'cos'

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def dim(self) -> int:
        return self.data.shape[1]

    @property
    def degree(self) -> int:
        return self.nbr_ids.shape[1]

    @property
    def code_dim(self) -> int:
        return self.nbr_codes.shape[2]

    @property
    def device(self) -> torch.device:
        return self.data.device

    # ---- construction ----
    @staticmethod
    def create(capacity: int, dim: int, metric: str = "l2", degree: int = 32,
               device: torch.device = torch.device("cpu")) -> "BQGSpace":
        metric = metric.lower()
        if metric not in ("l2", "cos", "ip"):
            raise ValueError("bqg supports l2/cos/ip metrics")
        cdim = -(-dim // 128) * 128
        f32 = dict(dtype=torch.float32, device=device)
        return BQGSpace(
            data=torch.zeros((capacity, dim), **f32),
            sq_norms=torch.zeros((capacity,), **f32),
            dmin=torch.zeros((dim,), **f32),
            scale=torch.ones((dim,), **f32),
            nbr_ids=torch.full((capacity, degree), -1, dtype=torch.int32,
                               device=device),
            # the [C, R, Dp] code tensor (4 GB at 1M x 32 x 128) is
            # allocated on first encode, not through the kNN phase
            nbr_codes=torch.full((0, degree, cdim), 128, dtype=torch.uint8,
                                 device=device),
            nbr_xsq=torch.zeros((0, degree), **f32),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
            num=0,
            metric="ip" if metric == "ip" else "l2",
            user_metric=metric,
        )

    def _blocks_alloc(self) -> None:
        if self.nbr_codes.shape[0] != self.capacity:
            self.nbr_codes = torch.full(
                (self.capacity, self.degree, self.code_dim), 128,
                dtype=torch.uint8, device=self.device)
            self.nbr_xsq = torch.zeros((self.capacity, self.degree),
                                       dtype=torch.float32,
                                       device=self.device)

    def prep_query(self, q: Tensor) -> Tensor:
        q = q.float()
        return normalize_rows(q) if self.user_metric == "cos" else q

    def fit(self, vectors) -> "BQGSpace":
        """Store ``n`` vectors in slots [0, n) and set the SQ8 grid, in place."""
        v = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        if self.user_metric == "cos":
            v = normalize_rows(v)
        n = v.shape[0]
        dmin = v.min(0).values
        self.scale = torch.clamp((v.max(0).values - dmin) / 255.0, min=1e-30)
        self.dmin = dmin
        self.data[:n] = v
        self.sq_norms[:n] = (v * v).sum(-1)
        self.valid[:n] = True
        self.num = n
        return self

    # ---- neighbor blocks ----
    def update_neighbors(self, nbrs, chunk: int = 2048) -> "BQGSpace":
        """Set rows [0, num) of the adjacency and encode every node's
        neighbor block, chunk by chunk, into the code tensor in place."""
        n = self.num
        if n == 0:
            return self
        r = self.degree
        nb = torch.as_tensor(nbrs, device=self.device)[:n, :r].to(torch.int32)
        if nb.shape[1] < r:
            nb = torch.nn.functional.pad(nb, (0, r - nb.shape[1]), value=-1)
        self.nbr_ids[:n] = nb
        self._blocks_alloc()
        store_sq = self.metric == "l2"
        for lo in range(0, n, chunk):
            codes, xsq = _encode_block(self.data, self.dmin, self.scale,
                                       self.nbr_ids[lo:min(lo + chunk, n)],
                                       store_sq=store_sq)
            self.nbr_codes[lo:lo + codes.shape[0]] = codes
            self.nbr_xsq[lo:lo + codes.shape[0]] = xsq
        return self

    def insert_raw(self, vectors) -> Tensor:
        """Append raw vectors at the bump pointer, in place. Returns the new
        ids (i32 [b]); rows past capacity get −1 and are not stored. The
        new nodes' neighbor blocks are set with ``set_neighbor_rows``."""
        v = torch.atleast_2d(torch.as_tensor(vectors, dtype=torch.float32,
                                             device=self.device))
        if self.user_metric == "cos":
            v = normalize_rows(v)
        start = self.num
        ids, take = bump_slots(start, v.shape[0], self.capacity, self.device)
        if take:
            self.data[start:start + take] = v[:take]
            self.sq_norms[start:start + take] = (v[:take] * v[:take]).sum(-1)
            self.valid[start:start + take] = True
        self.num = start + take
        return ids

    def set_neighbor_rows(self, node_ids, rows) -> "BQGSpace":
        """Set the adjacency rows of arbitrary nodes and re-encode their
        packed blocks, in place. ``rows`` [T, ≤R] is padded to R with −1.
        Negative node ids are dropped with their rows (the JAX package
        scatters them to the last slot). Where an id repeats, the rows must
        be equal: which write lands last is unspecified."""
        ids = torch.as_tensor(node_ids, dtype=torch.int64,
                              device=self.device).reshape(-1)
        rows = torch.as_tensor(rows, device=self.device).to(torch.int32)
        r = self.degree
        if rows.shape[1] < r:
            rows = torch.nn.functional.pad(rows, (0, r - rows.shape[1]),
                                           value=-1)
        keep = ids >= 0
        ids, rows = ids[keep], rows[keep][:, :r]
        self._blocks_alloc()
        for lo in range(0, ids.shape[0], ENCODE_CHUNK):
            sub = ids[lo:lo + ENCODE_CHUNK]
            codes, xsq = _encode_block(self.data, self.dmin, self.scale,
                                       rows[lo:lo + ENCODE_CHUNK],
                                       store_sq=self.metric == "l2")
            self.nbr_ids[sub] = rows[lo:lo + ENCODE_CHUNK]
            self.nbr_codes[sub] = codes
            self.nbr_xsq[sub] = xsq
        return self

    def remove(self, ids) -> None:
        """Tombstone ``ids`` in place; negative ids are ignored (see
        ``raw.tombstone``)."""
        tombstone(self.valid, ids)

    # ---- query side (block-search protocol) ----
    @property
    def _dot_coef(self) -> float:
        # l2: d² = qconst − 2·(q∘s)·c_centered + |x̂|²;
        # ip: −q·x̂ = qconst − (q∘s)·c_centered (|x̂|² stored as 0)
        return 2.0 if self.metric == "l2" else 1.0

    def _clamp(self, est: Tensor) -> Tensor:
        return torch.clamp(est, min=0.0) if self.metric == "l2" else est

    def query_ctx(self, q: Tensor):
        """(q, q∘scale bf16 padded to Dp, qconst): qconst is
        |q|² − 2·q·(m + 128 s) for L2 and −q·(m + 128 s) for IP."""
        qs = (q * self.scale[None, :]).to(torch.bfloat16)
        pad = self.code_dim - self.dim
        if pad:
            qs = torch.nn.functional.pad(qs, (0, pad))  # pads face byte 128
        shift = self.dmin[None, :] + 128.0 * self.scale[None, :]
        if self.metric == "ip":
            qconst = -(q * shift).sum(-1)
        else:
            qconst = (q * q).sum(-1) - 2.0 * (q * shift).sum(-1)
        return q, qs.contiguous(), qconst

    def estimate_for(self, ctx, u: Tensor) -> Tuple[Tensor, Tensor]:
        """Estimated d² (L2) / −q·x̂ (IP) to the R neighbors of one popped
        node per query, u [B]: ([B, R] estimates, [B, R] ids). The blocks
        are gathered first and scored by ``block_diagdot``. This is the
        block-search protocol's one-node entry; ``block_beam_search`` takes
        ``estimate_many`` for every M, so it serves callers that hold the
        space itself (audits of a node's encoded block, tests)."""
        _, qs, qconst = ctx
        safe = u.clamp(0, self.capacity - 1).reshape(-1)
        dot = block_diagdot(self.nbr_codes.index_select(0, safe), qs)
        est = (qconst[:, None] - self._dot_coef * dot
               + self.nbr_xsq.index_select(0, safe))
        return self._clamp(est), self.nbr_ids.index_select(0, safe)

    def estimate_many(self, ctx, u: Tensor) -> Tuple[Tensor, Tensor]:
        """Estimated d² (L2) / −q·x̂ (IP) to the neighbors of all popped
        nodes u [B, M] (clamped into [0, capacity)): ([B, M*R] estimates,
        [B, M*R] ids). On the card one ``gather_estimate`` launch reads the
        code blocks, the norms and the ids and writes both."""
        _, qs, qconst = ctx
        return gather_estimate(self.nbr_codes,
                               u.to(torch.int32).contiguous(), qs,
                               qconst.contiguous(), self._dot_coef,
                               self.nbr_xsq, self.nbr_ids,
                               self.metric == "l2", variant=ESTIMATE_VARIANT)

    def gather_dists(self, q: Tensor, ids: Tensor) -> Tensor:
        """Exact f32 distances (seed scoring + final rerank)."""
        B, K = ids.shape
        safe = ids.clamp(0, self.capacity - 1).reshape(-1)
        vecs = self.data.index_select(0, safe).view(B, K, -1)
        dot = torch.bmm(vecs, q.unsqueeze(2)).squeeze(2)
        if self.metric == "ip":
            return -dot
        q_sq = (q * q).sum(-1, keepdim=True)
        return torch.clamp(
            q_sq + self.sq_norms.index_select(0, safe).view(B, K) - 2.0 * dot,
            min=0.0)

    # ---- persistence (the JAX package's npz keys) ----
    def save_arrays(self) -> dict:
        self._blocks_alloc()
        return {
            "data": self.data.cpu().numpy(),
            "dmin": self.dmin.cpu().numpy(),
            "scale": self.scale.cpu().numpy(),
            "nbr_ids": self.nbr_ids.cpu().numpy(),
            "nbr_codes": self.nbr_codes.cpu().numpy(),
            "nbr_xsq": self.nbr_xsq.cpu().numpy(),
            "valid": self.valid.cpu().numpy(),
            "num": int(self.num),
            "metric": self.user_metric,
        }

    @staticmethod
    def load_arrays(d: dict, device: torch.device = torch.device("cpu")
                    ) -> "BQGSpace":
        data = np.asarray(d["data"], dtype=np.float32)
        ids = np.asarray(d["nbr_ids"])
        sp = BQGSpace.create(data.shape[0], data.shape[1],
                             metric=str(d["metric"]), degree=ids.shape[1],
                             device=device)

        def put(x, dt):
            return torch.tensor(np.asarray(x, dtype=dt), device=device)

        sp.data = put(data, np.float32)
        sp.sq_norms = (sp.data * sp.data).sum(-1)
        sp.dmin = put(d["dmin"], np.float32)
        sp.scale = put(d["scale"], np.float32)
        sp.nbr_ids = put(ids, np.int32)
        sp.nbr_codes = put(d["nbr_codes"], np.uint8)
        sp.nbr_xsq = put(d["nbr_xsq"], np.float32)
        sp.valid = put(d["valid"], bool)
        sp.num = int(d["num"])
        return sp


def _encode_block(data: Tensor, dmin: Tensor, scale: Tensor, nbrs: Tensor,
                  store_sq: bool = True) -> Tuple[Tensor, Tensor]:
    """SQ8-encode neighbor vectors: [C, R] ids → (codes u8 [C, R, Dp],
    |x̂|² — or 0 when ``store_sq`` is False, the IP path — with inf on −1
    slots). Codes are padded to the 128 multiple with the centre byte."""
    C, R = nbrs.shape
    ok = nbrs >= 0
    safe = torch.where(ok, nbrs, torch.zeros_like(nbrs)).reshape(-1)
    vecs = data.index_select(0, safe).view(C, R, -1)
    c = torch.clamp(torch.round((vecs - dmin) / scale), 0, 255)
    if store_sq:
        xhat = c * scale + dmin
        val = (xhat * xhat).sum(-1)
    else:
        val = torch.zeros((C, R), dtype=torch.float32, device=data.device)
    xsq = torch.where(ok, val, torch.full_like(val, float("inf")))
    pad = -(-c.shape[2] // 128) * 128 - c.shape[2]
    if pad:
        c = torch.nn.functional.pad(c, (0, pad), value=128.0)
    return c.to(torch.uint8), xsq
