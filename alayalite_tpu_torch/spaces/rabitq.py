"""RaBitQ quantized-graph space: 1- or 2-bit neighbor codes with correction
factors (port of ``alayalite_tpu/spaces/rabitq.py``).

Each node u owns a block: its 32 neighbor ids, their codes (the signs, or
a 4-level grid, of the rotated residual r' = P(v − u)) packed little-endian
into bytes, and two factors per neighbor, so that

    d²(q, v) ≈ d²(q, u) + f_add + f_rescale · ⟨P q, y⟩

with y = (2b − 1)/√E at 1 bit and y = c − 1.5 at 2 bits (c = p0 + 2·p1),
E the rotated-space dim. ``estimate_many`` scores the blocks of the B·M
nodes a hop pops: it gathers their packed bytes, unpacks them into u8
codes 128 + b (1 bit) or 128 + p0 + 2·p1 (2 bits), and takes

    dot[b, k] = Σ_d (code − 128) · (P q)_d     (bf16 operands, f32 sums)

in one ``block_diagdot`` launch (``csrc/gather_diagdot.cu`` on a CUDA
tensor). Then ⟨P q, y⟩ is (2·dot − Σ P q)/√E or dot − 1.5·Σ P q. The JAX
package takes the same dot as an XLA einsum of the unpacked bits, the two
planes apart (``binary_dot_ref`` here, the tests' plain version).

The rotation is JAX's to the bit: ``make_rotation`` (QR of a Gaussian
draw) and ``make_fht_kac_rotation`` (sign flips and normalized FWHTs,
materialized as a matrix) are the same numpy code. l2 and cos only (cos is
normalize-then-l2); dim a multiple of 8. ``fit``, ``insert_raw``,
``set_neighbor_rows`` and ``remove`` update the tensors in place; a space
created over ``storage`` (a fit's) shares the raw space's slab: rows
appended to it show through once ``num`` is moved.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.diagdot import block_diagdot
from ..ops.distance import normalize_rows
from .raw import bump_slots, tombstone

Tensor = torch.Tensor
DEGREE = 32
QUANT_CHUNK = 8192    # nodes per step of the block quantization


def make_rotation(dim: int, seed: int = 0) -> np.ndarray:
    """Random orthonormal rotation: QR of a Gaussian draw, column signs
    fixed by R's diagonal."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(dim, dim)).astype(np.float64)
    q, r = np.linalg.qr(g)
    q *= np.sign(np.diag(r))[None, :]
    return q.astype(np.float32)


def make_fht_kac_rotation(dim: int, seed: int = 0,
                          rounds: int = 4) -> np.ndarray:
    """The FhtKac rotator materialized as a matrix: ``rounds`` of (random
    ±1 sign flip, normalized FWHT) applied to the identity. A dim that is
    not a power of two pads to the next one: the result is the [Dp, dim]
    column slice (rotating the zero-padded vector)."""
    from ..ops.hadamard import fwht_np

    dp = 1 << (dim - 1).bit_length()
    rng = np.random.default_rng(seed)
    m = np.eye(dp, dtype=np.float64)
    for _ in range(rounds):
        signs = rng.choice([-1.0, 1.0], size=dp)
        m = fwht_np(m * signs[None, :])
    return m.T.astype(np.float32)[:, :dim]


def _shifts(device) -> Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device)


def pack_bits(bits: Tensor) -> Tensor:
    """bool [..., D] → u8 [..., D/8], bit i of byte j = element 8j + i."""
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8).to(torch.uint8)
    return (b << _shifts(bits.device)).sum(-1, dtype=torch.uint8)


def _unpack(packed: Tensor) -> Tensor:
    """u8 [..., n] → {0, 1} u8 [..., 8n] (inverse of ``pack_bits``)."""
    b = (packed.unsqueeze(-1) >> _shifts(packed.device)) & 1
    return b.reshape(*packed.shape[:-1], packed.shape[-1] * 8)


_CODE_LUTS: dict = {}


def _code_lut(device, shift: int, base: int) -> Tensor:
    """i64 [256]: byte b → the u8 codes base | (bit_i << shift) of its 8
    bits, code i in byte i (little-endian), so one lookup writes 8 codes."""
    key = (str(device), shift, base)
    if key not in _CODE_LUTS:
        b = np.arange(256)[:, None] >> np.arange(8)[None, :]
        codes = (((b & 1) << shift) | base).astype(np.uint8)
        _CODE_LUTS[key] = torch.as_tensor(
            codes.view("<i8").reshape(256).copy(), device=device)
    return _CODE_LUTS[key]


def _lookup(packed: Tensor, shift: int, base: int) -> Tensor:
    """u8 [n] → i64 [n] of 8 packed codes each."""
    return _code_lut(packed.device, shift, base).index_select(
        0, packed.int())


def unpack_codes(packed: Tensor, bits: int) -> Tensor:
    """Packed blocks u8 [..., bits·E/8] → codes u8 [..., E] centred on 128:
    128 + b (1 bit) or 128 + p0 + 2·p1 (2 bits; plane 0 in the first E/8
    bytes), by one table lookup a byte per plane."""
    lead = packed.shape[:-1]
    db = packed.shape[-1] // bits
    planes = packed.reshape(-1, bits, db)
    w = _lookup(planes[:, 0].reshape(-1), 0, 128)
    if bits == 2:
        w |= _lookup(planes[:, 1].reshape(-1), 1, 0)
    return w.view(torch.uint8).reshape(*lead, db * 8)


def binary_dot_ref(packed: Tensor, qrot: Tensor, bits: int) -> Tensor:
    """Plain version of the hop's binary dot, as the JAX package takes it:
    the bit planes unpacked to bf16, each multiplied by the bf16 query in
    f32 and summed, planes apart. packed u8 [B, K, bits·E/8], qrot f32
    [B, E] → Σ_d c_d·(P q)_d f32 [B, K] with c = b or p0 + 2·p1."""
    qb = qrot.to(torch.bfloat16).float()[:, None, :]
    planes = packed.chunk(bits, dim=-1)
    dots = [(_unpack(p).to(torch.bfloat16).float() * qb).sum(-1)
            for p in planes]
    return dots[0] if bits == 1 else dots[0] + 2.0 * dots[1]


@dataclasses.dataclass
class RaBitQSpace:
    data: Tensor        # [C, D] f32 raw vectors (shared with the raw space
                        # when created over its storage)
    sq_norms: Tensor    # [C] f32
    rot: Tensor         # [E, D] f32 orthonormal rotation P
    nbr_ids: Tensor     # [C, 32] i32 (−1 pad)
    nbr_bits: Tensor    # [C, 32 · bits·E/8] u8; 0 rows until the first write
    f_add: Tensor       # [C, 32] f32
    f_rescale: Tensor   # [C, 32] f32
    valid: Tensor       # [C] bool
    num: int
    metric: str = "l2"       # compute metric: always l2
    user_metric: str = "l2"  # as requested: 'l2' | 'cos'
    bits: int = 1

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def dim(self) -> int:
        return self.data.shape[1]

    @property
    def code_dim(self) -> int:
        """Rotated-space dim E: the dim, or the next power of two for
        FhtKac at other dims."""
        return self.rot.shape[0]

    @property
    def degree(self) -> int:
        return self.nbr_ids.shape[1]

    @property
    def device(self) -> torch.device:
        return self.data.device

    # ---- construction ----
    @staticmethod
    def create(capacity: int, dim: int, metric: str = "l2", seed: int = 0,
               rotator: str = "matrix", bits: int = 1, rot=None,
               storage=None, device: torch.device = torch.device("cpu")
               ) -> "RaBitQSpace":
        """``storage``: the raw space's (data, sq_norms, valid, num) to share
        instead of allocating a slab (f32 [capacity, dim]); ``rot`` a saved
        rotation (skips the QR)."""
        metric = metric.lower()
        if metric not in ("l2", "cos"):
            raise ValueError("rabitq supports l2/cos metrics; "
                             "use quantization_type='bsq8' for ip")
        if dim % 8:
            raise ValueError("rabitq requires dim to be a multiple of 8")
        if rotator not in ("matrix", "fht_kac"):
            raise ValueError(f"unknown rotator {rotator!r}")
        if bits not in (1, 2):
            raise ValueError("rabitq bits must be 1 or 2")
        if rot is None:
            rot = (make_fht_kac_rotation(dim, seed) if rotator == "fht_kac"
                   else make_rotation(dim, seed))
        rot = torch.tensor(np.asarray(rot, dtype=np.float32), device=device)
        f32 = dict(dtype=torch.float32, device=device)
        if storage is not None:
            data, sq_norms, valid, num = storage
            if (tuple(data.shape) != (capacity, dim)
                    or data.dtype != torch.float32):
                raise ValueError("adopted storage must be f32 [capacity, dim]")
        else:
            data = torch.zeros((capacity, dim), **f32)
            sq_norms = torch.zeros((capacity,), **f32)
            valid = torch.zeros((capacity,), dtype=torch.bool, device=device)
            num = 0
        nbytes = bits * rot.shape[0] // 8
        return RaBitQSpace(
            data=data, sq_norms=sq_norms, rot=rot,
            nbr_ids=torch.full((capacity, DEGREE), -1, dtype=torch.int32,
                               device=device),
            # the blocks are written only by the build's last step: they
            # are allocated then, not through the kNN and prune phases
            nbr_bits=torch.zeros((0, DEGREE * nbytes), dtype=torch.uint8,
                                 device=device),
            f_add=torch.zeros((0, DEGREE), **f32),
            f_rescale=torch.zeros((0, DEGREE), **f32),
            valid=valid, num=int(num), metric="l2", user_metric=metric,
            bits=bits)

    def _blocks_alloc(self) -> None:
        if self.nbr_bits.shape[0] != self.capacity:
            dev = self.device
            self.nbr_bits = torch.zeros((self.capacity,
                                         self.nbr_bits.shape[1]),
                                        dtype=torch.uint8, device=dev)
            self.f_add = torch.zeros((self.capacity, DEGREE),
                                     dtype=torch.float32, device=dev)
            self.f_rescale = torch.zeros_like(self.f_add)

    def prep_query(self, q: Tensor) -> Tensor:
        q = q.float()
        return normalize_rows(q) if self.user_metric == "cos" else q

    def fit(self, vectors) -> "RaBitQSpace":
        """Store ``n`` vectors in slots [0, n), in place; the blocks come
        with ``update_neighbors`` once the graph exists."""
        v = self.prep_query(torch.as_tensor(vectors, dtype=torch.float32,
                                            device=self.device))
        n = v.shape[0]
        self.data[:n] = v
        self.sq_norms[:n] = (v * v).sum(-1)
        self.valid[:n] = True
        self.num = n
        return self

    # ---- neighbor blocks ----
    def _write_blocks(self, ids: Tensor, rows: Tensor) -> None:
        """Quantize the blocks of nodes ``ids`` [T] (≥ 0) with neighbor rows
        [T, 32] and write ids, codes and factors, in chunks."""
        self._blocks_alloc()
        for lo in range(0, ids.shape[0], QUANT_CHUNK):
            sub, r = ids[lo:lo + QUANT_CHUNK], rows[lo:lo + QUANT_CHUNK]
            code, fa, fr = quantize_block(self.data, self.rot, sub, r,
                                          bits=self.bits)
            self.nbr_ids[sub] = r
            self.nbr_bits[sub] = pack_bits(code).reshape(sub.shape[0], -1)
            self.f_add[sub] = fa
            self.f_rescale[sub] = fr

    def _pad_rows(self, rows) -> Tensor:
        rows = torch.as_tensor(rows, device=self.device).to(torch.int32)
        if rows.shape[1] < DEGREE:
            rows = torch.nn.functional.pad(rows, (0, DEGREE - rows.shape[1]),
                                           value=-1)
        return rows[:, :DEGREE]

    def update_neighbors(self, nbrs, chunk: int = QUANT_CHUNK
                         ) -> "RaBitQSpace":
        """Set rows [0, num) of the adjacency from ``nbrs`` [≥ num, ≤ 32]
        and quantize every node's block, in place."""
        n = self.num
        if n == 0:
            return self
        rows = self._pad_rows(torch.as_tensor(nbrs, device=self.device)[:n])
        ids = torch.arange(n, dtype=torch.int64, device=self.device)
        for lo in range(0, n, chunk):
            self._write_blocks(ids[lo:lo + chunk], rows[lo:lo + chunk])
        return self

    def insert_raw(self, vectors) -> Tensor:
        """Append raw vectors at the bump pointer, in place; the new nodes'
        blocks come with ``set_neighbor_rows``. Returns the ids (i32 [b]),
        −1 past capacity."""
        v = self.prep_query(torch.atleast_2d(torch.as_tensor(
            vectors, dtype=torch.float32, device=self.device)))
        start = self.num
        ids, take = bump_slots(start, v.shape[0], self.capacity, self.device)
        if take:
            self.data[start:start + take] = v[:take]
            self.sq_norms[start:start + take] = (v[:take] * v[:take]).sum(-1)
            self.valid[start:start + take] = True
        self.num = start + take
        return ids

    def set_neighbor_rows(self, node_ids, rows) -> "RaBitQSpace":
        """Set the adjacency rows of arbitrary nodes and re-quantize their
        blocks, in place. Negative node ids are dropped with their rows;
        a repeated id must carry equal rows."""
        ids = torch.as_tensor(node_ids, dtype=torch.int64,
                              device=self.device).reshape(-1)
        rows = self._pad_rows(rows)
        keep = ids >= 0
        self._write_blocks(ids[keep], rows[keep])
        return self

    def remove(self, ids) -> None:
        """Tombstone ``ids`` in place (see ``raw.tombstone``)."""
        tombstone(self.valid, ids)

    # ---- query side (block-search protocol) ----
    def query_ctx(self, q: Tensor):
        """(q, P·q in bf16 [B, E], Σ_d (P·q)_d f32 [B]), once per batch."""
        qrot = q @ self.rot.T
        return q, qrot.to(torch.bfloat16).contiguous(), qrot.sum(-1)

    def _epilogue(self, dot: Tensor, qsum: Tensor, d_center: Tensor,
                  safe: Tensor) -> Tensor:
        """est = max(d_center + f_add + f_rescale·⟨P q, y⟩, 0) from the
        binary dot [B, M, 32] of the blocks of ``safe`` [B, M]."""
        if self.bits == 1:
            proj = (2.0 * dot - qsum[:, None, None]) / math.sqrt(
                self.code_dim)
        else:
            proj = dot - 1.5 * qsum[:, None, None]
        est = (d_center[:, :, None] + self.f_add[safe]
               + self.f_rescale[safe] * proj)
        return torch.clamp(est, min=0.0)

    def estimate_many(self, ctx, u: Tensor,
                      d_center: Optional[Tensor] = None
                      ) -> Tuple[Tensor, Tensor]:
        """Estimated d² to the neighbors of the popped nodes u [B, M]
        (clamped into [0, capacity)): ([B, M·32] estimates, [B, M·32] ids).
        ``d_center`` [B, M], the popped nodes' exact distances, is gathered
        here unless the caller already holds it (the 1-bit result pool).
        One ``block_diagdot`` launch on the unpacked codes."""
        q, qs, qsum = ctx
        B, M = u.shape
        safe = u.clamp(0, self.capacity - 1).long()
        if d_center is None:
            d_center = self.gather_dists(q, safe)
        packed = self.nbr_bits.index_select(0, safe.reshape(-1))
        codes = unpack_codes(packed.view(B, M * DEGREE, -1), self.bits)
        dot = block_diagdot(codes, qs).view(B, M, DEGREE)
        est = self._epilogue(dot, qsum, d_center, safe)
        return est.reshape(B, -1), self.nbr_ids[safe].reshape(B, -1)

    def gather_dists(self, q: Tensor, ids: Tensor) -> Tensor:
        """Exact f32 squared distances (seeds, result pool, rerank)."""
        B, K = ids.shape
        safe = ids.clamp(0, self.capacity - 1).reshape(-1)
        vecs = self.data.index_select(0, safe).view(B, K, -1)
        dot = torch.bmm(vecs, q.unsqueeze(2)).squeeze(2)
        q_sq = (q * q).sum(-1, keepdim=True)
        return torch.clamp(
            q_sq + self.sq_norms.index_select(0, safe).view(B, K) - 2.0 * dot,
            min=0.0)

    # ---- persistence (the JAX package's npz keys) ----
    def save_arrays(self) -> dict:
        self._blocks_alloc()
        return {
            "data": self.data.cpu().numpy(),
            "rot": self.rot.cpu().numpy(),
            "nbr_ids": self.nbr_ids.cpu().numpy(),
            "nbr_bits": self.nbr_bits.cpu().numpy(),
            "f_add": self.f_add.cpu().numpy(),
            "f_rescale": self.f_rescale.cpu().numpy(),
            "valid": self.valid.cpu().numpy(),
            "num": int(self.num),
            "metric": self.user_metric,
            "bits": self.bits,
        }

    @staticmethod
    def load_arrays(d: dict, device: torch.device = torch.device("cpu"),
                    storage=None) -> "RaBitQSpace":
        """``storage``: the loaded raw space's (data, sq_norms, valid, num)
        to share, as a fit does, in place of the saved ``data``."""
        def put(x, dt):
            return torch.tensor(np.asarray(x, dtype=dt), device=device)

        if storage is None:
            data = put(d["data"], np.float32)
            storage = (data, (data * data).sum(-1), put(d["valid"], bool),
                       int(d["num"]))
        data = storage[0]
        sp = RaBitQSpace.create(data.shape[0], data.shape[1],
                                metric=str(d["metric"]),
                                bits=int(d.get("bits", 1)), rot=d["rot"],
                                storage=storage, device=device)
        sp.nbr_ids = put(d["nbr_ids"], np.int32)
        # flat [C, 32·nbytes], or the older [C, 32, nbytes]
        sp.nbr_bits = put(np.asarray(d["nbr_bits"], dtype=np.uint8)
                          .reshape(data.shape[0], -1), np.uint8)
        sp.f_add = put(d["f_add"], np.float32)
        sp.f_rescale = put(d["f_rescale"], np.float32)
        return sp


def quantize_block(data: Tensor, rot: Tensor, us: Tensor, nbrs: Tensor,
                   bits: int = 1):
    """Quantize the neighbor blocks of nodes ``us`` [C] with neighbors
    ``nbrs`` [C, 32] (−1 pad): (code planes bool [C, 32, bits·E], plane p
    at [..., p·E:(p+1)·E]; f_add [C, 32]; f_rescale [C, 32]). The JAX
    package's factor math: 1 bit codes the sign of the rotated residual,
    2 bits a 4-level uniform grid of step 0.9957·σ (σ = |r|/√E); a
    degenerate residual (0, or orthogonal to its code) gets factors 0, so
    its estimate falls back to d²(q, u)."""
    e = rot.shape[0]
    rot_t = rot.T
    center = data[us.long()]                               # [C, D]
    ok = nbrs >= 0
    vecs = data[torch.where(ok, nbrs, torch.zeros_like(nbrs)).long()]
    r = vecs - center[:, None, :]                          # [C, 32, D]
    rrot = r @ rot_t                                       # [C, 32, E]
    rsq = (r * r).sum(-1)
    norm_r = torch.sqrt(rsq)
    crot = center @ rot_t                                  # [C, E] = P·u
    zero = torch.zeros_like(norm_r)
    if bits == 1:
        code = rrot > 0
        xbar = (2.0 * code.float() - 1.0) / math.sqrt(float(e))
        rhat_dot_x = (rrot * xbar).sum(-1) / torch.clamp(norm_r, min=1e-30)
        good = ok & (rhat_dot_x > 1e-6)
        f_rescale = torch.where(
            good, -2.0 * norm_r / torch.where(good, rhat_dot_x,
                                              torch.ones_like(norm_r)), zero)
        c_dot_x = (xbar * crot[:, None, :]).sum(-1)
        f_add = torch.where(good, rsq - f_rescale * c_dot_x, zero)
        return code, f_add, f_rescale
    sigma = norm_r[:, :, None] / math.sqrt(float(e))
    step = 0.9957 * torch.clamp(sigma, min=1e-30)
    c = torch.clamp(torch.round(rrot / step + 1.5), 0, 3)
    y = c - 1.5
    t = (rrot * y).sum(-1)
    good = ok & (t > 1e-12)
    f_rescale = torch.where(
        good, -2.0 * rsq / torch.where(good, t, torch.ones_like(t)), zero)
    c_dot_y = (y * crot[:, None, :]).sum(-1)
    f_add = torch.where(good, rsq - f_rescale * c_dot_y, zero)
    ci = c.to(torch.int32)
    planes = torch.cat([(ci & 1) > 0, (ci >> 1) > 0], dim=-1)
    return planes, f_add, f_rescale
