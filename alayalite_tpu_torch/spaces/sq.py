"""SQSpace: per-dimension scalar quantization to 8 or 4 bits (port of
``spaces/sq.py``).

A plain dataclass of tensors on one device: ``codes`` u8 ``[capacity, dim]``
(sq8) or ``[capacity, ceil(dim / 2)]`` (sq4: two codes per byte, even
dimension in the low nibble), the per-dimension ``dmin`` and ``scale``,
``|x̂|²`` per row, a ``valid`` mask and a ``num`` bump counter.
``code = round((v − dmin) / scale)`` clipped to [0, levels];
``torch.round`` rounds half to even like ``jnp.round``, so the codes come
out byte-identical to the JAX package's. COS rows are normalized first and
the compute metric becomes IP.

``gather_dists`` is the asymmetric distance of a quantized graph
traversal: with x̂ = c∘s + m, q·x̂ = (q∘s)·(c − h) + q·(m + h·s), h =
(levels + 1) / 2; the centred codes and q∘s are bf16 values (both exact or
rounded as in the JAX package), products and sums f32. An sq8 space on a
CUDA device takes that sum through ``ops/gather_diagdot`` (the codes as
one-row blocks); sq4, and any space on the CPU, through ``index_select`` and
``torch.bmm``.

``fit``, ``insert`` and ``remove`` update the tensors in place (the JAX
package returns a new pytree). The distance tile against sq8 codes is
``ops/sq8_tile.sq8_tile``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..ops.distance import normalize_rows
from ..ops.gather_diagdot import gather_diagdot
from .raw import bump_slots, tombstone

# The gather_diagdot entry of the sq8 traversal's dot. At (4096 queries x
# 256 ids over 100,000 x 128 codes) chip_smoke.py timed rows at 0.0476 ms
# and bulk at 0.2429 ms of device time on an NVIDIA H100 80GB HBM3 at
# 700.00 W: bulk moves 128-byte rows one TMA copy each.
GATHER_VARIANT = "rows"


@dataclasses.dataclass
class SQSpace:
    codes: torch.Tensor      # [capacity, dim] u8; sq4 [capacity, ceil(dim/2)]
    dmin: torch.Tensor       # [dim] f32 per-dim minimum
    scale: torch.Tensor      # [dim] f32 per-dim (max − min) / levels
    xhat_sq: torch.Tensor    # [capacity] f32 |decoded row|²
    valid: torch.Tensor      # [capacity] bool
    num: int                 # bump counter (next free slot)
    metric: str              # compute metric: 'l2' | 'ip'
    user_metric: str         # as requested: 'l2' | 'ip' | 'cos'
    bits: int = 8
    dim: int = 0

    @property
    def capacity(self) -> int:
        return self.codes.shape[0]

    @property
    def levels(self) -> int:
        return (1 << self.bits) - 1

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @staticmethod
    def create(capacity: int, dim: int, bits: int = 8, metric: str = "l2",
               device: torch.device = torch.device("cpu")) -> "SQSpace":
        if bits not in (4, 8):
            raise ValueError("bits must be 4 or 8")
        metric = metric.lower()
        width = dim if bits == 8 else (dim + 1) // 2
        return SQSpace(
            codes=torch.zeros((capacity, width), dtype=torch.uint8,
                              device=device),
            dmin=torch.zeros((dim,), dtype=torch.float32, device=device),
            scale=torch.ones((dim,), dtype=torch.float32, device=device),
            xhat_sq=torch.zeros((capacity,), dtype=torch.float32,
                                device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
            num=0,
            metric="ip" if metric in ("ip", "cos") else "l2",
            user_metric=metric,
            bits=bits,
            dim=dim,
        )

    def prep_query(self, q: torch.Tensor) -> torch.Tensor:
        q = q.float()
        return normalize_rows(q) if self.user_metric == "cos" else q

    # ---- encode / decode ----
    def _encode(self, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Quantize rows → (codes u8, |x̂|²)."""
        c = torch.clamp(torch.round((v - self.dmin[None, :])
                                    / torch.clamp(self.scale[None, :],
                                                  min=1e-30)),
                        0, float(self.levels))
        xhat = c * self.scale[None, :] + self.dmin[None, :]
        xsq = (xhat * xhat).sum(-1)
        c = c.to(torch.uint8)
        if self.bits == 4:
            if v.shape[1] % 2:
                c = torch.nn.functional.pad(c, (0, 1))
            c = c[:, 0::2] | (c[:, 1::2] << 4)
        return c, xsq

    def _decode_codes(self, packed: torch.Tensor) -> torch.Tensor:
        """packed [..., dim or ceil(dim/2)] u8 → codes [..., dim] f32."""
        if self.bits == 8:
            return packed.float()
        c = torch.stack([packed & 0x0F, packed >> 4], dim=-1)
        return c.reshape(*packed.shape[:-1], -1)[..., :self.dim].float()

    def decode(self, ids: torch.Tensor) -> torch.Tensor:
        """Reconstructed rows ``codes[ids]·scale + dmin``, f32."""
        return self._decode_codes(self.codes[ids]) * self.scale + self.dmin

    # ---- fit / insert / remove (in place) ----
    def fit(self, vectors) -> "SQSpace":
        """Per-dimension range of ``vectors``, then encode them into slots
        [0, n), in chunks of ~2e8 values (three f32 transients per chunk)."""
        v = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        n, dim = v.shape
        if n > self.capacity:
            raise ValueError(f"fit of {n} vectors exceeds capacity "
                             f"{self.capacity}")
        if self.user_metric == "cos":
            v = normalize_rows(v)
        self.dmin = v.min(0).values
        self.scale = torch.clamp((v.max(0).values - self.dmin)
                                 / float(self.levels), min=1e-30)
        step = max(1, min(n, int(2e8 // max(dim, 1))))
        for lo in range(0, n, step):
            c, xsq = self._encode(v[lo:lo + step])
            self.codes[lo:lo + c.shape[0]] = c
            self.xhat_sq[lo:lo + c.shape[0]] = xsq
        self.valid[:n] = True
        self.num = n
        return self

    def insert(self, vectors) -> torch.Tensor:
        """Encode a batch at the bump pointer, in place. Returns the new ids
        (i32 [b]); slots past capacity get −1 and leave the stored rows as
        they were."""
        v = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        v = torch.atleast_2d(v)
        if self.user_metric == "cos":
            v = normalize_rows(v)
        start, b = self.num, v.shape[0]
        ids, take = bump_slots(start, b, self.capacity, self.device)
        if take:
            c, xsq = self._encode(v[:take])
            self.codes[start:start + take] = c
            self.xhat_sq[start:start + take] = xsq
            self.valid[start:start + take] = True
        self.num = min(start + b, self.capacity)
        return ids

    def remove(self, ids) -> None:
        """Tombstone ``ids`` in place (see ``spaces.raw.tombstone``)."""
        tombstone(self.valid, ids)

    def gather_dists(self, q: torch.Tensor, ids: torch.Tensor
                     ) -> torch.Tensor:
        """f32 [B, K] asymmetric distances from q [B, D] (prep_query'd) to
        the decoded rows ``ids`` [B, K] (−1 allowed; the caller masks). The
        codes are centred (c − h) before the product and the offset is
        folded into the per-query constant: uncentred, a large positive dot
        cancels against q·dmin and the bf16 rounding of q∘s grows
        ~levels/2-fold."""
        B, K = ids.shape
        safe = ids.clamp(0, self.capacity - 1).reshape(-1)
        half = float((self.levels + 1) // 2)
        qs = (q * self.scale[None, :]).to(torch.bfloat16)
        if self.bits == 8 and q.device.type == "cuda":
            # the codes as one-row blocks [C, 1, dim]: the kernel reads the
            # u8 rows once, with no decoded copy. Its epilogue form
            # (qconst − c·dot + xsq) is not this one's f32 order, so the
            # dot alone is taken and the epilogue stays here
            dot_c = gather_diagdot(self.codes.view(self.capacity, 1, -1),
                                   safe.view(B, K), qs.contiguous(),
                                   variant=GATHER_VARIANT)
        else:
            # c − h is an integer of at most 8 bits: exact in bf16, and its
            # product with a bf16 value is exact in f32
            cf = self._decode_codes(self.codes.index_select(0, safe)) - half
            dot_c = torch.bmm(cf.view(B, K, -1),
                              qs.float().unsqueeze(2)).squeeze(2)
        # q·x̂ = (q∘s)·(c − h) + q·(m + h·s)
        shift = self.dmin[None, :] + half * self.scale[None, :]
        q_dot_x = dot_c + (q * shift).sum(-1, keepdim=True)
        if self.metric == "ip":
            return -q_dot_x
        q_sq = (q * q).sum(-1, keepdim=True)
        d = q_sq - 2.0 * q_dot_x + self.xhat_sq.index_select(0, safe).view(B, K)
        return torch.clamp(d, min=0.0)

    # ---- persistence (the JAX package's npz keys) ----
    def save_arrays(self) -> dict:
        return {
            "codes": self.codes.cpu().numpy(),
            "dmin": self.dmin.cpu().numpy(),
            "scale": self.scale.cpu().numpy(),
            "xhat_sq": self.xhat_sq.cpu().numpy(),
            "valid": self.valid.cpu().numpy(),
            "num": int(self.num),
            "metric": self.user_metric,
            "bits": self.bits,
            "dim": self.dim,
        }

    @staticmethod
    def load_arrays(d: dict, device: torch.device = torch.device("cpu")
                    ) -> "SQSpace":
        codes = np.asarray(d["codes"])
        sp = SQSpace.create(codes.shape[0], int(d["dim"]),
                            bits=int(d["bits"]), metric=str(d["metric"]),
                            device=device)

        def t(key, dtype):
            return torch.tensor(np.asarray(d[key], dtype=dtype),
                                device=device)

        sp.codes = t("codes", np.uint8)
        sp.dmin = t("dmin", np.float32)
        sp.scale = t("scale", np.float32)
        sp.xhat_sq = t("xhat_sq", np.float32)
        sp.valid = t("valid", bool)
        sp.num = int(d["num"])
        return sp
