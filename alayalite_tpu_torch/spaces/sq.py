"""SQSpace: per-dimension scalar quantization to 8 bits (port of the sq8
part of ``spaces/sq.py``).

A plain dataclass of tensors on one device: ``codes[capacity, dim]`` u8,
the per-dimension ``dmin`` and ``scale``, ``|x̂|²`` per row, a ``valid``
mask and a ``num`` bump counter. ``code = round((v − dmin) / scale)``
clipped to [0, 255]; ``torch.round`` rounds half to even like
``jnp.round``, so the codes come out byte-identical to the JAX package's.
COS rows are normalized first and the compute metric becomes IP.

``fit``, ``insert`` and ``remove`` update the tensors in place (the JAX
package returns a new pytree). The distance tile against these codes is
``ops/sq8_tile.sq8_tile``. ``bits=4`` and ``gather_dists`` (quantized
graph traversal) wait for the graph path, ROADMAP queue 1 items 8-9.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..ops.distance import normalize_rows
from .raw import bump_slots, tombstone

_NOT_PORTED = "(ROADMAP queue 1, items 8-9: sq graph traversal)"


@dataclasses.dataclass
class SQSpace:
    codes: torch.Tensor      # [capacity, dim] u8
    dmin: torch.Tensor       # [dim] f32 per-dim minimum
    scale: torch.Tensor      # [dim] f32 per-dim (max − min) / 255
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
        if bits == 4:
            raise NotImplementedError(f"sq4 is not ported yet {_NOT_PORTED}")
        if bits != 8:
            raise ValueError("bits must be 4 or 8")
        metric = metric.lower()
        return SQSpace(
            codes=torch.zeros((capacity, dim), dtype=torch.uint8,
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
        return c.to(torch.uint8), (xhat * xhat).sum(-1)

    def decode(self, ids: torch.Tensor) -> torch.Tensor:
        """Reconstructed rows ``codes[ids]·scale + dmin``, f32."""
        return self.codes[ids].float() * self.scale + self.dmin

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

    def gather_dists(self, q: torch.Tensor, ids: torch.Tensor):
        raise NotImplementedError(
            f"SQSpace.gather_dists is not ported yet {_NOT_PORTED}")

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
