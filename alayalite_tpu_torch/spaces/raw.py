"""RawSpace: full-precision vector store (port of ``spaces/raw.py``).

A plain dataclass of tensors on one device: ``data[capacity, dim]`` with a
``valid`` mask and a ``num`` bump counter. COS is stored normalized and
computed as IP, like the JAX package. ``fit``, ``insert`` and ``remove``
update the tensors in place (the JAX package returns a new pytree).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.distance import normalize_rows, sqnorms


STORAGE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def bump_slots(num: int, b: int, capacity: int, device: torch.device):
    """Slots for ``b`` rows appended at the bump pointer ``num``: (ids i32
    [b], −1 past capacity; how many fit)."""
    take = max(0, min(b, capacity - num))
    ids = torch.full((b,), -1, dtype=torch.int32, device=device)
    ids[:take] = torch.arange(num, num + take, dtype=torch.int32,
                              device=device)
    return ids, take


def tombstone(valid: torch.Tensor, ids) -> None:
    """Clear ``valid`` at ``ids`` in place: ids past the end are clipped to
    the last slot, negative ids (−1) are ignored."""
    ids = torch.as_tensor(ids, dtype=torch.int64,
                          device=valid.device).reshape(-1)
    valid[ids[ids >= 0].clamp(max=valid.shape[0] - 1)] = False


@dataclasses.dataclass
class RawSpace:
    data: torch.Tensor       # [capacity, dim] f32, or bf16 (bf16 storage and
                             # the build's pool copy)
    sq_norms: torch.Tensor   # [capacity] f32 (0 for empty slots)
    valid: torch.Tensor      # [capacity] bool
    num: int                 # bump counter (next free slot)
    metric: str              # compute metric: 'l2' | 'ip'
    user_metric: str         # as requested: 'l2' | 'ip' | 'cos'
    bf16: bool = False       # bf16 rows: queries are rounded to bf16 too

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def dim(self) -> int:
        return self.data.shape[1]

    @property
    def device(self) -> torch.device:
        return self.data.device

    @staticmethod
    def create(capacity: int, dim: int, metric: str = "l2",
               storage_dtype: str = "float32",
               device: torch.device = torch.device("cpu")) -> "RawSpace":
        if storage_dtype not in STORAGE_DTYPES:
            raise NotImplementedError(
                f"storage_dtype={storage_dtype!r} is not ported yet "
                "(ROADMAP queue 1, item 8: integer and float16 storage)")
        metric = metric.lower()
        return RawSpace(
            data=torch.zeros((capacity, dim),
                             dtype=STORAGE_DTYPES[storage_dtype],
                             device=device),
            sq_norms=torch.zeros((capacity,), dtype=torch.float32,
                                 device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
            num=0,
            metric="ip" if metric in ("ip", "cos") else "l2",
            user_metric=metric,
            bf16=storage_dtype == "bfloat16",
        )

    def prep_query(self, q: torch.Tensor) -> torch.Tensor:
        q = q.float()
        return normalize_rows(q) if self.user_metric == "cos" else q

    def fit(self, vectors) -> "RawSpace":
        """Bulk-load ``n`` vectors into slots [0, n), in place."""
        v = torch.as_tensor(vectors, dtype=torch.float32, device=self.device)
        n = v.shape[0]
        if n > self.capacity:
            raise ValueError(f"fit of {n} vectors exceeds capacity "
                             f"{self.capacity}")
        if self.user_metric == "cos":
            v = normalize_rows(v)
        self.data[:n] = v.to(self.data.dtype)
        self.sq_norms[:n] = sqnorms(v)
        self.valid[:n] = True
        self.num = n
        return self

    def insert(self, vectors) -> torch.Tensor:
        """Append a batch at the bump pointer, in place. Returns the new ids
        (i32 [b]); slots past capacity get −1 and leave the stored rows as
        they were."""
        v = torch.atleast_2d(torch.as_tensor(vectors, dtype=torch.float32,
                                             device=self.device))
        if self.user_metric == "cos":
            v = normalize_rows(v)
        start, b = self.num, v.shape[0]
        ids, take = bump_slots(start, b, self.capacity, self.device)
        if take:
            self.data[start:start + take] = v[:take].to(self.data.dtype)
            self.sq_norms[start:start + take] = sqnorms(v[:take])
            self.valid[start:start + take] = True
        self.num = min(start + b, self.capacity)
        return ids

    def remove(self, ids) -> None:
        """Tombstone ``ids`` in place (see ``tombstone``)."""
        tombstone(self.valid, ids)

    def gather_dists(self, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Distances from per-query vectors q [B, D] to gathered node ids
        [B, K] (−1 allowed; the caller masks). Returns f32 [B, K]. A bf16
        space multiplies bf16 values with f32 accumulation, as the JAX
        bf16 einsum does."""
        B, K = ids.shape
        safe = ids.clamp(0, self.capacity - 1).reshape(-1)
        vecs = self.data.index_select(0, safe).view(B, K, -1).float()
        qq = q.to(torch.bfloat16).float() if self.bf16 else q
        dot = torch.bmm(vecs, qq.unsqueeze(2)).squeeze(2)
        if self.metric == "ip":
            return -dot
        q_sq = (q * q).sum(-1, keepdim=True)
        d = q_sq + self.sq_norms.index_select(0, safe).view(B, K) - 2.0 * dot
        return torch.clamp(d, min=0.0)

    # ---- persistence (the JAX package's npz keys) ----
    def save_arrays(self) -> dict:
        return {
            "data": self.data.float().cpu().numpy(),
            "valid": self.valid.cpu().numpy(),
            "num": int(self.num),
            "metric": self.user_metric,
        }

    @staticmethod
    def load_arrays(d: dict, storage_dtype: str = "float32",
                    device: torch.device = torch.device("cpu")) -> "RawSpace":
        data = np.asarray(d["data"], dtype=np.float32)
        sp = RawSpace.create(data.shape[0], data.shape[1],
                             metric=str(d["metric"]),
                             storage_dtype=storage_dtype, device=device)
        # data on disk is already normalized for cos: no re-normalize
        full = torch.tensor(data, device=device)
        sp.data = full.to(sp.data.dtype)
        sp.sq_norms = sqnorms(full)
        sp.valid = torch.tensor(np.asarray(d["valid"], dtype=bool),
                                device=device)
        sp.num = int(d["num"])
        return sp
