"""The yardstick of the kernels: the card's peaks, the least time a piece
of work could take on it, and the bytes of the kernels the benchmark
holds against it. A copy of the program's ``utils/timing.bound``
arithmetic, so that no later change to the program moves it.

Peaks of one NVIDIA H100 SXM from NVIDIA's data sheet (dense rates, the
700 W limit); a card set below 700 W runs slower, so its power limit is
printed beside every run.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12,      # float32 on the CUDA cores
                  "bf16": 989e12}    # bf16 on the tensor cores


def bound_s(nbytes: float, ops: float = 0.0, kind: str = "f32") -> float:
    """The least seconds the card could take to move ``nbytes`` and do
    ``ops`` operations of ``kind``: the larger of the two times."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind])


def pool_merge_bytes(B: int, L1: int, L2: int, k: int, flags: bool) -> int:
    """One ``pool_merge`` launch over [B, L1] and [B, L2] lists into a
    [B, k] pool: the keys (f32), the ids (i32) and, where the lists carry
    them, the flags (bool) of both operands read once, and the pool's
    written once."""
    per = 4 + 4 + (1 if flags else 0)
    return B * (L1 + L2) * per + B * k * per
