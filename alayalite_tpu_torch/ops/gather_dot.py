"""The exact re-scoring: f32 rows read by id and their distances to the
queries, in one kernel.

    gather_dot(data f32 [C, D], ids i32 | i64 [B, K], q f32 [B, D],
               q_sq f32 [B] | None, x_sq f32 [C] | None) -> f32 [B, K]
      dot[b, k] = sum_d data[clamp(ids[b, k], 0, C - 1), d] * q[b, d]
      L2 (q_sq and x_sq given): max((q_sq[b] + x_sq[id]) - 2 * dot, 0)
      IP (neither given): dot (the caller negates)

On CUDA tensors it launches the hand-written kernel of
``csrc/gather_dot.cu`` (sm_90a, built with nvcc on first use, see
``_build``), or raises. On CPU tensors it runs the plain PyTorch version
``gather_dot_ref``: ``index_select`` + ``row_dots`` + the spaces' epilogue,
what every f32 space's ``gather_dists`` computed before the kernel. There
is no other route and no fallback.

It replaces no Pallas kernel: the JAX package leaves the gather and the
product to XLA. It was added because on the card the same work was three
PyTorch kernels over a gathered [B*K, D] copy (the gather, ``row_dots``'
product and its sum), a quarter of the 1-bit search's device time. The
kernel is bound by memory (2 flops a 4-byte word read): a row is the unit
of work, the lanes that share a query keep their slice of it in
registers, and each thread starts 8 16-byte row loads before its first
multiply-add (see the note in the source). The order of the f32 sums
depends on D alone, so a (query, row) pair gets the same bits whatever
the batch, K and the pair's place in it. Products and sums are rounded
apart (no FMA), and at D = 128 the sums run in the order of PyTorch's
CUDA sum over the last axis, so there the kernel gives the bits of the
plain version on the card: a fit or a search reads what it read before
the kernel. The epilogue runs in the order above, as the plain
version's PyTorch ops do.

``gather_dot.calls`` counts calls on any device, ``gather_dot.launches``
CUDA kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .distance import row_dots

Tensor = torch.Tensor
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def gather_dot_ref(data: Tensor, ids: Tensor, q: Tensor,
                   q_sq: Optional[Tensor] = None,
                   x_sq: Optional[Tensor] = None) -> Tensor:
    """Plain version: gather the rows into [B, K, D], ``row_dots``, then
    the L2 epilogue where ``q_sq`` and ``x_sq`` are given."""
    (B, K), (C, D) = ids.shape, data.shape
    safe = ids.clamp(0, C - 1).reshape(-1)
    dot = row_dots(data.index_select(0, safe).view(B, K, D), q)
    if x_sq is None:
        return dot
    return torch.clamp(
        q_sq[:, None] + x_sq.index_select(0, safe).view(B, K) - 2.0 * dot,
        min=0.0)


def _check(data: Tensor, ids: Tensor, q: Tensor, q_sq: Optional[Tensor],
           x_sq: Optional[Tensor]) -> None:
    if data.dtype != torch.float32 or data.dim() != 2:
        raise TypeError(f"data must be float32 [C, D], got {data.dtype} "
                        f"{tuple(data.shape)}")
    C, D = data.shape
    if ids.dtype not in (torch.int32, torch.int64) or ids.dim() != 2:
        raise TypeError(f"ids must be int32 or int64 [B, K], got "
                        f"{ids.dtype} {tuple(ids.shape)}")
    B = ids.shape[0]
    if q.dtype != torch.float32 or tuple(q.shape) != (B, D):
        raise TypeError(f"q must be float32 [{B}, {D}], got {q.dtype} "
                        f"{tuple(q.shape)}")
    if (q_sq is None) != (x_sq is None):
        raise ValueError("q_sq and x_sq go together (L2) or not at all (IP)")
    tensors = [data, ids, q]
    if x_sq is not None:
        for name, t, n in (("q_sq", q_sq, B), ("x_sq", x_sq, C)):
            if t.dtype != torch.float32 or tuple(t.shape) != (n,):
                raise TypeError(f"{name} must be float32 [{n}], got "
                                f"{t.dtype} {tuple(t.shape)}")
        tensors += [q_sq, x_sq]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("data, ids, q, q_sq and x_sq must share one device")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("data, ids, q, q_sq and x_sq must be contiguous")
    if C == 0 and ids.numel():
        raise ValueError("data holds no row to gather from")


def gather_dot(data: Tensor, ids: Tensor, q: Tensor,
               q_sq: Optional[Tensor] = None,
               x_sq: Optional[Tensor] = None) -> Tensor:
    """f32 [B, K]: the dots of q[b] with the rows ``ids[b]`` (clamped into
    [0, C)), or their clamped squared L2 distances where ``q_sq`` and
    ``x_sq`` are given."""
    from ._build import entry, launch

    _check(data, ids, q, q_sq, x_sq)
    gather_dot.calls += 1
    if data.device.type == "cpu":
        return gather_dot_ref(data, ids, q, q_sq, x_sq)
    (B, K), (C, D) = ids.shape, data.shape
    out = torch.empty((B, K), dtype=torch.float32, device=data.device)
    if out.numel() == 0:
        return out
    vec = D % 4 == 0 and data.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0
    fn = entry("gather_dot", "alaya_gather_dot",
               [_P, _P, _I, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _I])
    launch(fn, data.device, data.data_ptr(), ids.data_ptr(),
           int(ids.dtype == torch.int64), q.data_ptr(),
           None if q_sq is None else q_sq.data_ptr(),
           None if x_sq is None else x_sq.data_ptr(), out.data_ptr(), C, B,
           K, D, int(vec))
    gather_dot.launches += 1
    return out


gather_dot.calls = 0
gather_dot.launches = 0
