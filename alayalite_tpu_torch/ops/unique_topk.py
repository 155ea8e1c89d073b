"""The block search's final selection: the first copy of each id, then the
k best, per row.

    unique_topk(d f32 [B, W], ids i32 [B, W], k, valid bool [C] or None)
    -> (out_d f32 [B, min(k, W)], out_i i32 [B, min(k, W)])

An entry of a row is out where its id is < 0, where
``valid[min(id, C − 1)]`` is False, or where an equal id stands in a lower
column of the row. The ``k`` smallest of the remaining entries come out
ascending by (d, column): among equal distances the lower column first. An
entry that is out reads +inf; ``out_i`` is −1 wherever ``out_d`` is not
finite. −0.0 equals +0.0, a NaN sorts after +inf, and a value comes out
with the bits it went in with, as ``topk_smallest`` orders and returns them.

On a CUDA tensor ``unique_topk`` launches the hand-written kernel of
``csrc/unique_topk.cu`` (sm_90a, built with nvcc on first use, see
``_build``), or raises. On a CPU tensor it runs the plain PyTorch version
``unique_topk_ref``. There is no other route and no fallback.

It replaces no Pallas kernel: the JAX package leaves the same duplicate net
and top k to XLA (``alayalite_tpu/index/search.py:407-420``, the end of
``_block_beam_search``). It was added because that net, three passes over a
[B, W, W] bool tensor, took a third of the 1-bit search's device time at
(4096, 522). The kernel is bound by bytes (~18 MB at (4096, 522, 10), ~5.5 us
at 3.35 TB/s): one warp a row reads it once into shared memory, takes the k
least keys by warp-wide reductions, and compares a winner's id with the
lower columns only where the selection reaches it, so no [W, W] compare is
made (see the note in the source).

``unique_topk.calls`` counts calls on any device; ``unique_topk.launches``
counts CUDA kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .topk import topk_smallest

Tensor = torch.Tensor
MAX_W = 16384     # the widest row whose ids, keys and winners fit a
                  # block's shared memory (csrc/unique_topk.cu)
_REF_CHUNK = 256  # rows of B per step of the plain version's net
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def unique_topk_ref(d: Tensor, ids: Tensor, k: int,
                    valid: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Plain version: the duplicate net (an id equal to one in a lower
    column), chunked over B to bound the [_REF_CHUNK, W, W] bool temporary,
    then ``topk_smallest`` of the masked row."""
    B, W = ids.shape
    ok = ids >= 0
    if valid is not None:
        ok &= valid[ids.clamp(0, valid.shape[0] - 1).long()]
    tril = torch.tril(torch.ones((W, W), dtype=torch.bool,
                                 device=ids.device), -1)
    dup = torch.empty_like(ok)
    for lo in range(0, B, _REF_CHUNK):
        rows = ids[lo:lo + _REF_CHUNK]
        dup[lo:lo + _REF_CHUNK] = ((rows[:, :, None] == rows[:, None, :])
                                   & tril).any(2)
    out_d, sel = topk_smallest(
        torch.where(ok & ~dup, d, torch.full_like(d, float("inf"))), k)
    out_i = torch.gather(ids, 1, sel)
    return out_d, torch.where(torch.isfinite(out_d), out_i,
                              torch.full_like(out_i, -1))


def _check(d: Tensor, ids: Tensor, k: int, valid: Optional[Tensor]) -> None:
    if d.dtype != torch.float32 or d.dim() != 2:
        raise TypeError(f"d must be float32 [B, W], got {d.dtype} "
                        f"{tuple(d.shape)}")
    if ids.dtype != torch.int32 or ids.shape != d.shape:
        raise TypeError(f"ids must be int32 {tuple(d.shape)}, got "
                        f"{ids.dtype} {tuple(ids.shape)}")
    if valid is not None and (valid.dtype != torch.bool or valid.dim() != 1
                              or valid.shape[0] == 0):
        raise TypeError(f"valid must be bool [C], C >= 1, got {valid.dtype} "
                        f"{tuple(valid.shape)}")
    tensors = (d, ids) if valid is None else (d, ids, valid)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("d, ids and valid must share one device")
    if d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {d.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("d, ids and valid must be contiguous")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if d.shape[1] > MAX_W:
        raise ValueError(f"W = {d.shape[1]} exceeds the kernel's {MAX_W}")


def unique_topk(d: Tensor, ids: Tensor, k: int,
                valid: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """The ``min(k, W)`` best entries of each row whose id is live and
    first in its row, ascending: (out_d f32, out_i i32, −1 where out_d is
    not finite)."""
    from ._build import entry, launch

    k = int(k)
    _check(d, ids, k, valid)
    unique_topk.calls += 1
    if d.device.type == "cpu":
        return unique_topk_ref(d, ids, k, valid)
    B, W = d.shape
    k = min(k, W)
    out_d = torch.empty((B, k), dtype=torch.float32, device=d.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=d.device)
    if B == 0 or k == 0:
        return out_d, out_i
    fn = entry("unique_topk", "alaya_unique_topk",
               [_P, _P, _P, _LL, _P, _P, _LL, _I, _I])
    launch(fn, d.device, d.data_ptr(), ids.data_ptr(),
           None if valid is None else valid.data_ptr(),
           0 if valid is None else valid.shape[0], out_d.data_ptr(),
           out_i.data_ptr(), B, W, k)
    unique_topk.launches += 1
    return out_d, out_i


unique_topk.calls = 0
unique_topk.launches = 0
