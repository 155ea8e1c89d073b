"""The flat scan's per-tile selection: each tile's k smallest distances,
merged into the running best.

    tile_topk(d f32 [Q, n], lo, best_d f32 [Q, k], best_i i32 [Q, k], k)
    -> (best_d, best_i), updated in place: the k smallest of
       best ∪ {(d[q, j], lo + j)}, ascending by (distance, then an entry of
       the running best before one of the tile, then the lower column)

``best_i`` is −1 wherever ``best_d`` is not finite. −0.0 equals +0.0, a NaN
sorts after +inf, and a value comes out with the bits it went in with, as a
stable ``torch.sort`` orders and returns them. The running best has to be
ascending on entry (``_exact_topk_device`` starts it at inf / −1). Since
the tiles come in the order of their rows, the rule among equal distances
is the lower id first, that of the JAX package's ``lax.top_k``.

Routes, chosen by ``k`` alone (``tile_topk_route``):
  "kernel"  ``k`` ≤ ``MAX_K``: on a CUDA tensor one launch of the
            hand-written kernel of ``csrc/tile_topk.cu`` (sm_90a, built with
            nvcc on first use, see ``_build``), or it raises;
  "wide"    past it: ``select_smallest`` and ``merge_topk``
            (``pool_merge``'s kernel), where the rows ``torch.topk`` keeps of
            several that tie at a tile's k-th place are its choice.
On a CPU tensor both run the plain PyTorch version ``tile_topk_ref``.

``MAX_K`` = 256. The callers of ``ops/distance._exact_topk_device`` pass
``k`` = the search's top k (the flat index's exact mode, ``exact_topk``,
``calc_gt``, the sharded slab's scan), 1 (``find_medoid``), the kNN graph's
width + 1 (``exact_knn``: 33 at the fits' 32, at most r / 2 + 1 in the
hnsw overlay), the flat index's fast coarse ``max(32, 4 · topk)`` (40 at
top 10) and ``calc_gt``'s fast coarse ``max(256, 16 · topk)``, the largest:
256 takes every one of them up to top 16, exact scans up to top 256 and
the flat index's fast scans up to top 64.

It replaces no Pallas kernel: the JAX package leaves the per-tile top k and
the merge to XLA (``lax.top_k`` twice in ``_exact_topk_device`` of
``alayalite_tpu/ops/distance.py``). It was added because ``torch.topk``'s
radix select, the sorts and gathers of its unordered result and the merge
with the running best took 62% of the exact flat scan's device time. The
kernel is bound by memory: it reads the tile once (see the note in the
source).

``tile_topk.calls`` counts calls on any device; ``tile_topk.launches``
counts the kernel's launches and nothing else; ``tile_topk.route_calls``
counts the CUDA calls by route (a "wide" call launches other wrappers'
kernels, none of this one).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .pool_sort import merge_kv_ref
from .topk import merge_topk, select_smallest

Tensor = torch.Tensor
MAX_K = 256        # the kernel's widest running best: 8 slots of 32 lanes
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _first_k(d: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """(values, columns) of the first ``k`` entries of a stable ascending
    sort of each row, without sorting the row: ``torch.topk`` gives the
    k-th value, every entry below it is in, and of the entries equal to it
    the lower columns fill the rest. NaN counts as equal to NaN and above
    +inf, as the sort has it."""
    kth = torch.topk(d, k, dim=1, largest=False).values[:, k - 1:k]
    nan_k, nan_d = torch.isnan(kth), torch.isnan(d)
    less = (d < kth) | (nan_k & ~nan_d)
    tie = (d == kth) | (nan_k & nan_d)
    need = k - less.sum(1, keepdim=True)
    take = less | (tie & (torch.cumsum(tie, 1) <= need))
    cols = take.nonzero()[:, 1].view(-1, k)
    vals, order = torch.sort(torch.gather(d, 1, cols), dim=1, stable=True)
    return vals, torch.gather(cols, 1, order)


def tile_topk_ref(d: Tensor, lo: int, best_d: Tensor, best_i: Tensor,
                  k: int) -> Tuple[Tensor, Tensor]:
    """Plain version, new tensors: the first ``min(k, n)`` of a stable sort
    of each tile row (lower column first), merged after the running best
    by ``merge_kv_ref``. The first k are found without sorting the row
    (``_first_k``), so a scan on the CPU sorts no list wider than the
    [Q, 2k] merge; the tests hold it to the stable sort itself."""
    n = d.shape[1]
    if n == 0:
        out_d, out_i = best_d.clone(), best_i.clone()
    else:
        vals, cols = _first_k(d, min(k, n))
        out_d, out_i = merge_kv_ref(best_d, best_i, vals,
                                    cols.to(torch.int32) + lo, k)
    return out_d, torch.where(torch.isfinite(out_d), out_i,
                              torch.full_like(out_i, -1))


def tile_topk_route(k: int) -> str:
    """The route ``tile_topk`` takes on a CUDA tensor for a given ``k``."""
    return "kernel" if k <= MAX_K else "wide"


def _check(d: Tensor, lo: int, best_d: Tensor, best_i: Tensor,
           k: int) -> None:
    if d.dtype != torch.float32 or d.dim() != 2:
        raise TypeError(f"d must be float32 [Q, n], got {d.dtype} "
                        f"{tuple(d.shape)}")
    Q = d.shape[0]
    if best_d.dtype != torch.float32 or tuple(best_d.shape) != (Q, k):
        raise TypeError(f"best_d must be float32 {(Q, k)}, got "
                        f"{best_d.dtype} {tuple(best_d.shape)}")
    if best_i.dtype != torch.int32 or tuple(best_i.shape) != (Q, k):
        raise TypeError(f"best_i must be int32 {(Q, k)}, got "
                        f"{best_i.dtype} {tuple(best_i.shape)}")
    if len({t.device for t in (d, best_d, best_i)}) != 1:
        raise ValueError("d, best_d and best_i must share one device")
    if d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {d.device}")
    if not all(t.is_contiguous() for t in (d, best_d, best_i)):
        raise ValueError("d, best_d and best_i must be contiguous")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if lo < 0 or lo + d.shape[1] > 2**31:
        raise ValueError(f"ids {lo} .. {lo + d.shape[1] - 1} do not fit int32")


def tile_topk(d: Tensor, lo: int, best_d: Tensor, best_i: Tensor,
              k: int) -> Tuple[Tensor, Tensor]:
    """Merge the tile ``d`` (its column j is id ``lo + j``) into the
    running best, in place; returns (best_d, best_i)."""
    from ._build import entry, launch

    k, lo = int(k), int(lo)
    _check(d, lo, best_d, best_i, k)
    tile_topk.calls += 1
    if d.device.type == "cpu":
        out_d, out_i = tile_topk_ref(d, lo, best_d, best_i, k)
        return best_d.copy_(out_d), best_i.copy_(out_i)
    Q, n = d.shape
    route = tile_topk_route(k)
    tile_topk.route_calls[route] += 1
    if route == "wide":
        d_t, sel = select_smallest(d, min(k, n))
        out_d, out_i = merge_topk(best_d, best_i, d_t,
                                  sel.to(torch.int32) + lo, k)
        best_i.copy_(torch.where(torch.isfinite(out_d), out_i,
                                 torch.full_like(out_i, -1)))
        return best_d.copy_(out_d), best_i
    if Q:
        fn = entry("tile_topk", "alaya_tile_topk",
                   [_P, _LL, _I, _I, _P, _P, _I])
        launch(fn, d.device, d.data_ptr(), Q, n, lo, best_d.data_ptr(),
               best_i.data_ptr(), k)
        tile_topk.launches += 1
    return best_d, best_i


tile_topk.calls = 0
tile_topk.launches = 0
tile_topk.route_calls = {"kernel": 0, "wide": 0}
