"""Sort and merge of a beam search's candidate pool: the hop's merge.

    sort_kv(keys, payload)        each list ascending by its f32 key, an i32
                                  payload (and the source positions) carried
                                  along; lists along rows [B, K] or columns
                                  [K, B]
    pool_merge(d1, i1, f1, d2, i2, f2, k, dedup)
                                  the first k of the sorted concatenation of
                                  two (distance, id, flag) sets, unsorted or
                                  not; with ``dedup`` the later of two
                                  adjacent equal entries becomes
                                  (inf, −1, True)
    roll_n(x, n)                  n circular shifts by 1 + (j mod 7) along
                                  the rows, one after the other

The order is that of a stable sort by key: among equal keys the earlier
position of the input comes first (for the two-operand functions: the first
operand first). −0.0 equals +0.0; a NaN key sorts after +inf, as in
``torch.sort``. Keys and payloads come out bit for bit as they went in.

On a CUDA tensor each function launches its hand-written kernel in
``csrc/pool_sort.cu`` (``roll_n``: ``csrc/roll_n.cu``; sm_90a, built with nvcc
on first use, see ``_build``), or raises. On a CPU tensor it runs the plain PyTorch version beside it
(``*_ref``: ``torch.sort(stable=True)`` and a gather, ``torch.roll``). There
is no other route and no fallback.

Replaces the TPU kernels ``scripts/proto_pallas_sort.py:111`` and ``:117``
(``sort_kernel``, ``merge_kernel``), ``scripts/proto_pallas_sort2.py:81``,
``:87``, ``:92`` (the sort along columns, and without payload along columns
and rows) and ``scripts/opt_hop2.py:120`` (``roll_kernel_n``). The kernels
are bound by memory on paper (a [4096, 64 + 256] merge moves 6.6 MB).
``pool_merge`` and ``sort_kv`` (lists along rows) keep each list in one
warp's registers and exchange words by shuffles, up to ``WARP_LIST`` words a
list, and sort longer ones (and ``sort_kv`` lists along columns) in shared
memory; ``roll_n`` exchanges by shuffles where a row is 32·W words (W ≤ 16)
and in shared memory elsewhere; see the notes in the sources.

Each function counts its calls on any device (``.calls``) and its CUDA kernel
launches and nothing else (``.launches``); ``sort_kv.route_launches``,
``pool_merge.route_launches`` and ``roll_n.route_launches`` split their
launches by kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor
MAX_LIST = 16384   # power-of-two stage of 8-byte words in 227 KB shared memory
WARP_LIST = 512    # pool_merge and sort_kv keep a list in one warp's registers
                   # up to here
WARP_ROLL = 512    # roll_n keeps a row of 32·W words in registers up to here
_SRC = "pool_sort"


# ---------------------------------------------------------------- plain versions
def sort_kv_ref(keys: Tensor, payload: Optional[Tensor] = None,
                k: Optional[int] = None, axis: int = 1,
                return_index: bool = False):
    sk, order = torch.sort(keys, dim=axis, stable=True)
    k = keys.shape[axis] if k is None else k
    sk, order = sk.narrow(axis, 0, k), order.narrow(axis, 0, k)
    sp = None if payload is None else torch.gather(payload, axis, order)
    out = (sk.contiguous(), sp)
    return (*out, order.contiguous()) if return_index else out


def merge_kv_ref(ka: Tensor, pa: Tensor, kb: Tensor, pb: Tensor,
                 k: int) -> Tuple[Tensor, Tensor]:
    """The first ``k`` (keys, payloads) of the stable sort of each row of
    [ka ‖ kb]: the plain merge of ``pool_merge_ref`` and
    ``tile_topk_ref``."""
    cat_d = torch.cat([ka, kb], dim=-1)
    pay = torch.cat([pa, pb], dim=-1)
    sd, order = torch.sort(cat_d, dim=-1, stable=True)
    order = order[..., :k]
    return sd[..., :k].contiguous(), torch.gather(pay, -1, order)


def _pack(i: Tensor, f: Optional[Tensor]) -> Tensor:
    return i if f is None else i * 2 + f.to(torch.int32)


def pool_merge_ref(d1, i1, f1, d2, i2, f2, k: int, dedup: bool = False):
    """Ids and flags ride one int32 payload ``id*2 + flag`` (exact for every
    id ≥ −1: the arithmetic shift restores the sign) through one stable
    sort of the concatenated row."""
    sd, sp = merge_kv_ref(d1, _pack(i1, f1), d2, _pack(i2, f2), k)
    if f1 is None:
        return sd, sp, None
    if not dedup:
        return sd, sp >> 1, (sp & 1) == 1
    prev = torch.cat([torch.full_like(sp[..., :1], -3), sp[..., :-1]], dim=-1)
    dup = (sp == prev) & (sp >= 0) & torch.isfinite(sd)
    sd = torch.where(dup, torch.full_like(sd, float("inf")), sd)
    ids = torch.where(dup, torch.full_like(sp, -1), sp >> 1)
    return sd, ids, ((sp & 1) == 1) | dup


def roll_n_ref(x: Tensor, n: int) -> Tensor:
    for j in range(n):
        x = torch.roll(x, 1 + j % 7, dims=1)
    return x


# ------------------------------------------------------------------- checks
def _check_2d(name: str, t: Tensor, dtype, like: Optional[Tensor] = None,
              same_shape: bool = False) -> None:
    if t.dtype != dtype or t.dim() != 2:
        raise TypeError(f"{name} must be {dtype} and 2-D, got {t.dtype} "
                        f"{tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if like is None:
        return
    if t.device != like.device:
        raise ValueError(f"{name} on {t.device} but the keys on {like.device}")
    if t.shape[0] != like.shape[0] or (same_shape and t.shape != like.shape):
        raise TypeError(f"{name} {tuple(t.shape)} does not match the keys "
                        f"{tuple(like.shape)}")


def _check_width(width: int) -> None:
    if width > MAX_LIST:
        raise ValueError(f"a list of {width} entries exceeds the kernel's "
                         f"shared-memory stage ({MAX_LIST})")


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def pool_merge_route(L1: int, L2: int, k: int) -> str:
    """The kernel ``pool_merge`` launches for a shape: "warp" (each list in
    one warp's registers, sorted apart and merged) where both lists and
    ``k`` pad to at most ``WARP_LIST`` words, else "network" (the padded
    concatenation sorted in shared memory by a block)."""
    return ("warp" if max(_pow2(L1), _pow2(L2), _pow2(k)) <= WARP_LIST
            else "network")


def sort_kv_route(K: int, axis: int = 1) -> str:
    """The kernel ``sort_kv`` launches for lists of ``K`` keys along
    ``axis``: "warp" (a list in one warp's registers) for lists along rows
    of at most ``WARP_LIST`` keys, else "network" (a list in shared memory,
    sorted by a block)."""
    return "warp" if axis == 1 and 0 < K <= WARP_LIST else "network"


def roll_n_route(K: int) -> str:
    """The kernel ``roll_n`` launches for rows of ``K`` words: "warp" (a row
    in one warp's registers, shifted by shuffles) where K is a multiple of
    32 up to ``WARP_ROLL``, else "shared" (a row in shared memory)."""
    return "warp" if K % 32 == 0 and 0 < K <= WARP_ROLL else "shared"


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def _entry(symbol: str, argtypes: list, src: str = _SRC):
    from ._build import entry

    return entry(src, symbol, argtypes)


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


# ----------------------------------------------------------------- wrappers
def sort_kv_on(route: str, keys: Tensor, payload: Optional[Tensor], k: int,
               axis: int = 1, return_index: bool = False,
               counted: bool = True):
    """The CUDA kernel of ``route`` ("warp" or "network") on checked
    operands: ``sort_kv``'s launch, and the way to hold one kernel against
    the other at the same shape. A launch adds one to ``sort_kv.launches``
    and to its route's count unless ``counted`` is off, as it is for a
    comparison that is not part of a path. Returns
    (keys, payload or None, positions or None)."""
    from ._build import launch

    if route not in sort_kv.route_launches:
        raise ValueError(f"unknown sort_kv route {route!r}")
    K = keys.shape[axis]
    B = keys.shape[1 - axis]
    if route == "warp" and sort_kv_route(K, axis) != "warp":
        raise ValueError(f"the warp kernel takes lists along rows of at "
                         f"most {WARP_LIST} keys, not {K} along axis {axis}")
    shape = (B, k) if axis == 1 else (k, B)
    dev = keys.device
    ok = torch.empty(shape, dtype=torch.float32, device=dev)
    op = (None if payload is None
          else torch.empty(shape, dtype=torch.int32, device=dev))
    oi = (torch.empty(shape, dtype=torch.int64, device=dev)
          if return_index else None)
    if not (B and k):
        return ok, op, oi
    if route == "warp":
        vec = K % 4 == 0 and keys.data_ptr() % 16 == 0
        launch(_entry("alaya_sort_kv_warp", [_P, _P, _P, _P, _P, _LL, _I,
                                             _I, _I]),
               dev, keys.data_ptr(), _ptr(payload), ok.data_ptr(), _ptr(op),
               _ptr(oi), B, K, k, int(vec))
    else:
        # (list stride, item stride) of the input and of the output
        ls, is_, ols, ois = (K, 1, k, 1) if axis == 1 else (1, B, 1, B)
        launch(_entry("alaya_sort_kv", [_P, _P, _P, _P, _P, _LL, _I, _I,
                                        _LL, _LL, _LL, _LL]),
               dev, keys.data_ptr(), _ptr(payload), ok.data_ptr(), _ptr(op),
               _ptr(oi), B, K, k, ls, is_, ols, ois)
    if counted:
        sort_kv.launches += 1
        sort_kv.route_launches[route] += 1
    return ok, op, oi


def sort_kv(keys: Tensor, payload: Optional[Tensor] = None,
            k: Optional[int] = None, axis: int = 1,
            return_index: bool = False):
    """(sorted keys, sorted payload or None[, positions int64]) of the first
    ``k`` entries of every list; ``axis`` 1: lists are the rows of
    ``keys`` [B, K]; 0: its columns [K, B]. On the card the layout and the
    width pick the kernel (``sort_kv_route``); both return the same bits."""
    _check_2d("keys", keys, torch.float32)
    if payload is not None:
        _check_2d("payload", payload, torch.int32, keys, same_shape=True)
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    K = keys.shape[axis]
    B = keys.shape[1 - axis]
    k = K if k is None else int(k)
    if not 0 <= k <= K:
        raise ValueError(f"k={k} outside [0, {K}]")
    _check_width(K)
    sort_kv.calls += 1
    if keys.device.type == "cpu":
        return sort_kv_ref(keys, payload, k, axis, return_index)
    ok, op, oi = sort_kv_on(sort_kv_route(K, axis), keys, payload, k, axis,
                            return_index)
    return (ok, op, oi) if return_index else (ok, op)


def pool_merge(d1: Tensor, i1: Tensor, f1: Optional[Tensor], d2: Tensor,
               i2: Tensor, f2: Optional[Tensor], k: int,
               dedup: bool = False):
    """(distances [B, k], ids [B, k], flags [B, k] bool or None): the
    smallest ``k`` of [d1 ‖ d2] ascending with their ids and flags, first
    operand first among ties. ``f1`` and ``f2`` are both bool tensors or both
    None (then no flags come back and ``dedup`` must be off). On the card
    the shape picks the kernel (``pool_merge_route``); both return the same
    bits."""
    from ._build import launch

    _check_2d("d1", d1, torch.float32)
    _check_2d("i1", i1, torch.int32, d1, same_shape=True)
    _check_2d("d2", d2, torch.float32, d1)
    _check_2d("i2", i2, torch.int32, d2, same_shape=True)
    if (f1 is None) != (f2 is None):
        raise TypeError("f1 and f2 must both be given or both be None")
    if f1 is not None:
        _check_2d("f1", f1, torch.bool, d1, same_shape=True)
        _check_2d("f2", f2, torch.bool, d2, same_shape=True)
    elif dedup:
        raise ValueError("dedup needs the flags")
    B, L1 = d1.shape
    L2 = d2.shape[1]
    k = min(int(k), L1 + L2)
    if k < 0:
        raise ValueError(f"k={k} is negative")
    _check_width(L1 + L2)
    pool_merge.calls += 1
    if d1.device.type == "cpu":
        return pool_merge_ref(d1, i1, f1, d2, i2, f2, k, dedup)
    dev = d1.device
    od = torch.empty((B, k), dtype=torch.float32, device=dev)
    oi = torch.empty((B, k), dtype=torch.int32, device=dev)
    of = (None if f1 is None
          else torch.empty((B, k), dtype=torch.bool, device=dev))
    if B and k:
        route = pool_merge_route(L1, L2, k)
        symbol = ("alaya_pool_merge_warp" if route == "warp"
                  else "alaya_pool_merge")
        launch(_entry(symbol, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I,
                               _I, _I, _I]),
               dev, d1.data_ptr(), i1.data_ptr(), _ptr(f1), d2.data_ptr(),
               i2.data_ptr(), _ptr(f2), od.data_ptr(), oi.data_ptr(),
               _ptr(of), B, L1, L2, k, int(bool(dedup)))
        pool_merge.launches += 1
        pool_merge.route_launches[route] += 1
    return od, oi, of


def roll_n(x: Tensor, n: int) -> Tensor:
    """``x`` [B, K] f32 after ``n`` circular shifts along the rows, the j-th
    by 1 + (j mod 7), done one by one: time / n / B is the card's cost of one
    exchange step of the sort. On the card the width picks the kernel
    (``roll_n_route``); both return the same bits."""
    from ._build import launch

    _check_2d("x", x, torch.float32)
    n = int(n)
    if n < 0:
        raise ValueError(f"n={n} is negative")
    _check_width(x.shape[1])
    roll_n.calls += 1
    if x.device.type == "cpu":
        return roll_n_ref(x, n)
    out = torch.empty_like(x)
    B, K = x.shape
    if B and K:
        route = roll_n_route(K)
        launch(_entry(f"alaya_roll_n_{route}", [_P, _P, _LL, _I, _I],
                      "roll_n"), x.device, x.data_ptr(), out.data_ptr(), B,
               K, n)
        roll_n.launches += 1
        roll_n.route_launches[route] += 1
    return out


for _fn in (sort_kv, pool_merge, roll_n):
    _fn.calls = 0
    _fn.launches = 0
pool_merge.route_launches = {"warp": 0, "network": 0}
sort_kv.route_launches = {"warp": 0, "network": 0}
roll_n.route_launches = {"warp": 0, "shared": 0}
