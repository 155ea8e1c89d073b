"""Row-wise membership test: the stale check of every beam-search hop.

    out[b, k] = nids[b, k] is among seen[b, :] or among seen2[b, :]
    nids i32 [B, K], seen i32 [B, S], seen2 i32 [B, S2] or None -> bool [B, K]

``seen`` (and ``seen2``) is what a query has expanded or pooled already: the
block hop passes its pop ring and its pool as two operands, so it does not
concatenate them before every call; the raw hop passes its pop ring alone.
``nids`` are the neighbor ids it is about to score. −1 equals −1, as in
the broadcast compare: the callers mask ``nids >= 0`` afterwards. Every
int32 is an id, ``INT_MIN`` and ``INT_MAX`` too.

On a CUDA tensor ``ring_probe`` launches a hand-written kernel of
``csrc/ring_probe.cu`` (sm_90a, built with nvcc on first use, see
``_build``), or raises. The seen width picks the kernel
(``ring_probe_route``): "hash", a table per query in shared memory (one
warp builds it from both seen rows and probes it, O(K + S) a query), up to
``HASH_SEEN`` seen ids; "scan", both rows staged in shared memory and every
id compared with every entry (O(K·S)), past it. Both return the same bits.
On a CPU tensor it runs the plain PyTorch version ``ring_probe_ref``. There
is no other route and no fallback.

Replaces the TPU kernel ``scripts/proto_pallas_sort2.py:105``
(``ring_probe_kernel``), whose ``[K, BT]`` / ``[RING, BT]`` operands are a
lane layout of the same function. The kernel is bound by memory: at the
search's shape (4096, 256) against 96 + 64 seen ids it must move 7.9 MB,
~2.4 us at 3.35 TB/s on an H100, where the eager compare writes and reduces
a [B, K, S] bool tensor (see the note in the source).

``ring_probe.calls`` counts calls on any device; ``ring_probe.launches``
counts CUDA kernel launches and nothing else, ``ring_probe.route_launches``
splits them by kernel. Both are counted in ``ring_probe_on``, where the
kernel is launched.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

Tensor = torch.Tensor
HASH_SEEN = 2048        # the hash kernel's widest S + S2 (4096 slots a warp)
_MAX_SMEM = 227 * 1024  # dynamic shared memory one block may use on sm_90
_REF_CHUNK = 256        # rows of B per step of the plain version
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def ring_probe_ref(nids: Tensor, seen: Tensor,
                   seen2: Optional[Tensor] = None) -> Tensor:
    """Plain version: the broadcast compare against the concatenated seen
    rows and ``any``, chunked over B to bound the [_REF_CHUNK, K, S + S2]
    bool temporary."""
    if seen2 is not None:
        seen = torch.cat([seen, seen2], dim=1)
    out = torch.empty(nids.shape, dtype=torch.bool, device=nids.device)
    for lo in range(0, nids.shape[0], _REF_CHUNK):
        hi = lo + _REF_CHUNK
        out[lo:hi] = (nids[lo:hi, :, None] == seen[lo:hi, None, :]).any(2)
    return out


def ring_probe_route(S: int, S2: int = 0) -> str:
    """The kernel ``ring_probe`` launches for ``S`` + ``S2`` seen ids a
    query: "hash" up to ``HASH_SEEN``, else "scan"."""
    return "hash" if S + S2 <= HASH_SEEN else "scan"


def _check(nids: Tensor, seen: Tensor, seen2: Optional[Tensor]) -> None:
    if nids.dtype != torch.int32 or nids.dim() != 2:
        raise TypeError(f"nids must be int32 [B, K], got {nids.dtype} "
                        f"{tuple(nids.shape)}")
    B = nids.shape[0]
    for name, t in (("seen", seen), ("seen2", seen2)):
        if t is None:
            continue
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != B:
            raise TypeError(f"{name} must be int32 [{B}, S], got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.device != nids.device:
            raise ValueError(f"nids on {nids.device} but {name} on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {nids.device}")
    if not nids.is_contiguous():
        raise ValueError("nids must be contiguous")
    width = seen.shape[1] + (0 if seen2 is None else seen2.shape[1])
    if (width + 4) * 4 > _MAX_SMEM:
        raise ValueError(f"S + S2 = {width} exceeds the scan kernel's "
                         "shared-memory stage")


def _aligned(t: Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def ring_probe_on(route: str, nids: Tensor, seen: Tensor,
                  seen2: Optional[Tensor] = None,
                  counted: bool = True) -> Tensor:
    """The CUDA kernel of ``route`` ("hash" or "scan") on checked operands:
    ``ring_probe``'s launch, and the way to hold one kernel against the
    other at the same shape. A launch adds one to ``ring_probe.launches``
    and to its route's count unless ``counted`` is off, as it is for a
    comparison that is not part of a path."""
    from ._build import entry, launch

    if route not in ring_probe.route_launches:
        raise ValueError(f"unknown ring_probe route {route!r}")
    B, K = nids.shape
    S = seen.shape[1]
    S2 = 0 if seen2 is None else seen2.shape[1]
    if S + S2 == 0 or B * K == 0:
        return torch.zeros((B, K), dtype=torch.bool, device=nids.device)
    if route == "hash" and S + S2 > HASH_SEEN:
        raise ValueError(f"S + S2 = {S + S2} exceeds the hash kernel's "
                         f"{HASH_SEEN}")
    out = torch.empty((B, K), dtype=torch.bool, device=nids.device)
    p2 = None if seen2 is None else seen2.data_ptr()
    if route == "hash":
        fn = entry("ring_probe", "alaya_ring_probe_hash",
                   [_P, _P, _P, _P, _LL, _I, _I, _I, _I])
        launch(fn, nids.device, nids.data_ptr(), seen.data_ptr(), p2,
               out.data_ptr(), B, K, S, S2,
               int(K % 4 == 0 and _aligned(nids)))
    else:
        vec = S % 4 == 0 and _aligned(seen)
        vec2 = vec and seen2 is not None and S2 % 4 == 0 and _aligned(seen2)
        fn = entry("ring_probe", "alaya_ring_probe",
                   [_P, _P, _P, _P, _LL, _LL, _LL, _LL, _I, _I])
        launch(fn, nids.device, nids.data_ptr(), seen.data_ptr(), p2,
               out.data_ptr(), B, K, S, S2, int(vec), int(vec2))
    if counted:
        ring_probe.launches += 1
        ring_probe.route_launches[route] += 1
    return out


def ring_probe(nids: Tensor, seen: Tensor,
               seen2: Optional[Tensor] = None) -> Tensor:
    """out[b, k] = nids[b, k] is among seen[b, :] ∪ seen2[b, :], bool
    [B, K]."""
    _check(nids, seen, seen2)
    ring_probe.calls += 1
    if nids.device.type == "cpu":
        return ring_probe_ref(nids, seen, seen2)
    S2 = 0 if seen2 is None else seen2.shape[1]
    return ring_probe_on(ring_probe_route(seen.shape[1], S2), nids, seen,
                         seen2)


ring_probe.calls = 0
ring_probe.launches = 0
ring_probe.route_launches = {"hash": 0, "scan": 0}
