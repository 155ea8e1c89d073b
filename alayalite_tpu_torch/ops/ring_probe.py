"""Row-wise membership test: the stale check of every beam-search hop.

    out[b, k] = any_j (nids[b, k] == seen[b, j])
    nids i32 [B, K], seen i32 [B, S] -> bool [B, K]

``seen`` is what a query has expanded or pooled already (pop ring ‖ pool);
``nids`` the neighbor ids it is about to score. −1 equals −1, as in the
broadcast compare: the callers mask ``nids >= 0`` afterwards.

On a CUDA tensor ``ring_probe`` launches the hand-written kernel
``csrc/ring_probe.cu`` (sm_90a, built with nvcc on first use, see
``_build``), or raises. On a CPU tensor it runs the plain PyTorch version
``ring_probe_ref``. There is no other route and no fallback.

Replaces the TPU kernel ``scripts/proto_pallas_sort2.py:105``
(``ring_probe_kernel``), whose ``[K, BT]`` / ``[RING, BT]`` operands are a
lane layout of the same function. The kernel is bound by memory: at the
search's shape (4096, 256) against (4096, 160) it must move 7.9 MB, ~2.3 us
at 3.35 TB/s on an H100, where the eager compare writes and reduces a
[B, K, S] bool tensor (see the note in the source).

``ring_probe.calls`` counts calls on any device; ``ring_probe.launches``
counts CUDA kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

_MAX_SMEM = 227 * 1024  # dynamic shared memory one block may use on sm_90
_REF_CHUNK = 256        # rows of B per step of the plain version


def ring_probe_ref(nids: torch.Tensor, seen: torch.Tensor) -> torch.Tensor:
    """Plain version: the broadcast compare and ``any``, chunked over B to
    bound the [_REF_CHUNK, K, S] bool temporary."""
    out = torch.empty(nids.shape, dtype=torch.bool, device=nids.device)
    for lo in range(0, nids.shape[0], _REF_CHUNK):
        hi = lo + _REF_CHUNK
        out[lo:hi] = (nids[lo:hi, :, None] == seen[lo:hi, None, :]).any(2)
    return out


def _check(nids: torch.Tensor, seen: torch.Tensor) -> None:
    if nids.dtype != torch.int32 or nids.dim() != 2:
        raise TypeError(f"nids must be int32 [B, K], got {nids.dtype} "
                        f"{tuple(nids.shape)}")
    B = nids.shape[0]
    if seen.dtype != torch.int32 or seen.dim() != 2 or seen.shape[0] != B:
        raise TypeError(f"seen must be int32 [{B}, S], got {seen.dtype} "
                        f"{tuple(seen.shape)}")
    if nids.device != seen.device:
        raise ValueError(f"nids on {nids.device} but seen on {seen.device}")
    if nids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {nids.device}")
    if not (nids.is_contiguous() and seen.is_contiguous()):
        raise ValueError("nids and seen must be contiguous")
    if (seen.shape[1] + 4) * 4 > _MAX_SMEM:
        raise ValueError(f"S={seen.shape[1]} exceeds the kernel's "
                         "shared-memory stage")


def _kernel():
    """The C entry point of csrc/ring_probe.cu (built and loaded on first
    use)."""
    from ._build import entry

    return entry("ring_probe", "alaya_ring_probe",
                 [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                  ctypes.c_int])


def ring_probe(nids: torch.Tensor, seen: torch.Tensor) -> torch.Tensor:
    """out[b, k] = nids[b, k] is among seen[b, :], bool [B, K]."""
    from ._build import launch

    _check(nids, seen)
    ring_probe.calls += 1
    if nids.device.type == "cpu":
        return ring_probe_ref(nids, seen)
    B, K = nids.shape
    S = seen.shape[1]
    if S == 0:
        return torch.zeros((B, K), dtype=torch.bool, device=nids.device)
    out = torch.empty((B, K), dtype=torch.bool, device=nids.device)
    vec = int(S % 4 == 0 and seen.data_ptr() % 16 == 0)
    launch(_kernel(), nids.device, nids.data_ptr(), seen.data_ptr(),
           out.data_ptr(), B, K, S, vec)
    ring_probe.launches += 1
    return out


ring_probe.calls = 0
ring_probe.launches = 0
