"""The block hop's estimate stage with the neighbor-block gather inside the
kernel.

    out[b, m*R + r] = sum_d (codes[u[b, m], r, d] - 128) * qs[b, d]
    codes u8 [C, R, Dp], u i32 [B, M] in [0, C), qs bf16 [B, Dp]
    -> f32 [B, M*R]

On CUDA tensors ``gather_diagdot`` launches one of the two hand-written
kernels of ``csrc/gather_diagdot.cu`` (sm_90a, built with nvcc on first
use, see ``_build``), or raises:
  "direct"  a block per (query, popped node) reads the node's code block
            straight from device memory;
  "staged"  a block walks a run of (query, node) pairs through two
            shared-memory stages, the next block's 16-byte ``cp.async``
            copies in flight while it computes.
On CPU tensors it runs the plain PyTorch version ``gather_diagdot_ref``
(``index_select`` + ``block_diagdot_ref``). There is no other route and no
fallback. ``u`` is not checked on the device: the callers clamp it into
[0, C).

Replaces the TPU kernels ``scripts/proto_dma_gather.py:48`` (``kernel`` via
``dma_diagdot``, the direct variant) and ``scripts/proto_dma_gather2.py:48``
(``kernel`` via ``dma2_diagdot``, the staged variant). Both take any B, M,
R and Dp, with byte loads where 16-byte accesses are not possible. The
kernels are bound by memory: at the main-path shape (B 4096, M 8, R 32,
Dp 128) they must move 139.6 MB, ~42 us at 3.35 TB/s on an H100, a third
of what ``index_select`` followed by ``block_diagdot`` moves (see the note
in the source).

``gather_diagdot.calls`` counts calls on any device;
``gather_diagdot.launches`` counts CUDA kernel launches (of either variant)
and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from .diagdot import block_diagdot_ref

_MAX_SMEM = 227 * 1024  # dynamic shared memory one block may use on sm_90
_MAX_GRID_Y = 65535
VARIANTS = ("direct", "staged")


def gather_diagdot_ref(codes: torch.Tensor, u: torch.Tensor,
                       qs: torch.Tensor) -> torch.Tensor:
    """Plain version: gather the popped nodes' blocks into [B, M*R, Dp],
    then the plain decode + dot."""
    B, M = u.shape
    _, R, Dp = codes.shape
    g = codes.index_select(0, u.reshape(-1)).view(B, M * R, Dp)
    return block_diagdot_ref(g, qs)


def _check(codes: torch.Tensor, u: torch.Tensor, qs: torch.Tensor) -> None:
    if codes.dtype != torch.uint8 or codes.dim() != 3:
        raise TypeError(f"codes must be uint8 [C, R, Dp], got {codes.dtype} "
                        f"{tuple(codes.shape)}")
    Dp = codes.shape[2]
    if u.dtype != torch.int32 or u.dim() != 2:
        raise TypeError(f"u must be int32 [B, M], got {u.dtype} "
                        f"{tuple(u.shape)}")
    B = u.shape[0]
    if qs.dtype != torch.bfloat16 or tuple(qs.shape) != (B, Dp):
        raise TypeError(f"qs must be bfloat16 [{B}, {Dp}], got {qs.dtype} "
                        f"{tuple(qs.shape)}")
    if not (codes.device == u.device == qs.device):
        raise ValueError(f"codes on {codes.device}, u on {u.device}, qs on "
                         f"{qs.device}")
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {codes.device}")
    if not (codes.is_contiguous() and u.is_contiguous()
            and qs.is_contiguous()):
        raise ValueError("codes, u and qs must be contiguous")
    if codes.shape[0] == 0 and u.numel():
        raise ValueError("codes holds no node to gather from")


def _staged_fits(R: int, Dp: int) -> bool:
    """Whether two stages of one [R, Dp] block and qs fit a block's shared
    memory."""
    def r16(n):
        return -(-n // 16) * 16
    return r16(Dp * 4) + 2 * r16(R * Dp) <= _MAX_SMEM


def _kernel(variant: str):
    """A C entry point of csrc/gather_diagdot.cu (built and loaded on first
    use)."""
    from ._build import entry

    flags = [ctypes.c_int] * (2 if variant == "staged" else 1)
    return entry("gather_diagdot", f"alaya_gather_diagdot_{variant}",
                 [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 + flags)


def gather_diagdot(codes: torch.Tensor, u: torch.Tensor, qs: torch.Tensor,
                   variant: str = "direct") -> torch.Tensor:
    """out[b, m*R + r] = sum_d (codes[u[b,m], r, d] - 128) * qs[b, d]."""
    from ._build import launch

    _check(codes, u, qs)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    gather_diagdot.calls += 1
    if codes.device.type == "cpu":
        return gather_diagdot_ref(codes, u, qs)
    B, M = u.shape
    _, R, Dp = codes.shape
    out = torch.empty((B, M * R), dtype=torch.float32, device=codes.device)
    if out.numel() == 0:
        return out
    aligned = codes.data_ptr() % 16 == 0
    if variant == "staged":
        if not _staged_fits(R, Dp):
            raise ValueError(f"a [{R}, {Dp}] block exceeds the staged "
                             "kernel's shared memory")
        # 16-byte copies into the stage; 16-byte reads of its rows
        flags = (int(aligned and (R * Dp) % 16 == 0), int(Dp % 16 == 0))
    else:
        if M > _MAX_GRID_Y or Dp * 4 + 16 > _MAX_SMEM:
            raise ValueError(f"M={M}, Dp={Dp} exceed the direct kernel's "
                             "grid or shared memory")
        flags = (int(aligned and Dp % 16 == 0),)
    launch(_kernel(variant), codes.device, codes.data_ptr(), u.data_ptr(),
           qs.data_ptr(), out.data_ptr(), B, M, R, Dp, *flags)
    gather_diagdot.launches += 1
    return out


gather_diagdot.calls = 0
gather_diagdot.launches = 0
