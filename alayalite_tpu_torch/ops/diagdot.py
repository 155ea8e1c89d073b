"""Fused u8 decode + per-query dot over code blocks already gathered
(``BQGSpace.estimate_for``); on the hop itself ``gather_estimate``
(``ops/gather_diagdot.py``) reads the blocks inside the kernel.

    dot[b, k] = sum_d (codes[b, k, d] - 128) * qs[b, d]
    codes u8 [B, K, Dp], qs bf16 [B, Dp] -> f32 [B, K]

On a CUDA tensor ``block_diagdot`` launches the hand-written kernel, the
entry ``alaya_block_diagdot`` of ``csrc/gather_diagdot.cu``: the rows kernel
of ``gather_diagdot`` with the identity gather (node b, one block a query),
so no index is read (sm_90a, built with nvcc on first use, see ``_build``),
or raises. On a CPU tensor it runs the plain PyTorch version
``block_diagdot_ref``. There is no other route and no fallback.

Replaces the TPU kernel ``alayalite_tpu/ops/pallas_block.py:46``
(``_diagdot_kernel`` via ``_diagdot_call``/``block_diagdot``). Unlike that
wrapper, which takes the kernel only for D % 128 == 0, B % 32 == 0 and
K % 8 == 0, this one takes any B, K and Dp (byte loads where Dp % 16 != 0
or ``codes`` or ``qs`` is not 16-byte aligned). The kernel is bound by
memory: at the main-path shape (4096, 256, 128) it must move ~139.5 MB,
~42 us at 3.35 TB/s on an H100 (see the note in the source).

``block_diagdot.calls`` counts calls on any device;
``block_diagdot.launches`` counts CUDA kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

_REF_CHUNK = 256        # rows of B per step of the plain version


def block_diagdot_ref(codes: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """Plain version: decode to bf16, then f32 multiply and sum (chunked
    over B to bound the [_REF_CHUNK, K, Dp] f32 temporary)."""
    B, K, _ = codes.shape
    q = qs.float()
    out = torch.empty((B, K), dtype=torch.float32, device=codes.device)
    for lo in range(0, B, _REF_CHUNK):
        hi = lo + _REF_CHUNK
        cf = (codes[lo:hi].to(torch.int16) - 128).to(torch.bfloat16).float()
        out[lo:hi] = (cf * q[lo:hi, None, :]).sum(-1)
    return out


def _check(codes: torch.Tensor, qs: torch.Tensor) -> None:
    if codes.dtype != torch.uint8 or codes.dim() != 3:
        raise TypeError(f"codes must be uint8 [B, K, Dp], got {codes.dtype} "
                        f"{tuple(codes.shape)}")
    B, _, Dp = codes.shape
    if qs.dtype != torch.bfloat16 or tuple(qs.shape) != (B, Dp):
        raise TypeError(f"qs must be bfloat16 [{B}, {Dp}], got {qs.dtype} "
                        f"{tuple(qs.shape)}")
    if codes.device != qs.device:
        raise ValueError(f"codes on {codes.device} but qs on {qs.device}")
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {codes.device}")
    if not (codes.is_contiguous() and qs.is_contiguous()):
        raise ValueError("codes and qs must be contiguous")


def _kernel():
    """The C entry point ``alaya_block_diagdot`` of csrc/gather_diagdot.cu
    (built and loaded on first use)."""
    from ._build import entry

    return entry("gather_diagdot", "alaya_block_diagdot",
                 [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                  ctypes.c_int])


def block_diagdot(codes: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """dot[b, k] = sum_d (codes[b,k,d] - 128) * qs[b,d], f32 [B, K]."""
    from ._build import launch
    from .gather_diagdot import _vec

    _check(codes, qs)
    block_diagdot.calls += 1
    if codes.device.type == "cpu":
        return block_diagdot_ref(codes, qs)
    B, K, Dp = codes.shape
    out = torch.empty((B, K), dtype=torch.float32, device=codes.device)
    launch(_kernel(), codes.device, codes.data_ptr(), qs.data_ptr(),
           out.data_ptr(), B, K, Dp, int(_vec(codes, qs)))
    block_diagdot.launches += 1
    return out


block_diagdot.calls = 0
block_diagdot.launches = 0
