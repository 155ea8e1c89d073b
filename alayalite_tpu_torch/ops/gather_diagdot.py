"""The block hop's estimate stage with the neighbor-block gather inside the
kernel, and with the estimate's epilogue fused in.

    gather_diagdot(codes, u, qs)
        out[b, m*R + r] = sum_d (codes[u[b, m], r, d] - 128) * qs[b, d]
        codes u8 [C, R, Dp], u i32 [B, M], qs bf16 [B, Dp] -> f32 [B, M*R]
    gather_estimate(codes, u, qs, qconst, coef, xsq, nbr_ids, clamp)
        (est, ids): est = (qconst[b] - coef * dot) + xsq[node, r], clamped
        at 0 where ``clamp`` (L2), ids = nbr_ids[node, r]; both [B, M*R]:
        ``BQGSpace.estimate_many``'s two outputs in one launch

``u`` is clamped into [0, C) (inside the kernel on the card). On CUDA
tensors each wrapper launches one of the two hand-written entries of
``csrc/gather_diagdot.cu`` (sm_90a, built with nvcc on first use, see
``_build``), or raises:
  "rows"  the unit of work is a code row: lanes that share a row keep
          their slice of qs in registers and start every row load before
          their first multiply-add; no shared memory, no barrier;
  "bulk"  each popped node's R*Dp bytes move by a TMA bulk copy into a ring
          of shared-memory stages, a few items ahead of the compute; it
          takes R*Dp % 16 == 0 and 16-byte aligned codes and raises
          elsewhere (``bulk_fits``).
On CPU tensors they run the plain PyTorch versions ``gather_diagdot_ref``
(``index_select`` + ``block_diagdot_ref``) and ``gather_estimate_ref`` (the
epilogue of ``estimate_many`` written out over it). There is no other route
and no fallback. The estimate is evaluated in the epilogue's f32 order
(multiply, subtract, add, no FMA), so for the same dot it equals the plain
epilogue bit for bit.

Replaces the TPU kernels ``scripts/proto_dma_gather.py:93`` (``dma_diagdot``,
the rows entry) and ``scripts/proto_dma_gather2.py:124`` (``dma2_diagdot``,
its double-buffered copies: the bulk entry). The kernels are bound by
memory: at the hop's shape (B 4096, M 8, R 32, Dp 128) each pop reads a
4 KB block, 139.6 MB in all (~42 us at 3.35 TB/s), but a block that several
pops share needs its bytes once: chip_smoke.py's bound over the distinct
blocks is 0.0322 ms (see the note in the source).

``.calls`` counts calls on any device, ``.launches`` CUDA kernel launches
and nothing else, ``.route_launches`` the launches by entry.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .diagdot import block_diagdot_ref

Tensor = torch.Tensor
_MAX_SMEM = 227 * 1024      # dynamic shared memory one block may use on sm_90
# the bulk entry's shared memory: barriers and node ids, then 4 stages of up
# to 128 pops or 16 KB
_BULK_STAGES, _BULK_TARGET, _BULK_HEADER, _BULK_POPS = 4, 16384, 2688, 128
VARIANTS = ("rows", "bulk")


def gather_diagdot_ref(codes: Tensor, u: Tensor, qs: Tensor) -> Tensor:
    """Plain version: gather the popped nodes' blocks into [B, M*R, Dp],
    then the plain decode + dot."""
    B, M = u.shape
    C, R, Dp = codes.shape
    safe = u.clamp(0, C - 1).reshape(-1)
    g = codes.index_select(0, safe).view(B, M * R, Dp)
    return block_diagdot_ref(g, qs)


def estimate_epilogue(dot: Tensor, u: Tensor, qconst: Tensor, coef: float,
                      xsq: Tensor, nbr_ids: Tensor,
                      clamp: bool) -> Tuple[Tensor, Tensor]:
    """``estimate_many``'s epilogue on given dots [B, M*R]: (est, ids)."""
    B, M = u.shape
    C, R = xsq.shape
    flat = u.clamp(0, C - 1).reshape(-1)
    est = (qconst[:, None] - coef * dot
           + xsq.index_select(0, flat).view(B, M * R))
    if clamp:
        est = torch.clamp(est, min=0.0)
    return est, nbr_ids.index_select(0, flat).view(B, M * R)


def gather_estimate_ref(codes: Tensor, u: Tensor, qs: Tensor, qconst: Tensor,
                        coef: float, xsq: Tensor, nbr_ids: Tensor,
                        clamp: bool) -> Tuple[Tensor, Tensor]:
    """Plain version of the fused entry: the epilogue over
    ``gather_diagdot_ref``."""
    return estimate_epilogue(gather_diagdot_ref(codes, u, qs), u, qconst,
                             coef, xsq, nbr_ids, clamp)


def _check(codes: Tensor, u: Tensor, qs: Tensor) -> None:
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


def _check_estimate(codes: Tensor, u: Tensor, qconst: Tensor, xsq: Tensor,
                    nbr_ids: Tensor) -> None:
    C, R, _ = codes.shape
    for name, t, dtype, shape in (("qconst", qconst, torch.float32,
                                   (u.shape[0],)),
                                  ("xsq", xsq, torch.float32, (C, R)),
                                  ("nbr_ids", nbr_ids, torch.int32, (C, R))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise TypeError(f"{name} must be {dtype} {list(shape)}, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != codes.device:
            raise ValueError(f"{name} on {t.device}, codes on {codes.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _vec(codes: Tensor, qs: Tensor) -> bool:
    """16-byte loads of code rows and of qs."""
    return (codes.shape[2] % 16 == 0 and codes.data_ptr() % 16 == 0
            and qs.data_ptr() % 16 == 0)


def bulk_fits(codes: Tensor) -> bool:
    """Whether the bulk entry takes these codes: whole 16-byte blocks at a
    16-byte aligned base, and four stages of a block in shared memory."""
    _, R, Dp = codes.shape
    blk = R * Dp
    T = min(_BULK_POPS, max(1, _BULK_TARGET // blk)) if blk else 1
    return (blk % 16 == 0 and codes.data_ptr() % 16 == 0
            and _BULK_HEADER + _BULK_STAGES * T * blk <= _MAX_SMEM)


def _kernel(variant: str):
    """A C entry point of csrc/gather_diagdot.cu (built and loaded on first
    use)."""
    from ._build import entry

    P, LL = ctypes.c_void_p, ctypes.c_longlong
    return entry("gather_diagdot", f"alaya_gather_diagdot_{variant}",
                 [P] * 4 + [LL] * 5 + [ctypes.c_int] + [P] * 4
                 + [ctypes.c_float, ctypes.c_int])


def _launch(fn, codes: Tensor, u: Tensor, qs: Tensor, out: Tensor,
            variant: str, est_args=(None, None, None, None, 0.0, 0)) -> None:
    from ._build import launch

    if variant == "bulk" and not bulk_fits(codes):
        raise ValueError(f"the bulk entry does not take codes "
                         f"{tuple(codes.shape)} at this base address")
    B, M = u.shape
    C, R, Dp = codes.shape
    launch(_kernel(variant), codes.device, codes.data_ptr(), u.data_ptr(),
           qs.data_ptr(), out.data_ptr(), C, B, M, R, Dp,
           int(_vec(codes, qs)), *est_args)
    fn.launches += 1
    fn.route_launches[variant] += 1


def gather_diagdot(codes: Tensor, u: Tensor, qs: Tensor,
                   variant: str = "rows") -> Tensor:
    """out[b, m*R + r] = sum_d (codes[u[b,m], r, d] - 128) * qs[b, d]."""
    _check(codes, u, qs)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    gather_diagdot.calls += 1
    if codes.device.type == "cpu":
        return gather_diagdot_ref(codes, u, qs)
    B, M = u.shape
    out = torch.empty((B, M * codes.shape[1]), dtype=torch.float32,
                      device=codes.device)
    if out.numel():
        _launch(gather_diagdot, codes, u, qs, out, variant)
    return out


def gather_estimate(codes: Tensor, u: Tensor, qs: Tensor, qconst: Tensor,
                    coef: float, xsq: Tensor, nbr_ids: Tensor, clamp: bool,
                    variant: str = "rows") -> Tuple[Tensor, Tensor]:
    """(est, ids) [B, M*R]: est = (qconst[b] - coef * dot) + xsq[node, r]
    (clamped at 0 where ``clamp``), ids = nbr_ids[node, r], node = u[b, m]
    clamped into [0, C)."""
    _check(codes, u, qs)
    _check_estimate(codes, u, qconst, xsq, nbr_ids)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    gather_estimate.calls += 1
    if codes.device.type == "cpu":
        return gather_estimate_ref(codes, u, qs, qconst, coef, xsq, nbr_ids,
                                   clamp)
    B, M = u.shape
    shape = (B, M * codes.shape[1])
    est = torch.empty(shape, dtype=torch.float32, device=codes.device)
    ids = torch.empty(shape, dtype=torch.int32, device=codes.device)
    if est.numel():
        _launch(gather_estimate, codes, u, qs, est, variant,
                (qconst.data_ptr(), xsq.data_ptr(), nbr_ids.data_ptr(),
                 ids.data_ptr(), float(coef), int(bool(clamp))))
    return est, ids


for _fn in (gather_diagdot, gather_estimate):
    _fn.calls = 0
    _fn.launches = 0
    _fn.route_launches = {v: 0 for v in VARIANTS}
