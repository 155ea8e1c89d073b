"""[Q, N] asymmetric squared-L2 tile against SQ8 codes, decode fused.

    qs = bf16(q∘scale), cf = c − 128, shift = dmin + 128·scale
    out[i, j] = max(Σ(q² − 2q·shift)_i − 2·(qs·cfᵀ)_ij + Σ(cf·scale + shift)²_j, 0)
    q f32 [Q, D], codes u8 [N, D], dmin / scale f32 [D] -> f32 [Q, N]

On a CUDA tensor ``sq8_tile`` launches the hand-written kernel
``csrc/sq8_tile.cu`` (sm_90a, built with nvcc on first use, see ``_build``),
or raises. On a CPU tensor it runs the plain PyTorch version
``sq8_tile_ref``. There is no other route and no fallback.

Replaces the TPU kernel ``alayalite_tpu/ops/pallas_distance.py:91``
(``_sq8_tile_kernel`` via ``sq8_pairwise_pallas``). As in the JAX package,
its caller is the distance-tile benchmark (``scripts/torch_pallas_bench.py``)
on the codes an ``SQSpace`` fit builds; flat + sq8 indices search the raw
rows. It takes any Q, N and D. It is bound by bytes: at (4096, 65536, 128)
it must move 1,084 MB, 0.324 ms at 3.35 TB/s on an H100, against 68.7 GFLOP
that the bf16 tensor cores would do in 0.070 ms (see the note in the
source).

``sq8_tile.calls`` counts calls on any device; ``sq8_tile.launches`` counts
CUDA kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

_MAX_Q = 65535 * 128  # grid.y holds the 128-row blocks of q


def sq8_tile_ref(q: torch.Tensor, codes: torch.Tensor, dmin: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """Plain version, the TPU kernel's arithmetic step by step: the bf16
    products are exact in f32, so an f32 product of the rounded operands
    gives them."""
    qs = (q * scale).to(torch.bfloat16).float()
    cf = codes.float() - 128.0
    dot = qs @ cf.T
    shift = dmin + 128.0 * scale
    qconst = (q * q - 2.0 * q * shift).sum(1)
    xhat = cf * scale + shift
    xsq = (xhat * xhat).sum(1)
    return torch.clamp(qconst[:, None] - 2.0 * dot + xsq[None, :], min=0.0)


def _check(q, codes, dmin, scale) -> None:
    if q.dtype != torch.float32 or q.dim() != 2:
        raise TypeError(f"q must be float32 [Q, D], got {q.dtype} "
                        f"{tuple(q.shape)}")
    D = q.shape[1]
    if codes.dtype != torch.uint8 or codes.dim() != 2 or codes.shape[1] != D:
        raise TypeError(f"codes must be uint8 [N, {D}], got {codes.dtype} "
                        f"{tuple(codes.shape)}")
    for name, t in (("dmin", dmin), ("scale", scale)):
        if t.dtype != torch.float32 or tuple(t.shape) != (D,):
            raise TypeError(f"{name} must be float32 [{D}], got {t.dtype} "
                            f"{tuple(t.shape)}")
    if len({t.device for t in (q, codes, dmin, scale)}) != 1:
        raise ValueError("q, codes, dmin and scale must share one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if not all(t.is_contiguous() for t in (q, codes, dmin, scale)):
        raise ValueError("q, codes, dmin and scale must be contiguous")
    if q.shape[0] > _MAX_Q:
        raise ValueError(f"Q={q.shape[0]} exceeds the kernel's grid "
                         f"({_MAX_Q} rows)")


def _kernel():
    """The C entry point of csrc/sq8_tile.cu (built and loaded on first
    use)."""
    from ._build import entry

    return entry("sq8_tile", "alaya_sq8_tile",
                 [ctypes.c_void_p] * 5
                 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_int])


def sq8_tile(q: torch.Tensor, codes: torch.Tensor, dmin: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """Asymmetric squared L2 from f32 queries to SQ8 codes, f32 [Q, N]."""
    from ._build import launch

    _check(q, codes, dmin, scale)
    sq8_tile.calls += 1
    if q.device.type == "cpu":
        return sq8_tile_ref(q, codes, dmin, scale)
    (Q, D), N = q.shape, codes.shape[0]
    out = torch.empty((Q, N), dtype=torch.float32, device=q.device)
    vec = int(D % 8 == 0 and q.data_ptr() % 16 == 0
              and codes.data_ptr() % 8 == 0)
    launch(_kernel(), q.device, q.data_ptr(), codes.data_ptr(),
           dmin.data_ptr(), scale.data_ptr(), out.data_ptr(), Q, N, D, vec)
    sq8_tile.launches += 1
    return out


sq8_tile.calls = 0
sq8_tile.launches = 0
