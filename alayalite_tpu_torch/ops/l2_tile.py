"""[Q, N] squared-L2 tile with the norm epilogue fused: the distance tile
of the flat index's exact scan.

    out[i, j] = max(|q_i|² + |x_j|² − 2·q_i·x_j, 0)
    q f32 [Q, D], x f32 [N, D] -> f32 [Q, N]

On a CUDA tensor ``l2_tile`` launches the hand-written kernel
``csrc/l2_tile.cu`` (sm_90a, built with nvcc on first use, see ``_build``),
or raises. On a CPU tensor it runs the plain PyTorch version
``l2_tile_ref``. There is no other route and no fallback.

Replaces the TPU kernel ``alayalite_tpu/ops/pallas_distance.py:43``
(``_l2_tile_kernel`` via ``pairwise_l2_pallas``), which the JAX package runs
only from its benchmark; here it is the exact scan of every flat l2 search
(``ops/distance.pairwise``) and of ``find_medoid``/``exact_knn``. Unlike
that kernel it takes any Q, N and D. It is bound by operations: at the
flat scan's tile (4096, 16384, 128) the 17.18 GFLOP of f32 products take
0.256 ms at 67 TFLOP/s, the 278.9 MB it moves 0.083 ms at 3.35 TB/s on an
H100 (see the note in the source).

``l2_tile.calls`` counts calls on any device; ``l2_tile.launches`` counts
CUDA kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

_MAX_Q = 65535 * 128  # grid.y holds the 128-row blocks of q


def l2_tile_ref(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version: float32 product, then the norm epilogue."""
    q_sq = (q * q).sum(1)
    x_sq = (x * x).sum(1)
    return torch.clamp(q_sq[:, None] + x_sq[None, :] - 2.0 * (q @ x.T),
                       min=0.0)


def _check(q: torch.Tensor, x: torch.Tensor) -> None:
    if q.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"q and x must be float32, got {q.dtype}, {x.dtype}")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise TypeError(f"q [Q, D] and x [N, D] must share D, got "
                        f"{tuple(q.shape)}, {tuple(x.shape)}")
    if q.device != x.device:
        raise ValueError(f"q on {q.device} but x on {x.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if not (q.is_contiguous() and x.is_contiguous()):
        raise ValueError("q and x must be contiguous")
    if q.shape[0] > _MAX_Q:
        raise ValueError(f"Q={q.shape[0]} exceeds the kernel's grid "
                         f"({_MAX_Q} rows)")


def _kernel():
    """The C entry point of csrc/l2_tile.cu (built and loaded on first use)."""
    from ._build import entry

    return entry("l2_tile", "alaya_l2_tile",
                 [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                  ctypes.c_int])


def l2_tile(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """max(|q|² + |x|² − 2·q·xᵀ, 0), f32 [Q, N]."""
    from ._build import launch

    _check(q, x)
    l2_tile.calls += 1
    if q.device.type == "cpu":
        return l2_tile_ref(q, x)
    (Q, D), N = q.shape, x.shape[0]
    out = torch.empty((Q, N), dtype=torch.float32, device=q.device)
    vec = int(D % 4 == 0 and q.data_ptr() % 16 == 0
              and x.data_ptr() % 16 == 0)
    launch(_kernel(), q.device, q.data_ptr(), x.data_ptr(), out.data_ptr(),
           Q, N, D, vec)
    l2_tile.launches += 1
    return out


l2_tile.calls = 0
l2_tile.launches = 0
