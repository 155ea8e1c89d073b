"""The block search's seed scan: per query row, the ``nseed`` sample points
of least ``sq[j] − 2·Σ_d bf16(q[i, d])·vec[j, d]``.

    q f32 [B, D], vecs bf16 [S, D], sq f32 [S], ids int32 [S]
    -> ids[sel] [B, min(nseed, S)], sel ascending by score

Products are bf16 × bf16 (q rounded to nearest even), summed in f32. Among
equal scores the lower j comes first, which is ``lax.top_k``'s order; the
sample's ids are sorted, so that is the lower id. A NaN score orders as
+inf.

On a CUDA tensor ``seed_scan`` launches the hand-written kernels of
``csrc/seed_scan.cu`` (sm_90a, built with nvcc on first use, see ``_build``),
or raises. On a CPU tensor it runs the plain PyTorch version
``seed_scan_ref``. There is no other route and no fallback.

It replaces no Pallas kernel: the JAX package leaves this product and
``approx_max_k`` to XLA (``alayalite_tpu/index/search.py``, ``scan_seeds``).
It was added because the PyTorch chain that computed it (an f32 gemm,
``2·dot``, a broadcast subtract and ``torch.topk`` over a [4096, 16384]
score matrix) set about 36% of the bsq8 search's device time. It is bound by
operations: 0.017 ms a slice at (4096, 16384, 128) on the bf16 tensor cores.
The kernel keeps the scores in shared memory and the running best of each row
in registers (see the note in the source), so the score matrix is never
written.

On the card one call runs two kernels in turn: the scan, whose blocks each
take a split of the sample and write a partial best to a scratch tensor, and
the merge of the splits. ``seed_scan.calls`` counts calls on any device;
``seed_scan.launches`` counts the calls that launched them, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

MAX_NSEED = 16
# the widest D whose 16 query rows, a block's fewest, fit the card's shared
# memory beside the sample ring and the score tile (csrc/seed_scan.cu)
MAX_D = 5952


def seed_scan_ref(q: torch.Tensor, sample_ids: torch.Tensor,
                  sample_vecs: torch.Tensor, sample_sq: torch.Tensor,
                  nseed: int) -> torch.Tensor:
    """Plain version: the bf16 products are exact in f32, so an f32 product
    of the rounded operands gives them; a stable sort puts the lower index
    first among equal scores."""
    dot = q.to(torch.bfloat16).float() @ sample_vecs.float().T    # [B, S]
    d = torch.nan_to_num(sample_sq[None, :] - 2.0 * dot, nan=float("inf"))
    k = min(nseed, d.shape[1])
    sel = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return sample_ids[sel]


def _check(q, sample_ids, sample_vecs, sample_sq, nseed) -> None:
    if q.dtype != torch.float32 or q.dim() != 2:
        raise TypeError(f"q must be float32 [B, D], got {q.dtype} "
                        f"{tuple(q.shape)}")
    D = q.shape[1]
    if (sample_vecs.dtype != torch.bfloat16 or sample_vecs.dim() != 2
            or sample_vecs.shape[1] != D):
        raise TypeError(f"sample_vecs must be bfloat16 [S, {D}], got "
                        f"{sample_vecs.dtype} {tuple(sample_vecs.shape)}")
    S = sample_vecs.shape[0]
    if sample_sq.dtype != torch.float32 or tuple(sample_sq.shape) != (S,):
        raise TypeError(f"sample_sq must be float32 [{S}], got "
                        f"{sample_sq.dtype} {tuple(sample_sq.shape)}")
    if sample_ids.dtype != torch.int32 or tuple(sample_ids.shape) != (S,):
        raise TypeError(f"sample_ids must be int32 [{S}], got "
                        f"{sample_ids.dtype} {tuple(sample_ids.shape)}")
    if not 1 <= nseed <= MAX_NSEED:
        raise ValueError(f"nseed must be in [1, {MAX_NSEED}], got {nseed}")
    tensors = (q, sample_ids, sample_vecs, sample_sq)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("q and the sample must share one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q and the sample must be contiguous")
    if D > MAX_D or S >= 2 ** 31:
        raise ValueError(f"D={D} past {MAX_D} or S={S} past 2^31 - 1: "
                         "beyond the kernel's shared memory or indices")


def _entries():
    """The C entry points of csrc/seed_scan.cu (built and loaded on first
    use)."""
    from ._build import entry

    ll, i = ctypes.c_longlong, ctypes.c_int
    splits = entry("seed_scan", "alaya_seed_scan_splits",
                   [ll, ll, ll, i, ctypes.POINTER(ctypes.c_int)])
    scan = entry("seed_scan", "alaya_seed_scan",
                 [ctypes.c_void_p] * 7 + [ll, ll, ll, i, i])
    return splits, scan


def seed_scan(q: torch.Tensor, sample_ids: torch.Tensor,
              sample_vecs: torch.Tensor, sample_sq: torch.Tensor,
              nseed: int = 8) -> torch.Tensor:
    """The ``min(nseed, S)`` sample ids of least score per row of ``q``,
    nearest first; int32 [B, min(nseed, S)]."""
    from ._build import launch

    _check(q, sample_ids, sample_vecs, sample_sq, nseed)
    seed_scan.calls += 1
    if q.device.type == "cpu":
        return seed_scan_ref(q, sample_ids, sample_vecs, sample_sq, nseed)
    (B, D), S = q.shape, sample_vecs.shape[0]
    k = min(nseed, S)
    out = torch.empty((B, k), dtype=torch.int32, device=q.device)
    if B == 0 or k == 0:
        return out
    plan, scan = _entries()
    splits = ctypes.c_int(0)
    launch(plan, q.device, B, S, D, k, ctypes.byref(splits))
    width = 8 if k <= 8 else 16
    part_d = torch.empty((splits.value, B, width), dtype=torch.float32,
                         device=q.device)
    part_i = torch.empty((splits.value, B, width), dtype=torch.int32,
                         device=q.device)
    vec = int(D % 8 == 0 and sample_vecs.data_ptr() % 16 == 0)
    launch(scan, q.device, q.data_ptr(), sample_vecs.data_ptr(),
           sample_sq.data_ptr(), sample_ids.data_ptr(), part_d.data_ptr(),
           part_i.data_ptr(), out.data_ptr(), B, S, D, k, vec)
    seed_scan.launches += 1
    return out


seed_scan.calls = 0
seed_scan.launches = 0
