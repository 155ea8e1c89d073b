"""Device resolution for the PyTorch port (replaces ``utils/platforms.py``).

Every entry point (``Client``, ``Index``, ``IndexEngine``) takes
``device=None``, which means ``"cuda"``: the port runs on the GPU unless the
caller names another device. Without a GPU it raises; it never falls back
to the CPU on its own. Tests pass ``device="cpu"`` explicitly.

``resolve_device`` also turns TF32 off for float32 matrix products and
convolutions (``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``): exact distances, the rerank
and the ground truth are float32 products, and TF32 keeps only ~3 decimal
digits. This is process-wide PyTorch state, set on every call.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if the named device is CUDA and absent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "alayalite_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
