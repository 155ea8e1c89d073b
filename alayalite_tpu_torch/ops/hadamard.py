"""Fast Walsh–Hadamard transform (port of ``alayalite_tpu/ops/hadamard.py``).

Only the host-side numpy transform ``fwht_np`` is ported: it materializes
RaBitQ's FhtKac rotation as a matrix (``spaces/rabitq.make_fht_kac_rotation``,
bit for bit the JAX package's), which the queries and blocks then meet as
one matrix product. The JAX package's ``fwht`` / ``fht_kac_rotate`` on
device arrays have no caller on its search or build paths either.
"""

from __future__ import annotations

import numpy as np


def fwht_np(x: np.ndarray, normalize: bool = True) -> np.ndarray:
    """Walsh–Hadamard transform along the last axis (power-of-two length),
    keeping the dtype; with ``normalize`` scaled by 1/sqrt(D), so
    orthonormal (H·H = I)."""
    d = x.shape[-1]
    if d & (d - 1):
        raise ValueError(f"fwht length must be a power of two, got {d}")
    lead = x.shape[:-1]
    y = np.asarray(x).reshape(-1, d)
    h = 1
    while h < d:
        y = y.reshape(-1, d // (2 * h), 2, h)
        a = y[:, :, 0, :]
        b = y[:, :, 1, :]
        y = np.stack([a + b, a - b], 2)
        h *= 2
    y = y.reshape(*lead, d)
    if normalize:
        y = y / np.sqrt(d).astype(y.dtype)
    return y
