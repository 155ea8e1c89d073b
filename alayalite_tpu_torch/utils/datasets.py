"""Synthetic dataset fixtures (numpy copy of ``alayalite_tpu/utils/datasets.py``).

Clustered Gaussian mixtures reproduce the local-neighbourhood structure
that makes graph ANN non-trivial; the same seed gives the same arrays as
the JAX package's ``random_dataset``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Dataset:
    data: np.ndarray       # [N, D] float32 base vectors
    queries: np.ndarray    # [Q, D] float32
    gt: Optional[np.ndarray] = None  # [Q, K] int ground-truth ids

    @property
    def dim(self) -> int:
        return int(self.data.shape[1])


def random_dataset(
    n: int = 1000,
    dim: int = 128,
    n_queries: int = 100,
    seed: int = 0,
    clusters: int = 32,
    topk: Optional[int] = None,
    metric: str = "l2",
) -> Dataset:
    """Gaussian-mixture base + queries drawn near base points."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, dim)).astype(np.float32) * 4.0
    assign = rng.integers(0, clusters, size=n)
    data = centers[assign] + rng.normal(size=(n, dim)).astype(np.float32)
    qidx = rng.integers(0, n, size=n_queries)
    queries = data[qidx] + 0.25 * rng.normal(size=(n_queries, dim)).astype(np.float32)
    data = data.astype(np.float32)
    queries = queries.astype(np.float32)
    ds = Dataset(data=data, queries=queries)
    if topk is not None:
        from .evaluate import calc_gt

        ds.gt = calc_gt(data, queries, topk, metric=metric)
    return ds
