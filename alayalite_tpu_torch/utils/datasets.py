"""Dataset fixtures (numpy copy of ``alayalite_tpu/utils/datasets.py``).

Clustered Gaussian mixtures reproduce the local-neighbourhood structure
that makes graph ANN non-trivial; the same seed gives the same arrays as
the JAX package's ``random_dataset``. Real datasets are read from local
files under ``$ALAYA_DATA_DIR`` in either of two layouts:

  texmex fvecs:   <dir>/<name>/<name>_{base,query}.fvecs (or .bvecs)
                  + <name>_groundtruth.ivecs            (sift, gist, ...)
  ann-benchmarks: <dir>/<name>.hdf5 with train / test / neighbors
"""

from __future__ import annotations

import dataclasses
import os
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
    device=None,
) -> Dataset:
    """Gaussian-mixture base + queries drawn near base points; with
    ``topk``, the exact ground truth by ``calc_gt`` on ``device``."""
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

        ds.gt = calc_gt(data, queries, topk, metric=metric, device=device)
    return ds


_REAL_METRIC = {"sift": "l2", "siftsmall": "l2", "gist": "l2",
                "deep1m": "cos"}


def data_dir() -> Optional[str]:
    d = os.environ.get("ALAYA_DATA_DIR")
    return d if d and os.path.isdir(d) else None


def _load_texmex(root: str, name: str) -> Optional[Dataset]:
    from .io import load_bvecs, load_fvecs, load_ivecs

    base_dir = os.path.join(root, name)
    if not os.path.isdir(base_dir):
        return None

    def pick(kind: str):
        for ext, loader in ((".fvecs", load_fvecs), (".bvecs", load_bvecs)):
            p = os.path.join(base_dir, f"{name}_{kind}{ext}")
            if os.path.exists(p):
                return loader(p)
        return None

    base, query = pick("base"), pick("query")
    if base is None or query is None:
        return None
    gtp = os.path.join(base_dir, f"{name}_groundtruth.ivecs")
    gt = load_ivecs(gtp) if os.path.exists(gtp) else None
    return Dataset(data=np.asarray(base, dtype=np.float32),
                   queries=np.asarray(query, dtype=np.float32), gt=gt)


def _load_hdf5(root: str, name: str) -> Optional[Dataset]:
    path = os.path.join(root, f"{name}.hdf5")
    if not os.path.exists(path):
        return None
    import h5py

    with h5py.File(path, "r") as f:
        data = np.asarray(f["train"], dtype=np.float32)
        queries = np.asarray(f["test"], dtype=np.float32)
        gt = np.asarray(f["neighbors"]) if "neighbors" in f else None
    return Dataset(data=data, queries=queries, gt=gt)


def load_real_dataset(name: str, root: Optional[str] = None,
                      topk: Optional[int] = None,
                      device=None) -> Optional[Dataset]:
    """Load a local real dataset by name ("sift", "gist", "siftsmall",
    "fashion-mnist-784-euclidean", ...); None when absent. Where the files
    hold no ground truth and ``topk`` is given, it is computed by
    ``calc_gt(fast=True)`` on ``device`` (``cuda`` by default)."""
    root = root or data_dir()
    if root is None:
        return None
    ds = _load_texmex(root, name) or _load_hdf5(root, name)
    if ds is None:
        return None
    if ds.gt is None and topk is not None:
        from .evaluate import calc_gt

        ds.gt = calc_gt(ds.data, ds.queries, topk,
                        metric=_REAL_METRIC.get(name, "l2"), fast=True,
                        device=device)
    return ds


def available_real_datasets(root: Optional[str] = None) -> list:
    """Names found under ``root`` (or ``$ALAYA_DATA_DIR``), either layout."""
    root = root or data_dir()
    if root is None:
        return []
    names = []
    for entry in sorted(os.listdir(root)):
        full = os.path.join(root, entry)
        if entry.endswith(".hdf5"):
            names.append(entry[: -len(".hdf5")])
        elif os.path.isdir(full) and any(
                os.path.exists(os.path.join(full, f"{entry}_base{ext}"))
                for ext in (".fvecs", ".bvecs")):
            names.append(entry)
    return names
