"""Vector file io: fvecs / ivecs / bvecs loaders, writers and md5 (a copy
of ``alayalite_tpu/utils/io.py``).

Each record is an int32 dim header followed by ``dim`` payload elements.
Pure numpy on the host: the JAX package first tries a native mmap loader,
which the port does not have (the numpy loader reads the same files into
the same arrays).
"""

from __future__ import annotations

import hashlib
import os
from typing import Union

import numpy as np

PathLike = Union[str, os.PathLike]


def _load_vecs(path: PathLike, dtype: np.dtype) -> np.ndarray:
    data = np.fromfile(path, dtype=np.uint8)
    if data.size == 0:
        return np.empty((0, 0), dtype=dtype)
    dim = int(np.frombuffer(data[:4].tobytes(), dtype=np.int32)[0])
    record = 4 + dim * np.dtype(dtype).itemsize
    if data.size % record != 0:
        raise ValueError(f"corrupt vecs file {path}: size {data.size} not a "
                         f"multiple of record {record}")
    n = data.size // record
    mat = data.reshape(n, record)[:, 4:].copy()
    return mat.view(dtype).reshape(n, dim)


def load_fvecs(path: PathLike) -> np.ndarray:
    return _load_vecs(path, np.dtype(np.float32))


def load_ivecs(path: PathLike) -> np.ndarray:
    return _load_vecs(path, np.dtype(np.int32))


def load_bvecs(path: PathLike) -> np.ndarray:
    data = np.fromfile(path, dtype=np.uint8)
    if data.size == 0:
        return np.empty((0, 0), dtype=np.uint8)
    dim = int(np.frombuffer(data[:4].tobytes(), dtype=np.int32)[0])
    record = 4 + dim
    n = data.size // record
    return data.reshape(n, record)[:, 4:].copy()


def _save_vecs(path: PathLike, mat: np.ndarray) -> None:
    n, d = mat.shape
    out = np.empty((n, d + 1), dtype=np.int32)
    out[:, 0] = d
    out[:, 1:] = mat.view(np.int32)
    out.tofile(path)


def save_fvecs(path: PathLike, mat: np.ndarray) -> None:
    _save_vecs(path, np.ascontiguousarray(mat, dtype=np.float32))


def save_ivecs(path: PathLike, mat: np.ndarray) -> None:
    _save_vecs(path, np.ascontiguousarray(mat, dtype=np.int32))


def md5(path: PathLike, chunk_size: int = 1 << 20) -> str:
    """md5 hex digest of a file, read in chunks."""
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(chunk_size), b""):
            h.update(chunk)
    return h.hexdigest()
