"""User-facing Index (port of the thin part of ``index_api.py``): the same
validation, capacity error and save/load directory contract as the JAX
package, over the PyTorch ``IndexEngine`` (flat and bsq8 indices take
insert and remove).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from .device import DeviceLike
from .index.engine import IndexEngine
from .params import IndexParams, fill_none_values


def _assert(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


class Index:
    def __init__(self, name: str = "default",
                 params: Optional[IndexParams] = None,
                 device: DeviceLike = None):
        self.name = name
        self.params = params if params is not None else IndexParams()
        self._engine = IndexEngine(self.params, device=device)
        self._dim: Optional[int] = None
        self._dtype = np.float32

    # ---- introspection ----
    def get_params(self) -> IndexParams:
        return self.params

    def get_dim(self) -> Optional[int]:
        return self._dim

    def get_dtype(self):
        return self._dtype

    def get_data_by_id(self, vector_id: int) -> np.ndarray:
        return self._engine.get_data_by_id(int(vector_id))

    @property
    def device(self) -> torch.device:
        return self._engine.device

    # ---- lifecycle ----
    def fit(self, vectors, ef_construction: int = 100,
            num_threads: int = 1) -> None:
        v = np.asarray(vectors)
        _assert(v.ndim == 2, "vectors must be 2-D [n, dim]")
        _assert(v.shape[0] > 0, "vectors must not be empty")
        self._dtype = v.dtype if v.dtype != np.float64 else np.float32
        self._engine.fit(v.astype(np.float32, copy=False),
                         ef_construction=ef_construction,
                         num_threads=num_threads)
        self._dim = int(v.shape[1])

    def insert(self, vectors, ef: int = 100):
        """Insert vector(s); raises RuntimeError at capacity. Returns the id
        (int) for a single vector, an int array for a batch."""
        v = np.asarray(vectors, dtype=np.float32)
        single = v.ndim == 1
        v = np.atleast_2d(v)
        _assert(self._dim is None or v.shape[1] == self._dim,
                "Vector dimension must match the index dimension.")
        ids = self._engine.insert(v, ef=ef)
        if (ids < 0).any():
            raise RuntimeError(
                "Insertion failed: The index is full. "
                f"(capacity={self._engine.capacity})")
        return int(ids[0]) if single else ids

    def remove(self, vector_id) -> None:
        self._engine.remove(np.asarray(vector_id, dtype=np.int32))

    # ---- search ----
    def search(self, query, topk: int, ef_search: int = 100) -> np.ndarray:
        q = np.asarray(query, dtype=np.float32)
        _assert(q.ndim == 1, "query must be 1-D")
        _assert(self._dim is None or q.shape[0] == self._dim,
                "Vector dimension must match the index dimension.")
        _assert(ef_search >= topk, "ef_search must be >= topk")
        return self._engine.search(q, topk, ef=ef_search)

    def search_with_distance(self, query, topk: int, ef_search: int = 100
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """``search`` with the distances: (ids [topk], dists [topk])."""
        q = np.asarray(query, dtype=np.float32)
        _assert(q.ndim == 1, "query must be 1-D")
        _assert(self._dim is None or q.shape[0] == self._dim,
                "Vector dimension must match the index dimension.")
        _assert(ef_search >= topk, "ef_search must be >= topk")
        return self._engine.search_with_distance(q, topk, ef=ef_search)

    @staticmethod
    def _as_query_batch(queries):
        """2-D query batch; device tensors pass through without a copy."""
        if isinstance(queries, torch.Tensor):
            return torch.atleast_2d(queries)
        return np.atleast_2d(np.asarray(queries, dtype=np.float32))

    def _check_batch(self, q, topk: int, ef_search: int) -> None:
        _assert(self._dim is None or q.shape[1] == self._dim,
                "Vector dimension must match the index dimension.")
        _assert(ef_search >= topk, "ef_search must be >= topk")

    def batch_search(self, queries, topk: int, ef_search: int = 100,
                     num_threads: int = 1) -> np.ndarray:
        q = self._as_query_batch(queries)
        self._check_batch(q, topk, ef_search)
        return self._engine.batch_search(q, topk, ef=ef_search,
                                         num_threads=num_threads)

    def batch_search_with_distance(self, queries, topk: int,
                                   ef_search: int = 100, num_threads: int = 1
                                   ) -> Tuple[np.ndarray, np.ndarray]:
        q = self._as_query_batch(queries)
        self._check_batch(q, topk, ef_search)
        return self._engine.batch_search_with_distance(
            q, topk, ef=ef_search, num_threads=num_threads)

    # ---- persistence ----
    def save(self, url) -> dict:
        """Write the index into ``url`` and return the schema map (the
        engine's files plus schema.json with ``type`` and ``dim``)."""
        self._engine.save(url)
        schema = self.params.to_dict()
        schema["type"] = "index"
        schema["dim"] = self._dim
        with open(os.path.join(url, "schema.json"), "w") as f:
            json.dump(schema, f, indent=4)
        return schema

    @classmethod
    def load(cls, url, name: str, device: DeviceLike = None) -> "Index":
        directory = os.path.join(url, name)
        if not os.path.exists(directory):
            raise RuntimeError(f"Index {name} does not exist")
        engine = IndexEngine.load(directory, device=device)
        idx = cls.__new__(cls)
        idx.name = name
        idx.params = engine.params
        idx._engine = engine
        idx._dim = engine.space.dim
        idx._dtype = np.float32
        return idx


def create_index(name: str = "default", device: DeviceLike = None,
                 **kwargs) -> Index:
    return Index(name, fill_none_values(**kwargs), device=device)
