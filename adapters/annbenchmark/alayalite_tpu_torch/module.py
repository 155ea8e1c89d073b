"""ann-benchmarks adapter for the PyTorch port (a copy of
``adapters/annbenchmark/alayalite_tpu/module.py`` over
``alayalite_tpu_torch``).

A BaseANN subclass exposing fit / set_query_arguments(ef) / query /
batch_query so the port drops into the ann-benchmarks harness for
recall-vs-QPS sweeps. It falls back to a standalone stub base class when
ann_benchmarks is not installed, so the adapter is importable and testable
offline. The index lives on ``method_param["device"]`` (default ``cuda``).
"""

from __future__ import annotations

import numpy as np

try:  # pragma: no cover - harness present only in ann-benchmarks images
    from ann_benchmarks.algorithms.base.module import BaseANN
except ImportError:
    class BaseANN:  # minimal stand-in with the harness' surface
        def done(self):
            pass

from alayalite_tpu_torch import Index, IndexParams


class AlayaLiteTPUTorch(BaseANN):
    def __init__(self, metric: str, method_param: dict):
        self._metric = {"euclidean": "l2", "angular": "cos",
                        "ip": "ip"}.get(metric, metric)
        self._index_type = method_param.get("index_type", "hnsw")
        self._quant = method_param.get("quantization_type", "none")
        self._m = int(method_param.get("M", 32))
        self._ef_construction = int(method_param.get("efConstruction", 200))
        self._device = method_param.get("device")
        self._ef = 100
        self._index = None
        self.name = (f"alayalite_tpu_torch({self._index_type},M={self._m},"
                     f"efC={self._ef_construction},q={self._quant})")

    def fit(self, X: np.ndarray) -> None:
        X = np.asarray(X, dtype=np.float32)
        self._index = Index("annb", IndexParams(
            index_type=self._index_type, metric=self._metric,
            capacity=X.shape[0], max_nbrs=self._m,
            quantization_type=self._quant,
            ef_construction=self._ef_construction), device=self._device)
        self._index.fit(X)

    def set_query_arguments(self, ef: int) -> None:
        self._ef = int(ef)

    def query(self, q: np.ndarray, n: int) -> np.ndarray:
        ids = self._index.search(np.asarray(q, dtype=np.float32), n,
                                 ef_search=max(self._ef, n))
        return ids[ids >= 0]

    def batch_query(self, X: np.ndarray, n: int) -> None:
        self._res = self._index.batch_search(
            np.asarray(X, dtype=np.float32), n,
            ef_search=max(self._ef, n))

    def get_batch_results(self) -> np.ndarray:
        return self._res

    def __str__(self) -> str:
        return f"{self.name}[ef={self._ef}]"
