"""alayalite_tpu_torch — the PyTorch/CUDA port of alayalite_tpu.

It covers the main path, ``hnsw`` + ``bsq8`` fit (QG build) and batch
search, with the block estimate stage in a hand-written CUDA kernel
(``csrc/diagdot.cu``); and the flat index (exact and fast scans, sq8 codes,
insert and remove), whose exact l2 scan runs the hand-written distance tile
``csrc/l2_tile.cu`` (``csrc/sq8_tile.cu`` is the tile against sq8 codes).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``. The package imports ``torch`` and numpy,
never ``jax`` or ``alayalite_tpu``; index directories are shared with the
JAX package in both directions.
"""

from .client import Client
from .index_api import Index
from .params import IndexParams, IndexType, MetricType, QuantizationType

__version__ = "0.1.0"

__all__ = [
    "Client",
    "Index",
    "IndexParams",
    "IndexType",
    "MetricType",
    "QuantizationType",
    "__version__",
]
