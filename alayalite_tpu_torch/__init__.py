"""alayalite_tpu_torch — the PyTorch/CUDA port of alayalite_tpu.

It covers ``Client`` (with ``url`` discovery), ``Collection`` and
``Index``: the block-quantized graphs (``bsq8``, ``rabitq``, ``rabitq2``),
the raw graph indices (``hnsw``, ``nsg``, ``fusion``) and the flat index,
each with fit, search, insert, remove and save/load; the block hop's
estimate and the pool's sorts, merges and probes run in hand-written CUDA
kernels (``csrc/*.cu``), the flat exact l2 scan in the distance tile
``csrc/l2_tile.cu`` (``csrc/sq8_tile.cu`` is the tile against sq8 codes).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``. The package imports ``torch`` and numpy,
never ``jax`` or ``alayalite_tpu``; index directories are shared with the
JAX package in both directions.
"""

from .client import Client
from .collection import Collection
from .index_api import Index
from .params import IndexParams, IndexType, MetricType, QuantizationType

__version__ = "0.1.0"

__all__ = [
    "Client",
    "Collection",
    "Index",
    "IndexParams",
    "IndexType",
    "MetricType",
    "QuantizationType",
    "__version__",
]
