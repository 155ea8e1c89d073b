"""Carry a fitted index across from the JAX package.

The JAX package's ``save_arrays()`` methods return numpy dicts (the npz
files of a saved index directory). ``from_jax_arrays`` turns them into a
fitted port ``IndexEngine`` on ``device``: the arrays play the role that
weights play for a model. ``IndexEngine.load`` is this function applied to
the npz files.
"""

from __future__ import annotations

from typing import Optional

import torch

from .device import DeviceLike
from .index.engine import IndexEngine
from .index.graph import Graph
from .params import IndexParams, QuantizationType
from .spaces.bqg import BQGSpace
from .spaces.rabitq import RaBitQSpace
from .spaces.raw import RawSpace
from .spaces.sq import SQSpace


def from_jax_arrays(params_json: str, raw_arrays: dict,
                    graph_arrays: Optional[dict] = None,
                    quant_arrays: Optional[dict] = None,
                    device: DeviceLike = None) -> IndexEngine:
    """(schema JSON, RawSpace / Graph / quantized-space array dicts) →
    engine. A flat index has no graph; a raw graph carries its overlay
    levels; without quantized arrays the raw space is also the search
    space."""
    params = IndexParams.from_json(params_json)
    eng = IndexEngine(params, device=device)
    eng.space = RawSpace.load_arrays(raw_arrays,
                                     storage_dtype=params.storage_dtype,
                                     device=eng.device)
    if graph_arrays is not None:
        eng.graph = Graph.load_arrays(graph_arrays, device=eng.device)
    qtype = {QuantizationType.BSQ8: BQGSpace, QuantizationType.SQ8: SQSpace,
             QuantizationType.SQ4: SQSpace,
             QuantizationType.RABITQ: RaBitQSpace,
             QuantizationType.RABITQ2: RaBitQSpace,
             }.get(params.quantization_type)
    if quant_arrays is None or qtype is None:
        eng.search_space = eng.space
    elif qtype is RaBitQSpace:
        eng.search_space = RaBitQSpace.load_arrays(
            quant_arrays, device=eng.device, storage=_shared_slab(eng.space))
    else:
        eng.search_space = qtype.load_arrays(quant_arrays, device=eng.device)
    eng._fitted = True
    return eng


def _shared_slab(space: RawSpace):
    """A rabitq space shares an f32 raw slab, as at fit (the two hold the
    same normalize-then-store rows); other storage gets its own copy."""
    if space.data.dtype != torch.float32:
        return None
    return space.data, space.sq_norms, space.valid, space.num

