"""Carry a fitted index across from the JAX package.

The JAX package's ``save_arrays()`` methods return numpy dicts (the npz
files of a saved index directory). ``from_jax_arrays`` turns them into a
fitted port ``IndexEngine`` on ``device``: the arrays play the role that
weights play for a model. ``IndexEngine.load`` is this function applied to
the npz files.
"""

from __future__ import annotations

from .device import DeviceLike
from .index.engine import IndexEngine
from .index.graph import Graph
from .params import IndexParams
from .spaces.bqg import BQGSpace
from .spaces.raw import RawSpace


def from_jax_arrays(params_json: str, raw_arrays: dict, graph_arrays: dict,
                    bqg_arrays: dict, device: DeviceLike = None
                    ) -> IndexEngine:
    """(schema JSON, RawSpace / Graph / BQGSpace array dicts) → engine."""
    params = IndexParams.from_json(params_json)
    eng = IndexEngine(params, device=device)
    eng.space = RawSpace.load_arrays(raw_arrays,
                                     storage_dtype=params.storage_dtype,
                                     device=eng.device)
    eng.graph = Graph.load_arrays(graph_arrays, device=eng.device)
    eng.search_space = BQGSpace.load_arrays(bqg_arrays, device=eng.device)
    eng._fitted = True
    return eng
