"""Carry a fitted index across from the JAX package.

The JAX package's ``save_arrays()`` methods return numpy dicts (the npz
files of a saved index directory). ``from_jax_arrays`` turns them into a
fitted port ``IndexEngine`` on ``device``: the arrays play the role that
weights play for a model. ``IndexEngine.load`` is this function applied to
the npz files. ``from_jax_sharded_leaves`` does the same for the JAX
package's sharded objects on a given mesh.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
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



def from_jax_sharded_leaves(kind: str, leaves, mesh, metric: str = "l2",
                            params: Optional[IndexParams] = None,
                            device: DeviceLike = None):
    """The numpy leaves of a JAX sharded object → the port's on ``mesh``
    (the concatenated row-sharded arrays split into one tensor per "db"
    shard on its device):

      "block": ``ShardedBlockIndex._leaves`` (data, sq_norms, dmin [ndb, D],
               scale, nbr_ids, nbr_codes, nbr_xsq, valid, eps [ndb, E]) →
               ``ShardedBlockIndex``;
      "graph": ``(*ShardedGraphIndex._leaves, _nbrs, _eps)`` (data,
               sq_norms, valid, nbrs, eps [ndb, E]) → ``ShardedGraphIndex``;
      "dist":  a ``DistGraphEngine``'s ``dist_graph.npz`` arrays (data,
               nbrs, eps, valid, n) with its ``params`` → ``DistGraphEngine``
               (its mesh is the engine's own)."""
    from .parallel.sharded import ShardedBlockIndex, ShardedGraphIndex

    if kind == "dist":
        from .parallel.dist_graph import DistGraphEngine

        return DistGraphEngine.from_arrays(params, leaves, device=device)
    devs = mesh.axis_devices("db")

    def split(x, dtype=None):
        parts = np.split(np.asarray(x), len(devs))
        return [torch.as_tensor(p if dtype is None else p.astype(dtype),
                                device=d) for p, d in zip(parts, devs)]

    if kind == "block":
        data, sq, dmin, scale, nids, ncodes, nxsq, valid, eps = leaves
        idx = ShardedBlockIndex(mesh, metric=metric,
                                max_nbrs=np.asarray(nids).shape[1])
        idx._leaves = (split(data, np.float32), split(sq, np.float32),
                       [x[0] for x in split(dmin, np.float32)],
                       [x[0] for x in split(scale, np.float32)],
                       split(nids, np.int32), split(ncodes, np.uint8),
                       split(nxsq, np.float32), split(valid, bool),
                       [x[0] for x in split(eps, np.int32)])
    elif kind == "graph":
        data, sq, valid, nbrs, eps = leaves
        idx = ShardedGraphIndex(mesh, metric=metric,
                                max_nbrs=np.asarray(nbrs).shape[1])
        idx._leaves = (split(data, np.float32), split(sq, np.float32),
                       split(valid, bool))
        idx._nbrs = split(nbrs, np.int32)
        idx._eps = [x[0] for x in split(eps, np.int32)]
    else:
        raise ValueError(f"unknown sharded kind {kind!r}")
    idx._per = np.asarray(leaves[0]).shape[0] // len(devs)
    idx._n = int(np.asarray(leaves[-2 if kind == "block" else 2]).sum())
    return idx
