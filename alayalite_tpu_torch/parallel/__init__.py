"""Multi-device scaling over a mesh of torch devices (port of
``parallel/``): db-sharded searches and the sharded SDK engine, the
ring-rotating sharded build, the serve-sharded single graph, and
multi-process loading."""

from .multihost import (
    fit_shards_from_file,
    load_vecs_global,
    load_vecs_rows,
    maybe_distributed_init,
    probe_vecs,
)
from .sharded import (
    ShardedBlockIndex,
    ShardedFlatIndex,
    ShardedGraphIndex,
    db_sharded_flat_search,
    db_sharded_graph_search,
    dp_sharded_beam_search,
    make_mesh,
    shard_space_by_rows,
)

__all__ = [
    "fit_shards_from_file",
    "load_vecs_global",
    "load_vecs_rows",
    "maybe_distributed_init",
    "probe_vecs",
    "ShardedBlockIndex",
    "ShardedFlatIndex",
    "ShardedGraphIndex",
    "db_sharded_flat_search",
    "db_sharded_graph_search",
    "dp_sharded_beam_search",
    "make_mesh",
    "shard_space_by_rows",
]
