"""Index parameter schema and enums.

A jax-free copy of ``alayalite_tpu/params.py``: the same fields, defaults,
validation and JSON, so ``schema.json`` is byte-for-byte what the JAX
package writes and either package loads the other's index directories.
Devices are not a parameter: the engine takes its ``device`` separately.

TPU-native re-design of the reference's parameter plumbing:
  - enums mirror reference include/utils/metric_type.hpp:26-54 and
    python/src/alayalite/common.py:38-190 (string-valued for JSON round-trips).
  - ``IndexParams`` mirrors python/src/alayalite/schema.py:46-165 (same
    defaults: hnsw / float32 / uint32 / none / l2 / capacity=100000 /
    max_nbrs=32) plus TPU-specific knobs (storage dtype, batch sizing).
  - JSON round-trip + on-disk naming contract match schema.py:58-68 so a
    directory written by this framework has the same shape of metadata.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Optional


class MetricType(str, enum.Enum):
    L2 = "l2"
    IP = "ip"
    COS = "cos"

    @classmethod
    def parse(cls, v: "MetricType | str") -> "MetricType":
        if isinstance(v, MetricType):
            return v
        return cls(str(v).lower())


class IndexType(str, enum.Enum):
    FLAT = "flat"  # brute-force exact (TPU MXU shines here; no ref analog needed)
    HNSW = "hnsw"
    NSG = "nsg"
    FUSION = "fusion"

    @classmethod
    def parse(cls, v: "IndexType | str") -> "IndexType":
        if isinstance(v, IndexType):
            return v
        return cls(str(v).lower())


class QuantizationType(str, enum.Enum):
    NONE = "none"
    SQ8 = "sq8"
    SQ4 = "sq4"
    RABITQ = "rabitq"
    RABITQ2 = "rabitq2"  # 2-bit extension (beyond the reference's 1-bit)
    # TPU-native extension: block-SQ8 quantized graph (spaces/bqg.py) —
    # RaBitQ's packed-neighbor layout with 8-bit codes; the throughput config
    BSQ8 = "bsq8"

    @property
    def is_block(self) -> bool:
        """Block layouts (packed per-node neighbor payloads) that imply the
        QG-style graph + block beam search."""
        return self in (QuantizationType.RABITQ, QuantizationType.RABITQ2,
                        QuantizationType.BSQ8)

    @classmethod
    def parse(cls, v: "QuantizationType | str | None") -> "QuantizationType":
        if v is None:
            return cls.NONE
        if isinstance(v, QuantizationType):
            return v
        return cls(str(v).lower())


_VALID_DTYPES = ("float32", "bfloat16", "float16", "int8", "uint8", "int32", "uint32", "float64")
_VALID_ID_TYPES = ("uint32", "uint64", "int32", "int64")


@dataclasses.dataclass
class IndexParams:
    """User-facing index configuration (reference: schema.py:46-165)."""

    index_type: IndexType = IndexType.HNSW
    data_type: str = "float32"
    id_type: str = "uint32"
    quantization_type: QuantizationType = QuantizationType.NONE
    metric: MetricType = MetricType.L2
    capacity: int = 100_000
    max_nbrs: int = 32

    # --- TPU-specific extensions (defaults chosen to be safe everywhere) ---
    # dtype used for the on-device vector slab; bfloat16 halves HBM traffic
    # at a tiny recall cost and keeps MXU-native matmuls.
    storage_dtype: str = "float32"
    # beam width used at build time (ef_construction analog).
    ef_construction: int = 200
    # entries popped per lockstep hop (CAGRA-style multi-expansion); 1 ==
    # strictly-greedy reference semantics, 8 is the TPU sweet spot (tune_hops.py).
    beam_expand: int = 8
    # hop cap for the lockstep beam; 0 = auto (max(8, ef/beam_expand + 4)).
    # Tuned jointly with beam_expand (scripts/sweep_hop_sched.py).
    search_iters: int = 0
    # per-query seed scan for block (bsq8/rabitq) indices: sample size for
    # the one-MXU-pass entry-point selection (search.scan_seeds). 0 turns
    # it off (shared entry points). Plays the role of the HNSW upper
    # layers for flat-adjacency block graphs; measured 238k -> 438k chip
    # QPS at recall 0.957 on bsq8@100k (scripts/proto_seedscan.py).
    seed_sample: int = 4096
    # flat index scan mode: "exact" (default) = single-pass full-precision
    # brute force, matching the reference's exact FLAT semantics; "fast" =
    # bf16 MXU scan + approx selection + f32 rerank (recall ≥ 0.999 vs
    # exact, ~8x faster) — opt in for throughput.
    flat_mode: str = "exact"
    # ef multiplier applied internally for 1-bit rabitq searches. The 1-bit
    # estimator's noise needs ~4-5x the pool width of exact traversal for
    # equal recall (the reference's own acceptance test runs ef=400 for
    # k=10, test_rabitq_search.py:38-66; measured here: ef=240 for 0.96 at
    # 100k, results/sweep_rabitq_100k.json). Applied only when
    # quantization_type == "rabitq"; set 1.0 to opt out. rabitq2 (2-bit)
    # needs no boost and is the recommended rabitq config.
    rabitq_ef_boost: float = 4.0
    # RaBitQ rotator: "matrix" (QR orthonormal, MatrixRotator) or "fht_kac"
    # (sign-flip + Walsh-Hadamard rounds, FhtKac rotator; non-pow2 dims pad
    # to the next power of two like the reference — rotator.hpp:85-166;
    # materialized to its equivalent matrix at create).
    rotator: str = "matrix"
    # Multi-chip scaling knob (the reference's num_threads analog,
    # index.py:145-162, re-expressed as a device-mesh axis — SURVEY.md §2c):
    # > 1 partitions the database rows into this many shards, searched
    # fan-out with one ICI all_gather top-k merge (parallel/sharded.py).
    # Supported for flat and block (bsq8) indices. With fewer JAX devices
    # than shards the engine falls back to sequential per-shard search with
    # a host merge (same results; lets a sharded index build/run anywhere).
    db_shards: int = 1
    # occlusion-rule slack for the graph builders (hnsw/nsg/fusion/qg):
    # 1.0 == the reference's MRNG heuristic (an edge to j is dropped when
    # some already-selected t has d(t, j) < d(node, j)). alpha > 1 runs a
    # second, relaxed selection pass (DiskANN occlude_list's progressive
    # cur_alpha rounds): pass 1 keeps the reference-exact diverse backbone,
    # pass 2 fills remaining row capacity with edges whose occluder is not
    # alpha-times closer. Where distances concentrate (high ambient dim,
    # e.g. GIST-960) the strict rule over-prunes and rows run far under
    # max_nbrs; alpha 1.15-1.3 densifies them without losing diversity.
    prune_alpha: float = 1.0
    # Mesh-sharded BUILD (parallel/build_sharded.py): > 1 builds one graph
    # with node rows sharded over a ("db",) mesh of this many devices —
    # NND rounds, pools, and prunes run SPMD with the data shards rotating
    # over ICI, so build-time HBM scales with chips (SURVEY §2c build
    # parallelism; the reference's multi-threaded HNSWBuilder analog).
    # Supported for raw/sq graph types (hnsw/nsg/fusion base layer);
    # requires at least this many JAX devices at fit time.
    build_shards: int = 1
    # ONE graph bigger than one chip's HBM (parallel/dist_graph.py): > 1
    # row-shards the raw slab over a ("db",) mesh of this many devices at
    # fit AND at serve — the adjacency (small, int32) replicates, the fat
    # vector payload shards, and the serving beam merges each hop's owned
    # candidate distances with one psum over ICI. Traversal is identical
    # to the single-chip beam, so recall parity is structural. Raw graph
    # indices (hnsw/nsg/fusion, quantization none); static after fit
    # (search/remove; growth is a refit — the reference's big-index u64
    # path is likewise fit-then-serve, dispatch.hpp:25-175).
    serve_shards: int = 1
    # when the tombstoned fraction of stored vectors exceeds this, remove()
    # triggers a batched edge rewire: every live node that lost a neighbor
    # re-selects edges through the removed nodes' 2-hop neighborhoods (the
    # reference's GraphUpdateJob::update applied lazily in bulk,
    # graph_update_job.hpp:105-137). 0 disables.
    compaction_threshold: float = 0.2

    def __post_init__(self) -> None:
        self.index_type = IndexType.parse(self.index_type)
        self.metric = MetricType.parse(self.metric)
        self.quantization_type = QuantizationType.parse(self.quantization_type)
        if self.data_type not in _VALID_DTYPES:
            raise ValueError(f"invalid data_type {self.data_type!r}; one of {_VALID_DTYPES}")
        if self.id_type not in _VALID_ID_TYPES:
            raise ValueError(f"invalid id_type {self.id_type!r}; one of {_VALID_ID_TYPES}")
        if self.storage_dtype not in ("float32", "bfloat16", "float16",
                                      "uint8", "int8"):
            raise ValueError(f"invalid storage_dtype {self.storage_dtype!r}")
        # integer data vectors (SIFT is u8) are stored in their native dtype
        # — the reference instantiates u8/i8 spaces end-to-end
        # (python/include/dispatch.hpp:25-175); here dtype is data, and the
        # MXU contraction upcasts losslessly. COS would need normalized
        # (fractional) storage, so it is rejected like any invalid combo.
        if self.data_type in ("uint8", "int8"):
            if self.metric is MetricType.COS:
                raise ValueError("cos metric requires float data_type "
                                 "(normalization is fractional)")
            if self.storage_dtype == "float32":
                self.storage_dtype = self.data_type
        if self.rotator not in ("matrix", "fht_kac"):
            raise ValueError(f"invalid rotator {self.rotator!r}")
        if int(self.capacity) <= 0:
            raise ValueError("capacity must be positive")
        # Device-side node ids are int32 (graph rows, pools, packed sort
        # payloads are i32 lanes — the TPU-native layout). The reference's
        # u64 template instantiation (dispatch.hpp:25-175) exists to exceed
        # 2³¹ nodes; one chip's HBM cannot hold that many vectors, so
        # beyond-int32 capacity must shard across chips (parallel/sharded)
        # rather than widen ids. Fail loudly instead of overflowing.
        if int(self.capacity) > 2**30 - 1:
            # the limit is the PACKED sort payload, not bare int32: the
            # top-k merge units pack id*2+flag into one int32 lane
            # (ops/topk.py), so PER-DEVICE ids must fit 30 bits + sign.
            # Sharded engines go beyond it: each shard's local ids stay in
            # range and the host-side global ids are int64 (the reference's
            # u64 template instantiation, dispatch.hpp:25-175) — so allow
            # any capacity whose per-shard slice fits, requiring a 64-bit
            # id_type once global ids can exceed int32.
            per_shard = -(-int(self.capacity) // max(1, int(self.db_shards)))
            if int(self.db_shards) <= 1 or per_shard > 2**30 - 1:
                raise ValueError(
                    "capacity exceeds the packed node-id range (2**30 - 1; "
                    "ids ride int32 sort lanes as id*2+flag) — shard the "
                    "database (db_shards) so each shard's slice fits")
            if (int(self.capacity) > 2**31 - 2
                    and self.id_type not in ("uint64", "int64")):
                raise ValueError(
                    "capacity beyond 2**31 - 2 rows needs a 64-bit id_type "
                    "(the reference's u64 dispatch, dispatch.hpp:25-175): "
                    "set id_type='int64' or 'uint64'")
        if int(self.max_nbrs) <= 0:
            raise ValueError("max_nbrs must be positive")
        self.capacity = int(self.capacity)
        self.max_nbrs = int(self.max_nbrs)
        self.ef_construction = int(self.ef_construction)
        self.beam_expand = max(1, int(self.beam_expand))
        self.search_iters = int(self.search_iters)
        self.seed_sample = int(self.seed_sample)
        self.rabitq_ef_boost = float(self.rabitq_ef_boost)
        if self.rabitq_ef_boost < 1.0:
            raise ValueError("rabitq_ef_boost must be >= 1.0")
        self.db_shards = int(self.db_shards)
        if self.db_shards < 1:
            raise ValueError("db_shards must be >= 1")
        self.build_shards = int(self.build_shards)
        if self.build_shards < 1:
            raise ValueError("build_shards must be >= 1")
        if self.build_shards > 1 and (
                self.index_type is IndexType.FLAT
                or self.quantization_type.is_block):
            raise ValueError(
                "build_shards > 1 applies to raw/sq graph builds "
                "(hnsw/nsg/fusion); flat has no graph and block (bsq8) "
                "builds are single-device (use db_shards to scale them)")
        if self.db_shards > 1:
            ok = (self.index_type is IndexType.FLAT
                  or self.quantization_type is QuantizationType.BSQ8)
            if not ok:
                raise ValueError(
                    "db_shards > 1 supports flat indices and block (bsq8) "
                    "graphs; other graph types replicate per chip "
                    "(dp_sharded_beam_search)")
        self.serve_shards = int(self.serve_shards)
        if self.serve_shards < 1:
            raise ValueError("serve_shards must be >= 1")
        if self.serve_shards > 1:
            if (self.index_type is IndexType.FLAT
                    or self.quantization_type is not QuantizationType.NONE):
                raise ValueError(
                    "serve_shards > 1 shards ONE raw graph (hnsw/nsg/"
                    "fusion, quantization none); use db_shards for flat/"
                    "bsq8 fan-out sharding")
            if self.db_shards > 1 or self.build_shards > 1:
                raise ValueError(
                    "serve_shards subsumes build_shards (it builds on the "
                    "same mesh) and is exclusive with db_shards")
        if self.flat_mode not in ("fast", "exact"):
            raise ValueError(f"invalid flat_mode {self.flat_mode!r}")

    # ---- persistence contract (reference: schema.py:58-68) ----
    def index_filename(self) -> str:
        return f"{self.index_type.value}_{self.metric.value}_{self.max_nbrs}.index"

    def data_filename(self) -> str:
        return "raw.data"

    def quant_filename(self) -> Optional[str]:
        if self.quantization_type is QuantizationType.NONE:
            return None
        return f"{self.quantization_type.value}.data"

    def to_dict(self) -> dict:
        return {
            "index_type": self.index_type.value,
            "data_type": self.data_type,
            "id_type": self.id_type,
            "quantization_type": self.quantization_type.value,
            "metric": self.metric.value,
            "capacity": self.capacity,
            "max_nbrs": self.max_nbrs,
            "storage_dtype": self.storage_dtype,
            "ef_construction": self.ef_construction,
            "beam_expand": self.beam_expand,
            "search_iters": self.search_iters,
            "seed_sample": self.seed_sample,
            "rabitq_ef_boost": self.rabitq_ef_boost,
            "db_shards": self.db_shards,
            "build_shards": self.build_shards,
            "serve_shards": self.serve_shards,
            "prune_alpha": self.prune_alpha,
            "rotator": self.rotator,
            "compaction_threshold": self.compaction_threshold,
            "flat_mode": self.flat_mode,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "IndexParams":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json(cls, s: str) -> "IndexParams":
        return cls.from_dict(json.loads(s))


def fill_none_values(params: Optional[dict] = None, **kwargs: Any) -> IndexParams:
    """Build IndexParams from a possibly-sparse dict, defaulting missing keys
    (reference behavior: schema.py:70-84)."""
    merged = dict(params or {})
    merged.update({k: v for k, v in kwargs.items() if v is not None})
    merged = {k: v for k, v in merged.items() if v is not None}
    return IndexParams.from_dict(merged)
