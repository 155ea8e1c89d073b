"""IndexEngine (port of part of ``index/engine.py``).

Ported: block quantization (bsq8: ``fit`` built by ``QGBuilder``, the
block branch of batch search, the per-query seed-scan sample) and the flat
index (``index_type="flat"`` with quantization none or sq8: exact and fast
scans, insert, tombstone remove), and save/load in the JAX package's
on-disk layout (``schema.json`` + npz files), so either package loads the
other's index directories.

Not ported yet, each raising ``NotImplementedError``: raw and sq graph
indices (ROADMAP queue 1, items 8-9), other quantizations (item 9),
insert/remove/compact/update_nodes on block indices (item 7), sharding
(item 12).

Queries are searched in slices of ``qchunk`` rows (4096; 1024 at dim ≥ 512
on the block path) without padding the batch: the JAX package pads to
fixed buckets only so XLA does not recompile on new shapes.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, synchronize
from ..ops.distance import exact_topk, flat_search_device
from ..params import IndexParams, IndexType, QuantizationType
from ..spaces.bqg import BQGSpace
from ..spaces.raw import RawSpace
from ..spaces.sq import SQSpace
from .graph import Graph

log = logging.getLogger("alayalite_tpu_torch")

_FLAT_QUANT = (QuantizationType.NONE, QuantizationType.SQ8)


def check_supported(params: IndexParams) -> None:
    """Raise for the parts of IndexParams the port does not cover yet."""
    qt = params.quantization_type
    flat = params.index_type is IndexType.FLAT
    if qt is not QuantizationType.BSQ8 and not (flat and qt in _FLAT_QUANT):
        raise NotImplementedError(
            f"index_type={params.index_type.value!r} with quantization_type="
            f"{qt.value!r} is not ported yet: the port covers bsq8 and flat "
            "indices with none or sq8 (ROADMAP queue 1, items 8-9 hold raw "
            "and sq graphs, sq4 and rabitq)")
    if max(params.db_shards, params.build_shards, params.serve_shards) > 1:
        raise NotImplementedError(
            "sharded indices are not ported yet (ROADMAP queue 1, item 12)")
    if params.storage_dtype != "float32":
        raise NotImplementedError(
            f"storage_dtype={params.storage_dtype!r} is not ported yet "
            "(ROADMAP queue 1, item 8)")


class IndexEngine:
    """Host wrapper over device state (raw space, quantized space, graph)."""

    def __init__(self, params: IndexParams, device: DeviceLike = None):
        check_supported(params)
        self.params = params
        self.device = resolve_device(device)
        self.space: Optional[RawSpace] = None   # build / rerank / flat scan
        # the block space (bsq8), the SQSpace of a flat + sq8 index, or the
        # raw space itself
        self.search_space = None
        self.graph: Optional[Graph] = None     # None for a flat index
        self.build_timings: dict = {}
        self._fitted = False
        self._sscan = None
        self._sscan_version = None

    # ------------------------------------------------------------------ fit
    def fit(self, vectors, ef_construction: Optional[int] = None,
            num_threads: int = 1) -> None:
        """Build the index over ``vectors`` [n, dim]."""
        del num_threads
        v = torch.as_tensor(np.asarray(vectors, dtype=np.float32)
                            if not isinstance(vectors, torch.Tensor)
                            else vectors.float(), device=self.device)
        if v.dim() != 2:
            raise ValueError("fit expects a 2-D array [n, dim]")
        n, dim = v.shape
        capacity = max(self.params.capacity, n)
        if ef_construction:
            self.params.ef_construction = int(ef_construction)
        t0 = time.time()
        p = self.params
        metric = p.metric.value
        self.space = RawSpace.create(capacity, dim, metric=metric,
                                     device=self.device).fit(v)
        self._sscan = None
        if p.quantization_type is QuantizationType.BSQ8:
            bqg = BQGSpace.create(capacity, dim, metric=metric,
                                  degree=p.max_nbrs, device=self.device).fit(v)
            del v
            from .qg import QGBuilder

            builder = QGBuilder(r=p.max_nbrs, ef=max(p.ef_construction, 128),
                                alpha=float(p.prune_alpha))
            self.graph, self.search_space = builder.build_graph(self.space,
                                                                bqg, n)
            self.build_timings = dict(builder.timings)
        else:
            # flat: no graph; an sq8 index also builds and saves the codes,
            # but searches the raw rows, as the JAX package does
            self.graph = None
            self.search_space = (SQSpace.create(capacity, dim, metric=metric,
                                                device=self.device).fit(v)
                                 if p.quantization_type is
                                 QuantizationType.SQ8 else self.space)
        self._fitted = True
        synchronize(self.device)
        log.info("fit: n=%d dim=%d in %.2fs", n, dim, time.time() - t0)

    # --------------------------------------------------------------- search
    def _require_fitted(self):
        if not self._fitted:
            raise RuntimeError("index is not fitted")

    @property
    def _id_dtype(self):
        return (np.int64 if self.params.id_type in ("uint64", "int64")
                else np.int32)

    def batch_search_with_distance(self, queries, topk: int, ef: int = 100,
                                   num_threads: int = 1
                                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(ids [Q, topk] in the id_type width with −1 pad, dists f32)."""
        ids, d = self._batch_search_impl(queries, topk, ef, num_threads)
        return (ids.cpu().numpy().astype(self._id_dtype, copy=False),
                d.cpu().numpy())

    def _batch_search_impl(self, queries, topk: int, ef: int = 100,
                           num_threads: int = 1):
        """Device tensors (ids [Q, topk] i32, dists [Q, topk] f32)."""
        from .search import block_search_device

        del num_threads
        self._require_fitted()
        if isinstance(queries, torch.Tensor):
            q = queries.to(self.device, torch.float32)
        else:
            q = torch.as_tensor(np.asarray(queries, dtype=np.float32),
                                device=self.device)
        q = torch.atleast_2d(q)
        if self.params.index_type is IndexType.FLAT:
            return self._flat_search(q, topk)
        qchunk = 1024 if self.space.dim >= 512 else 4096
        ef = max(int(ef), int(topk))
        seed_arrays = self._seed_scan_arrays()
        if (seed_arrays is None and self.params.seed_sample <= 0
                and self.space.num >= 512
                and not getattr(self, "_warned_no_scan", False)):
            self._warned_no_scan = True
            log.warning(
                "seed_sample=0 disables the per-query seed scan on a block "
                "index whose graph was built with scan-seeded pools; expect "
                "degraded recall")
        d, i = block_search_device(
            self.search_space, self.graph.eps,
            self.search_space.prep_query(q), k=topk, ef=ef,
            valid=self.space.valid, max_iters=self.params.search_iters,
            n_expand=self.params.beam_expand, qchunk=qchunk,
            seed_sample=seed_arrays)
        if self.space.user_metric == "cos":
            # block spaces score squared L2 of normalized vectors (2 − 2cos);
            # return the −cos convention of every other path
            d = torch.where(torch.isfinite(d), d / 2.0 - 1.0, d)
        return i, d

    def batch_search(self, queries, topk: int, ef: int = 100,
                     num_threads: int = 1) -> np.ndarray:
        ids, _ = self.batch_search_with_distance(queries, topk, ef,
                                                 num_threads)
        return ids

    def search(self, query, topk: int, ef: int = 100) -> np.ndarray:
        return self.batch_search(np.atleast_2d(query), topk, ef)[0]

    def search_with_distance(self, query, topk: int, ef: int = 100):
        ids, d = self.batch_search_with_distance(np.atleast_2d(query), topk,
                                                 ef)
        return ids[0], d[0]

    def _flat_search(self, q: torch.Tensor, topk: int):
        """Brute-force scan of the live raw rows (a flat + sq8 index scans
        them too, as the JAX package does). Exact mode: one f32 pass
        through ``l2_tile`` (or the f32 product for ip/cos). Fast mode: bf16
        coarse scan keeping max(32, 4·topk) candidates, then an f32 rerank.
        The JAX package caches a padded copy of the slab for its fast mode
        (it pads to fixed shapes for XLA); the port scans the rows in place
        and reads the space's own norms, so there is nothing to cache."""
        sp = self.space
        n = sp.num
        qp = sp.prep_query(q)
        if self.params.flat_mode == "fast":
            d, i = flat_search_device(
                qp, sp.data[:n], sp.sq_norms[:n], sp.valid[:n], k=topk,
                metric=sp.metric, tile_n=min(65536, max(n, 1)),
                rerank=max(32, 4 * topk))
        else:
            d, i = exact_topk(qp, sp.data[:n], topk, metric=sp.metric,
                              valid=sp.valid[:n])
        return i, d

    def _seed_scan_arrays(self):
        """Cached (ids, vecs bf16, sq_norms) sample for the per-query seed
        scan: the same ids as the JAX package (numpy rng 0x5EED over the
        live rows). None below 256 rows or when params.seed_sample == 0."""
        from .search import seed_sample_arrays

        S = int(self.params.seed_sample)
        n = self.space.num
        if S <= 0 or n < 256:
            return None
        bucket = 1024 if n < 262_144 else 65_536
        version = ("exact", n) if n < 2048 else ("bucket", n // bucket)
        if self._sscan is None or self._sscan_version != version:
            live = np.flatnonzero(self.space.valid[:n].cpu().numpy())
            S = min(S, (live.size // 128) * 128)
            if S < 128:
                return None
            rng = np.random.default_rng(0x5EED)
            ids = torch.as_tensor(np.sort(rng.choice(live, size=S,
                                                     replace=False))
                                  .astype(np.int32), device=self.device)
            self._sscan = seed_sample_arrays(self.space.data, ids,
                                             self.space.user_metric)
            self._sscan_version = version
        return self._sscan

    # --------------------------------------------------------------- update
    def _require_flat(self, op: str) -> None:
        if self.params.quantization_type.is_block:
            raise NotImplementedError(
                f"{op} on a block index is not ported yet (ROADMAP queue 1, "
                "item 7)")

    def insert(self, vectors, ef: int = 100) -> np.ndarray:
        """Append rows to a flat index (both spaces). Returns the new ids,
        −1 where capacity was exhausted (``Index.insert`` raises)."""
        del ef
        self._require_flat("insert")
        self._require_fitted()
        v = torch.atleast_2d(torch.as_tensor(
            np.asarray(vectors, dtype=np.float32), device=self.device))
        ids = self.space.insert(v)
        if self.search_space is not self.space:
            self.search_space.insert(v)
        return ids.cpu().numpy().astype(self._id_dtype, copy=False)

    def remove(self, ids) -> None:
        """Tombstone ``ids`` in both spaces of a flat index; searches skip
        them. Raises on ids out of [0, capacity): the spaces clip ids, so an
        out-of-range id would remove whatever lives at the clip target."""
        self._require_flat("remove")
        self._require_fitted()
        raw = np.atleast_1d(np.asarray(ids))
        if raw.size and (raw.min() < 0 or raw.max() >= self.space.capacity):
            raise ValueError(
                f"remove: id out of range [0, {self.space.capacity}) "
                f"(got min={raw.min()}, max={raw.max()})")
        arr = torch.as_tensor(raw.astype(np.int32), device=self.device)
        self.space.remove(arr)
        if self.search_space is not self.space:
            self.search_space.remove(arr)

    def get_data_by_id(self, id_: int) -> np.ndarray:
        self._require_fitted()
        return self.space.data[int(id_)].float().cpu().numpy()

    @property
    def num(self) -> int:
        return self.space.num if self.space is not None else 0

    @property
    def capacity(self) -> int:
        return (self.space.capacity if self.space is not None
                else self.params.capacity)

    # ---------------------------------------------------------- persistence
    def save(self, directory: Union[str, os.PathLike]) -> None:
        """schema.json + npz files, the JAX package's layout."""
        self._require_fitted()
        os.makedirs(directory, exist_ok=True)
        p = self.params
        with open(os.path.join(directory, "schema.json"), "w") as f:
            f.write(p.to_json())
        np.savez(os.path.join(directory, p.data_filename() + ".npz"),
                 **self.space.save_arrays())
        if self.graph is not None:
            np.savez(os.path.join(directory, p.index_filename() + ".npz"),
                     **self.graph.save_arrays())
        qf = p.quant_filename()
        if qf is not None and self.search_space is not self.space:
            np.savez(os.path.join(directory, qf + ".npz"),
                     **self.search_space.save_arrays())

    @classmethod
    def load(cls, directory: Union[str, os.PathLike],
             device: DeviceLike = None) -> "IndexEngine":
        """Load an index directory written by either package; the graph and
        quantized-space files are read where they exist."""
        from ..convert import from_jax_arrays

        with open(os.path.join(directory, "schema.json")) as f:
            params_json = f.read()
        params = IndexParams.from_json(params_json)

        def arrays(name):
            if name is None:
                return None
            path = os.path.join(directory, name + ".npz")
            if not os.path.exists(path):
                return None
            with np.load(path, allow_pickle=False) as z:
                return dict(z.items())

        check_supported(params)
        return from_jax_arrays(params_json,
                               arrays(params.data_filename()),
                               arrays(params.index_filename()),
                               arrays(params.quant_filename()), device)
