"""IndexEngine (port of part of ``index/engine.py``).

Ported: ``fit`` for block quantization (bsq8, built by ``QGBuilder``), the
block branch of batch search, the per-query seed-scan sample, and
save/load in the JAX package's on-disk layout (``schema.json`` + npz
files), so either package loads the other's index directories.

Not ported yet, each raising ``NotImplementedError``: other index types and
quantizations (ROADMAP queue 1, items 8-10), insert/remove/compact/
update_nodes (item 7), sharding (item 12).

Queries are searched in slices of ``qchunk`` rows (4096; 1024 at dim ≥ 512)
without padding the batch: the JAX package pads to fixed buckets only so
XLA does not recompile on new shapes.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, synchronize
from ..params import IndexParams, QuantizationType
from ..spaces.bqg import BQGSpace
from ..spaces.raw import RawSpace
from .graph import Graph

log = logging.getLogger("alayalite_tpu_torch")


def check_supported(params: IndexParams) -> None:
    """Raise for the parts of IndexParams this slice does not port."""
    if params.quantization_type is not QuantizationType.BSQ8:
        raise NotImplementedError(
            f"quantization_type={params.quantization_type.value!r} is not "
            "ported yet: the port covers bsq8 (ROADMAP queue 1, items 8-10 "
            "hold raw graphs, sq/rabitq and flat)")
    if max(params.db_shards, params.build_shards, params.serve_shards) > 1:
        raise NotImplementedError(
            "sharded indices are not ported yet (ROADMAP queue 1, item 12)")
    if params.storage_dtype != "float32":
        raise NotImplementedError(
            f"storage_dtype={params.storage_dtype!r} is not ported yet "
            "(ROADMAP queue 1, item 8)")


class IndexEngine:
    """Host wrapper over device state (raw space, block space, graph)."""

    def __init__(self, params: IndexParams, device: DeviceLike = None):
        check_supported(params)
        self.params = params
        self.device = resolve_device(device)
        self.space: Optional[RawSpace] = None          # build / rerank space
        self.search_space: Optional[BQGSpace] = None   # block space
        self.graph: Optional[Graph] = None
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
        self.space = RawSpace.create(capacity, dim, metric=p.metric.value,
                                     device=self.device).fit(v)
        bqg = BQGSpace.create(capacity, dim, metric=p.metric.value,
                              degree=p.max_nbrs, device=self.device).fit(v)
        del v
        from .qg import QGBuilder

        builder = QGBuilder(r=p.max_nbrs, ef=max(p.ef_construction, 128),
                            alpha=float(p.prune_alpha))
        self.graph, self.search_space = builder.build_graph(self.space, bqg, n)
        self.build_timings = dict(builder.timings)
        self._sscan = None
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

    # ------------------------------------------------------- not ported yet
    def insert(self, vectors, ef: int = 100):
        raise NotImplementedError(
            "insert is not ported yet (ROADMAP queue 1, item 7)")

    def remove(self, ids) -> None:
        raise NotImplementedError(
            "remove is not ported yet (ROADMAP queue 1, item 7)")

    def get_data_by_id(self, id_: int) -> np.ndarray:
        self._require_fitted()
        return self.space.data[int(id_)].float().cpu().numpy()

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
        np.savez(os.path.join(directory, p.index_filename() + ".npz"),
                 **self.graph.save_arrays())
        np.savez(os.path.join(directory, p.quant_filename() + ".npz"),
                 **self.search_space.save_arrays())

    @classmethod
    def load(cls, directory: Union[str, os.PathLike],
             device: DeviceLike = None) -> "IndexEngine":
        """Load an index directory written by either package."""
        from ..convert import from_jax_arrays

        with open(os.path.join(directory, "schema.json")) as f:
            params_json = f.read()
        params = IndexParams.from_json(params_json)

        def arrays(name):
            with np.load(os.path.join(directory, name + ".npz"),
                         allow_pickle=False) as z:
                return dict(z.items())

        check_supported(params)
        return from_jax_arrays(params_json,
                               arrays(params.data_filename()),
                               arrays(params.index_filename()),
                               arrays(params.quant_filename()), device)
