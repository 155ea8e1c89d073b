"""IndexEngine (port of part of ``index/engine.py``).

Ported: block quantization (bsq8: ``fit`` built by ``QGBuilder``, the
block branch of batch search, the per-query seed-scan sample, online
insert through ``fused_block_insert``, tombstone remove with the
compaction threshold, ``compact`` and ``update_nodes``), the raw graph
indices (``hnsw``, ``nsg``, ``fusion`` with quantization none, sq8 or sq4:
``fit`` through their builders, overlay descent + beam + exact re-score,
and for sq the quantized traversal re-ranked in the build space), the flat
index (``index_type="flat"`` with quantization none or sq8: exact and fast
scans, insert, tombstone remove), and save/load in the JAX package's
on-disk layout (``schema.json`` + npz files), so either package loads the
other's index directories, mutated or not.

Not ported yet, each raising ``NotImplementedError``: insert, remove,
compact and update_nodes on a raw graph index (ROADMAP queue 1, item 8),
rabitq (item 9, with its host-side insert), sharding (item 12).

Inserts and rewires run on batches of any size, in slices that bound the
temporaries: the JAX package pads them to buckets only so XLA does not
recompile.

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
from ..spaces.raw import STORAGE_DTYPES, RawSpace
from ..spaces.sq import SQSpace
from .graph import Graph

log = logging.getLogger("alayalite_tpu_torch")

_FLAT_QUANT = (QuantizationType.NONE, QuantizationType.SQ8)
_GRAPH_QUANT = (QuantizationType.NONE, QuantizationType.SQ8,
                QuantizationType.SQ4)
_RAW_MUTATION = ("{} on a raw graph index (hnsw, nsg, fusion with "
                 "quantization none, sq8 or sq4) is not ported yet (ROADMAP "
                 "queue 1, item 8: fused_raw_connect, the bsq8 insert shadow, "
                 "overlay_update)")
INSERT_CHUNK = 4096   # rows per fused insert step (the search's qchunk)
REWIRE_CHUNK = 2048   # rows per rewire step: bounds the [A, W + W², D] gather


def check_supported(params: IndexParams) -> None:
    """Raise for the parts of IndexParams the port does not cover yet."""
    qt = params.quantization_type
    flat = params.index_type is IndexType.FLAT
    if qt is not QuantizationType.BSQ8 and qt not in (
            _FLAT_QUANT if flat else _GRAPH_QUANT):
        raise NotImplementedError(
            f"index_type={params.index_type.value!r} with quantization_type="
            f"{qt.value!r} is not ported yet: the port covers bsq8, graph "
            "indices with none, sq8 or sq4, and flat indices with none or "
            "sq8 (ROADMAP queue 1, item 9 holds rabitq)")
    if max(params.db_shards, params.build_shards, params.serve_shards) > 1:
        raise NotImplementedError(
            "sharded indices are not ported yet (ROADMAP queue 1, item 12)")
    if params.storage_dtype not in STORAGE_DTYPES:
        raise NotImplementedError(
            f"storage_dtype={params.storage_dtype!r} is not ported yet "
            "(ROADMAP queue 1, item 8: integer and float16 storage)")


def _make_builder(params: IndexParams, seed: int = 0):
    from .fusion import FusionGraphBuilder
    from .hnsw import HNSWBuilder
    from .nsg import NSGBuilder

    r, l, a = params.max_nbrs, params.ef_construction, float(params.prune_alpha)
    if params.index_type is IndexType.HNSW:
        return HNSWBuilder(r=r, l=l, seed=seed, alpha=a)
    if params.index_type is IndexType.NSG:
        return NSGBuilder(r=r, l=max(l // 2, 64), seed=seed, alpha=a)
    if params.index_type is IndexType.FUSION:
        return FusionGraphBuilder(r=r, l=l, seed=seed, alpha=a)
    raise ValueError(f"no graph builder for {params.index_type}")


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
        self._mutations = 0          # removes so far (seed-sample version)
        self._removed: list = []     # tombstones since the last compaction
        self._rng = np.random.default_rng(0xA1A7A)  # entry-point redraws
        self._insert_gen: Optional[torch.Generator] = None

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
                                     storage_dtype=p.storage_dtype,
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
            bits = {QuantizationType.SQ8: 8,
                    QuantizationType.SQ4: 4}.get(p.quantization_type)
            # an sq index encodes the rows; a graph walks the codes and
            # re-ranks in the raw space, a flat index scans the raw rows
            # (and saves the codes), as the JAX package does
            self.search_space = (self.space if bits is None else
                                 SQSpace.create(capacity, dim, bits=bits,
                                                metric=metric,
                                                device=self.device).fit(v))
            del v
            self.graph = None
            if p.index_type is not IndexType.FLAT:
                builder = _make_builder(p)
                self.graph = builder.build_graph(self.space, n)
                self.build_timings = dict(builder.timings)
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
        ef = max(int(ef), int(topk))
        if not self._is_block:
            return self._graph_search(q, topk, ef)
        qchunk = 1024 if self.space.dim >= 512 else 4096
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

    @property
    def _is_block(self) -> bool:
        return self.params.quantization_type is QuantizationType.BSQ8

    def _graph_search(self, q: torch.Tensor, topk: int, ef: int):
        """Raw graph search. Raw space: descent, beam and exact re-score of
        the k results. sq space: the walk keeps a pool of ``ef`` ids by the
        quantized distance, re-ranked exactly in the build space."""
        from .search import exact_rescore, graph_search_device

        g, p = self.graph, self.params
        kw = dict(max_iters=p.search_iters, valid=self.space.valid,
                  n_expand=p.beam_expand)
        if self.search_space is self.space:
            d, i = graph_search_device(self.space, g.nbrs, g.eps, g.overlay,
                                       self.space.prep_query(q), k=topk,
                                       ef=ef, **kw)
            return i, d
        _, pool = graph_search_device(self.search_space, g.nbrs, g.eps,
                                      g.overlay,
                                      self.search_space.prep_query(q), k=ef,
                                      ef=ef, exact_rerank=False, **kw)
        d, i = exact_rescore(self.space, self.space.prep_query(q), pool, topk)
        return i, d

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
        version = (("exact", n) if n < 2048 else ("bucket", n // bucket),
                   self._mutations)
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
    def insert(self, vectors, ef: int = 100) -> np.ndarray:
        """Append rows. A flat index stores them in both spaces; a block
        index also links them into the graph (``fused_block_insert``).
        Returns the new ids, −1 where capacity was exhausted
        (``Index.insert`` raises)."""
        self._require_fitted()
        self._refuse_raw_mutation("insert")
        v = torch.atleast_2d(torch.as_tensor(
            np.asarray(vectors, dtype=np.float32), device=self.device))
        if self.graph is not None:
            ids = self._insert_block_fused(v, ef)
        else:
            ids = self.space.insert(v)
            if self.search_space is not self.space:
                self.search_space.insert(v)
        return ids.cpu().numpy().astype(self._id_dtype, copy=False)

    def _insert_block_fused(self, v: torch.Tensor, ef: int) -> torch.Tensor:
        """bsq8 insert in slices of ``INSERT_CHUNK`` rows; each slice is one
        ``fused_block_insert`` step and sees the slices before it. The raw
        space mirrors the same bump slots."""
        from .build_phases import make_generator
        from .fused_insert import fused_block_insert

        if self._insert_gen is None:
            self._insert_gen = make_generator(self.device, 0x1A5E)
        r = self.search_space.degree
        out = []
        for lo in range(0, v.shape[0], INSERT_CHUNK):
            sub = v[lo:lo + INSERT_CHUNK]
            out.append(fused_block_insert(
                self.search_space, self.graph.nbrs, self.graph.eps, sub,
                self._insert_gen, self._seed_scan_arrays(), r=r, w=16,
                ef=max(int(ef), r), iters=0, m=self.params.beam_expand))
            self.space.insert(sub)
        return torch.cat(out)

    def _refuse_raw_mutation(self, what: str) -> None:
        if self.graph is not None and not self._is_block:
            raise NotImplementedError(_RAW_MUTATION.format(what))

    def remove(self, ids) -> None:
        """Tombstone ``ids`` in both spaces; searches skip them. On a graph
        index, once the tombstones since the last compaction exceed
        ``params.compaction_threshold`` of the live rows, ``compact``
        rewires around them. Raises on ids out of [0, capacity): the spaces
        clip ids, so an out-of-range id would remove whatever lives at the
        clip target."""
        self._require_fitted()
        self._refuse_raw_mutation("remove")
        raw = np.atleast_1d(np.asarray(ids))
        if raw.size and (raw.min() < 0 or raw.max() >= self.space.capacity):
            raise ValueError(
                f"remove: id out of range [0, {self.space.capacity}) "
                f"(got min={raw.min()}, max={raw.max()})")
        self._mutations += 1
        arr = torch.as_tensor(raw.astype(np.int32), device=self.device)
        self.space.remove(arr)
        if self.search_space is not self.space:
            self.search_space.remove(arr)
        if self.graph is None:
            return
        self._removed.extend(int(x) for x in raw)
        thr = float(self.params.compaction_threshold)
        if thr <= 0 or not self._removed:
            return
        live = int(self.space.valid[:self.space.num].sum())
        if len(self._removed) > thr * max(live, 1):
            self.compact()

    def compact(self) -> None:
        """Rewire edges around the tombstones gathered since the last
        compaction and replace dead entry points with live rows. Ids are
        stable: removed slots stay tombstoned and are never reused."""
        self._require_fitted()
        self._refuse_raw_mutation("compact")
        if self.graph is None or not self._removed:
            self._removed = []
            return
        removed = np.unique(np.asarray(self._removed, dtype=np.int32))
        mask = self._removed_mask(removed)
        nbrs = self.graph.nbrs
        hit = ((nbrs >= 0) & mask[nbrs.clamp(min=0).long()]).any(1) & ~mask
        affected = torch.nonzero(hit).reshape(-1).to(torch.int32)
        t0 = time.time()
        if affected.numel():
            self.update_nodes(affected, _removed=removed)
        eps = self.graph.eps.cpu().numpy()
        dead_ep = np.isin(eps, removed)
        if dead_ep.any():
            pool = np.flatnonzero(self.space.valid.cpu().numpy())
            if pool.size:
                fresh = self._rng.choice(pool, size=eps.shape[0])
                self.graph.eps = torch.as_tensor(
                    np.where(dead_ep, fresh, eps).astype(np.int32),
                    device=self.device)
        log.info("compact: %d tombstones, %d nodes rewired in %.2fs",
                 removed.size, affected.numel(), time.time() - t0)
        self._removed = []

    def _removed_mask(self, removed: np.ndarray) -> torch.Tensor:
        mask = torch.zeros((self.graph.capacity,), dtype=torch.bool,
                           device=self.device)
        if removed.size:
            mask[torch.as_tensor(removed.astype(np.int64),
                                 device=self.device)] = True
        return mask

    def update_nodes(self, ids, _removed=None) -> None:
        """Rebuild the edges of ``ids``: candidates = live current edges ∪
        the live edges of removed neighbors (the 2-hop detour), top-R by
        exact distance; the rebuilt rows are re-encoded in the same pass.
        Every row is computed from the adjacency as it stands on entry."""
        self._require_fitted()
        self._refuse_raw_mutation("update_nodes")
        if self.graph is None:
            raise RuntimeError("flat index has no graph to update")
        ids = torch.as_tensor(ids, device=self.device).reshape(-1).long()
        if ids.numel() == 0:
            return
        removed = (np.empty(0, np.int32) if _removed is None
                   else np.asarray(_removed, dtype=np.int32))
        mask = self._removed_mask(removed)
        r = self.search_space.degree
        rows = torch.cat([
            _rewire_rows_dev(self.space, self.graph.nbrs, mask,
                             ids[lo:lo + REWIRE_CHUNK], r=r)
            for lo in range(0, ids.numel(), REWIRE_CHUNK)])
        self.search_space.set_neighbor_rows(ids, rows)
        self.graph.nbrs[ids] = self.search_space.nbr_ids[ids]

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


def _rewire_rows_dev(space, nbrs: torch.Tensor, removed_mask: torch.Tensor,
                     ids: torch.Tensor, r: int) -> torch.Tensor:
    """Rebuilt rows [A, r] for ``ids`` [A] from the adjacency ``nbrs``:
    live current edges ∪ removed neighbors' live edges, exact top-r with
    keep-best dedup. The [A, W + W²] candidate table is mostly −1 (only
    removed neighbors open a second hop), so it is compacted to its widest
    row before the distance gather; −1 slots score inf either way."""
    a = ids.shape[0]
    cur = nbrs[ids]                                            # [A, W]
    rem = removed_mask[cur.clamp(min=0).long()]
    is_live = (cur >= 0) & ~rem
    is_rem = (cur >= 0) & rem
    hop2 = nbrs[torch.where(is_rem, cur, torch.zeros_like(cur)).long()]
    ok2 = (is_rem[:, :, None] & (hop2 >= 0)
           & ~removed_mask[hop2.clamp(min=0).long()])          # [A, W, W]
    cand = torch.cat([torch.where(is_live, cur, torch.full_like(cur, -1)),
                      torch.where(ok2, hop2, torch.full_like(hop2, -1))
                      .reshape(a, -1)], dim=1)
    cand = torch.where(cand == ids[:, None].to(cand.dtype),
                       torch.full_like(cand, -1), cand)
    width = max(int((cand >= 0).sum(1).max()), r)
    order = torch.sort((cand < 0).to(torch.int8), dim=1, stable=True).indices
    cand = torch.gather(cand, 1, order[:, :width])
    d = space.gather_dists(space.data[ids], cand.clamp(min=0))
    d = torch.where(cand >= 0, d, torch.full_like(d, float("inf")))
    return _topr_dedup(d, cand, r)


def _topr_dedup(cand_d: torch.Tensor, cand_i: torch.Tensor,
                r: int) -> torch.Tensor:
    """Top-r candidates by distance, duplicate ids dropped (keep-best)."""
    from .prune import _sort_dedup

    return _sort_dedup(cand_d, cand_i)[1][:, :r]
