"""IndexEngine (port of part of ``index/engine.py``).

Ported: block quantization (bsq8: ``fit`` built by ``QGBuilder``, the
block branch of batch search, the per-query seed-scan sample, online
insert through ``fused_block_insert``, tombstone remove with the
compaction threshold, ``compact`` and ``update_nodes``; rabitq and
rabitq2, whose space shares the raw f32 slab, with the 1-bit search's
``rabitq_ef_boost`` and the host-orchestrated insert ``_insert_rabitq``),
the raw graph indices (``hnsw``, ``nsg``, ``fusion`` with quantization
none, sq8 or sq4 and any storage dtype: ``fit`` through their builders,
overlay descent + beam + exact re-score, and for sq the quantized
traversal re-ranked in the build space; insert through the search, the
append, ``fused_raw_connect`` and ``extend_overlay``, with the neighbor
search through a bsq8 shadow of the graph on large f32 indices; remove,
``compact`` with ``strip_overlay``, ``update_nodes``), the flat index
(``index_type="flat"`` with quantization none or sq8: exact and fast
scans, insert, tombstone remove), and save/load in the JAX package's
on-disk layout (``schema.json`` + npz files), so either package loads
the other's index directories, mutated or not.

Not ported yet, raising ``NotImplementedError``: sharding (ROADMAP queue
1, item 6) and flat + sq4.

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
from ..spaces.rabitq import RaBitQSpace
from ..spaces.raw import RawSpace
from ..spaces.sq import SQSpace
from .graph import Graph

log = logging.getLogger("alayalite_tpu_torch")

_FLAT_QUANT = (QuantizationType.NONE, QuantizationType.SQ8)
_GRAPH_QUANT = (QuantizationType.NONE, QuantizationType.SQ8,
                QuantizationType.SQ4)
INSERT_CHUNK = 4096   # rows per fused insert step (the search's qchunk)
REWIRE_CHUNK = 2048   # rows per rewire step: bounds the [A, W + W², D] gather
# A raw f32 graph index with at least this many stored rows searches an
# insert's neighbors through a bsq8 shadow of its graph (the JAX package's
# size gate; below it the pack costs more than the block search saves)
SHADOW_MIN_ROWS = 10_000
RESERVOIR = 16        # reverse-table slots per touched row of an insert


def check_supported(params: IndexParams) -> None:
    """Raise for the parts of IndexParams the port does not cover yet."""
    qt = params.quantization_type
    flat = params.index_type is IndexType.FLAT
    if not qt.is_block and qt not in (_FLAT_QUANT if flat else _GRAPH_QUANT):
        raise NotImplementedError(
            f"index_type={params.index_type.value!r} with quantization_type="
            f"{qt.value!r} is not ported: the port covers the block "
            "quantizations (bsq8, rabitq, rabitq2), graph indices with none, "
            "sq8 or sq4, and flat indices with none or sq8 (ROADMAP)")
    if max(params.db_shards, params.build_shards, params.serve_shards) > 1:
        raise NotImplementedError(
            "sharded indices are not ported yet (ROADMAP queue 1, item 6)")


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
        self._ins_shadow: Optional[BQGSpace] = None  # raw insert's search

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
        self._ins_shadow = None
        self.space = RawSpace.create(capacity, dim, metric=metric,
                                     storage_dtype=p.storage_dtype,
                                     device=self.device).fit(v)
        self._sscan = None
        if self._is_block:
            block = self._make_block_space(capacity, dim, v)
            del v
            from .qg import QGBuilder

            builder = QGBuilder(r=block.degree,
                                ef=max(p.ef_construction, 128),
                                alpha=float(p.prune_alpha))
            self.graph, self.search_space = builder.build_graph(self.space,
                                                                block, n)
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

    def _make_block_space(self, capacity: int, dim: int, v: torch.Tensor):
        """The block space of a fit: BQGSpace (bsq8, degree max_nbrs), or a
        RaBitQSpace (degree 32) over the raw space's slab where that is
        f32 (both hold the same normalize-then-store rows), else with its
        own f32 copy."""
        p = self.params
        metric = p.metric.value
        if p.quantization_type is QuantizationType.BSQ8:
            return BQGSpace.create(capacity, dim, metric=metric,
                                   degree=p.max_nbrs, device=self.device).fit(v)
        bits = 2 if p.quantization_type is QuantizationType.RABITQ2 else 1
        sp = self.space
        shared = sp.data.dtype == torch.float32
        rq = RaBitQSpace.create(
            capacity, dim, metric=metric, rotator=p.rotator, bits=bits,
            storage=((sp.data, sp.sq_norms, sp.valid, sp.num) if shared
                     else None), device=self.device)
        return rq if shared else rq.fit(v)

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
        if self.params.quantization_type is QuantizationType.RABITQ:
            # 1-bit estimates need ~4x the pool width for equal recall
            ef = max(ef, int(round(ef * self.params.rabitq_ef_boost)))
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
        return self.params.quantization_type.is_block

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
        index also links them into the graph (``fused_block_insert``), a
        raw graph index through ``_insert_raw_graph``. Returns the new ids,
        −1 where capacity was exhausted (``Index.insert`` raises)."""
        self._require_fitted()
        v = torch.atleast_2d(torch.as_tensor(
            np.asarray(vectors, dtype=np.float32), device=self.device))
        if self.params.quantization_type is QuantizationType.BSQ8:
            ids = self._insert_block_fused(v, ef)
        elif self._is_block:
            ids = self._insert_rabitq(v, ef)
        elif self.graph is not None:
            ids = self._insert_raw_graph(v, ef)
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

    def _insert_rabitq(self, v: torch.Tensor, ef: int) -> torch.Tensor:
        """rabitq insert, orchestrated from the host as in the JAX package
        (its re-quantization is relative to each block's centre node): the
        new rows' neighbors by the index's own search at max(ef, 32), the
        append, then the rows of every node the new rows point at
        re-selected from [its edges ∪ the new rows pointing at it] by exact
        distance (top 32, duplicates dropped), and one batched
        re-quantization of the new and the touched blocks."""
        ss = self.search_space
        r = ss.degree
        ids_nb, _ = self._batch_search_impl(v, r, ef=max(int(ef), r))
        new_ids = self.space.insert(v)
        if ss.data is self.space.data:
            ss.num = self.space.num      # the shared slab holds the rows
        else:
            ss.insert_raw(v)
        ok = new_ids >= 0
        if not bool(ok.any()):
            return new_ids
        src, rows = new_ids[ok], ids_nb[ok].to(torch.int32)
        touched, rev = _reverse_candidates(src, rows)
        all_ids, all_rows = [src], [rows]
        for lo in range(0, touched.shape[0], REWIRE_CHUNK):
            t = touched[lo:lo + REWIRE_CHUNK]
            cand = torch.cat([ss.nbr_ids[t.long()], rev[lo:lo + REWIRE_CHUNK]],
                             dim=1)
            cand = torch.where(cand == t[:, None], torch.full_like(cand, -1),
                               cand)
            d = self.space.gather_dists(self.space.data[t.long()].float(),
                                        cand.clamp(min=0))
            d = torch.where(cand >= 0, d, torch.full_like(d, float("inf")))
            all_ids.append(t)
            all_rows.append(_topr_dedup(d, cand, r))
        all_ids = torch.cat(all_ids).long()
        ss.set_neighbor_rows(all_ids, torch.cat(all_rows))
        self.graph.nbrs[all_ids] = ss.nbr_ids[all_ids]
        return new_ids

    def _insert_raw_graph(self, v: torch.Tensor, ef: int) -> torch.Tensor:
        """Raw graph insert in slices of ``INSERT_CHUNK`` rows, each seeing
        the slices before it: the neighbor search (through the bsq8 shadow
        where ``_shadow_auto_on``, else the index's own search, at
        ``max(ef, max_nbrs)``), the append into both spaces,
        ``fused_raw_connect`` at the row width (2·max_nbrs for fusion), the
        shadow's re-encode of the rows the connect wrote, and the overlay
        link of the new nodes that draw a level."""
        from .build_phases import make_generator
        from .fused_insert import fused_raw_connect
        from .overlay_update import extend_overlay

        if self._insert_gen is None:
            self._insert_gen = make_generator(self.device, 0x1A5E)
        r = self.params.max_nbrs
        row_w = self.graph.nbrs.shape[1]
        out = []
        for lo in range(0, v.shape[0], INSERT_CHUNK):
            sub = v[lo:lo + INSERT_CHUNK]
            shadow = self._ins_shadow
            if shadow is None and self._shadow_auto_on():
                shadow = self._ensure_ins_shadow()
            if shadow is not None:
                ids_nb = self._shadow_insert_search(shadow, sub, r,
                                                    ef=max(int(ef), r))
            else:
                ids_nb, _ = self._batch_search_impl(sub, r,
                                                    ef=max(int(ef), r))
            new_ids = self.space.insert(sub)
            if self.search_space is not self.space:
                self.search_space.insert(sub)
            ok = new_ids >= 0
            nrow = torch.where(ok[:, None], ids_nb.to(torch.int32),
                               torch.full_like(ids_nb, -1, dtype=torch.int32))
            slots = torch.randint(0, RESERVOIR, (sub.shape[0], row_w),
                                  generator=self._insert_gen,
                                  device=self.device)
            touched = fused_raw_connect(
                self.space, self.graph.nbrs, new_ids, nrow, slots,
                row_w=row_w, w=RESERVOIR)
            if shadow is not None:
                self._shadow_sync(shadow, torch.cat([new_ids, touched]))
            extend_overlay(self.graph, self.space, new_ids.cpu().numpy(),
                           self._rng, r)
            out.append(new_ids)
        return torch.cat(out)

    # ------------------------------------------- the raw insert's shadow
    def _shadow_auto_on(self) -> bool:
        """Search a raw graph insert's neighbors through a bsq8 shadow?
        Quantization none, f32 rows, a graph and at least
        ``SHADOW_MIN_ROWS`` stored rows (the JAX package's gate; its
        ALAYA_INSERT_SHADOW switch is fixed at its default)."""
        return (self.params.quantization_type is QuantizationType.NONE
                and self.graph is not None
                and self.space.data.dtype == torch.float32
                and self.space.num >= SHADOW_MIN_ROWS)

    def _ensure_ins_shadow(self) -> BQGSpace:
        """The insert shadow: a bsq8 block space over the current graph at
        its row width that shares the raw slab's tensors (no f32 copy);
        packed once, then kept in step by ``_shadow_sync``, and dropped by
        every other mutation."""
        from ..spaces.bqg import shadow_space

        if self._ins_shadow is None:
            sp = self.space
            self._ins_shadow = shadow_space(sp.data, sp.sq_norms, sp.valid,
                                            sp.num, sp.user_metric,
                                            self.graph.nbrs)
        return self._ins_shadow

    def _shadow_insert_search(self, shadow: BQGSpace, v: torch.Tensor,
                              r: int, ef: int) -> torch.Tensor:
        """The insert's neighbor search through the shadow: the block
        search with the seed-scan sample, whose exact re-rank of the pool
        gives the f32 path's candidate order. Returns ids [B, r]."""
        from .search import block_search_device

        _, i = block_search_device(
            shadow, self.graph.eps, shadow.prep_query(v), k=r, ef=ef,
            valid=self.space.valid, max_iters=self.params.search_iters,
            n_expand=self.params.beam_expand, qchunk=INSERT_CHUNK,
            seed_sample=self._seed_scan_arrays())
        return i

    def _shadow_sync(self, shadow: BQGSpace, ids: torch.Tensor) -> None:
        """After an append and a connect step: the shadow's bump counter
        (its rows, norms and valid mask are the raw space's own tensors)
        and the blocks of ``ids`` (−1 dropped), re-encoded from the
        adjacency."""
        from ..spaces.bqg import shadow_blocks_update

        shadow.num = self.space.num
        shadow_blocks_update(shadow, self.graph.nbrs, ids)

    def remove(self, ids) -> None:
        """Tombstone ``ids`` in both spaces; searches skip them. On a graph
        index, once the tombstones since the last compaction exceed
        ``params.compaction_threshold`` of the live rows, ``compact``
        rewires around them. Raises on ids out of [0, capacity): the spaces
        clip ids, so an out-of-range id would remove whatever lives at the
        clip target."""
        self._require_fitted()
        raw = np.atleast_1d(np.asarray(ids))
        if raw.size and (raw.min() < 0 or raw.max() >= self.space.capacity):
            raise ValueError(
                f"remove: id out of range [0, {self.space.capacity}) "
                f"(got min={raw.min()}, max={raw.max()})")
        self._mutations += 1
        self._ins_shadow = None   # its valid mask would be stale
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
        compaction, drop them from the overlay levels, and replace dead
        entry points with live rows. Ids are stable: removed slots stay
        tombstoned and are never reused."""
        from .overlay_update import strip_overlay

        self._require_fitted()
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
        strip_overlay(self.graph, removed)
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
        exact distance, R the block degree (bsq8 and rabitq, whose rebuilt
        rows are re-encoded in the same pass) or the row width (raw graphs:
        fusion rows are 2·max_nbrs). Every row is computed from the
        adjacency as it stands on entry."""
        self._require_fitted()
        if self.graph is None:
            raise RuntimeError("flat index has no graph to update")
        self._ins_shadow = None   # rows rewritten below
        ids = torch.as_tensor(ids, device=self.device).reshape(-1).long()
        if ids.numel() == 0:
            return
        removed = (np.empty(0, np.int32) if _removed is None
                   else np.asarray(_removed, dtype=np.int32))
        mask = self._removed_mask(removed)
        r = (self.search_space.degree if self._is_block
             else self.graph.nbrs.shape[1])
        rows = torch.cat([
            _rewire_rows_dev(self.space, self.graph.nbrs, mask,
                             ids[lo:lo + REWIRE_CHUNK], r=r)
            for lo in range(0, ids.numel(), REWIRE_CHUNK)])
        if self._is_block:
            self.search_space.set_neighbor_rows(ids, rows)
            rows = self.search_space.nbr_ids[ids]
        self.graph.nbrs[ids] = rows

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
    d = space.gather_dists(space.data[ids].float(), cand.clamp(min=0))
    d = torch.where(cand >= 0, d, torch.full_like(d, float("inf")))
    return _topr_dedup(d, cand, r)


def _reverse_candidates(src: torch.Tensor, rows: torch.Tensor):
    """Invert (source node → its edge row) into per-destination candidate
    lists: (touched [T] i32, ascending; rev [T, maxc] i32, −1 padded, the
    sources pointing at each, in source order)."""
    r = rows.shape[1]
    s = src.to(torch.int32).repeat_interleave(r)
    dst = rows.reshape(-1)
    keep = dst >= 0
    s, dst = s[keep], dst[keep]
    if not dst.numel():
        return (torch.empty(0, dtype=torch.int32, device=rows.device),
                torch.empty((0, 0), dtype=torch.int32, device=rows.device))
    dst_s, order = torch.sort(dst, stable=True)
    src_s = s[order]
    touched, counts = torch.unique_consecutive(dst_s, return_counts=True)
    start = torch.cumsum(counts, 0) - counts
    row = torch.repeat_interleave(torch.arange(touched.shape[0],
                                               device=rows.device), counts)
    pos = torch.arange(dst_s.shape[0], device=rows.device) - start[row]
    rev = torch.full((touched.shape[0], int(counts.max())), -1,
                     dtype=torch.int32, device=rows.device)
    rev[row, pos] = src_s
    return touched.to(torch.int32), rev


def _topr_dedup(cand_d: torch.Tensor, cand_i: torch.Tensor,
                r: int) -> torch.Tensor:
    """Top-r candidates by distance, duplicate ids dropped (keep-best)."""
    from .prune import _sort_dedup

    return _sort_dedup(cand_d, cand_i)[1][:, :r]
