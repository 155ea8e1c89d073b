"""ShardedEngine: the db-sharded index behind the SDK (port of
``parallel/engine_sharded.py``).

``IndexParams(db_shards=N)`` makes ``Index`` / ``Client`` create, save,
load, insert into and remove from a row-partitioned index with the same
``schema.json`` + npz layout: N single-device ``IndexEngine`` shards own
mutation; search fans out over a ("dp"=1, "db"=N) mesh with one top-k merge
(``db_sharded_flat_search`` / ``db_sharded_block_search``). With fewer
devices than shards (``utils.platforms.devices``), search runs the shards
one after another and merges on the host: on one card that is the path the
SDK takes, as the JAX package does on one chip. Both run the kernels on the
shards' device.

Ids: an explicit global ⇄ (shard, local) map keeps global ids the row
positions at fit (0..n-1) and growing across inserts, whichever shard took
the row. The mesh path returns combined ids ``s * per_cap + local`` (every
shard has the same capacity), which ``_remap`` turns into global ids.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..params import IndexParams, IndexType, QuantizationType

log = logging.getLogger("alayalite_tpu_torch")

_MAPFILE = "shard_map.npz"

# single-engine packed-id ceiling (the params capacity guard): beyond this
# a sharded engine allocates its per-shard slabs on demand
_PACKED_ID_MAX = 2**30 - 1


class _GidMap:
    """global id → (shard, local). Dense arrays cover the contiguous ids
    from zero (grown by doubling while new ids stay within twice the
    window); ids far beyond it spill to a dict, so the map costs memory in
    proportion to the rows that exist, not to the id counter."""

    def __init__(self, n: int = 0):
        self.s = np.full(n, -1, np.int32)
        self.l = np.full(n, -1, np.int32)
        self.over: dict = {}

    def set_many(self, gids: np.ndarray, shard, locals_) -> None:
        gids = np.asarray(gids, dtype=np.int64)
        if gids.size == 0:
            return
        shard = np.broadcast_to(np.asarray(shard, np.int32), gids.shape)
        locals_ = np.broadcast_to(np.asarray(locals_, np.int32), gids.shape)
        hi = int(gids.max())
        if hi >= self.s.size:
            want = hi + 1
            if want <= max(2 * self.s.size, 1 << 20):
                new = max(want, 2 * self.s.size, 1 << 12)  # amortized O(1)
                grown_s = np.full(new, -1, np.int32)
                grown_l = np.full(new, -1, np.int32)
                grown_s[: self.s.size] = self.s
                grown_l[: self.l.size] = self.l
                self.s, self.l = grown_s, grown_l
        dense = gids < self.s.size
        self.s[gids[dense]] = shard[dense]
        self.l[gids[dense]] = locals_[dense]
        for g, sh, lc in zip(gids[~dense].tolist(), shard[~dense].tolist(),
                             locals_[~dense].tolist()):
            self.over[g] = (sh, lc)

    def lookup(self, gids: np.ndarray):
        """→ (shard i32, local i32), −1 where unknown."""
        gids = np.asarray(gids, dtype=np.int64)
        ss = np.full(gids.shape, -1, np.int32)
        ll = np.full(gids.shape, -1, np.int32)
        dense = (gids >= 0) & (gids < self.s.size)
        ss[dense] = self.s[gids[dense]]
        ll[dense] = self.l[gids[dense]]
        if self.over:
            for i in np.nonzero(gids >= self.s.size)[0].tolist():
                ss[i], ll[i] = self.over.get(int(gids[i]), (-1, -1))
        return ss, ll

    def state(self) -> dict:
        og = np.fromiter(self.over.keys(), np.int64, len(self.over))
        ov = np.array([self.over[g] for g in og], np.int32).reshape(-1, 2)
        return {"g2s": self.s, "g2l": self.l,
                "over_gids": og, "over_vals": ov}

    @classmethod
    def from_state(cls, z) -> "_GidMap":
        m = cls(0)
        m.s = np.asarray(z["g2s"], np.int32)
        m.l = np.asarray(z["g2l"], np.int32)
        if "over_gids" in z:
            og = np.asarray(z["over_gids"], np.int64)
            ov = np.asarray(z["over_vals"], np.int32).reshape(-1, 2)
            m.over = {int(g): (int(s), int(l)) for g, (s, l) in zip(og, ov)}
        return m


class ShardedEngine:
    """Same surface as ``index.engine.IndexEngine``."""

    def __init__(self, params: IndexParams, device: DeviceLike = None):
        if params.db_shards < 2:
            raise ValueError("ShardedEngine requires db_shards >= 2")
        self.params = params
        self.device = resolve_device(device)
        self.ndb = int(params.db_shards)
        self.per_cap = -(-params.capacity // self.ndb)
        # beyond the single-engine packed-id range the capacity is virtual:
        # per-shard slabs are sized on demand at fit (2x headroom)
        self._lazy = self.per_cap > 0 and params.capacity > _PACKED_ID_MAX
        self.shards: List = [self._make_shard() for _ in range(self.ndb)]
        self._fitted = False
        self._l2g: List[np.ndarray] = [np.full(0, -1, np.int64)
                                       for _ in range(self.ndb)]
        self._gid_map = _GidMap(0)
        self._next_gid = 0
        self._leaves = None          # cached per-shard search state
        self._leaves_key = None
        self._l2g_flat_cache = None
        self.fit_seconds: List[float] = []  # per shard, at the last fit

    def _make_shard(self, alloc_cap: Optional[int] = None):
        from ..index.engine import IndexEngine

        cap = alloc_cap if alloc_cap is not None else (
            min(self.per_cap, 4096) if self._lazy else self.per_cap)
        p = dataclasses.replace(self.params, capacity=cap, db_shards=1)
        return IndexEngine(p, device=self.device)

    # ------------------------------------------------------------------ fit
    def fit(self, vectors, ef_construction: Optional[int] = None,
            num_threads: int = 1) -> None:
        del num_threads
        v = np.asarray(vectors.cpu() if isinstance(vectors, torch.Tensor)
                       else vectors, dtype=np.float32)
        if v.ndim != 2:
            raise ValueError("fit expects a 2-D array [n, dim]")
        n = v.shape[0]
        if n > self.ndb * self.per_cap:
            self.per_cap = -(-n // self.ndb)
            self.shards = [self._make_shard() for _ in range(self.ndb)]
        if n < self.ndb:
            raise ValueError(
                f"fit of {n} vectors cannot fill db_shards={self.ndb} "
                "shards; lower db_shards or fit more vectors")
        # contiguous balanced chunks: global id == row position
        chunks = np.array_split(v, self.ndb)
        if self._lazy:
            # demand-sized equal slabs: fitted rows + 2x insert headroom
            alloc = min(self.per_cap,
                        max(2 * max(c.shape[0] for c in chunks), 4096))
            self.shards = [self._make_shard(alloc) for _ in range(self.ndb)]
        # a refit resets the id maps: stale rows of an earlier fit must not
        # let remove(old_gid) tombstone a live row of the new index
        self._gid_map = _GidMap(n)
        self._l2g = [np.full(0, -1, np.int64) for _ in range(self.ndb)]
        off = 0
        self.fit_seconds = []
        for s, rows in enumerate(chunks):
            t = time.time()
            self.shards[s].fit(rows, ef_construction=ef_construction)
            self.fit_seconds.append(time.time() - t)
            self._register_fit_chunk(s, rows.shape[0], off)
            off += rows.shape[0]
        self._next_gid = n
        self._fitted = True
        self._leaves = None

    def _register_fit_chunk(self, s: int, n_rows: int, off: int) -> None:
        """Record shard s's fitted rows as global ids off..off+n_rows-1
        (shared with ``parallel.multihost.fit_shards_from_file``)."""
        gids = off + np.arange(n_rows, dtype=np.int64)
        self._l2g[s] = np.full(self.shards[s].space.capacity, -1, np.int64)
        self._l2g[s][:n_rows] = gids
        self._gid_map.set_many(gids, s, np.arange(n_rows, dtype=np.int32))
        self._l2g_flat_cache = None

    # --------------------------------------------------------------- search
    def _require_fitted(self):
        if not self._fitted:
            raise RuntimeError("index is not fitted")

    @property
    def _id_dtype(self):
        return (np.int64 if self.params.id_type in ("uint64", "int64")
                else np.int32)

    def _mesh(self):
        """("dp"=1, "db"=ndb) mesh when enough devices of the engine's kind
        exist, else None."""
        from ..utils import platforms
        from .sharded import make_mesh

        devs = platforms.devices(self.device.type)
        if len(devs) < self.ndb:
            return None
        return make_mesh(n_devices=self.ndb, dp=1, devices=devs)

    def _assemble_leaves(self, mesh):
        """The shards' search arrays as per-shard lists on the mesh's "db"
        devices (``.to``: no copy where a shard already sits there), cached
        until a shard mutates. The JAX package concatenates them under a
        NamedSharding; the port keeps the list."""
        from .sharded import ShardedSpace, _eps8, block_leaves

        devs = mesh.axis_devices("db")
        key = (tuple(devs),
               tuple(getattr(sh, "_mutations", 0) for sh in self.shards))
        if self._leaves is not None and self._leaves_key == key:
            return self._leaves
        if self.params.index_type is IndexType.FLAT:
            sp0 = self.shards[0].space
            self._leaves = ShardedSpace(
                data=[[sh.space.data.to(d) for sh, d in zip(self.shards,
                                                             devs)]],
                sq_norms=[[sh.space.sq_norms.to(d)
                           for sh, d in zip(self.shards, devs)]],
                valid=[[sh.space.valid.to(d)
                        for sh, d in zip(self.shards, devs)]],
                metric=sp0.metric, user_metric=sp0.user_metric)
        else:  # block (bsq8)
            cols = [[] for _ in range(9)]
            for sh, d in zip(self.shards, devs):
                eps = _eps8(sh.graph.eps.cpu().numpy(), sh.space.capacity,
                            clip=True)
                for c, x in zip(cols, block_leaves(sh.search_space, eps)):
                    c.append(x.to(d))
                cols[7][-1] = sh.space.valid.to(d)
            self._leaves = tuple(cols)
        self._leaves_key = key
        return self._leaves

    def _l2g_flat(self) -> np.ndarray:
        """Concatenated per-shard l2g tables, aligned with the combined ids
        of the mesh path (cached; mutations invalidate)."""
        if self._l2g_flat_cache is None:
            self._l2g_flat_cache = np.concatenate(self._l2g)
        return self._l2g_flat_cache

    def _remap(self, ids: np.ndarray) -> np.ndarray:
        """Combined ids (row offset in the concatenated shard slabs) →
        global ids through the l2g table."""
        flat = self._l2g_flat()
        safe = np.clip(ids, 0, max(flat.size - 1, 0))
        return np.where(ids >= 0, flat[safe], -1)

    def batch_search_with_distance(self, queries, topk: int, ef: int = 100,
                                   num_threads: int = 1
                                   ) -> Tuple[np.ndarray, np.ndarray]:
        del num_threads
        self._require_fitted()
        q = np.atleast_2d(np.asarray(
            queries.cpu() if isinstance(queries, torch.Tensor) else queries,
            dtype=np.float32))
        mesh = self._mesh()
        if mesh is None or not (
                self.params.index_type is IndexType.FLAT
                or self.params.quantization_type is QuantizationType.BSQ8):
            # the mesh path assembles flat slabs or the bsq8 block layout
            # (nbr_ids / nbr_codes / nbr_xsq); raw, sq and rabitq search
            # spaces have no such layout and are served per shard with a
            # host merge (the same results)
            return self._search_fallback(q, topk, ef)
        qt = torch.as_tensor(q, device=mesh.lead)
        if self.params.index_type is IndexType.FLAT:
            from .sharded import db_sharded_flat_search

            space = self._assemble_leaves(mesh)
            d, i = db_sharded_flat_search(
                mesh, space, space.prep_query(qt), topk,
                bf16=self.params.flat_mode == "fast")
        else:
            from .sharded import db_sharded_block_search

            # each shard's beam seeded from the shard's own seed-scan
            # sample, as its single-device search is (the JAX package scans
            # a strided ~1024 rows a shard: too few at 250,000 rows)
            d, i = db_sharded_block_search(
                mesh, self._assemble_leaves(mesh), self.params.metric.value,
                qt, k=topk, ef=max(int(ef), topk),
                n_expand=self.params.beam_expand,
                seed_samples=[sh._seed_scan_arrays() for sh in self.shards])
        ids = self._remap(i.cpu().numpy())
        d = np.where(ids >= 0, d.cpu().numpy(), np.inf)
        if (self.params.index_type is not IndexType.FLAT
                and self.params.metric.value == "cos"):
            # block spaces score squared L2 of normalized vectors (2 − 2cos);
            # the −cos convention of the engine (the per-shard fallback
            # inherits it from IndexEngine)
            d = np.where(np.isfinite(d), d / 2.0 - 1.0, d)
        return ids.astype(self._id_dtype, copy=False), d

    def _search_fallback(self, q, topk: int, ef: int):
        """The shards searched one after another, then a host top-k merge
        (the mesh path's results; the path with fewer devices than
        shards)."""
        all_d, all_i = [], []
        for s, sh in enumerate(self.shards):
            ids, d = sh.batch_search_with_distance(q, topk, ef=ef)
            ids = np.asarray(ids, dtype=np.int64)
            tbl = self._l2g[s]
            gl = np.where(ids >= 0, tbl[np.clip(ids, 0, tbl.size - 1)], -1)
            all_i.append(gl)
            all_d.append(np.where(gl >= 0, np.asarray(d), np.inf))
        dd = np.concatenate(all_d, axis=1)
        ii = np.concatenate(all_i, axis=1)
        sel = np.argsort(dd, axis=1, kind="stable")[:, :topk]
        out_d = np.take_along_axis(dd, sel, axis=1)
        out_i = np.take_along_axis(ii, sel, axis=1)
        out_i = np.where(np.isfinite(out_d), out_i, -1)
        return out_i.astype(self._id_dtype, copy=False), out_d

    def batch_search(self, queries, topk: int, ef: int = 100,
                     num_threads: int = 1) -> np.ndarray:
        return self.batch_search_with_distance(queries, topk, ef,
                                               num_threads)[0]

    def search(self, query, topk: int, ef: int = 100) -> np.ndarray:
        return self.batch_search(np.atleast_2d(query), topk, ef)[0]

    def search_with_distance(self, query, topk: int, ef: int = 100):
        ids, d = self.batch_search_with_distance(np.atleast_2d(query),
                                                 topk, ef)
        return ids[0], d[0]

    # --------------------------------------------------------------- update
    def insert(self, vectors, ef: int = 100) -> np.ndarray:
        """Each batch slice goes to the emptiest shards; the shards insert
        through the single-device machinery."""
        self._require_fitted()
        v = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        out = np.full(v.shape[0], -1, np.int64)
        remaining = np.arange(v.shape[0])
        order = np.argsort([-(sh.space.capacity - sh.space.num)
                            for sh in self.shards], kind="stable")
        for s in order:
            if remaining.size == 0:
                break
            sh = self.shards[s]
            free = sh.space.capacity - sh.space.num
            if free <= 0:
                continue
            take = remaining[:free]
            local = np.asarray(sh.insert(v[take], ef=ef), dtype=np.int64)
            ok = local >= 0
            gids = self._next_gid + np.arange(int(ok.sum()), dtype=np.int64)
            self._next_gid += int(ok.sum())
            self._l2g[s][local[ok]] = gids
            self._gid_map.set_many(gids, s, local[ok].astype(np.int32))
            out[take[ok]] = gids
            remaining = remaining[free:]
        self._leaves = None
        self._l2g_flat_cache = None
        return out.astype(self._id_dtype, copy=False)

    def remove(self, ids) -> None:
        self._require_fitted()
        gids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        ss, ll = self._gid_map.lookup(gids)
        for s in range(self.ndb):
            loc = ll[ss == s]
            if loc.size:
                self.shards[s].remove(loc.astype(np.int32))
        self._leaves = None

    def compact(self) -> None:
        """Rewire every shard around its tombstones."""
        self._require_fitted()
        for sh in self.shards:
            sh.compact()
        self._leaves = None

    def get_data_by_id(self, id_: int) -> np.ndarray:
        self._require_fitted()
        ss, ll = self._gid_map.lookup(np.asarray([int(id_)]))
        s, l = int(ss[0]), int(ll[0])
        if s < 0:
            raise ValueError(f"unknown id {id_}")
        return self.shards[s].get_data_by_id(l)

    @property
    def num(self) -> int:
        return sum(sh.space.num for sh in self.shards) if self._fitted else 0

    @property
    def capacity(self) -> int:
        return self.ndb * self.per_cap

    @property
    def space(self):
        """Shard 0's space (dim / dtype for the SDK)."""
        return self.shards[0].space

    # ---------------------------------------------------------- persistence
    def save(self, directory: Union[str, os.PathLike]) -> None:
        """One subdirectory per shard (a complete single-device index with
        its schema.json) and the id map; the top schema.json (with
        db_shards) is written by ``Index.save``."""
        self._require_fitted()
        os.makedirs(directory, exist_ok=True)
        for s, sh in enumerate(self.shards):
            sh.save(os.path.join(directory, f"shard_{s:02d}"))
        state = {f"l2g_{s}": self._l2g[s] for s in range(self.ndb)}
        state.update(self._gid_map.state())
        np.savez(os.path.join(directory, _MAPFILE),
                 next_gid=np.int64(self._next_gid), **state)

    @classmethod
    def load(cls, directory: Union[str, os.PathLike],
             device: DeviceLike = None) -> "ShardedEngine":
        """Load a sharded directory written by either package, including
        the JAX package's pre-round-4 layout (one [ndb, per_cap] l2g)."""
        from ..index.engine import IndexEngine

        with open(os.path.join(directory, "schema.json")) as f:
            params = IndexParams.from_dict(json.load(f))
        eng = cls(params, device=device)
        eng.shards = [
            IndexEngine.load(os.path.join(directory, f"shard_{s:02d}"),
                             device=eng.device)
            for s in range(eng.ndb)]
        if not eng._lazy:
            eng.per_cap = eng.shards[0].space.capacity
        with np.load(os.path.join(directory, _MAPFILE)) as z:
            if "l2g" in z:  # pre-round-4 layout
                old = np.asarray(z["l2g"], np.int64)
                eng._l2g = [old[s] for s in range(eng.ndb)]
            else:
                eng._l2g = [np.asarray(z[f"l2g_{s}"], np.int64)
                            for s in range(eng.ndb)]
            eng._gid_map = _GidMap.from_state(z)
            eng._next_gid = int(z["next_gid"])
        eng._fitted = True
        return eng
