"""Database sharding and query data parallelism over a mesh of torch devices
(port of ``parallel/sharded.py``).

The JAX package runs one program per device under ``shard_map`` over a
``("dp", "db")`` ``Mesh``. The port is single-controller in the same way:
one Python process holds every shard and loops over them.

  ``Mesh``         a ``[dp, db]`` grid of ``torch.device``s, axis names
                   ("dp", "db"); a device may appear more than once (virtual
                   shards, ``utils.platforms.force_devices``).
  row-sharded      a list of per-shard tensors, shard ``s`` on the grid's
                   ``db`` device ``s``; the shards are never joined onto one
                   device on the search path.
  all_gather + top-k
                   each shard's ``[Q, k]`` result moves to the lead device,
                   is concatenated and cut with ``topk_smallest``
                   (``sort_kv`` on the card); −1 where the distance is inf.
  "dp"             splits the query batch into ``dp`` slices, one per grid
                   row; each row holds its own copies of the shards (no
                   copy where the row's devices are the first row's).

Each shard's launches go to its own device's current stream. The searches
sync the host once a hop (ROADMAP queue 3), so shards on several cards
take turns hop by hop.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.distance import _exact_topk_device, normalize_rows
from ..ops.topk import topk_smallest

Tensor = torch.Tensor
FINF = float("inf")
QCHUNK = 4096      # queries per slice of a shard's graph search


@dataclasses.dataclass
class Mesh:
    """A grid of devices with named axes: ``devices`` is an object array of
    ``torch.device`` of shape ``[dp, db]`` (or ``[db]`` for a build mesh)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...] = ("dp", "db")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str = "db") -> List[torch.device]:
        """The devices along ``axis`` at index 0 of the other axis."""
        a = self.axis_names.index(axis)
        grid = np.moveaxis(self.devices, a, 0).reshape(
            self.devices.shape[a], -1)
        return list(grid[:, 0])

    def rows(self) -> List[List[torch.device]]:
        """The ``db`` devices of every ``dp`` row (one row for a 1-D mesh)."""
        if self.devices.ndim == 1:
            return [list(self.devices)]
        return [list(r) for r in self.devices]

    @property
    def lead(self) -> torch.device:
        return self.devices.reshape(-1)[0]


def _grid(devs: Sequence[torch.device], shape) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = list(devs)
    return arr.reshape(shape)


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              devices=None) -> Mesh:
    """2-D ("dp", "db") mesh over the first ``n_devices`` devices; ``dp``
    defaults to 2 where their count is even and above 2, else 1."""
    from ..utils import platforms

    if devices is None:
        devices = platforms.devices()
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n == 0:
        raise RuntimeError("make_mesh: no devices")
    if dp is None:
        dp = 2 if n % 2 == 0 and n > 2 else 1
    db = n // dp
    return Mesh(_grid(devices[: dp * db], (dp, db)), ("dp", "db"))


@dataclasses.dataclass
class ShardedSpace:
    """A raw space's arrays row-sharded over a mesh's "db" axis:
    ``data[r][s]``, ``sq_norms[r][s]`` and ``valid[r][s]`` are shard ``s``'s
    rows on grid row ``r``'s device ``s``."""

    data: List[List[Tensor]]
    sq_norms: List[List[Tensor]]
    valid: List[List[Tensor]]
    metric: str = "l2"
    user_metric: str = "l2"

    @property
    def shard_rows(self) -> int:
        return self.data[0][0].shape[0]

    def prep_query(self, q: Tensor) -> Tensor:
        q = q.float()
        return normalize_rows(q) if self.user_metric == "cos" else q


def _split_rows(x: Tensor, ndb: int) -> List[Tensor]:
    if x.shape[0] % ndb:
        raise ValueError(f"{x.shape[0]} rows do not split over {ndb} shards")
    return list(torch.chunk(x, ndb, dim=0))


def _place(parts: Sequence[Tensor], mesh: Mesh) -> List[List[Tensor]]:
    """Per-shard tensors onto every grid row (``.to`` copies only where a
    row's device differs)."""
    return [[p.to(d) for p, d in zip(parts, row)] for row in mesh.rows()]


def shard_space_by_rows(mesh: Mesh, space) -> ShardedSpace:
    """A raw space with its rows split over the "db" axis; its capacity must
    be a multiple of the axis size (as the JAX sharding requires)."""
    ndb = mesh.shape["db"]
    return ShardedSpace(
        data=_place(_split_rows(space.data, ndb), mesh),
        sq_norms=_place(_split_rows(space.sq_norms, ndb), mesh),
        valid=_place(_split_rows(space.valid, ndb), mesh),
        metric=space.metric, user_metric=space.user_metric)


def replicate(mesh: Mesh, tensors):
    """Each tensor copied onto every device of the mesh (one copy per
    distinct device): a list aligned with the flattened grid."""
    flat = list(mesh.devices.reshape(-1))
    return [[t.to(d) for d in flat] for t in tensors]


def _dp_slices(q: Tensor, dp: int) -> List[Tensor]:
    return list(torch.tensor_split(q, dp, dim=0))


def _row_slices(mesh: Mesh, q: Tensor):
    """(the "db" devices of grid row r, query slice r) for every row: the
    leaves are moved to a row's devices with ``.to``, a no-op where they
    already sit there."""
    rows = mesh.rows()
    return list(zip(rows, _dp_slices(q, len(rows))))


def merge_shard_topk(parts_d: Sequence[Tensor], parts_i: Sequence[Tensor],
                     k: int, lead: torch.device) -> Tuple[Tensor, Tensor]:
    """The all_gather over "db" and the cross-shard top-k: each shard's
    [Q, k] (distances, combined ids) onto ``lead``, concatenated in shard
    order, the ``k`` smallest (lower shard first among ties), −1 where the
    distance is inf."""
    dd = torch.cat([d.to(lead) for d in parts_d], dim=1)
    ii = torch.cat([i.to(lead) for i in parts_i], dim=1)
    nd, sel = topk_smallest(dd.contiguous(), k)
    out_i = torch.gather(ii, 1, sel)
    return nd, torch.where(torch.isfinite(nd), out_i,
                           torch.full_like(out_i, -1))


def _local_flat_topk(q: Tensor, data: Tensor, x_sq: Tensor, valid: Tensor,
                     k: int, metric: str, bf16: bool):
    """Exact top-k of ``q`` against one shard's rows. ``k`` may exceed the
    shard: the result pads with inf / −1 so the merge stays [Q, k]."""
    kk = min(k, data.shape[0])
    d, i = _exact_topk_device(q, data.float(), x_sq, valid, kk, metric,
                              tile_n=16384, bf16=bf16)
    if kk < k:
        d = torch.nn.functional.pad(d, (0, k - kk), value=FINF)
        i = torch.nn.functional.pad(i, (0, k - kk), value=-1)
    return d, i


def db_sharded_flat_search(mesh: Mesh, space: ShardedSpace, queries: Tensor,
                           k: int, bf16: bool = False
                           ) -> Tuple[Tensor, Tensor]:
    """Exact top-k over a row-sharded database: each shard scans its rows
    (``l2_tile`` in f32 l2), one all_gather top-k merges. Ids are combined
    ids, ``s * shard_rows + local``. Returns (dists [Q, k], ids [Q, k]) on
    the mesh's lead device."""
    rows = space.shard_rows
    outs_d, outs_i = [], []
    for r, qr in enumerate(_dp_slices(queries, len(space.data))):
        row_devs = mesh.rows()[r]
        parts_d, parts_i = [], []
        for s, dev in enumerate(row_devs):
            d, i = _local_flat_topk(qr.to(dev), space.data[r][s],
                                    space.sq_norms[r][s], space.valid[r][s],
                                    k, space.metric, bf16)
            parts_d.append(d)
            parts_i.append(torch.where(i >= 0, i + s * rows, i))
        d, i = merge_shard_topk(parts_d, parts_i, k, row_devs[0])
        outs_d.append(d.to(mesh.lead))
        outs_i.append(i.to(mesh.lead))
    return torch.cat(outs_d), torch.cat(outs_i)


def dp_sharded_beam_search(mesh: Mesh, space, nbrs: Tensor, seeds: Tensor,
                           queries: Tensor, k: int, ef: int,
                           valid: Optional[Tensor] = None):
    """Graph beam search with the query batch split over every device of
    the mesh and the graph and space replicated (copied only to devices
    that do not hold them)."""
    from ..index.search import beam_search

    flat = list(mesh.devices.reshape(-1))
    out_d, out_i = [], []
    q_parts = torch.tensor_split(queries, len(flat), dim=0)
    s_parts = torch.tensor_split(seeds, len(flat), dim=0)
    for dev, q, sd in zip(flat, q_parts, s_parts):
        sp = dataclasses.replace(space, data=space.data.to(dev),
                                 sq_norms=space.sq_norms.to(dev),
                                 valid=space.valid.to(dev))
        d, i = beam_search(sp, nbrs.to(dev), sd.to(dev), q.to(dev), k=k,
                           ef=ef, valid=None if valid is None
                           else valid.to(dev))
        out_d.append(d.to(mesh.lead))
        out_i.append(i.to(mesh.lead))
    return torch.cat(out_d), torch.cat(out_i)


def _graph_shard_search(space, nbrs, eps, q, k, ef, n_expand):
    from ..index.search import beam_search

    outs_d, outs_i = [], []
    for lo in range(0, q.shape[0], QCHUNK):
        qc = q[lo:lo + QCHUNK]
        seeds = eps.reshape(1, -1).expand(qc.shape[0], -1)
        d, i = beam_search(space, nbrs, seeds, qc, k=k, ef=ef,
                           valid=space.valid, n_expand=n_expand)
        outs_d.append(d)
        outs_i.append(i)
    return torch.cat(outs_d), torch.cat(outs_i)


def db_sharded_graph_search(mesh: Mesh, space_leaves, metric: str,
                            nbrs: Sequence[Tensor], eps: Sequence[Tensor],
                            queries: Tensor, k: int, ef: int,
                            n_expand: int = 8):
    """Graph beam search over a row-partitioned database: every shard holds
    its own subgraph (local neighbor ids over its rows) and runs the full
    beam for all queries; one all_gather top-k merges.

    space_leaves: (data, sq_norms, valid), each a list of per-shard tensors
    on the "db" devices; nbrs per-shard [rows, R] local ids; eps per-shard
    entry points [E] (local ids)."""
    from ..spaces.raw import RawSpace

    data, sq, valid = space_leaves
    outs_d, outs_i = [], []
    for devs, qr in _row_slices(mesh, queries):
        parts_d, parts_i = [], []
        for s, dev in enumerate(devs):
            rows = data[s].shape[0]
            sp = RawSpace(data=data[s].to(dev), sq_norms=sq[s].to(dev),
                          valid=valid[s].to(dev), num=rows, metric=metric,
                          user_metric=metric)
            d, i = _graph_shard_search(sp, nbrs[s].to(dev), eps[s].to(dev),
                                       qr.to(dev), k, ef, n_expand)
            parts_d.append(d)
            parts_i.append(torch.where(i >= 0, i + s * rows, i))
        d, i = merge_shard_topk(parts_d, parts_i, k, devs[0])
        outs_d.append(d.to(mesh.lead))
        outs_i.append(i.to(mesh.lead))
    return torch.cat(outs_d), torch.cat(outs_i)


def _block_shard_search(space, eps, q, k, ef, n_expand, metric, valid,
                        sample=None):
    """One shard's block search: a seed scan ahead of the shared entry
    points (QG graphs are built locality-first, so entry points near the
    query matter), over ``sample`` (ids, vecs bf16, sq_norms) where given,
    else over a strided sample of ~1024 local rows, as the JAX package
    scans."""
    from ..index.search import block_beam_search, scan_seeds, seed_sample_arrays

    if sample is None:
        rows = space.capacity
        step = max(1, rows // 1024)
        sids = torch.arange(0, rows, step, dtype=torch.int32, device=q.device)
        sample = seed_sample_arrays(space.data, sids, metric)
    outs_d, outs_i = [], []
    for lo in range(0, q.shape[0], QCHUNK):
        qj = space.prep_query(q[lo:lo + QCHUNK])
        scan = scan_seeds(qj, *sample, nseed=min(8, sample[0].shape[0]))
        seeds = torch.cat([scan, eps.reshape(1, -1).expand(qj.shape[0], -1)],
                          dim=1)
        d, i = block_beam_search(space, seeds, qj, k=k, ef=ef, valid=valid,
                                 n_expand=n_expand)
        outs_d.append(d)
        outs_i.append(i)
    return torch.cat(outs_d), torch.cat(outs_i)


def db_sharded_block_search(mesh: Mesh, leaves, metric: str, queries: Tensor,
                            k: int, ef: int, n_expand: int = 8,
                            seed_samples=None):
    """Block (bsq8) graph search over a row-partitioned database: every
    shard holds an independent QG subindex, runs the block beam for all
    queries (``gather_estimate``, ``ring_probe``, ``pool_merge`` on every
    hop) and exact-reranks locally, so f32 distances merge across shards
    with one all_gather top-k.

    leaves: (data, sq_norms, dmin, scale, nbr_ids, nbr_codes, nbr_xsq,
    valid, eps), each a list of per-shard tensors (dmin / scale [D], eps
    [E] local ids). ``seed_samples``: per shard a seed-scan sample (ids,
    vecs bf16, sq_norms) or None; a shard without one scans a strided
    sample of ~1024 of its rows, the JAX package's only choice, which at
    250,000 rows a shard leaves recall@10 at 0.87 (PERF.md §6): the
    SDK engine passes its shards' own samples."""
    from ..spaces.bqg import BQGSpace

    outs_d, outs_i = [], []
    for devs, qr in _row_slices(mesh, queries):
        parts_d, parts_i = [], []
        for s, dev in enumerate(devs):
            data, sq, dmin, scale, nids, ncodes, nxsq, valid, eps = (
                x[s].to(dev) for x in leaves)
            rows = data.shape[0]
            sp = BQGSpace(data=data, sq_norms=sq, dmin=dmin, scale=scale,
                          nbr_ids=nids, nbr_codes=ncodes, nbr_xsq=nxsq,
                          valid=valid, num=rows,
                          metric="ip" if metric == "ip" else "l2",
                          user_metric=metric)
            sample = None if seed_samples is None else seed_samples[s]
            if sample is not None:
                sample = tuple(x.to(dev) for x in sample)
            d, i = _block_shard_search(sp, eps, qr.to(dev).float(), k, ef,
                                       n_expand, metric, valid, sample)
            parts_d.append(d)
            parts_i.append(torch.where(i >= 0, i + s * rows, i))
        d, i = merge_shard_topk(parts_d, parts_i, k, devs[0])
        outs_d.append(d.to(mesh.lead))
        outs_i.append(i.to(mesh.lead))
    return torch.cat(outs_d), torch.cat(outs_i)


def _check_fit(n: int, ndb: int) -> None:
    if n < ndb:
        raise ValueError(f"fit of {n} vectors cannot fill {ndb} shards")


def _eps8(eg: np.ndarray, per: int, clip: bool) -> np.ndarray:
    e = np.zeros(8, dtype=np.int32)
    e[: min(len(eg), 8)] = (np.clip(eg[:8], 0, per - 1) if clip
                            else eg[:8])
    return e


class ShardedGraphIndex:
    """Rows partitioned over the mesh's "db" axis, one independent subgraph
    per shard (hnsw or nsg builder, seeded by the shard number), fan-out
    search and one top-k merge. Shards take ``np.array_split`` chunks, so
    n = 9 over 8 shards gives every shard at least one row."""

    def __init__(self, mesh: Optional[Mesh] = None, metric: str = "l2",
                 max_nbrs: int = 16, ef_construction: int = 100,
                 builder: str = "nsg"):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.metric = metric.lower()
        self.max_nbrs = max_nbrs
        self.ef_construction = ef_construction
        self.builder = builder
        self._leaves = None

    def fit(self, vectors) -> None:
        from ..index.hnsw import HNSWBuilder
        from ..index.nsg import NSGBuilder
        from ..spaces.raw import RawSpace

        v = np.asarray(vectors, dtype=np.float32)
        n, dim = v.shape
        devs = self.mesh.axis_devices("db")
        ndb = len(devs)
        _check_fit(n, ndb)
        per = -(-n // ndb)
        datas, sqs, valids, nbrs_l, eps_l = [], [], [], [], []
        for s, rows in enumerate(np.array_split(v, ndb)):
            space = RawSpace.create(per, dim, metric=self.metric,
                                    device=devs[s]).fit(rows)
            if self.builder == "hnsw":
                b = HNSWBuilder(r=self.max_nbrs, l=self.ef_construction,
                                seed=s)
            else:
                b = NSGBuilder(r=self.max_nbrs,
                               l=max(self.ef_construction // 2, 64), seed=s)
            g = b.build_graph(space, rows.shape[0])
            datas.append(space.data.float())
            sqs.append(space.sq_norms)
            valids.append(space.valid)
            nbrs_l.append(g.nbrs[:, : self.max_nbrs].contiguous())
            eps_l.append(torch.as_tensor(
                _eps8(g.eps.cpu().numpy(), per, clip=False), device=devs[s]))
        self._leaves = (datas, sqs, valids)
        self._nbrs, self._eps = nbrs_l, eps_l
        self._per, self._n = per, n

    def batch_search_with_distance(self, queries, topk: int,
                                   ef_search: int = 100):
        if self._leaves is None:
            raise RuntimeError("index is not fitted")
        q = torch.as_tensor(np.atleast_2d(np.asarray(queries, np.float32)),
                            device=self.mesh.lead)
        if self.metric == "cos":
            q = normalize_rows(q)
        d, i = db_sharded_graph_search(
            self.mesh, self._leaves, "ip" if self.metric in ("ip", "cos")
            else "l2", self._nbrs, self._eps, q, k=topk,
            ef=max(ef_search, topk))
        return i.cpu().numpy(), d.cpu().numpy()

    def batch_search(self, queries, topk: int, ef_search: int = 100):
        return self.batch_search_with_distance(queries, topk, ef_search)[0]


class ShardedFlatIndex:
    """Rows sharded over the mesh's "db" axis; exact search (or the bf16
    scan with ``bf16``) with one all_gather top-k merge."""

    def __init__(self, mesh: Optional[Mesh] = None, metric: str = "l2",
                 bf16: bool = True):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.metric = metric.lower()
        self.bf16 = bf16
        self.space = None

    def fit(self, vectors) -> None:
        from ..spaces.raw import RawSpace

        v = np.asarray(vectors, dtype=np.float32)
        n, dim = v.shape
        ndb = self.mesh.shape["db"]
        cap = -(-n // ndb) * ndb  # row-shardable capacity
        space = RawSpace.create(cap, dim, metric=self.metric,
                                device=self.mesh.lead).fit(v)
        self.space = shard_space_by_rows(self.mesh, space)
        self._n = n

    def batch_search(self, queries, topk: int, ef_search: int = 0):
        return self.batch_search_with_distance(queries, topk, ef_search)[0]

    def batch_search_with_distance(self, queries, topk: int,
                                   ef_search: int = 0):
        del ef_search  # exact search has no beam knob; kept for API parity
        q = self.space.prep_query(torch.as_tensor(
            np.atleast_2d(np.asarray(queries, np.float32)),
            device=self.mesh.lead))
        d, i = db_sharded_flat_search(self.mesh, self.space, q, topk,
                                      bf16=self.bf16)
        return i.cpu().numpy(), d.cpu().numpy()


class ShardedBlockIndex:
    """The bsq8 block layout row-partitioned over the mesh's "db" axis, one
    independent QG subindex per shard, fan-out block search and one top-k
    merge."""

    def __init__(self, mesh: Optional[Mesh] = None, metric: str = "l2",
                 max_nbrs: int = 32, ef_construction: int = 128):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.metric = metric.lower()
        self.max_nbrs = max_nbrs
        self.ef_construction = ef_construction
        self._leaves = None

    def fit(self, vectors) -> None:
        from ..index.qg import QGBuilder
        from ..spaces.bqg import BQGSpace
        from ..spaces.raw import RawSpace

        v = np.asarray(vectors, dtype=np.float32)
        n, dim = v.shape
        devs = self.mesh.axis_devices("db")
        ndb = len(devs)
        _check_fit(n, ndb)
        per = -(-n // ndb)
        cols = [[] for _ in range(9)]
        for s, rows in enumerate(np.array_split(v, ndb)):
            raw = RawSpace.create(per, dim, metric=self.metric,
                                  device=devs[s]).fit(rows)
            bqg = BQGSpace.create(per, dim, metric=self.metric,
                                  degree=self.max_nbrs,
                                  device=devs[s]).fit(rows)
            g, bqg = QGBuilder(r=self.max_nbrs,
                               ef=max(self.ef_construction, 64)
                               ).build_graph(raw, bqg, rows.shape[0])
            eps = _eps8(g.eps.cpu().numpy(), per, clip=True)
            for c, x in zip(cols, block_leaves(bqg, eps)):
                c.append(x)
        self._leaves = tuple(cols)
        self._per, self._n = per, n

    def batch_search_with_distance(self, queries, topk: int,
                                   ef_search: int = 100):
        if self._leaves is None:
            raise RuntimeError("index is not fitted")
        q = torch.as_tensor(np.atleast_2d(np.asarray(queries, np.float32)),
                            device=self.mesh.lead)
        d, i = db_sharded_block_search(self.mesh, self._leaves, self.metric,
                                       q, k=topk, ef=max(ef_search, topk))
        return i.cpu().numpy(), d.cpu().numpy()

    def batch_search(self, queries, topk: int, ef_search: int = 100):
        return self.batch_search_with_distance(queries, topk, ef_search)[0]


def block_leaves(bqg, eps) -> tuple:
    """One shard's leaves in ``db_sharded_block_search``'s order, from a
    BQGSpace and its entry points (no copies)."""
    return (bqg.data, bqg.sq_norms, bqg.dmin, bqg.scale, bqg.nbr_ids,
            bqg.nbr_codes, bqg.nbr_xsq, bqg.valid,
            torch.as_tensor(np.asarray(eps, np.int32), device=bqg.device))
