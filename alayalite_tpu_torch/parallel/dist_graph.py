"""ONE graph served with its raw slab row-sharded over a ("db",) mesh
(port of ``parallel/dist_graph.py``).

  - the slab is split over the mesh's devices at fit (host → per-shard
    blocks; the full slab never sits on one device);
  - the base adjacency is built by the sharded builder
    (``parallel/build_sharded.py``, rotating data blocks);
  - connectivity repair is the host ``nsg._attach_unreached`` with a
    nearest-reached scan over the sharded slab;
  - serving runs the single-device lockstep beam (``index/search.py``) over
    ``DistSlab``, whose ``gather_dists`` has every shard score the
    candidate ids it owns and sums the partial distances (the JAX
    package's per-hop ``psum``). Exactly one shard owns each id and the
    others add 0.0, so the sum is exact.

The JAX package runs the same beam on every shard with identical inputs
under ``shard_map``; the port runs it once, on the lead device, and fans
out only ``gather_dists``: the same results.

Two defects of the JAX package are not copied: ``DistSlab`` bounds ids by
the appended-row count ``n`` (the JAX package by ``sum(valid)``, so after
k removes the live ids in [n − k, n) read as inf), and ``remove`` checks
ids against ``n`` (the JAX package against the padded row count).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
import types
from typing import List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.distance import pairwise
from ..ops.gather_dot import gather_dot
from ..params import IndexParams
from .sharded import Mesh

log = logging.getLogger("alayalite_tpu_torch")

Tensor = torch.Tensor
FINF = float("inf")
QCHUNK = 4096      # queries per slice of a search
SCAN_TILE = 16384  # slab rows per tile of the nearest-reached scan


@dataclasses.dataclass
class DistSlab:
    """Space shim for ``beam_search`` over a row-sharded slab: shard s
    holds rows [offset_s, offset_s + rows_s) on its device."""

    data: List[Tensor]       # per-shard [rows, D] f32
    sq_norms: List[Tensor]   # per-shard [rows]
    n_total: int             # appended rows: ids in [0, n_total) are live
    metric: str = "l2"

    @property
    def capacity(self) -> int:
        return sum(x.shape[0] for x in self.data)

    def gather_dists(self, q: Tensor, ids: Tensor) -> Tensor:
        """Distances [B, K] of ``q`` [B, D] to ``ids`` [B, K] on ``q``'s
        device: every shard scores the ids it owns (one ``gather_dot``;
        the others count 0.0), the partial distances are summed."""
        lead = q.device
        total = torch.zeros(ids.shape, device=lead)
        off = 0
        for data, sq in zip(self.data, self.sq_norms):
            dev = data.device
            rows = data.shape[0]
            qd, idd = q.to(dev).contiguous(), ids.to(dev)
            local = (idd - off).contiguous()
            own = (local >= 0) & (local < rows)
            # gather_dot clamps the ids another shard owns into its rows
            if self.metric == "ip":
                d = -gather_dot(data, local, qd)
            else:
                d = gather_dot(data, local, qd, (qd * qd).sum(-1), sq)
            total += torch.where(own, d, torch.zeros_like(d)).to(lead)
            off += rows
        in_range = (ids >= 0) & (ids < self.n_total)
        return torch.where(in_range, total, torch.full_like(total, FINF))


def dist_graph_search(mesh: Mesh, data_sh: List[Tensor],
                      sq_sh: List[Tensor], valid_rep: Tensor,
                      nbrs_rep: Tensor, eps_rep: Tensor, queries: Tensor,
                      k: int, ef: int, metric: str = "l2", n_expand: int = 8,
                      max_iters: int = 0, seed_sample=None,
                      n: Optional[int] = None):
    """Lockstep beam over ONE global graph with the slab row-sharded:
    data / sq per shard on the "db" devices; valid / nbrs / eps on the lead
    device, where the beam runs. ``n`` bounds the ids (the appended rows;
    default the slab's rows). Returns (dists [B, k], ids [B, k] global)."""
    from ..index.search import beam_search, scan_seeds

    lead = mesh.lead
    slab = DistSlab(data=data_sh, sq_norms=sq_sh,
                    n_total=int(n) if n is not None
                    else sum(x.shape[0] for x in data_sh), metric=metric)
    outs_d, outs_i = [], []
    for lo in range(0, queries.shape[0], QCHUNK):
        q = queries[lo:lo + QCHUNK].to(lead).float()
        if seed_sample is not None:
            seeds = scan_seeds(q, *seed_sample)
        else:
            seeds = eps_rep.reshape(1, -1).expand(q.shape[0], -1)
        d, i = beam_search(slab, nbrs_rep, seeds, q, k=k, ef=ef,
                           valid=valid_rep, n_expand=n_expand,
                           max_iters=max_iters)
        outs_d.append(d)
        outs_i.append(i)
    return torch.cat(outs_d), torch.cat(outs_i)


def _nearest_reached_factory(mesh: Mesh, data_sh: List[Tensor],
                             host_data: np.ndarray, metric: str):
    """nearest_fn for ``nsg._attach_unreached``: the nearest REACHED row of
    each representative, by a scan of every shard's rows in tiles
    (``pairwise``: ``l2_tile`` for l2, which takes the norms itself), a
    per-shard argmin, then a merge on the lead device, lower shard first
    among ties."""
    lead = mesh.lead

    def nearest(rep_ids: np.ndarray, reached: np.ndarray) -> np.ndarray:
        q_host = torch.as_tensor(np.ascontiguousarray(host_data[rep_ids]))
        best_d, best_i = [], []
        off = 0
        for data in data_sh:
            dev, rows = data.device, data.shape[0]
            q = q_host.to(dev)
            ok_all = torch.zeros(rows, dtype=torch.bool)
            hi = min(off + rows, reached.size)
            if hi > off:
                ok_all[: hi - off] = torch.as_tensor(reached[off:hi])
            ok_all = ok_all.to(dev)
            bd = torch.full((q.shape[0],), FINF, device=dev)
            bi = torch.full((q.shape[0],), -1, dtype=torch.int32, device=dev)
            for t in range(0, rows, SCAN_TILE):
                d = pairwise(q, data[t:t + SCAN_TILE], metric=metric)
                d = torch.where(ok_all[None, t:t + SCAN_TILE], d,
                                torch.full_like(d, FINF))
                dm, j = d.min(1)
                upd = dm < bd
                bd = torch.where(upd, dm, bd)
                bi = torch.where(upd, (off + t + j).to(torch.int32), bi)
            best_d.append(bd.to(lead))
            best_i.append(bi.to(lead))
            off += rows
        dd, ii = torch.stack(best_d, 1), torch.stack(best_i, 1)
        jj = torch.argmin(dd, dim=1, keepdim=True)
        src = torch.gather(ii, 1, jj)[:, 0]
        src = torch.where(torch.isfinite(torch.gather(dd, 1, jj)[:, 0]), src,
                          torch.full_like(src, -1))
        return src.cpu().numpy()

    return nearest


class DistGraphEngine:
    """Engine for the serve-sharded single graph (``serve_shards > 1``).
    Static after fit: search, remove, compact, save and load; online insert
    raises, as in the JAX package (growing a sharded slab is a refit)."""

    def __init__(self, params: IndexParams, device: DeviceLike = None):
        from ..utils import platforms
        from .build_sharded import make_build_mesh

        self.params = params
        self.device = resolve_device(device)
        self._fitted = False
        self._removed: list = []
        self.build_timings: dict = {}
        p = int(params.serve_shards)
        devs = platforms.devices(self.device.type)
        if len(devs) < p:
            raise RuntimeError(
                f"serve_shards={p} needs that many devices; "
                f"{len(devs)} available")
        self.mesh = make_build_mesh(p, devs)

    # ------------------------------------------------------------- fit
    def fit(self, vectors, ef_construction: Optional[int] = None,
            num_threads: int = 1) -> None:
        del num_threads
        from ..index.nsg import _attach_unreached
        from .build_sharded import ShardedGraphBuilder

        v = np.asarray(vectors.cpu() if isinstance(vectors, torch.Tensor)
                       else vectors, dtype=np.float32)
        if v.ndim != 2:
            raise ValueError("fit expects a 2-D array [n, dim]")
        if ef_construction:
            self.params.ef_construction = int(ef_construction)
        n, dim = v.shape
        t0 = time.time()
        metric = self.params.metric.value
        if metric == "cos":
            v = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True),
                               1e-30)
        r = self.params.max_nbrs
        builder = ShardedGraphBuilder(
            mesh=self.mesh, r=r, knn_k=32,
            alpha=float(self.params.prune_alpha), ef=max(2 * r, 64),
            metric="ip" if metric in ("ip", "cos") else "l2")
        nbrs, ep = builder.build(v, n)
        self.build_timings = dict(builder.timings)
        t = time.time()
        # shard the slab before the repair: its nearest-reached scan runs
        # over the shards, so the full slab never lands on one device
        self._upload(v, n, metric)
        nearest = _nearest_reached_factory(self.mesh, self._data_sh, v,
                                           self._metric)
        self.repair_rounds: list = []
        nbrs = _attach_unreached(nbrs, ep, nearest, rounds=self.repair_rounds)
        self.build_timings["repair"] = time.time() - t
        rng = np.random.default_rng(0xD157 ^ n)
        extra = rng.integers(0, n, size=7).astype(np.int32)
        self._set_graph(nbrs, np.concatenate([[ep], extra]))
        self._seed_sample = self._draw_seed_sample(v, n, rng)
        self._fitted = True
        log.info("dist fit: n=%d dim=%d shards=%d in %.1fs", n, dim,
                 len(self._data_sh), time.time() - t0)

    def _set_graph(self, nbrs: np.ndarray, eps: np.ndarray) -> None:
        lead = self.mesh.lead
        self._nbrs = torch.as_tensor(np.array(nbrs, np.int32), device=lead)
        self._eps = torch.as_tensor(np.array(eps, np.int32), device=lead)

    def _draw_seed_sample(self, v: np.ndarray, n: int, rng):
        """The per-query seed-scan sample, drawn from ``rng`` after the
        entry points as in the JAX package; the rows are gathered on the
        host and only the sample goes to the lead device."""
        from ..index.search import seed_sample_arrays

        s = min(int(self.params.seed_sample), (n // 128) * 128)
        if s < 128:
            return None
        ids = np.sort(rng.choice(n, size=s, replace=False)).astype(np.int32)
        sample = seed_sample_arrays(torch.as_tensor(v), torch.as_tensor(ids),
                                    self.params.metric.value)
        return tuple(x.to(self.mesh.lead) for x in sample)

    def _upload(self, v: np.ndarray, n: int, metric: str) -> None:
        """Rows zero-padded to a multiple of 128·P, one block per shard."""
        devs = self.mesh.axis_devices("db")
        p = len(devs)
        npad = -(-n // (128 * p)) * (128 * p)
        rows = npad // p
        self._metric = "ip" if metric in ("ip", "cos") else "l2"
        self._user_metric = metric
        self._data_sh, self._sq_sh = [], []
        for s, dev in enumerate(devs):
            block = np.zeros((rows, v.shape[1]), np.float32)
            got = v[s * rows: min((s + 1) * rows, n)]
            block[: got.shape[0]] = got
            x = torch.as_tensor(block, device=dev)
            self._data_sh.append(x)
            self._sq_sh.append((x * x).sum(1))
        valid = torch.zeros(npad, dtype=torch.bool)
        valid[:n] = True
        self._valid = valid.to(self.mesh.lead)
        self._host_data = v
        self._npad, self._n = npad, n

    # ---------------------------------------------------------- search
    def _require_fitted(self):
        if not self._fitted:
            raise RuntimeError("index is not fitted")

    @property
    def _id_dtype(self):
        return (np.int64 if self.params.id_type in ("uint64", "int64")
                else np.int32)

    def batch_search_with_distance(self, queries, topk: int, ef: int = 100,
                                   num_threads: int = 1):
        del num_threads
        self._require_fitted()
        q = np.atleast_2d(np.asarray(
            queries.cpu() if isinstance(queries, torch.Tensor) else queries,
            dtype=np.float32))
        if q.shape[1] != self._host_data.shape[1]:
            raise ValueError(f"query dim {q.shape[1]} != index dim "
                             f"{self._host_data.shape[1]}")
        if self._user_metric == "cos":
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True),
                               1e-30)
        d, i = dist_graph_search(
            self.mesh, self._data_sh, self._sq_sh, self._valid, self._nbrs,
            self._eps, torch.as_tensor(q), k=topk, ef=max(int(ef), int(topk)),
            metric=self._metric, n_expand=int(self.params.beam_expand),
            max_iters=int(self.params.search_iters),
            seed_sample=self._seed_sample, n=self._n)
        return (i.cpu().numpy().astype(self._id_dtype, copy=False),
                d.cpu().numpy())

    def batch_search(self, queries, topk: int, ef: int = 100,
                     num_threads: int = 1) -> np.ndarray:
        return self.batch_search_with_distance(queries, topk, ef)[0]

    def search(self, query, topk: int, ef: int = 100) -> np.ndarray:
        return self.batch_search(np.atleast_2d(query), topk, ef)[0]

    def search_with_distance(self, query, topk: int, ef: int = 100):
        ids, d = self.batch_search_with_distance(np.atleast_2d(query),
                                                 topk, ef)
        return ids[0], d[0]

    # ---------------------------------------------------------- update
    def insert(self, vectors, ef: int = 100) -> np.ndarray:
        raise RuntimeError(
            "serve_shards > 1 serves a static fitted index; online insert "
            "needs serve_shards=1 (refit to grow a sharded slab)")

    def remove(self, ids) -> None:
        """Tombstone ids in the valid mask (the walk still routes through
        removed nodes; results skip them). Ids must lie in [0, n)."""
        self._require_fitted()
        raw = np.atleast_1d(np.asarray(ids)).astype(np.int64)
        if raw.size and (raw.min() < 0 or raw.max() >= self._n):
            raise ValueError(
                f"remove: id out of range [0, {self._n}) "
                f"(got min={raw.min()}, max={raw.max()})")
        self._valid[torch.as_tensor(raw, device=self._valid.device)] = False
        self._removed.extend(int(x) for x in raw)

    def compact(self) -> None:
        self._removed = []  # tombstones are already filtered at result time

    def get_data_by_id(self, id_: int) -> np.ndarray:
        self._require_fitted()
        return np.asarray(self._host_data[int(id_)])

    @property
    def num(self) -> int:
        return int(self._valid.sum()) if self._fitted else 0

    @property
    def capacity(self) -> int:
        return int(self.params.capacity)

    @property
    def space(self):
        """Shape metadata for the SDK (``Index.load`` reads .dim)."""
        if not self._fitted:
            return None
        return types.SimpleNamespace(dim=self._host_data.shape[1],
                                     num=self.num)

    # ----------------------------------------------------- persistence
    def save_arrays(self) -> dict:
        """The arrays of ``dist_graph.npz`` (the JAX package's keys)."""
        return {"data": self._host_data, "nbrs": self._nbrs.cpu().numpy(),
                "eps": self._eps.cpu().numpy(),
                "valid": self._valid.cpu().numpy(), "n": self._n}

    def save(self, directory) -> None:
        self._require_fitted()
        os.makedirs(directory, exist_ok=True)
        np.savez(os.path.join(directory, "dist_graph.npz"),
                 **self.save_arrays())

    @classmethod
    def from_arrays(cls, params: IndexParams, z,
                    device: DeviceLike = None) -> "DistGraphEngine":
        """An engine from ``dist_graph.npz``'s arrays (either package's):
        the slab sharded over the mesh, the seed sample redrawn as at fit."""
        eng = cls(params, device=device)
        v = np.asarray(z["data"], np.float32)
        n = int(z["n"])
        eng._upload(v, n, params.metric.value)
        eng._valid = torch.as_tensor(np.array(z["valid"], bool),
                                     device=eng.mesh.lead)
        eng._set_graph(z["nbrs"], z["eps"])
        rng = np.random.default_rng(0xD157 ^ n)
        rng.integers(0, n, size=7)  # keep the draw stream aligned with fit
        eng._seed_sample = eng._draw_seed_sample(v, n, rng)
        eng._fitted = True
        return eng

    @classmethod
    def load(cls, directory, device: DeviceLike = None) -> "DistGraphEngine":
        with open(os.path.join(directory, "schema.json")) as f:
            params = IndexParams.from_dict(json.load(f))
        with np.load(os.path.join(directory, "dist_graph.npz")) as z:
            return cls.from_arrays(params, dict(z.items()), device=device)
