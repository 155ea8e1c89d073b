"""One graph built with its rows sharded over a ("db",) mesh (port of
``parallel/build_sharded.py``).

Every per-node state tensor (rows, squared norms, kNN rows, pools,
adjacency) lives row-sharded: shard p owns rows [p·Nl, (p+1)·Nl) on its
mesh device, and each phase processes only its own rows. Scoring a
candidate owned by another shard goes around the ring: at stage s shard p
reads block (p + s) mod P, copied to its own device (the JAX package's
``ppermute``), and scores the candidates in that block's id range. Small
global state (the kNN ids for the neighbors-of-neighbors join, the
adjacency for the reverse edges) is gathered whole: ids, not vectors.

Phases, as in the JAX package: NN-Descent rounds from a random init (early
stop on the changed count) → sampled 2-hop pools with long-edge slots →
occlusion prune → bounded reverse edges + re-prune → degree fill from the
pools. ``build_graph_sharded`` adds the overlay levels, the device
connectivity repair and the entry points. One change from the JAX
package: a pool's long-edge slots hold the nearest of a larger random
draw, not the draw itself (``N_LONG``, ``LONG_DRAW``).

The per-shard work runs the port's kernels: ``_dedup_merge_fast`` and the
prune's compaction go through ``topk_smallest`` (``sort_kv``). Random
streams are ``torch.Generator``s seeded from ``seed`` per shard and per
round (the JAX package folds PRNG keys), so the graphs differ from the JAX
package's; their recall is what is compared.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..index.build_phases import make_generator
from ..index.nndescent import _dedup_merge_fast
from ..index.prune import _sort_dedup, occlude_greedy
from ..ops.distance import row_dots
from .sharded import Mesh, _grid

log = logging.getLogger("alayalite_tpu_torch")

Tensor = torch.Tensor
FINF = float("inf")
# Long-edge slots of a pool: the nearest N_LONG of LONG_DRAW random rows.
# The JAX package's 8 uniform random rows leave navigability to the draw
# (recall@10 swings by a few points from one build seed to the next);
# 16 of 64 build a graph above the single-device build's recall at the
# same fit time (scripts/torch_build_sharded_probe.py, PERF.md).
# N_LONG = LONG_DRAW = 8 is the JAX package's rule (the draw itself), and
# tests/test_torch_build_sharded.py holds that build against JAX's.
N_LONG = 16
LONG_DRAW = 64


def make_build_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D ("db",) mesh over the first ``n_devices`` devices."""
    from ..utils import platforms

    if devices is None:
        devices = platforms.devices()
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(_grid(devices, (len(devices),)), ("db",))


def _gen(device, seed: int, *tags: int) -> torch.Generator:
    """A generator for (seed, phase, round, shard, ...): one stream each."""
    h = int(seed) & 0xFFFFFFFF
    for t in tags:
        h = (h * 0x9E3779B1 + int(t) + 1) & 0x7FFFFFFFFFFF
    return make_generator(device, h)


# --------------------------------------------------------------------- ring
def _ring_dists(q: Tensor, qsq: Tensor, blocks: List[Tensor],
                block_sqs: List[Tensor], cand: Tensor, p_idx: int, n: int,
                metric: str, chunk: int) -> Tensor:
    """Distances from each query row to its candidate ids, the shards'
    blocks going once around the ring.

    q [Q, D] f32 (sq norms qsq [Q]) on shard ``p_idx``'s device; blocks[s]
    [Nl, D] bf16 shard s's rows; cand [Q, M] global ids, those < 0 or ≥ n
    score +inf. Products of bf16 values summed in f32. Chunked over Q to
    bound the [chunk, M, D] gather."""
    dev = q.device
    nring, nl = len(blocks), blocks[0].shape[0]
    cand = torch.where(cand < n, cand, torch.full_like(cand, -1))
    out = torch.full(cand.shape, FINF, device=dev)
    qb = q.to(torch.bfloat16).float()
    for s in range(nring):
        src = (p_idx + s) % nring
        blk, blk_sq = blocks[src].to(dev), block_sqs[src].to(dev)
        lo_g = src * nl
        for clo in range(0, q.shape[0], chunk):
            ids = cand[clo:clo + chunk]
            rel = ids - lo_g
            hit = (ids >= 0) & (rel >= 0) & (rel < nl)
            safe = rel.clamp(0, nl - 1).long()
            dot = row_dots(blk[safe].float(), qb[clo:clo + chunk])
            if metric == "ip":
                dd = -dot
            else:
                dd = torch.clamp(qsq[clo:clo + chunk, None] + blk_sq[safe]
                                 - 2.0 * dot, min=0.0)
            cur = out[clo:clo + chunk]
            out[clo:clo + chunk] = torch.where(hit, torch.minimum(cur, dd),
                                               cur)
    return out


def _ring_gather(blocks: List[Tensor], block_sqs: List[Tensor], ids: Tensor,
                 p_idx: int, n: int) -> Tuple[Tensor, Tensor]:
    """Candidate vectors and their sq norms from the rotating blocks: ids
    [C, M] global → (vecs [C, M, D] bf16, sq [C, M] f32), zeros for ids
    < 0 or ≥ n."""
    dev = ids.device
    nring, nl = len(blocks), blocks[0].shape[0]
    ids = torch.where(ids < n, ids, torch.full_like(ids, -1))
    vecs = torch.zeros(ids.shape + (blocks[0].shape[1],),
                       dtype=torch.bfloat16, device=dev)
    sq = torch.zeros(ids.shape, device=dev)
    for s in range(nring):
        src = (p_idx + s) % nring
        blk, blk_sq = blocks[src].to(dev), block_sqs[src].to(dev)
        rel = ids - src * nl
        hit = (ids >= 0) & (rel >= 0) & (rel < nl)
        safe = rel.clamp(0, nl - 1).long()
        vecs = torch.where(hit[..., None], blk[safe], vecs)
        sq = torch.where(hit, blk_sq[safe], sq)
    return vecs, sq


def _occlude_mat(cand_d: Tensor, cand_i: Tensor, vecs_c: Tensor,
                 sq_c: Tensor, r: int, alpha: float, metric: str) -> Tensor:
    """The occlusion rule over ring-gathered candidate vectors [C, M, D]:
    the greedy walk of ``prune.occlusion_prune_chunk`` with the pair
    distances from ``vecs_c``. cand_d / cand_i sorted ascending (−1 / inf
    pads). Returns [C, r] i32, −1 padded."""
    v = vecs_c.float()
    dots = torch.bmm(v, v.transpose(1, 2))
    if metric == "ip":
        pair_d = -dots
    else:
        pair_d = torch.clamp(sq_c[:, :, None] + sq_c[:, None, :] - 2.0 * dots,
                             min=0.0)
    return occlude_greedy(cand_d, cand_i, pair_d.transpose(1, 2).contiguous(),
                          r, alpha)


def _scatter_reverse(targets: Tensor, slot: Tensor, base: int, nl: int,
                     width: int) -> Tensor:
    """Bounded reverse table for rows [base, base + nl): row t gets the
    sources s with targets[s, j] == t in slot[s, j] (colliding writes keep
    one, which one is unspecified, as in the JAX scatter)."""
    npd, w = targets.shape
    src = torch.arange(npd, dtype=torch.int32, device=targets.device)[:, None]
    rel = targets - base
    ok = (targets >= 0) & (rel >= 0) & (rel < nl)
    rev = torch.full((nl, width), -1, dtype=torch.int32,
                     device=targets.device)
    rev[rel[ok].long(), slot[ok]] = src.expand(npd, w)[ok]
    return rev


def _me(base: int, lo: int, c: int, dev) -> Tensor:
    return (base + lo + torch.arange(c, dtype=torch.int32, device=dev))[:, None]


def _neg1(mask: Tensor, x: Tensor) -> Tensor:
    return torch.where(mask, torch.full_like(x, -1), x)


# ------------------------------------------------------------------ builder
class ShardedGraphBuilder:
    """One graph's base adjacency built with its rows sharded over "db":
    (adjacency [n, r] i32 with −1 pads, entry point)."""

    def __init__(self, mesh: Optional[Mesh] = None, r: int = 32,
                 knn_k: int = 32, ef: int = 0, alpha: float = 1.0,
                 rounds: int = 0, seed: int = 0, chunk: int = 1024,
                 metric: str = "l2"):
        self.mesh = mesh if mesh is not None else make_build_mesh()
        self.devs = self.mesh.axis_devices("db")
        self.p = len(self.devs)
        self.r = r
        self.knn_k = knn_k
        self.ef = ef if ef > 0 else max(2 * r, 64)
        self.alpha = alpha
        self.rounds = rounds
        self.seed = seed
        self.chunk = chunk
        self.metric = metric
        self.timings: dict = {}
        self.changed: list = []

    def _sync(self) -> None:
        for d in set(self.devs):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _phase(self, name: str, t0: float) -> float:
        self._sync()
        now = time.time()
        self.timings[name] = self.timings.get(name, 0.0) + now - t0
        log.info("sharded build: %s %.2fs", name, self.timings[name])
        return now

    # ---------------------------------------------------------------- build
    def build(self, data, n: Optional[int] = None) -> Tuple[np.ndarray, int]:
        """→ (adjacency [n, r] int32, −1 pad; entry point id). ``data``
        [n, D] host rows (numpy) or a tensor; each shard's rows go to its
        device, zero-padded to Nl."""
        t_start = t = time.time()
        self.timings, self.changed = {}, []
        host = (data.float().cpu().numpy() if isinstance(data, torch.Tensor)
                else np.asarray(data, dtype=np.float32))
        if n is None:
            n = host.shape[0]
        p = self.p
        nl0 = -(-n // p)
        chunk = max(64, min(self.chunk, (nl0 // 64) * 64 or nl0))
        nl = -(-nl0 // chunk) * chunk
        self.nl = nl
        dd, sq = [], []
        for s, dev in enumerate(self.devs):
            block = np.zeros((nl, host.shape[1]), np.float32)
            rows = host[s * nl: min((s + 1) * nl, n)]
            block[: rows.shape[0]] = rows
            x = torch.as_tensor(block, device=dev)
            dd.append(x)
            sq.append((x * x).sum(1))
        ring = ([x.to(torch.bfloat16) for x in dd], sq)
        k = self.knn_k
        # a random init needs ~log2(n) descent rounds
        rounds = self.rounds if self.rounds > 0 else max(
            8, int(np.ceil(np.log2(max(n, 2)))) + 2)

        kd, ki = self._init(dd, sq, ring, n, chunk, k)
        t = self._phase("init", t)
        for rd in range(rounds):
            kd, ki, ch = self._round(dd, sq, ring, kd, ki, n, chunk, k, rd)
            self.changed.append(ch)
            log.info("sharded nnd round %d/%d: %d changed", rd + 1, rounds,
                     ch)
            if ch < max(64, (n * k) // 2000):
                break
        t = self._phase("rounds", t)
        pool_d, pool_i = self._pools(dd, sq, ring, ki, n,
                                     max(64, chunk // 8), k)
        t = self._phase("pools", t)
        cand_d = [torch.cat([a, b], 1) for a, b in zip(pool_d, kd)]
        cand_i = [torch.cat([a, b], 1) for a, b in zip(pool_i, ki)]
        del pool_d, pool_i, kd, ki
        nbrs = self._prune(ring, cand_d, cand_i, n, max(64, chunk // 4))
        t = self._phase("prune", t)
        nbrs = self._reprune(dd, sq, ring, nbrs, n, max(64, chunk // 4))
        t = self._phase("reprune", t)
        # degree fill: occlusion thins rows to ~r/3; without the nearest
        # unselected pool candidates the graph is islands that repair's
        # single bridges cannot make navigable
        nbrs = self._fill(nbrs, cand_d, cand_i, n, max(64, chunk // 4))
        t = self._phase("fill", t)

        nbrs_np = torch.cat([x.cpu() for x in nbrs]).numpy()[:n]
        nbrs_np = np.where(nbrs_np < n, nbrs_np, -1).astype(np.int32)
        # entry point: the row nearest the mean of a sample (host, cheap)
        rng = np.random.default_rng(self.seed)
        samp = host[rng.integers(0, n, size=min(n, 4096))]
        mean = samp.mean(axis=0, keepdims=True)
        head = host[: min(n, 65536)]
        ep = int(np.argmin(((head - mean) ** 2).sum(axis=1)))
        log.info("sharded build done: n=%d r=%d over %d shards in %.1fs",
                 n, self.r, p, time.time() - t_start)
        return nbrs_np, ep

    # --------------------------------------------------------------- phases
    def _init(self, dd, sq, ring, n: int, chunk: int, k: int):
        kd, ki = [], []
        for s, dev in enumerate(self.devs):
            nl = dd[s].shape[0]
            cand = torch.randint(0, n, (nl, k + 8), dtype=torch.int32,
                                 generator=_gen(dev, self.seed, 1, s),
                                 device=dev)
            cand = _neg1(cand == _me(s * nl, 0, nl, dev), cand)
            d = _ring_dists(dd[s], sq[s], *ring, cand, s, n, self.metric,
                            chunk)
            sd, si = _sort_dedup(d, cand)
            kd.append(sd[:, :k].contiguous())
            ki.append(si[:, :k].contiguous())
        return kd, ki

    def _round(self, dd, sq, ring, kd, ki, n: int, chunk: int, k: int,
               rd: int):
        """One NN-Descent round. The forward samples of every node (the
        sources of the reverse edges into a shard's rows can be anywhere)
        are drawn once from the round's generator, as the JAX package draws
        them identically on every device."""
        # sample widths of the single-device NN-Descent (nndescent)
        s1, s2, s_rev, n_rand = max(4, k // 2), max(4, k // 4), max(8, k // 2), 4
        lead = self.devs[0]
        ki_full = torch.cat([x.to(lead) for x in ki])          # all_gather
        npd = ki_full.shape[0]
        g = _gen(lead, self.seed, 2, rd)
        sel1 = torch.randint(0, k, (npd, s1), generator=g, device=lead)
        mid_full = torch.gather(ki_full, 1, sel1)
        slot = torch.randint(0, s_rev, (npd, s1), generator=g, device=lead)
        changed = 0
        for s, dev in enumerate(self.devs):
            nl = ki[s].shape[0]
            base = s * nl
            kif, midf = ki_full.to(dev), mid_full.to(dev)
            rev = _scatter_reverse(midf, slot.to(dev), base, nl, s_rev)
            mid_c = midf[base:base + nl]
            gs = _gen(dev, self.seed, 3, rd, s)
            their = kif[torch.where(mid_c >= 0, mid_c,
                                    torch.zeros_like(mid_c)).long()]
            sel2 = torch.randint(0, k, (nl, s1, s2), generator=gs, device=dev)
            hop2 = torch.gather(their, 2, sel2)
            hop2 = torch.where(mid_c[:, :, None] >= 0, hop2,
                               torch.full_like(hop2, -1)).reshape(nl, s1 * s2)
            rand = torch.randint(0, n, (nl, n_rand), dtype=torch.int32,
                                 generator=gs, device=dev)
            cand = torch.cat([hop2, rev, rand], dim=1)
            cand = _neg1(cand == _me(base, 0, nl, dev), cand)
            d = _ring_dists(dd[s], sq[s], *ring, cand, s, n, self.metric,
                            chunk)
            for lo in range(0, nl, chunk):
                kd_c, ki_c = kd[s][lo:lo + chunk], ki[s][lo:lo + chunk]
                nd, ni = _dedup_merge_fast(kd_c, ki_c, d[lo:lo + chunk],
                                           cand[lo:lo + chunk], k)
                changed += int((ni != ki_c).sum())
                kd[s][lo:lo + chunk] = nd
                ki[s][lo:lo + chunk] = ni
        return kd, ki, changed

    def _pools(self, dd, sq, ring, ki, n: int, chunk: int, k: int):
        """Sampled 2-hop pools (16 samples per neighbor), the nearest
        ``ef`` kept, plus N_LONG long-edge slots exempt from that cut: a
        converged kNN's 2-hop pool is purely local, and the occlusion rule
        keeps the few diverse long edges. The slots hold the nearest
        N_LONG of LONG_DRAW random rows (the JAX package: 8 random rows)."""
        s2 = min(k, 16)
        ww = min(self.ef, k + k * s2)
        n_long, draw = N_LONG, LONG_DRAW
        lead = self.devs[0]
        ki_full = torch.cat([x.to(lead) for x in ki])          # all_gather
        pool_d, pool_i = [], []
        for s, dev in enumerate(self.devs):
            nl = ki[s].shape[0]
            base = s * nl
            kif = ki_full.to(dev)
            gs = _gen(dev, self.seed, 4, s)
            pd = torch.full((nl, ww + n_long), FINF, device=dev)
            pi = torch.full((nl, ww + n_long), -1, dtype=torch.int32,
                            device=dev)
            for lo in range(0, nl, chunk):
                ki_c = ki[s][lo:lo + chunk]
                c = ki_c.shape[0]
                their = kif[torch.where(ki_c >= 0, ki_c,
                                        torch.zeros_like(ki_c)).long()]
                sel = torch.randint(0, k, (c, k, s2), generator=gs,
                                    device=dev)
                hop2 = torch.gather(their, 2, sel)
                hop2 = torch.where((ki_c >= 0)[:, :, None], hop2,
                                   torch.full_like(hop2, -1)
                                   ).reshape(c, k * s2)
                rand = torch.randint(0, n, (c, draw), dtype=torch.int32,
                                     generator=gs, device=dev)
                cand = torch.cat([ki_c, hop2, rand], dim=1)
                cand = _neg1(cand == _me(base, lo, c, dev), cand)
                d = _ring_dists(dd[s][lo:lo + c], sq[s][lo:lo + c], *ring,
                                cand, s, n, self.metric, chunk)
                sd, si = _sort_dedup(d[:, :-draw], cand[:, :-draw])
                ld, li = _sort_dedup(d[:, -draw:], cand[:, -draw:])
                pd[lo:lo + c] = torch.cat([sd[:, :ww], ld[:, :n_long]], 1)
                pi[lo:lo + c] = torch.cat([si[:, :ww], li[:, :n_long]], 1)
            pool_d.append(pd)
            pool_i.append(pi)
        return pool_d, pool_i

    def _prune(self, ring, cand_d, cand_i, n: int, chunk: int):
        nbrs = []
        for s, dev in enumerate(self.devs):
            nl = cand_i[s].shape[0]
            out = torch.full((nl, self.r), -1, dtype=torch.int32, device=dev)
            for lo in range(0, nl, chunk):
                cd, ci = cand_d[s][lo:lo + chunk], cand_i[s][lo:lo + chunk]
                bad = (ci == _me(s * nl, lo, ci.shape[0], dev)) | (ci >= n)
                cd = torch.where(bad, torch.full_like(cd, FINF), cd)
                cd, ci = _sort_dedup(cd, _neg1(bad, ci))
                vecs, vsq = _ring_gather(*ring, ci, s, n)
                out[lo:lo + chunk] = _occlude_mat(cd, ci, vecs, vsq, self.r,
                                                  self.alpha, self.metric)
            nbrs.append(out)
        return nbrs

    def _reprune(self, dd, sq, ring, nbrs, n: int, chunk: int):
        """Bounded reverse table of every shard's own rows, scattered from
        the gathered adjacency (ids only), then the occlusion rule over
        [edges ∪ reverse edges]."""
        w = 2 * self.r
        lead = self.devs[0]
        nb_full = torch.cat([x.to(lead) for x in nbrs])         # all_gather
        slot = torch.randint(0, w, nb_full.shape,
                             generator=_gen(lead, self.seed, 5), device=lead)
        out_all = []
        for s, dev in enumerate(self.devs):
            nl = nbrs[s].shape[0]
            base = s * nl
            rev = _scatter_reverse(nb_full.to(dev), slot.to(dev), base, nl, w)
            out = torch.full((nl, self.r), -1, dtype=torch.int32, device=dev)
            for lo in range(0, nl, chunk):
                cand = torch.cat([nbrs[s][lo:lo + chunk],
                                  rev[lo:lo + chunk]], dim=1)
                c = cand.shape[0]
                cand = _neg1((cand == _me(base, lo, c, dev)) | (cand >= n),
                             cand)
                d = _ring_dists(dd[s][lo:lo + c], sq[s][lo:lo + c], *ring,
                                cand, s, n, self.metric, chunk)
                d, cand = _sort_dedup(d, cand)
                vecs, vsq = _ring_gather(*ring, cand, s, n)
                out[lo:lo + c] = _occlude_mat(d, cand, vecs, vsq, self.r,
                                              self.alpha, self.metric)
            out_all.append(out)
        return out_all

    def _fill(self, nbrs, cand_d, cand_i, n: int, chunk: int):
        """Free slots of each row filled with the nearest unselected pool ∪
        kNN candidates (the single-device ``fill_degree_dev``)."""
        r = self.r
        out_all = []
        for s, dev in enumerate(self.devs):
            nl = nbrs[s].shape[0]
            out = nbrs[s].clone()
            later = torch.triu(torch.ones((r, r), dtype=torch.bool,
                                          device=dev), 1)[None]
            for lo in range(0, nl, chunk):
                row = out[lo:lo + chunk]
                cd, ci = cand_d[s][lo:lo + chunk], cand_i[s][lo:lo + chunk]
                c = row.shape[0]
                in_row = (ci[:, :, None] == row[:, None, :]).any(2)
                ok = ((ci >= 0) & (ci < n) & ~in_row
                      & (ci != _me(s * nl, lo, c, dev)) & torch.isfinite(cd))
                order = torch.sort(torch.where(ok, cd,
                                               torch.full_like(cd, FINF)),
                                   dim=1, stable=True).indices
                add = torch.gather(_neg1(~ok, ci), 1, order)[:, :r]
                # pool ∪ kNN candidates overlap: drop later duplicates
                dup = ((add[:, None, :] == add[:, :, None]) & later).any(1)
                cat = torch.cat([row, _neg1(dup, add)], dim=1)
                order2 = torch.sort((cat < 0).to(torch.int8), dim=1,
                                    stable=True).indices
                out[lo:lo + chunk] = torch.gather(cat, 1, order2)[:, :r]
            out_all.append(out)
        return out_all


def build_graph_sharded(space, n: int, r: int, params, mesh=None,
                        timings: Optional[dict] = None, seed: int = 0):
    """The engine's hook: the base adjacency built on ``mesh`` (random
    streams from ``seed``), then the overlay levels, the device
    connectivity repair and the entry points, as the single-device HNSW
    pipeline finishes. Returns a Graph on the space's device; ``timings``
    (if given) gets the seconds of each phase."""
    from ..index.captured import scope
    from ..index.graph import Graph
    from ..index.hnsw import _build_overlay
    from ..index.repair_dev import repair_connectivity

    builder = ShardedGraphBuilder(
        mesh=mesh, r=r, knn_k=32, alpha=float(params.prune_alpha),
        ef=max(2 * r, 64), metric=space.metric, seed=seed)
    nbrs, ep = builder.build(space.data[:n], n)
    t = time.time()
    rng = np.random.default_rng(0xA1A7A ^ n)
    overlay, top_global = _build_overlay(space, n, r, rng)
    if top_global is not None:
        ep = top_global
    with scope():                    # the repair's graphs go with it
        nbrs = repair_connectivity(
            space, torch.as_tensor(nbrs, device=space.device), ep)
    extra = rng.integers(0, n, size=7).astype(np.int32)
    graph = Graph.from_rows(nbrs, eps=np.concatenate([[ep], extra]),
                            capacity=space.capacity, overlay=overlay)
    if timings is not None:
        timings.update(builder.timings)
        timings["overlay_repair"] = time.time() - t
        timings["nnd_rounds"] = float(len(builder.changed))
    return graph
