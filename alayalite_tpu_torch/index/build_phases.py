"""Device-resident builder phases (port of part of ``index/build_phases.py``).

Every heavy intermediate stays on the device; the JAX package's
``lax.scan`` over chunk starts becomes a Python loop here, writing each
chunk's rows into a preallocated output in place. The prune phases and the
two-hop pools run their chunks through ``captured.run_chunks``: one shape a
phase (the tail chunk overlaps), the chunk's row ids an input, no host
sync, and on the card each chunk one replay of a captured graph. A
builder's ``PhaseTimer`` runs each phase in a ``captured.scope()``, so no
graph of a fit, nor its memory pool, outlives its phase.

  search_pool_dev          beam-search pools over a raw (bf16) space
  block_pool_dev           the same beams over an interim block space
  twohop_pool_dev          kNN ∪ kNN² pools scored exactly (no beam)
  prune_all_dev            occlusion prune of [pool ∪ kNN] candidates
  reverse_edges_dev        bounded reverse-edge table by random-slot scatter
  reprune_with_reverse_dev re-prune every node over [edges ∪ reverse]
  fill_degree_dev          pad rows to exactly r with unused candidates

Random draws come from ``torch.Generator``s seeded with the integers the
JAX package turns into keys; the streams differ, so the graphs differ too.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import synchronize
from .captured import chunk_starts, run_chunks, scope
from .prune import occlusion_prune_chunk
from .search import beam_search, block_beam_search, scan_seeds

Tensor = torch.Tensor
FINF = float("inf")
log = logging.getLogger("alayalite_tpu_torch")


class PhaseTimer:
    """Seconds per build phase into ``timings``: calling it with a name
    closes that phase with a device sync. Used as a context manager, it
    also runs each phase in a ``captured.scope()`` of its own, so the
    graphs a phase captures, and their memory pool, go when it closes."""

    def __init__(self, device, prefix: str, timings: Dict[str, float]):
        self.device, self.prefix, self.timings = device, prefix, timings
        self.t = time.time()
        self._scope = None

    def __enter__(self) -> "PhaseTimer":
        self._scope = scope().__enter__()
        return self

    def __exit__(self, *exc) -> None:
        sc, self._scope = self._scope, None
        sc.__exit__(*exc)

    def __call__(self, name: str) -> None:
        if self._scope is not None:          # the next phase, a new scope
            self._scope.__exit__(None, None, None)
            self._scope = scope().__enter__()
        synchronize(self.device)
        now = time.time()
        self.timings[name] = now - self.t
        self.t = now
        log.info("%s: %s %.2fs", self.prefix, name, self.timings[name])


def make_generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0x7FFF_FFFF_FFFF_FFFF)
    return g


def bf16_pool_space(space):
    """Traversal-only bf16 copy of a raw space for the candidate-pool
    beams (pool distances only order candidates; the prune re-scores)."""
    return dataclasses.replace(space, data=space.data.to(torch.bfloat16),
                               bf16=True)


def _pool_seeds(eps_dev, qj, n, n_rand_seeds, gen, seed_sample):
    """[scan seeds ‖ entry points ‖ random nodes] per row of ``qj``."""
    b = qj.shape[0]
    rand = torch.randint(0, n, (b, n_rand_seeds), generator=gen,
                         device=qj.device, dtype=torch.int32)
    seeds = torch.cat([eps_dev[None, :].expand(b, -1), rand], dim=1)
    if seed_sample is not None:
        seeds = torch.cat([scan_seeds(qj, *seed_sample), seeds], dim=1)
    return seeds


def search_pool_dev(space, nbrs_dev: Tensor, eps: np.ndarray, ef: int,
                    n: int, chunk: int = 4096, n_rand_seeds: int = 16,
                    seed: int = 0, max_iters: int = 0,
                    seed_sample=None) -> Tuple[Tensor, Tensor]:
    """Beam-search pool for each of the first n nodes' own vectors over
    the adjacency ``nbrs_dev``. Returns (pool_d [n, ef], pool_i [n, ef])."""
    dev = space.device
    eps_dev = torch.as_tensor(np.asarray(eps, np.int32), device=dev)
    starts, chunk = chunk_starts(n, chunk)
    pool_d = torch.zeros((n, ef), dtype=torch.float32, device=dev)
    pool_i = torch.zeros((n, ef), dtype=torch.int32, device=dev)
    gen = make_generator(dev, seed ^ 0xB00F)
    for lo in starts:
        qj = space.data[lo:lo + chunk].float()
        seeds = _pool_seeds(eps_dev, qj, n, n_rand_seeds, gen, seed_sample)
        d, i = beam_search(space, nbrs_dev, seeds, qj, k=ef, ef=ef,
                           n_expand=8, max_iters=max_iters)
        pool_d[lo:lo + chunk] = d
        pool_i[lo:lo + chunk] = i
    return pool_d, pool_i


def block_pool_dev(bspace, eps: np.ndarray, ef: int, n: int,
                   chunk: int = 4096, n_rand_seeds: int = 16, seed: int = 0,
                   max_iters: int = 0, seed_sample=None,
                   n_expand: int = 8) -> Tuple[Tensor, Tensor]:
    """Beam-search pools over a block space whose neighbor blocks were
    packed from the kNN graph: one ``gather_estimate`` and one ``ring_probe``
    per hop. The in-search exact rerank makes the returned pool_d exact f32."""
    dev = bspace.device
    eps_dev = torch.as_tensor(np.asarray(eps, np.int32), device=dev)
    starts, chunk = chunk_starts(n, chunk)
    pool_d = torch.zeros((n, ef), dtype=torch.float32, device=dev)
    pool_i = torch.zeros((n, ef), dtype=torch.int32, device=dev)
    gen = make_generator(dev, seed ^ 0xB10C)
    for lo in starts:
        qj = bspace.data[lo:lo + chunk]
        seeds = _pool_seeds(eps_dev, qj, n, n_rand_seeds, gen, seed_sample)
        d, i = block_beam_search(bspace, seeds, qj, k=ef, ef=ef,
                                 n_expand=n_expand, max_iters=max_iters)
        pool_d[lo:lo + chunk] = d
        pool_i[lo:lo + chunk] = i
    return pool_d, pool_i


def twohop_pool_dev(space, knn_i: Tensor, ef: int, n: int,
                    chunk: int = 4096) -> Tuple[Tensor, Tensor]:
    """Pools from the kNN graph alone: each node's kNN row ∪ its
    neighbors' kNN rows (a [C, K + K²] gather a chunk), itself dropped,
    scored exactly, duplicates dropped, the ``ef`` best kept. Returns
    (pool_d [n, ef], pool_i [n, ef]), inf / −1 past the candidates. On the
    card each chunk is one replay (``captured.run_chunks``)."""
    from .prune import _sort_dedup

    def one_chunk(rows, ki):                                       # [C, K]
        ok = ki >= 0
        hop2 = knn_i[torch.where(ok, ki, torch.zeros_like(ki)).long()]
        hop2 = torch.where(ok[:, :, None], hop2, torch.full_like(hop2, -1))
        cand = torch.cat([ki, hop2.reshape(ki.shape[0], -1)], dim=1)
        cand = torch.where(cand == rows[:, None], torch.full_like(cand, -1),
                           cand)
        d = space.gather_dists(space.data[rows.long()].float(),
                               cand.clamp(min=0))
        d = torch.where(cand >= 0, d, torch.full_like(d, FINF))
        sd, si = _sort_dedup(d, cand)
        return sd[:, :ef], si[:, :ef]

    return run_chunks("twohop_pool", one_chunk, n, chunk, (knn_i[:n],),
                      reads=(space, knn_i), static=(ef,))


def _drop_self(cd: Tensor, ci: Tensor, rows: Tensor):
    is_me = ci == rows[:, None]
    return (torch.where(is_me, torch.full_like(cd, FINF), cd),
            torch.where(is_me, torch.full_like(ci, -1), ci))


def prune_all_dev(space, cand_d: Tensor, cand_i: Tensor, r: int,
                  alpha: float = 1.0, chunk: int = 4096) -> Tensor:
    """Occlusion-prune every node's candidate row (self-edges dropped). On
    the card each chunk is one replay (``captured.run_chunks``)."""
    def one_chunk(rows, cd, ci):
        cd, ci = _drop_self(cd, ci, rows)
        return (occlusion_prune_chunk(space, cd, ci, r=r, alpha=alpha),)

    return run_chunks("prune", one_chunk, cand_i.shape[0], chunk,
                      (cand_d, cand_i), reads=(space,),
                      static=(r, float(alpha)))[0]


_SCRAMBLE = 0x9E3779B1     # odd: position -> priority is a bijection mod 2^32


def pick_proposals(cell: Tensor, ok: Tensor, n_cells: int) -> Tensor:
    """[n_cells] i32: for each cell, the row i of the one proposal (i, j)
    with ``cell[i, j]`` = that cell and ``ok[i, j]`` that stays, −1 where
    none. Where proposals collide, the one whose position maps to the
    largest priority (``position · _SCRAMBLE mod 2^32``: a fixed
    pseudo-random order) stays, so the choice is reproducible and does not
    lean to high ids as "the last in (i, j) order" would (JAX's scatter
    leaves it open). A scatter of the priorities' maximum, masked
    proposals landing in a scratch cell: fixed in shape, no host sync, and
    the result does not depend on the order in which the writes land."""
    rows, s = cell.shape
    dev = cell.device
    flat = torch.where(ok, cell, n_cells).reshape(-1)
    pos = torch.arange(rows * s, dtype=torch.int64, device=dev)
    prio = (pos * _SCRAMBLE) & 0xFFFFFFFF
    best = torch.full((n_cells + 1,), -1, dtype=torch.int64, device=dev)
    best.scatter_reduce_(0, flat, torch.where(ok.reshape(-1), prio, -1),
                         reduce="amax")
    # the winners, one a cell, write their rows (the rest the scratch cell)
    won = ok.reshape(-1) & (prio == best[flat])
    out = torch.full((n_cells + 1,), -1, dtype=torch.int32, device=dev)
    out.scatter_(0, torch.where(won, flat, n_cells),
                 torch.where(won, pos // s, -1).to(torch.int32))
    return out[:n_cells]


def reverse_edges_dev(nbrs: Tensor, gen: torch.Generator,
                      width: int) -> Tensor:
    """Bounded reverse-edge table [n, width] by random-slot scatter: edge
    (i, j) proposes i at a random slot of row ``nbrs[i, j]``. Colliding
    proposals keep one entry (reservoir semantics), chosen by
    ``pick_proposals``."""
    n, r = nbrs.shape
    slot = torch.randint(0, width, (n, r), generator=gen, device=nbrs.device)
    rev = pick_proposals(nbrs.long() * width + slot, nbrs >= 0, n * width)
    return rev.view(n, width)


def reprune_with_reverse_dev(space, nbrs: Tensor, rev: Tensor, r: int,
                             alpha: float = 1.0, chunk: int = 4096) -> Tensor:
    """Re-prune every node over [current edges ∪ reverse candidates]. On
    the card each chunk is one replay (``captured.run_chunks``)."""
    def one_chunk(rows, nb, rv):
        ci = torch.cat([nb, rv], dim=1)
        ci = torch.where(ci == rows[:, None], torch.full_like(ci, -1), ci)
        ok = ci >= 0
        vecs = space.data[rows.long()].float()
        cd = space.gather_dists(vecs, torch.where(ok, ci,
                                                  torch.zeros_like(ci)))
        cd = torch.where(ok, cd, torch.full_like(cd, FINF))
        return (occlusion_prune_chunk(space, cd, ci, r=r, alpha=alpha),)

    return run_chunks("reprune", one_chunk, nbrs.shape[0], chunk,
                      (nbrs, rev), reads=(space,),
                      static=(r, float(alpha)))[0]


def fill_degree_dev(nbrs: Tensor, cand_d: Tensor, cand_i: Tensor, r: int,
                    chunk: int = 4096) -> Tensor:
    """Pad every row to exactly r edges with its nearest unused candidates
    (keep-first dedup of [row ‖ candidates by distance], compacted left).
    On the card each chunk is one replay (``captured.run_chunks``)."""
    def one_chunk(rows, nb, cd, ci):
        cd, ci = _drop_self(cd, ci, rows)
        order = torch.sort(cd, dim=1, stable=True).indices
        ci = torch.gather(ci, 1, order)
        cat = torch.cat([nb, ci], dim=1)
        s, order_keys = torch.sort(cat, dim=1, stable=True)
        first = torch.cat([torch.ones_like(s[:, :1], dtype=torch.bool),
                           s[:, 1:] != s[:, :-1]], dim=1) & (s >= 0)
        keep = torch.zeros_like(first).scatter_(1, order_keys, first)
        compact = torch.sort((~keep).to(torch.int8), dim=1,
                             stable=True).indices
        vals = torch.gather(torch.where(keep, cat, torch.full_like(cat, -1)),
                            1, compact)[:, :r]
        if vals.shape[1] < r:
            vals = torch.nn.functional.pad(vals, (0, r - vals.shape[1]),
                                           value=-1)
        return (vals,)

    return run_chunks("fill", one_chunk, nbrs.shape[0], chunk,
                      (nbrs, cand_d, cand_i), static=(r,))[0]
