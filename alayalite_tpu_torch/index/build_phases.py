"""Device-resident builder phases (port of part of ``index/build_phases.py``).

Every heavy intermediate stays on the device; the JAX package's
``lax.scan`` over chunk starts becomes a plain Python loop here, writing
each chunk's rows into a preallocated output in place.

  search_pool_dev          beam-search pools over a raw (bf16) space
  block_pool_dev           the same beams over an interim block space
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
from .prune import occlusion_prune_chunk
from .search import beam_search, block_beam_search, scan_seeds

Tensor = torch.Tensor
FINF = float("inf")
log = logging.getLogger("alayalite_tpu_torch")


class PhaseTimer:
    """Seconds per build phase into ``timings``: calling it with a name
    closes that phase with a device sync."""

    def __init__(self, device, prefix: str, timings: Dict[str, float]):
        self.device, self.prefix, self.timings = device, prefix, timings
        self.t = time.time()

    def __call__(self, name: str) -> None:
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


def _chunks(n: int, chunk: int):
    """Chunk starts covering [0, n) with a possibly-overlapping tail."""
    chunk = min(chunk, n)
    starts = list(range(0, n - chunk + 1, chunk))
    if n % chunk and (not starts or starts[-1] + chunk < n):
        starts.append(n - chunk)
    return starts, chunk


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
                    seed: int = 0, max_iters: int = 0, seed_sample=None,
                    ) -> Tuple[Tensor, Tensor]:
    """Beam-search pool for each of the first n nodes' own vectors over
    the adjacency ``nbrs_dev``. Returns (pool_d [n, ef], pool_i [n, ef])."""
    dev = space.device
    eps_dev = torch.as_tensor(np.asarray(eps, np.int32), device=dev)
    starts, chunk = _chunks(n, chunk)
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
                   max_iters: int = 0, seed_sample=None, n_expand: int = 8,
                   ) -> Tuple[Tensor, Tensor]:
    """Beam-search pools over a block space whose neighbor blocks were
    packed from the kNN graph: one ``gather_estimate`` and one ``ring_probe``
    per hop. The in-search exact rerank makes the returned pool_d exact f32."""
    dev = bspace.device
    eps_dev = torch.as_tensor(np.asarray(eps, np.int32), device=dev)
    starts, chunk = _chunks(n, chunk)
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


def _drop_self(cd: Tensor, ci: Tensor, lo: int):
    me = lo + torch.arange(ci.shape[0], dtype=torch.int32,
                           device=ci.device)[:, None]
    is_me = ci == me
    return (torch.where(is_me, torch.full_like(cd, FINF), cd),
            torch.where(is_me, torch.full_like(ci, -1), ci))


def prune_all_dev(space, cand_d: Tensor, cand_i: Tensor, r: int,
                  alpha: float = 1.0, chunk: int = 4096) -> Tensor:
    """Occlusion-prune every node's candidate row (self-edges dropped)."""
    n = cand_i.shape[0]
    starts, chunk = _chunks(n, chunk)
    out = torch.zeros((n, r), dtype=torch.int32, device=cand_i.device)
    for lo in starts:
        cd, ci = _drop_self(cand_d[lo:lo + chunk], cand_i[lo:lo + chunk], lo)
        out[lo:lo + chunk] = occlusion_prune_chunk(space, cd, ci, r=r,
                                                   alpha=alpha)
    return out


def reverse_edges_dev(nbrs: Tensor, gen: torch.Generator,
                      width: int) -> Tensor:
    """Bounded reverse-edge table [n, width] by random-slot scatter.
    Colliding writes drop all but one entry (reservoir semantics); which
    one survives is unspecified, as ``index_put_`` with duplicate indices
    on CUDA is nondeterministic, like the JAX scatter it replaces."""
    n, r = nbrs.shape
    src = torch.arange(n, dtype=torch.int32, device=nbrs.device)[:, None]
    slot = torch.randint(0, width, (n, r), generator=gen, device=nbrs.device)
    ok = nbrs >= 0
    rev = torch.full((n, width), -1, dtype=torch.int32, device=nbrs.device)
    rev[nbrs[ok].long(), slot[ok]] = src.expand(n, r)[ok]
    return rev


def reprune_with_reverse_dev(space, nbrs: Tensor, rev: Tensor, r: int,
                             alpha: float = 1.0, chunk: int = 4096) -> Tensor:
    """Re-prune every node over [current edges ∪ reverse candidates]."""
    n = nbrs.shape[0]
    starts, chunk = _chunks(n, chunk)
    out = torch.zeros((n, r), dtype=torch.int32, device=nbrs.device)
    for lo in starts:
        ci = torch.cat([nbrs[lo:lo + chunk], rev[lo:lo + chunk]], dim=1)
        me = lo + torch.arange(ci.shape[0], dtype=torch.int32,
                               device=ci.device)[:, None]
        ci = torch.where(ci == me, torch.full_like(ci, -1), ci)
        ok = ci >= 0
        vecs = space.data[lo:lo + chunk].float()
        cd = space.gather_dists(vecs, torch.where(ok, ci, torch.zeros_like(ci)))
        cd = torch.where(ok, cd, torch.full_like(cd, FINF))
        out[lo:lo + chunk] = occlusion_prune_chunk(space, cd, ci, r=r,
                                                   alpha=alpha)
    return out


def fill_degree_dev(nbrs: Tensor, cand_d: Tensor, cand_i: Tensor, r: int,
                    chunk: int = 4096) -> Tensor:
    """Pad every row to exactly r edges with its nearest unused candidates
    (keep-first dedup of [row ‖ candidates by distance], compacted left)."""
    n = nbrs.shape[0]
    starts, chunk = _chunks(n, chunk)
    out = torch.zeros((n, r), dtype=torch.int32, device=nbrs.device)
    for lo in starts:
        cd, ci = _drop_self(cand_d[lo:lo + chunk], cand_i[lo:lo + chunk], lo)
        order = torch.sort(cd, dim=1, stable=True).indices
        ci = torch.gather(ci, 1, order)
        cat = torch.cat([nbrs[lo:lo + chunk], ci], dim=1)
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
        out[lo:lo + chunk] = vals
    return out
