"""NN-Descent: batched k-NN-graph construction (port of ``index/nndescent.py``).

Each round, every node gathers a sample of its neighbors' neighbors, a
bounded reverse-edge sample and a few random nodes; one batched distance
evaluation scores them and a compare-matrix dedup + top-k merge updates the
node's kNN row. Chunks of a round run in order and update the kNN state in
place, so a later chunk sees the rows an earlier one improved, as in the
JAX package's in-jit loop. Rounds run in blocks of four; the build stops
when the last round of a block changed at most ``MIN_UPDATE_FRAC·n·k``
entries.

Above ``cluster_init_min`` rows (100k, the JAX value) the rows start from
a cluster-local init instead of random ones; the gate is an argument so a
small input can drive that branch.
"""

from __future__ import annotations

import logging
import time
from typing import Tuple

import numpy as np
import torch

from ..ops.topk import topk_smallest
from .build_phases import make_generator

log = logging.getLogger("alayalite_tpu_torch")

Tensor = torch.Tensor
FINF = float("inf")


def _dedup_merge_fast(pool_d, pool_i, cand_d, cand_i, k: int):
    """Merge candidates into pools dropping duplicates: a candidate is
    dropped if it repeats an earlier candidate or a pool id ([C, M, M] and
    [C, M, K] compares). Pool ids are unique on entry and exit."""
    M = cand_i.shape[1]
    tril = torch.tril(torch.ones((M, M), dtype=torch.bool,
                                 device=cand_i.device), -1)
    dup_earlier = ((cand_i[:, :, None] == cand_i[:, None, :])
                   & tril[None]).any(2)
    in_pool = (cand_i[:, :, None] == pool_i[:, None, :]).any(2)
    bad = (cand_i < 0) | dup_earlier | in_pool
    cand_d = torch.where(bad, torch.full_like(cand_d, FINF), cand_d)
    cand_i = torch.where(bad, torch.full_like(cand_i, -1), cand_i)
    nd, sel = topk_smallest(torch.cat([pool_d, cand_d], dim=1), k)
    ni = torch.gather(torch.cat([pool_i, cand_i], dim=1), 1, sel)
    return nd, torch.where(torch.isfinite(nd), ni, torch.full_like(ni, -1))


def _nnd_reverse_sample(knn_i: Tensor, gen, s1: int, s_rev: int):
    """Sample s1 forward edges per node and scatter a bounded reverse-edge
    table [N, s_rev]. Colliding writes keep one entry, which one is
    unspecified (``index_put_`` with duplicate indices on CUDA is
    nondeterministic, like the JAX scatter). Returns (mid, rev)."""
    N, K = knn_i.shape
    dev = knn_i.device
    sel1 = torch.randint(0, K, (N, s1), generator=gen, device=dev)
    mid = torch.gather(knn_i, 1, sel1)                            # [N, s1]
    slot = torch.randint(0, s_rev, (N, s1), generator=gen, device=dev)
    src = torch.arange(N, dtype=torch.int32, device=dev)[:, None].expand(N, s1)
    rev = torch.full((N, s_rev), -1, dtype=torch.int32, device=dev)
    ok = mid >= 0
    rev[mid[ok].long(), slot[ok]] = src[ok]
    return mid, rev


def _nnd_round_chunk(space, knn_d, knn_i, mid, rev, gen, lo: int, s2: int,
                     n_rand: int, chunk: int) -> int:
    """One join for nodes [lo, lo+chunk), updating knn_d/knn_i in place.
    Returns the number of changed kNN entries."""
    N, K = knn_i.shape
    dev = knn_i.device
    mid_c = mid[lo:lo + chunk]
    C, s1 = mid_c.shape
    their = knn_i.index_select(
        0, torch.where(mid_c >= 0, mid_c, torch.zeros_like(mid_c)).reshape(-1)
    ).view(C, s1, K)
    sel2 = torch.randint(0, K, (C, s1, s2), generator=gen, device=dev)
    hop2 = torch.gather(their, 2, sel2)
    hop2 = torch.where(mid_c[:, :, None] >= 0, hop2,
                       torch.full_like(hop2, -1)).reshape(C, s1 * s2)
    rand = torch.randint(0, N, (C, n_rand), generator=gen, device=dev,
                         dtype=torch.int32)
    cand = torch.cat([hop2, rev[lo:lo + chunk], rand], dim=1)
    me = lo + torch.arange(C, dtype=torch.int32, device=dev)[:, None]
    cand = torch.where(cand == me, torch.full_like(cand, -1), cand)
    ok = cand >= 0
    qv = space.data[lo:lo + chunk].float()
    d = space.gather_dists(qv, torch.where(ok, cand, torch.zeros_like(cand)))
    d = torch.where(ok, d, torch.full_like(d, FINF))
    ki_c = knn_i[lo:lo + chunk]
    new_d, new_i = _dedup_merge_fast(knn_d[lo:lo + chunk], ki_c, d, cand, K)
    changed = (new_i != ki_c).sum()
    knn_d[lo:lo + chunk] = new_d
    knn_i[lo:lo + chunk] = new_i
    return changed


def _init_random_knn(space, n: int, k: int, gen, chunk: int):
    dev = space.device
    kd = torch.zeros((n, k), dtype=torch.float32, device=dev)
    ki = torch.zeros((n, k), dtype=torch.int32, device=dev)
    chunk = min(chunk, n)
    for lo in range(0, n, chunk):
        start = min(lo, n - chunk)
        cand = torch.randint(0, n, (chunk, k), generator=gen, device=dev,
                             dtype=torch.int32)
        me = start + torch.arange(chunk, dtype=torch.int32,
                                  device=dev)[:, None]
        cand = torch.where(cand == me, (cand + 1) % n, cand)
        d = space.gather_dists(space.data[start:start + chunk].float(), cand)
        pd = torch.full((chunk, k), FINF, device=dev)
        pi = torch.full((chunk, k), -1, dtype=torch.int32, device=dev)
        kd[start:start + chunk], ki[start:start + chunk] = _dedup_merge_fast(
            pd, pi, d, cand, k)
    return kd, ki


def _init_cluster_knn(space, n: int, k: int, seed: int, chunk: int):
    """Cluster-local init: random anchors → nearest anchor of every node
    (bf16 values, f32 products) → each node's row starts from k random
    members of its own cluster ∪ k random nodes."""
    dev = space.device
    rng = np.random.default_rng(seed)
    n_anchors = int(min(max(256, n // 256), 16384))
    anchors = np.sort(rng.choice(n, size=n_anchors, replace=False))
    a_vecs = space.data[torch.as_tensor(anchors, device=dev)].float()
    a_sq = (a_vecs * a_vecs).sum(-1)
    a_t = a_vecs.to(torch.bfloat16).float().T
    c = min(chunk, n)
    assign = torch.empty((n,), dtype=torch.int32, device=dev)
    for lo in range(0, n, c):
        q = space.data[lo:min(lo + c, n)].to(torch.bfloat16).float()
        # |q|² is constant per row: argmin of |a|² − 2 q·a
        assign[lo:lo + c] = torch.argmin(a_sq[None, :] - 2.0 * (q @ a_t),
                                         dim=1).to(torch.int32)
    order = torch.sort(assign, stable=True).indices.to(torch.int32)
    counts = torch.bincount(assign, minlength=n_anchors).to(torch.int32)
    starts_c = torch.cumsum(counts, 0, dtype=torch.int32) - counts

    gen = make_generator(dev, seed ^ 0x5EED)
    kd = torch.zeros((n, k), dtype=torch.float32, device=dev)
    ki = torch.zeros((n, k), dtype=torch.int32, device=dev)
    starts = list(range(0, n - c + 1, c)) or [0]
    if n % c and starts[-1] + c < n:
        starts.append(n - c)
    for lo in starts:
        a = assign[lo:lo + c].long()
        cnt = torch.clamp(counts[a], min=1)
        pos = torch.randint(0, 2**30, (c, k), generator=gen, device=dev,
                            dtype=torch.int32) % cnt[:, None]
        local = order[((starts_c[a][:, None] + pos) % n).long()]
        rand = torch.randint(0, n, (c, k), generator=gen, device=dev,
                             dtype=torch.int32)
        cc = torch.cat([local, rand], dim=1)
        me = lo + torch.arange(c, dtype=torch.int32, device=dev)[:, None]
        cc = torch.where(cc == me, torch.full_like(cc, -1), cc)
        ok = cc >= 0
        d = space.gather_dists(space.data[lo:lo + c].float(),
                               torch.where(ok, cc, torch.zeros_like(cc)))
        d = torch.where(ok, d, torch.full_like(d, FINF))
        pd = torch.full((c, k), FINF, device=dev)
        pi = torch.full((c, k), -1, dtype=torch.int32, device=dev)
        kd[lo:lo + c], ki[lo:lo + c] = _dedup_merge_fast(pd, pi, d, cc, k)
    return kd, ki


SAMPLE_RATE = 0.5          # forward-edge sample per round, as a share of k
MIN_UPDATE_FRAC = 0.001    # stop when a round changes ≤ this share of n·k
EXACT_THRESHOLD = 4096     # exact all-pairs kNN up to this many rows


def build_knn_graph(space, n: int, k: int, max_iters: int = 0, seed: int = 0,
                    cluster_init_min: int = 100_000,
                    ) -> Tuple[Tensor, Tensor]:
    """Approximate kNN graph of the first ``n`` rows of ``space``:
    (dists [n, k] f32, ids [n, k] i32) on the space's device. Exact
    all-pairs search up to EXACT_THRESHOLD rows."""
    if max_iters <= 0:
        max_iters = (12 if n > 100_000
                     else max(12, int(np.log2(max(n, 2))) + 6))
    if n <= EXACT_THRESHOLD:
        from .knn import exact_knn

        return exact_knn(space.data[:n].float(), k, metric=space.metric)

    s1 = max(4, int(k * SAMPLE_RATE))
    s2 = max(4, int(k * SAMPLE_RATE) // 2)
    s_rev = max(8, k // 2)
    n_rand = 4
    # bound the [chunk, s1·s2 + s_rev + n_rand, D] gather to ~2.5 GB
    m_width = s1 * s2 + s_rev + n_rand
    chunk = min(n, max(2048, int(2.5e9 / (m_width * space.dim * 4))))

    t0 = time.time()
    if n > cluster_init_min:
        knn_d, knn_i = _init_cluster_knn(space, n, k, seed, chunk=chunk)
    else:
        knn_d, knn_i = _init_random_knn(space, n, k,
                                        make_generator(space.device, seed),
                                        chunk=chunk)
    gen = make_generator(space.device, seed + 1)
    n_chunks = -(-n // chunk)
    block = 4  # rounds between convergence checks
    it = 0
    while it < max_iters:
        rounds = min(block, max_iters - it)
        changes = []
        for _ in range(rounds):
            mid, rev = _nnd_reverse_sample(knn_i, gen, s1=s1, s_rev=s_rev)
            changed = 0
            for ci in range(n_chunks):
                lo = min(ci * chunk, n - chunk)
                changed = changed + _nnd_round_chunk(
                    space, knn_d, knn_i, mid, rev, gen, lo, s2=s2,
                    n_rand=n_rand, chunk=chunk)
            changes.append(int(changed))
        it += rounds
        log.info("nndescent rounds %d-%d: changed=%s (%.1fs)", it - rounds,
                 it - 1, changes, time.time() - t0)
        if changes[-1] <= MIN_UPDATE_FRAC * n * k:
            break
    return knn_d, knn_i
