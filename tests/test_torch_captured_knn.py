"""NN-Descent and the connectivity repair as the reference's jit runs them.

On the CPU, against the JAX package: the repair's BFS, label propagation
and representatives give the ids JAX's device repair gives on the same
adjacency; the fixed-shape attach writes what JAX's ``_attach_dev`` writes
(rows and protected slots equal); ``build_knn_graph`` at 6000 rows (the
random init) reaches within 0.01 of JAX's recall against exact kNN (the
random streams differ by design), and the cluster-init branch reaches
0.95.

On the CPU, against the port itself: a block of rounds equals a plain
per-chunk loop written out here on the same draws (quarter-integer rows,
so every distance is exact and no tie breaks another way), bit for bit;
the reverse samples keep, of a collision, the proposal a fixed
pseudo-random order ranks first; a block of rounds makes one host read.

With a CUDA device (``python -m pytest --noconftest -m gpu
tests/test_torch_captured_knn.py``: JAX is imported inside the CPU tests
only) NN-Descent and the repair run captured and uncaptured, bit for bit,
a replay adding the uncaptured call's launches; a phase's end drops its
graphs and their pool; a fit leaves no graph held and its reserved memory
after ``empty_cache`` within 0.25 GiB of an uncaptured fit's.
"""

import contextlib
import gc

import numpy as np
import pytest
import torch

from alayalite_tpu_torch.index import build_phases, captured, nndescent
from alayalite_tpu_torch.index import repair_dev
from alayalite_tpu_torch.spaces.raw import RawSpace

torch.set_num_threads(2)

DIM = 16


def _grid_rows(rng, n):
    """Quarter-integer rows in [0, 63.75]: every f32 distance is exact."""
    return rng.integers(0, 256, size=(n, DIM)).astype(np.float32) / 4


def _broken_graph(n=1200, r=8, parts=6, seed=0):
    """Rows in ``parts`` clusters whose edges stay inside their cluster,
    20% of them −1: many components, some nodes unreachable."""
    rng = np.random.default_rng(seed)
    part = np.arange(n) % parts
    data = (rng.normal(size=(n, DIM)) + part[:, None] * 4).astype(np.float32)
    nbrs = np.full((n, r), -1, dtype=np.int32)
    for p in range(parts):
        ids = np.flatnonzero(part == p)
        nbrs[ids] = rng.choice(ids[: max(1, ids.size - 5)], size=(ids.size, r))
    nbrs[rng.random((n, r)) < 0.2] = -1
    return data, nbrs


def _recall(ids, exact) -> float:
    k = exact.shape[1]
    return float(np.mean([len(set(a) & set(b)) / k
                          for a, b in zip(ids, exact)]))


# --------------------------------------------------- the repair against JAX
@pytest.mark.parametrize("seed", [0, 1])
def test_repair_loops_match_jax(seed):
    """BFS from node 0, the labels of the unreached subgraph and its
    representatives: the ids JAX's device repair gives (bool / int ids,
    equal)."""
    import jax.numpy as jnp

    from alayalite_tpu.index import repair_dev as jrd

    _, nbrs = _broken_graph(seed=seed)
    n = nbrs.shape[0]
    seed_mask = np.zeros(n, dtype=bool)
    seed_mask[0] = True
    got = repair_dev._expand_reached(torch.from_numpy(nbrs),
                                     torch.from_numpy(seed_mask))
    want = np.asarray(jrd._expand_reached_dev(jnp.asarray(nbrs),
                                              jnp.asarray(seed_mask)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < n
    mask = ~want
    labels = repair_dev._component_labels(torch.from_numpy(nbrs),
                                          torch.from_numpy(mask))
    jlabels = jrd._component_labels_dev(jnp.asarray(nbrs), jnp.asarray(mask))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    reps = repair_dev._representatives(labels, torch.from_numpy(mask))
    np.testing.assert_array_equal(
        reps.numpy(), np.asarray(jrd._representatives_dev(jlabels,
                                                          jnp.asarray(mask))))


@pytest.mark.parametrize("wrap", [False, True])
def test_attach_writes_what_jax_writes(wrap):
    """The fixed-shape attach against JAX's donated ``_attach_dev`` on the
    same pairs: invalid reps (n), a src with several pairs, protected
    slots, empty slots; ``wrap``: one src takes more pairs than its row
    has slots, so two pairs land on one slot (the later in pair order
    stays)."""
    import jax.numpy as jnp

    from alayalite_tpu.index.repair_dev import _attach_dev

    rng = np.random.default_rng(3 + wrap)
    n, r, k = 300, 8, 64
    nbrs = rng.integers(0, n, size=(n, r)).astype(np.int32)
    nbrs[rng.random((n, r)) < 0.3] = -1
    protected = rng.random((n, r)) < 0.2
    reps = np.sort(rng.choice(n, size=k, replace=False)).astype(np.int32)
    reps[-9:] = n                                          # padding
    srcs = rng.integers(0, 40, size=k).astype(np.int32)
    if wrap:
        srcs[:12] = 7                                      # 12 pairs, 8 slots
    t_nbrs, t_prot = torch.from_numpy(nbrs.copy()), torch.from_numpy(
        protected.copy())
    t_prot = repair_dev._attach(t_nbrs, torch.from_numpy(reps),
                                torch.from_numpy(srcs), t_prot)
    j_nbrs, j_prot = _attach_dev(jnp.asarray(nbrs), jnp.asarray(reps),
                                 jnp.asarray(srcs), jnp.asarray(protected))
    np.testing.assert_array_equal(t_nbrs.numpy(), np.asarray(j_nbrs))
    np.testing.assert_array_equal(t_prot.numpy(), np.asarray(j_prot))
    assert (t_nbrs.numpy() != nbrs).any()


def test_attach_with_no_valid_pair_writes_nothing():
    """Every pair invalid (the replay's warm-up inputs): no row changes."""
    rng = np.random.default_rng(5)
    n, r = 100, 8
    nbrs = torch.from_numpy(rng.integers(-1, n, size=(n, r)).astype(np.int32))
    prot = torch.from_numpy(rng.random((n, r)) < 0.5)
    want_n, want_p = nbrs.clone(), prot.clone()
    got_p = repair_dev._attach(nbrs, torch.full((16,), n, dtype=torch.int32),
                               torch.zeros(16, dtype=torch.int32), prot)
    assert torch.equal(nbrs, want_n) and torch.equal(got_p, want_p)


# --------------------------------------------------- NN-Descent against JAX
def test_build_knn_graph_recall_matches_jax():
    """6000 rows (random init, 18 rounds at most): each kNN row's recall
    against exact kNN, averaged, within 0.01 of JAX's on the same rows."""
    import jax.numpy as jnp

    from alayalite_tpu.index.nndescent import build_knn_graph as jax_knn
    from alayalite_tpu.spaces.raw import RawSpace as JaxRaw
    from alayalite_tpu_torch.index.knn import exact_knn
    from alayalite_tpu_torch.utils.datasets import random_dataset

    d = random_dataset(n=6000, dim=DIM, n_queries=1, seed=4)
    raw = RawSpace.create(6000, DIM).fit(torch.from_numpy(d.data))
    _, exact = exact_knn(raw.data, 16)
    _, ids = nndescent.build_knn_graph(raw, 6000, 16)
    _, jids = jax_knn(JaxRaw.create(6000, DIM).fit(jnp.asarray(d.data)),
                      6000, 16)
    got, want = _recall(ids.numpy(), exact.numpy()), _recall(jids,
                                                             exact.numpy())
    assert got >= want - 0.01, (got, want)


def test_cluster_init_branch_recall():
    """The cluster-local init (``cluster_init_min`` 1000 drives it at
    6000 rows) and the default rounds: recall against exact kNN ≥ 0.95
    (it reads 0.974-0.975 here, as before the rounds were captured)."""
    from alayalite_tpu_torch.index.knn import exact_knn
    from alayalite_tpu_torch.utils.datasets import random_dataset

    d = random_dataset(n=6000, dim=DIM, n_queries=1, seed=5)
    raw = RawSpace.create(6000, DIM).fit(torch.from_numpy(d.data))
    _, exact = exact_knn(raw.data, 16)
    _, ids = nndescent.build_knn_graph(raw, 6000, 16, cluster_init_min=1000)
    assert _recall(ids.numpy(), exact.numpy()) >= 0.95


# ---------------------------------------------- the port against itself
def _ref_round(x, kd, ki, draws, s_rev, chunk):
    """One round written out: the reverse sample by sequential writes
    (``_pick_reference``), then each chunk in order, candidates scored
    exactly and merged by a stable sort. kd / ki updated in place; returns
    the changed entries."""
    sel1, slot, sel2, rand = (t.numpy().astype(np.int64) for t in draws)
    n, k = ki.shape
    mid = np.take_along_axis(ki, sel1, 1)
    rev = _pick_reference(np.where(mid >= 0, mid * s_rev + slot, 0),
                          mid >= 0, n * s_rev).reshape(n, s_rev)
    changed = 0
    xd = x.astype(np.float64)
    for ci in range(-(-n // chunk)):
        lo = min(ci * chunk, n - chunk)
        mid_c = mid[lo:lo + chunk]
        their = ki[np.where(mid_c >= 0, mid_c, 0)]
        hop2 = np.take_along_axis(their, sel2[ci], 2)
        hop2 = np.where(mid_c[:, :, None] >= 0, hop2, -1).reshape(chunk, -1)
        cand = np.concatenate([hop2, rev[lo:lo + chunk], rand[ci]], 1)
        me = np.arange(lo, lo + chunk)[:, None]
        cand = np.where(cand == me, -1, cand)
        for b in range(chunk):
            row, c = lo + b, cand[b]
            dist = ((xd[np.where(c >= 0, c, 0)] - xd[row]) ** 2).sum(1)
            bad = c < 0
            for m in range(c.size):
                bad[m] |= (c[m] in c[:m]) or (c[m] in ki[row])
            cat_d = np.concatenate([kd[row], np.where(bad, np.inf, dist)
                                    .astype(np.float32)])
            cat_i = np.concatenate([ki[row], np.where(bad, -1, c)])
            order = np.argsort(cat_d, kind="stable")[:k]
            nd = cat_d[order]
            ni = np.where(np.isfinite(nd), cat_i[order], -1).astype(np.int32)
            changed += int((ni != ki[row]).sum())
            kd[row], ki[row] = nd, ni
    return changed


def test_block_equals_per_chunk_loop():
    """Two rounds of ``nnd_block`` (1000 rows in chunks of 384: the tail
    chunk overlaps) against ``_ref_round`` on the same generator's draws:
    distances, ids and each round's change count equal."""
    rng = np.random.default_rng(8)
    n, k = 1000, 8
    x = _grid_rows(rng, n)
    sp = RawSpace.create(n, DIM).fit(torch.from_numpy(x))
    shape = nndescent.round_shape(n, k, DIM)
    shape["chunk"] = 384
    kd0, ki0 = nndescent._init_random_knn(
        sp, n, k, build_phases.make_generator(sp.device, 3), chunk=384)
    kd, ki, changes = nndescent.nnd_block(
        sp, kd0.clone(), ki0.clone(), build_phases.make_generator(
            sp.device, 9), rounds=2, **shape)
    gen = build_phases.make_generator(sp.device, 9)
    rkd, rki = kd0.numpy().copy(), ki0.numpy().copy()
    want = []
    n_chunks = -(-n // 384)
    for _ in range(2):
        draws = nndescent._draw_round(
            gen, n, k, shape["s1"], shape["s2"], shape["s_rev"],
            shape["n_rand"], n_chunks, 384, sp.device)
        want.append(_ref_round(x, rkd, rki, draws, shape["s_rev"], 384))
    np.testing.assert_array_equal(ki.numpy(), rki)
    np.testing.assert_array_equal(kd.numpy(), rkd)
    assert changes.tolist() == want and want[0] > 0


def _pick_reference(cell, ok, n_cells):
    """Sequential writes: a proposal replaces the cell's entry where its
    priority (position · _SCRAMBLE mod 2^32) is larger."""
    rows, s = cell.shape
    best = {}
    for i in range(rows):
        for j in range(s):
            if ok[i, j]:
                p = ((i * s + j) * build_phases._SCRAMBLE) & 0xFFFFFFFF
                c = int(cell[i, j])
                if c not in best or p > best[c][0]:
                    best[c] = (p, i)
    out = np.full(n_cells, -1, dtype=np.int32)
    for c, (_, i) in best.items():
        out[c] = i
    return out


@pytest.mark.parametrize("n,k,s1,s_rev", [(50, 4, 4, 4), (200, 8, 8, 3),
                                          (30, 6, 6, 16)])
def test_reverse_sample_collision_rule(n, k, s1, s_rev):
    """Every node's forward edges land on a few hub rows, so slots
    collide: the reverse table holds, of each slot's proposals, the one
    of the largest fixed pseudo-random priority, as sequential writes
    written out here leave it, and the kept rows do not lean to high ids
    as the last proposal in (node, slot) order would; −1 edges propose
    nothing. The build's reverse edges take the same rule."""
    rng = np.random.default_rng(n)
    ki = rng.integers(0, 5, size=(n, k)).astype(np.int32)
    ki[rng.random((n, k)) < 0.2] = -1
    sel1 = torch.from_numpy(rng.integers(0, k, size=(n, s1)).astype(np.uint8))
    slot = torch.from_numpy(rng.integers(0, s_rev, size=(n, s1))
                            .astype(np.uint8))
    mid, rev = nndescent._nnd_reverse_sample(torch.from_numpy(ki), sel1,
                                             slot, s_rev)
    m = mid.numpy()
    cell = np.where(m >= 0, m * s_rev + slot.numpy(), 0)
    want = _pick_reference(cell, m >= 0, n * s_rev).reshape(n, s_rev)
    np.testing.assert_array_equal(rev.numpy(), want)
    kept = rev.numpy()[rev.numpy() >= 0]
    assert kept.size and kept.mean() < 0.8 * (n - 1)
    gen = build_phases.make_generator(torch.device("cpu"), 4)
    rev2 = build_phases.reverse_edges_dev(torch.from_numpy(ki), gen, s_rev)
    slots = torch.randint(0, s_rev, ki.shape, generator=(
        build_phases.make_generator(torch.device("cpu"), 4))).numpy()
    cell2 = np.where(ki >= 0, ki * s_rev + slots, 0)
    np.testing.assert_array_equal(
        rev2.numpy(), _pick_reference(cell2, ki >= 0, n * s_rev)
        .reshape(n, s_rev))


@pytest.mark.parametrize("cluster_init_min", [100_000, 1000])
def test_block_makes_one_host_read(cluster_init_min, monkeypatch):
    """8 rounds at 6000 rows are two blocks: two reads of a change vector
    (``tolist``) and no other read of a tensor's value on the host; the
    stated count adds the cluster init's anchor upload."""
    from alayalite_tpu_torch.utils.datasets import random_dataset

    reads = []
    for name in ("tolist", "item", "__bool__", "__int__", "__float__",
                 "numpy", "cpu"):
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, _name=name, **kw):
            reads.append(_name)
            return _real(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    d = random_dataset(n=6000, dim=DIM, n_queries=1, seed=6)
    raw = RawSpace.create(6000, DIM).fit(torch.from_numpy(d.data))
    reads.clear()
    s0 = nndescent.build_knn_graph.syncs
    nndescent.build_knn_graph(raw, 6000, 16, max_iters=8,
                              cluster_init_min=cluster_init_min)
    assert reads == ["tolist", "tolist"], reads
    stated = 2 + (nndescent.INIT_SYNCS if cluster_init_min < 6000 else 0)
    assert nndescent.build_knn_graph.syncs - s0 == stated


# ------------------------------------------------------------- on the card
def test_phase_timer_with_and_without_a_scope():
    """A PhaseTimer records each phase's seconds used bare and as a
    context manager; as one it runs each phase in a scope of its own, and
    leaves none open."""
    dev = torch.device("cpu")
    bare = {}
    build_phases.PhaseTimer(dev, "t", bare)("a")
    assert list(bare) == ["a"] and captured._scopes() == []
    timed = {}
    with build_phases.PhaseTimer(dev, "t", timed) as phase:
        first = captured._scopes()
        assert len(first) == 1
        first = first[0]
        phase("a")
        assert captured._scopes() and captured._scopes()[0] is not first
        phase("b")
        assert len(captured._scopes()) == 1
    assert list(timed) == ["a", "b"] and captured._scopes() == []


def _cuda_space(n=20_000, dim=32, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(64, dim)) * 4
    x = centers[rng.integers(0, 64, size=n)] + rng.normal(size=(n, dim))
    return RawSpace.create(n, dim, device=torch.device("cuda")).fit(
        torch.as_tensor(x.astype(np.float32), device="cuda"))


def _delta(before):
    return {k: v - before[k] for k, v in captured.counts().items()}


@pytest.mark.gpu
def test_cuda_knn_captured_equals_uncaptured():
    """NN-Descent over 20k rows (cluster init, 8 rounds) inside one scope:
    the captured call and a replay equal the uncaptured call bit for bit,
    and the replay adds the uncaptured call's launches."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    sp = _cuda_space()
    n = sp.num

    def call(mode):
        before = captured.counts()
        with contextlib.nullcontext() if mode else captured.eager():
            out = nndescent.build_knn_graph(sp, n, 16, max_iters=8,
                                            cluster_init_min=1000)
        return out, _delta(before)

    want, d_u = call(False)
    with captured.scope():
        first, _ = call(True)
        got, d_c = call(True)
        assert captured.cached() >= 3
    for out in (first, got):
        assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert d_c == d_u and any(d_u.values())
    assert captured.held() == []


@pytest.mark.gpu
def test_cuda_repair_captured_equals_uncaptured():
    """The repair of a broken 20k graph, from one buffer each call: the
    captured calls equal the uncaptured one bit for bit, the replay adds
    its launches, and every node is reached."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    data, nbrs = _broken_graph(n=20_000, r=16, parts=40)
    sp = RawSpace.create(data.shape[0], DIM, device=torch.device(
        "cuda")).fit(torch.as_tensor(data, device="cuda"))
    nb0 = torch.as_tensor(nbrs, device="cuda")
    buf = torch.empty_like(nb0)

    def call(mode):
        before = captured.counts()
        with contextlib.nullcontext() if mode else captured.eager():
            out = repair_dev.repair_connectivity(sp, buf.copy_(nb0),
                                                 0).clone()
        return out, _delta(before)

    want, _ = call(False)
    with captured.scope():
        first, _ = call(True)
        got, _ = call(True)
    assert torch.equal(first, want) and torch.equal(got, want)
    assert not torch.equal(want, nb0)
    seed = torch.zeros(nb0.shape[0], dtype=torch.bool, device="cuda")
    seed[0] = True
    assert bool(repair_dev._expand_reached(want, seed).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bsq8", "hnsw"])
def test_cuda_fit_holds_no_graph(kind):
    """A fit on the card leaves no graph held, and its reserved memory
    after ``empty_cache`` is within 0.25 GiB of the same fit uncaptured;
    the two fits' adjacency is equal."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from alayalite_tpu_torch import Index, IndexParams

    rng = np.random.default_rng(1)
    x = rng.normal(size=(30_000, 32)).astype(np.float32)
    params = dict(index_type="hnsw", capacity=31_000)
    if kind == "bsq8":
        params.update(quantization_type="bsq8", max_nbrs=32)
    captured.clear()
    graphs, held = [], []
    for mode in (True, False):
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved()
        idx = Index(f"fit_{mode}", IndexParams(**params))
        with contextlib.nullcontext() if mode else captured.eager():
            idx._engine.fit(x)
        torch.cuda.synchronize()
        assert captured.held() == []
        gc.collect()
        torch.cuda.empty_cache()
        held.append((torch.cuda.memory_reserved() - base) / 2**30)
        graphs.append(idx._engine.graph.nbrs)
        del idx
    assert held[0] - held[1] <= 0.25, held
    assert torch.equal(graphs[0], graphs[1])


@pytest.mark.gpu
def test_cuda_phase_end_drops_graphs_and_pool():
    """Inside a PhaseTimer, the graphs a phase captured and their pool go
    when the phase ends; the next phase captures into a pool of its own."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    data, nbrs = _broken_graph(n=20_000, r=16, parts=40)
    sp = RawSpace.create(data.shape[0], DIM, device=torch.device(
        "cuda")).fit(torch.as_tensor(data, device="cuda"))
    nb0 = torch.as_tensor(nbrs, device="cuda")
    with captured.eager():
        want = repair_dev.repair_connectivity(sp, nb0.clone(), 0)
    with build_phases.PhaseTimer(sp.device, "t", {}) as phase:
        got = repair_dev.repair_connectivity(sp, nb0.clone(), 0)
        first = phase._scope
        assert captured.held() and first.pools
        phase("repair")
        assert captured.held() == [] and not first.pools
        again = repair_dev.repair_connectivity(sp, nb0.clone(), 0)
        assert captured.held() and phase._scope.pools
        phase("repair_again")
    assert captured.held() == [] and captured._scopes() == []
    assert torch.equal(got, want) and torch.equal(again, want)
