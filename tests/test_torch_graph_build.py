"""The raw graph builders of the port (hnsw with its overlay, nsg, fusion):
the overlay against the JAX package's for the same seed, the graphs'
invariants, bf16 storage, the quick start with the default parameters, and
what a raw graph index refuses. The recall of port-built graphs against
JAX-built ones shares the JAX fits of ``tests/test_torch_graph_search.py``
and lives there."""

import numpy as np
import pytest
import torch

from alayalite_tpu_torch import Client, Index, IndexParams
from alayalite_tpu_torch.index.engine import IndexEngine
from alayalite_tpu_torch.index.graph import Graph
from alayalite_tpu_torch.spaces.raw import RawSpace
from alayalite_tpu_torch.utils.datasets import random_dataset
from alayalite_tpu_torch.utils.evaluate import calc_gt, calc_recall

# the tensors here are small: more threads only contend with the other
# test workers' (the fits run twice as fast with two)
torch.set_num_threads(2)

N, DIM, K = 1200, 16, 10


@pytest.fixture(scope="module")
def ds():
    d = random_dataset(n=N, dim=DIM, n_queries=64, seed=11)
    d.gt = calc_gt(d.data, d.queries, K, device="cpu")
    return d


@pytest.mark.parametrize("capacity", [N, 2 * N + 5])
@pytest.mark.parametrize("r,seed", [(8, 0), (16, 3)])
def test_overlay_matches_jax(ds, r, seed, capacity):
    """Same n, r and seed: the same level members, down maps and slot
    padding as JAX's ``_build_overlay``, and the same exact kNN rows."""
    import jax.numpy as jnp

    from alayalite_tpu.index.hnsw import _build_overlay as jax_overlay
    from alayalite_tpu.spaces.raw import RawSpace as JaxRaw
    from alayalite_tpu_torch.index.hnsw import _build_overlay

    jsp = JaxRaw.create(capacity, DIM).fit(jnp.asarray(ds.data))
    sp = RawSpace.create(capacity, DIM).fit(torch.from_numpy(ds.data))
    want, jtop = jax_overlay(jsp, N, r, np.random.default_rng(seed))
    got, top = _build_overlay(sp, N, r, np.random.default_rng(seed))
    assert top == jtop and len(got) == len(want) == 2
    for lvl, jlvl in zip(got, want):
        np.testing.assert_array_equal(lvl.ids.numpy(), np.asarray(jlvl.ids))
        np.testing.assert_array_equal(lvl.down.numpy(), np.asarray(jlvl.down))
        assert lvl.nbrs.shape == jlvl.nbrs.shape
        assert lvl.size % 8 == 0
        # exact kNN both sides; a tie may order two neighbors differently
        same = (lvl.nbrs.numpy() == np.asarray(jlvl.nbrs)).mean()
        assert same >= 0.99, same
    # every level's down map names the same node one level below
    for upper, lower in zip(got, got[1:]):
        live = upper.ids >= 0
        assert torch.equal(lower.ids[upper.down[live].long()],
                           upper.ids[live])
    bottom = got[-1]
    assert torch.equal(bottom.down, bottom.ids)


def test_no_overlay_below_the_level_threshold():
    from alayalite_tpu_torch.index.hnsw import _build_overlay

    sp = RawSpace.create(60, 4).fit(torch.randn(60, 4))
    assert _build_overlay(sp, 60, 8, np.random.default_rng(0)) == ((), None)


def test_union_rows_matches_jax():
    from alayalite_tpu.index.fusion import _union_rows as jax_union
    from alayalite_tpu_torch.index.fusion import _union_rows

    rng = np.random.default_rng(2)
    a = rng.integers(-1, 30, size=(50, 8)).astype(np.int32)
    b = rng.integers(-1, 30, size=(50, 8)).astype(np.int32)
    for width in (16, 10, 20):
        got = _union_rows(torch.from_numpy(a), torch.from_numpy(b), width)
        np.testing.assert_array_equal(got.numpy(), jax_union(a, b, width))


def _reachable(nbrs, start):
    seen = np.zeros(nbrs.shape[0], bool)
    seen[start] = True
    frontier = np.array([start])
    while frontier.size:
        nxt = nbrs[frontier].reshape(-1)
        nxt = np.unique(nxt[nxt >= 0])
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    return seen


@pytest.mark.parametrize("kind", ["hnsw", "nsg", "fusion"])
def test_built_graph_invariants(ds, kind):
    from alayalite_tpu_torch.index.nsg import find_medoid

    idx = Index("g", IndexParams(index_type=kind, capacity=N + 100,
                                 max_nbrs=8, ef_construction=32),
                device="cpu")
    idx.fit(ds.data, ef_construction=32)
    eng = idx._engine
    g = eng.graph
    width = 16 if kind == "fusion" else 8
    assert g.nbrs.shape == (N + 100, width) and g.nbrs.dtype == torch.int32
    nbrs = g.nbrs[:N].numpy()
    assert (g.nbrs[N:] == -1).all() and nbrs.max() < N
    me = np.arange(N)[:, None]
    assert not (nbrs == me).any()
    assert all(len(set(r[r >= 0])) == (r >= 0).sum() for r in nbrs)
    ep = int(g.eps[0])
    assert _reachable(nbrs, ep).mean() >= 1 - 2e-4
    assert g.eps.shape == (8,) and int(g.eps.max()) < N
    if kind == "nsg":
        assert g.overlay == () and ep == find_medoid(eng.space, N)
        assert set(eng.build_timings) == {"knn", "pools", "prune",
                                          "reverse_reprune", "repair"}
    else:
        assert len(g.overlay) == 2
        assert ep == int(g.overlay[0].ids[0])      # the top level's first
        timed = set(eng.build_timings)
        assert ({"hnsw_knn", "nsg_repair"} <= timed if kind == "fusion"
                else {"knn", "overlay", "pools", "prune", "reverse_reprune",
                      "repair"} == timed)
    rec = calc_recall(idx.batch_search(ds.queries, K, ef_search=64), ds.gt)
    assert rec >= 0.9


def test_nsg_needs_a_cut_wider_than_the_degree(ds):
    from alayalite_tpu_torch.index.nsg import NSGBuilder

    sp = RawSpace.create(N, DIM).fit(torch.from_numpy(ds.data))
    with pytest.raises(ValueError, match="c > r"):
        NSGBuilder(r=32, c=32).build_graph(sp, N)


def test_hnsw_under_ip_fills_the_degree():
    from alayalite_tpu_torch.index.hnsw import HNSWBuilder

    d = random_dataset(n=600, dim=16, n_queries=8, seed=2)
    for metric, full in (("ip", True), ("l2", False)):
        sp = RawSpace.create(600, 16, metric=metric).fit(
            torch.from_numpy(d.data))
        g = HNSWBuilder(r=8, l=32).build_graph(sp, 600)
        degree = (g.nbrs >= 0).sum(1).float().mean()
        assert (degree > 7.9) == full, (metric, degree)


def test_hnsw_high_dimension_rule(monkeypatch):
    """From dim 512 up the candidate pools are ef 64 wide, in chunks of
    2048 rows."""
    from alayalite_tpu_torch.index import hnsw

    seen = {}
    real = hnsw.search_pool_dev

    def recording(space, knn_i, eps, **kw):
        seen.update(kw)
        return real(space, knn_i, eps, **kw)

    monkeypatch.setattr(hnsw, "search_pool_dev", recording)
    for dim, want in ((512, (64, 2048)), (32, (128, 4096))):
        sp = RawSpace.create(300, dim).fit(torch.randn(300, dim))
        hnsw.HNSWBuilder(r=8, l=200).build_graph(sp, 300)
        assert (seen["ef"], seen["chunk"]) == want


def test_graph_arrays_round_trip_with_overlay(ds):
    from alayalite_tpu_torch.index.hnsw import HNSWBuilder

    sp = RawSpace.create(N, DIM).fit(torch.from_numpy(ds.data))
    g = HNSWBuilder(r=8, l=32).build_graph(sp, N)
    arrays = g.save_arrays()
    assert arrays["n_overlay"] == 2 and {"ov0_ids", "ov1_nbrs",
                                         "ov1_down"} <= set(arrays)
    back = Graph.load_arrays(arrays)
    assert torch.equal(back.nbrs, g.nbrs) and torch.equal(back.eps, g.eps)
    for a, b in zip(back.overlay, g.overlay):
        assert (torch.equal(a.ids, b.ids) and torch.equal(a.nbrs, b.nbrs)
                and torch.equal(a.down, b.down))


def test_bf16_storage_matches_jax(ds, tmp_path):
    """Rows stored in bf16: ``gather_dists`` rounds the query to bf16 where
    JAX does (values exact in f32, sums in another order: rtol 1e-5 / atol
    1e-3); a saved index loads in the JAX package to the same recall."""
    import jax.numpy as jnp

    from alayalite_tpu import Index as JaxIndex
    from alayalite_tpu.spaces.raw import RawSpace as JaxRaw

    rng = np.random.default_rng(6)
    ids = rng.integers(-1, N, size=(32, 20)).astype(np.int32)
    q = ds.queries[:32]
    jsp = JaxRaw.create(N, DIM, storage_dtype="bfloat16").fit(
        jnp.asarray(ds.data))
    sp = RawSpace.create(N, DIM, storage_dtype="bfloat16").fit(
        torch.from_numpy(ds.data))
    assert sp.data.dtype == torch.bfloat16 and sp.bf16
    np.testing.assert_array_equal(sp.data.float().numpy(),
                                  np.asarray(jsp.data.astype(jnp.float32)))
    np.testing.assert_allclose(
        sp.gather_dists(torch.from_numpy(q), torch.from_numpy(ids)).numpy(),
        np.asarray(jsp.gather_dists(jnp.asarray(q), jnp.asarray(ids))),
        rtol=1e-5, atol=1e-3)

    idx = Index("b", IndexParams(capacity=N, max_nbrs=8, ef_construction=32,
                                 storage_dtype="bfloat16"), device="cpu")
    idx.fit(ds.data, ef_construction=32)
    assert idx._engine.space.data.dtype == torch.bfloat16
    ids_p, dist = idx.batch_search_with_distance(ds.queries, K, ef_search=64)
    rec = calc_recall(ids_p, ds.gt)
    assert rec >= 0.9 and np.isfinite(dist).all()
    idx.save(str(tmp_path / "b"))
    again = Index.load(str(tmp_path), "b", device="cpu")
    assert again._engine.space.data.dtype == torch.bfloat16
    # as in JAX, a loaded space takes its norms from the stored (rounded)
    # rows, a fitted one from the rows it was given, so the two rank
    # near-ties differently; the loaded index is held to JAX's load
    rec_l = calc_recall(again.batch_search(ds.queries, K, ef_search=64),
                        ds.gt)
    assert rec_l >= 0.9
    jidx = JaxIndex.load(str(tmp_path), "b")
    jrec = calc_recall(jidx.batch_search(ds.queries, K, ef_search=64), ds.gt)
    assert abs(jrec - rec_l) <= 0.01


@pytest.mark.parametrize("kwargs", [
    dict(index_type="hnsw"), dict(index_type="nsg"),
    dict(index_type="fusion"), dict(quantization_type="sq8"),
    dict(quantization_type="sq4"), dict(storage_dtype="bfloat16"),
    dict(metric="cos"), dict(index_type="nsg", quantization_type="sq8"),
])
def test_quick_start_with_the_defaults(kwargs):
    """The README's quick start on the CPU: 1000 × 128 rows, every row its
    own nearest neighbor."""
    data = np.random.default_rng(0).normal(size=(1000, 128)).astype(
        np.float32)
    idx = Client(device="cpu").create_index("demo", capacity=100_000,
                                            **kwargs)
    idx.fit(data)
    ids = idx.batch_search(data[:8], 10, ef_search=64)
    assert ids.shape == (8, 10) and (ids[:, 0] == np.arange(8)).all()
    assert idx.search(data[5], 3, ef_search=16)[0] == 5


@pytest.mark.parametrize("what", ["insert", "remove", "compact",
                                  "update_nodes"])
@pytest.mark.parametrize("quant", ["none", "sq8"])
def test_raw_graph_mutation_raises(what, quant):
    """Raw graph mutation is ported: each call runs and leaves its mark
    (``tests/test_torch_raw_update.py`` holds it against the JAX package),
    and the misuse the JAX package refuses still raises."""
    idx = Index("m", IndexParams(capacity=400, max_nbrs=8,
                                 quantization_type=quant), device="cpu")
    idx.fit(np.random.default_rng(1).normal(size=(300, 8)).astype(np.float32))
    eng: IndexEngine = idx._engine
    nbrs = eng.graph.nbrs.clone()
    if what == "insert":
        assert idx.insert(np.zeros(8, np.float32)) == 300
        assert eng.num == eng.search_space.num == 301
        assert (eng.graph.nbrs[300] >= 0).any()
        with pytest.raises(ValueError, match="dimension"):
            idx.insert(np.zeros(9, np.float32))
    elif what == "remove":
        idx.remove([3])
        assert not eng.space.valid[3] and not eng.search_space.valid[3]
        assert eng._removed == [3] and torch.equal(eng.graph.nbrs, nbrs)
        with pytest.raises(ValueError, match="out of range"):
            idx.remove([400])
    elif what == "compact":
        idx.remove([3])
        eng.compact()
        assert eng._removed == []
        assert not (eng.graph.nbrs[:300][torch.arange(300) != 3] == 3).any()
    else:
        eng.update_nodes([1, 2])
        assert torch.equal(eng.graph.nbrs[3:], nbrs[3:])
        assert not (eng.graph.nbrs[1] == 1).any()
        flat = Index("f", IndexParams(index_type="flat", capacity=400),
                     device="cpu")
        flat.fit(np.zeros((10, 8), np.float32))
        with pytest.raises(RuntimeError, match="no graph"):
            flat._engine.update_nodes([1])
    assert eng.space.valid[:300].sum() >= 299


def _broken_graph(seed=0, n=600, r=6, parts=5, dim=8):
    """Rows that only link within their own part: every part but the entry
    point's is unreachable; a few nodes have no in-edge at all."""
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, dim)).astype(np.float32)
    part = np.sort(rng.integers(0, parts, size=n))
    data += part[:, None] * 6.0
    nbrs = np.full((n, r), -1, np.int32)
    for p in range(parts):
        ids = np.flatnonzero(part == p)
        nbrs[ids] = rng.choice(ids[: max(1, ids.size - 5)], size=(ids.size, r))
    nbrs[rng.random((n, r)) < 0.2] = -1
    return data, nbrs


def test_host_repair_matches_jax():
    """The port repairs every graph on the device. On a broken graph it
    writes the edges the JAX package's device repair writes, and reaches
    every node as the JAX package's host repair (its route at this size)
    does."""
    import jax.numpy as jnp

    from alayalite_tpu.index.nsg import _attach_unreached as jax_host
    from alayalite_tpu.index.repair_dev import (
        repair_connectivity_dev as jax_dev)
    from alayalite_tpu.spaces.raw import RawSpace as JaxRaw
    from alayalite_tpu_torch.index.repair_dev import repair_connectivity

    data, nbrs = _broken_graph()
    n = data.shape[0]
    assert _reachable(nbrs, 0).mean() < 0.5
    sp = RawSpace.create(n, data.shape[1]).fit(torch.from_numpy(data))
    got = repair_connectivity(sp, torch.from_numpy(nbrs.copy()), 0).numpy()
    assert _reachable(got, 0).all()
    jsp = JaxRaw.create(n, data.shape[1]).fit(jnp.asarray(data))
    assert _reachable(jax_host(jsp, nbrs.copy(), 0), 0).all()
    np.testing.assert_array_equal(
        got, np.asarray(jax_dev(jsp, jnp.asarray(nbrs), 0)))


def test_repair_dispatch_by_size():
    """One repair at every size, in place: a small broken graph comes back
    with every node reached and no edge dropped; a graph above 200,000 rows
    (where the JAX package changes from its host repair to its device
    repair) takes the same function, here a tree that needs no edge."""
    from alayalite_tpu_torch.index.repair_dev import repair_connectivity

    data, nbrs = _broken_graph(seed=1)
    n = data.shape[0]
    sp = RawSpace.create(n, data.shape[1]).fit(torch.from_numpy(data))
    t = torch.from_numpy(nbrs.copy())
    out = repair_connectivity(sp, t, 0)
    assert out is t
    assert _reachable(out.numpy(), 0).all()
    # edges were only added or, in a full row, replaced: never dropped
    assert ((out.numpy() >= 0).sum(1) >= (nbrs >= 0).sum(1)).all()

    big, r = 200_001, 8
    kids = np.arange(big, dtype=np.int64)[:, None] * r + np.arange(1, r + 1)
    tree = torch.from_numpy(np.where(kids < big, kids, -1).astype(np.int32))
    sp = RawSpace.create(big, 2).fit(torch.zeros((big, 2)))
    want = tree.clone()
    out = repair_connectivity(sp, tree, 0)
    assert out is tree and torch.equal(out, want)
