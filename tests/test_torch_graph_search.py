"""The raw graph path (hnsw, nsg, fusion; quantization none, sq8, sq4)
against the JAX package at small size on the CPU.

The JAX package fits hnsw, nsg and fusion under l2 and hnsw under cos and
ip (n = 1200, dim 16, max_nbrs 8, ef_construction 32: two overlay levels);
these fits dominate this file's run time and every test shares them. The
sq8 and sq4 indices reuse the l2 hnsw fit's raw space and graph (the JAX
engine builds the graph on the raw rows whatever the quantization) with
codes fitted by the JAX ``SQSpace``, and are saved by the JAX engine.

The port searches the JAX-built graphs, so the walks differ only where f32
sums round differently: parity is recall within ±0.01, and seeds that match
exactly. Builds differ by their random streams (torch.Generator vs
jax.random): build parity is recall ≥ the JAX-built graph's − 0.01, the
port's side averaged over three builder seeds.
"""

import numpy as np
import pytest
import torch

from alayalite_tpu import Index as JaxIndex
from alayalite_tpu import IndexParams as JaxParams
from alayalite_tpu_torch import Index, IndexParams
from alayalite_tpu_torch.convert import from_jax_arrays
from alayalite_tpu_torch.index.engine import IndexEngine
from alayalite_tpu_torch.ops.pool_sort import pool_merge
from alayalite_tpu_torch.ops.ring_probe import ring_probe
from alayalite_tpu_torch.utils.datasets import random_dataset
from alayalite_tpu_torch.utils.evaluate import calc_gt, calc_recall

# the tensors here are small: more threads only contend with the other
# test workers' (the fits run twice as fast with two)
torch.set_num_threads(2)

N, DIM, NQ, K = 1200, 16, 64, 10
BASE = dict(capacity=N, max_nbrs=8, ef_construction=32)
EFS = (32, 64)
# kind -> (index_type, quantization_type, metric)
KINDS = {"hnsw": ("hnsw", "none", "l2"), "nsg": ("nsg", "none", "l2"),
         "fusion": ("fusion", "none", "l2"), "sq8": ("hnsw", "sq8", "l2"),
         "sq4": ("hnsw", "sq4", "l2"), "cos": ("hnsw", "none", "cos"),
         "ip": ("hnsw", "none", "ip")}


def _params(kind, cls):
    it, qt, metric = KINDS[kind]
    return cls(index_type=it, quantization_type=qt, metric=metric, **BASE)


@pytest.fixture(scope="module")
def ds():
    d = random_dataset(n=N, dim=DIM, n_queries=NQ, seed=11)
    d.gts = {m: calc_gt(d.data, d.queries, K, metric=m, device="cpu")
             for m in ("l2", "cos", "ip")}
    return d


@pytest.fixture(scope="module")
def jax_built(ds, tmp_path_factory):
    """{kind: JAX Index}, each saved under root/kind, with its recalls."""
    from alayalite_tpu.index.engine import _make_quant_space

    root = tmp_path_factory.mktemp("jax_graphs")
    out = {"root": root, "idx": {}, "rec": {}}
    for kind in KINDS:
        idx = JaxIndex(kind, _params(kind, JaxParams))
        if KINDS[kind][1] == "none":
            idx.fit(ds.data, ef_construction=BASE["ef_construction"])
        else:
            # the l2 hnsw fit's rows and graph, codes fitted by the JAX space
            src, eng = out["idx"]["hnsw"]._engine, idx._engine
            eng.space, eng.graph = src.space, src.graph
            eng.search_space = _make_quant_space(idx.params, N, DIM).fit(
                ds.data)
            eng._fitted = True
            idx._dim = DIM
        idx.save(str(root / kind))
        out["idx"][kind] = idx
        gt = ds.gts[KINDS[kind][2]]
        out["rec"][kind] = {
            ef: calc_recall(idx.batch_search(ds.queries, K, ef_search=ef), gt)
            for ef in EFS}
    return out


def _arrays(jidx):
    eng = jidx._engine
    quant = (None if eng.search_space is eng.space
             else eng.search_space.save_arrays())
    return (jidx.params.to_json(), eng.space.save_arrays(),
            eng.graph.save_arrays(), quant)


@pytest.mark.parametrize("kind", ["hnsw", "nsg", "fusion", "sq8", "sq4"])
def test_load_from_directory_and_from_arrays(ds, jax_built, kind):
    jidx = jax_built["idx"][kind]
    a = Index.load(str(jax_built["root"]), kind, device="cpu")
    b = from_jax_arrays(*_arrays(jidx), device="cpu")
    want = jidx._engine.graph.save_arrays()
    for eng in (a._engine, b):
        got = eng.graph.save_arrays()
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))
        assert (eng.search_space is eng.space) == (KINDS[kind][1] == "none")
    n_levels = {"nsg": 0}.get(kind, 2)
    assert len(a._engine.graph.overlay) == n_levels
    ra = a.batch_search_with_distance(ds.queries, K, ef_search=32)
    rb = b.batch_search_with_distance(ds.queries, K, ef=32)
    np.testing.assert_array_equal(ra[0], rb[0])
    np.testing.assert_array_equal(ra[1], rb[1])


@pytest.mark.parametrize("kind", ["hnsw", "cos", "sq8"])
def test_seeds_match_jax(ds, jax_built, kind):
    """``graph_seeds`` (``overlay_descend`` per level) lands every query on
    the node JAX's descent lands it on, and counts one host sync per step."""
    import jax.numpy as jnp

    from alayalite_tpu.index.search import graph_seeds as jax_seeds
    from alayalite_tpu_torch.index.search import graph_seeds, overlay_descend

    jeng = jax_built["idx"][kind]._engine
    eng = from_jax_arrays(*_arrays(jax_built["idx"][kind]), device="cpu")
    q = torch.from_numpy(ds.queries)
    jq = jeng.search_space.prep_query(jnp.asarray(ds.queries))
    want = np.asarray(jax_seeds(jeng.search_space, jeng.graph.eps,
                                jeng.graph.overlay, jq))
    syncs = overlay_descend.syncs
    got = graph_seeds(eng.search_space, eng.graph.eps, eng.graph.overlay,
                      eng.search_space.prep_query(q))
    assert overlay_descend.syncs - syncs >= 2 * len(eng.graph.overlay)
    assert got.shape == (NQ, 1) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 4            # the descent does move


def test_seeds_guard_a_dead_top_slot(ds, jax_built):
    """A removed slot 0 of the top level: the descent starts at the first
    live slot, as in JAX; a top level with no live slot falls back to the
    first entry point."""
    import dataclasses

    import jax.numpy as jnp

    from alayalite_tpu.index.search import graph_seeds as jax_seeds
    from alayalite_tpu_torch.index.search import graph_seeds

    jeng = jax_built["idx"]["hnsw"]._engine
    eng = from_jax_arrays(*_arrays(jax_built["idx"]["hnsw"]), device="cpu")
    q = torch.from_numpy(ds.queries)
    top, rest = eng.graph.overlay[0], eng.graph.overlay[1:]
    jtop, jrest = jeng.graph.overlay[0], jeng.graph.overlay[1:]
    for dead in ([0], list(range(top.size))):
        ids = top.ids.clone()
        ids[dead] = -1
        nbrs = torch.where(torch.isin(top.nbrs, torch.tensor(dead)),
                           torch.full_like(top.nbrs, -1), top.nbrs)
        got = graph_seeds(eng.space, eng.graph.eps,
                          (dataclasses.replace(top, ids=ids, nbrs=nbrs),
                           *rest), q)
        want = jax_seeds(jeng.space, jeng.graph.eps,
                         (jtop.replace(ids=jnp.asarray(ids.numpy()),
                                       nbrs=jnp.asarray(nbrs.numpy())),
                          *jrest), jnp.asarray(ds.queries))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == eng.graph.eps[0]).all()


@pytest.mark.parametrize("ef", EFS)
@pytest.mark.parametrize("kind", list(KINDS))
def test_search_recall_parity_on_jax_graph(ds, jax_built, kind, ef):
    idx = Index.load(str(jax_built["root"]), kind, device="cpu")
    merges, probes = pool_merge.calls, ring_probe.calls
    ids, dist = idx.batch_search_with_distance(ds.queries, K, ef_search=ef)
    assert pool_merge.calls > merges and ring_probe.calls > probes
    rec = calc_recall(ids, ds.gts[KINDS[kind][2]])
    assert abs(rec - jax_built["rec"][kind][ef]) <= 0.01, (
        rec, jax_built["rec"][kind][ef])
    jids, jdist = jax_built["idx"][kind].batch_search_with_distance(
        ds.queries, K, ef_search=ef)
    same = ids == jids
    assert same.mean() > 0.9
    # same ids → the same exact re-score; atol covers the f32 cancellation
    # in |q|² + |x|² − 2 q·x at |x|² ~ 250 summed in another order
    np.testing.assert_allclose(dist[same], jdist[same], rtol=1e-5, atol=1e-3)
    assert ids.dtype == np.int32 and np.isfinite(dist).all()


@pytest.mark.parametrize("kind", ["hnsw", "sq8"])
def test_tombstones_through_valid(ds, jax_built, kind):
    """10% of the rows removed in JAX (below its compaction threshold, so
    only ``valid`` changes): the port's walk routes through them and
    returns none."""
    jidx = JaxIndex.load(str(jax_built["root"]), kind)
    dead = np.random.default_rng(0).choice(N, size=N // 10, replace=False)
    jidx.remove(dead)
    gt = calc_gt(ds.data, ds.queries, K, deleted=dead, device="cpu")
    eng = from_jax_arrays(*_arrays(jidx), device="cpu")
    for ef in EFS:
        ids = eng.batch_search(ds.queries, K, ef=ef)
        assert not np.isin(ids, dead).any()
        jrec = calc_recall(jidx.batch_search(ds.queries, K, ef_search=ef), gt)
        assert abs(calc_recall(ids, gt) - jrec) <= 0.01


def test_visited_probe_and_set_matches_jax():
    import jax.numpy as jnp

    from alayalite_tpu.index.search import _visited_probe_and_set as jax_probe
    from alayalite_tpu_torch.index.search import _visited_probe_and_set

    rng = np.random.default_rng(4)
    C, B, Kc = 700, 9, 40
    jv = jnp.zeros((B, -(-C // 32)), jnp.uint32)
    tv = torch.zeros((B, -(-C // 32)), dtype=torch.int32)
    for _ in range(3):                 # later rounds meet bits already set
        ids = rng.integers(-1, C, size=(B, Kc)).astype(np.int32)
        ids[:, :4] = [C - 1, 31, 32, 63]           # bit 31 and word edges
        jv, jfresh, jids = jax_probe(jv, jnp.asarray(ids))
        fresh, ids_s = _visited_probe_and_set(tv, torch.from_numpy(ids))
        np.testing.assert_array_equal(fresh.numpy(), np.asarray(jfresh))
        np.testing.assert_array_equal(ids_s.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(tv.numpy().view(np.uint32),
                                      np.asarray(jv))


@pytest.mark.parametrize("kind", ["hnsw", "nsg"])
def test_both_visited_modes(ds, jax_built, kind):
    """The exact bitset and the pop ring walk the same graph to the same
    recall; the bitset never scores a node twice, so it returns no
    duplicate."""
    from alayalite_tpu_torch.index.search import graph_search_device

    eng = from_jax_arrays(*_arrays(jax_built["idx"][kind]), device="cpu")
    g, sp = eng.graph, eng.space
    q = sp.prep_query(torch.from_numpy(ds.queries))
    rec = {}
    for mode in ("ring", "bitmask"):
        probes = ring_probe.calls
        d, i = graph_search_device(sp, g.nbrs, g.eps, g.overlay, q, k=K,
                                   ef=32, n_expand=4, visited_mode=mode,
                                   qchunk=40)
        assert (ring_probe.calls > probes) == (mode == "ring")
        ids = i.numpy()
        assert all(len(set(r)) == K for r in ids)
        rec[mode] = calc_recall(ids, ds.gts["l2"])
    assert abs(rec["ring"] - rec["bitmask"]) <= 0.01, rec
    assert rec["bitmask"] >= jax_built["rec"][kind][32] - 0.02
    with pytest.raises(ValueError, match="visited_mode"):
        graph_search_device(sp, g.nbrs, g.eps, g.overlay, q, k=K, ef=32,
                            visited_mode="ring2")


def test_traversal_without_rerank_keeps_the_pool(ds, jax_built):
    """``exact_rerank=False`` with k = ef is the sq traversal's call: the
    whole pool comes back, ordered by the space's own distance."""
    from alayalite_tpu_torch.index.search import graph_search_device

    eng = from_jax_arrays(*_arrays(jax_built["idx"]["sq8"]), device="cpu")
    g, sq = eng.graph, eng.search_space
    q = sq.prep_query(torch.from_numpy(ds.queries))
    d, pool = graph_search_device(sq, g.nbrs, g.eps, g.overlay, q, k=40,
                                  ef=40, exact_rerank=False)
    found = pool >= 0                   # a short walk may not fill the pool
    assert pool.shape == (NQ, 40) and found[:, :K].all()
    assert (d[:, 1:] >= d[:, :-1]).all() and torch.isinf(d[~found]).all()
    np.testing.assert_allclose(
        d[found].numpy(), sq.gather_dists(q, pool.clamp(min=0))[found].numpy(),
        rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("dim", [16, 7])
@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_sq4_codes_match_jax(metric, dim):
    """Nibble packing (even dimension low, odd dimension high, a zero pad
    nibble at odd dim): bytes identical to JAX's, decode too."""
    import jax.numpy as jnp

    from alayalite_tpu.spaces.sq import SQSpace as JaxSQ
    from alayalite_tpu_torch.spaces.sq import SQSpace

    x = (np.random.default_rng(dim).normal(size=(300, dim)) * 2.0
         ).astype(np.float32)
    j = JaxSQ.create(320, dim, bits=4, metric=metric).fit(jnp.asarray(x))
    p = SQSpace.create(320, dim, bits=4, metric=metric).fit(
        torch.from_numpy(x))
    assert p.codes.shape == (320, (dim + 1) // 2)
    np.testing.assert_array_equal(p.codes.numpy(), np.asarray(j.codes))
    # under cos the rows are normalized first, which rounds in another
    # order in the two frameworks: the grid may move by an ulp
    np.testing.assert_allclose(p.scale.numpy(), np.asarray(j.scale),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(p.xhat_sq.numpy(), np.asarray(j.xhat_sq),
                               rtol=1e-6, atol=1e-6)
    ids = np.arange(0, 300, 7)
    np.testing.assert_allclose(p.decode(torch.from_numpy(ids)).numpy(),
                               np.asarray(j.decode(jnp.asarray(ids))),
                               rtol=1e-6, atol=1e-6)
    back = SQSpace.load_arrays(j.save_arrays())
    assert back.bits == 4 and torch.equal(back.codes, p.codes)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("bits,dim", [(8, 32), (4, 32), (4, 7)])
def test_sq_gather_dists_match_jax(bits, dim, metric):
    """rtol 2e-2 / atol 2.0, the tolerance of tests/test_pallas.py for the
    bf16 product; in fact both sides round q∘scale to bf16 alike and differ
    only in the order of the f32 sums (held at 1e-4 / 1e-2 too)."""
    import jax.numpy as jnp

    from alayalite_tpu.spaces.sq import SQSpace as JaxSQ
    from alayalite_tpu_torch.spaces.sq import SQSpace

    rng = np.random.default_rng(bits + dim)
    x = (rng.normal(size=(400, dim)) * 2.0).astype(np.float32)
    q = rng.normal(size=(24, dim)).astype(np.float32)
    ids = rng.integers(-1, 400, size=(24, 33)).astype(np.int32)
    j = JaxSQ.create(400, dim, bits=bits, metric=metric).fit(jnp.asarray(x))
    p = SQSpace.create(400, dim, bits=bits, metric=metric).fit(
        torch.from_numpy(x))
    want = np.asarray(j.gather_dists(jnp.asarray(q), jnp.asarray(ids)))
    got = p.gather_dists(torch.from_numpy(q), torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2.0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)
    # and near the exact distance to the decoded rows
    dec = p.decode(torch.from_numpy(ids.clip(0)).long()).numpy()
    exact = (-(dec * q[:, None]).sum(-1) if metric == "ip"
             else ((dec - q[:, None]) ** 2).sum(-1))
    np.testing.assert_allclose(got, exact, rtol=2e-2, atol=2.0)


def _port_built(ds, kind, seed):
    """An engine around the graph ``_make_builder(params, seed)`` builds."""
    from alayalite_tpu_torch.index.engine import _make_builder
    from alayalite_tpu_torch.spaces.raw import RawSpace

    eng = IndexEngine(_params(kind, IndexParams), device="cpu")
    eng.space = eng.search_space = RawSpace.create(N, DIM).fit(
        torch.from_numpy(ds.data))
    eng.graph = _make_builder(eng.params, seed=seed).build_graph(eng.space, N)
    eng._fitted = True
    return eng


@pytest.mark.parametrize("kind", ["hnsw", "nsg", "fusion"])
def test_build_parity(ds, jax_built, kind):
    """Graphs the port builds hold JAX's recall − 0.01 at both widths. At
    1,200 rows and degree 8 one build's recall moves by ±0.05 with its
    random stream, in either package (the streams differ), so the port's
    side is the mean over three builder seeds."""
    recs = {ef: [] for ef in EFS}
    for seed in range(3):
        eng = _port_built(ds, kind, seed)
        for ef in EFS:
            recs[ef].append(calc_recall(eng.batch_search(ds.queries, K, ef=ef),
                                        ds.gts["l2"]))
    for ef in EFS:
        assert np.mean(recs[ef]) >= jax_built["rec"][kind][ef] - 0.01, (
            ef, recs, jax_built["rec"][kind])


@pytest.mark.parametrize("kind", ["hnsw", "nsg", "fusion"])
def test_port_built_index_loads_in_jax(ds, jax_built, kind):
    idx = Index("p", _params(kind, IndexParams), device="cpu")
    idx.fit(ds.data, ef_construction=BASE["ef_construction"])
    root = jax_built["root"] / f"port_{kind}"
    idx.save(str(root / "p"))
    jidx = JaxIndex.load(str(root), "p")
    assert len(jidx._engine.graph.overlay) == len(idx._engine.graph.overlay)
    for ef in EFS:
        rec = calc_recall(idx.batch_search(ds.queries, K, ef_search=ef),
                          ds.gts["l2"])
        jrec = calc_recall(jidx.batch_search(ds.queries, K, ef_search=ef),
                           ds.gts["l2"])
        assert abs(jrec - rec) <= 0.01, (ef, jrec, rec)


@pytest.mark.parametrize("quant", ["sq8", "sq4"])
def test_port_built_sq_index_round_trips(ds, quant, tmp_path):
    idx = Index("q", _params(quant, IndexParams), device="cpu")
    idx.fit(ds.data, ef_construction=BASE["ef_construction"])
    idx.save(str(tmp_path / "q"))
    rec = calc_recall(idx.batch_search(ds.queries, K, ef_search=64),
                      ds.gts["l2"])
    assert rec >= 0.9
    jidx = JaxIndex.load(str(tmp_path), "q")
    np.testing.assert_array_equal(np.asarray(jidx._engine.search_space.codes),
                                  idx._engine.search_space.codes.numpy())
    jrec = calc_recall(jidx.batch_search(ds.queries, K, ef_search=64),
                       ds.gts["l2"])
    assert abs(jrec - rec) <= 0.01
    again = IndexEngine.load(str(tmp_path / "q"), device="cpu")
    a = idx.batch_search_with_distance(ds.queries, K, ef_search=32)
    b = again.batch_search_with_distance(ds.queries, K, ef=32)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
