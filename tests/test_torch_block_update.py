"""Maintenance of an hnsw + bsq8 index in the port (insert, remove, compact,
update_nodes) against the JAX package at small size on the CPU.

Module level: the space's in-place updates and the rewire step take the
same inputs as their JAX counterparts and must give the same state. Slice
level: the JAX package's own update and maintenance cases, run on the
port; random streams differ (torch.Generator for the reverse-table slots
where JAX draws from a PRNG key), so graphs differ and parity is held by
recall on the same data.
"""

import numpy as np
import pytest
import torch

from alayalite_tpu import Index as JaxIndex
from alayalite_tpu import IndexParams as JaxParams
from alayalite_tpu_torch import Index, IndexParams
from alayalite_tpu_torch.index.engine import _rewire_rows_dev, _topr_dedup
from alayalite_tpu_torch.spaces.bqg import BQGSpace
from alayalite_tpu_torch.utils.datasets import random_dataset
from alayalite_tpu_torch.utils.evaluate import calc_gt, calc_recall

# the tensors here are small: more threads only contend with the other
# test workers' (the fits run twice as fast with two)
torch.set_num_threads(2)

DIM = 16


def _params(cls, capacity, **kw):
    return cls(index_type="hnsw", quantization_type="bsq8", max_nbrs=16,
               ef_construction=64, capacity=capacity, **kw)


def _spaces(metric, n=300, dim=40, r=16, capacity=340, seed=0):
    """The same fitted block space in both packages (dim 40: codes are
    padded to 128 with the centre byte)."""
    import jax.numpy as jnp

    from alayalite_tpu.spaces.bqg import BQGSpace as JaxBQG

    rng = np.random.default_rng(seed)
    data = (rng.normal(size=(n, dim)) * 2.0).astype(np.float32)
    nbrs = rng.integers(-1, n, size=(n, r)).astype(np.int32)
    jsp = JaxBQG.create(capacity, dim, metric=metric, degree=r).fit(
        jnp.asarray(data)).update_neighbors(nbrs)
    sp = BQGSpace.create(capacity, dim, metric=metric, degree=r).fit(
        torch.from_numpy(data))
    sp.update_neighbors(torch.from_numpy(nbrs))
    return jsp, sp, rng


def _assert_same_space(jsp, sp):
    assert int(jsp.num) == sp.num
    np.testing.assert_array_equal(np.asarray(jsp.valid), sp.valid.numpy())
    np.testing.assert_array_equal(np.asarray(jsp.nbr_ids), sp.nbr_ids.numpy())
    np.testing.assert_array_equal(np.asarray(jsp.nbr_codes),
                                  sp.nbr_codes.numpy())
    np.testing.assert_allclose(np.asarray(jsp.nbr_xsq), sp.nbr_xsq.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jsp.data), sp.data.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jsp.sq_norms), sp.sq_norms.numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("metric", ["l2", "cos", "ip"])
def test_space_updates_match_jax(metric):
    """insert_raw (with rows past capacity), set_neighbor_rows (narrow rows,
    −1 slots) and remove leave the same state as the JAX space: codes
    byte-identical, nbr_xsq / data / norms to rtol 1e-6."""
    import jax.numpy as jnp

    jsp, sp, rng = _spaces(metric)
    new = (rng.normal(size=(50, 40)) * 2.0).astype(np.float32)
    jsp, jids = jsp.insert_raw(jnp.asarray(new))
    ids = sp.insert_raw(torch.from_numpy(new))
    np.testing.assert_array_equal(np.asarray(jids), ids.numpy())
    assert (ids.numpy()[:40] == np.arange(300, 340)).all()
    assert (ids.numpy()[40:] == -1).all() and sp.num == 340
    nodes = np.array([300, 7, 339, 12], np.int32)
    rows = rng.integers(-1, 340, size=(4, 12)).astype(np.int32)
    jsp = jsp.set_neighbor_rows(nodes, rows)
    sp.set_neighbor_rows(torch.from_numpy(nodes), torch.from_numpy(rows))
    dead = np.array([0, 5, 301], np.int32)
    jsp = jsp.remove(jnp.asarray(dead))
    sp.remove(torch.from_numpy(dead))
    _assert_same_space(jsp, sp)
    assert not sp.valid[dead.tolist()].any()


def test_space_updates_drop_negative_ids():
    """Where the port departs from JAX: a −1 node id writes nowhere (JAX
    wraps it to the last slot) and remove([0, −1]) removes row 0 (JAX clips
    −1 to slot 0 and may write its old valid bit back)."""
    _, sp, rng = _spaces("l2")
    before = (sp.nbr_ids.clone(), sp.nbr_codes.clone(), sp.nbr_xsq.clone())
    rows = torch.from_numpy(rng.integers(0, 300, size=(2, 16)).astype(np.int32))
    sp.set_neighbor_rows(torch.tensor([-1, 3], dtype=torch.int32), rows)
    keep = torch.ones(340, dtype=torch.bool)
    keep[3] = False
    assert torch.equal(sp.nbr_ids[keep], before[0][keep])
    assert torch.equal(sp.nbr_codes[keep], before[1][keep])
    assert torch.equal(sp.nbr_ids[3], rows[1])
    assert not torch.equal(sp.nbr_codes[3], before[1][3])
    sp.remove(torch.tensor([0, -1]))
    assert not sp.valid[0] and sp.valid[1:300].all()


@pytest.fixture(scope="module")
def jax_built(tmp_path_factory):
    """One JAX fit (n = 900, dim 16, capacity 1000), saved."""
    ds = random_dataset(n=900, dim=DIM, n_queries=16, seed=6)
    root = tmp_path_factory.mktemp("jax_upd")
    idx = JaxIndex("j", _params(JaxParams, 1000, compaction_threshold=0.0))
    idx.fit(ds.data)
    idx.save(str(root / "j"))
    return {"ds": ds, "root": root, "idx": idx}


def test_rewire_rows_match_jax(jax_built):
    """``_rewire_rows_dev`` + ``_topr_dedup`` on the JAX-built graph: the
    same rows as JAX's, as sets per row, and the same distances to them
    (rtol 1e-5; near-ties may order differently)."""
    import jax.numpy as jnp

    from alayalite_tpu.index.engine import _rewire_rows_dev as jax_rewire

    ds, jeng = jax_built["ds"], jax_built["idx"]._engine
    eng = Index.load(str(jax_built["root"]), "j", device="cpu")._engine
    removed = np.arange(0, 900, 5, dtype=np.int32)
    mask = np.zeros(1000, bool)
    mask[removed] = True
    nbrs = np.asarray(jeng.graph.nbrs)
    ids = np.flatnonzero(np.isin(nbrs, removed).any(1) & ~mask)[:300]
    assert ids.size == 300
    want = np.asarray(jax_rewire(jeng.space, jeng.graph.nbrs,
                                 jnp.asarray(mask),
                                 jnp.asarray(ids.astype(np.int32)), r=16))
    got = _rewire_rows_dev(eng.space, eng.graph.nbrs, torch.from_numpy(mask),
                           torch.from_numpy(ids), r=16).numpy()
    assert got.shape == want.shape
    assert not np.isin(got, removed).any()
    data = ds.data.astype(np.float64)

    def dists(rows, i):
        live = rows[rows >= 0]
        return np.sort(((data[live] - data[i]) ** 2).sum(1))

    same = 0
    for i, a, b in zip(ids, got, want):
        same += set(a[a >= 0]) == set(b[b >= 0])
        np.testing.assert_allclose(dists(a, i), dists(b, i), rtol=1e-5)
    assert same >= 0.99 * len(ids)
    d = torch.tensor([[3.0, 1.0, 1.0, 2.0, float("inf")]])
    i = torch.tensor([[7, 4, 4, 9, -1]], dtype=torch.int32)
    assert _topr_dedup(d, i, 4).tolist() == [[4, 9, 7, -1]]


@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_block_quantized_insert(metric):
    """New vectors become searchable and old ones stay found after the
    touched blocks are re-encoded (tests/test_update.py, bsq8 case)."""
    ds = random_dataset(n=600, dim=DIM, n_queries=4, seed=17)
    idx = Index("q", _params(IndexParams, 700, metric=metric), device="cpu")
    idx.fit(ds.data)
    rng = np.random.default_rng(2)
    new = ds.data[:24] + 0.01 * rng.normal(size=(24, DIM)).astype(np.float32)
    new_ids = idx.insert(new)
    assert (new_ids == np.arange(600, 624)).all()
    ids = idx.batch_search(new, 5, ef_search=64)
    hit = np.mean([new_ids[i] in ids[i] for i in range(len(new_ids))])
    assert hit >= 0.9, f"hit {hit}"
    gt = calc_gt(np.concatenate([ds.data, new]), ds.queries, 10,
                 metric=metric, device="cpu")
    assert calc_recall(idx.batch_search(ds.queries, 10, ef_search=64),
                       gt) >= 0.8
    eng = idx._engine
    assert eng.num == eng.space.num == eng.search_space.num == 624
    assert torch.equal(eng.graph.nbrs, eng.search_space.nbr_ids)
    assert torch.equal(eng.space.valid, eng.search_space.valid)
    single = idx.insert(ds.data[30] + 0.02)
    assert single == 624 and isinstance(single, int)


def test_block_insert_keeps_first_nodes_edges():
    ds = random_dataset(n=400, dim=DIM, n_queries=2, seed=23)
    idx = Index("pw", _params(IndexParams, 500), device="cpu")
    idx.fit(ds.data)
    row0 = idx._engine.graph.nbrs[0].clone()
    new_ids = idx.insert(ds.data[:12] + 0.01)
    eng = idx._engine
    assert (eng.search_space.nbr_ids[int(new_ids[0])] >= 0).any()
    assert (eng.graph.nbrs[int(new_ids[0])] >= 0).any()
    # every encoded block matches its adjacency row
    from alayalite_tpu_torch.spaces.bqg import _encode_block

    sp = eng.search_space
    codes, xsq = _encode_block(sp.data, sp.dmin, sp.scale, sp.nbr_ids[:412])
    assert torch.equal(codes, sp.nbr_codes[:412])
    assert torch.equal(xsq, sp.nbr_xsq[:412])
    # slot 0 changed only if a new row points at it
    if not (eng.graph.nbrs[400:412] == 0).any():
        assert torch.equal(eng.graph.nbrs[0], row0)


def test_block_insert_then_remove():
    ds = random_dataset(n=400, dim=DIM, n_queries=8, seed=19)
    idx = Index("qr", _params(IndexParams, 500), device="cpu")
    idx.fit(ds.data)
    new_ids = idx.insert(ds.data[:8] + 0.005)
    idx.remove(new_ids[:4])
    ids = idx.batch_search(ds.queries, 10, ef_search=64)
    assert not np.isin(ids[ids >= 0], new_ids[:4]).any()
    with pytest.raises(ValueError, match="out of range"):
        idx.remove(500)


def test_block_insert_capacity():
    """Rows past the capacity get −1 from the engine and write nowhere;
    ``Index.insert`` raises as for a flat index."""
    ds = random_dataset(n=300, dim=DIM, n_queries=2, seed=3)
    idx = Index("cap", _params(IndexParams, 310), device="cpu")
    idx.fit(ds.data)
    eng = idx._engine
    row0 = (eng.graph.nbrs[0].clone(), eng.search_space.nbr_codes[0].clone())
    far = np.full((16, DIM), 50.0, np.float32) + np.arange(16)[:, None]
    ids = eng.insert(far)
    assert (ids[:10] == np.arange(300, 310)).all() and (ids[10:] == -1).all()
    assert eng.num == 310 and eng.search_space.num == 310
    # far rows touch nobody near slot 0: its row and block stay as they were
    assert torch.equal(eng.graph.nbrs[0], row0[0])
    assert torch.equal(eng.search_space.nbr_codes[0], row0[1])
    # the outlier batch is reachable through its within-batch edges
    top = eng.batch_search(far[:10], 1, ef=32)[:, 0]
    assert (top == ids[:10]).mean() >= 0.9
    with pytest.raises(RuntimeError, match="full"):
        idx.insert(ds.data[0])


def test_update_nodes_rewires_through_removed():
    """compact() takes every tombstoned id out of the live rows and their
    blocks follow (tests/test_maintenance.py, bsq8 edition)."""
    ds = random_dataset(n=900, dim=DIM, n_queries=16, seed=6)
    idx = Index("t", _params(IndexParams, 900, compaction_threshold=0.0),
                device="cpu")
    idx.fit(ds.data)
    eng = idx._engine
    removed = np.arange(0, 900, 5, dtype=np.int32)
    idx.remove(removed)
    assert eng._removed and np.isin(eng.graph.nbrs.numpy(), removed).any()
    eng.graph.eps[0] = 5                       # a dead entry point
    eng.compact()
    assert eng._removed == []
    nbrs = eng.graph.nbrs.numpy()
    live = np.setdiff1d(np.arange(900), removed)
    assert not np.isin(nbrs[live], removed).any()
    assert not np.isin(eng.graph.eps.numpy(), removed).any()
    assert torch.equal(eng.graph.nbrs, eng.search_space.nbr_ids)
    assert (nbrs[live] >= 0).sum(1).min() >= 8
    gt = calc_gt(ds.data, ds.queries, 10, deleted=removed, device="cpu")
    ids = idx.batch_search(ds.queries, 10, ef_search=80)
    assert calc_recall(ids, gt) >= 0.8
    before = nbrs.copy()
    eng.update_nodes(np.array([1, 2, 3], np.int32))   # nothing removed: same
    after = eng.graph.nbrs.numpy()
    for i in (1, 2, 3):
        assert set(before[i]) == set(after[i])


def test_remove_compacts_past_threshold_and_resamples_seeds():
    ds = random_dataset(n=600, dim=DIM, n_queries=8, seed=8)
    idx = Index("thr", _params(IndexParams, 600, compaction_threshold=0.15),
                device="cpu")
    idx.fit(ds.data)
    eng = idx._engine
    sample = eng._seed_scan_arrays()[0].numpy()
    idx.remove(np.arange(0, 60, dtype=np.int32))       # 10%: below threshold
    assert len(eng._removed) == 60
    idx.remove(np.arange(60, 120, dtype=np.int32))     # 20% of 480 live rows
    assert eng._removed == []
    assert not np.isin(eng.graph.nbrs[120:600].numpy(),
                       np.arange(120)).any()
    fresh = eng._seed_scan_arrays()[0].numpy()
    assert np.isin(sample, np.arange(120)).any()
    assert not np.isin(fresh, np.arange(120)).any()
    # the same sample as the JAX package draws over the live rows
    want = np.sort(np.random.default_rng(0x5EED).choice(
        np.arange(120, 600), size=fresh.size, replace=False))
    np.testing.assert_array_equal(fresh, want)


def _churn(index_cls, params_cls, ds, n, **kw):
    """tests/test_maintenance.py's 30% churn: three rounds of removing a
    tenth of the live rows and inserting as many fresh ones."""
    idx = index_cls("c", _params(params_cls, 3 * n, compaction_threshold=0.15),
                    **kw)
    idx.fit(ds.data)
    rng = np.random.default_rng(1)
    vecs = {i: ds.data[i] for i in range(n)}
    live = set(range(n))
    for _ in range(3):
        doomed = rng.choice(sorted(live), size=n // 10, replace=False)
        idx.remove(doomed.astype(np.int32))
        live -= set(int(x) for x in doomed)
        fresh = rng.normal(size=(n // 10, DIM)).astype(np.float32)
        new_ids = np.asarray(idx.insert(fresh))
        assert (new_ids >= 0).all()
        for j, nid in enumerate(new_ids):
            vecs[int(nid)] = fresh[j]
            live.add(int(nid))
    live_ids = np.asarray(sorted(live), dtype=np.int64)
    base = np.stack([vecs[int(i)] for i in live_ids])
    d2 = ((ds.queries[:, None, :] - base[None]) ** 2).sum(-1)
    gt = live_ids[np.argsort(d2, axis=1)[:, :10]]
    ids = np.asarray(idx.batch_search(ds.queries, 10, ef_search=96))
    dead = np.setdiff1d(np.arange(idx._engine.num), live_ids)
    assert not np.isin(ids[ids >= 0], dead).any()
    return calc_recall(ids, gt)


def test_churn_30pct_holds_recall():
    n = 900
    ds = random_dataset(n=n, dim=DIM, n_queries=16, seed=9)
    rec = _churn(Index, IndexParams, ds, n, device="cpu")
    jrec = _churn(JaxIndex, JaxParams, ds, n)
    assert rec >= 0.8, f"churn recall {rec}"
    assert rec >= jrec - 0.02, (rec, jrec)


def test_mutated_index_round_trips_through_jax(jax_built, tmp_path):
    """JAX-built index → port: insert, remove, compact, save → JAX loads it
    and searches clean; and the port reloads its own save exactly."""
    ds = jax_built["ds"]
    idx = Index.load(str(jax_built["root"]), "j", device="cpu")
    rng = np.random.default_rng(4)
    new = ds.data[:40] + 0.01 * rng.normal(size=(40, DIM)).astype(np.float32)
    new_ids = idx.insert(new)
    dead = np.concatenate([np.arange(0, 900, 9), new_ids[:5]]).astype(np.int32)
    idx.remove(dead)
    idx._engine.compact()
    idx.save(str(tmp_path / "m"))
    live_new = new_ids[5:]
    gt = calc_gt(np.concatenate([ds.data, new]), ds.queries, 10,
                 deleted=dead, device="cpu")
    back = JaxIndex.load(str(tmp_path), "m")
    again = Index.load(str(tmp_path), "m", device="cpu")
    assert int(back._engine.space.num) == again._engine.num == 940
    got = {}
    for name, ix in (("port", idx), ("jax", back), ("reloaded", again)):
        ids = np.asarray(ix.batch_search(ds.queries, 10, ef_search=64))
        assert not np.isin(ids, dead).any(), name
        got[name] = (ids, calc_recall(ids, gt))
        own = np.asarray(ix.batch_search(new[5:], 1, ef_search=64))[:, 0]
        assert (own == live_new).mean() >= 0.9, name
    np.testing.assert_array_equal(got["port"][0], got["reloaded"][0])
    assert got["port"][1] >= 0.8
    assert abs(got["port"][1] - got["jax"][1]) <= 0.02, got
    # the JAX package goes on mutating what the port saved
    more = np.asarray(back.insert(ds.data[100:104] + 0.01))
    assert (more == np.arange(940, 944)).all()


def test_flat_index_has_no_graph_to_update():
    ds = random_dataset(n=64, dim=8, n_queries=1, seed=1)
    idx = Index("f", IndexParams(index_type="flat", capacity=64),
                device="cpu")
    idx.fit(ds.data)
    idx.remove(3)
    idx._engine.compact()                       # nothing to do, as in JAX
    with pytest.raises(RuntimeError, match="no graph"):
        idx._engine.update_nodes([1])


def test_cluster_init_with_spare_capacity():
    """A space with room to insert into (capacity > n) fits like a full
    one: the cluster-local kNN init reads rows [0, n) only, also where a
    chunk ends past n."""
    from alayalite_tpu_torch.index.nndescent import _init_cluster_knn
    from alayalite_tpu_torch.spaces.raw import RawSpace

    d = random_dataset(n=5000, dim=16, n_queries=1, seed=4)
    out = {}
    for capacity in (5000, 6000):
        raw = RawSpace.create(capacity, 16).fit(torch.from_numpy(d.data))
        out[capacity] = _init_cluster_knn(raw, 5000, 8, seed=0, chunk=2048)
    assert torch.equal(out[5000][1], out[6000][1])
    ids = out[6000][1]
    assert ids.shape == (5000, 8) and int(ids.max()) < 5000


def test_block_insert_below_seed_scan_size():
    """Under 256 rows there is no seed-scan sample: the insert's search
    starts from the graph's shared entry points."""
    ds = random_dataset(n=200, dim=DIM, n_queries=2, seed=29)
    idx = Index("tiny", _params(IndexParams, 260), device="cpu")
    idx.fit(ds.data)
    assert idx._engine._seed_scan_arrays() is None
    new = ds.data[:20] + 0.01
    new_ids = idx.insert(new)
    assert (new_ids == np.arange(200, 220)).all()
    top = idx.batch_search(new, 1, ef_search=32)[:, 0]
    assert (top == new_ids).mean() >= 0.9
