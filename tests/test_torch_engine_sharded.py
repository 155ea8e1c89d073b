"""The db-sharded SDK engine (``parallel/engine_sharded.py``): the SDK cases
of test_sharded.py and both cases of test_sharded_u64.py on the port, the
id map against the JAX package's, and sharded index directories carried
between the packages both ways.

The port takes the mesh program under ``platforms.force_devices(8, "cpu")``
and the per-shard fallback with the CPU's one real device; both are
checked. Cross-package searches use exact flat shards (ids equal) or the
same bsq8 graph (equal id rows on ≥ 0.99 of the queries: the JAX block beam
and the port's break ties in the bf16 estimates differently)."""

import os

import numpy as np
import pytest
import torch

from alayalite_tpu import Index as JaxIndex
from alayalite_tpu import IndexParams as JaxParams
from alayalite_tpu.parallel.engine_sharded import _GidMap as JaxGidMap
from alayalite_tpu_torch import Client, Index, IndexParams
from alayalite_tpu_torch.parallel.engine_sharded import ShardedEngine, _GidMap
from alayalite_tpu_torch.utils import platforms
from alayalite_tpu_torch.utils.datasets import random_dataset
from alayalite_tpu_torch.utils.evaluate import calc_recall

torch.set_num_threads(2)

CAP = 2_400_000_000  # > 2**31 - 2; per-shard 6e8 < 2**30 - 1


@pytest.fixture
def cpu8():
    with platforms.force_devices(8, "cpu"):
        yield


def _same_rows(a, b) -> float:
    return float(np.mean([set(x[x >= 0]) == set(y[y >= 0])
                          for x, y in zip(a, b)]))


@pytest.mark.parametrize("mesh", [True, False])
def test_sdk_sharded_bsq8_full_lifecycle(tmp_path, mesh):
    """Fit, search, save, load, insert, remove through Index (the JAX
    test's sizes), on the mesh program and on the fallback."""
    ds = random_dataset(n=1200, dim=32, n_queries=16, seed=41, topk=10,
                        device="cpu")
    with platforms.force_devices(8 if mesh else 1, "cpu"):
        idx = Index("s", IndexParams(index_type="hnsw", capacity=1600,
                                     max_nbrs=16, ef_construction=48,
                                     quantization_type="bsq8", db_shards=2),
                    device="cpu")
        idx.fit(ds.data)
        assert isinstance(idx._engine, ShardedEngine)
        assert (idx._engine._mesh() is not None) == mesh
        ids = idx.batch_search(ds.queries, 10, ef_search=80)
        assert calc_recall(ids, ds.gt) >= 0.85
        d = tmp_path / "s"
        idx.save(str(d))
        idx2 = Index.load(str(tmp_path), "s", device="cpu")
        np.testing.assert_array_equal(
            ids, idx2.batch_search(ds.queries, 10, ef_search=80))
        new = ds.data[:8] + 0.01
        nids = np.atleast_1d(idx2.insert(new))
        assert (nids >= 1200).all()
        got = idx2.batch_search(new, 5, ef_search=64)
        assert np.mean([nids[i] in got[i] for i in range(8)]) >= 0.9
        idx2.remove(nids[:4])
        got2 = idx2.batch_search(ds.queries, 10, ef_search=64)
        assert not np.isin(got2, nids[:4]).any()
        idx2._engine.compact()
        assert not np.isin(idx2.batch_search(ds.queries, 10, ef_search=64),
                           nids[:4]).any()


def test_sdk_sharded_flat_ids_are_row_positions(cpu8):
    ds = random_dataset(n=1000, dim=16, n_queries=32, seed=43, topk=10,
                        device="cpu")
    idx = Client(device="cpu").create_index("f", index_type="flat",
                                            capacity=1200, db_shards=4)
    idx.fit(ds.data)
    assert idx._engine._mesh() is not None
    ids = idx.batch_search(ds.queries, 10, ef_search=10)
    assert calc_recall(ids, ds.gt) == 1.0
    np.testing.assert_allclose(idx.get_data_by_id(int(ids[0, 0])),
                               ds.data[int(ids[0, 0])], rtol=1e-6)
    # each shard holds only its own rows
    assert [sh.space.capacity for sh in idx._engine.shards] == [300] * 4


def test_sdk_sharded_fallback_matches_mesh():
    ds = random_dataset(n=800, dim=16, n_queries=16, seed=47, topk=10,
                        device="cpu")
    idx = Index("fb", IndexParams(index_type="flat", capacity=800,
                                  db_shards=2), device="cpu")
    idx.fit(ds.data)
    assert idx._engine._mesh() is None   # one CPU device
    fb_ids, fb_d = idx.batch_search_with_distance(ds.queries, 10,
                                                  ef_search=10)
    with platforms.force_devices(8, "cpu"):
        mesh_ids, mesh_d = idx.batch_search_with_distance(ds.queries, 10,
                                                          ef_search=10)
    assert calc_recall(fb_ids, ds.gt) == 1.0
    np.testing.assert_array_equal(mesh_ids, fb_ids)
    np.testing.assert_array_equal(mesh_d, fb_d)


@pytest.mark.parametrize("index_type,quant", [
    ("hnsw", "none"), ("hnsw", "sq8"), ("nsg", "none"), ("hnsw", "rabitq")])
def test_non_block_shards_search_with_devices_to_spare(index_type, quant):
    """IndexParams refuses db_shards for layouts the mesh program cannot
    assemble (raw, sq, rabitq), in both packages. An engine given such
    params all the same serves them per shard with a host merge, even where
    the devices would make a mesh: the same results as with one device."""
    kw = dict(index_type=index_type, capacity=700, max_nbrs=16,
              ef_construction=48, quantization_type=quant)
    for params_cls in (IndexParams, JaxParams):
        with pytest.raises(ValueError, match="db_shards > 1 supports"):
            params_cls(db_shards=2, **kw)
    params = IndexParams(**kw)
    params.db_shards = 2   # past the check in __post_init__
    ds = random_dataset(n=600, dim=16, n_queries=16, seed=49, topk=10,
                        device="cpu")
    eng = ShardedEngine(params, device="cpu")
    eng.fit(ds.data)
    ids1, d1 = eng.batch_search_with_distance(ds.queries, 10, ef=64)
    with platforms.force_devices(2, "cpu"):
        assert eng._mesh() is not None
        ids2, d2 = eng.batch_search_with_distance(ds.queries, 10, ef=64)
    assert calc_recall(ids1, ds.gt) >= 0.8
    np.testing.assert_array_equal(ids2, ids1)
    np.testing.assert_array_equal(d2, d1)


def test_mesh_ids_after_uneven_inserts(cpu8):
    """After inserts the shards differ in num but not in capacity: the
    mesh's combined ids (s * per_cap + local) still map to global ids."""
    ds = random_dataset(n=600, dim=16, n_queries=8, seed=48, topk=10,
                        device="cpu")
    idx = Index("u", IndexParams(index_type="flat", capacity=900,
                                 db_shards=3), device="cpu")
    idx.fit(ds.data[:500])
    idx.insert(ds.data[500:520])
    nums = [sh.space.num for sh in idx._engine.shards]
    assert len(set(nums)) > 1
    assert len({sh.space.capacity for sh in idx._engine.shards}) == 1
    new = idx.insert(ds.data[520:600])
    got = idx.batch_search(ds.data[520:600], 1, ef_search=10)
    np.testing.assert_array_equal(got[:, 0], new)
    with platforms.force_devices(1, "cpu"):
        np.testing.assert_array_equal(
            idx.batch_search(ds.data[520:600], 1, ef_search=10), got)


def test_guard_rejects_unsharded_and_narrow_ids():
    with pytest.raises(ValueError, match="shard the database"):
        IndexParams(index_type="flat", capacity=CAP)
    with pytest.raises(ValueError, match="64-bit id_type"):
        IndexParams(index_type="flat", capacity=CAP, db_shards=4)


@pytest.mark.parametrize("mesh", [True, False])
def test_sharded_index_beyond_int32_ids_end_to_end(tmp_path, mesh):
    params = IndexParams(index_type="flat", capacity=CAP, db_shards=4,
                         id_type="int64")
    with platforms.force_devices(8 if mesh else 1, "cpu"):
        idx = Index("big", params, device="cpu")
        rng = np.random.default_rng(7)
        data = rng.normal(size=(512, 16)).astype(np.float32)
        idx.fit(data)
        eng = idx._engine
        assert eng.capacity >= CAP
        assert sum(sh.space.capacity for sh in eng.shards) <= 4 * 4096
        ids, _ = idx.batch_search_with_distance(data[:8], 3, ef_search=32)
        assert ids.dtype == np.int64
        assert (ids[:, 0] == np.arange(8)).all()
        eng._next_gid = 2**31 + 3
        fresh = rng.normal(size=(5, 16)).astype(np.float32) + 50.0
        got = np.asarray(idx.insert(fresh))
        assert got.dtype == np.int64 and got.min() > 2**31
        ids2, _ = idx.batch_search_with_distance(fresh, 1, ef_search=32)
        assert (ids2[:, 0] == got).all()
        np.testing.assert_allclose(idx.get_data_by_id(int(got[0])), fresh[0],
                                   rtol=1e-6)
        d = os.path.join(tmp_path, "big")
        os.makedirs(d, exist_ok=True)
        idx.save(d)
        idx2 = Index.load(str(tmp_path), "big", device="cpu")
        assert idx2._engine.capacity >= CAP
        ids3 = idx2.batch_search(fresh, 1, ef_search=32)
        assert ids3.dtype == np.int64 and (ids3[:, 0] == got).all()
        idx2._engine.remove(got[0])
        assert idx2.batch_search(fresh[:1], 1, ef_search=32)[0, 0] != got[0]


def test_gid_map_state_matches_jax():
    calls = [(np.arange(100), 0, np.arange(100)),
             (np.arange(100, 140), 1, np.arange(40)),
             (np.array([5000, 5001]), 2, np.array([7, 8])),
             (np.array([2**31 + 3, 2**33]), 3, np.array([1, 2]))]
    j, p = JaxGidMap(100), _GidMap(100)
    for g, s, l in calls:
        j.set_many(g, s, l)
        p.set_many(g, s, l)
    js, ps = j.state(), p.state()
    assert js.keys() == ps.keys()
    for key in js:
        np.testing.assert_array_equal(ps[key], js[key])
    probe = np.array([0, 99, 120, 139, 140, 5001, 2**31 + 3, 2**33, 7, -1])
    for a, b in zip(p.lookup(probe), j.lookup(probe)):
        np.testing.assert_array_equal(a, b)
    q = _GidMap.from_state(js)
    np.testing.assert_array_equal(q.lookup(probe)[1], j.lookup(probe)[1])


def test_flat_directory_both_ways(tmp_path, cpu8):
    """A flat db_shards=4 directory saved by the JAX package searches with
    JAX's ids in the port (mesh and fallback), and the port's in JAX."""
    ds = random_dataset(n=900, dim=16, n_queries=24, seed=49, topk=10,
                        device="cpu")
    kw = dict(index_type="flat", capacity=1000, db_shards=4)
    j = JaxIndex("jf", JaxParams(**kw))
    j.fit(ds.data)
    j.remove(np.array([int(i) for i in ds.gt[:3, 0]]))
    jids, jd = j.batch_search_with_distance(ds.queries, 10)
    (tmp_path / "jf").mkdir()
    j.save(str(tmp_path / "jf"))
    p = Index.load(str(tmp_path), "jf", device="cpu")
    assert isinstance(p._engine, ShardedEngine)
    pids, pd = p.batch_search_with_distance(ds.queries, 10)
    np.testing.assert_array_equal(pids, jids)
    with platforms.force_devices(1, "cpu"):
        np.testing.assert_array_equal(p.batch_search(ds.queries, 10), jids)
    # the reverse: the port inserts, saves; the JAX package loads
    new = p.insert(ds.queries[:4] + 0.5)
    (tmp_path / "pf").mkdir()
    p.save(str(tmp_path / "pf"))
    j2 = JaxIndex.load(str(tmp_path), "pf")
    np.testing.assert_array_equal(j2.batch_search(ds.queries, 10),
                                  p.batch_search(ds.queries, 10))
    np.testing.assert_array_equal(
        j2.batch_search(ds.queries[:4] + 0.5, 1)[:, 0], new)


@pytest.mark.parametrize("loader", ["port", "jax"])
def test_pre_round4_map_layout_loads(tmp_path, loader):
    """shard_map.npz in the layout before per-shard l2g tables (one
    [ndb, per_cap] l2g, dense g2s / g2l, no overflow) loads in both
    packages with the ids an insert gave."""
    ds = random_dataset(n=600, dim=16, n_queries=16, seed=53, topk=10,
                        device="cpu")
    p = Index("old", IndexParams(index_type="flat", capacity=800,
                                 db_shards=2), device="cpu")
    p.fit(ds.data)
    new = p.insert(ds.queries[:4] + 0.5)
    want = p.batch_search(ds.queries, 10)
    (tmp_path / "old").mkdir()
    p.save(str(tmp_path / "old"))
    eng = p._engine
    gm = eng._gid_map.state()
    np.savez(os.path.join(tmp_path, "old", "shard_map.npz"),
             next_gid=np.int64(eng._next_gid), l2g=np.stack(eng._l2g),
             g2s=gm["g2s"], g2l=gm["g2l"])
    back = (Index.load(str(tmp_path), "old", device="cpu") if loader == "port"
            else JaxIndex.load(str(tmp_path), "old"))
    np.testing.assert_array_equal(back.batch_search(ds.queries, 10), want)
    np.testing.assert_array_equal(
        back.batch_search(ds.queries[:4] + 0.5, 1)[:, 0], new)
    assert back.insert(ds.queries[4] + 0.5) == eng._next_gid


def test_bsq8_directory_both_ways(tmp_path, cpu8):
    """The same bsq8 db_shards=2 graph in both packages: the port's
    directory loads in JAX (both take their mesh programs), JAX saves it
    again, and the port loads that with its own ids."""
    ds = random_dataset(n=1000, dim=32, n_queries=32, seed=51, topk=10,
                        device="cpu")
    p = Index("pb", IndexParams(index_type="hnsw", capacity=1100,
                                max_nbrs=16, ef_construction=48,
                                quantization_type="bsq8", db_shards=2),
              device="cpu")
    p.fit(ds.data)
    new = p.insert(ds.queries[:4] + 0.01)
    p.remove(np.array([int(i) for i in ds.gt[:2, 0]]))
    pids = p.batch_search(ds.queries, 10, ef_search=64)
    (tmp_path / "pb").mkdir()
    p.save(str(tmp_path / "pb"))
    j = JaxIndex.load(str(tmp_path), "pb")
    assert j._engine._mesh() is not None
    jids = j.batch_search(ds.queries, 10, ef_search=64)
    assert _same_rows(pids, jids) >= 0.99
    assert abs(calc_recall(pids, ds.gt) - calc_recall(jids, ds.gt)) <= 0.01
    (tmp_path / "jb").mkdir()
    j.save(str(tmp_path / "jb"))
    p2 = Index.load(str(tmp_path), "jb", device="cpu")
    np.testing.assert_array_equal(p2.batch_search(ds.queries, 10,
                                                  ef_search=64), pids)
    got = p2.batch_search(ds.queries[:4] + 0.01, 1, ef_search=64)[:, 0]
    assert np.mean(got == new) >= 0.75


def test_block_cos_distances(cpu8):
    """The block mesh path returns −cos (d/2 − 1 of the normalized L2), as
    the per-shard fallback does through IndexEngine."""
    ds = random_dataset(n=600, dim=16, n_queries=16, seed=53, topk=10,
                        metric="cos", device="cpu")
    idx = Index("c", IndexParams(index_type="hnsw", capacity=600,
                                 max_nbrs=16, ef_construction=48,
                                 quantization_type="bsq8", metric="cos",
                                 db_shards=2), device="cpu")
    idx.fit(ds.data)
    ids, d = idx.batch_search_with_distance(ds.queries, 5, ef_search=48)
    xn = ds.data / np.linalg.norm(ds.data, axis=1, keepdims=True)
    qn = ds.queries / np.linalg.norm(ds.queries, axis=1, keepdims=True)
    want = -np.take_along_axis(qn @ xn.T, ids.astype(np.int64), 1)
    np.testing.assert_allclose(d, want, atol=2e-5)
    with platforms.force_devices(1, "cpu"):
        fids, fd = idx.batch_search_with_distance(ds.queries, 5,
                                                  ef_search=48)
    want_f = -np.take_along_axis(qn @ xn.T, fids.astype(np.int64), 1)
    np.testing.assert_allclose(fd, want_f, atol=2e-5)
    assert calc_recall(ids, ds.gt[:, :5]) >= 0.9


def test_sharded_params_through_client():
    c = Client(device="cpu")
    with pytest.raises(ValueError, match="db_shards"):
        c.create_index("x", index_type="hnsw", db_shards=2)
    idx = c.create_index("ok", index_type="flat", db_shards=2, capacity=64)
    assert isinstance(idx._engine, ShardedEngine)
