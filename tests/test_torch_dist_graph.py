"""serve_shards: ONE graph with its slab row-sharded
(``parallel/dist_graph.py``), on 8 virtual CPU shards
(``platforms.force_devices(8, "cpu")``), against the JAX package's
``DistGraphEngine`` fitted once per module on its 8 virtual CPU devices.

The port's ``dist_graph_search`` over the arrays of JAX's fitted engine
(carried across with ``convert.from_jax_sharded_leaves``) returns JAX's ids
on ≥ 0.99 of the queries; the port's own fit reads within 0.02 of a
single-device fit (JAX's own bound, test_dist_graph.py). Two JAX defects
are shown absent: ids in [n − k, n) stay searchable after k removes, and
``remove`` checks ids against n, not the padded row count."""

import jax
import numpy as np
import pytest
import torch

from alayalite_tpu import Index as JaxIndex
from alayalite_tpu import IndexParams as JaxParams
from alayalite_tpu_torch import Index, IndexParams
from alayalite_tpu_torch.convert import from_jax_sharded_leaves
from alayalite_tpu_torch.parallel.dist_graph import DistGraphEngine
from alayalite_tpu_torch.utils import platforms
from alayalite_tpu_torch.utils.datasets import random_dataset

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 JAX devices")

N = 2003  # not divisible by 8
PARAMS = dict(index_type="hnsw", capacity=N, serve_shards=8, max_nbrs=16,
              ef_construction=64)


@pytest.fixture
def cpu8():
    with platforms.force_devices(8, "cpu"):
        yield


def _recall(got, gt):
    return float(np.mean([len(set(got[i]) & set(gt[i])) / gt.shape[1]
                          for i in range(gt.shape[0])]))


def _same_rows(a, b) -> float:
    return float(np.mean([set(x[x >= 0]) == set(y[y >= 0])
                          for x, y in zip(a, b)]))


@pytest.fixture(scope="module")
def ds():
    d = random_dataset(n=N, dim=32, n_queries=64, seed=21, device="cpu")
    gt = np.argsort(((d.queries[:, None, :] - d.data[None, :, :]) ** 2)
                    .sum(-1), axis=1)[:, :10]
    return d, gt


@pytest.fixture(scope="module")
def jax_fitted(ds):
    d, _ = ds
    j = JaxIndex("dist", JaxParams(**PARAMS))
    j.fit(d.data)
    return j


@pytest.fixture(scope="module")
def port_fitted(ds):
    d, _ = ds
    with platforms.force_devices(8, "cpu"):
        p = Index("dist", IndexParams(**PARAMS), device="cpu")
        p.fit(d.data)
    return p


def _from_jax(j) -> DistGraphEngine:
    e = j._engine
    arrays = {"data": np.asarray(e._host_data), "nbrs": np.asarray(e._nbrs),
              "eps": np.asarray(e._eps), "valid": np.asarray(e._valid),
              "n": e._n}
    return from_jax_sharded_leaves("dist", arrays, None,
                                   params=IndexParams(**PARAMS), device="cpu")


def test_slab_is_sharded_not_replicated(port_fitted):
    eng = port_fitted._engine
    shards = eng._data_sh
    assert len(shards) == 8
    rows = sum(s.shape[0] for s in shards)
    assert rows >= N and rows % (128 * 8) == 0
    assert all(s.shape[0] == rows // 8 for s in shards)
    assert all(s.shape[0] == rows // 8 for s in eng._sq_sh)
    # the adjacency and the valid mask sit once, on the lead device
    assert eng._nbrs.shape == (N, 16) and eng._valid.shape == (rows,)
    assert eng.build_timings["repair"] >= 0.0


def test_recall_parity_vs_single_device(ds, port_fitted):
    d, gt = ds
    r_dist = _recall(port_fitted.batch_search(d.queries, 10, ef_search=96),
                     gt)
    single = Index("one", IndexParams(index_type="hnsw", capacity=N,
                                      max_nbrs=16, ef_construction=64),
                   device="cpu")
    single.fit(d.data)
    r_one = _recall(single.batch_search(d.queries, 10, ef_search=96), gt)
    assert r_dist >= r_one - 0.02, (r_dist, r_one)
    assert r_dist >= 0.9, r_dist


def test_search_on_jax_arrays_returns_jax_ids(ds, jax_fitted, cpu8):
    d, gt = ds
    eng = _from_jax(jax_fitted)
    got, dist = eng.batch_search_with_distance(d.queries, 10, ef=96)
    want, wd = jax_fitted.batch_search_with_distance(d.queries, 10,
                                                     ef_search=96)
    assert _same_rows(got, want) >= 0.99
    assert abs(_recall(got, gt) - _recall(want, gt)) <= 0.002
    np.testing.assert_allclose(np.sort(dist, 1), np.sort(wd, 1), rtol=1e-4,
                               atol=1e-3)


def test_remove_tombstones_filter(ds, jax_fitted, cpu8):
    d, gt = ds
    idx = Index.__new__(Index)
    idx.name, idx._engine = "t", _from_jax(jax_fitted)
    idx.params, idx._dim = idx._engine.params, 32
    victim = int(gt[0][0])
    idx.remove(victim)
    assert victim not in idx.batch_search(d.queries[:8], 10, ef_search=96)
    with pytest.raises(ValueError):
        idx.remove(10**7)
    with pytest.raises(RuntimeError):
        idx.insert(d.data[0])  # static after fit, an explicit error
    assert idx._engine.num == N - 1


def test_live_ids_past_removed_count_stay_searchable(ds, jax_fitted, cpu8):
    """JAX bounds ids by sum(valid): after k removes its DistSlab scores
    the live ids in [n − k, n) as inf, and they vanish from the results.
    The port bounds ids by n."""
    d, _ = ds
    eng = _from_jax(jax_fitted)
    eng.remove(np.arange(100))
    tail = d.data[N - 100:]
    got = eng.batch_search(tail, 1, ef=64)[:, 0]
    assert np.mean(got == np.arange(N - 100, N)) >= 0.95
    assert not np.isin(got, np.arange(100)).any()
    # JAX's behaviour, on a copy of its own engine
    jcopy = JaxIndex("jcopy", JaxParams(**PARAMS))
    jcopy._engine = type(jax_fitted._engine).__new__(
        type(jax_fitted._engine))
    jcopy._engine.__dict__.update(jax_fitted._engine.__dict__)
    jcopy._engine._removed = []
    jcopy._dim = 32
    jcopy._engine.remove(np.arange(100))
    jgot = jcopy.batch_search(tail, 1, ef_search=64)[:, 0]
    assert np.mean(jgot == np.arange(N - 100, N)) < 0.5


def test_remove_checks_ids_against_n(jax_fitted, cpu8):
    """The padded rows [n, npad) are not ids: the port refuses them, the
    JAX package accepts them (its check is against npad)."""
    eng = _from_jax(jax_fitted)
    pad_id = eng._npad - 1
    assert pad_id >= N
    with pytest.raises(ValueError, match="out of range"):
        eng.remove(pad_id)
    with pytest.raises(ValueError):
        eng.remove(N)
    assert jax_fitted._engine._npad - 1 >= N   # JAX would take it


def test_save_load_both_ways(ds, jax_fitted, port_fitted, tmp_path, cpu8):
    d, _ = ds
    a = port_fitted.batch_search(d.queries, 10, ef_search=96)
    (tmp_path / "p").mkdir()
    port_fitted.save(str(tmp_path / "p"))
    p2 = Index.load(str(tmp_path), "p", device="cpu")
    np.testing.assert_array_equal(a, p2.batch_search(d.queries, 10,
                                                     ef_search=96))
    j2 = JaxIndex.load(str(tmp_path), "p")
    assert _same_rows(j2.batch_search(d.queries, 10, ef_search=96), a) >= 0.99
    (tmp_path / "j").mkdir()
    jax_fitted.save(str(tmp_path / "j"))
    p3 = Index.load(str(tmp_path), "j", device="cpu")
    assert isinstance(p3._engine, DistGraphEngine)
    np.testing.assert_array_equal(
        p3.batch_search(d.queries, 10, ef_search=96),
        _from_jax(jax_fitted).batch_search(d.queries, 10, ef=96))


def test_cos_metric(cpu8):
    ds = random_dataset(n=1100, dim=32, n_queries=32, seed=4, device="cpu")
    idx = Index("dcos", IndexParams(index_type="nsg", capacity=1100,
                                    serve_shards=8, max_nbrs=16,
                                    ef_construction=64, metric="cos"),
                device="cpu")
    idx.fit(ds.data)
    got, dist = idx.batch_search_with_distance(ds.data[:32], 5,
                                               ef_search=64)
    assert np.mean(got[:, 0] == np.arange(32)) >= 0.95
    np.testing.assert_allclose(dist[:, 0], -1.0, atol=1e-5)


def test_param_validation():
    with pytest.raises(ValueError):
        IndexParams(index_type="flat", serve_shards=8)
    with pytest.raises(ValueError):
        IndexParams(index_type="hnsw", serve_shards=8,
                    quantization_type="bsq8")
    with pytest.raises(ValueError):
        IndexParams(index_type="hnsw", serve_shards=8, db_shards=2)
    p = IndexParams(index_type="hnsw", serve_shards=8)
    assert IndexParams.from_dict(p.to_dict()).serve_shards == 8
    # one real CPU device: too few, and JAX raises at construction too
    with pytest.raises(RuntimeError, match="serve_shards=8"):
        Index("few", p, device="cpu")


def _islands(seed: int = 3, n: int = 600, dim: int = 16, r: int = 8,
             parts: int = 6):
    """Rows in ``parts`` far-apart blobs whose edges stay inside the blob,
    a fifth of them cut: a graph with many unreached components."""
    rng = np.random.default_rng(seed)
    part = np.sort(rng.integers(0, parts, size=n))
    data = (rng.normal(size=(n, dim)) + part[:, None] * 6.0).astype(
        np.float32)
    nbrs = np.full((n, r), -1, np.int32)
    for p in range(parts):
        ids = np.flatnonzero(part == p)
        nbrs[ids] = rng.choice(ids[: max(1, ids.size - 5)],
                               size=(ids.size, r))
    nbrs[rng.random((n, r)) < 0.2] = -1
    return data, nbrs


def test_components_of_matches_jax_and_bfs():
    """Both routes return JAX's representatives: scipy's undirected
    components, and the BFS route (no scipy), which follows out-edges only
    and so may split a component into more representatives."""
    from alayalite_tpu.index import nsg as jnsg
    from alayalite_tpu_torch.index import nsg

    _, nbrs = _islands()
    members = np.flatnonzero(np.random.default_rng(4).random(600) < 0.7)
    got = nsg._components_of(nbrs, members)
    np.testing.assert_array_equal(got, jnsg._components_of(nbrs, members))
    bfs = nsg._components_of_bfs(nbrs, members)
    np.testing.assert_array_equal(bfs,
                                  jnsg._components_of_bfs(nbrs, members))
    assert bfs.size >= got.size > 1


@pytest.mark.parametrize("shards", [1, 4])
def test_attach_unreached_matches_jax(shards):
    """The host repair writes JAX's edges on the same broken graph, through
    the sharded nearest-reached scan of ``dist_graph`` over the rows in one
    shard or in four (JAX scans its whole space)."""
    import jax.numpy as jnp

    from alayalite_tpu.index.nsg import _attach_unreached as jax_attach
    from alayalite_tpu.spaces.raw import RawSpace as JaxRaw
    from alayalite_tpu_torch.index.nsg import _attach_unreached
    from alayalite_tpu_torch.parallel.build_sharded import make_build_mesh
    from alayalite_tpu_torch.parallel.dist_graph import (
        _nearest_reached_factory)

    data, nbrs = _islands()
    n = data.shape[0]
    want = jax_attach(JaxRaw.create(n, data.shape[1]).fit(jnp.asarray(data)),
                      nbrs.copy(), 0)
    rounds = []
    with platforms.force_devices(shards, "cpu"):
        mesh = make_build_mesh(shards)
    parts = [torch.from_numpy(x) for x in np.split(data, shards)]
    got = _attach_unreached(
        nbrs.copy(), 0, _nearest_reached_factory(mesh, parts, data, "l2"),
        rounds=rounds)
    np.testing.assert_array_equal(got, want)
    assert rounds and rounds[0][1] > 1
