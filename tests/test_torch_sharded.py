"""The port's sharded searches (``parallel/sharded.py``) against the JAX
package's on 8 devices: the JAX side on the 8 virtual CPU devices of
``tests/conftest.py``, the port's on 8 virtual shards of the CPU
(``platforms.force_devices(8, "cpu")``, restored after each test).

Both packages search the same graphs: per-shard kNN graphs made with numpy
(exact, on each shard's rows) and, for the block search, the port's
``BQGSpace`` codes of those graphs, carried across with
``convert.from_jax_sharded_leaves``. Thresholds: exact flat f32 ids equal
and distances within rtol 1e-5 and an atol of 4 ulp of max |q|² + max |x|²
(``_atol``, as in test_torch_flat.py: |q|² + |x|² − 2 q·x cancels sums near
1000 on this data, whose f32 ulp is 6e-5); bf16 flat recall within 0.002 of
JAX's; graph and block searches recall within 0.002 of JAX's with equal id
rows on ≥ 0.99 of the queries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import alayalite_tpu.parallel as jpar
from alayalite_tpu.parallel.sharded import db_sharded_block_search as jax_block_search
from alayalite_tpu.spaces.raw import RawSpace as JaxRawSpace
from alayalite_tpu_torch.convert import from_jax_sharded_leaves
from alayalite_tpu_torch.parallel import sharded as tsh
from alayalite_tpu_torch.spaces.bqg import BQGSpace
from alayalite_tpu_torch.spaces.raw import RawSpace
from alayalite_tpu_torch.utils import platforms
from alayalite_tpu_torch.utils.datasets import random_dataset
from alayalite_tpu_torch.utils.evaluate import calc_recall

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 JAX devices")

N, DIM, NQ, K = 1024, 16, 64, 10


@pytest.fixture
def cpu8():
    with platforms.force_devices(8, "cpu"):
        yield


@pytest.fixture(scope="module")
def ds():
    return random_dataset(n=N, dim=DIM, n_queries=NQ, seed=2, topk=K,
                          device="cpu")


def _atol(x: np.ndarray, q: np.ndarray) -> float:
    top = (q ** 2).sum(1).max() + (x ** 2).sum(1).max()
    return max(1e-5, 4 * float(np.spacing(np.float32(top))))


def _same_rows(a, b) -> float:
    return float(np.mean([set(x[x >= 0]) == set(y[y >= 0])
                          for x, y in zip(a, b)]))


def _shard_knn(x: np.ndarray, ndb: int, r: int) -> np.ndarray:
    """Per-shard exact kNN rows over each shard's own rows (local ids)."""
    per = x.shape[0] // ndb
    out = np.zeros((x.shape[0], r), np.int32)
    for s in range(ndb):
        blk = x[s * per:(s + 1) * per]
        d = ((blk[:, None] - blk[None]) ** 2).sum(-1)
        np.fill_diagonal(d, np.inf)
        out[s * per:(s + 1) * per] = np.argsort(d, 1)[:, :r]
    return out


EPS = np.arange(0, 128, 16, dtype=np.int32)


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shape_matches_jax(n, cpu8):
    want = dict(jpar.make_mesh(n).shape)
    got = tsh.make_mesh(n)
    assert got.shape == want
    assert got.axis_names == ("dp", "db")


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dp", [1, None])
def test_flat_search_matches_jax(ds, metric, dp, cpu8):
    jm = jpar.make_mesh(8, dp=dp)
    jsp = jpar.shard_space_by_rows(jm, JaxRawSpace.create(N, DIM, metric=metric)
                                   .fit(ds.data))
    jd, ji = jpar.db_sharded_flat_search(jm, jsp, jnp.asarray(ds.queries), K)
    pm = tsh.make_mesh(8, dp=dp)
    assert pm.shape == dict(jm.shape)
    psp = tsh.shard_space_by_rows(pm, RawSpace.create(N, DIM, metric=metric)
                                  .fit(ds.data))
    # every shard holds only its own rows
    assert [x.shape[0] for x in psp.data[0]] == [N // pm.shape["db"]] * \
        pm.shape["db"]
    pd, pi = tsh.db_sharded_flat_search(pm, psp, torch.as_tensor(ds.queries),
                                        K)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=_atol(ds.data, ds.queries))


def test_flat_search_bf16_recall_matches_jax(ds, cpu8):
    jm, pm = jpar.make_mesh(8), tsh.make_mesh(8)
    jsp = jpar.shard_space_by_rows(jm, JaxRawSpace.create(N, DIM).fit(ds.data))
    _, ji = jpar.db_sharded_flat_search(jm, jsp, jnp.asarray(ds.queries), K,
                                        bf16=True)
    psp = tsh.shard_space_by_rows(pm, RawSpace.create(N, DIM).fit(ds.data))
    _, pi = tsh.db_sharded_flat_search(pm, psp, torch.as_tensor(ds.queries),
                                       K, bf16=True)
    rj, rp = calc_recall(np.asarray(ji), ds.gt), calc_recall(pi.numpy(), ds.gt)
    assert abs(rp - rj) <= 0.002, (rp, rj)


def test_flat_k_larger_than_shard(cpu8):
    """8 rows a shard, k = 12: each shard pads its result to k."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    q = rng.normal(size=(8, 8)).astype(np.float32)
    jm = jpar.make_mesh(8, dp=1)
    jd, ji = jpar.db_sharded_flat_search(
        jm, jpar.shard_space_by_rows(jm, JaxRawSpace.create(64, 8).fit(x)),
        jnp.asarray(q), 12)
    pm = tsh.make_mesh(8, dp=1)
    pd, pi = tsh.db_sharded_flat_search(
        pm, tsh.shard_space_by_rows(pm, RawSpace.create(64, 8).fit(x)),
        torch.as_tensor(q), 12)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=_atol(x, q))


def test_dp_sharded_beam_search_matches_jax(ds, cpu8):
    from alayalite_tpu_torch.index.knn import exact_knn

    _, nbrs = exact_knn(torch.as_tensor(ds.data), 16)
    eps = np.arange(0, N, 8, dtype=np.int32)
    seeds = np.broadcast_to(eps[None], (NQ, eps.size))
    jspace = JaxRawSpace.create(N, DIM).fit(ds.data)
    _, ji = jpar.dp_sharded_beam_search(
        jpar.make_mesh(8), jspace, jnp.asarray(nbrs.numpy()),
        jnp.asarray(seeds), jnp.asarray(ds.queries), k=K, ef=64,
        valid=jspace.valid)
    pspace = RawSpace.create(N, DIM).fit(ds.data)
    _, pi = tsh.dp_sharded_beam_search(
        tsh.make_mesh(8), pspace, nbrs, torch.as_tensor(seeds.copy()),
        torch.as_tensor(ds.queries), k=K, ef=64, valid=pspace.valid)
    ji, pi = np.asarray(ji), pi.numpy()
    assert abs(calc_recall(pi, ds.gt) - calc_recall(ji, ds.gt)) <= 0.002
    assert _same_rows(pi, ji) >= 0.99


def _graph_leaves(x: np.ndarray, ndb: int = 8, r: int = 12):
    nbrs = _shard_knn(x, ndb, r)
    return (x, (x * x).sum(1).astype(np.float32), np.ones(x.shape[0], bool),
            nbrs, np.tile(EPS, (ndb, 1)))


def test_db_sharded_graph_search_matches_jax(ds, cpu8):
    leaves = _graph_leaves(ds.data)
    jm = jpar.make_mesh(8, dp=1)

    def put(a, *spec):
        return jax.device_put(a, NamedSharding(jm, P(*spec)))

    jd, ji = jpar.db_sharded_graph_search(
        jm, (put(leaves[0], "db", None), put(leaves[1], "db"),
             put(leaves[2], "db")), "l2", put(leaves[3], "db", None),
        put(leaves[4], "db", None), jnp.asarray(ds.queries), k=K, ef=48)
    pm = tsh.make_mesh(8, dp=1)
    idx = from_jax_sharded_leaves("graph", leaves, pm)
    assert [x.shape[0] for x in idx._leaves[0]] == [N // 8] * 8
    pi, pd = idx.batch_search_with_distance(ds.queries, K, ef_search=48)
    ji = np.asarray(ji)
    assert abs(calc_recall(pi, ds.gt) - calc_recall(ji, ds.gt)) <= 0.002
    assert _same_rows(pi, ji) >= 0.99
    np.testing.assert_allclose(np.sort(pd, 1), np.sort(np.asarray(jd), 1),
                               rtol=1e-4, atol=1e-4)


def _block_leaves(x: np.ndarray, ndb: int = 8, r: int = 8,
                  metric: str = "l2"):
    """The JAX layout of ShardedBlockIndex._leaves for per-shard kNN graphs,
    with codes packed by the port's BQGSpace."""
    nbrs = _shard_knn(x, ndb, r)
    per = x.shape[0] // ndb
    cols = [[] for _ in range(9)]
    for s in range(ndb):
        sp = BQGSpace.create(per, x.shape[1], metric=metric, degree=r).fit(
            torch.as_tensor(x[s * per:(s + 1) * per]))
        sp.update_neighbors(torch.as_tensor(nbrs[s * per:(s + 1) * per]))
        for j, a in enumerate(tsh.block_leaves(sp, EPS)):
            a = a.numpy()
            cols[j].append(a[None] if j in (2, 3, 8) else a)
    return [np.concatenate(c) for c in cols]


BLOCK_SPECS = (("db", None), ("db",), ("db", None), ("db", None),
               ("db", None), ("db", None, None), ("db", None), ("db",),
               ("db", None))


@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_db_sharded_block_search_matches_jax(ds, metric, cpu8):
    leaves = _block_leaves(ds.data, metric=metric)
    jm = jpar.make_mesh(8, dp=1)
    jl = tuple(jax.device_put(a, NamedSharding(jm, P(*spec)))
               for a, spec in zip(leaves, BLOCK_SPECS))
    jd, ji = jax_block_search(jm, jl, metric, jnp.asarray(ds.queries), k=K,
                              ef=32)
    idx = from_jax_sharded_leaves("block", leaves, tsh.make_mesh(8, dp=1),
                                  metric=metric)
    pi, pd = idx.batch_search_with_distance(ds.queries, K, ef_search=32)
    ji = np.asarray(ji)
    gt = random_dataset(n=N, dim=DIM, n_queries=NQ, seed=2, topk=K,
                        metric=metric, device="cpu").gt
    assert abs(calc_recall(pi, gt) - calc_recall(ji, gt)) <= 0.002
    assert _same_rows(pi, ji) >= 0.99
    np.testing.assert_allclose(pd, np.asarray(jd), rtol=1e-4, atol=1e-4)


def test_block_index_equals_per_shard_replay(cpu8):
    """The mesh result equals each shard's block search, merged on the
    host (test_sharded.py's replay, on the port)."""
    from alayalite_tpu_torch.index.search import block_beam_search

    mesh = tsh.make_mesh(dp=1)
    ndb = mesh.shape["db"]
    rng = np.random.default_rng(5)
    n, dim, nq, k = 64 * ndb, 16, 8, 5
    data = rng.normal(size=(n, dim)).astype(np.float32)
    q = rng.normal(size=(nq, dim)).astype(np.float32)
    idx = tsh.ShardedBlockIndex(mesh=mesh, max_nbrs=8, ef_construction=32)
    idx.fit(data)
    ids, dists = idx.batch_search_with_distance(q, k, ef_search=16)
    alld, alli = [], []
    for s in range(ndb):
        lv = [x[s] for x in idx._leaves]
        sp = BQGSpace(data=lv[0], sq_norms=lv[1], dmin=lv[2], scale=lv[3],
                      nbr_ids=lv[4], nbr_codes=lv[5], nbr_xsq=lv[6],
                      valid=lv[7], num=64)
        qt = torch.as_tensor(q)
        step = max(1, 64 // 1024)
        from alayalite_tpu_torch.index.search import (scan_seeds,
                                                      seed_sample_arrays)
        sids = torch.arange(0, 64, step, dtype=torch.int32)
        scan = scan_seeds(qt, *seed_sample_arrays(lv[0], sids, "l2"),
                          nseed=8)
        seeds = torch.cat([scan, lv[8][None].expand(nq, -1)], 1)
        d, i = block_beam_search(sp, seeds, qt, k=k, ef=16, valid=lv[7],
                                 n_expand=8)
        alld.append(d.numpy())
        alli.append(np.where(i.numpy() >= 0, i.numpy() + s * 64, -1))
    dd, ii = np.concatenate(alld, 1), np.concatenate(alli, 1)
    sel = np.argsort(dd, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(ids, np.take_along_axis(ii, sel, 1))
    np.testing.assert_allclose(dists, np.take_along_axis(dd, sel, 1),
                               rtol=1e-6)


@pytest.mark.parametrize("kind", ["flat", "graph", "block"])
def test_classes_fit_search_non_divisible(kind, cpu8):
    """n = 1003 over 8 shards: array_split chunks, every shard filled,
    no padding slot in the results."""
    ds = random_dataset(n=1003, dim=16, n_queries=32, seed=6, topk=K,
                        device="cpu")
    mesh = tsh.make_mesh(8, dp=1)
    if kind == "flat":
        idx = tsh.ShardedFlatIndex(mesh, bf16=False)
        floor = 1.0
    elif kind == "graph":
        idx = tsh.ShardedGraphIndex(mesh, max_nbrs=12, ef_construction=64)
        floor = 0.9
    else:
        idx = tsh.ShardedBlockIndex(mesh, max_nbrs=8, ef_construction=32)
        floor = 0.85
    idx.fit(ds.data)
    ids, dists = idx.batch_search_with_distance(ds.queries, K, ef_search=64)
    if kind != "flat":
        # combined ids: shard s's local row j is s * per + j
        per = idx._per
        sizes = [c.shape[0] for c in np.array_split(ds.data, 8)]
        gid = np.concatenate([s * per + np.arange(m)
                              for s, m in enumerate(sizes)])
        lut = np.full(8 * per, -1)
        lut[gid] = np.arange(1003)
        ids = lut[ids]
        assert all(x.shape[0] == per for x in idx._leaves[0])
    assert (ids >= 0).all() and (ids < 1003).all()
    assert calc_recall(ids, ds.gt) >= floor
    assert (np.diff(dists, axis=1) >= -1e-5).all()


DRYRUN = ["flat", "beam", "dbgraph", "dbblock", "sdkshard", "nnd",
          "shardedbuild", "distgraph"]


@pytest.mark.parametrize("stage", DRYRUN)
def test_torch_dryrun_multichip(stage, cpu8):
    """__graft_entry__.dryrun_multichip's stages on the port over 8 virtual
    CPU shards at tiny shapes: each runs and returns well-formed ids."""
    from alayalite_tpu_torch import Index, IndexParams

    n, dim, nq = 64 * 8, 32, 8 * 8
    rng = np.random.default_rng(0)
    data = rng.normal(size=(n, dim)).astype(np.float32)
    q = torch.as_tensor(data[:nq] + 0.01)
    mesh = tsh.make_mesh(8)
    if stage == "flat":
        sp = tsh.shard_space_by_rows(mesh, RawSpace.create(n, dim).fit(data))
        _, i = tsh.db_sharded_flat_search(mesh, sp, q, 5)
        assert (i[:, 0].numpy() == np.arange(nq)).all()
    elif stage == "beam":
        from alayalite_tpu_torch.index.knn import exact_knn

        sp = RawSpace.create(n, dim).fit(data)
        _, nb = exact_knn(sp.data, 8)
        seeds = torch.arange(0, n, 8, dtype=torch.int32)[None].expand(nq, -1)
        _, i = tsh.dp_sharded_beam_search(mesh, sp, nb, seeds, q, k=5, ef=16,
                                          valid=sp.valid)
        assert i.shape == (nq, 5)
    elif stage == "dbgraph":
        idx = from_jax_sharded_leaves("graph", _graph_leaves(data, 4, 8),
                                      tsh.make_mesh(8))
        assert idx.batch_search(q.numpy(), 5, ef_search=16).shape == (nq, 5)
    elif stage == "dbblock":
        idx = tsh.ShardedBlockIndex(mesh=mesh, max_nbrs=8, ef_construction=32)
        idx.fit(data)
        assert idx.batch_search(q.numpy(), 5, ef_search=16).shape == (nq, 5)
    elif stage == "sdkshard":
        idx = Index("dry", IndexParams(index_type="hnsw", capacity=n + 64,
                                       max_nbrs=8, ef_construction=32,
                                       quantization_type="bsq8", db_shards=4),
                    device="cpu")
        idx.fit(data)
        assert idx._engine._mesh() is not None
        assert idx.batch_search(q.numpy(), 5, ef_search=16).shape == (nq, 5)
        new = idx.insert(data[:4])
        idx.remove(np.atleast_1d(new)[:1])
    elif stage == "nnd":
        from alayalite_tpu_torch.parallel.build_sharded import (
            ShardedGraphBuilder, make_build_mesh)

        b = ShardedGraphBuilder(make_build_mesh(8), r=8, knn_k=8, rounds=1,
                                chunk=64)
        nb, ep = b.build(data, n)
        assert nb.shape == (n, 8) and 0 <= ep < n and len(b.changed) == 1
    elif stage == "shardedbuild":
        idx = Index("b", IndexParams(index_type="hnsw", capacity=n,
                                     max_nbrs=8, ef_construction=32,
                                     build_shards=8), device="cpu")
        idx.fit(data)
        assert idx.batch_search(q.numpy(), 5, ef_search=32).shape == (nq, 5)
    else:
        idx = Index("d", IndexParams(index_type="hnsw", capacity=n,
                                     max_nbrs=8, ef_construction=32,
                                     serve_shards=8), device="cpu")
        idx.fit(data)
        got = idx.batch_search(q.numpy(), 5, ef_search=32)
        assert np.mean(got[:, 0] == np.arange(nq)) >= 0.9
