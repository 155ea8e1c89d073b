"""The port's main path (hnsw + bsq8 fit and batch search) against the JAX
package at small size on the CPU.

One JAX fit (n = 2000, dim 32, max_nbrs 16, ef_construction 64, l2) is
shared by every test here; it dominates this file's run time. Random
streams differ between the packages (torch.Generator vs jax.random) and
the port picks seeds by exact top-k where JAX takes approx_max_k, so graphs
and ids differ: parity is judged by recall against the same ground truth.
"""

import numpy as np
import pytest
import torch

from alayalite_tpu import Index as JaxIndex
from alayalite_tpu import IndexParams as JaxParams
from alayalite_tpu_torch import Index, IndexParams
from alayalite_tpu_torch.convert import from_jax_arrays
from alayalite_tpu_torch.index.engine import IndexEngine
from alayalite_tpu_torch.ops.gather_diagdot import gather_estimate
from alayalite_tpu_torch.utils.datasets import random_dataset
from alayalite_tpu_torch.utils.evaluate import calc_gt, calc_recall

# the tensors here are small: more threads only contend with the other
# test workers' (the fits run twice as fast with two)
torch.set_num_threads(2)

N, DIM, NQ, K = 2000, 32, 64, 10
PARAMS = dict(index_type="hnsw", quantization_type="bsq8", capacity=N,
              max_nbrs=16, ef_construction=64, metric="l2")
EFS = (32, 64)


@pytest.fixture(scope="module")
def ds():
    d = random_dataset(n=N, dim=DIM, n_queries=NQ, seed=11)
    d.gt = calc_gt(d.data, d.queries, K, device="cpu")
    return d


@pytest.fixture(scope="module")
def jax_built(ds, tmp_path_factory):
    """JAX fit once; save it before and after tombstoning 10% of rows."""
    root = tmp_path_factory.mktemp("jax")
    idx = JaxIndex("j", JaxParams(**PARAMS))
    idx.fit(ds.data)
    idx.save(str(root / "j"))
    out = {"root": root}
    for ef in EFS:
        ids, dist = idx.batch_search_with_distance(ds.queries, K, ef_search=ef)
        out[ef] = (calc_recall(ids, ds.gt), ids, dist)
    dead = np.random.default_rng(0).choice(N, size=N // 10, replace=False)
    idx.remove(dead)
    out["dead"] = dead
    out["gt_dead"] = calc_gt(ds.data, ds.queries, K, deleted=dead,
                             device="cpu")
    out["arrays_dead"] = (idx.params.to_json(),
                          idx._engine.space.save_arrays(),
                          idx._engine.graph.save_arrays(),
                          idx._engine.search_space.save_arrays())
    out["rec_dead"] = {ef: calc_recall(idx.batch_search(ds.queries, K,
                                                        ef_search=ef),
                                       out["gt_dead"]) for ef in EFS}
    return out


@pytest.fixture(scope="module")
def port_built(ds, tmp_path_factory):
    idx = Index("p", IndexParams(**PARAMS), device="cpu")
    idx.fit(ds.data)
    root = tmp_path_factory.mktemp("port")
    idx.save(str(root / "p"))
    return idx, root


@pytest.mark.parametrize("ef", EFS)
def test_search_parity_on_jax_graph(ds, jax_built, ef):
    idx = Index.load(str(jax_built["root"]), "j", device="cpu")
    ids, dist = idx.batch_search_with_distance(ds.queries, K, ef_search=ef)
    jrec, jids, jdist = jax_built[ef]
    assert abs(calc_recall(ids, ds.gt) - jrec) <= 0.01
    # same ids → same exact distances; atol covers the f32 cancellation in
    # |q|² + |x|² − 2 q·x at |x|² ~ 500 summed in another order
    same = ids == jids
    assert same.mean() > 0.9
    np.testing.assert_allclose(dist[same], jdist[same], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("ef", EFS)
def test_search_parity_with_tombstones(ds, jax_built, ef):
    eng = from_jax_arrays(*jax_built["arrays_dead"], device="cpu")
    ids = eng.batch_search(ds.queries, K, ef=ef)
    assert not np.isin(ids, jax_built["dead"]).any()
    assert abs(calc_recall(ids, jax_built["gt_dead"])
               - jax_built["rec_dead"][ef]) <= 0.01


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


def test_build_parity(ds, jax_built, port_built):
    idx, _ = port_built
    rec = calc_recall(idx.batch_search(ds.queries, K, ef_search=64), ds.gt)
    assert rec >= jax_built[64][0] - 0.02
    eng = idx._engine
    nbrs = eng.graph.nbrs[:N].numpy()
    assert (nbrs >= 0).all() and nbrs.shape[1] == PARAMS["max_nbrs"]
    assert all(len(set(r)) == len(r) for r in nbrs)
    assert _reachable(nbrs, int(eng.graph.eps[0])).all()


def test_port_saved_index_loads_in_jax(ds, port_built):
    idx, root = port_built
    jidx = JaxIndex.load(str(root), "p")
    for ef in EFS:
        prec = calc_recall(idx.batch_search(ds.queries, K, ef_search=ef),
                           ds.gt)
        jrec = calc_recall(jidx.batch_search(ds.queries, K, ef_search=ef),
                           ds.gt)
        assert abs(prec - jrec) <= 0.01, (ef, prec, jrec)


def test_load_round_trip_is_exact(ds, port_built):
    idx, root = port_built
    again = IndexEngine.load(str(root / "p"), device="cpu")
    a = idx.batch_search_with_distance(ds.queries, K, ef_search=32)
    b = again.batch_search_with_distance(ds.queries, K, ef=32)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("metric", ["cos", "ip"])
def test_metrics(metric):
    d = random_dataset(n=1200, dim=16, n_queries=32, seed=5, topk=K,
                       metric=metric, device="cpu")
    idx = Index("m", IndexParams(quantization_type="bsq8", capacity=1200,
                                 max_nbrs=16, ef_construction=64,
                                 metric=metric), device="cpu")
    idx.fit(d.data)
    ids, dist = idx.batch_search_with_distance(d.queries, K, ef_search=80)
    assert calc_recall(ids, d.gt) >= 0.8
    if metric == "cos":
        assert (dist >= -1.0 - 1e-5).all() and (dist <= 1.0 + 1e-5).all()


def test_block_pools_run_the_kernel_path(ds, jax_built):
    """The pool mode the build takes from 250k rows up, forced at n = 2000
    on the 32-cluster data: its recall is held against the beam-pool build
    and against the JAX package's own build (beam pools at this n)."""
    from alayalite_tpu_torch.index.qg import QGBuilder
    from alayalite_tpu_torch.spaces.bqg import BQGSpace
    from alayalite_tpu_torch.spaces.raw import RawSpace

    data = torch.from_numpy(ds.data)
    rec = {}
    for mode in ("beam", "block"):
        raw = RawSpace.create(N, DIM).fit(data)
        bqg = BQGSpace.create(N, DIM, degree=16).fit(data)
        calls = gather_estimate.calls
        graph, bqg = QGBuilder(r=16, ef=128, pool_mode=mode).build_graph(
            raw, bqg, N)
        used = gather_estimate.calls - calls
        assert (used > 0) == (mode == "block"), (mode, used)
        eng = IndexEngine(IndexParams(**PARAMS), device="cpu")
        eng.space, eng.search_space, eng.graph = raw, bqg, graph
        eng._fitted = True
        rec[mode] = calc_recall(eng.batch_search(ds.queries, K, ef=32), ds.gt)
    assert rec["block"] >= rec["beam"] - 0.02, rec
    assert rec["block"] >= jax_built[32][0] - 0.02, (rec, jax_built[32][0])


def test_nndescent_cluster_init_branch():
    from alayalite_tpu_torch.index.knn import exact_knn
    from alayalite_tpu_torch.index.nndescent import build_knn_graph
    from alayalite_tpu_torch.spaces.raw import RawSpace

    d = random_dataset(n=6000, dim=32, n_queries=1, seed=4)
    raw = RawSpace.create(6000, 32).fit(torch.from_numpy(d.data))
    _, ids = build_knn_graph(raw, 6000, 16, cluster_init_min=1000)
    _, exact = exact_knn(raw.data, 16)
    hits = [len(set(a) & set(b)) for a, b in zip(ids.numpy(), exact.numpy())]
    assert np.mean(hits) / 16 >= 0.9
