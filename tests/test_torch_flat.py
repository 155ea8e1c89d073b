"""The flat index (exact and fast scans, tombstones, insert, sq8 codes and
the directory format) against the JAX package at test_index_types.py's
sizes: n = 1200, dim 16, 32 queries, k = 10.

Exact mode: ids equal JAX's, distances within rtol 1e-5 / atol 1e-4 (the
f32 sums run in another order), recall@10 1.0. For l2 the atol is at
least 4 ulp of max |q|² + max |x|² (``_atol``): |q|² + |x|² − 2 q·x cancels
sums near 1000 here, where one f32 ulp is 1.2e-4. Fast mode: the port's
coarse selection is exact where JAX's is ``approx_max_k``, so recall is
held against the exact ids (≥ 0.99) and against JAX's (within 0.01)."""

import numpy as np
import pytest
import torch

from alayalite_tpu import Index as JaxIndex
from alayalite_tpu import IndexParams as JaxParams
from alayalite_tpu_torch import Index, IndexParams
from alayalite_tpu_torch.ops.l2_tile import l2_tile
from alayalite_tpu_torch.spaces.raw import RawSpace
from alayalite_tpu_torch.utils.datasets import random_dataset
from alayalite_tpu_torch.utils.evaluate import calc_recall

N, DIM, NQ, K = 1200, 16, 32, 10
METRICS = ["l2", "ip", "cos"]


@pytest.fixture(scope="module", params=METRICS)
def ds(request):
    d = random_dataset(n=N, dim=DIM, n_queries=NQ, seed=21, topk=K,
                       metric=request.param, device="cpu")
    d.metric = request.param
    return d


def _atol(ds, metric="l2"):
    if metric != "l2":
        return 1e-4
    top = (ds.queries ** 2).sum(1).max() + (ds.data ** 2).sum(1).max()
    return max(1e-4, 4 * float(np.spacing(np.float32(top))))


def _pair(ds, capacity=N, **kw):
    """The same flat index fitted in both packages."""
    kw = dict(index_type="flat", capacity=capacity,
              metric=getattr(ds, "metric", "l2"), **kw)
    j = JaxIndex("j", JaxParams(**kw))
    p = Index("p", IndexParams(**kw), device="cpu")
    j.fit(ds.data)
    p.fit(ds.data)
    return j, p


def test_exact_mode_matches_jax(ds):
    j, p = _pair(ds)
    calls = l2_tile.calls
    ids, dist = p.batch_search_with_distance(ds.queries, K)
    assert (l2_tile.calls > calls) == (ds.metric == "l2")
    jids, jdist = j.batch_search_with_distance(ds.queries, K)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(dist, jdist, rtol=1e-5,
                               atol=_atol(ds, ds.metric))
    assert calc_recall(ids, ds.gt) == 1.0


def test_fast_mode_recall(ds):
    j, p = _pair(ds, flat_mode="fast")
    ids = p.batch_search(ds.queries, K)
    rec, jrec = calc_recall(ids, ds.gt), calc_recall(
        j.batch_search(ds.queries, K), ds.gt)
    assert rec >= 0.99 and abs(rec - jrec) <= 0.01, (rec, jrec)


def test_tombstones_match_jax(ds):
    j, p = _pair(ds)
    dead = np.arange(0, N, 3)
    j.remove(dead)
    p.remove(dead)
    ids = p.batch_search(ds.queries, K)
    assert not np.isin(ids, dead).any()
    np.testing.assert_array_equal(ids, j.batch_search(ds.queries, K))
    with pytest.raises(ValueError, match="out of range"):
        p.remove(N + 5)


def test_insert_matches_jax_and_fills_up():
    ds = random_dataset(n=N, dim=DIM, n_queries=NQ, seed=21)
    j, p = _pair(ds, capacity=N + 16)
    new = (np.random.default_rng(9).normal(size=(16, DIM)) * 4.0
           ).astype(np.float32)
    pids = p.insert(new)
    np.testing.assert_array_equal(pids, j.insert(new))
    np.testing.assert_array_equal(pids, np.arange(N, N + 16))
    assert (p.batch_search(new, 1)[:, 0] == pids).all()
    assert p.get_data_by_id(N + 3).tolist() == new[3].tolist()
    with pytest.raises(RuntimeError, match="full"):
        p.insert(new[0])
    with pytest.raises(RuntimeError, match="full"):
        j.insert(new[0])


@pytest.mark.parametrize("live", [0.8, 0.004])
def test_exact_topk_merges_per_tile_results(monkeypatch, live):
    """Across many 128-row tiles, with tombstones and (at 0.4% live) fewer
    valid rows than k: the same ids as JAX's ``exact_topk``, and no sort
    wider than the [Q, 2k] merge."""
    from alayalite_tpu.ops.distance import exact_topk as jax_exact_topk
    from alayalite_tpu_torch.ops.distance import exact_topk

    rng = np.random.default_rng(12)
    q = rng.normal(size=(40, 8)).astype(np.float32)
    x = rng.normal(size=(1000, 8)).astype(np.float32)
    valid = rng.random(1000) < live
    widths = []
    sort = torch.sort

    def recording_sort(t, *a, **kw):
        widths.append(t.shape[-1])
        return sort(t, *a, **kw)

    monkeypatch.setattr(torch, "sort", recording_sort)
    d, i = exact_topk(torch.from_numpy(q), torch.from_numpy(x), K,
                      valid=torch.from_numpy(valid), tile_n=128)
    jd, ji = jax_exact_topk(q, x, K, valid=valid, tile_n=128)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(d.numpy(), jd, rtol=1e-5, atol=1e-4)
    assert max(widths) <= 2 * K
    assert ((i.numpy() < 0) == ~np.isfinite(d.numpy())).all()


def test_raw_space_insert_past_capacity_keeps_rows():
    sp = RawSpace.create(4, 3).fit(torch.ones((3, 3)))
    ids = sp.insert(torch.full((2, 3), 2.0))
    assert ids.tolist() == [3, -1] and sp.num == 4
    before = sp.data.clone()
    assert sp.insert(torch.zeros(3)).tolist() == [-1]
    assert torch.equal(sp.data, before) and sp.valid.all()
    sp.remove(torch.tensor([1, -1, 9]))
    assert sp.valid.tolist() == [True, False, True, False]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_sq8_round_trip(tmp_path, direction):
    ds = random_dataset(n=N, dim=DIM, n_queries=NQ, seed=21)
    j, p = _pair(ds, quantization_type="sq8")
    src, load = ((j, lambda: Index.load(str(tmp_path), "x", device="cpu"))
                 if direction == "jax_to_port" else
                 (p, lambda: JaxIndex.load(str(tmp_path), "x")))
    src.save(str(tmp_path / "x"))
    back = load()
    a = src.batch_search_with_distance(ds.queries, K)
    b = back.batch_search_with_distance(ds.queries, K)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(a[1], b[1], rtol=1e-5, atol=_atol(ds))
    codes = [np.asarray(ix._engine.search_space.codes) for ix in (src, back)]
    np.testing.assert_array_equal(*codes)


def test_client_creates_flat_indices():
    from alayalite_tpu_torch import Client

    ds = random_dataset(n=N, dim=DIM, n_queries=NQ, seed=21, topk=K,
                        device="cpu")
    c = Client(device="cpu")
    for name, quant in (("f", "none"), ("q", "sq8")):
        idx = c.create_index(name, index_type="flat", quantization_type=quant,
                             capacity=N)
        idx.fit(ds.data)
        assert c.get_index(name) is idx
        assert calc_recall(idx.batch_search(ds.queries, K), ds.gt) == 1.0
        assert (idx._engine.search_space is idx._engine.space) == (
            quant == "none")


def test_single_search_and_get_data():
    ds = random_dataset(n=N, dim=DIM, n_queries=NQ, seed=21)
    p = Index("t", IndexParams(index_type="flat", capacity=N), device="cpu")
    p.fit(ds.data)
    ids = p.search(ds.queries[0], 5, ef_search=10)
    assert ids.shape == (5,)
    v = p.get_data_by_id(int(ids[0]))
    np.testing.assert_allclose(v, ds.data[int(ids[0])], rtol=1e-6)
    i1, d1 = p.search_with_distance(ds.queries[0], 5, ef_search=10)
    np.testing.assert_array_equal(i1, ids)
    assert (np.diff(d1) >= 0).all()
