"""flat + sq4 against the JAX package (n = 1200, dim 16, 32 queries,
k = 10): fit, the exact scan of the raw rows, insert into both spaces,
tombstone remove, and save / load in both directions. The search scans
the raw rows in both packages, so the ids are JAX's and the distances
agree within rtol 1e-5 / atol (test_torch_flat.py's ``_atol``); the 4-bit
codes, fitted and inserted, are JAX's bit for bit."""

import numpy as np
import pytest

from alayalite_tpu import Index as JaxIndex
from alayalite_tpu import IndexParams as JaxParams
from alayalite_tpu_torch import Client, Index, IndexParams
from alayalite_tpu_torch.utils.datasets import random_dataset
from alayalite_tpu_torch.utils.evaluate import calc_recall

N, DIM, NQ, K = 1200, 16, 32, 10


def _atol(ds):
    top = (ds.queries ** 2).sum(1).max() + (ds.data ** 2).sum(1).max()
    return max(1e-4, 4 * float(np.spacing(np.float32(top))))


def _codes(idx):
    return np.asarray(idx._engine.search_space.codes)


def _pair(ds, metric):
    kw = dict(index_type="flat", quantization_type="sq4", capacity=N + 16,
              metric=metric)
    j = JaxIndex("j", JaxParams(**kw))
    p = Index("p", IndexParams(**kw), device="cpu")
    j.fit(ds.data)
    p.fit(ds.data)
    return j, p


@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_fit_search_insert_remove_match_jax(metric):
    ds = random_dataset(n=N, dim=DIM, n_queries=NQ, seed=23, topk=K,
                        metric=metric, device="cpu")
    j, p = _pair(ds, metric)
    assert p._engine.search_space is not p._engine.space
    assert p._engine.search_space.bits == 4
    np.testing.assert_array_equal(_codes(p), _codes(j))
    ids, dist = p.batch_search_with_distance(ds.queries, K)
    jids, jdist = j.batch_search_with_distance(ds.queries, K)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(dist, jdist, rtol=1e-5, atol=_atol(ds))
    assert calc_recall(ids, ds.gt) == 1.0

    new = (np.random.default_rng(9).normal(size=(16, DIM)) * 4.0
           ).astype(np.float32)
    pids = p.insert(new)
    np.testing.assert_array_equal(pids, j.insert(new))
    np.testing.assert_array_equal(pids, np.arange(N, N + 16))
    np.testing.assert_array_equal(_codes(p), _codes(j))
    assert (p.batch_search(new, 1)[:, 0] == pids).all()

    dead = np.concatenate([np.arange(0, N, 7), pids[:4]])
    p.remove(dead)
    j.remove(dead)
    ids = p.batch_search(ds.queries, K)
    assert not np.isin(ids, dead).any()
    np.testing.assert_array_equal(ids, j.batch_search(ds.queries, K))
    with pytest.raises(RuntimeError, match="full"):
        p.insert(new[0])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_round_trip(tmp_path, direction):
    ds = random_dataset(n=N, dim=DIM, n_queries=NQ, seed=23)
    j, p = _pair(ds, "l2")
    new = ds.queries[:8] + 0.5
    j.insert(new)
    p.insert(new)
    j.remove([3, 5, N + 1])
    p.remove([3, 5, N + 1])
    src, load = ((j, lambda: Index.load(str(tmp_path), "x", device="cpu"))
                 if direction == "jax_to_port" else
                 (p, lambda: JaxIndex.load(str(tmp_path), "x")))
    src.save(str(tmp_path / "x"))
    assert (tmp_path / "x" / "sq4.data.npz").exists()
    back = load()
    a = src.batch_search_with_distance(ds.queries, K)
    b = back.batch_search_with_distance(ds.queries, K)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(a[1], b[1], rtol=1e-5, atol=_atol(ds))
    np.testing.assert_array_equal(_codes(src), _codes(back))
    assert not np.isin(a[0], [3, 5, N + 1]).any()


def test_client_creates_flat_sq4():
    ds = random_dataset(n=N, dim=DIM, n_queries=NQ, seed=23, topk=K,
                        device="cpu")
    c = Client(device="cpu")
    idx = c.create_index("q4", index_type="flat", quantization_type="sq4",
                         capacity=N)
    idx.fit(ds.data)
    assert c.get_index("q4") is idx
    assert calc_recall(idx.batch_search(ds.queries, K), ds.gt) == 1.0
