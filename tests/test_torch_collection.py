"""The port's Collection against the JAX package's: the cases of
``tests/test_collection.py``; collection directories saved by either
package loaded by the other (the same documents, metadata and maps, and
recall within 0.02 of the saving package on the same index files); and an
upsert and a delete_by_filter on 2,000 rows leaving JAX's table, row for
row."""

import numpy as np
import pytest
import torch

from alayalite_tpu import Collection as JaxCollection
from alayalite_tpu import IndexParams as JaxParams
from alayalite_tpu_torch import Collection, IndexParams
from alayalite_tpu_torch.utils.datasets import random_dataset
from alayalite_tpu_torch.utils.evaluate import calc_gt

torch.set_num_threads(2)


def _items(n, dim=8, seed=0, prefix="id"):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, dim)).astype(np.float32)
    return [(f"{prefix}{i}", f"document {i}", emb[i], {"even": i % 2 == 0})
            for i in range(n)], emb


def _flat(capacity):
    return Collection("c", IndexParams(index_type="flat", capacity=capacity),
                      device="cpu")


def test_insert_and_batch_query():
    col = _flat(256)
    items, emb = _items(64)
    col.insert(items)
    res = col.batch_query(emb[:4], 3, ef_search=10)
    assert res["id"][0][0] == "id0"
    assert res["document"][1][0] == "document 1"
    assert len(res["distance"][0]) == 3
    assert res["distance"][0][0] == pytest.approx(0.0, abs=1e-4)


def test_duplicate_insert_rejected():
    col = _flat(64)
    items, _ = _items(8)
    col.insert(items)
    with pytest.raises(ValueError, match="already exist"):
        col.insert(items[:1])


def test_filter_query_and_get_by_id():
    col = _flat(64)
    items, _ = _items(10)
    col.insert(items)
    res = col.filter_query({"even": True})
    assert len(res["id"]) == 5
    res2 = col.filter_query({"even": True}, limit=2)
    assert res2["id"] == ["id0", "id2"]
    got = col.get_by_id(["id4", "id3", "missing"])
    assert got["id"] == ["id3", "id4"]       # table order, as pandas gives


def test_upsert_replaces():
    col = _flat(64)
    items, emb = _items(8)
    col.insert(items)
    newvec = np.full(8, 9.0, dtype=np.float32)
    col.upsert([("id0", "updated doc", newvec, {"even": False})])
    res = col.batch_query(newvec[None, :], 1, ef_search=10)
    assert res["id"][0][0] == "id0"
    assert res["document"][0][0] == "updated doc"


def test_delete_by_id_and_filter():
    col = _flat(64)
    items, emb = _items(10)
    col.insert(items)
    col.delete_by_id(["id0"])
    res = col.batch_query(emb[:1], 1, ef_search=10)
    assert res["id"][0][0] != "id0"
    col.delete_by_filter({"even": True})
    assert len(col.filter_query({"even": True})["id"]) == 0


def test_reindex():
    col = _flat(64)
    items, emb = _items(16)
    col.insert(items)
    col.delete_by_id([f"id{i}" for i in range(8)])
    col.reindex()
    res = col.batch_query(emb[8:10], 1, ef_search=10)
    assert res["id"][0][0] == "id8"
    assert res["id"][1][0] == "id9"
    assert col._outer_inner == {f"id{i}": i - 8 for i in range(8, 16)}


def test_set_metric_guard():
    col = Collection("c", device="cpu")
    col.set_metric("cos")
    items, _ = _items(4)
    col.insert(items)
    with pytest.raises(RuntimeError):
        col.set_metric("l2")


def test_join_results_alignment_with_missing_ids():
    """Distances stay paired with their documents when an internal id is
    missing from the map mid-list; a row with no known id gives []."""
    col = _flat(64)
    emb = np.eye(4, 8, dtype=np.float32)
    col.insert([(f"u{i}", f"doc {i}", emb[i], {}) for i in range(4)])
    ids = np.array([[0, 7, 2], [9, 8, 7]], dtype=np.int32)
    dists = np.array([[0.0, 0.5, 2.0], [1.0, 1.0, 1.0]], dtype=np.float32)
    res = col._join_results(ids, dists)
    assert res["id"] == [["u0", "u2"], []]
    assert res["distance"] == [[0.0, 2.0], []]
    assert res["document"] == [["doc 0", "doc 2"], []]


def _table(col):
    """The collection's rows as lists, for either package."""
    if isinstance(col, JaxCollection):
        return {c: col._df[c].tolist() for c in ("id", "document",
                                                  "metadata")}
    return {c: list(v) for c, v in col._cols.items()}


def test_upsert_and_delete_by_filter_match_jax_row_for_row():
    """2,000 rows, then an upsert of 300 existing ids and 100 new ones and a
    delete_by_filter: the same table, row for row, and the same maps."""
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(2400, 16)).astype(np.float32)
    items = [(f"d{i}", f"text {i}", emb[i], {"shard": i % 7})
             for i in range(2000)]
    moved = rng.choice(2000, size=300, replace=False)
    ups = ([(f"d{i}", f"moved {i}", emb[2000 + k], {"shard": 99})
            for k, i in enumerate(moved)]
           + [(f"n{i}", f"new {i}", emb[2300 + i], {"shard": i % 7})
              for i in range(100)])
    cols = (JaxCollection("c", JaxParams(index_type="flat", capacity=2500)),
            Collection("c", IndexParams(index_type="flat", capacity=2500),
                       device="cpu"))
    for col in cols:
        col.insert(items)
        col.upsert(ups)
        col.delete_by_filter({"shard": 3})
    jax_t, port_t = _table(cols[0]), _table(cols[1])
    assert port_t == jax_t
    assert len(port_t["id"]) < 2100 and "d3" not in port_t["id"]
    assert cols[1]._outer_inner == cols[0]._outer_inner
    assert cols[1]._inner_outer == cols[0]._inner_outer
    assert cols[1].filter_query({"shard": 99}) == cols[0].filter_query(
        {"shard": 99})
    pick = [f"d{i}" for i in moved[:20]] + ["n5", "d3"]
    assert cols[1].get_by_id(pick) == cols[0].get_by_id(pick)


@pytest.fixture(scope="module")
def saved_pair(tmp_path_factory):
    """A default (raw hnsw) collection built by each package (insert, an
    upsert, a delete) and saved under one root."""
    root = tmp_path_factory.mktemp("cols")
    ds = random_dataset(n=1000, dim=16, n_queries=64, seed=21)
    rng = np.random.default_rng(3)
    items = [(f"u{i}", f"doc {i}", ds.data[i], {"g": i % 5})
             for i in range(900)]
    ups = [(f"u{i}", f"doc {i}", ds.data[i], {"g": i % 5})
           for i in range(900, 1000)]
    dead = [f"u{i}" for i in rng.choice(900, size=40, replace=False)]
    kw = dict(index_type="hnsw", capacity=1100, max_nbrs=16,
              ef_construction=64)
    out = {"root": root, "ds": ds, "dead": set(dead)}
    for name, col in (("jax", JaxCollection("jax", JaxParams(**kw))),
                      ("port", Collection("port", IndexParams(**kw),
                                          device="cpu"))):
        col.insert(items)
        col.upsert(ups)
        col.delete_by_id(dead)
        col.save(str(root / name))
        out[name] = col
    live = np.array([i for i in range(1000) if f"u{i}" not in out["dead"]])
    out["gt"] = [[f"u{live[j]}" for j in row]
                 for row in calc_gt(ds.data[live], ds.queries, 10,
                                    device="cpu")]
    return out


def _recall(col, ds, gt):
    res = col.batch_query(ds.queries, 10, ef_search=64)
    return float(np.mean([len(set(r) & set(g)) / 10.0
                          for r, g in zip(res["id"], gt)])), res


def test_collections_load_both_ways(saved_pair):
    """Either package loads the other's collection directory: the same
    rows and maps, no deleted id returned, recall@10 within 0.02 of the
    saving package's."""
    m = saved_pair
    ds, gt = m["ds"], m["gt"]
    jax_in_port = Collection.load(str(m["root"]), "jax", device="cpu")
    port_in_jax = JaxCollection.load(str(m["root"]), "port")
    for loaded, saver in ((jax_in_port, m["jax"]), (port_in_jax, m["port"])):
        assert _table(loaded) == _table(saver)
        assert loaded._outer_inner == saver._outer_inner
        assert loaded._inner_outer == saver._inner_outer
        r_loaded, res = _recall(loaded, ds, gt)
        r_saver, _ = _recall(saver, ds, gt)
        assert abs(r_loaded - r_saver) <= 0.02, (r_loaded, r_saver)
        assert r_loaded >= 0.85
        assert not any(i in m["dead"] for row in res["id"] for i in row)
        for row_i, row_d in zip(res["id"], res["document"]):
            assert row_d == [f"doc {u[1:]}" for u in row_i]
    assert jax_in_port.get_index_params().to_json() == \
        m["jax"].get_index_params().to_json()


def test_loaded_collection_goes_on_mutating(saved_pair):
    """The port inserts into and reindexes the collection JAX saved."""
    m = saved_pair
    col = Collection.load(str(m["root"]), "jax", device="cpu")
    v = np.full(16, 7.0, dtype=np.float32)
    col.insert([("extra", "extra doc", v, {"g": 0})])
    assert col.batch_query(v, 1, ef_search=32)["id"] == [["extra"]]
    col.reindex()
    assert col.batch_query(v, 1, ef_search=32)["id"] == [["extra"]]
    assert sorted(col._inner_outer) == list(range(len(col._cols["id"])))
    recall, _ = _recall(col, m["ds"], m["gt"])
    assert recall >= 0.85
