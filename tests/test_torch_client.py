"""The port's Client against the JAX package's: the cases of
``tests/test_client.py``, and ``Client(url, device="cpu")`` discovering a
directory that holds one index and one collection saved by the JAX
package."""

import numpy as np
import pytest
import torch

from alayalite_tpu import Client as JaxClient
from alayalite_tpu_torch import Client, Collection, Index

torch.set_num_threads(2)


def _client(url=None):
    return Client(url=url, device="cpu")


def test_create_and_get():
    c = _client()
    idx = c.create_index("i1", index_type="flat", capacity=100)
    col = c.create_collection("c1")
    assert isinstance(idx, Index) and isinstance(col, Collection)
    assert c.get_index("i1") is idx
    assert c.get_collection("c1") is col
    assert c.list_indices() == ["i1"]
    assert c.list_collections() == ["c1"]
    assert idx.device.type == "cpu" and col.device.type == "cpu"


def test_name_conflicts():
    c = _client()
    c.create_index("x")
    with pytest.raises(RuntimeError, match="already exists"):
        c.create_index("x")
    with pytest.raises(RuntimeError, match="already exists"):
        c.create_collection("x")


def test_get_or_create():
    c = _client()
    a = c.get_or_create_index("i")
    assert c.get_or_create_index("i") is a
    b = c.get_or_create_collection("c")
    assert c.get_or_create_collection("c") is b


def test_delete_and_reset():
    c = _client()
    c.create_index("i")
    c.create_collection("c")
    c.delete_index("i")
    with pytest.raises(RuntimeError):
        c.delete_index("i")
    c.delete_collection("c")
    with pytest.raises(RuntimeError):
        c.delete_collection("missing")
    c.create_index("j")
    c.reset()
    assert c.list_indices() == []


def test_save_requires_url():
    c = _client()
    c.create_index("i")
    with pytest.raises(RuntimeError, match="url"):
        c.save_index("i")
    with pytest.raises(RuntimeError, match="url"):
        c.save_collection("i")


def test_client_with_url_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.normal(size=(200, 8)).astype(np.float32)
    c = _client(str(tmp_path))
    idx = c.create_index("idx", index_type="flat", capacity=256)
    idx.fit(data)
    c.save_index("idx")

    col = c.create_collection("col")
    items = [(f"u{i}", f"doc {i}", data[i], {"k": i % 2}) for i in range(50)]
    col.insert(items)
    c.save_collection("col")
    with pytest.raises(RuntimeError, match="does not exist"):
        c.save_index("nope")

    c2 = _client(str(tmp_path))
    assert sorted(c2.list_indices()) == ["idx"]
    assert sorted(c2.list_collections()) == ["col"]
    got = c2.get_index("idx").batch_search(data[:5], 1, ef_search=10)
    assert (got[:, 0] == np.arange(5)).all()
    res = c2.get_collection("col").batch_query(data[:2], 3, ef_search=10)
    assert res["id"][0][0] == "u0"
    c2.delete_index("idx", delete_on_disk=True)
    assert not (tmp_path / "idx").exists()
    c2.reset(delete_on_disk=True)
    assert not (tmp_path / "col").exists()


def test_url_discovers_jax_saved_index_and_collection(tmp_path):
    """A directory written by the JAX client (one raw hnsw index, one
    collection, one stray directory) is discovered by the port's client:
    the index answers with the JAX index's ids, the collection with its
    documents."""
    rng = np.random.default_rng(5)
    data = rng.normal(size=(400, 16)).astype(np.float32)
    jc = JaxClient(url=str(tmp_path))
    jidx = jc.create_index("vecs", index_type="hnsw", capacity=400,
                           max_nbrs=16, ef_construction=64)
    jidx.fit(data)
    jc.save_index("vecs")
    jcol = jc.create_collection("docs", index_type="flat", capacity=128)
    jcol.insert([(f"d{i}", f"text {i}", data[i], {"p": i % 3})
                 for i in range(100)])
    jc.save_collection("docs")
    (tmp_path / "stray").mkdir()

    c = _client(str(tmp_path))
    assert c.list_indices() == ["vecs"]
    assert c.list_collections() == ["docs"]
    want = np.asarray(jidx.batch_search(data[:16], 5, ef_search=64))
    got = c.get_index("vecs").batch_search(data[:16], 5, ef_search=64)
    assert (got[:, 0] == np.arange(16)).all()
    assert (got == want).mean() >= 0.95
    res = c.get_collection("docs").batch_query(data[:3], 2, ef_search=10)
    assert [r[0] for r in res["id"]] == ["d0", "d1", "d2"]
    assert res["document"][2][0] == "text 2"
    assert c.get_collection("docs").filter_query({"p": 1}) == \
        jcol.filter_query({"p": 1})
