"""A raw hnsw index mutated by one package (fit, insert, remove,
compact) loads in the other, which searches it and goes on mutating it;
the port's own save returns the same ids. Beside
``tests/test_torch_raw_update.py``, in a file of its own so that the JAX
package's compiles run on another test worker."""

import numpy as np
import pytest
import torch

from alayalite_tpu import Index as JaxIndex
from alayalite_tpu import IndexParams as JaxParams
from alayalite_tpu_torch import Index, IndexParams
from alayalite_tpu_torch.utils.datasets import random_dataset
from alayalite_tpu_torch.utils.evaluate import calc_gt, calc_recall

torch.set_num_threads(2)

DIM = 16


@pytest.fixture(scope="module")
def mutated_pair(tmp_path_factory):
    """One raw hnsw index mutated by each package (fit, insert, remove,
    compact), saved."""
    root = tmp_path_factory.mktemp("raw_mut")
    ds = random_dataset(n=900, dim=DIM, n_queries=32, seed=12)
    rng = np.random.default_rng(2)
    new = (ds.data[rng.integers(0, 900, size=100)]
           + 0.05 * rng.normal(size=(100, DIM))).astype(np.float32)
    dead = np.arange(0, 900, 7, dtype=np.int32)
    kw = dict(index_type="hnsw", capacity=1100, max_nbrs=16,
              ef_construction=64, compaction_threshold=0.0)
    out = {"ds": ds, "new": new, "dead": dead, "root": root}
    for name, idx in (("jax", JaxIndex("jax", JaxParams(**kw))),
                      ("port", Index("port", IndexParams(**kw),
                                     device="cpu"))):
        idx.fit(ds.data)
        ids = np.asarray(idx.insert(new))
        assert (ids == np.arange(900, 1000)).all()
        idx.remove(dead)
        idx._engine.compact()
        idx.save(str(root / name))
        out[name] = idx
    out["gt"] = calc_gt(np.concatenate([ds.data, new]), ds.queries, 10,
                        deleted=dead, device="cpu")
    return out


def test_mutated_raw_index_loads_both_ways(mutated_pair):
    """Either package loads the other's mutated raw index and answers with
    recall within 0.01 of the saving package; no removed id comes back."""
    m = mutated_pair
    ds, gt, dead = m["ds"], m["gt"], m["dead"]

    def recall(ix):
        ids = np.asarray(ix.batch_search(ds.queries, 10, ef_search=64))
        assert not np.isin(ids, dead).any()
        return calc_recall(ids, gt)

    jax_in_port = Index.load(str(m["root"]), "jax", device="cpu")
    port_in_jax = JaxIndex.load(str(m["root"]), "port")
    assert len(jax_in_port._engine.graph.overlay) == len(
        m["jax"]._engine.graph.overlay)
    assert abs(recall(jax_in_port) - recall(m["jax"])) <= 0.01
    assert abs(recall(port_in_jax) - recall(m["port"])) <= 0.01
    assert recall(m["port"]) >= 0.8 and recall(m["jax"]) >= 0.8
    # the port goes on mutating what JAX saved, and JAX what the port saved
    more = np.asarray(jax_in_port.insert(m["new"][:8] + 0.01))
    assert (more == np.arange(1000, 1008)).all()
    more = np.asarray(port_in_jax.insert(m["new"][:8] + 0.01))
    assert (more == np.arange(1000, 1008)).all()


def test_saved_port_index_returns_same_ids(mutated_pair):
    m = mutated_pair
    again = Index.load(str(m["root"]), "port", device="cpu")
    q = m["ds"].queries
    np.testing.assert_array_equal(
        again.batch_search(q, 10, ef_search=64),
        m["port"].batch_search(q, 10, ef_search=64))
    for a, b in zip(again._engine.graph.overlay,
                    m["port"]._engine.graph.overlay):
        assert torch.equal(a.ids, b.ids) and torch.equal(a.nbrs, b.nbrs)
