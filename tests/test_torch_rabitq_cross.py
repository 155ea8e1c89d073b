"""JAX-built rabitq and rabitq2 indices loaded and searched by the port,
then mutated by the port and read back by the JAX package. Beside
``tests/test_torch_rabitq.py``, in a file of its own so that the JAX
package's fit runs on another test worker."""

import numpy as np
import pytest
import torch

from alayalite_tpu import Index as JaxIndex
from alayalite_tpu import IndexParams as JaxParams
from alayalite_tpu.spaces.rabitq import RaBitQSpace as JaxRaBitQ
from alayalite_tpu_torch import Index
from alayalite_tpu_torch.spaces.rabitq import RaBitQSpace
from alayalite_tpu_torch.utils.datasets import random_dataset
from alayalite_tpu_torch.utils.evaluate import calc_gt, calc_recall

torch.set_num_threads(2)

N, DIM, CAP = 3000, 32, 3100


@pytest.fixture(scope="module")
def jax_pair(tmp_path_factory):
    """A JAX-built 1-bit rabitq index over 3,000 x 32 rows, and the 2-bit
    index over the same graph: JAX's RaBitQSpace(bits=2) quantizing the
    fitted adjacency, as the JAX fit of rabitq2 does after the same graph
    build (the build does not depend on the bit width). Both saved."""
    root = tmp_path_factory.mktemp("rq")
    ds = random_dataset(n=N, dim=DIM, n_queries=200, seed=9)
    kw = dict(index_type="hnsw", capacity=CAP, ef_construction=64)
    j1 = JaxIndex("rq1", JaxParams(quantization_type="rabitq", **kw))
    j1.fit(ds.data)
    j1.save(str(root / "rq1"))
    j2 = JaxIndex("rq2", JaxParams(quantization_type="rabitq2", **kw))
    e1, e2 = j1._engine, j2._engine
    e2.space, e2.graph = e1.space, e1.graph
    e2.search_space = JaxRaBitQ.create(
        CAP, DIM, bits=2, rot=np.asarray(e1.search_space.rot)).fit(
        ds.data).update_neighbors(np.asarray(e1.graph.nbrs)[:N])
    e2._fitted, j2._dim = True, DIM
    j2.save(str(root / "rq2"))
    gt = calc_gt(ds.data, ds.queries, 10, device="cpu")
    return {"root": root, "ds": ds, "gt": gt, "rq1": j1, "rq2": j2}


@pytest.mark.parametrize("name,efs", [("rq1", (10, 16)), ("rq2", (16, 32))])
def test_jax_index_searched_by_port(jax_pair, name, efs):
    """The port loads the JAX-built index (the rotation, ids, bits, factors
    and codes) and reads recall@10 within 0.02 of JAX's."""
    m = jax_pair
    port = Index.load(str(m["root"]), name, device="cpu")
    sp = port._engine.search_space
    assert isinstance(sp, RaBitQSpace)
    assert sp.bits == (1 if name == "rq1" else 2)
    np.testing.assert_array_equal(
        sp.rot.numpy(), np.asarray(m[name]._engine.search_space.rot))
    for ef in efs:
        rj = calc_recall(np.asarray(m[name].batch_search(
            m["ds"].queries, 10, ef_search=ef)), m["gt"])
        rp = calc_recall(port.batch_search(m["ds"].queries, 10,
                                           ef_search=ef), m["gt"])
        assert abs(rp - rj) <= 0.02, (ef, rp, rj)
        assert rp >= 0.7


def test_port_mutates_jax_index_and_jax_loads_it(jax_pair, tmp_path):
    """The port inserts into and removes from the JAX-built 1-bit index,
    saves it, and the JAX package loads it and finds the new rows."""
    m = jax_pair
    port = Index.load(str(m["root"]), "rq1", device="cpu")
    rng = np.random.default_rng(1)
    new = (m["ds"].data[rng.integers(0, N, size=50)]
           + 0.05 * rng.normal(size=(50, DIM))).astype(np.float32)
    ids = port.insert(new)
    np.testing.assert_array_equal(ids, np.arange(N, N + 50))
    port.remove(np.arange(0, 200))
    port.save(str(tmp_path / "back"))
    back = JaxIndex.load(str(tmp_path), "back")
    got = np.asarray(back.batch_search(new, 1, ef_search=64))[:, 0]
    assert (got == ids).mean() >= 0.95
    res = np.asarray(back.batch_search(m["ds"].queries, 10, ef_search=32))
    assert not np.isin(res, np.arange(200)).any()
