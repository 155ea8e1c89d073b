"""Serving and the service on the card: a query's answer does not depend
on the batch it rides in (``ops.distance.row_dots``), so threads searching
one fitted index at once and SearchServer's coalesced batches return one
direct call's rows exactly; the REST service on its default device (cuda).
No JAX import, so the file runs where JAX is absent: ``python -m pytest
--noconftest -m gpu tests/test_torch_serving_card.py``."""

import threading

import numpy as np
import pytest
import torch

from alayalite_tpu_torch import Index, IndexParams
from alayalite_tpu_torch.utils.datasets import random_dataset
from alayalite_tpu_torch.utils.evaluate import calc_gt, calc_recall


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.fixture(scope="module")
def fitted():
    _need_card()
    ds = random_dataset(n=20_000, dim=64, n_queries=1024, seed=5)
    idx = Index("b", IndexParams(quantization_type="bsq8", capacity=20_000,
                                 max_nbrs=16))
    idx.fit(ds.data)
    return ds, idx, calc_gt(ds.data, ds.queries, 10)


@pytest.mark.gpu
def test_cuda_row_dots_do_not_depend_on_the_batch():
    _need_card()
    from alayalite_tpu_torch.spaces.raw import RawSpace

    rng = np.random.default_rng(3)
    sp = RawSpace.create(5000, 128, device=torch.device("cuda")).fit(
        torch.as_tensor(rng.normal(size=(5000, 128)).astype(np.float32),
                        device="cuda"))
    q = torch.as_tensor(rng.normal(size=(4096, 128)).astype(np.float32),
                        device="cuda")
    ids = torch.as_tensor(rng.integers(0, 5000, size=(4096, 256)),
                          device="cuda")
    full = sp.gather_dists(q, ids)
    for rows in (512, 54, 1):
        parts = torch.cat([sp.gather_dists(q[lo:lo + rows], ids[lo:lo + rows])
                           for lo in range(0, 4096, rows)])
        assert torch.equal(parts, full), rows
    want = torch.bmm(sp.data[ids.reshape(-1)].view(4096, 256, 128),
                     q.unsqueeze(2)).squeeze(2)
    q_sq = (q * q).sum(-1, keepdim=True)
    torch.testing.assert_close(
        full, torch.clamp(q_sq + sp.sq_norms[ids] - 2.0 * want, min=0.0),
        rtol=1e-5, atol=1e-3)


@pytest.mark.gpu
def test_cuda_concurrent_searches_match_serial(fitted):
    ds, idx, _ = fitted
    parts = [ds.queries[t * 128:(t + 1) * 128] for t in range(8)]
    want = np.split(idx.batch_search(ds.queries[:1024], 10, ef_search=64), 8)
    idx._engine._sscan = None
    got = [None] * 8
    barrier = threading.Barrier(8)

    def worker(t):
        barrier.wait()
        got[t] = idx.batch_search(parts[t], 10, ef_search=64)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_cuda_search_server(fitted):
    from alayalite_tpu_torch.ops.gather_diagdot import gather_estimate
    from alayalite_tpu_torch.serving import SearchServer

    ds, idx, gt = fitted
    direct = idx.batch_search(ds.queries, 10, ef_search=64)
    server = SearchServer(idx, topk=10, ef=64, max_batch=128)
    launches = gather_estimate.launches
    try:
        futs = [server.submit(q) for q in ds.queries]
        ids = np.stack([f.result(timeout=300)[0] for f in futs])
    finally:
        server.close()
    assert gather_estimate.launches > launches
    np.testing.assert_array_equal(ids, direct)
    assert calc_recall(ids, gt) >= 0.95
    assert server.queries == ds.queries.shape[0]


@pytest.mark.gpu
def test_cuda_service_default_device(tmp_path):
    _need_card()
    from alayalite_tpu_torch.service.app import create_app

    app = create_app(str(tmp_path))
    assert app.client.device.type == "cuda"
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(500, 32)).astype(np.float32)
    assert app.handle("POST", "/api/v1/collection/create",
                      {"collection_name": "c"})[0] == 200
    items = [[i, f"doc {i}", emb[i].tolist(), {}] for i in range(500)]
    assert app.handle("POST", "/api/v1/collection/insert",
                      {"collection_name": "c", "items": items})[0] == 200
    s, res = app.handle("POST", "/api/v1/collection/query", {
        "collection_name": "c", "query_vector": emb[:20].tolist(),
        "limit": 1, "ef_search": 32})
    assert s == 200 and [r[0] for r in res["id"]] == list(range(20))
