"""SearchServer (``alayalite_tpu_torch/serving.py``): concurrent
micro-batched serving over the native queue, the cases of
tests/test_serving.py on the CPU; concurrent direct searches of one
fitted index; and the kernel build's lock under threads."""

import sys
import threading
import time

import numpy as np
import pytest

from alayalite_tpu_torch import Index, IndexParams
from alayalite_tpu_torch.native import BatchQueue, get_lib
from alayalite_tpu_torch.serving import SearchServer
from alayalite_tpu_torch.utils.datasets import random_dataset

needs_native = pytest.mark.skipif(get_lib() is None,
                                  reason="native toolchain unavailable")


def _flat(n, dim, seed, name="s"):
    ds = random_dataset(n=n, dim=dim, n_queries=0, seed=seed)
    idx = Index(name, IndexParams(index_type="flat", capacity=n),
                device="cpu")
    idx.fit(ds.data)
    return ds, idx


@needs_native
def test_concurrent_search_correct():
    ds, idx = _flat(500, 16, 2)
    server = SearchServer(idx, topk=1, ef=10, max_batch=16, timeout_us=5000)
    results = {}

    def worker(lo, hi):
        for i in range(lo, hi):
            ids, dists = server.search(ds.data[i])
            results[i] = int(ids[0])

    threads = [threading.Thread(target=worker, args=(t * 10, t * 10 + 10))
               for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    server.close()
    assert all(results[i] == i for i in range(40)), results
    assert server.queries == 40 and 1 <= server.batches <= 40


@needs_native
def test_unfitted_server_rejected():
    for target in (Index("u", IndexParams(index_type="flat", capacity=10),
                         device="cpu"),
                   Index("e", IndexParams(capacity=10), device="cpu")._engine):
        with pytest.raises(RuntimeError, match="fitted"):
            SearchServer(target)


@needs_native
def test_push_rejects_wrong_dimension():
    """BatchQueue.push copies dim*4 bytes: a shorter vector must raise,
    not read out of bounds."""
    q = BatchQueue(dim=16, capacity=32, max_batch=8, timeout_us=1000)
    try:
        with pytest.raises(ValueError, match="dimension"):
            q.push(0, np.ones(8, dtype=np.float32))
        with pytest.raises(ValueError, match="dimension"):
            q.push(0, np.ones((2, 16), dtype=np.float32))
        q.push(0, np.ones(16, dtype=np.float32))  # correct dim still works
    finally:
        q.close()


@needs_native
def test_error_propagates_to_all_waiters():
    """A batch whose search raises fails every future in the batch, and the
    server keeps serving; a topk above the server's width is an error."""
    ds, idx = _flat(100, 8, 5, "e")
    server = SearchServer(idx, topk=3, ef=10, max_batch=8, timeout_us=3000)
    orig = idx._engine.batch_search_with_distance
    try:
        calls = {"n": 0}

        def flaky(*a, **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected failure")
            return orig(*a, **kw)

        idx._engine.batch_search_with_distance = flaky
        fut = server.submit(ds.data[0])
        with pytest.raises(RuntimeError, match="injected"):
            fut.result(timeout=10)
        ids, _ = server.search(ds.data[1])
        assert int(ids[0]) == 1
        with pytest.raises(ValueError, match="batch width"):
            server.search(ds.data[1], topk=4)
        ids, d = server.search(ds.data[2], topk=2)
        assert ids.shape == (2,) and int(ids[0]) == 2
    finally:
        idx._engine.batch_search_with_distance = orig
        server.close()


@needs_native
def test_stress_concurrent_clients_with_error_and_close():
    """8 client threads hammer the server while one batch errors, and a
    cancelled future does not kill the dispatcher; then close() under load
    fails (does not hang) every pending request."""
    ds, idx = _flat(400, 16, 8, "st")
    server = SearchServer(idx, topk=1, ef=10, max_batch=32, timeout_us=2000)
    orig = idx._engine.batch_search_with_distance
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("boom")
        return orig(*a, **kw)

    idx._engine.batch_search_with_distance = flaky
    ok, errs = [], []

    def client(t):
        for i in range(t * 20, t * 20 + 20):
            try:
                ids, _ = server.search(ds.data[i])
                ok.append((i, int(ids[0])))
            except RuntimeError:
                errs.append(i)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
    try:
        server.submit(ds.data[0]).cancel()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert all(not t.is_alive() for t in threads)
        assert all(i == r for i, r in ok)
        assert len(ok) + len(errs) == 160
        assert calls["n"] >= 3
        futs = [server.submit(ds.data[i]) for i in range(8)]
        server.close()
        t0 = time.time()
        for f in futs:
            try:
                f.result(timeout=5)
            except RuntimeError:
                pass
        assert time.time() - t0 < 5, "close() left futures hanging"
        with pytest.raises(RuntimeError):
            server.submit(ds.data[0])
    finally:
        idx._engine.batch_search_with_distance = orig
        server.close()


@pytest.fixture(scope="module")
def bsq8():
    ds = random_dataset(n=1500, dim=16, n_queries=64, seed=31)
    idx = Index("b", IndexParams(quantization_type="bsq8", capacity=1500,
                                 max_nbrs=16), device="cpu")
    idx.fit(ds.data)
    return ds, idx


def test_concurrent_direct_searches_match_serial(bsq8):
    """8 threads searching one fitted bsq8 index at once (each its own
    slice, the seed-scan cache dropped first so they race to draw it,
    threads switched every microsecond) return the serial call's ids."""
    ds, idx = bsq8
    want = idx.batch_search(ds.queries, 10, ef_search=32)
    idx._engine._sscan = None
    got = [None] * 8
    barrier = threading.Barrier(8)

    def worker(t):
        barrier.wait()
        got[t] = idx.batch_search(ds.queries[t * 8:(t + 1) * 8], 10,
                                  ef_search=32)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    np.testing.assert_array_equal(np.concatenate(got), want)


@needs_native
def test_served_rows_match_the_direct_call(bsq8):
    """Rows served through the queue, in batches of any size, equal one
    direct batch_search_with_distance of all the queries."""
    ds, idx = bsq8
    want, wd = idx._engine.batch_search_with_distance(ds.queries, 10, ef=32)
    server = SearchServer(idx, topk=10, ef=32, max_batch=16,
                          timeout_us=2000)
    try:
        futs = [server.submit(q) for q in ds.queries]
        rows = [f.result(timeout=60) for f in futs]
    finally:
        server.close()
    np.testing.assert_array_equal(np.stack([r[0] for r in rows]), want)
    np.testing.assert_allclose(np.stack([r[1] for r in rows]), wd,
                               rtol=1e-6, atol=1e-6)


def test_build_lock_runs_one_compile(tmp_path, monkeypatch):
    """8 threads that reach the same kernel first together run one compile
    and load one library."""
    from alayalite_tpu_torch.ops import _build

    compiles = []

    class Done:
        returncode = 0

        def poll(self):
            return 0

    def fake_compile(name, tmp, log):
        compiles.append(name)
        time.sleep(0.2)
        tmp.write_bytes(b"lib")
        return Done()

    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build, "_start_compile", fake_compile)
    monkeypatch.setattr(_build, "_open_library", lambda path: object())
    monkeypatch.setattr(_build, "_loaded", {})
    barrier = threading.Barrier(8)
    libs = []

    def worker():
        barrier.wait()
        libs.append(_build.load("l2_tile"))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert compiles == ["l2_tile"]
    assert len(libs) == 8 and all(lib is libs[0] for lib in libs)
    assert _build.lib_path("l2_tile").read_bytes() == b"lib"
