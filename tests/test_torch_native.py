"""The port's native host runtime (``alayalite_tpu_torch/native``): the
vecs loader and the batch queue, the cases of tests/test_native.py, and
the port's loader against the JAX package's on the same file."""

import threading

import numpy as np
import pytest

from alayalite_tpu_torch.native import (BatchQueue, get_lib, lib_path,
                                        load_vecs_native)
from alayalite_tpu_torch.utils.io import _load_vecs, load_fvecs, save_fvecs

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="native toolchain unavailable")


def test_native_loader_matches_python(tmp_path, rng):
    mat = rng.normal(size=(257, 33)).astype(np.float32)
    path = str(tmp_path / "x.fvecs")
    save_fvecs(path, mat)
    want = _load_vecs(path, np.dtype(np.float32))
    got = load_vecs_native(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, mat)
    np.testing.assert_array_equal(load_fvecs(path), mat)
    # built under build/native with the source's hash, not in the package
    assert lib_path().parent.name == "native"
    assert lib_path().parent.parent.name == "build"


def test_native_loader_corrupt(tmp_path):
    path = str(tmp_path / "bad.fvecs")
    with open(path, "wb") as f:
        f.write(b"\x08\x00\x00\x00abc")  # truncated record
    with pytest.raises(ValueError):
        load_vecs_native(path)
    with pytest.raises(ValueError):
        load_fvecs(path)


def test_native_loader_matches_jax_package(tmp_path, rng):
    from alayalite_tpu.native import get_lib as jax_get_lib
    from alayalite_tpu.native import load_vecs_native as jax_load

    if jax_get_lib() is None:
        pytest.skip("the JAX package's native library did not build")
    mat = rng.normal(size=(1000, 128)).astype(np.float32)
    path = str(tmp_path / "y.fvecs")
    save_fvecs(path, mat)
    got, want = load_vecs_native(path), jax_load(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_batch_queue_coalesces(rng):
    dim = 16
    q = BatchQueue(dim, capacity=64, max_batch=8, timeout_us=20_000)
    vecs = rng.normal(size=(20, dim)).astype(np.float32)

    def producer(lo, hi):
        for i in range(lo, hi):
            q.push(i, vecs[i])

    threads = [threading.Thread(target=producer, args=(i * 5, i * 5 + 5))
               for i in range(4)]
    for t in threads:
        t.start()

    got = {}
    while len(got) < 20:
        batch, tickets = q.pop_batch()
        assert batch is not None
        assert batch.shape[0] <= 8
        for row, ticket in zip(batch, tickets):
            got[int(ticket)] = row
    for t in threads:
        t.join()
    q.close()
    assert sorted(got) == list(range(20))
    for i in range(20):
        np.testing.assert_array_equal(got[i], vecs[i])


def test_batch_queue_close_unblocks():
    q = BatchQueue(4, capacity=8, max_batch=4, timeout_us=1000)
    out = []

    def popper():
        out.append(q.pop_batch())

    t = threading.Thread(target=popper)
    t.start()
    q.close()
    t.join(timeout=5)
    assert not t.is_alive()
    assert out[0] == (None, None)
