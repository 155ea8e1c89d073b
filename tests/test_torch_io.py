"""Vector-file io, the real-dataset loaders and the ground truth of the
port against the JAX package: the cases of ``tests/test_io.py`` run on the
port's ``utils/io.py`` and ``utils/datasets.py``; files written by either
package read by the other, byte for byte; ``calc_gt`` on the device path
(exact and fast) against numpy and against JAX's ``calc_gt``."""

import numpy as np
import pytest
import torch

from alayalite_tpu.utils import io as jax_io
from alayalite_tpu.utils.evaluate import calc_gt as jax_calc_gt
from alayalite_tpu_torch.utils import io as port_io
from alayalite_tpu_torch.utils.datasets import (available_real_datasets,
                                                load_real_dataset,
                                                random_dataset)
from alayalite_tpu_torch.utils.evaluate import _calc_gt_device, calc_gt

torch.set_num_threads(2)


def test_fvecs_roundtrip(tmp_path, rng):
    mat = rng.normal(size=(100, 17)).astype(np.float32)
    p = str(tmp_path / "a.fvecs")
    port_io.save_fvecs(p, mat)
    np.testing.assert_array_equal(port_io.load_fvecs(p), mat)


def test_ivecs_roundtrip(tmp_path, rng):
    mat = rng.integers(0, 1000, size=(50, 10)).astype(np.int32)
    p = str(tmp_path / "a.ivecs")
    port_io.save_ivecs(p, mat)
    np.testing.assert_array_equal(port_io.load_ivecs(p), mat)


def test_bvecs_and_corrupt_file(tmp_path, rng):
    mat = rng.integers(0, 256, size=(20, 12)).astype(np.uint8)
    rec = np.concatenate([np.tile(np.array([12], np.int32).view(np.uint8),
                                  (20, 1)), mat], axis=1)
    p = str(tmp_path / "a.bvecs")
    rec.tofile(p)
    np.testing.assert_array_equal(port_io.load_bvecs(p), mat)
    np.testing.assert_array_equal(jax_io.load_bvecs(p), mat)
    bad = str(tmp_path / "bad.fvecs")
    np.concatenate([np.array([4], np.int32), np.zeros(6, np.int32)]).tofile(bad)
    with pytest.raises(ValueError, match="corrupt"):
        port_io.load_fvecs(bad)


def test_empty_file(tmp_path):
    p = str(tmp_path / "empty.fvecs")
    open(p, "wb").close()
    assert port_io.load_fvecs(p).size == 0


def test_md5(tmp_path):
    p = str(tmp_path / "x.bin")
    with open(p, "wb") as f:
        f.write(b"hello world")
    assert port_io.md5(p) == "5eb63bbbe01eeed093cb22bb8f5acdc3"
    assert port_io.md5(p) == jax_io.md5(p)


@pytest.mark.parametrize("kind", ["fvecs", "ivecs"])
def test_files_cross_both_ways(tmp_path, rng, kind):
    """A file written by either package reads back in the other, and both
    writers give the same bytes."""
    if kind == "fvecs":
        mat = rng.normal(size=(64, 24)).astype(np.float32)
    else:
        mat = rng.integers(-5, 10_000, size=(64, 24)).astype(np.int32)
    pj, pp = str(tmp_path / f"j.{kind}"), str(tmp_path / f"p.{kind}")
    getattr(jax_io, f"save_{kind}")(pj, mat)
    getattr(port_io, f"save_{kind}")(pp, mat)
    with open(pj, "rb") as a, open(pp, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(getattr(port_io, f"load_{kind}")(pj), mat)
    np.testing.assert_array_equal(getattr(jax_io, f"load_{kind}")(pp), mat)


def test_real_dataset_discovery_texmex(tmp_path, rng):
    """<dir>/<name>/<name>_{base,query}.fvecs + groundtruth.ivecs."""
    d = tmp_path / "sift"
    d.mkdir()
    base = rng.normal(size=(200, 16)).astype(np.float32)
    queries = rng.normal(size=(9, 16)).astype(np.float32)
    gt = rng.integers(0, 200, size=(9, 10)).astype(np.int32)
    port_io.save_fvecs(str(d / "sift_base.fvecs"), base)
    port_io.save_fvecs(str(d / "sift_query.fvecs"), queries)
    port_io.save_ivecs(str(d / "sift_groundtruth.ivecs"), gt)

    assert available_real_datasets(str(tmp_path)) == ["sift"]
    ds = load_real_dataset("sift", root=str(tmp_path))
    np.testing.assert_allclose(ds.data, base)
    np.testing.assert_allclose(ds.queries, queries)
    np.testing.assert_array_equal(ds.gt, gt)
    assert load_real_dataset("gist", root=str(tmp_path)) is None


def test_real_dataset_discovery_hdf5(tmp_path, rng):
    """ann-benchmarks layout: <name>.hdf5 with train / test / neighbors."""
    h5py = pytest.importorskip("h5py")

    with h5py.File(tmp_path / "fashion-mnist-784-euclidean.hdf5", "w") as f:
        f["train"] = rng.normal(size=(150, 8)).astype(np.float32)
        f["test"] = rng.normal(size=(7, 8)).astype(np.float32)
        f["neighbors"] = rng.integers(0, 150, size=(7, 5))
    assert available_real_datasets(str(tmp_path)) == [
        "fashion-mnist-784-euclidean"]
    ds = load_real_dataset("fashion-mnist-784-euclidean", root=str(tmp_path))
    assert ds.data.shape == (150, 8)
    assert ds.queries.shape == (7, 8)
    assert ds.gt.shape == (7, 5)


def test_real_dataset_gt_computed_when_missing(tmp_path, rng):
    """Without a ground-truth file, ``topk`` computes it (fast mode on the
    named device): the numpy exact ids here."""
    d = tmp_path / "siftsmall"
    d.mkdir()
    base = rng.normal(size=(120, 12)).astype(np.float32)
    queries = base[:5] + 0.01
    port_io.save_fvecs(str(d / "siftsmall_base.fvecs"), base)
    port_io.save_fvecs(str(d / "siftsmall_query.fvecs"), queries)
    ds = load_real_dataset("siftsmall", root=str(tmp_path), topk=3,
                           device="cpu")
    np.testing.assert_array_equal(ds.gt,
                                  calc_gt(base, queries, 3, device="cpu"))


def test_calc_gt_fast_agrees_with_exact():
    """calc_gt(fast=True) on the device path (bf16 coarse scan, f32 rerank
    of max(256, 16k)) holds ≥ 0.999 of the exact float64 ids at 2,000 x
    64, with and without deleted rows."""
    ds = random_dataset(n=2000, dim=64, n_queries=256, seed=5)
    dead = np.arange(0, 2000, 9)
    for deleted in (None, dead):
        want = calc_gt(ds.data, ds.queries, 10, deleted=deleted,
                       device="cpu")
        got = calc_gt(ds.data, ds.queries, 10, deleted=deleted, fast=True,
                      device="cpu")
        assert got.shape == (256, 10) and got.dtype == np.int32
        agree = np.mean([len(set(g) & set(w)) / 10.0
                         for g, w in zip(got, want)])
        assert agree >= 0.999, agree
        if deleted is not None:
            assert not np.isin(got, dead).any()


def _check_against_jax_gt(metric, exact):
    """``exact(data, queries, k, metric, dead)`` against JAX's calc_gt,
    deleted rows honoured: the same ids except where two distances tie
    within f32 rounding (then the sorted distances must agree to 1e-5
    relative)."""
    ds = random_dataset(n=1500, dim=32, n_queries=64, seed=8)
    dead = np.arange(3, 1500, 11)
    want = np.asarray(jax_calc_gt(ds.data, ds.queries, 10, metric=metric,
                                  deleted=dead))
    got = exact(ds.data, ds.queries, 10, metric, dead)
    assert not np.isin(got, dead).any()
    same = got == want
    assert same.mean() >= 0.99, same.mean()
    x = ds.data.astype(np.float64)
    q = ds.queries.astype(np.float64)
    if metric == "cos":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    for b in np.flatnonzero(~same.all(1)):
        if metric == "l2":
            d = ((x[got[b]] - q[b]) ** 2).sum(1), ((x[want[b]] - q[b]) ** 2).sum(1)
        else:
            d = -(x[got[b]] @ q[b]), -(x[want[b]] @ q[b])
        np.testing.assert_allclose(np.sort(d[0]), np.sort(d[1]), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_calc_gt_device_matches_jax(metric):
    """The exact device path (exact_topk, l2_tile's plain version on the
    CPU) against JAX's calc_gt."""
    def exact(x, q, k, metric, dead):
        return _calc_gt_device(x, q, k, metric, dead, False,
                               torch.device("cpu"))

    _check_against_jax_gt(metric, exact)


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_calc_gt_numpy_matches_jax(metric):
    """calc_gt(device="cpu"), the float64 numpy reference, against JAX's
    calc_gt."""
    def exact(x, q, k, metric, dead):
        return calc_gt(x, q, k, metric=metric, deleted=dead, device="cpu")

    _check_against_jax_gt(metric, exact)
