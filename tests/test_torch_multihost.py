"""Multi-process loading (``parallel/multihost.py``): the four cases of
test_multihost.py on the port, its ranged reads against the JAX package's
on one file, and ``maybe_distributed_init`` in a two-rank gloo group of
spawned processes (each with a timeout on ``init_process_group`` and a
join with a deadline; the test fails on either)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from alayalite_tpu.parallel.multihost import load_vecs_rows as jax_rows
from alayalite_tpu_torch.params import IndexParams
from alayalite_tpu_torch.parallel import make_mesh
from alayalite_tpu_torch.parallel.engine_sharded import ShardedEngine
from alayalite_tpu_torch.parallel.multihost import (
    fit_shards_from_file, load_vecs_global, load_vecs_rows,
    maybe_distributed_init, probe_vecs, process_row_range)
from alayalite_tpu_torch.utils import platforms
from alayalite_tpu_torch.utils.io import load_fvecs, save_fvecs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fvecs_file(tmp_path_factory):
    rng = np.random.default_rng(3)
    mat = rng.normal(size=(403, 24)).astype(np.float32)
    path = tmp_path_factory.mktemp("mh") / "base.fvecs"
    save_fvecs(path, mat)
    return str(path), mat


def test_probe_and_ranged_reads(fvecs_file):
    path, mat = fvecs_file
    assert probe_vecs(path) == (403, 24)
    np.testing.assert_array_equal(load_fvecs(path), mat)
    for lo, hi in [(0, 403), (0, 1), (100, 250), (400, 500), (403, 410)]:
        got = load_vecs_rows(path, lo, hi)
        np.testing.assert_array_equal(got, mat[lo:hi])
        np.testing.assert_array_equal(got, jax_rows(path, lo, hi))


def test_process_row_range_matches_array_split():
    for n, k in [(403, 7), (8, 8), (100, 3)]:
        for i, s in enumerate(np.array_split(np.arange(n), k)):
            assert process_row_range(n, k, i) == (int(s[0]), int(s[-1]) + 1)


def test_load_vecs_global_sharded(fvecs_file):
    path, mat = fvecs_file
    with platforms.force_devices(8, "cpu"):
        mesh = make_mesh(n_devices=8, dp=1)
    parts, n = load_vecs_global(path, mesh, axis="db")
    assert n == 403
    assert len(parts) == 8
    # row-sharded: 8 blocks of 51 rows (408, padded to a multiple of 8)
    assert all(p.shape == (51, 24) for p in parts)
    arr = torch.cat(parts).numpy()
    np.testing.assert_array_equal(arr[:n], mat)
    assert np.all(arr[n:] == 0)


def test_fit_shards_from_file_matches_array_fit(fvecs_file):
    path, mat = fvecs_file
    params = IndexParams(index_type="flat", capacity=500, db_shards=4)
    eng_file = ShardedEngine(params, device="cpu")
    fit_shards_from_file(eng_file, path)
    eng_arr = ShardedEngine(params, device="cpu")
    eng_arr.fit(mat)
    q = mat[:16] + 0.01
    ids_f, d_f = eng_file.batch_search_with_distance(q, 5, ef=32)
    ids_a, d_a = eng_arr.batch_search_with_distance(q, 5, ef=32)
    np.testing.assert_array_equal(ids_f, ids_a)
    np.testing.assert_allclose(d_f, d_a, rtol=1e-5)
    assert eng_file.num == 403


def test_distributed_init_noop_without_env(monkeypatch):
    monkeypatch.delenv("ALAYA_COORDINATOR", raising=False)
    assert maybe_distributed_init() is False


RANK_CODE = """
import os, sys, torch
sys.path.insert(0, {root!r})
import torch.distributed as dist
from alayalite_tpu_torch.parallel.multihost import maybe_distributed_init
assert maybe_distributed_init(timeout_s=30) is True
assert maybe_distributed_init() is True   # already up
rank = dist.get_rank()
x = torch.full((2,), float(rank + 1))
out = [torch.zeros(2) for _ in range(dist.get_world_size())]
dist.all_gather(out, x)
print("GATHERED", [o.tolist() for o in out], flush=True)
dist.destroy_process_group()
"""


def test_two_rank_gloo_all_gather():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, ALAYA_COORDINATOR=f"127.0.0.1:{port}",
                   ALAYA_NUM_PROCESSES="2", ALAYA_PROCESS_ID=str(rank),
                   CUDA_VISIBLE_DEVICES="")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_CODE.format(root=ROOT)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=90)
            assert p.returncode == 0, err
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for out in outs:
        assert "GATHERED [[1.0, 1.0], [2.0, 2.0]]" in out, out
