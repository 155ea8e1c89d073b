"""Multi-process loading for sharded indices (port of
``parallel/multihost.py``).

Every process reads only its own rows of the on-disk dataset, so no host
holds the whole file:

- ``maybe_distributed_init()``: a ``torch.distributed`` process group from
  the ALAYA_COORDINATOR (``host:port``), ALAYA_NUM_PROCESSES and
  ALAYA_PROCESS_ID environment variables (NCCL where CUDA is present, else
  gloo; ``tcp://`` init); a no-op without them. This is the only module of
  the port that touches ``torch.distributed``.
- ``probe_vecs`` / ``load_vecs_rows``: header-aware ranged reads of
  (f|i|b)vecs files through ``np.memmap`` (only the requested rows are
  paged in; the layout of ``utils/io.py``).
- ``load_vecs_global(path, mesh, axis)``: the per-shard tensors of a vecs
  file over ``mesh[axis]``, each process reading only the shards it owns.

``fit_shards_from_file`` fits a ``ShardedEngine`` with each shard reading
its own row range: peak host memory is one shard's rows.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Tuple

import numpy as np

_VECS_DTYPES = {
    ".fvecs": np.dtype(np.float32),
    ".ivecs": np.dtype(np.int32),
    ".bvecs": np.dtype(np.uint8),
}


def maybe_distributed_init(timeout_s: float = 300.0) -> bool:
    """Start a ``torch.distributed`` group from the ALAYA_* environment.
    Returns True if a group is up (already, or started here), False
    without ALAYA_COORDINATOR."""
    import torch
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True
    coord = os.environ.get("ALAYA_COORDINATOR")
    if not coord:
        return False
    nproc = int(os.environ.get("ALAYA_NUM_PROCESSES", "1"))
    pid = int(os.environ.get("ALAYA_PROCESS_ID", "0"))
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = coord if "://" in coord else f"tcp://{coord}"
    dist.init_process_group(backend, init_method=url, world_size=nproc,
                            rank=pid,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def _process() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _vecs_dtype(path: str, dtype: Optional[np.dtype]) -> np.dtype:
    if dtype is not None:
        return np.dtype(dtype)
    ext = os.path.splitext(str(path))[1].lower()
    if ext not in _VECS_DTYPES:
        raise ValueError(f"cannot infer vecs dtype from {path!r}; pass dtype=")
    return _VECS_DTYPES[ext]


def probe_vecs(path: str, dtype: Optional[np.dtype] = None) -> Tuple[int, int]:
    """(n_rows, dim) of a vecs file from its header and size, no data read."""
    dt = _vecs_dtype(path, dtype)
    size = os.path.getsize(path)
    if size == 0:
        return 0, 0
    with open(path, "rb") as f:
        dim = int(np.frombuffer(f.read(4), dtype=np.int32)[0])
    record = 4 + dim * dt.itemsize
    if dim <= 0 or size % record != 0:
        raise ValueError(
            f"corrupt vecs file {path}: size {size}, header dim {dim}")
    return size // record, dim


def load_vecs_rows(path: str, start: int, stop: int,
                   dtype: Optional[np.dtype] = None) -> np.ndarray:
    """Rows [start, stop) of a vecs file via memmap, clamped to the file:
    only the requested byte range is paged in."""
    dt = _vecs_dtype(path, dtype)
    n, dim = probe_vecs(path, dt)
    start, stop = max(0, int(start)), min(n, int(stop))
    if stop <= start:
        return np.empty((0, dim), dtype=dt)
    record = 4 + dim * dt.itemsize
    mm = np.memmap(path, dtype=np.uint8, mode="r",
                   offset=start * record, shape=((stop - start) * record,))
    rows = np.asarray(mm).reshape(stop - start, record)[:, 4:].copy()
    del mm
    return rows.view(dt).reshape(stop - start, dim)


def process_row_range(n: int, num_shards: int, index: int) -> Tuple[int, int]:
    """Contiguous balanced range of shard ``index`` of ``num_shards``: the
    split of ``np.array_split``, so file-fed and array-fed shards line up
    row for row."""
    base, extra = divmod(n, num_shards)
    start = index * base + min(index, extra)
    return start, start + base + (1 if index < extra else 0)


def load_vecs_global(path: str, mesh, axis: str = "db",
                     dtype: Optional[np.dtype] = None):
    """The rows of a vecs file zero-padded to a multiple of ``mesh``'s
    ``axis`` and split into one block per shard, each on its mesh device.
    Returns (per-shard tensors, n_rows). A process reads only the blocks of
    the shards it owns (a contiguous range of shards per rank); the others
    are None."""
    import torch

    dt = _vecs_dtype(path, dtype)
    n, dim = probe_vecs(path, dt)
    devs = mesh.axis_devices(axis)
    nsh = len(devs)
    rows = -(-n // nsh)
    rank, world = _process()
    own_lo, own_hi = process_row_range(nsh, world, rank)
    out: List = [None] * nsh
    for s in range(own_lo, own_hi):
        block = np.zeros((rows, dim), dtype=dt)
        got = load_vecs_rows(path, s * rows, min((s + 1) * rows, n), dtype=dt)
        block[: got.shape[0]] = got
        out[s] = torch.as_tensor(block, device=devs[s])
    return out, n


def fit_shards_from_file(engine, path: str, dtype: Optional[np.dtype] = None,
                         ef_construction: Optional[int] = None) -> None:
    """Fit a ``ShardedEngine`` with each shard reading its own row range
    from disk."""
    from .engine_sharded import _GidMap

    dt = _vecs_dtype(path, dtype)
    n, _dim = probe_vecs(path, dt)
    ndb = engine.ndb
    if n < ndb:
        raise ValueError(f"fit of {n} vectors cannot fill db_shards={ndb}")
    if n > ndb * engine.per_cap:
        raise RuntimeError(
            f"file has {n} rows > capacity {ndb * engine.per_cap}")
    engine._gid_map = _GidMap(n)
    engine._l2g = [np.full(0, -1, np.int64) for _ in range(ndb)]
    off = 0
    for s in range(ndb):
        lo, hi = process_row_range(n, ndb, s)
        rows = load_vecs_rows(path, lo, hi, dtype=dt).astype(
            np.float32, copy=False)
        engine.shards[s].fit(rows, ef_construction=ef_construction)
        engine._register_fit_chunk(s, rows.shape[0], off)
        off += rows.shape[0]
    engine._next_gid = n
    engine._fitted = True
    engine._leaves = None
