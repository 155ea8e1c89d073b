"""ctypes bindings for the native host runtime (``alaya_native.cpp``), the
port's copy of ``alayalite_tpu/native``: ``get_lib``, ``load_vecs_native``
and ``BatchQueue``, with the same signatures and errors.

The library is built on first use with ``g++`` into ``build/native/``
beside the kernels (``ops/_build.build_dir``), named with a hash of the
source and the flags, so an edited source is rebuilt and the package
directory is never written. Building holds a lock, so threads that need the
library first together run one compile. Without a compiler ``get_lib``
returns None and the callers fall back to numpy, as the JAX package's do.
This is host code: it runs on no device.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops._build import build_dir

log = logging.getLogger("alayalite_tpu_torch")

SRC = Path(__file__).resolve().parent / "alaya_native.cpp"
# no -march=native (the JAX package's flag): the library's name does not
# name the machine, and its loops are memcpy and condition variables
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def lib_path() -> Path:
    digest = hashlib.sha1(SRC.read_bytes()
                          + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return build_dir().parent / "native" / f"libalaya_native-{digest}.so"


def _build(out: Path) -> Optional[Path]:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC), "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except Exception as e:
        log.warning("native build failed (%s); using python fallbacks", e)
        return None
    os.replace(tmp, out)
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on first use; None if
    unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = lib_path()
        if not path.exists() and _build(path) is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(path))
        lib.al_vecs_probe.restype = ctypes.c_int
        lib.al_vecs_probe.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int64),
                                      ctypes.POINTER(ctypes.c_int64)]
        lib.al_vecs_load.restype = ctypes.c_int
        lib.al_vecs_load.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_void_p, ctypes.c_int]
        lib.al_bq_create.restype = ctypes.c_void_p
        lib.al_bq_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int64]
        lib.al_bq_push.restype = ctypes.c_int
        lib.al_bq_push.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_void_p]
        lib.al_bq_pop_batch.restype = ctypes.c_int
        lib.al_bq_pop_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_void_p]
        lib.al_bq_size.restype = ctypes.c_int
        lib.al_bq_size.argtypes = [ctypes.c_void_p]
        lib.al_bq_close.argtypes = [ctypes.c_void_p]
        lib.al_bq_destroy.argtypes = [ctypes.c_void_p]
        lib.al_arena_create.restype = ctypes.c_void_p
        lib.al_arena_alloc.restype = ctypes.c_void_p
        lib.al_arena_alloc.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_int64]
        lib.al_arena_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def load_vecs_native(path: str, dtype=np.float32,
                     threads: int = 8) -> Optional[np.ndarray]:
    """mmap + parallel header-strip load of an (f|i|b)vecs file.
    Returns None if the native library is unavailable (caller falls back)."""
    lib = get_lib()
    if lib is None:
        return None
    elem = np.dtype(dtype).itemsize
    n = ctypes.c_int64()
    dim = ctypes.c_int64()
    rc = lib.al_vecs_probe(path.encode(), elem, ctypes.byref(n),
                           ctypes.byref(dim))
    if rc != 0:
        raise ValueError(f"corrupt or unreadable vecs file {path} (rc={rc})")
    if n.value == 0:
        return np.empty((0, 0), dtype=dtype)
    out = np.empty((n.value, dim.value), dtype=dtype)
    rc = lib.al_vecs_load(path.encode(), elem, n.value, dim.value,
                          out.ctypes.data_as(ctypes.c_void_p), threads)
    if rc != 0:
        raise IOError(f"failed to load {path} (rc={rc})")
    return out


class BatchQueue:
    """Concurrent query coalescer: producers push single queries from any
    thread; one dispatcher pops batches of up to ``max_batch`` for one
    device search."""

    def __init__(self, dim: int, capacity: int = 8192, max_batch: int = 1024,
                 timeout_us: int = 2000):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.dim = dim
        self.max_batch = max_batch
        self._q = lib.al_bq_create(capacity, dim, max_batch, timeout_us)
        self._out = np.empty((max_batch, dim), dtype=np.float32)
        self._tickets = np.empty(max_batch, dtype=np.int64)

    def push(self, ticket: int, vec: np.ndarray) -> None:
        v = np.ascontiguousarray(vec, dtype=np.float32)
        if v.shape != (self.dim,):
            # al_bq_push copies dim*4 bytes from this buffer: a shorter
            # vector would be an out-of-bounds read in the native queue
            raise ValueError(
                f"query dimension mismatch: got shape {v.shape}, "
                f"expected ({self.dim},)")
        rc = self._lib.al_bq_push(self._q, ticket,
                                  v.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError("queue closed")

    def pop_batch(self):
        """Blocks for work; returns (queries [b, dim] f32 copy, tickets [b])
        or (None, None) when closed and drained."""
        n = self._lib.al_bq_pop_batch(
            self._q, self._out.ctypes.data_as(ctypes.c_void_p),
            self._tickets.ctypes.data_as(ctypes.c_void_p))
        if n == 0:
            return None, None
        return self._out[:n].copy(), self._tickets[:n].copy()

    def size(self) -> int:
        return self._lib.al_bq_size(self._q)

    def close(self) -> None:
        self._lib.al_bq_close(self._q)

    def __del__(self):
        try:
            self._lib.al_bq_close(self._q)
            self._lib.al_bq_destroy(self._q)
        except Exception:
            pass
