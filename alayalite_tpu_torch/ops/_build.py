"""Builds the port's CUDA sources (``csrc/*.cu``) into shared libraries.

Each source is compiled on first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, ``build/kernels/lib<name>-<hash>.so``
under the source tree's root (or under the working directory when the
package is installed rather than run from a checkout), and loaded with
``ctypes``. The hash covers the source and the flags, so an edited source
is rebuilt and a stale library is never loaded. ``build()`` starts one ``nvcc`` per source, all at once.

Building and loading hold one process-wide lock, so threads that reach a
kernel first together (the serving dispatcher, HTTP handler threads) run
one ``nvcc`` for it and load one library, never two compiles writing one
``.so``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SRC_ROOT = Path(__file__).resolve().parents[2]
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.RLock()     # guards build / load / entry and the maps
_loaded: Dict[str, ctypes.CDLL] = {}
_entries: Dict[tuple, object] = {}
# of the sources this process compiled: seconds of each nvcc, its output
build_seconds: Dict[str, float] = {}
build_logs: Dict[str, str] = {}


def build_dir() -> Path:
    """``build/kernels`` of the checkout the package sits in; of the working
    directory for an installed package, never a directory beside
    site-packages."""
    in_checkout = (_SRC_ROOT / "pyproject.toml").is_file()
    return (_SRC_ROOT if in_checkout else Path.cwd()) / "build" / "kernels"


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def _start_compile(name: str, tmp: Path, log) -> subprocess.Popen:
    """One ``nvcc`` process compiling ``csrc/<name>.cu`` into ``tmp``."""
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)


def _open_library(path: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(path))


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library yet, all
    ``nvcc`` processes in parallel. Raises with the compiler's output if
    one fails. Returns {name: library path}; ``build_seconds`` and
    ``build_logs`` keep each compile's wall seconds and output."""
    with _lock:
        return _build(list(sources() if names is None else names))


def _build(names: list) -> Dict[str, Path]:
    jobs = {}
    t0 = time.time()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = tmp.with_suffix(".log").open("w+")
        jobs[name] = (_start_compile(name, tmp, log), tmp, out, log)
    errors = []
    while jobs:
        for name in [n for n, job in jobs.items() if job[0].poll() is not None]:
            proc, tmp, out, log = jobs.pop(name)
            build_seconds[name] = time.time() - t0
            log.seek(0)
            build_logs[name] = log.read()
            log.close()
            os.remove(log.name)
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n"
                              f"{build_logs[name]}")
            else:
                os.replace(tmp, out)
        time.sleep(0.05)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: lib_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _open_library(lib_path(name))
            _loaded[name] = lib
        return lib


def entry(name: str, symbol: str, argtypes: list):
    """The C function ``symbol`` of ``csrc/<name>.cu``, typed (once); every
    entry point takes the CUDA stream last and returns a CUDA error code."""
    key = (name, symbol)
    fn = _entries.get(key)
    if fn is None:
        with _lock:
            fn = _entries.get(key)
            if fn is None:
                fn = getattr(load(name), symbol)
                fn.argtypes = [*argtypes, ctypes.c_void_p]
                fn.restype = ctypes.c_int
                _entries[key] = fn
    return fn


def launch(fn, device, *args) -> None:
    """Call a kernel entry point on ``device``'s current stream (switching
    the current device only when it is another); raise with the CUDA error
    if the launch was refused."""
    import torch

    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error "
                           f"{err}")
