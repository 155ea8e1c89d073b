"""Builds the port's CUDA sources (``csrc/*.cu``) into shared libraries.

Each source is compiled on first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, ``build/kernels/lib<name>-<hash>.so``
under the source tree's root (or under the working directory when the
package is installed rather than run from a checkout), and loaded with
``ctypes``. The hash covers the source and the flags, so an edited source
is rebuilt and a stale library is never loaded. ``build()`` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SRC_ROOT = Path(__file__).resolve().parents[2]
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


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


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library yet, all
    ``nvcc`` processes in parallel. Raises with the compiler's output if
    one fails. Returns {name: library path}."""
    names = list(sources() if names is None else names)
    jobs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    errors = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: lib_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (built on first use)."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _loaded[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes: list):
    """The C function ``symbol`` of ``csrc/<name>.cu``, typed; every entry
    point takes the CUDA stream last and returns a CUDA error code."""
    fn = getattr(load(name), symbol)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(fn, device, *args) -> None:
    """Call a kernel entry point on ``device``'s current stream; raise with
    the CUDA error if the launch was refused."""
    import torch

    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error "
                           f"{err}")
