#!/usr/bin/env python3
"""Compile CUDA sources one after another with the port's nvcc flags and
report, for each, the wall seconds of its compile, the compiler's warnings
(ptxas C7520: wgmma serialized) and the HGMMA instructions in its SASS:
``python3 scripts/torch_nvcc_probe.py [file.cu ...]`` (default: every
``alayalite_tpu_torch/csrc/*.cu``). Libraries go to ``build/nvcc_probe/``.
Needs nvcc, not a card; prints one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_source(src: str, name: str) -> dict:
    """nvcc ``src`` into build/nvcc_probe/lib<name>.so; its seconds, log,
    warnings and HGMMA count. Raises if nvcc fails."""
    sys.path.insert(0, ROOT)
    from alayalite_tpu_torch.ops import _build

    out = Path(ROOT) / "build" / "nvcc_probe" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                           str(out), src], capture_output=True, text=True)
    seconds = time.time() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{log}")
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(out)], capture_output=True,
                          text=True, check=True).stdout
    return {"source": src, "library": str(out), "seconds": seconds,
            "warnings": [ln for ln in log.splitlines() if "warning" in ln],
            "c7520": log.count("C7520"),
            "hgmma": sum(1 for ln in sass.splitlines() if "HGMMA" in ln)}


def main(argv) -> int:
    srcs = argv or sorted(str(p) for p in
                          Path(ROOT, "alayalite_tpu_torch", "csrc").glob("*.cu"))
    out = {}
    for src in srcs:
        rep = compile_source(src, Path(src).stem)
        out[src] = {k: v for k, v in rep.items() if k != "library"}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
