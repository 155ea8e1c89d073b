"""Timing on the card for the port's scripts (``chip_smoke.py``,
``scripts/torch_*.py``): CUDA-event medians and the card's name and power
limit, which every kept number stands beside."""

from __future__ import annotations

import subprocess

import numpy as np

# H100 SXM data sheet, dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12,      # float32 on the CUDA cores
                  "bf16": 989e12}    # bf16 on the tensor cores


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take for work that must move
    ``nbytes`` and do ``ops`` operations of type ``kind``: the larger of
    the two times, and which one it is."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms}


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


SPIN_CYCLES = 400_000   # ~0.2 ms of device spin ahead of a timed call


def cuda_ms(fn, warmup: int = 3, reps: int = 25, spin: bool = False) -> float:
    """Median milliseconds of ``fn`` between CUDA events, after
    ``warmup`` calls. That span holds the ~0.03 ms the host takes to launch
    one kernel wherever the kernel runs shorter than that. With ``spin``
    the device spins for a moment before the first event, so the host has
    enqueued ``fn`` by the time the event passes and the span is the
    device's time alone. The two are different yardsticks: compare a number
    only with others taken the same way."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))
