"""Arithmetic the readers share. A reader returns None where it finds
nothing to read; the run then leaves its metric out of the line."""

from __future__ import annotations

import math
import re
from typing import Optional


def capture_s(run) -> Optional[float]:
    """Seconds the captured layer spent capturing inside the window
    (``captured.stats``); 0 where the warm-up captured every key."""
    if not run.before or not run.after:
        return None
    return (run.after["captured"]["capture_s"]
            - run.before["captured"]["capture_s"])


def idle_share(run) -> Optional[float]:
    """100 × (1 − the union of device operation intervals over the traced
    span's wall)."""
    tr = run.trace_result
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def finite(x) -> Optional[float]:
    return float(x) if x is not None and math.isfinite(x) else None


GATHER_ESTIMATE = re.compile(r"gather_rows_kernel<\s*\d+\s*,\s*true\s*>")
POOL_MERGE = re.compile(r"pool_merge(_warp)?_kernel")
