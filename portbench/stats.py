"""The benchmark's arithmetic: percentiles, spreads, rates, the open
loop's schedule and the union of busy intervals. Plain Python and numpy,
tested on synthetic inputs (``tests/test_portbench_stats.py``)."""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np


def percentile(values: Sequence[float], p: float) -> float:
    """The ``p``-th percentile (0-100) by the nearest rank: the smallest
    value with at least p% of the sample at or below it. An infinite value
    (a request that failed or never came) sorts past every other."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if v.size == 0:
        raise ValueError("percentile of an empty sample")
    rank = max(1, math.ceil(p / 100.0 * v.size))
    return float(v[rank - 1])


def spread(values: Sequence[float]) -> float:
    """(third quartile − first) / median, the quartiles as
    ``statistics.quantiles(values, n=4)`` gives them."""
    q1, med, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / abs(med) if med else math.inf


def rate(count: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("a rate over no time")
    return count / seconds


def poisson_schedule(rate_per_s: float, seconds: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Due times in [0, seconds) of an open loop at ``rate_per_s``: the
    gaps are the quantiles of the exponential distribution at (i + 0.5) / N
    for N = round(rate · seconds) arrivals, scaled to fill the window, in
    an order drawn from ``rng``. Every seed gets the same set of gaps, and
    so the same number of requests, in another order."""
    n = int(round(rate_per_s * seconds))
    if n < 1:
        raise ValueError("no request in the window")
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u)
    gaps *= seconds / gaps.sum()
    gaps = rng.permutation(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])


def schedule(rate_per_s: float, seconds: float, rng: np.random.Generator,
             burst: Optional[dict] = None) -> np.ndarray:
    """Due times in [0, seconds) of an open loop at a mean ``rate_per_s``.
    Without ``burst``, ``poisson_schedule``. With ``burst`` {"on_s",
    "off_s"}, the same number of arrivals, Poisson within the on-phases
    (at rate × (on + off) / on) and none in the off-phases: the window
    starts on."""
    if not burst:
        return poisson_schedule(rate_per_s, seconds, rng)
    on, off = float(burst["on_s"]), float(burst["off_s"])
    if on <= 0 or off < 0:
        raise ValueError(f"a burst needs on_s > 0 and off_s >= 0: {burst}")
    period = on + off
    whole, part = divmod(seconds, period)
    on_time = whole * on + min(part, on)
    n = int(round(rate_per_s * seconds))
    t = poisson_schedule(n / on_time, on_time, rng)
    cycle, within = np.divmod(t, on)
    return cycle * period + within


def latencies(due: np.ndarray, done: np.ndarray) -> np.ndarray:
    """Seconds from each request's due time to its result; ``done`` is
    NaN where the result never came or was an error: those read +inf."""
    lat = done - due
    return np.where(np.isnan(done), np.inf, lat)


def union_length(intervals: Iterable[Tuple[float, float]],
                 lo: float = -math.inf, hi: float = math.inf) -> float:
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]
