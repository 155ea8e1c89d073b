import math
import statistics

import numpy as np
import pytest

from portbench import stats


def test_poisson_schedule_same_gaps_for_every_seed():
    a = stats.poisson_schedule(1000.0, 2.0, np.random.default_rng(1))
    b = stats.poisson_schedule(1000.0, 2.0, np.random.default_rng(2))
    assert a.size == b.size == 2000
    assert a[0] == 0.0 and np.all(np.diff(a) > 0) and a[-1] < 2.0
    ga, gb = np.diff(np.append(a, 2.0)), np.diff(np.append(b, 2.0))
    assert not np.allclose(ga, gb)                       # another order
    assert np.allclose(np.sort(ga[:-1]), np.sort(gb[:-1]), atol=1e-4) or \
        abs(ga.sum() - gb.sum()) < 1e-9


def test_poisson_schedule_repeats_with_its_seed_and_is_exponential():
    a = stats.poisson_schedule(500.0, 4.0, np.random.default_rng(7))
    b = stats.poisson_schedule(500.0, 4.0, np.random.default_rng(7))
    assert np.array_equal(a, b)
    gaps = np.diff(a)
    assert gaps.mean() == pytest.approx(1 / 500.0, rel=0.02)
    # exponential: the coefficient of variation is 1
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, abs=0.05)


@pytest.mark.parametrize("on,off,seconds", [(0.5, 0.5, 4.0), (1.0, 3.0, 6.5),
                                            (0.25, 0.0, 2.0)])
def test_burst_schedule_keeps_the_mean_rate_and_falls_silent(on, off,
                                                             seconds):
    a = stats.schedule(400.0, seconds, np.random.default_rng(5),
                       {"on_s": on, "off_s": off})
    b = stats.schedule(400.0, seconds, np.random.default_rng(6),
                       {"on_s": on, "off_s": off})
    assert a.size == b.size == round(400.0 * seconds)
    assert a[0] == 0.0 and np.all(np.diff(a) > 0) and a[-1] < seconds
    assert np.all(np.mod(a, on + off) < on)              # none while off
    plain = stats.schedule(400.0, 2.0, np.random.default_rng(5))
    assert np.array_equal(plain, stats.poisson_schedule(
        400.0, 2.0, np.random.default_rng(5)))


def test_latencies_from_due_time_and_missing_results():
    due = np.array([0.0, 0.1, 0.2])
    done = np.array([0.05, np.nan, 0.5])
    lat = stats.latencies(due, done)
    assert lat[0] == pytest.approx(0.05) and math.isinf(lat[1])
    assert lat[2] == pytest.approx(0.3)


def test_percentile_nearest_rank_and_infinite_requests():
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == 95
    assert stats.percentile(v, 50) == 50
    assert stats.percentile([1.0, 2.0, math.inf], 95) == math.inf
    assert stats.percentile([3.0], 95) == 3.0


def test_spread_is_quartile_distance_over_median():
    v = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)


def test_rate():
    assert stats.rate(300, 1.5) == 200
    with pytest.raises(ValueError):
        stats.rate(1, 0)


def test_union_and_gaps_of_overlapping_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 12)]
    assert stats.union_length(iv) == pytest.approx(3 + 1 + 4)
    assert stats.union_length(iv, 1, 10) == pytest.approx(2 + 1 + 2)
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 8)]
    assert stats.gaps(iv, -1, 13) == [(-1, 0), (3, 5), (6, 8), (12, 13)]
    # the union never exceeds the wall, the sum of times can
    assert sum(e - s for s, e in iv) > stats.union_length(iv)
