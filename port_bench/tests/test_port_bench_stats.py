import statistics

import pytest

from port_bench import bounds, stats


def test_rate_is_bytes_over_all_the_window():
    assert stats.rate_mb_per_s(3_000_000, 2.0) == pytest.approx(1.5)


def test_percentile_interpolates_between_ranks():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile([1, 3], 50) == 2
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_spread_uses_statistics_quartiles():
    xs = [100, 101, 99, 103, 98, 100]
    q1, _, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / statistics.median(xs))
    # the run farthest from the median is left out
    assert stats.spread_without_farthest(xs + [150]) == pytest.approx(stats.spread(xs))


def test_bound_is_five_spreads_within_one_and_twenty_five_percent():
    assert stats.bound(0.004) == pytest.approx(0.02)
    assert stats.bound(0.0001) == 0.01
    assert stats.bound(0.2) == 0.25


def test_peaks_and_bounds():
    assert bounds.INT_OPS_PER_S == pytest.approx(16.727e12, rel=1e-4)
    assert bounds.count_ops(10, 7) == 34
    # a BC1 4096x4096 chain transformed: its 11.2 MB read and written at 3.35 TB/s
    n = 1_398_103
    assert bounds.bytes_seconds(bounds.transform_bytes(8, n)) == pytest.approx(
        16 * n / 3.35e12)
    assert bounds.regions_bytes(8, n, 4 * 4 * n) == 24 * n
