"""Statistics of runs: the rate over a window, percentiles, and the spread and bound
arithmetic that sets an end-to-end metric's bound."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def rate_mb_per_s(total_bytes: int, seconds: float) -> float:
    """Bytes (10^6 to a MB) over all the time of the window."""
    return total_bytes / 1e6 / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between closest ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile (``statistics.quantiles``,
    n=4) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def spread_without_farthest(values: Sequence[float]) -> float:
    """:func:`spread` of the values with the one farthest from the median left out."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])


def bound(widest_spread: float, factor: float = 5.0, floor: float = 0.01,
          ceiling: float = 0.25) -> float:
    """The bound of a metric: ``factor`` times the widest spread, never under
    ``floor`` nor over ``ceiling``."""
    return min(ceiling, max(floor, factor * widest_spread))
