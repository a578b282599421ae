"""Percentiles and rates as the benchmark defines them."""
from __future__ import annotations

import math
import statistics


def percentile(values, p: float) -> float:
    """The nearest-rank ``p``-th percentile (0 < p <= 100): the
    ceil(p/100 * n)-th smallest value. A missing value is ``math.inf`` and
    sorts last, so a refused or unfinished request counts against the tail
    and never falls out of it. Empty input gives ``math.nan``."""
    xs = sorted(values)
    if not xs:
        return math.nan
    k = max(1, math.ceil(p / 100.0 * len(xs)))
    return float(xs[k - 1])


def rate(count: float, seconds: float) -> float:
    """Work per second over a window; nan for an empty window."""
    return count / seconds if seconds > 0 else math.nan


def spread(values) -> float:
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles`` with n=4, the rule the bounds follow)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else math.inf
