"""Order statistics the metrics and the spread reckoning use."""
from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least
    q% of the values at or below it."""
    v = sorted(values)
    return v[max(math.ceil(q / 100 * len(v)) - 1, 0)]


def spread(values: Sequence[float]) -> float:
    """(third quartile - first quartile) / median, quartiles as
    ``statistics.quantiles(values, n=4)`` gives them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
