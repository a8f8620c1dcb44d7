"""Percentiles of all the samples of a window.

The nearest-rank percentile: the smallest sample with at least ``q``
percent of the samples at or below it. It is a sample that was measured,
and needs no interpolation between two.
"""

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th nearest-rank percentile of ``values`` (0 < q <= 100)."""
    if not values:
        raise ValueError("percentile of no samples")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return float(ordered[rank - 1])
