"""Order statistics for latencies."""
from __future__ import annotations

from typing import Sequence


def percentile(values: Sequence[float], p: float) -> float:
    """The ``p``-th percentile by linear interpolation between the closest
    ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    k = (len(xs) - 1) * p / 100.0
    lo = int(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)
