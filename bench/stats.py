"""The end-to-end arithmetic: a rate over a window, and a percentile over
all requests (a request with no answer counts as missing every limit)."""

from __future__ import annotations

import math


def rate(count: float, seconds: float) -> float:
    """``count`` per second over a window of ``seconds``."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return count / seconds


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (nearest rank) of ``values``, where ``inf``
    stands for a request that never got its answer."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    rank = max(math.ceil(q / 100.0 * len(v)), 1)
    return v[rank - 1]

