"""The end-to-end statistics of a window of frames.

``rate`` takes all the work and all the time of the window; ``percentile``
is taken over every frame, interpolated between the two nearest ranks;
``spread`` is the distance between the first and third quartiles of
``statistics.quantiles(values, n=4)`` as a share of the median, the
measure the bounds of ``BENCHMARK.json`` are set from.
"""

from __future__ import annotations

import statistics
from typing import Sequence


def rate(entities: int, frames: int, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return entities * frames / seconds


def percentile(values: Sequence[float], q: float) -> float:
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
