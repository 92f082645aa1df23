"""The arithmetic the benchmark's numbers come from: percentiles, spreads,
the union of device intervals and its gaps, and the trace kernels'
bytes-only bound.

All of it is plain Python over lists of numbers, so the tests check it on
synthetic inputs.
"""

from __future__ import annotations

import math
import statistics

# NVIDIA H100 SXM's device memory rate (the data sheet's 3.35 TB/s)
PEAK_BYTES_S = 3.35e12
# a live ray's bytes in (origin, direction, mint, maxt: 8 float32), every
# lane's bytes out (hit 1, t 4, triangle 4, two barycentrics 8), and a
# triangle's bytes (three vertices, 9 float32)
RAY_IN_BYTES, LANE_OUT_BYTES, TRIANGLE_BYTES = 32, 17, 36


def percentile(values, q):
    """The q-th percentile (0 < q < 100) by the nearest rank: the smallest
    value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def spread(values):
    """(third quartile - first quartile) / median, by
    statistics.quantiles(values, n=4)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union(intervals):
    """Sorted, merged (start, end) intervals of the given ones."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def clip(intervals, lo, hi):
    """The parts of the intervals inside [lo, hi]."""
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def busy(intervals, lo, hi):
    """Length of the union of the intervals within [lo, hi]: overlapping
    work on the device counts once."""
    return sum(b - a for a, b in union(clip(intervals, lo, hi)))


def gaps(intervals, lo, hi):
    """The idle (start, end) stretches of [lo, hi] outside every
    interval."""
    out, cur = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return out


def trace_bound_s(launches, n_triangles):
    """The least seconds the trace launches could take on the device's
    memory rate, from work that no tree or kernel changes: each launch
    reads its live rays and the scene's triangles once and writes every
    lane. launches: [(lanes, live lanes)]."""
    n_bytes = sum(live * RAY_IN_BYTES + lanes * LANE_OUT_BYTES
                  + n_triangles * TRIANGLE_BYTES for lanes, live in launches)
    return n_bytes / PEAK_BYTES_S
