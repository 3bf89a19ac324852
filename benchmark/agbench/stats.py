"""The arithmetic that turns a run's records into numbers: the rate over
the window, percentiles with their sample count, and the union of
device intervals with its idle gaps."""

from __future__ import annotations

import math


def search_rate(barrier: float, searches: list) -> tuple:
    """(bytes a second, seconds) of the searches that completed: every
    input byte of every completed search over the time from the barrier
    to the last completion.  searches: dicts with t1 (completion, on the
    barrier's clock) and bytes."""
    done = [s for s in searches if s.get("t1") is not None]
    if not done:
        return None, None
    span = max(s["t1"] for s in done) - barrier
    if span <= 0:
        return None, None
    return sum(s["bytes"] for s in done) / span, span


def percentile(values, q: float):
    """The q-th percentile (0-100) of values by the nearest rank: the
    smallest value with at least q % of the values at or below it.
    Returns (value, sample count); (None, 0) for no values."""
    xs = sorted(values)
    if not xs:
        return None, 0
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1], len(xs)


def union(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint
    intervals."""
    out = []
    for s, e in sorted((s, e) for s, e in intervals if e > s):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def busy(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] that some interval covers."""
    return sum(e - s for s, e in union(clip(intervals, lo, hi)))


def gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out
