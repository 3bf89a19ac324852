"""search_p95_ms: the 95th percentile of the walls of every client's
searches that completed in the traced window (nearest rank), with the
sample count; moves search_gbs."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from agbench import stats  # noqa: E402


def read(bundle):
    walls = [(s["t1"] - s["t0"]) * 1e3 for s in bundle["searches"]]
    value, n = stats.percentile(walls, 95)
    if value is None:
        return None
    return value, {"samples": n}
