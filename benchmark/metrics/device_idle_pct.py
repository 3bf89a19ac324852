"""device_idle_pct: 100 less the share of the traced window in which
any client's kernel, copy or memset ran on the card (the union of every
client's device events, put on one clock through each client's marker
span); moves search_gbs."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from agbench import stats  # noqa: E402


def read(bundle):
    lo, hi = bundle["window"]
    if hi <= lo or not bundle["device"]:
        return None
    busy = stats.busy([(d[0], d[1]) for d in bundle["device"]], lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo))
