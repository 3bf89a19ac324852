"""scan_roofline_pct: the least time of the searches' function on one
H100 (agbench/roofline.py, from each search's input and expected rows
and the configuration's "roofline" machine) over the device time of
every kernel in the traced window, in %; moves search_gbs.  Nothing
where the trace holds no kernel time: a share of a roofline is never 0
for want of a reading."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from agbench import roofline  # noqa: E402


def read(bundle):
    lo, hi = bundle["window"]
    t = sum(min(e, hi) - max(s, lo) for s, e, kind, _n, _c
            in bundle["device"] if kind == "kernel")
    machine = bundle["config"].get("roofline")
    if t <= 0 or machine is None or not bundle["searches"]:
        return None
    least = 0.0
    for s in bundle["searches"]:
        x = bundle["inputs"][s["key"]]
        least += roofline.least_seconds(machine, x["n_bytes"], x["n_lines"],
                                        x["line_bytes"], x["rows"])
    return 100.0 * least / t
