"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Runs from the root of a checkout that holds agrep_tpu_torch/.  The cell
(BENCHMARK.json's workloads) names a configuration
(benchmark/configs/<name>.json, with its plain reference in
benchmark/reference/) and a traffic mix (benchmark/traffic/<name>.json);
its clients search through the port on one card for S seconds after a
barrier (agbench/harness.py).  The last line of stdout is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones, benchmark/metrics/),
device, with --trace 1 breakdown, and last "compared", each number
compared with its limit; the same numbers end stderr.  Without a CUDA
card (or with fewer than the cell asks for), or when a client or the
comparison cannot finish, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from agbench import harness, judge, layout  # noqa: E402


def need_cards(chips: int) -> None:
    """Raises NoCard unless torch sees at least `chips` CUDA cards."""
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        raise harness.NoCard("the cell needs %d CUDA card(s); this machine "
                             "has %d" % (chips, have))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        bench = layout.benchmark()
        cell = layout.cell(bench, args.workload)
        cfg = layout.config(bench, cell["config"])
        traffic = layout.traffic(cell["traffic"])
    except layout.LayoutError as e:
        print("agbench: %s" % e, file=sys.stderr)
        return 2
    try:
        out = harness.run_cell(bench, cell, cfg, traffic, args.seed,
                               args.seconds, bool(args.trace), T_START,
                               check=lambda: need_cards(cell["chips"]))
    except harness.NoCard as e:
        print("agbench: %s" % e, file=sys.stderr)
        return 3
    except harness.RunError as e:
        print("agbench: %s" % e, file=sys.stderr)
        return 1
    numbers = {k: v["value"] for k, v in out["compared"].items()}
    print("compared: %s" % judge.line(numbers), file=sys.stderr)
    print("correct: %s" % out["correct"], file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
