"""The control of a cell's comparison: the plain reference put in the
program's place with one guarantee of the configuration broken (its
"control" entry: one edit fewer), judged exactly as run.py judges the
program's searches.  Every seed must come out not correct.

    python3 benchmark/control.py --workload NAME --seeds N,N,...

Prints a line a seed with the compared numbers and their limits, and a
last JSON line; exits 1 if any seed's control comes out correct.  Needs
no card: the reference is NumPy.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import tempfile
import zlib

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from agbench import inputs as inputs_mod  # noqa: E402
from agbench import judge, layout  # noqa: E402


def control_numbers(bench, cell_name: str, seed: int,
                    scale: float = 1.0) -> dict:
    cell = layout.cell(bench, cell_name)
    cfg = layout.config(bench, cell["config"])
    traffic = layout.traffic(cell["traffic"])
    ref = layout.reference(cfg)
    work = tempfile.mkdtemp(prefix="agbench-control-")
    try:
        inp = inputs_mod.build(cfg, traffic, seed, work, scale)
        want = ref.expected(cfg, inp)
        got = ref.expected({**cfg, **cfg["control"]}, inp)
        searches, kept = [], []
        for n, (key, (body, count)) in enumerate(sorted(got.items())):
            digest = hashlib.sha256(body).hexdigest()
            searches.append({"key": key, "digest": digest, "count": count,
                             "error": None})
            name = "out-%d.z" % n
            with open(os.path.join(work, name), "wb") as fh:
                fh.write(zlib.compress(body, 1))
            kept.append({"key": key, "digest": digest, "file": name})
        numbers = judge.judge(searches, kept, want, work)
        numbers["inputs"] = len(searches)
        return numbers
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args()
    bench = layout.benchmark()
    rows, bad = [], 0
    for seed in [int(s) for s in args.seeds.split(",")]:
        nums = control_numbers(bench, args.workload, seed, args.scale)
        ok = judge.correct(nums)
        bad += ok
        print("%s seed %d: %s -> correct %s" % (
            args.workload, seed, judge.line(nums), ok), flush=True)
        rows.append({"seed": seed, **nums, "correct": ok})
    print(json.dumps({"workload": args.workload, "control": rows}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
