#!/usr/bin/env python3
"""Sweep one sticky lane's length through both routes of bitap_lanes, to
fix where a lane leaves the one-thread walk for the segment maps
(ops/scan.py's LANES_LONG).

    python3 tools/torch_lanes_sweep.py [--min-kb 1] [--max-mb 16]
        [--out FILE.json]

For each machine (`-p aproximat`, D 0, and `-2 -p hello`, D 2) and each
length from --min-kb KiB to --max-mb MiB by powers of two, one lane of
seeded letters ended by a newline is timed through ops.scan's
_lanes_launch twice: with no chunks (every lane through the one-thread
walk) and with LANES_LONG set to 0 for the call (every lane through the
segment maps, one block a chunk), each by ops.timing.time_kernel.  The
two routes' hits must agree, and up to 64 KiB equal
bitap_lanes_reference's.  Prints the card's name and power limit, one
`sweep:` line a length and machine (both times, their ratio, the bound,
n, the segment bytes and the maps grid), the least length at which the
segment maps are faster for each machine, and a last JSON line; every
row also goes to --out as JSON where given.  Exits non-zero without a
CUDA device or on a mismatch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MACHINES = (["-p", "aproximat"], ["-2", "-p", "hello"])
WORDS = (b"hello", b"aproximate", b"helo", b"aprox")
CHECK_BYTES = 64 << 10


def machine(argv):
    from agrep_tpu_torch.compile.query import compile_query
    from agrep_tpu_torch.ops import scan as scan_ops
    from agrep_tpu_torch.options import parse_args
    from agrep_tpu_torch.runtime import engine
    opts, pattern, _ = parse_args(argv + ["x"])
    q = compile_query(pattern, opts)
    m = scan_ops.lanes_machine(q.folded_mask, engine._sticky_consts(q), q.D,
                               q.costs, "cuda")
    return q, m, engine._lane_inits(q, q.D)


def lane(rng, n: int):
    """n seeded letters with words planted every ~4 KiB, then '\\n'."""
    import numpy as np
    t = rng.integers(97, 123, n + 1, dtype=np.uint8)
    for at in range(0, max(n - 16, 0), 4096):
        w = WORDS[int(rng.integers(0, len(WORDS)))]
        t[at:at + len(w)] = np.frombuffer(w, np.uint8)
    t[n] = 0x0A
    return t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--min-kb", type=int, default=1)
    ap.add_argument("--max-mb", type=int, default=16)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_lanes_sweep: no CUDA device", file=sys.stderr)
        return 1
    from agrep_tpu_torch.ops import scan as scan_ops
    from agrep_tpu_torch.ops.timing import card_line, lanes_bound, time_kernel
    card = card_line()
    print(card)
    rng = np.random.default_rng(0)
    rows, cross, bad = [], {}, []
    n = args.min_kb << 10
    lengths = []
    while n <= args.max_mb << 20:
        lengths.append(n)
        n <<= 1
    for argv_m in MACHINES:
        q, m, init = machine(argv_m)
        name = " ".join(argv_m)
        for n in lengths:
            text = torch.from_numpy(lane(rng, n)).cuda()
            starts = torch.zeros(1, dtype=torch.int64, device="cuda")
            lens = torch.full((1,), n, dtype=torch.int64, device="cuda")
            args_l = (text, starts, lens, m, init, None, q.and_flag, False)
            walk_ms = time_kernel(lambda: scan_ops._lanes_launch(*args_l, 0))
            walk = scan_ops._lanes_launch(*args_l, 0)[1]
            saved = scan_ops.LANES_LONG
            scan_ops.LANES_LONG = 0
            try:
                chunks = scan_ops.lane_chunks(text, starts, lens, m)
                maps_ms = time_kernel(
                    lambda: scan_ops._lanes_launch(*args_l, chunks))
                maps = scan_ops._lanes_launch(*args_l, chunks)[1]
                geo = scan_ops.lanes_geometry(1, m, "cuda", chunks)
            finally:
                scan_ops.LANES_LONG = saved
            ok = torch.equal(walk, maps)
            if ok and n <= CHECK_BYTES:
                ref = scan_ops.bitap_lanes_reference(*args_l)[1]
                ok = torch.equal(walk.long(), ref.long())
            if not ok:
                bad.append((name, n))
            bms, by = lanes_bound(m, n + 1, np.array([n]))
            rows.append({"machine": name, "D": q.D, "bytes": n,
                         "walk_ms": walk_ms, "maps_ms": maps_ms,
                         "bound_ms": bms, "bound_by": by, "n": m.nodes,
                         "seg": geo["seg"], "groups": geo["groups"],
                         "maps_grid": chunks, "hits": int(walk.item()),
                         "equal": ok})
            if maps_ms < walk_ms and name not in cross:
                cross[name] = n
            print("sweep: %-16s lane %9d B: one-thread walk %.4f ms, "
                  "segment maps %.4f ms (%.1fx), bound %.4f ms (%s); n %d, "
                  "seg %d B, %d segments a block, %d chunks; hits %#x, "
                  "routes equal: %s | card: %s"
                  % (name, n, walk_ms, maps_ms, walk_ms / maps_ms, bms, by,
                     m.nodes, geo["seg"], geo["groups"], chunks,
                     int(walk.item()), ok, card))
            del text
    for name, n in cross.items():
        print("sweep: %s: the segment maps are faster from a %d B lane on"
              % (name, n))
    out = {"card": card, "rows": rows, "faster_from": cross,
           "mismatches": bad}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps({"faster_from": cross, "mismatches": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
