#!/usr/bin/env python3
"""Time the bench's mask_scan and chain_scan launches over a slice that
fits the card's L2, once with the slice in L2 and once after L2 was
flushed, to see what a cold read of the text costs.

    python3 tools/torch_l2_cold.py [--mb 32] [--reps 9]

The slice is the first --mb MB of agrep_tpu_torch.bench's corpus; the
rows are the bench's k2 and exact_k0 mask_scan launches and its f100
chain_scan launch.  Each launch is timed alone between two CUDA events:
warm, right after the same launch (which left the slice in L2), and
cold, right after a read of a 256 MB buffer (five times the H100's
50 MB L2).  Reads leave L2 clean, so the cold launch pays no write-back
of the flush.  --reps of each, interleaved, are queued behind one spin
of the card, and that the first event was still pending once the last
launch was queued is checked, as in ops.timing.time_kernel (the spin
doubles up to 4 times, then the tool raises).  Prints the card's name
and power limit, one `l2:` line a row (median, min and max ms of each
kind, the cold/warm ratio and the bytes bound of the slice), and a last
JSON line.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FLUSH_BYTES = 256 << 20


def warm_cold_ms(fn, flush, reps: int) -> dict:
    """{"warm": [ms], "cold": [ms]} of reps single launches of fn each."""
    import torch

    from agrep_tpu_torch.ops.timing import SPIN_CYCLES
    fn()
    flush()
    torch.cuda.synchronize()
    for k in range(5):
        # four calls a rep: the warm-up launch, two timed, the flush
        torch.cuda._sleep(SPIN_CYCLES * 4 * reps << k)
        pairs = {"warm": [], "cold": []}
        for _ in range(reps):
            for kind, before in (("warm", fn), ("cold", flush)):
                before()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                pairs[kind].append((a, b))
        queued_first = not pairs["warm"][0][0].query()
        torch.cuda.synchronize()
        if queued_first:
            return {kind: [a.elapsed_time(b) for a, b in v]
                    for kind, v in pairs.items()}
    raise RuntimeError("torch_l2_cold: the card finished its spin before "
                       "the host had queued %d launches" % (4 * reps))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=32)
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_l2_cold: no CUDA device", file=sys.stderr)
        return 1
    from agrep_tpu_torch import bench
    from agrep_tpu_torch.ops import _cuda, chain_kernel, kernels, timing
    print(timing.card_line())
    _cuda.build_all(["mask_scan", "chain_scan"])
    text = kernels.to_device(bench.make_text(args.mb << 20), "cuda")
    N = text.numel()
    junk = torch.ones(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    with tempfile.TemporaryDirectory() as d:
        terms = bench.read_terms(bench.make_patfile(d))
    prog = chain_kernel.compile_chain(terms, np.arange(256, dtype=np.uint8))
    if prog is None:
        raise RuntimeError("compile_chain refused the %d patterns"
                           % len(terms))
    p = chain_kernel.device_program(prog, "cuda")
    rows = {}
    for name, D in (("k2", 2), ("exact_k0", 0)):
        m, W, L = bench.mask_machine("matching", D, None, "cuda")
        rows[name] = (lambda m=m, W=W, L=L:
                      kernels.mask_scan(text, m, W, L))
    rows["f100_chain_kernel"] = lambda: chain_kernel.chain_scan(text, p)
    out = {}
    for name, fn in rows.items():
        t = warm_cold_ms(fn, junk.sum, args.reps)
        r = {kind: {"ms": statistics.median(v), "min_ms": min(v),
                    "max_ms": max(v)} for kind, v in t.items()}
        r["cold_over_warm"] = r["cold"]["ms"] / r["warm"]["ms"]
        r["bytes_ms"] = N / timing.HBM_BYTES_PER_S * 1e3
        out[name] = r
        print("l2: %-17s %d MB: warm %.4f ms (%.4f-%.4f), cold %.4f ms "
              "(%.4f-%.4f), cold/warm %.4f, text over HBM %.4f ms"
              % (name, args.mb, r["warm"]["ms"], r["warm"]["min_ms"],
                 r["warm"]["max_ms"], r["cold"]["ms"], r["cold"]["min_ms"],
                 r["cold"]["max_ms"], r["cold_over_warm"], r["bytes_ms"]))
    print(json.dumps({"card": timing.card_line(), "mb": args.mb,
                      "reps": args.reps, "rows": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
