#!/usr/bin/env python3
"""Time the chain kernel (csrc/chain_scan.cu) alone on one CUDA GPU.

    python3 tools/torch_chain_scan_time.py [--seed N] [--mb 100] [--reps 20]

Builds only chain_scan, then at the four shapes the main path gives it --
config 5's 100 patterns over chip_smoke's 100 MB records stream (config5
and config5c), the same through memagrep (the stream behind one newline,
memagrep5), and bool5's two terms over the records stream -- holds the
kernel's plane bit for bit against chain_scan_reference for every
candidate launch (start positions a tile, blocks an SM) and
times each with CUDA events (one warm-up launch, then --reps launches),
printing ms per launch and the share of timing.chain_bound().  The
row of the wrapper's own choice (chain_kernel.TILE, every block an SM
holds) is marked.  The first line is the card's
name and power limit.  Exits non-zero without a CUDA device or on any
mismatch.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CANDIDATE_TILES = (4096, 8192, 16384, 32768)
CANDIDATE_BLOCKS = (1, 2, 4, 8)       # and every block an SM holds


def shapes(mb: int, seed: int, device: str):
    """(name, text on the card, program) of the four main-path
    launches."""
    import numpy as np

    import chip_smoke
    from agrep_tpu_torch.ops import chain_kernel, kernels
    tr = np.arange(256, dtype=np.uint8)
    records = chip_smoke.make_records(chip_smoke.make_corpus(mb << 20, seed),
                                      seed)
    rec = kernels.to_device(records, device)
    mem = kernels.to_device(
        np.frombuffer(b"\n" + records.tobytes(), np.uint8), device)
    p100, p2 = (chain_kernel.device_program(
        chain_kernel.compile_chain(terms, tr), device)
        for terms in (chip_smoke.make_patterns(100, seed),
                      [b"hello", b"lazy"]))
    return [("config5", rec, p100), ("config5c", rec, p100),
            ("memagrep5", mem, p100), ("bool5", rec, p2)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mb", type=int, default=100)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_chain_scan_time: no CUDA device", file=sys.stderr)
        return 1
    from agrep_tpu_torch.ops import _cuda, chain_kernel, timing
    print(timing.card_line())
    _cuda.build_all(["chain_scan"])
    log = _cuda.build_logs.get("chain_scan", "")
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log))
    print("build: chain_scan %d kernels, registers max %s, spill bytes %d"
          % (len(regs), max(regs, default="n/a (built before)"), spills))
    failed = []
    for name, text, p in shapes(args.mb, args.seed, "cuda"):
        N = text.numel()
        want = chain_kernel.chain_scan_reference(text, p)
        bms, by = timing.chain_bound(N)
        auto = chain_kernel.launch_geometry(N, p, "cuda")
        print("shape: %s N=%d, %d terms, %d positions, %d classes, maxlen "
              "%d; bound %.4f ms (%s); wrapper: tile=%d blocks/SM=%d"
              % (name, N, p.n_terms, p.n_pos, p.n_cls, p.maxlen, bms, by,
                 auto["tile"], auto["blocks_per_sm"]))
        for tile in CANDIDATE_TILES:
            fits = chain_kernel.launch_geometry(N, p, "cuda",
                                                tile)["fits_per_sm"]
            for b in sorted({b for b in CANDIDATE_BLOCKS if b < fits}
                            | {fits}):
                geo = chain_kernel.launch_geometry(N, p, "cuda", tile, b)
                got = chain_kernel._launch(text, p, tile, b)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    failed.append((name, tile, b))
                    print("time: %s tile=%d blocks/SM=%d MISMATCH"
                          % (name, tile, b))
                    continue
                ms = timing.time_kernel(
                    lambda: chain_kernel._launch(text, p, tile, b), args.reps)
                mark = (" <- wrapper" if (tile, b) == (
                    auto["tile"], auto["blocks_per_sm"]) else "")
                print("time: %-9s tile=%-5d blocks/SM=%-2d grid=%-5d "
                      "smem=%-6d %.4f ms  %5.1f %% of bound%s"
                      % (name, tile, b, geo["grid"], geo["smem_bytes"], ms,
                         100 * bms / ms, mark))
    print("card: %s" % timing.card_line())
    if failed:
        print("mismatches: %s" % failed)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
