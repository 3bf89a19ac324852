#!/usr/bin/env python3
"""Time the mask-machine kernel (csrc/mask_scan.cu) alone on one CUDA GPU.

    python3 tools/torch_mask_scan_time.py [--seed N] [--mb 100] [--reps 20]

Builds only mask_scan, then at the five shapes the main path gives it --
configs 1-3 on one 32 MB chunk of chip_smoke's corpus, memagrep's whole
100 MB buffer, and bool5m's packed term words (two hit planes) over the
100 MB records corpus -- holds the kernel's planes bit for bit against
mask_scan_reference for every candidate launch (sub-tiles a tile s,
tiles a block) and times each with CUDA events (one warm-up launch, then
--reps launches), printing ms per launch and the share of
timing.bound().  The row the wrapper's own choice (choose_split)
takes is marked.  The first line is the card's name and power limit.
Candidates the launcher refuses (too many threads or too much shared
memory a block, a split without a plan) are listed as refused.  Exits
non-zero without a CUDA device or on any mismatch.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CANDIDATE_SPLITS = (1, 2, 4, 8, 16)
CANDIDATE_TPB = (16, 32, 64, 128, 256)


def shapes(mb: int, seed: int, device: str):
    """(name, text on the card, machine, W, L) of the five main-path
    launches."""
    import numpy as np

    import chip_smoke
    from agrep_tpu_torch.compile.multi import pack_terms
    from agrep_tpu_torch.compile.query import compile_query
    from agrep_tpu_torch.ops import kernels
    from agrep_tpu_torch.ops import scan as scan_ops
    from agrep_tpu_torch.options import parse_args
    L = scan_ops.DEFAULT_TILE
    corpus = chip_smoke.make_corpus(mb << 20, seed)
    chunk = kernels.to_device(corpus[:scan_ops.STREAM_CHUNK], device)
    mem = kernels.to_device(
        np.frombuffer(b"\n" + corpus.tobytes(), np.uint8), device)
    out = []
    for name, argv in chip_smoke.CONFIGS + [("memagrep",
                                             chip_smoke.CONFIGS[0][1])]:
        opts, pattern, _ = parse_args(argv + ["x"])
        q = compile_query(pattern, opts)
        if q.engine_class == "sgrep":
            args = (q.sg_mask, q.sg_consts, q.D, "sgrep", None)
        else:
            args = (q.folded_mask, q.consts, q.D, "bitap", q.costs)
        m = kernels.machine_from_arrays(*args, device=device)
        out.append((name, mem if name == "memagrep" else chunk, m,
                    chip_smoke.halo(args[1], q.D, L), L))
    # bool5m: 'hello;matching,<136 classes>' past the chain caps; the
    # long term goes to the host, the other two to one packed word (two
    # hit bits)
    records = kernels.to_device(chip_smoke.make_records(corpus, seed),
                                device)
    groups, _ = pack_terms([b"hello", b"matching",
                            os.fsencode(chip_smoke.WIDE_TERM)],
                           np.arange(256, dtype=np.uint8))
    g = groups[0]
    m = kernels.machine_from_arrays(g.mask, g.consts, 0, "bitap", None,
                                    device)
    out.append(("bool5m", records, m, chip_smoke.halo(g.consts, 0, L), L))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mb", type=int, default=100)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_mask_scan_time: no CUDA device", file=sys.stderr)
        return 1
    from agrep_tpu_torch.ops import _cuda, kernels, timing
    print(timing.card_line())
    _cuda.build_all(["mask_scan"])
    log = _cuda.build_logs.get("mask_scan", "")
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log))
    print("build: mask_scan %d kernels, registers max %s, spill bytes %d"
          % (len(regs), max(regs, default="n/a (built before)"), spills))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    failed = []
    for name, text, m, W, L in shapes(args.mb, args.seed, "cuda"):
        want = kernels.mask_scan_reference(text, m, W, L)
        bms, by = timing.bound(m, text.numel(), W, L, want)
        T, _ = kernels.geometry(text.numel(), W, L)
        auto = kernels.launch_geometry(text.numel(), m, W, L, "cuda")
        print("shape: %s N=%d T=%d W=%d n_hit=%d D=%d %s; bound %.4f ms "
              "(%s); choose_split -> s=%d tiles/block=%d (%d SMs)"
              % (name, text.numel(), T, W, len(m.hit_masks), m.D,
                 m.variant, bms, by, auto["s"], auto["tiles_per_block"],
                 n_sm))
        for s in CANDIDATE_SPLITS:
            for tpb in CANDIDATE_TPB:
                geo = kernels.launch_geometry(text.numel(), m, W, L, "cuda",
                                              s, tpb)
                try:
                    got = kernels._launch(text, m, W, L, s, tpb)
                except RuntimeError:
                    print("time: %-8s s=%-2d tpb=%-3d refused"
                          % (name, s, tpb))
                    continue
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    failed.append((name, s, tpb))
                    print("time: %s s=%d tpb=%d MISMATCH" % (name, s, tpb))
                    continue
                ms = timing.time_kernel(
                    lambda: kernels._launch(text, m, W, L, s, tpb),
                    args.reps)
                mark = (" <- choose_split" if (s, tpb) == (
                    auto["s"], auto["tiles_per_block"]) else "")
                print("time: %-8s s=%-2d tpb=%-3d threads=%-3d blocks=%-6d "
                      "smem=%-6d %.4f ms  %5.1f %% of bound%s"
                      % (name, s, tpb, geo["threads"], geo["blocks"],
                         geo["smem_bytes"], ms, 100 * bms / ms, mark))
    print("card: %s" % timing.card_line())
    if failed:
        print("mismatches: %s" % failed)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
