#!/usr/bin/env python3
"""Time the regex lanes kernel (csrc/renfa_lanes.cu) and the q-gram
filter (csrc/qgram_filter.cu) alone on one CUDA GPU.

    python3 tools/torch_renfa_lanes_time.py [--seed N] [--mb 100] [--reps 20]

Builds only those two sources, then times renfa_lanes at three shapes --
config 4's machine (`-2 'appro[a-z]*mat(e|ion)'`, M = 15) over the lines
of chip_smoke's first 32 MB chunk (config4) and of its 100 MB memagrep
buffer (memagrep4), and the 29-position machine of chip_smoke's
WIDE_REGEX at D = 2 over the chunk (wide) -- each in the length order
the engine launches them in, for every candidate launch: Next form,
threads a block and blocks an SM, and the launch's fixed cost (one
empty line a thread: the launch and the table fill), by CUDA events and
by torch.profiler's device time; then config 4's pattern at D = 0..4
over the chunk with 512 threads at 1, 2 and all the blocks an SM
holds; and, counted on the host over a sample of config 4's runs of 32
lines (--bank-every), the shared-memory wavefronts a CMask and a table
load take.  Every candidate's verdicts are held
bit for bit against renfa_lines_reference before it is timed (CUDA
events, one warm-up launch, then --reps launches), and each row prints
ms per launch and the share of timing.regex_bound().  It also times
one launch over chip_smoke's LONG_LENS lines (8191, 8192 and 49153
bytes), the long-line tail of one thread a line, and qgram_filter at
config5q's shape (chip_smoke's 400 patterns over its 100 MB records
stream) for every blocks an SM, checked against qgram_reference, beside
timing.qgram_bound().  The wrapper's own choices are marked.  The
first line is the card's name and power limit.  Exits non-zero without a
CUDA device or on any mismatch.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CANDIDATE_THREADS = (128, 256, 512, 1024)
CANDIDATE_BLOCKS = (1, 2, 4, 8)       # and every block an SM holds


def lines_of(buf, device):
    """(text, starts, lens) on the card of the lines of buf up to its
    last newline, in the engine's length order, and the host lens."""
    import numpy as np
    import torch

    from agrep_tpu_torch.ops import kernels
    nls = np.flatnonzero(buf == 0x0A)
    starts = np.concatenate([[0], nls[:-1] + 1]).astype(np.int64)
    lens = (nls - starts).astype(np.int64)
    order = np.argsort(lens, kind="stable")
    return (kernels.to_device(buf[:int(nls[-1]) + 1], device),
            torch.from_numpy(starts[order]).to(device),
            torch.from_numpy(lens[order]).to(device), lens)


def machine(pattern: str, d: int, device):
    """(RegexMachine, post-newline states) of a pattern at D = d."""
    from agrep_tpu_torch.compile.query import compile_query
    from agrep_tpu_torch.ops import renfa, renfa_kernel
    from agrep_tpu_torch.options import Options
    mc = compile_query(pattern, Options(D=d, approx=d > 0)).re_mc
    cont, _ = renfa.step_newline(list(mc["inits"]), int(mc["mask"][0x0A]),
                                 mc)
    return renfa_kernel.machine_from_mc(mc, device), cont


def bank_spread(buf, mc, init, every: int) -> tuple:
    """Shared-memory wavefronts a warp's table load takes in the kernel's
    one-table form, counted on the host over every `every`-th run of 32
    lines of buf (in the engine's length order): a load takes as many
    wavefronts as the most distinct words any one bank serves among the
    warp's active lanes (1 when none conflict).  Returns (mean over the
    CMask loads, mean over the nxt loads, the nxt loads a byte)."""
    import numpy as np

    from agrep_tpu_torch.ops import renfa
    nls = np.flatnonzero(buf == 0x0A)
    starts = np.concatenate([[0], nls[:-1] + 1]).astype(np.int64)
    lens = (nls - starts).astype(np.int64)
    order = np.argsort(lens, kind="stable")
    n_runs = len(order) // 32
    runs = np.arange(0, n_runs, every)
    idx = order[:n_runs * 32].reshape(n_runs, 32)[runs]     # [W, 32]
    st, ln = starts[idx], lens[idx]
    lo_tab, _, _, rel = renfa.next_tables_arrays(mc)
    assert rel <= 15
    tab = lo_tab.astype(np.int64)
    mask = (1 << rel) - 1
    cmask = mc["mask"].astype(np.int64)
    D, init1, noerr = mc["D"], int(mc["init1"]), int(mc["no_err"])
    W = len(runs)

    def waves(words, active):
        """wavefronts of each warp's load of words [W, 32]."""
        w = np.where(active, words, -1)
        w = np.sort(w, axis=1)
        first = np.ones_like(w, dtype=bool)
        first[:, 1:] = w[:, 1:] != w[:, :-1]
        first &= w >= 0
        bank = np.where(first, w % 32, 32)
        counts = np.zeros((W, 33), dtype=np.int64)
        np.add.at(counts, (np.arange(W)[:, None], bank), 1)
        return counts[:, :32].max(axis=1)

    def nxt(x):
        return tab[(x >> 1) & mask]

    s = [np.full((W, 32), int(v), dtype=np.int64) for v in init]
    n = [nxt(v) for v in s]
    cm_w = cm_n = nx_w = nx_n = 0
    for j in range(int(ln.max())):
        act = ln > j
        live = act.any(axis=1)
        b = buf[np.minimum(st + j, len(buf) - 1)].astype(np.int64)
        cm_w += int(waves(b, act)[live].sum())
        cm_n += int(live.sum())
        cm = cmask[b]
        nw = [(n[0] & cm) | (init1 & s[0])]
        nn = [nxt(nw[0])]
        for k in range(1, D + 1):
            nw.append((n[k] & cm) | ((s[k - 1] | n[k - 1] | nn[k - 1])
                                     & noerr) | (init1 & s[k]))
            nn.append(nxt(nw[k]))
        for k in range(D + 1):
            nx_w += int(waves((nw[k] >> 1) & mask, act)[live].sum())
            nx_n += int(live.sum())
            s[k] = np.where(act, nw[k], s[k])
            n[k] = np.where(act, nn[k], n[k])
    return cm_w / cm_n, nx_w / nx_n, D + 1


def time_lanes(args, failed) -> None:
    import numpy as np
    import torch

    import chip_smoke

    from agrep_tpu_torch.ops import renfa_kernel, timing
    from agrep_tpu_torch.ops.scan import STREAM_CHUNK
    corpus = chip_smoke.make_corpus(args.mb << 20, args.seed)
    chunk = lines_of(corpus[:STREAM_CHUNK], "cuda")
    mem = lines_of(np.frombuffer(b"\n" + corpus.tobytes(), np.uint8), "cuda")
    m4, c4 = machine(chip_smoke.REGEX, 2, "cuda")
    mw, cw = machine(chip_smoke.WIDE_REGEX, 2, "cuda")
    for name, (text, st, ln, lens), m, init in (
            ("config4", chunk, m4, c4), ("memagrep4", mem, m4, c4),
            ("wide", chunk, mw, cw)):
        R = len(lens)
        want = renfa_kernel.renfa_lines_reference(text, st, ln, m, init)
        bms, by = timing.regex_bound(m, text.numel(), lens)
        auto = renfa_kernel.launch_geometry(R, m, "cuda")
        print("shape: %s %d B, %d lines, M=%d D=%d; bound %.4f ms (%s); "
              "wrapper: form=%s threads=%d blocks/SM=%d"
              % (name, text.numel(), R, m.M, m.D, bms, by, auto["form"],
                 auto["threads"], auto["blocks_per_sm"]))
        for form in renfa_kernel.forms(m.M):
            for threads in CANDIDATE_THREADS:
                fits = renfa_kernel.launch_geometry(
                    R, m, "cuda", form, threads)["fits_per_sm"]
                for b in sorted({b for b in CANDIDATE_BLOCKS if b < fits}
                                | {fits}):
                    geo = renfa_kernel.launch_geometry(R, m, "cuda", form,
                                                       threads, b)
                    got = renfa_kernel._launch(text, st, ln, m, init, form,
                                               threads, b)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        failed.append((name, form, threads, b))
                        print("time: %s form=%s threads=%d blocks/SM=%d "
                              "MISMATCH" % (name, form, threads, b))
                        continue
                    ms = timing.time_kernel(
                        lambda: renfa_kernel._launch(
                            text, st, ln, m, init, form, threads, b),
                        args.reps)
                    mark = (" <- wrapper" if (form, threads, b) == (
                        auto["form"], auto["threads"],
                        auto["blocks_per_sm"]) else "")
                    print("time: %-9s form=%-6s threads=%-4d blocks/SM=%-2d "
                          "grid=%-5d table=%-6d regs=%-3d %.4f ms  %5.1f %% "
                          "of bound%s"
                          % (name, form, threads, b, geo["grid"],
                             geo["table_bytes"], geo["regs"], ms,
                             100 * bms / ms, mark))
        # the launch's fixed cost: every thread of the wrapper's grid
        # takes one empty line, so the time is the launch and the table
        # fill
        n0 = auto["grid"] * auto["threads"]
        st0 = torch.zeros(n0, dtype=torch.int64, device="cuda")
        ms = timing.time_kernel(
            lambda: renfa_kernel._launch(text, st0, st0, m, init), args.reps)
        dev0 = timing.profiled_ms(
            lambda: renfa_kernel._launch(text, st0, st0, m, init),
            "renfa_lanes_kernel", args.reps)
        dev = timing.profiled_ms(
            lambda: renfa_kernel._launch(text, st, ln, m, init),
            "renfa_lanes_kernel", args.reps)
        print("time: %-9s fixed cost (the wrapper's grid, %d empty lines): "
              "%.4f ms by events, %s by the profiler's device time; the "
              "wrapper's launch %s by the profiler"
              % (name, n0, ms, "not measured" if dev0 is None
                 else "%.4f ms" % dev0,
                 "not measured" if dev is None else "%.4f ms" % dev))
    # config 4's pattern at every D over the chunk, with 512 threads at
    # one and two blocks an SM and at all the SM holds: the time a level
    # of the recurrence adds, and what the block count does to it
    text, st, ln, lens = chunk
    for d in range(renfa_kernel.MAX_D + 1):
        m, init = machine(chip_smoke.REGEX, d, "cuda")
        want = renfa_kernel.renfa_lines_reference(text, st, ln, m, init)
        bms, by = timing.regex_bound(m, text.numel(), lens)
        fits = renfa_kernel.launch_geometry(len(lens), m, "cuda", "one",
                                            512)["fits_per_sm"]
        for b in sorted({1, 2, fits}):
            got = renfa_kernel._launch(text, st, ln, m, init, "one", 512, b)
            if not torch.equal(got, want):
                failed.append(("by D", d, b))
                print("time: config4 D=%d blocks/SM=%d MISMATCH" % (d, b))
                continue
            ms = timing.time_kernel(
                lambda: renfa_kernel._launch(text, st, ln, m, init, "one",
                                             512, b), args.reps)
            print("time: config4 at D=%d form=one threads=512 blocks/SM=%d "
                  "(of %d) %.4f ms  %5.1f %% of its %.4f ms bound (%s)"
                  % (d, b, fits, ms, 100 * bms / ms, bms, by))
    # the bank spread of the table loads at config 4, counted on the host
    from agrep_tpu_torch.compile.query import compile_query
    from agrep_tpu_torch.ops import renfa
    from agrep_tpu_torch.options import Options
    mc = compile_query(chip_smoke.REGEX, Options(D=2, approx=True)).re_mc
    cont, _ = renfa.step_newline(list(mc["inits"]), int(mc["mask"][0x0A]),
                                 mc)
    cmw, nxw, per_byte = bank_spread(corpus[:STREAM_CHUNK], mc, cont,
                                     args.bank_every)
    n_bytes = int(lens.sum())
    waves = n_bytes / 32 * (cmw + per_byte * nxw)
    print("banks: config4 (every %d-th run of 32 lines, counted on the "
          "host): a CMask load takes %.2f shared wavefronts, a table load "
          "%.2f (1 = no conflict), %d table loads a byte; at one wavefront "
          "a clock an SM (132 SMs, 1.98 GHz) the chunk's loads alone take "
          "%.4f ms" % (args.bank_every, cmw, nxw, per_byte,
                       waves / (132 * 1.98e9) * 1e3))
    # the long-line tail: one thread a line
    rng = np.random.default_rng(args.seed)
    t, s = chip_smoke.make_lines(chip_smoke.LONG_LENS, rng)
    lens = np.asarray(chip_smoke.LONG_LENS, dtype=np.int64)
    text, st, ln = (torch.from_numpy(t).cuda(), torch.from_numpy(s).cuda(),
                    torch.from_numpy(lens).cuda())
    want = renfa_kernel.renfa_lines_reference(text, st, ln, m4, c4)
    if not torch.equal(renfa_kernel._launch(text, st, ln, m4, c4), want):
        failed.append(("long",))
        print("time: long MISMATCH")
    else:
        ms = timing.time_kernel(
            lambda: renfa_kernel._launch(text, st, ln, m4, c4), args.reps)
        bms, by = timing.regex_bound(m4, text.numel(), lens)
        print("time: long lines %s, config 4's machine: %.4f ms a launch "
              "(%.2f ns a byte of the longest line); bound %.4f ms (%s)"
              % (list(chip_smoke.LONG_LENS), ms, 1e6 * ms / lens.max(), bms,
                 by))


def time_qgram(args, failed) -> None:
    import numpy as np
    import torch

    import chip_smoke

    from agrep_tpu_torch.compile import multi
    from agrep_tpu_torch.ops import kernels, qgram_kernel, timing
    records = chip_smoke.make_records(
        chip_smoke.make_corpus(args.mb << 20, args.seed), args.seed)
    text = kernels.to_device(records, "cuda")
    pats = chip_smoke.make_patterns(400, args.seed)
    tb = multi.build_qgram_tables(pats, np.arange(256, dtype=np.uint8))
    words = qgram_kernel.words_tensor(multi.member_projection_1024(tb),
                                      "cuda")
    N = text.numel()
    want = qgram_kernel.qgram_reference(text, words)
    bms, by = timing.qgram_bound(N)
    auto = qgram_kernel.launch_geometry(N, "cuda")
    print("shape: config5q %d B, 400 patterns; bound %.4f ms (%s); wrapper: "
          "threads=%d blocks/SM=%d" % (N, bms, by, auto["threads"],
                                       auto["blocks_per_sm"]))
    fits = auto["fits_per_sm"]
    for b in sorted({b for b in CANDIDATE_BLOCKS if b < fits} | {fits}):
        got = qgram_kernel._launch(text, words, b)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            failed.append(("config5q", b))
            print("time: config5q blocks/SM=%d MISMATCH" % b)
            continue
        ms = timing.time_kernel(
            lambda: qgram_kernel._launch(text, words, b), args.reps)
        if b == auto["blocks_per_sm"]:
            dev = timing.profiled_ms(
                lambda: qgram_kernel._launch(text, words, b),
                "qgram_filter_kernel", args.reps)
            print("time: config5q  qgram_filter wrapper's launch by the "
                  "profiler's device time: %s" % (
                      "not measured" if dev is None else "%.4f ms" % dev))
        geo = qgram_kernel.launch_geometry(N, "cuda", b)
        print("time: config5q  qgram_filter blocks/SM=%-2d grid=%-5d %.4f ms"
              "  %5.1f %% of bound%s"
              % (b, geo["grid"], ms, 100 * bms / ms,
                 " <- wrapper" if b == auto["blocks_per_sm"] else ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mb", type=int, default=100)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--bank-every", type=int, default=8,
                    help="count the bank spread on every n-th run")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_renfa_lanes_time: no CUDA device", file=sys.stderr)
        return 1
    from agrep_tpu_torch.ops import _cuda, timing
    print(timing.card_line())
    _cuda.build_all(["renfa_lanes", "qgram_filter"])
    for name in ("renfa_lanes", "qgram_filter"):
        log = _cuda.build_logs.get(name, "")
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log))
        print("build: %s %d kernels, registers max %s, spill bytes %d"
              % (name, len(regs), max(regs, default="n/a (built before)"),
                 spills))
    failed: list = []
    time_lanes(args, failed)
    time_qgram(args, failed)
    print("card: %s" % timing.card_line())
    if failed:
        print("mismatches: %s" % failed)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
