#!/usr/bin/env python3
"""Where the time of agrep_tpu_torch's multi-pattern runs goes, on one GPU.

    python3 tools/torch_mgrep_breakdown.py [--seed N] [--mb 100] [--top 12]
                                           [--routes-only]

Makes chip_smoke.py's config-5 corpus (its lines with a blank line every
8-16 lines) and pattern files from --seed, then:

  * routes: for small term sets (bool5's two terms, two planted terms,
    and -f with 5 and 20 patterns, all over '$$' records) the engine's
    occurrence search (MgrepEngine._all_occurrences) and the whole run
    timed through the chain kernel and through the mask machine's packed
    term words (the route a set past the chain caps takes, forced by
    compiling no chain program); one warm-up run, then one timed run of
    each, outputs compared;
  * unless --routes-only, for each of chip_smoke's config-5 runs
    (config5, config5c, config5c400, config5q, memagrep5, bool5, bool5m)
    on the torch backend and the GPU: one warm-up run, then one timed run (host
    clock, ended by a synchronize); one run under torch.profiler: the
    device time of every CUDA kernel and copy, by name, and their sum
    over the timed wall (the card's busy share); one run under cProfile:
    the --top functions by their own host time.

Prints the card's name and power limit first.  Without a CUDA device it
exits non-zero.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def device_times(prof) -> dict:
    """{name: device ms} of the profiled run's kernels and copies: the
    events that ran on the card, not the host operators that launched
    them (those repeat their children's device time), and not CUPTI's
    own buffer requests.  Kernel names are cut at their argument list."""
    out = {}
    for ev in prof.key_averages():
        if (not str(getattr(ev, "device_type", "")).endswith("CUDA")
                or ev.key == "Activity Buffer Request"):
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            name = ev.key.split("(unsigned")[0].split("<")[0][:60]
            out[name] = out.get(name, 0.0) + us / 1e3
    return out


def compare_routes(sets, run) -> None:
    """Times each (name, argv, n_terms) of sets through the chain kernel
    and through the packed term words: the engine's _all_occurrences
    (summed over its calls) and the whole run, after one warm-up run of
    each route."""
    from agrep_tpu_torch.ops import chain_kernel
    from agrep_tpu_torch.runtime import mgrep
    real_all = mgrep.MgrepEngine._all_occurrences
    real_compile = chain_kernel.compile_chain
    spent = []

    def timed_all(self, stream):
        t0 = time.perf_counter()
        out = real_all(self, stream)
        spent.append(time.perf_counter() - t0)
        return out

    mgrep.MgrepEngine._all_occurrences = timed_all
    try:
        for name, argv, n_terms in sets:
            res = {}
            for route in ("chain", "packed"):
                chain_kernel.compile_chain = (
                    real_compile if route == "chain"
                    else (lambda terms, tr: None))
                launches = dict(chain_kernel.launches)
                run(argv, None)
                spent.clear()
                t0 = time.perf_counter()
                out = run(argv, None)
                wall = time.perf_counter() - t0
                took_chain = chain_kernel.launches != launches
                res[route] = (sum(spent), wall, out, took_chain)
            chain_kernel.compile_chain = real_compile
            if res["chain"][2] != res["packed"][2]:
                raise AssertionError("routes: %s differs between the "
                                     "routes" % name)
            if not res["chain"][3] or res["packed"][3]:
                raise AssertionError("routes: %s did not take the routes "
                                     "asked for" % name)
            print("routes: %-7s %2d terms | _all_occurrences chain %.4f s, "
                  "packed words %.4f s | run wall chain %.3f s, packed "
                  "words %.3f s | outputs equal"
                  % (name, n_terms, res["chain"][0], res["packed"][0],
                     res["chain"][1], res["packed"][1]))
    finally:
        mgrep.MgrepEngine._all_occurrences = real_all
        chain_kernel.compile_chain = real_compile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mb", type=int, default=100)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--routes-only", action="store_true")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_mgrep_breakdown: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from agrep_tpu_torch import api
    from agrep_tpu_torch.ops import _cuda, timing
    from agrep_tpu_torch.ops import scan as scan_ops
    scan_ops.set_backend("torch")
    scan_ops.set_device("cuda")
    print(timing.card_line())
    _cuda.build_all(_cuda.SOURCES)

    corpus = cs.make_corpus(args.mb << 20, args.seed)
    records = cs.make_records(corpus, args.seed)
    pats = cs.make_patterns(400, args.seed)
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        rec = os.path.join(tmp, "records.txt")
        records.tofile(rec)
        files = {k: os.path.join(tmp, "pats%d.txt" % k)
                 for k in (5, 20, 100, 400)}
        for k, f in files.items():
            with open(f, "wb") as fh:
                fh.write(b"".join(w + b"\n" for w in pats[:k]))
        p100, p400 = files[100], files[400]
        p400w = os.path.join(tmp, "pats400w.txt")
        with open(p400w, "wb") as fh:
            fh.write(b"".join(w + b"\n" for w in cs.wide_patterns(pats)))
        c5 = ["-f", p100] + cs.CONFIG5_DELIM
        mem = b"\n" + records.tobytes()
        runs = [("config5", c5 + [rec], None),
                ("config5c", ["-c", "-f", p100, rec], None),
                ("config5c400", ["-c", "-f", p400, rec], None),
                ("config5q", ["-c", "-f", p400w, rec], None),
                ("memagrep5", c5, mem),
                ("bool5", cs.CONFIG5_DELIM + ["hello;lazy", rec], None),
                ("bool5m", cs.CONFIG5_DELIM
                 + ["hello;matching," + cs.WIDE_TERM, rec], None)]

        def run(argv, data):
            buf = io.BytesIO()
            if data is None:
                api.fileagrep(argv, output=buf)
            else:
                api.memagrep(argv, data, output=buf)
            torch.cuda.synchronize()
            return buf.getvalue()

        compare_routes([
            ("bool5", cs.CONFIG5_DELIM + ["hello;lazy", rec], 2),
            ("bool5p", cs.CONFIG5_DELIM + ["hello;matching", rec], 2),
            ("f5", cs.CONFIG5_DELIM + ["-f", files[5], rec], 5),
            ("f20", cs.CONFIG5_DELIM + ["-f", files[20], rec], 20)], run)
        if args.routes_only:
            return 0

        for name, argv, data in runs:
            run(argv, data)
            t0 = time.perf_counter()
            run(argv, data)
            wall = time.perf_counter() - t0
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts,
                                        acc_events=True) as prof:
                run(argv, data)
            dev = device_times(prof)
            busy = sum(dev.values())
            print("%s: wall %.3f s; device time %.3f ms (%.3f %% of the "
                  "wall); by name: %s"
                  % (name, wall, busy, busy / (wall * 1e3) * 100, "; ".join(
                      "%s %.3f ms" % (k, v) for k, v in sorted(
                          dev.items(), key=lambda kv: -kv[1])[:6])))
            pr = cProfile.Profile()
            pr.enable()
            run(argv, data)
            pr.disable()
            st = io.StringIO()
            pstats.Stats(pr, stream=st).sort_stats("tottime") \
                .print_stats(args.top)
            lines = [ln.replace(REPO + os.sep, "")
                     for ln in st.getvalue().splitlines() if ln.strip()]
            print("%s: cProfile, top %d by own host time:\n%s"
                  % (name, args.top, "\n".join(lines[-args.top - 1:])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
