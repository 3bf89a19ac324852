#!/usr/bin/env python3
"""Where the time of line_terms' one launch goes, on one CUDA GPU.

    python3 tools/torch_terms_phases.py [TREE ...] [--seed N] [--mb 40]
                                        [--reps 20]

Each TREE is the root of a checkout holding agrep_tpu_torch/ (an
unpacked `git archive` of a commit; default: this checkout), run in a
process of its own in the order given.  A run builds the tree's
csrc/line_terms.cu into build/kernels/phases/ with stamps added, makes
chip_smoke's corpus from --seed (--mb MB; the first 32 MB chunk is the
same at any size past 32), records the four streamed booleans' first
line_terms call (chip_smoke.terms_inputs: bools, boolsc, boolst,
boolsq), and at each runs the tree's own wrapper with the stamped
library swapped in: its output is held bit for bit to
line_terms_reference, and both builds are timed with this checkout's
timing.time_kernel over the tree's `_terms_call`.

The stamps follow the tree's design.  A cooperative launch (the source
calls cudaLaunchCooperativeKernel) is cut by its text: each block's
first thread stamps %globaltimer at its start, the end of phase 1 (the
summaries), the release of the first grid sync, block 0's end of its
scan, the release of the second, the end of phase 3 (the fire counts),
and for the rows form the release of the third and fourth syncs (block
0's count scan between them) and the end of phase 4.  A look-back
launch carries its own hooks (LT_STAMP, LT_SPAN_BEGIN/END, LT_TICK,
empty unless defined, stamping for the first compute thread and the
look-back warp's first): each block's start and the look-back warp's
end by %globaltimer, and summed over its tiles by clock64 -- converted
by the SM's clock rate -- the compute warps' whole tile and, within it,
their wait for its staged copy, their verify and fold up to its
aggregate (and within it the words' newline and candidate masks, the
compaction and verification, the words' fold and the scan), their wait
for a free stash and their writes to it, the next tile's copies, ticket
and ragged loads, and the ragged stores and the stash's hand-over; the
look-back warp's look-back (its wait included) and its rows; and the
tiles the block took.

The first line is the card's name and power limit; then one `phases:`
line a run and input.  Exits non-zero without a CUDA device, on a
failed build or on a mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STAMPS = 16
MAX_BLOCKS = 8192
STAMP_CODE = r'''#include <cuda_runtime.h>
__device__ long long g_stamps[%d][%d];
__device__ __forceinline__ void stamp(int k) {
    if (threadIdx.x == 0) {
        long long t;
        asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
        g_stamps[k][blockIdx.x] = t;
    }
}
__device__ __forceinline__ void stamp_any(int k) {
    long long t;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
    g_stamps[k][blockIdx.x] = t;
}
__device__ __forceinline__ void span(int k, long long t0) {
    g_stamps[k][blockIdx.x] += clock64() - t0;
}
#define LT_STAMP(k) \
    do { if (line_terms::lead_thread()) stamp_any(k); } while (0)
#define LT_SPAN_BEGIN(v) const long long v = clock64()
#define LT_SPAN_END(k, v) \
    do { if (line_terms::lead_thread()) span(k, v); } while (0)
#define LT_TICK(k) \
    do { if (threadIdx.x == 0) g_stamps[k][blockIdx.x] += 1; } while (0)
extern "C" int stage_stamps(long long* out) {
    return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
extern "C" int stage_reset() {
    void* p;
    cudaError_t e = cudaGetSymbolAddress(&p, g_stamps);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaMemset(p, 0, sizeof(g_stamps));
}
extern "C" int stage_clock_khz(int* khz) {
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaDeviceGetAttribute(khz, cudaDevAttrClockRate, dev);
}
''' % (STAMPS, MAX_BLOCKS)

# the cooperative design's stamps, cut in by text: (old, new, count)
HEAD = ("    load_shared(p, sh);\n    summarize(p, sh, sc, ws);\n"
        "    grid.sync();\n    if (blockIdx.x == 0) scan_summaries(p, sc);\n"
        "    grid.sync();\n")
COOPERATIVE_CUTS = [
    (HEAD, "    stamp(0);\n    load_shared(p, sh);\n"
     "    summarize(p, sh, sc, ws);\n    stamp(1);\n    grid.sync();\n"
     "    stamp(2);\n    if (blockIdx.x == 0) scan_summaries(p, sc);\n"
     "    stamp(3);\n    grid.sync();\n    stamp(4);\n", 2),
    ("(unsigned long long)t);\n    }\n}",
     "(unsigned long long)t);\n    }\n    stamp(5);\n}", 1),
    ("        sc.count[blockIdx.x] = t;\n    }\n    grid.sync();\n"
     "    if (blockIdx.x == 0) scan_counts(p, sc);\n    grid.sync();\n",
     "        sc.count[blockIdx.x] = t;\n    }\n    stamp(5);\n"
     "    grid.sync();\n    stamp(6);\n"
     "    if (blockIdx.x == 0) scan_counts(p, sc);\n    grid.sync();\n"
     "    stamp(7);\n", 1),
    ("        return (long long)c;\n    });\n}",
     "        return (long long)c;\n    });\n    stamp(8);\n}", 1),
]


def design(src: str) -> str:
    return ("cooperative" if "cudaLaunchCooperativeKernel" in src
            else "look-back")


def stamped(src: str) -> str:
    """The source with STAMP_CODE ahead of it and, for a cooperative
    launch, stamp(k) cut in at its phase boundaries (a cut that no longer
    matches raises)."""
    if design(src) == "cooperative":
        for old, new, n in COOPERATIVE_CUTS:
            if src.count(old) != n:
                raise RuntimeError("line_terms.cu no longer holds %r %d "
                                   "times" % (old, n))
            src = src.replace(old, new)
    elif "LT_SPAN_END" not in src:
        raise RuntimeError("line_terms.cu has neither a cooperative launch "
                           "nor the LT_* hooks")
    return STAMP_CODE + src


def build(tree: str) -> tuple:
    """(the stamped library of tree's csrc/line_terms.cu, its design)."""
    from agrep_tpu_torch.ops import _cuda
    out = os.path.join(_cuda.BUILD_DIR, "phases")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(_cuda.CSRC, "line_terms.cu")) as f:
        src = f.read()
    path = os.path.join(out, "line_terms_stamped.cu")
    with open(path, "w") as f:
        f.write(stamped(src))
    lib = path[:-3] + ".so"
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I",
                           _cuda.CSRC, "-shared", "-o", lib, path],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError("nvcc failed on %s:\n%s"
                           % (path, proc.stdout + proc.stderr))
    return ctypes.CDLL(lib), design(src)


def use(lib) -> None:
    """Make the tree's wrapper launch lib's kernel (None: the built
    library of csrc/line_terms.cu)."""
    from agrep_tpu_torch.ops import _cuda, chain_kernel
    _cuda._libs.pop("line_terms", None)
    if lib is not None:
        _cuda._libs["line_terms"] = lib
    for name in ("_terms_geometry",):
        fn = getattr(chain_kernel, name, None)
        if fn is not None:
            fn.cache_clear()


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def split(t, how: str, grid: int, khz: int) -> dict:
    """The phase split of one stamped launch (t: int64 [STAMPS, grid])."""
    import numpy as np
    if how == "cooperative":
        t0 = t[0].min()
        ms = (t - t0) / 1e6
        out = {"starts_spread": ms[0].max(), "phase1_end": ms[1].max(),
               "sync1_release": [ms[2].min(), ms[2].max()],
               "block0_scan_end": ms[3][0],
               "sync2_release": [ms[4].min(), ms[4].max()],
               "phase3_end": ms[5].max()}
        if t[8].max() > 0:
            out.update(sync3_release=ms[6].max(), sync4_release=ms[7].max(),
                       end=ms[8].max())
        else:
            out["end"] = ms[5].max()
        return {k: (float(v) if np.isscalar(v) else [float(x) for x in v])
                for k, v in out.items()}
    t0 = t[0].min()
    tiles = int(t[6].sum())
    us = 1e3 / khz                      # µs a cycle: cycles / (kHz) = ms

    def per_tile(k):
        return float(t[k].sum() * us / max(tiles, 1))
    return {"tiles": tiles, "starts_spread": float((t[0].max() - t0) / 1e6),
            "end": float((t[1].max() - t0) / 1e6),
            "busiest_block_end": float((t[1] - t[0]).max() / 1e6),
            "us_a_tile": {"compute": per_tile(8),
                          "staging_wait": per_tile(2),
                          "verify_and_fold": per_tile(3),
                          "words": per_tile(9),
                          "compact_and_verify": per_tile(10),
                          "word_fold": per_tile(11),
                          "scan": per_tile(12),
                          "stash_wait": per_tile(7),
                          "stash_write": per_tile(15),
                          "issue_and_ragged_loads": per_tile(13),
                          "ragged_stores_and_hand_over": per_tile(14),
                          "look_back": per_tile(4),
                          "rows": per_tile(5)}}


def child(tree: str, args) -> int:
    """One tree: every input's split and times; one JSON line."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    cs = _load("phases_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    timing = _load("phases_timing", os.path.join(
        REPO, "agrep_tpu_torch", "ops", "timing.py"))
    import tempfile

    import numpy as np
    import torch

    import agrep_tpu_torch
    from agrep_tpu_torch.ops import _cuda
    from agrep_tpu_torch.ops import chain_kernel as ck
    if os.path.dirname(os.path.abspath(agrep_tpu_torch.__file__)) != \
            os.path.join(tree, "agrep_tpu_torch"):
        raise AssertionError("agrep_tpu_torch imported from %s, not %s"
                             % (agrep_tpu_torch.__file__, tree))
    _cuda.build_all(["chain_scan", "qgram_filter", "line_terms"])
    lib, how = build(tree)
    khz = ctypes.c_int()
    _cuda.check(lib, "line_terms", lib.stage_clock_khz(ctypes.byref(khz)),
                "clock rate")
    build_dir = os.path.join(tree, "build")
    os.makedirs(build_dir, exist_ok=True)
    res = {}
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        path = os.path.join(tmp, "corpus.txt")
        cs.make_corpus(args.mb << 20, args.seed).tofile(path)
        inputs = cs.terms_inputs(path)
    for name, (a, kw) in inputs.items():
        text, plane, shift, tables = a
        kw = dict(kw)
        count_only = kw.pop("count_only")
        body = kw["body"]
        want = ck.line_terms_reference(text, plane, shift, tables,
                                       count_only=count_only, **kw)
        out = None if count_only else torch.empty(
            (ck.terms_capacity(body, tables.min_len), 2),
            dtype=torch.int64, device=text.device)

        def launch():
            return ck._terms_call(text, plane, shift, tables, body,
                                  kw["carry"], kw["begin"], kw["cap_e"],
                                  kw["last"], kw["base"], out, grid)
        row = {"count_only": count_only, "K": want[1]}
        for label, lb in (("unstamped", None), ("stamped", lib)):
            use(lb)
            grid = ck.terms_grid(body, not count_only, text.device)
            got = ck.line_terms(text, plane, shift, tables,
                                count_only=count_only, **kw)
            diff = cs._terms_diff(got, want)
            if diff:
                raise AssertionError("%s %s: line_terms differs from its "
                                     "plain version (%d)"
                                     % (label, name, diff))
            row[label + "_ms"] = timing.time_kernel(launch, args.reps)
            row["grid"] = grid
        _cuda.check(lib, "line_terms", lib.stage_reset(), "stamp reset")
        launch()
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (STAMPS * MAX_BLOCKS))()
        _cuda.check(lib, "line_terms", lib.stage_stamps(buf), "stamps")
        t = np.frombuffer(buf, dtype=np.int64).reshape(
            STAMPS, MAX_BLOCKS)[:, :grid]
        row["split"] = split(t, how, grid, khz.value)
        use(None)
        res[name] = row
    print(json.dumps({"tree": tree, "design": how, "clock_khz": khz.value,
                      "runs": res}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", default=[REPO])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mb", type=int, default=40)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--child", action="store_true",
                    help="run the one tree given in this process")
    args = ap.parse_args(argv)
    if args.child:
        return child(args.trees[0], args)
    import torch
    if not torch.cuda.is_available():
        print("torch_terms_phases: no CUDA device", file=sys.stderr)
        return 1
    timing = _load("phases_timing", os.path.join(
        REPO, "agrep_tpu_torch", "ops", "timing.py"))
    card = timing.card_line()
    print(card)
    for tree in map(os.path.abspath, args.trees):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree,
             "--seed", str(args.seed), "--mb", str(args.mb), "--reps",
             str(args.reps)], capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-8000:])
            print("torch_terms_phases: the run of %s failed (exit %d)"
                  % (tree, proc.returncode), file=sys.stderr)
            return 1
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        for name, r in run["runs"].items():
            print("phases: %s (%s) %-6s %s K=%d grid=%d: %.4f ms a launch "
                  "(stamped %.4f); %s | card: %s"
                  % (os.path.basename(os.path.normpath(tree)),
                     run["design"], name,
                     "count" if r["count_only"] else "rows", r["K"],
                     r["grid"], r["unstamped_ms"], r["stamped_ms"],
                     json.dumps(r["split"]), card), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
