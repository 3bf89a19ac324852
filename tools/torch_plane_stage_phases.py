#!/usr/bin/env python3
"""Where the time of event_pairs' and record_verdicts' one launch goes, on
one CUDA GPU.

    python3 tools/torch_plane_stage_phases.py [--seed N] [--reps 20]

Builds csrc/event_pairs.cu and csrc/record_verdicts.cu into
build/kernels/phases/ with a stamp of %globaltimer by each block's first
thread at its phase boundaries: after it reads the active planes, before
and after the grid sync, after record_verdicts' block and warp prefixes,
and at its end.  The stamps are cut into the source by its text, so a
change to a kernel that moves a cut makes this tool fail, not mislead.
Each build runs through the port's own wrappers (ops/kernels.py, its
library swapped in) at chip_smoke's shapes: event_pairs over the planes
of configs 1 and 2 at 32 MB and 100 MB of the main-path corpus,
record_verdicts over config 2's; its output is held bit for bit to the
plain version, and it is timed with timing.time_kernel beside the
unstamped kernel.  Per shape it prints the ms a launch of both builds
and, from the last stamped launch, ms from the first block's start: the
spread of the starts, the end of phase 1 (latest block), the grid sync's
release (earliest and latest), record_verdicts' prefixes done (latest)
and the end (latest).  The first line is the card's name and power
limit.  Exits non-zero without a CUDA device, on a failed build or on a
mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STAMPS = 5
MAX_BLOCKS = 4096
STAMP_CODE = r'''
__device__ unsigned long long g_stamps[%d][%d];
__device__ __forceinline__ void stamp(int k) {
    if (threadIdx.x == 0) {
        unsigned long long t;
        asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
        g_stamps[k][blockIdx.x] = t;
    }
}
extern "C" int stage_stamps(unsigned long long* out) {
    return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
''' % (STAMPS, MAX_BLOCKS)


def _cut(src: str, old: str, new: str, name: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError("%s.cu no longer holds %r once" % (name, old))
    return src.replace(old, new)


def stamped(name: str, src: str) -> str:
    """The source with stamp(k) at the phase boundaries: 0 after the
    active planes, 1 before the grid sync, 2 after it, 4 after
    record_verdicts' prefixes, 3 at the kernel's end."""
    src = _cut(src, '#include "plane_words.cuh"\n',
               '#include "plane_words.cuh"\n' + STAMP_CODE, name)
    load = "load_active(p, a);" if name == "event_pairs" \
        else "load_active(p.pl, a);"
    src = _cut(src, load, load + " stamp(0);", name)
    src = _cut(src, "    cg::this_grid().sync();\n",
               "    stamp(1);\n    cg::this_grid().sync();\n    stamp(2);\n",
               name)
    if name == "record_verdicts":
        src = _cut(src, "    // each lane's words again",
                   "    stamp(4);\n    // each lane's words again", name)
    end = "\n}\n\n// The instantiation of a launch"
    return _cut(src, end, "\n    stamp(3);\n}\n\n// The instantiation of a "
                "launch", name)


def build(name: str) -> str:
    """The stamped library of csrc/<name>.cu."""
    from agrep_tpu_torch.ops import _cuda
    out = os.path.join(_cuda.BUILD_DIR, "phases")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(_cuda.CSRC, name + ".cu")) as f:
        src = stamped(name, f.read())
    path = os.path.join(out, name + "_stamped.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = path[:-3] + ".so"
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I",
                           _cuda.CSRC, "-shared", "-o", lib, path],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError("nvcc failed on %s:\n%s"
                           % (path, proc.stdout + proc.stderr))
    return lib


def use(name: str, lib):
    """Make the port's wrappers launch lib's kernels (None: the built
    library of csrc/<name>.cu)."""
    from agrep_tpu_torch.ops import _cuda, kernels
    _cuda._libs.pop(name, None)
    if lib is not None:
        _cuda._libs[name] = lib
    kernels._pairs_geometry.cache_clear()
    kernels._records_geometry.cache_clear()


def shapes(cs, seed: int, device: str = "cuda"):
    """(stage, name, planes, vals, W, N, consts) of every timed shape."""
    from agrep_tpu_torch.compile.query import compile_query
    from agrep_tpu_torch.ops import kernels
    from agrep_tpu_torch.ops.scan import DEFAULT_TILE as L
    from agrep_tpu_torch.options import parse_args
    corpus = cs.make_corpus(100 << 20, seed)
    out = []
    for cname, argv in cs.CONFIGS[:2]:
        opts, pattern, _ = parse_args(argv + ["x"])
        q = compile_query(pattern, opts)
        if q.engine_class == "sgrep":
            table, consts, variant, costs = (q.sg_mask, q.sg_consts,
                                             "sgrep", None)
        else:
            table, consts, variant, costs = (q.folded_mask, q.consts,
                                             "bitap", q.costs)
        m = kernels.machine_from_arrays(table, consts, q.D, variant, costs,
                                        device)
        W = cs.halo(consts, q.D, L)
        for mb in (32, 100):
            text = kernels.to_device(corpus[:mb << 20], device)
            planes = kernels.mask_scan(text, m, W, L)
            vals = cs.pairs_vals(m, device)
            name = "%s %d MB" % (cname, mb)
            out.append(("event_pairs", name, planes, vals, W, text.numel(),
                        consts))
            if variant == "bitap":
                out.append(("record_verdicts", name, planes, vals, W,
                            text.numel(), consts))
    return out


def run(stage, planes, vals, W, N, consts, cs):
    """(launch function, grid, max |kernel - plain|) of one shape with
    the library in use."""
    from agrep_tpu_torch.ops import kernels
    from agrep_tpu_torch.ops.scan import DEFAULT_TILE as L
    if stage == "event_pairs":
        got = kernels.event_pairs(planes, vals, W, L, N, 0)
        diff = cs._pairs_diff(got, kernels.event_pairs_reference(
            planes, vals, W, L, N, 0))
        return (lambda: kernels.pairs_passes(planes, vals, W, L, N, 0,
                                             *got),
                kernels.pairs_grid(N, 0, planes.shape[0], planes.device)[0],
                diff)
    args = (W, L, N, 0, int(consts["endpos"]), int(consts["d_endpos"]), -1,
            False, False, 0)
    got = kernels.record_verdicts(planes, vals, *args)
    diff = cs._rows_diff(got, kernels.record_verdicts_reference(
        planes, vals, *args))
    return (lambda: kernels.records_passes(planes, vals, *args, got[0]),
            kernels.records_grid(N, 0, planes.shape[0], planes.device)[0],
            diff)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_plane_stage_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from agrep_tpu_torch.ops import _cuda, timing
    print(timing.card_line())
    libs = {n: ctypes.CDLL(build(n)) for n in ("event_pairs",
                                               "record_verdicts")}
    _cuda.build_all(list(libs))
    failed = []
    for stage, name, planes, vals, W, N, consts in shapes(cs, args.seed):
        use(stage, None)
        fn, grid, diff = run(stage, planes, vals, W, N, consts, cs)
        plain_ms = timing.time_kernel(fn, args.reps)
        use(stage, libs[stage])
        fn, grid, sdiff = run(stage, planes, vals, W, N, consts, cs)
        ms = timing.time_kernel(fn, args.reps)
        fn()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (STAMPS * MAX_BLOCKS))()
        _cuda.check(libs[stage], stage, libs[stage].stage_stamps(buf),
                    "stamps")
        t = np.frombuffer(buf, dtype=np.uint64).reshape(
            STAMPS, MAX_BLOCKS)[:, :grid].astype(np.int64)
        t = (t - t[0].min()) / 1e6
        use(stage, None)
        if diff or sdiff:
            failed.append((stage, name, diff, sdiff))
        print("phases: %-15s %-13s grid=%d: %.4f ms a launch (stamped "
              "%.4f); from the first block's start: starts spread %.4f, "
              "phase 1 ends %.4f, grid sync releases %.4f-%.4f,%s end %.4f "
              "ms" % (stage, name, grid, plain_ms, ms, t[0].max(),
                      t[1].max(), t[2].min(), t[2].max(),
                      " prefixes done %.4f," % t[4].max()
                      if stage == "record_verdicts" else "", t[3].max()),
              flush=True)
    print("card: %s" % timing.card_line())
    if failed:
        print("torch_plane_stage_phases: outputs differ from the plain "
              "versions: %s" % failed, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
