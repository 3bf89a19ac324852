#!/usr/bin/env python3
"""Time the four CUDA kernels of two or more checkouts of the port with
one method, each checkout in a process of its own.

    python3 tools/torch_kernel_ab.py TREE [TREE ...] [--seed N] [--mb 100]
                                     [--reps 20]

Each TREE is the root of a checkout holding agrep_tpu_torch/ (an
unpacked `git archive` of a commit, say); the trees run in the order
given, so `A B B A` times A, B, B, A.  Each run builds its tree's
kernels from its own csrc/ into its own build/kernels/, makes
chip_smoke's corpora from --seed, and times every kernel at the main
path's shapes through that tree's own `_launch`: mask_scan at configs
1-3's 32 MB chunk, the 100 MB memagrep buffer and bool5m (its inputs
recorded from the main path's own run); renfa_lanes at config 4's
chunk and the memagrep buffer; chain_scan at config 5's records stream
(config5), behind one newline (memagrep5) and with bool5's two terms;
qgram_filter at config5q's.  Every time comes from this checkout's
timing.time_kernel and timing.profiled_ms (agrep_tpu_torch/ops/timing.py)
-- CUDA events over --reps launches after the card's checked spin, and
torch.profiler's device time -- whatever the tree's own timer does.  The trees'
outputs at each shape must be equal (sha256 of the output bytes); the
plain versions are not run here (chip_smoke holds each kernel to its
plain version).  The first line is the card's name and power limit;
then one `ab:` line a shape with every run's events and profiler ms,
one `libs:` line a run with the library files it built, and a last JSON
line with every number.  Exits non-zero without a CUDA device, when a
run fails or when the trees' outputs differ.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("mask_scan", "renfa_lanes", "chain_scan", "qgram_filter")


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _helpers():
    """(chip_smoke, timing) of this checkout, loaded by path under other
    names, so that a tree's own chip_smoke.py and timing module are
    never the ones used and a tree without them still runs."""
    return (_load("ab_chip_smoke", os.path.join(REPO, "chip_smoke.py")),
            _load("ab_timing", os.path.join(REPO, "agrep_tpu_torch", "ops",
                                            "timing.py")))


def shapes(cs, mb: int, seed: int, tmp: str, device: str = "cuda"):
    """(name, kernel, launch function of no arguments) of every
    main-path shape, with the tree's agrep_tpu_torch."""
    import io

    import numpy as np
    import torch

    from agrep_tpu_torch import api
    from agrep_tpu_torch.compile import multi
    from agrep_tpu_torch.compile.query import compile_query
    from agrep_tpu_torch.ops import chain_kernel, kernels, qgram_kernel
    from agrep_tpu_torch.ops import renfa, renfa_kernel
    from agrep_tpu_torch.ops import scan as scan_ops
    from agrep_tpu_torch.options import parse_args
    corpus = cs.make_corpus(mb << 20, seed)
    records = cs.make_records(corpus, seed)
    pats = cs.make_patterns(400, seed)
    chunk = kernels.to_device(corpus[:scan_ops.STREAM_CHUNK], device)
    mem_buf = np.frombuffer(b"\n" + corpus.tobytes(), np.uint8)
    mem = kernels.to_device(mem_buf, device)
    out = []
    for name, argv in cs.CONFIGS + [("memagrep", cs.CONFIGS[0][1])]:
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
        L = scan_ops.DEFAULT_TILE
        W = cs.halo(consts, q.D, L)
        t = mem if name == "memagrep" else chunk
        out.append((name, "mask_scan",
                    lambda t=t, m=m, W=W, L=L: kernels._launch(t, m, W, L)))
    # bool5m: the mask machine's packed term words, as the main path
    # gives them to the wrapper
    rec_path = os.path.join(tmp, "records.txt")
    records.tofile(rec_path)
    seen = []
    real = kernels.mask_scan

    def recorder(*args):
        seen.append(args)
        return real(*args)
    scan_ops.set_backend("torch")
    kernels.mask_scan = recorder
    try:
        api.fileagrep(cs.CONFIG5_DELIM + ["hello;matching," + cs.WIDE_TERM,
                                          rec_path], output=io.BytesIO())
    finally:
        kernels.mask_scan = real
    if not seen:
        raise AssertionError("bool5m launched no mask_scan")
    args5m = seen[-1]
    out.append(("bool5m", "mask_scan", lambda: kernels._launch(*args5m)))

    mc = compile_query(cs.REGEX, parse_args(
        cs.REGEX_CONFIGS[0][1] + ["x"])[0]).re_mc
    rm = renfa_kernel.machine_from_mc(mc, device)
    cont, _ = renfa.step_newline(list(mc["inits"]), int(mc["mask"][0x0A]),
                                 mc)
    for name, buf in (("config4", corpus[:scan_ops.STREAM_CHUNK]),
                      ("memagrep4", mem_buf)):
        nls = np.flatnonzero(buf == 0x0A)
        starts = np.concatenate([[0], nls[:-1] + 1]).astype(np.int64)
        lens = (nls - starts).astype(np.int64)
        order = np.argsort(lens, kind="stable")
        seg = kernels.to_device(buf[:int(nls[-1]) + 1], device)
        st = torch.from_numpy(starts[order]).to(device)
        ln = torch.from_numpy(lens[order]).to(device)
        out.append((name, "renfa_lanes",
                    lambda seg=seg, st=st, ln=ln: renfa_kernel._launch(
                        seg, st, ln, rm, cont)))

    tr = np.arange(256, dtype=np.uint8)
    rec = kernels.to_device(records, device)
    rec_mem = kernels.to_device(
        np.frombuffer(b"\n" + records.tobytes(), np.uint8), device)
    p100, p2 = (chain_kernel.device_program(
        chain_kernel.compile_chain(terms, tr), device)
        for terms in (pats[:100], [b"hello", b"lazy"]))
    for name, t, p in (("config5", rec, p100), ("memagrep5", rec_mem, p100),
                       ("bool5", rec, p2)):
        out.append((name, "chain_scan",
                    lambda t=t, p=p: chain_kernel._launch(t, p)))
    words = qgram_kernel.words_tensor(
        multi.member_projection_1024(multi.build_qgram_tables(
            cs.wide_patterns(pats), tr)), device)
    out.append(("config5q", "qgram_filter",
                lambda: qgram_kernel._launch(rec, words)))
    return out


def child(tree: str, args) -> int:
    """One run: time every shape with tree's package; prints one JSON
    line."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    cs, timing = _helpers()
    import tempfile

    import torch

    import agrep_tpu_torch
    from agrep_tpu_torch.ops import _cuda
    if os.path.dirname(os.path.abspath(agrep_tpu_torch.__file__)) != \
            os.path.join(tree, "agrep_tpu_torch"):
        raise AssertionError("agrep_tpu_torch imported from %s, not %s"
                             % (agrep_tpu_torch.__file__, tree))
    paths = _cuda.build_all(list(KERNELS))
    build = os.path.join(tree, "build")
    os.makedirs(build, exist_ok=True)
    res = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        for name, kname, fn in shapes(cs, args.mb, args.seed, tmp):
            got = fn().contiguous()
            torch.cuda.synchronize()
            if got.dtype == torch.uint32:
                got = got.view(torch.int32)
            digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
            res[name] = {
                "kernel": kname, "bytes": int(got.numel()
                                              * got.element_size()),
                "sha256": digest,
                "ms": timing.time_kernel(fn, args.reps),
                "device_ms": timing.profiled_ms(fn, kname + "_kernel",
                                                args.reps)}
    print(json.dumps({"tree": tree, "times": res, "libs": {
        k: os.path.basename(v) for k, v in paths.items()}}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="checkout roots, in order")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mb", type=int, default=100)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--child", action="store_true",
                    help="time the one tree given in this process")
    args = ap.parse_args(argv)
    if args.child:
        return child(args.trees[0], args)

    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    timing = _helpers()[1]
    print(timing.card_line())
    runs = []
    for tree in map(os.path.abspath, args.trees):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree,
             "--seed", str(args.seed), "--mb", str(args.mb), "--reps",
             str(args.reps)], capture_output=True, text=True,
            cwd=os.path.abspath(tree))
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-8000:])
            print("torch_kernel_ab: the run of %s failed (exit %d)"
                  % (tree, proc.returncode), file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print("libs: run %d %s %s" % (len(runs), tree,
                                      " ".join(runs[-1]["libs"].values())))
    differ = []
    for name, r0 in runs[0]["times"].items():
        cells = []
        for i, r in enumerate(runs):
            t = r["times"][name]
            if t["sha256"] != r0["sha256"]:
                differ.append((name, i + 1))
            cells.append("%s %.4f/%s" % (
                os.path.basename(os.path.normpath(r["tree"])), t["ms"],
                "n/a" if t["device_ms"] is None
                else "%.4f" % t["device_ms"]))
        print("ab: %-12s %-9s ms a launch, events/profiler: %s"
              % (r0["kernel"], name, " | ".join(cells)))
    print("card: %s" % timing.card_line())
    print(json.dumps({"runs": runs}))
    if differ:
        print("torch_kernel_ab: outputs differ from the first run's: %s"
              % differ, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
