#!/usr/bin/env python3
"""Time the CUDA kernels and device stages of two or more checkouts of
the port with one method, each checkout in a process of its own.

    python3 tools/torch_kernel_ab.py TREE [TREE ...] [--seed N] [--mb 100]
                                     [--reps 20] [--only K,...] [--split]

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
qgram_filter at config5q's.  The device stages run every pass of one
call without the host's read (`index_passes`, `lines_passes`):
line_index at config 4's first window and memagrep4's buffer,
line_rows (`rows_passes`, both forms: the rows and a count) over the
main path's verdicts at config 4's first window, memagrep4's buffer and
config 4's window with -v (nearly every line fires); qgram_lines over
config5q's plane (a count), config5qn's (its rows) and config5qs's first
streamed chunk; event_pairs (`pairs_passes`) at
configs 1-3's first 32 MB chunk, the memagrep buffer and bool5m's
stream; record_verdicts at the first chunk of config 2, config2c and
config 3 (the inputs the main path's search gives mask_scan and
record_verdicts), and line_terms (`_terms_call`, its one launch) at the
first 32 MB chunk of the streamed booleans bools, boolsc, boolst and
boolsq (chip_smoke.terms_inputs), each tree through its own route: a
tree whose record_verdicts takes pairs runs `pairs_passes` and then
`records_passes` over them, a tree whose record_verdicts takes
mask_scan's planes (it has `pair_records_reference`) runs its
`records_passes` on the planes; their rows must be equal.  These two
stages, line_rows and line_terms also get the wrapper's time with its
read of K, the count or the summary
(chip_smoke's `_host_ms`: host clock, synchronized, median of 5).
--only times the named kernels alone; --split also splits each stage's
time by pass (timing.pass_split: CUDA events around each pass, and the
time before it: the launch gaps and the torch kernels between passes).
Every time comes from this checkout's timing.time_kernel and
timing.profiled_ms (agrep_tpu_torch/ops/timing.py) -- CUDA events over
--reps launches after the card's checked spin, and torch.profiler's
device time (the kernels only) -- whatever the tree's own timer does.  The trees'
outputs at each shape must be equal (sha256 of the output bytes); the
plain versions are not run here (chip_smoke holds each kernel to its
plain version).  The first line is the card's name and power limit;
then one `ab:` line a shape with every run's events and profiler ms (a
`split:` line a run after a stage's), one `libs:` line a run with the
library files it built, and a last JSON line with every number.  Exits
non-zero without a CUDA device, when a run fails or when the trees'
outputs differ.
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
KERNELS = ("mask_scan", "renfa_lanes", "chain_scan", "qgram_filter",
           "line_index", "line_rows", "qgram_lines", "event_pairs",
           "record_verdicts", "line_terms")
# The device stages: the module and the attributes through which each
# launches its passes, in any tree (timing.pass_split wraps those the
# tree's module has, for --split).  An older event_pairs launched its
# two passes through _pairs_count and _pairs_write, and an older
# record_verdicts its three through _records_call after them.
STAGE_HOOKS = {
    "line_index": ("renfa_kernel", ("_index_call",)),
    "line_rows": ("renfa_kernel", ("_rows_call",)),
    "qgram_lines": ("qgram_kernel", ("_lines_call",)),
    "event_pairs": ("kernels", ("_pairs_call", "_pairs_count",
                                "_pairs_write")),
    "record_verdicts": ("kernels", ("_pairs_call", "_pairs_count",
                                    "_pairs_write", "_records_call")),
    "line_terms": ("chain_kernel", ("_terms_call",))}


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


def shapes(cs, mb: int, seed: int, tmp: str, device: str = "cuda",
           only=()):
    """(name, kernel, launch function of no arguments[, function of the
    output, wrapper function]) of every main-path shape, with the tree's
    agrep_tpu_torch (line_terms' alone, which need no other stage's
    inputs, where only line_terms is asked for)."""
    if only and set(only) <= {"line_terms"}:
        return terms_shapes(cs, cs.make_corpus(mb << 20, seed), tmp)
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
    scans = []        # (name, mask_scan's arguments) of event_pairs' shapes
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
        scans.append((name, (t, m, W, L)))
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
    scans.append(("bool5m", args5m))
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

    # the device stages: line_index at config 4's first window (the
    # glitch byte inserted at 49,152, as the regex engine inserts it) and
    # at memagrep4's buffer; qgram_lines over config5q's candidate plane
    # (a count), config5qn's (its rows) and config5qs's first streamed
    # chunk (32 MB and the halo of maxlen - 1 bytes; its rows)
    for name, buf in (("config4", np.insert(corpus[:scan_ops.STREAM_CHUNK],
                                            49152, 0)),
                      ("memagrep4", mem_buf)):
        seg = kernels.to_device(buf, device)
        idx = renfa_kernel.line_index(seg)
        out.append((name, "line_index",
                    lambda seg=seg, idx=idx: renfa_kernel.index_passes(
                        seg, idx),
                    lambda idx=idx: torch.cat(list(idx[:4]))))
    out += rows_shapes(corpus, mem_buf, rm, cont, device)
    wide = cs.wide_patterns(pats)
    _tb, tables = cs.qgram_line_tables(wide, False, False, device)
    region = records[:scan_ops.STREAM_CHUNK + max(map(len, wide)) - 1]
    for name, t, count in (("config5q", rec, True), ("config5qn", rec, False),
                           ("config5qs", kernels.to_device(region, device),
                            False)):
        plane = qgram_kernel.qgram_filter(t, words)
        rows, k = qgram_kernel.qgram_lines(t, plane, tables, count)
        res = rows if rows is not None else torch.tensor([k])
        out.append((name, "qgram_lines",
                    lambda t=t, plane=plane, rows=rows:
                    qgram_kernel.lines_passes(t, plane, tables, rows),
                    lambda res=res: res))
    out += pairs_shapes(scans)
    out += records_shapes(cs, corpus, tmp)
    out += terms_shapes(cs, corpus, tmp)
    return out


def terms_shapes(cs, corpus, tmp) -> list:
    """line_terms at the first 32 MB chunk of each streamed boolean
    (chip_smoke.BOOL_STREAM_RUNS: the arguments the main path's search
    gives the tree's wrapper, chip_smoke.terms_inputs): its one launch
    into the rows of an earlier call (or a count), the rows or the
    count, carried mask and last newline, and the wrapper with its
    read."""
    import torch

    from agrep_tpu_torch.ops import chain_kernel as ck
    path = os.path.join(tmp, "bools.txt")
    corpus.tofile(path)
    out = []
    for name, (a, kw) in cs.terms_inputs(path).items():
        text, plane, shift, tables = a
        kw = dict(kw)
        count_only = kw.pop("count_only")
        body = kw["body"]
        rows, k, carry, nl_at = ck.line_terms(text, plane, shift, tables,
                                              count_only=count_only, **kw)
        res = torch.tensor([k, carry, nl_at])
        if rows is not None:
            res = torch.cat([rows.flatten().cpu(), res])
        dest = None if count_only else torch.empty(
            (ck.terms_capacity(body, tables.min_len), 2), dtype=torch.int64,
            device=text.device)
        grid = ck.terms_grid(body, not count_only, text.device)
        out.append((name, "line_terms",
                    lambda a=a, kw=kw, dest=dest, grid=grid: ck._terms_call(
                        *a, kw["body"], kw["carry"], kw["begin"],
                        kw["cap_e"], kw["last"], kw["base"], dest, grid),
                    lambda res=res: res,
                    lambda a=a, kw=kw, c=count_only: ck.line_terms(
                        *a, count_only=c, **kw)))
    return out


def rows_shapes(corpus, mem_buf, rm, cont, device) -> list:
    """line_rows over the main path's own verdicts (renfa_lines over
    line_index, from the regex engine's states after a newline) at
    config 4's first window (the glitch byte at 49,152, every line kept),
    at memagrep4's buffer (its leading line dropped) and at config 4's
    window with -v (nearly every line fires), each in both forms: every
    pass of one call into the rows of an earlier one, or of a count
    (renfa_kernel.rows_passes), the rows or the count, and the wrapper
    with its read of the count."""
    import numpy as np
    import torch

    from agrep_tpu_torch.ops import kernels, renfa_kernel
    from agrep_tpu_torch.ops import scan as scan_ops
    window = np.insert(corpus[:scan_ops.STREAM_CHUNK], 49152, 0)
    out = []
    for name, buf, glitch, first, invert in (
            ("config4", window, 49152, 0, False),
            ("memagrep4", mem_buf, -1, 1, False),
            ("config4v", window, 49152, 0, True)):
        seg = kernels.to_device(buf, device)
        idx = renfa_kernel.line_index(seg)
        v = renfa_kernel.renfa_lines(seg, idx.starts, idx.lens, rm, cont)
        args = (v, idx.ords, idx.nl, invert, first, idx.nl.numel(), glitch)
        for form, want in (("rows", True), ("count", False)):
            rows, k = renfa_kernel.line_rows(*args, want)
            res = rows if want else torch.tensor([k])
            out.append((name + "/" + form, "line_rows",
                        lambda a=args, r=rows:
                        renfa_kernel.rows_passes(*a, r),
                        lambda res=res: res,
                        lambda a=args, w=want: renfa_kernel.line_rows(
                            *a, w)))
    return out


def _vals(m):
    """The event word of each of mask_scan's planes (kernels.event_vals)
    on the machine's device."""
    import numpy as np
    import torch

    from agrep_tpu_torch.ops import kernels
    return torch.from_numpy(np.asarray(kernels.event_vals(m),
                                       dtype=np.uint32)).to(m.table.device)


def pairs_shapes(scans) -> list:
    """event_pairs over the planes of each (name, mask_scan arguments):
    every pass of one call into the pairs of an earlier one
    (kernels.pairs_passes), the pairs, and the wrapper."""
    import torch

    from agrep_tpu_torch.ops import kernels
    out = []
    for name, (t, m, W, L) in scans:
        planes, vals, N = kernels.mask_scan(t, m, W, L), _vals(m), t.numel()
        pos, word = kernels.event_pairs(planes, vals, W, L, N, 0)
        out.append((name, "event_pairs",
                    lambda a=(planes, vals, W, L, N, 0, pos, word):
                    kernels.pairs_passes(*a),
                    lambda pos=pos, word=word: torch.cat(
                        [pos, word.to(torch.int64)]),
                    lambda a=(planes, vals, W, L, N, 0):
                    kernels.event_pairs(*a)))
    return out


def records_shapes(cs, corpus, tmp) -> list:
    """record_verdicts at the first chunk of config 2, config2c and
    config 3: the arguments the main path's search (the tree's
    api.fileagrep on the torch backend) gives mask_scan and
    record_verdicts first, then the tree's own route over them -- the
    planes stage where record_verdicts takes planes, event_pairs and the
    pair cut where it takes pairs."""
    import io

    from agrep_tpu_torch import api
    from agrep_tpu_torch.ops import kernels
    path = os.path.join(tmp, "corpus.txt")
    corpus.tofile(path)
    planes_route = hasattr(kernels, "pair_records_reference")
    out = []
    for name, argv in (cs.CONFIGS[1], cs.CONFIG2C, cs.CONFIGS[2]):
        seen = {}
        real = {k: getattr(kernels, k) for k in ("mask_scan",
                                                 "record_verdicts")}

        def recorder(k):
            def call(*args, **kw):
                seen.setdefault(k, args)
                return real[k](*args, **kw)
            return call
        for k in real:
            setattr(kernels, k, recorder(k))
        try:
            api.fileagrep(argv + [path], output=io.BytesIO())
        finally:
            for k, fn in real.items():
                setattr(kernels, k, fn)
        t, m, W, L = seen["mask_scan"]
        rv = seen["record_verdicts"]
        scal = rv[6:12] if planes_route else rv[2:8]
        planes, vals, N = kernels.mask_scan(t, m, W, L), _vals(m), t.numel()
        if planes_route:
            rows = kernels.record_verdicts(planes, vals, W, L, N, 0,
                                           *scal)[0]
            out.append((name, "record_verdicts",
                        lambda a=(planes, vals, W, L, N, 0) + scal, r=rows:
                        kernels.records_passes(*a, r),
                        lambda r=rows: r,
                        lambda a=(planes, vals, W, L, N, 0) + scal:
                        kernels.record_verdicts(*a)))
            continue
        pos, word = kernels.event_pairs(planes, vals, W, L, N, 0)
        rows = kernels.record_verdicts(pos, word, *scal)[0]

        def parent(a=(planes, vals, W, L, N, 0, pos, word), s=scal,
                   r=rows):
            kernels.pairs_passes(*a)
            kernels.records_passes(a[6], a[7], *s, r)
        out.append((name, "record_verdicts", parent, lambda r=rows: r,
                    lambda a=(planes, vals, W, L, N, 0), s=scal:
                    kernels.record_verdicts(*kernels.event_pairs(*a), *s)))
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
        only = [k for k in args.only.split(",") if k]
        for name, kname, fn, *extra in shapes(cs, args.mb, args.seed, tmp,
                                              only=only):
            if args.only and kname not in args.only.split(","):
                continue
            got = (extra[0] if extra else fn)().contiguous()
            torch.cuda.synchronize()
            if got.dtype == torch.uint32:
                got = got.view(torch.int32)
            digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
            key = name if kname not in STAGE_HOOKS else name + ":" + kname
            res[key] = {
                "kernel": kname, "bytes": int(got.numel()
                                              * got.element_size()),
                "sha256": digest,
                "ms": timing.time_kernel(fn, args.reps),
                "device_ms": None if kname in STAGE_HOOKS else
                timing.profiled_ms(fn, kname + "_kernel", args.reps)}
            if len(extra) > 1:
                res[key]["wrapper_ms"] = cs._host_ms(extra[1])
            if args.split and kname in STAGE_HOOKS:
                mod, hooks = STAGE_HOOKS[kname]
                mod = importlib.import_module("agrep_tpu_torch.ops." + mod)
                res[key]["split"] = timing.pass_split(
                    fn, mod, tuple(h for h in hooks if hasattr(mod, h)),
                    args.reps)
    print(json.dumps({"tree": tree, "times": res, "libs": {
        k: os.path.basename(v) for k, v in paths.items()}}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="checkout roots, in order")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mb", type=int, default=100)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="",
                    help="comma-separated kernels to time (default: all)")
    ap.add_argument("--split", action="store_true",
                    help="also split each device stage's time by pass "
                    "(timing.pass_split: CUDA events around each pass)")
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
             str(args.reps), "--only", args.only]
            + ["--split"] * args.split,
            capture_output=True, text=True,
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
            cells.append("%s %.4f/%s%s" % (
                os.path.basename(os.path.normpath(r["tree"])), t["ms"],
                "n/a" if t["device_ms"] is None
                else "%.4f" % t["device_ms"],
                " [wrapper %.4f]" % t["wrapper_ms"] if "wrapper_ms" in t
                else ""))
        print("ab: %-12s %-9s ms a launch, events/profiler: %s"
              % (r0["kernel"], name.split(":")[0], " | ".join(cells)))
        for r in runs:
            if "split" in r["times"][name]:
                print("split: %-12s %-9s %s: %s" % (
                    r0["kernel"], name.split(":")[0],
                    os.path.basename(os.path.normpath(r["tree"])),
                    ", ".join("%s %.4f" % (lab, ms) for lab, ms in
                              r["times"][name]["split"])))
    print("card: %s" % timing.card_line())
    print(json.dumps({"runs": runs}))
    if differ:
        print("torch_kernel_ab: outputs differ from the first run's: %s"
              % differ, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
