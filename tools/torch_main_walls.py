#!/usr/bin/env python3
"""Walls and stage timers of the main path's runs in two or more checkouts
of the port, each checkout in a process of its own.

    python3 tools/torch_main_walls.py TREE[@REPS] [TREE[@REPS] ...]
                                      [--seed N] [--mb 100] [--reps 3]
                                      [--runs NAME,...] [--samples PATH]

Each TREE is the root of a checkout holding agrep_tpu_torch/ (an
unpacked `git archive` of a commit, say); the trees run in the order
given, so `A B B A` runs A, B, B, A.  TREE@REPS times REPS runs a
backend in that tree in place of --reps (`A@1 B B A@1`: a tree whose
runs take a minute each, timed once).  Each run builds its tree's kernels
and native library, makes chip_smoke's corpora from --seed (this
checkout's chip_smoke.py, loaded by path), and runs --runs of: BASELINE
configs 1-3 (`-c hello`, `-1 -n matching`, `-3 -D2 -I1 -S1 -w -i
approximate`) and config2c (config 2 as a count, chip_smoke.CONFIG2C) on
the --mb MB file, memagrep `-c hello` on the same bytes in memory, and
bool5m (`-d '$$' 'hello;matching,<a term of 136 byte classes>'`) on the
records file (the default), and config2v (`-1 -v -n matching`, nearly
every record printed), BASELINE config 4 (`-2 'appro[a-z]*mat(e|ion)'`)
as a count (config4) and a line-numbered print (config4n) on the file
and as a count in memory (memagrep4; these four by name only), and
BASELINE config 5's 400 patterns past the chain caps (chip_smoke's
pats400w: 154 byte classes) on the records file as a count (config5q)
and as the matching lines (config5qn; agrep refuses -n with -f; printed
whole, at chip_smoke's WHOLE_FILE_RUNS streaming threshold), and the
matching lines of chip_smoke's pats400 (within the chain caps; config5s)
and of pats400w (config5qs) printed in chunks at the default 8 MB
threshold (chip_smoke's STREAMED_RUNS; these four by name only), and
chip_smoke's BOOL_STREAM_RUNS, the booleans streamed in chunks at that
threshold on the --mb MB file (bools `hello;lazy`, boolsc `-c
lazy;dog;fox;over`, boolst `{hello,matching};~lazy`, boolsq that tree
with the 136-class term; by name only), through
the tree's agrep_tpu_torch.api, with
AGREP_TORCH_STATS=2: one warm-up run, then --reps timed runs on the GPU
route (each ended by a synchronize) and --reps on the tree's numpy host
backend.  For each GPU run it keeps the tree's stage timers
(runtime/trace.py: `scan`, the engines' whole search; `compile`; and any
stage the tree adds) and the host time inside the tree's
ops/scan.py::_scan_torch and, where the tree has it, _records_torch,
and inside the regex engine's device calls (runtime/regex_engine.py's
RegexEngine._upload and _kernel_verdicts where the tree has them --
their host length sort and gathers included --, else its _to_device,
_fire and ops/renfa_kernel.py's line_index), and inside the mgrep
engine's q-gram device calls (runtime/mgrep.py's MgrepEngine._qgram_plane,
_qgram_positions and, where the tree has it, _qgram_lines, and its chain
calls _chain_plane and _chain_starts, and ops/chain_kernel.py's
line_terms where the tree has it; a call inside another is counted
once): the device layer (the
text's copy to the card, the kernels, the read-back; their wrappers
here, in both trees alike), and the launches of each kernel.  The GPU route's output must equal the
numpy backend's, and every tree's the first tree's (sha256 and exit
code).  The first line is the card's name and power limit; then one
`walls:` and one `stages:` line a run, with every tree's medians, and a
last JSON line with those medians and the path of the file that holds
every sample (--samples, relative to this checkout; by default
build/torch_main_walls.json).  Exits non-zero without a CUDA
device, when a run fails or when outputs differ.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _helpers():
    """(chip_smoke, timing) of this checkout, loaded by path under other
    names, so that a tree's own chip_smoke.py and timing module are never
    the ones used."""
    return (_load("walls_chip_smoke", os.path.join(REPO, "chip_smoke.py")),
            _load("walls_timing", os.path.join(REPO, "agrep_tpu_torch", "ops",
                                               "timing.py")))


DEFAULT_RUNS = "config1,config2,config3,config2c,memagrep,bool5m"


def runs(cs, path: str, rec: str, data: bytes, p400: str,
         p400w: str) -> list:
    """(name, api function name, argv, in-memory data or None)."""
    return [
        ("config1", "fileagrep", cs.CONFIGS[0][1] + [path], None),
        ("config2", "fileagrep", cs.CONFIGS[1][1] + [path], None),
        ("config3", "fileagrep", cs.CONFIGS[2][1] + [path], None),
        ("config2c", "fileagrep", cs.CONFIG2C[1] + [path], None),
        ("config2v", "fileagrep", ["-1", "-v", "-n", "matching", path],
         None),
        ("config4", "fileagrep", cs.REGEX_CONFIGS[0][1] + [path], None),
        ("config4n", "fileagrep", cs.REGEX_CONFIGS[1][1] + [path], None),
        ("memagrep4", "memagrep", cs.REGEX_CONFIGS[0][1], data),
        ("memagrep", "memagrep", cs.CONFIGS[0][1], data),
        ("bool5m", "fileagrep",
         cs.CONFIG5_DELIM + ["hello;matching," + cs.WIDE_TERM, rec], None),
        ("config5q", "fileagrep", ["-c", "-f", p400w, rec], None),
        ("config5qn", "fileagrep", ["-f", p400w, rec], None),
        ("config5s", "fileagrep", ["-f", p400, rec], None),
        ("config5qs", "fileagrep", ["-f", p400w, rec], None),
    ] + [(name, "fileagrep", argv + [path], None)
         for name, argv in cs.BOOL_STREAM_RUNS]


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def child(tree: str, args) -> int:
    """One run: every run of `runs` with tree's package; prints one JSON
    line."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    cs = _helpers()[0]
    import tempfile

    import torch

    import agrep_tpu_torch
    from agrep_tpu_torch import api, native
    from agrep_tpu_torch.ops import (_cuda, chain_kernel, kernels,
                                     qgram_kernel, renfa_kernel)
    from agrep_tpu_torch.ops import scan as scan_ops
    from agrep_tpu_torch.runtime import mgrep, regex_engine, trace
    if os.path.dirname(os.path.abspath(agrep_tpu_torch.__file__)) != \
            os.path.join(tree, "agrep_tpu_torch"):
        raise AssertionError("agrep_tpu_torch imported from %s, not %s"
                             % (agrep_tpu_torch.__file__, tree))
    if not trace.DETAILED:
        raise AssertionError("AGREP_TORCH_STATS=2 is not set")
    _cuda.build_all(list(_cuda.SOURCES))
    if native.get_lib() is None:
        raise RuntimeError("the native host library did not build")
    scan_ops.set_device("cuda")
    layer = [0.0]
    depth = [0]

    def timed(real):
        def call(*a, **kw):
            t0 = time.perf_counter()
            depth[0] += 1
            try:
                return real(*a, **kw)
            finally:
                depth[0] -= 1
                if not depth[0]:
                    layer[0] += time.perf_counter() - t0
        return call
    for fn in ("_scan_torch", "_records_torch"):
        if hasattr(scan_ops, fn):
            setattr(scan_ops, fn, timed(getattr(scan_ops, fn)))
    engine = regex_engine.RegexEngine
    for fn in ("_upload", "_kernel_verdicts", "_to_device", "_fire"):
        if hasattr(engine, fn):
            setattr(engine, fn, timed(getattr(engine, fn)))
    if hasattr(renfa_kernel, "line_index"):
        renfa_kernel.line_index = timed(renfa_kernel.line_index)
    if hasattr(chain_kernel, "line_terms"):
        chain_kernel.line_terms = timed(chain_kernel.line_terms)
    for fn in ("_qgram_plane", "_qgram_positions", "_qgram_lines",
               "_chain_plane", "_chain_starts"):
        if hasattr(mgrep.MgrepEngine, fn):
            setattr(mgrep.MgrepEngine, fn,
                    timed(getattr(mgrep.MgrepEngine, fn)))

    def launched():
        return {**kernels.launches, **renfa_kernel.launches,
                **chain_kernel.launches, **qgram_kernel.launches}

    corpus = cs.make_corpus(args.mb << 20, args.seed)
    records = cs.make_records(corpus, args.seed)
    build = os.path.join(tree, "build")
    os.makedirs(build, exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = os.path.join(tmp, "corpus.txt")
        corpus.tofile(path)
        rec = os.path.join(tmp, "records.txt")
        records.tofile(rec)
        p400 = os.path.join(tmp, "pats400.txt")
        p400w = os.path.join(tmp, "pats400w.txt")
        pats = cs.make_patterns(400, args.seed)
        for f, ws in ((p400, pats), (p400w, cs.wide_patterns(pats))):
            with open(f, "wb") as fh:
                fh.write(b"".join(w + b"\n" for w in ws))
        chosen = args.runs.split(",")
        for name, fn_name, argv, data in runs(cs, path, rec,
                                              b"\n" + corpus.tobytes(),
                                              p400, p400w):
            if name not in chosen:
                continue
            fn = getattr(api, fn_name)

            def once():
                buf = io.BytesIO()
                t0 = time.perf_counter()
                with cs.stream_mb(name):
                    rc = (fn(argv, output=buf) if data is None
                          else fn(argv, data, output=buf))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                return wall, (hashlib.sha256(buf.getvalue()).hexdigest(),
                              rc & 0xFF)
            r = {"gpu": [], "numpy": [], "stages": [], "layer_s": [],
                 "launches": [], "counters": []}
            scan_ops.set_backend("torch")
            _, digest = once()
            for _ in range(args.reps):
                trace.reset()
                layer[0] = 0.0
                before = launched()
                wall, d = once()
                if d != digest:
                    raise AssertionError("%s: GPU runs differ" % name)
                r["gpu"].append(wall)
                r["stages"].append(dict(trace.timers))
                r["counters"].append(dict(trace.counters))
                r["layer_s"].append(layer[0])
                r["launches"].append({k: v - before.get(k, 0)
                                      for k, v in launched().items()})
            scan_ops.set_backend("numpy")
            for _ in range(args.reps):
                wall, d = once()
                if d != digest:
                    raise AssertionError(
                        "%s: stdout sha256/rc %s on the GPU, %s on the "
                        "numpy backend" % (name, digest, d))
                r["numpy"].append(wall)
            r["digest"] = digest
            out[name] = r
    print(json.dumps({"tree": tree, "runs": out}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+",
                    help="checkout roots, in order, each with an optional "
                    "@REPS")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mb", type=int, default=100)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--runs", default=DEFAULT_RUNS,
                    help="comma-separated names of the runs")
    ap.add_argument("--samples", default=os.path.join(
        "build", "torch_main_walls.json"),
                    help="file for every sample, relative to this checkout")
    ap.add_argument("--child", action="store_true",
                    help="run the one tree given in this process")
    args = ap.parse_args(argv)
    if args.child:
        return child(args.trees[0], args)

    import torch
    if not torch.cuda.is_available():
        print("torch_main_walls: no CUDA device", file=sys.stderr)
        return 1
    timing = _helpers()[1]
    print(timing.card_line())
    env = dict(os.environ, AGREP_TORCH_STATS="2")
    done = []
    for spec in args.trees:
        tree, at, reps = spec.rpartition("@")
        if not at:
            tree, reps = spec, str(args.reps)
        tree = os.path.abspath(tree)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree,
             "--seed", str(args.seed), "--mb", str(args.mb), "--reps",
             reps, "--runs", args.runs],
            capture_output=True,
            text=True,
            cwd=tree, env=env)
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-8000:])
            print("torch_main_walls: the run of %s failed (exit %d)"
                  % (tree, proc.returncode), file=sys.stderr)
            return 1
        done.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    differ = []
    for name, r0 in done[0]["runs"].items():
        walls, stages = [], []
        for i, d in enumerate(done):
            r = d["runs"][name]
            if r["digest"] != r0["digest"]:
                differ.append((name, i + 1))
            tag = os.path.basename(os.path.normpath(d["tree"]))
            walls.append("%s %.3f [numpy %.3f] (%d a backend)" % (
                tag, _median(r["gpu"]), _median(r["numpy"]), len(r["gpu"])))
            keys = sorted({k for st in r["stages"] for k in st})
            cut = r.get("counters", [{}])[-1]
            stages.append("%s %s device layer=%.3fs launches=%s%s" % (
                tag, " ".join("%s=%.3fs" % (k, _median(
                    [st.get(k, 0.0) for st in r["stages"]])) for k in keys),
                _median(r["layer_s"]),
                ",".join("%s:%d" % kv for kv in r["launches"][-1].items()),
                "".join(" %s=%d" % (k, cut[k]) for k in
                        ("record_pairs", "record_rows", "regex_lines",
                         "regex_rows", "chain_scans", "qgram_lines",
                         "qgram_line_rows", "stream_print_chunks",
                         "bool_stream_chunks", "line_terms",
                         "line_terms_rows")
                        if k in cut)))
        print("walls: %-8s medians, s, GPU route [numpy backend]: %s"
              % (name, " | ".join(walls)))
        print("stages: %-8s medians: %s" % (name, " | ".join(stages)))
    print("card: %s" % timing.card_line())
    # every sample goes to a file: with many runs one JSON line of them
    # grows past what the tail of a log keeps
    path = os.path.join(REPO, args.samples)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump({"runs": done}, fh)
    print(json.dumps({"samples": os.path.relpath(path, REPO), "medians": {
        name: [{"tree": os.path.basename(os.path.normpath(d["tree"])),
                "gpu_s": _median(d["runs"][name]["gpu"]),
                "numpy_s": _median(d["runs"][name]["numpy"]),
                "layer_s": _median(d["runs"][name]["layer_s"])}
               for d in done] for name in done[0]["runs"]}}))
    if differ:
        print("torch_main_walls: outputs differ from the first run's: %s"
              % differ, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
