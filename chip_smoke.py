#!/usr/bin/env python3
"""Smoke run of agrep_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py [--seed N] [--mb 100]

Phases, each printing its own lines; any failure raises and the script
exits non-zero:

  1. card: the GPU's name and power limit (nvidia-smi) and the torch and
     CUDA versions;
  2. build: compiles csrc/mask_scan.cu with nvcc and times the build;
  3. parity: the mask_scan kernel against its plain PyTorch version
     (mask_scan_reference) on the card, bit for bit, over every variant,
     D, cost wiring, endpos shape and edge size the kernel takes (phase 4
     repeats the check at the main path's chunk shape);
  4. main path: a --mb MB ASCII corpus made from --seed, searched through
     agrep_tpu_torch.api.fileagrep with BASELINE configs 1-3 (the file
     is over the streaming threshold, so each run is chunked) and one
     in-memory memagrep call; stdout and return codes must equal the
     port's own numpy host backend, and every run must launch the kernel;
  5. kernels: one JSON line with each kernel's launches on the main path,
     its time, its plain version's time and its bound on this card.

The last line is {"ok": true, "device": {...}}.  Without a CUDA device,
or without the agrep_tpu_torch package beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 at 3.35 TB/s; 67 TFLOP/s fp32
# outside the tensor cores is 132 SMs x 128 lanes x 2 (FMA) x 1.98 GHz, and
# an SM has half as many int32 lanes: 132 x 64 x 1.98e9 int32 op/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

CONFIGS = [
    ("config1", ["-c", "hello"]),
    ("config2", ["-1", "-n", "matching"]),
    ("config3", ["-3", "-D2", "-I1", "-S1", "-w", "-i", "approximate"]),
]
FILLER = [b"the", b"quick", b"brown", b"fox", b"pattern", b"search",
          b"world", b"lorem", b"ipsum", b"dolor", b"bibliography",
          b"string", b"grep", b"over", b"lazy", b"dog"]
PLANTS = [b"hello", b"matching", b"matchng", b"Approximate",
          b"aproximate", b"approximately", b"HELLO"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------
# corpora
# ---------------------------------------------------------------------

def make_corpus(n_bytes: int, seed: int):
    """ASCII lines of 8 filler words; every ~1000th line carries a planted
    word, so matches stay sparse.  A 4 MB template is tiled to size."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lines = []
    total = 0
    while total < min(n_bytes, 4 << 20):
        ws = [FILLER[i] for i in rng.integers(0, len(FILLER), 8)]
        if rng.integers(0, 1000) == 0:
            ws[int(rng.integers(0, 8))] = PLANTS[
                int(rng.integers(0, len(PLANTS)))]
        line = b" ".join(ws) + b"\n"
        lines.append(line)
        total += len(line)
    tmpl = np.frombuffer(b"".join(lines), dtype=np.uint8)
    return np.tile(tmpl, -(-n_bytes // len(tmpl)))[:n_bytes].copy()


def random_text(n: int, rng):
    """Printable bytes with newlines, empty lines and planted words, for
    the kernel parity phase."""
    import numpy as np
    t = rng.integers(32, 127, size=n, dtype=np.uint8)
    t[::61] = 0x0A
    # '\n\n' completes the -d '$$' delimiter (agrep reads '$' as a
    # newline there)
    for p in PLANTS + [b"\n\n", b"abc", b"cde", b"fgh"]:
        pb = np.frombuffer(p, dtype=np.uint8)
        if n > len(pb):
            k = max(1, n // 800)
            for off in rng.integers(0, n - len(pb), k):
                t[off:off + len(pb)] = pb
    return t


# ---------------------------------------------------------------------
# machines
# ---------------------------------------------------------------------

def parity_machines():
    """(name, mask table, consts, D, variant, costs) of every machine
    shape phase 3 holds the kernel to."""
    import string

    from agrep_tpu_torch.compile.query import compile_query
    from agrep_tpu_torch.options import Options
    out = []
    for D in (0, 1, 2, 3, 8):
        q = compile_query("approximate",
                          Options(D=D, approx=D > 0, linenum=True))
        out.append(("bitap_D%d" % D, q.folded_mask, q.consts, D, "bitap",
                    None))
    q = compile_query("approximate", Options(
        D=3, approx=True, linenum=True, jump=True, cost_insert=2,
        cost_subst=1, cost_delete=1))
    out.append(("bitap_costs211_D3", q.folded_mask, q.consts, 3, "bitap",
                q.costs))
    for D in (0, 1, 2):
        q = compile_query("matching", Options(D=D, approx=D > 0))
        out.append(("sgrep_D%d" % D, q.sg_mask, q.sg_consts, D, "sgrep",
                    None))
    for n in (3, 12):
        q = compile_query(";".join(string.ascii_lowercase[:n]),
                          Options(linenum=True))
        out.append(("bitap_parts%d" % n, q.folded_mask, q.consts, 0,
                    "bitap", None))
    # 20 part bits: no AND pattern fits 32 bits with 20 terms, so the
    # 12-term machine takes a 20-bit endpos
    q = compile_query(";".join(string.ascii_lowercase[:12]),
                      Options(linenum=True))
    c20 = dict(q.consts, endpos=sum(1 << b for b in range(2, 22)))
    out.append(("bitap_parts20", q.folded_mask, c20, 0, "bitap", None))
    q = compile_query("hello", Options(linenum=True, delimiter="$$"))
    out.append(("bitap_delim_dollar", q.folded_mask, q.consts, 0, "bitap",
                None))
    return out


def halo(consts: dict, D: int, L: int) -> int:
    return min(max(consts.get("m", 32) + D + 2, 48), L)


# ---------------------------------------------------------------------
# work counts for the bound
# ---------------------------------------------------------------------

def level_ops(m) -> int:
    """int32 operations of one pass over the D+1 levels, counted from
    the expressions of kernels._levels."""
    D = m.D
    if m.variant == "sgrep":
        return 3 + 8 * D            # level 0: >>, |, &; level k: 8
    if m.costs is None:
        return 4 + 9 * D            # level 0: >>, &, &, |; level k: 9
    ci, cs, cd = m.costs
    n = 0
    for k in range(D + 1):
        # (s >> 1) & cm | s & init1, the insert edge, and the error
        # edges OR-ed together, then >> 1, & noerr, |
        err = (k - cs >= 0) + (k - cd >= 0)
        n += 4 + (k - ci >= 0) + (err + 2 if err else 0)
    return n


def ops_per_column(m) -> int:
    """int32 operations of one window column: the table lookup, the
    level pass, the event tests and the bit packing; for bitap also the
    trigger test, the state select and the delimiter bit."""
    n = 1 + level_ops(m) + 4 * len(m.hit_masks)
    if m.variant == "sgrep":
        return n + (1 if m.D else 0)       # the newline test
    return n + 2 + (m.D + 1) + 2


def restart_ops(m) -> int:
    """Extra operations of one delimiter restart: a second level pass
    and the d_mask gate."""
    return level_ops(m) + 1


def bound(m, N: int, W: int, L: int, planes) -> tuple:
    """(bound_ms, bound_by) of one scan of N bytes: each input byte read
    once and each plane word written once over HBM's rate, against the
    int32 operations of every window column (plus the restarts this
    input triggers) over the card's int32 rate."""
    import torch
    T, n_words = planes.shape[1], planes.shape[2]
    n_bytes = N + 256 * 4 + planes.numel() * 4
    triggers = 0
    if m.variant == "bitap" and m.d_endpos:
        p0 = planes[0].to(torch.int64)
        triggers = int(sum(((p0 >> b) & 1).sum().item() for b in range(32)))
    ops = T * (W + L) * ops_per_column(m) + triggers * restart_ops(m)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def time_kernel(fn, reps: int = 5) -> float:
    """ms per call of fn on the card: CUDA events around reps calls after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# ---------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------

def phase_build() -> None:
    """Build every kernel source from the checkout, all compiles started
    together."""
    from agrep_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    paths = _cuda.build_all(["mask_scan"])
    _cuda.load("mask_scan")
    dt = time.perf_counter() - t0
    log = _cuda.build_logs.get("mask_scan", "")
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    frames = [int(x) for x in re.findall(r"(\d+) bytes stack frame", log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    t0 = time.perf_counter()
    from agrep_tpu_torch import native
    if native.get_lib() is None:
        raise RuntimeError("the native host library did not build")
    print("build: native host library (g++) in %.2f s"
          % (time.perf_counter() - t0))
    print("build: mask_scan.cu -> %s in %.2f s (%d compile units in "
          "parallel); %d kernels; registers max %s; stack frame max %s B; "
          "kernels that spill: %d"
          % (os.path.relpath(paths["mask_scan"], REPO), dt,
             len(_cuda.UNITS["mask_scan"]), len(regs),
             max(regs, default="n/a"), max(frames, default="n/a"),
             sum(1 for s in spills if s)))


def phase_parity(device: str, seed: int, big: int) -> float:
    """Kernel planes vs plain planes on every machine and edge size;
    returns the largest |kernel - plain| word difference (0 or fail)."""
    import numpy as np
    import torch

    from agrep_tpu_torch.ops import kernels
    from agrep_tpu_torch.ops.scan import DEFAULT_TILE as L
    rng = np.random.default_rng(seed)
    worst = 0
    texts = {}
    failed = []
    for name, table, consts, D, variant, costs in parity_machines():
        m = kernels.machine_from_arrays(table, consts, D, variant, costs,
                                        device)
        W = halo(consts, D, L)
        sizes = (1, W - 1, L, L + 1, 3 * L + 17, big)
        n_hits = n_delims = 0
        bad = []
        t0 = time.perf_counter()
        for N in sizes:
            if N not in texts:
                texts[N] = kernels.to_device(random_text(N, rng), device)
            text = texts[N]
            got = kernels.mask_scan(text, m, W, L)
            want = kernels.mask_scan_reference(text, m, W, L)
            if got.shape != want.shape:
                raise AssertionError("%s N=%d: shape %s vs %s" % (
                    name, N, tuple(got.shape), tuple(want.shape)))
            diff = int((got.to(torch.int64) - want.to(torch.int64))
                       .abs().max().item())
            worst = max(worst, diff)
            if diff != 0:
                bad.append(N)
                where = (got != want).nonzero()[:4].tolist()
                print("parity: %s N=%d MISMATCH max |diff| %d; first "
                      "(plane, tile, word, kernel, plain): %s"
                      % (name, N, diff, [
                          (p, t, w, hex(int(got[p, t, w])),
                           hex(int(want[p, t, w]))) for p, t, w in where]))
            n_hits += int((want[1:] != 0).sum().item())
            n_delims += int((want[0] != 0).sum().item())
        torch.cuda.synchronize()
        if bad:
            failed.append((name, bad))
            continue
        print("parity: %-20s W=%-3d N=%s equal bit for bit (nonzero "
              "words: %d hit, %d delimiter) %.1f s"
              % (name, W, list(sizes), n_hits, n_delims,
                 time.perf_counter() - t0))
    if failed:
        raise AssertionError("kernel planes differ from "
                             "mask_scan_reference: %s" % failed)
    return float(worst)


def _run(api_fn, argv, data=None):
    buf = io.BytesIO()
    if data is None:
        rc = api_fn(argv, output=buf)
    else:
        rc = api_fn(argv, data, output=buf)
    out = buf.getvalue()
    return hashlib.sha256(out).hexdigest(), rc & 0xFF, len(out)


def phase_main(device: str, seed: int, mb: int, card: str) -> dict:
    import numpy as np
    import torch

    from agrep_tpu_torch import api
    from agrep_tpu_torch.compile.query import compile_query
    from agrep_tpu_torch.ops import kernels
    from agrep_tpu_torch.ops import scan as scan_ops
    from agrep_tpu_torch.options import parse_args

    n_bytes = mb << 20
    corpus = make_corpus(n_bytes, seed)
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    res = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = os.path.join(tmp, "corpus.txt")
        corpus.tofile(path)
        runs = [(name, api.fileagrep, argv + [path], None)
                for name, argv in CONFIGS]
        mem_data = b"\n" + corpus.tobytes()
        # memory mode of the bitap engine is a per-byte host loop
        # (bitap.c:309-446 emulation); the sgrep engine scans on the card
        runs.append(("memagrep", api.memagrep, CONFIGS[0][1], mem_data))

        # the main path, on the card: counts start at 0 here
        scan_ops.set_backend("torch")
        for k in kernels.launches:
            kernels.launches[k] = 0
        got = {}
        for name, fn, argv, data in runs:
            before = kernels.launches["mask_scan"]
            t0 = time.perf_counter()
            got[name] = _run(fn, argv, data)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = kernels.launches["mask_scan"] - before
            if n == 0:
                raise AssertionError("%s: the main path launched no "
                                     "mask_scan kernel" % name)
            res[name] = {"wall_s": wall, "launches": n}
        main_launches = dict(kernels.launches)

        # the same runs on the port's exact host backend
        scan_ops.set_backend("numpy")
        try:
            for name, fn, argv, data in runs:
                want = _run(fn, argv, data)
                if got[name][:2] != want[:2]:
                    raise AssertionError(
                        "%s: stdout sha256/rc %s on the GPU, %s on the "
                        "numpy backend" % (name, got[name][:2], want[:2]))
        finally:
            scan_ops.set_backend("torch")

    # the kernel alone at the main path's chunk shape
    chunk = corpus[:scan_ops.STREAM_CHUNK]
    text = kernels.to_device(chunk, device)
    for name, argv in CONFIGS:
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
        W, L = halo(consts, q.D, scan_ops.DEFAULT_TILE), \
            scan_ops.DEFAULT_TILE
        ms = time_kernel(lambda: kernels.mask_scan(text, m, W, L))
        planes = kernels.mask_scan(text, m, W, L)
        kernels.mask_scan_reference(text, m, W, L)     # warm the allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = kernels.mask_scan_reference(text, m, W, L)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        # the kernel against its plain version at this shape too
        diff = int((planes.to(torch.int64) - want.to(torch.int64))
                   .abs().max().item())
        if diff != 0:
            raise AssertionError("%s: kernel planes differ from "
                                 "mask_scan_reference on the %d MB chunk "
                                 "(max |diff| %d)"
                                 % (name, len(chunk) >> 20, diff))
        bms, by = bound(m, len(chunk), W, L, planes)
        r = res[name]
        r.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                 chunk_mb=len(chunk) >> 20, max_abs_err=diff)
        print("main: %s %-44s rc=%d out=%d B sha256=%s.. wall=%.3f s "
              "(%.3f GB/s) launches=%d | kernel %.4f ms per %d MB chunk "
              "(%.1f GB/s, equal to plain), plain %.1f ms, bound %.4f ms "
              "(%s) | card: %s"
              % (name, " ".join(argv), got[name][1], got[name][2],
                 got[name][0][:12], r["wall_s"], n_bytes / r["wall_s"] / 1e9,
                 r["launches"], ms, len(chunk) >> 20,
                 len(chunk) / ms / 1e6, plain_ms, bms, by, card))
    r = res["memagrep"]
    print("main: memagrep %s (%d MB buffer) rc=%d sha256=%s.. wall=%.3f s "
          "(%.3f GB/s) launches=%d | card: %s"
          % (" ".join(CONFIGS[0][1]), mb, got["memagrep"][1],
             got["memagrep"][0][:12], r["wall_s"],
             n_bytes / r["wall_s"] / 1e9, r["launches"], card))
    print("main: stdout and return codes equal the numpy host backend "
          "for all %d runs" % len(runs))
    res["launches"] = main_launches
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mb", type=int, default=100,
                    help="size of the main-path corpus in MB")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs only on a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from agrep_tpu_torch.ops import scan as scan_ops
    scan_ops.set_backend("torch")
    scan_ops.set_device("cuda")
    t_start = time.perf_counter()

    card = card_line()
    print(card)
    print("card: torch %s, CUDA %s, python %s, devices %d"
          % (torch.__version__, torch.version.cuda,
             sys.version.split()[0], torch.cuda.device_count()))
    phase_build()
    err = phase_parity("cuda", args.seed, 8 << 20)
    res = phase_main("cuda", args.seed, args.mb, card)

    c2 = res["config2"]
    line = {"kernels": [{
        "name": "mask_scan",
        "route": "cuda",
        "source": "agrep_tpu_torch/csrc/mask_scan.cu",
        "replaces": "agrep_tpu/ops/kernels.py:386",
        "launches": res["launches"]["mask_scan"],
        "max_abs_err": max([err] + [res[n]["max_abs_err"]
                                    for n, _ in CONFIGS]),
        "ms": c2["ms"],
        "plain_ms": c2["plain_ms"],
        "bound_ms": c2["bound_ms"],
        "bound_by": c2["bound_by"],
        "library_ms": None,
    }]}
    print("kernels: times are per launch at the main path's %d MB chunk "
          "of config2 (%s); launches are all main-path runs; card: %s"
          % (c2["chunk_mb"], " ".join(CONFIGS[1][1]), card))
    print(json.dumps(line))
    print("total: %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
