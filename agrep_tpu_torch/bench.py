"""Benchmark: the port's kernels and CLI on one CUDA GPU, behind a
conformance gate.  The counterpart of the repo's root bench.py, on the
same inputs and under the same row names.

    python -m agrep_tpu_torch.bench [--mb 256] [--gate-mb 8]
                                    [--para-mb 128] [--device cuda|cpu]

Prints one JSON line, the last:
  {"metric": "k2_scan_throughput_per_chip", "value": GB/s, "unit": "GB/s",
   "vs_baseline": x, "conformance": "pass" | "FAIL:<labels>",
   "configs": {row: {...}}, "device": "<name>, <power limit>" | "cpu",
   "gate_ref": ..., "baseline": "oracle" | "absent"}

The gate runs first and every row depends on it: 8 CLI searches on a
--gate-mb file and records file, each on the torch backend against the
numpy backend (stdout bytes and exit code; against the reference binary
too where .oracle/agrep exists or tools/build_oracle.sh builds it), and
7 kernel checks (event words of scan_events against the numpy backend
at D 0, 2, a cost wiring and an 18-byte scattered class; the regex
lanes against the numpy lanes; chain match starts against a naive numpy
match; q-gram candidates against a direct membership test), over a
quarter of the gate size (at most 2 MB) of corpus followed by as much
uniform random bytes.  A failed gate prints "FAIL:<labels>", no row,
and exits 1.  The end-to-end rows are gated inline the same way: their
outputs on the two backends (and the reference binary's) must agree, or
the line reads "FAIL:<rows>" and the bench exits 1.

Kernel rows time the launch the main path makes, at its geometry (the
mask machine at W = max(m + D + 2, 48) and L = DEFAULT_TILE, as
scan_events launches it) over the whole --mb corpus, uploaded once:
SAMPLES samples of REPS launches each with ops.timing.time_kernel
(CUDA events after a spin), the median ms a pass with min and max, gbs
from the median, and bound_ms / share_of_bound from ops.timing's
counters.  At the default 256 MB the text does not fit the card's 50 MB
L2, so every pass reads it cold from HBM.  End-to-end rows run
api.fileagrep on the default route (the torch backend) and, as
host_gbs, on the numpy backend, each the best of two.  ref_gbs and
vs_ref are the reference binary's, and null without it.  With
--device cpu the rows time the plain PyTorch versions on the host clock
(perf_counter), one call a sample; without it and without CUDA, the
bench raises.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = 5
REPS = 9
FB_PAT = "[a1c3e5g7i9k!m#o%q=]atching"
REGEX_PAT = "wo(r|t)king"
# the regex row's lines: slots of 512 bytes, each a 510-byte line, its
# newline and one spare byte, at most 131,072 of them (64 MB)
REGEX_SLOT, REGEX_LINES = 512, 131072
E2E_MB = 16
# (row, D, costs, pattern, the reference binary's argv) of the mask
# machine's rows; k2 is the headline
MASK_ROWS = [
    ("k2", 2, None, "matching", ["-2", "-c", "matching"]),
    ("exact_k0", 0, None, "matching", ["-c", "matching"]),
    ("costs_k3_D2I1S1", 3, (1, 1, 2), "matching",
     ["-3", "-D2", "-I1", "-S1", "-c", "matching"]),
    ("fallback_class18", 1, None, FB_PAT, ["-1", "-c", FB_PAT]),
]

# (label, argv) of the CLI gates; {conf}, {pats} and {para} name the
# gate's corpus file, the 100-pattern file and the records file
CLI_GATES = [
    ("cli_exact_count", ["-c", "matching", "{conf}"]),
    ("cli_exact_print", ["-n", "bibliography", "{conf}"]),
    ("cli_sgrep_k1", ["-1", "-c", "matching", "{conf}"]),
    ("cli_k2", ["-2", "-c", "matching", "{conf}"]),
    ("cli_costs", ["-3", "-D2", "-I1", "-S1", "-c", "matching", "{conf}"]),
    ("cli_regex", ["-2", "-c", REGEX_PAT, "{conf}"]),
    ("cli_f100", ["-c", "-f", "{pats}", "{conf}"]),
    ("cli_f100_records", ["-c", "-d", "$$", "-f", "{pats}", "{para}"]),
]


# ---------------------------------------------------------------------
# inputs (bench.py's, byte for byte)
# ---------------------------------------------------------------------

def make_text(n_bytes: int) -> np.ndarray:
    rng = np.random.default_rng(7)
    words = [b"the", b"quick", b"brown", b"matching", b"pattern",
             b"approximate", b"search", b"hello", b"world", b"lorem",
             b"ipsum", b"bibliography"]
    chunks = []
    total = 0
    while total < (1 << 20):
        line = b" ".join(words[i] for i in
                         rng.integers(0, len(words), 8)) + b"\n"
        chunks.append(line)
        total += len(line)
    tmpl = np.frombuffer(b"".join(chunks), dtype=np.uint8)
    reps = -(-n_bytes // len(tmpl))
    return np.tile(tmpl, reps)[:n_bytes]


def make_patfile(dirpath: str) -> str:
    rnd = random.Random(11)
    words = ["the", "quick", "brown", "matching", "pattern",
             "approximate", "search", "hello", "world", "lorem"]
    pats = []
    for i in range(100):
        r = i % 3
        if r == 0:
            pats.append(rnd.choice(words))
        elif r == 1:
            pats.append("nosuch%03d" % i)
        else:
            pats.append(rnd.choice(words)[:3] + rnd.choice(words)[-3:])
    p = os.path.join(dirpath, "bench_pats.txt")
    with open(p, "w") as f:
        f.write("".join(x + "\n" for x in pats))
    return p


def make_para_corpus(dirpath: str, n_mb: int = 128,
                     name: str = "bench_para.txt") -> str:
    """'$$'-delimited paragraph corpus (BASELINE config 5 records)."""
    rnd = random.Random(3)
    words = ["the", "quick", "brown", "matching", "pattern",
             "approximate", "search", "hello", "world", "lorem"]
    paras = []
    tot = 0
    while tot < (1 << 20):
        p = "\n".join(" ".join(rnd.choices(words,
                                           k=rnd.randint(4, 8)))
                      for _ in range(rnd.randint(2, 5))) + "\n$$\n"
        paras.append(p)
        tot += len(p)
    tmpl = "".join(paras).encode()
    path = os.path.join(dirpath, name)
    with open(path, "wb") as f:
        for _ in range(n_mb):
            f.write(tmpl)
    return path


def read_terms(patfile: str) -> list:
    with open(patfile) as f:
        return [ln.encode() for ln in f.read().splitlines() if ln]


# ---------------------------------------------------------------------
# the reference binary, where there is one
# ---------------------------------------------------------------------

def oracle_exe() -> str | None:
    """.oracle/agrep, built by tools/build_oracle.sh if missing; None
    where it cannot be built (its sources are absent)."""
    exe = os.path.join(REPO, ".oracle", "agrep")
    if not os.path.exists(exe):
        try:
            subprocess.run([os.path.join(REPO, "tools", "build_oracle.sh")],
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL, check=True,
                           timeout=600)
        except (OSError, subprocess.SubprocessError):
            return None
    return exe if os.path.exists(exe) else None


def oracle_run(exe: str, argv: list) -> tuple:
    p = subprocess.run([exe] + argv, capture_output=True, timeout=600)
    return p.stdout, p.returncode & 0xFF


def reference_bps(exe: str | None, path: str, argv: list) -> float | None:
    """Bytes/s of the reference binary searching path, or None."""
    if exe is None:
        return None
    t0 = time.perf_counter()
    oracle_run(exe, argv + [path])
    return os.path.getsize(path) / (time.perf_counter() - t0)


# ---------------------------------------------------------------------
# machines and backends
# ---------------------------------------------------------------------

@contextlib.contextmanager
def _backend(name: str):
    """Runs the scans inside on the named backend of ops.scan."""
    from .ops import scan as scan_ops
    old = scan_ops._BACKEND
    scan_ops.set_backend(name)
    try:
        yield
    finally:
        scan_ops.set_backend(old)


def _query(pattern: str, D: int, costs: tuple | None):
    from .compile.query import compile_query
    from .options import Options
    opts = Options(D=D, approx=D > 0, linenum=True)
    if costs is not None:
        ci, cs, cd = costs
        opts.jump = True
        opts.cost_insert, opts.cost_subst, opts.cost_delete = ci, cs, cd
    return compile_query(pattern, opts)


def mask_machine(pattern: str, D: int, costs: tuple | None, device):
    """(machine, W, L) of the bitap mask machine as scan_events launches
    it."""
    from .ops import kernels
    from .ops.scan import DEFAULT_TILE
    q = _query(pattern, D, costs)
    m = kernels.machine_from_arrays(q.folded_mask.astype(np.uint32),
                                    q.consts, D, "bitap", q.costs, device)
    W = min(max(q.consts.get("m", 32) + D + 2, 48), DEFAULT_TILE)
    return m, W, DEFAULT_TILE


def regex_lines(text: np.ndarray, R: int, slot: int) -> tuple:
    """(flat u8 buffer, starts, lens) of R lines cut from text: each
    slot-byte slot holds slot - 2 bytes with newlines made spaces, a
    newline and one spare byte."""
    lanes = np.ascontiguousarray(text[:R * slot]).reshape(R, slot).copy()
    lanes[lanes == 0x0A] = 0x20
    lanes[:, slot - 2] = 0x0A
    starts = np.arange(R, dtype=np.int64) * slot
    lens = np.full(R, slot - 2, dtype=np.int64)
    return lanes.reshape(-1), starts, lens


# ---------------------------------------------------------------------
# the conformance gate
# ---------------------------------------------------------------------

def _fileagrep(argv: list) -> tuple:
    from . import api
    buf = io.BytesIO()
    rc = api.fileagrep(list(argv), output=buf)
    return buf.getvalue(), rc & 0xFF


def gate_cli(argv: list, label: str, failures: list,
             exe: str | None) -> None:
    """The torch backend's stdout and exit code against the numpy
    backend's, and against the reference binary's where there is one."""
    got = _fileagrep(argv)
    with _backend("numpy"):
        want = _fileagrep(argv)
    if got != want or (exe is not None and got != oracle_run(exe, argv)):
        failures.append(label)


def gate_kernel_events(text: np.ndarray, D: int, costs: tuple | None,
                       label: str, failures: list,
                       pattern: str = "matching") -> None:
    """scan_events' event words on the torch backend (the mask_scan
    kernel) against the numpy backend's."""
    from .ops import scan
    q = _query(pattern, D, costs)
    mt = q.folded_mask.astype(np.uint32)
    got = scan.scan_events(text, mt, q.consts, D, "bitap", q.costs)
    with _backend("numpy"):
        want = scan.scan_events(text, mt, q.consts, D, "bitap", q.costs)
    if not np.array_equal(got, want):
        failures.append(label)


def gate_regex_lanes(text: np.ndarray, label: str, failures: list,
                     device) -> None:
    """The lanes kernel's verdicts against the numpy lanes on 512 lines
    of 190 bytes."""
    import torch

    from .ops import kernels, renfa, renfa_kernel
    mc = _query(REGEX_PAT, 2, None).re_mc
    R, L = 512, 192
    flat, starts, lens = regex_lines(text, R, L)
    got = renfa_kernel.renfa_lines(
        kernels.to_device(flat, device), torch.from_numpy(starts).to(device),
        torch.from_numpy(lens).to(device),
        renfa_kernel.machine_from_mc(mc, device), mc["inits"])
    want = renfa.scan_records(flat.reshape(R, L), lens, mc, mc["inits"],
                              mc["inits"])
    if not np.array_equal(got.cpu().numpy(), want):
        failures.append(label)


def gate_chain(text: np.ndarray, terms: list, label: str, failures: list,
               device) -> None:
    """The chain kernel's match starts against a naive numpy match."""
    from .ops import chain_kernel, kernels
    tr = np.arange(256, dtype=np.uint8)
    prog = chain_kernel.compile_chain(terms, tr)
    if prog is None:
        failures.append(label + ":compile-rejected")
        return
    got = chain_kernel.chain_match_starts(kernels.to_device(text, device),
                                          prog)
    folded = tr[text]
    hits = np.zeros(len(text), dtype=bool)
    for t in terms:
        tf = tr[np.frombuffer(t, dtype=np.uint8)]
        L = len(tf)
        m = np.ones(len(text) - L + 1, dtype=bool)
        for k in range(L):
            m &= folded[k:len(text) - L + 1 + k] == tf[k]
        hits[:len(m)] |= m
    if not np.array_equal(got, np.flatnonzero(hits)):
        failures.append(label)


def gate_qgram(text: np.ndarray, terms: list, label: str, failures: list,
               device) -> None:
    """The q-gram kernel's candidates against a direct membership test,
    and qgram_lines' rows over them against the native pass
    qgram_first_per_line."""
    from . import native
    from .compile import multi
    from .ops import kernels, qgram_kernel
    tr = np.arange(256, dtype=np.uint8)
    tb = multi.build_qgram_tables(terms, tr)
    proj = multi.member_projection_1024(tb)
    if proj is None:
        failures.append(label + ":no-projection")
        return
    t = kernels.to_device(text, device)
    got = qgram_kernel.qgram_candidates(t, proj)
    f = (tr & 31).astype(np.uint32)[text]
    prev = np.concatenate([[np.uint32(0)], f[:-1]])
    if not np.array_equal(got, np.flatnonzero(proj[(f << 5) | prev])):
        failures.append(label)
    csr = multi.csr_tables(tb, terms)
    tables = qgram_kernel.line_tables(tb.member, tb.hash_id, *csr, tr,
                                      tb.p_size, tb.long_, False, t.device)
    rows, _k = qgram_kernel.qgram_lines(
        t, qgram_kernel.qgram_filter(t, qgram_kernel.words_tensor(
            proj, t.device)), tables)
    want = native.qgram_first_per_line(text, tb.member, tb.hash_id, *csr,
                                       tr, tb.p_size, bool(tb.long_),
                                       bool(tb.short), False)
    if want is None or not np.array_equal(rows.cpu().numpy(),
                                          np.stack(want, 1)):
        failures.append(label + ":lines")


def kernel_gate_text(text: np.ndarray, gate_bytes: int) -> np.ndarray:
    """The kernel gates' input: a quarter of the gate size (at most
    2 MB) of corpus, then as many uniform random bytes over 0-255, so
    that a wrong compare constant or range bound cannot hide behind the
    corpus's 12 words."""
    n = min(2 << 20, gate_bytes // 4)
    rnd = np.random.default_rng(11).integers(0, 256, n, dtype=np.uint8)
    return np.concatenate([text[:n], rnd])


def run_conformance_gate(tmpd: str, patfile: str, para_path: str,
                         text: np.ndarray, gate_bytes: int,
                         exe: str | None, device) -> str:
    """Every gate; returns "pass" or "FAIL:<labels>"."""
    failures: list = []
    conf_path = os.path.join(tmpd, "conf.txt")
    text[:gate_bytes].tofile(conf_path)
    names = {"conf": conf_path, "pats": patfile, "para": para_path}
    for label, argv in CLI_GATES:
        gate_cli([a.format(**names) for a in argv], label, failures, exe)
    ktext = kernel_gate_text(text, gate_bytes)
    terms = read_terms(patfile)
    gate_kernel_events(ktext, 0, None, "kernel_k0", failures)
    gate_kernel_events(ktext, 2, None, "kernel_k2", failures)
    gate_kernel_events(ktext, 3, (1, 1, 2), "kernel_costs", failures)
    gate_kernel_events(ktext, 1, None, "kernel_class18", failures,
                       pattern=FB_PAT)
    gate_regex_lanes(ktext, "kernel_regex", failures, device)
    gate_qgram(text[:min(len(text), 1 << 20)], terms, "kernel_qgram",
               failures, device)
    gate_chain(ktext, terms, "kernel_chain", failures, device)
    return "pass" if not failures else "FAIL:" + ",".join(failures)


# ---------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------

def samples_ms(fn, cuda: bool) -> list:
    """SAMPLES times of one call of fn, in ms: on the card each the mean
    of REPS launches by time_kernel; on the CPU one call on the host
    clock, after a warm-up call."""
    if cuda:
        from .ops.timing import time_kernel
        return [time_kernel(fn, REPS) for _ in range(SAMPLES)]
    fn()
    out = []
    for _ in range(SAMPLES):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _gbs(gbs: float) -> float:
    """A rate to 3 decimals; under 1 GB/s to 3 significant digits, so
    that a plain version's slow pass on the CPU never reads 0."""
    return round(gbs, 3) if gbs >= 1 else float("%.3g" % gbs)


def kernel_row(n_bytes: int, ms: list, bound: tuple, cuda: bool) -> dict:
    """A kernel row from its samples and its bound on the card; a CPU
    time is no share of the card's bound."""
    med = statistics.median(ms)
    return {"gbs": _gbs(n_bytes / med / 1e6), "ms": med,
            "min_ms": min(ms), "max_ms": max(ms), "bound_ms": bound[0],
            "bound_by": bound[1],
            "share_of_bound": bound[0] / med if cuda else None}


def bench_mask_machine(text_d, D: int, costs: tuple | None = None,
                       pattern: str = "matching") -> dict:
    """The mask_scan launch of scan_events over the whole corpus."""
    from .ops import kernels
    from .ops.timing import bound
    m, W, L = mask_machine(pattern, D, costs, text_d.device)
    N = text_d.numel()
    ms = samples_ms(lambda: kernels.mask_scan(text_d, m, W, L),
                    text_d.is_cuda)
    return kernel_row(N, ms, bound(m, N, W, L,
                                   kernels.mask_scan(text_d, m, W, L)),
                      text_d.is_cuda)


def bench_regex(text: np.ndarray, device) -> dict:
    """The lanes launch over the regex row's lines (regex_lines)."""
    import torch

    from .ops import kernels, renfa_kernel
    from .ops.timing import regex_bound
    mc = _query(REGEX_PAT, 2, None).re_mc
    R = min(REGEX_LINES, len(text) // REGEX_SLOT)
    flat, starts, lens = regex_lines(text, R, REGEX_SLOT)
    buf = kernels.to_device(flat, device)
    st, ln = (torch.from_numpy(starts).to(device),
              torch.from_numpy(lens).to(device))
    m = renfa_kernel.machine_from_mc(mc, device)
    cuda = buf.is_cuda
    # on the card the launch alone: the wrapper's bounds check waits for
    # the card
    run = (renfa_kernel._launch if cuda
           else renfa_kernel.renfa_lines_reference)
    ms = samples_ms(lambda: run(buf, st, ln, m, mc["inits"]), cuda)
    return kernel_row(len(flat), ms, regex_bound(m, len(flat), lens), cuda)


def bench_chain(text_d, terms: list) -> dict:
    """The chain_scan launch over the whole corpus with the 100
    patterns (identity fold)."""
    from .ops import chain_kernel
    from .ops.timing import chain_bound
    prog = chain_kernel.compile_chain(terms, np.arange(256, dtype=np.uint8))
    if prog is None:
        raise RuntimeError("compile_chain refused the %d patterns"
                           % len(terms))
    p = chain_kernel.device_program(prog, text_d.device)
    N = text_d.numel()
    ms = samples_ms(lambda: chain_kernel.chain_scan(text_d, p),
                    text_d.is_cuda)
    return kernel_row(N, ms, chain_bound(N), text_d.is_cuda)


def e2e_bps(argv: list, path: str) -> tuple:
    """(best bytes/s of two runs, stdout and exit code) of api.fileagrep
    on the current backend."""
    best, out = 0.0, None
    for _ in range(2):
        t0 = time.perf_counter()
        out = _fileagrep(argv + [path])
        best = max(best, os.path.getsize(path) / (time.perf_counter() - t0))
    return best, out


def link_gbs(arr: np.ndarray) -> float:
    """Host-to-device GB/s of one pageable copy of arr, the best of two."""
    import torch
    src = torch.from_numpy(np.ascontiguousarray(arr))
    best = 0.0
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        src.to("cuda")
        torch.cuda.synchronize()
        best = max(best, len(arr) / (time.perf_counter() - t0) / 1e9)
    return best


def _ref(row: dict, ref_bps: float | None) -> dict:
    row["ref_gbs"] = round(ref_bps / 1e9, 4) if ref_bps else None
    row["vs_ref"] = round(row["gbs"] / row["ref_gbs"], 1) \
        if ref_bps else None
    return row


def e2e_row(argv: list, path: str, exe: str | None) -> tuple:
    """(row, ok) of an end-to-end search: gbs on the default route,
    host_gbs on the numpy backend; ok when both print the same bytes and
    exit code (as the reference binary does, where there is one)."""
    bps, got = e2e_bps(argv, path)
    with _backend("numpy"):
        host_bps, want = e2e_bps(argv, path)
    ok = got == want and (exe is None
                          or got == oracle_run(exe, argv + [path]))
    row = {"gbs": _gbs(bps / 1e9), "host_gbs": _gbs(host_bps / 1e9)}
    return _ref(row, reference_bps(exe, path, argv)), ok


# ---------------------------------------------------------------------
# main
# ---------------------------------------------------------------------

def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m agrep_tpu_torch.bench",
        description="k=2 scan throughput and the BASELINE config rows on "
                    "one CUDA GPU, behind a conformance gate")
    ap.add_argument("--mb", type=float, default=256,
                    help="corpus size in MB (kernel rows; default 256)")
    ap.add_argument("--gate-mb", type=float, default=8,
                    help="the gate's corpus size in MB (default 8)")
    ap.add_argument("--para-mb", type=int, default=128,
                    help="the records corpus of f100_records in MB "
                         "(default 128)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu runs the plain PyTorch versions")
    return ap.parse_args(argv)


def run(args) -> dict:
    """The bench's JSON object (see the module docstring)."""
    from .ops import kernels
    from .ops import scan as scan_ops
    from .ops.timing import card_line
    scan_ops.require_device()
    cuda = args.device == "cuda"
    n_bytes = int(args.mb * (1 << 20))
    gate_bytes = int(args.gate_mb * (1 << 20))
    text = make_text(max(n_bytes, gate_bytes))
    exe = oracle_exe()
    out = {"metric": "k2_scan_throughput_per_chip", "value": None,
           "unit": "GB/s", "vs_baseline": None, "conformance": None,
           "configs": {}, "device": card_line() if cuda else "cpu",
           "gate_ref": ("the port's numpy backend and the reference binary"
                        if exe else "the port's numpy backend"),
           "baseline": "oracle" if exe else "absent"}
    with tempfile.TemporaryDirectory(prefix="agrep_bench_") as tmpd:
        patfile = make_patfile(tmpd)
        terms = read_terms(patfile)
        conf_para = make_para_corpus(tmpd, max(1, int(args.gate_mb)),
                                     "conf_para.txt")
        out["conformance"] = run_conformance_gate(
            tmpd, patfile, conf_para, text, gate_bytes, exe, args.device)
        if out["conformance"] != "pass":
            return out
        text = text[:n_bytes]
        # the reference binary's corpus: at most 64 MB, as in bench.py,
        # since that binary scans on one CPU core
        path = os.path.join(tmpd, "corpus.txt")
        text[:min(n_bytes, 64 << 20)].tofile(path)

        configs = out["configs"]
        text_d = kernels.to_device(text, args.device)
        for name, D, costs, pattern, ref_argv in MASK_ROWS:
            configs[name] = _ref(
                bench_mask_machine(text_d, D, costs, pattern),
                reference_bps(exe, path, ref_argv))
        configs["regex_k2"] = _ref(
            bench_regex(text, args.device),
            reference_bps(exe, path, ["-2", "-c", REGEX_PAT]))
        configs["fallback_class18"]["note"] = (
            "18-char scattered class, cube-cover kernel path")
        configs["f100_chain_kernel"] = _ref(
            bench_chain(text_d, terms),
            reference_bps(exe, path, ["-c", "-f", patfile]))

        # end to end: the reference binary's corpus, 16 MB of it, and the
        # records, each gated inline
        e2e_path = os.path.join(tmpd, "dev_e2e.txt")
        text[:E2E_MB << 20].tofile(e2e_path)
        para = make_para_corpus(tmpd, args.para_mb)
        f100 = ["-c", "-f", patfile]
        failed = []
        for name, argv, p in (
                ("f100_onepass", f100, path),
                ("f100_device_e2e", f100, e2e_path),
                ("f100_records", ["-c", "-d", "$$", "-f", patfile], para)):
            configs[name], ok = e2e_row(argv, p, exe)
            if not ok:
                failed.append(name)
        configs["f100_device_e2e"].update(
            conformance="FAIL" if "f100_device_e2e" in failed else "pass",
            link_gbs=(round(link_gbs(text[:E2E_MB << 20]), 3) if cuda
                      else None),
            note="CLI end-to-end on the default route, output gated "
                 "inline; link_gbs is the pageable host-to-device copy of "
                 "the same bytes")
        if failed:
            out["conformance"] = "FAIL:" + ",".join(failed)
            return out
    k2 = configs["k2"]
    out["value"] = k2["gbs"]
    out["vs_baseline"] = k2["vs_ref"]
    return out


def main(argv=None) -> int:
    """Runs the bench and prints its JSON line; 1 unless the gate
    passed."""
    args = parse_args(argv)
    from .ops import scan as scan_ops
    saved = (scan_ops._BACKEND, scan_ops._DEVICE)
    scan_ops.set_backend("torch")
    scan_ops.set_device(args.device)
    try:
        out = run(args)
    finally:
        scan_ops._BACKEND, scan_ops._DEVICE = saved
    print(json.dumps(out))
    return 0 if out["conformance"] == "pass" else 1


if __name__ == "__main__":
    sys.exit(main())
