#!/usr/bin/env python3
"""Smoke run of agrep_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py [--seed N] [--mb 100]

Phases, each printing its own lines; any failure raises and the script
exits non-zero:

  1. card: the GPU's name and power limit (nvidia-smi) and the torch and
     CUDA versions;
  2. build: compiles the four kernel sources (csrc/mask_scan.cu,
     renfa_lanes.cu, chain_scan.cu, qgram_filter.cu) with nvcc, every
     compile unit of all four started together, and times the build;
  3. parity: the mask_scan kernel against its plain PyTorch version
     (mask_scan_reference) on the card, bit for bit, over every variant,
     D, cost wiring, endpos shape and edge size the kernel takes (sizes
     whose last tile ends inside a later sub-tile among them), with the
     wrapper's own sub-tile split and with every split it may choose, and
     on machines with a sticky bit, which take whole tiles and whose
     split the launcher must refuse; then
     the renfa_lanes kernel against renfa_lines_reference, bit for bit,
     over regex machines (D = 0..4, -i, anchors, M - 1 from 0 to 30,
     15 and 16 among them) and line sets (R = 1, 31, 32, 33, 4097, empty
     lines, lengths at the length buckets' edges, a line over 49152
     bytes, a launch from the memory-mode seed states, lines of 0-33
     bytes starting at every offset mod 16 with the last newline the
     text's last byte, with every Next form and on views 1-15 bytes past
     an aligned address, and 100,000 lines on one block of 128 threads
     an SM, so that every warp walks many runs); then the chain_scan
     kernel against
     chain_scan_reference over term sets (1 term, config 5's 100, terms
     of 31-128 bytes, a full-byte-range set, a set whose terms run past
     the text's end into its zero pad, one-byte terms beside longer
     ones, a set at the 96-class cap; each with and without -i) and
     texts (N = 1, 15, 16, 17, 31, 32, 33, 4095, 4096, 4097, 8 MB), on
     views 1-15 bytes past an aligned address, and at 8 MB with one
     block an SM, so that each block walks several tiles; and the
     qgram_filter kernel against qgram_reference on
     2-gram, LONG and -i member sets at N = 1..33, 4065..4097 (every N
     mod 32), the sizes above and 8 MB (there with one block an SM too),
     each on views at offsets 1-15 too; phase 4 repeats every check at
     the main path's shapes;
  4. main path: a --mb MB ASCII corpus made from --seed, searched through
     agrep_tpu_torch.api.fileagrep with BASELINE configs 1-4 (the file
     is over the streaming threshold, so each run is chunked; config 4,
     the regex, runs as a count and as a line-numbered print) and
     through memagrep with configs 1 and 4 on the in-memory buffer; then
     BASELINE config 5 on a second corpus, the first with a blank line
     every 8-16 lines: -f with 100 patterns over '$$' records (config5),
     the same as a count (config5c) and through memagrep (memagrep5), a
     count with 400 patterns, past the chain kernel's caps (config5q),
     a boolean AND over '$$' records (bool5, the chain kernel), and a
     boolean with a term past the chain caps (bool5m, the mask
     machine's packed term words); stdout and return codes must equal
     the port's own numpy host backend, whose walls are printed beside
     the GPU route's, and every run must launch its kernel (config5q
     the q-gram kernel and no chain kernel);
  5. kernels: mask_scan's launch geometry (split, tiles a block, threads,
     dynamic shared memory; registers and spills from ptxas) and its
     time against its bound at all five main-path shapes, chain_scan's
     launch geometry (grid, blocks an SM, tile, threads, dynamic shared
     memory; registers and spills) at its four, renfa_lanes' (Next form,
     table bytes, threads, blocks an SM, grid, registers, spills) and
     time at its two, qgram_filter's (threads, blocks an SM, grid) and
     time at config5q's, each on a line of its own; then one JSON line
     with each kernel's launches on the main path, its time, its plain
     version's time and its bound on this card;
  6. scale-out: (a) phase 4's corpus cut into 4 shards with the
     MAX_RECORD halo, on parallel.dist.make_mesh() (all four on cuda:0 on
     a one-card machine), counted and located by distributed_scan_count /
     _offsets with three machines (-n matching, -2 -n matching, config
     3's cost wiring): totals, per-shard counts and offsets must equal
     the single-stream scan_events on the card and on the numpy backend;
     (b) entry.entry() against the plain version, and
     entry.dryrun_multichip(4); (c) two `python -m agrep_tpu_torch.cli`
     ranks (WORLD_SIZE=2, MASTER_ADDR=127.0.0.1, a free port, both bound
     to cuda:0) over phase 4's two corpora, each cut into 8 files of
     --mb/8 MB (over the 8 MB streaming threshold at the default size):
     configs 1, 2, 4 (-n), 5 (-f 100 patterns -d '$$'), config5q (-c -f
     400 patterns), -L 7:0:0 and mgrep -v -c -f; rank 0's stdout and both
     exit codes must equal the port's single-process run on the card
     (in this process; for configs 1 and 5 also one CLI process) and on
     the numpy backend, rank 1 must print nothing, and each rank must
     launch the search's kernel (the launch counts of its
     AGREP_TORCH_STATS line).  Its walls (one process against two ranks,
     the CLI processes' from start to exit) measure the partition's
     overhead and start-up: both ranks share the one card.  BASELINE
     config 5's sharded 10 GB corpus is cut to the two --mb corpora on
     one card, for the run's time limit.

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
# shared memory serves 128 B a clock per SM: 32 four-byte loads, issued
# on the load/store pipe beside the int32 lanes
SHARED_LOADS_PER_S = 132 * 32 * 1.98e9

CONFIGS = [
    ("config1", ["-c", "hello"]),
    ("config2", ["-1", "-n", "matching"]),
    ("config3", ["-3", "-D2", "-I1", "-S1", "-w", "-i", "approximate"]),
]
REGEX = "appro[a-z]*mat(e|ion)"          # BASELINE config 4
REGEX_CONFIGS = [
    ("config4", ["-2", "-c", REGEX]),
    ("config4n", ["-2", "-n", REGEX]),
]
CONFIG5_DELIM = ["-d", "$$"]               # BASELINE config 5's records
FILLER = [b"the", b"quick", b"brown", b"fox", b"pattern", b"search",
          b"world", b"lorem", b"ipsum", b"dolor", b"bibliography",
          b"string", b"grep", b"over", b"lazy", b"dog"]
PLANTS = [b"hello", b"matching", b"matchng", b"Approximate",
          b"aproximate", b"approximately", b"HELLO"]
# a boolean term past the chain kernel's 128 bytes a term
LONG_TERM = "hello" + "q" * 131


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


def make_records(corpus, seed: int):
    """Config 5's corpus: the corpus's lines with a blank line after every
    8-16 of them, so that -d '$$' (a blank line) cuts it into records;
    cut back to the corpus's size."""
    import numpy as np
    rng = np.random.default_rng(seed + 1)
    nl = np.flatnonzero(corpus == 0x0A)
    at = np.cumsum(rng.integers(8, 17, len(nl) // 8 + 1)) - 1
    at = at[at < len(nl)]
    return np.insert(corpus, nl[at] + 1, 0x0A)[:len(corpus)]


def make_patterns(n: int, seed: int) -> list:
    """Config 5's pattern file: the PLANTS, then random 5-10-letter words
    that no FILLER or PLANT word holds, so matches stay sparse.  The
    first k patterns of n are those of k."""
    import numpy as np
    rng = np.random.default_rng(seed + 2)
    pats = list(PLANTS)
    while len(pats) < n:
        w = bytes(rng.integers(97, 123, int(rng.integers(5, 11)))
                  .astype(np.uint8))
        if w not in pats and not any(w in f for f in FILLER + PLANTS):
            pats.append(w)
    return pats


def plant(text, terms, rng, fold: bool):
    """text with every term copied in at a few random offsets (each copy
    in random case when fold), ending in the bytes FE FD."""
    import numpy as np
    n = len(text)
    for t in terms:
        if len(t) >= n:
            continue
        for off in rng.integers(0, n - len(t), max(1, n // 4000)):
            b = t.swapcase() if fold and rng.integers(0, 2) else t
            text[off:off + len(t)] = np.frombuffer(b, dtype=np.uint8)
    text[-2:] = np.frombuffer(b"\xfe\xfd", dtype=np.uint8)[-min(n, 2):]
    return text


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


# regex machines: tests/test_renfa_kernel.py's patterns, the REGEXES of
# tests/test_conformance_more.py that compile to the regex engine,
# config 4's pattern at D = 0..4, anchors, and 29 positions (compile
# takes at most 30)
WIDE_REGEX = "abcdefghijklmnopqrstuvwxy(z|0)"     # 29 positions
REGEX_SPECS = [
    ("ab*c", 0), ("a(bc|de)f", 1), ("[a-d]x*[0-9]", 1), ("ab*c", 2),
    ("x.*y", 1), ("wo(r|t)king", 2),
    ("a(b|d)c", 3), ("colou|or", 2), ("h(el)*lo", 1), ("ab.*ld", 4),
    (REGEX, 0), (REGEX, 1), (REGEX, 2), (REGEX, 3), (REGEX, 4),
    ("^wo(r|t)king", 1), ("ab*c$", 0), ("^h(el)*lo$", 3),
    (WIDE_REGEX, 0), (WIDE_REGEX, 2),
    # 16 and 17 positions: M - 1 = 15 (the one-table form's largest) and
    # 16 (the smallest of the wide form); 31, which a '?' gives (maskgen
    # counts it as a position) and only the byte-table form takes
    ("abcdefghijkl(m|n)", 2), ("abcdefghijklm(n|o)", 1),
    ("abcdefghijklmnopqrstuvwx(y|z)?0?", 1),
]
RE_PLANTS = [b"abbbc", b"adef", b"ax3", b"xqqy", b"working", b"wotking",
             b"colour", b"hellello", b"approximate", b"APPROXIMATION",
             b"aproxmation", b"abd", b"abxyzld",
             b"abcdefghijklmnopqrstuvwxy0"]
# line lengths at the edges of the plain version's length buckets
# (ops/renfa.py MAXLINE_BUCKETS: a line of n bytes takes the bucket of
# n + 1), and past the last one
EDGE_LENS = [0, 30, 31, 32, 126, 127, 128, 510, 511, 512, 2046, 2047,
             2048]
LONG_LENS = [8191, 8192, 49153]


def synthetic_mc(M: int, D: int, seed: int) -> dict:
    """A regex machine of M positions with random follow bits, mask and
    no_err bits, for the M that compile_query never makes (it makes
    3..29): the kernel takes every M from 1 to 30."""
    import types

    import numpy as np

    from agrep_tpu_torch.ops import renfa
    rng = np.random.default_rng(seed)
    fb = np.zeros(33, dtype=np.uint32)
    fb[:M] = rng.integers(0, 1 << M, M, dtype=np.uint64).astype(np.uint32)
    auto = types.SimpleNamespace(m=M, follow_bits=fb, head_bit=1 << (M - 1))
    mask = rng.integers(0, 1 << 32, 256, dtype=np.uint64).astype(np.uint32)
    return renfa.machine_from_automaton(
        auto, mask, int(rng.integers(0, 1 << 32)) | 1, D, True, True)


# synthetic machines: M - 1 = 0, 1 and 29
SYNTHETIC_M = [(1, 1), (2, 0), (30, 2)]


def regex_machines():
    """(name, re_mc, extra line sets) of every regex machine phase 3
    holds the lanes kernel to, M - 1 from 0 to 30 (15 and 16 either side
    of the one-table form's edge).  The plain version steps one column
    at a time, so the bucket-edge lines go to five machines and the long
    lines to one."""
    from agrep_tpu_torch.compile.query import compile_query
    from agrep_tpu_torch.options import Options
    out = []
    for pat, d in REGEX_SPECS:
        q = compile_query(pat, Options(D=d, approx=d > 0))
        extra = []
        if pat in (REGEX, WIDE_REGEX) and d % 2 == 0:
            extra.append("edges")
        if (pat, d) == (REGEX, 0):
            extra.append("long")
        out.append(("%s D%d" % (pat, d), q.re_mc, extra))
    q = compile_query(REGEX, Options(D=2, approx=True, nocase="i"))
    out.append(("%s D2 -i" % REGEX, q.re_mc, []))
    for M, d in SYNTHETIC_M:
        out.append(("synthetic M=%d D%d" % (M, d), synthetic_mc(M, d, M),
                    []))
    return out


def make_lines(lens, rng):
    """A text of lines of the given lengths, each ended by '\\n':
    printable bytes, with a RE_PLANTS sample at the start or the end of
    every third line that fits one.  Returns (text, starts)."""
    import numpy as np
    lens = np.asarray(lens, dtype=np.int64)
    text = rng.integers(32, 127, size=int(lens.sum()) + len(lens),
                        dtype=np.uint8)
    starts = np.concatenate([[0], np.cumsum(lens + 1)[:-1]]) \
        .astype(np.int64)
    text[starts + lens] = 0x0A
    for r in range(0, len(lens), 3):
        p = RE_PLANTS[(r // 3) % len(RE_PLANTS)]
        if lens[r] >= len(p):
            off = int(starts[r]) + (0 if r % 2 else int(lens[r]) - len(p))
            text[off:off + len(p)] = np.frombuffer(p, dtype=np.uint8)
    return text, starts


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


def nxt_ops(M: int) -> tuple:
    """(int32 operations, shared loads) of one nxt at its least: a load
    from the reference's tabulated Next (ops/renfa.py
    next_tables_arrays), indexed by the state's bits 1..M-1.  Up to 15
    index bits the table (128 KB at most) fits the 227 KB of shared
    memory a block can take: one three-input logic op (LOP3) masks the
    index, with an OR of two states fused in, one LEA scales it to an
    address, one load.  Above 15, two half tables: two index and two
    scale ops, one OR, two loads.  M <= 1: nxt is the constant head
    bit."""
    rel = max(M - 1, 0)
    if rel == 0:
        return 0, 0
    return (2, 1) if rel <= 15 else (5, 2)


def regex_byte_ops(D: int, M: int) -> tuple:
    """(int32 operations, shared loads) of one text byte of the lanes
    machine at its least, with the ORs and ANDs fused into LOP3s.  nxt is
    an OR over the set bits of its argument, so re1's nxt(s[k-1] |
    nw[k-1]) is nxt(s[k-1]) | nxt(nw[k-1]), both already at hand when
    each state's nxt is carried beside it: a byte takes one nxt a level.
    The byte's extract from a wide load and its scale to a CMask address
    (2) and the CMask load; level 0 is (n & cm) | (init1 & s) (2 LOP3)
    and the new state's nxt; level k is the eight-input combine (4 LOP3)
    and the new state's nxt.  The loop's control, amortized by
    unrolling, is not counted."""
    no, nl = nxt_ops(M)
    return 2 + 2 + no + D * (4 + no), 1 + nl * (D + 1)


def regex_verdict_ops(tail: bool, M: int) -> tuple:
    """(int32 operations, shared loads) of a line's verdict at its
    newline at its least: CMask['\\n'] is a constant and nxt(s[D]) is
    carried; 2 LOP3 form ad; the tail step is nxt and a LOP3 that takes
    the & 1 too (without it, the & 1 alone)."""
    no, nl = nxt_ops(M)
    if tail:
        return no + 3, nl
    return 3, 0


def regex_bound(m, n_text: int, lens) -> tuple:
    """(bound_ms, bound_by) of one lanes launch over R lines, from the
    function's least work (not this kernel's): the largest of the text
    read once, 16 B of line index and 1 B of verdict a line and the
    machine (CMask and the follow bits) over HBM's rate; the int32
    operations of every line's bytes and verdict over the card's int32
    rate; and their shared loads over the shared-memory rate."""
    R = len(lens)
    n_bytes = n_text + 17 * R + 256 * 4 + 4 * m.M
    (bo, bl), (vo, vl) = (regex_byte_ops(m.D, m.M),
                          regex_verdict_ops(m.tail, m.M))
    n = int(lens.sum())
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max((n * bo + R * vo) / INT32_OPS_PER_S,
                (n * bl + R * vl) / SHARED_LOADS_PER_S)
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def chain_ops() -> tuple:
    """(int32 operations, shared loads) of one text byte of the chain
    function at its least: a multi-string (Aho-Corasick) automaton over
    the folded classes with its transition table in shared memory
    (config 5's 784 states times 32 classes at 2 B an entry is 50 KB):
    the byte's class load and the transition load, the next-state index
    (one IMAD), the state's accept bit tested and merged into the output
    word (2 LOP3/SHF).  Moving a match's bit from its end to its start
    costs a few operations for each of the run's sparse matches, which
    this count leaves out."""
    return 3, 2


def chain_bound(N: int) -> tuple:
    """(bound_ms, bound_by) of one chain scan of N bytes: the text read
    once and the start plane written once over HBM's rate, against
    chain_ops over the int32 and shared-load rates.  The TPU kernel's
    bit-plane form does about 80 operations a byte for config 5's terms:
    that is one design's count, not the function's least work, and is
    not the bound."""
    ops, loads = chain_ops()
    t_bytes = (N + 4 * -(-N // 32)) / HBM_BYTES_PER_S
    t_ops = max(N * ops / INT32_OPS_PER_S, N * loads / SHARED_LOADS_PER_S)
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def qgram_ops() -> tuple:
    """(int32 operations, shared loads) of one text byte of the q-gram
    filter at its least: the byte's low 5 bits (kept for the next byte's
    previous), the member word's load (its index is those bits), the
    shift by the previous byte's bits and the bit's merge into the
    output word (2 LOP3/SHF), and the byte's extract from a wide load."""
    return 4, 1


def qgram_bound(N: int) -> tuple:
    """(bound_ms, bound_by) of one q-gram filter of N bytes: the text
    read once, the 128 B member set and the candidate plane written once
    over HBM's rate, against qgram_ops over the int32 and shared-load
    rates."""
    ops, loads = qgram_ops()
    t_bytes = (N + 128 + 4 * -(-N // 32)) / HBM_BYTES_PER_S
    t_ops = max(N * ops / INT32_OPS_PER_S, N * loads / SHARED_LOADS_PER_S)
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


# clock cycles the card spins a timed call before time_kernel's first
# event (about 0.1 ms at 1.98 GHz)
SPIN_CYCLES = 200000


def time_kernel(fn, reps: int = 5) -> float:
    """ms per call of fn on the card: CUDA events around reps calls after
    one warm-up call.  The card first spins (SPIN_CYCLES a call, doubled
    up to 4 times while too short), so that the host has queued every
    call before the first event: the events then hold the calls' device
    time, not the host's time to launch them.  That the spin outlasted
    the queuing is checked -- the first event must still be pending once
    the last call is queued -- and a timing whose spin never did raises,
    as does an fn that waits for the card."""
    import torch
    fn()
    torch.cuda.synchronize()
    for k in range(5):
        torch.cuda._sleep(SPIN_CYCLES * reps << k)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued_first = not a.query()
        torch.cuda.synchronize()
        if queued_first:
            return a.elapsed_time(b) / reps
    raise RuntimeError("time_kernel: the card finished its spin of %d "
                       "cycles before the host had queued %d calls"
                       % (SPIN_CYCLES * reps << 4, reps))


def profiled_ms(fn, kernel: str, reps: int):
    """Device ms per launch of the kernels whose name holds `kernel`, as
    torch.profiler's CUDA activity reads them over reps calls of fn, or
    None when the trace holds no device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if kernel in e.key]
    total = sum(getattr(e, "device_time_total", 0) for e in evs)
    count = sum(e.count for e in evs)
    return total / count / 1e3 if count and total else None


# ---------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------

def phase_build() -> None:
    """Build every kernel source from the checkout, all compile units of
    all sources started together."""
    from agrep_tpu_torch.ops import _cuda
    names = list(_cuda.SOURCES)
    t0 = time.perf_counter()
    paths = _cuda.build_all(names)
    for name in names:
        _cuda.load(name)
    dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    from agrep_tpu_torch import native
    if native.get_lib() is None:
        raise RuntimeError("the native host library did not build")
    print("build: native host library (g++) in %.2f s"
          % (time.perf_counter() - t0))
    for name in names:
        log = _cuda.build_logs.get(name, "")
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        frames = [int(x) for x in re.findall(r"(\d+) bytes stack frame",
                                             log)]
        spills = [int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
        print("build: %s.cu -> %s (%d compile units); %d kernels; "
              "registers max %s; stack frame max %s B; kernels that "
              "spill: %d"
              % (name, os.path.relpath(paths[name], REPO),
                 len(_cuda.UNITS.get(name, [()])), len(regs),
                 max(regs, default="n/a"), max(frames, default="n/a"),
                 sum(1 for sp in spills if sp)))
    print("build: %d compile units of %d sources in parallel in %.2f s"
          % (sum(len(_cuda.UNITS.get(n, [()])) for n in names),
             len(names), dt))


def sticky(m):
    """The machine with a sticky bit (init1_ns keeps bit 0 of init0): an
    unbounded dependence window, which the kernel scans in whole tiles."""
    import dataclasses
    return dataclasses.replace(m, init1_ns=m.init1_ns | 1)


def phase_parity(device: str, seed: int, big: int) -> float:
    """Kernel planes vs plain planes on every machine and edge size, for
    the wrapper's own sub-tile split and for every split it may choose
    (only whole tiles for the sticky machines, where the launcher must
    refuse a split); returns the largest |kernel - plain| word difference
    (0 or fail)."""
    import numpy as np
    import torch

    from agrep_tpu_torch.ops import kernels
    from agrep_tpu_torch.ops.scan import DEFAULT_TILE as L
    rng = np.random.default_rng(seed)
    worst = 0
    texts = {}
    failed = []
    machines = []
    for name, table, consts, D, variant, costs in parity_machines():
        m = kernels.machine_from_arrays(table, consts, D, variant, costs,
                                        device)
        machines.append((name, m, halo(consts, D, L)))
        if name in ("bitap_D2", "bitap_costs211_D3", "bitap_delim_dollar"):
            machines.append((name + "_sticky", sticky(m),
                             halo(consts, D, L)))
    for name, m, W in machines:
        # sub-tile edges: the last tile ends inside a later sub-tile
        sizes = (1, W - 1, L, L + 1, 2 * L + W + 33, 3 * L + 17,
                 3 * L + 600, big)
        splits = kernels.SPLITS if kernels.bounded(m) else (1,)
        n_hits = n_delims = 0
        bad = []
        t0 = time.perf_counter()
        used = set()
        for N in sizes:
            if N not in texts:
                texts[N] = kernels.to_device(random_text(N, rng), device)
            text = texts[N]
            want = kernels.mask_scan_reference(text, m, W, L)
            auto = kernels.launch_geometry(N, m, W, L, device)["s"]
            for s in (None,) + splits:
                got = (kernels.mask_scan(text, m, W, L) if s is None
                       else kernels._launch(text, m, W, L, s))
                used.add(auto if s is None else s)
                if got.shape != want.shape:
                    raise AssertionError("%s N=%d s=%s: shape %s vs %s" % (
                        name, N, s, tuple(got.shape), tuple(want.shape)))
                diff = _max_diff(got, want)
                worst = max(worst, diff)
                if diff != 0:
                    bad.append((N, s))
                    where = (got != want).nonzero()[:4].tolist()
                    print("parity: %s N=%d s=%s MISMATCH max |diff| %d; "
                          "first (plane, tile, word, kernel, plain): %s"
                          % (name, N, s, diff, [
                              (p, t, w, hex(int(got[p, t, w])),
                               hex(int(want[p, t, w])))
                              for p, t, w in where]))
            n_hits += int((want[1:] != 0).sum().item())
            n_delims += int((want[0] != 0).sum().item())
        if not kernels.bounded(m):
            # no fallback: a split of an unbounded machine is refused
            try:
                kernels._launch(texts[L], m, W, L, 2)
            except RuntimeError:
                pass
            else:
                raise AssertionError("%s: the launcher took s=2 for an "
                                     "unbounded machine" % name)
        torch.cuda.synchronize()
        if bad:
            failed.append((name, bad))
            continue
        print("parity: %-26s W=%-3d N=%s s=%s equal bit for bit (nonzero "
              "words: %d hit, %d delimiter) %.1f s"
              % (name, W, list(sizes), sorted(used), n_hits, n_delims,
                 time.perf_counter() - t0))
    if failed:
        raise AssertionError("kernel planes differ from "
                             "mask_scan_reference: %s" % failed)
    return float(worst)


def offset_lines(rng):
    """Lines of lengths 0-33 (around the kernel's 16-byte pieces) and
    47-49, 63-65, line i starting at i mod 16 (bytes between the lines
    pad them there), the last line's newline the text's last byte.
    Returns (text, starts, lens)."""
    import numpy as np
    lens = list(range(34)) + [47, 48, 49, 63, 64, 65]
    lens += [int(x) for x in rng.integers(0, 66, 24)]
    text = bytearray()
    starts = []
    for i, ln in enumerate(lens):
        text += b"x" * ((i - len(text)) % 16)
        starts.append(len(text))
        line = bytearray(rng.integers(97, 123, ln, dtype=np.uint8))
        p = RE_PLANTS[i % len(RE_PLANTS)]
        if len(p) <= ln:
            off = 0 if i % 2 else ln - len(p)
            line[off:off + len(p)] = p
        text += line + b"\n"
    return (np.frombuffer(bytes(text), np.uint8).copy(),
            np.array(starts, dtype=np.int64), np.array(lens, dtype=np.int64))


# the persistent-grid check: this many short lines, 128 threads a block
# and one block an SM, so that every warp walks many runs of 32 lines
GRID_LINES = 100000


def phase_parity_regex(device: str, seed: int) -> float:
    """Lanes-kernel verdicts vs plain verdicts on every regex machine and
    line set, with the wrapper's own launch, with every Next form on the
    lines at every offset mod 16 (on views 1-15 bytes past an aligned
    address too), and with one block of 128 threads an SM over
    GRID_LINES lines; returns the largest |kernel - plain| (0 or fail)."""
    import numpy as np
    import torch

    from agrep_tpu_torch.ops import kernels, renfa, renfa_kernel
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 100, 4097)
    lens[::8] = 0
    sets = {}
    text, starts = make_lines(lens, rng)
    for R in (1, 31, 32, 33, 4097):
        idx = np.arange(R)
        if R == 4097:
            idx = np.argsort(lens, kind="stable")  # the main path's order
        sets["R=%d" % R] = (text, starts[idx], lens[idx])
    for name, ls in (("edges", EDGE_LENS), ("long", LONG_LENS)):
        t, st = make_lines(ls, rng)
        sets[name] = (t, st, np.asarray(ls, dtype=np.int64))
    sets["offsets"] = offset_lines(rng)
    glens = np.sort(rng.integers(0, 60, GRID_LINES))
    t, st = make_lines(glens, rng)
    sets["grid"] = (t, st, glens)
    dev_sets = {k: (kernels.to_device(t, device),
                    torch.from_numpy(st).to(device),
                    torch.from_numpy(ln).to(device))
                for k, (t, st, ln) in sets.items()}
    # the offsets set again on views 1-15 bytes past an aligned address,
    # in a buffer whose bytes around the view are not newlines
    t_off = dev_sets["offsets"][0]
    for o in range(1, 16):
        buf = torch.full((t_off.numel() + 32,), 0xA5, dtype=torch.uint8,
                         device=device)
        buf[o:o + t_off.numel()] = t_off
        dev_sets["offsets@%d" % o] = ((buf[o:o + t_off.numel()],)
                                      + dev_sets["offsets"][1:])
    worst = 0
    failed = []
    walks = None
    for name, mc, extra in regex_machines():
        m = renfa_kernel.machine_from_mc(mc, device)
        cont, _ = renfa.step_newline(list(mc["inits"]),
                                     int(mc["mask"][0x0A]), mc)
        # memory mode's seed (regex_engine.search_stream): re() seeds
        # Init[0] at every level, re1() the Init[k] closures
        seed0 = ([int(mc["init0"])] * (m.D + 1) if m.M <= 15
                 else list(mc["inits"]))
        # (label, set, init, launch arguments past the wrapper's)
        runs = [(k, k, cont, None) for k in sets
                if k.startswith("R=")]
        runs.append(("R=33 seed", "R=33", seed0, None))
        runs += [(k, k, cont, None) for k in extra]
        runs += [("offsets %s" % f, "offsets", cont, {"form": f})
                 for f in renfa_kernel.forms(m.M)]
        runs += [("offsets@%d" % o, "offsets@%d" % o, cont, None)
                 for o in range(1, 16)]
        runs.append(("grid 1x128", "grid", cont,
                     {"threads": 128, "blocks_per_sm": 1}))
        t0 = time.perf_counter()
        n_true = 0
        bad = []
        for label, key, init, kw in runs:
            text_d, st_d, ln_d = dev_sets[key]
            if kw is None:
                got = renfa_kernel.renfa_lines(text_d, st_d, ln_d, m, init)
            else:
                got = renfa_kernel._launch(text_d, st_d, ln_d, m, init,
                                           **kw)
            want = renfa_kernel.renfa_lines_reference(text_d, st_d, ln_d,
                                                      m, init)
            diff = int((got.to(torch.int64) - want.to(torch.int64))
                       .abs().max().item())
            worst = max(worst, diff)
            n_true += int(want.sum().item())
            if diff:
                where = (got != want).nonzero()[:4, 0].tolist()
                bad.append(label)
                print("parity: regex %s %s MISMATCH; first (line, start, "
                      "len, kernel, plain): %s"
                      % (name, label, [
                          (r, int(st_d[r]), int(ln_d[r]), bool(got[r]),
                           bool(want[r])) for r in where]))
        torch.cuda.synchronize()
        if walks is None:
            g = renfa_kernel.launch_geometry(GRID_LINES, m, device,
                                             threads=128, blocks_per_sm=1)
            walks = GRID_LINES / 32 / (g["grid"] * g["threads"] // 32)
        if bad:
            failed.append((name, bad))
            continue
        print("parity: regex %-38s M=%-2d form %s, %s equal bit for bit "
              "(%d true verdicts) %.1f s"
              % (name, m.M, renfa_kernel.table_form(m.M),
                 [r[0] for r in runs if not r[0].startswith("offsets@")]
                 + ["offsets@1-15"], n_true, time.perf_counter() - t0))
    print("parity: regex grid 1x128 walks %.1f runs of 32 lines a warp"
          % walks)
    if failed:
        raise AssertionError("lanes verdicts differ from "
                             "renfa_lines_reference: %s" % failed)
    return float(worst)


def chain_sets(pats100) -> list:
    """(name, terms, fold) of every term set phase 3 holds the chain
    kernel to, each with and without -i folding."""
    import numpy as np
    rng = np.random.default_rng(5)
    sets = [
        ("1 term", [b"hello"]),
        ("100 terms", pats100),
        ("31..128 B", [bytes(rng.integers(97, 123, n).astype(np.uint8))
                       for n in (31, 32, 33, 64, 65, 128)]),
        # tests/test_chain_kernel.py test_full_byte_range's shape
        ("full bytes", [b"\x00\xff", bytes(range(200, 212)),
                        b"\x80\x00\x7f", b"\n\n", b"ab\x00c"]),
        # plant() ends every text in FE FD: these run into the zero pad
        ("zero pad", [b"\xfe\xfd\x00\x00", b"\xfd\x00", b"hello"]),
        # one-byte terms match whatever follows them
        ("one-byte", [b"Q", b"\n", b"hello", b"ab", b"~", b"xyz\x00"]),
        ("96 classes", cap_classes(rng)),
    ]
    return [(name + (" -i" if fold else ""), terms, fold)
            for name, terms in sets for fold in (False, True)]


def cap_classes(rng) -> list:
    """Terms of 2-7 bytes that hold every byte 32..127 once (96 classes,
    the chain kernel's cap), three one-byte terms and a 128-byte term."""
    import numpy as np
    order = rng.permutation(np.arange(32, 128, dtype=np.uint8))
    cuts = np.cumsum(rng.integers(2, 8, 48))
    terms = [bytes(c) for c in np.split(order, cuts[cuts < 96]) if len(c)]
    return terms + [b"!", b"@", b"~", bytes(rng.integers(
        32, 128, 128).astype(np.uint8))]


def qgram_sets() -> list:
    """(name, terms, fold) of every member set phase 3 holds the q-gram
    kernel to: 2-gram tables, LONG (3-gram) tables (multilen > 400) and
    -i folding."""
    import numpy as np
    rng = np.random.default_rng(6)

    def words(k, lo, hi):
        return [bytes(rng.integers(97, 123, int(rng.integers(lo, hi)))
                      .astype(np.uint8)) for _ in range(k)]
    return [("2-gram", words(30, 3, 7), False),
            ("LONG", words(60, 5, 11), False),
            ("2-gram -i", words(30, 3, 7), True)]


PARITY_SIZES = (1, 15, 16, 17, 31, 32, 33, 4095, 4096, 4097)


def phase_parity_multi(device: str, seed: int, big: int, pats100) -> tuple:
    """chain_scan planes vs chain_scan_reference planes, and qgram_filter
    planes vs qgram_reference planes, on every set and size; returns the
    largest |kernel - plain| word difference of each (0 or fail)."""
    import numpy as np
    import torch

    from agrep_tpu_torch.compile import multi
    from agrep_tpu_torch.ops import chain_kernel, kernels, qgram_kernel
    from agrep_tpu_torch.runtime.mgrep import _fold_tr
    rng = np.random.default_rng(seed)
    sizes = PARITY_SIZES + (big,)
    base = {n: random_text(n, rng) for n in sizes}
    base_bytes = {n: rng.integers(0, 256, n, dtype=np.uint8) for n in sizes}
    worst = {"chain_scan": 0, "qgram_filter": 0}
    failed = []

    def check(kname, name, n, got, want):
        diff = _max_diff(got, want)
        worst[kname] = max(worst[kname], diff)
        if diff:
            where = (got != want).nonzero()[:4, 0].tolist()
            print("parity: %s %s N=%d MISMATCH; first (word, kernel, "
                  "plain): %s" % (kname, name, n, [
                      (w, hex(int(got[w]) & 0xFFFFFFFF),
                       hex(int(want[w]) & 0xFFFFFFFF)) for w in where]))
            failed.append((kname, name, n))

    for name, terms, fold in chain_sets(pats100):
        tr = _fold_tr(fold)
        prog = chain_kernel.compile_chain(terms, tr)
        if prog is None:
            raise AssertionError("chain set %s does not compile" % name)
        p = chain_kernel.device_program(prog, device)
        t0 = time.perf_counter()
        hits = 0
        for n in sizes:
            src = base_bytes if name.startswith("full") else base
            text = kernels.to_device(plant(src[n].copy(), terms, rng, fold),
                                     device)
            want = chain_kernel.chain_scan_reference(text, p)
            check("chain_scan", name, n, chain_kernel.chain_scan(text, p),
                  want)
            hits += _set_bits(want)
            # at 8 MB one block an SM, so that each block walks several
            # tiles
            if n == big:
                check("chain_scan", name + " blocks/SM=1", n,
                      chain_kernel._launch(text, p, blocks_per_sm=1), want)
            # views 1-15 bytes past an aligned address, in a buffer whose
            # bytes around the view are not 0
            buf = torch.full((n + 32,), 0xA5, dtype=torch.uint8,
                             device=device)
            for o in range(1, 16):
                view = buf[o:o + n]
                view.copy_(text)
                check("chain_scan", name + " offset %d" % o, n,
                      chain_kernel.chain_scan(view, p), want)
                view.fill_(0xA5)
        torch.cuda.synchronize()
        geo = chain_kernel.launch_geometry(big, p, device, blocks_per_sm=1)
        print("parity: chain %-16s %3d terms, %4d positions, %2d classes, "
              "N=%s equal bit for bit (%d starts), and on views at offsets "
              "1-15; at 8 MB blocks/SM=1 walks %.1f tiles a block %.1f s"
              % (name, len(terms), sum(len(t) for t in prog[1]),
                 len(prog[0]), list(sizes), hits,
                 geo["tiles"] / geo["grid"],
                 time.perf_counter() - t0))
    # every N mod 32 (so mod 16 too), short and past 4 KB, and 8 MB
    qsizes = sorted(set(PARITY_SIZES) | set(range(1, 34))
                    | set(range(4065, 4098))) + [big]
    for n in qsizes:
        if n not in base:
            base[n] = random_text(n, rng)
    for name, terms, fold in qgram_sets():
        tr = _fold_tr(fold)
        tb = multi.build_qgram_tables(terms, tr)
        proj = multi.member_projection_1024(tb)
        words = qgram_kernel.words_tensor(proj, device)
        t0 = time.perf_counter()
        hits = 0
        for n in qsizes:
            text = kernels.to_device(plant(base[n].copy(), terms, rng, fold),
                                     device)
            want = qgram_kernel.qgram_reference(text, words)
            check("qgram_filter", name, n,
                  qgram_kernel.qgram_filter(text, words), want)
            hits += _set_bits(want)
            if n == big:
                check("qgram_filter", name + " blocks/SM=1", n,
                      qgram_kernel._launch(text, words, blocks_per_sm=1),
                      want)
            # views 1-15 bytes past an aligned address, in a buffer whose
            # bytes around the view are not 0
            buf = torch.full((n + 32,), 0xA5, dtype=torch.uint8,
                             device=device)
            for o in range(1, 16):
                view = buf[o:o + n]
                view.copy_(text)
                check("qgram_filter", name + " offset %d" % o, n,
                      qgram_kernel.qgram_filter(view, words), want)
                view.fill_(0xA5)
        torch.cuda.synchronize()
        print("parity: qgram %-10s %2d terms, LONG=%d, %4d member grams, "
              "N=1..33, 4065..4097, %s equal bit for bit (%d candidates), "
              "and on views at offsets 1-15; at 8 MB also blocks/SM=1 %.1f s"
              % (name, len(terms), tb.long_, int(proj.sum()),
                 [n for n in qsizes if 33 < n < 4065 or n > 4097], hits,
                 time.perf_counter() - t0))
    if failed:
        raise AssertionError("multi-pattern kernels differ from their "
                             "plain versions: %s" % failed)
    return float(worst["chain_scan"]), float(worst["qgram_filter"])


def _run(api_fn, argv, data=None):
    buf = io.BytesIO()
    if data is None:
        rc = api_fn(argv, output=buf)
    else:
        rc = api_fn(argv, data, output=buf)
    out = buf.getvalue()
    return hashlib.sha256(out).hexdigest(), rc & 0xFF, len(out)


def _time_plain(fn) -> float:
    """ms of one call of a plain version on the card, after one warm-up
    call (which also warms the allocator)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _set_bits(t) -> int:
    """Number of set bits in a tensor of u32 words (int32 or uint32)."""
    import torch
    w = t.to(torch.int64) & 0xFFFFFFFF
    return int(sum(((w >> b) & 1).sum().item() for b in range(32)))


def _max_diff(a, b) -> int:
    import torch
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def phase_main(device: str, seed: int, mb: int, card: str) -> dict:
    import numpy as np
    import torch

    from agrep_tpu_torch import api
    from agrep_tpu_torch.compile.query import compile_query
    from agrep_tpu_torch.ops import chain_kernel, kernels, qgram_kernel
    from agrep_tpu_torch.ops import renfa, renfa_kernel
    from agrep_tpu_torch.ops import scan as scan_ops
    from agrep_tpu_torch.options import parse_args

    counts = _launch_counts()
    n_bytes = mb << 20
    corpus = make_corpus(n_bytes, seed)
    records = make_records(corpus, seed)
    pats = make_patterns(400, seed)
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    res = {}
    mem_data = b"\n" + corpus.tobytes()
    mem_records = b"\n" + records.tobytes()
    # the inputs of each kernel wrapper's last call in each run, for the
    # kernel-alone checks below (the wrappers still count their launches)
    seen: dict = {}
    real = {"chain_scan": (chain_kernel, chain_kernel.chain_scan),
            "qgram_filter": (qgram_kernel, qgram_kernel.qgram_filter),
            "mask_scan": (kernels, kernels.mask_scan)}

    def recorder(kname, fn):
        def call(*args):
            seen[kname] = args
            return fn(*args)
        return call

    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = os.path.join(tmp, "corpus.txt")
        corpus.tofile(path)
        rec = os.path.join(tmp, "records.txt")
        records.tofile(rec)
        p100 = os.path.join(tmp, "pats100.txt")
        p400 = os.path.join(tmp, "pats400.txt")
        for f, k in ((p100, 100), (p400, 400)):
            with open(f, "wb") as fh:
                fh.write(b"".join(w + b"\n" for w in pats[:k]))
        runs = ([(name, api.fileagrep, argv + [path], None, "mask_scan")
                 for name, argv in CONFIGS]
                + [(name, api.fileagrep, argv + [path], None, "renfa_lanes")
                   for name, argv in REGEX_CONFIGS])
        # memory mode of the bitap engine is a per-byte host loop
        # (bitap.c:309-446 emulation); the sgrep engine scans on the card,
        # and so does the regex engine, its virtual leading line included
        runs.append(("memagrep", api.memagrep, CONFIGS[0][1], mem_data,
                     "mask_scan"))
        runs.append(("memagrep4", api.memagrep, REGEX_CONFIGS[0][1],
                     mem_data, "renfa_lanes"))
        # BASELINE config 5 on its records corpus: 100 patterns take the
        # chain kernel, 400 (past its caps) the q-gram kernel, a boolean
        # of two terms the chain kernel too, and a boolean with a term
        # past the chain caps the mask machine's packed term words
        c5 = ["-f", p100] + CONFIG5_DELIM
        runs += [
            ("config5", api.fileagrep, c5 + [rec], None, "chain_scan"),
            ("config5c", api.fileagrep, ["-c", "-f", p100, rec], None,
             "chain_scan"),
            ("config5q", api.fileagrep, ["-c", "-f", p400, rec], None,
             "qgram_filter"),
            ("memagrep5", api.memagrep, c5, mem_records, "chain_scan"),
            ("bool5", api.fileagrep, CONFIG5_DELIM + ["hello;lazy", rec],
             None, "chain_scan"),
            ("bool5m", api.fileagrep,
             CONFIG5_DELIM + ["hello;matching," + LONG_TERM, rec], None,
             "mask_scan"),
        ]
        progs = {k: chain_kernel.compile_chain(
            pats[:k], np.arange(256, dtype=np.uint8)) for k in (100, 400)}
        if progs[100] is None or progs[400] is not None:
            raise AssertionError("config 5's 100 patterns must compile to "
                                 "a chain program and its 400 must not")

        # the main path, on the card: counts start at 0 here
        scan_ops.set_backend("torch")
        _zero(counts)
        for kname, (mod, fn) in real.items():
            setattr(mod, kname, recorder(kname, fn))
        got, inputs = {}, {}
        try:
            for name, fn, argv, data, kname in runs:
                before = {k: c[k] for k, c in counts.items()}
                seen.clear()
                t0 = time.perf_counter()
                got[name] = _run(fn, argv, data)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                n = {k: c[k] - before[k] for k, c in counts.items()}
                if n[kname] == 0:
                    raise AssertionError("%s: the main path launched no %s "
                                         "kernel" % (name, kname))
                if name == "config5q" and n["chain_scan"]:
                    raise AssertionError("config5q launched the chain "
                                         "kernel past its caps")
                inputs[name] = dict(seen)
                res[name] = {"wall_s": wall, "launches": n[kname],
                             "kernel": kname}
        finally:
            for kname, (mod, fn) in real.items():
                setattr(mod, kname, fn)
        main_launches = {k: c[k] for k, c in counts.items()}

        # the same runs on the port's exact host backend (native C passes)
        scan_ops.set_backend("numpy")
        try:
            for name, fn, argv, data, _k in runs:
                t0 = time.perf_counter()
                want = _run(fn, argv, data)
                res[name]["host_wall_s"] = time.perf_counter() - t0
                if got[name][:2] != want[:2]:
                    raise AssertionError(
                        "%s: stdout sha256/rc %s on the GPU, %s on the "
                        "numpy backend" % (name, got[name][:2], want[:2]))
        finally:
            scan_ops.set_backend("torch")

    # the mask kernel alone at the main path's chunk shape, and at the
    # memagrep buffer's
    chunk = corpus[:scan_ops.STREAM_CHUNK]
    text = kernels.to_device(chunk, device)
    mem_text = kernels.to_device(np.frombuffer(mem_data, np.uint8), device)
    for name, argv in CONFIGS + [("memagrep", CONFIGS[0][1])]:
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
        t = mem_text if name == "memagrep" else text
        ms = time_kernel(lambda: kernels.mask_scan(t, m, W, L))
        planes = kernels.mask_scan(t, m, W, L)
        plain_ms = _time_plain(
            lambda: kernels.mask_scan_reference(t, m, W, L))
        # the kernel against its plain version at this shape too
        diff = _max_diff(planes, kernels.mask_scan_reference(t, m, W, L))
        if diff != 0:
            raise AssertionError("%s: kernel planes differ from "
                                 "mask_scan_reference on %d bytes "
                                 "(max |diff| %d)" % (name, t.numel(), diff))
        bms, by = bound(m, t.numel(), W, L, planes)
        res[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                         bound_by=by, shape_b=t.numel(), max_abs_err=diff,
                         geometry=kernels.launch_geometry(t.numel(), m, W,
                                                          L, device))

    # the lanes kernel alone on the same chunk and on the memagrep
    # buffer, each split into its lines in the length order the engine
    # launches them in
    opts, pattern, _ = parse_args(REGEX_CONFIGS[0][1] + ["x"])
    mc = compile_query(pattern, opts).re_mc
    m = renfa_kernel.machine_from_mc(mc, device)
    cont, _ = renfa.step_newline(list(mc["inits"]), int(mc["mask"][0x0A]),
                                 mc)
    for buf, names in ((chunk, ("config4", "config4n")),
                       (np.frombuffer(mem_data, np.uint8), ("memagrep4",))):
        nls = np.flatnonzero(buf == 0x0A)
        starts = np.concatenate([[0], nls[:-1] + 1]).astype(np.int64)
        lens = (nls - starts).astype(np.int64)
        order = np.argsort(lens, kind="stable")
        seg = kernels.to_device(buf[:int(nls[-1]) + 1], device)
        st_d = torch.from_numpy(starts[order]).to(device)
        ln_d = torch.from_numpy(lens[order]).to(device)
        # the launch alone: the wrapper's bounds check syncs the host
        ms = time_kernel(
            lambda: renfa_kernel._launch(seg, st_d, ln_d, m, cont))
        verdicts = renfa_kernel.renfa_lines(seg, st_d, ln_d, m, cont)
        plain_ms = _time_plain(lambda: renfa_kernel.renfa_lines_reference(
            seg, st_d, ln_d, m, cont))
        diff = _max_diff(verdicts, renfa_kernel.renfa_lines_reference(
            seg, st_d, ln_d, m, cont))
        if diff != 0:
            raise AssertionError("lanes verdicts differ from "
                                 "renfa_lines_reference on %d bytes"
                                 % seg.numel())
        bms, by = regex_bound(m, seg.numel(), lens)
        geo = renfa_kernel.launch_geometry(len(lens), m, device)
        for n in names:
            res[n].update(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                          bound_by=by, shape_b=seg.numel(),
                          max_abs_err=diff, lines=len(lens),
                          true=int(verdicts.sum().item()), geometry=geo)

    # the config 5 runs' kernels alone, on the inputs the main path gave
    # their wrappers (each run's last call), against their plain versions
    plain_fns = {"chain_scan": chain_kernel.chain_scan_reference,
                 "qgram_filter": qgram_kernel.qgram_reference,
                 "mask_scan": kernels.mask_scan_reference}
    launch_fns = {"chain_scan": chain_kernel._launch,
                  "qgram_filter": qgram_kernel._launch,
                  "mask_scan": kernels._launch}
    for name, _fn, _argv, _data, kname in runs[-6:]:
        args = inputs[name][kname]
        N = args[0].numel()
        ms = time_kernel(lambda: launch_fns[kname](*args))
        out = launch_fns[kname](*args)
        plain_ms = _time_plain(lambda: plain_fns[kname](*args))
        diff = _max_diff(out, plain_fns[kname](*args))
        if diff != 0:
            raise AssertionError("%s: the %s kernel differs from its plain "
                                 "version on %d bytes (max |diff| %d)"
                                 % (name, kname, N, diff))
        if kname == "chain_scan":
            bms, by = chain_bound(N)
            res[name]["geometry"] = chain_kernel.launch_geometry(N, args[1],
                                                                 device)
        elif kname == "qgram_filter":
            bms, by = qgram_bound(N)
            res[name]["geometry"] = qgram_kernel.launch_geometry(N, device)
        else:
            bms, by = bound(args[1], N, args[2], args[3], out)
            res[name]["geometry"] = kernels.launch_geometry(N, *args[1:],
                                                            device)
        res[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                         bound_by=by, shape_b=N, max_abs_err=diff,
                         set_bits=_set_bits(out))

    for name, fn, argv, data, kname in runs:
        r = res[name]
        src = "records " if name.endswith(("5", "5c", "5q", "5m")) else ""
        where = ("%d MB %sbuffer" % (mb, src) if data is not None
                 else "%d MB %sfile" % (mb, src))
        print("main: %-9s %-38s %s rc=%d out=%d B sha256=%s.. GPU route "
              "wall=%.3f s (%.3f GB/s), numpy backend wall=%.3f s | %s "
              "launches=%d | kernel %.4f ms per %d B launch (%.1f GB/s, "
              "equal to plain), plain %.1f ms, bound %.4f ms (%s) | card: %s"
              % (name, " ".join(argv[:len(argv) - (data is None)]), where,
                 got[name][1], got[name][2], got[name][0][:12],
                 r["wall_s"], n_bytes / r["wall_s"] / 1e9,
                 r["host_wall_s"], kname, r["launches"], r["ms"],
                 r["shape_b"], r["shape_b"] / r["ms"] / 1e6,
                 r["plain_ms"], r["bound_ms"], r["bound_by"], card))
    for name in ("config5", "config5q", "bool5", "bool5m"):
        r = res[name]
        print("main: the %s kernel's %d B launch of %s sets %d bits"
              % (r["kernel"], r["shape_b"], name, r["set_bits"]))
    for name in ("config4", "memagrep4"):
        r = res[name]
        print("main: the lanes kernel's %d B launch of %s holds %d lines, "
              "%d true verdicts" % (r["shape_b"], name, r["lines"],
                                    r["true"]))
    print("main: stdout and return codes equal the numpy host backend "
          "for all %d runs" % len(runs))
    res["launches"] = main_launches
    return res


# ---------------------------------------------------------------------
# phase 6: the sharded scan, the entry points, two ranks on the card
# ---------------------------------------------------------------------

DIST_MACHINES = [
    ("D0", ["-n", "matching"]),
    ("D2", ["-2", "-n", "matching"]),
    ("costs", CONFIGS[2][1]),
]
DIST_SHARDS = 4
RANK_FILES = 8
# the searches two ranks run over phase 4's corpora, each cut into
# RANK_FILES files: (name, argv before the files, corpus, kernel)
RANK_RUNS = [
    ("config1", CONFIGS[0][1], "corpus", "mask_scan"),
    ("config2", CONFIGS[1][1], "corpus", "mask_scan"),
    ("config4n", REGEX_CONFIGS[1][1], "corpus", "renfa_lanes"),
    ("config5", ["-f", "{p100}"] + CONFIG5_DELIM, "records", "chain_scan"),
    ("config5q", ["-c", "-f", "{p400}"], "records", "qgram_filter"),
    ("limit", ["-L", "7:0:0", "matching"], "corpus", "mask_scan"),
    ("mgrep_vc", ["-v", "-c", "-f", "{p100}"], "records", "chain_scan"),
]


def _zero(counts) -> None:
    for c in counts.values():
        for k in c:
            c[k] = 0


def _launch_counts():
    from agrep_tpu_torch.ops import chain_kernel, kernels, qgram_kernel
    from agrep_tpu_torch.ops import renfa_kernel
    return {"mask_scan": kernels.launches,
            "renfa_lanes": renfa_kernel.launches,
            "chain_scan": chain_kernel.launches,
            "qgram_filter": qgram_kernel.launches}


def _launched(counts) -> dict:
    return {k: v for c in counts.values() for k, v in c.items()}


def phase_dist(corpus, card: str) -> None:
    """(a) the corpus in DIST_SHARDS shards with the MAX_RECORD halo on
    make_mesh() (every shard on cuda:0 on a one-card machine), counted
    and located by distributed_scan_count / _offsets with each of
    DIST_MACHINES; totals, per-shard counts and offsets must equal the
    single-stream scan_events on the card and on the numpy backend."""
    import numpy as np
    import torch

    from agrep_tpu_torch.compile.query import compile_query
    from agrep_tpu_torch.ops import scan as scan_ops
    from agrep_tpu_torch.options import parse_args
    from agrep_tpu_torch.parallel import dist

    counts = _launch_counts()
    mesh = dist.make_mesh()
    shards, starts = dist.shard_corpus(corpus, DIST_SHARDS)
    shard_len = shards.shape[1] - dist.MAX_RECORD
    n = len(corpus)
    for name, argv in DIST_MACHINES:
        opts, pattern, _ = parse_args(argv + ["x"])
        q = compile_query(pattern, opts)
        if q.engine_class != "bitap":
            raise AssertionError("%s compiled to %s" % (name, q.engine_class))
        consts = dict(q.consts)
        endpos = np.uint32(q.consts["endpos"])
        walls, launched = {}, {}
        _zero(counts)
        t0 = time.perf_counter()
        total, locals_ = dist.distributed_scan_count(
            shards, q.folded_mask, consts, q.D, mesh=mesh, costs=q.costs,
            n_bytes=n)
        walls["count"] = time.perf_counter() - t0
        launched["count"] = _launched(counts)["mask_scan"]
        _zero(counts)
        t0 = time.perf_counter()
        pos = dist.distributed_scan_offsets(
            shards, starts, n, q.folded_mask, consts, q.D, mesh=mesh,
            costs=q.costs)
        walls["offsets"] = time.perf_counter() - t0
        launched["offsets"] = _launched(counts)["mask_scan"]
        refs = {}
        for backend in ("torch", "numpy"):
            scan_ops.set_backend(backend)
            _zero(counts)
            t0 = time.perf_counter()
            ev = scan_ops.scan_events(corpus, q.folded_mask, q.consts, q.D,
                                      "bitap", q.costs)
            torch.cuda.synchronize()
            walls[backend] = time.perf_counter() - t0
            launched[backend] = _launched(counts)["mask_scan"]
            refs[backend] = np.flatnonzero(ev & endpos)
            del ev
        scan_ops.set_backend("torch")
        ref = refs["torch"]
        per_shard = np.bincount(ref // shard_len, minlength=DIST_SHARDS)
        if not (np.array_equal(ref, refs["numpy"]) and total == len(ref)
                and np.array_equal(locals_, per_shard)
                and np.array_equal(pos, ref)):
            raise AssertionError(
                "dist %s: sharded total %d, shards %s, %d offsets against "
                "%d single-stream events on the card (shards %s), %d on "
                "the numpy backend" % (name, total, locals_.tolist(),
                                       len(pos), len(ref),
                                       per_shard.tolist(),
                                       len(refs["numpy"])))
        if launched["count"] != DIST_SHARDS or \
                launched["offsets"] != DIST_SHARDS or launched["torch"] < 1:
            raise AssertionError("dist %s: mask_scan launches %s"
                                 % (name, launched))
        print("dist: %-5s %-30s %d shards of %d B (+%d B halo) on %s: "
              "%d events (shards %s) equal to the single-stream scan on "
              "the card and on the numpy backend | count %.3f s "
              "(%d mask_scan launches), offsets %.3f s (%d) | "
              "single-stream on the card %.3f s (%d launch), numpy "
              "backend %.3f s | card: %s"
              % (name, " ".join(argv), DIST_SHARDS, shard_len,
                 dist.MAX_RECORD, ",".join(sorted({str(d) for d in mesh})),
                 total, locals_.tolist(), walls["count"], launched["count"],
                 walls["offsets"], launched["offsets"], walls["torch"],
                 launched["torch"], walls["numpy"], card))


def phase_entries() -> None:
    """(b) entry(): one flagship mask_scan step on the card, against its
    plain version; dryrun_multichip(DIST_SHARDS), which raises on any
    difference."""
    import torch

    from agrep_tpu_torch import entry
    from agrep_tpu_torch.ops import kernels

    counts = _launch_counts()
    _zero(counts)
    fn, args = entry.entry()
    planes = fn(*args)
    if not args[0].is_cuda:
        raise AssertionError("entry() is not on the card")
    diff = _max_diff(planes, kernels.mask_scan_reference(args[0], args[1],
                                                          entry.W, entry.L))
    n_entry = _launched(counts)["mask_scan"]
    if diff != 0 or n_entry != 1:
        raise AssertionError("entry(): |kernel - plain| %d, %d launches"
                             % (diff, n_entry))
    _zero(counts)
    entry.dryrun_multichip(DIST_SHARDS)
    torch.cuda.synchronize()
    n = _launched(counts)
    if n["mask_scan"] < DIST_SHARDS or n["chain_scan"] < DIST_SHARDS:
        raise AssertionError("dryrun_multichip launched %s" % n)
    print("entry: entry() one mask_scan launch %s equal to plain; "
          "dryrun_multichip(%d) launches %s"
          % (tuple(planes.shape), DIST_SHARDS,
             " ".join("%s=%d" % kv for kv in n.items())))


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cli(argvs_envs, timeout: int = 300) -> list:
    """Run `python -m agrep_tpu_torch.cli argv` once for each (argv,
    extra env), all at once; [(stdout, stderr, rc)] and the wall from
    the first start to the last exit."""
    t0 = time.perf_counter()
    procs = []
    for argv, extra in argvs_envs:
        env = dict(os.environ, AGREP_TORCH_BACKEND="torch",
                   AGREP_TORCH_DEVICE="cuda", AGREP_TORCH_STATS="1",
                   **extra)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "agrep_tpu_torch.cli", *argv],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            stdin=subprocess.DEVNULL, env=env, cwd=REPO))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((out, err.decode(errors="replace"), p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs, time.perf_counter() - t0


def _stats_launches(err: str) -> dict:
    """The kernel launches of the last AGREP_TORCH_STATS line."""
    found = re.findall(r"launches=(\S+)", err)
    if not found:
        raise AssertionError("no stats line on stderr:\n" + err[-2000:])
    return {k: int(v) for k, v in (kv.split(":")
                                   for kv in found[-1].split(","))}


def _in_process(argv, backend: str):
    """(rc, stdout bytes, wall s) of api.fileagrep in this process on a
    scan backend."""
    import torch

    from agrep_tpu_torch import api
    from agrep_tpu_torch.ops import scan as scan_ops
    scan_ops.set_backend(backend)
    try:
        buf = io.BytesIO()
        t0 = time.perf_counter()
        rc = api.fileagrep(argv, output=buf) & 0xFF
        torch.cuda.synchronize()
        return rc, buf.getvalue(), time.perf_counter() - t0
    finally:
        scan_ops.set_backend("torch")


# the searches whose one-process CLI run is timed from process start to
# exit beside the two ranks': the smallest output and the largest
CLI_WALL_RUNS = ("config1", "config5")


def phase_ranks(corpus, records, pats, card: str) -> None:
    """(c) two `python -m agrep_tpu_torch.cli` ranks (WORLD_SIZE=2,
    MASTER_ADDR=127.0.0.1, a free port, both bound to cuda:0) on each
    RANK_RUNS search; rank 0's stdout and both exit codes must equal the
    port's single-process run on the card (in this process, and for
    CLI_WALL_RUNS also as one CLI process) and on the numpy backend,
    rank 1's stdout must be empty, and each rank must launch the
    search's kernel (its AGREP_TORCH_STATS line)."""
    counts = _launch_counts()
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        paths = {}
        for name, data in (("corpus", corpus), ("records", records)):
            step = -(-len(data) // RANK_FILES)
            paths[name] = []
            for i in range(RANK_FILES):
                p = os.path.join(tmp, "%s%d.txt" % (name, i))
                data[i * step:(i + 1) * step].tofile(p)
                paths[name].append(p)
        fmt = {}
        for k in (100, 400):
            fmt["p%d" % k] = os.path.join(tmp, "pats%d.txt" % k)
            with open(fmt["p%d" % k], "wb") as fh:
                fh.write(b"".join(w + b"\n" for w in pats[:k]))
        walls = {"one": 0.0, "ranks": 0.0, "cli": 0.0, "cli_ranks": 0.0}
        for name, head, which, kname in RANK_RUNS:
            argv = [a.format(**fmt) for a in head] + paths[which]
            _zero(counts)
            rc_1, out_1, w_1 = _in_process(argv, "torch")
            n_1 = _launched(counts)[kname]
            want_rc, want, w_np = _in_process(argv, "numpy")
            port = str(_free_port())
            ranks, w2 = _cli([(argv, {
                "WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": str(r),
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port})
                for r in range(2)])
            (out0, err0, rc0), (out1, err1, rc1) = ranks
            if (out_1, rc_1) != (want, want_rc) or n_1 < 1:
                raise AssertionError(
                    "ranks %s: the single-process run on the card (rc %d, "
                    "%d B, %d %s launches) differs from the numpy backend "
                    "(rc %d, %d B)" % (name, rc_1, len(out_1), n_1, kname,
                                       want_rc, len(want)))
            if out0 != want or out1 != b"" or rc0 != want_rc or \
                    rc1 != want_rc:
                raise AssertionError(
                    "ranks %s: rank 0 rc %d, %d B; rank 1 rc %d, %d B; "
                    "wanted rc %d, %d B from rank 0 and nothing from rank "
                    "1\n%s\n%s" % (name, rc0, len(out0), rc1, len(out1),
                                   want_rc, len(want), err0[-2000:],
                                   err1[-2000:]))
            n = [_stats_launches(e)[kname] for e in (err0, err1)]
            if min(n) < 1:
                raise AssertionError("ranks %s: launches of %s by rank %s"
                                     % (name, kname, n))
            cli = ""
            if name in CLI_WALL_RUNS:
                (single,), w_cli = _cli([(argv, {})])
                if (single[0], single[2]) != (want, want_rc):
                    raise AssertionError(
                        "ranks %s: one CLI process on the card (rc %d, %d "
                        "B) differs from the numpy backend\n%s"
                        % (name, single[2], len(single[0]),
                           single[1][-2000:]))
                walls["cli"] += w_cli
                walls["cli_ranks"] += w2
                cli = ("; one CLI process %.3f s (%d launches)"
                       % (w_cli, _stats_launches(single[1])[kname]))
            walls["one"] += w_1
            walls["ranks"] += w2
            print("ranks: %-8s %-40s %d files of %d B: rc=%d out=%d B "
                  "sha256=%s.. equal to one process on the card and to "
                  "the numpy backend; rank 1 printed nothing | %s launches "
                  "rank 0 %d, rank 1 %d (one process %d) | walls: one "
                  "process in this one %.3f s, two CLI ranks from start "
                  "to exit %.3f s%s; numpy backend %.3f s | card: %s"
                  % (name, " ".join(head).format(p100="pats100",
                                                 p400="pats400"),
                     RANK_FILES, -(-len(corpus) // RANK_FILES), want_rc,
                     len(want), hashlib.sha256(want).hexdigest()[:12],
                     kname, n[0], n[1], n_1, w_1, w2, cli, w_np, card))
        print("ranks: %d searches: one process in this one %.3f s, two "
              "CLI ranks %.3f s from process start to exit; on %s, one "
              "CLI process %.3f s, two ranks %.3f s.  Both ranks share "
              "the one card, so these walls measure the partition's "
              "overhead and the processes' start-up, not scaling"
              % (len(RANK_RUNS), walls["one"], walls["ranks"],
                 " and ".join(CLI_WALL_RUNS), walls["cli"],
                 walls["cli_ranks"]))

MASK_SHAPES = ("config1", "config2", "config3", "memagrep", "bool5m")


def mask_scan_geometry_line(res) -> str:
    """mask_scan's launch at each main-path shape, and the registers and
    spills ptxas reported for its kernels."""
    from agrep_tpu_torch.ops import _cuda
    log = _cuda.build_logs.get("mask_scan", "")
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log))
    return ("geometry: mask_scan %s | registers max %s, spill bytes %d "
            "(ptxas, %d kernels)" % (" | ".join(
                "%s s=%d tiles/block=%d threads=%d blocks=%d dynamic "
                "shared=%d B" % (n, g["s"], g["tiles_per_block"],
                                 g["threads"], g["blocks"], g["smem_bytes"])
                for n in MASK_SHAPES for g in [res[n]["geometry"]]),
                max(regs, default="n/a"), spills, len(regs)))


CHAIN_SHAPES = ("config5", "config5c", "memagrep5", "bool5")


def chain_scan_geometry_line(res) -> str:
    """chain_scan's launch at each main-path shape, and the registers and
    spills ptxas reported for its kernels."""
    from agrep_tpu_torch.ops import _cuda
    log = _cuda.build_logs.get("chain_scan", "")
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log))
    return ("geometry: chain_scan %s | registers max %s, spill bytes %d "
            "(ptxas, %d kernels)" % (" | ".join(
                "%s grid=%d (%d blocks/SM) tile=%d threads=%d dynamic "
                "shared=%d B tiles=%d"
                % (n, g["grid"], g["blocks_per_sm"], g["tile"], g["threads"],
                   g["smem_bytes"], g["tiles"])
                for n in CHAIN_SHAPES for g in [res[n]["geometry"]]),
                max(regs, default="n/a"), spills, len(regs)))


def renfa_lanes_geometry_line(res) -> str:
    """renfa_lanes' launch at its two main-path shapes: Next form, table
    bytes, threads, blocks an SM, grid, and the kernel's registers and
    local (spill) bytes a thread (cudaFuncGetAttributes); and the spills
    ptxas reported over all its kernels."""
    from agrep_tpu_torch.ops import _cuda
    log = _cuda.build_logs.get("renfa_lanes", "")
    spills = sum(int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log))
    return ("geometry: renfa_lanes %s | spill bytes %d (ptxas, %d kernels)"
            % (" | ".join(
                "%s %d lines form=%s table=%d B threads=%d blocks/SM=%d "
                "grid=%d registers=%d local=%d B"
                % (n, res[n]["lines"], g["form"], g["table_bytes"],
                   g["threads"], g["blocks_per_sm"], g["grid"], g["regs"],
                   g["local_bytes"])
                for n in ("config4", "memagrep4")
                for g in [res[n]["geometry"]]), spills,
               len(re.findall(r"Used (\d+) registers", log))))


def qgram_filter_geometry_line(res) -> str:
    g = res["config5q"]["geometry"]
    return ("geometry: qgram_filter config5q %d words threads=%d "
            "blocks/SM=%d grid=%d" % (g["words"], g["threads"],
                                      g["blocks_per_sm"], g["grid"]))


def times_line(res, kname: str, names, card: str) -> str:
    return "times: %s %s | card: %s" % (kname, " | ".join(
        "%s %.4f ms per %d B launch, %.1f %% of its %.4f ms bound (%s)"
        % (n, r["ms"], r["shape_b"], 100 * r["bound_ms"] / r["ms"],
           r["bound_ms"], r["bound_by"])
        for n in names for r in [res[n]]), card)




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
    err_re = phase_parity_regex("cuda", args.seed)
    err_chain, err_qgram = phase_parity_multi(
        "cuda", args.seed, 8 << 20, make_patterns(100, args.seed))
    res = phase_main("cuda", args.seed, args.mb, card)

    c2, c4, c5, c5q = (res["config2"], res["config4"], res["config5"],
                       res["config5q"])
    print(mask_scan_geometry_line(res))
    print(times_line(res, "mask_scan", MASK_SHAPES, card))
    print(chain_scan_geometry_line(res))
    print(renfa_lanes_geometry_line(res))
    print(times_line(res, "renfa_lanes", ("config4", "memagrep4"), card))
    print(qgram_filter_geometry_line(res))
    print(times_line(res, "qgram_filter", ("config5q",), card))
    t6 = time.perf_counter()
    corpus = make_corpus(args.mb << 20, args.seed)
    phase_dist(corpus, card)
    phase_entries()
    phase_ranks(corpus, make_records(corpus, args.seed),
                make_patterns(400, args.seed), card)
    print("phase 6: %.1f s" % (time.perf_counter() - t6))
    line = {"kernels": [{
        "name": "mask_scan",
        "route": "cuda",
        "source": "agrep_tpu_torch/csrc/mask_scan.cu",
        "replaces": "agrep_tpu/ops/kernels.py:386",
        "launches": res["launches"]["mask_scan"],
        "max_abs_err": max([err] + [res[n]["max_abs_err"] for n in (
            "config1", "config2", "config3", "memagrep", "bool5m")]),
        "ms": c2["ms"],
        "plain_ms": c2["plain_ms"],
        "bound_ms": c2["bound_ms"],
        "bound_by": c2["bound_by"],
        "library_ms": None,
    }, {
        "name": "renfa_lanes",
        "route": "cuda",
        "source": "agrep_tpu_torch/csrc/renfa_lanes.cu",
        "replaces": "agrep_tpu/ops/renfa_kernel.py:188",
        "launches": res["launches"]["renfa_lanes"],
        "max_abs_err": max(err_re, c4["max_abs_err"],
                           res["memagrep4"]["max_abs_err"]),
        "ms": c4["ms"],
        "plain_ms": c4["plain_ms"],
        "bound_ms": c4["bound_ms"],
        "bound_by": c4["bound_by"],
        # no PyTorch call computes this automaton
        "library_ms": None,
    }, {
        "name": "chain_scan",
        "route": "cuda",
        "source": "agrep_tpu_torch/csrc/chain_scan.cu",
        "replaces": "agrep_tpu/ops/chain_kernel.py:233",
        "launches": res["launches"]["chain_scan"],
        "max_abs_err": max([err_chain] + [res[n]["max_abs_err"] for n in (
            "config5", "config5c", "memagrep5", "bool5")]),
        "ms": c5["ms"],
        "plain_ms": c5["plain_ms"],
        "bound_ms": c5["bound_ms"],
        "bound_by": c5["bound_by"],
        # no PyTorch call matches many strings at once: the nearest,
        # unfold + eq + all per term, is the plain version itself
        "library_ms": None,
    }, {
        "name": "qgram_filter",
        "route": "cuda",
        "source": "agrep_tpu_torch/csrc/qgram_filter.cu",
        "replaces": "agrep_tpu/ops/qgram_kernel.py:102",
        "launches": res["launches"]["qgram_filter"],
        "max_abs_err": max(err_qgram, c5q["max_abs_err"]),
        "ms": c5q["ms"],
        "plain_ms": c5q["plain_ms"],
        "bound_ms": c5q["bound_ms"],
        "bound_by": c5q["bound_by"],
        # no single PyTorch call packs a gathered bit set into words; the
        # gather alone is the plain version's first step
        "library_ms": None,
    }]}
    print("kernels: times are per launch at the main path's %d B chunk "
          "of config2 (%s) and of config4 (%s), at config5's %d B stream "
          "(chain_scan) and config5q's %d B stream (qgram_filter); "
          "launches are all main-path runs; card: %s"
          % (c2["shape_b"], " ".join(CONFIGS[1][1]),
             " ".join(REGEX_CONFIGS[0][1]), c5["shape_b"], c5q["shape_b"],
             card))
    print(json.dumps(line))
    print("total: %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
