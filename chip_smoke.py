#!/usr/bin/env python3
"""Smoke run of agrep_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py [--seed N] [--mb 100]

Phases, each printing its own lines; any failure raises and the script
exits non-zero:

  1. card: the GPU's name and power limit (nvidia-smi) and the torch and
     CUDA versions;
  2. build: compiles the eleven kernel sources (csrc/mask_scan.cu,
     renfa_lanes.cu, chain_scan.cu, qgram_filter.cu, event_pairs.cu,
     record_verdicts.cu, line_index.cu, line_rows.cu, qgram_lines.cu,
     line_terms.cu, bitap_lanes.cu) with nvcc, every compile unit of all
     eleven started together, and times the build;
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
     ones, 96 classes; past the TPU's caps up to the port's: 127
     classes, config 5's 400 patterns, 32,767 positions, a term of
     chain_kernel.MAX_TERM_LEN bytes; each with and without -i; and a
     set under codepage 437's -i# class fold) and texts (N = 1, 15, 16,
     17, 31, 32, 33, 4095, 4096, 4097, 8 MB), on views 1-15 bytes past
     an aligned address, and at 8 MB with one block an SM, so that each
     block walks several tiles, each set's shared bytes a block checked
     against chain_kernel.smem_bytes and its 8 MB launch timed; two
     programs just past the caps (128 classes, a term one byte past the
     cap) must be refused by the launcher before a launch; and the
     qgram_filter kernel against qgram_reference on
     2-gram, LONG and -i member sets at N = 1..33, 4065..4097 (every N
     mod 32), the sizes above and 8 MB (there with one block an SM too),
     each on views at offsets 1-15 too; and the event_pairs kernel against
     event_pairs_reference, bit for bit, with keep_from 0 and W, on every
     mask machine's kernel planes at N = 0, 1, L-1, L, L+1 and 3L+17, on
     planes with no bit, every bit (a pair at every kept position) and
     random bits over 33 planes at those sizes, and on config 2's 32 MB
     chunk (its planes, and all-set planes of its geometry), each with
     its planes and values also as views 1-15 elements past an aligned
     address, and each with its pairs' capacity forced to 0 and to 1
     (a second launch at K); and the record_verdicts kernel against
     record_verdicts_reference, bit for bit (rows and summary, its
     events included), with AND and OR, with and without -v, with and
     without a dropped event, from an acc of 0 and of endpos, on the
     planes of event streams of K = 0, 1, 2047, 2048 (every event a
     record end), 2049 (hits on record ends), 5000, 600,000 (no record
     end) and 1,000,000 under one and three hit bits (one plane a word
     bit, junk bits in the halo columns and past N), and on config 2's
     and config 3's planes over a 32 MB chunk, each also as views 1-15
     elements past an aligned address and with its rows' capacity
     forced to 0 and to 1 (a second launch at R); and the line_index and line_rows kernels against
     line_index_reference and line_rows_reference, bit for bit, on the
     edge texts (empty, no newline, one newline, a leading newline, no
     final newline), lines of 127-129, 8,191-8,193, 49,153 and 60,000
     bytes, every length key, texts at 16 KB block edges (16,383-16,385
     bytes; 2,047-2,049 and 4,097 lines, empty ones among them), 1 MB of
     dense short lines and of newlines alone, a glitch byte inside a line
     and before a newline, config 4's 32 MB chunk, and at line_index's own
     block geometry texts of a block's bytes -1, +0, +1 and three blocks
     and 17 bytes, a line longer than two blocks, three blocks of newlines
     alone (K = n) and of no newline, and a scatter round's lines -1, +0
     and +1 of one length, and line_rows' share of a block's lines -1,
     +0, +1 and three shares and 17 lines, the texts also as
     views 1-15 bytes past an aligned address, line_rows with and without
     -v, three kept-ordinal ranges, with and without a glitch byte, rows
     and count alone, on verdicts all false and all true (R = K under
     -v), with its verdicts, ords and nl as views, with its grid forced
     to 1, 2 and 3 blocks, against rows_library too, and with ordinals
     outside 0..K-1; and the
     qgram_lines stage against qgram_lines_reference, bit for bit (rows
     and count alone), on 2-gram and LONG tables with and without -i and
     -w, the edge set (a bucket's highest term failing -w where a lower
     one passes, a term past the text's end, an anchor at p - 1, empty
     lines, a final line without a newline, many winners on a line, a
     text shorter than p), a LONG set over 33 MB, config5q's patterns
     over 8 MB of its records, and a text whose every position is a
     member hit (every word holds 32 candidates; with -w and LONG), each
     with qgram_filter's plane, with no
     bit and with every bit set, on views 1-15 bytes past an aligned
     address; and the line_terms stage against line_terms_reference, bit
     for bit (rows, count, carried mask, last newline), on boolean term
     sets of 1, 2 (with and without -i), 4 and 16 terms, a tree with ~
     and a set past the chain caps (TERM_SETS), over seeded texts of 1 KB
     to 1 MB and one without a final newline, each cut at random seams
     into chunks whose masks carry from one to the next and whose last
     tail is a line, with chain_scan's plane (shift 0) and qgram_filter's
     (shift p_size - 1), each also with junk bits that do not verify,
     and with every bit set, in both forms, on views 1-15 bytes past an
     aligned address; and at the geometry of its tiles (terms_tile_cases:
     bodies at, one before and one after tile edges, a term longer than
     the staged halo starting 20 bytes before tile ends, 8 MB of lines,
     more tiles than the card's resident blocks), each launch at the
     wrapper's grid and at grids of 1, 3 and one block a tile; and the
     bitap_lanes kernel against bitap_lanes_reference, bit for bit
     (verdicts and hits), on fourteen sticky machines (-p and '#', D 0-8,
     uniform and cost wiring, AND and OR) over one lane, 33, 5,000,
     empty lanes, lanes of 8-49 KB and a 1 MB lane (at D 0), on views
     1-15 bytes past an aligned address, the first lane from Init0 and
     from the post-reset states, with and without -v, and at the sticky
     runs' shapes (the STICKY_MB file stream and memory buffer of phase
     4), and, past LANES_LONG (the segment maps), on every machine lanes
     of LANES_LONG - 1, LANES_LONG and LANES_LONG + 1 bytes, a chunk and
     one either side, two chunks and a segment, 64 KiB, 256 KiB at D 2
     and 4 MiB for -p aproximat, at offsets 0 and 7, the first lane from
     Init0 and not, with and without -v (bitap_lane_maps must launch),
     and line_index at the delimiter bytes 'o', '$' and 0 against
     line_index_reference; phase 4 repeats every check at the main
     path's shapes;
  4. main path: a --mb MB ASCII corpus made from --seed, searched through
     agrep_tpu_torch.api.fileagrep with BASELINE configs 1-4 (the file
     is over the streaming threshold, so each run is chunked; config 4,
     the regex, runs as a count and as a line-numbered print) and
     through memagrep with configs 1 and 4 on the in-memory buffer; then
     BASELINE config 5 on a second corpus, the first with a blank line
     every 8-16 lines: -f with 100 patterns over '$$' records (config5),
     the same as a count (config5c) and through memagrep (memagrep5), a
     count with 400 patterns (config5c400; both counts count the lines
     that hold a chain start on the card: one line count a launch, no
     start positions read back), a count with the 400 patterns holding
     154 byte classes, past the chain kernel's caps (config5q, counted
     on the card by qgram_lines: one launch, no candidate positions read
     back), the same set's matching lines (config5qn, qgram_lines' rows;
     agrep refuses -n with -f; printed whole, as a file under
     AGREP_TORCH_STREAM_MB is: WHOLE_FILE_RUNS, the whole-file route),
     the matching lines of the 400 patterns (config5s) and of the 400
     wide ones (config5qs) at the default 8 MB threshold, printed in
     32 MB chunks (STREAMED_RUNS: config5s launches chain_scan, config5qs
     qgram_filter and qgram_lines, once each a chunk; neither calls the
     host's per-term find, mgrep._find_occurrences; config5qs reads no
     positions back, and its output must equal config5qn's, as
     config4n's, streamed over the threshold on both backends, must
     equal its output read whole on the numpy backend), a
     boolean AND over '$$' records (bool5, the chain kernel), and a
     boolean with a term of 136 byte classes, past the chain caps
     (bool5m, the mask machine's packed term words); the booleans
     streamed in 32 MB chunks over the line corpus at the default 8 MB
     threshold (BOOL_STREAM_RUNS: bools 'hello;lazy' printed, boolsc -c
     'lazy;dog;fox;over', boolst '{hello,matching};~lazy' and boolsq,
     that tree with the 136-class term: one chain_scan, or past the caps
     one qgram_filter, and one line_terms a chunk, no host find, no start
     positions read back; boolsc's count equal to the numpy backend's
     read whole, and the three prints' bytes over the corpus's first
     BOOL_WHOLE_MB MB, streamed on the card, equal to the numpy
     backend's read whole); stdout and return
     codes must equal the port's own numpy host backend, whose walls are
     printed beside the GPU route's, and every run must launch its
     kernel (config5q and config5qn the q-gram kernel and qgram_lines
     once each, and no chain kernel); with
     tracing on, every -d run must leave the counter qgram_candidates
     at 0 (no call of compile/multi.py's qgram_occurrences), and config5
     must take its records' rows from the native pass over the card's
     anchors (native.qgram_first_per_anchor_at); config 1, memagrep
     and bool5m must read their events back through event_pairs, and no
     run may call the host's planes_to_events (both wrapped and counted);
     configs 2, 3 and config2c (config 2 as a count: CONFIG2C) must cut
     their records from mask_scan's planes through record_verdicts
     (wrapped and counted), launching no event_pairs and taking no
     second launch, the rows they read back (trace counter record_rows)
     must be the records that fire, as record_verdicts_reference counts
     them on the same planes, and their events (record_pairs) the pairs
     event_pairs_reference gives there; config 2 with -v (config2v,
     nearly every record fires) reports its second launches and must
     equal the numpy backend; config4, config4n and memagrep4 must index their lines
     through line_index and read them back through line_rows, one launch
     of each a chunk (the buffer in memory mode), every line indexed on
     the card (trace counter regex_lines), one row read back a printed
     line (regex_rows; 0 for a count), and the regex engine may call no
     numpy index or sort over 65,536 or more elements (a host newline
     index or length sort); memagrep2 (config 2, -1 -n matching) and
     memagrep3 (config 3) through memagrep on the 100 MB buffer must cut
     their records from mask_scan's planes through record_verdicts, one
     launch of each a buffer, no per-byte loop; wild (-n 'appr#mate'),
     wildp (-p -c aproximat) over a STICKY_MB MB file of the corpus and
     memwild ('appr#mate' through memagrep over a STICKY_MB MB buffer)
     must cut every record on the card through line_index, bitap_lanes
     and line_rows, one launch each, reading back one row a printed
     record, with no host lane scan and no per-byte loop; memagrep2,
     memagrep3 and memwild over the buffer's first LOOP_MB MB must equal
     the per-byte memory loop (BitapEngine._memory_search_loop) on the
     card; wildl (-p -n aproximat over the STICKY_MB MB file with one
     newline every LONG_RECORD bytes) must cut its records the same way
     with one bitap_lane_maps launch (the sticky runs above with none);
     and the serial lanes: SERIAL_RUNS (-p -c aproximat, -2 -p -c hello,
     -2 -D2 -I1 -S1 -c 'br#vo') over a STICKY_MB MB file with no
     delimiter, one lane through the segment maps, each one
     bitap_lane_maps launch, its hits equal to the native sequential
     scan's, its launches timed against the bound and n x the bound;
     bitap_lane_maps alone on a 1 MiB lane against its plain version;
  5. kernels: mask_scan's launch geometry (split, tiles a block, threads,
     dynamic shared memory; registers and spills from ptxas) and its
     time against its bound at all five main-path shapes, chain_scan's
     launch geometry (grid, blocks an SM, tile, threads, dynamic shared
     memory; registers and spills) and time at its five, renfa_lanes'
     (Next form, table bytes, threads, blocks an SM, grid, registers,
     spills) and time at its two, qgram_filter's (threads, blocks an
     SM, grid) and time at config5q's, event_pairs' (pairs, planes, grid;
     its launch's device time, the wrapper's with the host's read of K,
     the plain version's and a library composite's: unpack by shifts,
     then torch.nonzero) at configs 1-3's 32 MB chunk, the memagrep
     buffer and bool5m's last stream, and record_verdicts' (events, rows,
     grid; its launch's device time, the wrapper's with the host's read
     of the summary, the plain version's and a library composite's: the
     event_pairs composite, then torch.cumsum of the delimiter flags and
     scatter_add of the hit flags) at the first 32 MB chunk's planes of
     configs 2, 3 and config2c, and
     line_index's and line_rows' (lines, rows, grids; their passes'
     device time and each one's by pass (timing.pass_split), the
     wrapper's with the host's read of K or the count, line_rows' in
     both forms (rows and count),
     the plain version's and a library composite's: torch.nonzero of the
     newlines and a stable torch.sort of the lengths; index_put_ of the
     flags, torch.nonzero and gathers) at config 4's first window (the
     lanes kernel timed on that window's index too) and the memagrep
     buffer, and qgram_lines' (rows or count, tiles; its passes' device
     time, whole and by
     pass, the wrapper's with the host's read of the count, the plain
     version's and a library composite's: torch.nonzero of the plane,
     gathers, a padded term matrix's compare and torch.cumsum of the
     newlines) at config5q's and config5qn's 100 MB streams, and
     line_terms' (rows or count, the plane's bits, grid; its launch's
     device time, the wrapper's with the host's read, the plain
     version's and a library composite's: torch.nonzero of the plane, a
     padded term matrix's compare, torch.searchsorted of the newlines and
     index_put_) at each streamed boolean's first chunk, and
     bitap_lanes' (lanes, threads, blocks an SM, grid, registers; its
     launch's device time, the plain version's, the bound) at each
     sticky run, and its segment maps' (n, seg, segments a block,
     threads, shared bytes, blocks an SM, grid, registers) at wildl,
     each checked
     bit for bit against the plain version and the
     composite first, each on a line of its own; then one JSON line with
     each kernel's launches on the main path, its time, its plain
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
     the 400 wide patterns), -L 7:0:0 and mgrep -v -c -f; rank 0's
     stdout and both exit codes must equal the port's single-process
     run on the card (in this process; for configs 1 and 5 also one CLI
     process) and on the numpy backend, rank 1 must print nothing, and each rank must
     launch the search's kernel (the launch counts of its
     AGREP_TORCH_STATS line).  Its walls (one process against two ranks,
     the CLI processes' from start to exit) measure the partition's
     overhead and start-up: both ranks share the one card.  BASELINE
     config 5's sharded 10 GB corpus is cut to the two --mb corpora on
     one card, for the run's time limit;
  7. bench: agrep_tpu_torch.bench.main at --mb 32 --gate-mb 8
     --para-mb 16, in this process: its JSON line is printed after
     "bench: ", its conformance gate must pass, and the launch counts
     (set to 0 just before it) must show every kernel launched but
     line_terms (the bench streams no boolean);
  8. sweep: tools/torch_fuzz_sweep.py, loaded by path, in this process,
     with --device cuda --ref numpy over the fixed seed ranges of
     SWEEP_RUNS in every mode (uniform, stratified, regex, and the
     device route's grown corpora with its past-caps stratum and its
     boolean stratum, whose booleans of 2-6 terms stream, and the memory
     stratum: memagrep cases held against the per-byte memory loop,
     whose sticky one-byte cases launch bitap_lanes): random
     corpora and flag sets from tools/fuzz_sweep.py's generators, the
     port's GPU route against its own numpy host backend, stdout and
     exit code compared exactly.  Its line gives the cases by mode,
     the divergences, the cases over the tool's time limit with their
     seeds, each kernel's launches (the counts set to 0 just before it),
     the cases that launch qgram_lines and the seconds; any divergence or
     crash, or a kernel launched no time, fails the run (qgram_lines
     excepted: only the past-caps stratum's 30-term counts and prints
     take it, and its count is reported; and line_terms, which only a
     boolean streamed in chunks takes); then a streaming pass (the
     tool's --stream): the grown seeds of SWEEP_RUNS again, every file
     searched in 64 KiB chunks on the card (scan_ops.STREAM_CHUNK,
     AGREP_TORCH_STREAM_MB=0) and read whole on the numpy backend (its
     threshold raised for its runs only), so that a streaming fault
     both backends share shows; its line gives the divergences, the
     crashes, the cases that printed a -f search in chunks on the
     card and those that streamed a boolean there, with line_terms'
     launches, and any divergence or crash, or no line_terms launch,
     fails the run.

The last line is {"ok": true, "device": {...}}.  Without a CUDA device,
or without the agrep_tpu_torch package beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
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

CONFIGS = [
    ("config1", ["-c", "hello"]),
    ("config2", ["-1", "-n", "matching"]),
    ("config3", ["-3", "-D2", "-I1", "-S1", "-w", "-i", "approximate"]),
]
# config 2 as a count: `-1 -c matching` alone takes the sgrep engine
# (checksg's fast path), which cuts no bitap records; -n keeps the mask
# machine (agrep warns that -n is ignored with -c)
CONFIG2C = ("config2c", ["-1", "-n", "-c", "matching"])
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
# a boolean term of 136 byte classes, past the chain kernel's 127: the
# argument as the CLI gets raw bytes 0xA0-0xFF from the command line
WIDE_TERM = "hello" + os.fsdecode(b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
                                  + bytes(range(0xA0, 0x100)))


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


def wide_patterns(pats: list) -> list:
    """The patterns with a byte 0x80-0xFF put in each one after the
    PLANTS, so that a set of 135 or more patterns holds more byte classes
    than the chain kernel's 127 (a list of binary signatures); matches
    stay the PLANTS'."""
    k = len(PLANTS)
    return pats[:k] + [w[:2] + bytes([0x80 + i % 128]) + w[2:]
                       for i, w in enumerate(pats[k:])]


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


# event_pairs' parity sizes (N) and view offsets (elements past an
# aligned address)
PAIRS_SIZES = (0, 1, 1023, 1024, 1025, 3 * 1024 + 17)
PAIRS_OFFSETS = (0, 1, 3, 15)


def pairs_vals(m, device):
    """The event word of each of mask_scan's planes, as event_pairs takes
    them (kernels.event_vals)."""
    import numpy as np
    import torch

    from agrep_tpu_torch.ops import kernels
    return torch.from_numpy(np.asarray(kernels.event_vals(m),
                                       dtype=np.uint32)).to(device)


def _view(t, off: int):
    """t's values in a view off elements past the start of a larger
    buffer of t's dtype."""
    import torch
    buf = torch.empty(t.numel() + off + 7, dtype=t.dtype, device=t.device)
    v = buf[off:off + t.numel()].view(t.shape)
    v.copy_(t)
    return v


def _pairs_diff(got, want) -> int:
    """Largest |kernel - plain| over the pairs' positions and words; a
    different number of pairs counts as a difference of the larger
    count."""
    (gp, gw), (wp, ww) = got, want
    if gp.numel() != wp.numel() or gw.numel() != ww.numel():
        return max(gp.numel(), wp.numel(), 1)
    if gp.numel() == 0:
        return 0
    return max(_max_diff(gp, wp), _max_diff(gw, ww))


def pairs_cases(device: str, seed: int):
    """(name, planes, vals, W, N) of every shape phase 3 holds
    event_pairs to: every parity machine's kernel planes at PAIRS_SIZES;
    planes with no bit, every bit and random bits (33 planes, the
    delimiter value and 32 one-bit hit values) there too; and config 2's
    32 MB chunk of the main-path corpus, its planes and all-set planes of
    its geometry."""
    import numpy as np
    import torch

    from agrep_tpu_torch.compile.query import compile_query
    from agrep_tpu_torch.ops import kernels
    from agrep_tpu_torch.ops.scan import DEFAULT_TILE as L
    from agrep_tpu_torch.ops.scan import STREAM_CHUNK
    from agrep_tpu_torch.options import parse_args
    rng = np.random.default_rng(seed)
    for name, table, consts, D, variant, costs in parity_machines():
        m = kernels.machine_from_arrays(table, consts, D, variant, costs,
                                        device)
        W = halo(consts, D, L)
        vals = pairs_vals(m, device)
        for N in PAIRS_SIZES:
            if N == 0:
                planes = torch.zeros((vals.numel(),)
                                     + kernels.geometry(0, W, L),
                                     dtype=torch.int32,
                                     device=device).view(torch.uint32)
            else:
                planes = kernels.mask_scan(
                    kernels.to_device(random_text(N, rng), device), m, W, L)
            yield name, planes, vals, W, N
    W = 56
    for fill in ("empty", "full", "random33"):
        for N in PAIRS_SIZES:
            shape = kernels.geometry(N, W, L)
            if fill == "random33":
                v = [0x4000] + [1 << b for b in range(32)]
                a = (rng.integers(0, 1 << 32, (33,) + shape, dtype=np.uint64)
                     & rng.integers(0, 1 << 32, (33,) + shape,
                                    dtype=np.uint64)).astype(np.uint32)
            else:
                v = [0x200, 1]
                a = np.full((2,) + shape,
                            0xFFFFFFFF if fill == "full" else 0,
                            dtype=np.uint32)
            yield (fill, torch.from_numpy(a).to(device),
                   torch.from_numpy(np.asarray(v, dtype=np.uint32))
                   .to(device), W, N)
    opts, pattern, _ = parse_args(CONFIGS[1][1] + ["x"])
    q = compile_query(pattern, opts)
    m = kernels.machine_from_arrays(q.folded_mask, q.consts, q.D, "bitap",
                                    q.costs, device)
    W = halo(q.consts, q.D, L)
    text = kernels.to_device(make_corpus(STREAM_CHUNK, seed), device)
    planes = kernels.mask_scan(text, m, W, L)
    yield "config2_chunk", planes, pairs_vals(m, device), W, text.numel()
    yield ("config2_chunk_full",
           torch.full(planes.shape, -1, dtype=torch.int32,
                      device=device).view(torch.uint32),
           pairs_vals(m, device), W, text.numel())


# capacities forced on a launch (its private argument): each must take a
# second launch wherever the output holds more
FORCED_CAPACITIES = (0, 1)


def phase_parity_pairs(device: str, seed: int) -> float:
    """event_pairs against event_pairs_reference on the card, bit for
    bit, on every shape of pairs_cases with keep_from 0 and W, with the
    planes and values as views PAIRS_OFFSETS elements past an aligned
    address, and with the pairs' capacity forced to FORCED_CAPACITIES
    (each must launch again where K is larger); all-set planes must give
    a pair at every kept position.  Returns the largest |kernel - plain|
    (0 or fail)."""
    import torch

    from agrep_tpu_torch.ops import kernels
    from agrep_tpu_torch.ops.scan import DEFAULT_TILE as L
    worst = 0
    failed = []
    t0 = time.perf_counter()
    shapes = {}
    for name, planes, vals, W, N in pairs_cases(device, seed):
        big = N > 3 * L + 17
        for kf in (0, W):
            want = kernels.event_pairs_reference(planes, vals, W, L, N, kf)
            K = want[0].numel()
            if "full" in name and K != max(N - kf, 0):
                failed.append((name, N, kf, "K=%d" % K))
            for off in (PAIRS_OFFSETS[:2] if big else PAIRS_OFFSETS):
                p, v = ((planes, vals) if off == 0
                        else (_view(planes, off), _view(vals, off)))
                got = kernels.event_pairs(p, v, W, L, N, kf)
                diff = _pairs_diff(got, want)
                worst = max(worst, diff)
                if diff:
                    failed.append((name, N, kf, off, diff))
            for cap in FORCED_CAPACITIES:
                again = kernels.relaunches["event_pairs"]
                got = kernels._pairs_launch(planes, vals, W, L, N, kf, cap)
                again = kernels.relaunches["event_pairs"] - again
                diff = _pairs_diff(got, want)
                worst = max(worst, diff)
                if diff or again != (K > cap):
                    failed.append((name, N, kf, "capacity", cap, diff,
                                   again))
            sh = shapes.setdefault(name, [0, set(), set(), set()])
            sh[0] += K
            sh[1].add(N)
            sh[2].add(planes.shape[0])
            sh[3].update(PAIRS_OFFSETS[:2] if big else PAIRS_OFFSETS)
        del planes
    torch.cuda.synchronize()
    for name, (K, sizes, n_planes, offs) in shapes.items():
        print("parity: event_pairs %-20s N=%s planes=%s keep_from 0 and W, "
              "views at %s, capacity %s: %d pairs, equal bit for bit"
              % (name, sorted(sizes), sorted(n_planes), sorted(offs),
                 list(FORCED_CAPACITIES), K))
    print("parity: event_pairs %d shapes in %.1f s"
          % (len(shapes), time.perf_counter() - t0))
    if failed:
        raise AssertionError("event_pairs differs from "
                             "event_pairs_reference: %s" % failed[:20])
    return float(worst)


# record_verdicts' parity streams: (name, events K, hit and end shares)
RECORD_STREAMS = [
    ("empty", 0, 0.5, 0.5),
    ("one_hit_end", 1, 1.0, 1.0),
    ("one_end", 1, 0.0, 1.0),
    ("one_hit", 1, 1.0, 0.0),
    ("no_end", 2047, 0.3, 0.0),
    ("every_end", 2048, 0.3, 1.0),
    ("hits_on_ends", 2049, 1.0, 0.5),
    ("random", 5000, 0.2, 0.3),
    ("no_end_big", 600_000, 0.01, 0.0),
    ("random_big", 1_000_000, 0.05, 0.2),
]
# (endpos, d_endpos) of the synthetic streams: one hit bit, three
RECORD_MASKS = [(0x1, 0x100), (0x2A, 0x400)]
RECORD_OFFSETS = (0, 1, 3, 15)
# the synthetic streams' tile and halo (W not a multiple of 32: a stream
# word's bits straddle two plane words)
RECORD_L, RECORD_W = 1024, 56


def record_stream(rng, K: int, endpos: int, d_endpos: int, p_hit: float,
                  p_end: float):
    """K ascending positions and their words: a random non-empty subset
    of endpos' bits with share p_hit, d_endpos with share p_end, noise
    bits outside both."""
    import numpy as np
    pos = np.cumsum(rng.integers(1, 20, K)).astype(np.int64)
    bits = [1 << b for b in range(32) if endpos >> b & 1]
    pick = rng.integers(1, 1 << len(bits), K)
    hit = np.zeros(K, dtype=np.int64)
    for j, b in enumerate(bits):
        hit |= ((pick >> j) & 1) * b
    word = (np.where(rng.random(K) < p_hit, hit, 0)
            | np.where(rng.random(K) < p_end, d_endpos, 0)
            | (rng.integers(0, 1 << 32, K) & 0x00F000F0 & ~(endpos | d_endpos)))
    return pos, word.astype(np.uint32)


def stream_planes(rng, pos, word, N: int, W: int, L: int):
    """(planes u32 [P, T, n_words], vals u32 [P]) in mask_scan's layout
    holding the events (pos, word) of a scan of N bytes: one plane a bit
    the words hold (value 1 << bit), its bit set at each position whose
    word has the bit, and junk bits (a quarter) in the halo columns, the
    columns past the tile and the positions at or past N, which the
    kernels must ignore."""
    import numpy as np
    from agrep_tpu_torch.ops import kernels
    T, nw = kernels.geometry(N, W, L)
    bits = [b for b in range(32)
            if np.bitwise_or.reduce(word, initial=0) >> b & 1] or [0]
    body = np.zeros((T, 32 * nw), dtype=bool)
    body[:, W:W + L] = np.arange(T * L).reshape(T, L) < N
    live = np.packbits(body, axis=-1, bitorder="little").view(np.uint32)
    planes = (rng.integers(0, 1 << 32, (len(bits), T, nw), dtype=np.uint64)
              & rng.integers(0, 1 << 32, (len(bits), T, nw),
                             dtype=np.uint64)).astype(np.uint32) & ~live
    t, col = pos // L, W + pos % L
    for k, b in enumerate(bits):
        on = (word >> b & 1).astype(bool)
        np.bitwise_or.at(planes[k], (t[on], col[on] >> 5),
                         (np.uint32(1) << (col[on] & 31)).astype(np.uint32))
    return planes, np.asarray([1 << b for b in bits], dtype=np.uint32)


def chunk_planes(device: str, seed: int, argv):
    """mask_scan's planes of a bitap query over the main-path corpus's
    first STREAM_CHUNK bytes, as the card's main path leaves them, their
    values, W, N and the machine's endpos and d_endpos."""
    from agrep_tpu_torch.compile.query import compile_query
    from agrep_tpu_torch.ops import kernels
    from agrep_tpu_torch.ops.scan import DEFAULT_TILE as L
    from agrep_tpu_torch.ops.scan import STREAM_CHUNK
    from agrep_tpu_torch.options import parse_args
    opts, pattern, _ = parse_args(argv + ["x"])
    q = compile_query(pattern, opts)
    m = kernels.machine_from_arrays(q.folded_mask, q.consts, q.D, "bitap",
                                    q.costs, device)
    W = halo(q.consts, q.D, L)
    text = kernels.to_device(make_corpus(STREAM_CHUNK, seed), device)
    return (kernels.mask_scan(text, m, W, L), pairs_vals(m, device), W,
            text.numel(), int(q.consts["endpos"]), int(q.consts["d_endpos"]))


def _rows_diff(got, want) -> int:
    """Largest |kernel - plain| over the rows and the summary; a different
    number of rows counts as a difference of the larger count."""
    (gr, gs), (wr, ws) = got, want
    if gr.shape != wr.shape:
        return max(gr.shape[0], wr.shape[0], 1)
    diff = max(abs(a - b) for a, b in zip(gs, ws))
    if gr.numel():
        diff = max(diff, _max_diff(gr, wr))
    return diff


def records_cases(device: str, seed: int):
    """(name, planes, vals, W, N, endpos, d_endpos) of every stream phase
    3 holds record_verdicts to: the planes of RECORD_STREAMS under each
    of RECORD_MASKS (stream_planes), and config 2's and config 3's planes
    over a STREAM_CHUNK chunk."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    for endpos, d_endpos in RECORD_MASKS:
        for name, K, p_hit, p_end in RECORD_STREAMS:
            pos, word = record_stream(rng, K, endpos, d_endpos, p_hit,
                                      p_end)
            N = int(pos[-1]) + 1 + int(rng.integers(0, 100)) if K else 77
            planes, vals = stream_planes(rng, pos, word, N, RECORD_W,
                                         RECORD_L)
            yield ("%s/%d-bit" % (name, bin(endpos).count("1")),
                   torch.from_numpy(planes).to(device),
                   torch.from_numpy(vals).to(device), RECORD_W, N, endpos,
                   d_endpos)
    for name, argv in CONFIGS[1:]:
        yield (name + "_chunk",) + chunk_planes(device, seed, argv)


def phase_parity_records(device: str, seed: int) -> float:
    """record_verdicts against record_verdicts_reference on the card, bit
    for bit (rows and summary), on every stream of records_cases with
    and_flag and invert each off and on, with no event dropped and with
    the middle event dropped, from an acc of 0 and of endpos, with the
    planes and values as views RECORD_OFFSETS elements past an aligned
    address, and with the rows' capacity forced to FORCED_CAPACITIES
    (each must launch again where R is larger).  Returns the largest
    |kernel - plain| (0 or fail)."""
    import torch

    from agrep_tpu_torch.ops import kernels
    from agrep_tpu_torch.ops.scan import DEFAULT_TILE as L
    assert L == RECORD_L
    worst = 0
    failed = []
    t0 = time.perf_counter()
    for name, planes, vals, W, N, endpos, d_endpos in records_cases(device,
                                                                    seed):
        pos = kernels.event_pairs_reference(planes, vals, W, L, N, 0)[0]
        K = pos.numel()
        rows = 0
        for and_flag in (False, True):
            for invert in (False, True):
                for skip in ((-1, int(pos[K // 2].item())) if K else (-1,)):
                    for acc in (0, endpos):
                        args = (W, L, N, 0, endpos, d_endpos, skip, and_flag,
                                invert, acc)
                        want = kernels.record_verdicts_reference(
                            planes, vals, *args)
                        R = want[0].shape[0]
                        rows += R
                        for off in RECORD_OFFSETS:
                            p, v = ((planes, vals) if off == 0
                                    else (_view(planes, off),
                                          _view(vals, off)))
                            diff = _rows_diff(kernels.record_verdicts(
                                p, v, *args), want)
                            worst = max(worst, diff)
                            if diff:
                                failed.append((name, args[4:], off, diff))
                        for cap in FORCED_CAPACITIES:
                            again = kernels.relaunches["record_verdicts"]
                            diff = _rows_diff(kernels._records_launch(
                                planes, vals, *args, capacity=cap), want)
                            again = (kernels.relaunches["record_verdicts"]
                                     - again)
                            worst = max(worst, diff)
                            if diff or again != (R > cap):
                                failed.append((name, args[4:], "capacity",
                                               cap, diff, again))
        print("parity: record_verdicts %-22s K=%d, AND and OR, -v, skip, "
              "acc, views at %s, capacity %s: %d rows, equal bit for bit"
              % (name, K, list(RECORD_OFFSETS), list(FORCED_CAPACITIES),
                 rows))
        del planes
    torch.cuda.synchronize()
    print("parity: record_verdicts in %.1f s" % (time.perf_counter() - t0))
    if failed:
        raise AssertionError("record_verdicts differs from "
                             "record_verdicts_reference: %s" % failed[:20])
    return float(worst)


# line_index's and line_rows' views (elements past an aligned address)
LINE_OFFSETS = (0, 1, 3, 15)


def line_texts(seed: int, geometry=(256, 65536, 2048, 225),
               rows_share: int = 8192):
    """(name, u8 numpy text, glitch position or -1) of every text phase 3
    holds line_index and line_rows to: the edge shapes (empty, no
    newline, one newline, a leading newline, no final newline), lines of
    127-129, 8,191-8,193, 49,153 and 60,000 bytes, every length key
    (each length 0-600, then every 7th up to 9,000), texts at 16 KB block
    edges (16,383-16,385 and 49,169 bytes; 2,047-2,049 and 4,097 lines,
    empty ones among them: one key, the scatter's worst contention), 1 MB
    of dense short lines and 1 MB of newlines alone, a glitch byte inside
    a line and before a newline, the main path's first STREAM_CHUNK
    window (config 4's chunk); and at the kernel's geometry (threads,
    text bytes a block B, lines a scatter round R, keys): texts of B - 1,
    B, B + 1 and 3 B + 17 bytes whose lines straddle the blocks, a line
    longer than two blocks between short ones, every byte a newline over
    3 B (K = n: R lines and more a block, many scatter rounds), no
    newline over 3 B, and R - 1, R and R + 1 lines of one length in one
    block; and at line_rows' share of a block (threads times lines a
    piece, S): S - 1, S, S + 1 and 3 S + 17 lines."""
    import numpy as np

    from agrep_tpu_torch.ops.scan import STREAM_CHUNK
    rng = np.random.default_rng(seed + 15)

    def u8(b):
        return np.frombuffer(b, np.uint8)

    def rand(n, p):
        t = rng.integers(32, 127, n, dtype=np.uint8)
        t[rng.random(n) < p] = 0x0A
        return t

    def lines(lens):
        return u8(b"".join(bytes(rng.integers(97, 123, int(n),
                                              dtype=np.uint8)) + b"\n"
                           for n in lens))

    for name, b in (("empty", b""), ("no_newline", b"abc def"),
                    ("one_newline", b"\n"), ("leading", b"\nabc\n\nxyz\n"),
                    ("no_final", b"ab\ncd\n\nef")):
        yield name, u8(b), -1
    yield "long", lines([5, 127, 128, 129, 0, 8191, 8192, 8193, 49153, 0,
                         60000, 7, 8192, 200]), -1
    yield "every_key", lines(rng.permutation(
        np.r_[np.arange(601), np.arange(601, 9001, 7)])), -1
    for n in (16383, 16384, 16385, 3 * 16384 + 17):
        yield "bytes_%d" % n, rand(n, 1 / 40), -1
    for k in (2047, 2048, 2049, 4097):
        yield "empty_lines_%d" % k, u8(b"\n" * k), -1
        yield "lines_%d" % k, lines(rng.integers(0, 50, k)), -1
    yield "dense_1mb", rand(1 << 20, 0.5), -1
    yield "newlines_1mb", u8(b"\n" * (1 << 20)), -1
    r = rand(100_000, 1 / 40)
    inside = int(np.flatnonzero((r[1:] != 0x0A)
                                & (r[:-1] != 0x0A))[5000]) + 1
    on_nl = int(np.flatnonzero(r == 0x0A)[2000])
    for name, at in (("glitch_inside", inside), ("glitch_on_newline", on_nl)):
        yield name, np.insert(r, at, 0), at
    yield "config4_chunk", make_corpus(STREAM_CHUNK, seed), -1
    B, R = geometry[1], geometry[2]
    for n in (B - 1, B, B + 1, 3 * B + 17):
        yield "block_bytes_%d" % n, rand(n, 1 / 50), -1
    yield "longer_than_blocks", u8(b"ab\n" * 100 + b"x" * (2 * B + 5)
                                   + b"\n" + b"cd\n" * 100), -1
    yield "newlines_3_blocks", u8(b"\n" * (3 * B)), -1
    yield "no_newline_3_blocks", rand(3 * B, 0.0), -1
    for k in (R - 1, R, R + 1):
        yield "round_lines_%d" % k, u8(b"abcdefg\n" * k), -1
    for k in (rows_share - 1, rows_share, rows_share + 1,
              3 * rows_share + 17):
        yield "share_lines_%d" % k, lines(rng.integers(0, 9, k)), -1


def _index_diff(got, want) -> int:
    """Largest |kernel - plain| over a line index's arrays and its last
    newline; a different number of lines counts as a difference of the
    larger count."""
    if got.nl.numel() != want.nl.numel():
        return max(got.nl.numel(), want.nl.numel(), 1)
    diff = abs(got.last - want.last)
    for a, b in zip(got[:4], want[:4]):
        if a.numel():
            diff = max(diff, _max_diff(a, b))
    return diff


def _line_rows_diff(got, want) -> int:
    """Largest |kernel - plain| over line_rows' rows and count."""
    (gr, gc), (wr, wc) = got, want
    diff = abs(gc - wc)
    if (gr is None) != (wr is None):
        return max(diff, 1)
    if gr is not None:
        if gr.shape != wr.shape:
            return max(gr.shape[0], wr.shape[0], 1)
        if gr.numel():
            diff = max(diff, _max_diff(gr, wr))
    return diff


def _rows_forced(v, ords, nl, args, rows: bool, grid: int) -> tuple:
    """line_rows' one launch with its grid forced to grid blocks (each
    thread then walks many pieces and each warp many bitmap steps), as
    (rows, count) like the wrapper's; not counted in its launches."""
    import torch

    from agrep_tpu_torch.ops import renfa_kernel as rk
    K = nl.numel()
    out = torch.empty((K, 3), dtype=torch.int64, device=nl.device) \
        if rows else None
    scratch = rk._rows_call("forced", v, ords, nl, args[:4], out, grid)
    R = int(scratch[grid].item())
    return (out[:R] if rows else None), R


def _rows_library_diff(got, v, ords, nl, args) -> int:
    """Largest |kernel - rows_library| over line_rows' rows or count."""
    lib = rows_library(v, ords, nl, *args[:4])
    return _line_rows_diff(got, (lib if args[4] else None, lib.shape[0]))


def phase_parity_lines(device: str, seed: int) -> tuple:
    """line_index and line_rows against their plain versions on the card,
    bit for bit, on every text of line_texts, the text also as views
    LINE_OFFSETS bytes past an aligned address (two of them for the
    large ones); line_rows, in both forms (rows and count alone), on
    random verdicts over each index, with and without invert, with the
    kept ordinals [0, K), [1, K) and [2, K - 1), the text's glitch byte
    or a byte a third in, the verdicts as views too; on verdicts all
    false and all true (with -v every kept line fires: R = K), on ords
    and nl as views, with its grid forced to 1, 2 and 3 blocks (many
    pieces a thread, many bitmap steps a warp), against rows_library
    too, and with ordinals outside 0..K-1.  Returns the largest |kernel -
    plain| of each (0 or fail)."""
    import numpy as np
    import torch

    from agrep_tpu_torch.ops import _cuda
    from agrep_tpu_torch.ops import renfa_kernel as rk
    worst = [0, 0]
    failed = []
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 16)
    threads, piece, _b = rk._rows_geometry(_cuda.device_index(device),
                                           True)

    def check(name, got, v, ords, nl, args, what, library=True):
        ref = rk.line_rows_reference(v, ords, nl, *args)
        diff = _line_rows_diff(got, ref)
        if library:
            diff = max(diff, _rows_library_diff(got, v, ords, nl, args))
        worst[1] = max(worst[1], diff)
        if diff:
            failed.append(("line_rows", name, args, what, diff))
        return ref[1] if args[4] else 0

    for name, arr, glitch in line_texts(seed, rk.index_geometry(device),
                                        threads * piece):
        text = torch.from_numpy(np.array(arr, dtype=np.uint8)).to(device)
        want = rk.line_index_reference(text)
        K = want.nl.numel()
        offs = LINE_OFFSETS[:2] if arr.size > (1 << 20) else LINE_OFFSETS
        for off in offs:
            t = text if off == 0 else _view(text, off)
            diff = _index_diff(rk.line_index(t), want)
            worst[0] = max(worst[0], diff)
            if diff:
                failed.append(("line_index", name, off, diff))
        ords, nl = want.ords, want.nl
        v = torch.from_numpy(rng.random(K) < 0.3).to(device)
        g = glitch if glitch >= 0 else arr.size // 3
        rows = 0
        for invert in (False, True):
            for first, end in ((0, K), (1, K), (2, max(K - 1, 0))):
                for gl in (-1, g):
                    for want_rows in (True, False):
                        args = (invert, first, end, gl, want_rows)
                        for off in offs:
                            vv = v if off == 0 else _view(v, off)
                            rows += check(name, rk.line_rows(
                                vv, ords, nl, *args), v, ords, nl, args,
                                "view %d" % off)
        # every line or none fires; ords and nl as views
        for fill in (False, True):
            vf = torch.full((K,), fill, dtype=torch.bool, device=device)
            for invert in (False, True):
                for want_rows in (True, False):
                    args = (invert, 0, K, g, want_rows)
                    rows += check(name, rk.line_rows(vf, ords, nl, *args),
                                  vf, ords, nl, args, "all %s" % fill)
        for want_rows in (True, False):
            args = (True, 1, K, g, want_rows)
            check(name, rk.line_rows(_view(v, 3), _view(ords, 1),
                                     _view(nl, 1), *args),
                  v, ords, nl, args, "ords and nl views")
            if 0 < K <= 1 << 20:
                for grid in (1, 2, 3):
                    check(name, _rows_forced(v, ords, nl, args, want_rows,
                                             grid),
                          v, ords, nl, args, "grid %d" % grid)
        if K > 2:
            # ordinals outside 0..K-1 name no line: both skip them
            bad = ords.clone()
            bad[::7] = -1
            bad[3::11] = K
            for want_rows in (True, False):
                args = (False, 0, K, -1, want_rows)
                check(name, rk.line_rows(v, bad, nl, *args), v, bad, nl,
                      args, "bad ordinals", library=False)
        print("parity: line_index, line_rows %-18s %d B, %d lines, views "
              "at %s: equal bit for bit (line_rows: %d rows over -v, kept "
              "ordinals, glitch, all or no verdict, forced grids)"
              % (name, arr.size, K, list(offs), rows))
        del text
    torch.cuda.synchronize()
    print("parity: line_index, line_rows in %.1f s"
          % (time.perf_counter() - t0))
    if failed:
        raise AssertionError("line_index or line_rows differs from its "
                             "plain version: %s" % failed[:20])
    return float(worst[0]), float(worst[1])


def chain_sets(pats400) -> list:
    """(name, terms, fold) of every term set phase 3 holds the chain
    kernel to, each with and without -i folding (fold True or False),
    and one under codepage 437's -i# class fold (fold "cp437 -i#").  The
    sets from "127 classes" on are past the TPU kernel's caps (96
    classes, 2,400 positions, 128-byte terms), up to the port's
    (chain_kernel.fits)."""
    import numpy as np
    from agrep_tpu_torch.ops import chain_kernel
    rng = np.random.default_rng(5)
    alnum = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789", np.uint8)
    L = chain_kernel.MAX_TERM_LEN
    n_words = chain_kernel.MAX_POSITIONS // 10
    at_cap = sorted({bytes(rng.choice(alnum, 10)) for _ in range(n_words)})
    at_cap += [b"hello" + b"z" * (chain_kernel.MAX_POSITIONS
                                  - 10 * len(at_cap) - 5)]
    sets = [
        ("1 term", [b"hello"]),
        ("100 terms", pats400[:100]),
        ("31..128 B", [bytes(rng.integers(97, 123, n).astype(np.uint8))
                       for n in (31, 32, 33, 64, 65, 128)]),
        # tests/test_chain_kernel.py test_full_byte_range's shape
        ("full bytes", [b"\x00\xff", bytes(range(200, 212)),
                        b"\x80\x00\x7f", b"\n\n", b"ab\x00c"]),
        # plant() ends every text in FE FD: these run into the zero pad
        ("zero pad", [b"\xfe\xfd\x00\x00", b"\xfd\x00", b"hello"]),
        # one-byte terms match whatever follows them
        ("one-byte", [b"Q", b"\n", b"hello", b"ab", b"~", b"xyz\x00"]),
        ("96 classes", cap_classes(rng, 32, 128)),
        ("127 classes", cap_classes(rng, 1, 128)),
        ("400 terms", pats400),
        ("32767 positions", at_cap),
        ("%d B term" % L, [bytes(rng.choice(alnum[:4], L)), b"hello",
                           b"ab"]),
    ]
    out = [(name + (" -i" if fold else ""), terms, fold)
           for name, terms in sets for fold in (False, True)]
    letters = np.frombuffer(b"aeiouAEIOUxyz19" + bytes(range(0x80, 0xA6)),
                            np.uint8)
    return out + [("cp437 -i#", [bytes(rng.choice(letters, int(k)))
                                 for k in rng.integers(2, 9, 40)],
                   "cp437 -i#")]


def cap_classes(rng, lo: int, hi: int) -> list:
    """Terms of 2-7 bytes that hold every byte lo..hi - 1 once (one class
    each), three one-byte terms and a 128-byte term."""
    import numpy as np
    order = rng.permutation(np.arange(lo, hi, dtype=np.uint8))
    cuts = np.cumsum(rng.integers(2, 8, hi - lo))
    terms = [bytes(c) for c in np.split(order, cuts[cuts < hi - lo])
             if len(c)]
    return terms + [b"!", b"@", b"~", bytes(rng.integers(
        lo, hi, 128).astype(np.uint8))]


def chain_past_caps() -> list:
    """(name, program) of chain programs just past the port's caps, built
    by hand (compile_chain gives None for their term sets)."""
    from agrep_tpu_torch.ops import chain_kernel
    L = chain_kernel.MAX_TERM_LEN + 1
    return [
        ("128 classes", (tuple((b,) for b in range(128)),
                         tuple((2 * i, 2 * i + 1) for i in range(64)),
                         tuple(range(64)), 2)),
        ("%d B term" % L, (((ord("x"),),), ((0,) * L,), (0,), L)),
    ]


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


def phase_parity_multi(device: str, seed: int, big: int, pats400) -> tuple:
    """chain_scan planes vs chain_scan_reference planes, and qgram_filter
    planes vs qgram_reference planes, on every set and size; returns the
    largest |kernel - plain| word difference of each (0 or fail).  Each
    chain set's shared bytes must be chain_kernel.smem_bytes', and its
    kernel is timed at `big` bytes; a program past the caps must be
    refused before it launches."""
    import numpy as np
    import torch

    from agrep_tpu_torch import codepage
    from agrep_tpu_torch.compile import multi
    from agrep_tpu_torch.ops import chain_kernel, kernels, qgram_kernel
    from agrep_tpu_torch.ops.timing import chain_bound, time_kernel
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

    for name, terms, fold in chain_sets(pats400):
        tr = (codepage.build_lut(437, "#") if fold == "cp437 -i#"
              else _fold_tr(fold))
        fold = fold is True
        prog = chain_kernel.compile_chain(terms, tr)
        if prog is None:
            raise AssertionError("chain set %s does not compile" % name)
        p = chain_kernel.device_program(prog, device)
        # at most 100 of the terms planted, a few copies of each
        planted = terms[::-(-len(terms) // 100)]
        t0 = time.perf_counter()
        hits = 0
        for n in sizes:
            src = base_bytes if name.startswith("full") else base
            text = kernels.to_device(plant(src[n].copy(), planted, rng,
                                           fold), device)
            want = chain_kernel.chain_scan_reference(text, p)
            check("chain_scan", name, n, chain_kernel.chain_scan(text, p),
                  want)
            hits += _set_bits(want)
            # at 8 MB one block an SM, so that each block walks several
            # tiles; and the kernel's time there
            if n == big:
                check("chain_scan", name + " blocks/SM=1", n,
                      chain_kernel._launch(text, p, blocks_per_sm=1), want)
                ms = time_kernel(lambda: chain_kernel.chain_scan(text, p))
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
        geo = chain_kernel.launch_geometry(big, p, device)
        smem = chain_kernel.smem_bytes(p.n_cls, p.n_pos, p.n_terms,
                                       p.maxlen)
        if geo["smem_bytes"] != smem:
            failed.append(("chain_scan", name + " shared bytes %d, "
                           "smem_bytes %d" % (geo["smem_bytes"], smem), big))
        one = chain_kernel.launch_geometry(big, p, device, blocks_per_sm=1)
        bms, by = chain_bound(big)
        print("parity: chain %-21s %4d terms, %5d positions, %3d classes, "
              "longest %4d B, N=%s equal bit for bit (%d starts), and on "
              "views at offsets 1-15; at 8 MB blocks/SM=1 walks %.1f tiles "
              "a block; %d shared B a block, %d blocks/SM, %.4f ms per 8 MB "
              "launch, %.1f %% of its %.4f ms bound (%s) %.1f s"
              % (name, p.n_terms, p.n_pos, p.n_cls, p.maxlen, list(sizes),
                 hits, one["tiles"] / one["grid"], smem,
                 geo["blocks_per_sm"], ms, 100 * bms / ms, bms, by,
                 time.perf_counter() - t0))
    # past the caps: compile_chain refuses the set, and the launcher a
    # program built by hand, before any launch
    text = kernels.to_device(base[4096], device)
    for name, prog in chain_past_caps():
        p = chain_kernel.device_program(prog, device)
        before = chain_kernel.launches["chain_scan"]
        try:
            chain_kernel.chain_scan(text, p)
            refused = False
        except ValueError:
            refused = chain_kernel.launches["chain_scan"] == before
        if not refused:
            failed.append(("chain_scan", name + " not refused", 4096))
        print("parity: chain %s (%d classes, %d positions, longest %d B) "
              "refused by the launcher before a launch: %s"
              % (name, p.n_cls, p.n_pos, p.maxlen, refused))
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


def qgram_line_tables(terms, fold: bool, wordbound: bool, device):
    """(compile/multi.py's q-gram tables of the terms, the same as
    qgram_lines takes them on device)."""
    from agrep_tpu_torch.compile import multi
    from agrep_tpu_torch.ops import qgram_kernel
    from agrep_tpu_torch.runtime.mgrep import _fold_tr
    tr = _fold_tr(fold)
    tb = multi.build_qgram_tables(terms, tr)
    return tb, qgram_kernel.line_tables(
        tb.member, tb.hash_id, *multi.csr_tables(tb, terms), tr, tb.p_size,
        tb.long_, wordbound, device)


# terms in buckets of several (tests/test_torch_qgram_lines.py's edge
# set): at -w "abc" (a higher id) matches inside "abcd" and fails the word
# test where "abcd" passes; "hijklmnx" would end past the text's end where
# the lower "hijklm" fits
QLINE_EDGE_TERMS = [b"abcd", b"abc", b"hijklm", b"hijklmnx", b"xyz", b"xyzw",
                    b"efg"] + [b"q%02dz" % i for i in range(30)]
QLINE_EDGE_TEXT = (b"abc xyz abcd\n\n\nefg efg abcd xyzw\n abcd \n\nxyz\n"
                   b"nothing here\nq07z q08z\n" * 3 + b"tail hijklm")
# views of the text this many bytes past an aligned address
QLINE_OFFSETS = (0, 1, 2, 3, 5, 8, 13, 15)


def qgram_line_cases(seed: int, pats400):
    """(name, terms, u8 numpy text, fold, wordbound) of every input phase
    3 holds qgram_lines to: 2-gram and LONG tables with and without -i
    and -w over 64 KB of letters, spaces and newlines with empty lines,
    the terms planted; the edge set (a bucket's highest term failing -w
    where a lower one passes, a term past the text's end, an anchor at
    p - 1, empty lines, a final line without a newline, a line with many
    winners, a text shorter than p); a LONG set over 33 MB (more tiles
    than the scan's threads); config5q's 400 wide patterns over 8 MB of
    its records corpus; and a text where every position is a member hit
    (every word holds 32 candidates), with -w and LONG."""
    import numpy as np
    rng = np.random.default_rng(seed + 17)
    al = np.frombuffer(b"abcdefghij", np.uint8)

    def words(k, lo, hi):
        return [bytes(rng.choice(al, int(rng.integers(lo, hi))))
                for _ in range(k)]

    def text(terms, n, fold):
        t = rng.choice(np.frombuffer(b"abcdefghij  ", np.uint8), n)
        t[rng.random(n) < 1 / 30] = 0x0A
        for term in terms:
            for off in rng.integers(0, max(1, n - len(term)),
                                    max(3, n // 20000)):
                b = np.frombuffer(term, np.uint8)
                if fold and rng.integers(0, 2):
                    b = b - 32 * ((b >= 97) & (b <= 122))
                t[off:off + len(b)] = b[:n - off]
        return t

    out = []
    for long_ in (False, True):
        for fold in (False, True):
            for wb in (False, True):
                terms = words(120 if long_ else 30, 3, 9)
                out.append(("%s%s%s" % ("LONG" if long_ else "2-gram",
                                        " -i" if fold else "",
                                        " -w" if wb else ""),
                            terms, text(terms[::3], 1 << 16, fold), fold, wb))
    edge = np.frombuffer(QLINE_EDGE_TEXT, np.uint8)
    for wb in (False, True):
        w = " -w" if wb else ""
        out.append(("edge" + w, QLINE_EDGE_TERMS, edge, False, wb))
        out.append(("edge LONG" + w, QLINE_EDGE_TERMS + words(60, 4, 8),
                    edge, False, wb))
        out.append(("edge -i" + w, QLINE_EDGE_TERMS,
                    np.frombuffer(QLINE_EDGE_TEXT.upper(), np.uint8), True,
                    wb))
        out.append(("head, tail" + w, QLINE_EDGE_TERMS,
                    np.frombuffer(b"abcd x\nq01z", np.uint8), False, wb))
    for name, t in (("empty lines", b"\n" * 40 + b"xyz\n\n\nabc"),
                    ("one line", b"abc abc abcd xyz q03z q03z"),
                    ("short", b"ab")):
        out.append((name, QLINE_EDGE_TERMS, np.frombuffer(t, np.uint8),
                    False, False))
    terms = words(120, 3, 9)
    out.append(("LONG 33 MB", terms, text(terms[::3], 33 << 20, False),
                False, False))
    recs = make_records(make_corpus(8 << 20, seed), seed)
    out.append(("pats400w 8 MB", wide_patterns(pats400), recs, False,
                False))
    # every position a member hit and most a winner: every word holds 32
    # candidates, each thread walks 64
    dense = np.frombuffer((b"abc" * 33 + b"\n") * 2000, np.uint8)
    cyc = [b"abc", b"bca", b"cab", b"abcab"]
    for wb in (False, True):
        w = " -w" if wb else ""
        out.append(("dense" + w, cyc, dense, False, wb))
        out.append(("dense LONG" + w, cyc + words(80, 5, 8), dense, False,
                    wb))
    return out


def _qlines_diff(got, want) -> int:
    """Largest |kernel - plain| over the rows and the count; a different
    count counts as a difference of the larger count."""
    (gr, gk), (wr, wk) = got, want
    if gk != wk:
        return max(gk, wk, 1)
    if (gr is None) != (wr is None):
        return 1
    if gr is None or gk == 0:
        return 0
    return _max_diff(gr, wr)


def phase_parity_qgram_lines(device: str, seed: int, pats400) -> float:
    """qgram_lines against qgram_lines_reference on the card, bit for bit
    (rows and count alone), on every input of qgram_line_cases with
    qgram_filter's plane, a plane with no bit and one with every bit set,
    and on views QLINE_OFFSETS bytes past an aligned address in a buffer
    of letters (a read past the view would change a -w verdict).  Returns
    the largest |kernel - plain| (0 or fail)."""
    import torch

    from agrep_tpu_torch.compile import multi
    from agrep_tpu_torch.ops import kernels, qgram_kernel as qk
    worst = 0
    failed = []
    t0 = time.perf_counter()
    for name, terms, arr, fold, wb in qgram_line_cases(seed, pats400):
        tb, tables = qgram_line_tables(terms, fold, wb, device)
        text = kernels.to_device(arr, device)
        words = qk.words_tensor(multi.member_projection_1024(tb), device)
        plane = qk.qgram_filter(text, words)
        want = qk.qgram_lines_reference(text, plane, tables)
        planes = [("plane", plane, want),
                  ("no bit", torch.zeros_like(plane), None),
                  ("every bit", torch.full_like(plane, -1), None)]
        big = arr.size > (1 << 20)
        for pname, pl, ref in planes:
            if ref is None:
                ref = qk.qgram_lines_reference(text, pl, tables)
            for off in QLINE_OFFSETS[:2] if big else QLINE_OFFSETS:
                t = text
                if off:
                    buf = torch.full((arr.size + off + 16,), ord("a"),
                                     dtype=torch.uint8, device=device)
                    t = buf[off:off + arr.size]
                    t.copy_(text)
                for count_only in (False, True):
                    r = (None, ref[1]) if count_only else ref
                    diff = _qlines_diff(qk.qgram_lines(t, pl, tables,
                                                       count_only), r)
                    worst = max(worst, diff)
                    if diff:
                        failed.append((name, pname, off, count_only, diff))
        print("parity: qgram_lines %-16s %2s terms, LONG=%d, p=%d, -w=%d, "
              "%d B, %d lines hold a winner (every bit: %d), "
              "views at %s: equal bit for bit, rows and count"
              % (name, len(terms), tb.long_, tb.p_size, wb, arr.size,
                 want[1], qk.qgram_lines_reference(
                     text, torch.full_like(plane, -1), tables)[1],
                 list(QLINE_OFFSETS[:2] if big else QLINE_OFFSETS)))
        del text, plane
    torch.cuda.synchronize()
    print("parity: qgram_lines in %.1f s" % (time.perf_counter() - t0))
    if failed:
        raise AssertionError("qgram_lines differs from its plain version: "
                             "%s" % failed[:20])
    return float(worst)


def qlines_library(text, plane, tables):
    """The function of qgram_lines as a composite of PyTorch calls on the
    card (the yardstick of library_ms): the plane unpacked by shifts and
    torch.nonzero, the gram hashes and member bits gathered, each bucket
    depth's terms compared whole through a gather of a padded term matrix,
    and each line's first winner through a torch.cumsum of the newlines:
    (rows, count)."""
    import torch
    dev = text.device
    N, p = text.numel(), tables.p
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    bits = ((plane.to(torch.int64)[:, None] >> shifts) & 1).flatten()
    a = torch.nonzero(bits).flatten()
    a = a[(a >= p - 1) & (a < N)]
    b = text.long()
    h = ((b[a] & 31) << 5) | (b[a - 1] & 31)
    if tables.long_:
        h = ((h << 5) | (b[a - 2] & 31)) & 32767
    mw = tables.member.long() & 0xFFFFFFFF
    member = ((mw[h >> 5] >> (h & 31)) & 1) != 0
    a, h = a[member], h[member]
    t_off, tr = tables.t_off, tables.tr.long()
    lens = t_off[1:] - t_off[:-1]
    L = int(lens.max())
    k = torch.arange(L, dtype=torch.int64, device=dev)
    at = (t_off[:-1, None] + k).clamp(max=tables.t_bytes.numel() - 1)
    terms = tr[tables.t_bytes.long()[at]]                    # [terms, L]
    bk = tables.hash_id[h].long()
    lo, hi = tables.b_off[bk], tables.b_off[bk + 1]
    win = torch.full_like(a, -1)
    s = a - (p - 1)
    for d in range(int((hi - lo).max()) if a.numel() else 0):
        j = hi - 1 - d
        tid = tables.b_tids[j.clamp(min=0)]
        ln = lens[tid]
        got = tr[b[(s[:, None] + k).clamp(max=N - 1)]]
        ok = ((got == terms[tid]) | (k >= ln[:, None])).all(1)
        ok &= (j >= lo) & (win < 0) & (s + ln <= N)
        if tables.wordbound:
            aft = torch.where(s + ln < N, b[(s + ln).clamp(max=N - 1)], 0)
            bef = torch.where(s > 0, b[(s - 1).clamp(min=0)], 0)
            aln = [((c >= 48) & (c <= 57)) | (((c | 32) >= 97)
                                              & ((c | 32) <= 122))
                   for c in (aft, bef)]
            ok &= ~aln[0] & ~aln[1]
        win = torch.where(ok, tid, win)
    a, win = a[win >= 0], win[win >= 0]
    line = torch.cumsum(text == 0x0A, 0)[a]
    first = torch.ones_like(a, dtype=torch.bool)
    first[1:] = line[1:] != line[:-1]
    return torch.stack([a[first], win[first]], 1), int(first.sum())


def qlines_alone(name, text, plane, tables, count_only: bool) -> dict:
    """qgram_lines at one main-path input: the kernel against its plain
    version and against qlines_library, bit for bit; its device time
    (every pass the run takes, without the host's read of the count), the
    wrapper's with that read, the plain version's, the library
    composite's and the bound."""
    from agrep_tpu_torch.ops import qgram_kernel as qk
    from agrep_tpu_torch.ops.timing import (pass_split, qgram_lines_bound,
                                            time_kernel)
    got = qk._lines_launch(text, plane, tables, False)
    ref = qk.qgram_lines_reference(text, plane, tables)
    diff = max(_qlines_diff(got, ref),
               _qlines_diff(got, qlines_library(text, plane, tables)),
               _qlines_diff(qk._lines_launch(text, plane, tables, True),
                            (None, ref[1])))
    if diff:
        raise AssertionError("%s: qgram_lines differs from its plain "
                             "version or the library composite on %d bytes "
                             "(max |diff| %d)" % (name, text.numel(), diff))
    rows, K = got
    out = None if count_only else rows
    ms = time_kernel(lambda: qk.lines_passes(text, plane, tables, out))
    wrapper_ms = _host_ms(lambda: qk._lines_launch(text, plane, tables,
                                                   count_only))
    plain_ms = _time_plain(lambda: qk.qgram_lines_reference(
        text, plane, tables, count_only))
    library_ms = _host_ms(lambda: qlines_library(text, plane, tables))
    bms, by = qgram_lines_bound(text.numel(), 0 if count_only else K,
                                _set_bits(plane))
    return {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bms, "bound_by": by,
            "K": K, "shape_b": text.numel(), "count_only": count_only,
            "tiles": qk.lines_tiles(text.numel(),
                                    qk.lines_tile_words(text.device)),
            "split": pass_split(lambda: qk.lines_passes(text, plane, tables,
                                                        out),
                                qk, "_lines_call"),
            "max_abs_err": diff}


# ---------------------------------------------------------------------
# line_terms: the streamed boolean's lines on the card
# ---------------------------------------------------------------------

# (name, boolean pattern, -i): the term sets line_terms is held on; the
# last is past the chain caps (a term of 136 byte classes)
TERM_SETS = [
    ("one", "hello", False),
    ("and2", "hello;lazy", False),
    ("and2-i", "HELLO;lazy", True),
    ("and4", "lazy;dog;fox;over", False),
    ("tree", "{hello,matching};~lazy", False),
    ("sixteen", "{" + ",".join(
        ["hello", "matching", "dog", "fox", "over", "quick", "brown",
         "the", "pattern", "search", "world", "lorem", "ipsum",
         "dolor", "grep"]) + "};~lazy", False),
    ("wide", "{hello,matching};~" + WIDE_TERM, False),
]
TERM_OFFSETS = (0, 1, 3, 15)


def term_set(pattern: str, nocase: bool, device):
    """(terms, fold, line_terms' tables on device, chain program or None,
    the 2-gram projection of the q-gram tables) of a boolean pattern."""
    import numpy as np

    from agrep_tpu_torch.compile import boolean, multi
    from agrep_tpu_torch.ops import chain_kernel
    split = boolean.split_pattern(pattern)
    if split is None:
        terms, tree, op = [pattern], None, "and"
    else:
        terms, tree = split.terminals, split.tree
        op = "and" if tree is None else "or"
    terms = [os.fsencode(t) for t in terms]
    tr = np.arange(256, dtype=np.uint8)
    if nocase:
        tr[65:91] += 32
    table = boolean.truth_table(tree, op, [True] * len(terms), len(terms))
    tables = chain_kernel.term_tables(terms, tr, table, device)
    prog = chain_kernel.compile_chain(terms, tr)
    proj = multi.member_projection_1024(multi.build_qgram_tables(terms, tr))
    return terms, tr, tables, prog, proj


def term_texts(seed: int, terms) -> list:
    """(name, u8 numpy text) of the texts line_terms is held on: lines of
    filler and the terms (every line with every term now and then, upper
    case now and then) at 1 KB, 200 KB and 1 MB, and 70 KB without a
    final newline, ending in the set's longest term."""
    import numpy as np
    rng = np.random.default_rng(seed)
    words = FILLER + [t for t in terms if t] * 4

    def lines(n):
        out = bytearray()
        while len(out) < n:
            ws = [words[i] for i in rng.integers(0, len(words),
                                                 int(rng.integers(0, 9)))]
            if rng.random() < 0.03:
                ws += [t for t in terms if t]
            line = b" ".join(ws)
            if rng.random() < 0.1:
                line = line.upper()
            out += line + b"\n"
        return bytes(out[:n])
    return [("1 KB", np.frombuffer(lines(1024), np.uint8)),
            ("200 KB", np.frombuffer(lines(200_000), np.uint8)),
            ("1 MB", np.frombuffer(lines(1 << 20), np.uint8)),
            ("no final newline",
             np.frombuffer(lines(70_000) + b"x " + max(terms, key=len),
                           np.uint8))]


def _terms_diff(got, want) -> int:
    """Largest |kernel - plain| over line_terms' rows, count, carried mask
    and last newline; a different count counts as the larger count."""
    (gr, gk, gc, gn), (wr, wk, wc, wn) = got, want
    if gk != wk:
        return max(gk, wk, 1)
    diff = max(abs(gc - wc), abs(gn - wn))
    if (gr is None) != (wr is None):
        return max(diff, 1)
    if gr is None or gk == 0:
        return diff
    return max(diff, _max_diff(gr, wr))


def phase_parity_line_terms(device: str, seed: int) -> float:
    """line_terms against line_terms_reference on the card, bit for bit
    (rows, count, carried mask, last newline), on every TERM_SETS set over
    term_texts cut at random seams into chunks (each chunk's region its
    body and the set's halo, the mask carried from chunk to chunk, the
    last chunk's tail a line), with chain_scan's plane (shift 0, within
    the caps) and qgram_filter's (shift p_size - 1), each also with junk
    bits that do not verify and with every bit set, in both forms, and on
    views TERM_OFFSETS bytes past an aligned address.  Returns the
    largest |kernel - plain| (0 or fail)."""
    import numpy as np
    import torch

    from agrep_tpu_torch.ops import chain_kernel as ck
    from agrep_tpu_torch.ops import kernels, qgram_kernel as qk
    rng = np.random.default_rng(seed + 22)
    worst = 0
    failed = []
    t0 = time.perf_counter()
    for name, pattern, nocase in TERM_SETS:
        terms, tr, tables, prog, proj = term_set(pattern, nocase, device)
        p = min(len(t) for t in terms)
        maxlen = max(len(t) for t in terms)
        dprog = None if prog is None else ck.device_program(prog, device)
        fired = launches = 0
        for tname, arr in term_texts(seed, terms):
            n = arr.size
            seams = [0] + sorted(set(rng.integers(1, n, 3).tolist())) + [n]
            carry = {}
            last_nl = {}
            for g0, g1 in zip(seams[:-1], seams[1:]):
                region = arr[g0:min(g1 + maxlen - 1, n)]
                text = kernels.to_device(np.ascontiguousarray(region),
                                         device)
                planes = []
                if dprog is not None:
                    planes.append(("chain", ck.chain_scan(text, dprog), 0))
                if proj is not None and p >= 2:
                    planes.append(("qgram", qk.qgram_filter(
                        text, qk.words_tensor(proj, device)), p - 1))
                for pname, plane, shift in list(planes):
                    junk = torch.from_numpy(
                        (rng.random(plane.numel()) < 0.01)
                        * rng.integers(1, 1 << 31, plane.numel())
                    ).to(torch.int32).to(device)
                    planes.append((pname + "+junk", plane | junk, shift))
                planes.append(("every bit", torch.full_like(
                    planes[0][1], -1), p - 1))
                for pname, plane, shift in planes:
                    key = (tname, pname)
                    args = dict(body=g1 - g0, carry=carry.get(key, 0),
                                begin=last_nl.get(key, -1) + 1, cap_e=n,
                                last=g1 >= n, base=g0)
                    want = ck.line_terms_reference(
                        text, plane, shift, tables, count_only=False,
                        **args)
                    for off in TERM_OFFSETS:
                        t = text if off == 0 else _view(text, off)
                        for count_only in (False, True):
                            got = ck.line_terms(t, plane, shift, tables,
                                                count_only=count_only,
                                                **args)
                            launches += 1
                            w = ((None,) + want[1:]) if count_only else want
                            diff = _terms_diff(got, w)
                            worst = max(worst, diff)
                            if diff:
                                failed.append((name, tname, pname, g0, off,
                                               count_only, diff))
                    carry[key], nl_at = want[2], want[3]
                    if nl_at >= 0:
                        last_nl[key] = nl_at
                    fired += want[1]
                del text
        print("parity: line_terms %-8s %2d terms (p=%d, maxlen %d, chain "
              "%s), %d launches over %d texts cut at 3 seams: %d lines "
              "fire; equal bit for bit, rows and count, views at %s"
              % (name, len(terms), p, maxlen, prog is not None, launches,
                 len(term_texts(seed, terms)), fired, list(TERM_OFFSETS)))
    worst = max(worst, terms_tile_cases(device, seed, failed))
    torch.cuda.synchronize()
    print("parity: line_terms in %.1f s" % (time.perf_counter() - t0))
    if failed:
        raise AssertionError("line_terms differs from its plain version: %s"
                             % failed[:20])
    return float(worst)


# a term longer than line_terms' staged halo (kHalo, 256 bytes)
TERM_LONG = "abcdefghijklmnopqrstuvwxyz" * 12


def terms_tile_cases(device: str, seed: int, failed: list) -> int:
    """line_terms at the geometry of its tiles, against
    line_terms_reference bit for bit, in both forms, each launch with the
    wrapper's grid and with forced ones (1, 3, and one a tile: more
    blocks than the card holds at once where the tiles outnumber them):
    bodies at, one before and one after tile edges, on chain_scan's plane,
    qgram_filter's and every bit set; a 312-byte term (past the staged
    halo) planted to start 20 bytes before tile ends; and 8 MB of lines
    (more tiles than resident blocks).  Appends each difference to
    failed; returns the largest |kernel - plain|."""
    import numpy as np
    import torch

    from agrep_tpu_torch.ops import _cuda
    from agrep_tpu_torch.ops import chain_kernel as ck
    from agrep_tpu_torch.ops import kernels, qgram_kernel as qk
    rng = np.random.default_rng(seed + 23)
    idx = _cuda.device_index(device)
    tile = ck._terms_geometry(idx, True)[2]
    resident = ck._terms_geometry(idx, True)[1]

    def lines(n, words):
        out = bytearray()
        while len(out) < n:
            ws = [words[i] for i in rng.integers(0, len(words),
                                                 int(rng.integers(0, 9)))]
            out += b" ".join(ws) + b"\n"
        return bytearray(out[:n])

    edges = lines(3 * tile + 200, FILLER + [b"hello", b"lazy"] * 3)
    long_text = lines(6 * tile, FILLER + [b"hello"] * 2)
    for k in range(1, 6):
        at = k * tile - 20
        long_text[at:at + len(TERM_LONG)] = TERM_LONG.encode()
    big = lines(8 << 20, FILLER + [b"hello", b"lazy", b"dog"] * 2)
    cases = [
        ("edges", "hello;lazy", edges,
         [tile, 2 * tile - 1, 2 * tile, 2 * tile + 1, 3 * tile]),
        ("long term", "hello," + TERM_LONG, long_text,
         [len(long_text) - 300, len(long_text)]),
        ("8 MB", "{hello,dog};~lazy", big, [len(big)]),
    ]
    worst = 0
    t0 = time.perf_counter()
    for cname, pattern, raw, bodies in cases:
        terms, _tr, tables, prog, proj = term_set(pattern, False, device)
        p = min(len(t) for t in terms)
        text = kernels.to_device(np.frombuffer(bytes(raw), np.uint8), device)
        N = text.numel()
        planes = [("chain", ck.chain_scan(text, ck.device_program(prog,
                                                                  device)),
                   0),
                  ("every bit", torch.full(((N + 31) // 32,), -1,
                                           dtype=torch.int32, device=device),
                   p - 1)]
        if proj is not None:
            planes.append(("qgram", qk.qgram_filter(
                text, qk.words_tensor(proj, device)), p - 1))
        n_launch = 0
        for pname, plane, shift in planes:
            for body in bodies:
                kw = dict(body=body, carry=1, begin=3, cap_e=N + 5,
                          last=body == N, base=11)
                tiles = -(-body // tile)
                for count_only in (False, True):
                    want = ck.line_terms_reference(
                        text, plane, shift, tables, count_only=count_only,
                        **kw)
                    grids = sorted({ck.terms_grid(body, not count_only,
                                                  text.device),
                                    1, 3, tiles})
                    for grid in grids:
                        rows = None if count_only else torch.empty(
                            (ck.terms_capacity(body, tables.min_len), 2),
                            dtype=torch.int64, device=device)
                        out = ck._terms_call(
                            text, plane, shift, tables, body, kw["carry"],
                            kw["begin"], kw["cap_e"], kw["last"],
                            kw["base"], rows, grid).tolist()
                        got = (None if rows is None else rows[:out[0]],
                               out[0], out[1], out[2])
                        n_launch += 1
                        diff = _terms_diff(got, want)
                        worst = max(worst, diff)
                        if diff:
                            failed.append((cname, pname, body, grid,
                                           count_only, diff))
        print("parity: line_terms %-9s %d B, tiles of %d B (%d blocks "
              "resident), bodies %s, %d launches at the wrapper's grid, 1, "
              "3 and one block a tile" % (cname, N, tile, resident, bodies,
                                          n_launch))
    print("parity: line_terms tile cases in %.1f s"
          % (time.perf_counter() - t0))
    return worst


def terms_library(text, plane, shift, tables, body, carry, begin, cap_e,
                  last, count_only, base):
    """The function of line_terms as a composite of PyTorch calls on the
    card (the yardstick of library_ms): the plane unpacked by shifts and
    torch.nonzero, every term compared whole at every start through a
    gather of a padded term matrix, each start's line by torch.searchsorted
    of the body's newlines, the lines' hits by index_put_ (accumulate),
    their verdicts gathered from the truth table: (rows, count, carried
    mask, last newline)."""
    import torch
    dev = text.device
    N = text.numel()
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    bits = ((plane.to(torch.int64)[:, None] >> shifts) & 1).flatten()
    s = torch.nonzero(bits).flatten() - shift
    s = s[(s >= 0) & (s < body)]
    t_off = tables.t_off.long()
    lens = t_off[1:] - t_off[:-1]
    NT = lens.numel()
    k = torch.arange(int(lens.max()), dtype=torch.int64, device=dev)
    at = (t_off[:-1, None] + k).clamp(max=tables.t_bytes.numel() - 1)
    terms = tables.t_bytes.long()[at]                       # [NT, L]
    tr, b = tables.tr.long(), text.long()
    got = tr[b[(s[:, None] + k).clamp(max=N - 1)]]          # [S, L]
    ok = ((got[:, None, :] == terms[None]) | (k >= lens[:, None])).all(2)
    ok &= (s[:, None] + lens <= N) & (lens > 0)             # [S, NT]
    nl = torch.nonzero(text[:body] == 0x0A).flatten()
    K = nl.numel()
    line = torch.searchsorted(nl, s)
    cnt = torch.zeros((K + 1, NT), dtype=torch.int64, device=dev)
    li, ti = torch.nonzero(ok, as_tuple=True)
    cnt.index_put_((line[li], ti), torch.ones_like(li), accumulate=True)
    lm = ((cnt > 0).long() << torch.arange(NT, device=dev)).sum(1)
    lm[0] |= carry
    tw = tables.table.to(torch.int64) & 0xFFFFFFFF
    fire = (((tw[lm >> 5] >> (lm & 31)) & 1) != 0) & (lm != 0)
    tail = bool(last) and bool(fire[K])
    last_nl = base + int(nl[-1]) if K else -1
    j = torch.nonzero(fire[:K]).flatten()
    count = j.numel() + tail
    carry_out = 0 if last else int(lm[K])
    if count_only:
        return None, count, carry_out, last_nl
    prev = torch.where(j > 0, base + nl[(j - 1).clamp(min=0)] + 1,
                       torch.full_like(j, begin))
    rows = torch.stack([prev, base + nl[j] + 1], 1)
    if tail:
        rows = torch.cat([rows, torch.tensor(
            [[last_nl + 1 if K else begin, cap_e]], device=dev)])
    return rows, count, carry_out, last_nl


def terms_alone(name, args, kw) -> dict:
    """line_terms at one main-path input (a run's first chunk: the
    wrapper's arguments args and keywords kw): the kernel against its
    plain version and against terms_library, bit for bit, in both forms;
    its launch's device time (without the host's read), the wrapper's
    with that read, the plain version's, the library composite's and the
    bound, in the run's own form."""
    import torch

    from agrep_tpu_torch.ops import chain_kernel as ck
    from agrep_tpu_torch.ops.timing import line_terms_bound, time_kernel
    text, plane, shift, tables = args
    kw = dict(kw)
    count_only = kw.pop("count_only")
    diff = 0
    for form in (False, True):
        ref = ck.line_terms_reference(text, plane, shift, tables,
                                      count_only=form, **kw)
        for got in (ck.line_terms(text, plane, shift, tables,
                                  count_only=form, **kw),
                    terms_library(text, plane, shift, tables,
                                  count_only=form, **kw)):
            diff = max(diff, _terms_diff(got, ref))
    if diff:
        raise AssertionError("%s: line_terms differs from its plain version "
                             "or the library composite on %d bytes (max "
                             "|diff| %d)" % (name, text.numel(), diff))
    K = ref[1]
    N, body = text.numel(), kw["body"]
    out = None if count_only else torch.empty(
        (ck.terms_capacity(body, tables.min_len), 2), dtype=torch.int64,
        device=text.device)
    grid = ck.terms_grid(body, not count_only, text.device)
    ms = time_kernel(lambda: ck._terms_call(
        text, plane, shift, tables, body, kw["carry"], kw["begin"],
        kw["cap_e"], kw["last"], kw["base"], out, grid))

    def call(fn):
        return lambda: fn(text, plane, shift, tables, count_only=count_only,
                          **kw)
    wrapper_ms = _host_ms(call(ck.line_terms))
    plain_ms = _time_plain(call(ck.line_terms_reference))
    library_ms = _host_ms(call(terms_library))
    bms, by = line_terms_bound(N, K, tables.n_bytes, count_only)
    return {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bms, "bound_by": by,
            "K": K, "shape_b": N, "count_only": count_only, "grid": grid,
            "shift": shift, "starts": _set_bits(plane),
            "max_abs_err": diff}


class _Captured(BaseException):
    """Ends a search once its first line_terms call is recorded."""


def terms_inputs(path: str) -> dict:
    """{run: (line_terms' arguments, keywords)} of the first chunk of each
    BOOL_STREAM_RUNS run over the file at path (the file must pass the
    8 MB streaming threshold), as the main path's search on the torch
    backend gives them to the wrapper; the search stops there."""
    from agrep_tpu_torch import api
    from agrep_tpu_torch.ops import chain_kernel
    from agrep_tpu_torch.ops import scan as scan_ops
    real = chain_kernel.line_terms
    got = {}

    def recorder(*args, **kw):
        got["call"] = (args, kw)
        raise _Captured()
    out = {}
    scan_ops.set_backend("torch")
    chain_kernel.line_terms = recorder
    try:
        for name, argv in BOOL_STREAM_RUNS:
            got.clear()
            try:
                with stream_threshold("8"):
                    api.fileagrep(argv + [path], output=io.BytesIO())
            except _Captured:
                pass
            if "call" not in got:
                raise AssertionError("%s made no line_terms call" % name)
            out[name] = got["call"]
    finally:
        chain_kernel.line_terms = real
    return out


# ---------------------------------------------------------------------
# the sticky machines' record lanes: bitap_lanes (phases 3-5)
# ---------------------------------------------------------------------

# the sticky machines phase 3 holds bitap_lanes to: -p and '#', D 0-8,
# uniform and cost wiring, AND and OR
LANE_MACHINES = [
    ["-p", "aproximat"], ["-2", "-p", "hello"], ["appr#mate"], ["-1", "h#o"],
    ["al#ha;ko#la"], ["-1", "br#vo,zz"], ["-2", "-D2", "-I1", "-S1", "br#vo"],
    ["-3", "-I2", "-S1", "-D3", "ma#ing"], ["-4", "-p", "hello"],
    ["-5", "h#llo#orld"], ["-6", "-p", "approximate"],
    ["-7", "-p", "abcdefghi"], ["-8", "abcdefgh#ijklm"],
    ["-8", "-p", "abcdefghijkl"],
]
LANE_WORDS = [b"hello", b"aproximate", b"approximately", b"koala", b"alpha",
              b"bravo", b"zz", b"matching", b"abcdefghijklm", b"helloworld"]
LANE_OFFSETS = (0, 1, 3, 15)
# the sticky runs of phase 4 and the size of their file and buffer
STICKY_MB = 16
STICKY_RUNS = ("wild", "wildp", "memwild")
# a sticky run whose records are past LANES_LONG (the segment maps): the
# STICKY_MB file with one newline every LONG_RECORD bytes
LONG_STICKY_RUNS = ("wildl",)
LONG_RECORD = 256 << 10
MEMORY_RECORD_RUNS = ("memagrep2", "memagrep3")
# the memory runs held at this size against the per-byte loop
LOOP_MB = 1


def lane_machine(argv, device):
    """(compiled query, bitap_lanes' machine, the post-reset states, Init0
    states) of a sticky search's argv."""
    from agrep_tpu_torch.compile.query import compile_query
    from agrep_tpu_torch.ops import scan as scan_ops
    from agrep_tpu_torch.options import parse_args
    from agrep_tpu_torch.runtime import engine
    opts, pattern, _ = parse_args(argv + ["x"])
    q = compile_query(pattern, opts)
    if q.engine_class != "bitap" or not engine.BitapEngine(q).sticky():
        raise AssertionError("%s is not a sticky bitap machine" % argv)
    m = scan_ops.lanes_machine(q.folded_mask, engine._sticky_consts(q), q.D,
                               q.costs, device)
    return (q, m, engine._lane_inits(q, q.D),
            [int(q.consts["init0"])] * (q.D + 1))


def lane_bytes(rng, lens):
    """u8 numpy text of one '\\n'-ended lane a length: seeded letters
    with two of LANE_WORDS planted."""
    import numpy as np
    out = []
    for n in lens:
        t = bytearray(rng.integers(97, 123, n, dtype=np.uint8).tobytes())
        for _ in range(2):
            w = LANE_WORDS[int(rng.integers(0, len(LANE_WORDS)))]
            if len(t) > len(w):
                at = int(rng.integers(0, len(t) - len(w)))
                t[at:at + len(w)] = w
        out.append(bytes(t) + b"\n")
    return np.frombuffer(b"".join(out), dtype=np.uint8)


def long_lane_texts(rng, m, D: int) -> list:
    """(name, text, views) of the long lanes phase 3 holds the segment
    maps to on a machine: lanes of LANES_LONG - 1, LANES_LONG and
    LANES_LONG + 1 record bytes, of a chunk's bytes and one either side,
    of two chunks and a segment, and of 64 KiB, among 50 short ones
    (views: also 7 bytes past an aligned address, and the first lane
    from the post-reset states); at D 2 a 256 KiB lane (lane_texts' 1 MB
    lane is D 0's)."""
    from agrep_tpu_torch.ops import scan as scan_ops
    T = scan_ops.LANES_LONG
    plan = scan_ops.maps_plan(m.nodes)
    chunk = plan["chunk"]
    edges = [T - 1, T, T + 1, chunk - 2, chunk - 1, chunk,
             2 * chunk + plan["seg"] + 3, 64 << 10]
    out = [("edges", lane_bytes(rng, edges
                                + list(rng.integers(0, 200, 50))), True)]
    if D == 2:
        out.append(("lane256KiB", lane_bytes(rng, [256 << 10]), False))
    return out


def lane_texts(rng) -> list:
    """(name, u8 numpy text of '\\n'-ended lanes, views: "all" offsets,
    "some" or none) of every lane set
    phase 3 holds bitap_lanes to: one lane, 33, 5,000 of 0-200 bytes with
    words planted, empty lanes alone, lanes of 8,191, 8,192, 12,345 and
    49,153 bytes among short ones, and a 1 MB lane (held at D 0 only)."""
    import numpy as np
    lanes = functools.partial(lane_bytes, rng)
    return [("R1", lanes([40]), "all"),
            ("R33", lanes(rng.integers(0, 200, 33)), "all"),
            ("R5000", lanes(rng.integers(0, 200, 5000)), "some"),
            ("empty", np.full(100, 0x0A, dtype=np.uint8), "all"),
            ("long", lanes([8191, 8192, 12345, 49153]
                           + list(rng.integers(0, 200, 300))), False),
            ("lane1MB", lanes([1 << 20]), False)]


def _lanes_diff(got, want) -> int:
    """0 when bitap_lanes' (verdicts, hits) equal the plain version's, else
    the largest |hits| difference (at least 1)."""
    import torch
    if torch.equal(got[0], want[0]) and torch.equal(got[1].long(),
                                                    want[1].long()):
        return 0
    return max(1, _max_diff(got[1], want[1]))


def lanes_check(name, text, m, init, first, and_flag, failed: list,
                delim: int = 0x0A) -> int:
    """bitap_lanes on text's lines (line_index at delim) against its plain
    version, with -v and without (the kernel's verdicts against the
    plain hits' under -v); returns the lanes held."""
    from agrep_tpu_torch.ops import renfa_kernel
    from agrep_tpu_torch.ops import scan as scan_ops
    idx = renfa_kernel.line_index(text, delim)
    if idx.nl.numel() == 0:
        return 0
    args = (text, idx.starts, idx.lens, m, init, first, and_flag)
    want = scan_ops.bitap_lanes_reference(*args, False)
    for inv in (False, True):
        got = scan_ops.bitap_lanes(*args, inv)
        v = (want[0] | inv) if and_flag else (want[0] ^ inv)
        d = _lanes_diff(got, (v, want[1]))
        if d:
            failed.append((name, inv, d))
    return idx.nl.numel()


def sticky_streams(corpus):
    """(file stream of the STICKY_MB file as the bitap engine builds it --
    the prefilled newline, the glitch byte at 49,153, the EOF newline --
    and memory mode's buffer: a newline, the corpus, a 0 byte where odd)
    of phase 4's sticky runs, as u8 numpy arrays."""
    import numpy as np
    data = corpus[:STICKY_MB << 20]
    nl = np.frombuffer(b"\n", np.uint8)
    stream = np.concatenate([nl, data[:49152], np.zeros(1, np.uint8),
                             data[49152:], nl])
    mem = np.concatenate([nl, data])
    if len(mem) & 1:
        mem = np.concatenate([mem, np.zeros(1, np.uint8)])
    return stream, mem


def long_records(corpus):
    """The LONG_STICKY_RUNS file: the STICKY_MB corpus with its newlines
    made spaces and one newline ending every LONG_RECORD bytes, and its
    file stream as the bitap engine builds it (sticky_streams')."""
    data = corpus[:STICKY_MB << 20].copy()
    data[data == 0x0A] = 0x20
    data[LONG_RECORD - 1::LONG_RECORD] = 0x0A
    return data, sticky_streams(data)[0]


def phase_parity_lanes(device: str, seed: int) -> int:
    """bitap_lanes against bitap_lanes_reference, bit for bit (verdicts
    and hits), on every LANE_MACHINES machine over lane_texts (also as
    views 1-15 bytes past an aligned address), the first lane from Init0
    and from the post-reset states, with and without -v; then at the
    sticky runs' shapes (phase 4's STICKY_MB file stream and memory
    buffer, 'appr#mate' and -p aproximat); and line_index at the bytes
    'o', '$' and 0 against line_index_reference.  Returns the largest
    difference (0 or fail)."""
    import numpy as np
    import torch

    from agrep_tpu_torch.ops import renfa_kernel
    from agrep_tpu_torch.ops import scan as scan_ops
    rng = np.random.default_rng(seed + 24)
    failed, held, t0 = [], 0, time.perf_counter()
    texts = lane_texts(rng)
    for argv in LANE_MACHINES:
        q, m, init, first = lane_machine(argv, device)
        for name, text, views in texts:
            if name == "lane1MB" and q.D > 0:
                continue
            for off in (LANE_OFFSETS if views == "all" else (0, 15)
                        if views else (0,)):
                buf = torch.zeros(len(text) + 16, dtype=torch.uint8,
                                  device=device)
                buf[off:off + len(text)] = torch.from_numpy(text.copy())
                t = buf[off:off + len(text)]
                for fst in ((first, init) if off == 0 and views
                            else (first,)):
                    held += lanes_check(
                        "%s %s +%d" % (" ".join(argv), name, off), t, m,
                        init, fst, q.and_flag, failed)
    # lanes past LANES_LONG: the segment maps
    maps_before = scan_ops.launches["bitap_lane_maps"]
    long_held, t_long = 0, time.perf_counter()
    for argv in LANE_MACHINES:
        q, m, init, first = lane_machine(argv, device)
        texts = long_lane_texts(rng, m, q.D)
        if argv == ["-p", "aproximat"]:
            texts.append(("lane4MiB", lane_bytes(rng, [4 << 20]), False))
        for name, text, views in texts:
            for off, fst in (((0, first), (0, init), (7, first)) if views
                             else ((0, first),)):
                buf = torch.zeros(len(text) + 16, dtype=torch.uint8,
                                  device=device)
                buf[off:off + len(text)] = torch.from_numpy(text.copy())
                long_held += lanes_check(
                    "%s %s +%d" % (" ".join(argv), name, off),
                    buf[off:off + len(text)], m, init, fst, q.and_flag,
                    failed)
    maps_n = scan_ops.launches["bitap_lane_maps"] - maps_before
    held += long_held
    if not maps_n:
        failed.append(("the long lanes launched no segment maps", 0))
    print("parity: bitap_lanes' segment maps (lanes past LANES_LONG = %d) "
          "vs bitap_lanes_reference on %d machines: %d lanes (LANES_LONG - "
          "1, LANES_LONG, LANES_LONG + 1, a chunk and one either side, two "
          "chunks and a segment, 64 KiB among 50 short ones, at offsets 0 "
          "and 7, the first lane from Init0 and not; 256 KiB at D 2, 4 MiB "
          "for -p aproximat; with and without -v), %d "
          "bitap_lane_maps launches, %.1f s"
          % (scan_ops.LANES_LONG, len(LANE_MACHINES), long_held, maps_n,
             time.perf_counter() - t_long))
    corpus = make_corpus(STICKY_MB << 20, seed)
    stream, mem = sticky_streams(corpus)
    for argv in (["appr#mate"], ["-p", "aproximat"]):
        q, m, init, first = lane_machine(argv, device)
        for name, text, fst in (("file stream", stream, init),
                                ("memory buffer", mem, first)):
            held += lanes_check("%s %s" % (" ".join(argv), name),
                                torch.from_numpy(text).to(device), m, init,
                                fst, q.and_flag, failed)
    idx_bad = 0
    for delim in (ord("o"), ord("$"), 0):
        for n in (1, 17, 4096, 70001, 1 << 20):
            text = rng.choice(np.frombuffer(b"ab\nxyo$\x00", np.uint8), n)
            for off in (0, 3):
                buf = torch.zeros(n + 16, dtype=torch.uint8, device=device)
                buf[off:off + n] = torch.from_numpy(text)
                t = buf[off:off + n]
                a = renfa_kernel.line_index(t, delim)
                b = renfa_kernel.line_index_reference(t, delim)
                if not (all(torch.equal(x, y) for x, y in zip(a[:4], b[:4]))
                        and a.last == b.last):
                    idx_bad += 1
                    failed.append(("line_index", delim, n, off))
    print("parity: bitap_lanes vs bitap_lanes_reference on %d machines "
          "(D 0-8, -p and '#', uniform and cost wiring, AND and OR), %d "
          "lanes (one, 33, 5,000, empty, 8-49 KB, a 1 MB lane at D 0, "
          "views at offsets 1-15, the first lane from Init0 and not, with "
          "and without -v) and at the sticky runs' %d MB file stream and "
          "memory buffer: %d mismatches; line_index at the bytes 'o', '$' "
          "and 0: %d mismatches; %.1f s"
          % (len(LANE_MACHINES), held, STICKY_MB, len(failed) - idx_bad,
             idx_bad, time.perf_counter() - t0))
    if failed:
        raise AssertionError("bitap_lanes parity failed: %s" % failed[:10])
    return 0


def lanes_cut(name, n: dict, counters, printed, loop_calls: int,
              host_lanes: int, want_records: int) -> dict:
    """The checks of a STICKY_RUNS or LONG_STICKY_RUNS run: one
    line_index, one bitap_lanes call and one line_rows launch, one
    bitap_lane_maps launch where records are past LANES_LONG (the
    LONG_STICKY_RUNS) and none where none is, every record cut on the
    card (trace counter lane_records), one row read back a printed
    record (lane_rows; a -c run's rows are reported), no host lane and
    no per-byte loop."""
    recs, rows = counters.get("lane_records", 0), counters.get("lane_rows",
                                                               0)
    maps = int(name in LONG_STICKY_RUNS)
    if (n["bitap_lanes"] != 1 or n["line_index"] != 1 or n["line_rows"] != 1
            or n["bitap_lane_maps"] != maps
            or recs != want_records or loop_calls or host_lanes
            or (printed is not None and rows != printed)):
        raise AssertionError(
            "%s: bitap_lanes %d, bitap_lane_maps %d (want %d), line_index "
            "%d, line_rows %d launches, %d records cut on the card of %d, "
            "%d rows for %s printed, %d host lane scans, %d per-byte loops"
            % (name, n["bitap_lanes"], n["bitap_lane_maps"], maps,
               n["line_index"], n["line_rows"], recs, want_records, rows,
               printed, host_lanes, loop_calls))
    return {"records": recs, "rows": rows, "maps_launches": maps}


def lanes_alone(name, args, device, plain: bool = True) -> dict:
    """bitap_lanes alone on the inputs the main path gave it (text,
    starts, lens, machine, init, first, and_flag, invert): its launches'
    device time (time_kernel: the one-thread walk, and the segment maps
    where a lane is past LANES_LONG; the wrapper's bounds check and
    chunk count read back), the bound, the geometry, and with plain the
    plain version's time and the kernels against the plain version."""
    from agrep_tpu_torch.ops import scan as scan_ops
    from agrep_tpu_torch.ops.timing import lanes_bound, time_kernel
    text, starts, lens, m = args[:4]
    chunks = scan_ops.lane_chunks(text, starts, lens, m)
    ms = time_kernel(lambda: scan_ops._lanes_launch(*args, chunks))
    got = scan_ops._lanes_launch(*args, chunks)
    plain_ms = diff = None
    if plain:
        plain_ms = _time_plain(
            lambda: scan_ops.bitap_lanes_reference(*args))
        diff = _lanes_diff(got, scan_ops.bitap_lanes_reference(*args))
        if diff:
            raise AssertionError("%s: bitap_lanes differs from its plain "
                                 "version (%d)" % (name, diff))
    lens_h = lens.cpu().numpy()
    bms, by = lanes_bound(m, text.numel(), lens_h)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "shape_b": text.numel(), "lanes": len(lens_h),
            "longest": int(lens_h.max()) + 1, "true": int(got[0].sum()),
            "max_abs_err": diff, "chunks": chunks,
            "geometry": scan_ops.lanes_geometry(len(lens_h), m, device,
                                                chunks)}


# the serial lanes: searches over a STICKY_MB file with no delimiter in
# it (one record, one lane, past LANES_LONG: the segment maps)
SERIAL_RUNS = (["-p", "-c", "aproximat"], ["-2", "-p", "-c", "hello"],
               ["-2", "-D2", "-I1", "-S1", "-c", "br#vo"])


def serial_lanes(corpus, device: str, card: str) -> list:
    """The serial lanes: a STICKY_MB file with no delimiter in it is one
    record, one lane of 16 MB.  Each of SERIAL_RUNS over it on the card
    (wall; one bitap_lanes call, one bitap_lane_maps launch), bitap_lanes
    alone on its inputs (time against the bound, and against n times the
    bound, the segment maps' floor), and the lane's hits against the
    native sequential scan of the same stream with the sticky Init1 (the
    per-byte loop's machine in C: its event at the last byte)."""
    import numpy as np

    from agrep_tpu_torch import api, native
    from agrep_tpu_torch.ops import scan as scan_ops
    from agrep_tpu_torch.runtime import engine
    data = corpus[:STICKY_MB << 20].copy()
    data[data == 0x0A] = 0x20
    stream = np.concatenate([np.frombuffer(b"\n", np.uint8), data,
                             np.frombuffer(b"\n", np.uint8)])
    real = scan_ops.bitap_lanes
    out = []
    build = os.path.join(REPO, "build")
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = os.path.join(tmp, "serial.txt")
        data.tofile(path)
        for argv in SERIAL_RUNS:
            got = {}

            def recorder(*args):
                got.setdefault("args", args)
                return real(*args)
            scan_ops.bitap_lanes = recorder
            before = dict(scan_ops.launches)
            try:
                t0 = time.perf_counter()
                ran = _run(api.fileagrep, argv + [path])
                wall = time.perf_counter() - t0
            finally:
                scan_ops.bitap_lanes = real
            n = {k: scan_ops.launches[k] - before[k] for k in before}
            if n != {"bitap_lanes": 1, "bitap_lane_maps": 1}:
                raise AssertionError("serial lane %s: launches %s, not one "
                                     "call through the segment maps"
                                     % (" ".join(argv), n))
            alone = lanes_alone("serial", got["args"], device, plain=False)
            q, m, _init, _first = lane_machine(
                [a for a in argv if a != "-c"], device)
            consts = dict(engine._sticky_consts(q))
            consts["init1_ns"] = consts["init1"]
            pos, words = native.bitap_scan_events(
                stream, q.folded_mask, consts, q.D, "bitap", q.costs)
            want = int(words[-1]) & int(q.consts["endpos"]) \
                if len(pos) and pos[-1] == len(stream) - 1 else 0
            args = got["args"]
            hits = scan_ops._lanes_launch(
                *args, scan_ops.lane_chunks(*args[:4]))[1].cpu().numpy()
            lens = args[2].cpu().numpy()
            lane = int(hits[int(np.argmax(lens))])
            if lane != want:
                raise AssertionError("serial lane %s: hits %#x on the card, "
                                     "%#x by the native sequential scan"
                                     % (" ".join(argv), lane, want))
            g = alone["geometry"]
            print("lanes: serial lane %s over a %d MB file with no "
                  "delimiter (one lane of %d B): rc=%d out=%d B, GPU route "
                  "wall %.3f s, %d bitap_lanes call, %d bitap_lane_maps "
                  "launch; the launches alone %.3f ms (%.1f MB/s), bound "
                  "%.4f ms (%s), n %d columns: n x bound %.4f ms; seg %d B, "
                  "%d segments a block, %d chunks, maps threads %d, blocks "
                  "an SM %d, registers %d; hits %#x equal to the native "
                  "sequential scan's | card: %s"
                  % (" ".join(argv), STICKY_MB, alone["longest"], ran[1],
                     ran[2], wall, n["bitap_lanes"], n["bitap_lane_maps"],
                     alone["ms"], alone["longest"] / alone["ms"] / 1e3,
                     alone["bound_ms"], alone["bound_by"], g["n"],
                     g["n"] * alone["bound_ms"], g["seg"], g["groups"],
                     alone["chunks"], g["maps_threads"],
                     g["maps_blocks_per_sm"], g["maps_regs"], lane, card))
            out.append(dict(alone, wall_s=wall, argv=argv,
                            maps_launches=n["bitap_lane_maps"]))
    return out


def maps_alone(device: str, seed: int, card: str) -> dict:
    """bitap_lanes on one 1 MiB lane of -p aproximat (D 0), past
    LANES_LONG: the call's device time (the one-thread walk's launch,
    which skips the lane, and the segment maps'), the plain version's
    time and the kernels against it, and the bound."""
    import numpy as np
    import torch

    from agrep_tpu_torch.ops import scan as scan_ops
    from agrep_tpu_torch.ops.timing import lanes_bound, time_kernel
    q, m, init, first = lane_machine(["-p", "aproximat"], device)
    text = torch.from_numpy(lane_bytes(np.random.default_rng(seed + 25),
                                       [1 << 20]).copy()).to(device)
    starts = torch.zeros(1, dtype=torch.int64, device=device)
    lens = torch.full((1,), 1 << 20, dtype=torch.int64, device=device)
    args = (text, starts, lens, m, init, first, q.and_flag, False)
    chunks = scan_ops.lane_chunks(text, starts, lens, m)
    if not chunks:
        raise AssertionError("a 1 MiB lane is not past LANES_LONG")
    ms = time_kernel(lambda: scan_ops._lanes_launch(*args, chunks))
    plain_ms = _time_plain(lambda: scan_ops.bitap_lanes_reference(*args))
    diff = _lanes_diff(scan_ops._lanes_launch(*args, chunks),
                       scan_ops.bitap_lanes_reference(*args))
    if diff:
        raise AssertionError("bitap_lane_maps differs from the plain "
                             "version on a 1 MiB lane (%d)" % diff)
    bms, by = lanes_bound(m, text.numel(), np.array([1 << 20]))
    print("times: bitap_lane_maps -p aproximat one 1 MiB lane: %.4f ms a "
          "call (%d chunks), %.2f %% of its %.4f ms bound (%s), n %d "
          "columns: n x bound %.4f ms; plain %.1f ms | card: %s"
          % (ms, chunks, 100 * bms / ms, bms, by, m.nodes, m.nodes * bms,
             plain_ms, card))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "max_abs_err": diff, "n": m.nodes}


def _run(api_fn, argv, data=None):
    """(stdout sha256, exit code, stdout bytes, lines printed but the
    Grand Total) of one search in this process."""
    buf = io.BytesIO()
    if data is None:
        rc = api_fn(argv, output=buf)
    else:
        rc = api_fn(argv, data, output=buf)
    out = buf.getvalue()
    return (hashlib.sha256(out).hexdigest(), rc & 0xFF, len(out),
            sum(not line.startswith(b"Grand Total")
                for line in out.splitlines()))


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


# the runs that must read their events back through event_pairs, and
# the shapes event_pairs is timed at (configs 2-3 cut their records from
# the planes, but their chunks' planes are event_pairs' too elsewhere)
PAIRS_RUNS = ("config1", "memagrep", "bool5m")
PAIRS_SHAPES = ("config1", "config2", "config3", "memagrep", "bool5m")
# the runs past the chain caps whose lines qgram_lines folds on the card
QLINE_RUNS = ("config5q", "config5qn")
# AGREP_TORCH_STREAM_MB of the runs that print a file whole, as a file
# under the streaming threshold is printed: config5qn holds the
# whole-file route, whose output config5qs's chunks must give, and
# "config4n whole" is config4n read whole on the numpy backend, whose
# output config4n's chunks must give
WHOLE_FILE_RUNS = {"config5qn": "128", "config4n whole": "128"}
# the -f prints and the booleans streamed in chunks at the default 8 MB
# threshold, and the kernels each of their chunks launches once
STREAMED_RUNS = {"config5s": ("chain_scan",),
                 "config5qs": ("qgram_filter", "qgram_lines"),
                 "bools": ("chain_scan", "line_terms"),
                 "boolsc": ("chain_scan", "line_terms"),
                 "boolst": ("chain_scan", "line_terms"),
                 "boolsq": ("qgram_filter", "line_terms")}
# the streamed booleans on config 1's line corpus: an AND printed, an AND
# of four counted, a tree with negation printed, and that tree past the
# chain caps (a term of 136 byte classes: qgram_filter's plane)
BOOL_STREAM_RUNS = [
    ("bools", ["hello;lazy"]),
    ("boolsc", ["-c", "lazy;dog;fox;over"]),
    ("boolst", ["{hello,matching};~lazy"]),
    ("boolsq", ["{hello,matching};~" + WIDE_TERM]),
]
# the streamed booleans held to the numpy backend's whole-file bytes: the
# count over the whole corpus, the prints over its first BOOL_WHOLE_MB MB
# (two chunks, one seam; the whole-file print walk is slow on the host)
BOOL_WHOLE_MB = 40


@contextlib.contextmanager
def stream_threshold(mb):
    """AGREP_TORCH_STREAM_MB at mb (None: as it is), restored after."""
    was = os.environ.get("AGREP_TORCH_STREAM_MB")
    if mb is not None:
        os.environ["AGREP_TORCH_STREAM_MB"] = mb
    try:
        yield
    finally:
        if was is None:
            os.environ.pop("AGREP_TORCH_STREAM_MB", None)
        else:
            os.environ["AGREP_TORCH_STREAM_MB"] = was


def stream_mb(name: str):
    """The run's AGREP_TORCH_STREAM_MB (WHOLE_FILE_RUNS; the default 8
    for STREAMED_RUNS), restored after."""
    return stream_threshold(WHOLE_FILE_RUNS.get(
        name, "8" if name in STREAMED_RUNS else None))


# qgram_lines' inputs timed alone: the whole-file runs' streams and the
# first chunk of config5qs
QLINE_SHAPES = QLINE_RUNS + ("config5qs",)


def stream_check(name: str, n: dict, reads: dict, finds: int, counters,
                 size: int, chunk: int) -> None:
    """A streamed -f print or boolean on the card (STREAMED_RUNS): as many
    chunks as the file holds (stream_print_chunks, bool_stream_chunks),
    one launch of each of its kernels a chunk and of no other -f kernel,
    no host find and, past the chain caps or for a boolean, no start
    positions read back."""
    chunks = -(-size // chunk)
    kinds = STREAMED_RUNS[name]
    got = {k: n[k] for k in ("chain_scan", "qgram_filter", "qgram_lines",
                             "line_terms")}
    want = {k: chunks if k in kinds else 0 for k in got}
    streamed = counters.get("bool_stream_chunks" if "line_terms" in kinds
                            else "stream_print_chunks", 0)
    positions = (reads["plane_positions"] if kinds[-1] != "chain_scan"
                 else 0)
    if got != want or streamed != chunks or finds or positions:
        raise AssertionError(
            "%s: %d chunks of %d B streamed (want %d), launches %s (want "
            "%s), %d host finds, %d start positions read back"
            % (name, streamed, chunk, chunks, got, want, finds, positions))


def _host_ms(fn, reps: int = 5) -> float:
    """Median ms of reps calls of fn on the host's clock, each ended by a
    synchronize, after one warm-up call: for a call that waits for the
    card itself (a read of its result's size)."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[len(ts) // 2]


def pairs_library(planes, vals, W: int, L: int, N: int, keep_from: int):
    """The function of event_pairs as a composite of PyTorch calls on the
    card (the yardstick of library_ms; the port never calls it): every
    plane's bytes unpacked by shifts into a dense column mask, the body
    columns cut out, the values OR-ed in, then torch.nonzero."""
    import torch
    P, T, nw = planes.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=planes.device)
    bits = (planes.view(torch.uint8).view(P, T, 4 * nw, 1) >> shifts) & 1
    cols = bits.view(P, T, 32 * nw)[:, :, W:W + L].reshape(P, -1)[:, :N]
    v = vals.to(torch.int64)
    ev = torch.zeros(N, dtype=torch.int64, device=planes.device)
    for i in range(P):
        ev |= cols[i].to(torch.int64) * v[i]
    ev[:keep_from] = 0
    pos = torch.nonzero(ev).flatten()
    return pos, ev[pos].to(torch.uint32)


def pairs_alone(name, planes, vals, W: int, L: int, N: int,
                keep_from: int) -> dict:
    """event_pairs at one main-path shape: the kernel against its plain
    version and against pairs_library, bit for bit; the kernel's device
    time (its launch, without the host's read of K, by time_kernel), the
    wrapper's time with that read (and its second launches past the
    capacity), the plain version's, the library composite's (host
    clock, synchronized) and the bound."""
    from agrep_tpu_torch.ops import kernels
    from agrep_tpu_torch.ops.timing import pairs_bound, time_kernel
    got = kernels._pairs_launch(planes, vals, W, L, N, keep_from)
    diff = max(_pairs_diff(got, kernels.event_pairs_reference(
        planes, vals, W, L, N, keep_from)), _pairs_diff(
            got, pairs_library(planes, vals, W, L, N, keep_from)))
    if diff:
        raise AssertionError("%s: event_pairs differs from its plain "
                             "version or the library composite on %d bytes "
                             "(max |diff| %d)" % (name, N, diff))
    pos, word = got
    K = pos.numel()
    ms = time_kernel(lambda: kernels.pairs_passes(planes, vals, W, L, N,
                                                  keep_from, pos, word))
    again = kernels.relaunches["event_pairs"]
    wrapper_ms = _host_ms(lambda: kernels._pairs_launch(planes, vals, W, L,
                                                        N, keep_from))
    plain_ms = _time_plain(lambda: kernels.event_pairs_reference(
        planes, vals, W, L, N, keep_from))
    library_ms = _host_ms(lambda: pairs_library(planes, vals, W, L, N,
                                                keep_from))
    bms, by = pairs_bound(vals, N, keep_from, K)
    return {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bms, "bound_by": by,
            "K": K, "shape_b": N, "planes": planes.shape[0],
            "grid": kernels.pairs_grid(N, keep_from, planes.shape[0],
                                       planes.device)[0],
            "relaunches": kernels.relaunches["event_pairs"] - again,
            "max_abs_err": diff}


# the runs whose bitap records the card must cut (record_verdicts)
RECORD_RUNS = ("config2", "config2c", "config3")


def records_cut(name, n: dict, again: int, calls, counters) -> dict:
    """The checks of a RECORD_RUNS run: it launched record_verdicts and
    no event_pairs, took no second launch (again), and the rows it read
    back (trace counter record_rows) are the records that fire, as
    record_verdicts_reference counts them on the same planes, of the
    events event_pairs_reference finds there (record_pairs)."""
    from agrep_tpu_torch.ops import kernels
    if n["record_verdicts"] == 0 or not calls:
        raise AssertionError("%s: the main path cut its records without "
                             "record_verdicts" % name)
    if n["event_pairs"] or again:
        raise AssertionError("%s: the records route launched event_pairs "
                             "%d times and took %d second launches"
                             % (name, n["event_pairs"], again))
    fire = sum(kernels.record_verdicts_reference(*a)[0].shape[0]
               for a in calls)
    pairs = sum(kernels.event_pairs_reference(*a[:6])[0].numel()
                for a in calls)
    rows = counters.get("record_rows", 0)
    if rows != fire or counters.get("record_pairs", 0) != pairs:
        raise AssertionError(
            "%s: %d rows read back of %d events (record_pairs %d), where "
            "%d records fire" % (name, rows, pairs,
                                 counters.get("record_pairs", 0), fire))
    return {"launches": n["record_verdicts"], "rows": rows, "pairs": pairs,
            "fire": fire}


def records_library(planes, vals, W: int, L: int, N: int, keep_from: int,
                    endpos: int, d_endpos: int, skip_pos: int,
                    and_flag: bool, invert: bool, acc: int):
    """The function of record_verdicts as a composite of PyTorch calls on
    the card (the yardstick of library_ms; the port never calls it):
    pairs_library's events, then a torch.cumsum of the delimiter flags
    numbers each event's record, a scatter_add of each endpos bit's
    flags counts its hits a record, the verdicts, and the rows by
    torch.nonzero."""
    import torch
    pos, word = pairs_library(planes, vals, W, L, N, keep_from)
    keep = pos != skip_pos
    p = pos[keep]
    w = word.to(torch.int64)[keep] & 0xFFFFFFFF
    end = (w & d_endpos) != 0
    rec = torch.cumsum(end.to(torch.int64), 0)
    rec -= end.to(torch.int64)
    ends = torch.nonzero(end).flatten()
    E = ends.numel()
    accs = torch.zeros(E + 1, dtype=torch.int64, device=pos.device)
    accs[0] = acc & endpos
    for b in range(32):
        if endpos >> b & 1:
            hits = torch.zeros(E + 1, dtype=torch.int64, device=pos.device)
            hits.scatter_add_(0, rec, (w >> b) & 1)
            accs |= (hits > 0).to(torch.int64) << b
    racc = accs[:E]
    fire = ((((racc & endpos) == endpos) | invert) if and_flag
            else ((racc != 0) ^ invert))
    k = torch.nonzero(fire).flatten()
    ep = p[ends]
    prev = torch.cat([ep.new_full((1,), -1), ep[:-1]])
    last = int(ep[-1].item()) if E else -1
    return (torch.stack([k, ep[k], prev[k]], 1),
            (E, last, int(accs[E].item()), pos.numel()))


def records_alone(name, planes, vals, W, L, N, keep_from, endpos, d_endpos,
                  skip_pos, and_flag, invert, acc) -> dict:
    """record_verdicts at one main-path input (a chunk's planes): the
    kernel against its plain version and against records_library, bit
    for bit; its device time (its launch, without the host's read of the
    summary, by time_kernel), the wrapper's time with that read, the
    plain version's, the library composite's (host clock, synchronized)
    and the bound."""
    from agrep_tpu_torch.ops import kernels
    from agrep_tpu_torch.ops.timing import plane_records_bound, time_kernel
    args = (planes, vals, W, L, N, keep_from, endpos, d_endpos, skip_pos,
            and_flag, invert, acc)
    got = kernels._records_launch(*args)
    diff = max(_rows_diff(got, kernels.record_verdicts_reference(*args)),
               _rows_diff(got, records_library(*args)))
    if diff:
        raise AssertionError("%s: record_verdicts differs from its plain "
                             "version or the library composite on %d bytes "
                             "(max |diff| %d)" % (name, N, diff))
    rows, (E, _last, _acc, K) = got
    ms = time_kernel(lambda: kernels.records_passes(*args, rows))
    wrapper_ms = _host_ms(lambda: kernels._records_launch(*args))
    plain_ms = _time_plain(lambda: kernels.record_verdicts_reference(*args))
    library_ms = _host_ms(lambda: records_library(*args))
    bms, by = plane_records_bound(vals, endpos, d_endpos, N, keep_from, E,
                                  rows.shape[0])
    return {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bms, "bound_by": by,
            "K": K, "R": rows.shape[0], "ends": E,
            "grid": kernels.records_grid(N, keep_from, planes.shape[0],
                                         planes.device)[0],
            "max_abs_err": diff}


# config 2 with -v: nearly every record fires, more rows than a first
# chunk's capacity holds; its file (CONFIG2V_MB of the main-path corpus,
# ~1.4 s of printing on each backend a MB) is streamed in CONFIG2V_CHUNK
# chunks, so that the chunks after the first allocate from the first's
# rows
CONFIG2V = ("config2v", ["-1", "-v", "-n", "matching"])
CONFIG2V_MB = 8
CONFIG2V_CHUNK = 2 << 20


def records_relaunch(path: str) -> dict:
    """CONFIG2V over path on the card in CONFIG2V_CHUNK chunks: its
    record_verdicts launches and second launches, rows, and its stdout
    against the numpy backend's."""
    from agrep_tpu_torch import api
    from agrep_tpu_torch.ops import kernels
    from agrep_tpu_torch.ops import scan as scan_ops
    from agrep_tpu_torch.runtime import trace
    n0 = kernels.launches["record_verdicts"]
    r0 = kernels.relaunches["record_verdicts"]
    trace_was = trace.ENABLED
    chunk_was = scan_ops.STREAM_CHUNK
    stream_was = os.environ.get("AGREP_TORCH_STREAM_MB")
    trace.ENABLED = True
    trace.counters.pop("record_rows", None)
    scan_ops.STREAM_CHUNK = CONFIG2V_CHUNK
    os.environ["AGREP_TORCH_STREAM_MB"] = "0"
    try:
        t0 = time.perf_counter()
        got = _run(api.fileagrep, CONFIG2V[1] + [path])
        wall = time.perf_counter() - t0
        rows = trace.counters.get("record_rows", 0)
        scan_ops.set_backend("numpy")
        want = _run(api.fileagrep, CONFIG2V[1] + [path])
    finally:
        scan_ops.set_backend("torch")
        trace.ENABLED = trace_was
        scan_ops.STREAM_CHUNK = chunk_was
        if stream_was is None:
            os.environ.pop("AGREP_TORCH_STREAM_MB", None)
        else:
            os.environ["AGREP_TORCH_STREAM_MB"] = stream_was
    if got[:2] != want[:2]:
        raise AssertionError("config2v: stdout sha256/rc %s on the GPU, %s "
                             "on the numpy backend" % (got[:2], want[:2]))
    return {"launches": kernels.launches["record_verdicts"] - n0,
            "relaunches": kernels.relaunches["record_verdicts"] - r0,
            "rows": rows, "wall_s": wall}


# the runs whose lines the card must index and read back (line_index,
# renfa_lanes, line_rows)
LINE_RUNS = ("config4", "config4n", "memagrep4")


def regex_chunks(data) -> int:
    """The chunks the regex engine cuts a stream of data into: each
    window of max(STREAM_CHUNK, 64 KiB) bytes cut after its last newline
    (the stream's end for the last), a window without one grown by a
    window."""
    import numpy as np

    from agrep_tpu_torch.ops.scan import STREAM_CHUNK
    chunk = max(STREAM_CHUNK, 1 << 16)
    n, lo, cuts = len(data), 0, 0
    while lo < n:
        hi = min(lo + chunk, n)
        nls = np.flatnonzero(data[lo:hi] == 0x0A)
        while hi < n and not len(nls):
            hi = min(hi + chunk, n)
            nls = np.flatnonzero(data[lo:hi] == 0x0A)
        lo = n if hi == n else lo + int(nls[-1]) + 1
        cuts += 1
    return cuts


class HostIndexCalls:
    """The numpy module as runtime/regex_engine.py sees it, counting the
    calls that index or sort at least `big` elements: a newline index or
    length sort of a chunk or a stream, which the torch route no longer
    builds on the host (the engine's own small calls pass)."""

    def __init__(self, big: int = 1 << 16):
        import numpy
        self._np = numpy
        self.big = big
        self.calls = []

    def __getattr__(self, name):
        real = getattr(self._np, name)
        if name not in ("flatnonzero", "argsort", "count_nonzero",
                        "nonzero"):
            return real

        def call(a, *args, **kw):
            if self._np.size(a) >= self.big:
                self.calls.append((name, int(self._np.size(a))))
            return real(a, *args, **kw)
        return call


def lines_cut(name, n: dict, printed: int, counters, want_lines: int,
              chunks: int, host_calls) -> dict:
    """The checks of a LINE_RUNS run: one line_index and one line_rows
    launch a chunk (memory mode: the buffer), every line indexed on the
    card (trace counter regex_lines), a row read back a printed line
    (regex_rows; none for a count), and no newline index or length sort
    on the host."""
    lines, rows = counters.get("regex_lines", 0), counters.get(
        "regex_rows", 0)
    if (n["line_index"] != chunks or n["line_rows"] != chunks
            or lines != want_lines or rows != printed or host_calls):
        raise AssertionError(
            "%s: line_index %d and line_rows %d launches for %d chunks, "
            "%d lines indexed on the card of %d, %d rows read back for %d "
            "printed lines, host index calls %s"
            % (name, n["line_index"], n["line_rows"], chunks, lines,
               want_lines, rows, printed, host_calls[:5]))
    return {"chunks": chunks, "lines": lines, "rows": rows}


def index_library(text):
    """The function of line_index as a composite of PyTorch calls on the
    card (the yardstick of library_ms; the port never calls it):
    torch.nonzero of the newlines, then a stable torch.sort of the
    lengths."""
    import torch
    nl = torch.nonzero(text == 0x0A).flatten()
    starts = torch.cat([nl.new_zeros(min(1, nl.numel())), nl[:-1] + 1])
    lens = nl - starts
    order = torch.sort(lens, stable=True).indices
    return nl, starts[order], lens[order], order


def rows_library(v, ords, nl, invert, first, end, glitch):
    """The function of line_rows as a composite of PyTorch calls on the
    card (the yardstick of library_ms): the flags put to their ordinals
    by index_put_, torch.nonzero of them, the starts and newlines
    gathered."""
    import torch
    K = nl.numel()
    keep = (v ^ bool(invert)) & (ords >= first) & (ords < end)
    fire = torch.zeros(K, dtype=torch.bool, device=nl.device)
    fire.index_put_((ords,), keep)
    j = torch.nonzero(fire).flatten()
    prev = torch.cat([nl.new_full((1,), -1), nl[:-1]])
    rows = torch.stack([j, prev[j] + 1, nl[j]], 1)
    if glitch >= 0:
        rows[:, 1:] -= (rows[:, 1:] > glitch).to(torch.int64)
    return rows


def index_alone(name, text) -> dict:
    """line_index at one main-path text: the kernel against its plain
    version, and against index_library where every line is shorter than
    its exact keys' 128 bytes (the two orders agree there); the kernel's
    device time (every pass, without the host's read of K, by
    time_kernel), the wrapper's with that read, the plain version's, the
    library composite's (host clock, synchronized) and the bound."""
    from agrep_tpu_torch.ops import renfa_kernel as rk
    from agrep_tpu_torch.ops.timing import (line_index_bound, pass_split,
                                            time_kernel)
    idx = rk._index_launch(text)
    diff = _index_diff(idx, rk.line_index_reference(text))
    lib = index_library(text)
    if int(idx.lens.max().item()) < rk.EXACT_LEN:
        diff = max(diff, max(_max_diff(a, b) for a, b in zip(idx[:4], lib)))
    if diff:
        raise AssertionError("%s: line_index differs from its plain "
                             "version or the library composite on %d bytes "
                             "(max |diff| %d)" % (name, text.numel(), diff))
    K = idx.nl.numel()
    ms = time_kernel(lambda: rk.index_passes(text, idx))
    wrapper_ms = _host_ms(lambda: rk._index_launch(text))
    plain_ms = _time_plain(lambda: rk.line_index_reference(text))
    library_ms = _host_ms(lambda: index_library(text))
    bms, by = line_index_bound(text.numel(), K)
    return {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bms, "bound_by": by,
            "K": K, "shape_b": text.numel(),
            "grids": (rk.index_grid(text),), "max_abs_err": diff,
            "split": pass_split(lambda: rk.index_passes(text, idx), rk,
                                "_index_call"),
            "idx": idx}


def rows_alone(name, v, idx, invert, first, end, glitch) -> dict:
    """line_rows at one main-path input in both forms (the rows a print
    takes, and a count): the kernel against its plain version and
    against rows_library, bit for bit; its launch's device time (without
    the host's read of the count), the wrapper's with that read, the
    plain version's, the library composite's (rows form) and the bound."""
    from agrep_tpu_torch.ops import renfa_kernel as rk
    from agrep_tpu_torch.ops.timing import (line_rows_bound, pass_split,
                                            time_kernel)
    args = (invert, first, end, glitch)
    ords, nl = idx.ords, idx.nl
    diff = 0
    for want in (True, False):
        got = rk._rows_launch(v, ords, nl, *args, want)
        diff = max(diff, _line_rows_diff(got, rk.line_rows_reference(
            v, ords, nl, *args, want)),
            _rows_library_diff(got, v, ords, nl, args + (want,)))
        if want:
            rows = got[0]
    if diff:
        raise AssertionError("%s: line_rows differs from its plain version "
                             "or the library composite on %d lines (max "
                             "|diff| %d)" % (name, nl.numel(), diff))
    K = nl.numel()
    ms = time_kernel(lambda: rk.rows_passes(v, ords, nl, *args, rows))
    count_ms = time_kernel(lambda: rk.rows_passes(v, ords, nl, *args, None))
    wrapper_ms = _host_ms(lambda: rk._rows_launch(v, ords, nl, *args, True))
    count_wrapper_ms = _host_ms(lambda: rk._rows_launch(v, ords, nl, *args,
                                                        False))
    plain_ms = _time_plain(lambda: rk.line_rows_reference(
        v, ords, nl, *args))
    library_ms = _host_ms(lambda: rows_library(v, ords, nl, *args))
    F = int((v ^ bool(invert)).sum().item())
    bms, by = line_rows_bound(K, F, rows.shape[0])
    return {"ms": ms, "count_ms": count_ms, "wrapper_ms": wrapper_ms,
            "count_wrapper_ms": count_wrapper_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bms, "bound_by": by,
            "count_bound_ms": line_rows_bound(K, F, 0)[0],
            "K": K, "R": rows.shape[0],
            "grids": (rk.rows_grid(K, True, v.device),
                      rk.rows_grid(K, False, v.device)),
            "max_abs_err": diff,
            "split": pass_split(lambda: rk.rows_passes(
                v, ords, nl, *args, rows), rk, "_rows_call")}


def phase_main(device: str, seed: int, mb: int, card: str) -> dict:
    import numpy as np
    import torch

    from agrep_tpu_torch import api
    from agrep_tpu_torch.compile.query import compile_query
    from agrep_tpu_torch.ops import chain_kernel, kernels, qgram_kernel
    from agrep_tpu_torch.ops import renfa, renfa_kernel
    from agrep_tpu_torch.ops import scan as scan_ops
    from agrep_tpu_torch.ops.timing import (bound, chain_bound, qgram_bound,
                                            regex_bound, time_kernel)
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
    # the inputs of each kernel wrapper's first call in each run, for the
    # kernel-alone checks below (the wrappers still count their launches)
    seen: dict = {}
    real = {"chain_scan": (chain_kernel, chain_kernel.chain_scan),
            "qgram_filter": (qgram_kernel, qgram_kernel.qgram_filter),
            "qgram_lines": (qgram_kernel, qgram_kernel.qgram_lines),
            "mask_scan": (kernels, kernels.mask_scan),
            "event_pairs": (kernels, kernels.event_pairs),
            "record_verdicts": (kernels, kernels.record_verdicts),
            "line_index": (renfa_kernel, renfa_kernel.line_index),
            "line_rows": (renfa_kernel, renfa_kernel.line_rows),
            "line_terms": (chain_kernel, chain_kernel.line_terms),
            "bitap_lanes": (scan_ops, scan_ops.bitap_lanes)}
    # the inputs of every record_verdicts call of the run
    rv_calls: list = []

    def recorder(kname, fn):
        def call(*args, **kw):
            # line_terms' keywords too (the engine passes its chunk's)
            seen.setdefault(kname, (args, kw) if kw else args)
            if kname == "record_verdicts":
                rv_calls.append(args)
            return fn(*args, **kw)
        return call

    # calls of the pure count's line count and of the read-back of start
    # positions, which the occurrence route takes
    reads = {"lines_with_starts": 0, "plane_positions": 0}
    real_reads = {k: getattr(chain_kernel, k) for k in reads}

    def read_counter(name, fn):
        def call(*args):
            reads[name] += 1
            return fn(*args)
        return call

    # calls of the -d flat-OR path's pass over the card's anchors, and
    # the trace counter of compile/multi.py's qgram_occurrences, which
    # no -d run may reach
    from agrep_tpu_torch import native
    from agrep_tpu_torch.runtime import trace
    at_calls = [0]
    real_at = native.qgram_first_per_anchor_at

    def at_counted(*args, **kw):
        at_calls[0] += 1
        return real_at(*args, **kw)

    # the regex engine's numpy calls over a chunk or the stream (a host
    # newline index or length sort), which the torch route no longer makes
    from agrep_tpu_torch.runtime import regex_engine
    host_index = HostIndexCalls()
    real_np = regex_engine.np
    # the lines each LINE_RUNS run must index on the card, in chunks
    want_lines = {"config4": (int(np.count_nonzero(corpus == 0x0A)),
                              regex_chunks(corpus)),
                  "memagrep4": (mem_data.count(b"\n"), 1)}
    want_lines["config4n"] = want_lines["config4"]

    # calls of the host's per-term find, which no streamed print makes on
    # the card
    from agrep_tpu_torch.runtime import mgrep
    finds = [0]
    real_find = mgrep._find_occurrences

    def find_counted(*args):
        finds[0] += 1
        return real_find(*args)

    # calls of the bitap engine's per-byte memory loop and of the host's
    # record lanes, which no run on the card makes
    from agrep_tpu_torch.runtime import engine
    host_calls = {"loop": 0, "lanes": 0}
    real_loop = engine.BitapEngine._memory_search_loop
    real_lanes = scan_ops.scan_lanes

    def loop_counted(*args, **kw):
        host_calls["loop"] += 1
        return real_loop(*args, **kw)

    def lanes_counted(*args, **kw):
        host_calls["lanes"] += 1
        return real_lanes(*args, **kw)
    sticky_stream, sticky_mem = sticky_streams(corpus)
    want_records = {"wild": int(np.count_nonzero(sticky_stream == 0x0A)),
                    "memwild": int(np.count_nonzero(sticky_mem == 0x0A))}
    want_records["wildp"] = want_records["wild"]
    mem16 = b"\n" + corpus[:STICKY_MB << 20].tobytes()
    long_data, long_stream = long_records(corpus)
    want_records["wildl"] = int(np.count_nonzero(long_stream == 0x0A))

    # calls of the dense host read-back, which the torch route no longer
    # makes
    p2e_calls = [0]
    real_p2e = kernels.planes_to_events

    def p2e_counted(*args, **kw):
        p2e_calls[0] += 1
        return real_p2e(*args, **kw)

    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = os.path.join(tmp, "corpus.txt")
        corpus.tofile(path)
        rec = os.path.join(tmp, "records.txt")
        records.tofile(rec)
        p100 = os.path.join(tmp, "pats100.txt")
        p400 = os.path.join(tmp, "pats400.txt")
        p400w = os.path.join(tmp, "pats400w.txt")
        for f, ws in ((p100, pats[:100]), (p400, pats),
                      (p400w, wide_patterns(pats))):
            with open(f, "wb") as fh:
                fh.write(b"".join(w + b"\n" for w in ws))
        runs = ([(name, api.fileagrep, argv + [path], None, "mask_scan")
                 for name, argv in CONFIGS + [CONFIG2C]]
                + [(name, api.fileagrep, argv + [path], None, "renfa_lanes")
                   for name, argv in REGEX_CONFIGS])
        # memory mode of the bitap engine is a per-byte host loop
        # (bitap.c:309-446 emulation); the sgrep engine scans on the card,
        # and so does the regex engine, its virtual leading line included
        runs.append(("memagrep", api.memagrep, CONFIGS[0][1], mem_data,
                     "mask_scan"))
        runs.append(("memagrep4", api.memagrep, REGEX_CONFIGS[0][1],
                     mem_data, "renfa_lanes"))
        # BASELINE config 5 on its records corpus: 100 and 400 patterns
        # take the chain kernel (the pure -c counts its starts by line on
        # the card), 400 with 154 byte classes (past its caps) the q-gram
        # kernel, a boolean of two terms the chain kernel too, and a
        # boolean with a term past the chain caps the mask machine's
        # packed term words
        c5 = ["-f", p100] + CONFIG5_DELIM
        runs += [
            ("config5", api.fileagrep, c5 + [rec], None, "chain_scan"),
            ("config5c", api.fileagrep, ["-c", "-f", p100, rec], None,
             "chain_scan"),
            ("config5c400", api.fileagrep, ["-c", "-f", p400, rec], None,
             "chain_scan"),
            ("config5q", api.fileagrep, ["-c", "-f", p400w, rec], None,
             "qgram_filter"),
            # the lines themselves (agrep refuses -n with -f)
            ("config5qn", api.fileagrep, ["-f", p400w, rec], None,
             "qgram_filter"),
            # the lines of both 400-pattern sets, printed in chunks
            ("config5s", api.fileagrep, ["-f", p400, rec], None,
             "chain_scan"),
            ("config5qs", api.fileagrep, ["-f", p400w, rec], None,
             "qgram_filter"),
            ("memagrep5", api.memagrep, c5, mem_records, "chain_scan"),
            ("bool5", api.fileagrep, CONFIG5_DELIM + ["hello;lazy", rec],
             None, "chain_scan"),
            ("bool5m", api.fileagrep,
             CONFIG5_DELIM + ["hello;matching," + WIDE_TERM, rec], None,
             "mask_scan"),
        ]
        # the streamed booleans, on the line corpus
        runs += [(name, api.fileagrep, argv + [path], None,
                  STREAMED_RUNS[name][0]) for name, argv in BOOL_STREAM_RUNS]
        # the bitap engine's memory mode with errors and its cost wiring
        # (records from mask_scan's planes through record_verdicts), and
        # the sticky machines ('#', -p: line_index, bitap_lanes and
        # line_rows) over a STICKY_MB file and buffer
        path16 = os.path.join(tmp, "corpus%d.txt" % STICKY_MB)
        corpus[:STICKY_MB << 20].tofile(path16)
        runs += [
            ("memagrep2", api.memagrep, CONFIGS[1][1], mem_data, "mask_scan"),
            ("memagrep3", api.memagrep, CONFIGS[2][1], mem_data, "mask_scan"),
            ("wild", api.fileagrep, ["-n", "appr#mate", path16], None,
             "bitap_lanes"),
            ("wildp", api.fileagrep, ["-p", "-c", "aproximat", path16], None,
             "bitap_lanes"),
            ("memwild", api.memagrep, ["-n", "appr#mate"], mem16,
             "bitap_lanes"),
        ]
        # records past LANES_LONG: the segment maps
        path_long = os.path.join(tmp, "long%d.txt" % STICKY_MB)
        long_data.tofile(path_long)
        runs.append(("wildl", api.fileagrep,
                     ["-p", "-n", "aproximat", path_long], None,
                     "bitap_lane_maps"))
        path_whole = os.path.join(tmp, "corpus%d.txt" % BOOL_WHOLE_MB)
        corpus[:BOOL_WHOLE_MB << 20].tofile(path_whole)
        ident = np.arange(256, dtype=np.uint8)
        if (chain_kernel.compile_chain(pats[:100], ident) is None
                or chain_kernel.compile_chain(pats, ident) is None
                or chain_kernel.compile_chain(wide_patterns(pats), ident)
                is not None):
            raise AssertionError("config 5's 100 and 400 patterns must "
                                 "compile to a chain program and the 400 "
                                 "wide ones must not")

        # the main path, on the card: counts start at 0 here
        scan_ops.set_backend("torch")
        _zero(counts)
        for kname, (mod, fn) in real.items():
            setattr(mod, kname, recorder(kname, fn))
        for name, fn in real_reads.items():
            setattr(chain_kernel, name, read_counter(name, fn))
        native.qgram_first_per_anchor_at = at_counted
        kernels.planes_to_events = p2e_counted
        engine.BitapEngine._memory_search_loop = loop_counted
        scan_ops.scan_lanes = lanes_counted
        mgrep._find_occurrences = find_counted
        regex_engine.np = host_index
        trace_was = trace.ENABLED
        trace.ENABLED = True
        got, inputs = {}, {}
        try:
            for name, fn, argv, data, kname in runs:
                before = {k: c[k] for k, c in counts.items()}
                again = kernels.relaunches["record_verdicts"]
                reads_before = dict(reads)
                at_before = at_calls[0]
                p2e_before = p2e_calls[0]
                finds_before = finds[0]
                host_before = dict(host_calls)
                for k in ("qgram_candidates", "record_rows",
                          "record_pairs", "regex_lines", "regex_rows",
                          "stream_print_chunks", "bool_stream_chunks",
                          "line_terms", "line_terms_rows", "lane_records",
                          "lane_rows"):
                    trace.counters.pop(k, None)
                host_index.calls.clear()
                seen.clear()
                rv_calls.clear()
                t0 = time.perf_counter()
                with stream_mb(name):
                    got[name] = _run(fn, argv, data)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                n = {k: c[k] - before[k] for k, c in counts.items()}
                if n[kname] == 0:
                    raise AssertionError("%s: the main path launched no %s "
                                         "kernel" % (name, kname))
                p2e_n = p2e_calls[0] - p2e_before
                if p2e_n:
                    raise AssertionError("%s: the torch route called the "
                                         "host's planes_to_events %d times"
                                         % (name, p2e_n))
                if name in PAIRS_RUNS and n["event_pairs"] == 0:
                    raise AssertionError("%s: the main path read its events "
                                         "back without event_pairs" % name)
                records = "-d" in argv
                qcand = trace.counters.get("qgram_candidates", 0)
                if records and qcand:
                    raise AssertionError(
                        "%s: a -d run reached qgram_occurrences (%d "
                        "candidates)" % (name, qcand))
                at_n = at_calls[0] - at_before
                if name == "config5" and not at_n:
                    raise AssertionError("config5: the -d flat-OR path did "
                                         "not walk the card's anchors")
                r = {k: reads[k] - reads_before[k] for k in reads}
                if name in QLINE_RUNS and (
                        n["chain_scan"] or n["qgram_lines"] != 1
                        or r["plane_positions"]):
                    raise AssertionError(
                        "%s: past the caps the run launched chain_scan %d "
                        "times and qgram_lines %d times, and read %s back, "
                        "not one qgram_lines launch and no positions"
                        % (name, n["chain_scan"], n["qgram_lines"], r))
                finds_n = finds[0] - finds_before
                if name in STREAMED_RUNS:
                    stream_check(name, n, r, finds_n, trace.counters,
                                 os.path.getsize(rec),
                                 scan_ops.STREAM_CHUNK)
                if name.startswith("config5c") and (
                        r["lines_with_starts"] != n["chain_scan"]
                        or r["plane_positions"]):
                    raise AssertionError(
                        "%s: the pure count read %s back for %d chain "
                        "launches, not one line count a launch"
                        % (name, r, n["chain_scan"]))
                inputs[name] = dict(seen)
                res[name] = {"wall_s": wall, "launches": n[kname],
                             "pairs_launches": n["event_pairs"],
                             "qlines_launches": n["qgram_lines"],
                             "kernel": kname, "reads": r,
                             "records": records, "qgram_candidates": qcand,
                             "anchor_passes": at_n, "finds": finds_n,
                             "chunks": trace.counters.get(
                                 "stream_print_chunks", 0),
                             "filter_launches": n["qgram_filter"],
                             "terms_launches": n["line_terms"],
                             "bool_chunks": trace.counters.get(
                                 "bool_stream_chunks", 0),
                             "terms_rows": trace.counters.get(
                                 "line_terms_rows", 0)}
                host_n = {k: host_calls[k] - host_before[k]
                          for k in host_calls}
                if name in RECORD_RUNS + MEMORY_RECORD_RUNS:
                    res[name]["cut"] = records_cut(
                        name, n, kernels.relaunches["record_verdicts"]
                        - again, rv_calls, trace.counters)
                    inputs[name]["record_verdicts"] = rv_calls[0]
                if name in MEMORY_RECORD_RUNS and (
                        n["mask_scan"] != 1 or n["record_verdicts"] != 1
                        or host_n["loop"]):
                    raise AssertionError(
                        "%s: memory mode launched mask_scan %d and "
                        "record_verdicts %d times for one buffer, and ran "
                        "the per-byte loop %d times" % (
                            name, n["mask_scan"], n["record_verdicts"],
                            host_n["loop"]))
                if name in STICKY_RUNS + LONG_STICKY_RUNS:
                    res[name]["lanes_cut"] = lanes_cut(
                        name, n, trace.counters,
                        None if "-c" in argv else got[name][3],
                        host_n["loop"], host_n["lanes"],
                        want_records[name])
                rv_calls.clear()
                if name in LINE_RUNS:
                    res[name]["lines_cut"] = lines_cut(
                        name, n, 0 if "-c" in argv else got[name][3],
                        trace.counters, *want_lines[name],
                        host_index.calls)
                elif host_index.calls:
                    raise AssertionError("%s: host index calls %s"
                                         % (name, host_index.calls[:5]))
        finally:
            for kname, (mod, fn) in real.items():
                setattr(mod, kname, fn)
            for name, fn in real_reads.items():
                setattr(chain_kernel, name, fn)
            native.qgram_first_per_anchor_at = real_at
            kernels.planes_to_events = real_p2e
            engine.BitapEngine._memory_search_loop = real_loop
            scan_ops.scan_lanes = real_lanes
            mgrep._find_occurrences = real_find
            regex_engine.np = real_np
            trace.ENABLED = trace_was
        main_launches = {k: c[k] for k, c in counts.items()}

        # the same runs on the port's exact host backend (native C passes)
        scan_ops.set_backend("numpy")
        try:
            for name, fn, argv, data, _k in runs:
                t0 = time.perf_counter()
                with stream_mb(name):
                    want = _run(fn, argv, data)
                res[name]["host_wall_s"] = time.perf_counter() - t0
                if got[name][:2] != want[:2]:
                    raise AssertionError(
                        "%s: stdout sha256/rc %s on the GPU, %s on the "
                        "numpy backend" % (name, got[name][:2], want[:2]))
            # config4n streams on both backends: its bytes read whole
            # too, on the numpy backend
            name, fn, argv, data, _k = next(r for r in runs
                                            if r[0] == "config4n")
            t0 = time.perf_counter()
            with stream_mb("config4n whole"):
                whole4n = _run(fn, argv, data)
            res[name]["whole_host_wall_s"] = time.perf_counter() - t0
            # the streamed booleans' bytes read whole on the numpy
            # backend: the count over the corpus, the prints over its
            # first BOOL_WHOLE_MB MB (streamed on the card there too)
            bool_whole = {}
            for name, argv in BOOL_STREAM_RUNS:
                f = path if "-c" in argv else path_whole
                scan_ops.set_backend("numpy")
                t0 = time.perf_counter()
                with stream_threshold("128"):
                    want = _run(api.fileagrep, argv + [f])
                res[name]["whole_host_wall_s"] = time.perf_counter() - t0
                if f == path:
                    got_s = got[name]
                else:
                    scan_ops.set_backend("torch")
                    with stream_threshold("8"):
                        got_s = _run(api.fileagrep, argv + [f])
                bool_whole[name] = (os.path.getsize(f) >> 20, got_s)
                if got_s[:2] != want[:2]:
                    raise AssertionError(
                        "%s: stdout sha256/rc %s streamed in chunks on the "
                        "card, %s read whole on the numpy backend (%s)"
                        % (name, got_s[:2], want[:2],
                           os.path.basename(f)))
        finally:
            scan_ops.set_backend("torch")
    if got["config5qs"][:2] != got["config5qn"][:2]:
        raise AssertionError(
            "config5qs: stdout sha256/rc %s streamed in chunks, %s printed "
            "whole (config5qn)" % (got["config5qs"][:2],
                                   got["config5qn"][:2]))
    if got["config4n"][:2] != whole4n[:2]:
        raise AssertionError(
            "config4n: stdout sha256/rc %s streamed in chunks, %s read "
            "whole on the numpy backend" % (got["config4n"][:2],
                                            whole4n[:2]))
    # the memory runs at LOOP_MB on the card against the per-byte loop,
    # which the numpy backend's walk does not give
    for name, fn, argv, data, _k in runs:
        if name not in MEMORY_RECORD_RUNS + ("memwild",):
            continue
        part = data[:LOOP_MB << 20]
        got1 = _run(fn, argv, part)
        real_ms = engine.BitapEngine._memory_search
        engine.BitapEngine._memory_search = real_loop
        try:
            t0 = time.perf_counter()
            want1 = _run(fn, argv, part)
            loop_s = time.perf_counter() - t0
        finally:
            engine.BitapEngine._memory_search = real_ms
        if got1[:2] != want1[:2] or not got1[3]:
            raise AssertionError(
                "%s: stdout sha256/rc %s over %d MB on the card, %s by the "
                "per-byte loop (%d lines)" % (name, got1[:2], LOOP_MB,
                                             want1[:2], got1[3]))
        res[name]["loop"] = {"sha": got1[0], "lines": got1[3],
                             "loop_s": loop_s}

    # the mask kernel alone at the main path's chunk shape, and at the
    # memagrep buffer's
    chunk = corpus[:scan_ops.STREAM_CHUNK]
    text = kernels.to_device(chunk, device)
    mem_text = kernels.to_device(np.frombuffer(mem_data, np.uint8), device)
    for name, argv in CONFIGS + [CONFIG2C, ("memagrep", CONFIGS[0][1]),
                                 ("memagrep2", CONFIGS[1][1]),
                                 ("memagrep3", CONFIGS[2][1])]:
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
        t = mem_text if name.startswith("memagrep") else text
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
                                                          L, device),
                         pairs=pairs_alone(name, planes, pairs_vals(m, device),
                                           W, L, t.numel(), 0))

    # the regex stages alone at config 4's first chunk (the main path's
    # first window, with the glitch byte inserted at 49,152 as the engine
    # inserts it) and at the memagrep buffer: line_index cuts and orders
    # the lines, the lanes kernel walks them in that order, line_rows
    # reads back the lines that fire (as config4n's print takes them;
    # memory mode keeps ordinals from 1: 0 is the leading line)
    opts, pattern, _ = parse_args(REGEX_CONFIGS[0][1] + ["x"])
    mc = compile_query(pattern, opts).re_mc
    m = renfa_kernel.machine_from_mc(mc, device)
    cont, _ = renfa.step_newline(list(mc["inits"]), int(mc["mask"][0x0A]),
                                 mc)
    for buf, glitch, first, names in (
            (np.insert(chunk, 49152, 0), 49152, 0, ("config4", "config4n")),
            (np.frombuffer(mem_data, np.uint8), -1, 1, ("memagrep4",))):
        seg = kernels.to_device(buf, device)
        index = index_alone(names[0], seg)
        idx = index.pop("idx")
        st_d, ln_d = idx.starts, idx.lens
        lens = ln_d.cpu().numpy()
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
        rows = rows_alone(names[0], verdicts, idx, False, first,
                          idx.nl.numel(), glitch)
        for n in names:
            res[n].update(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                          bound_by=by, shape_b=seg.numel(),
                          max_abs_err=diff, lines=len(lens),
                          true=int(verdicts.sum().item()), geometry=geo,
                          index=index, rows=rows)
        del seg, idx, verdicts

    # the config 5 runs' kernels alone, on the inputs the main path gave
    # their wrappers (each run's last call), against their plain versions
    plain_fns = {"chain_scan": chain_kernel.chain_scan_reference,
                 "qgram_filter": qgram_kernel.qgram_reference,
                 "mask_scan": kernels.mask_scan_reference}
    launch_fns = {"chain_scan": chain_kernel._launch,
                  "qgram_filter": qgram_kernel._launch,
                  "mask_scan": kernels._launch}
    first5 = [r[0] for r in runs].index("config5")
    for name, _fn, _argv, _data, kname in runs[first5:]:
        if name in MEMORY_RECORD_RUNS + STICKY_RUNS + LONG_STICKY_RUNS:
            continue                 # timed with configs 1-3 and below
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
        if name == "bool5m":
            res[name]["pairs"] = pairs_alone(
                name, *inputs[name]["event_pairs"])
        if name in QLINE_SHAPES:
            res[name]["qlines"] = qlines_alone(
                name, *inputs[name]["qgram_lines"][:3], name == "config5q")
        if name in STREAMED_RUNS and "line_terms" in STREAMED_RUNS[name]:
            res[name]["terms"] = terms_alone(name,
                                             *inputs[name]["line_terms"])

    # bitap_lanes alone on the inputs each sticky run gave it (the plain
    # version, a Python step a column, is not timed at wildl's 256 KiB
    # records: phase 3 holds the segment maps to it)
    for name in STICKY_RUNS + LONG_STICKY_RUNS:
        res[name].update(lanes_alone(name, inputs[name]["bitap_lanes"],
                                     device, name in STICKY_RUNS))

    # the record cut alone at the first chunk's planes of each record run
    for name in RECORD_RUNS:
        res[name]["verdicts"] = records_alone(
            name, *inputs[name]["record_verdicts"])
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = os.path.join(tmp, "corpus.txt")
        corpus[:CONFIG2V_MB << 20].tofile(path)
        res["config2v"] = records_relaunch(path)

    for name, fn, argv, data, kname in runs:
        r = res[name]
        src = ("records " if name.endswith(("5", "5c", "5c400", "5q", "5qn",
                                            "5s", "5qs", "5m"))
               else "")
        size = STICKY_MB if name in STICKY_RUNS + LONG_STICKY_RUNS else mb
        where = ("%d MB %sbuffer" % (size, src) if data is not None
                 else "%d MB %sfile" % (size, src))
        plain = ("equal to plain), plain %.1f ms" % r["plain_ms"]
                 if r["plain_ms"] is not None else
                 "held to plain in phase 3), plain not timed")
        print("main: %-9s %-38s %s rc=%d out=%d B sha256=%s.. GPU route "
              "wall=%.3f s (%.3f GB/s), numpy backend wall=%.3f s | %s "
              "launches=%d | kernel %.4f ms per %d B launch (%.1f GB/s, "
              "%s, bound %.4f ms (%s) | card: %s"
              % (name, " ".join(argv[:len(argv) - (data is None)]).replace(
                  WIDE_TERM, "hello<136 classes>"), where,
                 got[name][1], got[name][2], got[name][0][:12],
                 r["wall_s"], (size << 20) / r["wall_s"] / 1e9,
                 r["host_wall_s"], kname, r["launches"], r["ms"],
                 r["shape_b"], r["shape_b"] / r["ms"] / 1e6,
                 plain, r["bound_ms"], r["bound_by"], card))
    for name in ("config5", "config5c400", "config5q", "bool5", "bool5m"):
        r = res[name]
        print("main: the %s kernel's %d B launch of %s sets %d bits"
              % (r["kernel"], r["shape_b"], name, r["set_bits"]))
    for name in ("config5c", "config5c400"):
        print("main: %s counted its lines on the card: %s" % (
            name, res[name]["reads"]))
    for name in QLINE_RUNS:
        r = res[name]
        print("main: %s verified its candidates on the card through "
              "qgram_lines (%d launch): %d %s back, no candidate positions "
              "read (%s)" % (name, r["qlines_launches"], r["qlines"]["K"],
                             "lines counted, the count" if
                             r["qlines"]["count_only"] else "rows read",
                             r["reads"]))
    for name, kinds in STREAMED_RUNS.items():
        if "line_terms" in kinds:
            continue
        r = res[name]
        print("main: %s printed its lines in %d chunks of %d B through %s "
              "(%s launches), %d host finds, %d reads of start positions"
              "%s; GPU route wall %.3f s, numpy backend wall %.3f s"
              % (name, r["chunks"], scan_ops.STREAM_CHUNK,
                 " and ".join(kinds), "/".join(
                     str(r["filter_launches"] if k == "qgram_filter"
                         else r["qlines_launches"] if k == "qgram_lines"
                         else r["launches"]) for k in kinds),
                 r["finds"], r["reads"]["plane_positions"],
                 ", stdout equal to config5qn's whole-file bytes"
                 if name == "config5qs" else "", r["wall_s"],
                 r["host_wall_s"]))
    for name, argv in BOOL_STREAM_RUNS:
        r = res[name]
        whole_mb, whole = bool_whole[name]
        print("main: %s %s streamed its %d B chunks (%d) through %s (%d/%d "
              "launches), %d host finds, %d reads of start positions, %d "
              "rows read back; GPU route wall %.3f s, numpy backend wall "
              "%.3f s; equal to the numpy backend's whole-file bytes over "
              "%d MB (sha256=%s.., numpy whole-file wall %.3f s)"
              % (name, " ".join(argv).replace(WIDE_TERM, "hello<136 classes>"),
                 scan_ops.STREAM_CHUNK, r["bool_chunks"],
                 " and ".join(STREAMED_RUNS[name]), r["filter_launches"]
                 if STREAMED_RUNS[name][0] == "qgram_filter"
                 else r["launches"], r["terms_launches"], r["finds"],
                 r["reads"]["plane_positions"], r["terms_rows"],
                 r["wall_s"], r["host_wall_s"],
                 whole_mb, whole[0][:12],
                 r["whole_host_wall_s"]))
    print("main: config4n streamed in chunks printed the bytes it prints "
          "read whole on the numpy backend (sha256=%s.., wall %.3f s)"
          % (got["config4n"][0][:12], res["config4n"]["whole_host_wall_s"]))
    for name, _fn, _argv, _data, kname in runs:
        r = res[name]
        if r["records"]:
            print("main: -d run %s: %s launches %d, passes over the card's "
                  "anchors %d, qgram_candidates %d; GPU route wall %.3f s, "
                  "numpy backend wall %.3f s"
                  % (name, kname, r["launches"], r["anchor_passes"],
                     r["qgram_candidates"], r["wall_s"], r["host_wall_s"]))
    for name in PAIRS_RUNS:
        r = res[name]
        print("main: %s read its events back through event_pairs (%d "
              "launches), planes_to_events called 0 times" % (
                  name, r["pairs_launches"]))
    for name in RECORD_RUNS:
        c = res[name]["cut"]
        print("main: %s cut its records from the planes through "
              "record_verdicts (%d launches, no event_pairs, no second "
              "launch): %d rows read back of %d events, the records that "
              "fire (record_verdicts_reference on the same planes: %d)"
              % (name, c["launches"], c["rows"], c["pairs"], c["fire"]))
    v = res["config2v"]
    print("main: config2v %s over %d MB in %d B chunks: record_verdicts %d "
          "launches, %d second launches past the rows' capacity, %d rows; "
          "GPU route wall %.3f s, stdout equal to the numpy backend"
          % (" ".join(CONFIG2V[1]), CONFIG2V_MB, CONFIG2V_CHUNK,
             v["launches"], v["relaunches"], v["rows"], v["wall_s"]))
    for name in MEMORY_RECORD_RUNS:
        r, c = res[name], res[name]["cut"]
        print("main: %s (memory mode) cut its records from mask_scan's "
              "planes through record_verdicts (%d launch a buffer, no "
              "per-byte loop): %d rows read back of %d events, the records "
              "that fire; at %d MB equal to the per-byte loop (%d lines, "
              "sha256=%s.., the loop's wall %.3f s); GPU route wall %.3f s, "
              "numpy backend wall %.3f s | card: %s"
              % (name, c["launches"], c["rows"], c["pairs"], LOOP_MB,
                 r["loop"]["lines"], r["loop"]["sha"][:12],
                 r["loop"]["loop_s"], r["wall_s"], r["host_wall_s"], card))
    for name in STICKY_RUNS:
        r, c = res[name], res[name]["lanes_cut"]
        print("main: %s cut its %d records on the card through line_index, "
              "bitap_lanes and line_rows (one launch each), %d rows read "
              "back, no host lane, no per-byte loop; bitap_lanes %.4f ms per "
              "%d B launch (%d lanes, the longest %d B, %d fire), bound "
              "%.4f ms (%s), plain %.1f ms%s; GPU route wall %.3f s, numpy "
              "backend wall %.3f s | card: %s"
              % (name, c["records"], c["rows"], r["ms"], r["shape_b"],
                 r["lanes"], r["longest"], r["true"], r["bound_ms"],
                 r["bound_by"], r["plain_ms"],
                 "; at %d MB equal to the per-byte loop (%d lines, the "
                 "loop's wall %.3f s)" % (LOOP_MB, r["loop"]["lines"],
                                           r["loop"]["loop_s"])
                 if "loop" in r else "", r["wall_s"], r["host_wall_s"],
                 card))
    for name in LONG_STICKY_RUNS:
        r, c, g = res[name], res[name]["lanes_cut"], res[name]["geometry"]
        print("main: %s cut its %d records (%d B each) on the card through "
              "line_index, bitap_lanes (one call: %d bitap_lane_maps launch, "
              "%d chunks) and line_rows, %d rows read back, no host lane; "
              "both kernels %.4f ms per %d B call (%d lanes, the longest %d "
              "B, %d fire), bound %.4f ms (%s), n %d columns: n x bound "
              "%.4f ms; seg %d B, %d segments a block; GPU route wall %.3f "
              "s, numpy backend wall %.3f s | card: %s"
              % (name, c["records"], LONG_RECORD, c["maps_launches"],
                 r["chunks"], c["rows"], r["ms"], r["shape_b"], r["lanes"],
                 r["longest"], r["true"], r["bound_ms"], r["bound_by"],
                 g["n"], g["n"] * r["bound_ms"], g["seg"], g["groups"],
                 r["wall_s"], r["host_wall_s"], card))
    for name in ("config4", "memagrep4"):
        r = res[name]
        print("main: the lanes kernel's %d B launch of %s holds %d lines, "
              "%d true verdicts" % (r["shape_b"], name, r["lines"],
                                    r["true"]))
    for name in LINE_RUNS:
        c = res[name]["lines_cut"]
        print("main: %s indexed its %d lines on the card through "
              "line_index and read %d rows back through line_rows (one "
              "launch each a chunk, %d chunks); no newline index or length "
              "sort on the host" % (name, c["lines"], c["rows"],
                                    c["chunks"]))
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
    ("config5q", ["-c", "-f", "{p400w}"], "records", "qgram_filter"),
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
    from agrep_tpu_torch.ops import scan as scan_ops
    return {"mask_scan": kernels.launches,
            "event_pairs": kernels.launches,
            "record_verdicts": kernels.launches,
            "renfa_lanes": renfa_kernel.launches,
            "line_index": renfa_kernel.launches,
            "line_rows": renfa_kernel.launches,
            "chain_scan": chain_kernel.launches,
            "qgram_filter": qgram_kernel.launches,
            "qgram_lines": qgram_kernel.launches,
            "line_terms": chain_kernel.launches,
            "bitap_lanes": scan_ops.launches,
            "bitap_lane_maps": scan_ops.launches}


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
        for k, ws in (("p100", pats[:100]), ("p400w", wide_patterns(pats))):
            fmt[k] = os.path.join(tmp, "pats%s.txt" % k[1:])
            with open(fmt[k], "wb") as fh:
                fh.write(b"".join(w + b"\n" for w in ws))
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
                                                 p400w="pats400w"),
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

# ---------------------------------------------------------------------
# phase 7: the port's bench, small
# ---------------------------------------------------------------------

BENCH_ARGV = ["--mb", "32", "--gate-mb", "8", "--para-mb", "16"]


def phase_bench(card: str) -> None:
    """agrep_tpu_torch.bench.main at BENCH_ARGV, in this process: its
    conformance gate must pass and it must launch every kernel."""
    import contextlib

    from agrep_tpu_torch import bench
    counts = _launch_counts()
    _zero(counts)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(BENCH_ARGV)
    dt = time.perf_counter() - t0
    line = buf.getvalue().strip().splitlines()[-1]
    print("bench: %s" % line)
    res = json.loads(line)
    launched = _launched(counts)
    print("bench: %s in %.1f s, rc=%d, launches %s | card: %s"
          % (" ".join(BENCH_ARGV), dt, rc, launched, card))
    if rc != 0 or res["conformance"] != "pass":
        raise AssertionError("bench: conformance %r, rc %d"
                             % (res["conformance"], rc))
    # the bench streams no boolean and runs no sticky machine: line_terms
    # and bitap_lanes (both of its kernels) are not on its path
    idle = [k for k, n in launched.items()
            if n == 0 and k not in ("line_terms", "bitap_lanes",
                                    "bitap_lane_maps")]
    if idle:
        raise AssertionError("bench: launched no %s kernel" % idle)


# ---------------------------------------------------------------------
# phase 8: the conformance sweep on the card
# ---------------------------------------------------------------------

# (mode, grown past the device route's 64 KiB, cases, first seed): the
# seed ranges of tests/test_torch_fuzz_sweep*.py, continued
SWEEP_RUNS = [
    ("uniform", False, 200, 13000),
    ("stratified", False, 200, 14000),
    ("regex", False, 100, 15000),
    ("uniform", True, 100, 16000),
    ("stratified", True, 60, 7000),
    ("regex", True, 60, 17000),
    ("boolean", True, 40, 18000),
    ("memory", False, 120, 19000),
]


def phase_sweep(card: str) -> None:
    """tools/torch_fuzz_sweep.py over SWEEP_RUNS on the card against the
    port's numpy backend: no divergence or crash, every kernel
    launched."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_fuzz_sweep", os.path.join(REPO, "tools",
                                         "torch_fuzz_sweep.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    counts = _launch_counts()
    _zero(counts)
    # the cases that launch qgram_lines: a -f set past the chain caps of
    # 24 or more terms, counted or printed whole
    real_case = tool.check_case
    qline_cases = [0]

    def case_counted(*a, **kw):
        before = counts["qgram_lines"]["qgram_lines"]
        try:
            return real_case(*a, **kw)
        finally:
            qline_cases[0] += counts["qgram_lines"]["qgram_lines"] > before
    tool.check_case = case_counted
    try:
        res = tool.sweep(SWEEP_RUNS, ref="numpy", device="cuda",
                         out=lambda line: print("sweep: %s" % line))
    finally:
        tool.check_case = real_case
    launched = _launched(counts)
    print("sweep: cases %s, divergences %d, crashes %d, over_limit %s, "
          "launches %s, cases that launch qgram_lines %d, %.1f s | card: %s"
          % (json.dumps(res["cases"]), res["divergences"], res["crashes"],
             json.dumps(res["over_limit"]), launched, qline_cases[0],
             res["seconds"], card))
    if res["divergences"] or res["crashes"]:
        raise AssertionError("sweep: %d divergences, %d crashes"
                             % (res["divergences"], res["crashes"]))
    # qgram_lines takes only the past-caps stratum's 30-term sets under a
    # count or a print, line_terms only a boolean streamed in chunks
    # (the streamed pass below), and bitap_lane_maps only a sticky record
    # past LANES_LONG: their counts are reported, not required
    idle = [k for k, n in launched.items()
            if n == 0 and k not in ("qgram_lines", "line_terms",
                                    "bitap_lane_maps")]
    if idle:
        raise AssertionError("sweep: launched no %s kernel" % idle)
    sweep_streamed(tool, card)


def sweep_streamed(tool, card: str) -> None:
    """SWEEP_RUNS' grown seeds again, each file searched on the card in
    64 KiB chunks and read whole on the numpy backend (the tool's
    --stream): the chunk carries of every engine against the whole-file
    walk.  Counts the cases that printed a -f search in chunks on the
    card."""
    from agrep_tpu_torch.runtime import mgrep
    engine = mgrep.MgrepEngine
    real = {k: getattr(engine, k) for k in ("_print_stream_chunked",
                                            "_bool_stream_chunked")}
    on_card = {k: False for k in real}
    streamed = {k: 0 for k in real}

    def seen(k):
        def call(self, data, sink):
            on_card[k] = on_card[k] or self._device_route(len(data))
            return real[k](self, data, sink)
        return call

    real_case = tool.check_case

    def case_seen(*a, **kw):
        for k in on_card:
            on_card[k] = False
        try:
            return real_case(*a, **kw)
        finally:
            for k in on_card:
                streamed[k] += on_card[k]
    for k in real:
        setattr(engine, k, seen(k))
    tool.check_case = case_seen
    try:
        res = tool.sweep([r for r in SWEEP_RUNS if r[1]], ref="numpy",
                         device="cuda", stream=True,
                         out=lambda line: print("sweep: streamed %s" % line))
    finally:
        tool.check_case = real_case
        for k, fn in real.items():
            setattr(engine, k, fn)
    print("sweep: streamed in %d B chunks on the card, read whole on the "
          "numpy backend: cases %s, divergences %d, crashes %d, over_limit "
          "%s, launches %s, cases that printed a -f search in chunks on "
          "the card %d, cases that streamed a boolean on the card %d "
          "(line_terms launches %d), %.1f s | card: %s"
          % (tool.STREAM_CHUNK, json.dumps(res["cases"]), res["divergences"],
             res["crashes"], json.dumps(res["over_limit"]),
             json.dumps(res["launches"]),
             streamed["_print_stream_chunked"],
             streamed["_bool_stream_chunked"],
             res["launches"].get("line_terms", 0), res["seconds"], card))
    if res["divergences"] or res["crashes"]:
        raise AssertionError("sweep, streamed: %d divergences, %d crashes"
                             % (res["divergences"], res["crashes"]))
    # the boolean stratum streams its booleans through line_terms
    if not res["launches"].get("line_terms", 0):
        raise AssertionError("sweep, streamed: no line_terms launch")


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


CHAIN_SHAPES = ("config5", "config5c", "config5c400", "memagrep5", "bool5",
                "config5s")


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


def event_pairs_line(res, card: str) -> str:
    """event_pairs at each of PAIRS_SHAPES: pairs, planes, grid, the
    kernel's device ms against its bound, the wrapper's ms with the
    host's read of K, the plain version's and the library composite's."""
    return "times: event_pairs %s | card: %s" % (" | ".join(
        "%s %d B %d planes %d pairs grid=%d: %.4f ms (%.1f %% of its %.4f "
        "ms bound, %s), wrapper %.4f ms, plain %.2f ms, library %.3f ms"
        % (n, p["shape_b"], p["planes"], p["K"], p["grid"], p["ms"],
           100 * p["bound_ms"] / p["ms"], p["bound_ms"], p["bound_by"],
           p["wrapper_ms"], p["plain_ms"], p["library_ms"])
        for n in PAIRS_SHAPES for p in [res[n]["pairs"]]), card)


def record_verdicts_line(res, card: str) -> str:
    """record_verdicts at each of RECORD_RUNS' first chunks: events, rows,
    grid, the launch's device ms against the bound, the wrapper's ms with
    the host's read of the summary, the plain version's and the library
    composite's."""
    return "times: record_verdicts %s | card: %s" % (" | ".join(
        "%s %d events %d rows grid=%d: %.4f ms (%.1f %% of its %.4f ms "
        "bound, %s), wrapper %.4f ms, plain %.2f ms, library %.3f ms"
        % (n, r["K"], r["R"], r["grid"], r["ms"],
           100 * r["bound_ms"] / r["ms"], r["bound_ms"], r["bound_by"],
           r["wrapper_ms"], r["plain_ms"], r["library_ms"])
        for n in RECORD_RUNS for r in [res[n]["verdicts"]]), card)


def line_stages_line(res, card: str) -> str:
    """line_index and line_rows at config 4's first chunk and the
    memagrep buffer: lines, rows, grids, the passes' device ms against
    the bound, the wrapper's ms with the host's read of K or the count,
    the plain version's and the library composite's."""
    out = []
    for stage, key, what in (("line_index", "index", "lines"),
                             ("line_rows", "rows", "rows")):
        out.append("times: %s %s | card: %s" % (stage, " | ".join(
            "%s %d B %d lines%s grids=%s: %.4f ms (%.1f %% of its %.4f ms "
            "bound, %s%s), wrapper %.4f ms%s, plain %.2f ms, library "
            "%.3f ms"
            % (n, res[n]["shape_b"], r["K"],
               " %d rows" % r["R"] if what == "rows" else "",
               list(r["grids"]), r["ms"], 100 * r["bound_ms"] / r["ms"],
               r["bound_ms"], r["bound_by"],
               "; passes " + split_text(r["split"]) if "split" in r else "",
               r["wrapper_ms"],
               "; count %.4f ms (%.1f %% of its %.4f ms bound), wrapper "
               "%.4f ms" % (r["count_ms"],
                            100 * r["count_bound_ms"] / r["count_ms"],
                            r["count_bound_ms"], r["count_wrapper_ms"])
               if "count_ms" in r else "",
               r["plain_ms"], r["library_ms"])
            for n in ("config4", "memagrep4") for r in [res[n][key]]),
            card))
    return "\n".join(out)


def split_text(split) -> str:
    """timing.pass_split's [(label, ms)] as "pass ms, ..."; a pass's
    ":before" (the time from the previous pass's end to its launch) in
    parentheses after it."""
    before = {lab[:-len(":before")]: ms for lab, ms in split
              if lab.endswith(":before")}
    return ", ".join("%s %.4f (%.4f)" % (lab, ms, before.get(lab, 0.0))
                     for lab, ms in split if not lab.endswith(":before"))


def qgram_lines_line(res, card: str) -> str:
    """qgram_lines at QLINE_SHAPES (the whole-file runs' 100 MB streams,
    config5qs's first chunk): rows, tiles, the passes' device ms against the bound and each pass's, the
    wrapper's ms with the host's read of the count, the plain version's
    and the library composite's."""
    return "times: qgram_lines %s | card: %s" % (" | ".join(
        "%s %d B %s %d tiles=%d: %.4f ms (%.1f %% of its %.4f ms "
        "bound, %s; passes %s), wrapper %.4f ms, plain %.2f ms, library "
        "%.3f ms"
        % (n, r["shape_b"], "count" if r["count_only"] else "rows", r["K"],
           r["tiles"], r["ms"], 100 * r["bound_ms"] / r["ms"],
           r["bound_ms"], r["bound_by"], split_text(r["split"]),
           r["wrapper_ms"], r["plain_ms"], r["library_ms"])
        for n in QLINE_SHAPES for r in [res[n]["qlines"]]), card)


def line_terms_line(res, card: str) -> str:
    """line_terms at the streamed booleans' first chunks: rows or count,
    the plane's set bits and shift, the grid, the launch's device ms
    against the bound, the wrapper's ms with the host's read, the plain
    version's and the library composite's."""
    return "times: line_terms %s | card: %s" % (" | ".join(
        "%s %d B %s %d, %d plane bits (shift %d), grid=%d: %.4f ms (%.1f %% "
        "of its %.4f ms bound, %s), wrapper %.4f ms, plain %.2f ms, "
        "library %.3f ms"
        % (n, r["shape_b"], "count" if r["count_only"] else "rows", r["K"],
           r["starts"], r["shift"], r["grid"], r["ms"],
           100 * r["bound_ms"] / r["ms"], r["bound_ms"], r["bound_by"],
           r["wrapper_ms"], r["plain_ms"], r["library_ms"])
        for n, _argv in BOOL_STREAM_RUNS for r in [res[n]["terms"]]), card)


def lanes_geometry_line(res) -> str:
    """bitap_lanes' launch at each sticky run, and the registers and
    spills ptxas reported for its kernels."""
    from agrep_tpu_torch.ops import _cuda
    log = _cuda.build_logs.get("bitap_lanes", "")
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    return ("geometry: bitap_lanes %s | %s | kernels' registers %s-%s, %d "
            "spill" % (
                " | ".join("%s: %d lanes, threads %d, blocks an SM %d, grid "
                           "%d, registers %d"
                           % (n, res[n]["lanes"], g["threads"],
                              g["blocks_per_sm"], g["grid"], g["regs"])
                           for n in STICKY_RUNS
                           for g in [res[n]["geometry"]]),
                " | ".join("%s: segment maps past LANES_LONG = %d: n %d, seg "
                           "%d B, %d segments a block, threads %d, shared "
                           "%d B, blocks an SM %d, grid %d, registers %d, "
                           "local %d B"
                           % (n, g["long"], g["n"], g["seg"], g["groups"],
                              g["maps_threads"], g["maps_smem"],
                              g["maps_blocks_per_sm"], g["maps_grid"],
                              g["maps_regs"], g["maps_local_bytes"])
                           for n in LONG_STICKY_RUNS
                           for g in [res[n]["geometry"]]),
                min(regs, default=0), max(regs, default=0),
                sum(1 for sp in spills if sp)))


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
    from agrep_tpu_torch.ops.timing import card_line
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
        "cuda", args.seed, 8 << 20, make_patterns(400, args.seed))
    err_pairs = phase_parity_pairs("cuda", args.seed)
    err_records = phase_parity_records("cuda", args.seed)
    err_index, err_rows = phase_parity_lines("cuda", args.seed)
    err_qlines = phase_parity_qgram_lines("cuda", args.seed,
                                          make_patterns(400, args.seed))
    err_terms = phase_parity_line_terms("cuda", args.seed)
    err_lanes = phase_parity_lanes("cuda", args.seed)
    res = phase_main("cuda", args.seed, args.mb, card)

    c1, c2, c4, c5, c5q = (res["config1"], res["config2"], res["config4"],
                           res["config5"], res["config5q"])
    c5qn = res["config5qn"]
    bools = res["bools"]["terms"]
    print(mask_scan_geometry_line(res))
    print(times_line(res, "mask_scan", MASK_SHAPES, card))
    print(chain_scan_geometry_line(res))
    print(times_line(res, "chain_scan", CHAIN_SHAPES, card))
    print(renfa_lanes_geometry_line(res))
    print(times_line(res, "renfa_lanes", ("config4", "memagrep4"), card))
    print(qgram_filter_geometry_line(res))
    print(times_line(res, "qgram_filter", ("config5q", "config5qs"), card))
    print(qgram_lines_line(res, card))
    print(line_terms_line(res, card))
    print(event_pairs_line(res, card))
    print(record_verdicts_line(res, card))
    print(line_stages_line(res, card))
    print(lanes_geometry_line(res))
    print(times_line(res, "bitap_lanes", STICKY_RUNS, card))
    corpus = make_corpus(args.mb << 20, args.seed)
    serial = serial_lanes(corpus, "cuda", card)
    maps = maps_alone("cuda", args.seed, card)
    t6 = time.perf_counter()
    phase_dist(corpus, card)
    phase_entries()
    phase_ranks(corpus, make_records(corpus, args.seed),
                make_patterns(400, args.seed), card)
    print("phase 6: %.1f s" % (time.perf_counter() - t6))
    phase_bench(card)
    phase_sweep(card)
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
        "max_abs_err": max([err_chain] + [res[n]["max_abs_err"]
                                          for n in CHAIN_SHAPES]),
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
        "max_abs_err": max(err_qgram, c5q["max_abs_err"],
                           res["config5qs"]["max_abs_err"]),
        "ms": c5q["ms"],
        "plain_ms": c5q["plain_ms"],
        "bound_ms": c5q["bound_ms"],
        "bound_by": c5q["bound_by"],
        # no single PyTorch call packs a gathered bit set into words; the
        # gather alone is the plain version's first step
        "library_ms": None,
    }, {
        "name": "event_pairs",
        "route": "cuda",
        "source": "agrep_tpu_torch/csrc/event_pairs.cu",
        # the host read-back it replaces (no Pallas kernel: a device stage
        # the port adds beside the TPU kernels)
        "replaces": "agrep_tpu/ops/kernels.py:521",
        "launches": res["launches"]["event_pairs"],
        "max_abs_err": max([err_pairs] + [res[n]["pairs"]["max_abs_err"]
                                          for n in PAIRS_SHAPES]),
        "ms": c1["pairs"]["ms"],
        "plain_ms": c1["pairs"]["plain_ms"],
        "bound_ms": c1["pairs"]["bound_ms"],
        "bound_by": c1["pairs"]["bound_by"],
        # no one PyTorch call compacts bit planes into pairs: the
        # composite pairs_library (unpack by shifts, torch.nonzero)
        "library_ms": c1["pairs"]["library_ms"],
    }, {
        "name": "record_verdicts",
        "route": "cuda",
        "source": "agrep_tpu_torch/csrc/record_verdicts.cu",
        # the host walk it replaces (no Pallas kernel: a device stage the
        # port adds beside the TPU kernels)
        "replaces": "agrep_tpu/runtime/engine.py:109",
        "launches": res["launches"]["record_verdicts"],
        "max_abs_err": max([err_records]
                           + [res[n]["verdicts"]["max_abs_err"]
                              for n in RECORD_RUNS]),
        "ms": c2["verdicts"]["ms"],
        "plain_ms": c2["verdicts"]["plain_ms"],
        "bound_ms": c2["verdicts"]["bound_ms"],
        "bound_by": c2["verdicts"]["bound_by"],
        # no one PyTorch call cuts records: the composite records_library
        # (pairs_library's events, torch.cumsum of the delimiter flags,
        # scatter_add of the hits)
        "library_ms": c2["verdicts"]["library_ms"],
    }, {
        "name": "line_index",
        "route": "cuda",
        "source": "agrep_tpu_torch/csrc/line_index.cu",
        # the host line index it replaces (no Pallas kernel: a device
        # stage the port adds beside the TPU kernels)
        "replaces": "agrep_tpu/runtime/regex_engine.py:116",
        "launches": res["launches"]["line_index"],
        "max_abs_err": max([err_index] + [res[n]["index"]["max_abs_err"]
                                          for n in ("config4",
                                                    "memagrep4")]),
        "ms": c4["index"]["ms"],
        "plain_ms": c4["index"]["plain_ms"],
        "bound_ms": c4["index"]["bound_ms"],
        "bound_by": c4["index"]["bound_by"],
        # no one PyTorch call indexes lines: the composite index_library
        # (torch.nonzero of the newlines, a stable torch.sort)
        "library_ms": c4["index"]["library_ms"],
    }, {
        "name": "line_rows",
        "route": "cuda",
        "source": "agrep_tpu_torch/csrc/line_rows.cu",
        # the host verdict walk it replaces (no Pallas kernel: a device
        # stage the port adds beside the TPU kernels)
        "replaces": "agrep_tpu/runtime/regex_engine.py:233",
        "launches": res["launches"]["line_rows"],
        "max_abs_err": max([err_rows] + [res[n]["rows"]["max_abs_err"]
                                         for n in ("config4",
                                                   "memagrep4")]),
        # the rows form (config4n's print); the count form (config 4's
        # -c, memagrep4) beside it
        "ms": c4["rows"]["ms"],
        "plain_ms": c4["rows"]["plain_ms"],
        "bound_ms": c4["rows"]["bound_ms"],
        "bound_by": c4["rows"]["bound_by"],
        # no one PyTorch call compacts flags into rows: the composite
        # rows_library (index_put_ of the flags, torch.nonzero, gathers)
        "library_ms": c4["rows"]["library_ms"],
        "wrapper_ms": c4["rows"]["wrapper_ms"],
        "count_ms": c4["rows"]["count_ms"],
        "count_bound_ms": c4["rows"]["count_bound_ms"],
        "count_wrapper_ms": c4["rows"]["count_wrapper_ms"],
    }, {
        "name": "qgram_lines",
        "route": "cuda",
        "source": "agrep_tpu_torch/csrc/qgram_lines.cu",
        # the host verify and line fold it replaces (no Pallas kernel: a
        # device stage the port adds beside the TPU kernels)
        "replaces": "agrep_tpu/runtime/mgrep.py:967",
        "launches": res["launches"]["qgram_lines"],
        "max_abs_err": max([err_qlines] + [res[n]["qlines"]["max_abs_err"]
                                           for n in QLINE_SHAPES]),
        "ms": c5qn["qlines"]["ms"],
        "plain_ms": c5qn["qlines"]["plain_ms"],
        "bound_ms": c5qn["qlines"]["bound_ms"],
        "bound_by": c5qn["qlines"]["bound_by"],
        # no one PyTorch call verifies and folds candidates by line: the
        # composite qlines_library (torch.nonzero, gathers, torch.cumsum)
        "library_ms": c5qn["qlines"]["library_ms"],
    }, {
        "name": "line_terms",
        "route": "cuda",
        "source": "agrep_tpu_torch/csrc/line_terms.cu",
        # the host's find a term and line fold it replaces (no Pallas
        # kernel: a device stage the port adds beside the TPU kernels)
        "replaces": "agrep_tpu/runtime/mgrep.py:336",
        "launches": res["launches"]["line_terms"],
        "max_abs_err": max([err_terms] + [res[n]["terms"]["max_abs_err"]
                                          for n, _a in BOOL_STREAM_RUNS]),
        # the rows form at bools' first chunk; the count form (boolsc)
        # beside it
        "ms": bools["ms"],
        "plain_ms": bools["plain_ms"],
        "bound_ms": bools["bound_ms"],
        "bound_by": bools["bound_by"],
        # no one PyTorch call verifies terms and folds them by line: the
        # composite terms_library (torch.nonzero, a padded term matrix's
        # compare, torch.searchsorted, index_put_)
        "library_ms": bools["library_ms"],
        "wrapper_ms": bools["wrapper_ms"],
        "count_ms": res["boolsc"]["terms"]["ms"],
        "count_bound_ms": res["boolsc"]["terms"]["bound_ms"],
    }, {
        "name": "bitap_lanes",
        "route": "cuda",
        "source": "agrep_tpu_torch/csrc/bitap_lanes.cu",
        # the host lane scan it replaces (no Pallas kernel: a numpy column
        # loop of agrep_tpu, fed by engine.py:721's per-record copies)
        "replaces": "agrep_tpu/ops/scan.py:337",
        "launches": res["launches"]["bitap_lanes"],
        "max_abs_err": max([err_lanes] + [res[n]["max_abs_err"]
                                          for n in STICKY_RUNS]),
        "ms": res["wild"]["ms"],
        "plain_ms": res["wild"]["plain_ms"],
        "bound_ms": res["wild"]["bound_ms"],
        "bound_by": res["wild"]["bound_by"],
        # no PyTorch call runs a shift-or machine
        "library_ms": None,
    }, {
        "name": "bitap_lane_maps",
        "route": "cuda",
        "source": "agrep_tpu_torch/csrc/bitap_lanes.cu",
        # the host lane scan it replaces for lanes past LANES_LONG (no
        # Pallas kernel: a numpy column loop of agrep_tpu)
        "replaces": "agrep_tpu/ops/scan.py:337",
        "launches": res["launches"]["bitap_lane_maps"],
        "max_abs_err": max(err_lanes, maps["max_abs_err"]),
        # one 1 MiB lane of -p aproximat (D 0), both kernels' launches
        "ms": maps["ms"],
        "plain_ms": maps["plain_ms"],
        "bound_ms": maps["bound_ms"],
        "bound_by": maps["bound_by"],
        # no PyTorch call runs a shift-or machine
        "library_ms": None,
        "n": maps["n"],
        "wildl_ms": res["wildl"]["ms"],
        "wildl_bound_ms": res["wildl"]["bound_ms"],
        # a STICKY_MB record with no delimiter, one a SERIAL_RUNS search
        "serial": [{"argv": " ".join(r["argv"]), "ms": r["ms"],
                    "bound_ms": r["bound_ms"], "n": r["geometry"]["n"],
                    "seg": r["geometry"]["seg"],
                    "launches": r["maps_launches"]} for r in serial],
    }]}
    print("kernels: times are per launch at the main path's %d B chunk "
          "of config2 (%s; record_verdicts: its launch over that chunk's "
          "planes, without the host's read of the summary; event_pairs: "
          "its launch over config1's chunk, without the host's read of K) "
          "and of config4 (%s; line_index and line_rows: every pass over "
          "its first window, without the host's read of K or the "
          "count; line_rows' count_ms: its count form), "
          "at config5's %d B "
          "stream (chain_scan) and config5q's %d B stream (qgram_filter; "
          "qgram_lines: every pass of config5qn's print over it, without "
          "the host's read of the count; line_terms: its launch over "
          "bools' first %d B chunk, without the host's read; bitap_lanes: "
          "its launch over wild's %d B stream; bitap_lane_maps: the call's "
          "launches over a 1 MiB lane, wildl_ms over wildl's stream, "
          "serial over one lane of %d B); launches are all main-path runs; "
          "card: %s"
          % (c2["shape_b"], " ".join(CONFIGS[1][1]),
             " ".join(REGEX_CONFIGS[0][1]), c5["shape_b"], c5q["shape_b"],
             bools["shape_b"], res["wild"]["shape_b"], serial[0]["longest"],
             card))
    print(json.dumps(line))
    print("total: %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
