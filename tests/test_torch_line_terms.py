"""line_terms, the streamed boolean's device stage, on the CPU.

  * compile/boolean.py truth_table against agrep_tpu's eval_tree_vec, for
    every terminal mask, over trees parsed by agrep_tpu's parser (flat
    ANDs and ORs, trees with ~, 16 terminals), and the port's parser
    giving the same table;
  * line_terms_reference against a numpy model of agrep_tpu's streamed
    fold (agrep_tpu/runtime/mgrep.py _bool_stream_chunked: a host find a
    term, each occurrence placed on its line, the tree over each line's
    hits, the any-hit gate, the tail line's occurrences carried to the
    next chunk), chunk by chunk, on seeded texts cut at random seams,
    with planes of the true starts (shift 0) or anchors (shift p - 1)
    plus junk bits that do not verify, -i, 1 to 16 terms, both forms;
  * a Python model of the kernel's cooperative launch
    (csrc/line_terms.cu: text words of 32 bytes, each warp a run of
    32-word steps, phase 1's summaries with only the starts after a
    word's last newline verified, each block's fold of its warps', block
    0's scan of the blocks' from the carried mask, each warp's prefix
    from its block's, phase 3's lane scan and fire masks over the starts
    before a word's last newline, a start's terms filtered by its first
    byte, the rows form's offsets by block and warp and its rows), at
    1-5 blocks of 1, 2 and the kernel's own warps, against the plain
    version;
  * the wrapper's and term_tables' refusals.

The kernel itself runs only on the card, where chip_smoke.py holds it to
the plain version.
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

from agrep_tpu.compile import boolean as j_boolean
from agrep_tpu.runtime import mgrep as j_mgrep
from agrep_tpu_torch.compile import boolean as t_boolean
from agrep_tpu_torch.ops import chain_kernel as t_chain

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "agrep_tpu_torch", "csrc", "line_terms.cu")

TREES = ["a;b", "a,b", "a;b;c;d", "{a,b};~c", "~a", "~{a;b},c",
         "{a;~b},{c;~d}", "~{~a,b};c",
         ";".join("t%02d" % i for i in range(16)),
         "{" + ",".join("t%02d" % i for i in range(15)) + "};~u"]


def _fold(nocase: bool) -> np.ndarray:
    tr = np.arange(256, dtype=np.uint8)
    if nocase:
        tr[65:91] += 32
    return tr


def _table(pattern: str):
    """(tree, op, terminals, agrep_tpu's verdict of each mask)."""
    split = j_boolean.split_pattern(pattern)
    NT = len(split.terminals)
    m = np.arange(1 << NT)
    hits = ((m[:, None] >> np.arange(NT)) & 1).astype(bool)
    if split.tree is None:
        ok = j_boolean.eval_tree_vec(None, split.op, hits)
    else:
        ok = j_boolean.eval_tree_vec(split.tree, "or", hits)
    return split, ok & (m != 0)


def _bits(words: np.ndarray, NT: int) -> np.ndarray:
    return np.unpackbits(words.astype("<u4").view(np.uint8),
                         bitorder="little")[:1 << NT].astype(bool)


@pytest.mark.parametrize("pattern", TREES)
def test_truth_table_matches_eval_tree(pattern):
    split, want = _table(pattern)
    NT = len(split.terminals)
    op = split.op if split.tree is None else "or"
    got = t_boolean.truth_table(split.tree, op, [True] * NT, NT)
    assert got.dtype == np.uint32 and got.shape == (max(1, (1 << NT) // 32),)
    assert np.array_equal(_bits(got, NT), want)
    port = t_boolean.split_pattern(pattern)
    assert port.terminals == split.terminals
    assert np.array_equal(t_boolean.truth_table(port.tree, op, [True] * NT,
                                                NT), got)


def test_truth_table_dead_terms_and_edges():
    # a flat AND over the live terms only; a mask never has a dead bit
    got = _bits(t_boolean.truth_table(None, "and", [True, False, True], 3), 3)
    assert got.tolist() == [False, False, False, False, False, True, False,
                            True]
    # the empty mask never fires, whatever the tree says of it
    split = j_boolean.split_pattern("~a;~b")
    assert not _bits(t_boolean.truth_table(split.tree, "or", [True] * 2,
                                           2), 2)[0]
    with pytest.raises(ValueError):
        t_boolean.truth_table(None, "and", [True] * 17, 17)


# ---------------------------------------------------------------------
# the plain version against agrep_tpu's fold
# ---------------------------------------------------------------------

def _text(rng, n: int, terms, nocase: bool) -> np.ndarray:
    words = [b"the", b"quick", b"brown", b"jumps", b"a", b""] + [
        t for t in terms if t] * 3
    out = bytearray()
    while len(out) < n:
        k = int(rng.integers(0, 7))
        line = b" ".join(words[i] for i in rng.integers(0, len(words), k))
        if rng.random() < 0.04:
            # every term once: a line that a wide AND needs
            line = b" ".join(t for t in rng.permutation(
                np.asarray([t for t in terms if t], dtype=object)))
        if nocase and rng.random() < 0.3:
            line = line.upper()
        out += line + b"\n"
    return np.frombuffer(bytes(out[:n]), dtype=np.uint8).copy()


def _np_fold(data: np.ndarray, seams, terms, tr, verdict, no_rescan):
    """agrep_tpu's _bool_stream_chunked fold over chunks [seams[i],
    seams[i+1]) of data, its host find and all: the (begin, end) rows of
    each chunk."""
    n = len(data)
    maxlen = max(len(t) for t in terms if t)
    NT = len(terms)
    live = [i for i, t in enumerate(terms) if t]
    last_nl = -1
    pend_p = np.empty(0, dtype=np.int64)
    pend_t = np.empty(0, dtype=np.int64)
    out = []
    for g0, g1 in zip(seams[:-1], seams[1:]):
        region = np.ascontiguousarray(data[g0:min(g1 + maxlen - 1, n)])
        pp, tt = [pend_p], [pend_t]
        for tid in live:
            st = j_mgrep._find_occurrences(region, terms[tid], tr)
            st = st[st + g0 < g1]
            pp.append(st + g0)
            tt.append(np.full(len(st), tid, dtype=np.int64))
        allp, allt = np.concatenate(pp), np.concatenate(tt)
        nl = np.flatnonzero(region[:g1 - g0] == 0x0A) + g0
        pend_p = pend_t = np.empty(0, dtype=np.int64)
        n_lines = len(nl) + (g1 >= n)
        jdx = np.searchsorted(nl, allp, side="left")
        if g1 < n:
            un = jdx >= len(nl)
            pend_p, pend_t = allp[un], allt[un]
            allp, allt, jdx = allp[~un], allt[~un], jdx[~un]
        hits = np.zeros((n_lines, NT), dtype=bool)
        hits[jdx, allt] = True
        ok = verdict(hits)
        any_hit = np.zeros(n_lines, dtype=bool)
        any_hit[jdx] = True
        sel = np.flatnonzero(ok & any_hit)
        cap_e = n - 1 if no_rescan else n
        rows = [(int(nl[j - 1]) + 1 if j > 0 else last_nl + 1,
                 int(nl[j]) + 1 if j < len(nl) else cap_e) for j in sel]
        out.append(rows)
        if len(nl):
            last_nl = int(nl[-1])
    return out


def _plane(n: int, pos, rng, junk: float) -> torch.Tensor:
    hit = torch.zeros(n, dtype=torch.bool)
    pos = np.asarray(pos, dtype=np.int64)
    hit[torch.from_numpy(pos[(pos >= 0) & (pos < n)])] = True
    hit |= torch.from_numpy(rng.random(n) < junk)
    return t_chain.pack_bits(hit)


def _port_fold(data, seams, terms, tr, table, shift, rng, junk, count_only,
               no_rescan, fn=None):
    """The same chunks through line_terms_reference (or fn), each chunk's
    plane the true starts (shifted) plus junk bits."""
    fn = fn or t_chain.line_terms_reference
    n = len(data)
    maxlen = max(len(t) for t in terms if t)
    tables = t_chain.term_tables(terms, tr, table)
    carry, last_nl, out = 0, -1, []
    for g0, g1 in zip(seams[:-1], seams[1:]):
        region = np.ascontiguousarray(data[g0:min(g1 + maxlen - 1, n)])
        starts = np.concatenate([j_mgrep._find_occurrences(region, t, tr)
                                 for t in terms if t])
        text = torch.from_numpy(region)
        plane = _plane(len(region), starts + shift, rng, junk)
        rows, k, carry, nl_at = fn(
            text, plane, shift, tables, g1 - g0, carry, last_nl + 1,
            n - 1 if no_rescan else n, g1 >= n, count_only, g0)
        if count_only:
            assert rows is None
            out.append(k)
        else:
            assert rows.shape == (k, 2) and rows.dtype == torch.int64
            out.append([tuple(r) for r in rows.tolist()])
        assert k <= t_chain.terms_capacity(g1 - g0, tables.min_len)
        nl = np.flatnonzero(region[:g1 - g0] == 0x0A)
        assert nl_at == (g0 + int(nl[-1]) if len(nl) else -1)
        if nl_at >= 0:
            last_nl = nl_at
    assert carry == 0
    return out


# (pattern, nocase, junk bit rate)
FOLD_CASES = [("hello;lazy", False, 0.0), ("hello;lazy", True, 0.02),
              ("lazy;dog;fox;over", False, 0.05),
              ("{hello,matching};~lazy", False, 0.01),
              ("~{ab;zz},xyz", True, 0.05), ("q;ab", False, 0.3),
              ("~fox;dog", False, 0.0),
              (";".join(["ab", "bca", "cab", "xyz", "zz", "q", "hello",
                         "lazy", "dog", "fox", "over", "matching", "abc",
                         "ca", "by", "ox"]), False, 0.02),
              ("{" + ",".join(["ab", "bca", "cab", "xyz", "zz", "q", "hello",
                               "lazy", "dog", "fox", "over", "matching",
                               "abc", "ca", "by"]) + "};~ox", True, 0.02)]


def _setup(pattern, nocase, seed, n):
    split = t_boolean.split_pattern(pattern)
    terms = [t.encode("latin-1") for t in split.terminals]
    tr = _fold(nocase)
    op = "and" if split.tree is None else "or"
    NT = len(terms)
    table = t_boolean.truth_table(split.tree, op, [True] * NT, NT)

    def verdict(hits):
        if split.tree is None:
            return hits.all(axis=1)
        return j_boolean.eval_tree_vec(split.tree, "or", hits)
    rng = np.random.default_rng(seed)
    data = _text(rng, n, terms, nocase)
    return terms, tr, table, verdict, rng, data


def _seams(rng, n: int, k: int) -> list:
    return [0] + sorted(set(rng.integers(1, n, k).tolist())) + [n]


@pytest.mark.parametrize("shift_of", ["starts", "anchors"])
@pytest.mark.parametrize("count_only", [False, True], ids=["rows", "count"])
@pytest.mark.parametrize("pattern,nocase,junk", FOLD_CASES,
                         ids=["%d%s" % (i, "-i" if c[1] else "")
                              for i, c in enumerate(FOLD_CASES)])
def test_reference_matches_agrep_tpu_fold(pattern, nocase, junk, count_only,
                                          shift_of):
    terms, tr, table, verdict, rng, data = _setup(
        pattern, nocase, len(pattern) + 7 * nocase, 6000)
    shift = 0 if shift_of == "starts" else min(map(len, terms)) - 1
    for cut, no_final in ((12, False), (3, True), (0, False)):
        d = np.concatenate([data, np.frombuffer(
            b"last " + terms[-1], np.uint8)]) if no_final else data
        seams = _seams(rng, len(d), cut)
        want = _np_fold(d, seams, terms, tr, verdict, False)
        got = _port_fold(d, seams, terms, tr, table, shift, rng, junk,
                         count_only, False)
        if count_only:
            want = [len(r) for r in want]
        assert got == want, (seams, pattern)
    assert sum(len(r) for r in _np_fold(data, [0, len(data)], terms, tr,
                                        verdict, False)) > 3


def test_reference_seam_edges():
    """A term across a seam; a line whose terms lie on both sides of a
    seam; an occurrence only in the halo; a body of one byte; a last
    chunk without a newline under no EOF rescan (cap_e = n - 1)."""
    terms = [b"hello", b"lazy"]
    tr = _fold(False)
    table = t_boolean.truth_table(None, "and", [True, True], 2)
    data = np.frombuffer(b"x hello lazy\nhel" + b"lo and lazy\nlaz"
                         + b"y hello\nnothing\nhello lazy", np.uint8).copy()
    n = len(data)
    rng = np.random.default_rng(3)

    def verdict(h):
        return h.all(axis=1)
    for seams in ([0, n], [0, 15, n], [0, 14, 16, 30, 31, n],
                  list(range(n + 1)), [0, 30, n - 1, n]):
        for no_rescan in (False, True):
            want = _np_fold(data, seams, terms, tr, verdict, no_rescan)
            got = _port_fold(data, seams, terms, tr, table, 0, rng, 0.0,
                             False, no_rescan)
            assert got == want, seams
    assert _np_fold(data, [0, n], terms, tr, verdict, False) == [
        [(0, 13), (13, 28), (28, 39), (47, n)]]


# ---------------------------------------------------------------------
# a Python model of the kernel's launch
# ---------------------------------------------------------------------

def kernel_constants() -> dict:
    """The constexpr ints of csrc/line_terms.cu."""
    with open(CSRC) as fh:
        return {k: int(v) for k, v in re.findall(
            r"constexpr int (k\w+) = (\d+);", fh.read())}


K_CONST = kernel_constants()
IDENT = (0, -1)


def _combine(a, b):
    return b if b[1] >= 0 else (a[0] | b[0], a[1])


def _warp_scan(x):
    x = list(x)
    d = 1
    while d < 32:
        y = [x[l - d] if l >= d else x[l] for l in range(32)]
        x = [_combine(y[l], x[l]) if l >= d else x[l] for l in range(32)]
        d <<= 1
    return x


def _warp_reduce(x):
    """The shfl_down reduction: lane 0 ends with the ordered fold."""
    x = list(x)
    d = 1
    while d < 32:
        y = [x[l + d] if l + d < 32 else x[l] for l in range(32)]
        x = [_combine(x[l], y[l]) if l + d < 32 else x[l]
             for l in range(32)]
        d <<= 1
    return x[0]


def kernel_model(text, plane, shift, tables, body, carry, begin, cap_e, last,
                 count_only, base, grid, threads):
    """csrc/line_terms.cu's launch, transcribed: (rows, count, carry_out,
    last_nl) as the wrapper returns them."""
    warps_b = threads // 32
    t = text.numpy()
    N = len(t)
    pw = plane.numpy().view(np.uint32)
    tr = tables.tr.numpy()
    tb = tables.t_bytes.numpy()
    off = tables.t_off.numpy().tolist()
    tw = tables.table.numpy().view(np.uint32)
    NT = tables.n_terms
    words = -(-body // 32)
    steps_all = -(-words // 32)
    G = grid * warps_b
    warp_words = 32 * -(-steps_all // G)

    def load_word(w):
        i0 = 32 * w
        nl = 0
        for b in range(32):
            if i0 + b < N and t[i0 + b] == 0x0A:
                nl |= 1 << b
        a0 = i0 + shift
        q, r = a0 >> 5, a0 & 31
        lo = int(pw[q]) if q < len(pw) else 0
        hi = int(pw[q + 1]) if q + 1 < len(pw) else 0
        cand = ((lo | hi << 32) >> r) & 0xFFFFFFFF
        left = body - i0
        keep = 0xFFFFFFFF if left >= 32 else (1 << left) - 1
        return nl & keep, cand & keep

    # the terms whose first byte is each folded byte
    first = [0] * 256
    for k in range(NT):
        if off[k + 1] > off[k]:
            first[tb[off[k]]] |= 1 << k

    def terms_at(s):
        m = 0
        for k in range(NT):
            if not first[tr[t[s]]] >> k & 1:
                continue
            o, L = off[k], off[k + 1] - off[k]
            if s + L > N:
                continue
            if all(tr[t[s + j]] == tb[o + j] for j in range(1, L)):
                m |= 1 << k
        return m

    def summary(w, wd):
        nl, c = wd
        tail, lastp = 0, -1
        if nl:
            hi = nl.bit_length() - 1
            lastp = 32 * w + hi
            c = 0 if hi == 31 else c & (0xFFFFFFFF << (hi + 1)) & 0xFFFFFFFF
        for b in range(32):
            if c >> b & 1:
                tail |= terms_at(32 * w + b)
        return tail, lastp

    def fires(m):
        return m != 0 and (int(tw[m >> 5]) >> (m & 31)) & 1

    def fire_mask(w, wd, acc):
        nl, c = wd
        if not nl:
            return 0
        c &= (2 << (nl.bit_length() - 1)) - 1     # a start past the last
        f = 0                                      # newline ends no line
        for b in range(32):
            if c >> b & 1:
                acc |= terms_at(32 * w + b)
            if nl >> b & 1:
                if fires(acc):
                    f |= 1 << b
                acc = 0
        return f

    def run_of(gw):
        w0 = gw * warp_words
        w1 = min(w0 + warp_words, words)
        return w0, w1, (-(-(w1 - w0) // 32) if w0 < w1 else 0)

    # phase 1: each warp's run, each block's fold of its warps
    ws = []
    for gw in range(G):
        w0, w1, steps = run_of(gw)
        run = IDENT
        for st in range(steps):
            s = []
            for lane in range(32):
                w = w0 + 32 * st + lane
                s.append(summary(w, load_word(w)) if w < w1 else IDENT)
            run = _combine(run, _warp_reduce(s))
        ws.append(run)
    bs = []
    for blk in range(grid):
        acc = IDENT
        for k in range(warps_b):
            acc = _combine(acc, ws[blk * warps_b + k])
        bs.append(acc)
    # phase 2, block 0: the blocks' exclusive prefixes
    per = -(-grid // threads)
    x = []
    for th in range(threads):
        i0, i1 = min(th * per, grid), min(th * per + per, grid)
        acc = IDENT
        for i in range(i0, i1):
            acc = _combine(acc, bs[i])
        x.append(acc)
    incl = []
    for wb in range(warps_b):
        incl += _warp_scan(x[32 * wb:32 * wb + 32])
    wpre, pre = [], (carry, -1)
    for wb in range(warps_b):
        wpre.append(pre)
        pre = _combine(pre, incl[32 * wb + 31])
    bpx = list(bs)
    for th in range(threads):
        lane, wb = th & 31, th >> 5
        p = _combine(wpre[wb], incl[th - 1] if lane else IDENT)
        i0, i1 = min(th * per, grid), min(th * per + per, grid)
        for i in range(i0, i1):
            bpx[i] = p
            p = _combine(p, bs[i])
        if th == threads - 1:
            total = p
    tail_fires = int(bool(last) and bool(fires(total[0])))
    carry_out = 0 if last else total[0]
    last_nl = base + total[1] if total[1] >= 0 else -1
    # each warp's prefix: its block's, then its block's warps before it
    px = []
    for blk in range(grid):
        p = bpx[blk]
        for k in range(warps_b):
            px.append(p)
            p = _combine(p, ws[blk * warps_b + k])

    def walk(gw, visit):
        w0, w1, steps = run_of(gw)
        p = px[gw]
        for st in range(steps):
            ws_ = [w0 + 32 * st + lane for lane in range(32)]
            wds = [load_word(w) if w < w1 else (0, 0) for w in ws_]
            s = [summary(w, wd) if w < w1 else IDENT
                 for w, wd in zip(ws_, wds)]
            inc = _warp_scan(s)
            before = [_combine(p, inc[lane - 1] if lane else IDENT)
                      for lane in range(32)]
            f = [fire_mask(w, wd, b[0]) if w < w1 else 0
                 for w, wd, b in zip(ws_, wds, before)]
            visit(ws_, wds, f, [b[1] for b in before])
            p = _combine(p, inc[31])

    counts = []
    for gw in range(G):
        c = [0]
        walk(gw, lambda w, wd, f, lb: c.__setitem__(
            0, c[0] + sum(bin(x).count("1") for x in f)))
        counts.append(c[0])
    K = sum(counts) + tail_fires
    if count_only:
        return None, K, carry_out, last_nl
    rows = [None] * K
    # block 0's scan of the blocks' counts, then each block's of its warps'
    bc = [sum(counts[blk * warps_b:(blk + 1) * warps_b])
          for blk in range(grid)]
    boff = np.concatenate([[0], np.cumsum(bc)]).tolist()
    offs = []
    for blk in range(grid):
        o = boff[blk]
        for k in range(warps_b):
            offs.append(o)
            o += counts[blk * warps_b + k]
    for gw in range(G):
        o = [offs[gw]]

        def put(ws_, wds, f, lb):
            x = 0
            for lane in range(32):
                i = o[0] + x
                for b in range(32):
                    if not f[lane] >> b & 1:
                        continue
                    below = wds[lane][0] & ((1 << b) - 1)
                    prev = (32 * ws_[lane] + below.bit_length() - 1
                            if below else lb[lane])
                    rows[i] = (base + prev + 1 if prev >= 0 else begin,
                               base + 32 * ws_[lane] + b + 1)
                    i += 1
                x += bin(f[lane]).count("1")
            o[0] += x
        walk(gw, put)
    if tail_fires:
        rows[K - 1] = (last_nl + 1 if total[1] >= 0 else begin, cap_e)
    return torch.tensor(rows, dtype=torch.int64).reshape(-1, 2), K, \
        carry_out, last_nl


# (blocks, threads a block): one warp, two, and the kernel's own
GEOMETRIES = [(1, 32), (3, 32), (2, 64), (5, 64), (2, K_CONST["kThreads"])]


@pytest.mark.parametrize("grid,threads", GEOMETRIES,
                         ids=["%dx%d" % g for g in GEOMETRIES])
@pytest.mark.parametrize("case", [0, 3, 7])
def test_kernel_model_matches_reference(grid, threads, case):
    pattern, nocase, junk = FOLD_CASES[case]
    terms, tr, table, _verdict, rng, data = _setup(pattern, nocase, 11 + case,
                                                   2800)
    shift = (min(map(len, terms)) - 1) * (case % 2)
    seams = _seams(rng, len(data), 3)

    def model(*a):
        return kernel_model(*a, grid=grid, threads=threads)
    for count_only in (False, True):
        want = _port_fold(data, seams, terms, tr, table, shift,
                          np.random.default_rng(1), junk, count_only, False)
        got = _port_fold(data, seams, terms, tr, table, shift,
                         np.random.default_rng(1), junk, count_only, False,
                         fn=model)
        assert got == want


def test_kernel_model_dense_and_long():
    """Every plane bit set (every position a candidate), a line longer
    than a warp's run, a word whose last byte is a newline, a body that
    ends inside a word, and more steps a warp than one."""
    terms = [b"ab", b"b", b"ba"]
    tr = _fold(False)
    split = t_boolean.split_pattern("{ab,b};~ba")
    table = t_boolean.truth_table(split.tree, "or", [True] * 3, 3)
    tables = t_chain.term_tables(terms, tr, table)
    raw = (b"ab" * 700 + b"\n" + b"x" * 30 + b"\n" + b"bab\n" * 40
           + b"ab" * 15 + b"a\n" + b"yb" * 300)
    text = torch.from_numpy(np.frombuffer(raw, np.uint8).copy())
    N = text.numel()
    plane = torch.full((-(-N // 32),), -1, dtype=torch.int32)
    for body in (N, N - 5, 1000, 1, 31, 32, 33):
        for carry, last in ((0, True), (5, False), (2, True)):
            args = (text, plane, 0, tables, body, carry, 3, N + 9, last,
                    False, 100)
            want = t_chain.line_terms_reference(*args)
            for grid, threads in ((1, 32), (4, 32), (2, 64)):
                got = kernel_model(*args, grid=grid, threads=threads)
                assert got[1:] == want[1:], (body, carry, last)
                assert got[0].tolist() == want[0].tolist()


# ---------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------

def test_tables_and_wrapper_refuse_what_the_kernel_does_not_take():
    tr = _fold(False)
    table = t_boolean.truth_table(None, "and", [True, True], 2)
    with pytest.raises(ValueError, match="newline"):
        t_chain.term_tables([b"a\nb", b"c"], tr, table)
    with pytest.raises(ValueError, match="terms"):
        t_chain.term_tables([b"x%d" % i for i in range(17)], tr,
                            np.zeros(4096, np.uint32))
    with pytest.raises(ValueError, match="words"):
        t_chain.term_tables([b"ab", b"cd"], tr, np.zeros(2, np.uint32))
    with pytest.raises(ValueError, match="live"):
        t_chain.term_tables([b"", b""], tr, table)
    tables = t_chain.term_tables([b"ab", b"cd"], tr, table)
    text = torch.zeros(40, dtype=torch.uint8)
    plane = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        t_chain.line_terms(text, plane.long(), 0, tables, 40)
    with pytest.raises(TypeError):
        t_chain.line_terms(text, torch.zeros(3, dtype=torch.int32), 0,
                           tables, 40)
    with pytest.raises(TypeError):
        t_chain.line_terms(text.int(), plane, 0, tables, 40)
    for body, shift, carry in ((0, 0, 0), (41, 0, 0), (40, -1, 0),
                               (40, 0, 4)):
        with pytest.raises(ValueError):
            t_chain.line_terms(text, plane, shift, tables, body, carry)
    with pytest.raises(ValueError, match="empty"):
        t_chain.line_terms(text[:0], plane[:0], 0, tables, 1)
    rows, k, carry, nl = t_chain.line_terms(text, plane, 0, tables, 40,
                                            last=True)
    assert (rows.shape, k, carry, nl) == ((0, 2), 0, 0, -1)
