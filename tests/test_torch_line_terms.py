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
  * a Python model of the kernel's one-pass launch (csrc/line_terms.cu:
    tiles of a 32-byte word a thread taken by ticket, staged with a halo
    and misaligned views, candidates compacted and verified once each,
    a term past the halo read on from the text, the words' aggregates
    and a block scan by warp shuffles, the decoupled look-back over
    epoch-tagged statuses, the rows), its blocks interleaved in seeded
    random orders over a scratch that persists from launch to launch,
    at 1-9 blocks of one, two and the kernel's own warps, against the
    plain version: seeded texts at random seams, bodies that end inside
    a tile and at a tile edge, q-gram anchors, lines longer than a tile,
    carried masks in and out, both forms;
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
    """The constexpr ints of csrc/line_terms.cu that are plain numbers."""
    with open(CSRC) as fh:
        return {k: int(v) for k, v in re.findall(
            r"constexpr int (k\w+) = (\d+);", fh.read())}


K_CONST = kernel_constants()
IDENT = (0, 0, -1, 0)          # an aggregate: head, tail, last, cnt
FULL = 0xFFFFFFFF
PER = K_CONST["kBackLane"]     # the look-back's statuses a lane
BACK = 32 * PER                # its window


def _set_bits(x):
    while x:
        b = (x & -x).bit_length() - 1
        yield b
        x &= x - 1


def _nl_chunk(buf, at: int) -> int:
    return sum(1 << j for j in range(32) if buf[at + j] == 0x0A)


class LaunchModel:
    """csrc/line_terms.cu's launch, transcribed: the tiles of `threads`
    32-byte words taken by ticket by `grid` blocks, each block's compute
    warps and its look-back warp two coroutines joined by a stash of two
    slots, which a seeded scheduler runs in random interleavings (a
    coroutine yields where the kernel may be overtaken: after its
    tickets, after each publication, at a full or empty stash, and at
    every spin of a look-back on a status not yet of this launch's
    epoch; the first block can be made slow, so that many tiles wait on
    its first), each tile staged as the TMA copies and the ragged
    loads leave it (the text at shared index lead + (x - t0) among
    garbage newlines, the plane words at plead + (q - q0) among garbage
    ones, zeros past the plane), its words' newline masks cut from the
    aligned 32-byte chunks by the funnel, its candidates by the plane's
    funnel shift, each warp's compacted into its part of a list and
    verified once each (a byte past the staged halo read from the text), the
    words' aggregates and fire bits, the block's scan by warp shuffles,
    each word's stash (its fire bits with its first line's unless that is
    the tile's first, its rows' offset in the tile, the newline before
    it),
    the look-back over windows of 32 statuses, and the rows.  The
    scratch (ticket, statuses, aggregates, inclusive prefixes) persists
    from launch to launch as the wrapper's does, with its epoch and the
    tickets taken."""

    def __init__(self, threads: int = K_CONST["kThreads"],
                 halo_cap: int = K_CONST["kHalo"],
                 term_smem: int = K_CONST["kTermSmem"],
                 per: int = K_CONST["kPerThread"]):
        self.threads = threads
        self.per = per
        self.tile = 32 * threads * per
        self.halo_cap = halo_cap
        self.term_smem = term_smem
        self.sc = None
        self.stats = {"verified": 0, "global_bytes": 0, "spins": 0,
                      "staged": 0, "max_tiles_a_block": 0,
                      "most_aggregates": 0}

    def scratch_for(self, tiles: int) -> dict:
        sc = self.sc
        if sc is None or sc["tiles"] < tiles:
            cap = max(tiles, 64, 2 * sc["tiles"] if sc else 0)
            sc = self.sc = {"tiles": cap, "ticket": 0,
                            "status": [(0, (0, 0))] * cap, "epoch": 0,
                            "taken": 0}
        return sc

    def __call__(self, text, plane, shift, tables, body, carry, begin,
                 cap_e, last, count_only, base, grid, rng, lead=0,
                 plead=0, slow=1.0):
        t = text.numpy()
        N = len(t)
        pw = -(-N // 32)
        pl = [int(x) for x in plane.numpy().view(np.uint32)]
        tr = tables.tr.numpy().tolist()
        tb = tables.t_bytes.numpy().tolist()
        off = tables.t_off.numpy().tolist()
        tw = tables.table.numpy().view(np.uint32).tolist()
        NT = tables.n_terms
        halo = min(tables.max_len - 1, self.halo_cap)
        TH, TILE, PT = self.threads, self.tile, self.per
        WORDS = TH * PT
        tiles = -(-body // TILE)
        sc = self.scratch_for(tiles)
        epoch, tbase = sc["epoch"] + 1, sc["taken"]
        cap = 0 if count_only else t_chain.terms_capacity(body,
                                                          tables.min_len)
        rows = [None] * cap
        out = [None] * 4
        first = [0] * 256
        for k in range(NT):
            if off[k + 1] > off[k]:
                first[tb[off[k]]] |= 1 << k
        stats = self.stats

        def fires(m):
            return m != 0 and (tw[m >> 5] >> (m & 31)) & 1 == 1

        def comb(a, b):
            if a[2] < 0:
                return (a[0] | b[0], b[1], b[2], b[3])
            if b[2] < 0:
                return (a[0], a[1] | b[0], a[2], a[3])
            return (a[0], b[1], b[2], a[3] + fires(a[1] | b[0]) + b[3])

        def apply(p, a):
            if a[2] < 0:
                return (p[0] | a[0], p[1], p[2])
            return (a[1], a[2], p[2] + fires(p[0] | a[0]) + a[3])

        def warp_scan(x):
            x = list(x)
            d = 1
            while d < 32:
                x = [comb(x[ln - d], x[ln]) if ln >= d else x[ln]
                     for ln in range(32)]
                d <<= 1
            return x

        def block_scan(vals):
            """(each thread's exclusive aggregate, the total)."""
            incl = []
            for w in range(TH // 32):
                incl += warp_scan(vals[32 * w:32 * w + 32])
            tot = warp_scan([incl[32 * w + 31] for w in range(TH // 32)]
                            + [IDENT] * (32 - TH // 32))
            ex = [comb(tot[(i >> 5) - 1] if i >> 5 else IDENT,
                       incl[i - 1] if i & 31 else IDENT) for i in range(TH)]
            return ex, tot[TH // 32 - 1]

        def take():
            sc["ticket"] += 1
            return sc["ticket"] - 1 - tbase

        def stage(T):
            t0 = T * TILE
            t1 = min(t0 + TILE, body)
            end = min(t1 + halo, N)
            text_s = [0x0A] * (TILE + self.halo_cap + 32)
            for x in range(t0, end):
                text_s[lead + x - t0] = int(t[x])
            stats["staged"] += t1 - t0
            q0 = t0 // 32 + (shift >> 5)
            q1 = max(q0, min(q0 + WORDS + 1, pw))
            plane_s = [FULL] * (WORDS + 8)
            for j in range(WORDS + 1):
                plane_s[plead + j] = pl[q0 + j] if q0 + j < q1 else 0
            return t0, t1, end, text_s, plane_s

        def terms_at(x, t0, end, text_s):
            sx = lead + x - t0
            m = 0
            stats["verified"] += 1
            for k in _set_bits(first[tr[text_s[sx]]]):
                o, L = off[k], off[k + 1] - off[k]
                if x + L > N:
                    continue
                j = 1
                while j < L:
                    if x + j < end:
                        v = text_s[sx + j]
                    else:
                        v = int(t[x + j])
                        stats["global_bytes"] += 1
                    if tr[v] != tb[o + j]:
                        break
                    j += 1
                if j == L:
                    m |= 1 << k
            return m

        def pack(a):
            """A flag-1 status's payload: two u32 words."""
            return (a[0] | a[1] << 16, (a[2] + 1) | a[3] << 16)

        def agg_of(v, i):
            last = v[1] & 0xFFFF
            return (v[0] & 0xFFFF, v[0] >> 16,
                    i * TILE + last - 1 if last else -1, v[1] >> 16)

        def look_back(T):
            """The look-back: windows of BACK tiles, PER a lane (lane
            ln the entries PER ln + j), re-read until every entry nearer
            than the nearest inclusive prefix is of this epoch."""
            x = (0, 0, -1, 0)
            top = T - 1
            while True:
                got = {}
                gaps = [e for e in range(BACK) if top - e >= 0]
                while True:
                    for e in gaps:
                        st, payload = sc["status"][top - e]
                        if st >> 2 == epoch:
                            got[e] = (st & 3, payload)
                    gaps = [e for e in gaps if e not in got]
                    pe = min([e for e, g in got.items() if g[0] == 2]
                             + [top + 1 if top + 1 < BACK else BACK])
                    ie = gaps[0] if gaps else BACK
                    if ie > pe or ie == BACK:
                        break
                    stats["spins"] += 1
                    yield
                stats["most_aggregates"] = max(stats["most_aggregates"],
                                               T - 1 - top + pe)
                w = [(0, 0, -1, 0)] * 32
                for ln in range(32):
                    for j in range(PER - 1, -1, -1):
                        e = PER * ln + j
                        if e < pe:
                            w[ln] = comb(w[ln], agg_of(got[e][1], top - e))
                d = 1
                while d < 32:
                    w = [comb(w[ln + d], w[ln]) if ln + d < 32 else w[ln]
                         for ln in range(32)]
                    d <<= 1
                x = comb(w[0], x)
                if pe < BACK:
                    q = got[pe][1] if top - pe >= 0 else (carry, -1, 0)
                    return apply(q, x)
                top -= BACK

        def put_row(i, b, e):
            if i < cap:
                rows[i] = (b, e)

        def do_tile(T, staged):
            """The compute warps' fold of tile T: its stash."""
            t0, t1, end, text_s, plane_s = staged
            nls, cands = [], []
            A = [_nl_chunk(text_s, 32 * i) for i in range(WORDS + 1)]
            sh = shift & 31
            for i in range(WORDS):
                nl = A[i]
                if lead:
                    nl = (nl >> lead | A[i + 1] << (32 - lead)) & FULL
                c = plane_s[plead + i]
                if sh:
                    c = ((c | plane_s[plead + i + 1] << 32) >> sh) & FULL
                left = t1 - (t0 + 32 * i)
                keep = FULL if left >= 32 else (1 << left) - 1 \
                    if left > 0 else 0
                nls.append(nl & keep)
                cands.append(c & keep)
            # a round a word of the lanes: each warp's list, verified
            masks = {}
            for j in range(PT):
                for wp in range(TH // 32):
                    ws = [PT * (32 * wp + ln) + j for ln in range(32)]
                    lst = [32 * wd + b for wd in ws
                           for b in _set_bits(cands[wd])]
                    for r in lst:
                        masks[r] = terms_at(t0 + r, t0, end, text_s)
            words, fires_in = [], []
            for i in range(WORDS):
                w = list(IDENT)
                fire, acc, seen = 0, 0, False
                for b in _set_bits(nls[i] | cands[i]):
                    if cands[i] >> b & 1:
                        acc |= masks[32 * i + b]
                    if nls[i] >> b & 1:
                        if not seen:
                            w[0], seen = acc, True
                        elif fires(acc):
                            fire |= 1 << b
                            w[3] += 1
                        w[2] = 32 * i + b
                        acc = 0
                if seen:
                    w[1] = acc
                else:
                    w[0] = acc
                words.append(tuple(w))
                fires_in.append(fire)
            # a thread's words combined, the threads' scan, each word's
            # exclusive aggregate
            mine = []
            for i in range(TH):
                a = words[PT * i]
                for j in range(1, PT):
                    a = comb(a, words[PT * i + j])
                mine.append(a)
            ex_t, tot = block_scan(mine)
            ex = []
            for i in range(TH):
                x = ex_t[i]
                for j in range(PT):
                    ex.append(x)
                    x = comb(x, words[PT * i + j])
            if T > 0:
                sc["status"][T] = (epoch << 2 | 1, pack(tot))
            sh = {"T": T, "all": tot, "nl": nls, "fire": [], "first_nl": None,
                  "roff": [x[3] for x in ex], "last": [x[2] for x in ex]}
            for i in range(WORDS):
                nl, x, f = nls[i], ex[i], fires_in[i]
                # a word's first line, but for the tile's first
                if nl and x[2] >= 0 and fires(x[1] | words[i][0]):
                    f |= nl & -nl
                if nl and x[2] < 0:
                    sh["first_nl"] = 32 * i + (nl & -nl).bit_length() - 1
                sh["fire"].append(f)
            return sh

        def finish_tile(sh):
            """The look-back warp's work on a stashed tile."""
            T, tot = sh["T"], sh["all"]
            t0 = T * TILE
            a = (tot[0], tot[1], t0 + tot[2] if tot[2] >= 0 else -1, tot[3])
            pre = (carry, -1, 0)
            if T > 0:
                pre = yield from look_back(T)
            inc = apply(pre, a)
            sc["status"][T] = (epoch << 2 | 2, inc)
            if T == tiles - 1:
                tail = bool(last) and fires(inc[0])
                if not count_only and tail:
                    put_row(inc[2], base + inc[1] + 1 if inc[1] >= 0
                            else begin, cap_e)
                out[:] = [inc[2] + tail, 0 if last else inc[0],
                          base + inc[1] if inc[1] >= 0 else -1, int(tail)]
            yield
            if count_only:
                return
            f0 = tot[2] >= 0 and fires(pre[0] | tot[0])
            if f0:
                put_row(pre[2], base + pre[1] + 1 if pre[1] >= 0 else begin,
                        base + t0 + sh["first_nl"] + 1)
            for i in range(WORDS):
                nl, o = sh["nl"][i], pre[2] + f0 + sh["roff"][i]
                w0 = base + t0 + 32 * i
                for b in _set_bits(sh["fire"][i]):
                    below = nl & ((1 << b) - 1)
                    put_row(o, w0 + below.bit_length() if below
                            else base + t0 + sh["last"][i] + 1, w0 + b + 1)
                    o += 1

        def compute(stash):
            """A block's compute warps: tiles by ticket, each folded, its
            aggregate published, and stashed once one of the two stash
            slots is free (None: no more tiles)."""
            T = take()
            staged = stage(T) if T < tiles else None
            yield
            n = 0
            while T < tiles:
                nT = take()
                nstaged = stage(nT) if nT < tiles else None
                yield
                sh = do_tile(T, staged)
                yield
                while len(stash) == 2:
                    yield
                stash.append(sh)
                n += 1
                T, staged = nT, nstaged
            while len(stash) == 2:
                yield
            stash.append(None)
            stats["max_tiles_a_block"] = max(stats["max_tiles_a_block"], n)

        def back(stash):
            """A block's look-back warp: the stashed tiles in turn."""
            while True:
                while not stash:
                    yield
                if stash[0] is None:
                    return
                yield from finish_tile(stash[0])
                stash.pop(0)

        # the scheduler: each block takes its first ticket in turn, then a
        # block at random, the first one `slow` times as often as the others
        live = []
        for b in range(grid):
            stash = []
            live += [[compute(stash), slow if b == 0 else 1.0],
                     [back(stash), slow if b == 0 else 1.0]]
        for g in live[::2]:         # the blocks take their first tickets
            next(g[0])
        steps = 0
        while live:
            w = np.array([x[1] for x in live])
            g = live[int(rng.choice(len(live), p=w / w.sum()))]
            try:
                next(g[0])
            except StopIteration:
                live.remove(g)
            steps += 1
            assert steps < 10 ** 7, "the launch does not finish"
        sc["epoch"] = epoch
        sc["taken"] += tiles + grid
        assert sc["ticket"] == sc["taken"]
        K = out[0]
        assert K is not None and K <= max(cap, K if count_only else 0)
        if count_only:
            return None, K, out[1], out[2]
        assert None not in rows[:K]
        return (torch.tensor(rows[:K], dtype=torch.int64).reshape(-1, 2),
                K, out[1], out[2])


# (threads a block, halo cap, blocks, text lead, plane lead): one warp,
# two, small halos, misaligned views, and the kernel's own
GEOMETRIES = [(32, 8, 1, 0, 0), (32, 8, 3, 5, 1), (32, 2, 7, 15, 3),
              (64, 3, 2, 1, 2),
              (K_CONST["kThreads"], K_CONST["kHalo"], 4, 0, 0)]


@pytest.mark.parametrize("threads,halo,grid,lead,plead", GEOMETRIES,
                         ids=["%dt-h%d-%db-l%d-p%d" % g for g in GEOMETRIES])
@pytest.mark.parametrize("case", [0, 3, 7])
def test_kernel_model_matches_reference(threads, halo, grid, lead, plead,
                                        case):
    """Seeded texts of three tiles cut at two random seams, the mask
    carried from chunk to chunk, both forms, one model (one scratch) for
    every launch, tiles run in a random order each."""
    pattern, nocase, junk = FOLD_CASES[case]
    terms, tr, table, _verdict, rng, data = _setup(
        pattern, nocase, 11 + case, 3 * 32 * threads * K_CONST["kPerThread"])
    shift = (min(map(len, terms)) - 1) * (case % 2)
    seams = _seams(rng, len(data), 2)
    model = LaunchModel(threads, halo)
    order = np.random.default_rng(case)

    def run(*a):
        return model(*a, grid=grid, rng=order, lead=lead, plead=plead)
    for count_only in (False, True):
        want = _port_fold(data, seams, terms, tr, table, shift,
                          np.random.default_rng(1), junk, count_only, False)
        got = _port_fold(data, seams, terms, tr, table, shift,
                         np.random.default_rng(1), junk, count_only, False,
                         fn=run)
        assert got == want
    assert model.sc["epoch"] == 2 * (len(seams) - 1)


def _edge_text():
    """Lines of a's and b's, one of 2,500 bytes (longer than two tiles of
    one warp), a term of 40 bytes starting 20 bytes before each of three
    tile ends, words whose last byte is a newline."""
    long_term = b"qrstuvwxyz" * 4
    raw = (b"ab" * 700 + b"\n" + b"x" * 30 + b"\n" + b"bab\n" * 40
           + b"ab" * 15 + b"a\n" + b"yb" * 300 + b"\n")
    for _ in range(3):
        raw += b"k" * ((1024 - 20 - len(raw)) % 1024) + long_term + b" ab\n"
    raw += b"b" * 2500 + b"\n" + b"ab ba " + long_term + b"\n" + b"yb" * 200
    return raw, long_term


# (name, body: its length, or N less it where <= 0; shift, carry, last)
EDGE_CASES = [("mid-tile", -37, 0, 5, False),
              ("tile-edge", 4096, 0, 2, True),
              ("two-tile-edges", 2048, 1, 0, True),
              ("anchors", -1, 3, 6, False),
              ("one-byte", 1, 0, 1, True),
              ("whole", 0, 0, 7, True)]


@pytest.mark.parametrize("name,cut,shift,carry,last", EDGE_CASES,
                         ids=[c[0] for c in EDGE_CASES])
@pytest.mark.parametrize("count_only", [False, True], ids=["rows", "count"])
@pytest.mark.parametrize("per", sorted({1, K_CONST["kPerThread"]}),
                         ids=lambda n: "%dw" % n)
def test_kernel_model_edges(name, cut, shift, carry, last, count_only, per):
    """Tiles of one warp (1,024 bytes a word a thread) and a halo of 8:
    a body that ends
    inside a tile and exactly at a tile edge, q-gram anchors (shift > 0),
    a 40-byte term past the halo across a tile's end (read on from the
    text), a line longer than two tiles, every plane bit set, carried
    masks in and out; each launch after stale statuses of earlier
    launches in the scratch, and the tiles in several random orders."""
    terms = [b"ab", b"b", b"ba", b"qrstuvwxyz" * 4]
    tr = _fold(False)
    split = t_boolean.split_pattern("{ab,b};~ba,qrstuvwxyz"
                                    "qrstuvwxyzqrstuvwxyzqrstuvwxyz")
    assert [t.encode() for t in split.terminals] == terms
    table = t_boolean.truth_table(split.tree, "or", [True] * 4, 4)
    tables = t_chain.term_tables(terms, tr, table)
    raw, _long = _edge_text()
    text = torch.from_numpy(np.frombuffer(raw, np.uint8).copy())
    N = text.numel()
    body = N if cut == 0 else cut if cut > 0 else N + cut
    plane = torch.full((-(-N // 32),), -1, dtype=torch.int32)
    model = LaunchModel(32, 8, per=per)
    args = (text, plane, shift, tables, body, carry, 3, N + 9, last,
            count_only, 100)
    want = t_chain.line_terms_reference(*args)
    for seed in range(3):
        for grid in (1, 3, 9):
            # stale statuses: the epoch before, every flag, junk values
            sc = model.scratch_for(-(-body // model.tile))
            for i in range(len(sc["status"])):
                sc["status"][i] = (sc["epoch"] << 2 | 1, (0xF000F, 0x30100))
                if i % 2:
                    sc["status"][i] = (sc["epoch"] << 2 | 2, (0xF, 12345, 99))
            got = model(*args, grid=grid, rng=np.random.default_rng(seed),
                        lead=seed * 7 % 16, plead=seed)
            assert got[1:] == want[1:], (grid, seed)
            if not count_only:
                assert got[0].tolist() == want[0].tolist(), (grid, seed)
    tiles = -(-body // model.tile)
    # every body byte staged once a launch, every candidate verified once
    assert model.stats["staged"] == 9 * body
    starts = min(body, 32 * plane.numel() - shift)
    assert model.stats["verified"] == 9 * starts
    if name == "whole":
        assert model.stats["global_bytes"] > 0     # the term past the halo
        assert tiles > 3 and model.stats["max_tiles_a_block"] > 1
        assert want[1] > 3


@pytest.mark.parametrize("count_only", [False, True], ids=["rows", "count"])
def test_kernel_model_long_look_back(count_only):
    """160 tiles of one warp and 150 blocks whose first (it holds tile 0)
    is run 100 times less often: tiles publish their aggregates while
    tile 0 stalls, so a look-back combines more than a window of them
    before it reaches an inclusive prefix."""
    terms = [b"ab", b"b", b"ba", b"qrstuvwxyz" * 4]
    split = t_boolean.split_pattern("{ab,b};~ba,qrstuvwxyz"
                                    "qrstuvwxyzqrstuvwxyzqrstuvwxyz")
    table = t_boolean.truth_table(split.tree, "or", [True] * 4, 4)
    tables = t_chain.term_tables(terms, _fold(False), table)
    raw = (_edge_text()[0] * 20)[:160 * 1024 - 100]
    text = torch.from_numpy(np.frombuffer(raw, np.uint8).copy())
    N = text.numel()
    rng = np.random.default_rng(5)
    plane = _plane(N, rng.integers(0, N, N // 4), rng, 0.0)
    args = (text, plane, 0, tables, N - 50, 3, 0, N, False, count_only, 7)
    want = t_chain.line_terms_reference(*args)
    model = LaunchModel(32, 8, per=1)
    got = model(*args, grid=150, rng=np.random.default_rng(2), slow=0.01)
    assert got[1:] == want[1:]
    if not count_only:
        assert got[0].tolist() == want[0].tolist()
    assert model.stats["most_aggregates"] > BACK
    assert want[1] > 10


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
