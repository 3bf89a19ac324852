"""The q-gram route's lines on the scan device, against agrep_tpu, exactly,
on the CPU.

  * qgram_lines_reference (and the qgram_lines wrapper, which takes it for
    a CPU tensor) against agrep_tpu's native qgram_first_per_line, the
    count (count_only) and the (anchor, term id) pairs, on tables built by
    agrep_tpu's compile/multi.py from seeded data: LONG and 2-gram
    tables, -i (a folding tr), -w where a bucket's highest term matches
    but fails the word test and a lower one passes, a term that would end
    past the text's end, anchors at p - 1, empty lines, a final line
    without a newline, lines that hold several winners, a plane with no
    bit set and one with every bit set;
  * a model of csrc/qgram_lines.cu's three passes in Python (a thread's
    words' newline and exact member masks, each candidate walked by the
    thread that found it, the thread, tile and prefix folds, pass 3's
    rows from pass 1's masks) at small tiles and a persistent grid,
    against the plain version, so that the decomposition is proved where
    the kernel cannot run: every plane bit set, a word of 32 candidates,
    -w, LONG tables, -i, and term sets of hundreds to over a thousand
    terms;
  * the wrapper's argument checks, and that a CPU tensor launches no
    kernel;
  * the CLI: -c, -c -i, -c -w, the lines (agrep refuses -n with -f), -l
    and several files with the 600-term wide set past the chain caps, on
    files over and under 64 KiB, whole and streamed, through both packages
    (agrep_tpu on its numpy backend), byte for byte with the exit code;
    each device-route file calls qgram_lines once and reads back no
    candidate positions, runs no native verify and, for a count, builds no
    occurrence table; under 64 KiB the host pass counts or prints.

Every value is an integer, so every comparison is exact.  The CUDA kernel
is held against its plain version by chip_smoke.py on the GPU.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

import agrep_tpu.api as j_api
from agrep_tpu import native as j_native
from agrep_tpu.compile import multi as j_multi
from agrep_tpu.ops import scan as j_scan
import agrep_tpu_torch.api as t_api
from agrep_tpu_torch import native as t_native
from agrep_tpu_torch.ops import chain_kernel as t_chain
from agrep_tpu_torch.ops import qgram_kernel as t_qgram
from agrep_tpu_torch.ops import scan as t_scan
from agrep_tpu_torch.runtime import mgrep as t_mgrep
from tests.test_torch_mgrep import _patterns_600_wide, _write_corpus

from .torch_oracle import one_thread


@pytest.fixture(autouse=True)
def _backends():
    """Port on the plain PyTorch versions (CPU), reference on its exact
    numpy backend; both restored afterwards."""
    saved = (t_scan._BACKEND, t_scan._DEVICE, j_scan._BACKEND)
    t_scan.set_backend("torch")
    t_scan.set_device("cpu")
    j_scan.set_backend("numpy")
    with one_thread():
        yield
    t_scan._BACKEND, t_scan._DEVICE = saved[:2]
    j_scan.set_backend(saved[2])


# ---------------------------------------------------------------------
# the function against agrep_tpu's native pass
# ---------------------------------------------------------------------

FOLD = np.arange(256, dtype=np.uint8)
FOLD[65:91] += 32


def csr(tb, terms):
    """The bucket and term CSR tables of the native passes."""
    b_off = np.zeros(len(tb.bucket_list) + 1, dtype=np.int64)
    for i, ids in enumerate(tb.bucket_list):
        b_off[i + 1] = b_off[i] + len(ids)
    b_tids = np.concatenate(tb.bucket_list).astype(np.int64)
    t_off = np.zeros(len(terms) + 1, dtype=np.int64)
    for i, t in enumerate(terms):
        t_off[i + 1] = t_off[i] + len(t)
    return b_off, b_tids, np.frombuffer(b"".join(terms), np.uint8).copy(), \
        t_off


class Case:
    """One input: agrep_tpu's tables of the terms, the port's, the text and
    qgram_filter's plane over it."""

    def __init__(self, terms, text: bytes, fold: bool, wordbound: bool):
        self.terms = terms
        self.text = np.frombuffer(text, np.uint8).copy()
        self.tr = FOLD if fold else np.arange(256, dtype=np.uint8)
        self.wb = wordbound
        self.tb = j_multi.build_qgram_tables(terms, self.tr)
        self.csr = csr(self.tb, terms)
        self.tables = t_qgram.line_tables(
            self.tb.member, self.tb.hash_id, *self.csr, self.tr,
            self.tb.p_size, self.tb.long_, wordbound)
        self.t = torch.from_numpy(self.text)
        self.plane = t_qgram.qgram_filter(self.t, t_qgram.words_tensor(
            j_multi.member_projection_1024(self.tb)))

    def native(self, count_only=False):
        tb = self.tb
        return j_native.qgram_first_per_line(
            self.text, tb.member, tb.hash_id, *self.csr, self.tr, tb.p_size,
            bool(tb.long_), bool(tb.short), self.wb, count_only=count_only)


def _words(rng, k, lo, hi, alphabet=b"abcdefghij"):
    al = np.frombuffer(alphabet, np.uint8)
    return [bytes(rng.choice(al, int(rng.integers(lo, hi))))
            for _ in range(k)]


def _text(rng, terms, n, p_nl=1 / 30, fold=False) -> bytes:
    """Letters, spaces and newlines (empty lines among them) with the
    terms planted, in random case under fold."""
    t = rng.choice(np.frombuffer(b"abcdefghij  ", np.uint8), n)
    t[rng.random(n) < p_nl] = 0x0A
    for term in terms:
        for off in rng.integers(0, max(1, n - len(term)), 3):
            b = np.frombuffer(term, np.uint8)
            if fold and rng.integers(0, 2):
                b = b - 32 * ((b >= 97) & (b <= 122))
            t[off:off + len(b)] = b[:n - off]
    return t.tobytes()


def _edge_terms():
    """Terms in buckets of several: at -w, "abc" (a higher id) matches
    inside "abcd" and fails the word test where "abcd" passes; "hijklmnx"
    would end past the text's end where the lower "hijklm" fits."""
    return [b"abcd", b"abc", b"hijklm", b"hijklmnx", b"xyz", b"xyzw",
            b"efg"] + [b"q%02dz" % i for i in range(30)]


def _edge_text() -> bytes:
    return (b"abc xyz abcd\n\n\nefg efg abcd xyzw\n abcd \n\nxyz\n"
            b"nothing here\nq07z q08z\n" * 3 + b"tail hijklm")


def cases():
    rng = np.random.default_rng(12)
    out = {}
    for seed in range(4):
        for long_ in (False, True):
            for fold in (False, True):
                for wb in (False, True):
                    r = np.random.default_rng(100 * seed + 8 * long_
                                              + 2 * fold + wb)
                    # multilen > 400 with p_size > 2 makes a LONG table
                    terms = _words(r, 120 if long_ else 30, 3, 9)
                    out["s%d_%s%s%s" % (seed, "long" if long_ else "2gram",
                                        "_i" if fold else "",
                                        "_w" if wb else "")] = (
                        terms, _text(r, terms[::3], 6000, fold=fold), fold,
                        wb)
    edge = _edge_terms()
    for wb in (False, True):
        w = "_w" if wb else ""
        out["edge" + w] = (edge, _edge_text(), False, wb)
        out["edge_long" + w] = (edge + _words(rng, 60, 4, 8), _edge_text(),
                                False, wb)
        out["edge_i" + w] = (edge, _edge_text().upper(), True, wb)
        # a term at position 0 (anchor p - 1) and a final line without a
        # newline that holds a match
        out["head_tail" + w] = (edge, b"abcd x\nq01z", False, wb)
    out["empty_lines"] = (edge, b"\n" * 40 + b"xyz\n\n\nabc", False, False)
    out["one_line"] = (edge, b"abc abc abcd xyz q03z q03z", False, False)
    out["short_text"] = (edge, b"ab", False, False)
    out["no_match"] = (edge, b"nothing to see\nat all\n", False, False)
    return out


CASES = cases()


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_equals_the_native_pass(name):
    c = Case(*CASES[name])
    want_a, want_t = c.native()
    rows, k = t_qgram.qgram_lines_reference(c.t, c.plane, c.tables)
    assert k == len(want_a) == c.native(count_only=True)
    assert np.array_equal(rows[:, 0].numpy(), want_a)
    assert np.array_equal(rows[:, 1].numpy(), want_t)
    assert t_qgram.qgram_lines_reference(c.t, c.plane, c.tables,
                                         count_only=True) == (None, k)


def test_the_cases_cover_their_edges():
    """The edge cases reach what they are named for."""
    assert any(Case(*CASES[n]).tb.long_ for n in CASES if "long" in n)
    assert not Case(*CASES["edge"]).tb.long_
    for name in ("edge", "edge_w"):
        c = Case(*CASES[name])
        rows, _k = t_qgram.qgram_lines_reference(c.t, c.plane, c.tables)
        tids = set(rows[:, 1].tolist())
        # abc (1) wins inside "abcd " too, but not at -w: abcd (0) does
        assert 1 in tids and (0 in tids) == c.wb
        # the final line's hijklm: hijklm (2) fits, hijklmnx does not
        assert rows[-1, 1] == 2 and rows[-1, 0] > len(c.text) - 7
    c = Case(*CASES["head_tail"])
    rows, _k = t_qgram.qgram_lines_reference(c.t, c.plane, c.tables)
    assert rows[0, 0] == c.tb.p_size - 1
    assert rows[-1, 0] > c.text.tobytes().rindex(b"\n")
    c = Case(*CASES["one_line"])
    want_all = j_multi.qgram_occurrences(c.text, c.terms, c.tr, c.tb)
    assert sum(len(v) for v in want_all.values()) > 3
    assert t_qgram.qgram_lines_reference(c.t, c.plane, c.tables)[1] == 1


@pytest.mark.parametrize("name", ["s0_long_i_w", "s1_2gram", "edge_w"])
def test_planes_with_no_bit_and_every_bit(name):
    c = Case(*CASES[name])
    none = torch.zeros_like(c.plane)
    rows, k = t_qgram.qgram_lines(c.t, none, c.tables)
    assert k == 0 and rows.shape == (0, 2)
    # the member test is exact: every bit set gives the native pairs
    full = torch.full_like(c.plane, -1)
    rows, k = t_qgram.qgram_lines(c.t, full, c.tables)
    want_a, want_t = c.native()
    assert k == len(want_a)
    assert np.array_equal(rows.numpy(), np.stack([want_a, want_t], 1))


# ---------------------------------------------------------------------
# a model of the kernel's passes
# ---------------------------------------------------------------------

NL, HEAD, TAIL = 1, 2, 4


def combine(x, y):
    """csrc/qgram_lines.cu's combine: the summary (flags, mid) of run x
    followed by run y."""
    (xf, xm), (yf, ym) = x, y
    if not xf & NL:
        return (yf & NL) | ((xf | yf) & HEAD) | (yf & TAIL), \
            ym if yf & NL else 0
    if not yf & NL:
        return NL | (xf & HEAD) | (TAIL if (xf & TAIL) or (yf & HEAD)
                                   else 0), xm
    return NL | (xf & HEAD) | (yf & TAIL), \
        xm + ym + int(bool((xf & TAIL) or (yf & HEAD)))


def word_sum(nl: int, win: int):
    if not nl:
        return (HEAD if win else 0), 0
    first = (nl & -nl).bit_length() - 1
    last = nl.bit_length() - 1
    f = NL | (HEAD if win & ((1 << first) - 1) else 0) | \
        (TAIL if win >> last else 0)
    mid, prev, rest = 0, first, nl & (nl - 1)
    while rest:
        q = (rest & -rest).bit_length() - 1
        mid += bool(win & ((1 << q) - 1) & ~((1 << prev) - 1))
        prev, rest = q, rest & (rest - 1)
    return f, mid


def rows_of(s):
    return bool(s[0] & HEAD) + s[1] + bool(s[0] & NL and s[0] & TAIL)


def open_won(s):
    return bool(s[0] & TAIL) if s[0] & NL else bool(s[0] & HEAD)


def model_winner(c: Case, tabs: dict, a: int) -> int:
    """csrc/qgram_lines.cu's winner at anchor a, whose gram hash is a
    member, over tabs (b_off, b_tids, t_off, t_bytes)."""
    text, n, p = c.text, len(c.text), c.tb.p_size
    tr = c.tr
    bk = int(c.tables.hash_id[gram_hash(text, a, c.tb.long_)])
    s = a - (p - 1)
    for j in range(int(tabs["b_off"][bk + 1]) - 1, int(tabs["b_off"][bk]) - 1,
                   -1):
        tid = int(tabs["b_tids"][j])
        o = int(tabs["t_off"][tid])
        L = int(tabs["t_off"][tid + 1]) - o
        if s + L > n:
            continue
        if any(tr[text[s + k]] != tr[tabs["t_bytes"][o + k]]
               for k in range(L)):
            continue
        if c.wb:
            after = int(text[s + L]) if s + L < n else 0
            before = int(text[s - 1]) if s > 0 else 0
            if _alnum(after) or _alnum(before):
                continue
        return tid
    return -1


def _alnum(b: int) -> bool:
    return 48 <= b <= 57 or 97 <= (b | 32) <= 122


def gram_hash(text, a: int, long_) -> int:
    """The gram hash at anchor a; bytes before the text read as 0."""
    def b(i):
        return int(text[i]) & 31 if 0 <= i < len(text) else 0
    h = b(a) << 5 | b(a - 1)
    return (h << 5 | b(a - 2)) & 32767 if long_ else h


def scan_model(sums, threads: int):
    """Pass 2: each thread folds a run of ceil(len / threads) consecutive
    summaries, the threads' folds are scanned, and each thread writes its
    run's prefixes: (the exclusive prefixes, with the whole fold
    appended; the whole fold)."""
    per = -(-len(sums) // threads)
    runs = [sums[t * per:(t + 1) * per] for t in range(threads)]
    pre, excl = [], (0, 0)
    for run in runs:
        p = excl
        for x in run:
            pre.append(p)
            p = combine(p, x)
        excl = p
    return pre + [excl], excl


def kernel_model(c: Case, threads: int, words: int, grid: int = 2,
                 stats=None, scan_threads: int = 3):
    """csrc/qgram_lines.cu's three passes: tiles of threads * words plane
    words, block b taking tiles b, b + grid, ...; a thread's words' newline
    and exact member masks ANDed with the plane and the valid positions;
    each candidate walked by the thread that found it; a thread's fold of
    its words, the tile's of its threads; the tiles' exclusive prefixes;
    and from pass 1's masks each row tile's thread prefixes and rows walk,
    one winner a row.  Returns (count, [(anchor, term id)]); stats (a
    dict) gets the walks and the most one thread made in a tile."""
    text, N, p = c.text, len(c.text), c.tb.p_size
    plane = c.plane.numpy().view(np.uint32)
    member = c.tables.member.numpy().view(np.uint32)
    n_words = len(plane)
    tabs = {k: getattr(c.tables, k).numpy() for k in ("b_off", "b_tids",
                                                       "t_off", "t_bytes")}
    tile_words = threads * words
    tiles = -(-n_words // tile_words)
    assert tiles == t_qgram.lines_tiles(N, tile_words)
    nlm = np.zeros(n_words, dtype=np.int64)
    winm = np.zeros(n_words, dtype=np.int64)
    sums = [None] * tiles
    st = stats if stats is not None else {}
    st.update(walks=0, most=0)

    def thread_masks(w0):
        out = []
        for w in range(w0, w0 + words):
            nl = mem = cand = 0
            for r in range(32):
                a = 32 * w + r
                nl |= int(a < N and text[a] == 0x0A) << r
                h = gram_hash(text, a, c.tb.long_)
                mem |= ((int(member[h >> 5]) >> (h & 31)) & 1) << r
            if w < n_words:
                cand = int(plane[w]) & mem
                for r in range(32):
                    if not (p - 1 <= 32 * w + r < N):
                        cand &= ~(1 << r)
            out.append((nl, cand))
        return out

    for b in range(grid):
        for tile in range(b, tiles, grid):
            masks = [thread_masks(tile * tile_words + t * words)
                     for t in range(threads)]
            win = [0] * tile_words
            for t in range(threads):
                mine = 0
                for k, (_nl, cand) in enumerate(masks[t]):
                    w = tile * tile_words + t * words + k
                    for r in range(32):
                        if not (cand >> r) & 1:
                            continue
                        mine += 1
                        if model_winner(c, tabs, 32 * w + r) >= 0:
                            win[t * words + k] |= 1 << r
                st["walks"] += mine
                st["most"] = max(st["most"], mine)
            tile_sum = (0, 0)
            for t in range(threads):
                s = None
                for k, (nl, _cand) in enumerate(masks[t]):
                    w = tile * tile_words + t * words + k
                    ws = word_sum(nl, win[t * words + k])
                    s = ws if s is None else combine(s, ws)
                    if w < n_words:
                        nlm[w], winm[w] = nl, win[t * words + k]
                tile_sum = combine(tile_sum, s)
            sums[tile] = tile_sum
    pre, acc = scan_model(sums, scan_threads)
    rows = []
    for tile in range(tiles):
        if rows_of(pre[tile + 1]) == rows_of(pre[tile]):
            continue
        mine = pre[tile]
        for t in range(threads):
            w0 = tile * tile_words + t * words
            ws = [(int(nlm[w]), int(winm[w])) if w < n_words else (0, 0)
                  for w in range(w0, w0 + words)]
            won, o = open_won(mine), rows_of(mine)
            assert o == len(rows)
            for k, (nl, wn) in enumerate(ws):
                for q_ in range(32):
                    if (nl >> q_) & 1:
                        won = False
                    if (wn >> q_) & 1 and not won:
                        a = 32 * (w0 + k) + q_
                        rows.append((a, model_winner(c, tabs, a)))
                        won = True
            for nl, wn in ws:
                mine = combine(mine, word_sum(nl, wn))
    return rows_of(acc), rows


def _want(c: Case, plane=None):
    rows, k = t_qgram.qgram_lines_reference(
        c.t, c.plane if plane is None else plane, c.tables)
    return k, [tuple(r) for r in rows.tolist()]


@pytest.mark.parametrize("threads,rounds", [(1, 1), (2, 3), (4, 1)])
@pytest.mark.parametrize("name", ["s0_2gram", "s2_long_i_w", "edge_w",
                                  "head_tail", "empty_lines", "one_line"])
def test_kernel_model_equals_the_plain_version(name, threads, rounds):
    """rounds: the words a thread owns."""
    c = Case(*CASES[name])
    if len(c.text) > 2000:
        c = Case(CASES[name][0], CASES[name][1][:2000], *CASES[name][2:])
    assert kernel_model(c, threads, rounds) == _want(c)


@pytest.mark.parametrize("grid", [1, 2, 3])
@pytest.mark.parametrize("name", ["s1_long", "s3_2gram_i", "edge_long_w",
                                  "edge_i"])
def test_kernel_model_every_bit_set(name, grid):
    """Every bit of the plane set, so that every member hit is a
    candidate and a thread walks many in one tile."""
    c = Case(*CASES[name])
    c = Case(CASES[name][0], CASES[name][1][:1500], *CASES[name][2:])
    c.plane = torch.full_like(c.plane, -1)
    st = {}
    assert kernel_model(c, 4, 2, grid, stats=st) == _want(c, c.plane)
    assert st["most"] > 2


def test_kernel_model_word_of_32_candidates():
    """A word whose 32 positions are all member hits and winners."""
    terms = [b"aa", b"ab", b"zzz"]
    c = Case(terms, b"a" * 100 + b"\n" + b"ab" * 40 + b"\nzz\n", False,
             False)
    w1 = int(c.plane[1]) & 0xFFFFFFFF
    assert w1 == 0xFFFFFFFF
    st = {}
    assert kernel_model(c, 2, 2, stats=st) == _want(c)
    assert st["most"] >= 32


@pytest.mark.parametrize("wb", [False, True], ids=["plain", "w"])
@pytest.mark.parametrize("n_terms", [400, 1500])
def test_kernel_model_large_term_sets(n_terms, wb):
    """Hundreds to over a thousand terms (buckets of many terms, term
    tables of many KB, read where the wrapper gives them)."""
    rng = np.random.default_rng(n_terms + wb)
    terms = _words(rng, n_terms, 6, 12)
    # whole words: the terms beside other words, so that -w passes too
    toks = [terms[i] for i in rng.integers(0, n_terms, 40)] + \
        _words(rng, 80, 2, 12)
    text = b"".join(t + (b"\n" if rng.random() < 0.2 else b" ")
                    for t in rng.permutation(np.array(toks, dtype=object)))
    c = Case(terms, text, False, wb)
    assert c.tables.t_bytes.numel() > 8 * n_terms
    want = _want(c)
    assert want[0] > 0
    assert kernel_model(c, 4, 2) == want


@pytest.mark.parametrize("threads", [1, 3, 64, 1024])
def test_scan_model_equals_the_running_fold(threads):
    """Pass 2's runs (fewer summaries than threads, too) give every
    summary's exclusive prefix."""
    rng = np.random.default_rng(threads)
    sums = [word_sum(int(nl), int(win)) for nl, win in
            zip(rng.integers(0, 1 << 32, 300, dtype=np.uint64)
                & rng.integers(0, 1 << 32, 300, dtype=np.uint64),
                rng.integers(0, 1 << 32, 300, dtype=np.uint64)
                & rng.integers(0, 1 << 32, 300, dtype=np.uint64))]
    want, acc = [], (0, 0)
    for x in sums:
        want.append(acc)
        acc = combine(acc, x)
    assert scan_model(sums, threads) == (want + [acc], acc)


def test_the_fold_is_associative():
    rng = np.random.default_rng(5)
    sums = [word_sum(int(nl), int(win)) for nl, win in
            zip(rng.integers(0, 1 << 32, 200, dtype=np.uint64)
                & rng.integers(0, 1 << 32, 200, dtype=np.uint64),
                rng.integers(0, 1 << 32, 200, dtype=np.uint64)
                & rng.integers(0, 1 << 32, 200, dtype=np.uint64))]
    sums += [(0, 0), (HEAD, 0), (NL, 0), (NL | TAIL, 3)]
    for _ in range(500):
        x, y, z = (sums[i] for i in rng.integers(0, len(sums), 3))
        assert combine(combine(x, y), z) == combine(x, combine(y, z))


# ---------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------

def test_wrapper_checks_and_launches_nothing_on_the_cpu():
    c = Case(*CASES["edge"])
    before = dict(t_qgram.launches)
    rows, k = t_qgram.qgram_lines(c.t, c.plane, c.tables)
    assert k > 0 and rows.shape == (k, 2)
    assert t_qgram.launches == before
    with pytest.raises(TypeError):
        t_qgram.qgram_lines(c.t, c.plane[:-1], c.tables)
    with pytest.raises(TypeError):
        t_qgram.qgram_lines(c.t.long(), c.plane, c.tables)
    with pytest.raises(ValueError):
        t_qgram.qgram_lines(c.t[:0], c.plane[:0], c.tables)
    with pytest.raises(ValueError):
        t_qgram.qgram_lines(torch.from_numpy(np.repeat(c.text, 2))[::2],
                            c.plane, c.tables)
    with pytest.raises(ValueError):
        t_qgram.line_tables(np.zeros(256, bool), np.zeros(256, np.int32),
                            *c.csr, c.tr, 1, False, False)


# ---------------------------------------------------------------------
# the CLI, past the chain caps
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("qgram_lines")
    out = {"a": _write_corpus(d / "a.txt", 4000, seed=17),
           "b": _write_corpus(d / "b.txt", 3000, seed=18),
           "small": _write_corpus(d / "small.txt", 300, seed=19)}
    path = d / "p600w.txt"
    path.write_bytes("".join(p + "\n" for p in _patterns_600_wide())
                     .encode("latin-1"))
    out["p600w"] = str(path)
    return out


def _run(api, argv):
    buf = io.BytesIO()
    ret = api.fileagrep(argv, output=buf)
    return buf.getvalue(), ret & 0xFF


@pytest.fixture
def calls(monkeypatch):
    """Calls of the stage, of the q-gram filter, of whatever reads
    candidates back or verifies them on the host, and of the host count."""
    seen = {}

    def wrap(mod, name):
        real = getattr(mod, name)

        def counted(*a, **k):
            seen[name] = seen.get(name, 0) + 1
            return real(*a, **k)
        monkeypatch.setattr(mod, name, counted)

    for mod, name in ((t_qgram, "qgram_lines"), (t_qgram, "qgram_filter"),
                      (t_chain, "plane_positions"), (t_chain, "chain_scan"),
                      (t_native, "qgram_occ_at"),
                      (t_native, "qgram_first_per_line"),
                      (t_mgrep.MgrepEngine, "_all_occurrences")):
        wrap(mod, name)
    return seen


RUNS = {
    "c": (["-c"], ["a"]),
    "c_i": (["-c", "-i"], ["a"]),
    "c_w": (["-c", "-w"], ["a"]),
    "c_files": (["-c"], ["a", "small", "b"]),
    # agrep refuses -n with -f: the print form is the lines alone
    "print": ([], ["a"]),
    "l": (["-l"], ["b", "small", "a"]),
    "print_files": ([], ["small", "b"]),
}


@pytest.mark.parametrize("stream_mb", [None, "0"], ids=["whole", "over_mb"])
@pytest.mark.parametrize("case", list(RUNS))
def test_cli_past_the_caps_takes_qgram_lines(files, calls, monkeypatch, case,
                                             stream_mb):
    if stream_mb is not None:
        monkeypatch.setenv("AGREP_TORCH_STREAM_MB", stream_mb)
        monkeypatch.setenv("AGREP_TPU_STREAM_MB", stream_mb)
    flags, names = RUNS[case]
    argv = flags + ["-f", files["p600w"]] + [files[k] for k in names]
    calls.clear()
    got = _run(t_api, argv)
    seen = dict(calls)
    assert got == _run(j_api, argv), argv
    assert got[0]
    # a streamed print takes its file's route a chunk: one chunk here
    n_dev = sum(1 for k in names if k != "small")
    assert seen.get("qgram_lines", 0) == n_dev, seen
    assert seen.get("qgram_filter", 0) == n_dev, seen
    for name in ("plane_positions", "qgram_occ_at", "chain_scan"):
        assert name not in seen, seen
    count = "-c" in flags
    if count:
        assert "_all_occurrences" not in seen, seen
    # under 64 KiB the host's native pass takes the file
    if n_dev:
        assert seen.get("qgram_first_per_line", 0) == len(names) - n_dev, \
            seen


def test_cli_counts_lines_that_hold_several_matches(files):
    """The 600-term set matches several times on many of the corpus's
    lines: the count is of lines, not of matches."""
    terms = [p.encode("latin-1") for p in _patterns_600_wide()]
    text = np.fromfile(files["a"], dtype=np.uint8)
    c = Case(terms, text.tobytes(), False, False)
    occ = j_multi.qgram_occurrences(c.text, terms, c.tr, c.tb)
    n_occ = len(np.unique(np.concatenate(list(occ.values()))))
    k = t_qgram.qgram_lines(c.t, c.plane, c.tables, count_only=True)[1]
    assert n_occ > 2 * k > 0
    assert k == c.native(count_only=True)
