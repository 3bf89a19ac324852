"""The lanes kernel's Next tables and line walk, and the q-gram kernel's
word-a-thread walk, proved on the CPU.

csrc/renfa_lanes.cu builds its Next tables in each block from the four
byte tables the machine carries (RegexMachine.tables rows 1-4) in one
of two forms -- one table of 2^(M-1) words with the head bit folded
in, or the byte tables themselves -- and walks
each line in aligned 16-byte pieces, funnel-shifting each 16 line bytes
out of two of them (bytes of a piece outside the text read one by one),
on a persistent grid whose warps take runs of 32 lines.  Its step
carries each state's nxt value and evaluates one nxt a level a byte,
since nxt(a | b) = nxt(a) | nxt(b).
csrc/qgram_filter.cu gives a thread one 32-position output word, read as
two (three when the text is not 16-byte aligned) aligned pieces, the
previous byte shuffled from the neighbouring lane, each bit formed by a
rotate of the member word and shifted into the output word.

The models below do exactly that in numpy and Python ints, with bytes
outside the text holding noise, and must give:

  * for the Next fill: next_tables_arrays' tables and the scalar nxt,
    for every machine of tests/test_torch_renfa.py and for M - 1 = 0, 1,
    15, 16, 28, 29 and 30;
  * for the line walk: the line's own bytes, loads only inside the
    text, and renfa_lines_reference's verdicts, at every start offset
    mod 16, lengths 0-40 around the pieces, a newline at the text's
    last byte, texts at every address mod 16; and each line of a launch
    taken once on the persistent grid;
  * for the q-gram walk: qgram_reference's plane, and agrep_tpu's Pallas
    q-gram kernel run in interpret mode, at every N mod 32 and texts at
    every address mod 16.

The kernels themselves are held against the plain versions by
chip_smoke.py on the GPU.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from agrep_tpu.ops import qgram_kernel as j_qgram
from agrep_tpu_torch.compile import multi as t_multi
from agrep_tpu_torch.compile.query import compile_query as t_compile
from agrep_tpu_torch.ops import qgram_kernel as t_qgram
from agrep_tpu_torch.ops import renfa as t_renfa
from agrep_tpu_torch.ops import renfa_kernel as t_rk
from agrep_tpu_torch.options import Options as TOptions
from agrep_tpu_torch.runtime.mgrep import _fold_tr
from tests.test_torch_renfa import MACHINES

U32 = 0xFFFFFFFF


def _funnel_r(lo, hi, s):
    """__funnelshift_r: the low word of hi:lo shifted right by s & 31."""
    return ((((hi & U32) << 32) | (lo & U32)) >> (s & 31)) & U32


# ---------------------------------------------------------------------
# machines
# ---------------------------------------------------------------------

def _compiled(pattern, d, nocase=False):
    q = t_compile(pattern, TOptions(D=d, approx=d > 0,
                                    nocase="i" if nocase else None))
    assert q.engine_class == "regex"
    return q.re_mc


def _synthetic(M, D, seed, tail=True):
    """A machine of M positions with random follow bits, mask and no_err
    bits (compile_query makes no M below 3 and none above 29)."""
    rng = np.random.default_rng(seed)
    fb = np.zeros(33, dtype=np.uint32)
    fb[:M] = rng.integers(0, 1 << max(M, 1), M, dtype=np.uint64) \
        .astype(np.uint32)
    auto = SimpleNamespace(m=M, follow_bits=fb,
                           head_bit=1 << (M - 1) if M >= 1 else 1)
    mask = rng.integers(0, 1 << 32, 256, dtype=np.uint64).astype(np.uint32)
    no_err = int(rng.integers(0, 1 << 32)) | 1
    return t_renfa.machine_from_automaton(auto, mask, no_err, D, True, tail)


# (name, re_mc): every machine of tests/test_torch_renfa.py, compiled
# machines of 16 and 17 positions (M - 1 = 15 and 16, either side of the
# one-table form's edge) and of 31 (a '?' counts as a position: only the
# byte tables take it), and synthetic ones at M = 1, 2 and 30
FILL_MACHINES = (
    [("%s_D%d%s" % (p, d, "_i" if i else ""), functools.partial(
        _compiled, p, d, i)) for p, d, i in MACHINES]
    + [("M16", functools.partial(_compiled, "abcdefghijkl(m|n)", 2)),
       ("M17", functools.partial(_compiled, "abcdefghijklm(n|o)", 1)),
       ("M31", functools.partial(_compiled,
                                 "abcdefghijklmnopqrstuvwx(y|z)?0?", 1))]
    + [("synthetic_M%d" % M, functools.partial(_synthetic, M, M % 5, M))
       for M in (1, 2, 30)])


def _mc(name):
    return dict(FILL_MACHINES)[name]()


# ---------------------------------------------------------------------
# the Next fill
# ---------------------------------------------------------------------

def fill_model(m, form):
    """The block's Next tables from the machine's byte tables, as the
    kernel's fill<F> builds them."""
    t = m.tables.numpy().astype(np.int64)
    rel = max(m.M - 1, 0)

    def byte_nxt(s):
        return (t[1][s & 255] | t[2][(s >> 8) & 255]
                | t[3][(s >> 16) & 255] | t[4][s >> 24])

    if form == "one":
        return [m.head_bit | byte_nxt(np.arange(1 << rel) << 1)]
    return [t[1:5]]


def nxt_model(m, form, tabs):
    """The kernel's Next<F> over the tables of fill_model."""
    rel = max(m.M - 1, 0)
    mask = (1 << rel) - 1
    if form == "one":
        return lambda s: tabs[0][(s >> 1) & mask]
    t = tabs[0]
    return lambda s: (m.head_bit | t[0][s & 255] | t[1][(s >> 8) & 255]
                      | t[2][(s >> 16) & 255] | t[3][s >> 24])


@pytest.mark.parametrize("name", [n for n, _ in FILL_MACHINES])
def test_next_fill_equals_next_tables_and_scalar_nxt(name):
    mc = _mc(name)
    m = t_rk.machine_from_mc(mc, "cpu")
    rel = max(m.M - 1, 0)
    lo_tab = t_renfa.next_tables_arrays(mc)[0]
    rng = np.random.default_rng(len(name))
    states = rng.integers(0, 1 << 32, 400, dtype=np.int64)
    states[:3] = (0, U32, int(mc["init0"]))
    want = np.array([mc["nxt"](int(s)) for s in states], dtype=np.int64)
    forms = t_rk.forms(m.M)
    assert forms == (["one", "bytes"] if rel <= 15 else ["bytes"])
    assert t_rk.table_form(m.M) == forms[0]
    for form in forms:
        tabs = fill_model(m, form)
        if form == "one":
            # next_tables_arrays' one table, at most 2^15 words
            assert np.array_equal(tabs[0], lo_tab.astype(np.int64))
            assert len(tabs[0]) <= 1 << 15
        assert np.array_equal(nxt_model(m, form, tabs)(states), want), form


# ---------------------------------------------------------------------
# the line walk
# ---------------------------------------------------------------------

def _piece(mem, lo, hi, a, loads):
    """The kernel's piece(): four words of the 16 bytes at a."""
    if a >= lo and a + 16 <= hi:
        loads.append((a, 16))
        b = mem[a:a + 16]
    else:
        b = np.zeros(16, dtype=np.uint8)
        for k in range(16):
            if lo <= a + k < hi:
                loads.append((a + k, 1))
                b[k] = mem[a + k]
    return [int(x) for x in b.view("<u4")]


def _window(p, q, sh):
    """The kernel's window(): bytes sh .. sh + 15 of p:q as four words."""
    x = p + q
    y = [x[k + 2] if sh & 8 else x[k] for k in range(6)]
    z = [y[k + 1] if sh & 4 else y[k] for k in range(5)]
    return [_funnel_r(z[k], z[k + 1], 8 * (sh & 3)) for k in range(4)]


def line_walk(mem, lo, hi, s0, length):
    """The bytes of the line at address s0 in the order the kernel's
    thread steps them, the newline byte, and every load it makes."""
    loads = []
    sh = s0 & 15
    a = s0 - sh
    zero = [0, 0, 0, 0]
    e = s0 + length

    def load(x):
        # a piece is loaded when it holds a byte of the line
        return _piece(mem, lo, hi, x, loads) if x < e else zero

    cur, nx = load(a), load(a + 16)
    out = []
    j = 0
    while j + 16 <= length:
        ahead = load(a + 32)
        w = _window(cur, nx, sh)
        out += [(w[b >> 2] >> (8 * (b & 3))) & 255 for b in range(16)]
        a += 16
        cur, nx = nx, ahead
        j += 16
    if j < length:
        w = _window(cur, nx, sh)
        out += [(w[b >> 2] >> (8 * (b & 3))) & 255
                for b in range(length - j)]
    loads.append((s0 + length, 1))
    return out, int(mem[s0 + length]), loads


def walk_verdicts(text, starts, lens, m, form, init, base):
    """Verdicts of csrc/renfa_lanes.cu's thread walk over the lines,
    the text placed `base` bytes past a 16-byte boundary in memory
    whose other bytes are noise; asserts the bytes walked are the
    line's and that no load leaves the text."""
    n = len(text)
    mem = np.random.default_rng(base).integers(0, 256, n + 64,
                                               dtype=np.uint8)
    lo, hi = 32 + base, 32 + base + n
    mem[lo:hi] = text
    cm = m.tables[0].numpy().astype(np.int64)
    nxt = nxt_model(m, form, fill_model(m, form))
    init1, noerr, D = m.init1, m.no_err, m.D
    out = []
    for s, ln in zip(starts.tolist(), lens.tolist()):
        got, nl, loads = line_walk(mem, lo, hi, lo + s, ln)
        assert got == text[s:s + ln].tolist(), (base, s, ln)
        assert all(lo <= a and a + w <= hi for a, w in loads), (base, s)
        # each piece once, and only pieces that hold a byte of the line
        # (or, for an empty line, the piece below it)
        pieces = [a & ~15 for a, w in loads[:-1]]
        assert len(set(a for a, w in loads[:-1])) == len(loads) - 1
        assert all(p < lo + s + max(ln, 1) for p in pieces), (base, s)
        # the kernel's step: the states and their nxt values, one nxt a
        # level a byte (nxt(a | b) = nxt(a) | nxt(b))
        st = [int(v) & U32 for v in init]
        nx = [int(nxt(v)) for v in st]
        for b in got:
            c = int(cm[b])
            new = [(nx[0] & c) | (init1 & st[0])]
            nn = [int(nxt(new[0]))]
            for k in range(1, D + 1):
                new.append((nx[k] & c)
                           | ((st[k - 1] | nx[k - 1] | nn[k - 1]) & noerr)
                           | (init1 & st[k]))
                nn.append(int(nxt(new[k])))
            st, nx = new, nn
        c = int(cm[nl])
        ad = (nx[D] & c) | (init1 & st[D])
        if m.tail:
            ad |= int(nxt(ad))
        out.append(bool(ad & 1))
    return np.array(out)


def _walk_lines(seed):
    """Lines of lengths 0-40 and random ones, line i starting at i mod
    16, the regex plants among them, and a last line whose newline is
    the text's last byte."""
    rng = np.random.default_rng(seed)
    plants = [b"approximate", b"aproxmation", b"abbbc", b"hellello",
              b"abcdefghijklmn", b"abcdefghijklmnopqrstuvwxy0"]
    lens = np.concatenate([np.arange(41), rng.integers(0, 41, 23)])
    text = bytearray()
    starts = []
    for i, ln in enumerate(lens.tolist()):
        # bytes between lines, so that line i starts at i mod 16
        text += b"x" * ((i - len(text)) % 16)
        starts.append(len(text))
        line = bytearray(rng.integers(97, 123, ln, dtype=np.uint8))
        p = plants[i % len(plants)]
        if len(p) <= ln:
            off = 0 if i % 2 else ln - len(p)
            line[off:off + len(p)] = p
        text += line + b"\n"
    text = np.frombuffer(bytes(text), np.uint8).copy()
    starts = np.array(starts, dtype=np.int64)
    assert len(set((starts % 16).tolist())) == 16
    assert starts[-1] + lens[-1] == len(text) - 1
    return text, starts, lens.astype(np.int64)


WALK_MACHINES = ["appro[a-z]*mat(e|ion)_D2", "appro[a-z]*mat(e|ion)_D4",
                 "ab*c_D0", "h(el)*lo_D1_i",
                 "abcdefghijklmnopqrstuvwxy(z|0)_D3", "M16", "M17", "M31",
                 "synthetic_M1", "synthetic_M30"]


@pytest.mark.parametrize("name", WALK_MACHINES)
def test_line_walk_gives_the_reference_verdicts(name):
    mc = _mc(name)
    m = t_rk.machine_from_mc(mc, "cpu")
    text, starts, lens = _walk_lines(len(name))
    cont, _ = t_renfa.step_newline(list(mc["inits"]),
                                   int(mc["mask"][0x0A]), mc)
    tt, st, ln = (torch.from_numpy(text), torch.from_numpy(starts),
                  torch.from_numpy(lens))
    n_true = 0
    for init in (cont, list(mc["inits"])):
        want = t_rk.renfa_lines_reference(tt, st, ln, m, init).numpy()
        n_true += int(want.sum())
        forms = t_rk.forms(m.M)
        for k, form in enumerate(forms):
            # the walk depends on the text's address mod 16: take them
            # all across the forms
            for base in range(k, 16, len(forms)):
                got = walk_verdicts(text, starts, lens, m, form, init, base)
                assert np.array_equal(got, want), (form, base)
    # random machines, and M31, whose tables the '?' misaligns as the
    # reference's do, need not match these lines
    if not name.startswith("synthetic") and name != "M31":
        assert n_true


def grid_visits(R, threads, grid):
    """How often the persistent grid's threads take each of R lines:
    warp w takes the runs of 32 lines w, w + warps, ..."""
    seen = np.zeros(R, dtype=np.int64)
    warps = grid * threads // 32
    n_runs = -(-R // 32)
    for warp in range(warps):
        for run in range(warp, n_runs, warps):
            r = np.arange(run * 32, min(run * 32 + 32, R))
            seen[r] += 1
    return seen


@pytest.mark.parametrize("R,threads,blocks", [
    (1, 256, 6), (31, 128, 1), (33, 256, 3), (4097, 512, 1),
    (20000, 128, 1), (684929, 256, 3)])
def test_persistent_grid_takes_every_line_once(R, threads, blocks):
    sms = 132
    grid = max(1, min(-(-R // threads), blocks * sms))
    assert grid * threads // 32 >= 1
    assert np.all(grid_visits(R, threads, grid) == 1)


# ---------------------------------------------------------------------
# the q-gram walk
# ---------------------------------------------------------------------

def qgram_model(text, words, sh):
    """Plane (int32 words) of csrc/qgram_filter.cu over text placed sh
    bytes past a 16-byte boundary in noise: a thread a word, vectorized
    over every word."""
    n = len(text)
    n_words = -(-n // 32)
    mem = np.random.default_rng(sh + 1).integers(0, 256, n + 96,
                                                 dtype=np.uint8)
    lo, hi = 32 + sh, 32 + sh + n
    mem[lo:hi] = text
    w = np.arange(n_words)
    a = lo + 32 * w - sh
    assert np.all(a % 16 == 0)
    pieces = []
    for k in range(3 if sh else 2):
        addr = (a + 16 * k)[:, None] + np.arange(16)
        full = (a + 16 * k >= lo) & (a + 16 * k + 16 <= hi)
        inside = (addr >= lo) & (addr < hi)
        assert np.all(inside[full])         # a 16-byte load stays inside
        b = np.where(inside, mem[np.clip(addr, 0, len(mem) - 1)], 0)
        pieces.append(b.astype(np.uint8).copy().view("<u4").astype(np.int64))
    v = np.concatenate(pieces, axis=1)           # [n_words, 8 or 12]
    if sh == 0:
        x = v
    else:
        y = v[:, 2:12] if sh & 8 else v[:, 0:10]
        z = y[:, 1:10] if sh & 4 else y[:, 0:9]
        x = _funnel_r(z[:, :8], z[:, 1:9], 8 * (sh & 3))
    # previous byte: lane - 1's last byte; lane 0 loads its own
    rot = np.zeros(n_words, dtype=np.int64)
    rot[1:] = x[:-1, 7] >> 24
    lane0 = (w % 32 == 0) & (w > 0)
    rot[lane0] = text[32 * w[lane0] - 1]
    rot[0] = 0
    sw = np.asarray(words.numpy(), dtype=np.int64) & U32
    res = np.zeros(n_words, dtype=np.int64)
    for i in range(8):
        c4 = (x[:, i] & 0x1F1F1F1F) << 2
        for k in range(4):
            m = sw[((c4 >> (8 * k)) & 0xFF) >> 2]
            res = _funnel_r(res, _funnel_r(m, m, rot), 1)
            rot = x[:, i] >> (8 * k)
    left = n - 32 * w
    res = np.where(left < 32, res & ((1 << np.minimum(left, 32)) - 1), res)
    return np.where(res >= 1 << 31, res - (1 << 32), res).astype(np.int32)


def _qgram_sets():
    rng = np.random.default_rng(6)

    def words(k, lo, hi):
        return [bytes(rng.integers(97, 123, int(rng.integers(lo, hi)))
                      .astype(np.uint8)) for _ in range(k)]
    return {"two_gram": (words(30, 3, 7), False),
            "long": (words(60, 5, 11), False),
            "nocase": (words(30, 3, 7), True)}


QGRAM_SETS = _qgram_sets()
# every N mod 32 (and so mod 16), short texts and ones past 4 KB
QGRAM_SIZES = list(range(1, 34)) + list(range(4065, 4098))


@pytest.mark.parametrize("case", list(QGRAM_SETS))
def test_qgram_word_walk_equals_reference_and_pallas(case):
    terms, fold = QGRAM_SETS[case]
    tr = _fold_tr(fold)
    tb = t_multi.build_qgram_tables(terms, tr)
    proj = t_multi.member_projection_1024(tb)
    words = t_qgram.words_tensor(proj)
    rng = np.random.default_rng(len(case))
    stream = rng.integers(0, 256, 4097, dtype=np.uint8)
    stream[::3] = rng.integers(97, 123, len(stream[::3]))
    for t in terms:
        off = int(rng.integers(0, len(stream) - len(t)))
        stream[off:off + len(t)] = np.frombuffer(t, np.uint8)
    pallas = j_qgram.qgram_candidates(stream, proj, interpret=True)
    assert len(pallas)
    for i, n in enumerate(QGRAM_SIZES):
        text = stream[:n]
        want = t_qgram.qgram_reference(torch.from_numpy(text), words)
        sh = i % 16
        got = qgram_model(text, words, sh)
        assert np.array_equal(got, want.numpy()), (n, sh)
        pos = t_qgram.plane_positions(torch.from_numpy(got), n)
        assert np.array_equal(pos, pallas[pallas < n]), (n, sh)
    # the whole stream at every address mod 16
    want = t_qgram.qgram_reference(torch.from_numpy(stream), words).numpy()
    for sh in range(16):
        assert np.array_equal(qgram_model(stream, words, sh), want), sh
