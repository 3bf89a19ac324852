"""The record cut straight from mask_scan's planes (csrc/record_verdicts.cu),
on the CPU.

  * the decomposition the kernel stands on: a Python model of its
    word-at-a-time fold (a 32-position stream word into a summary by bit
    arithmetic: the ends' popcount, the last end, the head's and tail's
    hits, the records among the ends after the first that fire), its
    combine under random bracketings, random cuts of the words into runs
    (the kernel's blocks, warps and lanes), each run's prefix seeded with
    a carried acc, and the walk that writes each run's rows from its
    prefix, against pair_records_reference over event_pairs_reference's
    pairs of the same planes: random planes with bits in the halo columns
    and past N, keep_from of 0, W and an odd value, skip_pos on a hit, on
    an end, on neither and at -1, and_flag and invert, a non-zero acc;
  * record_verdicts on the planes of mask_scan_reference (the CPU route)
    against agrep_tpu's event walk over its numpy scan, for
    test_torch_record_verdicts.py's SCAN_ARGVS, whole and in random
    chunks, each with a halo it drops through keep_from;
  * the grid and the capacities the wrappers plan (kernels.plane_grid,
    pairs_capacity, rows_capacity).

Every value is an integer, so every comparison is exact.  The CUDA kernel
is held against record_verdicts_reference by chip_smoke.py on the GPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from agrep_tpu.ops import scan as j_scan
from agrep_tpu_torch.ops import kernels as t_kernels
from agrep_tpu_torch.ops import scan as t_scan

from .test_torch_record_verdicts import SCAN_ARGVS, _query, _text, walk

M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------
# a model of the kernel's fold, combine and walk
# ---------------------------------------------------------------------

def fires(acc, endpos, and_flag, invert):
    if and_flag:
        return (acc & endpos) == endpos or invert
    return (acc != 0) != invert


def combine(a, b, f):
    """The summary (n, fired, last, head, tail) of run a then run b."""
    n = a[0] + b[0]
    fired = a[1] + b[1] + (1 if a[0] and b[0] and f(a[4] | b[3]) else 0)
    return (n, fired, b[2] if b[0] else a[2],
            a[3] if a[0] else a[3] | b[3], b[4] if b[0] else a[4] | b[4])


IDENTITY = (0, 0, -1, 0, 0)


def upto(b):
    """Bits 0 .. b (b in -1 .. 31)."""
    return (2 << b) - 1 & M32 if b >= 0 else 0


def word_of(planes, vals, W, L, N, keep_from, skip_pos, d_endpos, g):
    """As the kernel loads stream word g: each plane's kept bits with
    skip_pos's cleared, the events (skip_pos's counted) and the ends."""
    T, nw = planes.shape[1:]
    t, j0 = 32 * g // L, W + 32 * g % L
    lo = max(keep_from - 32 * g, 0)
    hi = min(N - 32 * g, 32)
    km = (upto(hi - 1) & ~upto(lo - 1)) if hi > lo else 0
    keep = M32 ^ (1 << (skip_pos - 32 * g)) \
        if 0 <= skip_pos - 32 * g < 32 else M32
    bits, anyb, e = [], 0, 0
    for i, v in enumerate(vals):
        if not v:
            continue
        row = planes[i, t]
        pair = int(row[j0 >> 5]) | (int(row[(j0 >> 5) + 1]) << 32
                                    if j0 & 31 else 0)
        b = (pair >> (j0 & 31)) & M32 & km
        anyb |= b
        if v & d_endpos:
            e |= b
        bits.append((b & keep, v))
    return bits, bin(anyb).count("1"), e & keep


def hits(bits, mask, endpos):
    h = 0
    for b, v in bits:
        if b & mask:
            h |= v
    return h & endpos


def fold_word(bits, e, p0, endpos, f):
    """The kernel's fold of one word whose first position is p0; a word
    without a hit takes its short form, held here to the long one."""
    if not hits(bits, M32, endpos):
        n = bin(e).count("1")
        short = (n, (n - 1) * f(0) if n else 0,
                 p0 + e.bit_length() - 1 if n else -1, 0, 0)
        assert short == fold_long(bits, e, p0, endpos, f)
        return short
    return fold_long(bits, e, p0, endpos, f)


def fold_long(bits, e, p0, endpos, f):
    if not e:
        h = hits(bits, M32, endpos)
        return (0, 0, -1, h, h)
    hi = e.bit_length() - 1
    prev = (e & -e).bit_length() - 1
    fired, m = 0, e & (e - 1)
    while m:
        b = (m & -m).bit_length() - 1
        fired += f(hits(bits, upto(b) & ~upto(prev), endpos))
        prev, m = b, m & (m - 1)
    return (bin(e).count("1"), fired, p0 + hi,
            hits(bits, e ^ (e - 1), endpos),
            hits(bits, M32 & ~upto(hi), endpos))


def fold_bracketed(sums, f, rng):
    """The sums combined in order under a random bracketing."""
    if not sums:
        return IDENTITY
    if len(sums) == 1:
        return sums[0]
    k = int(rng.integers(1, len(sums)))
    return combine(fold_bracketed(sums[:k], f, rng),
                   fold_bracketed(sums[k:], f, rng), f)


def model(planes, vals, W, L, N, keep_from, endpos, d_endpos, skip_pos,
          and_flag, invert, acc, rng):
    """The kernel's two phases over random cuts of the words into runs:
    (rows, (ends, last, acc after it, events)), and how many lanes of 8
    words took the short form."""
    f = lambda a: fires(a, endpos, and_flag, invert)     # noqa: E731
    g_lo, g_hi = keep_from // 32, -(-N // 32)
    words = {g: word_of(planes, vals, W, L, N, keep_from, skip_pos,
                        d_endpos, g) for g in range(g_lo, g_hi)}
    cuts = sorted(set(rng.integers(g_lo, g_hi + 1, 6).tolist())
                  | {g_lo, g_hi})
    runs = list(zip(cuts, cuts[1:]))
    # phase 1: each run's summary and events
    sums = [fold_bracketed([fold_word(words[g][0], words[g][2], 32 * g,
                                      endpos, f) for g in range(a, b)],
                           f, rng) for a, b in runs]
    events = sum(w[1] for w in words.values())
    # a lane's 8 words without a hit take the kernel's short form
    shorts = 0
    for g in range(g_lo, g_hi - 7):
        lane = [words[k] for k in range(g, g + 8)]
        if any(hits(b, M32, endpos) for b, _ev, _e in lane):
            continue
        n = sum(bin(e).count("1") for _b, _ev, e in lane)
        last = max((32 * (g + i) + e.bit_length() - 1
                    for i, (_b, _ev, e) in enumerate(lane) if e), default=-1)
        short = (n, (n - 1) * f(0) if n else 0, last, 0, 0)
        assert short == fold_bracketed(
            [fold_word(b, e, 32 * (g + i), endpos, f)
             for i, (b, _ev, e) in enumerate(lane)], f, rng)
        shorts += 1
    # phase 2: each run's prefix, seeded, then its words walked
    rows = []
    pre = (0, 0, -1, acc & endpos, acc & endpos)
    for (a, b), s in zip(runs, sums):
        r = pre
        for g in range(a, b):
            bits, _ev, e = words[g]
            ord_, prev = r[0], r[2]
            out = r[1] + (1 if r[0] and f(r[3]) else 0)
            assert out == len(rows)
            cur, lo, m = r[4], -1, e
            while m:
                bit = (m & -m).bit_length() - 1
                cur |= hits(bits, upto(bit) & ~upto(lo), endpos)
                if f(cur):
                    rows.append((ord_, 32 * g + bit, prev))
                ord_, prev, cur, lo, m = (ord_ + 1, 32 * g + bit, 0, bit,
                                          m & (m - 1))
            r = combine(r, fold_word(bits, e, 32 * g, endpos, f), f)
            assert r[4] == cur | hits(bits, M32 & ~upto(lo), endpos)
        pre = combine(pre, s, f)
        assert pre == r
    return rows, (pre[0], pre[2], pre[4], events), shorts


def random_planes(rng, N, W, L, shares):
    """u32 planes [len(shares), T, n_words] with each column's bit set
    with its plane's share: the halo columns, the columns past the tile
    and the positions past N too."""
    T, nw = t_kernels.geometry(N, W, L)
    cols = rng.random((len(shares), T, 32 * nw)) < np.asarray(
        shares)[:, None, None]
    return np.packbits(cols, axis=-1, bitorder="little").view(np.uint32)


@pytest.mark.parametrize("skip", ["hit", "end", "neither", "none"])
@pytest.mark.parametrize("keep", ["zero", "W", "odd"])
@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("and_flag", [False, True])
def test_model_of_the_word_fold_equals_the_pair_cut(and_flag, invert, keep,
                                                    skip):
    W, L = 40, 256
    N = 3 * L + 77
    keep_from = {"zero": 0, "W": W, "odd": 77}[keep]
    endpos, d_endpos = 0x2A, 0x400
    # the delimiter plane; three hit planes, one also a delimiter; a
    # plane of noise bits; a plane of value 0
    vals = [d_endpos, 0x2, 0x8, 0x20 | d_endpos, 0x00F00000, 0]
    rng = np.random.default_rng(
        [and_flag, invert, ["zero", "W", "odd"].index(keep),
         ["hit", "end", "neither", "none"].index(skip)])
    planes = random_planes(rng, N, W, L, [0.03, 0.06, 0.06, 0.04, 0.2, 0.5])
    planes[1:4, 1] = 0                  # a tile without a hit
    pt = torch.from_numpy(planes)
    vt = torch.from_numpy(np.asarray(vals, dtype=np.uint32))
    pos, word = t_kernels.event_pairs_reference(pt, vt, W, L, N, keep_from)
    p, w = pos.numpy(), word.numpy().astype(np.int64)
    candidates = {
        "hit": p[(w & endpos != 0) & (w & d_endpos == 0)],
        "end": p[w & d_endpos != 0],
        "neither": np.setdiff1d(np.arange(keep_from, N), p),
        "none": np.asarray([-1]),
    }[skip]
    skip_pos = int(candidates[len(candidates) // 2])
    acc = 0x8
    want_rows, want_sum = t_kernels.pair_records_reference(
        pos, word, endpos, d_endpos, skip_pos, and_flag, invert, acc)
    want = ([tuple(r) for r in want_rows.tolist()],
            want_sum + (len(pos),))
    assert want[0], "no record fired -- test is vacuous"
    for trial in range(3):
        rows, summary, shorts = model(planes, vals, W, L, N, keep_from,
                                      endpos, d_endpos, skip_pos, and_flag,
                                      invert, acc, rng)
        assert (rows, summary) == want and shorts
    rows, summary = t_kernels.record_verdicts_reference(
        pt, vt, W, L, N, keep_from, endpos, d_endpos, skip_pos, and_flag,
        invert, acc)
    assert ([tuple(r) for r in rows.tolist()], summary) == want


# ---------------------------------------------------------------------
# the CPU route against agrep_tpu's event walk
# ---------------------------------------------------------------------

@pytest.fixture
def _numpy_reference():
    saved = j_scan._BACKEND
    j_scan.set_backend("numpy")
    yield
    j_scan.set_backend(saved)


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("name", list(SCAN_ARGVS))
def test_planes_route_matches_agrep_tpu(_numpy_reference, name, invert):
    """record_verdicts over mask_scan_reference's planes of the whole
    stream, and of random chunks (each with its machine's halo of real
    bytes before it, dropped through keep_from, and the carry of the
    chunks before it), against the walk over agrep_tpu's events."""
    q = _query(name)
    c = q.consts
    L = 256
    W = t_scan._halo(c, q.D, L)
    text = _text(9001, len(name) + 17)
    events = j_scan.scan_events(text, q.folded_mask, c, q.D, "bitap",
                                q.costs)
    pos = np.flatnonzero(events)
    skip_pos = int(pos[len(pos) // 3])
    endpos, d_endpos = int(c["endpos"]), int(c["d_endpos"])
    want, want_sum = walk(pos.tolist(), events[pos].tolist(), endpos,
                          d_endpos, skip_pos, q.and_flag, invert)
    assert want, "no record fired -- test is vacuous"
    m = t_kernels.machine_from_arrays(q.folded_mask, c, q.D, "bitap",
                                      q.costs)
    vals = torch.from_numpy(np.asarray(t_kernels.event_vals(m),
                                       dtype=np.uint32))
    args = (endpos, d_endpos)

    def cut(lo, g0, g1, acc):
        planes = t_kernels.mask_scan(torch.from_numpy(text[lo:g1].copy()),
                                     m, W, L)
        return t_kernels.record_verdicts(
            planes, vals, W, L, g1 - lo, g0 - lo, *args,
            skip_pos - lo if skip_pos >= lo else -1, q.and_flag, invert,
            acc)

    rows, summary = cut(0, 0, len(text), 0)
    assert [tuple(r) for r in rows.tolist()] == want
    assert summary == want_sum + (len(pos),)
    rng = np.random.default_rng(len(name))
    cuts = np.unique(rng.integers(1, len(text), 7))
    got, acc, base, last, n_events = [], 0, 0, -1, 0
    for g0, g1 in zip(np.r_[0, cuts], np.r_[cuts, len(text)]):
        lo = max(0, int(g0) - W)
        rows, (n, c_last, acc, ev) = cut(lo, int(g0), int(g1), acc)
        for k, end, prev in rows.tolist():
            got.append((k + base, end + lo, prev + lo if prev >= 0
                        else last))
        if n:
            last = c_last + lo
        base += n
        n_events += ev
    assert got == want
    assert (base, last, acc) == want_sum and n_events == len(pos)


# ---------------------------------------------------------------------
# the wrappers' plans
# ---------------------------------------------------------------------

@pytest.mark.parametrize("step", [32, 256])
@pytest.mark.parametrize("max_blocks", [1, 7, 264])
@pytest.mark.parametrize("N,keep_from", [(1, 0), (33, 31), (4097, 1000),
                                         (32 << 20, 0), (100 << 20, 48)])
def test_plane_grid_covers_the_words_with_no_idle_block(N, keep_from,
                                                        max_blocks, step):
    threads = 512
    warps = threads // 32
    grid, warp_words = t_kernels.plane_grid(N, keep_from, threads,
                                            max_blocks, step)
    words = -(-N // 32) - keep_from // 32
    assert 1 <= grid <= max_blocks and warp_words % step == 0
    assert grid * warps * warp_words >= words
    assert (grid - 1) * warps * warp_words < words
    assert t_kernels.plane_grid(N, N, threads, max_blocks, step) == (0, 0)


def test_capacities():
    assert t_kernels.pairs_capacity(32 << 20, 0) == 2 << 20
    assert t_kernels.pairs_capacity(100, 0) == t_kernels.PAIRS_MIN
    assert t_kernels.pairs_capacity(100, 200) == t_kernels.PAIRS_MIN
    assert t_kernels.rows_capacity(32 << 20) == 32 << 10
    assert t_kernels.rows_capacity(1000) == t_kernels.ROWS_MIN
    assert t_kernels.rows_capacity(32 << 20, 232) == t_kernels.ROWS_MIN
    assert t_kernels.rows_capacity(32 << 20, 600_000) == 1_200_000
