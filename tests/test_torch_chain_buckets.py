"""The chain kernel's program layout and tile walk, proved on the CPU.

csrc/chain_scan.cu stages each tile of TILE start positions with its
halo from the 16-byte aligned address at or below the tile's first
byte (bytes outside the text as 0), translates it to class ids into a
class buffer that skips one word after every eight (bit 7 of a class id
flags a class that has a one-byte term, NO_CLASS counts as class n_cls),
and gives each lane 32 consecutive positions, read as nine words.  A
position is a candidate when a bitmap over its class and the next two
(the next one only, past 31 classes) says a term starts with them or
its first class has a one-byte term; a candidate matches at once when
its class is flagged, else when a term of its pair bucket in
device_program's prefix-sum table matches.
kernel_model() below does exactly that with the same tables (every
tile and lane at once, in numpy; raw-buffer bytes the kernel never
staged hold noise), and its start plane must equal chain_scan_reference's
bit for bit, and agrep_tpu's Pallas chain kernel run in interpret mode,
on:

  * the term sets of tests/test_torch_mgrep.py (whose plain version that
    file holds against the Pallas kernel on the same inputs);
  * one-byte terms beside longer ones, a set at the TPU's 96-class cap,
    terms of 128 bytes ending at byte N - 1 (tests/test_torch_chain_caps.py
    runs the model on programs up to the port's caps);
  * N = 1, 2, 15-17, 31-33, 4095-4097 and TILE's edges, and texts that
    start 0-15 bytes past a 16-byte boundary.

The kernel itself is held against chain_scan_reference by chip_smoke.py
on the GPU, on unaligned views too.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from agrep_tpu.ops import chain_kernel as j_chain
from agrep_tpu_torch.ops import chain_kernel as t_chain
from agrep_tpu_torch.ops.chain_kernel import NO_CLASS, TILE
from tests.test_torch_mgrep import CHAIN_CASES, port_form

SINGLE = 0x80           # the kernel's flag: the class has a one-byte term


def halo(maxlen: int) -> int:
    """Bytes a tile reads past its last start position."""
    return max(maxlen, 2) - 1


def stage_slack(maxlen: int) -> int:
    """Bytes a raw buffer holds past its tile: the halo, up to 15 bytes
    before the tile's first byte, 15 of round-up to whole chunks and the
    word the translation reads past the class words, 16-byte aligned."""
    return (halo(maxlen) + 32 + 15) & ~15


def kernel_model(text: np.ndarray, p, tile: int = TILE,
                 offset: int = 0) -> np.ndarray:
    """Start plane (int32 words) of p over text as csrc/chain_scan.cu
    computes it, the text placed `offset` bytes past a 16-byte
    boundary."""
    N, C = len(text), p.n_cls
    stride = C + 1
    class_of = p.class_of.numpy().astype(np.int64)
    single = p.single.numpy().astype(np.int64)
    term = p.term_cls.numpy().astype(np.int64)
    off = p.term_off.numpy().astype(np.int64)
    pair = p.pair.numpy().astype(np.int64)
    assert len(pair) == stride ** 2 + 1 and len(single) == C
    # the block's program: NO_CLASS -> C, one-byte classes flagged; the
    # pair bitmap
    smap = np.where(class_of == NO_CLASS, C,
                    class_of | SINGLE * single[np.minimum(class_of, C - 1)])
    sterm = term | SINGLE * single[term]
    # the candidate bitmap over (c0, c1, c2): the classes a term starts
    # with (three when narrow, two when wide), anything after a term's
    # last class, anything after a one-byte term's class
    narrow = C < 32
    bitmap = np.zeros((stride, stride, stride), dtype=bool)
    for t in range(int(pair[-1])):
        s3 = term[off[t]:off[t + 1]]
        if narrow and len(s3) > 2:
            bitmap[s3[0], s3[1], s3[2]] = True
        else:
            bitmap[s3[0], s3[1], :] = True
    bitmap[np.flatnonzero(single)] = True
    # staging: each tile's 16-byte chunks into its raw buffer
    slack = stage_slack(p.maxlen)
    span = tile + halo(p.maxlen)
    n_tiles = -(-N // tile)
    g0 = np.arange(n_tiles) * tile
    a0 = (offset + g0) & ~15
    shift = offset + g0 - a0
    chunks = (shift + span + 15) >> 4
    mem = np.zeros(offset + n_tiles * tile + 2 * slack, np.uint8)
    mem[offset:offset + N] = text
    col = np.arange(tile + slack)[None, :]
    noise = np.random.default_rng(N).integers(0, 256, (n_tiles, col.size))
    raw = np.where(col < 16 * chunks[:, None], mem[a0[:, None] + col], noise)
    # translation into the class buffer: class word w of the tile at
    # word w + w // 8, the skipped words noise
    n_cw = (tile + halo(p.maxlen) + 3) // 4 + 1
    assert (shift + 4 * n_cw + 4 <= tile + slack).all()
    assert (16 * chunks <= tile + slack).all()
    b = np.arange(4 * n_cw)
    cls = np.random.default_rng(N + 1).integers(
        0, stride, (n_tiles, 4 * (n_cw + n_cw // 8 + 1)))
    cls[:, b + 4 * (b // 32)] = smap[raw[np.arange(n_tiles)[:, None],
                                         shift[:, None] + b]]

    def class_at(j):                     # j: [tiles, ...] positions
        return np.take_along_axis(cls, (j + 4 * (j >> 5)).reshape(
            n_tiles, -1), 1).reshape(j.shape)

    # each lane: words 9 r + m (m < 8) and 9 r + 9 of row r, 33 bytes
    r = np.arange(tile // 32)
    words = np.concatenate([9 * r[:, None] + np.arange(8)[None, :],
                            9 * r[:, None] + 9], axis=1)        # [rows, 9]
    idx = (4 * words[:, :, None] + np.arange(4)).reshape(len(r), 36)
    lane = cls[:, idx] & ~SINGLE                    # [tiles, rows, 36]
    cand = bitmap[lane[:, :, :32], lane[:, :, 1:33], lane[:, :, 2:34]]
    j = (32 * r[:, None] + np.arange(32)[None, :])[None].repeat(n_tiles, 0)
    lim = np.minimum(N - g0, tile)[:, None, None]
    cand &= j < lim
    # the candidates: a flagged class, else the pair bucket's terms
    c0 = class_at(j)
    hit = cand & ((c0 & SINGLE) != 0)
    pq = (c0 & ~SINGLE) * stride + (class_at(j + 1) & ~SINGLE)
    lo, hi = pair[pq], pair[pq + 1]
    todo = cand & ~hit
    for k_t in range(int(np.where(todo, hi - lo, 0).max())):
        ok = todo & ~hit & (lo + k_t < hi)
        t = np.where(ok, lo + k_t, 0)
        o, e = off[t], off[t + 1]
        for k in range(2, p.maxlen):
            cmp = ok & (o + k < e)      # early exit: mismatches drop out
            if not cmp.any():
                break
            want = sterm[np.minimum(o + k, p.n_pos - 1)]
            ok &= ~cmp | (class_at(np.minimum(j + k, span - 1)) == want)
        hit |= ok
    bits = hit.reshape(-1)[:N]
    return t_chain.pack_bits(torch.from_numpy(bits)).numpy()


def starts(words: np.ndarray, N: int) -> np.ndarray:
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.flatnonzero(bits[:N]).astype(np.int64)


@pytest.fixture(scope="module")
def pallas():
    """agrep_tpu's chain_match_starts in interpret mode, its kernel
    factory memoised per program (a pure function of the program), so
    that one compile serves every text of one set."""
    orig = j_chain._get_chain_kernel
    j_chain._get_chain_kernel = functools.cache(orig)
    try:
        yield lambda text, prog: j_chain.chain_match_starts(
            text, prog, interpret=True)
    finally:
        j_chain._get_chain_kernel = orig


def ident_tr():
    return np.arange(256, dtype=np.uint8)


def _u8(b: bytes) -> np.ndarray:
    return np.frombuffer(b, dtype=np.uint8).copy()


def _plant(text: np.ndarray, terms, rng, k: int = 3) -> np.ndarray:
    for t in terms:
        if len(t) < len(text):
            for at in rng.integers(0, len(text) - len(t), k):
                text[at:at + len(t)] = _u8(t)
    return text


# one-byte terms beside longer ones, NUL-ended terms running into the pad
EDGE_TERMS = [b"q", b"ab", b"abc", b"ba\n", b"\n", b"c\x00", b"bb\x00\x00",
              b"cab" * 5]


def _edge_text(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + n)
    return _plant(rng.choice(_u8(b"abc \n"), n), EDGE_TERMS, rng, 2)


def _cap96_terms() -> list:
    """Every byte 32..127 (96 classes) in terms of 2-7 bytes, a few of
    them one byte long, and two 128-byte terms."""
    rng = np.random.default_rng(96)
    order = rng.permutation(np.arange(32, 128, dtype=np.uint8))
    terms, i = [], 0
    while i < len(order):
        k = int(rng.integers(2, 8))
        terms.append(bytes(order[i:i + k]))
        i += k
    terms += [bytes([c]) for c in (33, 64, 126)]
    terms += [bytes(rng.integers(32, 128, 128).astype(np.uint8))
              for _ in range(2)]
    return terms


CAP96 = _cap96_terms()


def _cap96_text(n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    return _plant(rng.integers(0, 256, n).astype(np.uint8), CAP96, rng, 2)


LONG = [bytes(np.random.default_rng(128).choice(_u8(b"xy"), 128)),
        b"y" * 128]


def _long_end_text(n: int) -> np.ndarray:
    """A text over x and y whose last 128 bytes are LONG[0]."""
    rng = np.random.default_rng(n)
    s = rng.choice(_u8(b"xy"), n)
    s[n - 128:] = _u8(LONG[0])
    return s


EDGE_SIZES = (1, 2, 15, 16, 17, 31, 32, 33, 4095, 4096, 4097,
              TILE - 1, TILE, TILE + 1, 2 * TILE + 129)
CASES = {
    **{"mgrep_" + k: f for k, f in CHAIN_CASES.items()},
    **{"edge_n%d" % n: (lambda n=n: (_edge_text(n), EDGE_TERMS, ident_tr()))
       for n in EDGE_SIZES},
    **{"cap96_n%d" % n: (lambda n=n: (_cap96_text(n), CAP96, ident_tr()))
       for n in (200, 4097, TILE + 77)},
    **{"long128_end_n%d" % n: (lambda n=n: (_long_end_text(n), LONG,
                                            ident_tr()))
       for n in (128, 129, 4097, TILE + 3)},
}


@pytest.mark.parametrize("case", list(CASES))
def test_model_equals_reference(case):
    text, terms, tr = CASES[case]()
    prog = t_chain.compile_chain(terms, tr)
    assert prog is not None
    p = t_chain.device_program(prog)
    want = t_chain.chain_scan_reference(torch.from_numpy(text), p).numpy()
    assert np.array_equal(kernel_model(text, p), want)
    if case.startswith("long128"):
        assert len(text) - 128 in starts(want, len(text))


@pytest.mark.parametrize("offset", range(16))
def test_model_unaligned_text(offset):
    """A text that starts `offset` bytes past a 16-byte boundary: the
    first and last chunks of a tile straddle its ends."""
    for n, tile in ((17, 1024), (4097, 1024), (TILE + 5, TILE)):
        text = _edge_text(n, offset)
        p = t_chain.device_program(t_chain.compile_chain(EDGE_TERMS,
                                                         ident_tr()))
        want = t_chain.chain_scan_reference(torch.from_numpy(text), p)
        assert np.array_equal(kernel_model(text, p, tile, offset),
                              want.numpy()), (n, tile)


@pytest.mark.parametrize("make,terms,sizes", [
    (_edge_text, EDGE_TERMS, EDGE_SIZES),
    # the 96 classes without the 128-byte terms: the Pallas kernel's
    # four-word lookahead over 96 equality planes takes a minute to build
    (_cap96_text, CAP96[:-2], (4097,)),
    (_long_end_text, LONG, (129, TILE + 3)),
], ids=["edges", "cap96", "long128_end"])
def test_model_equals_pallas_interpret(pallas, make, terms, sizes):
    prog = t_chain.compile_chain(terms, ident_tr())
    j_prog = j_chain.compile_chain(terms, ident_tr())
    assert prog == port_form(j_prog)
    p = t_chain.device_program(prog)
    if make is _cap96_text:
        assert p.n_cls == 96
    for n in sizes:
        text = make(n)
        got = starts(kernel_model(text, p), n)
        assert np.array_equal(got, pallas(text, j_prog)), n
        assert len(got) > 0


@pytest.mark.parametrize("name,terms", [
    ("edges", EDGE_TERMS), ("cap96", CAP96), ("long128_end", LONG),
    ("hundred", CHAIN_CASES["hundred"]()[1]),
], ids=["edges", "cap96", "long128_end", "hundred"])
def test_device_program_tables(name, terms):
    """Every term of two or more classes lies in its pair's bucket and
    nowhere else, the one-byte terms come after them and flag their
    class; the pair table has (n_cls + 1)**2 + 1 entries."""
    prog = t_chain.compile_chain(terms, ident_tr())
    p = t_chain.device_program(prog)
    C = p.n_cls
    assert C == len(prog[0])
    pair = p.pair.numpy().astype(np.int64)
    off = p.term_off.numpy().astype(np.int64)
    cls = p.term_cls.numpy().tolist()
    specs = [tuple(cls[off[t]:off[t + 1]]) for t in range(p.n_terms)]
    assert sorted(specs) == sorted(set(prog[1]))
    multi = [s for s in specs if len(s) > 1]
    assert specs[:len(multi)] == multi
    assert len(pair) == (C + 1) ** 2 + 1
    assert (np.diff(pair) >= 0).all() and pair[-1] == len(multi)
    for t, s in enumerate(multi):
        q = s[0] * (C + 1) + s[1]
        assert pair[q] <= t < pair[q + 1]
    ones = {s[0] for s in specs if len(s) == 1}
    assert set(np.flatnonzero(p.single.numpy())) == ones
    if name == "cap96":
        assert C == 96 and len(pair) == 97 ** 2 + 1
        assert ones and p.maxlen == 128
