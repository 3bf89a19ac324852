"""A Python model of line_rows' one cooperative launch
(agrep_tpu_torch/csrc/line_rows.cu), held on the CPU to the plain
version and to agrep_tpu's regex engine, exactly.

The model transcribes the kernel's index arithmetic, block by block and
lane by lane, at any geometry (threads a block, blocks, rows a warp's
stage, bitmap steps kept in registers):

  * the launch-order walk: 16 verdicts a piece, loaded from the 16-byte
    aligned address below the verdicts (the bytes outside them junk and
    masked), invert, the kept range [first, end), an ordinal outside
    0..K-1 skipped;
  * count form: each block's sum, then block 0's sum of the blocks';
  * rows form: phase 0 zeroes a bitmap that starts as junk, phase 1 sets
    a bit a firing line, phase 2 each block's popcount over its warps'
    runs of bitmap words (a block an equal run, a warp an equal run of
    its block's), phase 3 the offsets before each block and warp, a
    warp-shuffle scan a 32-word step, each lane's rows' ordinals into
    the warp's stage in order, then the rows built from the stage into
    an output of K rows that starts as junk.

It runs at 1, 2 and 3 blocks of 32 threads, at blocks of 2 and 4 warps,
and at the kernel's own geometry (its constants read from the source),
on the edge shapes: K = 1, K around a piece, a word and a block's share,
every line or none firing (R = K under -v), first/end cuts, a glitch
byte, ordinals outside 0..K-1, verdicts 1-15 bytes past an aligned
address, and more bitmap steps a warp than the kernel keeps in
registers.
The verdicts come from a numpy seed.  The kernel itself runs only on the
card, where chip_smoke.py holds it to the plain version.
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

from agrep_tpu_torch.ops import renfa_kernel as t_rk
from agrep_tpu_torch.ops import scan as t_scan

from .test_torch_line_rows import np_walk

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "agrep_tpu_torch", "csrc", "line_rows.cu")
JUNK = -7


def kernel_constants() -> dict:
    """The constexpr ints of csrc/line_rows.cu."""
    with open(CSRC) as fh:
        return {k: int(v) for k, v in re.findall(
            r"constexpr int (k\w+) = (\d+);", fh.read())}


K_CONST = kernel_constants()
THREADS, PIECE = K_CONST["kThreads"], K_CONST["kPiece"]
STAGE, KEPT = K_CONST["kStage"], K_CONST["kKeptSteps"]
# the count form's blocks an H100 holds at once (its answer on the card:
# two blocks of 512 threads an SM; the rows form's 96 KB of stages take
# one, 132)
MAX_BLOCKS = 264


def popc(x: int) -> int:
    return bin(x).count("1")


def walk_piece(mem, a, g, ords, K, invert, first, end, fire):
    """walk_piece: piece g of the verdicts, mem the aligned bytes (v
    starts at mem[a])."""
    m = 0
    for b, byte in enumerate(mem[PIECE * g:PIECE * g + PIECE]):
        m |= int(byte != 0) << b
    if invert:
        m = ~m & 0xFFFF
    i0 = PIECE * g - a
    if i0 < 0:
        m &= (0xFFFF << -i0) & 0xFFFF
    left = K - i0
    if left < PIECE:
        m &= (1 << left) - 1
    for b in range(PIECE):
        if m >> b & 1:
            j = int(ords[i0 + b])
            if first <= j < end:
                fire(j)


def rows_model(v, a, ords, nl, invert, first, end, glitch, rows, threads,
               grid, stage=STAGE, rng=None):
    """The kernel's launch over verdicts v (bool [K]) placed a bytes past
    a 16-byte aligned address: (rows [R, 3] or None, R)."""
    rng = rng or np.random.default_rng(0)
    K = len(v)
    assert K >= 1 and threads % 32 == 0
    warps_a_block = threads // 32
    # v's bytes with junk around them, from the aligned address below
    mem = rng.integers(0, 256, -(-(K + a) // PIECE) * PIECE,
                       dtype=np.uint8)
    mem[a:a + K] = np.asarray(v, dtype=np.uint8)
    pieces = -(-(K + a) // PIECE)
    stride = grid * threads
    scratch = [JUNK] * (grid + 1)
    walk = (ords, K, invert, first, end)
    if not rows:
        for blk in range(grid):
            fired = []
            for t in range(threads):
                for g in range(blk * threads + t, pieces, stride):
                    walk_piece(mem, a, g, *walk, fired.append)
            scratch[blk] = len(fired)
        scratch[grid] = sum(scratch[:grid])
        return None, scratch[grid]

    words = -(-K // 32)
    bits = [int(x) for x in rng.integers(0, 1 << 32, words)]
    # phase 0, then phase 1
    for tid in range(stride):
        for w in range(tid, words, stride):
            bits[w] = 0

    def fire(j):
        bits[j >> 5] |= 1 << (j & 31)
    for tid in range(stride):
        for g in range(tid, pieces, stride):
            walk_piece(mem, a, g, *walk, fire)
    # phase 2: a block an equal run of words, a warp an equal run of its
    # block's
    block_words = 32 * -(-words // (32 * grid))
    warp_words = 32 * -(-block_words // (32 * warps_a_block))
    runs, s_warp = {}, {}
    for blk in range(grid):
        b1 = min((blk + 1) * block_words, words)
        for warp in range(warps_a_block):
            w0 = blk * block_words + warp * warp_words
            w1 = min(w0 + warp_words, b1)
            steps = -(-(w1 - w0) // 32) if w0 < w1 else 0
            runs[blk, warp] = (w0, w1, steps)
            s_warp[blk, warp] = sum(
                popc(bits[w]) for s in range(steps) for w in
                range(w0 + 32 * s, min(w0 + 32 * s + 32, w1)))
        scratch[blk] = sum(s_warp[blk, w] for w in range(warps_a_block))
    # phase 3
    out = np.full((K, 3), JUNK, dtype=np.int64)

    def unglitch(q):
        return q - (glitch >= 0 and q > glitch)
    for blk in range(grid):
        o = sum(scratch[:blk])
        s_off = []
        for warp in range(warps_a_block):
            s_off.append(o)
            o += s_warp[blk, warp]
        if blk == grid - 1:
            scratch[grid] = o
        for warp in range(warps_a_block):
            if not s_warp[blk, warp]:
                continue
            w0, w1, steps = runs[blk, warp]
            o = s_off[warp]
            for s in range(steps):
                # lane l's word (kept in registers for the first
                # kKeptSteps steps, reloaded after: the same word); 0
                # past the run
                m = [bits[w] if w < w1 else 0
                     for w in (w0 + 32 * s + lane for lane in range(32))]
                n = [popc(x) for x in m]
                x = np.cumsum(n).tolist()
                total = x[31]
                # each lane's rows are the step's [x - n, x), in order:
                # its remaining bits and next row carry across stages
                left = list(m)
                k = [x[lane] - n[lane] for lane in range(32)]
                for lo in range(0, total, stage):
                    sj = np.full(stage, JUNK, dtype=np.int64)
                    for lane in range(32):
                        while left[lane] and k[lane] < lo + stage:
                            b = (left[lane] & -left[lane]).bit_length() - 1
                            sj[k[lane] - lo] = 32 * (w0 + 32 * s + lane) + b
                            left[lane] &= left[lane] - 1
                            k[lane] += 1
                    cnt = min(stage, total - lo)
                    srow = np.full(3 * stage, JUNK, dtype=np.int64)
                    for q in range(cnt):
                        j = int(sj[q])
                        srow[3 * q:3 * q + 3] = (
                            j, unglitch(int(nl[j - 1]) + 1) if j else 0,
                            unglitch(int(nl[j])))
                    flat = out.reshape(-1)
                    flat[3 * (o + lo):3 * (o + lo + cnt)] = srow[:3 * cnt]
                o += total
    R = scratch[grid]
    assert (out[R:] == JUNK).all()
    return torch.from_numpy(out[:R].copy()), R


def kernel_grid(K: int) -> int:
    return t_rk.rows_blocks(K, THREADS, PIECE, MAX_BLOCKS)


def text_of(rng, K: int, glitch_at: int | None = None):
    """(text bytes with K lines of 0-8 letters, glitch position or -1,
    the glitch byte inserted at glitch_at when given)."""
    lens = rng.integers(0, 9, K)
    text = b"".join(bytes(rng.integers(97, 123, int(n), dtype=np.uint8))
                    + b"\n" for n in lens)
    if glitch_at is None:
        return text, -1
    at = min(glitch_at, len(text) - 1)
    return text[:at] + b"\x00" + text[at:], at


def index_of(text: bytes):
    t = torch.from_numpy(np.frombuffer(text, np.uint8).copy())
    return t_rk.line_index_reference(t)


def check(v, idx, args, threads, grid, a, rng, **kw):
    """The model in both forms against line_rows_reference."""
    ords, nl = idx.ords, idx.nl
    want_rows, want_n = t_rk.line_rows_reference(v, ords, nl, *args)
    got_rows, got_n = rows_model(v.numpy(), a, ords.numpy(), nl.numpy(),
                                 *args, True, threads, grid, rng=rng, **kw)
    assert got_n == want_n
    assert got_rows.tolist() == want_rows.tolist()
    none, n = rows_model(v.numpy(), a, ords.numpy(), nl.numpy(), *args,
                         False, threads, grid, rng=rng, **kw)
    assert none is None and n == want_n
    return got_rows


GEOMETRIES = [(32, 1), (32, 2), (32, 3), (64, 2), (128, 3), "kernel"]
GEO_IDS = ["32x1", "32x2", "32x3", "64x2", "128x3", "kernel"]
LINE_COUNTS = [1, 2, 15, 16, 17, 33, 511, 512, 513, 3 * 512 + 17]


def _geometry(geo, K):
    return (THREADS, kernel_grid(K)) if geo == "kernel" else geo


@pytest.mark.parametrize("geo", GEOMETRIES, ids=GEO_IDS)
@pytest.mark.parametrize("K", LINE_COUNTS)
def test_model_matches_the_plain_version(geo, K):
    """Random verdicts, every cut and alignment, with and without invert
    and a glitch byte, both forms."""
    rng = np.random.default_rng(K * 7 + len(str(geo)))
    text, glitch = text_of(rng, K, glitch_at=K * 2)
    idx = index_of(text)
    assert idx.nl.numel() == K
    threads, grid = _geometry(geo, K)
    v = torch.from_numpy(rng.random(K) < 0.3)
    for invert in (False, True):
        for first, end in ((0, K), (1, K), (2, max(K - 1, 0))):
            for gl in (-1, glitch):
                a = int(rng.integers(0, 16))
                check(v, idx, (invert, first, end, gl), threads, grid, a,
                      rng)


@pytest.mark.parametrize("geo", GEOMETRIES, ids=GEO_IDS)
@pytest.mark.parametrize("drop_first", [False, True])
@pytest.mark.parametrize("appended", [False, True])
@pytest.mark.parametrize("invert", [False, True])
def test_model_matches_the_engine_walk(geo, drop_first, appended, invert):
    """The model's rows and count against np_walk, agrep_tpu's regex
    engine on one chunk transcribed, with the engine's guards as the
    kept range."""
    rng = np.random.default_rng(2 * drop_first + appended + 4 * invert)
    K = 700
    text, glitch = text_of(rng, K, glitch_at=1000)
    idx = index_of(text)
    threads, grid = _geometry(geo, K)
    stream_v = rng.random(K) < 0.3
    v = torch.from_numpy(stream_v[idx.ords.numpy()])
    want = np_walk(text, glitch, stream_v, invert, drop_first, appended)
    args = (invert, 1 if drop_first else 0, K - 1 if appended else K,
            glitch)
    rows = check(v, idx, args, threads, grid, int(rng.integers(0, 16)),
                 rng)
    assert [tuple(r) for r in rows.tolist()] == want


@pytest.mark.parametrize("geo", GEOMETRIES, ids=GEO_IDS)
@pytest.mark.parametrize("fill", [False, True])
def test_model_every_line_or_none(geo, fill):
    """Verdicts all false or all true: under -v or without, every kept
    line fires (R = K: the stages split, every warp full) or none does."""
    rng = np.random.default_rng(11 + fill)
    K = 3 * 512 + 17
    text, glitch = text_of(rng, K, glitch_at=500)
    idx = index_of(text)
    threads, grid = _geometry(geo, K)
    v = torch.full((K,), fill)
    for invert in (False, True):
        for a in (0, 1, 15):
            rows = check(v, idx, (invert, 0, K, glitch), threads, grid, a,
                         rng)
            assert rows.shape[0] == (K if fill != invert else 0)


@pytest.mark.parametrize("geo", GEOMETRIES, ids=GEO_IDS)
def test_model_skips_ordinals_outside_the_lines(geo):
    rng = np.random.default_rng(5)
    K = 513
    text, _ = text_of(rng, K)
    idx = index_of(text)
    bad = idx.ords.clone()
    bad[::7] = -1
    bad[3::11] = K
    idx = idx._replace(ords=bad)
    threads, grid = _geometry(geo, K)
    v = torch.from_numpy(rng.random(K) < 0.5)
    for invert in (False, True):
        check(v, idx, (invert, 0, K, -1), threads, grid, 3, rng)


@pytest.mark.parametrize("threads,grid,K", [(32, 1, 5000), (64, 1, 9000),
                                            (32, 2, 9000)])
def test_model_walks_many_steps_a_warp(threads, grid, K):
    """A warp's run of more 32-word steps than kKeptSteps (the kernel
    reloads the later words out of the bitmap), many pieces a thread."""
    rng = np.random.default_rng(K)
    text, glitch = text_of(rng, K, glitch_at=K)
    idx = index_of(text)
    words = -(-K // 32)
    block_words = 32 * -(-words // (32 * grid))
    steps = -(-block_words // (32 * (threads // 32)))
    assert steps > KEPT
    v = torch.from_numpy(rng.random(K) < 0.6)
    check(v, idx, (False, 1, K, glitch), threads, grid, 7, rng)


def test_model_small_stages_split_a_step():
    rng = np.random.default_rng(3)
    K = 1000
    text, glitch = text_of(rng, K, glitch_at=77)
    idx = index_of(text)
    v = torch.from_numpy(rng.random(K) < 0.9)
    for stage in (1, 5, 31):
        check(v, idx, (False, 0, K, glitch), 64, 2, 9, rng, stage=stage)


def test_kernel_geometry_and_grid():
    """The source's constants as the model takes them, and the wrapper's
    grid: one piece a thread at most, no more blocks than the device
    holds, at least one."""
    assert THREADS % 32 == 0 and PIECE == 16 and STAGE > 0 and KEPT > 0
    assert kernel_grid(1) == 1
    assert kernel_grid(THREADS * PIECE) == 1
    assert kernel_grid(THREADS * PIECE + 1) == 2
    assert kernel_grid(684_929) == 84            # config 4's window
    assert kernel_grid(2_140_406) == 262         # memagrep4's buffer
    assert kernel_grid(10 ** 8) == MAX_BLOCKS


def test_wrapper_on_cpu_takes_the_plain_version():
    """A CPU tensor goes to line_rows_reference: no launch, the same
    rows and count, K = 0 included."""
    saved = (t_scan._BACKEND, t_scan._DEVICE)
    t_scan.set_device("cpu")
    try:
        rng = np.random.default_rng(9)
        text, glitch = text_of(rng, 40, glitch_at=60)
        idx = index_of(text)
        v = torch.from_numpy(rng.random(40) < 0.5)
        before = dict(t_rk.launches)
        for want in (True, False):
            got = t_rk.line_rows(v, idx.ords, idx.nl, True, 1, 39, glitch,
                                 want)
            ref = t_rk.line_rows_reference(v, idx.ords, idx.nl, True, 1, 39,
                                           glitch, want)
            assert got[1] == ref[1]
            assert (got[0] is None) == (not want)
            if want:
                assert got[0].tolist() == ref[0].tolist()
        empty = torch.empty(0, dtype=torch.int64)
        rows, n = t_rk.line_rows(torch.empty(0, dtype=torch.bool), empty,
                                 empty, False, 0, 0)
        assert n == 0 and tuple(rows.shape) == (0, 3)
        assert t_rk.launches == before
    finally:
        t_scan._BACKEND, t_scan._DEVICE = saved
