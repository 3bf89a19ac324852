"""Bit-parallel mask-table generation (reference maskgen.c:27-269).

Compiles the meta-byte pattern into the Wu-Manber shift-or tables:

    mask[256]    per-character position bitmask
    init0        initial state (prefix padding + separator bits)
    init1        sticky-bit mask (init0 | wildmask | endposition)
    endposition  check mask: last-char bit of every pattern part
    d_endpos     record-boundary bit (last char of the delimiter part)
    no_err_mask  positions where error transitions are allowed
    wildmask     '#' wildcard positions

Bit convention is the reference's: position k of M occupies bit
1 << (WORD - (WORD - M + k)) == 1 << (M - k); the automaton advances by
shifting *right*.  All words are uint32.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import codepage as cp
from ..options import AgrepError, PROGNAME

WORD = 32
U32 = 0xFFFFFFFF


def _bit(k: int) -> int:
    """Bit[k] of the reference: 1 << (WORD - k), Bit[WORD] == 1."""
    return (1 << (WORD - k)) & U32


@dataclass
class Position:
    """One pattern position: a character class plus flags."""
    pairs: list = field(default_factory=list)  # [(lo, hi), ...] byte pairs
    compl: bool = False                        # [^...] complement
    separator: bool = False                    # ANDPAT/ORPAT marker
    no_err: bool = False                       # inside a <>-zone / guard


@dataclass
class MaskTables:
    mask: np.ndarray          # uint32[256], pre-fold
    m: int                    # number of positions
    init0: int
    init1: int
    endposition: int
    d_endpos: int
    no_err_mask: int
    wildmask: int
    and_flag: bool
    or_flag: bool
    positions: list           # list[Position], 1-indexed semantics, 0-based list
    d_length: int


def maskgen(pattern: bytes, D: int, d_length: int, nocase: bool,
            regex: bool = False) -> MaskTables:
    """Build mask tables for a compiled meta-byte pattern."""
    pat = bytearray(pattern)
    if nocase:
        # non-EMX build folds the pattern with ASCII tolower only
        # (maskgen.c:56-58); codepage folding happens via the text LUT.
        for i, b in enumerate(pat):
            pat[i] = cp.tolower_ascii(b)

    positions: list[Position] = []
    wildmask = 0
    endposition = 0
    no_err_marks = 0
    no_error = False
    even = 0
    and_flag = False
    or_flag = False

    def bit_j(j: int) -> int:
        return _bit(j)

    i = 0
    M = len(pat)
    j = 1  # next position index (1-based, like maskgen.c:68)
    while i < M:
        pp = pat[i]
        if pp == cp.WILDCD:
            if regex:
                positions.append(Position(pairs=[(ord("."), ord("."))]))
                j += 1
            wildmask |= bit_j(j - 1)
        elif pp == cp.LANGLE:
            no_error = True
            even += 1
        elif pp == cp.RANGLE:
            no_error = False
            even -= 1
            if even < 0:
                raise AgrepError(
                    "%s: unmatched '<', '>' (use \\<, \\> to search for <, >)"
                    % PROGNAME)
        elif pp == cp.LRANGE:
            if no_error:
                no_err_marks |= bit_j(j)
            posn = Position(no_err=no_error)
            i += 1
            if i < M and pat[i] == cp.NOTSYM:
                posn.compl = True
                i += 1
            while i < M and pat[i] != cp.RRANGE:
                if pat[i] == cp.HYPHEN:
                    if posn.pairs:
                        lo, _ = posn.pairs[-1]
                        posn.pairs[-1] = (lo, pat[i + 1] if i + 1 < M else 0)
                    i += 2
                else:
                    posn.pairs.append((pat[i], pat[i]))
                    i += 1
            if i == M:
                raise AgrepError(
                    "%s: unmatched '[', ']' (use \\[, \\] to search for [, ])"
                    % PROGNAME)
            positions.append(posn)
            j += 1
        elif pp == cp.RRANGE:
            raise AgrepError(
                "%s: unmatched '[', ']' (use \\[, \\] to search for [, ])"
                % PROGNAME)
        elif pp == cp.ORPAT:
            if regex or and_flag:
                raise AgrepError(
                    "illegal pattern: cannot handle OR (',') and AND (';')"
                    "/regular-expressions simultaneously")
            or_flag = True
            positions.append(Position(separator=True))
            endposition |= bit_j(j)
            j += 1
        elif pp == cp.ANDPAT:
            if j > d_length:
                and_flag = True
            if or_flag or (regex and j > d_length):
                raise AgrepError(
                    "illegal pattern: cannot handle AND (';') and OR (',')"
                    "/regular-expressions simultaneously")
            positions.append(Position(separator=True))
            endposition |= bit_j(j)
            j += 1
        elif pp == ord("\n"):
            no_err_marks |= bit_j(j)
            positions.append(Position(pairs=[(10, 10)], no_err=True))
            j += 1
        elif pp == cp.WORDB:
            no_err_marks |= bit_j(j)
            positions.append(Position(
                pairs=[(1, 47), (58, 64), (91, 96), (123, 127)],
                no_err=True))
            j += 1
        elif pp == cp.NNLINE:
            no_err_marks |= bit_j(j)
            positions.append(Position(
                pairs=[(10, 10), (cp.NNLINE, cp.NNLINE)], no_err=True))
            j += 1
        elif pp in (cp.STAR, cp.ORSYM, cp.LPARENT, cp.RPARENT):
            pass
        else:
            if no_error:
                no_err_marks |= bit_j(j)
            positions.append(Position(pairs=[(pp, pp)], no_err=no_error))
            j += 1
        if j > WORD:
            raise AgrepError(
                "%s: pattern too long (has > %d chars)" % (PROGNAME, WORD))
        i += 1

    if even != 0:
        raise AgrepError(
            "%s: unmatched '<', '>' (use \\<, \\> to search for <, >)"
            % PROGNAME)

    m = j - 1
    base = WORD - m

    wildmask = (wildmask >> base) & U32
    endposition = (endposition >> base) & U32
    no_err_mask = (no_err_marks >> 1) & ~_bit(1) & U32
    no_err_mask = ((~no_err_mask & U32) >> (base - 1)) if base >= 1 else \
        (~no_err_mask & U32)

    init0 = 0
    for k in range(1, WORD - m + 1):
        init0 |= _bit(k)
    init0 |= endposition

    endposition = ((endposition << 1) + 1) & U32
    init1 = (init0 | wildmask | endposition) & U32
    shift = m - d_length
    d_endpos = ((endposition >> shift) << shift) & U32 if shift >= 0 else endposition
    endposition ^= d_endpos

    # per-character masks (maskgen.c:239-257)
    mask = np.zeros(256, dtype=np.uint64)  # build in u64, clip at end
    for c in range(256):
        mval = 0
        for k in range(1, m + 1):
            posn = positions[k - 1]
            hit = False
            for (lo, hi) in posn.pairs:
                if lo == cp.NOCARE and (c != ord("\n") or regex):
                    hit = True
                    break
                if lo <= c <= hi:
                    hit = True
                    break
            if hit:
                mval |= _bit(base + k)
            if posn.compl:
                mval ^= _bit(base + k)
        mask[c] = mval
    if nocase:
        # ASCII-only mask-row fold (maskgen.c:265)
        for c in range(ord("A"), ord("Z") + 1):
            mask[c] = mask[c + 32]

    return MaskTables(
        mask=mask.astype(np.uint32),
        m=m,
        init0=init0 & U32,
        init1=init1 & U32,
        endposition=endposition & U32,
        d_endpos=d_endpos & U32,
        no_err_mask=no_err_mask & U32,
        wildmask=wildmask & U32,
        and_flag=and_flag,
        or_flag=or_flag,
        positions=positions,
        d_length=d_length,
    )


def fold_mask_with_lut(tables: MaskTables, lut: np.ndarray) -> np.ndarray:
    """Pre-compose the scan-time LUT into the mask table.

    The reference applies the LUT per text byte in the hot loop
    (bitap.c:171: Mask[LUT[c]]); pre-folding gives identical semantics
    with zero per-byte cost.
    """
    return tables.mask[lut]
