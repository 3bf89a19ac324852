"""Multi-pattern device machines: pack many exact patterns into 32-bit
shift-or words.

The reference's mgrep uses a hashed Boyer-Moore skip table
(newmgrep.c SHIFT1/HASH); on TPU we instead pack terms into machine
words -- term positions separated by always-on separator bits (the same
mechanism maskgen uses for AND patterns) -- and run the dense windowed
scan once per word-group.  A group's event word identifies which term's
last character matched at each byte.  Terms longer than 31 positions
fall back to the host matcher.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

WORD = 32

# prepf limits (newmgrep.c:48-56)
MAXHASH = 32768
MASK5 = 32767
HBITS = 5
MAXPATFILE = 600000
MAX_NUM = 40000


@dataclass
class TermGroup:
    mask: np.ndarray          # uint32[256], fold pre-composed
    consts: dict              # machine constants for ops.scan 'bitap'
    term_ids: list            # global term index per packed term
    term_bits: list           # event bit (int) per packed term
    term_lens: list           # length per packed term


def pack_terms(terms: list[bytes], tr: np.ndarray):
    """Greedy packing of terms into <=32-position machine words.

    Returns (groups, leftover_ids): leftover terms are too long for a
    word and must be matched on the host."""
    groups: list[TermGroup] = []
    leftover: list[int] = []
    batch: list[int] = []
    used = 0
    for i, t in enumerate(terms):
        if not t:
            continue
        need = len(t) + (1 if batch else 0)
        if len(t) > WORD - 1:
            leftover.append(i)
            continue
        # cap at 31 positions: the first term needs at least one
        # always-on prefix bit to feed its first position
        if used + need > WORD - 1:
            groups.append(_build_group(batch, terms, tr))
            batch, used = [], 0
            need = len(t)
        batch.append(i)
        used += need
    if batch:
        groups.append(_build_group(batch, terms, tr))
    return groups, leftover


def _build_group(ids: list[int], terms: list[bytes],
                 tr: np.ndarray) -> TermGroup:
    # layout: [t0 chars] SEP [t1 chars] SEP ... (1-based positions);
    # separators and the prefix padding are always-on (Init0), so every
    # term restarts at any byte.  Bit for position k of M: 1 << (M - k).
    positions: list = []   # (char byte or None for separator)
    term_bits = []
    term_lens = []
    for j, ti in enumerate(ids):
        if j > 0:
            positions.append(None)
        for b in terms[ti]:
            positions.append(b)
        term_bits.append(None)  # fill later (needs M)
        term_lens.append(len(terms[ti]))
    M = len(positions)
    bit = lambda k: 1 << (M - k)  # noqa: E731

    init0 = 0
    for k in range(1, WORD - M + 1):
        init0 |= (1 << (WORD - k)) & 0xFFFFFFFF
    endpos = 0
    sep_bits = 0
    term_bits = []
    k = 1
    for j, ti in enumerate(ids):
        if j > 0:
            sep_bits |= bit(k)
            k += 1
        k += len(terms[ti]) - 1
        term_bits.append(bit(k))
        endpos |= bit(k)
        k += 1
    init0 = (init0 | sep_bits) & 0xFFFFFFFF

    mask = np.zeros(256, dtype=np.uint32)
    folded_pos = [None if p is None else int(tr[p]) for p in positions]
    for c in range(256):
        fc = int(tr[c])
        m = 0
        for k2, fp in enumerate(folded_pos, start=1):
            if fp is not None and fp == fc:
                m |= bit(k2)
        mask[c] = m

    consts = dict(
        init0=init0,
        init1_ns=init0,
        noerr=0,
        d_endpos=0,
        endpos=endpos,
        d_mask=0xFFFFFFFF,
        m=M,
    )
    return TermGroup(mask=mask, consts=consts, term_ids=list(ids),
                     term_bits=term_bits, term_lens=term_lens)


# ---------------------------------------------------------------------
# One-pass q-gram filter (the scalable many-pattern path)
# ---------------------------------------------------------------------
#
# The reference handles up to 40,000 patterns in ONE corpus pass with a
# hashed Boyer-Moore skip table (newmgrep.c:1725-1851 f_prep/f_prep1:
# SHIFT1 over 2/3-char tr1-folded grams of each pattern's p_size-char
# prefix, HASH buckets for candidate verification).  Skipping is a
# scalar-CPU idiom; the TPU-native equivalent keeps the *filter*
# structure but evaluates it densely: one vectorized pass computes the
# gram hash at every anchor position and tests membership in the set of
# pattern-tail hashes; only member positions reach the (sparse,
# per-bucket) exact verify.  Soundness: an occurrence of term t at
# start s implies tr-equality on its first p_size bytes, hence
# tr1-equality of the anchor gram, hence membership -- the filter is a
# strict superset of true matches and the verify makes it exact.


@dataclass
class QgramTables:
    p_size: int
    long_: int                 # LONG (3-char gram), newmgrep.c:355
    short: bool                # SHORT (p_size == 1), newmgrep.c:356
    member: np.ndarray         # bool[MAXHASH] (or [256] when short)
    buckets: dict = field(default_factory=dict)   # hash -> [term ids]
    hash_id: np.ndarray = None  # int32[len(member)]: dense bucket index
    bucket_list: list = None    # bucket index -> np.ndarray term ids


def _term_hash(tb: np.ndarray, p_size: int, long_: int, short: bool,
               tr: np.ndarray, tr1: np.ndarray) -> int:
    if short:
        return int(tr[tb[0]])
    j = p_size - 1
    h = int(tr1[tb[j]])
    h = (h << HBITS) + int(tr1[tb[j - 1]])
    if long_:
        h = (h << HBITS) + int(tr1[tb[j - 2]])
    return h & MASK5


def build_qgram_tables(terms: list[bytes], tr: np.ndarray) -> QgramTables:
    """prepf's filter tables, dense-membership form (newmgrep.c:192-375)."""
    nz = [(i, t) for i, t in enumerate(terms) if t]
    p_size = min(len(t) for _, t in nz)
    multilen = sum(len(t) + 1 for _, t in nz)
    long_ = 1 if (multilen > 400 and p_size > 2) else 0
    short = p_size == 1
    tr1 = (tr.astype(np.int64) & 31)
    buckets: dict = {}
    for i, t in nz:
        tb = np.frombuffer(t, dtype=np.uint8)
        h = _term_hash(tb, p_size, long_, short, tr, tr1)
        buckets.setdefault(h, []).append(i)
    size = 256 if short else MAXHASH
    member = np.zeros(size, dtype=bool)
    hash_id = np.full(size, -1, dtype=np.int32)
    bucket_list = []
    for h in sorted(buckets):
        member[h] = True
        hash_id[h] = len(bucket_list)
        bucket_list.append(np.asarray(buckets[h], dtype=np.int64))
    return QgramTables(p_size=p_size, long_=long_, short=short,
                       member=member, buckets=buckets, hash_id=hash_id,
                       bucket_list=bucket_list)


def qgram_hashes(stream: np.ndarray, tb: QgramTables,
                 tr: np.ndarray) -> np.ndarray:
    """Hash at every anchor a in [p_size-1, n-1]; index i = a-(p_size-1)."""
    n = len(stream)
    p = tb.p_size
    if n < p:
        return np.zeros(0, dtype=np.int32)
    if tb.short:
        return tr[stream].astype(np.int32)
    # tr1[c] == tr[c] & 31 == c & 31 (case folding only flips bit 5)
    f1 = (stream & np.uint8(31)).astype(np.int32)
    h = (f1[p - 1:] << HBITS) + f1[p - 2:n - 1]
    if tb.long_:
        h = (h << HBITS) + f1[p - 3:n - 2]
        h &= MASK5
    return h


def qgram_occurrences(stream: np.ndarray, terms: list[bytes],
                      tr: np.ndarray, tb: QgramTables,
                      cand_anchor_rel: np.ndarray | None = None) -> dict:
    """Exact start positions per term id, ONE pass over the stream.

    cand_anchor_rel: optional precomputed candidate indices (relative
    anchor positions, e.g. from the device filter kernel); when None
    the vectorized host filter runs here."""
    n = len(stream)
    occ = {i: np.zeros(0, dtype=np.int64) for i in range(len(terms))}
    p = tb.p_size
    if n < p:
        return occ
    if cand_anchor_rel is None:
        h = qgram_hashes(stream, tb, tr)
        cand = np.flatnonzero(tb.member[h])
        hv = h[cand]
    else:
        # device-filter candidates (a sound superset, e.g. the 2-gram
        # projection of a LONG 3-gram set): compute hashes only at the
        # candidate anchors and drop false positives here
        cand = np.asarray(cand_anchor_rel, dtype=np.int64)
        cand = cand[(cand >= 0) & (cand <= n - p)]
        if len(cand):
            a = cand + (0 if tb.short else p - 1)
            if tb.short:
                hv = tr[stream[a]].astype(np.int32)
            else:
                f1a = (stream[a] & np.uint8(31)).astype(np.int32)
                f1b = (stream[a - 1] & np.uint8(31)).astype(np.int32)
                hv = (f1a << HBITS) + f1b
                if tb.long_:
                    f1c = (stream[a - 2]
                           & np.uint8(31)).astype(np.int32)
                    hv = ((hv << HBITS) + f1c) & MASK5
            keep = tb.member[hv]
            cand, hv = cand[keep], hv[keep]
        else:
            hv = np.zeros(0, dtype=np.int64)
    if not len(cand):
        return occ
    from ..runtime import trace
    if trace.ENABLED:
        trace.add("qgram_candidates", int(len(cand)))
    folded = tr[stream]
    # group candidates by bucket: stable sort keeps anchors ascending
    bid = tb.hash_id[hv]
    order = np.argsort(bid, kind="stable")
    bid_s = bid[order]
    cand_s = cand[order]
    edges = np.flatnonzero(np.diff(bid_s)) + 1
    group_starts = np.concatenate([[0], edges, [len(bid_s)]])
    for gi in range(len(group_starts) - 1):
        lo, hi = group_starts[gi], group_starts[gi + 1]
        if lo == hi:
            continue
        b = int(bid_s[lo])
        # hash index i maps to anchor a = i + p - 1, and the match
        # start is a - (p - 1) = i (for short, a == i == start)
        starts_all = cand_s[lo:hi]
        # verify each DISTINCT byte string once; duplicate pattern
        # lines share the result.  Progressive filtering: each char
        # test shrinks the candidate set before the next gather.
        distinct: dict = {}
        for tid in tb.bucket_list[b]:
            distinct.setdefault(terms[tid], []).append(int(tid))
        for t, tids in distinct.items():
            L = len(t)
            s = starts_all
            if starts_all[-1] + L > n:
                s = s[s + L <= n]
            tf = tr[np.frombuffer(t, dtype=np.uint8)]
            for k in range(L):
                if not len(s):
                    break
                s = s[folded[s + k] == tf[k]]
            for tid in tids:
                occ[tid] = s
    return occ


def member_projection_1024(tb: QgramTables) -> np.ndarray | None:
    """2-gram membership set for the device filter kernel
    (ops/qgram_kernel.py): exact for the non-LONG tables, the sound
    tail-2-gram projection for LONG (h15 >> 5 recovers the full 10-bit
    2-gram: the &MASK5 truncation only drops 3rd-char bits).  None for
    SHORT tables (single-char sets have no gram structure)."""
    if tb.short:
        return None
    if not tb.long_:
        # non-LONG hashes are 10-bit; the table is allocated MAXHASH
        # wide but only the first 1024 slots can be set
        return tb.member[:1024].copy()
    m = np.zeros(1024, dtype=bool)
    marked = np.flatnonzero(tb.member)
    m[marked >> HBITS] = True
    return m
