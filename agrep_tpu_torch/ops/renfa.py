"""Regex-with-errors scan: the position automaton, record-parallel.

The NFA state is a 32-bit position set; the transition is
    next(S) = head_bit | U{ follow_bits[p] : p in S, 1 <= p <= M-1 }
(compute_next semantics, agrep.c:396-457) followed by & CMask and the
sticky bits, with the k-error recurrence of re1 (agrep.c:802-965).

Star closures make in-record dependence unbounded, so the tile+halo
trick does not apply; instead the scan is *record-parallel*: state
resets at every newline (re1:858-906), so each line is independent --
one GPU thread per line (ops/renfa_kernel.py).
"""

from __future__ import annotations

import numpy as np

U32 = 0xFFFFFFFF
# line-length buckets of the lane matrices (a line of n bytes and its
# newline takes the first bucket >= n + 1; longer lines their own length)
MAXLINE_BUCKETS = (32, 128, 512, 2048, 8192, 49152)


def machine_from_automaton(auto, mask: np.ndarray, no_err: int, D: int,
                           head_on: bool, tail_on: bool) -> dict:
    """Precompute machine constants (re1:489-504)."""
    M = auto.m
    init0 = 1 << M
    if head_on:
        init0 |= auto.head_bit

    def nxt(state: int) -> int:
        acc = auto.head_bit
        for p in range(1, M):
            if state & (1 << (M - p)):
                acc |= int(auto.follow_bits[p])
        return acc & U32

    inits = [init0]
    for _ in range(D):
        prev = inits[-1]
        inits.append((prev | nxt(prev)) & U32)
    init1 = (init0 | 1) & U32
    return dict(M=M, D=D, init0=init0, init1=init1, inits=inits,
                no_err=no_err, tail=tail_on, nxt=nxt, mask=mask,
                follow_bits=np.asarray(auto.follow_bits, dtype=np.uint32),
                head_bit=np.uint32(auto.head_bit))


# -- scalar spec ------------------------------------------------------

def step_char(states, cmask: int, mc) -> list[int]:
    """One non-newline char at all levels (re1:802-856)."""
    D, nxt = mc["D"], mc["nxt"]
    init1, noerr = mc["init1"], mc["no_err"]
    new = [((nxt(states[0]) & cmask) | (init1 & states[0])) & U32]
    for k in range(1, D + 1):
        r0 = states[k - 1] | new[k - 1]
        new.append(((nxt(states[k]) & cmask)
                    | ((states[k - 1] | nxt(r0)) & noerr)
                    | (init1 & states[k])) & U32)
    return new


def step_newline(states, cmask_nl: int, mc):
    """End-of-line check + reset (re1:858-906).
    Returns (new_states, matched_bool)."""
    D, nxt = mc["D"], mc["nxt"]
    init0, init1, noerr = mc["init0"], mc["init1"], mc["no_err"]
    ad = ((nxt(states[D]) & cmask_nl) | (init1 & states[D])) & U32
    if mc["tail"]:
        ad = (nxt(ad) | ad) & U32
    new = [((nxt(init0) & cmask_nl) | (init1 & init0)) & U32]
    for k in range(1, D + 1):
        r2 = new[k - 1] | init0
        new.append(((nxt(init0) & cmask_nl)
                    | ((init0 | nxt(r2)) & noerr)
                    | (init1 & init0)) & U32)
    return new, bool(ad & 1)


def scan_lines_ref(stream: bytes, mc):
    """Scalar spec: per-newline verdicts over a whole stream (the lane
    runner must agree with this).  Returns [(nl_index, matched)]."""
    mask = mc["mask"]
    states = list(mc["inits"])
    out = []
    for i, b in enumerate(stream):
        if b == 0x0A:
            states, matched = step_newline(states, int(mask[0x0A]), mc)
            out.append((i, matched))
        else:
            states = step_char(states, int(mask[b]), mc)
    return out


# -- record-parallel runners -----------------------------------------

def next_tables_arrays(mc):
    """Tabulated followpos transition -- the reference's own design
    (compute_next agrep.c:396-457 for re, split half-tables for re1
    :492-498).  nxt(s) depends only on state bits 1..M-1, so the
    index is (s >> 1) & (2^(M-1) - 1); above 17 positions the index
    splits into two gathers.  Returns (lo_tab, hi_tab_or_None, h,
    rel)."""
    M = mc["M"]
    fb = mc["follow_bits"]
    hb = np.uint32(int(mc["head_bit"]))
    rel = max(M - 1, 0)

    def build(lo_bit, n_bits):
        tab = np.full(1 << n_bits, hb if lo_bit == 0 else 0,
                      dtype=np.uint32)
        ar = np.arange(1 << n_bits, dtype=np.int64)
        for p in range(1, M):
            b = (M - p - 1) - lo_bit        # index-space bit
            if 0 <= b < n_bits:
                tab[(ar & (1 << b)) != 0] |= np.uint32(fb[p])
        return tab

    if rel <= 17:
        return build(0, rel), None, 0, rel
    h = rel // 2
    return build(0, h), build(h, rel - h), h, rel


def nxt_byte_tables(mc) -> np.ndarray:
    """u32[4, 256] tables T0..T3 with
        nxt(S) = head_bit | T0[S & 255] | T1[(S >> 8) & 255]
                          | T2[(S >> 16) & 255] | T3[S >> 24].
    Exact: nxt is an OR over the set bits 1..M-1 of S, each bit owned
    by one byte of S, and M <= 30 (compile/regex.py) keeps them in 32
    bits.  The lanes kernel looks nxt up in these (four loads)."""
    M = mc["M"]
    fb = mc["follow_bits"]
    tabs = np.zeros((4, 256), dtype=np.uint32)
    ar = np.arange(256)
    for p in range(1, M):
        bit = M - p
        tabs[bit >> 3, ((ar >> (bit & 7)) & 1) != 0] |= np.uint32(fb[p])
    return tabs


def _next_tables(mc):
    lo_tab, hi_tab, h, rel = next_tables_arrays(mc)
    if rel <= 0:
        def nxt0(s):
            return lo_tab[np.zeros(len(s), dtype=np.int64)]
        return nxt0
    idx_mask = np.int64((1 << rel) - 1)
    if hi_tab is None:
        def nxt(s):
            return lo_tab[(s.astype(np.int64) >> 1) & idx_mask]
        return nxt
    lo_mask = np.int64((1 << h) - 1)

    def nxt2(s):
        i = (s.astype(np.int64) >> 1) & idx_mask
        return lo_tab[i & lo_mask] | hi_tab[i >> h]
    return nxt2


def scan_records(lines: np.ndarray, line_len: np.ndarray, mc,
                 first_states, cont_states) -> np.ndarray:
    """The numpy lanes: lines: u8[R, L] = line bytes + '\\n' + padding;
    line_len[r] = index of the trailing newline.  Lane 0 starts from
    first_states (post-sentinel), others from cont_states (post-reset).
    Returns matched bool[R] (verdict at each lane's newline).  The
    torch backend builds no lane matrices: it runs
    renfa_kernel.renfa_lines on the text itself
    (runtime/regex_engine.py)."""
    R, L = lines.shape
    D, M = mc["D"], mc["M"]
    init1 = np.uint32(mc["init1"])
    noerr = np.uint32(mc["no_err"])
    cmasks = mc["mask"][lines].astype(np.uint32)
    nxt = _next_tables(mc)

    states = np.empty((D + 1, R), dtype=np.uint32)
    for k in range(D + 1):
        states[k, :] = cont_states[k]
        states[k, 0] = first_states[k]

    matched = np.zeros(R, dtype=bool)
    for j in range(L):
        cm = cmasks[:, j]
        at_nl = line_len == j
        if at_nl.any():
            ad = (nxt(states[D]) & cm) | (init1 & states[D])
            if mc["tail"]:
                ad = nxt(ad) | ad
            matched = np.where(at_nl, (ad & 1) != 0, matched)
        new = [(nxt(states[0]) & cm) | (init1 & states[0])]
        for k in range(1, D + 1):
            r0 = states[k - 1] | new[k - 1]
            new.append((nxt(states[k]) & cm)
                       | ((states[k - 1] | nxt(r0)) & noerr)
                       | (init1 & states[k]))
        states = np.stack(new)
    return matched
