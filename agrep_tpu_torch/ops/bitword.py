"""Scalar shift-or step functions -- the executable spec.

These implement the Wu-Manber bit-parallel recurrences with the exact
semantics of the reference engines (bitap.c:169-283 exact;
asearch.c:94-232 k errors; asearch1.c non-uniform costs; sgrep.c
agrep():1166-1238 simple k-error), operating on python ints masked to
32 bits.  They exist for testing: the production scan in scan.py must
produce identical event streams.

Event model: instead of the reference's sticky accumulator bits
(Init1's endposition self-loops) checked at record ends, we emit a
"pulse" event whenever a pattern part's last-char bit turns on, and a
delimiter event whenever the delimiter part completes exactly.  Record
verdicts are then segmented reductions over pulses, which is equivalent
(the sticky bits influence nothing but the record-end check; see
docs/DESIGN.md).
"""

from __future__ import annotations

U32 = 0xFFFFFFFF


def machine_constants(t, D: int):
    """Derive the event-machine constants from MaskTables t.

    Returns a dict of ints:  init0, init1_ns (without endposition
    stickies -- the pulse formulation), noerr, d_endpos, endpos (check
    bits), d_mask (reset mask for the delimiter prefix, bitap.c:131-133).
    """
    d_mask = t.d_endpos
    # widen D_Mask over the delimiter's character positions
    # (bitap.c:132: D_length-1 doublings over strlen(old_D_pat))
    dl = t.d_length - 1  # number of delimiter characters
    for _ in range(1, max(dl, 1)):
        d_mask = ((d_mask << 1) | d_mask) & U32
    d_mask = (~d_mask) & U32
    init1_ns = (t.init0 | t.wildmask) & U32
    return dict(
        init0=t.init0,
        init1=t.init1,
        init1_ns=init1_ns,
        noerr=t.no_err_mask,
        d_endpos=t.d_endpos,
        endpos=t.endposition,
        d_mask=d_mask,
        m=t.m,
    )


def step_exact(R: int, cmask: int, c: dict) -> tuple[int, int]:
    """One byte of the exact bitap machine (pulse formulation).

    Returns (new_state, events) where events has the delimiter bit
    and/or part last-char bits that fired on this byte.
    """
    r = (((R >> 1) & cmask) | (c["init1_ns"] & R)) & U32
    ev = r & (c["d_endpos"] | c["endpos"])
    if r & c["d_endpos"]:
        # record boundary: reset (bitap.c:223-225)
        r = ((((c["init0"] >> 1) & cmask) | (c["init1_ns"] & c["init0"]))
             & c["d_mask"]) & U32
    return r, ev


def step_kerr(Rs: list[int], cmask: int, c: dict, D: int):
    """One byte of the k-error machine (asearch.c:96-115 recurrence,
    pulse formulation).  Rs is the list of D+1 level states."""
    new = [0] * (D + 1)
    new[0] = (((Rs[0] >> 1) & cmask) | (c["init1_ns"] & Rs[0])) & U32
    for k in range(1, D + 1):
        r2 = Rs[k - 1] | ((((new[k - 1] | Rs[k - 1]) >> 1) & c["noerr"]))
        new[k] = ((((Rs[k] >> 1) & cmask) | (c["init1_ns"] & Rs[k])) | r2) & U32
    ev = (new[0] & c["d_endpos"]) | (new[D] & c["endpos"])
    if new[0] & c["d_endpos"]:
        # record boundary: reset all levels (asearch.c:177-196)
        B = c["init0"]
        new[0] = ((((B >> 1) & cmask) | (c["init1_ns"] & B)) & c["d_mask"]) & U32
        for k in range(1, D + 1):
            r2 = B | ((((new[k - 1] | B) >> 1) & c["noerr"]))
            new[k] = ((((B >> 1) & cmask) | (c["init1_ns"] & B)) | r2) & U32
    return new, ev


def step_jump(Rs: list[int], cmask: int, c: dict, D: int,
              cost_i: int, cost_s: int, cost_d: int):
    """One byte with non-uniform costs (asearch1.c:90-97 semantics).

    Level k draws its insertion term from level k-I, its deletion term
    from the *new* state at level k-DD, and its substitution term from
    level k-S; costs are clamped to D+1 (asearch1.c:42-44)."""
    ci = min(cost_i, D + 1)
    cs = min(cost_s, D + 1)
    cd = min(cost_d, D + 1)
    new = [0] * (D + 1)
    for k in range(0, D + 1):
        r = ((Rs[k] >> 1) & cmask) | (c["init1_ns"] & Rs[k])
        if k - ci >= 0:
            r |= Rs[k - ci]                      # insertion
        err = 0
        if k - cd >= 0:
            err |= new[k - cd]                   # deletion
        if k - cs >= 0:
            err |= Rs[k - cs]                    # substitution
        r |= ((err >> 1) & c["noerr"])
        new[k] = r & U32
    ev = (new[0] & c["d_endpos"]) | (new[D] & c["endpos"])
    if new[0] & c["d_endpos"]:
        B = c["init0"]
        tmp = [0] * (D + 1)
        for k in range(0, D + 1):
            r = ((B >> 1) & cmask) | (c["init1_ns"] & B)
            if k - ci >= 0:
                r |= B
            err = 0
            if k - cd >= 0:
                err |= tmp[k - cd]
            if k - cs >= 0:
                err |= B
            r |= ((err >> 1) & c["noerr"])
            if k == 0:
                r &= c["d_mask"]
            tmp[k] = r & U32
        new = tmp
    return new, ev


TOP = 0x80000000


def sgrep_mask(pattern: bytes) -> list[int]:
    """Per-char position mask for the simple k-error engine, active-high
    mirror of sgrep.c initmask:1023-1051: bit (31-j) set when
    pattern[j] == c."""
    mask = [0] * 256
    for j, b in enumerate(pattern):
        mask[b] |= (TOP >> j)
    return mask


def sgrep_init(D: int) -> list[int]:
    """Level-k initial state: k leading deletions allowed
    (sgrep.c agrep():1172-1174, complemented to active-high)."""
    states = [0]
    for k in range(1, D + 1):
        states.append(((states[-1] >> 1) | states[-1] | TOP) & U32)
    return states


def step_sgrep(Rs: list[int], byte: int, cmask: int, m: int, D: int):
    """One byte of the simple-pattern k-error engine (active-high mirror
    of sgrep.c agrep():1177-1237).  Resets at newline.  Returns
    (new_states, matched_bool)."""
    if byte == 0x0A:
        Rs = [0] * (D + 1)
    new = [0] * (D + 1)
    new[0] = (((Rs[0] >> 1) | TOP) & cmask) & U32
    for k in range(1, D + 1):
        new[k] = (((((Rs[k] >> 1) | TOP) & cmask)
                   | Rs[k - 1]
                   | (((new[k - 1] | Rs[k - 1]) >> 1) | TOP)) & U32)
    endbit = TOP >> (m - 1)
    return new, bool(new[D] & endbit)


def scan_stream_ref(data: bytes, mask, c: dict, D: int,
                    costs=None) -> list[tuple[int, int]]:
    """Scan a whole byte stream with the scalar machine.

    Returns [(index, events_word)] for every byte that produced events.
    `mask` is the folded uint32[256] mask table.
    """
    if D == 0:
        R = c["init0"]
        out = []
        for i, b in enumerate(data):
            R, ev = step_exact(R, int(mask[b]), c)
            if ev:
                out.append((i, ev))
        return out
    Rs = [c["init0"]] * (D + 1)
    out = []
    for i, b in enumerate(data):
        if costs is not None:
            Rs, ev = step_jump(Rs, int(mask[b]), c, D, *costs)
        else:
            Rs, ev = step_kerr(Rs, int(mask[b]), c, D)
        if ev:
            out.append((i, ev))
    return out
