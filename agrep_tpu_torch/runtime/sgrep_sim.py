"""Faithful emulation of sgrep.c's block-driver control-flow quirks.

The dense scan finds the same matches as the reference's Boyer-Moore /
partition engines (the filters never miss), but two *observable*
behaviours depend on the reference's control flow rather than the match
set:

1. bm() early-return: when the skip loop lands past textend and the
   emergency-stop copy of the pattern (sgrep.c:382) produces a bogus
   full match, bm returns before printing the INVERSE tail
   (sgrep.c:746-748, 987-1013).  Whether this happens depends on the
   skip-loop's landing alignment -- and, on multi-block files, on stale
   buffer contents between the trimmed block end and the stop bytes.

2. agrep() (the D>0 partition engine) counts an event again when a new
   candidate region re-scans the tail of an already-output record
   (sgrep.c:1187-1199: num_of_matched++ happens before the
   i <= lastend check).

Both are deterministic functions of the input bytes, emulated here over
a virtual copy of the reference's buffer layout.  This layer is only
consulted for the affected modes (INVERSE tails, D>0 counts); the hot
scan stays on the device.
"""

from __future__ import annotations

import numpy as np

BLOCKSIZE = 16384          # sgrep.c:56
MAXLINE = 1024
MAXPATT = 256
OFFSET = 2 * MAXLINE


def _tolower(b: int) -> int:
    return b + 32 if 65 <= b <= 90 else b


class VirtualSgrepBuffer:
    """Reproduces sgrep()'s buffer layout and block loop
    (sgrep.c:325-486): yields (block_index, start, end, first_time)
    with the evolving virtual buffer accessible as .buf."""

    def __init__(self, data: np.ndarray, pat: bytes, delimiter: bool,
                 d_pattern: bytes = b"\n", outtail: bool = False,
                 init_buf: np.ndarray | None = None):
        self.data = data
        self.pat = pat
        self.m = len(pat)
        size = 2 * BLOCKSIZE + 2 * MAXLINE + MAXPATT + 64
        if init_buf is not None and len(init_buf) == size:
            # cross-file persistence: sgrep() re-mallocs the same-size
            # buffer per file and glibc hands back the same chunk with
            # its CONTENT preserved (sgrep.c:327 alloc_buf ->
            # io.c:38 malloc); the previous file's bytes are the
            # stale background the new scan's excursions read
            self.buf = init_buf.copy()
        else:
            self.buf = np.zeros(size, dtype=np.uint8)
        # per-call writes (sgrep.c:328-330): the 1024-byte "security
        # zone" is re-zeroed every file -- which also erases the
        # malloc bin pointers glibc wrote into the first bytes
        self.buf[:MAXLINE] = 0
        self.buf[OFFSET - 1] = 0x0A
        self.delimiter = delimiter
        self.d_pattern = d_pattern
        self.outtail = outtail
        self.pos = 0

    def blocks(self):
        """Yields (start, end, gstart): scan span in buffer coordinates
        plus the global data offset of `start`."""
        start = OFFSET
        gstart = 0
        residue = 0
        first = True
        while True:
            num_read = min(2 * BLOCKSIZE, len(self.data) - self.pos)
            if num_read <= 0:
                break
            chunk = self.data[self.pos:self.pos + num_read]
            self.pos += num_read
            self.buf[OFFSET:OFFSET + num_read] = chunk
            buf_end = end = OFFSET + num_read - 1
            if first:
                # emergency stop copy of the pattern (sgrep.c:382)
                for i in range(1, self.m + 1):
                    self.buf[end + i] = self.pat[-1]
                first = False
            if not self.delimiter:
                if num_read == 2 * BLOCKSIZE:
                    while self.buf[end] != 0x0A and end > OFFSET:
                        end -= 1
                self.buf[start - 1] = 0x0A
            else:
                # trim to the last delimiter occurrence (sgrep.c:396-400)
                dp = self.d_pattern
                dl = len(dp)
                e = end + 1 - dl
                found = -1
                while e >= OFFSET:
                    if bytes(bytearray(self.buf[e:e + dl])) == dp:
                        found = e
                        break
                    e -= 1
                if found >= OFFSET + dl:
                    end = (found + dl - 1) if self.outtail else (found - 1)
                if start - dl >= 0:
                    self.buf[start - dl:start] = np.frombuffer(
                        dp, dtype=np.uint8)
            residue = buf_end - end + 1
            yield start, end, gstart
            gstart = gstart + (end - start) + 1
            start = OFFSET - residue
            if start < MAXLINE:
                start = MAXLINE
            # the residue copy is strncpy (sgrep.c:470): it stops at
            # the first NUL in the source and zero-fills the rest --
            # bytes past a NUL vanish from the carried record
            seg = self.buf[end:end + residue].copy()
            z = np.flatnonzero(seg == 0)
            if len(z):
                seg[int(z[0]):] = 0
            self.buf[start:start + residue] = seg
            start += 1
            if len(self.data) - self.pos <= 0:
                break
        # post-loop residue processing (sgrep.c:478-486)
        if residue > 1:
            if not self.delimiter:
                self.buf[start - 1] = 0x0A
                self.buf[start + residue] = 0x0A
            else:
                # note: start was ++'d after the copy, so start+residue
                # lands one byte INTO the stale region -- an accident of
                # the C that can defuse stale pseudo-matches and so
                # decides whether bm's INVERSE tail prints
                dp = np.frombuffer(self.d_pattern, dtype=np.uint8)
                dl = len(dp)
                if start > dl:
                    self.buf[start - dl:start] = dp
                self.buf[start + residue:start + residue + dl] = dp
            end = start + residue - 2
            yield start, end, gstart


class BlockBoundary:
    """One sgrep block boundary's observable geometry, in real data
    coordinates (sgrep.c:325-475 distilled to arithmetic).

    The reference reads 32KB blocks at buffer offset 2048, trims the
    scan back to the last delimiter/newline fully inside the new data,
    and copies the residue into at most OFFSET-MAXLINE = 1024 bytes of
    headroom (sgrep.c:464-468).  When the residue exceeds 1024 bytes
    the copy is clamped and the next fill_buf overwrites the rest: the
    bytes past the first 1024 of the residue silently VANISH from the
    scan, the carried record is stitched across the hole, and
    CurrentByteOffset (which advances by scanned span per block,
    sgrep.c:462) drifts behind the real offset forever after.
    """

    __slots__ = ("rb", "trim_end", "residue", "fallback", "clobbered",
                 "lost_lo", "lost_hi")

    def __init__(self, rb, trim_end, residue, fallback, clobbered):
        self.rb = rb                  # real offset where next read lands
        self.trim_end = trim_end      # real coord of scan `end` byte
        self.residue = residue
        self.fallback = fallback      # no qualifying delimiter in block
        self.clobbered = clobbered
        if clobbered:
            self.lost_lo = trim_end + (OFFSET - MAXLINE)
            self.lost_hi = rb
        else:
            self.lost_lo = self.lost_hi = -1


def block_layout(data, delim: bytes | None = None,
                 outtail: bool = False) -> list:
    """Boundaries of sgrep()'s 32KB block loop over `data`, real
    coords.  delim=None models the default newline trim (sgrep.c:389-
    393, applied only to full blocks); a byte-string models the -d
    backward_delimiter trim (sgrep.c:396-400, applied to every block).
    Only INTERIOR boundaries are returned (the EOF residue is re-scanned
    from an intact buffer -- no fill_buf follows to clobber it)."""
    B2 = 2 * BLOCKSIZE
    N = len(data)
    out = []
    k = 0
    while (k + 1) * B2 < N:          # another read follows this block
        lo = k * B2
        hi = lo + B2                 # full block (interior)
        fallback = False
        if delim is None:
            # while(text[end] != '\n' && end > offset) end--
            chunk = np.asarray(data[lo:hi])
            nls = np.flatnonzero(chunk == 0x0A)
            if len(nls):
                trim_end = lo + int(nls[-1])
            else:
                trim_end = lo        # end walked down to offset
        else:
            dl = len(delim)
            f = _last_delim_start(data, lo, hi, delim)
            if f >= lo + dl:
                trim_end = (f + dl - 1) if outtail else (f - 1)
            else:
                trim_end = hi - 1    # newbuf fallback: end = buf_end
                fallback = True
        residue = (hi - 1) - trim_end + 1
        clobbered = residue > OFFSET - MAXLINE
        out.append(BlockBoundary(hi, trim_end, residue, fallback,
                                 clobbered))
        k += 1
    return out


def nul_near_boundaries(data) -> bool:
    """Cheap pre-filter for nul_in_residue: a non-clobbered residue
    always lies within the last OFFSET-MAXLINE+1 bytes before an
    interior 32KB boundary.  Vectorized via a strided reshape view so
    a 10GB scan touches only the ~3% window bytes, in big batches."""
    B2 = 2 * BLOCKSIZE
    N = len(data)
    win = OFFSET - MAXLINE + 1
    nb = (N - 1) // B2          # number of interior boundaries
    if nb <= 0:
        return False
    view = np.asarray(data[:nb * B2]).reshape(nb, B2)[:, B2 - win:]
    step = 1 << 14              # rows per batch (~16MB of windows)
    for r0 in range(0, nb, step):
        if not np.all(view[r0:r0 + step]):
            return True
    return False


def nul_in_residue(data, layout) -> bool:
    """True when any interior block boundary carries a NUL byte in its
    copied residue: the strncpy residue copy (sgrep.c:470,
    newmgrep.c:560) truncates there and zero-fills, so the carried
    record bytes -- and any matches inside them -- vanish."""
    for b in layout:
        lo = b.trim_end
        hi = min(b.rb, lo + (OFFSET - MAXLINE) + 1)
        if hi > lo and bool((np.asarray(data[lo:hi]) == 0).any()):
            return True
    return False


def _last_delim_start(data, lo: int, hi: int, delim: bytes) -> int:
    """Real coord of the last occurrence of delim fully inside
    [lo, hi), or lo-1 if none (backward_delimiter, delim.c:77-100)."""
    dl = len(delim)
    chunk = np.asarray(data[lo:hi])
    if dl == 0 or len(chunk) < dl:
        return lo - 1
    hitmask = chunk[:len(chunk) - dl + 1] == delim[0]
    for j in range(1, dl):
        hitmask &= chunk[j:len(chunk) - dl + 1 + j] == delim[j]
    idx = np.flatnonzero(hitmask)
    return lo + int(idx[-1]) if len(idx) else lo - 1


def build_bm_tables(pat: bytes, tr: np.ndarray):
    """prep_bm (sgrep.c:1486-1525): SHIFT table + shift_1."""
    m = len(pat)
    shift = np.full(256, m, dtype=np.int32)
    for i in range(m - 1, -1, -1):
        h = tr[pat[i]]
        if shift[h] >= m - 1:
            shift[h] = m - 1 - i
    shift_1 = m - 1
    lastc = tr[pat[m - 1]]
    for i in range(m - 2, -1, -1):
        if tr[pat[i]] == lastc:
            shift_1 = m - 1 - i
            break
    if shift_1 == 0:
        shift_1 = 1
    for c in range(ord("A"), ord("Z") + 1):
        shift[c] = shift[c + 32]
    return shift, shift_1


def bm_inverse_survives(buf: np.ndarray, start: int, end: int,
                        pat: bytes, tr: np.ndarray, shift_tab, shift_1,
                        resume_positions, wordbound: bool = False) -> bool:
    """Walk bm()'s skip loop over one block and report whether the
    function reaches its INVERSE tail print (True) or early-returns on a
    stop-region pseudo-match (False).

    resume_positions: sorted record-end buffer positions where matches
    jump the scan (text = curtextend after output)."""
    from .. import native
    lib = native.get_lib()
    if lib is not None:
        import numpy as _np
        shift32 = _np.ascontiguousarray(shift_tab, dtype=_np.int32)
        res = _np.ascontiguousarray(
            _np.asarray(resume_positions, dtype=_np.int64))
        patv = _np.frombuffer(bytes(pat), dtype=_np.uint8)
        return bool(lib.bm_inverse_survives(
            _np.ascontiguousarray(buf), len(buf), int(start), int(end),
            _np.ascontiguousarray(patv), len(pat), shift32,
            int(shift_1), _np.ascontiguousarray(tr), res, len(res),
            1 if wordbound else 0))
    m = len(pat)
    patf = [int(tr[b]) for b in pat]
    text = start
    sh = 0
    textend = end
    ridx = 0
    guard = 0
    blen = len(buf)
    while text < textend:
        while sh:
            text += sh
            if text >= blen:
                # ran off the virtual buffer: the reference's skip
                # loop keeps striding through heap bytes until some
                # zero-shift byte, whose candidate compare then
                # MISMATCHES on garbage and exits the scan loop --
                # the tail print survives
                return True
            sh = int(shift_tab[buf[text]])
            guard += 1
            if guard > 10 * (blen + m + MAXPATT + 64):
                return False
        # full backward compare at text
        j = 0
        while j < m and text - j >= 0 and int(tr[buf[text - j]]) == patf[m - 1 - j]:
            j += 1
        if j == m:
            if text > textend:
                return False        # sgrep.c:748 early return
            if wordbound:
                # sgrep.c:749-753: rejected match steps by 1 (the
                # `shift=1; goto CONT` path), no record jump
                a1 = int(buf[text + 1]) if text + 1 < blen else 0
                b1 = int(buf[text - m]) if text - m >= 0 else 0
                if _isaln(a1) or _isaln(b1):
                    sh = 1
                    continue
            # a real match: jump to its record end -- the first resume
            # entry past text (record ends strictly increase)
            while ridx < len(resume_positions) and \
                    resume_positions[ridx] <= text:
                ridx += 1
            if ridx < len(resume_positions):
                text = resume_positions[ridx]
            else:
                # find next newline end (non-delim default)
                t = text + 1
                while t < textend and buf[t] != 0x0A:
                    t += 1
                text = t + 1
            sh = int(shift_tab[buf[text]]) if text < blen else 1
        else:
            sh = shift_1
    return True


def _agrep_rounds_py(buf, tb, te, cands, mask, endpos, D, delim,
                     outtail, silent):
    """Pure-Python twin of native agrep_rounds (sgrep.c:1166-1238)."""
    n = te - tb
    blen = len(buf)
    out_idx, out_flag, out_begin, out_end = [], [], [], []
    lastend = 0
    endpos &= 0xFFFFFFFF
    M32 = 0xFFFFFFFF

    def span_begin(i):
        if not delim:
            j = tb + i
            while j > tb:
                j -= 1
                if (buf[j] if j < blen else 0) == 0x0A:
                    break
            if j < blen and buf[j] == 0x0A:
                j += 1
            return j - tb
        dlen = len(delim)
        e, b = tb + i, tb
        if e - dlen < b:
            return 0
        if dlen == 1 and delim[0:1] == b"\n":
            e -= 1
            while e > b and (buf[e] if e < blen else 0) != 0x0A:
                e -= 1
            if outtail and e < blen and buf[e] == 0x0A:
                e += 1
            return e - tb
        cb = e - dlen
        while cb >= b:
            k = 0
            while k < dlen and \
                    (buf[cb + k] if cb + k < blen else 0) == delim[k]:
                k += 1
            if k >= dlen:
                return (cb + dlen if outtail else cb) - tb
            cb -= 1
        return 0

    def jump(i):
        if not delim:
            j = tb + i
            while j < te and (buf[j] if j < blen else 0) != 0x0A:
                j += 1
            if j < blen and buf[j] == 0x0A:
                j += 1
            return j - tb
        dlen = len(delim)
        b, e = tb + i, te
        if b + dlen > e:
            return e + 1 - tb
        if dlen == 1 and delim[0:1] == b"\n":
            b += 1
            while b < e and (buf[b] if b < blen else 0) != 0x0A:
                b += 1
            if outtail and b < blen and buf[b] == 0x0A:
                b += 1
            return b - tb
        cb = b
        while cb + dlen <= e:
            k = 0
            while k < dlen and \
                    (buf[cb + k] if cb + k < blen else 0) == delim[k]:
                k += 1
            if k >= dlen:
                return (cb + dlen if outtail else cb) - tb
            cb += 1
        return e + 1 - tb

    for (clo, chi) in cands:
        i = max(int(clo), 0)
        hi = min(int(chi), n)
        R1 = [M32] * (D + 1)
        R2 = [M32] * (D + 1)
        for k in range(1, D + 1):
            R1[k] = R2[k] = (R1[k - 1] >> 1) & R1[k - 1]
        while i < hi:
            for half in range(2):
                c = int(buf[tb + i]) if tb + i < blen else 0
                i += 1
                if c == 0x0A:
                    for k in range(D + 1):
                        R1[k] = R2[k] = M32
                r1 = int(mask[c])
                A, B = (R1, R2) if half == 0 else (R2, R1)
                A[0] = ((B[0] >> 1) | r1) & M32
                for k in range(1, D + 1):
                    A[k] = (((B[k] >> 1) | r1) & B[k - 1]
                            & ((A[k - 1] & B[k - 1]) >> 1)) & M32
                if (A[D] & endpos) == 0:
                    out_idx.append(i)
                    flag = 0
                    sb = se = -1
                    if i <= lastend:
                        i = lastend
                    elif not silent:
                        flag = 1
                        sb = span_begin(i)
                        i = jump(i)
                        se = i
                    out_flag.append(flag)
                    out_begin.append(sb)
                    out_end.append(se)
                    lastend = i
                    for k in range(D + 1):
                        R1[k] = R2[k] = M32
    return (np.asarray(out_idx, dtype=np.int64),
            np.asarray(out_flag, dtype=np.uint8),
            np.asarray(out_begin, dtype=np.int64),
            np.asarray(out_end, dtype=np.int64))


def agrep_exact(data: np.ndarray, pat: bytes, D: int, mask: np.ndarray,
                endpos: int, delimiter: bool = False,
                d_pattern: bytes = b"\n", outtail: bool = False,
                silent: bool = False,
                init_buf: np.ndarray | None = None):
    """Exact replay of agrep()'s candidate rounds + s_output jumps over
    the virtual buffer (sgrep.c:1123-1238, 1275-1345).  Used for
    degenerate fragment lengths (m - D <= 2) where the event-list proxy
    cannot model the per-round machine resets.

    Returns (count, out_positions, out_spans): total num_of_matched,
    the global data offsets (0-based match end, C's i-1) of the events
    that produced s_output records, and the corresponding (N, 2) array
    of s_output's own [curtextbegin, curtextend) record spans in global
    data coords -- which can truncate at block boundaries and re-print
    from the residue rescan, unlike a whole-stream record lookup."""
    from .. import native
    vb = VirtualSgrepBuffer(data, pat, delimiter, d_pattern, outtail,
                            init_buf=init_buf)
    shift_tab, d1, member, _m, _bs = build_agrep_tables(pat, D)
    delim_arg = d_pattern if delimiter else b""
    # our mask tables are active-high (bitword.sgrep_mask); the
    # reference machine is active-LOW (initmask, 0 bits = progress)
    mask = np.bitwise_not(np.asarray(mask, dtype=np.uint32))
    count = 0
    out_pos, out_spans, out_raw, out_blk = [], [], [], []
    for bi, (start, end, gstart) in enumerate(vb.blocks()):
        nc = native.agrep_candidates(vb.buf, start, end, pat, D,
                                     shift_tab, d1, member)
        if nc is None:
            cands = agrep_candidates(vb.buf, start, end, pat, D)
        else:
            cands = nc
        r = native.agrep_rounds(vb.buf, start, end, np.asarray(cands),
                                mask, endpos, D, delim_arg, outtail,
                                silent)
        if r is None:
            r = _agrep_rounds_py(vb.buf, start, end, cands, mask,
                                 endpos, D, delim_arg, outtail, silent)
        idxs, flags, begins, ends = r
        count += len(idxs)
        if len(idxs):
            sel = flags != 0
            out_pos.append(idxs[sel] + (gstart - 1))
            out_spans.append(
                np.stack([begins[sel], ends[sel]], axis=1) + gstart)
            out_blk.append(np.full(int(sel.sum()), bi, dtype=np.int64))
            # record bytes come from the evolving BUFFER, not the
            # stream: an overrun span can print stop-pattern or stale
            # residue bytes that exist nowhere in the data
            blen = len(vb.buf)
            for sb, se in zip(begins[sel], ends[sel]):
                lo = min(start + int(sb), blen)
                hi = min(start + int(se), blen)
                out_raw.append(bytes(bytearray(vb.buf[lo:hi])))
    if out_pos:
        pos = np.concatenate(out_pos)
        spans = np.concatenate(out_spans)
        blks = np.concatenate(out_blk)
    else:
        pos = np.empty(0, dtype=np.int64)
        spans = np.empty((0, 2), dtype=np.int64)
        blks = np.empty(0, dtype=np.int64)
    return count, pos, spans, out_raw, blks


def fresh_pulse_ok(buf, tb, frm, e, maskI, endpos, D) -> bool:
    """Post-jump verification for the event-list proxy: after a match,
    agrep() resets ALL machine words to ~0 (sgrep.c:1201-1204) -- the
    UNSEEDED state, unlike the round-start chain -- and jumps to the
    record end, skipping bytes.  A dense-scan event within m+D+2 bytes
    of the jump target may rely on skipped bytes or on reset seeding
    the fresh machine lacks (e.g. a leading-deletion match right after
    the jump).  Replay the reference machine from the jump target
    (block-relative frm) and report whether it pulses after consuming
    byte e.  Fresh pulses are a subset of dense events (alive-bit
    monotonicity), so rejection is the only possible correction."""
    M32 = 0xFFFFFFFF
    R1 = [M32] * (D + 1)
    R2 = [M32] * (D + 1)
    blen = len(buf)
    half = 0
    for t in range(frm, e + 1):
        c = int(buf[tb + t]) if 0 <= tb + t < blen else 0
        if c == 0x0A:
            R1 = [M32] * (D + 1)
            R2 = [M32] * (D + 1)
        r1 = int(maskI[c])
        A, B = (R1, R2) if half == 0 else (R2, R1)
        A[0] = ((B[0] >> 1) | r1) & M32
        for k in range(1, D + 1):
            A[k] = (((B[k] >> 1) | r1) & B[k - 1]
                    & ((A[k - 1] & B[k - 1]) >> 1)) & M32
        if t == e:
            return (A[D] & endpos) == 0
        half ^= 1
    return False


def _isaln(b: int) -> bool:
    return (48 <= b <= 57) or (65 <= b <= 90) or (97 <= b <= 122)


def monkey_inverse_survives(buf: np.ndarray, start: int, end: int,
                            pat: bytes, tr: np.ndarray, shift2,
                            resume_positions,
                            wordbound: bool = False) -> bool:
    """monkey()'s walk over one block (sgrep.c:1563-1801): True when
    the call reaches its INVERSE tail print, False when a verified
    candidate beyond textend early-returns (:1581)."""
    m = len(pat)
    m1 = m - 1
    patf = [int(tr[b]) for b in pat]
    blen = len(buf)
    text = start + m1
    textend = end
    ridx = 0
    guard = 0
    while text < textend:
        h = ((int(tr[buf[text]]) << 3)
             + int(tr[buf[text - 1]])) if text < blen and text >= 1 \
            else 0
        sh = int(shift2[h]) if h < 4096 else m
        while sh:
            text += sh
            if text >= blen:
                return True      # garbage exit: tail print survives
            h = (int(tr[buf[text]]) << 3) + int(tr[buf[text - 1]])
            sh = int(shift2[h]) if h < 4096 else m
            guard += 1
            if guard > 10 * (blen + m + 64):
                return False
        j = 0
        while j < m and text - j >= 0 \
                and int(tr[buf[text - j]]) == patf[m1 - j]:
            j += 1
        if j == m:
            if text > textend:
                return False     # sgrep.c:1581 early return
            if wordbound:
                # sgrep.c:1585-1589 reject: goto CONT -> text++
                a1 = int(buf[text + 1]) if text + 1 < blen else 0
                b1 = int(buf[text - m]) if text - m >= 0 else 0
                if _isaln(a1) or _isaln(b1):
                    text += 1
                    continue
            while ridx < len(resume_positions) and \
                    resume_positions[ridx] <= text:
                ridx += 1
            if ridx < len(resume_positions):
                text = resume_positions[ridx]
            else:
                t = text + 1
                while t < textend and buf[t] != 0x0A:
                    t += 1
                text = t + 1
        else:
            text += 1
    return True


def agrep_machine_tables(pat: bytes):
    """(inverted mask u32[256], endpos) of the agrep() round machine
    (initmask/sgrep.c:1043-1050 -- raw bytes, no folding at D>0)."""
    from ..ops import bitword
    mask = np.bitwise_not(
        np.asarray(bitword.sgrep_mask(pat), dtype=np.uint32))
    m = len(pat)
    endpos = (0x80000000 >> (m - 1)) & 0xFFFFFFFF
    return mask, np.uint32(endpos)


def _mem_delim_trim(data: np.ndarray, d_pattern: bytes,
                    outtail: bool, guard: int = 2 * 1024) -> int:
    """Scan end after the memory branch's -d trim (sgrep.c:598-603):
    backward_delimiter(text+end+1, text, ...) then the guard `newbuf <
    text+offset+D_length` cancels the trim.  sgrep's memory branch
    keeps `offset` at its 2*MAXLINE initializer (the "as if offset =
    0" comment lies about the variable), so guard=2048 there: small
    buffers never trim.  mgrep's memory branch (newmgrep.c:640-643)
    compares against text+D_length only -- guard=0: the trim engages
    whenever any delimiter exists.  Trimmed, end lands just before the
    last delimiter (curbegin, or curbegin+len under -t)."""
    n = len(data)
    dl = len(d_pattern)
    end = n - 1
    e = n                       # text + end + 1, with text at offset 0
    if e - dl < 0:
        nb = 0
    elif dl == 1 and d_pattern == b"\n":
        e -= 1
        while e > 0 and int(data[e]) != 0x0A:
            e -= 1
        if outtail and e < n and int(data[e]) == 0x0A:
            e += 1
        nb = e
    else:
        hit = np.ones(n - dl + 1, dtype=bool)
        for k, b in enumerate(d_pattern):
            hit &= data[k:n - dl + 1 + k] == b
        occ = np.flatnonzero(hit)
        nb = (int(occ[-1]) + (dl if outtail else 0)) if len(occ) else 0
    if nb < guard + dl:         # 2*MAXLINE (agrep.h:52) or D_length
        return end
    return nb - 1


def agrep_mem_exact(data: np.ndarray, pat: bytes, D: int,
                    mask: np.ndarray, endpos: int, delimiter: bool,
                    d_pattern: bytes, outtail: bool, silent: bool):
    """Memory-mode agrep() replay (sgrep.c:552-680): ONE call over the
    caller's buffer -- emergency-stop sentinel (m copies of pat[m-1])
    appended past the end, scan end trimmed back to the last delimiter
    (`while(text[end] != '\\n' && end > 1) end--`; DEAD CODE for -d,
    where offset keeps Max_record), then the same candidate rounds as
    the file path.  num_of_matched counts PULSES, independent of
    INVERSE (sgrep.c:1187).

    Returns (count, out_positions, out_spans, out_raw): like
    agrep_exact but single-block with tb=0, so spans/positions are
    already caller-buffer offsets; raw record bytes can overrun into
    the sentinel copies (the writable slack the contract requires)."""
    from .. import native
    m = len(pat)
    empty = (0, np.empty(0, dtype=np.int64),
             np.empty((0, 2), dtype=np.int64), [])
    buf = np.concatenate([np.asarray(data, dtype=np.uint8),
                          np.full(max(m, 1), pat[m - 1] if m else 0,
                                  dtype=np.uint8)])
    end = len(data) - 1
    if end < 0:
        return empty
    if not delimiter:
        while end > 1 and int(buf[end]) != 0x0A:
            end -= 1
    else:
        end = _mem_delim_trim(np.asarray(data, dtype=np.uint8),
                              d_pattern, outtail)
    shift_tab, d1, member, _m, _bs = build_agrep_tables(pat, D)
    maskI = np.bitwise_not(np.asarray(mask, dtype=np.uint32))
    delim_arg = d_pattern if delimiter else b""
    nc = native.agrep_candidates(buf, 0, end, pat, D, shift_tab, d1,
                                 member)
    cands = nc if nc is not None else agrep_candidates(buf, 0, end,
                                                       pat, D)
    r = native.agrep_rounds(buf, 0, end, np.asarray(cands), maskI,
                            endpos, D, delim_arg, outtail, silent)
    if r is None:
        r = _agrep_rounds_py(buf, 0, end, cands, maskI, endpos, D,
                             delim_arg, outtail, silent)
    idxs, flags, begins, ends = r
    sel = flags != 0
    raw = []
    blen = len(buf)
    for sb, se in zip(begins[sel], ends[sel]):
        lo = min(max(int(sb), 0), blen)
        hi = min(max(int(se), lo), blen)
        raw.append(bytes(bytearray(buf[lo:hi])))
    return (int(len(idxs)), idxs[sel] - 1,
            np.stack([begins[sel], ends[sel]], axis=1), raw)


def agrep_mem_count(data, pat, D, mask, endpos, delimiter, d_pattern,
                    outtail, silent) -> int:
    """Pulse count only (see agrep_mem_exact)."""
    return agrep_mem_exact(data, pat, D, mask, endpos, delimiter,
                           d_pattern, outtail, silent)[0]


def agrep_c_count(data: np.ndarray, events_g: np.ndarray, nl_g: np.ndarray,
                  pat: bytes, D: int, delimiter: bool = False,
                  d_pattern: bytes = b"\n",
                  rec_ends: np.ndarray | None = None) -> int:
    """One-shot wrapper around AgrepCountWalker (whole-file path).

    events_g: global data offsets of match-end events (0-based, i.e.
    C's i-1); nl_g: global offsets of newlines (or None when rec_ends
    is passed directly by the streaming path)."""
    ev = np.asarray(events_g, dtype=np.int64)
    if rec_ends is None:
        # record end per event (s_output's curtextend), vectorized
        jj = np.searchsorted(nl_g, ev + 1, side="left")
        rec_ends = np.where(
            jj < len(nl_g),
            (nl_g[np.minimum(jj, max(len(nl_g) - 1, 0))] + 1
             if len(nl_g) else 0),
            len(data) + 1).astype(np.int64)
    w = AgrepCountWalker(data, pat, D, delimiter, d_pattern)
    w.feed(ev, rec_ends, len(data) + 4)
    return w.finish()


class AgrepCountWalker:
    """Incremental replay of agrep()'s num_of_matched, including the
    candidate-round overcount (sgrep.c:1187-1199).

    feed() takes match-end events (data coords, ascending) with their
    record ends, plus a frontier: every event < frontier is final and
    resolved.  Virtual-buffer blocks wholly below the frontier are
    walked immediately and their events discarded -- so a streamed scan
    holds O(chunk) events, never O(file).  data may be an np.memmap;
    the block walk reads it sequentially in O(32KB) slices."""

    def __init__(self, data, pat: bytes, D: int, delimiter: bool = False,
                 d_pattern: bytes = b"\n",
                 init_buf: np.ndarray | None = None):
        self.data = data
        self.pat = pat
        self.D = D
        self.m_pat = len(pat)
        self.vb = VirtualSgrepBuffer(data, pat, delimiter, d_pattern,
                                     init_buf=init_buf)
        self._blocks = self.vb.blocks()
        self._cur = next(self._blocks, None)
        self.count = 0
        (self.shift_tab, self.d1, self.member,
         _m, _bs) = build_agrep_tables(pat, D)
        self.maskI, self.endpos = agrep_machine_tables(pat)
        self._ev = np.empty(0, dtype=np.int64)
        self._re = np.empty(0, dtype=np.int64)

    def feed(self, events_g, rec_ends, frontier) -> None:
        if len(events_g):
            self._ev = np.concatenate(
                [self._ev, np.asarray(events_g, dtype=np.int64)])
            self._re = np.concatenate(
                [self._re, np.asarray(rec_ends, dtype=np.int64)])
        while self._cur is not None:
            start, end, gstart = self._cur
            n = end - start
            # the pair-unroll overrun can consume one byte past the
            # round bound, so the block needs events < gstart + n + 2
            if gstart + n + 2 > frontier:
                break
            self._walk_block(start, end, gstart)
            self._cur = next(self._blocks, None)
            if self._cur is not None:
                # drop consumed events (blocks never look back past
                # their own gstart)
                lo = int(np.searchsorted(self._ev, self._cur[2],
                                         side="left"))
                self._ev = self._ev[lo:]
                self._re = self._re[lo:]

    def finish(self) -> int:
        while self._cur is not None:
            self._walk_block(*self._cur)
            self._cur = next(self._blocks, None)
        return self.count

    def _walk_block(self, start, end, gstart) -> None:
        from .. import native
        n = end - start  # textend - textbegin
        lo_g = gstart
        m_pat, D = self.m_pat, self.D
        e_lo = int(np.searchsorted(self._ev, lo_g, side="left"))
        e_hi = int(np.searchsorted(self._ev, lo_g + n + 2, side="right"))
        ev_blk = np.ascontiguousarray(self._ev[e_lo:e_hi])
        re_blk = np.ascontiguousarray(self._re[e_lo:e_hi])
        nc = native.agrep_candidates(self.vb.buf, start, end, self.pat,
                                     D, self.shift_tab, self.d1,
                                     self.member)
        if nc is not None:
            cands = np.clip(nc, [0, 0], [n, n])
            c = native.agrep_count_walk(ev_blk, re_blk, cands, lo_g,
                                        m_pat, D, self.vb.buf, start,
                                        self.maskI, int(self.endpos))
            if c is not None:
                self.count += c
                return
            cands = [tuple(x) for x in cands]
        else:
            cands = agrep_candidates(self.vb.buf, start, end, self.pat,
                                     D)
        lastend = 0
        win = m_pat + D + 2
        for (clo, chi) in cands:
            clo = max(int(clo), 0)
            chi = int(chi)
            warm = clo + (m_pat - D)
            k = int(np.searchsorted(ev_blk, lo_g + clo, side="left"))
            # walk the round like the C scan: the body is 2x-unrolled
            # with the bound checked once per PAIR (sgrep.c:1175-1238),
            # so after a count-jump in the first half the second half
            # still consumes one byte -- even past the round bound --
            # and can re-count an event there.  After an event the
            # index jumps (to the record end, or to lastend), so events
            # inside the jumped-over span are never encountered, and
            # the machine RESETS to the unseeded ~0 state
            # (sgrep.c:1201-1204) -- events shortly after the jump are
            # re-verified against the fresh machine (fresh_pulse_ok).
            i = clo
            fresh_from = -1
            while i < chi:
                for _half in range(2):
                    while k < len(ev_blk) and int(ev_blk[k]) < lo_g + i:
                        k += 1
                    hit = (k < len(ev_blk)
                           and int(ev_blk[k]) == lo_g + i
                           and i + 1 >= warm)
                    if (hit and fresh_from >= 0
                            and i - fresh_from < win
                            and not fresh_pulse_ok(
                                self.vb.buf, start, fresh_from, i,
                                self.maskI, self.endpos, D)):
                        hit = False
                        k += 1      # event consumed, not counted
                    if hit:
                        self.count += 1
                        idx = i + 1
                        if idx <= lastend:
                            i = lastend
                        else:
                            i = int(re_blk[k]) - lo_g
                        lastend = i
                        fresh_from = i
                        k += 1
                    else:
                        i += 1


def verify_dp(m: int, n: int, D: int, pat: bytes, window) -> int:
    """Banded Ukkonen verifier -- structural twin of sgrep.c
    verify:2118-2181 (two alternating rows A/B, the `last` frontier,
    the mid-window newline reset).  Returns the offset of the match end
    within window, or 0.  pat is NUL-extended like the C buffer."""
    from . import trace
    if trace.ENABLED:
        trace.add("candidates_verified")
    from .. import native
    if native.get_lib() is not None:
        r = native.verify_dp(m, n, D, bytes(pat), bytes(window))
        if r is not None:
            return r
    A = list(range(260))
    B = list(range(260))
    last = D
    patx = pat + b"\x00" * (260 - len(pat))
    t = 0
    wlen = len(window)

    def ch(i):
        return window[i] if 0 <= i < wlen else 0

    while t < n:
        for k in range(1, last + 1):
            cost = B[k - 1] + 1
            if patx[k - 1] != ch(t):
                if B[k] + 1 < cost:
                    cost = B[k] + 1
                if A[k - 1] + 1 < cost:
                    cost = A[k - 1] + 1
            else:
                cost = cost - 1
            A[k] = cost
        if patx[last] == ch(t):
            A[last + 1] = B[last]
            last += 1
        t += 1
        if A[last] < D:
            # verbatim C is `A[last+1] = A[last++]+1` -- unsequenced;
            # gcc materializes the destination AFTER the increment, so
            # the write lands one slot further and A[new last] is stale
            tmp = A[last] + 1
            last += 1
            A[last + 1] = tmp
        while A[last] > D:
            last -= 1
        if last >= m:
            return t - 1
        if ch(t) == 0x0A:
            last = D
            for c in range(m + 2):
                A[c] = B[c] = c
        for k in range(1, last + 1):
            cost = A[k - 1] + 1
            if patx[k - 1] != ch(t):
                if A[k] + 1 < cost:
                    cost = A[k] + 1
                if B[k - 1] + 1 < cost:
                    cost = B[k - 1] + 1
            else:
                cost = cost - 1
            B[k] = cost
        if patx[last] == ch(t):
            B[last + 1] = A[last]
            last += 1
        t += 1
        if B[last] < D:
            tmp = B[last] + 1
            last += 1
            B[last + 1] = tmp
        while B[last] > D:
            last -= 1
        if last >= m:
            return t - 1
        if ch(t) == 0x0A:
            last = D
            for c in range(m + 2):
                A[c] = B[c] = c
    return 0


def a_monkey_scan(data: np.ndarray, pat: bytes, D: int,
                  delimiter: bool = False, d_pattern: bytes = b"\n",
                  init_buf: np.ndarray | None = None):
    """Faithful emulation of a_monkey (sgrep.c:1839-2068): backward
    q-gram chain filter + verify DP.  The filter can MISS real matches
    (pinned reference behaviour), so the dense event stream cannot
    drive this sub-engine.  Returns a list of
    (match_end_buffer_pos, gstart, block_start, block_end, cbo)
    tuples plus per-block info for INVERSE handling."""
    m = len(pat)
    m1 = m - 1 - D
    hashmask = 0xFFFF
    member = np.zeros(65536, dtype=np.uint8)
    for b in pat:
        member[b] = 1
    for i in range(m - 1, 0, -1):
        member[((pat[i] << 8) + pat[i - 1]) & hashmask] = 1
    vb = VirtualSgrepBuffer(data, pat, delimiter, d_pattern,
                            init_buf=init_buf)
    matches = []
    blocks = []
    from .. import native
    dp = d_pattern if delimiter else None
    for (start, end, gstart) in vb.blocks():
        buf = vb.buf
        nm = native.a_monkey_block(buf, start, end, pat, D, member, dp)
        if nm is not None:
            matches.append([int(x) for x in nm])
            blocks.append((start, end, gstart))
            continue
        textend = end
        text = start
        oldtext = text
        block_matches = []
        guard = 0
        while text < textend:
            text = text + m1
            suffix_error = 0
            while suffix_error <= D:
                if text < 0:
                    break
                h = int(buf[text]) if text < len(buf) else 0
                text -= 1
                while member[h]:
                    if text < 0:
                        break
                    h = ((h << 8) + int(buf[text])) & hashmask
                    text -= 1
                suffix_error += 1
            guard += 1
            if guard > 4 * (end - start + 16):
                break
            if text <= oldtext:
                win = bytes(bytearray(
                    buf[oldtext:oldtext + 2 * m + D]))
                pos = verify_dp(m, 2 * m + D, D, pat, win)
                if pos > 0:
                    text = oldtext + pos
                    if text > textend:
                        break
                    block_matches.append(text)
                    # caller jumps text to the record end
                    rec_end = _record_end_buf(buf, text, textend,
                                              delimiter, d_pattern)
                    text = rec_end
                else:
                    text = oldtext + m
            oldtext = text
        matches.append(block_matches)
        blocks.append((start, end, gstart))
    return matches, blocks, vb


def monkey4_scan(data: np.ndarray, pat: bytes, D: int,
                 delimiter: bool = False, d_pattern: bytes = b"\n",
                 init_buf: np.ndarray | None = None):
    """Faithful emulation of monkey4 (sgrep.c:2221-2480): the DNA
    2-bit q-gram backward filter + verify DP.  Same contract as
    a_monkey_scan.  prep4 quirks preserved: char_map folds only 'A'
    (the g/t/c/n assignments set the lowercase twice, sgrep.c:2491-94),
    LOG_DNA is 3, and the seed consumes two chars before the member
    loop."""
    m = len(pat)
    m1 = m - 1 - D
    LOG_DNA = 3
    char_map = np.zeros(256, dtype=np.int64)
    char_map[ord('a')] = char_map[ord('A')] = 4
    char_map[ord('g')] = 1
    char_map[ord('t')] = 2
    char_map[ord('c')] = 3
    char_map[ord('n')] = 5
    # BSize = blog(4, m)
    mm = m + m // 2
    bsize = 1
    expv = 4
    while expv < mm:
        expv *= 4
        bsize += 1
    hashmask = 1
    for _ in range(1, bsize * LOG_DNA):
        hashmask = (hashmask << 1) + 1
    member = np.zeros(hashmask + 1, dtype=np.uint8)
    for j in range(bsize):
        for i in range(m - 1, j - 1, -1):
            h = 0
            for k in range(j + 1):
                h = (h << LOG_DNA) + int(char_map[pat[i - k]])
            member[h & hashmask] = 1
    vb = VirtualSgrepBuffer(data, pat, delimiter, d_pattern,
                            init_buf=init_buf)
    matches = []
    blocks = []
    from .. import native
    dp = d_pattern if delimiter else None
    for (start, end, gstart) in vb.blocks():
        buf = vb.buf
        nm = native.monkey4_block(buf, start, end, pat, D, char_map,
                                  member, hashmask, dp)
        if nm is not None:
            matches.append([int(x) for x in nm])
            blocks.append((start, end, gstart))
            continue
        textend = end
        text = start
        oldtext = text
        block_matches = []
        guard = 0
        while text < textend:
            text = text + m1
            suffix_error = 0
            while suffix_error <= D:
                if text < 1:
                    break
                h = int(char_map[buf[text]]) if text < len(buf) else 0
                text -= 1
                h = ((h << LOG_DNA)
                     + int(char_map[buf[text]])) & hashmask
                text -= 1
                while member[h]:
                    if text < 0:
                        break
                    h = ((h << LOG_DNA)
                         + int(char_map[buf[text]])) & hashmask
                    text -= 1
                suffix_error += 1
            guard += 1
            if guard > 4 * (end - start + 16):
                break
            if text <= oldtext:
                win = bytes(bytearray(
                    buf[oldtext:oldtext + 2 * m + D]))
                pos = verify_dp(m, 2 * m + D, D, pat, win)
                if pos > 0:
                    text = oldtext + pos
                    if text > textend:
                        break
                    block_matches.append(text)
                    # monkey4 resumes one PAST the record end
                    # (text = textbegin + 1, sgrep.c:2441)
                    rec_end = _record_end_buf(buf, text, textend,
                                              delimiter, d_pattern)
                    text = rec_end + 1
                else:
                    text = oldtext + m
            oldtext = text
        matches.append(block_matches)
        blocks.append((start, end, gstart))
    return matches, blocks, vb


def _record_end_buf(buf, pos, textend, delimiter, d_pattern):
    """curtextend for a match at pos (a_monkey:1891-1894)."""
    if not delimiter:
        t = pos + 1
        while t < textend and buf[t] != 0x0A:
            t += 1
        if t < len(buf) and buf[t] == 0x0A:
            t += 1
        return t
    dl = len(d_pattern)
    t = pos + 1
    while t + dl <= textend:
        if bytes(bytearray(buf[t:t + dl])) == d_pattern:
            return t + dl if False else t
        t += 1
    return textend + 1


def build_agrep_tables(pat: bytes, D: int):
    """prep() (sgrep.c:1053-1099): fragment SHIFT + 3-char MEMBER set."""
    M = len(pat)
    m = M // (D + 1)
    p = M - m * (D + 1)
    shift = np.full(256, m, dtype=np.int32)
    for i in range(M - 1, p - 1, -1):
        sh = (M - 1 - i) % m
        h = pat[i]
        if shift[h] > sh:
            shift[h] = sh
    shift_1 = m
    for i in range(D + 1):
        j = M - 1 - m * i
        for k in range(1, m):
            for q in range(D + 1):
                if j - k >= 0 and pat[j - k] == pat[M - 1 - m * q]:
                    if k < shift_1:
                        shift_1 = k
    if shift_1 == 0:
        shift_1 = 1
    member = np.zeros(8192, dtype=np.uint8)
    b_size = 3 if m >= 3 else m
    for i in range(D + 1):
        j = M - 1 - m * i
        h = 0
        for k in range(b_size):
            if j - k >= 0:
                h = ((h << 2) + pat[j - k])
        member[h % 8192] = 1
    return shift, shift_1, member, m, b_size


def agrep_candidates(buf: np.ndarray, start: int, end: int,
                     pat: bytes, D: int):
    """Walk agrep()'s filter loop (sgrep.c:1130-1154) over one block and
    return the candidate list [(lo, hi)] in buffer coordinates relative
    to textbegin (= start), exactly as Candidate[][] is built."""
    shift_tab, d1, member, m, b_size = build_agrep_tables(pat, D)
    M = len(pat)
    r1 = m if m < 3 else 3
    text = start
    textend = end
    cands = [(0, 0)]
    sh = m - 1
    blen = len(buf)
    while text < textend:
        text += sh
        if text >= blen:
            break
        sh = int(shift_tab[buf[text]])
        while sh:
            text += sh
            if text >= blen:
                break
            sh = int(shift_tab[buf[text]])
            text += sh
            if text >= blen:
                break
            sh = int(shift_tab[buf[text]])
        if text >= blen:
            break
        h = int(buf[text])
        j = 1
        while j < r1:
            h = (h << 2) + int(buf[text - j])
            j += 1
        if member[h % 8192]:
            i = text - start
            if (i - M - D - 10) > cands[-1][1]:
                cands.append((i - M - D - 2, i + M + D))
            else:
                cands[-1] = (cands[-1][0], i + M + D)
        sh = d1
    n = textend - start
    # Candidate[0] starts as a (0,0) sentinel but the first nearby hit
    # extends it in place (sgrep.c:1146-1150), and the rounds loop scans
    # round 0 too (sgrep.c:1166): keep it.
    return [(max(lo, 0), min(hi, n)) for (lo, hi) in cands]


# ---------------------------------------------------------------------------
# Exact block replay for the D==0 simple path (bm/monkey).
#
# The dense device scan models sgrep()'s block loop piecewise, which
# breaks down when a block's residue exceeds the 1024-byte copy-back
# headroom (the clamped strncpy at sgrep.c:464-468 silently drops the
# rest of the residue) or a block has no qualifying delimiter at all
# (records re-split at every read boundary, sgrep.c:389-399).  For
# those corpora we simulate the reference's 35KB buffer byte-for-byte
# -- fill_buf, trims, forced newlines, sentinel copy, clamped residue
# copy -- and drive bm()/monkey()'s match->record logic (sgrep.c:
# 694-1021 / 1541-1837) from a dense vectorized scan of each block.
# Exact by construction; only routed when block_layout detects a
# pathological boundary, so the device scan stays the hot path.
#
# Known divergence: bytes the C never wrote (malloc garbage at
# buf[MAXLINE..OFFSET) before the first copy reaches them, heap bytes
# past the allocation) are zero here; they can only matter if the
# folded pattern matches garbage, which requires the pattern to
# contain '\n' or NUL-adjacent bytes.
# ---------------------------------------------------------------------------


def build_monkey_tables(pat: bytes, tr: np.ndarray):
    """m_preprocess (sgrep.c:2187-2214): 2-char-hash SHIFT_2 table."""
    m = len(pat)
    shift2 = np.full(4096, m, dtype=np.int32)
    for i in range(m - 1, 0, -1):
        h = int(tr[pat[i]]) << 3
        sel = shift2[h:h + 256] == m
        shift2[h:h + 256][sel] = m - 1
        h2 = h + int(tr[pat[i - 1]])
        if shift2[h2] >= m - 1:
            shift2[h2] = m - 1 - i
    shift_1 = m - 1
    for i in range(m - 2, -1, -1):
        if tr[pat[i]] == tr[pat[m - 1]]:
            shift_1 = m - 1 - i
            break
    if shift_1 == 0:
        shift_1 = 1
    shift2[0] = 0
    return shift2, shift_1


def _sgrep_tr() -> np.ndarray:
    """char_tr (sgrep.c:216-236): unconditional ASCII case fold (the
    if(NOUPPER) guard is commented out in this build)."""
    tr = np.arange(256, dtype=np.uint8)
    for c in range(ord("A"), ord("Z") + 1):
        tr[c] = c + 32
    return tr


def _folded_ends(buf: np.ndarray, lo: int, hi: int,
                 patf: np.ndarray) -> np.ndarray:
    """Match-END positions p in [lo, hi) with tr-folded
    buf[p-m+1..p] == folded pattern."""
    m = len(patf)
    if hi <= lo or lo - m + 1 < 0:
        lo = max(lo, m - 1)
        if hi <= lo:
            return np.empty(0, dtype=np.int64)
    seg = _sgrep_tr()[buf[lo - m + 1:hi]]
    k = len(seg) - m + 1
    if k <= 0:
        return np.empty(0, dtype=np.int64)
    hit = np.ones(k, dtype=bool)
    for j in range(m):
        hit &= seg[j:j + k] == patf[j]
    return np.flatnonzero(hit).astype(np.int64) + lo


def _delim_occ(buf, lo: int, hi: int, dp: bytes) -> np.ndarray:
    """Start indices of dp occurrences with cb in [lo, hi-dl]
    (vectorized rolling AND -- the Python byte walks made every
    delimiter-free 32KB block cost ~10ms in the -d replay)."""
    dl = len(dp)
    k = (hi - lo) - dl + 1
    if k <= 0:
        return np.empty(0, dtype=np.int64)
    seg = np.asarray(buf[lo:hi])
    hit = seg[:k] == dp[0]
    for j in range(1, dl):
        hit &= seg[j:j + k] == dp[j]
    return np.flatnonzero(hit).astype(np.int64) + lo


def _bwd_delim(buf, e, b, dp: bytes, outtail: bool) -> int:
    """backward_delimiter (delim.c:75-100) over the buffer: search
    [b, e) for the last delim occurrence."""
    dl = len(dp)
    if e - dl < b:
        return b
    if dl == 1 and dp == b"\n":
        # while(e > b && buf[e] != nl) e--: largest index in
        # [b+1, e-1] holding a newline, else b (buf[b] untested)
        occ = _delim_occ(buf, b + 1, e, b"\n")
        r = int(occ[-1]) if len(occ) else b
        if outtail and buf[r] == 0x0A:
            r += 1
        return r
    occ = _delim_occ(buf, b, e, dp)
    if len(occ):
        cb = int(occ[-1])
        return cb + dl if outtail else cb
    return b


def _fwd_delim(buf, b, e, dp: bytes, outtail: bool) -> int:
    """forward_delimiter (delim.c:50-71): search [b, e) forward."""
    dl = len(dp)
    if b + dl > e:
        return e + 1
    if dl == 1 and dp == b"\n":
        # b++; while(b < e && buf[b] != nl) b++: first newline in
        # [b+1, e-1], else e (then OUTTAIL may read buf[e])
        occ = _delim_occ(buf, b + 1, e, b"\n")
        r = int(occ[0]) if len(occ) else e
        if outtail and buf[r] == 0x0A:
            r += 1
        return r
    occ = _delim_occ(buf, b, e, dp)
    if len(occ):
        cb = int(occ[0])
        return cb + dl if outtail else cb
    return e + 1


def _walk_survives(buf, start, end, pat, tr, sub, wordbound,
                   resumes) -> bool:
    """Walk the skip loop of bm() (sgrep.c:723-748) or monkey()
    (:1563-1586) over one block and report whether the INVERSE tail
    print is reached (True) or the function early-returns on a full
    match past textend (False).

    bm advances by shift_1 after a failed candidate and re-enters the
    skip loop with the shift of the jump target; monkey advances one
    byte (CONT: text++, sgrep.c:1801) and recomputes its 2-char hash
    at the loop top."""
    m = len(pat)
    patf = [int(tr[b]) for b in pat]
    blen = len(buf)
    textend = end
    ridx = 0
    if sub == "bm":
        shift_tab, shift_1 = build_bm_tables(pat, tr)
        text = start
        sh = 0
    else:
        shift2, _ = build_monkey_tables(pat, tr)
        text = start + m - 1
    # the walk legitimately strides the WHOLE raw read past a
    # small trimmed span, so the runaway guard scales with the
    # buffer, not the scan span
    guard_max = 4 * (blen + m + MAXPATT + 128)
    guard = 0
    while text < textend:
        if sub == "bm":
            while sh:
                text += sh
                if text >= blen:
                    return True   # heap-garbage candidate mismatches
                sh = int(shift_tab[buf[text]])
                guard += 1
                if guard > guard_max:
                    return False
        else:
            if text - 1 < 0:
                return False
            if text >= blen:
                return True
            h = (int(tr[buf[text]]) << 3) + int(tr[buf[text - 1]])
            sh = int(shift2[h])
            while sh:
                text += sh
                if text >= blen:
                    return True
                h = (int(tr[buf[text]]) << 3) + int(tr[buf[text - 1]])
                sh = int(shift2[h])
                guard += 1
                if guard > guard_max:
                    return False
        j = 0
        while j < m and text - j >= 0 and \
                int(tr[buf[text - j]]) == patf[m - 1 - j]:
            j += 1
        if j == m:
            if text > textend:
                return False          # sgrep.c:748 early return
            if wordbound and (_isalnum_b(buf[text + 1])
                              or (text - m >= 0
                                  and _isalnum_b(buf[text - m]))):
                if sub == "bm":
                    sh = 1
                else:
                    text += 1
                continue
            while ridx < len(resumes) and resumes[ridx] <= text:
                ridx += 1
            if ridx < len(resumes):
                text = resumes[ridx]
            else:
                t = text + 1
                while t < textend and buf[t] != 0x0A:
                    t += 1
                text = t + 1
            if sub == "bm":
                sh = int(shift_tab[buf[text]]) if text < blen else 1
        else:
            if sub == "bm":
                sh = shift_1
            else:
                text += 1
    return True


def _isalnum_b(b: int) -> bool:
    return (48 <= b <= 57) or (65 <= b <= 90) or (97 <= b <= 122)


def walk_fires_at_end(buf, start, end, pat: bytes, tr, sub: str,
                      wordbound: bool) -> bool:
    """Does the real bm()/monkey() walk fire a full match at exactly
    textend (= end)?  The dense event model assumes yes; the actual
    walk can exit first:

      * entry gate `while (text < textend)` (bm sgrep.c:723,
        monkey :1563) -- a 1-byte bm span or an m-byte monkey span
        scans nothing;
      * a false candidate at textend-1 steps text++ onto textend and
        the gate kills the iteration (monkey CONT, :1801);
      * a skip-run overshoots textend (both engines; bm then full-
        matches the emergency-stop copy and returns, :748);
      * an output's record jump lands at/after textend (bm's EOF
        record extension :786-789, monkey's curtextend==textend).

    buf must hold the final scan call's bytes with buf[start-1] the
    preceding '\\n' context and buf[end+1] standing in for the byte
    past textend (pat[-1], the emergency-stop convention the event
    filters already pin for WORDBOUND)."""
    m = len(pat)
    patf = [int(tr[b]) for b in pat]
    textend = end
    if sub == "bm":
        shift_tab, shift_1 = build_bm_tables(pat, tr)
        text = start
        sh = 0
    else:
        shift2, _ = build_monkey_tables(pat, tr)
        text = start + m - 1
    guard = 0
    guard_max = 4 * (end - start + m + 64)
    while text < textend:
        if sub == "bm":
            while sh:
                text += sh
                if text > textend:
                    return False
                sh = int(shift_tab[buf[text]])
                guard += 1
                if guard > guard_max:
                    return False
        else:
            h = (int(tr[buf[text]]) << 3) + int(tr[buf[text - 1]])
            sh = int(shift2[h])
            while sh:
                text += sh
                if text > textend:
                    return False
                h = (int(tr[buf[text]]) << 3) + int(tr[buf[text - 1]])
                sh = int(shift2[h])
                guard += 1
                if guard > guard_max:
                    return False
        j = 0
        while j < m and text - j >= 0 and \
                int(tr[buf[text - j]]) == patf[m - 1 - j]:
            j += 1
        if j == m:
            wb_fail = wordbound and (
                _isalnum_b(int(buf[text + 1]))
                or (text - m >= 0 and _isalnum_b(int(buf[text - m]))))
            if text == textend:
                return not wb_fail
            if wb_fail:
                # as if there was no match (sgrep.c:757, :1586)
                if sub == "bm":
                    sh = 1
                else:
                    text += 1
                continue
            # record jump: curtextend = one past the next newline
            # (bm extends through textend, :786-789 -- any landing
            # >= textend ends the walk identically)
            t = text + 1
            while t < textend and buf[t] != 0x0A:
                t += 1
            if buf[t] == 0x0A:
                t += 1
            text = t
            if sub == "bm":
                if text > textend:
                    return False
                sh = int(shift_tab[buf[text]])
            else:
                text += 1          # CONT after DO_OUTPUT (:1801)
        else:
            if sub == "bm":
                sh = shift_1
            else:
                text += 1
    return False


def sgrep_block_replay(read, n: int, q, sink, resume=None):
    """Byte-exact replay of sgrep()'s fd-mode block loop for D==0
    bm/monkey (sgrep.c:325-550).

    read(lo, hi) -> np.uint8 array of file bytes [lo, hi); n = file
    size.  Matches per block come from a dense vectorized scan; the
    match->record logic is a sparse transliteration of bm()/monkey().
    All output goes through `sink`, counts through sink.num_matched.

    resume: None to replay from the file start, or (trim, rb) to take
    over mid-file after a clean prefix: every block boundary before
    file offset rb was non-pathological, block k-1's scan ended at the
    delimiter/newline at real offset `trim`, and the next fill_buf
    read starts at rb (a 2*BLOCKSIZE multiple).  The carried state is
    reconstructed arithmetically (CurrentByteOffset == trim+1 while
    history is clean).  Invalid if the pattern contains a newline
    (reconstructed stale bytes below the copy region differ).

    Returns 'fname' if FILENAMEONLY printed (caller stops the file),
    'stop' on an output limit, else None.
    """
    o = q.opts
    pat = q.sg_pattern
    m = len(pat)
    sub = q.sg_sub
    tr = _sgrep_tr()
    patf = tr[np.frombuffer(pat, dtype=np.uint8)]
    delim = q.delim if q.delimiter_opt else None
    dp = bytes(delim) if delim is not None else None
    dl = len(dp) if dp is not None else 0
    outtail = bool(q.outtail)
    B2 = 2 * BLOCKSIZE
    buflen = B2 + 2 * MAXLINE + MAXPATT
    buf = np.zeros(buflen + MAXPATT + 8, dtype=np.uint8)
    buf[OFFSET - 1] = 0x0A
    start = OFFSET
    cbo = 0
    if o.wholeline:
        start -= 1
        cbo -= 1
    first_time = True
    fpos = 0
    residue = 0

    if resume is not None:
        trim, rb = resume
        residue = rb - trim
        carry = np.array(read(trim, rb), copy=True)
        z_c = np.flatnonzero(carry == 0)
        if len(z_c):
            carry[int(z_c[0]):] = 0    # the strncpy at the seam
        s2 = OFFSET - residue
        if s2 < MAXLINE:
            s2 = MAXLINE
        buf[s2:s2 + residue] = carry[:min(residue, len(buf) - s2)]
        start = s2 + 1
        cbo = trim + 1
        fpos = rb
        first_time = False
        if n >= B2 and m > 0:
            # the emergency-stop pattern copy written after the first
            # (full) block persists past every later read (sgrep.c:382)
            buf[OFFSET + B2:OFFSET + B2 + m] = pat[-1]

    while fpos < n:
        num_read = min(B2, n - fpos)
        buf[OFFSET:OFFSET + num_read] = read(fpos, fpos + num_read)
        fpos += num_read
        buf_end = end = OFFSET + num_read - 1
        oldcbo = cbo
        if first_time:
            if m > 0:
                buf[end + 1:end + 1 + m] = pat[-1]
            first_time = False
        if delim is None:
            if num_read == B2:
                seg = buf[OFFSET:end + 1]
                nls = np.flatnonzero(seg == 0x0A)
                end = OFFSET + int(nls[-1]) if len(nls) else OFFSET
            buf[start - 1] = 0x0A
        else:
            nb = _bwd_delim(buf, end + 1, OFFSET, dp, outtail)
            if nb < OFFSET + dl:
                nb = end + 1
            end = nb - 1
            buf[start - dl:start] = np.frombuffer(dp, dtype=np.uint8)
        residue = buf_end - end + 1
        rc = _replay_scan(buf, start, end, oldcbo, q, sink, sub, patf,
                          tr, dp, outtail)
        if rc is not None:
            return rc
        cbo = oldcbo + end - start + 1
        s2 = OFFSET - residue
        if s2 < MAXLINE:
            s2 = MAXLINE
        # strncpy (sgrep.c:470): stops at the first NUL in the residue
        # and zero-fills the rest of the copy
        seg_r = buf[end:end + residue].copy()
        z_r = np.flatnonzero(seg_r == 0)
        if len(z_r):
            seg_r[int(z_r[0]):] = 0
        buf[s2:s2 + residue] = seg_r
        start = s2 + 1
        if _replay_limits(o, sink):
            return 'stop'

    # EOF residue rescan from the intact copy (sgrep.c:478-547)
    if delim is None:
        buf[start - 1] = 0x0A
        buf[start + residue] = 0x0A
    else:
        dpa = np.frombuffer(dp, dtype=np.uint8)
        if start > dl:
            buf[start - dl:start] = dpa
        buf[start + residue:start + residue + dl] = dpa
    end = start + residue - 2
    if residue > 1:
        rc = _replay_scan(buf, start, end, cbo, q, sink, sub, patf,
                          tr, dp, outtail)
        if rc is not None:
            return rc
    return None


def _replay_limits(o, sink) -> bool:
    if o.limit_output > 0 and sink.num_matched >= o.limit_output:
        return True
    if o.limit_per_file > 0 and \
            (sink.num_matched - sink.prev_num_matched) >= o.limit_per_file:
        return True
    return False


def _replay_scan(buf, start, end, cbo0, q, sink, sub, patf, tr, dp,
                 outtail):
    """One bm()/monkey() call (sgrep.c:694-1021 / 1541-1837) over
    buf[start..end], driven by dense match events."""
    from .output import output_sgrep_record
    o = q.opts
    pat = q.sg_pattern
    m = len(pat)
    textend = end
    if end <= start:
        ev = np.empty(0, dtype=np.int64)
    else:
        ev = _folded_ends(buf, start, end + 1, patf)
        if sub == "monkey":
            ev = ev[ev >= start + m - 1]
    textbegin = start
    lastout = start
    text = start
    resumes = []
    for p in ev:
        p = int(p)
        if p < text:
            continue
        if o.wordbound and (_isalnum_b(int(buf[p + 1]))
                            or (p - m >= 0
                                and _isalnum_b(int(buf[p - m])))):
            continue
        if dp is None:
            ctb = p
            while ctb > textbegin and buf[ctb - 1] != 0x0A:
                ctb -= 1
            if ctb > textbegin and buf[ctb - 1] == 0x0A:
                pass                       # ctb just past the newline
            elif ctb == textbegin and buf[ctb] == 0x0A:
                ctb += 1
            cte = p + 1
            while cte < textend and buf[cte] != 0x0A:
                cte += 1
            if buf[cte] == 0x0A:
                cte += 1
            if sub == "bm" and cte >= textend:
                # EOF adjustment (sgrep.c:786-789); the appended
                # newline lands on the first residue byte and persists
                cte = textend + 1
                if buf[cte - 1] != 0x0A:
                    buf[cte] = 0x0A
                    cte += 1
        else:
            ctb = _bwd_delim(buf, p, textbegin, dp, outtail)
            cte = _fwd_delim(buf, p + 1, textend, dp, outtail)
        textbegin = cte
        sink.num_matched += 1
        if o.filename_only:
            return 'fname'
        if not o.count:
            if not o.invert:
                output_sgrep_record(sink, buf, ctb, cte,
                                    cbo0 + (p - start), p)
            else:
                sink.write(bytes(bytearray(buf[lastout:ctb])))
                lastout = cte
        text = cte
        resumes.append(cte)
        if _replay_limits(o, sink):
            return 'stop'
    if o.invert and not o.count:
        if _walk_survives(buf, start, end, pat, tr, sub,
                          bool(o.wordbound), resumes) \
                and lastout <= textend:
            sink.write(bytes(bytearray(buf[lastout:textend + 1])))
    return None
