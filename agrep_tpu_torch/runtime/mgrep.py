"""Multi-pattern / boolean record engine (reference newmgrep.c).

Semantics reproduced from monkey1()/m_short() (newmgrep.c:803-1506):
exact multi-string matching (tr-folded under -i), record extraction
around the *anchor* position (match start + shortest-pattern-length -
1), one output per record for flat OR, full-record terminal accumulation
for flat AND and complex boolean trees, MULTI_OUTPUT per-occurrence
mode, and the -P pattern-index decoration.

The occurrence finding itself is dense and vectorized (the reference's
hashed Boyer-Moore skip loop is a scalar-CPU idiom; on a GPU dense
scanning wins -- SURVEY.md section 7).  On the torch backend a stream of
at least DEVICE_MIN bytes is scanned on the device: a term set within
the exact chain kernel's caps (ops/chain_kernel.py fits(): 127 classes,
32,767 term positions, 8,192-byte terms) by that kernel, whose starts a
pure -c without -w counts by line on the device; past the caps, a set
of ONE_PASS_MIN or more terms by the q-gram filter kernel
(ops/qgram_kernel.py), and a smaller set by the mask-machine kernel in
packed bit-parallel words.  The native passes attribute the kernels'
anchors (a chain start + p_size - 1, or a q-gram candidate) to terms:
the -d flat-OR path takes one max-term row an anchor
(qgram_first_per_anchor_at), every other path the full occurrence
table (qgram_occ_at).  The route is fixed by the backend, the query and
the stream size.  The numpy backend, and every stream under DEVICE_MIN,
takes the host passes (the native C twins, else vectorized numpy).  A
flat-OR print streamed in chunks (a file over AGREP_TORCH_STREAM_MB)
takes its file's route for every chunk: chain_scan, or qgram_filter and
qgram_lines, on the device; qgram_first_per_line on the host
(_region_starts).  A boolean print or count streamed in chunks takes, on
the device route, its file's plane for every chunk (chain_scan's, or
qgram_filter's past the caps) and line_terms, which verifies and folds
the starts by line on the device (_region_lines); off it, one host find
a term and the host's fold.
"""

from __future__ import annotations

import bisect as _bisect
import os

import numpy as np

from ..compile import boolean
from ..options import AgrepError, PROGNAME
from . import trace
from .engine import _ISALNUM_TAB
from .output import Sink

MAXLINE = 1024

# Term count at which occurrence-finding switches to the one-pass
# q-gram filter (below it, packed word groups need few enough passes
# that the exact no-verify device scan wins).
ONE_PASS_MIN = 24

# Smallest stream the torch backend scans on its device.
DEVICE_MIN = 1 << 16


def _fold_tr(nocase: bool) -> np.ndarray:
    tr = np.arange(256, dtype=np.uint8)
    if nocase:
        for i in range(ord("A"), ord("Z") + 1):
            tr[i] = i + 32
    return tr


def _prep_terms(raw_terms: list[str], opts) -> list[bytes]:
    """prepf pattern normalization (newmgrep.c:323-345)."""
    out = []
    for t in raw_terms:
        b = bytearray(t.encode("latin-1"))
        if b and b[0:1] in (b"^", b"$"):
            b[0] = 0x0A
        if len(b) > 1 and b[-1:] in (b"^", b"$") and b[-2:-1] != b"\\":
            b[-1] = 0x0A
        # strip escapes
        res = bytearray()
        i = 0
        while i < len(b):
            if b[i] == 0x5C:  # backslash
                i += 1
                if i < len(b):
                    res.append(b[i])
                    i += 1
            else:
                res.append(b[i])
                i += 1
        if opts.wholeline:
            res = bytearray(b"\n") + res + bytearray(b"\n")
        out.append(bytes(res))
    return out


def _find_occurrences(stream: np.ndarray, term: bytes,
                      tr: np.ndarray) -> np.ndarray:
    """Start positions of folded-exact occurrences of term."""
    n, L = len(stream), len(term)
    if L == 0 or n < L:
        return np.zeros(0, dtype=np.int64)
    from .. import native
    if native.get_lib() is not None:
        out = native.find_occurrences(stream, term, tr)
        if out is not None:
            return out
    folded = tr[stream]
    tf = tr[np.frombuffer(term, dtype=np.uint8)]
    hit = folded[:n - L + 1] == tf[0]
    for k in range(1, L):
        hit &= folded[k:n - L + 1 + k] == tf[k]
    return np.flatnonzero(hit)


class MgrepEngine:
    def __init__(self, q):
        self.q = q
        o = q.opts
        self.terms = _prep_terms(q.terminals, o)
        if not any(self.terms):
            raise AgrepError("%s: the pattern file is empty" % PROGNAME)
        self.p_size = min(len(t) for t in self.terms if t)
        self.tr = _fold_tr(o.nocase is not None)
        self.total_line = 0
        self._qgram_tables = None
        self._qgram_csr = None
        self._chain_prog = None       # exact device scan program
        self._chain_tried = False
        self._chain_dev = None        # its tensors on the scan device
        self._qgram_dev = None        # the q-gram tables on the device
        self._terms_dev = None        # line_terms' tables on the device
        self._vmode = False          # scanning a clamped virtual stream
        self._plain_dirty = False    # non-newline trim mark on the
                                     # plain path (newline-free final
                                     # block): lines cross regions
        # mgrep's scan buffer is malloc'd per file at a constant size
        # (newmgrep.c:476) -- glibc returns the same chunk, so bytes
        # past a short file's final read are the PREVIOUS file's (or
        # the same file's previous block's) data at those offsets.
        # The verify loop (:946) and the wordbound after-byte probe
        # (:875) read them.  Zeros model the first allocation's fresh
        # pages; offsets past 2*BLOCKSIZE are never written.
        self._stale = np.zeros(2 * 16384 + 300, dtype=np.uint8)
        # The chunk is re-malloc'd per file; if the FIRST stdout bytes
        # of the run are emitted between a file's free_buf and the
        # next alloc_buf (-c count lines print in that gap), the stdio
        # buffer (4096+16-byte chunk) is carved from the freed space
        # and the next file's buffer lands 4112 bytes HIGHER -- its
        # content is the old buffer SHIFTED by 4112 (seed 850115,
        # confirmed with an LD_PRELOAD read() logger).  Exactly one
        # shift per process; stdio exists thereafter.
        self._stdio_at_commit = True
        self._stale_shift_done = False
        self._eof_win = None         # current file's post-EOF bytes
        self._stale_upto = None      # early-return stop: blocks READ
        self._eof_subs = []          # stale-completed term candidates
        self._eof_wb_risky = False
        self._vmode_marks = None
        self._vmode_dmarks = None
        self._vmode_data = None
        self._vmode_dirty = False

    def supports_streaming(self) -> bool:
        """Flat-OR newline record PRINTING streams in O(chunk) (the
        matched lines are disjoint and order-preserving); round 5 adds
        boolean AND/complex record print and count the same way (the
        per-record terminal masks are line-local); -c flat-OR already
        rides the mmap-backed one-pass, and every other mode's block-
        quirk emulation needs the whole stream."""
        q, o = self.q, self.q.opts
        if (q.delimiter_opt or o.invert or o.filename_only or o.silent
                or o.multi_output or o.fileout
                or o.bytecount or o.printoffset or o.printpattern
                or o.wordbound or o.limit_output or o.limit_per_file
                or getattr(o, "limit_total_file", 0)):
            return False
        if self.p_size <= 1:
            return False
        is_bool = q.bool_tree is not None or q.bool_op == "and"
        if o.count and not is_bool:
            return False           # flat-OR -c has its own one-pass
        if not (o.printrecord or o.count):
            return False           # -u: the walks write records
        return not any(t and b"\n" in t for t in self.terms)

    def _stream_precheck(self, data) -> bool:
        """False when the corpus has block-clamp / strncpy-NUL shapes
        whose printed bytes depend on the evolving buffer (the
        whole-file path models those); checks only the ~3% boundary
        windows plus the EOF residue."""
        B2 = 2 * 16384
        n = len(data)
        k = 1
        while True:
            end = min(k * B2, n)
            wlo = max(end - 1025, 0)
            win = np.asarray(data[wlo:end])
            if end - wlo > 1024 \
                    and not bool((win == 0x0A).any()):
                return False        # residue > MAXLINE: clamped copy
            if bool((win == 0).any()):
                return False        # strncpy NUL clamp
            if end >= n:
                break
            k += 1
        tail_lo = max(n - (B2 + 1025), 0)
        tail = np.asarray(data[tail_lo:n])
        nls = np.flatnonzero(tail == 0x0A)
        lo = (tail_lo + int(nls[-1])) if len(nls) else 0
        if n - lo > 2 and bool((np.asarray(data[lo:n]) == 0).any()):
            return False            # EOF rescan carry (newmgrep.c:585)
        if n > B2 and n % B2 != 1:
            # newline-free final read: its trim is a NON-newline mark
            # that splits a line into two scan regions (per-region
            # records / AND masks) -- whole-file path models that
            fstart = (n - 1) // B2 * B2
            if not bool((np.asarray(data[fstart:n]) == 0x0A).any()):
                return False
        return True

    def search_stream_chunked(self, data, sink, D: int) -> None:
        self._stale_shift_check(sink)
        self._prep_eof_stale(np.asarray(data))
        if self._eof_subs or not self._stream_precheck(data):
            # stale-completed tail candidates need the full-table
            # walk (search_stream re-preps; prep is idempotent)
            return self.search_stream(np.asarray(data), sink, D)
        q = self.q
        try:
            if q.bool_tree is not None or q.bool_op == "and":
                return self._bool_stream_chunked(data, sink)
            return self._print_stream_chunked(data, sink)
        finally:
            self._commit_stale(np.asarray(data), sink)

    def _region_starts(self, n: int):
        """The streamed print's source of occurrence starts, chosen once
        for a file of n bytes: a function of a chunk's region (u8, the
        chunk and its halo) that gives, in region coordinates, the starts
        of occurrences whose term lies wholly in the region -- every
        start, or at least each line's first.  In order:

        * the device route with the terms within the chain caps:
          chain_scan's start plane (_chain_starts);
        * the device route past the caps with ONE_PASS_MIN or more live
          terms: qgram_filter and qgram_lines, one row a line (its first
          winner's anchor, start + p_size - 1);
        * the host (the numpy backend, or a file under DEVICE_MIN) with
          ONE_PASS_MIN or more live terms: the native twin of qgram_lines,
          qgram_first_per_line;
        * otherwise one _find_occurrences a term.

        Every chunk of the file takes the same route, a last chunk under
        DEVICE_MIN included; a failed build or launch raises."""
        from .. import native
        terms = [t for t in self.terms if t]
        dev = self._device_route(n)
        if dev and self._chain_program() is not None:
            return self._chain_starts
        many = len(terms) >= ONE_PASS_MIN
        if many and dev:
            tb = self._tables()

            def first_on_card(region):
                from ..ops import kernels
                with trace.span("device_layer"):
                    rows = self._qgram_lines(region, tb, False)[0]
                    return kernels.to_host(rows[:, 0]) - (tb.p_size - 1)
            return first_on_card
        if many and native.get_lib() is not None:
            tb = self._tables()
            b_off, b_tids, t_bytes, t_off = self._qgram_csr_tables(tb)

            def first_on_host(region):
                # the pass's outputs are views into its scratch: the
                # subtraction copies them before the next chunk's call
                a = native.qgram_first_per_line(
                    region, tb.member, tb.hash_id, b_off, b_tids, t_bytes,
                    t_off, self.tr, tb.p_size, bool(tb.long_),
                    bool(tb.short), False)[0]
                return a - (tb.p_size - 1)
            return first_on_host

        def per_term(region):
            parts = [_find_occurrences(region, t, self.tr) for t in terms]
            return np.concatenate(parts)
        return per_term

    def _print_stream_chunked(self, data, sink) -> None:
        """Streaming flat-OR record print: per chunk, find the term
        occurrences that start in it (over the chunk and a lookahead
        halo of maxlen - 1 bytes, for terms crossing the chunk edge;
        _region_starts), dedup to one record per line, coalesce adjacent
        lines into single writes.  Events in a chunk's unterminated tail
        line defer until their newline arrives.  Byte-identical to
        search_stream (tests force small chunks).

        A chunk [g0, g1) only needs to know which lines hold an
        occurrence starting below g1, so each line's first winner in the
        region is enough:
        * every anchor is start + p_size - 1, so a line's first winner
          (by anchor) is its earliest start;
        * a start below g1 has its whole term inside the region, which
          ends at g1 + maxlen - 1, so the s + L <= N test drops only
          starts at or after g1, and the next chunk, whose region begins
          at g1, finds those;
        * -w never reaches this path (supports_streaming), and the terms
          hold no newline, so a term lies within one line and a line's
          first winner in the region is its earliest start there."""
        from ..ops import scan as scan_ops
        from .. import native
        n = len(data)
        chunk = max(scan_ops.STREAM_CHUNK, 1 << 16)
        maxlen = max(len(t) for t in self.terms if t)
        starts_of = self._region_starts(n)
        fname = bool(getattr(sink, "fname", False))
        # 1-byte final read without a newline: no EOF rescan, so the
        # final record stops BEFORE the last byte and gains no
        # appended newline (newmgrep.c:577 guard)
        no_rescan = (n % (2 * 16384) == 1 and n > 1
                     and int(np.asarray(data[n - 1:n])[0]) != 0x0A)
        g0 = 0
        last_nl = -1
        lastend = 0
        pend = np.empty(0, dtype=np.int64)
        while g0 < n:
            g1 = min(n, g0 + chunk)
            hi = min(g1 + maxlen - 1, n)
            region = np.ascontiguousarray(data[g0:hi])
            ev = np.sort(starts_of(region)) + g0
            ev = ev[ev < g1]
            if trace.ENABLED:
                trace.add("stream_print_chunks")
            body = region[:g1 - g0]
            nld = native.find_delims_all(body, b"\n")
            nl = ((nld + g0) if nld is not None
                  else (np.flatnonzero(body == 0x0A) + g0))
            allp = np.concatenate([pend, ev]) if len(pend) else ev
            pend = np.empty(0, dtype=np.int64)
            if len(allp):
                allp = allp[allp >= lastend]
            if len(allp):
                # terms never contain '\n', so data[s] != '\n' and the
                # first newline >= s bounds s's line
                jdx = np.searchsorted(nl, allp, side="left")
                resolved = jdx < len(nl)
                if g1 >= n:
                    resolved = np.ones(len(allp), dtype=bool)
                else:
                    pend = allp[~resolved]
                    allp = allp[resolved]
                    jdx = jdx[resolved]
            with trace.span("walk"):
                if len(allp):
                    cap_e = n - 1 if no_rescan else n
                    if len(nl):
                        ends = np.where(jdx < len(nl),
                                        nl[np.minimum(jdx,
                                                      len(nl) - 1)] + 1,
                                        np.int64(cap_e))
                        begins = np.where(
                            jdx > 0,
                            nl[np.maximum(jdx - 1, 0)] + 1,
                            np.int64(last_nl + 1))
                    else:
                        ends = np.full(len(allp), cap_e, dtype=np.int64)
                        begins = np.full(len(allp), last_nl + 1,
                                         dtype=np.int64)
                    e_u, first_i = np.unique(ends, return_index=True)
                    b_u = begins[first_i]
                    sink.num_matched += len(e_u)
                    lastend = int(e_u[-1])
                    if not fname:
                        brk = np.flatnonzero(b_u[1:] != e_u[:-1])
                        seg_lo = np.concatenate([[0], brk + 1])
                        seg_hi = np.concatenate([brk, [len(e_u) - 1]])
                        for s_i, h_i in zip(seg_lo.tolist(),
                                            seg_hi.tolist()):
                            sink.write_record(bytes(bytearray(np.asarray(
                                data[int(b_u[s_i]):int(e_u[h_i])]))),
                                h_i - s_i + 1)
                    else:
                        for b_, e_ in zip(b_u.tolist(), e_u.tolist()):
                            sink.emit_fname_prefix()
                            sink.write_record(bytes(bytearray(np.asarray(
                                data[b_:e_]))))
                    # EOF-rescan append (newmgrep.c:571): a final record
                    # without its newline prints one -- unless the rescan
                    # never runs (no_rescan above)
                    if (int(e_u[-1]) == n and n and not no_rescan
                            and int(np.asarray(data[n - 1:n])[0]) != 0x0A):
                        sink.write(b"\n")
            if len(nl):
                last_nl = int(nl[-1])
            g0 = g1

    def _region_lines(self, n: int):
        """The streamed boolean's source of each chunk's lines, chosen
        once for a file of n bytes: on the device route a function of a
        chunk's region and line_terms' other arguments (ops/chain_kernel.py)
        that gives line_terms' (rows, count, carried mask, last newline),
        from chain_scan's start plane within the chain caps, or from
        qgram_filter's candidate plane (its anchors p_size - 1 past their
        starts) past them; None off the device route (the host's find a
        term and fold).  A streamed boolean has p_size >= 2
        (supports_streaming), so its 2-gram projection exists.  Every chunk
        of the file takes the same route, a last chunk under DEVICE_MIN
        included; a failed build or launch raises."""
        if not self._device_route(n):
            return None
        from ..ops import chain_kernel
        if self._chain_program() is not None:
            def plane_of(region):
                return self._chain_plane(region), 0
        else:
            from ..compile import multi as multi_mod
            tb = self._tables()
            proj = multi_mod.member_projection_1024(tb)

            def plane_of(region):
                return self._qgram_plane(region, proj), tb.p_size - 1

        def lines(region, **kw):
            with trace.span("device_layer"):
                (text, plane), shift = plane_of(region)
                got = chain_kernel.line_terms(text, plane, shift,
                                              self._term_tables(text.device),
                                              **kw)
            if trace.ENABLED:
                trace.add("line_terms")
                trace.add("line_terms_rows",
                          0 if got[0] is None else got[1])
            return got
        return lines

    def _term_tables(self, device):
        """The boolean's terms and truth table on device (line_terms'
        tables), once per engine and device."""
        if self._terms_dev is None or self._terms_dev.device != device:
            from ..ops import chain_kernel
            q = self.q
            table = boolean.truth_table(
                q.bool_tree, "and" if q.bool_tree is None else "or",
                [bool(t) for t in self.terms], len(self.terms))
            self._terms_dev = chain_kernel.term_tables(self.terms, self.tr,
                                                       table, device)
        return self._terms_dev

    @staticmethod
    def _write_lines(data, sink, begins, ends, fname: bool, n: int,
                     no_rescan: bool) -> None:
        """Prints the lines [begins[i], ends[i]) of a chunk, in order, and
        the EOF rescan's newline (newmgrep.c:571) after a final line
        without one -- unless the rescan never runs (no_rescan)."""
        with trace.span("walk"):
            for b_, e_ in zip(begins.tolist(), ends.tolist()):
                if fname:
                    sink.emit_fname_prefix()
                sink.write_record(bytes(bytearray(np.asarray(data[b_:e_]))))
            if (int(ends[-1]) == n and n and not no_rescan
                    and int(np.asarray(data[n - 1:n])[0]) != 0x0A):
                sink.write(b"\n")

    def _bool_stream_chunked(self, data, sink) -> None:
        """Streaming boolean AND / complex-tree record print+count:
        per line-aligned chunk, per-term occurrences build the
        per-line terminal masks (newmgrep.c amatched_terminals[];
        terms never contain '\\n', so a line's mask is chunk-local
        once its newline arrives), the tree evaluates vectorized, and
        matched lines print in order.  On the device route each chunk's
        lines come from line_terms (_region_lines: no host find, only the
        count or the rows of the lines that fire come back, and the mask
        of the chunk's unterminated tail line carries to the next chunk);
        otherwise from one host find a term and the host's fold.
        Byte-identical to the whole-file walk (tests force small
        chunks)."""
        from ..ops import scan as scan_ops
        from .. import native
        q, o = self.q, self.q.opts
        n = len(data)
        chunk = max(scan_ops.STREAM_CHUNK, 1 << 16)
        term_ids = [i for i, t in enumerate(self.terms) if t]
        NT = len(self.terms)
        live = np.asarray([bool(t) for t in self.terms])
        is_complex = q.bool_tree is not None
        maxlen = max(len(self.terms[i]) for i in term_ids)
        fname = bool(getattr(sink, "fname", False))
        no_rescan = (n % (2 * 16384) == 1 and n > 1
                     and int(np.asarray(data[n - 1:n])[0]) != 0x0A)
        cap_e = n - 1 if no_rescan else n
        lines_of = self._region_lines(n)
        g0 = 0
        last_nl = -1
        carry = 0
        # pending rows of the unterminated tail line: (pos, tid)
        pend_p = np.empty(0, dtype=np.int64)
        pend_t = np.empty(0, dtype=np.int64)
        while g0 < n:
            g1 = min(n, g0 + chunk)
            hi = min(g1 + maxlen - 1, n)
            region = np.ascontiguousarray(data[g0:hi])
            if trace.ENABLED:
                trace.add("bool_stream_chunks")
            if lines_of is not None:
                rows, k, carry, nl_at = lines_of(
                    region, body=g1 - g0, carry=carry, begin=last_nl + 1,
                    cap_e=cap_e, last=g1 >= n, count_only=bool(o.count),
                    base=g0)
                sink.num_matched += k
                if k and not o.count:
                    from ..ops import kernels
                    with trace.span("device_layer"):
                        r = kernels.to_host(rows)
                    self._write_lines(data, sink, r[:, 0], r[:, 1], fname,
                                      n, no_rescan)
                if nl_at >= 0:
                    last_nl = nl_at
                g0 = g1
                continue
            pp, tt = [pend_p], [pend_t]
            for tid in term_ids:
                st = _find_occurrences(region, self.terms[tid],
                                       self.tr)
                st = st[st + g0 < g1]
                if len(st):
                    pp.append(st + g0)
                    tt.append(np.full(len(st), tid, dtype=np.int64))
            allp = np.concatenate(pp)
            allt = np.concatenate(tt)
            body = region[:g1 - g0]
            nld = native.find_delims_all(body, b"\n")
            nl = ((nld + g0) if nld is not None
                  else (np.flatnonzero(body == 0x0A) + g0))
            pend_p = np.empty(0, dtype=np.int64)
            pend_t = np.empty(0, dtype=np.int64)
            n_lines = len(nl) + (1 if g1 >= n else 0)
            if len(allp):
                jdx = np.searchsorted(nl, allp, side="left")
                if g1 < n:
                    un = jdx >= len(nl)
                    pend_p, pend_t = allp[un], allt[un]
                    allp, allt, jdx = (allp[~un], allt[~un],
                                       jdx[~un])
            else:
                jdx = np.empty(0, dtype=np.int64)
            if n_lines:
                hits = np.zeros((n_lines, NT), dtype=bool)
                if len(allp):
                    hits[jdx, allt] = True
                if is_complex:
                    ok = boolean.eval_tree_vec(q.bool_tree, "or",
                                               hits)
                else:
                    ok = hits[:, live].all(axis=1)
                # a line with no occurrence at all cannot satisfy a
                # pure-AND; complex trees with ~ negation can match
                # empty lines -- the reference only EVALUATES records
                # that registered at least one terminal
                # (amatched_terminals set inside the scan loop,
                # newmgrep.c:894; DOWITHMASK gates the eval)
                any_hit = np.zeros(n_lines, dtype=bool)
                if len(allp):
                    any_hit[jdx] = True
                ok &= any_hit
                sel = np.flatnonzero(ok)
                if len(sel):
                    ends = np.where(sel < len(nl),
                                    nl[np.minimum(sel, len(nl) - 1)]
                                    + 1, np.int64(cap_e))
                    begins = np.where(
                        sel > 0, nl[np.maximum(sel - 1, 0)] + 1,
                        np.int64(last_nl + 1))
                    sink.num_matched += len(sel)
                    if not o.count:
                        self._write_lines(data, sink, begins, ends, fname,
                                          n, no_rescan)
            if len(nl):
                last_nl = int(nl[-1])
            g0 = g1

    def _fast_or_applicable(self, o, q) -> bool:
        """Flat-OR searches over newline records only need the FIRST
        verified match per line (monkey1 jumps to the record end after
        a hit) -- with many terms, enumerating every occurrence is the
        dominant cost, so _first_match_occurrences prunes instead."""
        if q.bool_tree is not None or q.bool_op == "and":
            return False
        if o.multi_output or q.delimiter_opt:
            return False
        if self._vmode_dirty or self._plain_dirty:
            # non-newline region trims split lines: first-per-line
            # pruning would drop the follow-on region's record
            return False
        if self._eof_subs or (o.wordbound and self._eof_wb_risky):
            # post-EOF stale buffer bytes can complete or suppress a
            # match at the file tail: needs the full-table walk
            return False
        n_live = sum(1 for t in self.terms if t)
        if n_live < ONE_PASS_MIN:
            return False
        return not any(t and b"\n" in t for t in self.terms)

    def _prep_eof_stale(self, darr: np.ndarray) -> None:
        """Model what this file's final scan call sees PAST its last
        read byte: buffer offsets >= num_read hold the previous
        block's bytes (same file) or the previous file's (the
        malloc'd chunk is reused, newmgrep.c:476).  Computes the
        300-byte post-EOF window, the wordbound after-byte risk, and
        any stale-completed term candidates.  Idempotent; the
        persistent state advances only in _commit_stale."""
        BLK2 = 2 * 16384
        N = len(darr)
        self._eof_win = None
        self._eof_subs = []
        self._eof_wb_risky = False
        self._stale_upto = None
        if N == 0:
            return
        r = N % BLK2
        if r == 0:
            r = BLK2
        win = np.zeros(300, dtype=np.uint8)
        if N > BLK2:
            # final block's stale tail = the previous block of the
            # SAME file: buffer offset j held data[N-r-BLK2+j]
            src_lo = N - r - BLK2
            hi = min(r + 300, BLK2)
            win[:hi - r] = darr[src_lo + r:src_lo + hi]
        else:
            win[:] = self._stale[r:r + 300]
        self._eof_win = win
        tr = self.tr
        tail_n = min(N, 260)
        fd_tail = tr[np.asarray(darr[N - tail_n:])]
        win_f = tr[win]
        subs = []
        wb_risk = False
        for tid in range(len(self.terms) - 1, -1, -1):
            t = self.terms[tid]
            L = len(t)
            if not t:
                continue
            tf = tr[np.frombuffer(t, np.uint8)]
            if L <= tail_n and bool((fd_tail[tail_n - L:] == tf).all()):
                wb_risk = True      # ends exactly at EOF: after-byte
                                    # is win[0], not 0
            for k in range(max(1, L - 299), L):
                if k > tail_n:
                    continue
                if not bool((fd_tail[tail_n - k:] == tf[:k]).all()):
                    continue
                if bool((win_f[:L - k] == tf[k:]).all()):
                    after = int(win[L - k]) if L - k < 300 else 0
                    subs.append((N - k, tid, after))
        self._eof_subs = subs
        self._eof_wb_risky = wb_risk and _ISALNUM_TAB[int(win[0])]

    def _stale_shift_check(self, sink) -> None:
        """Apply the one-time +4112 stdio-carve shift (see __init__)
        when the run's first output fell between the previous file's
        free_buf and this file's alloc_buf."""
        if (not self._stale_shift_done and not self._stdio_at_commit
                and getattr(sink, "_vs_alloc", True)):
            SH = 4096 + 16
            st = self._stale
            st[:len(st) - SH] = st[SH:].copy()
            st[len(st) - SH:] = 0
            self._stale_shift_done = True

    def _commit_stale(self, darr: np.ndarray, sink=None) -> None:
        if sink is not None:
            self._stdio_at_commit = bool(
                getattr(sink, "_vs_alloc", True))
        BLK2 = 2 * 16384
        if self._stale_upto is not None:
            # -l / -L early returns exit the block loop mid-file: the
            # reused buffer holds only the blocks actually read
            darr = darr[:min(self._stale_upto, len(darr))]
            self._stale_upto = None
        N = len(darr)
        if N == 0:
            return
        r = N % BLK2
        if r == 0:
            r = BLK2
        st = self._stale
        st[:r] = darr[N - r:]
        if N > BLK2:
            st[r:BLK2] = darr[N - BLK2:N - r]

    def _clamp_total_line(self, anchor: int, base: int, n0: int,
                          stream, memory_mode: bool) -> None:
        """A -L limit stop exits the block loop mid-file
        (newmgrep.c:562-565): countline never sees the unread blocks,
        so the INVERSE -c line total drops the newlines past the
        stopping block's end (round-5 seeds 520011/520311) -- and the
        reused-buffer stale model must only advance through the blocks
        actually READ (the -l early return has the same effect,
        seed 570891)."""
        o, q = self.q.opts, self.q
        if memory_mode:
            return
        B2L = 2 * 16384
        if self._vmode:
            # V coords: the stopping scan call is the region holding
            # the anchor; its fill_buf block ends at the block of that
            # region's trim byte (round-5 seed 850457: the clamp must
            # consult the RAW file, not the stitched stream)
            raw = self._vmode_data
            if raw is None or not (o.invert and o.count):
                return
            mks = self._vmode_marks or []
            dmk = self._vmode_dmarks or []
            r = int(np.searchsorted(
                np.asarray(mks, dtype=np.int64),
                max(anchor - base, 0), side="left"))
            n_raw = len(raw)
            if r >= len(dmk):
                return               # final region/EOF rescan: no cut
            bend = min((int(dmk[r]) // B2L + 1) * B2L, n_raw)
            self._stale_upto = bend
            if bend >= n_raw:
                return
            beyond = int(np.count_nonzero(
                np.asarray(raw[bend:]) == 0x0A))
            if beyond:
                self.total_line -= beyond
            return
        d_off = max(anchor - base, 0)
        bend = min((d_off // B2L + 1) * B2L, n0)
        self._stale_upto = bend
        if not (o.invert and o.count):
            return
        if bend >= n0:
            return
        src = np.asarray(stream[base + bend:base + n0])
        beyond = int(np.count_nonzero(src == 0x0A))
        if beyond:
            self.total_line -= beyond

    def _device_route(self, n: int) -> bool:
        """True when the torch backend scans this stream on its device:
        a stream of at least DEVICE_MIN bytes.  The route depends on the
        backend and the stream size only; the numpy backend runs every
        pass on the host."""
        from ..ops import scan as scan_ops
        return scan_ops._BACKEND == "torch" and n >= DEVICE_MIN

    @staticmethod
    def _to_device(stream: np.ndarray):
        """The stream as a u8 tensor on the scan device (raises when the
        configured device is missing)."""
        import torch

        from ..ops import kernels
        from ..ops import scan as scan_ops
        scan_ops.require_device()
        return kernels.to_device(stream, torch.device(scan_ops._DEVICE))

    def _chain_program(self):
        """compile_chain's program of the terms, compiled once per
        engine; None past the chain kernel's caps."""
        if not self._chain_tried:
            from ..ops import chain_kernel
            self._chain_tried = True
            self._chain_prog = chain_kernel.compile_chain(
                self.terms, self.tr)
        return self._chain_prog

    def _chain_plane(self, stream: np.ndarray):
        """(text, start plane) of the chain kernel (ops/chain_kernel.py)
        over the stream on the scan device, the one-pass -f scan, for a
        caller on the device route; None when the term set is past the
        kernel's caps: callers then take the q-gram kernel, the mask
        machine or the host passes.  A failed launch raises."""
        if self._chain_program() is None:
            return None
        from ..ops import chain_kernel
        with trace.span("device_layer"):
            text = self._to_device(stream)
            if (self._chain_dev is None
                    or self._chain_dev.class_of.device != text.device):
                self._chain_dev = chain_kernel.device_program(
                    self._chain_prog, text.device)
            plane = chain_kernel.chain_scan(text, self._chain_dev)
        if trace.ENABLED:
            trace.add("chain_scans")
        return text, plane

    def _chain_starts(self, stream: np.ndarray) -> np.ndarray | None:
        """Exact match-start positions from the chain kernel, on the
        host; None as _chain_plane."""
        from ..ops import chain_kernel
        with trace.span("device_layer"):
            got = self._chain_plane(stream)
            if got is None:
                return None
            return chain_kernel.plane_positions(got[1], len(stream))

    def _chain_counts(self, n: int) -> bool:
        """Whether a pure -c of a stream of n bytes counts its lines
        from the chain kernel's starts, as agrep_tpu's _first_match_count
        does: on the device route, without -w, a term set within the
        kernel's caps."""
        return (self._device_route(n) and not self.q.opts.wordbound
                and self._chain_program() is not None)

    def _qgram_counts(self, n: int) -> bool:
        """Whether a pure -c of a stream of n bytes counts its lines on
        the card through qgram_lines: on the device route, past the chain
        kernel's caps, with ONE_PASS_MIN or more live terms and a table
        that is not SHORT (a shortest term of two bytes or more: it has a
        2-gram projection); -w included."""
        return (self._device_route(n) and self.p_size > 1
                and self._chain_program() is None
                and sum(1 for t in self.terms if t) >= ONE_PASS_MIN)

    def _qgram_lines(self, stream: np.ndarray, tb, count_only: bool):
        """(rows, count) of qgram_lines (ops/qgram_kernel.py) over the
        stream on the scan device: qgram_filter's candidate plane verified
        and folded by line on the card, so only the count, or one
        (anchor, term id) row a matching line, comes back.  The tables go
        to the device once per engine and device."""
        from ..compile import multi as multi_mod
        from ..ops import qgram_kernel
        with trace.span("device_layer"):
            text, plane = self._qgram_plane(
                stream, multi_mod.member_projection_1024(tb))
            if (self._qgram_dev is None
                    or self._qgram_dev.device != text.device):
                self._qgram_dev = qgram_kernel.line_tables(
                    tb.member, tb.hash_id, *self._qgram_csr_tables(tb),
                    self.tr, tb.p_size, tb.long_, self.q.opts.wordbound,
                    text.device)
            rows, k = qgram_kernel.qgram_lines(text, plane, self._qgram_dev,
                                               count_only)
        if trace.ENABLED:
            trace.add("qgram_lines")
            trace.add("qgram_line_rows", 0 if rows is None else k)
        return rows, k

    def _qgram_plane(self, stream: np.ndarray, proj: np.ndarray):
        """(text, candidate plane) of the q-gram kernel
        (ops/qgram_kernel.py) over the stream on the scan device: the
        2-gram member filter for term sets past the chain caps."""
        from ..ops import qgram_kernel
        with trace.span("device_layer"):
            text = self._to_device(stream)
            plane = qgram_kernel.qgram_filter(
                text, qgram_kernel.words_tensor(proj, text.device))
        return text, plane

    def _qgram_positions(self, stream: np.ndarray,
                         proj: np.ndarray) -> np.ndarray:
        """Candidate positions of the q-gram kernel over the stream, on
        the host."""
        from ..ops import chain_kernel
        with trace.span("device_layer"):
            text, plane = self._qgram_plane(stream, proj)
            return chain_kernel.plane_positions(plane, text.numel())

    def _device_anchors(self, stream: np.ndarray, tb):
        """(plane, shift) of the -d first-per-anchor pass's candidate
        anchors, from the card, as a u32 bit plane on the host (bit b of
        word w is anchor 32 w + b + shift): the chain kernel's start
        plane within its caps (shift p_size - 1); past them, with
        ONE_PASS_MIN or more live terms, the q-gram kernel's candidate
        plane (shift 0).  None for a SHORT set or fewer terms past the
        caps: those keep the occurrence table's route."""
        got = self._chain_plane(stream)
        shift = tb.p_size - 1
        if got is None:
            if sum(1 for t in self.terms if t) < ONE_PASS_MIN:
                return None
            from ..compile import multi as multi_mod
            proj = multi_mod.member_projection_1024(tb)
            if proj is None:
                return None
            got = self._qgram_plane(stream, proj)
            shift = 0
        from ..ops import kernels
        with trace.span("device_layer"):
            return kernels.to_host(got[1]), shift

    def _apply_seam_rules(self, occ_a, occ_i, occ_s, marks, stream,
                          seam_ctx, virt_append):
        """Block-seam observability (newmgrep.c:480-567): each region's
        scan buffer holds the memcpy'd delimiter at start-dl..start-1
        (:511-512) and begins candidates at start-1 (monkey1's
        `text = text+start+m1-1`, :832).  A raw-stream occurrence that
        straddles a seam mark m (start < m < anchor) is therefore
        scanned by NEITHER region -- region r-1 stops at anchor <= m,
        region r's earliest candidate has its first byte substituted by
        the spliced delimiter.  Drops those rows and injects the
        substituted-byte candidate at s = m-1 (verified against
        seam_ctx = per-mark (last, prev) context bytes), tagged sub=True
        so the walk consumes it only in the region starting at m.

        Returns (occ_a, occ_i, occ_s, occ_sub); occ_sub is None when no
        rows were injected and none need region gating."""
        q = self.q
        m1 = self.p_size - 1
        n_occ = len(occ_a)
        marks_arr = np.asarray(marks, dtype=np.int64)
        if not len(marks_arr) or self.p_size < 2:
            return occ_a, occ_i, occ_s, None
        if n_occ:
            ki = np.searchsorted(marks_arr, occ_s, side="right")
            big = np.int64(1) << 60
            mv = np.where(ki < len(marks_arr),
                          marks_arr[np.minimum(ki, len(marks_arr) - 1)],
                          big)
            cross = occ_a > mv
            if cross.any():
                keep = ~cross
                occ_a, occ_i, occ_s = (occ_a[keep], occ_i[keep],
                                       occ_s[keep])
        # substituted candidates at each seam's s = m-1
        inj_a, inj_i, inj_s = [], [], []
        if seam_ctx is not None:
            # cheap prefilter: candidates need a term whose FIRST byte
            # folds to a context byte -- with per-32KB seams and no
            # such term (the usual case), skip the whole loop
            tr0 = self.tr
            heads = {int(tr0[t[0]]) for t in self.terms if t}
            ctx_heads = set()
            for m0 in marks_arr.tolist():
                c0 = seam_ctx(m0)
                if c0 is not None:
                    ctx_heads.add(int(tr0[c0[0]]))
                    if len(ctx_heads) > 8:
                        break
            if not (heads & ctx_heads):
                seam_ctx = None
        if seam_ctx is not None:
            n_st = len(stream)
            dl = len(q.delim) if q.delimiter_opt else 0
            isaln = _ISALNUM_TAB
            tr = self.tr
            for m in marks_arr.tolist():
                if m < 1:
                    continue
                ctx = seam_ctx(m)
                if ctx is None:
                    continue
                c_last, c_prev = ctx
                fl = int(tr[c_last])
                win = -1
                for tid in range(len(self.terms) - 1, -1, -1):
                    t = self.terms[tid]
                    if not t or fl != int(tr[t[0]]):
                        continue
                    L = len(t)
                    seg = np.asarray(stream[m:m + L - 1])
                    if len(seg) < L - 1:
                        if virt_append and dl:
                            seg = np.concatenate([
                                seg, np.frombuffer(q.delim,
                                                   np.uint8)])[:L - 1]
                        if len(seg) < L - 1:
                            continue
                    tf = tr[np.frombuffer(t[1:], np.uint8)]
                    if not bool((tr[seg] == tf).all()):
                        continue
                    if self.q.opts.wordbound:
                        ap = m + L - 1
                        if ap < n_st:
                            after = int(stream[ap])
                        elif virt_append and dl and ap - n_st < dl:
                            after = q.delim[ap - n_st]
                        else:
                            after = 0
                        if isaln[after] or isaln[c_prev]:
                            continue
                    win = tid
                    break
                if win >= 0:
                    inj_a.append(m + m1 - 1)
                    inj_i.append(win)
                    inj_s.append(m - 1)
        if not inj_a:
            # region gating still needed when a raw row's anchor sits
            # exactly on a mark (p_size==2: region r's first probe
            # position) -- only then can the walk mis-assign it
            if m1 == 1 and len(occ_a) \
                    and bool(np.isin(occ_a, marks_arr).any()):
                return occ_a, occ_i, occ_s, np.zeros(len(occ_a),
                                                     dtype=bool)
            return occ_a, occ_i, occ_s, None
        occ_sub = np.zeros(len(occ_a), dtype=bool)
        occ_a = np.concatenate([occ_a,
                                np.asarray(inj_a, dtype=np.int64)])
        occ_i = np.concatenate([occ_i,
                                np.asarray(inj_i, dtype=np.int64)])
        occ_s = np.concatenate([occ_s,
                                np.asarray(inj_s, dtype=np.int64)])
        occ_sub = np.concatenate([occ_sub,
                                  np.ones(len(inj_a), dtype=bool)])
        # (anchor asc, raw before sub, idx desc) -- the walk's
        # first-per-(anchor, class) convention
        order = np.lexsort((-occ_i, occ_sub, occ_a))
        return (occ_a[order], occ_i[order], occ_s[order],
                occ_sub[order])

    def _apply_eof_stale_rows(self, occ_a, occ_i, occ_s, occ_sub, o,
                              base, n_data, bound, has_rescan,
                              term_len, stream):
        """Post-EOF stale-buffer effects on the final scan call
        (newmgrep.c:946 verify overrun, :875 wordbound after-byte):

        * a match ending exactly at EOF, observed by a BLOCK call
          (anchor <= bound), sees after = stale[r] -- drop it when
          that byte is alnum under -w (the EOF rescan's copy, when it
          runs, sees the appended delimiter instead and keeps its own
          rows);
        * a term whose tail completes in the stale bytes matches in
          the reference but has no raw-stream twin -- inject it.

        Returns the updated (occ_a, occ_i, occ_s, occ_sub)."""
        eof_end = base + n_data
        changed = False
        # m_short ABORTS on a hit at its textend before registration
        # (newmgrep.c:1345): the anchor ON the final trim refires in
        # the EOF rescan, whose after-context is the appended
        # delimiter, not the stale byte -- strict bound for p_size==1
        strict = self.p_size == 1
        if (o.wordbound and self._eof_wb_risky and len(occ_a)):
            ends = occ_s + term_len[occ_i]
            at = ends == eof_end
            if has_rescan:
                at &= (occ_a < bound) if strict else (occ_a <= bound)
            if at.any():
                keep = ~at
                occ_a, occ_i, occ_s = (occ_a[keep], occ_i[keep],
                                       occ_s[keep])
                if occ_sub is not None:
                    occ_sub = occ_sub[keep]
                changed = True
        inj_a, inj_i, inj_s = [], [], []
        m1 = self.p_size - 1
        isaln = _ISALNUM_TAB
        for s_d, tid, after in self._eof_subs:
            st = base + s_d
            a = st + m1
            # m_short probes its textend but ABORTS there before
            # registration (newmgrep.c:1345) -- for p_size==1 the
            # bound position itself never fires
            if (a >= bound if strict else a > bound):
                continue            # past the block call's textend
            if o.wordbound:
                bp = st - 1
                before = int(stream[bp]) if 0 <= bp < len(stream) \
                    else 0
                if isaln[after] or isaln[before]:
                    continue
            inj_a.append(a)
            inj_i.append(tid)
            inj_s.append(st)
        if inj_a:
            changed = True
            if occ_sub is None:
                occ_sub = np.zeros(len(occ_a), dtype=bool)
            occ_a = np.concatenate(
                [occ_a, np.asarray(inj_a, dtype=np.int64)])
            occ_i = np.concatenate(
                [occ_i, np.asarray(inj_i, dtype=np.int64)])
            occ_s = np.concatenate(
                [occ_s, np.asarray(inj_s, dtype=np.int64)])
            occ_sub = np.concatenate(
                [occ_sub, np.zeros(len(inj_a), dtype=bool)])
        if changed and occ_sub is not None and len(occ_a):
            order = np.lexsort((-occ_i, occ_sub, occ_a))
            occ_a, occ_i, occ_s, occ_sub = (
                occ_a[order], occ_i[order], occ_s[order],
                occ_sub[order])
        elif changed and len(occ_a):
            order = np.lexsort((-occ_i, occ_a))
            occ_a, occ_i, occ_s = (occ_a[order], occ_i[order],
                                   occ_s[order])
        return occ_a, occ_i, occ_s, occ_sub

    def _verify_at(self, stream, tb, anchors):
        """Winning term per candidate anchor: max pattern index whose
        occurrence (tr-folded, wordbound-checked when -w) ends its
        p_size prefix at the anchor.  Returns int64[len(anchors)] term
        ids, -1 where nothing verifies."""
        from ..compile import multi as multi_mod
        o = self.q.opts
        n = len(stream)
        p = tb.p_size
        best = np.full(len(anchors), -1, dtype=np.int64)
        starts0 = anchors - (p - 1)
        ok0 = starts0 >= 0
        idxs = np.flatnonzero(ok0)
        if not len(idxs):
            return best
        a = anchors[idxs]
        if tb.short:
            hv = self.tr[stream[a]].astype(np.int32)
        else:
            f1a = (stream[a] & np.uint8(31)).astype(np.int32)
            f1b = (stream[a - 1] & np.uint8(31)).astype(np.int32)
            hv = (f1a << multi_mod.HBITS) + f1b
            if tb.long_:
                f1c = (stream[a - 2] & np.uint8(31)).astype(np.int32)
                hv = ((hv << multi_mod.HBITS) + f1c) & multi_mod.MASK5
        keep = tb.member[hv]
        idxs, a, hv = idxs[keep], a[keep], hv[keep]
        if not len(idxs):
            return best
        folded = self.tr[stream]
        bid = tb.hash_id[hv]
        order = np.argsort(bid, kind="stable")
        bid_s, idxs_s, a_s = bid[order], idxs[order], a[order]
        edges = np.flatnonzero(np.diff(bid_s)) + 1
        gs = np.concatenate([[0], edges, [len(bid_s)]])
        isaln = _ISALNUM_TAB
        for gi in range(len(gs) - 1):
            lo, hi = gs[gi], gs[gi + 1]
            if lo == hi:
                continue
            b = int(bid_s[lo])
            sub_i = idxs_s[lo:hi]
            starts_all = a_s[lo:hi] - (p - 1)
            distinct: dict = {}
            for tid in tb.bucket_list[b]:
                distinct.setdefault(self.terms[tid], []).append(int(tid))
            for t, tids in distinct.items():
                L = len(t)
                okm = starts_all + L <= n
                s = starts_all
                sel = np.flatnonzero(okm)
                s = s[sel]
                tf = self.tr[np.frombuffer(t, dtype=np.uint8)]
                for k in range(L):
                    if not len(s):
                        break
                    m = folded[s + k] == tf[k]
                    s, sel = s[m], sel[m]
                if not len(sel):
                    continue
                if o.wordbound:
                    ap = s + L
                    after = np.where(ap < n, stream[np.minimum(ap, n - 1)],
                                     0)
                    bp = s - 1
                    before = np.where(bp >= 0,
                                      stream[np.maximum(bp, 0)], 0)
                    wok = ~isaln[after] & ~isaln[before]
                    sel = sel[wok]
                if not len(sel):
                    continue
                tid_max = max(tids)
                tgt = sub_i[sel]
                cur = best[tgt]
                best[tgt] = np.where(cur > tid_max, cur, tid_max)
        return best

    def _tables(self):
        """The terms' q-gram tables (compile/multi.py), built once per
        engine."""
        if self._qgram_tables is None:
            from ..compile import multi as multi_mod
            self._qgram_tables = multi_mod.build_qgram_tables(
                self.terms, self.tr)
        return self._qgram_tables

    def _qgram_csr_tables(self, tb):
        """CSR-packed bucket/term tables for the native q-gram pass."""
        if self._qgram_csr is None:
            from ..compile import multi as multi_mod
            self._qgram_csr = multi_mod.csr_tables(tb, self.terms)
        return self._qgram_csr

    def _first_match_count(self, stream: np.ndarray, tb) -> int | None:
        """Matched-line COUNT via the native pass, no materialized
        occurrence table (one corpus walk, no output growth); None when
        the native library is unavailable.  Where _chain_counts holds,
        the count of lines that hold a chain-kernel start instead, and
        where _qgram_counts holds the count of qgram_lines, both computed
        on the device."""
        if len(stream) < tb.p_size:
            return 0
        if self._chain_counts(len(stream)):
            # terms never contain \n here (the _fast_or_applicable
            # gate), so a match lies inside one line and the count is
            # the number of distinct lines holding an exact start
            from ..ops import chain_kernel
            with trace.span("device_layer"):
                text, plane = self._chain_plane(stream)
                return chain_kernel.lines_with_starts(text, plane)
        if self._qgram_counts(len(stream)):
            return self._qgram_lines(stream, tb, True)[1]
        from .. import native
        if native.get_lib() is None:
            return None
        b_off, b_tids, t_bytes, t_off = self._qgram_csr_tables(tb)

        def count_of(chunk):
            return int(native.qgram_first_per_line(
                chunk, tb.member, tb.hash_id, b_off, b_tids,
                t_bytes, t_off, self.tr, tb.p_size, bool(tb.long_),
                bool(tb.short), bool(self.q.opts.wordbound),
                count_only=True))

        n = len(stream)
        nthreads = min(4, os.cpu_count() or 1)
        par_min = int(os.environ.get("AGREP_TORCH_PAR_MIN",
                                     str(8 << 20)))
        if n < par_min or nthreads <= 1:
            return count_of(stream)
        # matched-line counting is line-local: split at newlines and
        # run the C pass per chunk concurrently (ctypes releases the
        # GIL; count_only uses no shared scratch)
        cuts = [0]
        for k in range(1, nthreads):
            t = n * k // nthreads
            w = 4096
            cut = None
            while t + w <= n + w:
                seg = np.asarray(stream[t:min(t + w, n)])
                nlp = np.flatnonzero(seg == 0x0A)
                if len(nlp):
                    cut = t + int(nlp[0]) + 1
                    break
                t += w
                if t >= n:
                    break
            cuts.append(cut if cut is not None else n)
        cuts.append(n)
        cuts = sorted(set(cuts))
        if len(cuts) < 3:
            return count_of(stream)
        from concurrent.futures import ThreadPoolExecutor
        parts = [stream[a:b] for a, b in zip(cuts, cuts[1:]) if b > a]
        with ThreadPoolExecutor(len(parts)) as ex:
            return sum(ex.map(count_of, parts))

    def _first_match_occurrences(self, stream: np.ndarray, tb) -> dict:
        """Reduced occurrence table for flat-OR: ONLY the winning
        (first-anchor, max-idx) entry of each matched line.  The
        downstream record walk selects exactly these lines, so output
        is identical to the full table, but verification cost is
        O(matched lines x tries), not O(occurrences) -- the vectorized
        analog of monkey1's record jump."""
        from ..compile import multi as multi_mod
        n = len(stream)
        occ = {i: np.zeros(0, dtype=np.int64)
               for i in range(len(self.terms))}
        p = tb.p_size
        if n < p:
            return occ
        # on the device route the chain scan has declined this term set
        # (_all_occurrences tried it first): qgram_lines verifies the
        # q-gram kernel's candidates on the card and sends back each
        # line's first winner.  SHORT tables have no projection and stay
        # on the host
        if self._device_route(n) and not tb.short:
            from ..ops import kernels
            with trace.span("device_layer"):
                rows = kernels.to_host(self._qgram_lines(stream, tb,
                                                         False)[0])
            return self._occ_from_pairs(rows[:, 0], rows[:, 1], p)
        # native twin: the same dense filter + bucket verify + line
        # jump as one C pass (agrep_host.cpp qgram_first_per_line)
        from .. import native
        if native.get_lib() is not None:
            b_off, b_tids, t_bytes, t_off = self._qgram_csr_tables(tb)
            out = native.qgram_first_per_line(
                stream, tb.member, tb.hash_id, b_off, b_tids,
                t_bytes, t_off, self.tr, p, bool(tb.long_),
                bool(tb.short), bool(self.q.opts.wordbound))
            if out is not None:
                res_a, res_i = out
                for tid in np.unique(res_i):
                    tid = int(tid)
                    occ[tid] = res_a[res_i == tid] - (p - 1)
                return occ
        h = multi_mod.qgram_hashes(stream, tb, self.tr)
        rel = np.flatnonzero(tb.member[h])
        anchors = rel + (0 if tb.short else p - 1)
        if not len(anchors):
            return occ
        nl = np.flatnonzero(stream == 0x0A)
        line_of = np.searchsorted(nl, anchors + 1, side="left")
        uline, off = np.unique(line_of, return_index=True)
        cnt = np.diff(np.append(off, len(anchors)))
        res_a = np.full(len(uline), -1, dtype=np.int64)
        res_i = np.full(len(uline), -1, dtype=np.int64)
        pending = np.arange(len(uline))
        k = 0
        while len(pending):
            sel = off[pending] + k
            valid = sel < off[pending] + cnt[pending]
            pending, sel = pending[valid], sel[valid]
            if not len(pending):
                break
            a = anchors[sel]
            best = self._verify_at(stream, tb, a)
            hit = best >= 0
            res_a[pending[hit]] = a[hit]
            res_i[pending[hit]] = best[hit]
            pending = pending[~hit]
            k += 1
        won = res_i >= 0
        res_a, res_i = res_a[won], res_i[won]
        for tid in np.unique(res_i):
            tid = int(tid)
            # downstream computes anchor = start + (p_size - 1)
            occ[tid] = res_a[res_i == tid] - (p - 1)
        return occ

    def _all_occurrences_native(self, stream: np.ndarray,
                                tb) -> dict | None:
        """Full occurrence table via the one-pass C filter+verify
        (native qgram_occ_all); None when the lib is unavailable."""
        from .. import native
        if native.get_lib() is None:
            return None
        if len(stream) < tb.p_size:
            return {i: np.zeros(0, dtype=np.int64)
                    for i in range(len(self.terms))}
        b_off, b_tids, t_bytes, t_off = self._qgram_csr_tables(tb)
        out = native.qgram_occ_all(
            stream, tb.member, tb.hash_id, b_off, b_tids, t_bytes,
            t_off, self.tr, tb.p_size, bool(tb.long_), bool(tb.short))
        if out is None:
            return None
        return self._occ_from_pairs(out[0], out[1], tb.p_size)

    def _verified_at(self, stream: np.ndarray, tb, anchors: np.ndarray):
        """Verified (anchor, tid) rows, in anchor order, at the given
        ascending candidate anchors (the q-gram kernel's): the rows
        qgram_occ_all gives there, from the native pass qgram_occ_at;
        None when the lib is unavailable."""
        from .. import native
        b_off, b_tids, t_bytes, t_off = self._qgram_csr_tables(tb)
        return native.qgram_occ_at(
            stream, anchors, tb.member, tb.hash_id, b_off, b_tids,
            t_bytes, t_off, self.tr, tb.p_size, bool(tb.long_),
            bool(tb.short))

    def _occ_from_pairs(self, res_a: np.ndarray, res_i: np.ndarray,
                        p: int) -> dict:
        """{term id: start positions} of every term from verified
        (anchor, tid) rows in anchor order (start = anchor - (p - 1))."""
        occ = {i: np.zeros(0, dtype=np.int64)
               for i in range(len(self.terms))}
        order = np.argsort(res_i, kind="stable")
        i_s = res_i[order]
        a_s = res_a[order]
        edges = np.flatnonzero(np.diff(i_s)) + 1
        gs = np.concatenate([[0], edges, [len(i_s)]])
        for gi in range(len(gs) - 1):
            lo, hi = int(gs[gi]), int(gs[gi + 1])
            if lo == hi:
                continue
            occ[int(i_s[lo])] = a_s[lo:hi] - (p - 1)
        return occ

    def _first_per_anchor_cols(self, stream: np.ndarray, dl: int, o,
                               delim_marks=None, virt_append=False):
        """-d flat-OR event stream straight from the native pass: the
        replay consumes exactly one max-tid row per anchor (occ_first),
        so the full per-term occurrence table, its python assembly
        loop, and the lexsort are skipped entirely.

        The main C pass runs directly over the stream (no whole-file
        ext concatenate); on the device route it walks only the card's
        anchors (_device_anchors, qgram_first_per_anchor_at).  Two SMALL
        edge windows reproduce the leading memcpy'd-delimiter context
        (start < p) and -- when the EOF rescan's appended delimiter is
        kept virtual (virt_append) -- the tail crossings into it.
        Returns (occ_a, occ_i, occ_s) in stream coordinates (wordbound
        already applied), or None when ineligible (on the device route
        also where the card gives no anchors)."""
        q = self.q
        if (q.bool_tree is not None or q.bool_op == "and"
                or o.multi_output or self.p_size <= 1):
            return None
        from .. import native
        if native.get_lib() is None:
            return None
        tb = self._tables()
        p = tb.p_size
        n = len(stream)
        m1 = self.p_size - 1
        dref = np.frombuffer(q.delim, dtype=np.uint8)
        maxlen = max((len(t) for t in self.terms if t), default=p)
        b_off, b_tids, t_bytes, t_off = self._qgram_csr_tables(tb)

        def cpass(buf, jump, marks=None, anchors=None):
            tables = (tb.member, tb.hash_id, b_off, b_tids, t_bytes, t_off,
                      self.tr, p, bool(tb.long_), bool(tb.short),
                      bool(o.wordbound))
            kw = dict(delim=(q.delim if jump else None), marks=marks,
                      maxs=self.p_size)
            if anchors is None:
                return native.qgram_first_per_anchor(buf, *tables, **kw)
            return native.qgram_first_per_anchor_at(buf, *anchors, *tables,
                                                    **kw)

        dev = self._device_route(n)
        ctx_h = maxlen + p + dl + 8
        if n <= ctx_h + 16:
            if dev:
                return None     # the table path takes it on the card
            # tiny stream: one legacy-shaped buffer covers everything
            parts = [dref, stream] + ([dref] if virt_append else [])
            buf = np.concatenate(parts)
            out = cpass(buf, False)
            if out is None:
                return None
            a_b, t_b = out
            occ_s = (a_b - dl) - (p - 1)
            occ_a = occ_s + m1
            return occ_a, t_b.copy(), occ_s.copy()

        marks = (np.asarray(delim_marks, dtype=np.int64)
                 if delim_marks else None)
        anchors = None
        if dev:
            # the main pass walks the card's anchors only: a position
            # that is no candidate never verifies
            anchors = self._device_anchors(stream, tb)
            if anchors is None:
                return None
        out = cpass(stream, True, marks, anchors)
        if out is None:
            return None
        a_m, t_m = out
        a_m, t_m = a_m.copy(), t_m.copy()     # scratch views
        cut_h = p                              # starts below: window
        keep = (a_m - (p - 1)) >= cut_h
        a_m, t_m = a_m[keep], t_m[keep]

        # head window: leading memcpy'd delimiter context
        hbuf = np.concatenate([dref, stream[:ctx_h]])
        ha, ht = cpass(hbuf, False)
        h_s = (ha - dl) - (p - 1)
        hk = h_s < cut_h
        h_s, ht = h_s[hk].copy(), ht[hk].copy()

        parts_s = [h_s, a_m - (p - 1)]
        parts_t = [ht, t_m]

        if virt_append:
            # tail window: the EOF rescan's appended delimiter
            ctx_t = maxlen + p + 8
            lo2 = max(0, n - ctx_t - 1)
            tbuf = np.concatenate([stream[lo2:], dref])
            ta, tt = cpass(tbuf, False)
            cut_t = lo2 + p                    # gram anchors >= : T's
            keep_m = (parts_s[1] + (p - 1)) < cut_t
            parts_s[1] = parts_s[1][keep_m]
            parts_t[1] = parts_t[1][keep_m]
            t_s = (ta + lo2) - (p - 1)
            tk = (ta + lo2) >= cut_t
            parts_s.append(t_s[tk].copy())
            parts_t.append(tt[tk].copy())

        occ_s = np.concatenate(parts_s)
        occ_i = np.concatenate(parts_t)
        if o.wordbound and delim_marks:
            # occurrences starting exactly at a region's scan start
            # (the residue dup byte) see the context memcpy'd
            # delimiter before them (newmgrep.c:511): the C pass
            # judged them with the raw previous byte -- re-verify
            # those positions with before = delim[-1]
            dm_w = np.asarray(delim_marks, dtype=np.int64)
            keep_w = ~np.isin(occ_s, dm_w)
            ex_s, ex_i = [], []
            dlast = q.delim[-1]
            if not _ISALNUM_TAB[dlast]:
                n_st2 = len(stream)
                folded = None
                for mk in delim_marks:
                    best = -1
                    for tid in range(len(self.terms) - 1, -1, -1):
                        t = self.terms[tid]
                        L = len(t)
                        if not t or mk + L > n_st2 + dl:
                            continue
                        if folded is None:
                            folded = self.tr[np.asarray(stream)]
                        seg = folded[mk:mk + L]
                        if len(seg) < L:
                            # tail crossing into the virtual append
                            ext2 = np.concatenate([
                                seg, self.tr[np.frombuffer(
                                    q.delim, np.uint8)]])[:L]
                            seg = ext2
                        tf = self.tr[np.frombuffer(t, np.uint8)]
                        if not bool((seg == tf).all()):
                            continue
                        aft = (int(stream[mk + L])
                               if mk + L < n_st2 else q.delim[0])
                        if _ISALNUM_TAB[aft]:
                            continue
                        best = tid
                        break
                    if best >= 0:
                        ex_s.append(mk)
                        ex_i.append(best)
            occ_s = occ_s[keep_w]
            occ_i = occ_i[keep_w]
            if ex_s:
                occ_s = np.concatenate(
                    [occ_s, np.asarray(ex_s, dtype=np.int64)])
                occ_i = np.concatenate(
                    [occ_i, np.asarray(ex_i, dtype=np.int64)])
                order_w = np.argsort(occ_s, kind="stable")
                occ_s, occ_i = occ_s[order_w], occ_i[order_w]
        occ_a = occ_s + m1
        return occ_a, occ_i, occ_s

    def _all_occurrences(self, stream: np.ndarray) -> dict:
        """Start positions per term.

        On the device route the exact chain kernel takes a term set of
        any size within its caps, as the JAX engine's device route does.
        Past them, three strategies by term count (newmgrep.c handles
        all sizes with ONE hashed skip loop; dense device scanning
        splits by shape):
        * many terms (>= ONE_PASS_MIN live): on the device route the
          q-gram filter kernel, its candidates verified by the native
          pass; on the host the one-pass q-gram member filter + sparse
          bucket verify (native qgram_occ_all, or compile/multi.py
          qgram_occurrences) -- one corpus pass regardless of pattern
          count, the rebuild of SHIFT1/HASH (newmgrep.c:1725-1851);
        * few terms, large scan: packed bit-parallel word groups, one
          dense mask-machine pass per <=31-position group;
        * few terms, small scan: vectorized per-term host compares."""
        from ..compile import multi as multi_mod
        n_live = sum(1 for t in self.terms if t)
        dev = n_live > 0 and self._device_route(len(stream))
        tb = self._tables() if dev or n_live >= ONE_PASS_MIN else None
        if dev:
            # the exact chain scan: starts have no false positives, so
            # the native pass only attributes term ids at true hits
            starts = self._chain_starts(stream)
            if starts is not None:
                rows = self._verified_at(stream, tb,
                                         starts + (tb.p_size - 1))
                if rows is not None:
                    return self._occ_from_pairs(rows[0], rows[1],
                                                tb.p_size)
                return multi_mod.qgram_occurrences(
                    stream, self.terms, self.tr, tb,
                    cand_anchor_rel=starts)
        if n_live >= ONE_PASS_MIN:
            if self._fast_or_applicable(self.q.opts, self.q):
                return self._first_match_occurrences(stream, tb)
            proj = multi_mod.member_projection_1024(tb) if dev else None
            if proj is None:
                occ_nat = self._all_occurrences_native(stream, tb)
                if occ_nat is not None:
                    return occ_nat
                return multi_mod.qgram_occurrences(stream, self.terms,
                                                   self.tr, tb)
            # past the chain caps: the q-gram kernel marks the candidate
            # anchors, the native pass verifies them
            anchors = self._qgram_positions(stream, proj)
            rows = self._verified_at(stream, tb, anchors)
            if rows is not None:
                return self._occ_from_pairs(rows[0], rows[1], tb.p_size)
            return multi_mod.qgram_occurrences(
                stream, self.terms, self.tr, tb,
                cand_anchor_rel=anchors - (tb.p_size - 1))
        occ = {}
        use_device = len(stream) >= (1 << 16)
        groups, leftover = ([], None)
        if use_device:
            from ..compile.multi import pack_terms
            from ..ops import scan as scan_ops
            groups, leftover_ids = pack_terms(self.terms, self.tr)
            for g in groups:
                pos, w = scan_ops.scan_event_pairs(stream, g.mask,
                                                   g.consts, 0, "bitap",
                                                   None)
                for tid, bit, ln in zip(g.term_ids, g.term_bits,
                                        g.term_lens):
                    sel = pos[(w & np.uint32(bit)) != 0]
                    occ[tid] = (sel - ln + 1).astype(np.int64)
            rest = leftover_ids
        else:
            rest = [i for i, t in enumerate(self.terms) if t]
        for i in rest:
            occ[i] = _find_occurrences(stream, self.terms[i], self.tr)
        for i, t in enumerate(self.terms):
            if i not in occ:
                occ[i] = np.zeros(0, dtype=np.int64)
        return occ

    def search_stream(self, data: np.ndarray, sink: Sink, D: int,
                      memory_mode: bool = False) -> None:
        fresh = not memory_mode and not self._vmode
        if fresh:
            self._stale_shift_check(sink)
            self._prep_eof_stale(np.asarray(data))
        try:
            return self._search_stream_impl(data, sink, D, memory_mode)
        finally:
            if fresh:
                self._commit_stale(np.asarray(data), sink)

    def _search_stream_impl(self, data: np.ndarray, sink: Sink, D: int,
                            memory_mode: bool = False) -> None:
        q, o = self.q, self.q.opts
        dl = len(q.delim)
        n0 = len(data)          # raw file length (data may be rebound)
        clamped = False
        live_append = False
        # ---- clamped residues (newmgrep.c:556-562): records larger
        # than MAXLINE crossing 32KB block ends lose bytes from the
        # scan; search the stitched stream the reference actually saw
        if (not memory_mode and not q.delimiter_opt
                and not self._vmode and len(data) > 1):
            B2 = 2 * 16384
            darr = np.asarray(data)
            ends = np.arange(B2, len(darr) + B2 - 1, B2,
                             dtype=np.int64)
            ends = np.minimum(ends, len(darr))
            from .. import native
            nld = native.find_delims_all(darr, b"\n")
            if nld is None:
                nld = np.flatnonzero(darr == 0x0A)
            if len(nld):
                ki = np.searchsorted(nld, ends)
                lastnl = np.where(ki > 0, nld[np.maximum(ki - 1, 0)],
                                  np.int64(-1))
            else:
                lastnl = np.full(len(ends), -1, dtype=np.int64)
            from . import sgrep_sim
            trigger = bool(((ends - lastnl) > 1024).any()) \
                or sgrep_sim.nul_near_boundaries(darr)
            # non-newline trim on the (non-clamped) plain path: only
            # the final block can have one (an interior newline-free
            # block always trips the clamp trigger above) -- its line
            # spans two scan regions, so first-per-line pruning and
            # line-keyed grouping are unsound for it
            self._plain_dirty = False
            if len(ends):
                fstart = int(ends[-2]) if len(ends) > 1 else 0
                if (int(lastnl[-1]) < fstart
                        and len(darr) - fstart > 1):
                    self._plain_dirty = True
            if not trigger and len(ends):
                # the EOF rescan's residue carry is ALSO strncpy
                # (newmgrep.c:585): a NUL in the final residue
                # zero-fills the rescanned copy -- applies to files
                # of any size, not just block-crossing ones
                lo = max(int(lastnl[-1]), 0)
                if len(darr) - lo > 2:
                    trigger = bool((darr[lo:] == 0).any())
            if trigger:
                V, marks, lossy, dmarks = _mgrep_virtual_stream(darr)
                if lossy:
                    if o.invert and o.count:
                        self.total_line += int(np.count_nonzero(
                            darr == 0x0A))
                    self._vmode = True
                    self._vmode_marks = marks
                    self._vmode_dmarks = dmarks
                    self._vmode_data = darr
                    # a trim that is NOT a newline (no-newline block)
                    # splits a line across scan regions: per-line
                    # pruning is then unsound
                    self._vmode_dirty = any(
                        int(V[mk]) != 0x0A for mk in marks)
                    try:
                        self.search_stream(V, sink, D)
                    finally:
                        self._vmode = False
                        self._vmode_marks = None
                        self._vmode_dmarks = None
                        self._vmode_data = None
                        self._vmode_dirty = False
                    return
        # ---- pure-count fast path: flat-OR -c with no inversion,
        # decorations, or limits needs only the NUMBER of matched
        # lines, which is exactly the winner count of the
        # first-match-per-line pass.  Skipping the padded stream copy
        # and the newline index drops two O(file) allocations whose
        # first-touch page faults dominate wall time on large files.
        # On the device route it counts from the chain kernel's starts
        # (_chain_counts) or, past the chain caps, qgram_lines' lines
        # (_qgram_counts), or steps aside.
        if (not memory_mode and not q.delimiter_opt and self.p_size > 1
                and o.count and not o.invert and not o.filename_only
                and not o.silent and o.limit_output <= 0
                and o.limit_per_file <= 0
                and (not self._device_route(len(data))
                     or self._chain_counts(len(data))
                     or self._qgram_counts(len(data)))
                and self._fast_or_applicable(o, q)):
            cnt = self._first_match_count(data, self._tables())
            if cnt is None:
                occ = self._first_match_occurrences(data, self._tables())
                cnt = sum(len(v) for v in occ.values())
            sink.num_matched += cnt
            return
        trim_end = None      # block-trim boundary (stream coords)
        virt_append = False  # EOF-rescan delimiter kept virtual
        mem_scan_end = None  # memory -d trim: bounds the walk, not
                             # the buffer
        if memory_mode:
            # countline (newmgrep.c:647) runs over num_read -- the
            # UNTRIMMED buffer -- even though the scan end was just
            # cut back
            if o.invert and o.count and not self._vmode:
                self.total_line += int(np.count_nonzero(
                    np.asarray(data) == 0x0A))
            # memory-mode end trim (newmgrep.c:637-644): back to the
            # last newline, or for -d the last delimiter with the weak
            # `newbuf < text+D_length` guard (unlike sgrep's stale
            # 2*MAXLINE offset, mgrep trims whenever one exists)
            end_t = len(data) - 1
            if end_t >= 0 and not q.delimiter_opt:
                while end_t > 1 and int(data[end_t]) != 0x0A:
                    end_t -= 1
                data = data[:end_t + 1]
            elif end_t >= 0:
                # the buffer is NOT sliced: monkey1's verify loop runs
                # FORWARD past textend (`tr[*px] == tr[*qx]` with no
                # bound, newmgrep.c:946), so a term anchored inside
                # the scan can complete in the trimmed-off tail; only
                # the WALK is bounded by the trim (mem_scan_end)
                from . import sgrep_sim
                mem_scan_end = sgrep_sim._mem_delim_trim(
                    np.asarray(data, dtype=np.uint8), q.delim,
                    q.outtail, guard=0)
            stream = data
            base = 0
        else:
            delim_marks = []
            seam_ctx = None
            if q.delimiter_opt:
                # mgrep()'s -d block loop (newmgrep.c:480-567):
                # `memcpy(text+start+residue, D_pattern)` overwrites
                # the first D_length bytes of EVERY block (residue==0
                # makes that the file head on block one); each block is
                # cut back to the last complete delimiter found in its
                # RAW data (the trim search at :503 runs before the
                # overwrite at :512), with the trim byte duplicated
                # into the next scan region (the residue copy at :560
                # has no start++); the EOF residue is rescanned with a
                # delimiter appended (:573-575) only when >1 byte, so
                # anchors past the final trim are seen only by that
                # rescan.
                # one raw delimiter index feeds both the clamp probe
                # and the block walk (each needed the identical
                # full-file scan -- 23% of the -d count wall)
                raw_dends_idx = _find_delims_arr(data, q.delim)
                if _delim_clamp_hit(data, q.delim, q.outtail,
                                    dends=raw_dends_idx):
                    # clamped residues (start<0, newmgrep.c:557-559):
                    # the stitched scan regions are NOT contiguous
                    # data -- bytes drop, the head splice lands inside
                    # block data, NULs truncate carries.  Search the
                    # virtual stream the reference actually scanned;
                    # splices/losses are embedded, so the overwrite
                    # machinery below is bypassed.
                    (V, delim_marks, trim_end, live_append, nlc,
                     _seam_map) = _mgrep_delim_clamp_sim(
                        data, q.delim, q.outtail)
                    seam_ctx = _seam_map.get
                    if o.invert and o.count and not self._vmode:
                        self.total_line += nlc
                    dpat = np.frombuffer(q.delim, dtype=np.uint8)
                    count_fast = (
                        o.count and not o.invert
                        and not o.filename_only and not o.silent
                        and o.limit_output <= 0
                        and o.limit_per_file <= 0 and self.p_size > 1
                        and q.bool_tree is None and q.bool_op != "and"
                        and not o.multi_output)
                    virt_append = live_append and count_fast
                    data = V
                    if live_append and not virt_append:
                        stream = np.concatenate([V, dpat])
                    else:
                        stream = V
                    base = 0
                    clamped = True
                else:
                    ow, delim_marks, trim_end, live_append, raw_dends = \
                        _mgrep_blocks_delim(data, q.delim, q.outtail,
                                            dends=raw_dends_idx)
                    # the non-clamp path guarantees start > dl+2 (the
                    # clamp-hit margin), so every seam's context bytes
                    # are the spliced delimiter's tail
                    _sc = (q.delim[-1],
                           q.delim[-2] if dl >= 2 else 0)
                    seam_ctx = lambda _m, _sc=_sc: _sc  # noqa: E731
                    fname = getattr(data, "filename", None)
                    if fname is not None and not memory_mode:
                        # copy-on-write map: only the pages dirtied by the
                        # block-start overwrites get private copies --
                        # data.copy() on a multi-GB file costs more in
                        # first-touch faults than the entire scan
                        head = np.memmap(fname, dtype=np.uint8,
                                         mode="c")[:len(data)]
                    else:
                        head = data.copy()
                    dpat = np.frombuffer(q.delim, dtype=np.uint8)
                    if ow and dl == 1:
                        head[np.asarray(ow, dtype=np.int64)] = dpat[0]
                    elif ow:
                        owa = np.asarray(ow, dtype=np.int64)
                        idx = (owa[:, None]
                               + np.arange(dl, dtype=np.int64)).ravel()
                        val = np.tile(dpat, len(owa))
                        inb = idx < len(data)
                        head[idx[inb]] = val[inb]
                    # countline (newmgrep.c:518) sees the head overwrites
                    # (:512) but runs BEFORE the residue strncpy (:560):
                    # capture the inverse line count pre-clamp
                    if o.invert and o.count and not self._vmode:
                        self.total_line += int(
                            np.count_nonzero(head == 0x0A))
                    # strncpy residue carries (newmgrep.c:560, :585): a
                    # NUL inside a block's residue zero-fills the rest of
                    # the carried copy -- the next scan (or the EOF
                    # rescan) sees zeros where the raw bytes were
                    clamped = False
                    B2c = 2 * 16384
                    spans = [(mk, min((mk // B2c + 1) * B2c, len(data)))
                             for mk in delim_marks]
                    if trim_end is not None:
                        spans.append((trim_end, len(data)))
                    for s_lo, s_hi in spans:
                        if s_hi - s_lo <= 1:
                            continue
                        seg = np.asarray(head[s_lo:s_hi])
                        z = np.flatnonzero(seg == 0)
                        if len(z) and s_lo + int(z[0]) + 1 < s_hi:
                            head[s_lo + int(z[0]):s_hi] = 0
                            clamped = True
                    # flat-OR count never slices records out of the
                    # stream, so the EOF-rescan delimiter can stay
                    # virtual: the event pass handles the tail in a small
                    # edge window instead of a whole-file concatenate
                    count_fast = (
                        o.count and not o.invert and not o.filename_only
                        and not o.silent and o.limit_output <= 0
                        and o.limit_per_file <= 0 and self.p_size > 1
                        and q.bool_tree is None and q.bool_op != "and"
                        and not o.multi_output)
                    virt_append = live_append and count_fast
                    if live_append and not virt_append:
                        stream = np.concatenate([head, dpat])
                    else:
                        stream = head
                    base = 0
            else:
                stream = np.concatenate([
                    np.frombuffer(b"\n", dtype=np.uint8), data,
                    np.frombuffer(b"\n", dtype=np.uint8)])
                base = 1
                clamped = False
        N = len(stream)
        if o.invert and o.count and not self._vmode \
                and not memory_mode and not q.delimiter_opt:
            # countline over the raw blocks (the -d path counted its
            # overwritten-but-unclamped head above; memory mode
            # counted its untrimmed buffer in the branch above)
            self.total_line += int(np.count_nonzero(data == 0x0A))

        m1 = self.p_size - 1
        # gather (anchor, pat_index, start, length) for all terms.
        # With -d the scan buffer is preceded by a memcpy'd delimiter
        # (newmgrep.c:511): a term may match with its head inside those
        # bytes, so search over delim+stream and shift starts by -dl.
        occ_cols = None
        if q.delimiter_opt and not memory_mode:
            # one max-term row an anchor; on the device route its main
            # pass walks the card's anchors (_device_anchors)
            occ_cols = self._first_per_anchor_cols(
                stream, dl, o, delim_marks, virt_append)
            if occ_cols is None:
                if virt_append:
                    # the fast path owned the virtual tail; the
                    # legacy table path needs it materialized
                    stream = np.concatenate([
                        stream, np.frombuffer(q.delim,
                                              dtype=np.uint8)])
                    virt_append = False
                ext = np.concatenate(
                    [np.frombuffer(q.delim, dtype=np.uint8), stream])
                occ = self._all_occurrences(ext)
                occ = {k: v - dl for k, v in occ.items()}
        else:
            occ = self._all_occurrences(stream)
        # ---- vectorized occurrence table: (anchor, idx, s, tl) columns
        # sorted by (anchor, idx) -- the per-occurrence tuple loop this
        # replaces dominated wall time past ~10^5 occurrences
        isaln = _ISALNUM_TAB
        a_parts, i_parts, s_parts = [], [], []
        term_len = np.asarray([len(t) for t in self.terms],
                              dtype=np.int64)
        if occ_cols is not None:
            # rows are already (first-per-anchor, max idx), anchor-
            # ascending, wordbound-filtered; apply the range and
            # trim-survival filters row-wise and skip the lexsort
            occ_a, occ_i, occ_s = occ_cols
            keep = (occ_a >= m1 - 1) & (occ_s >= -dl)
            occ_a, occ_i, occ_s = occ_a[keep], occ_i[keep], occ_s[keep]
            occ_sub = None
            if delim_marks:
                occ_a, occ_i, occ_s, occ_sub = self._apply_seam_rules(
                    occ_a, occ_i, occ_s, delim_marks, stream,
                    seam_ctx, virt_append)
            n_occ = len(occ_a)
        nd_marks_w = None
        if (o.wordbound and occ_cols is None and not q.delimiter_opt
                and not memory_mode and not self._vmode):
            nd_marks_w = np.asarray(
                [m + base for m in _mgrep_block_ends(data)],
                dtype=np.int64)
        for idx, t in enumerate(self.terms if occ_cols is None else []):
            if not t:
                continue
            starts = np.asarray(occ[idx], dtype=np.int64)
            if not len(starts):
                continue
            if o.wordbound:
                ap = starts + len(t)
                after = np.where(ap < N, stream[np.minimum(ap, N - 1)], 0)
                bp = starts - 1
                before = np.where(bp >= 0,
                                  stream[np.maximum(bp, 0)], 0)
                if q.delimiter_opt:
                    dref = np.frombuffer(q.delim, dtype=np.uint8)
                    # memory mode has no memcpy'd delimiter before the
                    # scan start: the context byte reads as NUL
                    neg = (bp < 0) & (dl + bp >= 0) \
                        & (not memory_mode)
                    if neg.any():
                        before = before.copy()
                        before[neg] = dref[(dl + bp)[neg]]
                    if not memory_mode and delim_marks:
                        # an occurrence starting exactly at a region's
                        # scan start (the residue dup byte) sees the
                        # context memcpy'd delimiter before it
                        # (newmgrep.c:511), not the raw previous byte
                        dm_w = np.asarray(delim_marks, dtype=np.int64)
                        at_mk = np.isin(starts, dm_w)
                        if at_mk.any():
                            before = before.copy()
                            before[at_mk] = dref[-1]
                elif not memory_mode and not self._vmode \
                        and nd_marks_w is not None:
                    # no-delim twin: the byte before a region's scan
                    # start is the written newline (newmgrep.c:500 /
                    # the EOF rescan's :571) -- an occurrence starting
                    # ON a trim mark (the residue dup byte) is
                    # word-bounded by '\n', not by the raw previous
                    # byte (round-5 seed 530213: term 'a' at a
                    # non-newline block trim)
                    at_mk = np.isin(starts, nd_marks_w)
                    if at_mk.any():
                        before = before.copy()
                        before[at_mk] = 0x0A
                elif (not memory_mode and self._vmode
                      and self._vmode_marks):
                    # vmode: region r's scan START in V is mark+1 (V
                    # embeds the dup trim byte), and the byte before
                    # the reference's scan start is the written
                    # newline (newmgrep.c:500/:571), not region r-1's
                    # V byte (round-5 seed 860332: 'alpha' opening
                    # the EOF rescan after a clamped block)
                    mkv_w = np.asarray(self._vmode_marks,
                                       dtype=np.int64) + base + 1
                    at_mk = np.isin(starts, mkv_w)
                    if at_mk.any():
                        before = before.copy()
                        before[at_mk] = 0x0A
                keep = ~isaln[after] & ~isaln[before]
                starts = starts[keep]
                if not len(starts):
                    continue
            anchor = starts + m1
            ok = (anchor >= m1 - 1) & (starts >= -dl)
            if (not q.delimiter_opt and not memory_mode
                    and self.p_size == 1):
                # the stream's leading byte is the VIRTUAL context
                # newline (text[start-1]='\n', newmgrep.c:477): record
                # spans consult it, and monkey1's backward compare can
                # reach it (hence starts >= -dl), but m_short probes
                # candidates AT their start byte from `start` onward --
                # a '\n'-leading term (the prepf ^/$ translation,
                # newmgrep.c:325-326) cannot start on the virtual byte
                ok &= starts >= 1
            starts = starts[ok]
            anchor = anchor[ok]
            if self._vmode and self._vmode_marks and len(starts):
                # a term whose START precedes its scan region's first
                # byte cannot verify in the reference: the byte before
                # each region's start is the spliced newline
                # (newmgrep.c:500, :571), not the previous region's
                # content that V abuts there.  Keep only a 1-byte
                # overlap that coincides with that '\n'.
                mkv_ = np.asarray(self._vmode_marks,
                                  dtype=np.int64) + base
                ki_ = np.searchsorted(mkv_, anchor, side="left")
                # region r's scan starts at mk[r-1]+1 (V holds the
                # trim byte twice: once as region r-1's last byte,
                # once as the carried copy opening region r)
                lb_ = np.where(ki_ > 0,
                               mkv_[np.maximum(ki_ - 1, 0)] + 1,
                               np.int64(-1) << 40)
                miss_ = lb_ - starts
                bad_ = miss_ > 0
                if bad_.any():
                    keep2v = np.ones(len(starts), dtype=bool)
                    for ii in np.flatnonzero(bad_):
                        if not (int(miss_[ii]) == 1
                                and t[:1] == b"\n"):
                            keep2v[ii] = False
                    starts = starts[keep2v]
                    anchor = anchor[keep2v]
                    if not len(starts):
                        continue
                if self.p_size == 1 and len(starts):
                    # m_short ABORTS a call whose candidate sits at
                    # textend (newmgrep.c:1345): an event ON a mark
                    # never fires in its own region.  V carries the
                    # dup trim byte again at mk+1 (the rescan copy),
                    # so the refire is already a separate occurrence
                    # there -- the on-mark row is a phantom (its tail
                    # bytes read region r+1's mangled copy, which the
                    # aborted call never scanned).  The skipped
                    # INVERSE tail flush is modeled by tail_ok on the
                    # raw bytes (round-5 seed 580808).
                    on_mk = np.isin(anchor, mkv_)
                    if on_mk.any():
                        starts = starts[~on_mk]
                        anchor = anchor[~on_mk]
                        if not len(starts):
                            continue
            if len(starts):
                a_parts.append(anchor)
                i_parts.append(np.full(len(starts), idx, dtype=np.int64))
                s_parts.append(starts)
        if occ_cols is None:
            if a_parts:
                occ_a = np.concatenate(a_parts)
                occ_i = np.concatenate(i_parts)
                occ_s = np.concatenate(s_parts)
                # same anchor == same match start; the bucket is probed
                # in DESCENDING pattern-index order (f_prep1 fills
                # slots top-down, newmgrep.c:1783-1813), so the highest
                # index wins the -P decoration and the AND trigger
                order = np.lexsort((-occ_i, occ_a))
                occ_a, occ_i, occ_s = (occ_a[order], occ_i[order],
                                       occ_s[order])
            else:
                occ_a = occ_i = occ_s = np.zeros(0, dtype=np.int64)
            occ_sub = None
            if q.delimiter_opt and not memory_mode and delim_marks:
                occ_a, occ_i, occ_s, occ_sub = self._apply_seam_rules(
                    occ_a, occ_i, occ_s, delim_marks, stream,
                    seam_ctx, virt_append)
            elif (not q.delimiter_opt and not memory_mode
                  and not self._vmode and len(occ_a)
                  and (self._plain_dirty
                       or any(t and b"\n" in t[1:]
                              for t in self.terms))):
                # newline-record seams: same observability geometry
                # (text[start-1]='\n', newmgrep.c:500).  A '\n' trim
                # can only be straddled by a '\n'-bearing term, but a
                # NON-newline trim (newline-free final block) is
                # crossed by ordinary terms too -- e.g. "alpha"
                # spanning the final block boundary is scanned by
                # neither call (round-5 seed 520159).  The substituted
                # candidate reads the written context newline.
                mks = [m + base for m in _mgrep_block_ends(data)]
                ctx_nd = (0x0A, 0)
                occ_a, occ_i, occ_s, occ_sub = self._apply_seam_rules(
                    occ_a, occ_i, occ_s, mks, stream,
                    (lambda _m, _c=ctx_nd: _c), False)
            n_occ = len(occ_a)
        final_abort = False
        if (self.p_size == 1 and not memory_mode
                and not q.delimiter_opt):
            # m_short's `if(text >= textend) return 0`
            # (newmgrep.c:1345): a term matching AT the final scan
            # call's last byte aborts before registration -- the
            # event is neither counted nor output.  (Interior trims
            # re-scan the aborted byte in the next call, so only the
            # final region's last position truly drops.)
            te_fin = (base + len(data)
                      + (1 if (len(data) and data[-1] != 0x0A
                               and len(data) % (2 * 16384) != 1)
                         else 0)) - 1
            if n_occ:
                keep_f = occ_a != te_fin
                if not keep_f.all():
                    occ_a, occ_i, occ_s = (occ_a[keep_f],
                                           occ_i[keep_f],
                                           occ_s[keep_f])
                    n_occ = len(occ_a)
                    final_abort = True   # the return 0 also skips the
                                         # final call's INVERSE tail
            if not final_abort and not self._vmode:
                # a STALE-completed candidate at the same position
                # (previous file's buffer bytes finish the term,
                # _prep_eof_stale) aborts identically without ever
                # producing an event (round-5 seed 570891)
                for s_d, _tid, _aft in self._eof_subs:
                    if base + s_d == te_fin:
                        final_abort = True
                        break

        # -d record spans never consult the newline index
        nl = (np.flatnonzero(stream == 0x0A) if not q.delimiter_opt
              else np.zeros(0, dtype=np.int64))
        if not q.delimiter_opt:
            delim_ends = None
        elif memory_mode or (live_append and not virt_append) \
                or (not memory_mode and clamped):
            # (clamped: the zero-filled residue spans can erase
            # delimiters, so the derived index is stale)
            delim_ends = _find_delims_arr(stream, q.delim)
        else:
            # derive from the raw scan + overwrite windows (saves a
            # second whole-file pass)
            delim_ends = _delim_ends_after_overwrite(
                stream, raw_dends, ow, q.delim)

        n_terms = len(self.terms)
        # m_short's `if (MATCHED) text--` (newmgrep.c:1471) decrements
        # the scan pointer without adjusting CurrentByteOffset, so -b/-q
        # offsets drift +1 per previously output record when the
        # shortest pattern is a single char
        short_drift = [0]
        cbo_region = [-1]    # m_short's text-- drift dies at each
                             # block end: CBO is re-derived from the
                             # scan span there (newmgrep.c:555)
        matched_terms = np.zeros(n_terms, dtype=bool)
        in_record = False
        cur_begin = cur_end = 0
        lastout = base
        resume_at = -1

        def record_span(anchor: int, s: int = None, tl: int = 0):
            lo = hi = None
            if q.delimiter_opt and not memory_mode and delim_marks:
                import bisect
                ki = bisect.bisect_left(delim_marks, anchor)
                lo = delim_marks[ki - 1] if ki > 0 else None
                hi = delim_marks[ki] if ki < len(delim_marks) else None
            b, e = _mgrep_record_span(stream, nl, delim_ends, anchor,
                                      q, base, len(data), lo, hi)
            gb = e
            if (not q.delimiter_opt and not self._vmode
                    and not memory_mode and bounds):
                # records never cross a scan region: curtextbegin is
                # floored at textbegin (= the region's dup trim byte)
                # and curtextend is capped at textend, consuming the
                # trim byte only when it is a newline
                # (newmgrep.c:878-882).  Matters when a trim is NOT a
                # newline (newline-free final block): the nl-derived
                # span would leak into the neighbouring region.
                ri0 = _bisect.bisect_left(bounds, anchor)
                refire = (self.p_size == 1 and ri0 < len(bounds)
                          and bounds[ri0] == anchor)
                if not refire:      # refire fires in region ri0+1
                    if ri0 > 0:
                        mk0 = bounds[ri0 - 1]
                        b = max(b, mk0 + (1 if int(stream[mk0]) == 0x0A
                                          else 0))
                    if ri0 < len(bounds):
                        te0 = bounds[ri0]
                        if (self.p_size >= 2 and anchor == te0
                                and int(stream[te0]) != 0x0A):
                            # monkey1 probes its textend (text ==
                            # textend passes the strict > check):
                            # curtextend = text+1 starts past textend,
                            # so the record ends one byte past the
                            # region (newmgrep.c:880-882)
                            e = min(e, te0 + 1)
                        else:
                            e = min(e, te0
                                    + (1 if int(stream[te0]) == 0x0A
                                       else 0))
                    elif (n0 % (2 * 16384) == 1 and n0 > 1
                          and int(stream[base + n0 - 1]) != 0x0A):
                        # 1-byte final read without a newline: residue
                        # stays 1, the EOF rescan (and its appended
                        # newline) never runs, and the final call's
                        # curtextend stops AT its textend -- the last
                        # byte is outside every record
                        e = min(e, base + n0 - 1)
                    gb = e
            if (self.p_size == 1 and not q.delimiter_opt
                    and not self._vmode and not memory_mode and bounds
                    and anchor <= bounds[-1]):
                # m_short trim-byte abort + refire (newmgrep.c:1345):
                # a SHORT term matching AT a block call's last scanned
                # byte (the trim newline) aborts that call before
                # output -- its record is never printed at full span.
                # The residue copy rescans the same byte as the NEXT
                # call's first position, where curtextbegin is pinned
                # at textbegin (+1 past the newline) and curtextend is
                # bounded by that call's own trim: the record that
                # actually prints is the residue-clipped one.
                ri = _bisect.bisect_left(bounds, anchor)
                if ri < len(bounds) and bounds[ri] == anchor:
                    # non-newline trims (newline-free final block):
                    # the refired record INCLUDES the dup trim byte
                    # (curtextbegin floors at textbegin, which isn't
                    # consumed when it isn't a newline)
                    b = max(b, anchor
                            + (1 if int(stream[anchor]) == 0x0A
                               else 0))
                    e = min(e, _region_end_excl(ri + 1))
                    gb = e
            if self._vmode and self._vmode_marks:
                # records never cross a scan region (curtextbegin/end
                # bounded by textbegin/textend, newmgrep.c:880-886)
                mk = self._vmode_marks
                r = _bisect.bisect_left(mk, anchor - base)
                if r < len(mk):
                    nl_trim = int(stream[mk[r] + base]) == 0x0A
                    rend = mk[r] + base + (1 if nl_trim else 0)
                else:
                    rend = N
                    rawd = self._vmode_data
                    if (rawd is not None and len(rawd) > 1
                            and len(rawd) % (2 * 16384) == 1
                            and int(rawd[len(rawd) - 1]) != 0x0A):
                        # 1-byte final read, no newline: no EOF
                        # rescan -- the final record stops before its
                        # textend byte, no appended newline
                        rend = base + n0 - 1
                rbeg = (mk[r - 1] + 1 + base) if r > 0 else base
                b, e = max(b, rbeg), min(e, rend)
                # an anchor ON a dirty (non-newline) trim byte still
                # belongs to this record: the call-end crossing check
                # evaluates everything matched through textend
                # (newmgrep.c:1015-1019), though the print stops at e
                gb = e + 1 if (r < len(mk) and not nl_trim
                               and e == rend) else e
            return b, e, gb

        def do_output(pat_index: int, anchor: int, begin: int, end: int,
                      change_text: bool, cbo_override=None,
                      off_override=None) -> bool:
            """DO_OUTPUT macro (newmgrep.c:911-971). Returns stop flag.
            off_override: scan-pointer position for the -q subtraction
            when the output fires away from the anchor (the complex
            crossing flush)."""
            sink.num_matched += 1
            if o.filename_only or o.silent:
                if o.filename_only:
                    # FILENAMEONLY returns at the match, but every
                    # prior NON-firing scan call already ran its
                    # INVERSE tail flush (newmgrep.c:1024) -- those
                    # raw region prints precede the filename line
                    if o.invert and not o.count:
                        if self.p_size == 1:
                            inv_advance(_bisect.bisect_right(bounds,
                                                             anchor))
                        else:
                            inv_advance(_bisect.bisect_left(bounds,
                                                            anchor))
                    sink.write_str("%s\n" % sink.current_filename)
                    self._clamp_total_line(anchor, base, n0, stream,
                                           memory_mode)
                    return True
                # SILENT: DO_OUTPUT's `return 0` exits only the
                # CURRENT scan call (newmgrep.c:912) -- the block loop
                # keeps calling monkey1/m_short per block and per EOF
                # rescan, counting once per firing call
                return "region"
            if not o.count:
                if o.invert:
                    # pending region tails are raw fwrites that precede
                    # this hit's decorations (monkey1 prints each
                    # block's tail before the next block runs).
                    # m_short processes textend inclusively but ABORTS
                    # on a match there (newmgrep.c:1330, :1345): the
                    # event actually fires in the NEXT region's rescan
                    # of the duplicated byte -- assign it there
                    if self.p_size == 1:
                        inv_advance(_bisect.bisect_right(bounds,
                                                         anchor))
                    else:
                        inv_advance(_bisect.bisect_left(bounds,
                                                        anchor))
                printed = sink.emit_fname_prefix()
                if o.printpattern:
                    sink.write_str("%d- " % (pat_index + 1))
                    printed = True
                # each block boundary's duplicate byte advances the
                # per-block CurrentByteOffset accumulation by one
                # (newmgrep.c:556-560 copies text[end] twice)
                if cbo_override is not None:
                    cbo = cbo_override
                else:
                    # the text-- drift desyncs within ONE scan call;
                    # the block loop recomputes CBO at call end
                    # (newmgrep.c:550), so a new region resets it.  An
                    # m_short anchor ON a trim mark fires in the NEXT
                    # call's rescan (the textend abort+refire), hence
                    # bisect_right for p_size==1
                    if self.p_size == 1:
                        reg = _bisect.bisect_right(bounds, anchor)
                    else:
                        reg = _bisect.bisect_left(bounds, anchor)
                    if reg != cbo_region[0]:
                        cbo_region[0] = reg
                        short_drift[0] = 0
                    # vmode streams embed the duplicate bytes, so the
                    # stream offset IS the accumulated CBO
                    drift = 0 if self._vmode else _bisect.bisect_left(
                        cbo_marks, anchor - m1 + 1 - base)
                    cbo = anchor - base - m1 + 1 + short_drift[0] + drift
                if o.bytecount:
                    sink.write_str("%d= " % cbo)
                    printed = True
                if o.printoffset:
                    ref = off_override if off_override is not None \
                        else anchor
                    sink.write_str("@%d{%d} " % (cbo - (ref - begin),
                                                 end - begin))
                    printed = True
                if not o.invert:
                    if o.printrecord:
                        sink.write_record(bytes(bytearray(
                            stream[begin:end])))
                    elif printed:
                        sink.write_str("\n")
                else:
                    nonlocal lastout
                    if lastout < begin:
                        sink.write(bytes(bytearray(stream[lastout:begin])))
                    lastout = end
            if (o.limit_output > 0 and sink.num_matched >= o.limit_output) \
                or (o.limit_per_file > 0 and
                    sink.num_matched - sink.prev_num_matched
                    >= o.limit_per_file):
                self._clamp_total_line(anchor, base, n0, stream,
                                       memory_mode)
                return True
            return False

        is_and = q.bool_op == "and" and q.bool_tree is None
        is_complex = q.bool_tree is not None

        # Per-block scan regions (newmgrep.c:480-567): every block's
        # INVERSE complement pointer starts at its own region start --
        # the previous block's trim byte (the residue copy at :560 has
        # no start++, so that byte belongs to both regions and prints
        # twice when no record covers it).
        cbo_marks = []
        if not memory_mode:
            if not q.delimiter_opt:
                cbo_marks = (list(self._vmode_marks) if self._vmode
                             else _mgrep_block_ends(data))
            else:
                cbo_marks = list(delim_marks)
        bounds = [m + base for m in cbo_marks]       # inclusive ends
        # final region's exclusive end (the INVERSE tail bound)
        final_end = base + len(data)
        if mem_scan_end is not None:
            # memory -d: textend = text + (trimmed) end; the walk,
            # record ends, and the INVERSE tail flush all stop there,
            # while occurrences still verify into the raw tail
            final_end = mem_scan_end + 1
        raw_nr = (self._vmode_data if self._vmode else data)
        if not memory_mode and not q.delimiter_opt and len(data) \
                and data[-1] != 0x0A \
                and (len(raw_nr) % (2 * 16384) != 1
                     if raw_nr is not None
                     else len(data) % (2 * 16384) != 1):
            # appended newline (newmgrep.c:570) -- visible only when
            # the EOF rescan runs: a 1-byte final read with no newline
            # leaves residue == 1 and the rescan is skipped (:577).
            # In vmode the 1-byte-read test consults the RAW file (V's
            # length says nothing about the final fill_buf size)
            final_end += 1
        elif not memory_mode and q.delimiter_opt \
                and trim_end is not None:
            final_end += 1          # one appended delim byte (:576)

        # ---- post-EOF stale-buffer rows (previous file / previous
        # block bytes past the final read -- see _prep_eof_stale)
        if (not memory_mode and not self._vmode and not clamped
                and self._eof_win is not None
                and (self._eof_subs
                     or (o.wordbound and self._eof_wb_risky))):
            if q.delimiter_opt:
                has_rescan = bool(live_append)
                eof_bound = trim_end if (has_rescan
                                         and trim_end is not None) \
                    else base + n0 - 1
            else:
                nblocks = (n0 + 2 * 16384 - 1) // (2 * 16384)
                has_rescan = len(cbo_marks) == nblocks and nblocks > 0
                eof_bound = (cbo_marks[-1] + base if has_rescan
                             else base + n0 - 1)
            occ_a, occ_i, occ_s, occ_sub = self._apply_eof_stale_rows(
                occ_a, occ_i, occ_s, occ_sub, o, base, n0, eof_bound,
                has_rescan, term_len, stream)
            n_occ = len(occ_a)

        r_cur = 0

        def _region_start(i):
            if i == 0:
                return base
            # vmode streams EMBED each seam's duplicate trim byte
            # right after the mark, so the next region's print starts
            # past the mark; on the plain path the mark byte itself
            # re-prints (the residue copy re-scans it)
            return bounds[i - 1] + 1 if self._vmode else bounds[i - 1]

        def _region_end_excl(i):
            return bounds[i] + 1 if i < len(bounds) else final_end

        # m_short aborts a block call when a term matches STARTING at
        # its last scanned byte (`if(text >= textend) return 0`,
        # newmgrep.c:1345): the call's INVERSE tail is never printed
        # and the match itself is neither counted nor output.  The
        # forward compare reads the buffer's RAW bytes past the trim,
        # and the abort check PRECEDES the WORDBOUND test -- a raw
        # verify hit at textend aborts even when -w would reject it
        # (round-5 seed 850121: -d o -w -v, term 'a' at the trim).
        # Applies to -d regions too (the trim byte is the scan end).
        tail_ok = None
        if (o.invert and not o.count and self.p_size == 1
                and not memory_mode and cbo_marks):
            dmk = (self._vmode_dmarks if self._vmode else cbo_marks)
            raw = (self._vmode_data if self._vmode else data)
            tail_ok = []
            for td in dmk:
                ok = True
                for t in self.terms:
                    if not t:
                        continue
                    seg = bytes(bytearray(
                        raw[td:td + len(t)]))
                    if len(seg) == len(t) and \
                            self.tr[np.frombuffer(seg, np.uint8)]\
                            .tobytes() == self.tr[np.frombuffer(
                                t, np.uint8)].tobytes():
                        ok = False
                        break
                tail_ok.append(ok)

        def inv_advance(region):
            nonlocal r_cur, lastout
            while r_cur < region:
                e = _region_end_excl(r_cur)
                ok = (tail_ok[r_cur] if tail_ok is not None
                      and r_cur < len(tail_ok) else True)
                if lastout < e and ok:
                    sink.write(bytes(bytearray(stream[lastout:e])))
                r_cur += 1
                lastout = _region_start(r_cur)

        if q.delimiter_opt:
            # Registration ORDER matters for booleans with -d: a hit
            # can land exactly on the record boundary before the
            # scan's crossing reset fires (newmgrep.c:894 vs :980,
            # :1001), terminals containing the delimiter anchor at
            # curtextend, and satisfied outputs jump the scan to the
            # record end.  Replay monkey1's actual skip walk.  Memory
            # mode is the same walk over ONE region (the caller's
            # buffer, trimmed above) with no memcpy'd delimiter before
            # the scan start and no EOF-rescan bytes after it.
            p_size = self.p_size
            m1w = p_size - 1
            short_mode = p_size == 1   # m_short (newmgrep.c:1300-1506)
            multilen = sum(len(t) + 1 for t in self.terms if t)
            LONG = 1 if (multilen > 400 and p_size > 2) else 0
            HB = 5
            tr1 = (self.tr & 31).astype(np.int32)
            SHIFT1 = np.full(32768, p_size - 1 - LONG, dtype=np.int32)
            for t in self.terms:
                if not t:
                    continue
                tbuf = np.frombuffer(t, dtype=np.uint8)
                for jj in range(p_size - 1, LONG, -1):
                    h = int(tr1[tbuf[jj]])
                    h = (h << HB) + int(tr1[tbuf[jj - 1]])
                    if LONG:
                        h = (h << HB) + int(tr1[tbuf[jj - 2]])
                    if SHIFT1[h] >= p_size - 1 - jj:
                        SHIFT1[h] = p_size - 1 - jj
            # bucket order is descending pattern index (f_prep1 fills
            # HASH slots top-down); one entry processed per candidate
            # (the hit path goto-exits the bucket loop).  Sorted by
            # (anchor, -idx), the FIRST row per anchor carries the
            # winning (max) pattern index.
            if occ_cols is not None:
                first = None         # rows are already one-per-anchor
            elif n_occ:
                if is_and or is_complex:
                    # the bucket loop only `break`s once MATCHED
                    # (newmgrep.c:978): until the boolean satisfies,
                    # EVERY verifying entry at an anchor registers --
                    # keep all rows (descending tid per anchor)
                    first = np.arange(n_occ, dtype=np.int64)
                elif occ_sub is not None:
                    # raw and substituted seam rows at the same anchor
                    # belong to DIFFERENT regions: keep one per class
                    first = np.flatnonzero(np.concatenate(
                        [[True], (occ_a[1:] != occ_a[:-1])
                         | (occ_sub[1:] != occ_sub[:-1])]))
                else:
                    first = np.flatnonzero(np.concatenate(
                        [[True], occ_a[1:] != occ_a[:-1]]))
            else:
                first = np.zeros(0, dtype=np.int64)
            nz_terms = np.asarray([bool(t) for t in self.terms])
            # hash context: the bytes before each scan start are the
            # memcpy'd delimiter (newmgrep.c:511); folded lazily --
            # _hs(i) = tr1 code of stream position i-dl
            _dref = np.frombuffer(q.delim, dtype=np.uint8)
            _n_st = len(stream)

            def _hs(i):
                j = i - dl
                if j < 0:
                    # memory mode: no memcpy'd delimiter -- the bytes
                    # before the caller's buffer read as NUL
                    return int(tr1[_dref[i]]) if not memory_mode else 0
                if j < _n_st:
                    return int(tr1[stream[j]])
                # virtual EOF-rescan delimiter bytes (file mode only)
                k = j - _n_st
                return (int(tr1[_dref[k]])
                        if k < dl and not memory_mode else 0)
            de_arr = delim_ends

            cbo_base = [0]

            # ---- anchor-driven replay.  The per-byte skip walk's
            # observable effects happen only at verified-match anchors
            # (occ_first), at DOW crossing flushes, and through the
            # m_short CBO carry; everything between is stepping, which
            # matters ONLY for flush timing ("does some visit land in
            # [cure-1, anchor)?").  Stepping never skips an anchor (an
            # occurrence's interior grams bound SHIFT1 below the
            # distance to its anchor -- the BM safety invariant), so
            # iterating anchors with searchsorted jumps is exact; the
            # skip-phase is resolved per-step only inside the rare
            # ambiguity window [cure-1, cure-1+max_shift).
            if first is None:
                wa, wi, ws = occ_a, occ_i, occ_s
                wl = None            # looked up lazily (term_len[wi])
                w_sub = occ_sub
            elif n_occ:
                wa = occ_a[first]
                wi = occ_i[first]
                ws = occ_s[first]
                wl = term_len[occ_i[first]]
                w_sub = occ_sub[first] if occ_sub is not None else None
            else:
                wa = wi = ws = wl = np.zeros(0, dtype=np.int64)
                w_sub = None
            # ---- native count walk: pure flat-OR -c consumes the
            # event rows without any output state, so the whole
            # region replay runs in C (threaded across regions)
            if (first is None and o.count and not o.invert
                    and not o.filename_only and not o.silent
                    and not o.multi_output and o.limit_output <= 0
                    and o.limit_per_file <= 0
                    and not (is_and or is_complex) and not short_mode
                    and w_sub is None
                    and os.environ.get(
                        "AGREP_TORCH_NO_NATIVE_WALK") != "1"):
                from .. import native
                cnt = native.mgrep_or_count_walk(
                    stream, q.delim, self.tr, SHIFT1, LONG, m1w,
                    wa, de_arr, np.asarray(bounds, dtype=np.int64),
                    base, final_end, bool(q.outtail))
                if cnt is not None:
                    sink.num_matched += cnt
                    return
            if not short_mode:
                MAXS = max(m1w - LONG, 1)
                # lazy per-position shift (delimiter context below 0);
                # materializing SHIFT1 over the whole stream cost more
                # in fresh-page faults than the entire walk

                def _sh_at(t):
                    i = dl + t
                    h = _hs(i) << HB
                    h += _hs(i - 1) if i >= 1 else 0
                    if LONG:
                        h = (h << HB) + (_hs(i - 2) if i >= 2 else 0)
                    return int(SHIFT1[h])

                def first_visit_ge(t, X):
                    # skip-walk phase: first visited position >= X
                    # starting from exact position t (candidate
                    # positions step by 1: `if(!MATCHED) shift=1`)
                    while t < X:
                        t += max(_sh_at(t), 1)
                    return t

            def walk_region(r):
                nonlocal lastout, r_cur
                if o.invert and not o.count:
                    # each block call resets its complement pointer to
                    # its own region start BEFORE scanning (m_short
                    # :1313, monkey1 :829) -- switch regions eagerly so
                    # lastout never rewinds over consumed records
                    inv_advance(r)
                tb_region = _region_start(r)
                te = _region_end_excl(r) - 1      # inclusive textend
                drift = 0       # m_short outputs: `text--` without
                                # CurrentByteOffset--, +1 each
                DOW = False
                amatched = np.zeros(len(self.terms), dtype=bool)
                curb = cure = cur_anchor = 0
                tb_jump = tb_region
                cbo_tail = None   # post-jump cbo when nv overshoots te

                def cbo_at(t):
                    return cbo_base[0] + (t - tb_region + 1) + drift

                def flush(v_cbo):
                    nonlocal DOW
                    DOW = False
                    if is_complex and boolean.eval_tree_vec(
                            q.bool_tree, "or", amatched[None, :])[0]:
                        rc2 = do_output(0, cur_anchor, curb, cure,
                                        False,
                                        v_cbo if short_mode else None)
                        if rc2:
                            return rc2
                    amatched[:] = False
                    return False

                def region_fired_exit():
                    # SILENT: DO_OUTPUT's `return 0` exits the call
                    # BEFORE its INVERSE tail flush (newmgrep.c:912 vs
                    # :1024) -- a firing call prints no complement at
                    # all; advance past this region without printing.
                    # The block loop's POST-CALL limit check
                    # (newmgrep.c:562-565) still runs: a fired-silent
                    # call that trips -L stops the whole scan
                    nonlocal r_cur, lastout
                    if o.invert and not o.count:
                        r_cur = r + 1
                        lastout = (_region_start(r + 1)
                                   if r + 1 <= len(bounds)
                                   else final_end)
                    if _limits_reached_mg(o, sink):
                        self._clamp_total_line(te, base, n0, stream,
                                               memory_mode)
                        return True
                    return False

                nv = tb_region if short_mode else tb_region + m1w - 1
                j = int(np.searchsorted(wa, nv, side="left"))

                def _skip_inelig(jj):
                    # seam rows are region-bound: a substituted-byte
                    # candidate (s = mark-1, first byte = the spliced
                    # delimiter tail) exists only for the region
                    # starting at its mark; a raw row whose start
                    # precedes this region's first byte belongs to the
                    # PREVIOUS region's scan (p_size==2 shares the
                    # anchor position across the seam)
                    if w_sub is None:
                        return jj
                    while jj < len(wa):
                        if w_sub[jj]:
                            if int(ws[jj]) == tb_region - 1:
                                return jj
                        elif r == 0 or int(ws[jj]) >= tb_region:
                            return jj
                        jj += 1
                    return jj

                while True:
                    j = _skip_inelig(j)
                    a = int(wa[j]) if j < len(wa) else None
                    if a is not None and a > te:
                        a = None
                    if DOW:
                        if a is None:
                            # no more events: the crossing flush fires
                            # at the first visit >= cure-1 (every
                            # region ends with text walking past te,
                            # so it always fires; cure <= te+1)
                            if short_mode:
                                v = max(nv, cure - 1)
                                vc = (cbo_at(min(v, te)) if v <= te
                                      else (cbo_tail if cbo_tail
                                            is not None else cbo_at(te)))
                            else:
                                vc = None
                            fr = flush(vc)
                            if fr == "region":
                                return region_fired_exit()
                            if fr:
                                return True
                            break
                        flush_before = False
                        if nv >= cure - 1:
                            flush_before = nv < a
                        elif a >= cure - 1:
                            if short_mode or a >= cure - 1 + MAXS:
                                flush_before = True
                            else:
                                flush_before = first_visit_ge(
                                    nv, cure - 1) < a
                        if flush_before:
                            v = max(nv, cure - 1)
                            fr = flush(cbo_at(v) if short_mode
                                       else None)
                            if fr == "region":
                                return region_fired_exit()
                            if fr:
                                return True
                    if a is None:
                        break
                    # ---- process the event at anchor a
                    idx, s_ = int(wi[j]), int(ws[j])
                    tl_ = (int(wl[j]) if wl is not None
                           else int(term_len[idx]))
                    if short_mode and a >= te:
                        # m_short aborts the whole block scan on a hit
                        # at textend (newmgrep.c:1345) BEFORE any
                        # registration or output -- its return 0 also
                        # skips the block's INVERSE tail print
                        if o.invert and not o.count:
                            inv_advance(r)
                            r_cur = r + 1
                            lastout = (_region_start(r + 1)
                                       if r + 1 <= len(bounds)
                                       else final_end)
                        return False
                    if not DOW:
                        # record extraction bounded by the advancing
                        # textbegin (monkey1:885-886)
                        i2 = int(np.searchsorted(
                            de_arr, a - 1, "right")) - 1
                        curb = tb_jump
                        while i2 >= 0:
                            de = int(de_arr[i2])
                            ds = de - dl + 1
                            if ds >= tb_jump and ds + dl <= a:
                                curb = ds + dl if q.outtail else ds
                                break
                            if de < tb_jump:
                                break
                            i2 -= 1
                        j2 = int(np.searchsorted(
                            de_arr, a + dl, "left"))
                        cure = te + 1
                        while j2 < len(de_arr):
                            de = int(de_arr[j2])
                            ds = de - dl + 1
                            if ds >= a + 1 and ds <= te - dl:
                                cure = ds + dl if q.outtail else ds
                                break
                            if ds > te - dl:
                                break
                            j2 += 1
                        if (not q.outtail) or o.invert:
                            tb_jump = cure
                        else:
                            tb_jump = cure - dl
                        DOW = True
                        cur_anchor = a
                    amatched[idx] = True
                    cbo_post = None   # C's cbo value at the post-event
                                      # flush check (short mode only)
                    out_fired = False
                    if is_complex:
                        post = a + tl_ - 1
                        nv = post + 1             # then shift=1
                        cbo_post = cbo_at(post)
                    elif (not is_and
                          or bool(amatched[nz_terms].all())):
                        out_fired = True
                        cbo_out = cbo_at(a)
                        rc3 = do_output(idx, a, curb, cure, True,
                                        cbo_out if short_mode else None)
                        if rc3 == "region":
                            return region_fired_exit()      # next scan call
                        if rc3:
                            return True
                        if o.multi_output:
                            post = a + tl_ - 1
                            nv = post + 1
                            cbo_post = cbo_out + tl_ - 1
                        else:
                            post = tb_jump
                            cbo_post = cbo_out + (post - a)
                            if short_mode:
                                drift += 1        # text-- w/o CBO--
                                nv = post         # revisit (shift 0)
                            else:
                                nv = post + (m1w - 1 if m1w - 1 > 0
                                             else 1)
                    else:
                        post = a                  # registered, shift=1
                        nv = a + 1
                        cbo_post = cbo_at(a)
                    # m_short carry past region end: no further
                    # iterations resync cbo, keep the exit value
                    cbo_tail = cbo_post if (short_mode and post > te) \
                        else None
                    # same-iteration crossing check at the post-event
                    # position (flush_cross after the hit block)
                    if DOW and post >= cure - 1:
                        fr = flush(cbo_post if short_mode else None)
                        if fr == "region":
                            return region_fired_exit()
                        if fr:
                            return True
                    if ((is_and or is_complex) and not out_fired
                            and j + 1 < len(wa)
                            and int(wa[j + 1]) == a):
                        # unsatisfied boolean: the bucket loop doesn't
                        # break (newmgrep.c:978) -- register the next
                        # entry at this same anchor
                        j += 1
                    else:
                        j = int(np.searchsorted(wa, nv, side="left"))
                return False

            for r in range(len(bounds) + 1):
                stop_all = walk_region(r)
                cbo_base[0] += (_region_end_excl(r) - 1
                                - _region_start(r) + 1)
                if stop_all:
                    break
            else:
                if o.invert and not o.count:
                    inv_advance(len(bounds))
                    if lastout < final_end:
                        sink.write(bytes(bytearray(
                            stream[lastout:final_end])))
            return

        # ---- vectorized flat-AND count: over newline records the
        # walk's group == the line of the first anchor, so a record
        # matches iff its line holds every terminal index.  (Terms
        # containing '\n' could make an anchor cross its line; gate
        # them to the sequential walk.)
        if (is_and and not is_complex and not q.delimiter_opt
                and o.count and not o.filename_only and not o.silent
                and not o.multi_output and o.limit_output <= 0
                and o.limit_per_file <= 0
                and not any(t and b"\n" in t for t in self.terms)
                and (n_occ == 0
                     or not bool((stream[occ_a] == 0x0A).any()))):
            if n_occ:
                line_of = np.searchsorted(nl, occ_a + 1, side="left")
                order2 = np.lexsort((occ_i, line_of))
                lo_s, ti_s = line_of[order2], occ_i[order2]
                fresh = np.concatenate(
                    [[True], (lo_s[1:] != lo_s[:-1])
                     | (ti_s[1:] != ti_s[:-1])])
                uline, cnts = np.unique(lo_s[fresh],
                                        return_counts=True)
                sink.num_matched += int(
                    np.count_nonzero(cnts == n_terms))
            return

        # ---- per-record walks over the sorted occurrence table.
        # Semantics identical to the reference's sequential scan, but
        # iteration count is O(matched records), not O(occurrences):
        # record-group boundaries come from searchsorted jumps.
        _nd_sh: dict = {}

        def _nd_first_visit(t, X):
            # SHIFT1 skip-walk phase (monkey1:833-841) over the
            # stream: first visited position >= X from exact t --
            # resolves the complex-boolean flush CBO above
            if "tab" not in _nd_sh:
                tr1l = (self.tr & 31).astype(np.int32)
                multilen = sum(len(tt) + 1 for tt in self.terms if tt)
                lg = 1 if (multilen > 400 and self.p_size > 2) else 0
                s1 = np.full(32768, self.p_size - 1 - lg,
                             dtype=np.int32)
                for tt in self.terms:
                    if not tt:
                        continue
                    tb2 = np.frombuffer(tt, dtype=np.uint8)
                    for jj in range(self.p_size - 1, lg, -1):
                        h = int(tr1l[tb2[jj]])
                        h = (h << 5) + int(tr1l[tb2[jj - 1]])
                        if lg:
                            h = (h << 5) + int(tr1l[tb2[jj - 2]])
                        if s1[h] >= self.p_size - 1 - jj:
                            s1[h] = self.p_size - 1 - jj
                _nd_sh["tab"] = (s1, tr1l, lg)
            s1, tr1l, lg = _nd_sh["tab"]
            n_st = len(stream)
            while t < X and t < n_st:
                h = int(tr1l[stream[t]]) << 5
                if t >= 1:
                    h += int(tr1l[stream[t - 1]])
                if lg:
                    h = (h << 5) + (int(tr1l[stream[t - 2]])
                                    if t >= 2 else 0)
                s = int(s1[h])
                t += s if s > 1 else 1
            return t

        if (o.silent and not o.filename_only and not memory_mode
                and not o.multi_output):
            # SILENT: every scan call (block region, EOF rescan)
            # counts at most once -- DO_OUTPUT's `return 0` exits the
            # call after its first firing record (newmgrep.c:912) and
            # the block loop moves on.  SILENT is only checked AT a
            # firing record: a call with no fire still runs the
            # INVERSE-&&-!COUNT tail flush (newmgrep.c:1024), so -v -s
            # prints every non-firing region in full
            def _inv_flush(r, rs):
                if not (o.invert and not o.count):
                    return
                if r == len(bounds) and final_abort:
                    return        # the abort's return 0 skips it too
                if (tail_ok is not None and r < len(tail_ok)
                        and not tail_ok[r]):
                    return
                re_f = _region_end_excl(r)
                if rs < re_f:
                    sink.write(bytes(bytearray(stream[rs:re_f])))
            for r in range(len(bounds) + 1):
                rs = _region_start(r)
                re_x = _region_end_excl(r)
                if (self.p_size == 1 and r < len(bounds)
                        and not q.delimiter_opt):
                    # m_short aborts a term STARTING at the call's
                    # last byte (`if(text >= textend) return 0`,
                    # newmgrep.c:1346) before num_of_matched++: an
                    # interior trim's final byte fires in the NEXT
                    # region's residue re-scan, not this one
                    re_x -= 1
                k0 = int(np.searchsorted(occ_a, rs, side="left"))
                k1 = int(np.searchsorted(occ_a, re_x, side="left"))
                n_fire = k1 - k0
                if (n_fire and r == len(bounds) and bounds
                        and not self._vmode and not memory_mode
                        and not q.delimiter_opt and self.p_size > 1
                        and self._plain_dirty):
                    # EOF rescan after a NON-newline final trim: the
                    # rescan buffer holds only the residue
                    # (data[mark..]), so an occurrence whose START
                    # precedes the mark cannot re-fire there -- its
                    # head bytes were left behind (round-5 seed
                    # 850258: a term straddling the final 32KB
                    # boundary fires the final-block call via the
                    # forward verify, not the rescan)
                    n_fire = int(np.count_nonzero(
                        occ_s[k0:k1] >= bounds[-1]))
                if not n_fire:
                    _inv_flush(r, rs)
                    continue
                if not (is_and or is_complex):
                    sink.num_matched += 1
                    if _limits_reached_mg(o, sink):
                        # the block loop's post-call limit check
                        # (newmgrep.c:562-565): no further regions
                        # scanned or flushed
                        self._clamp_total_line(int(occ_a[k0]), base,
                                               n0, stream, memory_mode)
                        return
                    continue
                live = np.asarray([bool(t) for t in self.terms])
                p2 = k0
                fired_any = False
                while p2 < k1:
                    anchor = int(occ_a[p2])
                    _cb, _ce, gb2 = record_span(
                        anchor, int(occ_s[p2]),
                        int(term_len[occ_i[p2]]))
                    g2 = min(max(int(np.searchsorted(
                        occ_a, gb2, side="left")), p2 + 1), k1)
                    mt = np.zeros(n_terms, dtype=bool)
                    mt[occ_i[p2:g2]] = True
                    if is_complex:
                        fired = bool(boolean.eval_tree_vec(
                            q.bool_tree, "or", mt[None, :])[0])
                    else:
                        fired = bool(mt[live].all())
                    if fired:
                        sink.num_matched += 1
                        fired_any = True
                        break
                    p2 = g2
                if not fired_any:
                    _inv_flush(r, rs)
                elif _limits_reached_mg(o, sink):
                    self._clamp_total_line(int(occ_a[p2 if p2 < k1
                                                     else k0]),
                                           base, n0, stream,
                                           memory_mode)
                    return        # newmgrep.c:562-565 post-call check
            return

        stop = False
        if o.multi_output and not (is_and or is_complex):
            # MULTI_OUTPUT: per-occurrence resume (rare; glimpse flag)
            pos = 0
            while pos < n_occ and not stop:
                anchor = int(occ_a[pos])
                s = int(occ_s[pos])
                idx = int(occ_i[pos])
                tl = int(term_len[idx])
                if anchor < resume_at:
                    pos += 1
                    continue
                cur_begin, cur_end, _gb = record_span(anchor, s, tl)
                stop = do_output(idx, anchor, cur_begin, cur_end, True)
                resume_at = s + tl - 1
                pos += 1
        elif (not (is_and or is_complex) and not q.delimiter_opt
              and n_occ and not bool((stream[occ_a] == 0x0A).any())
              and not any(t and b"\n" in t for t in self.terms)
              and not (self.p_size >= 2 and not self._vmode
                       and not memory_mode and bounds
                       and bool(np.isin(occ_a, np.asarray(
                           [mb for mb in bounds
                            if int(stream[mb]) != 0x0A],
                           dtype=np.int64)).any()))):
            # flat OR over newline records, no anchor ON a newline:
            # the greedy record jump selects exactly the first anchor
            # of each distinct line -- fully vectorized (an anchor on
            # a '\n' makes the record span TWO lines and the jump can
            # hop the next line's anchors; so does a p>=2 anchor ON a
            # non-newline trim, whose textend-probe record needs the
            # advanced-textbegin sequential walk; both shapes take the
            # sequential loop below)
            line_id = np.searchsorted(nl, occ_a + 1, side="left")
            mkv_plain = None
            if self._vmode and self._vmode_marks:
                # one anchor group per (line, scan region): a line
                # split by a non-newline trim produces a record on
                # each side (the jump stops at textend)
                mkv = np.asarray(self._vmode_marks,
                                 dtype=np.int64) + base
                reg_all = np.searchsorted(mkv, occ_a, side="left")
                key = line_id * (np.int64(len(mkv)) + 2) + reg_all
            elif (not memory_mode and bounds
                  and any(int(stream[mb]) != 0x0A for mb in bounds)):
                # plain path with a non-newline trim (newline-free
                # final block): same region split, shared-dup-byte
                # coordinates
                mkv_plain = np.asarray(bounds, dtype=np.int64)
                # m_short probes its textend and ABORTS on a hit there
                # (newmgrep.c:1345): an anchor ON a trim byte fires in
                # the NEXT call's rescan of the dup byte instead
                reg_all = np.searchsorted(
                    mkv_plain, occ_a,
                    side="right" if self.p_size == 1 else "left")
                key = line_id * (np.int64(len(mkv_plain)) + 2) + reg_all
                mkv = None
            else:
                mkv = None
                key = line_id
            uniq_k, first_idx = np.unique(key, return_index=True)
            uniq = line_id[first_idx]
            if (o.count and not o.invert and not o.filename_only
                    and not o.silent and o.limit_output <= 0
                    and o.limit_per_file <= 0):
                sink.num_matched += len(first_idx)
            else:
                safe_e = np.minimum(uniq, len(nl) - 1)
                cap_e = N
                if (not memory_mode and n0 % (2 * 16384) == 1
                        and n0 > 1
                        and int(stream[base + n0 - 1]) != 0x0A):
                    # no EOF rescan (1-byte final read): the final
                    # call's record stops before its textend byte
                    cap_e = base + n0 - 1
                ends = np.where(uniq < len(nl), nl[safe_e] + 1, N)
                if cap_e < N:
                    ends = np.minimum(ends, cap_e)
                bj = np.searchsorted(nl, occ_a[first_idx] - 1,
                                     side="right") - 1
                begins = np.where(bj >= 0, nl[np.maximum(bj, 0)] + 1, 0)
                if mkv is not None:
                    # curtextend consumes the trim byte only when it
                    # is a newline (newmgrep.c:881-882)
                    r = reg_all[first_idx]
                    mk_i = np.minimum(r, len(mkv) - 1)
                    is_nl = stream[mkv[mk_i]] == 0x0A
                    fin_end = N
                    rawd = self._vmode_data
                    if (rawd is not None and len(rawd) > 1
                            and len(rawd) % (2 * 16384) == 1
                            and int(rawd[len(rawd) - 1]) != 0x0A):
                        # 1-byte final read, no newline: no EOF
                        # rescan -- the final record excludes its
                        # textend byte and the appended newline
                        fin_end = base + n0 - 1
                    rend = np.where(r < len(mkv),
                                    mkv[mk_i] + is_nl.astype(np.int64),
                                    fin_end)
                    rbeg = np.where(r > 0,
                                    mkv[np.maximum(r - 1, 0)] + 1,
                                    base)
                    ends = np.minimum(ends, rend)
                    begins = np.maximum(begins, rbeg)
                elif mkv_plain is not None:
                    # plain coordinates share the dup trim byte: the
                    # region starts AT the mark (textbegin), which the
                    # record includes unless it is a newline
                    r = reg_all[first_idx]
                    mk_i = np.minimum(r, len(mkv_plain) - 1)
                    is_nl = (stream[mkv_plain[mk_i]] == 0x0A)\
                        .astype(np.int64)
                    rend = np.where(r < len(mkv_plain),
                                    mkv_plain[mk_i] + is_nl, N)
                    pmk = mkv_plain[np.maximum(r - 1, 0)]
                    p_nl = (stream[pmk] == 0x0A).astype(np.int64)
                    rbeg = np.where(r > 0, pmk + p_nl, base)
                    ends = np.minimum(ends, rend)
                    begins = np.maximum(begins, rbeg)
                for t in range(len(first_idx)):
                    k = int(first_idx[t])
                    stop = do_output(int(occ_i[k]), int(occ_a[k]),
                                     int(begins[t]), int(ends[t]), True)
                    if self.p_size == 1:
                        short_drift[0] += 1
                    if stop:
                        break
        elif not (is_and or is_complex):
            # flat OR: first hit per record, then jump past the record
            pos = 0
            tb_floor = -1          # monkey1's advancing textbegin:
            tb_floor_reg = -1      # curtextend (-1 with OUTTAIL),
                                   # per scan call (region)
            while pos < n_occ and not stop:
                anchor = int(occ_a[pos])
                idx = int(occ_i[pos])
                cur_begin, cur_end, gbound = record_span(
                    anchor, int(occ_s[pos]), int(term_len[idx]))
                if (self.p_size >= 2 and not memory_mode
                        and not self._vmode and bounds):
                    reg_f = _bisect.bisect_left(bounds, anchor)
                    if reg_f == tb_floor_reg and tb_floor > cur_begin:
                        # a later record in the SAME call floors its
                        # backward scan at the advanced textbegin
                        # (monkey1:878 `curtextbegin > textbegin`)
                        cur_begin = min(tb_floor, cur_end)
                    tb_floor_reg = reg_f
                    tb_floor = (cur_end - 1
                                if q.outtail and not o.invert
                                else cur_end)
                stop = do_output(idx, anchor, cur_begin, cur_end, True)
                if self.p_size == 1:
                    short_drift[0] += 1
                if self.p_size >= 2:
                    # scan resume = textbegin + shift (monkey1:1040):
                    # textbegin is curtextend (-1 with OUTTAIL, :890)
                    # -- but INVERSE keeps curtextend regardless
                    # (monkey1:889 `if (!OUTTAIL || INVERSE)`, round-5
                    # seed 880159); shift = max(m1-1, 1) -- an event
                    # AT the record end (the textend probe) is visited
                    # only when OUTTAIL backs the pointer onto it
                    # (seed 560321 vs 540744)
                    step = max(self.p_size - 2, 1)
                    thr = gbound + step - (1 if q.outtail
                                           and not o.invert else 0)
                else:
                    thr = gbound      # m_short revisits cure (text--)
                nxt = max(int(np.searchsorted(occ_a, thr,
                                              side="left")), pos + 1)
                if (self.p_size == 1 and not q.delimiter_opt
                        and not self._vmode and not memory_mode
                        and bounds):
                    # a record-jump inside call r skips only call r's
                    # scan: a SHORT term anchored ON the trim newline
                    # (= call r+1's first rescanned byte) still fires
                    # in call r+1 with the residue-clipped span (the
                    # record_span trim-refire rule above)
                    mb = gbound - 1
                    ri2 = _bisect.bisect_left(bounds, mb)
                    if (ri2 < len(bounds) and bounds[ri2] == mb
                            and int(stream[mb]) == 0x0A):
                        k_m = int(np.searchsorted(occ_a, mb,
                                                  side="left"))
                        if (pos < k_m < nxt and k_m < n_occ
                                and int(occ_a[k_m]) == mb):
                            nxt = k_m
                pos = nxt
        else:
            # AND / complex tree: group occurrences into records (the
            # crossing test `anchor >= cur_end` == searchsorted jump),
            # accumulate per-record terminal hits, then evaluate
            pos = 0
            while pos < n_occ and not stop:
                anchor = int(occ_a[pos])
                cur_anchor = anchor
                cur_begin, cur_end, gbound = record_span(
                    anchor, int(occ_s[pos]), int(term_len[occ_i[pos]]))
                g_end = max(int(np.searchsorted(occ_a, gbound,
                                                side="left")), pos + 1)
                g_idx = occ_i[pos:g_end]
                if is_complex:
                    matched_terms[:] = False
                    matched_terms[g_idx] = True
                    hits = matched_terms[None, :]
                    if boolean.eval_tree_vec(q.bool_tree, "or", hits)[0]:
                        # AComplexBoolean outputs fire at the record
                        # CROSSING check (newmgrep.c:1015-1019), i.e.
                        # at the first scan VISIT >= curtextend-1:
                        # after the last registration the pointer sits
                        # at anchor + pat_len - 1 (the complex-branch
                        # jump, :897-900), steps once (shift=1), then
                        # SHIFT1-walks; CurrentByteOffset tracks the
                        # pointer minus the p_size-1 warmup, plus one
                        # per prior seam's duplicate byte.  m_short
                        # (p_size == 1) visits every byte, so its
                        # flush lands exactly on the record end.
                        if self.p_size == 1:
                            v_s = cur_end - 1
                            cdrift = 0 if self._vmode else \
                                _bisect.bisect_left(cbo_marks,
                                                    cur_end - base)
                            cbo_v = cur_end - base + cdrift
                        else:
                            a_l = int(occ_a[g_end - 1])
                            tl_l = int(term_len[occ_i[g_end - 1]])
                            post = a_l + tl_l - 1
                            if post >= cur_end - 1:
                                v_s = post
                            else:
                                v_s = _nd_first_visit(post + 1,
                                                      cur_end - 1)
                            v = v_s - base
                            # the drift counts seam dup-bytes ALREADY
                            # rescanned by this call's CBO: a walk
                            # overshooting its own region's trim (loop
                            # exit past textend) must not count that
                            # trailing mark -- cap at the record's
                            # region index (sweep seed 1201234)
                            r_rec = _bisect.bisect_left(
                                cbo_marks, cur_end - 1 - base)
                            cdrift = 0 if self._vmode else min(
                                _bisect.bisect_left(cbo_marks, v),
                                r_rec)
                            cbo_v = (v - (self.p_size - 1) + 1
                                     + cdrift)
                        stop = do_output(0, cur_anchor, cur_begin,
                                         cur_end, False,
                                         cbo_override=cbo_v,
                                         off_override=v_s)
                    pos = g_end
                else:
                    # AND: output at the first prefix position that
                    # covers every terminal (the triggering entry's
                    # idx/anchor feed the decorations)
                    first_pos = np.full(n_terms, -1, dtype=np.int64)
                    rel = np.arange(g_end - pos, dtype=np.int64)
                    # reversed assignment keeps the FIRST entry per term
                    first_pos[g_idx[::-1]] = rel[::-1]
                    if (first_pos >= 0).all():
                        tpos = pos + int(first_pos.max())
                        stop = do_output(int(occ_i[tpos]),
                                         int(occ_a[tpos]),
                                         cur_begin, cur_end, True)
                        if self.p_size == 1:
                            short_drift[0] += 1
                    pos = g_end

        if o.invert and not o.count and not stop:
            inv_advance(len(bounds))
            if lastout < final_end and not final_abort:
                sink.write(bytes(bytearray(stream[lastout:final_end])))


def _limits_reached_mg(o, sink) -> bool:
    """The block loop's post-call limit check (newmgrep.c:562-565)."""
    if o.limit_output > 0 and sink.num_matched >= o.limit_output:
        return True
    if o.limit_per_file > 0 and \
            (sink.num_matched - sink.prev_num_matched) \
            >= o.limit_per_file:
        return True
    return False


def _delim_ends_after_overwrite(stream: np.ndarray,
                                all_dends: np.ndarray,
                                ow, delim: bytes) -> np.ndarray:
    """Delimiter END positions of `stream`, derived from the RAW
    data's ends (all_dends) plus rescans of the small windows around
    each block-start overwrite -- the overwrite can create or destroy
    occurrences only where an occurrence intersects [bs, bs+dl).
    Avoids a second whole-file scan."""
    dl = len(delim)
    n = len(stream)
    if not ow:
        return all_dends
    bs = np.asarray(ow, dtype=np.int64)
    # occurrences with start in (bs - dl, bs + dl) are affected;
    # their END range is [bs - dl + dl - 1 + 1, bs + dl - 1 + dl - 1]
    lo_e = bs                       # end >= (bs - dl + 1) + dl - 1 = bs
    hi_e = bs + 2 * dl - 1          # end <  bs + 2dl - 1
    ki = np.searchsorted(all_dends, lo_e, side="left")
    kj = np.searchsorted(all_dends, hi_e, side="left")
    # windows are 32KB apart, so the [ki, kj) ranges are disjoint:
    # mark range edges with +/-1 and prefix-sum
    delta = np.zeros(len(all_dends) + 1, dtype=np.int64)
    np.add.at(delta, ki, 1)
    np.add.at(delta, kj, -1)
    keep = np.cumsum(delta[:-1]) == 0
    kept = all_dends[keep]
    # rescan the fixed-width windows on the overwritten stream in one
    # gathered matrix; the (at most two) edge-clipped windows go the
    # scalar way
    dref = np.frombuffer(delim, dtype=np.uint8)
    W = 3 * dl - 2
    interior = bs[(bs - dl + 1 >= 0) & (bs + 2 * dl - 1 <= n)]
    new_parts = []
    if len(interior):
        offs = np.arange(-dl + 1, 2 * dl - 1, dtype=np.int64)
        mat = stream[(interior[:, None] + offs[None, :])]
        hits = np.ones((len(interior), W - dl + 1), dtype=bool)
        for k in range(dl):
            hits &= mat[:, k:W - dl + 1 + k] == dref[k]
        rows, cols = np.nonzero(hits)
        if len(rows):
            new_parts.append(interior[rows] + (cols - dl + 1)
                             + dl - 1)
    for b in bs[(bs - dl + 1 < 0) | (bs + 2 * dl - 1 > n)].tolist():
        w_lo = max(b - dl + 1, 0)
        w_hi = min(b + 2 * dl - 1, n)
        if w_hi - w_lo < dl:
            continue
        win = stream[w_lo:w_hi]
        hit = np.ones(len(win) - dl + 1, dtype=bool)
        for k in range(dl):
            hit &= win[k:len(win) - dl + 1 + k] == dref[k]
        pos = np.flatnonzero(hit)
        if len(pos):
            new_parts.append(pos + w_lo + dl - 1)
    if new_parts:
        merged = np.concatenate([kept] + new_parts)
        merged.sort()
        return merged
    return kept


def _find_delims_arr(stream: np.ndarray, delim: bytes) -> np.ndarray:
    if len(stream) < len(delim):
        return np.zeros(0, dtype=np.int64)
    if len(stream) >= (1 << 22):
        # large input: the C scan writes end positions straight into
        # one output array (the numpy path materializes several
        # O(file) bool temporaries, whose first-touch faults dominate)
        from .. import native
        ends = native.find_delims_all(stream, delim)
        if ends is not None:
            return ends
    if len(delim) == 1:
        return np.flatnonzero(stream == delim[0])
    hit = np.ones(len(stream) - len(delim) + 1, dtype=bool)
    for k, b in enumerate(delim):
        hit &= stream[k:len(stream) - len(delim) + 1 + k] == b
    return np.flatnonzero(hit) + len(delim) - 1


def _mgrep_record_span(stream, nl, delim_ends, anchor, q, base,
                       n_data=None, lo_b=None, hi_b=None):
    """Record boundaries around an anchor (newmgrep.c:878-887).

    With -d, extraction is bounded by the scan region the hit fell
    into (monkey1 passes the region's textbegin/textend to
    backward_/forward_delimiter): each region starts at the previous
    block's trim byte (lo_b) and ends at its own trim (hi_b); the
    final region spans to EOF plus the appended delimiter (which the
    forward search can never *find* -- it sits at textend -- so tail
    records print through it)."""
    N = len(stream)
    if not q.delimiter_opt:
        i = int(np.searchsorted(nl, anchor - 1, side="right")) - 1
        begin = int(nl[i]) + 1 if i >= 0 else 0
        j = int(np.searchsorted(nl, anchor + 1, side="left"))
        end = int(nl[j]) + 1 if j < len(nl) else N
        return begin, end
    dl = len(q.delim)
    lo = 0
    hi_data = (n_data if n_data is not None else N) - 1
    # textend sits ON the first appended-delimiter byte
    # (newmgrep.c:576), so a tail record prints exactly one of them
    end_nf = hi_data + 1 + (1 if N > hi_data + 1 else 0)
    if hi_b is not None:                 # bounded (non-final) region
        hi_data = hi_b
        end_nf = hi_b + 1
    if lo_b is not None:
        lo = lo_b
    i = int(np.searchsorted(delim_ends, anchor, side="left")) - 1
    begin = lo
    while i >= 0:
        dstart = int(delim_ends[i]) - dl + 1
        if dstart >= lo:
            begin = dstart + dl if q.outtail else dstart
            break
        i -= 1
    j = int(np.searchsorted(delim_ends, anchor + dl, side="left"))
    end = end_nf
    while j < len(delim_ends):
        dend = int(delim_ends[j])
        dstart = dend - dl + 1
        if dend <= hi_data:
            end = dstart + dl if q.outtail else dstart
            break
        j += 1
    return begin, end


def _mgrep_virtual_stream(data: np.ndarray):
    """The byte stream mgrep actually SCANS when a block residue
    outgrows MAXLINE (newmgrep.c:556-562): `start = MAXLINE - residue`
    goes negative, is forced to 1, and the next fill_buf clobbers every
    residue byte past MAXLINE -- so the scan sees only the residue's
    first MAXLINE-1 bytes stitched onto the next block, and whole spans
    of the file silently vanish.

    Returns (V, marks, lossy, dmarks): V = the stitched scan stream
    (each region re-scans its leading trim byte, so V embeds the
    duplicate bytes the intact-path models with cbo drift marks);
    marks = V-offsets of each region's trim byte (INVERSE region
    bounds); lossy = whether any byte was dropped; dmarks = the DATA
    offsets of those trim bytes (for raw-byte lookahead past them)."""
    MAXLINE = 1024
    BLK = 2 * 16384
    n = len(data)
    pieces = []
    marks = []
    dmarks = []
    vlen = 0
    res = np.zeros(0, dtype=np.uint8)    # starts with the trim byte
    lossy = False
    pos = 0
    while pos < n:
        num_read = min(BLK, n - pos)
        block = np.asarray(data[pos:pos + num_read])
        nls = np.flatnonzero(block == 0x0A)
        # `end` walks back to the block start when no newline exists
        # (newmgrep.c:499): the scan then covers res + one block byte
        end_rel = int(nls[-1]) if len(nls) else 0
        if len(res):
            pieces.append(res)
            vlen += len(res)
        scanned = block[:end_rel + 1]
        pieces.append(scanned)
        vlen += len(scanned)
        last_block = pos + num_read >= n
        trim_data = pos + end_rel        # data offset of the trim byte
        pos += num_read
        residue_full = block[end_rel:]   # starts AT the trim byte
        if not last_block or len(residue_full) > 1:
            marks.append(vlen - 1)       # the trim byte's V offset
            dmarks.append(trim_data)
        if len(residue_full) > MAXLINE and not last_block:
            # the copy lands at text+1 (start<0 clamp, newmgrep.c:558)
            # and the NEXT fill_buf clobbers everything past MAXLINE;
            # the FINAL block's residue has no following read, so it
            # survives whole and the EOF pass rescans all of it
            lossy = True
            res = residue_full[:MAXLINE - 1]
        else:
            res = residue_full
        # the carry is strncpy (newmgrep.c:560): it stops at the
        # first NUL and zero-fills the rest of the copy
        z = np.flatnonzero(res == 0)
        if len(z):
            res = res.copy()
            res[int(z[0]):] = 0
            lossy = True
    if len(res) > 1:
        # EOF residue rescan (newmgrep.c:577): covers the surviving
        # residue again, trim byte included
        pieces.append(res)
        vlen += len(res)
    V = (np.concatenate(pieces) if pieces
         else np.zeros(0, dtype=np.uint8))
    return V, marks, lossy, dmarks


def _mgrep_block_ends(data: np.ndarray) -> list:
    """Data offsets of each block's trailing newline (mgrep's 32KB
    block loop, newmgrep.c:480-567).  The byte at each mark prints
    twice under INVERSE (the residue copy lacks a start++)."""
    BLK = 2 * 16384
    marks = []
    pos = 0
    N = len(data)
    while pos < N:
        num_read = min(BLK, N - pos)
        span_end = pos + num_read          # exclusive, data coords
        # the trim search floor is MAXLINE -- only the FRESH read is
        # examined (`end > MAXLINE`, newmgrep.c:499): a newline-free
        # block trims at its own first byte, never inside the residue
        seg = data[pos:span_end]
        nl = np.flatnonzero(seg == 0x0A)
        if len(nl):
            e = pos + int(nl[-1])
        else:
            e = pos
        pos += num_read
        residue = span_end - e             # includes the duplicate byte
        if pos < N or residue > 1:
            # intermediate block, or the EOF residue rescan
            # (newmgrep.c:577 runs only when residue > 1)
            marks.append(e)
    return marks


def _delim_clamp_hit(data, delim, outtail, dends=None) -> bool:
    """True when any -d block residue exceeds MAXLINE=1024, i.e. the
    `start = MAXLINE - residue` computation goes negative and the
    reference clamps it to 1 (newmgrep.c:557-559), losing residue
    bytes and displacing the head splice.  Block trim positions are
    derivable from RAW data even under clamps (the trim search at
    :503 scans only the fresh read), so detection is exact."""
    BLK = 2 * 16384
    dl = len(delim)
    N = len(data)
    all_dends = (dends if dends is not None
                 else _find_delims_arr(data, delim))
    starts = np.arange(0, N, BLK, dtype=np.int64)
    ends_in = np.minimum(starts + BLK, N) - 1
    if len(all_dends):
        j1 = np.searchsorted(all_dends, starts + dl - 1, side="left")
        j2 = np.searchsorted(all_dends, ends_in, side="right") - 1
        has = j2 >= j1
        le = np.where(has, all_dends[np.clip(j2, 0,
                                             len(all_dends) - 1)], -1)
    else:
        has = np.zeros(len(starts), dtype=bool)
        le = np.full(len(starts), -1, dtype=np.int64)
    if outtail:
        t_arr = np.where(has, le, -1)
    else:
        ok = has & ((le - dl + 1) - starts >= dl)
        t_arr = np.where(ok, le - dl, -1)
    trims = np.where(t_arr >= 0, t_arr, ends_in)
    residues = ends_in - trims + 1
    # margin: keep start > dl+2 on the fast path so every seam's
    # candidate context is the spliced delimiter tail (start <= dl
    # skips the splice and exposes stale buffer bytes -- the byte-sim
    # models those exactly)
    return bool((residues > 1024 - dl - 4).any())


def _mgrep_delim_clamp_sim(data, delim, outtail):
    """Faithful byte-level simulation of mgrep()'s -d block loop
    (newmgrep.c:476-585) for runs with clamped residues: one
    persistent buffer reproduces the residue strncpy (incl. NUL
    truncation), the start<0 clamp's byte loss, the head splice
    landing inside block data, and read-clobber interactions.

    Returns (V, marks, trim_end, live_append, nl_count, ctxs): V is the
    concatenation of every scan call's [start, end] span in the
    OVERLAP model (each seam's duplicated trim byte appears once,
    shared -- the walk's existing region convention); marks/trim_end
    are V offsets with _mgrep_blocks_delim semantics; nl_count is
    countline's total (newlines per fresh block after the splices,
    newmgrep.c:518)."""
    MAXLINE = 1024
    BLK = 2 * 16384
    dl = len(delim)
    N = len(data)
    dpat = np.frombuffer(delim, dtype=np.uint8)
    buf = np.zeros(MAXLINE + BLK + dl + 4, dtype=np.uint8)
    pieces = []
    ctxs = []      # per scan call: (buf[start-1], buf[start-2]) after
                   # the splice writes -- region r's candidate at
                   # start-1 reads these, not the previous block's data
    start, residue, pos = MAXLINE, 0, 0
    nl_count = 0
    while pos < N:
        num_read = min(BLK, N - pos)
        buf[MAXLINE:MAXLINE + num_read] = data[pos:pos + num_read]
        buf_end = MAXLINE + num_read - 1
        # backward_delimiter over the fresh read (delim.c:75-95)
        seg_ends = _find_delims_arr(buf[MAXLINE:buf_end + 1], delim)
        newbuf = buf_end + 1
        if len(seg_ends):
            nb = MAXLINE + int(seg_ends[-1]) - dl + 1   # last start
            cand = nb + (dl if outtail else 0)
            if cand >= MAXLINE + dl:
                newbuf = cand
        end = newbuf - 1
        if start > dl:
            buf[start - dl:start] = dpat
        buf[start + residue:start + residue + dl] = dpat
        nl_count += int(np.count_nonzero(
            buf[MAXLINE:MAXLINE + num_read] == 0x0A))
        ctxs.append((int(buf[start - 1]) if start >= 1 else 0,
                     int(buf[start - 2]) if start >= 2 else 0))
        pieces.append(buf[start:end + 1].copy())
        residue = buf_end - end + 1
        ns = MAXLINE - residue
        if ns < 0:
            ns = 1
        src = buf[end:end + residue].copy()
        z = np.flatnonzero(src == 0)
        if len(z):                    # strncpy NUL truncation
            src[int(z[0]):] = 0
        buf[ns:ns + residue] = src
        start = ns
        pos += num_read
    live_append = False
    if residue > 1:                   # EOF residue rescan (:577)
        if start > dl:
            buf[start - dl:start] = dpat
        buf[start + residue:start + residue + dl] = dpat
        ctxs.append((int(buf[start - 1]) if start >= 1 else 0,
                     int(buf[start - 2]) if start >= 2 else 0))
        live_append = True
        # scan span ends at start+residue (the first appended-delim
        # byte); the caller materializes the appended delimiter, so
        # the piece carries the residue only
        pieces.append(buf[start:start + residue].copy())
    parts = [pieces[0]]
    marks = []
    ctx_map = {}
    off = len(pieces[0])
    for k, pc in enumerate(pieces[1:], start=1):
        marks.append(off - 1)         # the shared duplicated byte
        ctx_map[off - 1] = ctxs[k]
        parts.append(pc[1:])
        off += len(pc) - 1
    V = np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8)
    trim_end = marks.pop() if live_append and marks else None
    if live_append and trim_end is not None:
        marks.append(trim_end)        # _mgrep_blocks_delim keeps it
    return V, marks, trim_end, live_append, nl_count, ctx_map


def _mgrep_blocks_delim(data, delim, outtail, dends=None):
    """The -d block walk (newmgrep.c:480-567, :568-585): returns
    (overwrites, marks, final_trim, live_append, raw_delim_ends).

    overwrites: data offsets whose first dl bytes the loop replaces
    with the delimiter (every block's head); marks: duplicated bytes
    (each block's trim byte -- the residue copy lacks a start++);
    final_trim: the last block's trim boundary, set only when the EOF
    residue rescan runs (residue > 1); live_append: that rescan sees
    an appended delimiter."""
    BLK = 2 * 16384
    dl = len(delim)
    N = len(data)
    trim_end = None
    live = False
    # one global delimiter scan; per block, the last delimiter fully
    # inside [pos, pos+num_read) comes from a searchsorted (the
    # per-block rescan dominated -d setup on multi-MB files).
    # All blocks are resolved with VECTORIZED searchsorted pairs: the
    # skip-straddling-delimiters decrement loop == "largest end in
    # [pos+dl-1, pos+num_read-1]" (a straddler has end < pos+dl-1;
    # anything smaller than pos breaks the loop empty-handed)
    all_dends = (dends if dends is not None
                 else _find_delims_arr(data, delim))
    if N == 0:
        return [], [], None, False, all_dends
    starts = np.arange(0, N, BLK, dtype=np.int64)
    ends_in = np.minimum(starts + BLK, N) - 1       # inclusive
    if len(all_dends):
        j1 = np.searchsorted(all_dends, starts + dl - 1, side="left")
        j2 = np.searchsorted(all_dends, ends_in, side="right") - 1
        has = j2 >= j1
        le = np.where(has, all_dends[np.clip(j2, 0,
                                             len(all_dends) - 1)], -1)
    else:
        has = np.zeros(len(starts), dtype=bool)
        le = np.full(len(starts), -1, dtype=np.int64)
    if outtail:
        t_arr = np.where(has, le, -1)
    else:
        # le_start >= dl (else `newbuf < MAXLINE+D_length`: no trim)
        ok = has & ((le - dl + 1) - starts >= dl)
        t_arr = np.where(ok, le - dl, -1)
    overwrites = starts.tolist()
    # untrimmed blocks duplicate their last byte (residue==1 copy)
    marks_arr = np.where(t_arr >= 0, t_arr, ends_in)
    marks = marks_arr[:-1].tolist()
    # last block: a trim only registers when the EOF residue rescan
    # runs (more than one residue byte past the trim)
    t_last = int(t_arr[-1])
    if t_last >= 0:
        live = t_last < N - 1
        trim_end = t_last if live else None
        if live:
            marks.append(t_last)
    return overwrites, marks, trim_end, live, all_dends


