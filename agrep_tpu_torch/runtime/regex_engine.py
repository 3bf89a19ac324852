"""Regex-with-errors record engine (reference re()/re1(),
agrep.c:468-1917, output via r_output:1919-2044).

Lines are scanned record-parallel (ops.renfa): on the torch backend by
the lanes kernel (ops.renfa_kernel.renfa_lines), on the numpy backend by
the native C twin.  This module handles the line index, the sentinel
check, and r_output's byte-exact decorations.

On the torch backend the line index stays on the scan device too: a
chunk (or the whole stream) goes up once, with the 49152 glitch byte
inserted there, renfa_kernel.line_index cuts and orders its lines,
renfa_lines takes them in that order, and renfa_kernel.line_rows sends
back only the count of the lines that fire or, for a print, their rows
(ordinal, start, newline) in stream order.
"""

from __future__ import annotations

import os

import numpy as np

from ..ops import renfa, scan as scan_ops
from . import trace
from .output import Sink

MAXLINE_BUCKETS = renfa.MAXLINE_BUCKETS
CHUNK_R = 1 << 22               # lines per numpy lane matrix
BSR = 49152                     # BlockSize (agrep.h:48)
MAXLINE = 1024                  # Maxline (agrep.h)


def crosses(b, e):
    """Whether the file-mode line data[b:e + 1] (e its newline) holds a
    block boundary past its first byte, elementwise over arrays: only
    such a line can print other bytes than its own (line_record)."""
    return e // BSR * BSR > b


def _nul_fill(seg) -> np.ndarray:
    """seg as strncpy copies it: zero from its first NUL on."""
    seg = np.array(seg, dtype=np.uint8)
    z = np.flatnonzero(seg == 0)
    if len(z):
        seg[int(z[0]):] = 0
    return seg


def line_record(data, b: int, e: int, D: int):
    """The record r_output prints for the file-mode line data[b:e + 1]
    (e its newline) of a search with D errors, and the length -q gives
    it: a function of the line and, for a line across a block boundary,
    of the Maxline bytes before that boundary, so that the whole-file
    walk and the streamed one print the same.

    A line across block boundaries prints from the residue the scan
    carried over the last one, j (agrep.c:1426-1431 for D == 0; the
    D > 0 loop carries only the last Maxline bytes, :1739):
    * a line that began Maxline or more before j is clamped: the first
      Maxline - 1 bytes of the line (D == 0; none for D > 0), then the
      bytes from j on, and -q counts the newline;
    * otherwise the residue is strncpy'd, so a NUL zero-fills the rest
      of it: for D == 0 the line's bytes before j; for D > 0 the last
      Maxline bytes before j, which can erase the line's leading
      newline, so that r_output's backscan starts at an earlier newline
      of the residue, or at its start where none is left."""
    j = e // BSR * BSR
    if j <= b:
        return data[b:e + 1], e - b
    tail = np.asarray(data[j:e + 1])
    if b <= j - MAXLINE:
        head = (_nul_fill(data[b:b + MAXLINE - 1]) if D == 0
                else tail[:0])
        rec = np.concatenate([head, tail])
        return rec, len(rec)
    if D > 0:
        res = _nul_fill(data[j - MAXLINE:j])
        nls = np.flatnonzero(res == 0x0A)
        head = res[int(nls[-1]) + 1:] if len(nls) else res[:0]
    else:
        head = _nul_fill(data[b:j])
    rec = np.concatenate([head, tail])
    return rec, len(rec) - 1


def line_cbo(e: int, n: int, D: int) -> int:
    """CurrentByteOffset at the check of the file-mode line whose
    newline is data[e], in a file of n bytes: one byte late past the
    49152 glitch byte, and for D > 0 lagging one more where the newline
    lands on the first slot of re()'s two-byte unrolled loop (slot
    parity == parity of the offset)."""
    cbo = e + (1 if n > BSR and e >= BSR else 0)
    return cbo - 1 if D > 0 and cbo % 2 == 0 else cbo


class RegexEngine:
    def __init__(self, q):
        self.q = q
        self.mc = q.re_mc

    def supports_streaming(self) -> bool:
        """Pure-count regex streams in O(chunk): lines are independent
        lanes, so chunks cut at line boundaries scan exactly like the
        whole file (the 49152-boundary glitch byte keeps its global
        offset).  Record printing streams the same way; -u, -P, -G,
        -M, -l, -s and the output limits keep the whole-file path."""
        o = self.q.opts
        if (o.filename_only or o.silent
                or o.limit_output > 0 or o.limit_per_file > 0):
            return False
        if scan_ops._BACKEND == "numpy":
            # host path: the chunk scans ride the sequential C twin
            from .. import native
            if native.get_lib() is None:
                return False
        # torch: the lanes kernel is chunk-independent (every line
        # restarts from the same post-newline closure), so the same
        # chunk walk consumes the kernel's verdicts
        if o.count:
            return True
        # -n/-b/-q decorations stream too: they are cumulative
        # counters (line index, byte offset + the 49152 glitch lag),
        # and a line's record bytes are a function of the line and the
        # Maxline bytes before its block boundary (line_record).
        # INVERSE streams the same way: the whole-file output pass is
        # verdict-inversion followed by the identical r_output walk,
        # so the chunked walk only flips the verdicts
        return (o.printrecord
                and not o.printpattern and not o.fileout
                and not getattr(o, "multi_output", False))

    def _to_device(self, seg: np.ndarray, inj: int = -1):
        """seg on the torch backend's device, with a 0 byte inserted
        before seg[inj] where inj >= 0 (the 49152 overrun glitch byte,
        agrep.c block carry): the two pieces go up into their places, so
        the host never copies seg."""
        import torch

        from ..ops import kernels
        scan_ops.require_device()
        dev = torch.device(scan_ops._DEVICE)
        if inj < 0:
            return kernels.to_device(seg, dev)
        text = torch.empty(len(seg) + 1, dtype=torch.uint8, device=dev)
        text[inj] = 0
        for dst, src in ((text[:inj], seg[:inj]), (text[inj + 1:],
                                                   seg[inj:])):
            if len(src):
                with trace.span("upload", len(src)):
                    dst.copy_(kernels.host_tensor(src))
        return text

    def _fire(self, text, idx, init, first: int, end: int, glitch: int,
              rows: bool):
        """The lines of idx = line_index(text) that fire (renfa_lines
        from the D+1 states init, then line_rows with ordinals [first,
        end) kept and the glitch byte at text position glitch or -1):
        (rows int64 [R, 3] on the host -- ordinal, start, newline -- or
        None, count)."""
        from ..ops import kernels, renfa_kernel
        m = renfa_kernel.machine_from_mc(self.mc, text.device)
        v = renfa_kernel.renfa_lines(text, idx.starts, idx.lens, m, init)
        r, count = renfa_kernel.line_rows(v, idx.ords, idx.nl,
                                          self.q.opts.invert, first, end,
                                          glitch, rows)
        if r is not None:
            r = kernels.to_host(r)
        if trace.ENABLED:
            trace.add("regex_lines", idx.nl.numel())
            trace.add("regex_rows", 0 if r is None else len(r))
        return r, count

    def _device_chunks(self, data, rows: bool, drop_first: bool):
        """The torch backend's line-aligned chunks: yields (lo, cut, K,
        rows, count) a chunk [lo, cut), K its lines and rows/count
        _fire's (rows' positions relative to lo, without the glitch
        byte).  Each window [lo, hi) goes up once; its last newline (from
        the card) ends the chunk, and a window without one grows by a
        chunk until the stream's end, as the host walk cut it."""
        from ..ops import renfa_kernel
        mc = self.mc
        cont0, _ = renfa.step_newline(
            list(mc["inits"]), int(mc["mask"][0x0A]), mc)
        N = len(data)
        chunk = max(scan_ops.STREAM_CHUNK, 1 << 16)
        inj_g = BSR if N > BSR else -1
        lo = 0
        while lo < N:
            hi = min(lo + chunk, N)
            with trace.span("device_layer"):
                while True:
                    inj = inj_g - lo if lo <= inj_g < hi else -1
                    text = self._to_device(data[lo:hi], inj)
                    idx = renfa_kernel.line_index(text)
                    if idx.last >= 0 or hi == N:
                        break
                    hi = min(hi + chunk, N)
                # a glitch byte past the last newline leaves the chunk's
                # lines as they are; the next window inserts it again
                cut = (N if hi == N
                       else lo + idx.last + 1 - (0 <= inj < idx.last))
                K = idx.nl.numel()
                r, count = self._fire(text, idx, cont0,
                                      1 if lo == 0 and drop_first else 0, K,
                                      inj, rows)
            yield lo, cut, K, r, count
            lo = cut

    def _lane_verdicts(self, scan_stream: np.ndarray,
                       line_start: np.ndarray, line_len: np.ndarray,
                       cont_states) -> np.ndarray:
        """Per-line verdicts via the numpy record-parallel lanes (the
        numpy backend without the native library): length-bucketed
        lane matrices, every lane starting from the shared post-newline
        closure."""
        verdicts = np.zeros(len(line_start), dtype=bool)
        order = np.argsort(line_len, kind="stable")
        i = 0
        n_scan = len(scan_stream)
        mc = self.mc
        offs_cache: dict = {}
        while i < len(order):
            L = 1
            for b in MAXLINE_BUCKETS:
                if line_len[order[i]] + 1 <= b:
                    L = b
                    break
            else:
                L = int(line_len[order[i]]) + 1
            j = i
            while j < len(order) and line_len[order[j]] + 1 <= L:
                j += 1
            offs = offs_cache.setdefault(
                L, np.arange(L, dtype=np.int64))
            for s0 in range(i, j, CHUNK_R):
                idxs = order[s0:min(s0 + CHUNK_R, j)]
                lens = line_len[idxs]
                from .. import native
                lanes = native.pack_lines(scan_stream,
                                          line_start[idxs], lens, L)
                if lanes is None:
                    pos = line_start[idxs][:, None] + offs[None, :]
                    lanes = np.where(
                        offs[None, :] <= lens[:, None],
                        scan_stream[np.minimum(pos, n_scan - 1)],
                        np.uint8(0)).astype(np.uint8)
                got = renfa.scan_records(lanes, lens, mc,
                                         cont_states, cont_states)
                verdicts[idxs] = got
            i = j
        return verdicts

    def _host_chunks(self, data, rows: bool, drop_first: bool):
        """The numpy backend's twin of _device_chunks: the same
        line-aligned cut and glitch byte, the native C twin's verdicts a
        chunk, and what line_rows gives the card's walk: (lo, cut, K,
        rows, count), rows int64 [R, 3] (ordinal, start, newline,
        relative to lo) of the lines that fire, or None for a count.
        supports_streaming holds the native library to be there."""
        from .. import native
        o, mc = self.q.opts, self.mc
        cont0, _ = renfa.step_newline(
            list(mc["inits"]), int(mc["mask"][0x0A]), mc)
        N = len(data)
        chunk = max(scan_ops.STREAM_CHUNK, 1 << 16)
        inj_g = BSR if N > BSR else -1
        lo = 0
        while lo < N:
            hi = min(lo + chunk, N)
            cut = N
            while hi < N:
                nls = np.flatnonzero(np.asarray(data[lo:hi]) == 0x0A)
                if len(nls):
                    cut = lo + int(nls[-1]) + 1
                    break
                hi = min(hi + chunk, N)
            seg = np.ascontiguousarray(data[lo:cut])
            inj = inj_g - lo if lo <= inj_g < cut else -1
            v = native.renfa_scan_lines(seg, mc, cont0, inj)
            if v is None:
                raise RuntimeError("the native library is not loaded")
            hits = (v != 0) ^ o.invert
            if lo == 0 and drop_first and len(hits):
                hits[0] = False
            if rows:
                nls = np.flatnonzero(seg == 0x0A)
                k = np.flatnonzero(hits[:len(nls)])
                starts = np.where(k > 0, nls[np.maximum(k - 1, 0)] + 1, 0)
                yield (lo, cut, len(nls),
                       np.stack([k, starts, nls[k]], axis=1), len(k))
            else:
                yield lo, cut, None, None, int(np.count_nonzero(hits))
            lo = cut

    def search_stream_chunked(self, data, sink: Sink, D: int) -> None:
        """Streams the file by line-aligned chunks, byte for byte what
        search_stream prints: every line starts from the same
        post-newline closure state (re():1649 resets identically at
        every newline), the 49152 glitch byte keeps its offset in the
        chunk that holds it, and a print takes each line's record bytes
        and offsets from line_record and line_cbo, as the whole-file
        walk does.  The torch backend's chunks come from the card
        (_device_chunks), the numpy backend's from the C twin
        (_host_chunks)."""
        mc = self.mc
        if len(data) == 0:
            return
        # D>0 A-phase CBO quirk drops an empty FIRST line (search_stream)
        drop_first = bool(data[0] == 0x0A and int(mc["D"]) > 0)
        chunks = (self._device_chunks if scan_ops._BACKEND == "torch"
                  else self._host_chunks)
        if self.q.opts.count:
            sink.num_matched += sum(
                c for *_, c in chunks(data, False, drop_first))
            return
        o = self.q.opts
        N = len(data)
        fname = bool(getattr(sink, "fname", False))
        deco = bool(o.linenum or o.bytecount or o.printoffset)
        line_base = 0
        for lo, cut, K, r, _n in chunks(data, True, drop_first):
            with trace.span("walk"):
                if len(r):
                    sink.num_matched += len(r)
                    # each firing line's start and newline in data
                    b, e = r[:, 1] + lo, r[:, 2] + lo
                    if deco or fname:
                        for k, bt, et in zip(r[:, 0].tolist(), b.tolist(),
                                             e.tolist()):
                            sink.emit_fname_prefix()
                            if o.linenum:
                                sink.write_str("%d: " % (line_base + k + 1))
                            cbo = line_cbo(et, N, D)
                            if o.bytecount:
                                sink.write_str("%d= " % cbo)
                            rec, rec_len = line_record(data, bt, et, D)
                            if o.printoffset:
                                sink.write_str("@%d{%d} " % (cbo - rec_len,
                                                             rec_len))
                            sink.write_record(np.asarray(rec).tobytes())
                    else:
                        # adjacent lines in one write; a line across a
                        # block boundary alone, through line_record
                        cross = crosses(b, e)
                        brk = np.flatnonzero((b[1:] != e[:-1] + 1)
                                             | cross[1:] | cross[:-1])
                        for s_i, h_i in zip([0] + (brk + 1).tolist(),
                                            brk.tolist() + [len(b) - 1]):
                            if cross[s_i]:
                                rec = line_record(data, int(b[s_i]),
                                                  int(e[s_i]), D)[0]
                            else:
                                rec = data[int(b[s_i]):int(e[h_i]) + 1]
                            sink.write_record(np.asarray(rec).tobytes(),
                                              h_i - s_i + 1)
            line_base += K

    def _stream_rows(self, stream, inject_at, memory_mode, appended,
                     drop_first, cont_states, seed0, count_only):
        """search_stream's lines on the torch backend: (count of the
        lines that fire; (line, start, newline) of each one that fires,
        or None for a count; memory mode's leading
        line's verdict ^ invert; its newline, where a print needs it, or
        -1), or None for a stream without a newline.  Ordinal 0 of the
        card's index is the sentinel's empty line (file mode) or the
        leading line (memory mode), so line k is ordinal k + 1."""
        from ..ops import kernels, renfa_kernel
        with trace.span("device_layer"):
            glitch = -1 if inject_at is None else inject_at
            text = self._to_device(stream, glitch)
            idx = renfa_kernel.line_index(text)
            K = idx.nl.numel()
            if K == 0:
                return None
            # r_output's i >= end guard swallows the appended line
            end = K - 1 if (not memory_mode and appended) else K
            rows, n_fire = self._fire(text, idx, cont_states,
                                      2 if drop_first else 1, end, glitch,
                                      not count_only)
            extra0, nl0 = False, -1
            if memory_mode:
                # one single-line launch from the seed states
                m = renfa_kernel.machine_from_mc(self.mc, text.device)
                v0 = renfa_kernel.renfa_lines(text, idx.nl.new_zeros(1),
                                              idx.nl[:1], m, seed0)
                extra0 = kernels.read(v0[0]) ^ bool(self.q.opts.invert)
                if extra0 and not count_only:
                    nl0 = kernels.read(idx.nl[0])
            hits = (None if rows is None
                    else ((j - 1, bp, p) for j, bp, p in rows.tolist()))
            return n_fire, hits, extra0, nl0

    def _stream_hits(self, stream, inject_at, memory_mode, appended,
                     drop_first, cont_states, seed0, count_only):
        """_stream_rows' result on the numpy backend: the stream's
        newline index on the host, the native C twin's verdicts (the
        numpy lanes without the native library)."""
        o, mc = self.q.opts, self.mc
        N = len(stream)
        if inject_at is not None:
            scan_stream = np.concatenate([
                stream[:inject_at], np.frombuffer(b"\x00", np.uint8),
                stream[inject_at:]])
        else:
            scan_stream = stream
        nl = np.flatnonzero(stream == 0x0A)
        if len(nl) == 0:
            return None
        s_nl = (np.flatnonzero(scan_stream == 0x0A)
                if inject_at is not None else nl)
        n_lines = len(nl) - 1
        verdicts = np.zeros(n_lines, dtype=bool)
        if n_lines:
            # the sequential C twin (tabulated Next, reference
            # re()/re1() shape) beats the lane matrices whose
            # temporaries are O(lines x padded length)
            from .. import native
            v = native.renfa_scan_lines(
                scan_stream[int(s_nl[0]) + 1:], mc, cont_states)
            if v is not None:
                verdicts = v[:n_lines]
            else:
                line_start = s_nl[:-1] + 1          # scan-stream coords
                line_end = s_nl[1:]                # index of trailing '\n'
                line_len = (line_end - line_start).astype(np.int64)
                # line 1 starts from the post-sentinel state --
                # identical to cont_states (the reset ignores prior
                # state), so all lines share one init
                verdicts = self._lane_verdicts(
                    scan_stream, line_start, line_len, cont_states)
        extra0 = False
        if memory_mode:
            l0 = int(nl[0])
            if l0 == 0:
                _, v0 = renfa.step_newline(
                    seed0, int(mc["mask"][0x0A]), mc)
            else:
                lane0 = np.zeros((1, l0 + 1), dtype=np.uint8)
                lane0[0, :l0 + 1] = stream[:l0 + 1]
                v0 = bool(renfa.scan_records(
                    lane0, np.asarray([l0], dtype=np.int64), mc,
                    seed0, seed0)[0])
            extra0 = v0 ^ bool(o.invert)
        hit = verdicts ^ o.invert
        if n_lines and drop_first:
            hit = hit.copy()
            hit[0] = False
        if count_only:
            if (not memory_mode and appended and n_lines
                    and int(nl[n_lines]) == N - 1):
                # r_output i >= end guard swallows the appended line
                hit = hit.copy()
                hit[n_lines - 1] = False
            return int(np.count_nonzero(hit)), None, extra0, int(nl[0])
        return (None, ((k, int(nl[k]) + 1, int(nl[k + 1]))
                       for k in np.flatnonzero(hit).tolist()),
                extra0, int(nl[0]))

    def search_stream(self, data: np.ndarray, sink: Sink, D: int,
                      memory_mode: bool = False) -> None:
        q, o, mc = self.q, self.q.opts, self.mc
        # ---- pure-count host fast path: run the sequential C twin
        # straight over the (memmapped) data -- no padded stream copy,
        # no newline index.  The unterminated final line gets no
        # verdict from C, matching r_output's appended-line guard.
        from ..ops import scan as _so
        if (not memory_mode and o.count and not o.filename_only
                and not o.silent and o.limit_output <= 0
                and o.limit_per_file <= 0
                and _so._BACKEND == "numpy"):
            from .. import native
            if native.get_lib() is not None:
                cont0, _ = renfa.step_newline(
                    list(mc["inits"]), int(mc["mask"][0x0A]), mc)
                inj = 49152 if len(data) > 49152 else -1
                v = native.renfa_scan_lines(data, mc, cont0, inj)
                if v is not None:
                    hits = (v != 0) ^ o.invert
                    if (len(hits) and len(data) and data[0] == 0x0A
                            and int(mc["D"]) > 0):
                        # D>0 only: the A-phase newline branch of the
                        # 2x-unrolled loop forgets the CurrentByteOffset
                        # restore (agrep.c:1649-1660 vs :1723-1733), so
                        # CBO is still -1 at an empty FIRST line's check
                        # and r_output's `CurrentByteOffset < 0` guard
                        # returns before num_of_matched++ (:1927).  The
                        # D==0 loop restores in both halves.
                        hits = hits.copy()
                        hits[0] = False
                    sink.num_matched += int(np.count_nonzero(hits))
                    return
        if memory_mode:
            stream = data
            appended = False
        else:
            parts = [np.frombuffer(b"\n", dtype=np.uint8), data]
            if len(data) == 0 or data[-1] != 0x0A:
                # re1:517 appends a newline at EOF when missing; the
                # r_output i >= end guard then swallows that line
                parts.append(np.frombuffer(b"\n", dtype=np.uint8))
                appended = True
            else:
                appended = False
            stream = np.concatenate(parts)
        N = len(stream)
        # re()'s 2x-unrolled loops overrun `end` by one byte when a
        # block consumes an odd count (same bug as bitap.c): the
        # prefilled newline makes block one odd, so a stale (zero)
        # buffer byte corrupts the carried automaton state at data
        # offset BlockSize -- matches in progress across it die, and
        # CurrentByteOffset drifts one byte forward past it.
        inject_at = None
        if not memory_mode and len(data) > 49152:
            inject_at = 1 + 49152
        # sentinel check (the first '\n' is processed from the Init[k]
        # closure states; every later newline resets identically)
        states, matched0 = renfa.step_newline(
            list(mc["inits"]), int(mc["mask"][0x0A]), mc)
        cont_states = states
        count_only = (o.count and not o.filename_only
                      and o.limit_output <= 0 and o.limit_per_file <= 0)
        # memory mode's virtual leading line: the caller's contract
        # newline is scanned like any byte, so the line [0, nl[0]) gets
        # its own r_output check (from the raw Init closure, not the
        # post-newline state); the empty sentinel line prints nothing
        # but COUNTS.  Initial seeding differs by machine: re() (M <=
        # SHORTREG = 15, agrep.h:36 + bitap.c:104) sets A[k]=B[k]=Init[0]
        # at every level (agrep.c:1293) -- NO deletion closure -- while
        # re1() seeds Init[k] (agrep.c:503).  File mode never observes
        # this (the prefill newline resets the state before any data);
        # the memory leading line does.
        if int(mc["M"]) <= 15:
            seed0 = [int(mc["init0"])] * (int(mc["D"]) + 1)
        else:
            seed0 = list(mc["inits"])
        # D>0 only: the A-phase newline branch of the 2x-unrolled loop
        # forgets the CurrentByteOffset restore (agrep.c:1649-1660 vs
        # :1723-1733), so an EMPTY first line's check still sees
        # CurrentByteOffset == -1 and r_output's guard (:1927) drops it,
        # matched or inverse.  The D==0 loop restores in both halves.
        drop_first = (not memory_mode and len(data) and data[0] == 0x0A
                      and int(mc["D"]) > 0)
        lines = (self._stream_rows if scan_ops._BACKEND == "torch"
                 else self._stream_hits)
        got = lines(stream, inject_at, memory_mode, appended, drop_first,
                    cont_states, seed0, count_only)
        if got is None:
            return
        n_fire, hits, extra0, nl0 = got
        if count_only:
            # vectorized -c (the reference's j counter just sums)
            sink.num_matched += n_fire + int(extra0)
            return
        with trace.span("walk"):
            if extra0:
                # the virtual leading line: counted; r_output emits its
                # DECORATIONS (line number 0, -b offset) but the record
                # span is empty so NO bytes or newline follow -- in plain
                # print mode the whole first line stays unprinted
                # (memdrv probes: -v prints nothing, -v -n prints "0: ",
                # plain print skips the record; round-5 seeds
                # 870054/870057)
                sink.num_matched += 1
                if o.filename_only:
                    sink.write_str("%s\n" % sink.current_filename)
                    return
                p0 = nl0
                sink.emit_fname_prefix()
                if o.linenum:
                    sink.write_str("0: ")
                cbo0 = p0
                if int(mc["D"]) > 0 and (p0 - 1) % 2 == 0:
                    cbo0 -= 1
                if o.bytecount:
                    sink.write_str("%d= " % cbo0)
                if o.printoffset:
                    sink.write_str("@%d{%d} " % (cbo0 - p0, p0))
            for k, bp, p in hits:
                # line k: bp its start, p the stream pos of its '\n'
                if not memory_mode and appended and p == N - 1:
                    continue                       # r_output i >= end guard
                j = k + 2                          # j counter at this check
                if j < 1:
                    continue
                sink.num_matched += 1
                if o.count:
                    continue
                if o.filename_only:
                    sink.write_str("%s\n" % sink.current_filename)
                    return
                printed = sink.emit_fname_prefix()
                if o.linenum:
                    sink.write_str("%d: " % (j - 1))
                    printed = True
                if memory_mode:
                    # no prepended sentinel newline, so the C's
                    # CurrentByteOffset at a record check sits one AHEAD of
                    # the file-mode convention; the pair-slot parity is
                    # anchored at the loop's start in both modes (memory:
                    # i=0 with CurrentByteOffset=1, agrep.c RE1 memory
                    # loops), so the -b value rounds DOWN to even
                    cbo = p - 1 if D > 0 and (p - 1) % 2 == 0 else p
                    rec, rec_len = stream[bp:p + 1], p - bp
                else:
                    cbo = line_cbo(p - 1, len(data), D)
                    rec, rec_len = line_record(data, bp - 1, p - 1, D)
                if o.bytecount:
                    sink.write_str("%d= " % cbo)
                    printed = True
                if o.printoffset:
                    sink.write_str("@%d{%d} " % (cbo - rec_len, rec_len))
                    printed = True
                if o.printrecord:
                    sink.write_record(np.asarray(rec).tobytes())
                elif printed:
                    sink.write_str("\n")
                if (o.limit_output > 0
                        and sink.num_matched >= o.limit_output) or \
                   (o.limit_per_file > 0 and sink.num_matched
                        - sink.prev_num_matched >= o.limit_per_file):
                    return
        _ = matched0

