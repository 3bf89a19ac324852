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


class RegexEngine:
    def __init__(self, q):
        self.q = q
        self.mc = q.re_mc

    def supports_streaming(self) -> bool:
        """Pure-count regex streams in O(chunk): lines are independent
        lanes, so chunks cut at line boundaries scan exactly like the
        whole file (the 49152-boundary glitch byte keeps its global
        offset).  Plain record printing streams the same way; the
        decorated/inverse modes keep the whole-file path (CBO parity
        and residue-clamp emulation consult global state)."""
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
        # round 5: -n/-b/-q decorations stream too -- they are
        # cumulative counters (line index, byte offset + the 49152
        # glitch lag), and the precheck already routes every
        # residue-clamp shape to the whole-file emulation.  INVERSE
        # streams the same way (round-5 continuation): the whole-file
        # output pass is verdict-inversion followed by the identical
        # r_output walk, so the chunked walk only flips the verdicts
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
                dst.copy_(kernels.to_device(src, "cpu"))
        return text

    def _fire(self, text, idx, init, first: int, end: int, glitch: int,
              rows: bool):
        """The lines of idx = line_index(text) that fire (renfa_lines
        from the D+1 states init, then line_rows with ordinals [first,
        end) kept and the glitch byte at text position glitch or -1):
        (rows int64 [R, 3] on the host -- ordinal, start, newline -- or
        None, count)."""
        from ..ops import renfa_kernel
        m = renfa_kernel.machine_from_mc(self.mc, text.device)
        v = renfa_kernel.renfa_lines(text, idx.starts, idx.lens, m, init)
        r, count = renfa_kernel.line_rows(v, idx.ords, idx.nl,
                                          self.q.opts.invert, first, end,
                                          glitch, rows)
        if r is not None:
            r = r.cpu().numpy()
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
        inj_g = 49152 if N > 49152 else -1
        lo = 0
        while lo < N:
            hi = min(lo + chunk, N)
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

    def _chunk_verdicts(self, seg: np.ndarray, inj: int, cont0):
        """Verdicts for one line-aligned chunk (lines ending in '\\n'
        within seg) on the numpy backend, by the native C twin; None
        (without the native library) = caller falls back to the
        whole-file path."""
        from .. import native
        return native.renfa_scan_lines(seg, self.mc, cont0, inj)

    def search_stream_chunked(self, data, sink: Sink, D: int) -> None:
        """Chunked -c: per-chunk native line scans over line-aligned
        segments; equivalent to the whole-file scan byte-for-byte
        because every line starts from the same post-newline closure
        state (re():1649 resets identically at every newline)."""
        from .. import native
        q, o, mc = self.q, self.q.opts, self.mc
        if not o.count:
            return self._print_stream_chunked(data, sink)
        cont0, _ = renfa.step_newline(
            list(mc["inits"]), int(mc["mask"][0x0A]), mc)
        N = len(data)
        if N == 0:
            return
        drop_first = bool(N and data[0] == 0x0A and int(mc["D"]) > 0)
        if scan_ops._BACKEND == "torch":
            # one count a chunk from the card
            sink.num_matched += sum(
                c for *_, c in self._device_chunks(data, False, drop_first))
            return
        chunk = max(scan_ops.STREAM_CHUNK, 1 << 16)
        inj_g = 49152 if N > 49152 else -1
        total = 0
        first_chunk = True
        lo = 0
        while lo < N:
            hi = min(lo + chunk, N)
            cut = N
            if hi < N:
                while hi < N:
                    seg = np.asarray(data[lo:hi])
                    nls = np.flatnonzero(seg == 0x0A)
                    if len(nls):
                        cut = lo + int(nls[-1]) + 1
                        break
                    hi = min(hi + chunk, N)
                else:
                    cut = N
            seg = np.ascontiguousarray(data[lo:cut])
            inj = (inj_g - lo if (inj_g >= 0 and lo <= inj_g < cut)
                   else -1)
            v = self._chunk_verdicts(seg, inj, cont0)
            if v is None:
                # native lib vanished mid-run: whole-file fallback
                self.search_stream(np.asarray(data), sink, D)
                return
            hits = (v != 0) ^ o.invert
            if first_chunk and len(hits) and drop_first:
                # D>0 A-phase CBO quirk drops the empty FIRST line
                # (see search_stream)
                hits = hits.copy()
                hits[0] = False
            total += int(np.count_nonzero(hits))
            first_chunk = False
            lo = cut
        sink.num_matched += total

    def _print_stream_chunked(self, data, sink: Sink) -> None:
        """Streaming plain record print: per line-aligned chunk, run
        the native line scanner, emit matched lines with adjacent
        records coalesced.  Lines crossing a 49152 block boundary from
        more than Maxline back (or with a NUL in the carry window)
        take the whole-file path, whose residue-clamp emulation
        (agrep.c:1426-1431/:1739) needs global state."""
        o, mc = self.q.opts, self.mc
        N = len(data)
        if N == 0:
            return
        BSR = 49152
        b = BSR
        while b < N:
            win = np.asarray(data[b - 1025:b])
            if not bool((win == 0x0A).any()) \
                    or bool((win == 0).any()):
                self.search_stream(np.asarray(data), sink, 0)
                return
            b += BSR
        drop_first = bool(data[0] == 0x0A and int(mc["D"]) > 0)
        fname = bool(getattr(sink, "fname", False))
        deco = bool(o.linenum or o.bytecount or o.printoffset)
        inj_g = BSR if N > BSR else -1
        line_base = 0
        # per chunk: (lo, cut, K, line index in the chunk, line start,
        # line end past its newline) of each line that fires
        chunks = (((lo, cut, K, r[:, 0], r[:, 1], r[:, 2] + 1)
                   for lo, cut, K, r, _n in self._device_chunks(
                       data, True, drop_first))
                  if scan_ops._BACKEND == "torch"
                  else self._host_row_chunks(data, drop_first))
        for lo, cut, K, k_idx, begins, ends in chunks:
            if k_idx is None:
                self.search_stream(np.asarray(data), sink, 0)
                return
            seg = np.ascontiguousarray(data[lo:cut])
            if len(ends):
                sink.num_matched += len(ends)
                if deco:
                    # cumulative decorations (r_output: j-1 line
                    # numbers; CBO at the line's newline with the
                    # 49152 overrun lag and the D>0 pair parity)
                    D_ = int(mc["D"])
                    for t in range(len(ends)):
                        gnl = lo + int(ends[t]) - 1   # '\n' data pos
                        gb = lo + int(begins[t])
                        sink.emit_fname_prefix()
                        if o.linenum:
                            sink.write_str(
                                "%d: " % (line_base + int(k_idx[t])
                                          + 1))
                        glitch = 1 if (inj_g >= 0 and gnl >= BSR) \
                            else 0
                        cbo = gnl + glitch
                        if D_ > 0 and (gnl + glitch) % 2 == 0:
                            cbo -= 1
                        if o.bytecount:
                            sink.write_str("%d= " % cbo)
                        rec_len = gnl - gb
                        if o.printoffset:
                            sink.write_str("@%d{%d} " % (cbo - rec_len,
                                                         rec_len))
                        sink.write(bytes(bytearray(
                            seg[int(begins[t]):int(ends[t])])))
                elif not fname:
                    brk = np.flatnonzero(begins[1:] != ends[:-1])
                    seg_lo = np.concatenate([[0], brk + 1])
                    seg_hi = np.concatenate([brk, [len(ends) - 1]])
                    for s_i, h_i in zip(seg_lo.tolist(),
                                        seg_hi.tolist()):
                        sink.write(bytes(bytearray(
                            seg[int(begins[s_i]):int(ends[h_i])])))
                else:
                    for b_, e_ in zip(begins.tolist(), ends.tolist()):
                        sink.emit_fname_prefix()
                        sink.write(bytes(bytearray(seg[b_:e_])))
            line_base += K

    def _host_row_chunks(self, data, drop_first: bool):
        """The numpy backend's chunks, as _print_stream_chunked takes them:
        per line-aligned chunk the native line scanner's verdicts, and
        the chunk's newline index; k_idx None where the native library
        is missing (the caller takes the whole-file path)."""
        o, mc = self.q.opts, self.mc
        N = len(data)
        cont0, _ = renfa.step_newline(
            list(mc["inits"]), int(mc["mask"][0x0A]), mc)
        chunk = max(scan_ops.STREAM_CHUNK, 1 << 16)
        inj_g = 49152 if N > 49152 else -1
        first_chunk = True
        lo = 0
        while lo < N:
            hi = min(lo + chunk, N)
            cut = N
            if hi < N:
                while hi < N:
                    seg_ = np.asarray(data[lo:hi])
                    nls_ = np.flatnonzero(seg_ == 0x0A)
                    if len(nls_):
                        cut = lo + int(nls_[-1]) + 1
                        break
                    hi = min(hi + chunk, N)
                else:
                    cut = N
            seg = np.ascontiguousarray(data[lo:cut])
            inj = (inj_g - lo if (inj_g >= 0 and lo <= inj_g < cut)
                   else -1)
            v = self._chunk_verdicts(seg, inj, cont0)
            if v is None:
                yield lo, cut, 0, None, None, None
                return
            hits = (v != 0) ^ o.invert
            if first_chunk and len(hits) and drop_first:
                hits = hits.copy()
                hits[0] = False
            first_chunk = False
            if hits.any():
                nls = np.flatnonzero(seg == 0x0A)
                k_idx = np.flatnonzero(hits[:len(nls)])
                ends = nls[k_idx] + 1
                begins = np.where(k_idx > 0,
                                  nls[np.maximum(k_idx - 1, 0)] + 1,
                                  np.int64(0))
                yield lo, cut, len(nls), k_idx, begins, ends
            else:
                none = np.zeros(0, dtype=np.int64)
                yield (lo, cut, int(np.count_nonzero(seg == 0x0A)), none,
                       none, none)
            lo = cut

    def _stream_rows(self, stream, inject_at, memory_mode, appended,
                     drop_first, cont_states, seed0, count_only):
        """search_stream's lines on the torch backend: (count of the
        lines that fire; (line, start, newline) of each one that fires,
        or None for a count; memory mode's leading
        line's verdict ^ invert; its newline, where a print needs it, or
        -1), or None for a stream without a newline.  Ordinal 0 of the
        card's index is the sentinel's empty line (file mode) or the
        leading line (memory mode), so line k is ordinal k + 1."""
        from ..ops import renfa_kernel
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
            extra0 = bool(v0[0]) ^ bool(self.q.opts.invert)
            if extra0 and not count_only:
                nl0 = int(idx.nl[0])
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
        BSR = 49152                            # BlockSize (agrep.h:48)
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
            # residue clamping (agrep.c:1426-1431 for D==0; the D>0
            # loop carries only the last Maxline bytes, :1739): a line
            # crossing a block boundary prints a preserved 1023-byte
            # head + the final block's prefix (D==0), or the final
            # block's prefix alone (D>0), unless it began within
            # Maxline of the boundary
            head_hi = None                     # clamp pieces (stream)
            tail_lo = None
            if not memory_mode:
                pn_d = bp - 2                  # prev newline, data
                e_d = p - 1
                b_d = bp - 1
                j1b = (e_d // BSR) * BSR
                if D == 0:
                    b0 = (max(pn_d, 0) // BSR + 1) * BSR
                    if b0 <= j1b and (j1b > b0 or b0 - pn_d > 1024):
                        head_hi = bp - 1 + 1024   # stream coord
                        tail_lo = j1b + 1
                else:
                    if j1b > b_d and b_d <= j1b - 1024:
                        head_hi = bp          # empty head
                        tail_lo = j1b + 1
            printed = sink.emit_fname_prefix()
            if o.linenum:
                sink.write_str("%d: " % (j - 1))
                printed = True
            # re()'s scan loop is unrolled two bytes per iteration and
            # updates CurrentByteOffset once per pair (agrep.c re()
            # CONSUME blocks): an event landing on the first slot
            # reports a CBO lagging one byte.  Slot parity == parity of
            # the event's data offset.
            glitch = 1 if (inject_at is not None
                           and p >= inject_at) else 0
            # memory mode has no prepended sentinel newline, so the
            # C's CurrentByteOffset at a record check sits one AHEAD
            # of the file-mode convention relative to stream position
            cbo = p - 1 + glitch + (1 if memory_mode else 0)
            # pair-slot parity is anchored at the loop's start in BOTH
            # modes (memory: i=0 with CurrentByteOffset=1, agrep.c
            # RE1 memory loops): combined with the +1 base, the memory
            # -b value rounds DOWN to even (newline_idx & ~1)
            if D > 0 and (p - 1 + glitch) % 2 == 0:
                cbo -= 1
            if o.bytecount:
                sink.write_str("%d= " % cbo)
                printed = True
            # D>0 boundary crossings: the carried window is the LAST
            # Maxline bytes (agrep.c:1739 strncpy), so the NUL clamp
            # zero-fills from the RESIDUE's first NUL -- which can
            # erase the line-start newline itself, moving r_output's
            # backscan to an earlier (clamped) newline, or to the bp
            # fallback (buffer[Maxline], i.e. the block start)
            rec_override = None
            if (head_hi is None and not memory_mode and D > 0):
                j1b_ = ((p - 1) // BSR) * BSR
                if j1b_ + 1 > bp and j1b_ >= 1024:
                    res_lo = j1b_ - 1024       # data coords
                    seg = np.asarray(
                        stream[res_lo + 1:j1b_ + 1]).copy()
                    z = np.flatnonzero(seg == 0)
                    if len(z):
                        seg[int(z[0]):] = 0
                    nls_r = np.flatnonzero(seg == 0x0A)
                    if len(nls_r):
                        head_part = seg[int(nls_r[-1]) + 1:]
                    else:
                        head_part = seg[:0]    # bp fallback: Maxline
                    rec_override = np.concatenate(
                        [head_part,
                         np.asarray(stream[j1b_ + 1:p + 1])])
            if rec_override is not None:
                rec_len = len(rec_override) - 1
            else:
                rec_len = (p - bp if head_hi is None
                           else (head_hi - bp) + (p - tail_lo + 1))
            if o.printoffset:
                sink.write_str("@%d{%d} " % (cbo - rec_len, rec_len))
                printed = True
            if o.printrecord:
                # the carried residue is strncpy'd (agrep.c:1430): a
                # NUL in the preserved head zero-fills the rest of the
                # copy; the final block's bytes are read fresh
                if rec_override is not None:
                    sink.write(bytes(bytearray(rec_override)))
                elif head_hi is None:
                    rec = stream[bp:p + 1]
                    if not memory_mode:
                        j1b_ = ((p - 1) // BSR) * BSR
                        if j1b_ + 1 > bp:      # crosses a boundary
                            lo_ = max(bp - 1, 0)
                            seg_ = np.asarray(stream[lo_:j1b_ + 1])
                            z_ = np.flatnonzero(seg_ == 0)
                            if len(z_):
                                rec = np.array(rec, copy=True)
                                st_ = max(lo_ + int(z_[0]), bp) - bp
                                rec[st_:j1b_ + 1 - bp] = 0
                    sink.write(bytes(bytearray(rec)))
                else:
                    head = stream[bp:head_hi]
                    lo_ = max(bp - 1, 0)
                    seg_ = np.asarray(stream[lo_:head_hi])
                    z_ = np.flatnonzero(seg_ == 0)
                    if len(z_):
                        head = np.array(head, copy=True)
                        st_ = max(lo_ + int(z_[0]), bp) - bp
                        head[st_:] = 0
                    sink.write(bytes(bytearray(head)))
                    sink.write(bytes(bytearray(stream[tail_lo:p + 1])))
            elif printed:
                sink.write_str("\n")
            if (o.limit_output > 0
                    and sink.num_matched >= o.limit_output) or \
               (o.limit_per_file > 0 and sink.num_matched
                    - sink.prev_num_matched >= o.limit_per_file):
                return
        _ = matched0

