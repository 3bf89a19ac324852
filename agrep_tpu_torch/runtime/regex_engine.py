"""Regex-with-errors record engine (reference re()/re1(),
agrep.c:468-1917, output via r_output:1919-2044).

Lines are scanned record-parallel (ops.renfa): on the torch backend by
the lanes kernel (ops.renfa_kernel.renfa_lines), on the numpy backend by
the native C twin.  This module handles the line index, the sentinel
check, and r_output's byte-exact decorations.
"""

from __future__ import annotations

import os

import numpy as np

from ..ops import renfa, scan as scan_ops
from .output import Sink

MAXLINE_BUCKETS = renfa.MAXLINE_BUCKETS
CHUNK_R = 1 << 22               # lines per lanes launch / lane matrix


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

    def _upload(self, stream: np.ndarray):
        """(text, machine) on the torch backend's device: the stream
        goes up once, and every launch over it reuses both."""
        import torch

        from ..ops import kernels, renfa_kernel
        scan_ops.require_device()
        text = kernels.to_device(stream, torch.device(scan_ops._DEVICE))
        return text, renfa_kernel.machine_from_mc(self.mc, text.device)

    def _kernel_verdicts(self, dev, line_start: np.ndarray,
                         line_len: np.ndarray, init) -> np.ndarray:
        """Per-line verdicts from the lanes kernel over dev = _upload()'s
        (text, machine) (renfa_kernel.renfa_lines: the CUDA kernel, or
        its plain PyTorch version on 'cpu'), every line starting from
        init.  The lines go in length order, up to CHUNK_R a launch, so
        a warp's lines have close lengths."""
        import torch

        from ..ops import renfa_kernel
        text, m = dev
        verdicts = np.zeros(len(line_start), dtype=bool)
        order = np.argsort(line_len, kind="stable")
        for s0 in range(0, len(order), CHUNK_R):
            idxs = order[s0:s0 + CHUNK_R]
            starts = torch.from_numpy(
                line_start[idxs].astype(np.int64)).to(text.device)
            lens = torch.from_numpy(
                line_len[idxs].astype(np.int64)).to(text.device)
            verdicts[idxs] = renfa_kernel.renfa_lines(
                text, starts, lens, m, init).cpu().numpy()
        return verdicts

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
        within seg), dispatched by backend; None (numpy backend without
        the native library) = caller falls back to the whole-file
        path."""
        if scan_ops._BACKEND == "numpy":
            from .. import native
            return native.renfa_scan_lines(seg, self.mc, cont0, inj)
        if inj >= 0:
            # the 49152 overrun glitch byte (agrep.c block carry)
            seg = np.concatenate([
                seg[:inj], np.frombuffer(b"\x00", np.uint8), seg[inj:]])
        nls = np.flatnonzero(seg == 0x0A)
        if not len(nls):
            return np.zeros(0, dtype=bool)
        starts = np.concatenate([[0], nls[:-1] + 1]).astype(np.int64)
        lens = nls - starts
        return self._kernel_verdicts(self._upload(seg), starts, lens,
                                     cont0)

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
        chunk = max(scan_ops.STREAM_CHUNK, 1 << 16)
        inj_g = 49152 if N > 49152 else -1
        total = 0
        first_chunk = True
        drop_first = bool(N and data[0] == 0x0A and int(mc["D"]) > 0)
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
        from .. import native
        q, o, mc = self.q, self.q.opts, self.mc
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
        cont0, _ = renfa.step_newline(
            list(mc["inits"]), int(mc["mask"][0x0A]), mc)
        chunk = max(scan_ops.STREAM_CHUNK, 1 << 16)
        inj_g = BSR if N > BSR else -1
        drop_first = bool(data[0] == 0x0A and int(mc["D"]) > 0)
        first_chunk = True
        fname = bool(getattr(sink, "fname", False))
        deco = bool(o.linenum or o.bytecount or o.printoffset)
        line_base = 0
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
                self.search_stream(np.asarray(data), sink, 0)
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
                        glitch = 1 if (inj_g >= 0 and gnl >= BSR)                             else 0
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
            line_base += int(np.count_nonzero(seg == 0x0A))
            lo = cut

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
            scan_stream = np.concatenate([
                stream[:inject_at], np.frombuffer(b"\x00", np.uint8),
                stream[inject_at:]])
        else:
            scan_stream = stream
        nl = np.flatnonzero(stream == 0x0A)
        if len(nl) == 0:
            return

        # sentinel check (the first '\n' is processed from the Init[k]
        # closure states; every later newline resets identically)
        states, matched0 = renfa.step_newline(
            list(mc["inits"]), int(mc["mask"][0x0A]), mc)
        cont_states = states

        s_nl = (np.flatnonzero(scan_stream == 0x0A)
                if inject_at is not None else nl)
        n_lines = len(nl) - 1
        verdicts = np.zeros(n_lines, dtype=bool)
        backend = scan_ops._BACKEND
        # torch: the text and the machine go up once, for the lines and
        # for memory mode's leading line (scan_stream is stream there)
        dev = (self._upload(scan_stream)
               if backend == "torch" and (n_lines or memory_mode) else None)
        if n_lines:
            if backend == "numpy":
                # host path: the sequential C twin (tabulated Next,
                # reference re()/re1() shape) beats the lane matrices
                # whose temporaries are O(lines x padded length)
                from .. import native
                v = native.renfa_scan_lines(
                    scan_stream[int(s_nl[0]) + 1:], mc, cont_states)
                if v is not None:
                    verdicts = v[:n_lines]
                    n_lines_done = True
                else:
                    n_lines_done = False
            else:
                n_lines_done = False
        if n_lines and not n_lines_done:
            line_start = s_nl[:-1] + 1          # scan-stream coords
            line_end = s_nl[1:]                # index of trailing '\n'
            line_len = (line_end - line_start).astype(np.int64)
            # line 1 starts from the post-sentinel state -- identical
            # to cont_states (the reset ignores prior state), so all
            # lines share one init
            if backend == "torch":
                verdicts = self._kernel_verdicts(
                    dev, line_start, line_len, cont_states)
            else:
                verdicts = self._lane_verdicts(
                    scan_stream, line_start, line_len, cont_states)

        # memory mode also checks a verdict at the FIRST newline: the
        # caller's contract newline is scanned like any byte, so a
        # virtual leading line [0, nl[0]) gets its own r_output check
        # (from the raw Init closure, not the post-newline state); the
        # empty sentinel line prints nothing but COUNTS
        extra0 = False
        if memory_mode and len(nl):
            l0 = int(nl[0])
            # initial seeding differs by machine: re() (M <= SHORTREG
            # = 15, agrep.h:36 + bitap.c:104) sets A[k]=B[k]=Init[0]
            # at every level (agrep.c:1293) -- NO deletion closure --
            # while re1() seeds Init[k] (agrep.c:503).  File mode
            # never observes this (the prefill newline resets the
            # state before any data); the memory leading line does.
            if int(mc["M"]) <= 15:
                seed0 = [int(mc["init0"])] * (int(mc["D"]) + 1)
            else:
                seed0 = list(mc["inits"])
            if backend == "torch":
                # no verdict of the torch backend is taken on the host
                v0 = bool(self._kernel_verdicts(
                    dev, np.zeros(1, dtype=np.int64),
                    np.asarray([l0], dtype=np.int64), seed0)[0])
            elif l0 == 0:
                _, v0 = renfa.step_newline(
                    seed0, int(mc["mask"][0x0A]), mc)
            else:
                lane0 = np.zeros((1, l0 + 1), dtype=np.uint8)
                lane0[0, :l0 + 1] = stream[:l0 + 1]
                v0 = bool(renfa.scan_records(
                    lane0, np.asarray([l0], dtype=np.int64), mc,
                    seed0, seed0)[0])
            extra0 = v0 ^ bool(o.invert)

        # output pass (r_output conventions); iterate matches only
        hit = verdicts ^ o.invert
        if (n_lines and not memory_mode and len(data)
                and data[0] == 0x0A and int(mc["D"]) > 0):
            # D>0 only: the A-phase newline branch forgets the CBO
            # restore (agrep.c:1649-1660 vs :1723-1733), so an EMPTY
            # first line's check still sees CurrentByteOffset == -1
            # and r_output's guard (:1927) drops it, matched or
            # inverse.  The D==0 loop restores in both halves.
            hit = hit.copy()
            hit[0] = False
        if (o.count and not o.filename_only and o.limit_output <= 0
                and o.limit_per_file <= 0):
            # vectorized -c (the reference's j counter just sums)
            if (not memory_mode and appended and n_lines
                    and int(nl[n_lines]) == N - 1):
                # r_output i >= end guard swallows the appended line
                hit = hit.copy()
                hit[n_lines - 1] = False
            sink.num_matched += int(np.count_nonzero(hit)) + int(extra0)
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
            p0 = int(nl[0])
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
        for k in np.flatnonzero(hit).tolist():
            p = int(nl[k + 1])                 # stream pos of the '\n'
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
            bp = int(nl[k]) + 1                # line start
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
                        head_hi = int(nl[k]) + 1024   # stream coord
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

