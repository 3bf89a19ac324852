"""Per-stream search engines and the multi-file executor.

Engines consume the event stream produced by ops.scan and
reproduce the reference's record/output semantics:

  BitapEngine -- mask-machine record search (bitap.c / asearch.c /
                 asearch1.c record handling and output()).
  SgrepEngine -- simple-pattern search (sgrep.c bm()/agrep() record
                 handling, s_output()).

The Executor mirrors exec() (agrep.c:3332-3752): per-file loop, -c
count lines, -l, -G, limits, best-match escalation.
"""

from __future__ import annotations

import bisect
import os
import sys
import time as _time

import numpy as np

from ..options import Options
from ..ops import scan as scan_ops
from ..parallel import multihost
from . import trace
from .output import Sink, output_bitap_record, output_sgrep_record
from .stream_io import ByteStream, open_bytes

MAX_RECORD = 49152  # agrep.h:49


def _isalnum(b: int) -> bool:
    return (48 <= b <= 57) or (65 <= b <= 90) or (97 <= b <= 122)


# C-locale isalnum() as a byte lookup table (the -w boundary test)
_ISALNUM_TAB = np.zeros(256, dtype=bool)
_ISALNUM_TAB[48:58] = _ISALNUM_TAB[65:91] = _ISALNUM_TAB[97:123] = True


def _find_delims(stream: np.ndarray, delim: bytes) -> np.ndarray:
    """Positions of the LAST byte of every delimiter occurrence."""
    if len(delim) == 1:
        return np.flatnonzero(stream == delim[0])
    hit = np.ones(len(stream) - len(delim) + 1, dtype=bool) \
        if len(stream) >= len(delim) else np.zeros(0, dtype=bool)
    for k, b in enumerate(delim):
        hit &= stream[k:len(stream) - len(delim) + 1 + k] == b
    return np.flatnonzero(hit) + len(delim) - 1


class BitapEngine:
    def __init__(self, q):
        self.q = q

    def sticky(self) -> bool:
        """True for the sticky machines, -p supersequence (Init1 = ~0,
        bitap.c:123) and '#' wildcards: their bits have an unbounded
        dependence window, so they are scanned a record a lane."""
        q = self.q
        return (q.opts.cost_insert == 0
                or (q.tables is not None and q.tables.wildmask != 0))

    def supports_streaming(self) -> bool:
        """The chunk-halo restart is invalid for the sticky machines;
        everything else streams."""
        return not self.sticky()

    def search_stream_chunked(self, data, sink: Sink, D: int) -> None:
        """Streaming twin of search_stream: chunked scan with halo
        carry + incremental record emission, O(chunk) memory
        (bitap.c:450-505 streaming, minus the 48KB buffer).

        data: np.memmap (or array) of the file bytes.  Produces output
        byte-identical to search_stream; tests/test_streaming.py pins
        the equivalence with forced-small chunks."""
        q = self.q
        o = q.opts
        dl = len(q.delim)
        c = q.consts
        inject_at = 1 + MAX_RECORD if len(data) > MAX_RECORD else None
        # no EOF delimiter append on exact-BlockSize-multiple files
        # (bitap.c:160 fires only on a partial final read)
        tail_pat = (q.delim if (len(data) % MAX_RECORD) != 0 else b"")
        if inject_at is None:
            machine = ByteStream([b"\n", data, tail_pat])
        else:
            # the first-block unroll glitch byte (see search_stream)
            machine = ByteStream([b"\n", data[:MAX_RECORD], b"\x00",
                                  data[MAX_RECORD:], tail_pat])
        outs = ByteStream([b"\n", data, tail_pat])
        endpos = int(c["endpos"])
        d_endpos = int(c["d_endpos"])

        j0 = 0
        if q.delimiter_opt and bytes(bytearray(data[:dl])) == q.delim:
            j0 = -1
        dl_off = dl if q.delimiter_opt else 1
        data_end = 1 + len(data) - 1

        if (o.count and not o.filename_only
                and not q.and_flag and o.limit_output == 0
                and o.limit_per_file == 0):
            # vectorized -c (and -v -c): count records by hit segments;
            # the per-record Python walk below would dominate a 10GB
            # scan
            self._count_chunked(machine, outs, inject_at, sink, D,
                                len(data))
            return
        if scan_ops.records_on_device():
            return self._walk_rows(self._device_rows(machine, inject_at, D),
                                   outs, data, inject_at, sink)

        lasti = 1                      # record start (output coords)
        prev_pk = None                 # previous delimiter position
        rec_k = 0                      # record ordinal (1-based)
        acc = 0
        any_hit = False
        for pos_b, ev_b in scan_ops.scan_event_list(
                machine.read, len(machine), q.folded_mask, c, D,
                "bitap", q.costs):
            for p_m, w in zip(pos_b.tolist(), ev_b.tolist()):
                if inject_at is not None and p_m == inject_at:
                    continue
                extra = 1 if (inject_at is not None
                              and p_m > inject_at) else 0
                pk = p_m - extra
                if w & endpos:
                    any_hit = True
                    acc |= w
                if not (w & d_endpos):
                    continue
                rec_k += 1
                j = rec_k + j0
                if q.and_flag:
                    verdict = ((acc & endpos) == endpos) \
                        or (False ^ o.invert)
                else:
                    verdict = any_hit ^ o.invert
                acc = 0
                any_hit = False
                this_lasti = lasti
                this_prev = prev_pk
                prev_pk = pk
                lasti = pk + 1 - dl
                if not verdict:
                    continue
                if o.filename_only and (sink.new_file
                                        or not o.post_filter):
                    sink.num_matched += 1
                    sink.write_str("%s\n" % sink.current_filename)
                    sink.new_file = False
                    return
                if this_lasti >= data_end:
                    continue
                print_end = pk - dl
                byte_offset = pk + 1 - dl_off + extra
                p_ref = (this_prev + 1 - dl
                         if this_prev is not None else None)
                synth = _bitap_clamped_synth(
                    outs, p_ref, pk,
                    asearch_mode=q.D > 0 and not q.opts.jump,
                    align=getattr(q, "sim_align", 112))
                if synth is not None:
                    synth, was_clamped = synth
                    if was_clamped:
                        sink.truncate = True
                    output_bitap_record(
                        sink, synth, 0, len(synth) - 1 - dl, j,
                        byte_offset, dl, q.delimiter_opt, q.delim,
                        q.outtail)
                else:
                    output_bitap_record(
                        sink, outs, this_lasti, print_end, j,
                        byte_offset, dl, q.delimiter_opt, q.delim,
                        q.outtail)
                if _limits_reached(o, sink):
                    return

    def _count_chunked(self, machine: ByteStream, outs: ByteStream,
                       inject_at, sink: Sink, D: int,
                       n_data: int) -> None:
        """Vectorized streaming count: per chunk, segment the event
        stream at delimiter pulses (cumsum over hit pulses) and count
        segments with >= 1 hit whose record starts before the appended
        delimiter (the bitap.c:213 guard)."""
        if scan_ops.records_on_device():
            return self._count_rows(self._device_rows(machine, inject_at, D),
                                    inject_at, sink, n_data)
        q = self.q
        c = q.consts
        dl = len(q.delim)
        endpos = np.uint32(c["endpos"])
        d_endpos = np.uint32(c["d_endpos"])
        # scalar-loop guard: record start >= 1 + len(data) - 1
        # (outs may or may not carry the EOF delimiter append)
        guard = n_data
        carry_hits = 0
        last_delim_out = None            # out-pos of last delim event
        count = 0
        for pos_b, ev_b in scan_ops.scan_event_list(
                machine.read, len(machine), q.folded_mask, c, D,
                "bitap", q.costs):
            if inject_at is not None and len(pos_b):
                keep = pos_b != inject_at
                pos_b, ev_b = pos_b[keep], ev_b[keep]
                pos_out = pos_b - (pos_b > inject_at)
            else:
                pos_out = pos_b
            if not len(pos_b):
                continue
            h_sel = (ev_b & endpos) != 0
            d_sel = (ev_b & d_endpos) != 0
            ch = np.cumsum(h_sel)
            di = np.flatnonzero(d_sel)
            if len(di) == 0:
                carry_hits += int(ch[-1]) if len(ch) else 0
                continue
            seg = ch[di] - np.concatenate([[0], ch[di[:-1]]])
            seg[0] += carry_hits
            carry_hits = int(ch[-1] - ch[di[-1]])
            pk = pos_out[di]
            prev_pk = np.concatenate(
                [[last_delim_out if last_delim_out is not None
                  else dl], pk[:-1]])
            starts = prev_pk + 1 - dl
            if last_delim_out is None:
                starts[0] = 1
            # starts > pk - dl is the printer's empty-span early return
            # (output():3812 i1 > i2), which skips the count too
            hitrec = (seg > 0) if not self.q.opts.invert else (seg == 0)
            count += int((hitrec & (starts < guard)
                          & (starts <= pk - dl)).sum())
            last_delim_out = int(pk[-1])
        sink.num_matched += count

    def _device_rows(self, machine: ByteStream, inject_at, D: int):
        """scan_record_list's rows of the machine's stream, the glitch
        byte's pair dropped: the records that fire, cut on the card."""
        q = self.q
        return scan_ops.scan_record_list(
            machine.read, len(machine), q.folded_mask, q.consts, D, q.costs,
            -1 if inject_at is None else inject_at, q.and_flag,
            q.opts.invert)

    def _search_rows(self, stream: np.ndarray, data: np.ndarray, inject_at,
                     sink: Sink, D: int) -> None:
        """search_stream on the torch backend: the card cuts the whole
        stream's events into records (scan_record_verdicts), and the host
        counts or prints the rows of those that fire."""
        q, o = self.q, self.q.opts
        rows = scan_ops.scan_record_verdicts(
            stream, q.folded_mask, q.consts, D, q.costs,
            -1 if inject_at is None else inject_at, q.and_flag, o.invert)
        self._rows_out(rows, stream, data, inject_at, sink)

    def _rows_out(self, rows: np.ndarray, stream: np.ndarray,
                  data: np.ndarray, inject_at, sink: Sink) -> None:
        """Count or print the rows (ordinal, end, previous end; stream
        positions, the glitch byte at inject_at included) of the records
        of search_stream's stream that fire."""
        q, o = self.q, self.q.opts
        if inject_at is not None:
            stream = np.concatenate([stream[:inject_at],
                                     stream[inject_at + 1:]])
        if (o.count and not o.filename_only and not o.fileout
                and not q.and_flag and o.limit_output <= 0
                and o.limit_per_file <= 0 and o.limit_total_file <= 0):
            self._count_rows([rows], inject_at, sink, len(data))
            return
        self._walk_rows([rows], stream, data, inject_at, sink)

    def _count_rows(self, batches, inject_at, sink: Sink,
                    n_data: int) -> None:
        """The vectorized count over the rows of the records that fire:
        a record counts when it starts before the appended delimiter
        (the bitap.c:213 guard) and its span is not empty (output():3812
        i1 > i2)."""
        dl = len(self.q.delim)
        count = 0
        for rows in batches:
            end, prev = rows[:, 1], rows[:, 2]
            if inject_at is not None:
                end = end - (end > inject_at)
                prev = prev - (prev > inject_at)
            start = np.where(prev < 0, 1, prev + 1 - dl)
            count += int(np.count_nonzero((start < n_data)
                                          & (start <= end - dl)))
        sink.num_matched += count

    def _walk_rows(self, batches, buf, data, inject_at, sink: Sink) -> None:
        """The print walk over the rows of the records that fire
        (ordinal, end, previous end; machine positions): the host keeps
        the record numbers, the guards, the clamp simulation, the printer
        and the limits, as the per-event walks do."""
        q, o = self.q, self.q.opts
        dl = len(q.delim)
        j0 = 0
        if q.delimiter_opt and bytes(bytearray(data[:dl])) == q.delim:
            j0 = -1
        dl_off = dl if q.delimiter_opt else 1
        data_end = len(data)
        for rows in batches:
            with trace.span("walk"):
                for k, p_m, prev in rows.tolist():
                    extra = 0
                    if inject_at is not None:
                        extra = 1 if p_m > inject_at else 0
                        prev -= 1 if prev > inject_at else 0
                    pk = p_m - extra
                    if o.filename_only and (sink.new_file
                                            or not o.post_filter):
                        sink.num_matched += 1
                        sink.write_str("%s\n" % sink.current_filename)
                        sink.new_file = False
                        return
                    p_ref = prev + 1 - dl if prev >= 0 else None
                    lasti = 1 if p_ref is None else p_ref
                    if lasti >= data_end:
                        continue
                    byte_offset = pk + 1 - dl_off + extra
                    synth = _bitap_clamped_synth(
                        buf, p_ref, pk,
                        asearch_mode=q.D > 0 and not q.opts.jump,
                        align=getattr(q, "sim_align", 112))
                    if synth is not None:
                        synth, was_clamped = synth
                        if was_clamped:
                            sink.truncate = True
                        output_bitap_record(
                            sink, synth, 0, len(synth) - 1 - dl, k + 1 + j0,
                            byte_offset, dl, q.delimiter_opt, q.delim,
                            q.outtail)
                    else:
                        output_bitap_record(
                            sink, buf, lasti, pk - dl, k + 1 + j0,
                            byte_offset, dl, q.delimiter_opt, q.delim,
                            q.outtail)
                    if _limits_reached(o, sink):
                        return

    def _memory_search(self, data: np.ndarray, sink: Sink,
                       D: int) -> None:
        """Memory-mode scan (bitap.c:309-446) from the records that fire,
        walked as _memory_search_loop walks them (_walk_memory): ONE
        pass over the caller's buffer, plus one zero byte where its
        length is odd (the pair-unrolled loop's overrun).  A machine
        that is not sticky takes its records from the scan
        (_memory_rows: mask_scan and record_verdicts on the torch
        backend, the native scan's events on the numpy backend); a
        sticky one with a one-byte delimiter from its record lanes
        (_memory_lane_rows), the first record from Init0; a sticky one
        with a multi-byte delimiter, whose record events fire at the
        delimiter's subsequences, keeps the per-byte loop."""
        q = self.q
        if self.sticky() and len(q.delim) > 1:
            return self._memory_search_loop(data, sink, D)
        stream = (np.concatenate([data, np.zeros(1, np.uint8)])
                  if len(data) & 1 else data)
        if self.sticky():
            rows = self._memory_lane_rows(stream, D)
        else:
            rows = self._memory_rows(stream, D)
        if self._walk_memory(rows, data, sink):
            sink.finish()

    def _memory_rows(self, stream: np.ndarray, D: int) -> np.ndarray:
        """The rows (ordinal, end, previous end or -1) of the records of
        a memory-mode stream that fire, for a machine that is not
        sticky: on the torch backend from the card (scan_record_verdicts:
        no glitch byte, the loop's AND and -v verdict), on the numpy
        backend cut from the scan's events (_event_rows).  The pulses
        of the scan's end positions, ORed over a record, are the loop's
        sticky end-position bits at its delimiter."""
        q, o = self.q, self.q.opts
        if scan_ops.records_on_device():
            return scan_ops.scan_record_verdicts(
                stream, q.folded_mask, q.consts, D, q.costs, -1, q.and_flag,
                o.invert)
        pos, ev = scan_ops.scan_event_pairs(stream, q.folded_mask, q.consts,
                                            D, "bitap", q.costs)
        return _event_rows(pos, ev, q.consts, q.and_flag, o.invert)

    def _memory_lane_rows(self, stream: np.ndarray, D: int) -> np.ndarray:
        """_memory_rows for a sticky machine with a one-byte delimiter: a
        record a lane, from the post-reset states, the first from Init0
        as the loop starts (scan_lane_rows on the torch backend, the host
        lanes on the numpy backend)."""
        q, o = self.q, self.q.opts
        first = [int(q.consts["init0"])] * (D + 1)
        if scan_ops.records_on_device():
            return scan_ops.scan_lane_rows(
                stream, q.delim[0], q.folded_mask, _sticky_consts(q), D,
                q.costs, _lane_inits(q, D), first, q.and_flag, o.invert)
        events = _bitap_record_lane_events(q, stream, D, first)
        pos = np.flatnonzero(events)
        return _event_rows(pos, events[pos], q.consts, q.and_flag,
                           o.invert)

    def _walk_memory(self, rows: np.ndarray, data: np.ndarray,
                     sink: Sink) -> bool:
        """_memory_search_loop's walk over the rows of the records that
        fire: j counts every record end (a leading delimiter
        pre-decrements it), a record starts at 1 or at its previous
        delimiter's first byte, prints only where it starts inside the
        buffer, and -l or a limit ends the walk (False; True where it
        ran to its end)."""
        q, o = self.q, self.q.opts
        dl = len(q.delim)
        n = len(data)
        j0 = 0
        if q.delimiter_opt and bytes(bytearray(data[:dl])) == q.delim:
            j0 = -1                          # bitap.c:320-323
        dl_off = dl if q.delimiter_opt else 1
        with trace.span("walk"):
            for k, p, prev in rows.tolist():
                if o.filename_only and (sink.new_file
                                        or not o.post_filter):
                    sink.num_matched += 1
                    sink.write_str("%s\n" % sink.current_filename)
                    sink.new_file = False
                    return False
                lasti = 1 if prev < 0 else prev + 1 - dl
                if lasti < n:                # !(lasti >= num_read)
                    output_bitap_record(
                        sink, data, lasti, p - dl, k + 1 + j0,
                        p + 1 - dl_off, dl, q.delimiter_opt, q.delim,
                        q.outtail)
                if _limits_reached(o, sink):
                    return False
        return True

    def _memory_search_loop(self, data: np.ndarray, sink: Sink,
                            D: int) -> None:
        """Faithful memory-mode scan (bitap.c:309-446), one byte at a
        time: ONE pass over the caller's buffer -- no prefill, no residue
        copies, no EOF delimiter append; lasti starts at 1 (:318), a
        leading delimiter pre-decrements j (:320-323), and the
        pair-unrolled loop's overrun byte reads the writable slack
        (zeros).

        Per-byte python: the route of a sticky machine with a multi-byte
        delimiter, and the independent check that tools and tests hold
        _memory_search's record routes to."""
        from ..ops import bitword
        q, o = self.q, self.q.opts
        c = dict(q.consts)
        # the real machine's Init1 keeps endposition bits STICKY until
        # the delimiter reset (so the AND/OR verdict reads them all at
        # the record event); the dense kernel's init1_ns strips them
        # for pulse events, which this faithful loop does not want
        c["init1_ns"] = c.get("init1", c["init1_ns"])
        if q.opts.cost_insert == 0:
            c["init1_ns"] = 0xFFFFFFFF       # -p (bitap.c:123)
        mask = q.folded_mask
        dl = len(q.delim)
        n = len(data)
        j = 0
        if q.delimiter_opt and bytes(bytearray(data[:dl])) == q.delim:
            j -= 1                           # bitap.c:320-323
        lasti = 1
        n_scan = n + (n & 1)                 # pair-unroll overrun
        st = c["init0"]
        sts = [c["init0"]] * (D + 1)
        d_bit = np.uint32(c["d_endpos"])
        e_bits = np.uint32(c["endpos"])
        for i in range(n_scan):
            b = int(data[i]) if i < n else 0
            cm = int(mask[b])
            if D == 0 and q.costs is None:
                st, ev = bitword.step_exact(st, cm, c)
            elif q.costs is not None:
                sts, ev = bitword.step_jump(sts, cm, c, D, *q.costs)
            else:
                sts, ev = bitword.step_kerr(sts, cm, c, D)
            if not (ev & d_bit):
                continue
            j += 1
            # verdict (bitap.c:342): `(AND && all) || ((!AND && any)
            # ^ INVERSE)` -- ^ binds tighter than ||, so INVERSE only
            # xors the OR clause; AND + -v fires on EVERY record
            if q.and_flag:
                fire = ((ev & e_bits) == e_bits) or bool(o.invert)
            else:
                fire = bool(ev & e_bits) ^ bool(o.invert)
            if fire:
                if o.filename_only and (sink.new_file
                                        or not o.post_filter):
                    sink.num_matched += 1
                    sink.write_str("%s\n" % sink.current_filename)
                    sink.new_file = False
                    return
                print_end = i - dl
                if lasti < n:                # !(lasti >= num_read)
                    byte_offset = (i + 1
                                   - (dl if q.delimiter_opt else 1))
                    output_bitap_record(
                        sink, data, lasti, print_end, j, byte_offset,
                        dl, q.delimiter_opt, q.delim, q.outtail)
                if _limits_reached(o, sink):
                    return
            lasti = i + 1 - dl
        sink.finish()

    def search_stream(self, data: np.ndarray, sink: Sink, D: int,
                      memory_mode: bool = False) -> None:
        q = self.q
        o = q.opts
        if memory_mode:
            return self._memory_search(data, sink, D)
        dl = len(q.delim)
        inject_at = None        # stream position of the glitch byte
        # the EOF delimiter append happens only on a PARTIAL final
        # read (bitap.c:160 `if(num_read < BlockSize)`): files sized
        # an exact multiple of BlockSize never get it, so a trailing
        # unterminated record silently never completes
        tail_pat = (q.delim if (len(data) % MAX_RECORD) != 0 else b"")
        if memory_mode:
            stream = data  # caller guarantees leading '\n' (agrep.chronicle)
        else:
            if len(data) > MAX_RECORD:
                # bitap.c's 2x-unrolled loop overruns `end` by one when
                # a block consumes an odd byte count: the prefilled
                # newline makes block ONE odd (bitap.c:149,191,232), so
                # the second unroll half reads buffer[end] -- a fresh
                # (zero) byte -- corrupting the carried state at the
                # first block boundary.  Matches in progress across
                # data offset BlockSize die; emulate with one injected
                # NUL.  Later full blocks consume even counts: clean.
                stream = np.concatenate([
                    np.frombuffer(b"\n", dtype=np.uint8),
                    data[:MAX_RECORD], np.frombuffer(b"\x00", np.uint8),
                    data[MAX_RECORD:],
                    np.frombuffer(tail_pat, dtype=np.uint8)])
                inject_at = 1 + MAX_RECORD
            else:
                stream = np.concatenate([
                    np.frombuffer(b"\n", dtype=np.uint8), data,
                    np.frombuffer(tail_pat, dtype=np.uint8)])
        c = q.consts
        if scan_ops.records_on_device() and self.supports_streaming():
            return self._search_rows(stream, data, inject_at, sink, D)
        if self.sticky():
            # -p supersequence (Init1 = ~0, bitap.c:123) and '#'
            # wildcards have sticky bits with unbounded reach: the
            # tile+halo restart is invalid, so scan record-parallel
            # (one lane per record: on the torch backend on the card,
            # scan_lane_rows).  A MULTI-BYTE -d makes even the lane
            # split invalid (the sticky machine fires record events at
            # delimiter SUBSEQUENCE completions): sequential faithful
            # scan instead.
            if len(q.delim) > 1:
                events = _bitap_sticky_seq_events(q, stream, D)
            elif scan_ops.records_on_device():
                rows = scan_ops.scan_lane_rows(
                    stream, q.delim[0], q.folded_mask, _sticky_consts(q), D,
                    q.costs, _lane_inits(q, D), None, q.and_flag, o.invert)
                return self._rows_out(rows, stream, data, inject_at, sink)
            else:
                events = _bitap_record_lane_events(q, stream, D)
            pos = np.flatnonzero(events)
            ev = events[pos]
        else:
            pos, ev = scan_ops.scan_event_pairs(
                stream, q.folded_mask, q.consts, D, "bitap", q.costs)
        cbo_extra = np.zeros(len(pos), dtype=np.int64)
        if inject_at is not None:
            # remap to the real stream: the glitch byte exists only in
            # the machine's view, never in the record buffer -- but it
            # DID advance CurrentByteOffset (bitap.c:172), so -b/-q
            # offsets past it report one extra
            keep = pos != inject_at
            pos, ev = pos[keep], ev[keep]
            cbo_extra = (pos > inject_at).astype(np.int64)
            pos = pos - (pos > inject_at)
            stream = np.concatenate([stream[:inject_at],
                                     stream[inject_at + 1:]])
        delim_sel = (ev & np.uint32(c["d_endpos"])) != 0
        P = pos[delim_sel]                       # record-end positions
        P_extra = cbo_extra[delim_sel]
        hit_pos = pos[(ev & np.uint32(c["endpos"])) != 0]
        hit_ev = ev[(ev & np.uint32(c["endpos"])) != 0]

        j0 = 0
        if q.delimiter_opt and not memory_mode and \
                bytes(bytearray(data[:dl])) == q.delim:
            j0 = -1
        dl_off = dl if q.delimiter_opt else 1

        # iterate records: lasti starts at 1 in BOTH modes (file mode
        # past the prefilled newline, bitap.c:141; memory mode past the
        # caller's contract newline, bitap.c:318 `lasti = 1`)
        lasti0 = 1
        # ---- vectorized flat count: the per-record loop below only
        # contributes (verdict, lasti < data_end, i1 <= i2) to the
        # count, all computable array-wise -- the python loop
        # dominated -c wall time on line-dense files (e.g. the
        # kernel-ineligible fallback shapes)
        if (o.count and not o.filename_only and not o.fileout
                and not q.and_flag and o.limit_output <= 0
                and o.limit_per_file <= 0 and o.limit_total_file <= 0):
            if len(P):
                data_end = len(data)
                lasti_arr = np.empty(len(P), dtype=np.int64)
                lasti_arr[0] = lasti0
                lasti_arr[1:] = P[:-1] + 1 - dl
                hi_i = np.searchsorted(hit_pos, P, side="right")
                any_hit = np.diff(np.concatenate([[0], hi_i])) > 0
                verdict = any_hit ^ bool(o.invert)
                ok = (verdict & (lasti_arr < data_end)
                      & (lasti_arr <= P - dl))
                sink.num_matched += int(np.count_nonzero(ok))
            return
        idx_lo = 0
        for k in range(len(P)):
            pk = int(P[k])
            lasti = (int(P[k - 1]) + 1 - dl) if k > 0 else lasti0
            print_end = pk - dl
            j = k + 1 + j0
            # part hits within (prev event, this event]
            idx_hi = int(np.searchsorted(hit_pos, pk, side="right"))
            seg = hit_ev[idx_lo:idx_hi]
            idx_lo = idx_hi
            if q.and_flag:
                acc = 0
                for w in seg:
                    acc |= int(w)
                all_hit = (acc & c["endpos"]) == c["endpos"]
                verdict = all_hit or (False ^ o.invert)
            else:
                any_hit = len(seg) > 0
                verdict = any_hit ^ o.invert
            if not verdict:
                continue
            if o.filename_only and (sink.new_file or not o.post_filter):
                sink.num_matched += 1
                sink.write_str("%s\n" % sink.current_filename)
                sink.new_file = False
                return
            # bitap.c:213/268 guard: no output when the record starts at
            # or past the end of the real data (the appended delimiter)
            data_end = len(data) if memory_mode else 1 + len(data) - 1
            if lasti >= data_end:
                continue
            byte_offset = pk + 1 - dl_off + int(P_extra[k])
            synth = None
            if not memory_mode:
                # preserved spans start at the previous delimiter's
                # FIRST byte (lasti = i - D_length)
                p_ref = (int(P[k - 1]) + 1 - dl) if k > 0 else None
                synth = _bitap_clamped_synth(
                    stream, p_ref, pk,
                    asearch_mode=q.D > 0 and not q.opts.jump,
                    align=getattr(q, "sim_align", 112))
            if synth is not None:
                synth, was_clamped = synth
                if was_clamped:
                    sink.truncate = True
                output_bitap_record(
                    sink, synth, 0, len(synth) - 1 - dl, j,
                    byte_offset, dl, q.delimiter_opt, q.delim,
                    q.outtail)
            else:
                # unclamped records print whole, even past Max_record
                # (the buffer holds residue + current block)
                output_bitap_record(
                    sink, stream, lasti, print_end, j, byte_offset,
                    dl, q.delimiter_opt, q.delim, q.outtail)
            if _limits_reached(o, sink):
                break


BS_BITAP = 49152      # BlockSize == Max_record (agrep.h:48-49)


def _bitap_clamped_synth(stream, p_ref: int, pk: int,
                         asearch_mode: bool = False,
                         align: int = 112):
    """The reference's residue clamp, simulated per record: when a
    newline record outgrows the buffer, each block-end residue copy
    keeps only Max_record bytes from `lasti` (bitap.c:286-297,
    asearch.c:308-320), so output() prints a preserved head followed
    by the final block's prefix with the middle silently gone.
    asearch_mode replays asearch.c's `if (lasti == 0) lasti = 1`
    (:319), which erodes the preserved head by one byte per further
    clamp -- and even WITHOUT a clamp when the residue is exactly
    Max_record; bitap.c's `if (lasti < 0) lasti = 1` (:297) never
    fires, and neither does asearch1.c's (:244).  Dispatch: D > 0
    without -I/-S/-D -> asearch (erodes); any cost flag sets JUMP
    (agrep.c:2682-2694) -> asearch1 (bitap.c:113-116, no erosion).

    Returns (buf, clamped) -- `clamped` drives the TRUNCATE warning;
    an erosion-only shift prints from the synthesized buffer but
    keeps TRUNCATE off.

    Returns the synthesized print buffer starting AT the reference's
    lasti slot and ending at this delimiter, or None when the record
    never clamped (normal print).

    stream = '\\n' + data (+ appended delimiter); p_ref/pk are stream
    positions of the bounding delimiters (p_ref == 0 is the prefilled
    newline, buffer[Max_record-1]).

    p_ref is None when NO delimiter event preceded this record:
    bitap.c:141 / asearch.c:69 start lasti at Max_record (the first
    DATA byte), so the prefilled newline is never preserved and block
    one's residue is at most exactly Max_record (never clamps).  With
    the default newline delimiter the prefill itself fires the
    machine at position 0, so real records always have p_ref >= 0
    (p_ref == 0 means the previous delimiter's first byte IS the
    prefill slot, lasti = Max_record-1); only -d patterns the prefill
    cannot complete (e.g. paragraph mode '$$' -> '\\n\\n') reach the
    None case.

    The copies are performed with the PROCESS'S OWN libc strncpy on
    an alignment-matched scratch buffer, so the reference's exact
    copy semantics are inherited rather than modelled: NUL
    truncation + zero-fill of the preserved head, and the small
    deterministic mis-shift bands glibc's vectorized strncpy writes
    on overlapping src/dst (distance < 32 -- e.g. the eroded
    asearch copy strncpy(buf, buf+1, Max_record) garbles a 16-byte
    window per block; observed and fuzz-pinned against the compiled
    reference)."""
    BS = BS_BITAP
    if p_ref is None:
        p_d = -1                    # first copy point at block one
        lasti = BS                  # bitap.c:141: lasti = Max_record
    else:
        p_d = p_ref - 1             # data coords (-1 = prefill)
        lasti = BS - 1 if p_d < 0 else BS + (p_d % BS)
    e_d = pk - 1
    j1 = e_d // BS
    B = BS if p_d < 0 else (p_d // BS + 1) * BS   # first copy point
    if B > j1 * BS:
        return None     # no block end inside the record: normal print
    import ctypes
    buf = _sim_buffer(align)
    lib = _sim_libc()
    addr = buf.ctypes.data
    buf[:BS] = 0                    # area below lasti: never printed
    if p_ref == 0:
        buf[BS - 1] = stream[0]     # the prefilled newline slot
    clamped = False
    eroded = False
    while B <= j1 * BS:
        blk_lo_s = (B - BS) + 1     # stream coord of block start
        blk_hi_s = B + 1            # full blocks only (see j1 bound)
        buf[BS:2 * BS] = np.asarray(stream[blk_lo_s:blk_hi_s])
        R = BS + BS - lasti         # ResidueSize (l == BlockSize)
        if R > BS:
            R = BS                  # TRUNCATE; lasti is NOT moved
            clamped = True
        lib.strncpy(ctypes.c_void_p(addr + BS - R),
                    ctypes.c_void_p(addr + lasti), ctypes.c_size_t(R))
        lasti = BS - R
        if asearch_mode:
            if lasti == 0:
                # asearch.c:319 erodes even WITHOUT a clamp (an
                # exactly-Max_record residue): the print shifts one
                # byte but TRUNCATE stays off
                lasti = 1
                eroded = True
        else:
            if lasti < 0:
                lasti = 1
        B += BS
    # print span = buffer[lasti .. delim]: preserved head, then the
    # final block up to the delimiter (filled fresh, never copied)
    head = np.array(buf[lasti:BS], copy=True)
    tail = np.asarray(stream[j1 * BS + 1:pk + 1])
    out = np.concatenate([head, tail])
    if not clamped and not eroded:
        # residues never outgrew the window AND no NUL cut a copy
        # short: the preserved head equals the plain record bytes --
        # let the caller print straight from the stream
        plain = np.asarray(stream[p_ref + 1 - 1:pk + 1]) \
            if p_ref is not None else np.asarray(stream[1:pk + 1])
        if len(plain) == len(out) and bool((plain == out).all()):
            return None
    return out, clamped


_SIM_BUFS = {}
_SIM_LIBC = None

# glibc strncpy's overlap bands depend on the destination address mod
# 128 (its 4-vector main-loop period).  The reference's block buffer
# -- alloc_buf(Max_record+BlockSize+1), bitap.c:139/asearch.c:67 --
# is a heap chunk whose address is the heap base plus the footprint
# of every earlier input-dependent malloc: the Textfiles pointer
# array and per-file name copies (agrep.c:2938-2960),
# agrep_saved_pattern (:3074), preprocess's multibuf (freed,
# preprocess.c:60), one pattern+3 copy, and r_pat (freed,
# preprocess.c:113).  ALIGN_BASE is the heap-start residue of
# today's oracle build (derived with an LD_PRELOAD malloc logger;
# override with AGREP_TORCH_ALIGN_BASE if the reference is rebuilt
# with a different BSS layout).
ALIGN_BASE = int(os.environ.get("AGREP_TORCH_ALIGN_BASE", "672"))


def _glibc_chunk(req: int) -> int:
    """glibc malloc chunk footprint for a request of `req` bytes."""
    return max(32, 16 * ((req + 8 + 15) // 16))


def oracle_buf_align(pattern: str, d_arg_len, file_name_lens) -> int:
    """Mod-128 address residue of the reference's bitap/asearch block
    buffer for this invocation (see ALIGN_BASE).  Freed chunks stay in
    tcache and keep their footprint; r_pat reuses multibuf's freed
    chunk when their bins coincide (exact-size tcache).  Flat boolean
    patterns allocate one copy per , / ; term (len+2 each, the last
    len+3 -- LD_PRELOAD-verified)."""
    total = _glibc_chunk(8 * max(1, len(file_name_lens)))
    for ln in file_name_lens:
        total += _glibc_chunk(ln + 2)
    p = len(pattern)
    total += _glibc_chunk(p + 1)
    mb = _glibc_chunk(2 * p + 2)
    total += mb
    terms = []
    cur = []
    for ch in pattern:
        if ch in ",;":
            terms.append(len(cur))
            cur = []
        else:
            cur.append(ch)
    terms.append(len(cur))
    for tl in terms[:-1]:
        total += _glibc_chunk(tl + 2)
    total += _glibc_chunk(terms[-1] + 3)
    dw = (d_arg_len + 4) if d_arg_len is not None else 3
    rp = _glibc_chunk(p + 2 * dw + 8)
    if rp != mb:
        total += rp
    return (ALIGN_BASE + total) % 128


def _sim_buffer(align: int) -> np.ndarray:
    """Persistent 2*Max_record scratch whose address is pinned to
    `align` mod 128, matching the reference buffer's placement."""
    buf = _SIM_BUFS.get(align)
    if buf is None:
        base = np.zeros(2 * BS_BITAP + 8192 + 128, dtype=np.uint8)
        off = (align - (base.ctypes.data % 128)) % 128
        buf = base[off:off + 2 * BS_BITAP]
        _SIM_BUFS[align] = buf
    return buf


def _sim_libc():
    global _SIM_LIBC
    if _SIM_LIBC is None:
        import ctypes
        lib = ctypes.CDLL(None)
        lib.strncpy.restype = ctypes.c_void_p
        lib.strncpy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_size_t]
        _SIM_LIBC = lib
    return _SIM_LIBC


def _sgrep_delim_trims(data: np.ndarray, delim: bytes,
                       outtail: bool) -> list:
    """Per-block -d trim boundaries for sgrep's 32KB block loop
    (sgrep.c:325-399): each block's trim is the last delimiter fully
    inside its RAW read; no trim when the fallback
    `newbuf < text+offset+D_length` fires."""
    BLK = 2 * 16384
    dl = len(delim)
    N = len(data)
    marks = []
    pos = 0
    while pos < N:
        num_read = min(BLK, N - pos)
        dends = _find_delims(data[pos:pos + num_read], delim)
        if len(dends):
            le_end = int(dends[-1])
            le_start = le_end - dl + 1
            if outtail:
                marks.append(pos + le_end)
            elif le_start >= dl:
                marks.append(pos + le_start - 1)
        pos += num_read
    return marks


def _nonoverlapping_delims(stream: np.ndarray, delim: bytes) -> np.ndarray:
    """Left-greedy non-overlapping delimiter end positions (the machine
    cannot re-fire inside a just-consumed delimiter)."""
    ends = _find_delims(stream, delim)
    if len(delim) == 1 or len(ends) == 0:
        return ends
    out = []
    last_end = -1
    for e in ends:
        s = int(e) - len(delim) + 1
        if s > last_end:
            out.append(int(e))
            last_end = int(e)
    return np.asarray(out, dtype=np.int64)


def _bitap_sticky_seq_events(q, stream: np.ndarray, D: int) -> np.ndarray:
    """Sequential sticky-machine scan for -p / wildcard machines with a
    MULTI-BYTE -d: with Init1 = ~0 (bitap.c:123) the delimiter-end bit
    accumulates the delimiter as a SUBSEQUENCE, so record events fire
    wherever the delimiter's characters have appeared in order since
    the last event -- NOT at substring occurrences, which is what the
    record-lane split assumes.  Each event resets the machine through
    D_Mask (bitap.c:221-228), exactly like the bitword step functions.
    Per-byte python: slow, correct; the shape (-p with a multi-byte
    delimiter) is vanishingly rare."""
    from ..ops import bitword
    c = dict(q.consts)
    c["init1_ns"] = (0xFFFFFFFF if q.opts.cost_insert == 0
                     else c["init1"])
    mask = q.folded_mask
    events = np.zeros(len(stream), dtype=np.uint32)
    sb = bytes(bytearray(np.asarray(stream)))
    if D == 0 and q.costs is None:
        st = c["init0"]
        for i, b in enumerate(sb):
            st, ev = bitword.step_exact(st, int(mask[b]), c)
            if ev:
                events[i] = ev
    else:
        sts = [c["init0"]] * (D + 1)
        for i, b in enumerate(sb):
            if q.costs is not None:
                sts, ev = bitword.step_jump(sts, int(mask[b]), c, D,
                                            *q.costs)
            else:
                sts, ev = bitword.step_kerr(sts, int(mask[b]), c, D)
            if ev:
                events[i] = ev
    return events


def _event_rows(pos: np.ndarray, ev: np.ndarray, consts: dict,
                and_flag: bool, invert: bool) -> np.ndarray:
    """The rows (ordinal, end, previous end or -1) of the records that
    fire, cut from a stream's events as record_verdicts cuts them: an
    event with d_endpos ends a record, its own hit bits in it; a record
    fires, with and_flag, when its hit bits make up endpos or invert,
    else when it has any ^ invert."""
    endpos = np.uint32(consts["endpos"])
    ends = pos[(ev & np.uint32(consts["d_endpos"])) != 0]
    if not len(ends):
        return np.zeros((0, 3), dtype=np.int64)
    hit = ev & endpos
    seg = np.searchsorted(ends, pos, side="left")
    if and_flag:
        acc = np.zeros(len(ends) + 1, dtype=np.uint32)
        np.bitwise_or.at(acc, seg, hit)
        fire = ((acc[:len(ends)] & endpos) == endpos) | bool(invert)
    else:
        any_hit = np.bincount(seg[hit != 0], minlength=len(ends) + 1)
        fire = (any_hit[:len(ends)] != 0) ^ bool(invert)
    k = np.flatnonzero(fire)
    prev = np.concatenate([[-1], ends[:-1]])
    return np.stack([k, ends[k], prev[k]], 1).astype(np.int64)


def _sticky_consts(q) -> dict:
    """The machine constants the record lanes step with: Init1 is ~0 for
    -p (bitap.c:123 / asearch.c:49)."""
    consts = dict(q.consts)
    if q.opts.cost_insert == 0:
        consts["init1"] = 0xFFFFFFFF
    return consts


def _lane_inits(q, D: int) -> list:
    """The D+1 post-reset states a record lane starts from: one
    delimiter scalar-scanned from Init0 with the sticky Init1."""
    from ..ops import bitword
    sticky = _sticky_consts(q)
    sticky["init1_ns"] = sticky["init1"]
    mask = q.folded_mask
    if D == 0 and q.costs is None:
        st = sticky["init0"]
        for b in q.delim:
            st, _ = bitword.step_exact(st, int(mask[b]), sticky)
        return [st]
    sts = [sticky["init0"]] * (D + 1)
    for b in q.delim:
        if q.costs is not None:
            sts, _ = bitword.step_jump(sts, int(mask[b]), sticky, D,
                                       *q.costs)
        else:
            sts, _ = bitword.step_kerr(sts, int(mask[b]), sticky, D)
    return sts


def _bitap_record_lane_events(q, stream: np.ndarray, D: int,
                              first=None) -> np.ndarray:
    """Record-parallel evaluation of the mask machine (used when sticky
    bits make the windowed scan invalid), on the host: the numpy
    backend's route (the torch backend's is scan_ops.scan_lane_rows).
    Returns a synthetic event array: at each record's delimiter end,
    d_endpos plus the sticky part bits accumulated over the record.
    Every record starts from the post-reset states, the first from the
    D+1 states `first` where given (memory mode's Init0)."""
    c = q.consts
    sticky = _sticky_consts(q)
    P = _nonoverlapping_delims(stream, q.delim)
    events = np.zeros(len(stream), dtype=np.uint32)
    if len(P) == 0:
        return events
    mask = q.folded_mask
    init_states = np.asarray(_lane_inits(q, D), dtype=np.uint32)

    # lanes: record content + trailing delimiter
    starts = np.concatenate([[0], P[:-1] + 1])
    lens = P - starts                       # index of last delim byte
    order = np.argsort(lens, kind="stable")
    hits_all = np.zeros(len(P), dtype=np.uint32)
    from ..ops.scan import scan_lanes
    if first is not None:
        # the first record alone, from its own states
        order = order[order != 0]
        lane0 = np.asarray(stream[:P[0] + 1], dtype=np.uint8)[None, :]
        hits_all[0] = scan_lanes(
            lane0, lens[:1], mask, sticky, D, q.costs,
            np.asarray(first, dtype=np.uint32), sticky_endpos=True)[0]
    i = 0
    while i < len(order):
        Lmax = int(lens[order[i]]) + 1
        for b in (64, 256, 1024, 8192, 49152 + 64):
            if Lmax <= b:
                Lmax = b
                break
        j = i
        while j < len(order) and lens[order[j]] + 1 <= Lmax:
            j += 1
        idxs = order[i:j]
        R = len(idxs)
        lanes = np.zeros((R, Lmax), dtype=np.uint8)
        ll = np.empty(R, dtype=np.int64)
        for r, li in enumerate(idxs):
            s, e = int(starts[li]), int(P[li])
            lanes[r, :e - s + 1] = stream[s:e + 1]
            ll[r] = e - s
        hits = scan_lanes(lanes, ll, mask, sticky, D, q.costs,
                          init_states, sticky_endpos=True)
        hits_all[idxs] = hits
        i = j
    for k in range(len(P)):
        events[int(P[k])] = np.uint32(c["d_endpos"]) | \
            (hits_all[k] & np.uint32(c["endpos"]))
    return events


class SgrepEngine:
    def __init__(self, q):
        self.q = q
        # cross-file reused-buffer model: sgrep() re-mallocs the same
        # chunk per file (sgrep.c:327, io.c:38), so file K's scan runs
        # over file K-1's leftovers.  Files already scanned (or skipped
        # by a multihost partition) queue here; the buffer state is
        # materialized lazily the first time a replay path consults it.
        self._sg_pending: list = []
        self._sg_buf = None
        # one-time +4112 layout shift: if the run's FIRST stdout bytes
        # fall between a file's free_buf and the next alloc_buf (-c
        # count lines print in that gap), the stdio chunk is carved
        # from the freed space and the next buffer lands 4112 higher
        # (same mechanism as the mgrep model, seed 850115)
        self._sg_stdio_at_note = True
        self._sg_shift_done = False

    def _sg_note_file(self, data=None, path: str | None = None,
                      sink=None) -> None:
        """Record a file whose bytes passed through the reference's
        reused scan buffer before the next file's scan."""
        self._sg_pending.append(data if data is not None else path)
        if sink is not None:
            self._sg_stdio_at_note = bool(
                getattr(sink, "_vs_alloc", True))

    def _sg_init_buf(self, sink=None):
        """Materialize the reused buffer's pre-file state: walk every
        pending file's block loop (buffer writes only).  Returns the
        evolved buffer, or None when no prior file exists (zero-filled
        fresh-process state)."""
        if (sink is not None and not self._sg_shift_done
                and not self._sg_stdio_at_note
                and getattr(sink, "_vs_alloc", True)
                and (self._sg_pending or self._sg_buf is not None)):
            # the stdio carve happened in the gap before THIS file's
            # alloc: materialize what came before, then shift
            buf = self._sg_init_buf()
            if buf is not None:
                SH = 4096 + 16
                buf[:len(buf) - SH] = buf[SH:].copy()
                buf[len(buf) - SH:] = 0
            self._sg_shift_done = True
            return buf
        if not self._sg_pending:
            return self._sg_buf
        from . import sgrep_sim
        q = self.q
        for item in self._sg_pending:
            if isinstance(item, str):
                try:
                    item = open_bytes(item)
                except (OSError, IOError):
                    continue
            vb = sgrep_sim.VirtualSgrepBuffer(
                np.asarray(item), q.sg_pattern, q.delimiter_opt,
                q.delim, q.outtail, init_buf=self._sg_buf)
            for _ in vb.blocks():
                pass
            self._sg_buf = vb.buf
        self._sg_pending = []
        return self._sg_buf

    def supports_streaming(self) -> bool:
        """The -c fast paths stream, and so does the default record
        PRINT mode of the D==0 bm/monkey engines (the most common
        invocation on large files).  Inverse PRINT/-l/-d/limit modes
        still take the whole-file path (their block-quirk emulations
        walk the full virtual buffer) -- but -c -v streams: sgrep's
        COUNT branch ignores INVERSE and counts matched records
        (sgrep.c:808-817), so the inverse count IS the plain count."""
        q, o = self.q, self.q.opts
        if (q.delimiter_opt
                or o.limit_output or o.limit_per_file
                or getattr(o, "limit_total_file", 0)):
            return False
        if o.invert and not o.count:
            return False
        if o.filename_only:
            # -l early-returns at the first match (sgrep.c:745): the
            # streamed walk stops at the first surviving event.  Only
            # for the run's LAST file (Executor hint): an early stop
            # leaves the reference's reused scan buffer holding just
            # the blocks read, and the cross-file stale model replays
            # full files -- the last file has no stale consumer.
            return (q.D == 0 and q.sg_sub in ("bm", "monkey")
                    and b"\n" not in q.sg_pattern
                    and not o.invert and not o.count
                    and getattr(self, "_sg_more_files", True) is False)
        if q.D == 0:
            if not (q.sg_sub in ("bm", "monkey")
                    and b"\n" not in q.sg_pattern):
                return False
            if o.count:
                return True
            # streaming print: plain record output (+-b offsets)
            return not (o.silent or o.fileout or o.multi_output)
        return (o.count and q.sg_sub == "agrep" and not o.wordbound
                and q.sg_m - q.D > 2)

    def search_stream_chunked(self, data, sink: Sink, D: int) -> None:
        """Streaming -c: chunked scan + incremental line/record count,
        O(chunk) memory.  D==0 counts lines with >=1 match (bm/monkey
        jump to the record end after each count, sgrep.c:815); D>0
        replays agrep()'s overcount walk with streamed events."""
        q, o = self.q, self.q.opts
        if D == 0 and not o.count and not o.filename_only:
            return self._print_stream_chunked(data, sink)
        stream = ByteStream([b"\n", data])
        N = len(stream)
        chunk = scan_ops.STREAM_CHUNK
        W = min(max(q.sg_consts.get("m", 32) + D + 2, 48),
                scan_ops.DEFAULT_TILE)
        m = q.sg_m

        if D > 0 and q.sg_m // (D + 1) == 0:
            # zero-length fragments: the filter never fires (prep:1058)
            return

        walker = None
        if D > 0:
            # clamped residues (records > MAXLINE crossing 32KB block
            # ends) make the count depend on the clobbered buffer --
            # hand the whole file to the exact replay path
            from .. import native
            nld = native.find_delims_all(np.asarray(data), b"\n")
            if nld is None:
                nld = np.flatnonzero(np.asarray(data) == 0x0A)
            B2 = 2 * 16384
            ends = np.arange(B2, len(data), B2, dtype=np.int64)
            if len(ends):
                if len(nld):
                    ki = np.searchsorted(nld, ends)
                    lastnl = np.where(ki > 0,
                                      nld[np.maximum(ki - 1, 0)],
                                      np.int64(-1))
                else:
                    lastnl = np.full(len(ends), -1, dtype=np.int64)
                from . import sgrep_sim
                if bool(((ends - lastnl) > 1024).any()) \
                        or sgrep_sim.nul_near_boundaries(data):
                    layout = sgrep_sim.block_layout(
                        np.asarray(data), None, q.outtail)
                    if any(b.clobbered or b.fallback for b in layout) \
                            or sgrep_sim.nul_in_residue(data, layout):
                        self.search_stream(np.asarray(data), sink, D)
                        return
            from .sgrep_sim import AgrepCountWalker
            walker = AgrepCountWalker(data, q.sg_pattern, D,
                                      init_buf=self._sg_init_buf(sink))
        pend = np.empty(0, dtype=np.int64)  # events awaiting record end
        lines_counted = 0
        last_line = -1
        last_nl = -1                     # latest newline seen (stream)
        nl_before = 0                    # newlines before this chunk
        B2 = 2 * 16384
        g0 = 0
        while g0 < N:
            g1 = min(N, g0 + chunk)
            if D == 0 and g1 < N:
                # align chunk ends to sgrep's 32KB block boundaries
                # (stream coord 32768j + 1) so clobber geometry is
                # chunk-local (sgrep.c:464-468)
                g1 = max(((g1 - 1) // B2) * B2 + 1, g0 + 1)
            lo = g0 - W if g0 >= W else 0
            text = stream.read(lo, g1)
            body = text[g0 - lo:]
            # sparse C scan when available: the dense event-array
            # round-trip (zeros + scatter + flatnonzero over the whole
            # chunk) dominated exact -c wall time
            pairs = None
            if scan_ops._BACKEND == "numpy":
                from .. import native
                pairs = native.bitap_scan_events(
                    text, q.sg_mask, q.sg_consts, D, "sgrep", None)
            if pairs is not None:
                pp = pairs[0]
                pos = pp[pp >= (g0 - lo)] + lo
            else:
                pos = scan_ops.scan_event_pairs(
                    text, q.sg_mask, q.sg_consts, D, "sgrep",
                    keep_from=g0 - lo)[0] + lo
            from .. import native as _nat
            nld = _nat.find_delims_all(body, b"\n")
            nl = ((nld + g0) if nld is not None
                  else (np.flatnonzero(body == 0x0A) + g0))
            if D == 0:
                if o.wordbound and len(pos):
                    # vectorized over the chunk: events are at g0 <= p
                    # < g1 <= N, and text covers [lo, g1), so p+1 is in
                    # text except at the stream end and p-m reaches at
                    # most W+m bytes before g0 (the halo covers W >=
                    # m+2; p-m < lo only via the stream head)
                    last_char = q.sg_pattern[-1] if q.sg_pattern else 0
                    rel = pos - lo
                    np_text = np.asarray(text)
                    after = np.where(
                        pos + 1 < N,
                        np_text[np.minimum(rel + 1,
                                           len(np_text) - 1)],
                        np.uint8(last_char & 0xFF))
                    # the byte before the stream head is the spliced
                    # -d delimiter tail (sgrep.c:400-402), else the
                    # prefilled newline (sgrep.c:326)
                    head_b = (q.delim[-1] if q.delimiter_opt
                              else 0x0A)
                    before = np.where(
                        rel - m >= 0,
                        np_text[np.maximum(rel - m, 0)],
                        np.uint8(head_b))
                    isaln = _ISALNUM_TAB
                    keep = ~isaln[after] & ~isaln[before]
                    # edge fix-ups (a handful per chunk): p+1 past the
                    # chunk view but inside the stream; p-m before the
                    # halo but inside the stream
                    edge_a = (pos + 1 < N) & (rel + 1 >= len(np_text))
                    edge_b = (pos - m >= 0) & (rel - m < 0)
                    for ii in np.flatnonzero(edge_a | edge_b):
                        p = int(pos[ii])
                        a_b = int(stream[p + 1]) if p + 1 < N \
                            else last_char
                        b_b = int(stream[p - m]) if p - m >= 0 \
                            else head_b
                        keep[ii] = (not _isalnum(a_b)
                                    and not _isalnum(b_b))
                    pos = pos[keep]
                if g1 == N and len(pos) and int(pos[-1]) == N - 1:
                    pos = self._drop_phantom_tail_event(data, pos, N)
                # interior 32KB boundaries ending in this chunk: a
                # clamped residue copy (sgrep.c:464-468) makes block
                # behavior cascade -- count the clean prefix here, then
                # hand the rest of the file to the byte-exact buffer
                # replay (chunk ends are 32KB-aligned, so the carried
                # state at the takeover boundary is reconstructable)
                takeover = None          # (trim_data, rb_data)
                rb0 = max(1, (g0 - 1) // B2 + 1) * B2 + 1
                rbs = np.arange(rb0, min(g1, N - 1) + 1, B2,
                                dtype=np.int64)
                if len(rbs):
                    # last newline before each boundary, from the
                    # chunk's newline index (+ the carried last_nl for
                    # windows reaching before this chunk) -- the
                    # per-block rescan loop dominated exact -c
                    k = np.searchsorted(nl, rbs, side="left")
                    trims = np.where(k > 0,
                                     nl[np.maximum(k - 1, 0)],
                                     np.int64(-1))
                    lo_w = rbs - B2
                    trims = np.where(
                        trims >= lo_w, trims,
                        np.where(last_nl >= lo_w, np.int64(last_nl),
                                 lo_w))
                    bad = (rbs - 1) - trims + 1 > 1024
                    if not bad.all():
                        # strncpy residue copies (sgrep.c:470) truncate
                        # at a NUL and zero-fill: matches inside the
                        # zeroed span vanish -- replay from there.
                        # Residues here are <= 1024 bytes, so only the
                        # small window before each boundary is read.
                        for i in np.flatnonzero(~bad):
                            tr_i, rb_i = int(trims[i]), int(rbs[i])
                            if bool((stream.read(tr_i, rb_i)
                                     == 0).any()):
                                bad[i] = True
                    bi = np.flatnonzero(bad)
                    if len(bi):
                        rb = int(rbs[bi[0]])
                        trim = int(trims[bi[0]])
                        takeover = (trim - 1, rb - 1)
                        pos = pos[pos <= trim]
                if len(pos):
                    if o.filename_only:
                        # first surviving event: bm/monkey -l returns
                        # from inside the scan (sgrep.c:745/:1581)
                        sink.num_matched += 1
                        sink.write_str("%s\n" % sink.current_filename)
                        return
                    ids = nl_before + np.searchsorted(nl, pos, "left")
                    ids = np.unique(ids)
                    lines_counted += int((ids > last_line).sum())
                    last_line = max(last_line, int(ids[-1]))
                if takeover is not None:
                    from . import sgrep_sim
                    sink.num_matched += lines_counted
                    rc_t = sgrep_sim.sgrep_block_replay(
                        lambda lo, hi: np.asarray(data[lo:hi],
                                                  dtype=np.uint8),
                        len(data), q, sink, resume=takeover)
                    if rc_t == 'fname':
                        sink.write_str("%s\n" % sink.current_filename)
                    return
                if len(nl):
                    last_nl = int(nl[-1])
            else:
                # record end = one past the first newline at/after the
                # event+1 (s_output's curtextend); events past the last
                # newline of a chunk resolve in a later chunk.  Feed
                # resolved events to the incremental walk immediately --
                # O(chunk) retained, never O(file).
                ev_c: list = []
                re_c: list = []
                if len(pend) and len(nl):
                    ev_c.append(pend)
                    re_c.append(np.full(len(pend), int(nl[0]) + 1,
                                        dtype=np.int64))
                    pend = np.empty(0, dtype=np.int64)
                if len(pos):
                    jj = np.searchsorted(nl, pos + 1, side="left")
                    done = jj < len(nl)
                    if done.any():
                        ev_c.append(pos[done])
                        re_c.append(nl[jj[done]] + 1)
                    pend = np.concatenate([pend, pos[~done]])
                if len(nl):
                    last_nl = int(nl[-1])
                # stream coords -> data coords (base = leading "\n")
                frontier = min(g1, last_nl) - 1
                walker.feed(
                    np.concatenate(ev_c) - 1 if ev_c
                    else np.empty(0, dtype=np.int64),
                    np.concatenate(re_c) - 1 if re_c
                    else np.empty(0, dtype=np.int64),
                    frontier)
            nl_before += len(nl)
            g0 = g1

        if D == 0:
            sink.num_matched += lines_counted
            return
        if len(pend):
            walker.feed(pend - 1,
                        np.full(len(pend), len(data) + 1,
                                dtype=np.int64),
                        len(data) + 4)
        sink.num_matched += walker.finish()

    def _print_stream_chunked(self, data, sink: Sink) -> None:
        """Streaming record PRINT for the D==0 bm/monkey fast path:
        chunked scan + incremental record emission, O(chunk) + O(max
        line) memory.  Byte-identical to search_stream (pinned by
        tests/test_streaming.py with forced-small chunks).
        Pathological interior boundaries (clamped or NUL residues,
        sgrep.c:464-471) take over mid-stream via the byte-exact block
        replay, exactly like the -c streaming path."""
        q, o = self.q, self.q.opts
        from . import sgrep_sim
        from .. import native
        n_data = len(data)
        B2 = 2 * 16384
        # the EOF residue rescan (only after a full final read,
        # sgrep.c:478-486) re-reads its span through a strncpy carry:
        # a NUL there clamps printed bytes -- rare; whole-file path
        if n_data >= B2 and n_data % B2 == 0:
            tail = np.asarray(data[n_data - B2:], dtype=np.uint8)
            nls_f = np.flatnonzero(tail == 0x0A)
            trim_f = (n_data - B2 + int(nls_f[-1]) if len(nls_f)
                      else n_data - B2)
            if n_data - trim_f > 1 \
                    and bool((np.asarray(data[trim_f:]) == 0).any()):
                self.search_stream(np.asarray(data), sink, 0)
                return
        stream = ByteStream([b"\n", data])
        N = len(stream)
        chunk = scan_ops.STREAM_CHUNK
        m = q.sg_m
        W = min(max(m + 2, 48), scan_ops.DEFAULT_TILE)
        lastend = 0
        last_nl = 0                  # the prepended '\n' at stream 0
        pend = np.empty(0, dtype=np.int64)
        g0 = 0
        while g0 < N:
            g1 = min(N, g0 + chunk)
            if g1 < N:
                g1 = max(((g1 - 1) // B2) * B2 + 1, g0 + 1)
            lo = g0 - W if g0 >= W else 0
            text = stream.read(lo, g1)
            pairs = None
            if scan_ops._BACKEND == "numpy":
                pairs = native.bitap_scan_events(
                    text, q.sg_mask, q.sg_consts, 0, "sgrep", None)
            if pairs is not None:
                pp = pairs[0]
                pos = pp[pp >= (g0 - lo)] + lo
            else:
                pos = scan_ops.scan_event_pairs(
                    text, q.sg_mask, q.sg_consts, 0, "sgrep",
                    keep_from=g0 - lo)[0] + lo
            body = text[g0 - lo:]
            nld = native.find_delims_all(body, b"\n")
            nl = ((nld + g0) if nld is not None
                  else (np.flatnonzero(body == 0x0A) + g0))
            if o.wordbound and len(pos):
                last_char = q.sg_pattern[-1] if q.sg_pattern else 0
                rel = pos - lo
                np_text = np.asarray(text)
                after = np.where(
                    pos + 1 < N,
                    np_text[np.minimum(rel + 1, len(np_text) - 1)],
                    np.uint8(last_char & 0xFF))
                head_b = q.delim[-1] if q.delimiter_opt else 0x0A
                before = np.where(
                    rel - m >= 0, np_text[np.maximum(rel - m, 0)],
                    np.uint8(head_b))
                isaln = _ISALNUM_TAB
                keep = ~isaln[after] & ~isaln[before]
                edge_a = (pos + 1 < N) & (rel + 1 >= len(np_text))
                edge_b = (pos - m >= 0) & (rel - m < 0)
                for ii in np.flatnonzero(edge_a | edge_b):
                    p_ = int(pos[ii])
                    a_b = int(stream[p_ + 1]) if p_ + 1 < N \
                        else last_char
                    b_b = int(stream[p_ - m]) if p_ - m >= 0 \
                        else head_b
                    keep[ii] = (not _isalnum(a_b)
                                and not _isalnum(b_b))
                pos = pos[keep]
            if g1 == N and len(pos) and int(pos[-1]) == N - 1:
                pos = self._drop_phantom_tail_event(data, pos, N)
            # interior 32KB boundary health (clamps/NULs cascade):
            # emit the clean prefix, then hand the rest to the replay
            takeover = None
            rb0 = max(1, (g0 - 1) // B2 + 1) * B2 + 1
            rbs = np.arange(rb0, min(g1, N - 1) + 1, B2,
                            dtype=np.int64)
            if len(rbs):
                k_ = np.searchsorted(nl, rbs, side="left")
                trims = np.where(k_ > 0, nl[np.maximum(k_ - 1, 0)],
                                 np.int64(-1))
                lo_w = rbs - B2
                trims = np.where(
                    trims >= lo_w, trims,
                    np.where(last_nl >= lo_w, np.int64(last_nl),
                             lo_w))
                bad = (rbs - 1) - trims + 1 > 1024
                if not bad.all():
                    for i in np.flatnonzero(~bad):
                        tr_i, rb_i = int(trims[i]), int(rbs[i])
                        if bool((stream.read(tr_i, rb_i)
                                 == 0).any()):
                            bad[i] = True
                bi = np.flatnonzero(bad)
                if len(bi):
                    rb = int(rbs[bi[0]])
                    trim = int(trims[bi[0]])
                    takeover = (trim - 1, rb - 1)
                    pos = pos[pos <= trim]
            allp = (np.concatenate([pend, pos]) if len(pend)
                    else pos)
            pend = np.empty(0, dtype=np.int64)
            # ---- vectorized plain-record batch: no decorations means
            # the output is just the matched lines concatenated --
            # dedup to first-event-per-line, coalesce adjacent spans,
            # and write big slices.  EOF-adjacent records (the bm/
            # monkey textend adjustments) go through the scalar loop.
            fast = (o.printrecord and not o.bytecount
                    and not o.printoffset and not o.printpattern
                    and not getattr(sink, "fname", False))
            if fast and len(allp):
                emit = allp[allp >= lastend]
                idx_v = np.searchsorted(nl, emit - 1, "right") - 1
                begins = np.where(
                    idx_v >= 0,
                    (nl[np.maximum(idx_v, 0)] + 1 if len(nl)
                     else np.int64(0)),
                    np.int64(last_nl + 1))
                jdx_v = np.searchsorted(nl, emit + 1, "left")
                resolved = jdx_v < len(nl)
                pend = np.concatenate([pend, emit[~resolved]])
                emit = emit[resolved]
                begins = begins[resolved]
                ends = (nl[jdx_v[resolved]] + 1 if len(nl)
                        else np.empty(0, dtype=np.int64))
                # EOF-touching records take the scalar loop below
                near_eof = (g1 == N) & (ends >= N - 1)
                if np.any(near_eof):
                    pend = np.concatenate([pend, emit[near_eof]])
                    emit, begins, ends = (emit[~near_eof],
                                          begins[~near_eof],
                                          ends[~near_eof])
                if len(emit):
                    e_u, first_i = np.unique(ends, return_index=True)
                    b_u = begins[first_i]
                    sink.num_matched += len(e_u)
                    lastend = int(e_u[-1])
                    # coalesce adjacent records into single writes
                    brk = np.flatnonzero(b_u[1:] != e_u[:-1])
                    seg_lo = np.concatenate([[0], brk + 1])
                    seg_hi = np.concatenate([brk, [len(e_u) - 1]])
                    for s_i, h_i in zip(seg_lo.tolist(),
                                        seg_hi.tolist()):
                        sink.write(bytes(bytearray(stream.read(
                            int(b_u[s_i]), int(e_u[h_i])))))
                allp = pend if g1 == N else np.empty(0,
                                                     dtype=np.int64)
                if g1 == N:
                    pend = np.empty(0, dtype=np.int64)
            for p in allp.tolist():
                p = int(p)
                if p < lastend:
                    continue
                idx = int(np.searchsorted(nl, p - 1, "right")) - 1
                begin = int(nl[idx]) + 1 if idx >= 0 else last_nl + 1
                jdx = int(np.searchsorted(nl, p + 1, "left"))
                if jdx < len(nl):
                    end = int(nl[jdx]) + 1
                elif g1 == N:
                    end = N + 1
                else:
                    pend = np.concatenate(
                        [pend, np.asarray([p], dtype=np.int64)])
                    continue
                appended = False
                if q.sg_sub == "bm" and end >= N - 1:
                    end = N
                    appended = int(stream[N - 1]) != 0x0A
                elif end > N:
                    # monkey: no EOF adjustment (sgrep.c:1597-1599)
                    if p == N - 1:
                        end = N
                        appended = q.sg_pattern[-1:] == b"\n"
                    else:
                        end = N - 1
                        appended = False
                sink.num_matched += 1
                lastend = end
                if begin < end:
                    rec = stream.read(begin, min(end, N))
                else:
                    rec = np.zeros(0, dtype=np.uint8)
                output_sgrep_record(
                    sink, rec, 0, len(rec), p - 1, p - begin,
                    extra_len=1 if appended else 0)
                if appended and o.printrecord:
                    sink.write_str("\n")
            if takeover is not None:
                sgrep_sim.sgrep_block_replay(
                    lambda lo_, hi_: np.asarray(data[lo_:hi_],
                                                dtype=np.uint8),
                    n_data, q, sink, resume=takeover)
                return
            if len(nl):
                last_nl = int(nl[-1])
            g0 = g1

    def search_stream(self, data: np.ndarray, sink: Sink, D: int,
                      memory_mode: bool = False) -> None:
        q = self.q
        o = q.opts
        if (D == 0 and q.sg_sub in ("bm", "monkey") and not memory_mode
                and len(data) > 2 * 16384):
            # clamped residue copies (sgrep.c:464-468) and no-delimiter
            # fallback blocks (:399) make block behavior cascade in ways
            # the event-list model can't express: byte-exact buffer
            # replay instead (pathological corpora only)
            from . import sgrep_sim
            layout = sgrep_sim.block_layout(
                data, q.delim if q.delimiter_opt else None, q.outtail)
            if any(b.clobbered or b.fallback for b in layout) \
                    or sgrep_sim.nul_in_residue(data, layout):
                rc = sgrep_sim.sgrep_block_replay(
                    lambda lo, hi: np.asarray(data[lo:hi],
                                              dtype=np.uint8),
                    len(data), q, sink)
                if rc == 'fname':
                    sink.write_str("%s\n" % sink.current_filename)
                return
        data_orig = data                 # pre-trim (sentinel geometry)
        if memory_mode:
            # memory-mode scan END trims back to the last delimiter
            # (sgrep.c:597-603): `while(text[end] != '\n' && end > 1)
            # end--` -- the trailing partial record past it is NEVER
            # scanned (no matches, no inverse print beyond `end`)
            end_m = len(data) - 1
            if end_m >= 0 and not q.delimiter_opt:
                while end_m > 1 and int(data[end_m]) != 0x0A:
                    end_m -= 1
                data = data[:end_m + 1]
            elif end_m >= 0:
                # -d trim with the STALE offset guard: `offset` keeps
                # its 2*MAXLINE initializer in the memory branch, so
                # the backward-delimiter trim only engages when the
                # last delimiter sits at/after text+2048+D_length
                # (sgrep.c:598-603) -- small buffers never trim
                from . import sgrep_sim
                end_m = sgrep_sim._mem_delim_trim(
                    np.asarray(data, dtype=np.uint8), q.delim,
                    q.outtail)
                data = data[:end_m + 1]
            stream = data
            base = 0
        elif q.delimiter_opt:
            # with -d the scan buffer is the bare data: the delimiter is
            # written *before* the scan start (sgrep.c:400) and record
            # searches that find no delimiter stop at the buffer edges
            stream = data
            base = 0
        else:
            stream = np.concatenate(
                [np.frombuffer(b"\n", dtype=np.uint8), data])
            base = 1
        N = len(stream)
        amk_bounds = None        # a_monkey/monkey4 per-call spans
        amk_bufs = None          # their per-block buffer snapshots
        if not memory_mode:
            # every scan and PRINT reads the evolving block buffer,
            # where the residue carry is strncpy (sgrep.c:470): a NUL
            # in a residue (interior or EOF) zero-fills the rest of
            # the carried copy.  Swap in a clamped VIEW so events,
            # record spans, complements, and printed bytes all agree
            # with what the reference's buffer held.  (bm/monkey
            # interior-NUL shapes already returned via the block
            # replay above; this covers the other sub-engines and the
            # EOF residue.)
            V = self._sgrep_nul_clamp_view(data)
            if V is not None:
                data = V
                if q.delimiter_opt:
                    stream = data
                else:
                    stream = np.concatenate(
                        [np.frombuffer(b"\n", dtype=np.uint8), data])
        if q.sg_sub in ("a_monkey", "monkey4") and not memory_mode:
            # the long-approx/DNA filters can miss real matches and
            # choose DP-specific match ends; emulate their control
            # flow instead of dense scanning (sgrep_sim)
            from . import sgrep_sim
            scanf = (sgrep_sim.a_monkey_scan if q.sg_sub == "a_monkey"
                     else sgrep_sim.monkey4_scan)
            mpb, blocks, _ = scanf(
                data, q.sg_pattern, D, q.delimiter_opt, q.delim,
                init_buf=self._sg_init_buf(sink))
            plist = []
            for bm_list, (bstart, bend, gstart) in zip(mpb, blocks):
                for bp in bm_list:
                    plist.append(gstart + (bp - bstart) + base)
            pos = np.asarray(sorted(plist), dtype=np.int64)
            # record extraction is bounded by the CALL's textbegin/
            # textend (backward_delimiter(text, textbegin, ...) and
            # forward_delimiter(text+1, textend, ...), sgrep.c:
            # 2325-2331): clamp spans to the event's block
            amk_bounds = [(gstart + base,
                           gstart + (bend - bstart) + base)
                          for (bstart, bend, gstart) in blocks]
            # record BYTES come from the evolving block buffer
            # (clobbered splices, strncpy clamps, stale residue):
            # snapshot the buffers of event-bearing blocks
            amk_bufs = None
            if any(len(b_) for b_ in mpb):
                amk_bufs = {}
                vb2 = sgrep_sim.VirtualSgrepBuffer(
                    data, q.sg_pattern, q.delimiter_opt, q.delim,
                    q.outtail, init_buf=self._sg_init_buf(sink))
                for bi2, (s2, e2, g2) in enumerate(vb2.blocks()):
                    if bi2 < len(mpb) and len(mpb[bi2]):
                        amk_bufs[g2 + base] = np.asarray(
                            vb2.buf[s2:e2 + 2]).copy()
        else:
            pos = scan_ops.scan_event_pairs(
                stream, q.sg_mask, q.sg_consts, D, "sgrep")[0]
        m = q.sg_m

        sg_trims = None
        if q.delimiter_opt and not memory_mode and len(pos):
            # every block is cut back to the last complete delimiter in
            # its RAW data (sgrep.c:393-399); the residue is rescanned
            # from one past the trim (the in-loop copy start++,
            # sgrep.c:469-471), so matches straddling ANY trim boundary
            # are seen by neither scan (the memcpy'd delimiter before
            # the copy can stand in for a missing prefix); record
            # extraction is bounded by the final region, and the
            # appended D_pattern (sgrep.c:483) is out of range.
            dl_ = len(q.delim)
            marks = _sgrep_delim_trims(data, q.delim, q.outtail)
            if marks:
                sg_trims = marks
                keep = np.ones(len(pos), dtype=bool)
                starts = pos - (m - 1)
                for i_, (e, s_) in enumerate(zip(pos, starts)):
                    ki = bisect.bisect_left(marks, int(e))
                    lb = marks[ki - 1] if ki > 0 else None
                    if lb is None or s_ > lb:
                        continue
                    miss = lb + 1 - int(s_)
                    if miss > dl_ or \
                            q.sg_pattern[:miss] != q.delim[dl_ - miss:]:
                        keep[i_] = False
                pos = pos[keep]

        if q.sg_sub == "agrep" and q.sg_m // (D + 1) == 0:
            # escape-stripped pattern no longer than D (raw length
            # passed the checksg size guard): agrep()'s fragment
            # length m/(D+1) is zero, so the filter never produces a
            # candidate and nothing ever matches (sgrep.c prep:1058)
            pos = pos[:0]

        pos_count = pos
        if q.sg_sub == "agrep" and not memory_mode and len(pos):
            # agrep()'s scan loop never consumes the buffer's last byte
            # (i < n with n = textend - textbegin, sgrep.c:1169-1176):
            # a match ending exactly there does not fire for OUTPUT --
            # but an odd-length candidate round's pair-unroll overrun
            # CAN consume it and count it (the c_count walk models
            # that, so it sees the undropped events).
            pos = pos[pos != N - 1]

        if o.wordbound and D == 0:
            keep = []
            last_char = q.sg_pattern[-1] if q.sg_pattern else 0
            head_b3 = (q.delim[-1]
                       if (q.delimiter_opt and not memory_mode)
                       else 0x0A)
            for p in pos:
                p = int(p)
                after = int(stream[p + 1]) if p + 1 < N else last_char
                before = int(stream[p - m]) if p - m >= 0 else head_b3
                if not _isalnum(after) and not _isalnum(before):
                    keep.append(p)
            pos = np.asarray(keep, dtype=np.int64)

        if D == 0 and not memory_mode:
            pos = self._drop_phantom_tail_event(data, pos, N)

        nl = np.flatnonzero(stream == 0x0A)
        delim_ends = None
        if q.delimiter_opt:
            delim_ends = _find_delims(stream, q.delim)

        if (o.count and not q.delimiter_opt
                and not o.filename_only and D == 0
                and b"\n" not in q.sg_pattern
                and o.limit_output == 0 and o.limit_per_file == 0
                and len(pos)):
            # bm/monkey jump to the record end after each count
            # (sgrep.c:815 textbegin = curtextend), so the count is the
            # number of LINES with >= 1 match -- fully vectorizable.
            # (-v included: sgrep's COUNT branch ignores INVERSE and
            # counts matched records, sgrep.c:808-817.)
            # (tail-byte walk alignment already resolved by
            # _drop_phantom_tail_event above)
            lines = np.searchsorted(nl, pos, side="left")
            sink.num_matched += int(len(np.unique(lines)))
            return

        # bm()/monkey()'s INVERSE tail print depends on skip-loop
        # alignment (early return on a stop-region pseudo-match,
        # sgrep.c:748/:1581); emulate the reference's block loop.
        if (o.invert and not o.count and D == 0 and not memory_mode
                and not q.delimiter_opt
                and q.sg_sub in ("bm", "monkey")):
            self._bm_inverse_blocks(data, stream, base, pos, nl, sink)
            return
        # with -d each engine call restarts its complement pointer at
        # the block start, so spans between a block's last delimiter and
        # the next match are never printed (sgrep.c:396-403 + lastout)
        # -- and the same per-call lastout/tail-flush accounting
        # (sgrep.c:1242) governs the D>0 partition engine WITHOUT -d:
        # each block's tail flushes [lastout, textend] independently
        if (o.invert and not o.count and not memory_mode
                and (q.delimiter_opt
                     or (D > 0 and q.sg_sub == "agrep"
                         and q.sg_m // (D + 1) >= 1))):
            if (D > 0 and q.sg_sub == "agrep"
                    and q.sg_m // (D + 1) >= 1):
                # the partition engine's events, jumps, and record
                # spans all depend on the candidate-round machine
                # (post-jump UNSEEDED resets, s_output's
                # forward/backward_delimiter jumps): drive the inverse
                # complements straight from the exact replay's
                # s_output events and spans
                from . import sgrep_sim
                c_t, walk_pos, walk_spans, _r, walk_blk = \
                    sgrep_sim.agrep_exact(
                        data, q.sg_pattern, D, q.sg_mask,
                        q.sg_consts["endpos"], q.delimiter_opt,
                        q.delim, q.outtail, o.silent,
                        init_buf=self._sg_init_buf(sink))
                self._inverse_delim_replay(data, c_t, walk_pos,
                                           walk_spans, walk_blk, sink)
                return
            self._inverse_blocks_delim(data, pos, sink, D)
            return

        # agrep() (D>0 partition engine) overcounts events that a fresh
        # candidate round re-scans inside an already-output record;
        # reproduce its count exactly.
        c_count = None
        walk_spans = None
        if D > 0 and q.sg_sub == "agrep" and memory_mode \
                and q.sg_m // (D + 1) >= 1:
            # memory mode: ONE engine call over the caller's buffer --
            # pulse counting (num_of_matched per pulse, sgrep.c:1187)
            # with the sentinel + end-trim geometry; print modes drive
            # straight off the replay's s_output events and spans
            from . import sgrep_sim
            c_count, walk_pos, walk_spans, walk_raw = \
                sgrep_sim.agrep_mem_exact(
                    data_orig, q.sg_pattern, D, q.sg_mask,
                    q.sg_consts["endpos"], q.delimiter_opt, q.delim,
                    q.outtail, o.silent)
            if (o.count and not o.filename_only
                    and o.limit_output == 0 and o.limit_per_file == 0):
                sink.num_matched += c_count
                return
            pos = walk_pos           # caller-buffer offsets (base = 0)
        elif D > 0 and q.sg_sub == "agrep" and not memory_mode:
            from . import sgrep_sim
            # records outgrowing the residue window (MAXLINE,
            # sgrep.c:465-471) clobber the block buffer: candidates
            # and record spans then depend on the clamped copies,
            # which only the exact replay models.  Cheap pre-check:
            # any 32KB block end more than MAXLINE past the last
            # newline.
            pathological = False
            if not q.delimiter_opt and len(data) > 2 * 16384:
                B2 = 2 * 16384
                ends = np.arange(B2, len(data), B2, dtype=np.int64)
                nld = nl - base
                ki = np.searchsorted(nld, ends)
                lastnl = np.where(ki > 0, nld[np.maximum(ki - 1, 0)],
                                  np.int64(-1))
                if bool(((ends - lastnl) > 1024).any()):
                    layout = sgrep_sim.block_layout(data, None,
                                                    q.outtail)
                    pathological = any(b.clobbered or b.fallback
                                       for b in layout)
            if not pathological and not q.delimiter_opt \
                    and len(data) > 2 * 16384 \
                    and sgrep_sim.nul_near_boundaries(data):
                layout = sgrep_sim.block_layout(data, None, q.outtail)
                pathological = sgrep_sim.nul_in_residue(data, layout)
            # a match whose END touches the stream's last byte only
            # fires for OUTPUT via the EOF rescan's round machine (the
            # scan loop stops at i < n, but the 2x-unroll can consume
            # one byte past it -- sgrep.c:1169-1238): the event-list
            # proxy cannot decide it, so those shapes replay.  The
            # overrun byte is a stale/appended buffer byte, so the
            # D-level dense events can miss the shape: probe the tail
            # window one error level deeper.
            tail_ev = bool(len(pos_count)) \
                and int(pos_count[-1]) >= N - 1
            if (not tail_ev and not q.delimiter_opt and N >= 2
                    and stream[N - 1] != 0x0A and D + 1 <= 8):
                wlo = max(0, N - (q.sg_m + 2 * D + 10))
                ev_t = scan_ops.scan_events(
                    np.ascontiguousarray(stream[wlo:N]), q.sg_mask,
                    q.sg_consts, D + 1, "sgrep")
                tail_ev = bool(len(ev_t)) and bool(ev_t[-1])
            pure_count = (o.count and not o.filename_only
                          and o.limit_output == 0
                          and o.limit_per_file == 0)
            # m = M//(D+1) == 0 (D >= M) degenerates the filter: all
            # SHIFT entries are 0, the 0-char hash leaves only
            # MEMBER[0] set, and r1 = 0 makes HASH the *current* byte
            # -- candidates fire on NUL bytes only (sgrep.c:1061,
            # 1086-1099, 1126-1131).  Only the replay models that.
            if (q.sg_m - D <= 2 or q.delimiter_opt or pathological
                    or not pure_count or tail_ev):
                # degenerate fragment lengths (m close to D), -d
                # records, and EVERY print mode: which event triggers
                # each output depends on the per-round machine resets
                # (incl. the post-jump reset to the UNSEEDED ~0 state,
                # sgrep.c:1201-1204) and s_output's jumps, which the
                # event-list proxy cannot model -- replay the exact
                # round machine on the host and drive output from its
                # s_output events.  Pure counting keeps the proxy
                # (AgrepCountWalker), whose post-jump window events
                # are re-verified against the fresh machine.
                c_count, walk_pos, walk_spans, walk_raw, walk_blk = \
                    sgrep_sim.agrep_exact(
                        data, q.sg_pattern, D, q.sg_mask,
                        q.sg_consts["endpos"], q.delimiter_opt, q.delim,
                        q.outtail, o.silent,
                        init_buf=self._sg_init_buf(sink))
                pos = walk_pos + base
            else:
                c_count = sgrep_sim.agrep_c_count(
                    data, pos_count - base, nl - base, q.sg_pattern, D,
                    q.delimiter_opt, q.delim)
            if (o.count and not o.filename_only
                    and o.limit_output == 0 and o.limit_per_file == 0):
                # -v included: the count branch ignores INVERSE (the
                # loop below would count matched records and then
                # adjust to c_count either way)
                sink.num_matched += c_count
                return

        lastend = 0
        # -x starts the scan (and the INVERSE complement pointer) on
        # the sentinel newline (WHOLELINE start--), so the first
        # complement print leads with it
        lastout = 0 if (o.wholeline and o.invert and not memory_mode
                        and not q.delimiter_opt) else base
        # CurrentByteOffset at a match: bm tracks the match's last char
        # relative to the data start; agrep() (D>0) is one past it
        # (sgrep.c:738 vs :1178).  WHOLELINE's start--/CBO-- cancel out.
        cbo_adj = -base + (1 if (D > 0 and q.sg_sub == 'agrep') else 0)

        appended_newline = False
        records_counted = 0
        span_floor = 0          # textbegin chain within one region
        span_floor_reg = -1     # (resets per scan call, sgrep.c:812)
        for ei, p in enumerate(pos):
            p = int(p)
            if walk_spans is not None:
                # exact-walk mode: s_output's own spans and record
                # bytes -- truncation at block ends, residue re-prints,
                # stale-byte overrun prints, and skip-jumps are all
                # already encoded; no record lookup or dedup
                begin = int(walk_spans[ei, 0]) + base
                end = min(int(walk_spans[ei, 1]) + base, N)
                sink.num_matched += 1
                records_counted += 1
                if o.filename_only:
                    # agrep() returns at the first pulse of the match-
                    # bearing BLOCK (sgrep.c:1189), but every earlier
                    # non-firing engine call already ran its INVERSE
                    # tail flush (:1242): those raw block prints
                    # precede the filename line
                    if o.invert and walk_blk is not None \
                            and len(walk_blk) and not memory_mode:
                        from . import sgrep_sim as _sgs
                        first_blk = int(walk_blk[0])
                        vbf = _sgs.VirtualSgrepBuffer(
                            data, q.sg_pattern, q.delimiter_opt,
                            q.delim, q.outtail,
                            init_buf=self._sg_init_buf(sink))
                        for fb_i, (fs, fe, fg) in enumerate(
                                vbf.blocks()):
                            if fb_i >= first_blk:
                                break
                            sink.write(bytes(bytearray(
                                vbf.buf[fs:fe + 1])))
                    sink.write_str("%s\n" % sink.current_filename)
                    return
                if not o.count:
                    if o.invert:
                        sink.write(bytes(bytearray(
                            stream[lastout:max(begin, lastout)])))
                        lastout = end
                    else:
                        raw = walk_raw[ei]
                        output_sgrep_record(
                            sink, raw, 0, len(raw), p + cbo_adj,
                            p + 1 - begin, extra_len=0)
                if _limits_reached(o, sink):
                    return
                continue
            if p < lastend:
                continue
            # the backward search's floor is textbegin, which every
            # output advances to the previous record's END
            # (sgrep.c:812 textbegin = curtextend, no OUTTAIL
            # backoff): an overlapping delimiter occurrence starting
            # below it is invisible, so the NEXT record begins AT the
            # floor (round-5 seed 560314: '-d ll' over 'lll')
            floor_eff = 0
            if q.delimiter_opt and not memory_mode:
                regf = (bisect.bisect_left(sg_trims, p)
                        if sg_trims else 0)
                if regf == span_floor_reg:
                    floor_eff = span_floor
            begin, end = self._record_span(stream, nl, delim_ends, p, D,
                                           sg_trims,
                                           floor=floor_eff)
            amk_blo = None
            amk_snap = None
            if amk_bounds is not None:
                # spans are bounded by the engine call's textbegin/
                # textend (sgrep.c:2260-2283) and -- when the block
                # buffer snapshot is available -- computed IN it:
                # clobbered -d residues drift virtual offsets far from
                # raw ones, so a raw-stream span search looks at the
                # wrong bytes entirely
                bi_ = bisect.bisect_right(
                    [b_[0] for b_ in amk_bounds], p) - 1
                if 0 <= bi_ < len(amk_bounds):
                    blo, bhi = amk_bounds[bi_]
                    amk_blo = blo
                    snap_ = (amk_bufs.get(blo)
                             if amk_bufs is not None else None)
                    if snap_ is not None:
                        b_r, e_r = self._amk_span(
                            snap_, p - blo, bhi - blo, q.delim,
                            q.outtail, q.delimiter_opt)
                        begin, end = blo + b_r, blo + e_r
                        amk_snap = snap_
                    else:
                        begin = max(begin, blo)
                        if q.delimiter_opt:
                            # forward_delimiter returns end+1 when no
                            # delimiter fits (delim.c:56,69): the
                            # record includes the byte AT textend
                            lim = bhi + 1
                        else:
                            lim = bhi + (1 if (bhi < N
                                               and stream[bhi]
                                               == 0x0A)
                                         else 0)
                        if end > lim:
                            end = lim
            if (D == 0 and q.sg_sub == "bm" and not q.delimiter_opt
                    and end >= N - 1):
                # bm's EOF adjustment fires whenever the record end
                # reaches textend (sgrep.c:786-789) -- also via a
                # trailing PARTIAL line after the matched newline: the
                # record extends through it plus an artificial newline
                end = N
                appended_newline = stream[N - 1] != 0x0A
            if q.delimiter_opt:
                # the backward search's lower bound is textbegin, which
                # every output advances to the previous record's end
                # (sgrep.c:815 textbegin = curtextend): -d records
                # chain without overlap
                begin = max(begin, lastend)
            if end > N:
                if D == 0 and q.sg_sub == "monkey" and not q.delimiter_opt:
                    # monkey() has no EOF adjustment (sgrep.c:1597-1599
                    # vs bm:786-789): its forward scan stops AT the
                    # last byte (dropping it when it isn't \n), and for
                    # a match ending on the last byte it reads the
                    # sentinel pattern copy (pat[m-1]) placed after the
                    # block -- an extra \n when the pattern ends in \n.
                    if p == N - 1:
                        end = N
                        appended_newline = q.sg_pattern[-1:] == b"\n"
                    else:
                        end = N - 1
                        appended_newline = False
                elif D > 0 and q.sg_sub == "agrep" \
                        and not q.delimiter_opt:
                    # s_output has no EOF adjustment either: its
                    # forward scan stops AT the last byte and excludes
                    # it when it is not \n (sgrep.c:1306-1308)
                    end = N - 1
                    appended_newline = False
                else:
                    end = N
                    # bm appends an artificial newline for hits on a
                    # last line without one (sgrep.c:786-789); not -d
                    appended_newline = (not q.delimiter_opt
                                        and stream[N - 1] != 0x0A)
            sink.num_matched += 1
            records_counted += 1
            if o.filename_only:
                sink.write_str("%s\n" % sink.current_filename)
                return
            lastend = end
            span_floor = end
            span_floor_reg = (bisect.bisect_left(sg_trims, p)
                              if (q.delimiter_opt and sg_trims)
                              else 0)
            if not o.count:
                if o.invert:
                    sink.write(bytes(bytearray(stream[lastout:begin])))
                    lastout = end
                else:
                    byte_offset = p + cbo_adj
                    # s_output's @-offset subtracts (text + *i -
                    # curtextbegin) with *i one-past the match, same
                    # convention as its CurrentByteOffset -- keep the
                    # two in step so they cancel (sgrep.c:1399).
                    p_q = p + (1 if (D > 0 and q.sg_sub == "agrep")
                               else 0)
                    src, s_b, s_e, s_q = stream, begin, end, p_q
                    if amk_snap is not None:
                        # a_monkey/monkey4 record bytes from the
                        # block buffer snapshot (same coords shifted
                        # by the block's stream offset)
                        src = amk_snap
                        s_b = max(begin - amk_blo, 0)
                        s_e = min(end - amk_blo, len(src))
                        s_q = p_q - amk_blo
                    output_sgrep_record(
                        sink, src, s_b, s_e, byte_offset, s_q,
                        extra_len=1 if appended_newline else 0)
                    if appended_newline and o.printrecord:
                        sink.write_str("\n")
            if _limits_reached(o, sink):
                return
        if o.invert and not o.count and lastout <= N - 1:
            # memory mode: bm/monkey's skip walk runs past the trimmed
            # textend (the emergency-stop sentinel guarantees a
            # candidate); a VERIFIED occurrence ending beyond textend
            # hits `if(text > textend) return 0` (sgrep.c:748, :1581)
            # BEFORE the INVERSE tail flush (:987) -- the flush never
            # runs.  The guard precedes the WORDBOUND filter, so a raw
            # folded occurrence suffices.
            suppressed = False
            if memory_mode and D == 0 and q.sg_sub in ("bm", "monkey"):
                suppressed = self._mem_tail_match(
                    data_orig, N - 1, resume=lastout,
                    had_match=records_counted > 0)
            if not suppressed:
                sink.write(bytes(bytearray(stream[lastout:N])))
        if c_count is not None:
            sink.num_matched += c_count - records_counted

    def _wild_inverse_write(self, vb, p_buf: int, sink) -> None:
        """s_output INVERSE with curtextbegin BELOW lastout: fwrite
        gets a NEGATIVE length cast to size_t (sgrep.c:1355
        `fwrite(*lastout, 1, curtextbegin-*lastout, ...)`).  glibc's
        xsputn memcpys `buf_end - write_ptr` bytes from the wild
        pointer into the stdout stdio buffer, flushes, then the huge
        direct write(2) EFAULTs and emits nothing more -- so the
        reference prints up to 4096 bytes starting AT lastout.  With
        no prior output the stream has no buffer yet and nothing at
        all is emitted.  The source window runs off the text buffer's
        tail into adjacent heap: 16 bytes of malloc chunk metadata
        (the freed text chunk's size lingering in prev_size once a
        previous file cycled alloc_buf/free_buf, and the stdio
        chunk's size|PREV_INUSE), then the stdio buffer itself --
        lingering bytes of our OWN earlier output -- then untouched
        top-chunk zeros.  Verified against the oracle with an
        LD_PRELOAD fwrite logger (fuzz seed 810111)."""
        import struct
        had_buf = sink._vs_alloc
        # even an emitting-nothing attempt ALLOCATES the stream buffer
        # (glibc xsputn -> _IO_OVERFLOW -> _IO_doallocbuf): a later
        # wild write in the same run then has 4096 bytes of space
        sink._vs_alloc = True
        if not had_buf:
            return
        avail = 4096 - sink._vs_pos
        if avail <= 0:
            sink._vs_pos = 0          # overflow flush; EFAULT after
            return
        from . import sgrep_sim as _ss
        user = 2 * _ss.BLOCKSIZE + 2 * _ss.MAXLINE + _ss.MAXPATT
        tail = (bytes(bytearray(vb.buf[p_buf:user]))
                if p_buf < user else b"")
        prior = self._sg_buf is not None or bool(self._sg_pending)
        hdr = struct.pack("<QQ", user + 16 if prior else 0,
                          4096 + 16 + 1)
        img = bytes(sink._vs_img)
        sink.write((tail + hdr + img + b"\x00" * 4096)[:avail])
        sink._vs_pos = 0              # the reference's copy fills the
        #                               buffer exactly; OVERFLOW flushes

    def _inverse_delim_replay(self, data, c_total, pos, spans, blks,
                              sink) -> None:
        """INVERSE -d complements for the D>0 partition engine, driven
        by the exact replay's s_output events: per block (engine call),
        each printing event writes [lastout, curtextbegin) and moves
        lastout to its jump target; the call's tail [lastout, textend]
        flushes at the end (sgrep.c:1243-1271 + s_output's INVERSE
        branch :1399-1460)."""
        from . import sgrep_sim
        q, o = self.q, self.q.opts
        vb = sgrep_sim.VirtualSgrepBuffer(
            data, q.sg_pattern, q.delimiter_opt, q.delim, q.outtail,
            init_buf=self._sg_init_buf(sink))
        k = 0
        for bi, (start, end, gstart) in enumerate(vb.blocks()):
            g_end = gstart + (end - start)
            lastout = gstart
            # byte reads go through the evolving block buffer: strncpy
            # NUL clamps, clobbered splices, and stale residue bytes
            # are what s_output actually printed
            buf = vb.buf

            def bslice(glo, ghi):
                lo_b = start + (max(glo, gstart) - gstart)
                hi_b = start + (max(ghi, glo, gstart) - gstart)
                lo_b = max(min(lo_b, len(buf)), 0)
                hi_b = max(min(hi_b, len(buf)), lo_b)
                return bytes(bytearray(buf[lo_b:hi_b]))

            while k < len(blks) and int(blks[k]) == bi:
                if o.filename_only:
                    sink.num_matched += c_total
                    sink.write_str("%s\n" % sink.current_filename)
                    return
                sb = int(spans[k, 0])
                if sb < lastout:
                    # curtextbegin resolved BELOW lastout: the
                    # negative-length fwrite (see _wild_inverse_write)
                    self._wild_inverse_write(
                        vb, start + (lastout - gstart), sink)
                else:
                    sink.write(bslice(lastout, sb))
                lastout = int(spans[k, 1])
                k += 1
            if lastout <= g_end:
                sink.write(bslice(lastout, g_end + 1))
        sink.num_matched += c_total

    def _inverse_blocks_delim(self, data, pos, sink, D):
        """INVERSE with -d: per-engine-call complement printing with
        the delimiter-trimmed block spans (sgrep.c:395-403,934-966)."""
        from . import sgrep_sim
        q, o = self.q, self.q.opts
        dl = len(q.delim)
        vb = sgrep_sim.VirtualSgrepBuffer(
            data, q.sg_pattern, True, q.delim, q.outtail,
            init_buf=self._sg_init_buf(sink))
        ev_g = pos  # stream == data for -d (base 0)
        for (start, end, gstart) in vb.blocks():
            g_end = gstart + (end - start)
            sel = ev_g[(ev_g >= gstart) & (ev_g <= g_end)]
            # all BYTE reads go through the evolving block buffer:
            # strncpy NUL clamps, clobbered-residue splices, and stale
            # bytes are what the reference scanned AND printed
            # (positional virtual-global coords stay as before)
            buf = vb.buf

            def bslice(glo, ghi):
                lo_b = start + (glo - gstart)
                hi_b = start + (ghi - gstart)
                lo_b = max(min(lo_b, len(buf)), 0)
                hi_b = max(min(hi_b, len(buf)), lo_b)
                return bytes(bytearray(buf[lo_b:hi_b]))

            seg = np.asarray(buf[start:end + 1])
            dends = _find_delims(seg, q.delim)
            lastout = gstart
            lastend = gstart
            resume_buf = []
            # a TRIMMED block ends right before its last delimiter
            # occurrence (at it with -t); EOF/fallback blocks don't
            if q.outtail:
                trimmed = bytes(bytearray(
                    buf[end - dl + 1:end + 1])) == q.delim
            else:
                trimmed = bytes(bytearray(
                    buf[end + 1:end + 1 + dl])) == q.delim
            for e in sel:
                e = int(e)
                if e < lastend:
                    continue
                # record span around e in data coords.  backward_
                # delimiter floors at textbegin, which every output
                # advances to the previous record's END (sgrep.c:812
                # textbegin = curtextend): an overlapping delimiter
                # occurrence STARTING below the floor is invisible and
                # the complement resumes AT the floor (round-5 seed
                # 850473: '-d ll -t' over an 'lll' chain)
                i = int(np.searchsorted(dends + gstart, e, "left")) - 1
                if i >= 0:
                    dstart = int(dends[i]) + gstart - dl + 1
                    if dstart < lastend:
                        rbeg = lastend
                    else:
                        rbeg = dstart + dl if q.outtail else dstart
                else:
                    rbeg = gstart
                jdx = int(np.searchsorted(dends + gstart, e + dl, "left"))
                # forward_delimiter's range stops AT the block's last
                # byte (delim.c:64 curbegin+len <= end): on a trimmed
                # block a delimiter overlapping the trim is not found
                # (see _record_span)
                if trimmed and jdx < len(dends) \
                        and int(dends[jdx]) + gstart > g_end - 1:
                    jdx = len(dends)
                if jdx < len(dends):
                    dstart = int(dends[jdx]) + gstart - dl + 1
                    rend = dstart + dl if q.outtail else dstart
                else:
                    rend = g_end + 2 if not trimmed else g_end + 1
                sink.num_matched += 1
                if o.filename_only:
                    sink.write_str("%s\n" % sink.current_filename)
                    return
                sink.write(bslice(lastout, max(rbeg, lastout)))
                lastout = rend
                lastend = rend
                resume_buf.append(start + (rend - gstart))
                if _limits_reached(o, sink):
                    # sgrep.c:974-975: the limit return skips the
                    # call's INVERSE tail and all further blocks
                    return
            survives = True
            if D == 0 and q.sg_sub in ("bm", "monkey"):
                tr = np.arange(256, dtype=np.uint8)
                for cch in range(ord("A"), ord("Z") + 1):
                    tr[cch] = cch + 32
                if q.sg_sub == "bm":
                    shift_tab, shift_1 = sgrep_sim.build_bm_tables(
                        q.sg_pattern, tr)
                    survives = sgrep_sim.bm_inverse_survives(
                        vb.buf, start, end, q.sg_pattern, tr,
                        shift_tab, shift_1, resume_buf,
                        wordbound=bool(o.wordbound))
                else:
                    shift2, _s1 = sgrep_sim.build_monkey_tables(
                        q.sg_pattern, tr)
                    survives = sgrep_sim.monkey_inverse_survives(
                        vb.buf, start, end, q.sg_pattern, tr, shift2,
                        resume_buf, wordbound=bool(o.wordbound))
            if survives and lastout <= g_end:
                sink.write(bslice(lastout, g_end + 1))

    def _bm_inverse_blocks(self, data, stream, base, pos, nl, sink):
        """Per-block INVERSE output with bm()'s early-return emulation
        (sgrep.c:746-748, 987-1013)."""
        from . import sgrep_sim
        q, o = self.q, self.q.opts
        tr = np.arange(256, dtype=np.uint8)
        for c in range(ord("A"), ord("Z") + 1):
            tr[c] = c + 32
        if q.sg_sub == "monkey":
            shift2_m, _s1m = sgrep_sim.build_monkey_tables(
                q.sg_pattern, tr)
            shift_tab = shift_1 = None
        else:
            shift_tab, shift_1 = sgrep_sim.build_bm_tables(
                q.sg_pattern, tr)
            shift2_m = None
        # -x decrements the scan start onto the sentinel newline
        # (sgrep.c WHOLELINE start--): the FIRST complement write
        # starts there, leading the output with '\n' -- but only when
        # a write actually happens (an early-returning first call
        # prints nothing at all)
        pending_sentinel = bool(o.wholeline)
        vb = sgrep_sim.VirtualSgrepBuffer(data, q.sg_pattern, False,
                                          init_buf=self._sg_init_buf(sink))
        ev_g = pos - base        # match-end events in data coords
        nl_g = nl - base
        N = len(data)
        for (start, end, gstart) in vb.blocks():
            g_end = gstart + (end - start)
            sel = ev_g[(ev_g >= gstart) & (ev_g <= g_end)]
            # record walk within block
            lastout_g = gstart
            lastend_g = gstart
            resume_buf = []
            for e in sel:
                e = int(e)
                if e < lastend_g:
                    continue
                j = int(np.searchsorted(nl_g, e - 1, side="right")) - 1
                rbeg = int(nl_g[j]) + 1 if j >= 0 else 0
                jj = int(np.searchsorted(nl_g, e + 1, side="left"))
                rend = int(nl_g[jj]) + 1 if jj < len(nl_g) else N + 1
                rend = min(rend, g_end + 1)
                if rend >= g_end:
                    # bm's EOF adjust (sgrep.c:786-789): a record-end
                    # scan reaching textend sets curtextend past it,
                    # swallowing the block tail into the matched record
                    rend = (g_end + 1 if int(data[g_end]) == 0x0A
                            else g_end + 2)
                sink.num_matched += 1
                if o.filename_only:
                    sink.write_str("%s\n" % sink.current_filename)
                    return
                if pending_sentinel:
                    sink.write(b"\n")
                    pending_sentinel = False
                sink.write(bytes(bytearray(data[lastout_g:max(rbeg, lastout_g)])))
                lastout_g = rend
                lastend_g = rend
                resume_buf.append(start + (rend - gstart))
                if _limits_reached(o, sink):
                    # sgrep.c:974-975: skip the tail and later blocks
                    return
            # -x shifts the very first scan start onto the sentinel
            # newline (WHOLELINE start--), which changes the skip-walk
            # alignment -- and with it whether the emergency-stop
            # pseudo-match early-returns the call
            walk_start = (start - 1 if (o.wholeline and gstart == 0)
                          else start)
            if q.sg_sub == "monkey":
                survives = sgrep_sim.monkey_inverse_survives(
                    vb.buf, walk_start, end, q.sg_pattern, tr,
                    shift2_m, resume_buf,
                    wordbound=bool(o.wordbound))
            else:
                survives = sgrep_sim.bm_inverse_survives(
                    vb.buf, walk_start, end, q.sg_pattern, tr,
                    shift_tab, shift_1, resume_buf,
                    wordbound=bool(o.wordbound))
            if survives and lastout_g <= g_end:
                if pending_sentinel:
                    sink.write(b"\n")
                    pending_sentinel = False
                sink.write(bytes(bytearray(data[lastout_g:g_end + 1])))

    @staticmethod
    def _amk_span(snap, bp, te_rel, delim, outtail, delimiter_opt):
        """a_monkey/monkey4 record span around a match in BUFFER
        coords (sgrep.c:2260-2283): backward/forward newline walks or
        backward_/forward_delimiter (delim.c:50-96), bounded by the
        call's textbegin (snap[0]) and textend (snap[te_rel]).  Spans
        must be computed in the evolving buffer because clobbered -d
        residues make virtual offsets drift far from raw ones."""
        if not delimiter_opt:
            cb = bp
            while cb > 0 and snap[cb - 1] != 0x0A:
                cb -= 1
            if cb == 0 and len(snap) and snap[0] == 0x0A:
                cb = 1
            ce = bp + 1
            while ce < te_rel and snap[ce] != 0x0A:
                ce += 1
            if ce < len(snap) and snap[ce] == 0x0A:
                ce += 1
            return cb, ce
        dl = len(delim)
        if dl == 1 and delim == b"\n":
            e = bp - 1
            while e > 0 and snap[e] != 0x0A:
                e -= 1
            if outtail and e < len(snap) and snap[e] == 0x0A:
                e += 1
            cb = e if bp - dl >= 0 else 0
            b2 = bp + 1
            while b2 < te_rel and snap[b2] != 0x0A:
                b2 += 1
            if outtail and b2 < len(snap) and snap[b2] == 0x0A:
                b2 += 1
            ce = b2 if bp + 1 + dl <= te_rel else te_rel + 1
            return cb, ce
        cb = 0
        if bp - dl >= 0:
            for g in range(bp - dl, -1, -1):
                if bytes(bytearray(snap[g:g + dl])) == delim:
                    cb = g + dl if outtail else g
                    break
        ce = te_rel + 1
        if bp + 1 + dl <= te_rel:
            for g in range(bp + 1, te_rel - dl + 1):
                if bytes(bytearray(snap[g:g + dl])) == delim:
                    ce = g + dl if outtail else g
                    break
        return cb, ce

    def _sgrep_nul_clamp_view(self, data):
        """NUL-clamped view of the stream as the reference's evolving
        block buffer held it: each interior boundary's residue carry
        is strncpy (sgrep.c:470), so bytes after the residue's first
        NUL read as ZERO in the next block's scan and prints.  None
        when no residue holds an interior NUL (the copy is then
        byte-identical to the raw data) or when a boundary clobbers /
        falls back (cascading shapes, other paths handle those)."""
        q = self.q
        if len(data) <= 2 * 16384:
            return None
        from . import sgrep_sim
        if not sgrep_sim.nul_near_boundaries(data):
            return None
        layout = sgrep_sim.block_layout(
            data, q.delim if q.delimiter_opt else None, q.outtail)
        if any(b.clobbered or b.fallback for b in layout):
            return None
        V = None
        arr = np.asarray(data, dtype=np.uint8)
        for b in layout:
            seg = arr[b.trim_end:b.trim_end + b.residue]
            z = np.flatnonzero(seg == 0)
            if len(z) and int(z[0]) + 1 < b.residue:
                if V is None:
                    V = arr.copy()
                V[b.trim_end + int(z[0]):b.trim_end + b.residue] = 0
        # the EOF residue is carried by the SAME strncpy before the
        # post-loop rescan (sgrep.c:478-486): clamp it too.  Non-delim
        # blocks only trim when the read filled the whole 32KB buffer.
        B2 = 2 * 16384
        N = len(arr)
        lo = ((N - 1) // B2) * B2
        trim = N - 1
        if q.delimiter_opt:
            dl = len(q.delim)
            f = sgrep_sim._last_delim_start(arr, lo, N, q.delim)
            if f >= lo + dl:
                trim = (f + dl - 1) if q.outtail else (f - 1)
        elif N - lo == B2:
            chunk = arr[lo:N]
            nls = np.flatnonzero(chunk == 0x0A)
            trim = lo + int(nls[-1]) if len(nls) else lo
        residue = (N - 1) - trim + 1
        if residue > 1:
            if residue > 1024:
                return None          # clamped copy loses bytes: the
                                     # cascading shapes bail wholesale
            seg = arr[trim:N]
            z = np.flatnonzero(seg == 0)
            if len(z) and int(z[0]) + 1 < residue:
                if V is None:
                    V = arr.copy()
                V[trim + int(z[0]):N] = 0
        return V

    def _mem_tail_match(self, data_orig, te: int,
                        resume: int = 0, had_match: bool = False) -> bool:
        """True iff the memory-mode INVERSE tail flush is SKIPPED:
        bm()'s skip walk is unbounded (the emergency-stop sentinel --
        m copies of pat[m-1], sgrep.c:594 -- guarantees a landing),
        so after the last in-region output it overshoots textend onto
        ONE candidate; if that candidate VERIFIES, `if(text > textend)
        return 0` (:748) fires BEFORE the flush (:987).  A failed
        candidate re-enters the loop top, which exits normally and
        flushes.  Simulated exactly for bm (SHIFT = horspool table of
        m_preprocess with D=0, :1063-1068; d1 = shift_1, :1073-1085);
        monkey approximates with any-occurrence-beyond (its :1581
        guard is reached through a hashed walk, same shape)."""
        q = self.q
        pat = q.sg_pattern
        m = len(pat)
        if m == 0 or len(data_orig) == 0:
            return False
        buf = np.concatenate([np.asarray(data_orig, dtype=np.uint8),
                              np.full(m, pat[m - 1], dtype=np.uint8)])
        L = len(buf)
        tr = np.arange(256, dtype=np.uint8)
        if q.opts.nocase is not None:
            tr[65:91] += 32
        trp = tr[np.frombuffer(pat, dtype=np.uint8)]
        trb = tr[buf]
        if q.sg_sub != "bm":
            # monkey: any folded occurrence ending beyond textend
            if L < m:
                return False
            hit = np.ones(L - m + 1, dtype=bool)
            for k in range(m):
                hit &= trb[k:L - m + 1 + k] == trp[k]
            ends = np.flatnonzero(hit) + m - 1
            return bool((ends > te).any())
        SHIFT = np.full(256, m, dtype=np.int64)
        for i in range(m):
            if SHIFT[pat[i]] > m - 1 - i:
                SHIFT[pat[i]] = m - 1 - i
        d1 = m
        for k in range(1, m):
            if pat[m - 1 - k] == pat[m - 1] and k < d1:
                d1 = k
        if d1 == 0:
            d1 = 1
        dl = len(q.delim) if q.delimiter_opt else 1
        t = int(resume)
        shift = int(SHIFT[buf[t]]) if (had_match and 0 <= t < L) else 0
        guard = 0
        while t < te and guard < 4 * L + 64:
            guard += 1
            while shift:
                t += shift
                if t >= L:
                    return False
                shift = int(SHIFT[buf[t]])
            j = 0
            while j < m and (trb[t - j] if t - j >= 0 else 0) \
                    == trp[m - 1 - j]:
                j += 1
            if j == m:
                if t > te:
                    return True
                if q.opts.wordbound:
                    after = int(buf[t + 1]) if t + 1 < L else 0
                    before = int(buf[t - m]) if t - m >= 0 else 0
                    if _isalnum(after) or _isalnum(before):
                        shift = 1
                        continue
                # in-region verified match: jump to the record end the
                # way the INVERSE loop does (textbegin = curtextend)
                if not q.delimiter_opt:
                    e2 = t + 1
                    while e2 < te and buf[e2] != 0x0A:
                        e2 += 1
                    if e2 < L and buf[e2] == 0x0A:
                        e2 += 1
                else:
                    e2 = None
                    for cb in range(t + 1, te - dl + 1):
                        if bytes(bytearray(buf[cb:cb + dl])) == q.delim:
                            e2 = cb + dl if q.outtail else cb
                            break
                    if e2 is None:
                        e2 = te + 1
                if e2 <= t:
                    e2 = t + 1
                t = e2
                if t >= L:
                    return False
                shift = int(SHIFT[buf[t]])
            else:
                shift = d1
        return False

    def _drop_phantom_tail_event(self, data, pos, N):
        """Drop the event at stream position N-1 (a match ending on
        the file's last byte, no trailing newline) when the real
        bm/monkey walk never fires it -- entry gates, skip-run
        alignment, and record jumps at textend make the dense event
        model optimistic there (sgrep_sim.walk_fires_at_end).  pos in
        stream coords (base 1), ascending."""
        q = self.q
        if q.sg_sub not in ("bm", "monkey") or not len(pos):
            return pos
        if len(data) == 1:
            # 1-byte file: the entry gate `while (text < textend)`
            # scans nothing whatever the record mode (bm sgrep.c:723)
            return pos[:0]
        if (q.delimiter_opt or q.opts.wholeline
                or int(pos[-1]) != N - 1):
            return pos
        n = N - 1
        if n <= 0 or int(np.asarray(data[n - 1:n])[0]) == 0x0A:
            return pos
        B2 = 2 * 16384
        if n < B2:
            fstart = 0
        else:
            # final scan call region (sgrep.c:325-547): continuation
            # past the last FULL read's newline trim; for exact block
            # multiples it is the EOF residue rescan [trim+1, n-1]
            nf = n // B2
            lo = (nf - 1) * B2
            seg = np.asarray(data[lo:nf * B2])
            nls = np.flatnonzero(seg == 0x0A)
            if not len(nls):
                return pos        # fallback blocks replay elsewhere
            fstart = lo + int(nls[-1]) + 1
            if fstart >= n:
                return pos[:-1]   # rescan span empty
        from . import sgrep_sim
        wb = np.concatenate([
            np.frombuffer(b"\n", dtype=np.uint8),
            np.asarray(data[fstart:n]),
            np.frombuffer(q.sg_pattern[-1:] if q.sg_pattern
                          else b"\x00", dtype=np.uint8)])
        fires = sgrep_sim.walk_fires_at_end(
            wb, 1, len(wb) - 2, q.sg_pattern, sgrep_sim._sgrep_tr(),
            q.sg_sub, bool(q.opts.wordbound))
        return pos if fires else pos[:-1]

    def _record_span(self, stream, nl, delim_ends, p, D, trims=None,
                     floor=0):
        """Record boundaries around a match ending at p (sgrep.c
        bm:775-789 for D==0, s_output:1304-1313 for D>0).

        With -d, extraction is bounded by the scan region the hit
        fell into: block k's region ends AT its trim; the EOF residue
        rescan begins one past the last trim."""
        q = self.q
        if not q.delimiter_opt:
            back_from = p - 1 if D == 0 else p
            i = int(np.searchsorted(nl, back_from, side="right")) - 1
            begin = int(nl[i]) + 1 if i >= 0 else 0
            jdx = int(np.searchsorted(nl, p + 1, side="left"))
            end = int(nl[jdx]) + 1 if jdx < len(nl) else len(stream) + 1
            return begin, end
        # -d: nearest delimiter before/after (delim.c semantics).
        # Each block's scan region is (trims[k-1], trims[k]] with
        # trims[k] the block's trimmed last byte (one before the begin
        # of its last delimiter occurrence; its END with -t).  Inside
        # a block, forward_delimiter's range is [text+1, textend) with
        # textend AT the last byte (delim.c:64 `curbegin+len <= end`),
        # so a delimiter overlapping the trim -- e.g. the later
        # occurrences of a newline RUN under paragraph mode -- is NOT
        # found and the record runs to textend+1, absorbing the run's
        # leading bytes.  backward_delimiter's floor is the block's
        # textbegin (= one past the previous trim, the residue start).
        dl = len(q.delim)
        lo = 0
        hi = len(stream) - 1
        end_nf = len(stream) + 1
        strict_hi = False
        if trims:
            ki = bisect.bisect_left(trims, p)
            if ki < len(trims):          # block-phase hit
                hi = trims[ki]
                end_nf = trims[ki] + 1
                strict_hi = True
                if ki > 0:
                    lo = trims[ki - 1] + 1
            else:                        # EOF residue rescan
                lo = trims[-1] + 1
        lo = max(lo, floor)
        i = int(np.searchsorted(delim_ends, p, side="left")) - 1
        begin = lo
        while i >= 0:
            dstart = int(delim_ends[i]) - dl + 1
            if dstart >= lo:
                begin = dstart + dl if q.outtail else dstart
                break
            i -= 1
        jdx = int(np.searchsorted(delim_ends, p + 1 + dl - 1, side="left"))
        end = end_nf
        while jdx < len(delim_ends):
            dend = int(delim_ends[jdx])
            if dend <= (hi - 1 if strict_hi else hi):
                dstart = dend - dl + 1
                end = dstart + dl if q.outtail else dstart
                break
            jdx += 1
        return begin, end


def commit_stale_path(engine, path: str) -> None:
    """Advance an mgrep engine's reused-buffer stale model past a file
    this process did NOT scan (multihost partition): only the last two
    block windows of bytes matter, read via seek."""
    BLK2 = 2 * 16384
    try:
        n = os.path.getsize(path)
        if n == 0:
            return
        with open(path, "rb") as f:
            f.seek(max(0, n - 2 * BLK2))
            tail = np.frombuffer(f.read(), dtype=np.uint8)
        r = n % BLK2
        if r == 0:
            r = BLK2
        st = engine._stale
        st[:r] = tail[len(tail) - r:]
        if n > BLK2:
            st[r:BLK2] = tail[len(tail) - BLK2:len(tail) - r]
    except (OSError, IOError, AttributeError):
        pass


def _limits_reached(o: Options, sink: Sink) -> bool:
    if o.limit_output > 0 and sink.num_matched >= o.limit_output:
        return True
    if o.limit_per_file > 0 and \
            (sink.num_matched - sink.prev_num_matched) >= o.limit_per_file:
        return True
    return False


class Executor:
    """exec() equivalent: drives engines over files/buffers and emits
    per-file count lines, -G dumps, limits and the best-match loop."""

    def __init__(self, q, sink: Sink):
        self.q = q
        self.sink = sink
        if q.engine_class == "sgrep":
            self.engine = SgrepEngine(q)
        elif q.engine_class == "bitap":
            self.engine = BitapEngine(q)
        elif q.engine_class == "mgrep":
            from .mgrep import MgrepEngine
            self.engine = MgrepEngine(q)
        elif q.engine_class == "regex":
            from .regex_engine import RegexEngine
            self.engine = RegexEngine(q)
        else:
            raise NotImplementedError(q.engine_class)

    def run_files(self, files: list[str], _mh: dict | None = None) -> int:
        q, o, sink = self.q, self.q.opts, self.sink
        if (_mh is None and not getattr(self, "_mh_active", False)
                and multihost.requested()):
            return self._run_files_multihost(files)
        # under a multi-process run this process scans only its
        # assigned files, but all GLOBAL formatting state (FNAME,
        # file numbering, the clamp simulator's heap alignment) is
        # derived from the full file list
        all_files = _mh["global_files"] if _mh else files
        if q.engine_class == "bitap":
            # the clamp simulator's strncpy garble depends on the
            # reference buffer's heap placement, a function of the
            # invocation's pattern/delimiter/file-name lengths
            d_arg = o.delimiter
            q.sim_align = oracle_buf_align(
                q.pattern,
                len(d_arg) if d_arg is not None else None,
                [len(os.fsencode(f)) for f in all_files])
        # order matters (agrep.c:3217-3219): Numfiles>1 sets FNAME,
        # NOFILENAME clears it, ALWAYSFILENAME sets it LAST -- so -A
        # overrides -h
        sink.fname = len(all_files) > 1
        if o.no_filename:
            sink.fname = False
        if o.always_filename:
            sink.fname = True
        stats = trace.ENABLED
        t0 = _time.perf_counter() if stats else 0.0
        bytes_scanned = 0
        nomatch = True
        prof = trace.profiled()
        prof.__enter__()
        stream_min = int(os.environ.get("AGREP_TORCH_STREAM_MB",
                                        "8")) << 20
        if _mh:
            # entry state "some earlier file already printed": the
            # globally-first record's FIRSTOUTPUT byte games are
            # re-applied at the host merge (multihost.merge fix-up)
            sink.first_output = False
        mh_last_gi = -1
        for i, path in enumerate(files):
            gi = _mh["indices"][i] if _mh else i
            if _mh:
                _mh["boundary"](gi)
                if hasattr(self.engine, "_commit_stale"):
                    # the reference scans ALL files through one reused
                    # buffer: replay the skipped files' tails so this
                    # process's stale model matches the global sequence
                    for gj in range(mh_last_gi + 1, gi):
                        commit_stale_path(self.engine, all_files[gj])
                elif hasattr(self.engine, "_sg_note_file"):
                    for gj in range(mh_last_gi + 1, gi):
                        self.engine._sg_note_file(path=all_files[gj])
                mh_last_gi = gi
            sink.prev_num_matched = sink.num_matched
            sink.current_filename = (str(gi) if o.printfilenumber
                                     else path)
            sink.new_file = True
            # -l early-exit gate: only the run's last file may stop
            # scanning at the first match (no later file consults the
            # reused-buffer stale model); multihost stays conservative
            self.engine._sg_more_files = bool(_mh) or i < len(files) - 1
            try:
                size = os.path.getsize(path)
                if size > (4 << 20):
                    # read-only memmap: pages come straight from the
                    # page cache instead of first-touch-faulting a
                    # fresh anonymous copy (fromfile); above stream_min
                    # the chunked engines additionally walk it in
                    # O(chunk) resident memory
                    data = open_bytes(path)
                else:
                    data = np.fromfile(path, dtype=np.uint8)
            except (OSError, IOError):
                print("agrep: can't open file for reading: %s" % path,
                      file=sys.stderr)
                continue
            bytes_scanned += len(data)
            _ = getattr(self.engine, "total_line", 0)  # (cumulative)
            with trace.span("scan"):
                if len(data) == 0:
                    pass        # fill_buf returns 0: engines never run
                else:
                    self._scan_with_requeue(data, sink, size,
                                            stream_min)
                    if hasattr(self.engine, "_sg_note_file"):
                        # this file's bytes now sit in the reference's
                        # reused scan buffer (consulted lazily by the
                        # next file's replay paths); note the PATH so
                        # a many-file run doesn't pin every array
                        self.engine._sg_note_file(path=path, sink=sink)
            nfile = sink.num_matched - sink.prev_num_matched
            if _mh is not None and "file_counts" in _mh:
                _mh["file_counts"].append(
                    (gi, nfile, getattr(self.engine, "total_line", 0)))
            if nfile > 0:
                nomatch = False
                sink.files_matched += 1
            if o.count and not o.fileout:
                emit = True
                if o.invert and q.engine_class == "mgrep":
                    if _mh is not None and _mh.get("mg_inv_defer"):
                        # partitioned: this process's total_line lacks
                        # the other processes' files -- the cumulative
                        # count lines are formatted at the merge
                        emit = False
                    else:
                        # INVERSE multi-pattern counts LINES not
                        # matched: total_line - (num_of_matched -
                        # prev) -- total_line is the GLOBAL
                        # accumulator, never reset between files
                        # (agrep.c:3445-3486, newmgrep.c:518,694)
                        nfile = (getattr(self.engine, "total_line", 0)
                                 - nfile)
                if emit:
                    self._emit_count_line(nfile)
            if o.fileout and nfile:
                self._file_out(path)
            sink.vs_flush()           # fflush per file (agrep.c:3570)
            if (o.limit_output > 0 and sink.num_matched >= o.limit_output) \
                    or (o.limit_total_file > 0
                        and sink.files_matched >= o.limit_total_file):
                break
        prof.__exit__(None, None, None)
        if stats:
            # the reference's implicit cost model made explicit
            # (SURVEY.md section 5, tracing): AGREP_TORCH_STATS=1
            dt = _time.perf_counter() - t0
            from ..ops import chain_kernel, kernels, qgram_kernel
            from ..ops import renfa_kernel
            # kernel launches of this process so far
            launched = {**kernels.launches, **renfa_kernel.launches,
                        **chain_kernel.launches, **qgram_kernel.launches}
            print("agrep-tpu stats: rank=%d/%d engine=%s files=%d bytes=%d "
                  "matches=%d wall=%.3fs (%.1f MB/s) backend=%s "
                  "launches=%s"
                  % (multihost.process_index(), multihost.process_count(),
                     q.engine_class, len(files), bytes_scanned,
                     sink.num_matched, dt,
                     bytes_scanned / max(dt, 1e-9) / 1e6,
                     scan_ops._BACKEND,
                     ",".join("%s:%d" % kv for kv in launched.items())),
                  file=sys.stderr)
            trace.report()

        if _mh:
            # no finish(): the EATFIRST trailing newline belongs to the
            # merged stream (applied by the primary after the gather)
            return sink.num_matched
        if nomatch and o.bestmatch:
            self._best_match(files)
        sink.finish()
        return sink.num_matched

    def _run_files_multihost(self, files: list[str]) -> int:
        """Partitioned execution under torch.distributed (SURVEY.md
        section 5 'distributed communication backend').

        Each process scans files[i] with i % nproc == process_index,
        rendering output into per-file buffers; the buffers are
        all-gathered and re-assembled in GLOBAL file order (the
        reference's single-process ordering, agrep.c:3229-3231), the
        match count is summed across processes (exit-code contract,
        main.c:89-96), and only process 0 writes the merged stream.
        Round 5 partitions two previously-serial modes: global -L
        limits run limit-free in parallel, then the merge walks the
        gathered per-file counts in global order, keeps whole files
        before the cutoff and re-runs the straddling file with the
        remaining quota on its owner; mgrep -v count lines (cumulative
        total_line, agrep.c:3445-3486) defer formatting to the merge,
        which replays the per-file line totals in global order.  Only
        -B (interactive rescans) and -r stay on process 0.  A failed
        initialisation raises: no rank falls back to searching every
        file alone."""
        pid, nproc = multihost.init_multihost()
        q, o = self.q, self.q.opts
        mg_inv_count = (o.invert and q.engine_class == "mgrep"
                        and o.count)
        limits_g = o.limit_output > 0 or o.limit_total_file > 0
        serial = (o.bestmatch or o.recursive
                  or (limits_g and o.fileout)
                  or (mg_inv_count and (o.fileout or limits_g
                                        or o.limit_per_file > 0)))
        real_sink = self.sink
        if serial:
            # cross-file-coupled modes: process 0 runs the normal
            # single-process path; others only join the reduction
            self._mh_active = True
            try:
                local = self.run_files(files) if pid == 0 else 0
            finally:
                self._mh_active = False
            _, total = multihost.merge_outputs(b"", [], local)
            real_sink.num_matched = total
            return total
        buf = bytearray()
        marks: list = []
        capture = Sink(buf.extend, o)

        def boundary(gi):
            marks.append((gi, len(buf)))

        mine = multihost.assign_files(files, nproc, pid)
        file_counts: list = []
        saved_limits = (o.limit_output, o.limit_total_file)
        if limits_g:
            # pass 1 runs limit-free (per-file -L stays local); the
            # merge imposes the global cutoffs
            o.limit_output = 0
            o.limit_total_file = 0
        self.sink = capture
        try:
            self.run_files([f for _, f in mine],
                           _mh={"global_files": files,
                                "indices": [i for i, _ in mine],
                                "boundary": boundary,
                                "file_counts": file_counts,
                                "mg_inv_defer": mg_inv_count})
        finally:
            self.sink = real_sink
            o.limit_output, o.limit_total_file = saved_limits
        pieces, total = multihost.gather_pieces(
            bytes(buf), marks, capture.num_matched)
        merged = b"".join(b for _, b in pieces)
        # gathered (gi, matched_delta, total_line_after) rows drive
        # both deferred count-line formatting and the limit cutoff
        rows = multihost.allgather_rows(np.asarray(
            [(gi, nf, tl) for gi, nf, tl in file_counts],
            dtype=np.int64).reshape(len(file_counts), 3))
        per_file = {int(r[0]): (int(r[1]), int(r[2])) for r in rows}
        if limits_g:
            merged, total = self._mh_apply_limits(
                files, per_file, dict(pieces), total)
        if mg_inv_count:
            merged = self._mh_format_inverse_counts(
                files, per_file, merged)
        if pid == 0:
            # FIRSTOUTPUT fix-up (agrep.c:376, output():3820-3832):
            # in record-print bitap modes the globally first printed
            # record swallows its leading newline and owes a trailing
            # one (EATFIRST) at end of search
            if (q.engine_class == "bitap" and merged
                    and not (o.count or o.silent or o.filename_only
                             or o.fileout)
                    and merged[:1] == b"\n"):
                merged = merged[1:] + b"\n"
            real_sink.write(merged)
        real_sink.num_matched = total
        return total

    def _mh_format_inverse_counts(self, files, per_file,
                                  merged: bytes) -> bytes:
        """mgrep -v -c count lines, formatted at the merge: the
        printed value is cumulative-total_line minus the file's
        matched count (agrep.c:3445-3486; total_line never resets,
        newmgrep.c:518,694).  total_line deltas are reconstructed
        from each process's own cumulative sequence."""
        q, o = self.q, self.q.opts
        nproc = multihost.process_count()
        # per-process cumulative -> per-file deltas
        deltas = {}
        last_by_proc: dict = {}
        for gi in sorted(per_file):
            owner = gi % nproc
            prev = last_by_proc.get(owner, 0)
            deltas[gi] = per_file[gi][1] - prev
            last_by_proc[owner] = per_file[gi][1]
        out = bytearray()
        sink2 = Sink(out.extend, o)
        sink2.fname = len(files) > 1
        if o.no_filename:
            sink2.fname = False
        if o.always_filename:
            sink2.fname = True
        cum = 0
        for gi in range(len(files)):
            if gi not in per_file:
                continue            # unreadable file: no count line
            nf, _tl = per_file[gi]
            cum += deltas[gi]
            sink2.current_filename = (str(gi) if o.printfilenumber
                                      else files[gi])
            sink2.new_file = True
            old_sink = self.sink
            self.sink = sink2
            try:
                self._emit_count_line(cum - nf)
            finally:
                self.sink = old_sink
        return bytes(out)

    def _mh_apply_limits(self, files, per_file, pieces, total):
        """Impose global -L cutoffs on the gathered per-file pieces:
        walk files in global order accumulating matches; whole files
        before the cutoff keep their pass-1 output, a match-straddling
        file re-runs on its owner with the remaining quota (exactly
        the bytes the reference's mid-scan stop emits), everything
        after drops (agrep.c:3571-3575)."""
        q, o = self.q, self.q.opts
        pid = multihost.process_index()
        cum = 0
        files_matched = 0
        cut_gi = None
        quota = 0
        for gi in range(len(files)):
            if gi not in per_file:
                continue
            nf = per_file[gi][0]
            if o.limit_output > 0 and cum + nf >= o.limit_output:
                cut_gi = gi
                quota = o.limit_output - cum
                break
            cum += nf
            if nf > 0:
                files_matched += 1
                if (o.limit_total_file > 0
                        and files_matched >= o.limit_total_file):
                    cut_gi = gi
                    quota = -1        # whole-file cut: keep gi as-is
                    break
        if cut_gi is None:
            return b"".join(b for _, b in sorted(pieces.items())), total
        out = bytearray()
        new_total = 0
        for gi in range(cut_gi):
            if gi in pieces:
                out.extend(pieces[gi])
                new_total += per_file.get(gi, (0, 0))[0]
        if quota < 0:
            out.extend(pieces.get(cut_gi, b""))
            new_total += per_file.get(cut_gi, (0, 0))[0]
        else:
            # the straddling file re-runs with the remaining quota on
            # its owner; the piece is broadcast through merge_outputs
            owner = cut_gi % multihost.process_count()
            blob = b""
            cnt = 0
            if pid == owner:
                b2 = bytearray()
                cap2 = Sink(b2.extend, o)
                cap2.fname = self.sink.fname
                cap2.first_output = False
                cap2.current_filename = (str(cut_gi)
                                         if o.printfilenumber
                                         else files[cut_gi])
                cap2.new_file = True
                saved = (o.limit_output, o.limit_total_file)
                o.limit_output = quota
                o.limit_total_file = 0
                old_sink = self.sink
                self.sink = cap2
                try:
                    self.run_files([files[cut_gi]],
                                   _mh={"global_files": files,
                                        "indices": [cut_gi],
                                        "boundary": lambda gi2: None})
                finally:
                    self.sink = old_sink
                    o.limit_output, o.limit_total_file = saved
                blob = bytes(b2)
                cnt = cap2.num_matched
            rblob, rcnt = multihost.merge_outputs(
                blob, [(cut_gi, 0)], cnt)
            out.extend(rblob)
            new_total += rcnt
        return bytes(out), new_total

    def _scan_with_requeue(self, data, sink, size, stream_min) -> None:
        """One file's scan with failure re-queueing (SURVEY.md section
        5: a failed shard is re-run; scans are stateless/idempotent).
        A failed scan is retried once on the same backend and device;
        a second failure propagates -- there is no switch to another
        backend.  Retrying is safe only while the file has produced NO
        output and NO counts yet: a partially-emitted file cannot be
        replayed, so those failures propagate at once."""
        q = self.q

        def scan_once():
            if (size > stream_min
                    and hasattr(self.engine, "supports_streaming")
                    and self.engine.supports_streaming()):
                self.engine.search_stream_chunked(data, sink, q.D)
            else:
                self.engine.search_stream(data, sink, q.D)

        mark_b = sink.bytes_written
        mark_n = sink.num_matched
        mark_t = getattr(self.engine, "total_line", None)
        try:
            scan_once()
            return
        except (OSError, MemoryError):
            raise
        except Exception:
            if (sink.bytes_written != mark_b
                    or sink.num_matched != mark_n):
                raise               # partial output: not replayable
        if mark_t is not None:
            self.engine.total_line = mark_t
        scan_once()                 # one retry; a second failure raises

    def run_buffer(self, data: np.ndarray) -> int:
        q, o, sink = self.q, self.q.opts, self.sink
        sink.fname = o.always_filename
        _ = getattr(self.engine, "total_line", 0)  # (cumulative)
        with trace.span("scan"):
            self.engine.search_stream(data, sink, q.D, memory_mode=True)
        # memory mode emits NO count line: exec()'s -1 branch gates it
        # on `COUNT && ret` where ret is the engine's return value --
        # 0 on success, so the line never prints (agrep.c:3365, the
        # "dirty solution for glimpse's -b" comment); the match count
        # still feeds the Grand Total / return value
        sink.finish()
        return sink.num_matched

    def _emit_count_line(self, nfile: int) -> None:
        o, sink = self.q.opts, self.sink
        if nfile <= 0 and o.nooutputzero:
            return
        if sink.fname and (sink.new_file or not o.post_filter):
            sink.write_str("%s: %d\n" % (sink.current_filename, nfile))
            sink.new_file = False
        elif not sink.fname:
            sink.write_str("%d\n" % nfile)

    def _file_out(self, path: str) -> None:
        """-G: dump the whole matching file (file_out, agrep.c:3756)."""
        sink = self.sink
        if sink.fname:
            bar = ":" * len(path)
            sink.write_str("\n%s\n%s\n%s\n" % (bar, path, bar))
        with open(path, "rb") as f:
            sink.write(f.read())

    def _best_match(self, files: list[str]) -> None:
        """-B escalation loop (agrep.c:3582-3728)."""
        import copy
        q, o, sink = self.q, self.q.opts, self.sink
        from ..compile.query import compile_query

        q2 = q
        o2 = o
        # agrep.c:3584-3588 re-runs preprocess() on the ALREADY
        # preprocessed pattern for -w/-x/-v: the first pass's internal
        # meta bytes are re-embedded as literal positions, so the
        # rescan machine can never match raw text.  Observable: -B -w
        # (and -B -x when the D=0 pass missed) always reports 0.
        corrupted = o.wordbound or o.wholeline or o.invert
        if corrupted:
            o2 = copy.deepcopy(o)
            # faithful double-preprocess: feed pass one's INTERNAL
            # byte form (meta codes + embedded delimiter wrap) back
            # through the compiler -- the re-wrap re-interprets the
            # embedded ';' as a real ANDPAT past D_length, so a flat
            # OR pattern dies in maskgen with the mixed-boolean error
            # (rc 255 + Grand Total 0), while other shapes produce a
            # meta-soup machine that CAN still match at high D
            from ..compile import pattern as pattern_mod
            from ..options import AgrepError
            rw1 = pattern_mod.rewrite(q.pattern, o)
            pat2 = rw1.pattern.decode("latin-1")
            # pass one REDUCED D_pattern to the processed delimiter
            # bytes (preproce.c:223 strcpy(D_pattern, old_D_pat)), so
            # the rescan's wrap is those bytes alone -- no "<...>; "
            o2._d_pattern_override = rw1.old_d_pat.decode("latin-1")
            try:
                # BESTMATCH is still ON during the rescan compile:
                # checksg rejects every split terminal (checksg.c:127)
                # so the meta-soup always takes the maskgen path
                q2 = compile_query(pat2, o2)
            except AgrepError as e:
                e.late = True
                e.verbose = getattr(o, "verbose", 1)
                raise
            o2.bestmatch = False
        if corrupted and o.invert:
            # The re-preprocess REDUCES D_pattern to the processed
            # delimiter bytes (preproce.c:223), and the second pass
            # leaves old_D_pat EMPTY (instrumented reference: [B]
            # old_D_pat="" with Pattern = 90 0a 90 <pat>).  With
            # D_length == 0 the rescan machine never completes a
            # delimiter, and INVERSE counting happens only at
            # delimiter completions -- the escalation can never fire
            # at any D (num_of_matched stays 0 through D=MaxError).
            sink.num_matched = 0
            return
        # The C loop (agrep.c:3594-3630) resets prev_num_of_matched per
        # FILE and checks `num - prev == 0` per D level -- so escalation
        # continues until the LAST file has a hit, the reported count is
        # the last file's count, and num_of_matched accumulates across
        # every (D, file) scan: Grand Total / exit code on 'n'/EOF is
        # that running sum, not the winning level's count.
        # D < M uses maskgen's position count for mask-machine
        # patterns (agrep.c:3594 with M from :3179) -- a regex can
        # escalate to D=5 and die on the MaxRerror check (exit 255)
        M = q.tables.m if getattr(q, "tables", None) is not None \
            else len(q.pattern)
        D = 1
        total = 0
        last = 0
        while D < M and D <= 8 and last == 0:
            counter = Sink(lambda b: None, o2)
            eng = Executor(q2_with_d(q2, D), counter)
            for path in files:
                counter.prev_num_matched = counter.num_matched
                try:
                    data = np.fromfile(path, dtype=np.uint8)
                except OSError:
                    continue
                if len(data) == 0:
                    continue           # fill_buf returns 0: no scan
                eng.engine.search_stream(data, counter, D)
            last = counter.num_matched - counter.prev_num_matched
            total += counter.num_matched
            D += 1
        D -= 1
        sink.num_matched = total
        if last == 0:
            return
        found = last
        word = "word matches" if found == 1 else "words match"
        errs = "1 error" if D == 1 else "%d errors" % D
        sys.stderr.write("agrep: %d %s within %s" % (found, word, errs)
                         if found != 1 else
                         "agrep: 1 word matches within %s" % errs)
        if o.noprompt:
            sys.stderr.write("\n")
        else:
            q_ = "; search for it? (y/n)" if found == 1 \
                else "; search for them? (y/n)"
            sys.stderr.write(q_)
            sys.stderr.flush()
            try:
                ans = input()
            except EOFError:
                return
            if not ans.startswith("y"):
                return
        # final printing pass at the winning D
        sink.num_matched = 0
        eng = Executor(q2_with_d(q2, D), sink)
        for i, path in enumerate(files):
            sink.prev_num_matched = sink.num_matched
            sink.current_filename = str(i) if o.printfilenumber else path
            sink.new_file = True
            try:
                data = np.fromfile(path, dtype=np.uint8)
            except OSError:
                continue
            if len(data) == 0:
                continue               # fill_buf returns 0: no scan
            eng.engine.search_stream(data, sink, D)


def _corrupt(ql):
    """Make a -B rescan query that never matches (the double-preprocess
    corruption, agrep.c:3584-3588): zero the per-char mask tables so no
    state bit ever advances.  Inverse/count formatting still runs."""
    if ql.folded_mask is not None:
        ql.folded_mask = np.zeros(256, dtype=np.uint32)
    if ql.sg_mask is not None:
        ql.sg_mask = np.zeros(256, dtype=np.uint32)
    return ql


def q2_with_d(q, D: int):
    """Recompile a query for a different error budget (used by -B).

    BESTMATCH stays on: checksg kept SGREP off for the original compile
    (checksg.c:127), so the -B rescans run on the mask machine, never
    the simple fast path (agrep.c:3607-3608 uses the stale SGREP)."""
    import copy
    from ..compile.query import compile_query
    o = copy.deepcopy(q.opts)
    o.D = D
    o.approx = False
    o._bestmatch_rescan = True
    return compile_query(q.pattern, o)
