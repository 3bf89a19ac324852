"""Output sinks and the byte-exact record formatters.

Two sinks mirror the reference's dual-path output (FILE* vs bounded
caller buffer with OUTPUT_OVERFLOW, agrep.h:130): StreamSink writes to
a binary file object, BufferSink fills a bytearray and raises
OutputOverflow when full.
"""

from __future__ import annotations

import sys

from . import trace


class OutputOverflow(Exception):
    pass


class Sink:
    """Search-wide output state (mirrors the reference globals that the
    output layer consults: FIRSTOUTPUT, EATFIRST, FNAME, NEW_FILE...)."""

    def __init__(self, write_bytes, opts, limit=None):
        self._write = write_bytes
        self.opts = opts
        self.first_output = True      # FIRSTOUTPUT (agrep.c:376)
        self.eat_first = False        # EATFIRST
        self.num_matched = 0
        self.prev_num_matched = 0
        self.files_matched = 0
        self.fname = False            # FNAME: print "file: " prefixes
        self.new_file = False         # NEW_FILE (POST_FILTER bookkeeping)
        self.current_filename = ""
        self.truncate = False
        self.bytes_written = 0        # high-water mark (file requeue)
        # virtual image of the reference's stdout stdio buffer: the
        # negative-length s_output fwrite (sgrep.c:1355, curtextbegin
        # below lastout) makes glibc memcpy `buf_end - write_ptr`
        # bytes from the wild pointer into this buffer before the
        # direct write EFAULTs -- what it emits depends on whether the
        # buffer exists yet (any prior output), its fill level, and
        # its CONTENT (the wild source window overlaps it in the
        # heap).  Model glibc _IO_file_xsputn over every byte we emit.
        self._vs_alloc = False
        self._vs_pos = 0
        self._vs_img = bytearray(4096)

    def _vs_feed(self, b: bytes) -> None:
        if not b:
            return
        self._vs_alloc = True
        L = len(b)
        take = min(L, 4096 - self._vs_pos)
        if take:
            self._vs_img[self._vs_pos:self._vs_pos + take] = b[:take]
            self._vs_pos += take
        rest = L - take
        if rest > 0:
            # overflow: flush, then whole blocks bypass the buffer,
            # the remainder lands at its base (glibc fileops.c xsputn)
            self._vs_pos = 0
            r = rest % 4096
            if r:
                self._vs_img[0:r] = b[L - r:]
                self._vs_pos = r

    def vs_flush(self) -> None:
        """The reference fflushes after every file (agrep.c:3570):
        write_ptr returns to base, the content lingers."""
        self._vs_pos = 0

    def write(self, data: bytes):
        self.bytes_written += len(data)
        if trace.ENABLED:
            trace.add("bytes_printed", len(data))
        self._vs_feed(data)
        self._write(data)

    def write_str(self, s: str):
        self.write(s.encode("latin-1"))

    def write_record(self, data: bytes, n: int = 1):
        """write() of the bytes of n whole records that a walk prints
        (counted in the trace counter records_printed)."""
        if trace.ENABLED:
            trace.add("records_printed", n)
        self.write(data)

    # -- shared decoration helpers ------------------------------------

    def emit_fname_prefix(self) -> bool:
        """The "file: " prefix (output():3845-3875)."""
        o = self.opts
        if self.fname and (self.new_file or not o.post_filter):
            nextchar = "\n" if o.post_filter else " "
            prev = "\n" if o.post_filter else ""
            self.write_str("%s%s:%c" % (prev, self.current_filename, nextchar))
            self.new_file = False
            return True
        return False

    def finish(self):
        """End-of-search EATFIRST newline (exec() CONT:3731-3741)."""
        if self.eat_first:
            self.write_str("\n")
            self.eat_first = False


def make_stream_sink(opts, fileobj=None) -> Sink:
    f = fileobj if fileobj is not None else sys.stdout.buffer
    def w(data):
        f.write(data)
    return Sink(w, opts)


def make_buffer_sink(opts, out: bytearray, limit: int) -> Sink:
    def w(data):
        if len(out) + len(data) >= limit:
            room = max(0, limit - len(out) - 1)
            out.extend(data[:room])
            print("Output buffer overflow after %d bytes !!" % len(out),
                  file=sys.stderr)
            raise OutputOverflow()
        out.extend(data)
    return Sink(w, opts)


def output_bitap_record(sink: Sink, buffer, i1: int, i2: int, j: int,
                        byte_offset: int, d_length: int,
                        delimiter_opt: bool, d_pattern: bytes,
                        outtail: bool) -> None:
    """The mask-machine record printer (agrep.c output():3805-3956).

    buffer: the scanned stream (numpy uint8 or bytes); i1/i2: inclusive
    record span (lasti, print_end); j: record counter at the event;
    byte_offset: reference CurrentByteOffset at output time.
    """
    o = sink.opts
    if i1 > i2:
        return
    sink.num_matched += 1
    if o.count:
        return
    if o.silent:
        return
    if outtail or (not delimiter_opt and d_length == 1
                   and d_pattern[:1] == b"\n"):
        if j > 1:
            i1 += d_length
        i2 += d_length
    if delimiter_opt:
        j += 1
    if sink.first_output:
        if buffer[i1] == 0x0A:
            i1 += 1
            sink.eat_first = True
        sink.first_output = False
    if sink.truncate:
        print("WARNING!  some lines have been truncated in output record "
              "#%d" % (sink.num_matched - 1), file=sys.stderr)
        sink.truncate = False
    while i1 <= i2 and buffer[i1] == 0x0A:
        sink.write_str("\n")
        i1 += 1
    printed = sink.emit_fname_prefix()
    if o.linenum:
        sink.write_str("%d: " % (j - 1))
        printed = True
    if o.bytecount:
        sink.write_str("%d= " % (byte_offset - 1))
        printed = True
    if o.printoffset:
        sink.write_str("@%d{%d}\n" % (byte_offset - (i2 - i1), i2 - i1))
        printed = True
    if o.printrecord:
        sink.write_record(bytes(bytearray(buffer[i1:i2 + 1])))
    elif printed:
        sink.write_str("\n")


def output_sgrep_record(sink: Sink, buffer, begin: int, end: int,
                        byte_offset: int, match_end: int,
                        extra_len: int = 0) -> None:
    """The simple-path record printer (sgrep.c bm:815-932 / s_output).

    begin/end: record span [begin, end) in stream coordinates;
    byte_offset: CurrentByteOffset at the match (file coords);
    match_end: stream position of the match's last char (for -q);
    extra_len: artificial bytes appended to the record (bm's EOF
    newline is inside [curtextbegin, curtextend) and counts in -q's
    {length}).
    """
    o = sink.opts
    if o.silent:
        return
    printed = sink.emit_fname_prefix()
    if o.bytecount:
        sink.write_str("%d= " % byte_offset)
        printed = True
    if o.printoffset:
        sink.write_str("@%d{%d} " % (byte_offset - (match_end - begin),
                                     end - begin + extra_len))
        printed = True
    if o.printrecord:
        sink.write_record(bytes(bytearray(buffer[begin:end])))
    elif printed:
        sink.write_str("\n")
