"""Public library API.

Mirrors the reference's embeddable two-phase interface
(agrep.c:3017-3313: memagrep_init/search, fileagrep_init/search) with a
pythonic Query object on top.
"""

from __future__ import annotations

import io
import sys

import numpy as np

from .compile.query import CompiledQuery, compile_query
from .ops import scan as scan_ops
from .options import AgrepError, Options, compat_check, parse_args
from .runtime.engine import Executor
from .runtime.output import (OutputOverflow, Sink, make_buffer_sink,
                             make_stream_sink)


class Query:
    """A compiled search: pattern + options, reusable across inputs.

    The reference caches pattern compilation across calls
    (agrep_saved_pattern, agrep.c:3063-3087); here the compiled query
    object simply persists.
    """

    def __init__(self, pattern: str | None = None,
                 argv: list[str] | None = None, **kwargs):
        # the default torch backend scans on the GPU: with no card the
        # query raises here, before any output, instead of running on
        # the CPU
        scan_ops.require_device()
        if argv is not None:
            self.opts, self.pattern, self.files = parse_args(argv)
            # the reference is byte-oriented: recover each pattern-ish
            # argument's RAW argv bytes (Python decoded them as UTF-8)
            # and re-view them as latin-1, the str<->byte identity this
            # pipeline uses throughout
            import os as _os

            def _raw(s):
                return (_os.fsencode(s).decode("latin-1")
                        if s is not None else None)

            self.pattern = _raw(self.pattern)
            self.opts.delimiter = _raw(self.opts.delimiter)
            self.opts.pat_buffer = _raw(self.opts.pat_buffer)
        else:
            self.opts = Options(**kwargs)
            self.pattern = pattern
            self.files = []
        # the pattern-file error trailer names the first input file
        # (agrep.c:2858 prints post-parse argv[0])
        if self.files:
            self.opts.pat_errfile_hint = self.files[0]
        # checksg/preprocess/maskgen run BEFORE exec's compat() in the
        # reference (agrep.c:3169-3226 vs :3342): engine selection sees
        # the PRE-compat flags (-c -n still counts as LINENUM for the
        # fast-path bar; -c -B still bars it), while output honors the
        # post-compat mutations.
        from .runtime import trace
        with trace.stage("compile"):
            self.compiled: CompiledQuery = compile_query(self.pattern,
                                                         self.opts)
        compat_check(self.opts, self.opts.pat_file is not None
                     or self.opts.pat_buffer is not None)
        self._verbose_info()

    def _verbose_info(self) -> None:
        """The -V2/-V3 INFO lines (agrep.c:2762-2792), printed to
        stdout before scanning."""
        import os
        from .codepage import resolve_codepage
        o = self.opts
        if o.verbose > 3:
            # codepage resolution warning (agrep.c:2746-2754): on a
            # POSIX build get_current_codepage() is absent, so with no
            # -CP the detected number is always -1
            from .codepage import _TABLES
            j = o.codepage if o.codepage is not None else -1
            if j not in _TABLES:
                print("AGREP -- WARNING: The codepage (%d) is wrong "
                      "or could not be detected." % j)
        if o.verbose > 2:
            opts_env = os.environ.get("AGREPOPTS")
            if opts_env is not None:
                print("AGREP -- INFO: using default options %s" % opts_env)
            print("AGREP -- INFO: using codepage %d"
                  % resolve_codepage(o.codepage))
        if o.verbose > 1:
            msgs = {
                "a": "AGREP -- INFO: mapping all ISO characters to ASCII",
                "#": ("AGREP -- INFO: mapping letters to letters, digits "
                      "to digits, others to others"),
                "i": ("AGREP -- INFO: mapping all upper ISO characters "
                      "to lower ISO"),
            }
            print(msgs.get(o.nocase,
                           "AGREP -- INFO: case sensitive search"))
        if o.verbose > 4:
            self._lut_dump()

    def _lut_dump(self) -> None:
        """-V5 translation-table dump (agrep.c:2794-2818): 256 lines
        showing every byte's -i/-ia/-i# folds from the CP table;
        control bytes render as '.'."""
        from .codepage import _TABLES, resolve_codepage
        table = _TABLES[resolve_codepage(self.opts.codepage)]
        out = sys.stdout.buffer
        out.write(b"AGREP -- INFO: translation look-up tables for "
                  b"-i, -ia and -i# options:\n")
        for i in range(256):
            l1, l2, l3, meta = table[i]
            metatxt = (b" metasymbol; not searchable" if meta > 0
                       else b"")
            if i < 32:
                cells = [b"."] * 4
            else:
                cells = [bytes([v]) for v in (i, l1, l2, l3)]
            out.write(b"-i0: %s (%03d %02Xh) => -i: %s (%03d %02Xh)"
                      b"  -ia: %s (%03d %02Xh)  -i#: %s (%03d %02Xh)"
                      b" %s\n"
                      % (cells[0], i, i, cells[1], l1, l1,
                         cells[2], l2, l2, cells[3], l3, l3, metatxt))
        out.flush()

    def search_files(self, files: list[str], output=None) -> int:
        """Search files; returns total number of matched records."""
        sink = make_stream_sink(self.opts, output)
        ex = Executor(self.compiled, sink)
        return ex.run_files(files)

    def search_buffer(self, data: bytes, output=None) -> int:
        """Search an in-memory buffer (memagrep semantics: the buffer
        should start with a newline)."""
        sink = make_stream_sink(self.opts, output)
        ex = Executor(self.compiled, sink)
        arr = np.frombuffer(data, dtype=np.uint8)
        return ex.run_buffer(arr)


def fileagrep(argv: list[str], output=None, verbose_total=True) -> int:
    """CLI-equivalent entry: parse argv (without argv[0]), search files,
    print the Grand Total, return the match count (= exit code)."""
    import os
    try:
        q = Query(argv=argv)
    except AgrepError as e:
        # exec()-stage conflicts still print the Grand Total line
        # before the -1 return (agrep.c:3229) -- same as memagrep.
        # Early (usage/version) errors keep propagating to the caller.
        if not getattr(e, "late", False):
            raise
        msg = str(e)
        if msg:
            print(msg, file=sys.stderr)
        if getattr(e, "verbose", 1) > 0 and verbose_total:
            out = output if output is not None else sys.stdout.buffer
            out.write(b"Grand Total: 0 match(es) found.\n")
        return -1
    if not q.files:
        # agrep.c:2928 + fileagrep:3310: no files -> error return -1
        print("agrep: no target files found.", file=sys.stderr)
        return -1
    kept = []
    for f in q.files:
        if os.path.exists(f) or q.opts.recursive:
            kept.append(f)
        else:
            # check_file vetting (agrep.c:2952-2957)
            print("agrep: '%s' no such file or directory" % f,
                  file=sys.stderr)
    q.files = kept
    if not kept:
        return -1
    if q.opts.recursive:
        from .runtime.walker import run_recursive
        ret = run_recursive(q, q.files, output)
    else:
        ret = q.search_files(q.files, output)
    if q.opts.verbose > 0 and verbose_total:
        if is_primary():
            out = output if output is not None else sys.stdout.buffer
            out.write(b"Grand Total: %d match(es) found.\n" % ret)
    return ret


def is_primary() -> bool:
    """True on the output-owning process: always single-process, and
    rank 0 when torch.distributed is initialized -- gates the Grand
    Total line."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def memagrep(argv: list[str], data: bytes, output=None) -> int:
    try:
        q = Query(argv=argv)
    except AgrepError as e:
        # exec()-stage conflicts (compat.c): the library prints the
        # message to stderr and STILL emits the Grand Total line
        # before the -1 return (agrep.c:3229) -- same as the CLI
        msg = str(e)
        if msg:
            print(msg, file=sys.stderr)
        if getattr(e, "late", False) and getattr(e, "verbose", 1) > 0:
            out = output if output is not None else sys.stdout.buffer
            out.write(b"Grand Total: 0 match(es) found.\n")
        return -1
    ret = q.search_buffer(data, output)
    if q.opts.verbose > 0:
        out = output if output is not None else sys.stdout.buffer
        out.write(b"Grand Total: %d match(es) found.\n" % ret)
    return ret


def search_files(pattern: str, files: list[str], **kwargs) -> int:
    return Query(pattern, **kwargs).search_files(files)


def search_buffer(pattern: str, data: bytes, **kwargs) -> int:
    return Query(pattern, **kwargs).search_buffer(data)
