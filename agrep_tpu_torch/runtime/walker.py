"""-r recursive directory walk (reference recursiv.c:106-255).

lstat-based DFS that skips symlinks and batches files 10 at a time into
the executor (max_list, recursiv.c:75) -- the batching is observable:
the FNAME header logic sees at most 10 files per exec() call.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .engine import Executor
from .output import make_stream_sink

MAX_LIST = 10


def run_recursive(query, names: list[str], output=None) -> int:
    sink = make_stream_sink(query.opts, output)
    ex = Executor(query.compiled, sink)
    batch: list[str] = []

    def flush():
        if batch:
            _run_batch(query, ex, sink, batch)
            batch.clear()

    def treewalk(name: str):
        try:
            st = os.lstat(name)
        except OSError:
            print("agrep: permission denied or no such file: %s" % name,
                  file=sys.stderr)
            return
        if os.path.islink(name):
            return
        if os.path.isdir(name):
            # readdir order, NOT sorted (recursiv.c:214-255 uses the
            # raw directory stream; the output order is observable)
            try:
                entries = [e.name for e in os.scandir(name)]
            except OSError:
                return
            for e in entries:
                if e in (".", ".."):
                    continue
                treewalk(os.path.join(name, e))
        else:
            batch.append(name)
            if len(batch) >= MAX_LIST:
                flush()

    for n in names:
        if os.path.isdir(n):
            treewalk(n)
        else:
            batch.append(n)
            if len(batch) >= MAX_LIST:
                flush()
    flush()
    sink.finish()
    return sink.num_matched


def _run_batch(query, ex: Executor, sink, files: list[str]) -> None:
    o = query.opts
    sink.fname = (len(files) > 1 and not o.no_filename) or o.always_filename
    for i, path in enumerate(files):
        sink.prev_num_matched = sink.num_matched
        sink.current_filename = str(i) if o.printfilenumber else path
        sink.new_file = True
        try:
            data = np.fromfile(path, dtype=np.uint8)
        except OSError:
            print("agrep: can't open file for reading: %s" % path,
                  file=sys.stderr)
            continue
        ex.engine.search_stream(data, sink, query.compiled.D)
        nfile = sink.num_matched - sink.prev_num_matched
        if nfile > 0:
            sink.files_matched += 1
        if o.count and not o.fileout:
            ex._emit_count_line(nfile)
