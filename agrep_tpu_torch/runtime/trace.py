"""Tracing/profiling subsystem (SURVEY.md section 5): the port's one span
recorder, its counters and its profiler hook.

The reference had compile-time-only instrumentation (MEASURE_TIMES
gettimeofday wraps, sgrep.c:348-360; the perf_check shift/hash counters,
newmgrep.c:158-160).  This makes that implicit cost model explicit and
runtime-switchable:

  AGREP_TORCH_STATS=1   one summary line to stderr after a run
  AGREP_TORCH_STATS=2   summary + per-name span timers + counters
  AGREP_TORCH_PROFILE=<dir>  wrap the run in torch.profiler and write
                             a Chrome trace to <dir>/trace.json; every
                             span also opens a record_function of its
                             name, above the kernels and copies

The environment sets the level at import; enable(level) sets it later.
Spans are recorded at level 1 or 2, and wherever AGREP_TORCH_PROFILE is
set; else tracing is off.

Spans.  span(name, n_bytes) is a context manager; on exit it appends
(search_id, span_id, parent_id, name, t0, t1, n_bytes) to an in-memory
list, t0 and t1 from time.perf_counter().  The parent is the innermost
span open on the same thread (None for a root), and search_id the id of
the root span it lies under (its own for a root).  A span opened inside
another of the same name is not recorded: only the outermost counts.
take_spans() returns the records and clears them.  timers[name] is the
sum of the recorded spans of that name.  With tracing off, span() returns
one shared object that does nothing.

The spans, from the entry down (PERF.md section 3 names the metric each
feeds):
  search       the root: api.Query.search_buffer / search_files
  compile      api.Query.__init__'s compile_query
  scan         Executor.run_files (a file) and Executor.run_buffer
  device_layer the outermost device-layer call of each engine: the bitap
               engine's per-chunk records and pairs (ops/scan.py) and
               sticky lanes, the regex engine's _stream_rows and
               per-window work, the mgrep engine's chain and q-gram
               passes and the streamed boolean's per-chunk call
  upload       a host-to-card copy (n_bytes): the text, the machine and
               term tables (ops/kernels.py to_device)
  launch       the enqueue of one CUDA kernel (the C call)
  readback     a read that waits for the card (n_bytes): a count, a
               summary, the rows (ops/kernels.py read, to_host)
  walk         the record walk and print on the host

Counters are plain module-level ints, moved only with tracing on.  The
device stages of the torch backend count what crosses from the card: the
bitap engine's record_pairs (pairs cut) and record_rows (rows read back,
ops/scan.py) and, for its sticky machines, lane_records (records cut on
the card) and lane_rows (rows read back, ops/scan.py), the regex engine's
regex_lines (lines indexed on the card) and regex_rows (rows read back,
runtime/regex_engine.py), and the mgrep engine's chain_scans,
qgram_lines and qgram_line_rows (launches, rows read back),
stream_print_chunks (chunks of a streamed -f print), bool_stream_chunks,
line_terms and line_terms_rows (the streamed boolean's chunks, launches
and rows, runtime/mgrep.py) and qgram_candidates (compile/multi.py).
The sink counts records_printed (records the walks print whole) and
bytes_printed (every byte it writes, runtime/output.py).
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from contextlib import contextmanager

_level = os.environ.get("AGREP_TORCH_STATS", "")
ENABLED = _level not in ("", "0")
DETAILED = _level not in ("", "0", "1")
PROFILE_DIR = os.environ.get("AGREP_TORCH_PROFILE") or None

counters: dict[str, int] = {}
timers: dict[str, float] = {}

# Records kept until take_spans() at most: a caller that never drains
# stops recording there (the timers still sum).
MAX_SPANS = 1 << 20

_spans: list = []
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()        # the records and the timers


def enable(level: int) -> None:
    """Set the level as AGREP_TORCH_STATS does: 0 off, 1 the summary
    line and the spans, 2 the timers and counters too."""
    global ENABLED, DETAILED
    ENABLED = level >= 1
    DETAILED = level >= 2


def add(name: str, n: int = 1) -> None:
    counters[name] = counters.get(name, 0) + n


class _Off:
    """The span of tracing off: enters and exits, records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "n_bytes", "stack", "sid", "search_id",
                 "parent", "t0", "rf")

    def __init__(self, name: str, n_bytes: int, stack: list):
        self.name = name
        self.n_bytes = n_bytes
        self.stack = stack

    def __enter__(self):
        stack = self.stack
        self.sid = next(_ids)
        if stack:
            self.parent = stack[-1].sid
            self.search_id = stack[0].sid
        else:
            self.parent = None
            self.search_id = self.sid
        stack.append(self)
        self.rf = None
        if PROFILE_DIR:
            from torch.profiler import record_function
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        stack = self.stack
        if stack[-1] is self:
            stack.pop()
        else:                 # closed out of order (a suspended generator)
            stack.remove(self)
        name = self.name
        with _lock:
            timers[name] = timers.get(name, 0.0) + t1 - self.t0
            if len(_spans) < MAX_SPANS:
                _spans.append((self.search_id, self.sid, self.parent, name,
                               self.t0, t1, self.n_bytes))
        return False


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def span(name: str, n_bytes: int = 0):
    """A span of the work inside the with block (module docstring); the
    shared do-nothing object where tracing is off or a span of the same
    name is already open on this thread."""
    if not ENABLED and not PROFILE_DIR:
        return _OFF
    stack = _stack()
    for s in stack:
        if s.name == name:
            return _OFF
    return _Span(name, n_bytes, stack)


def search():
    """The root span of one search, with a fresh id."""
    return span("search")


def take_spans() -> list:
    """The recorded spans, oldest first; they are cleared."""
    with _lock:
        out = _spans[:]
        _spans.clear()
    return out


@contextmanager
def profiled():
    """torch.profiler wrapper gated on AGREP_TORCH_PROFILE: CPU and
    CUDA activity, exported as a Chrome trace into the directory."""
    if not PROFILE_DIR:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(PROFILE_DIR, exist_ok=True)
    prof.export_chrome_trace(os.path.join(PROFILE_DIR, "trace.json"))


def report(prefix: str = "agrep-tpu stats") -> None:
    """Emit the accumulated counters/timers to stderr (level 2)."""
    if not DETAILED:
        return
    parts = []
    for k in sorted(timers):
        parts.append("%s=%.3fs" % (k, timers[k]))
    for k in sorted(counters):
        parts.append("%s=%d" % (k, counters[k]))
    if parts:
        print("%s: %s" % (prefix, " ".join(parts)), file=sys.stderr)


def reset() -> None:
    counters.clear()
    timers.clear()
    take_spans()
