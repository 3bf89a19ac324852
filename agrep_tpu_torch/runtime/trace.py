"""Tracing/profiling subsystem (SURVEY.md section 5).

The reference had compile-time-only instrumentation (MEASURE_TIMES
gettimeofday wraps, sgrep.c:348-360; the perf_check shift/hash counters,
newmgrep.c:158-160).  This makes that implicit cost model explicit and
runtime-switchable:

  AGREP_TORCH_STATS=1   one summary line to stderr after a run
  AGREP_TORCH_STATS=2   summary + per-stage timers + counters
  AGREP_TORCH_PROFILE=<dir>  wrap the run in torch.profiler and write
                             a Chrome trace to <dir>/trace.json

Counters are plain module-level ints -- zero overhead when disabled
(every instrumentation site checks the ENABLED flag first).
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager

_level = os.environ.get("AGREP_TORCH_STATS", "")
ENABLED = _level not in ("", "0")
DETAILED = _level not in ("", "0", "1")
PROFILE_DIR = os.environ.get("AGREP_TORCH_PROFILE") or None

counters: dict[str, int] = {}
timers: dict[str, float] = {}


def add(name: str, n: int = 1) -> None:
    counters[name] = counters.get(name, 0) + n


@contextmanager
def stage(name: str):
    """Accumulating per-stage wall timer; no-op when stats are off."""
    if not ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        timers[name] = (timers.get(name, 0.0)
                        + time.perf_counter() - t0)


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
