"""One client of a cell: a closed loop of searches through the port's
public entry, started and fed by run.py.

    python3 benchmark/client.py INDEX WORKDIR

The protocol is one line at a time on stdin and stdout: the client loads
the port (PYTHONPATH names the checkout) while run.py makes the inputs;
run.py sends the spec (JSON); the client makes its inputs ready, warms
up with one search, starts the profiler when the run is traced,
and says "ready"; run.py sends "go T_END" once every client is ready
(the barrier); the client searches until time.perf_counter() passes
T_END, finishing the search it is in, writes WORKDIR/client-INDEX.json
(its searches, and the top-level names of jax, jaxlib, flax or the JAX
package that its sys.modules holds then) and says "done".

Each search's output goes to a sink that hashes it; the bytes of the
first output of each (input, digest) pair are kept, compressed, for the
comparison.  In a traced run the client also records, on the
perf_counter clock that every process on the machine shares:
- the program's compile stage per search (runtime/trace.py's timer,
  AGREP_TORCH_STATS=2) and a span around api.compile_query;
- spans around the device-layer functions the configuration lists (a
  call inside another is counted once);
- torch.profiler's device events (kernels, copies, memsets), put on the
  same clock through a marker span stamped at a known perf_counter time.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import sys
import time
import zlib


class Sink:
    """The file object a search prints to: hashes what it is given and
    keeps the pieces until the search is judged new or not."""

    def __init__(self):
        self.h = hashlib.sha256()
        self.n = 0
        self.parts = []

    def write(self, data) -> int:
        self.h.update(data)
        self.n += len(data)
        self.parts.append(data)
        return len(data)

    def flush(self) -> None:
        pass


class Spans:
    """Spans of the outermost calls of the wrapped functions."""

    def __init__(self):
        self.items = []
        self.depth = {}
        self.total = {}

    def wrap(self, where: str, label: str) -> None:
        """Wraps "module:attr" or "module:Class.attr" in place."""
        mod_name, _, qual = where.partition(":")
        owner = importlib.import_module(mod_name)
        *path, name = qual.split(".")
        for p in path:
            owner = getattr(owner, p)
        raw = owner.__dict__[name] if isinstance(owner, type) else \
            getattr(owner, name)
        kind = type(raw) if isinstance(raw, (staticmethod,
                                             classmethod)) else None
        real = raw.__func__ if kind else raw
        self.depth.setdefault(label, 0)
        self.total.setdefault(label, 0.0)

        def call(*a, **kw):
            t0 = time.perf_counter()
            self.depth[label] += 1
            try:
                return real(*a, **kw)
            finally:
                self.depth[label] -= 1
                if not self.depth[label]:
                    t1 = time.perf_counter()
                    self.total[label] += t1 - t0
                    self.items.append((label, t0, t1))
        call.__wrapped__ = real
        setattr(owner, name, kind(call) if kind else call)


def _device_events(trace_path: str, marker: float) -> list:
    """[(start, end, kind, name)] of the profiler's device events on
    the perf_counter clock; kind is kernel, h2d, d2h, copy or memset."""
    with open(trace_path, encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    mark = [e for e in events if e.get("name") == "agbench.marker"
            and e.get("cat") == "user_annotation"]
    if not mark:
        raise RuntimeError("the profiler's trace holds no marker span")
    offset = marker * 1e6 - float(mark[0]["ts"])
    out = []
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") != "X" or cat not in ("kernel", "gpu_memcpy",
                                               "gpu_memset"):
            continue
        name = e.get("name", "")
        if cat == "kernel":
            kind = "kernel"
        elif cat == "gpu_memset":
            kind = "memset"
        elif "HtoD" in name:
            kind = "h2d"
        elif "DtoH" in name:
            kind = "d2h"
        else:
            kind = "copy"
        s = (float(e["ts"]) + offset) / 1e6
        out.append((s, s + float(e.get("dur", 0.0)) / 1e6, kind, name))
    return out


def main(index: int, workdir: str) -> int:
    # the protocol keeps stdout; whatever else prints there goes to stderr
    proto = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    # the port (on PYTHONPATH) loads while run.py makes the inputs
    import numpy as np
    import torch

    from agrep_tpu_torch import api
    from agrep_tpu_torch.ops import scan as scan_ops
    from agrep_tpu_torch.runtime import trace as ptrace
    from agbench.harness import forbidden_modules
    spec = json.loads(sys.stdin.readline())

    traced = spec["trace"]
    if traced and not ptrace.DETAILED:
        raise RuntimeError("a traced client needs AGREP_TORCH_STATS=2")
    scan_ops.set_device(spec["device"])
    on_card = spec["device"].startswith("cuda")
    spans = Spans()
    if traced:
        spans.wrap(spec["compile_span"], "compile")
        for where in spec["device_layer"]:
            spans.wrap(where, "device_layer")

    pool = spec["pools"][index]
    fault = spec.get("fault")
    text = np.fromfile(spec["text_path"], dtype=np.uint8)
    bufs = {}
    for key in pool:
        s, e = spec["spans"][key]
        bufs[key] = b"\n" + text[s:e].tobytes()
    del text
    sizes = {k: len(b) for k, b in bufs.items()}
    query = api.Query(argv=list(spec["argv"]))
    if fault == "half_input":
        bufs = {k: b[:len(b) // 2] for k, b in bufs.items()}

    def search(key, sink):
        return query.search_buffer(bufs[key], output=sink)
    if fault == "alter_answer":
        real_search = search

        def search(key, sink):
            inner = Sink()
            n = real_search(key, inner)
            out = bytearray(b"".join(inner.parts))
            if out:
                out[0] ^= 0x20
            sink.write(bytes(out))
            return n
    if fault == "import_jax":
        # a search that loads a module named jax (a stub written here)
        stub = os.path.join(workdir, "stub-%d" % index)
        os.makedirs(os.path.join(stub, "jax"), exist_ok=True)
        open(os.path.join(stub, "jax", "__init__.py"), "w").close()
        plain_search = search

        def search(key, sink):
            sys.path.insert(0, stub)
            try:
                importlib.import_module("jax")
            finally:
                sys.path.remove(stub)
            return plain_search(key, sink)

    search(pool[0], Sink())                       # warm-up
    if on_card:
        torch.cuda.synchronize()
    spans.items.clear()
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if on_card:
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        marker = time.perf_counter()
        with record_function("agbench.marker"):
            pass
    proto.write("ready\n")
    proto.flush()
    line = sys.stdin.readline().split()
    if not line or line[0] != "go":
        return 2
    t_end = float(line[1])

    searches, kept, seen = [], [], set()
    i = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= t_end:
            break
        key = pool[i % len(pool)]
        i += 1
        sink = Sink()
        c0 = ptrace.timers.get("compile", 0.0)
        l0 = spans.total.get("device_layer", 0.0)
        err = None
        try:
            count = search(key, sink)
        except Exception as e:              # a failed search is counted
            count, err = None, "%s: %s" % (type(e).__name__, e)
        t1 = time.perf_counter()
        rec = {"key": key, "t0": t0, "t1": t1, "bytes": sizes[key],
               "count": count, "digest": sink.h.hexdigest(),
               "out_bytes": sink.n, "error": err}
        if traced:
            rec["compile_s"] = ptrace.timers.get("compile", 0.0) - c0
            rec["layer_s"] = spans.total.get("device_layer", 0.0) - l0
        if (key, rec["digest"]) not in seen and err is None:
            seen.add((key, rec["digest"]))
            kept.append((key, rec["digest"], sink.parts))
        searches.append(rec)

    for n, (key, digest, parts) in enumerate(kept):
        name = "out-%d-%d.z" % (index, n)
        with open(os.path.join(workdir, name), "wb") as fh:
            fh.write(zlib.compress(b"".join(parts), 1))
        kept[n] = {"key": key, "digest": digest, "file": name}

    result = {"index": index, "searches": searches, "kept": kept,
              "memory_peak_bytes": 0, "device_name": "cpu",
              "device_events": [], "spans": []}
    if on_card:
        torch.cuda.synchronize()
        result["memory_peak_bytes"] = int(torch.cuda.max_memory_reserved())
        result["device_name"] = torch.cuda.get_device_name()
    if traced:
        prof.__exit__(None, None, None)
        path = os.path.join(workdir, "trace-%d.json" % index)
        prof.export_chrome_trace(path)
        result["device_events"] = _device_events(path, marker)
        os.remove(path)
        result["spans"] = spans.items
    # what the searches loaded: run.py refuses a run whose clients hold
    # jax, jaxlib, flax or the JAX package once the window has closed
    result["forbidden"] = forbidden_modules()
    with open(os.path.join(workdir, "client-%d.json" % index), "w") as fh:
        json.dump(result, fh)
    proto.write("done\n")
    proto.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), sys.argv[2]))
