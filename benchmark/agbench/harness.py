"""One run of one cell: set-up, the clients' window, the comparison with
the plain reference, and the metrics.

Set-up (the parent, run.py's process): start the clients (they import
torch and the port meanwhile); in a thread, make the inputs from the
seed and write them to a fresh directory under TMPDIR (NumPy only); in
the main thread, look for the cards and build the configuration's kernel
libraries and the port's native host library once; hand each client its
spec, and wait until every client has warmed up.  The barrier is the
moment the last client is ready: setup_s runs from the process's start
to it, and the window from it to the last search's completion.  After
the window every client, and this process, must hold none of FORBIDDEN.
"""

from __future__ import annotations

import json
import os
import select
import shutil
import subprocess
import sys
import tempfile
import threading
import time

from . import inputs as inputs_mod
from . import judge, layout, stats

CLIENT = os.path.join(layout.BENCH, "client.py")
FORBIDDEN = ("jax", "jaxlib", "flax", "agrep_tpu")
READY_S = 900.0          # the first run in a checkout builds the kernels
FINISH_S = 240.0         # the last search after the window, and its trace


class RunError(Exception):
    """A run that cannot report: a client failed, a limit passed."""


class NoCard(RunError):
    """The machine lacks the cards the cell asks for."""


def forbidden_modules() -> list:
    """Top-level names in sys.modules that this process must not hold."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _env(trace: bool, device: str) -> dict:
    env = dict(os.environ)
    build = os.path.join(layout.ROOT, "build")
    env["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    env["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    env["AGREP_TORCH_DEVICE"] = device
    env["OMP_NUM_THREADS"] = "2"
    env["USE_FLAX"] = "0"
    env["PYTHONPATH"] = layout.ROOT
    if trace:
        env["AGREP_TORCH_STATS"] = "2"
    else:
        env.pop("AGREP_TORCH_STATS", None)
    env.pop("AGREP_TORCH_PROFILE", None)
    return env


def _readline(proc, deadline: float, what: str) -> str:
    while True:
        left = deadline - time.perf_counter()
        if left <= 0:
            raise RunError("a client did not say %r in time" % what)
        ready, _, _ = select.select([proc.stdout], [], [], min(left, 5.0))
        if ready:
            line = proc.stdout.readline()
            if not line:
                raise RunError("a client ended before saying %r" % what)
            return line.strip()
        if proc.poll() is not None:
            raise RunError("a client ended (exit %s) before saying %r"
                           % (proc.returncode, what))


def _build(cfg: dict, device: str) -> None:
    """The configuration's kernel libraries and the native host library,
    built once here so that the clients only load them."""
    sys.path.insert(0, layout.ROOT)
    from agrep_tpu_torch import native
    if device.startswith("cuda"):
        from agrep_tpu_torch.ops import _cuda
        _cuda.build_all(list(cfg["kernels"]))
    if native.get_lib() is None:
        raise RunError("the port's native host library did not build")


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, "rb") as fh:
            fh.seek(0, 2)
            fh.seek(max(0, fh.tell() - n))
            return fh.read().decode("utf-8", "replace")
    except OSError:
        return ""


def run_cell(bench: dict, cell: dict, cfg: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, t_start: float,
             device: str = "cuda", scale: float = 1.0,
             fault: str | None = None, check=None) -> dict:
    """The run's result line (a dict), or RunError.  check, called once
    the clients are loading, raises NoCard where the cards are missing."""
    work = tempfile.mkdtemp(prefix="agbench-")
    procs, logs = [], []
    try:
        n = traffic["clients"]
        env = _env(trace, device)
        for i in range(n):
            log = open(os.path.join(work, "client-%d.log" % i), "wb")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, CLIENT, str(i), work], cwd=layout.ROOT,
                env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=log, text=True))
        made = {}

        def make_inputs():
            t0 = time.perf_counter()
            try:
                made["inputs"] = inputs_mod.build(cfg, traffic, seed, work,
                                                  scale)
            except Exception as e:      # raised again in the main thread
                made["error"] = e
            made["s"] = time.perf_counter() - t0

        maker = threading.Thread(target=make_inputs, daemon=True)
        maker.start()
        if check is not None:
            check()
        t_build = time.perf_counter()
        _build(cfg, device)
        t_inputs = time.perf_counter()
        maker.join()
        if "error" in made:
            raise made["error"]
        inp = made["inputs"]
        t_spec = time.perf_counter()
        spec = {"device": device, "trace": trace,
                "argv": inp.argv, "pools": inp.pools,
                "spans": inp.spans, "text_path": inp.path,
                "compile_span": cfg["compile_span"],
                "device_layer": cfg["device_layer"], "fault": fault}
        line = json.dumps(spec) + "\n"
        for p in procs:
            p.stdin.write(line)
            p.stdin.flush()
        deadline = time.perf_counter() + READY_S
        for p in procs:
            if _readline(p, deadline, "ready") != "ready":
                raise RunError("a client broke the protocol")
        barrier = time.perf_counter()
        parts = {"start_s": t_build - t_start,
                 "build_s": t_inputs - t_build,
                 "inputs_s": made["s"],
                 "inputs_wait_s": t_spec - t_inputs,
                 "clients_s": barrier - t_spec}
        t_end = barrier + seconds
        for p in procs:
            p.stdin.write("go %r\n" % t_end)
            p.stdin.flush()
        deadline = t_end + FINISH_S
        for p in procs:
            if _readline(p, deadline, "done") != "done":
                raise RunError("a client broke the protocol")
        for p in procs:
            p.stdin.close()
            p.wait(timeout=60)
            if p.returncode != 0:
                raise RunError("a client exited %d" % p.returncode)
        results = []
        for i in range(n):
            with open(os.path.join(work, "client-%d.json" % i)) as fh:
                results.append(json.load(fh))
        held = ["client %d: %s" % (r["index"], ", ".join(r["forbidden"]))
                for r in results if r["forbidden"]]
        found = forbidden_modules()
        if found:
            held.append("run.py: %s" % ", ".join(found))
        if held:
            raise RunError("after the window, modules that the benchmark "
                           "must not load: %s" % "; ".join(held))
        out = _report(bench, cell, cfg, traffic, inp, results, barrier,
                      t_start, trace, device, work)
        out["run"]["setup_parts"] = parts
        out["compared"] = out.pop("compared")
        return out
    except NoCard:
        raise
    except RunError as e:
        tails = "".join("\n--- client %d ---\n%s" % (i, _tail(l.name))
                        for i, l in enumerate(logs))
        raise RunError("%s%s" % (e, tails)) from e
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(work, ignore_errors=True)


def _input_stats(inp, expected: dict) -> dict:
    """{key: n_bytes, n_lines, line_bytes, rows} of every buffer (its
    leading newline counted as a line of no bytes)."""
    import numpy as np
    nl = np.flatnonzero(inp.text == 0x0A)
    out = {}
    for key, (s, e) in inp.spans.items():
        lines = int(np.searchsorted(nl, e) - np.searchsorted(nl, s))
        n_bytes = e - s + 1
        out[key] = {"n_bytes": n_bytes, "n_lines": lines + 1,
                    "line_bytes": n_bytes - lines - 1,
                    "rows": expected[key][1]}
    return out


def _report(bench, cell, cfg, traffic, inp, results, barrier, t_start,
            trace, device, work) -> dict:
    searches, kept = [], []
    for r in results:
        for s in r["searches"]:
            s["client"] = r["index"]
            searches.append(s)
        kept.extend(r["kept"])
    done = [s for s in searches if s["error"] is None]
    rate, span = stats.search_rate(barrier, done)
    setup_s = barrier - t_start

    t_ref = time.perf_counter()
    ref = layout.reference(cfg)
    expected = ref.expected(cfg, inp)
    numbers = judge.judge(searches, kept, expected, work)
    ok = judge.correct(numbers) and bool(done) and all(
        r["searches"] for r in results)
    ref_s = time.perf_counter() - t_ref

    names = {m["name"] for m in layout.metrics_of(bench, "end_to_end",
                                                  cell["name"])}
    metrics = {}
    if not trace:
        if "search_gbs" in names and rate is not None:
            metrics["search_gbs"] = {"value": rate / 1e9, "unit": "GB/s"}
        if "setup_s" in names:
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    device_info = {
        "platform": "gpu" if device.startswith("cuda") else "cpu",
        "kind": results[0]["device_name"], "count": cell["chips"],
        "memory_peak_bytes": sum(r["memory_peak_bytes"] for r in results),
    }
    out = {"correct": ok, "attempted": len(searches),
           "failed": len(searches) - len(done) + numbers["searches_wrong"],
           "metrics": metrics, "device": device_info}
    if trace and span:
        bundle = _bundle(cfg, traffic, cell, inp, expected, results, done,
                         barrier, barrier + span)
        for m in layout.metrics_of(bench, "per_layer", cell["name"]):
            got = layout.metric(m["name"]).read(bundle)
            if got is not None:
                value, extra = got if isinstance(got, tuple) else (got, {})
                metrics[m["name"]] = {"value": value, "unit": m["unit"],
                                      **extra}
        lo, hi = bundle["window"]
        ivs = [(e[0], e[1]) for e in bundle["device"]]
        device_info["busy_s"] = stats.busy(ivs, lo, hi)
        device_info["window_s"] = hi - lo
        out["breakdown"] = breakdown(bundle)
    out["run"] = {"seconds_window": span, "searches": len(done),
                  "clients": len(results), "reference_s": ref_s,
                  "cpu_count": os.cpu_count(),
                  "client_searches": [len(r["searches"]) for r in results],
                  "gb_by_second": _by_second(done, barrier)}
    out["compared"] = {k: {"value": v, "limit": judge.LIMITS[k]}
                       for k, v in numbers.items()}
    return out


def _by_second(done: list, barrier: float) -> list:
    """GB completed in each second of the window (by completion)."""
    out = []
    for s in done:
        i = int(s["t1"] - barrier)
        out.extend([0.0] * (i + 1 - len(out)))
        out[i] += s["bytes"] / 1e9
    return [round(x, 3) for x in out]


def _bundle(cfg, traffic, cell, inp, expected, results, done, lo, hi):
    """What the per-layer metrics read: the window, its completed
    searches, every client's device events and host spans (on one
    clock), and each input's sizes and expected rows."""
    dev, spans = [], []
    for r in results:
        for s, e, kind, name in r["device_events"]:
            dev.append((s, e, kind, name, r["index"]))
        for label, s, e in r["spans"]:
            spans.append((r["index"], label, s, e))
        for s in r["searches"]:
            spans.append((r["index"], "search", s["t0"], s["t1"]))
    dev = [d for d in dev if d[1] > lo and d[0] < hi]
    return {"config": cfg, "traffic": traffic, "cell": cell,
            "window": (lo, hi), "searches": done, "device": dev,
            "spans": spans, "inputs": _input_stats(inp, expected)}


def host_state(bundle, t: float) -> str:
    """What the clients were doing at time t: the labels of the spans
    open then (compile, device_layer, else host inside a search), one a
    client, sorted and joined by '+'; 'between' where none searched."""
    open_by = {}
    for client, label, s, e in bundle["spans"]:
        if s <= t < e:
            open_by.setdefault(client, set()).add(label)
    states = set()
    for labels in open_by.values():
        if "compile" in labels:
            states.add("compile")
        elif "device_layer" in labels:
            states.add("device_layer")
        elif "search" in labels:
            states.add("host")
    return "+".join(sorted(states)) or "between"


def breakdown(bundle) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the card, each named by what the clients were doing."""
    lo, hi = bundle["window"]
    by_name = {}
    for s, e, kind, name, _c in bundle["device"]:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    ivs = [(d[0], d[1]) for d in bundle["device"]]
    gaps = sorted(stats.gaps(ivs, lo, hi), key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n[:120], v] for n, v in ops],
            "idle_gaps": [[host_state(bundle, (s + e) / 2), e - s]
                          for s, e in gaps]}
