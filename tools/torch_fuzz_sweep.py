"""The port's randomized conformance sweep: tools/fuzz_sweep.py's
random corpora and flag/pattern draws, agrep_tpu_torch against a
reference, both in process, stdout and exit code compared exactly.

  python tools/torch_fuzz_sweep.py
      [--stratified | --regex | --boolean | --memory] [--device-route]
      [--ref tpu|numpy] [--device cpu|cuda] [--port-backend torch|numpy]
      [--stream] [--limit S] [n_cases] [seed0]

  --ref tpu     agrep_tpu on its numpy backend (imported only here: the
                GPU machine has no JAX)
  --ref numpy   the port's own numpy backend (host passes, native C)
  --device      where the port's torch backend runs: cpu runs the
                kernels' plain PyTorch versions, cuda the Hopper kernels
  --port-backend
                the port's backend under test: torch (default) or numpy
  --stream      the port under test streams every file in 64 KiB chunks
                (AGREP_TORCH_STREAM_MB=0, scan.STREAM_CHUNK = 64 KiB),
                and the reference reads every file whole (its stream
                threshold, AGREP_TPU_STREAM_MB or AGREP_TORCH_STREAM_MB,
                raised for its runs only): a streaming fault that both
                packages share shows
  --device-route
                repeats each generated corpus past mgrep.DEVICE_MIN
                (64 KiB), so that -f sets, booleans and long streams take
                the port's device route as production sizes do; and every
                third case (seed % 3 == 0) of a uniform or stratified
                sweep takes the past-caps stratum: a -f file of terms
                that carry every byte 0x80-0xFF, so that the set holds
                more byte classes than the chain kernel's 127, with some
                terms planted in the corpus.  Of those, seeds with an odd
                seed // 3 draw 30 terms (qgram_filter and the native
                verify), the others 12 (the mask machine's packed term
                words).
  --boolean     the boolean stratum: an AND, an OR or a tree with ~ of
                2-6 terms of letters (two bytes at least: mgrep streams
                only such booleans), printed or counted (-c), with -i or
                -h now and then and no flag that makes mgrep read the
                file whole; a few lines that hold every term are put in
                the corpus.  With --device-route and --stream its files
                stream through MgrepEngine._bool_stream_chunked, which
                on the torch backend launches line_terms a chunk.
  --memory      the memory stratum: memagrep cases (a buffer and an argv)
                drawn as tests/test_memagrep_oracle.py's
                test_memagrep_fuzz_wide draws them (boolean trees,
                classes, '#' wildcards, ~, -t/-x/-k/-l/-s, costs, -d
                '$$', 'o' and 'll', buffers across 32 and 64 KB), each
                held against the port's per-byte memory-mode loop
                (BitapEngine._memory_search_loop, on the numpy backend)
                whatever --ref says: the bitap engine's memory records
                from the scan and the record lanes against the loop,
                the other engines against the numpy backend.
  --limit S     each side of each case gets S seconds (default 20) by
                SIGALRM (so the sweep runs in the main thread); a side
                over it is neither a pass nor a divergence: it is
                printed with its seed, argv and side and counted as
                over_limit
  --skip S,...  seeds left out, each listed in the last line: a case
                whose side loops inside native code, where SIGALRM's
                handler never runs (the reference's -d ... -t loop)

Each case is built as tools/fuzz_sweep.py's run_case builds it (the
same draws in the same order; the generators are imported from that
file unchanged).  Errors map as run_case maps them: AgrepError -> 255
with the version text or the late "Grand Total" line, OutputOverflow ->
255.  Every run reads "y" from stdin, so -B's prompt never waits.  The
last line is one JSON object after "sweep: ": the cases by mode, the
divergences, crashes and over_limit cases, each kernel's launches (the
port's launch counters: 0 on the CPU, where the plain versions run) and
the seconds.  The exit code is 1 on any divergence or crash.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import random
import signal
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# the device route's stream size (agrep_tpu_torch/runtime/mgrep.py's
# DEVICE_MIN is 64 KiB); make_corpus's largest size
GROW = 70000
ANSWER = b"y\n"
LIMIT_S = 20.0
# --stream: the subject's chunk, and a stream threshold no file reaches
STREAM_CHUNK = 1 << 16
WHOLE_MB = "1048576"
# ASCII bytes the past-caps terms carry besides their words' letters, so
# that the set stays past 127 classes under -i's fold too
EXTRA = b"0123456789#%&+/:=@_"


def generators():
    """tools/fuzz_sweep.py, loaded by path (it imports nothing of
    agrep_tpu at module level)."""
    name = "_fuzz_sweep_generators"
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(REPO, "tools", "fuzz_sweep.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return mod


def grow(corpus: bytes) -> bytes:
    """The corpus repeated whole until it holds GROW bytes or more."""
    if not corpus or len(corpus) >= GROW:
        return corpus
    return corpus * -(-GROW // len(corpus))


def past_caps(seed: int, mode: str, device_route: bool) -> bool:
    return device_route and mode != "regex" and seed % 3 == 0


def wide_terms(r: random.Random, n: int) -> list:
    """n terms, each a word of fuzz_sweep.WORDS with a run of bytes
    0x80-0xFF and one EXTRA byte put in it; together they hold every
    byte 0x80-0xFF."""
    fs = generators()
    k = -(-128 // n) + 1
    terms = []
    for j in range(n):
        w = r.choice(fs.WORDS)
        hi = bytes(0x80 + (j * (k - 1) + t) % 128 for t in range(k))
        cut = r.randint(0, len(w))
        terms.append(w[:cut] + hi + EXTRA[j % len(EXTRA):][:1] + w[cut:])
    return terms


def plant(r: random.Random, corpus: bytes, terms: list) -> bytes:
    """corpus with a few of the terms copied in at random offsets."""
    out = bytearray(corpus)
    for t in r.sample(terms, min(len(terms), r.randint(1, 4))):
        for _ in range(r.randint(1, 3)):
            if len(out) > len(t):
                at = r.randrange(len(out) - len(t))
                out[at:at + len(t)] = t
    return bytes(out)


# the boolean stratum's flags and the chance of each
BOOL_FLAGS = (("-c", .4), ("-i", .3), ("-h", .1))


def bool_terms(r: random.Random) -> list:
    """2-6 terms of two or more letters: words of fuzz_sweep.WORDS and
    drawn ones."""
    fs = generators()
    words = [w for w in fs.WORDS if len(w) >= 2 and w.isalpha()]
    out = []
    for _ in range(r.randint(2, 6)):
        if r.random() < 0.6:
            out.append(r.choice(words))
        else:
            out.append(bytes(r.choice(b"abcdehlmoxyz")
                             for _ in range(r.randint(2, 5))))
    return out


def bool_pattern(r: random.Random, terms: list) -> str:
    """An AND (;), an OR (,) or a tree of the terms, grouped by braces
    with ~ on some of them."""
    ts = [t.decode("latin-1") for t in terms]
    shape = r.choice(["and", "or", "tree", "tree"])
    if shape != "tree":
        return (";" if shape == "and" else ",").join(ts)

    def tree(xs):
        if len(xs) == 1:
            return ("~" if r.random() < 0.3 else "") + xs[0]
        k = r.randint(1, len(xs) - 1)
        op = r.choice(";,")
        left, right = tree(xs[:k]), tree(xs[k:])
        if k > 1:
            left = "{" + left + "}"
        if len(xs) - k > 1:
            right = "{" + right + "}"
        return left + op + right
    return tree(ts)


def plant_lines(r: random.Random, corpus: bytes, terms: list) -> bytes:
    """corpus with 1-5 lines that hold every term put in at line
    starts."""
    out = bytearray(corpus)
    for _ in range(r.randint(1, 5)):
        line = b" ".join(r.sample(terms, len(terms))) + b"\n"
        nl = [k + 1 for k in range(len(out)) if out[k] == 0x0A] or [0]
        at = r.choice(nl)
        out[at:at] = line
    return bytes(out)


def build_case(i: int, seed: int, tmpdir: str, mode: str = "uniform",
               device_route: bool = False) -> list:
    """The argv of case seed, its files written under tmpdir, drawn as
    tools/fuzz_sweep.py's run_case draws it (the boolean stratum as
    bool_pattern draws it); then grown and, for the past-caps stratum,
    given a -f file of wide terms."""
    fs = generators()
    r = random.Random(seed)
    if mode == "boolean":
        corpus = (fs.make_corpus_straddle(r) if r.random() < 0.3
                  else fs.make_corpus(r))
        terms = bool_terms(r)
        corpus = plant_lines(r, corpus, terms)
        args = [f for f, p in BOOL_FLAGS if r.random() < p]
        args += ["-e", bool_pattern(r, terms)]
        if device_route:
            corpus = grow(corpus)
        path = os.path.join(tmpdir, "c%d.txt" % (i % 8))
        with open(path, "wb") as f:
            f.write(corpus)
        return args + [path]
    if mode == "regex":
        corpus = (fs.make_corpus_straddle(r) if r.random() < 0.6
                  else fs.make_corpus(r))
        flags, pat = fs.make_args_regex(r)
        force_f = False
    elif mode == "stratified":
        corpus = fs.make_corpus_straddle(r)
        flags, pat, force_f = fs.make_args_stratified(r)
    else:
        corpus = fs.make_corpus(r)
        flags, pat = fs.make_args(r)
        force_f = False
    corpora = [corpus]
    if r.random() < 0.3:
        # multi-file: FNAME prefixes, per-file counts, -l lists
        corpora.append(fs.make_corpus(r))
    paths = [os.path.join(tmpdir, "%s%d.txt" % (c, i % 8))
             for c in "cd"[:len(corpora)]]
    pf = os.path.join(tmpdir, "p%d.txt" % (i % 8))
    pats = None
    if (force_f or r.random() < 0.15) and mode != "regex":
        npat = r.choice([2, 5, 30, 120])
        pats = [r.choice(fs.WORDS) for _ in range(npat // 2)]
        pats += [b"q%03d" % k for k in range(npat - len(pats))]
        args = [fl for fl in flags if fl not in ("-x", "-G")] + ["-f", pf]
    else:
        f_flags = [fl for fl in flags if fl not in ("-x", "-G")]
        if r.random() < 0.06:
            flags = ["-B", "-y"] + [fl for fl in flags
                                    if fl not in ("-B", "-y")]
        if r.random() < 0.05:
            flags.append(r.choice(["-CP437", "-CP850"]))
        if pat.startswith("-"):
            flags.append("-e")
        args = flags + [pat]
    if device_route:
        corpora = [grow(c) for c in corpora]
    if past_caps(seed, mode, device_route):
        pats = wide_terms(r, 30 if (seed // 3) % 2 else 12)
        corpora[0] = plant(r, corpora[0], pats)
        if "-f" not in args:
            args = f_flags + ["-f", pf]
    for path, data in zip(paths, corpora):
        with open(path, "wb") as f:
            f.write(data)
    if pats is not None:
        with open(pf, "wb") as f:
            f.write(b"".join(x + b"\n" for x in pats))
    return args + paths


# the memory stratum's words and patterns (test_memagrep_fuzz_wide's)
MEM_WORDS = [b"alpha", b"hello", b"matching", b"zz", b"koala", b"d$d",
             b"bravo", b"CaSe"]
MEM_PATS = ["hello", "koala", "alpha", "nosuch", "hel*o", "h#o",
            "hello;zz", "al(p|f)ha", "alpha;koala;zz", "hello,zz", "br#vo",
            "[a-h]ello", "~hello", "{alpha;bravo},koala"]


def memory_case(seed: int) -> tuple:
    """(argv, buffer) of memory case seed, drawn as
    tests/test_memagrep_oracle.py's test_memagrep_fuzz_wide draws its
    case of that seed."""
    rnd = random.Random(seed)
    out = bytearray(b"\n")
    size = rnd.choice([3, 30, 300, 3000, 20000, 33000, 65600])
    style = rnd.randrange(3)
    while len(out) < size:
        if style == 0:
            out += b" ".join(rnd.choice(MEM_WORDS)
                             for _ in range(rnd.randint(1, 6)))
            out += rnd.choice([b"\n", b"$$", b""])
        elif style == 1:
            out += rnd.choice(MEM_WORDS) * rnd.randint(1, 9)
            out += rnd.choice([b"\n", b" ", b"o", b"ll"])
        else:
            out += bytes(rnd.choice(b"ab\nxyo$") for _ in range(64))
    data = bytes(out[:size]) + rnd.choice(
        [b"\n", b"\n", b"", b" tail no newline"])
    flags = []
    for f, p in (("-c", .4), ("-n", .2), ("-v", .2), ("-i", .2),
                 ("-b", .1), ("-w", .15), ("-t", .1), ("-l", .05),
                 ("-s", .05), ("-x", .05), ("-k", .05)):
        if rnd.random() < p:
            flags.append(f)
    if rnd.random() < .3:
        flags.append("-%d" % rnd.randint(1, 3))
    if rnd.random() < .25:
        flags += ["-d", rnd.choice(["$$", "o", "ll"])]
    if rnd.random() < .1:
        flags += ["-D2", "-I1", "-S1"]
    return flags + [rnd.choice(MEM_PATS)], data


class OverLimit(BaseException):
    """A side ran past its time limit (a BaseException, so that no
    `except Exception` on the way swallows it)."""


@contextlib.contextmanager
def time_limit(seconds):
    """SIGALRM after `seconds` (the caller must be the main thread)."""
    def alarm(signum, frame):
        raise OverLimit()
    old = signal.signal(signal.SIGALRM, alarm)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _run(api, helpmod, err_cls, overflow_cls, args, limit,
         data=None) -> tuple:
    """(stdout bytes, exit code) of one in-process fileagrep (memagrep
    over data where it is not None), errors mapped as
    tools/fuzz_sweep.py's run_case maps them.  Text a run prints to
    sys.stdout lands after its output bytes; stderr is dropped."""
    buf = io.BytesIO()
    out, err = io.StringIO(), io.StringIO()
    saved = sys.stdin
    sys.stdin = io.TextIOWrapper(io.BytesIO(ANSWER))
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err), time_limit(limit):
            try:
                rc = (api.fileagrep(args, output=buf) if data is None
                      else api.memagrep(args, data, output=buf)) & 0xFF
            except err_cls as e:
                rc = 255
                if getattr(e, "version", False):
                    helpmod.print_version()
                elif getattr(e, "late", False) and getattr(
                        e, "verbose", 1) > 0:
                    buf.write(b"Grand Total: 0 match(es) found.\n")
            except overflow_cls:
                rc = 255
    finally:
        sys.stdin = saved
    return buf.getvalue() + out.getvalue().encode("utf-8",
                                                  "surrogateescape"), rc


@contextlib.contextmanager
def streaming(scan, var: str, stream):
    """A run with files streamed in STREAM_CHUNK chunks (stream
    "chunked": env var at 0) or read whole ("whole": at WHOLE_MB);
    stream None leaves both as they are."""
    if stream is None:
        yield
        return
    saved = os.environ.get(var), scan.STREAM_CHUNK
    os.environ[var] = "0" if stream == "chunked" else WHOLE_MB
    if stream == "chunked":
        scan.STREAM_CHUNK = STREAM_CHUNK
    try:
        yield
    finally:
        if saved[0] is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = saved[0]
        scan.STREAM_CHUNK = saved[1]


def port_side(device: str, backend: str = "torch", stream=None,
              loop: bool = False):
    """A runner of the port on `backend` ("torch" on `device`, or
    "numpy"), its files streamed as `stream` says (streaming); with
    loop, the bitap engine's memory mode runs its per-byte loop."""
    from agrep_tpu_torch import api, help as helpmod
    from agrep_tpu_torch.ops import scan
    from agrep_tpu_torch.options import AgrepError
    from agrep_tpu_torch.runtime.engine import BitapEngine
    from agrep_tpu_torch.runtime.output import OutputOverflow

    def run(args, limit, data=None):
        saved = scan._BACKEND, scan._DEVICE
        scan.set_backend(backend)
        scan.set_device(device)
        real = BitapEngine._memory_search
        if loop:
            BitapEngine._memory_search = BitapEngine._memory_search_loop
        try:
            with streaming(scan, "AGREP_TORCH_STREAM_MB", stream):
                return _run(api, helpmod, AgrepError, OutputOverflow,
                            args, limit, data)
        finally:
            scan._BACKEND, scan._DEVICE = saved
            BitapEngine._memory_search = real
    return run


def tpu_side(stream=None):
    """A runner of agrep_tpu on its numpy backend, its files streamed as
    `stream` says (streaming)."""
    from agrep_tpu import api, help as helpmod
    from agrep_tpu.ops import scan
    from agrep_tpu.options import AgrepError
    from agrep_tpu.runtime.output import OutputOverflow

    def run(args, limit):
        saved = scan._BACKEND
        scan.set_backend("numpy")
        try:
            with streaming(scan, "AGREP_TPU_STREAM_MB", stream):
                return _run(api, helpmod, AgrepError, OutputOverflow,
                            args, limit)
        finally:
            scan.set_backend(saved)
    return run


def sides(ref: str, device: str, backend: str = "torch",
          stream: bool = False) -> dict:
    """The runners: the port on `backend` ("ours"), and the reference;
    with stream, ours streams in chunks and the reference reads whole."""
    ours, theirs = ("chunked", "whole") if stream else (None, None)
    return {"ours": port_side(device, backend, ours),
            "ref": (tpu_side(theirs) if ref == "tpu"
                    else port_side(device, "numpy", theirs)),
            "loop": port_side(device, "numpy", loop=True)}


def check_case(i: int, seed: int, tmpdir: str, mode: str,
               device_route: bool, runners: dict,
               limit: float = LIMIT_S) -> dict:
    """One case: {"status": "pass" | "diverge" | "over_limit" | "crash",
    "seed", "mode", "args", and per side its output and exit code, or
    the side that ran over or crashed and its error}."""
    data = None
    if mode == "memory":
        args, data = memory_case(seed)
    else:
        args = build_case(i, seed, tmpdir, mode, device_route)
    res = {"seed": seed, "mode": mode_name(mode, device_route),
           "args": args}
    got = {}
    for side in ("ref", "ours"):
        run = runners["loop" if data is not None and side == "ref"
                      else side]
        try:
            got[side] = (run(args, limit) if data is None
                         else run(args, limit, data))
        except OverLimit:
            return dict(res, status="over_limit", side=side)
        except Exception as e:       # noqa: BLE001 -- reported
            return dict(res, status="crash", side=side, error=repr(e))
    res.update(ref=got["ref"], ours=got["ours"])
    res["status"] = "pass" if got["ref"] == got["ours"] else "diverge"
    return res


def mode_name(mode: str, device_route: bool) -> str:
    return ("device-route/" if device_route else "") + mode


def describe(res: dict) -> str:
    """The lines that report a case that did not pass."""
    head = "seed=%d mode=%s args=%r" % (res["seed"], res["mode"],
                                        res["args"])
    if res["status"] == "diverge":
        (o_out, o_rc), (m_out, m_rc) = res["ref"], res["ours"]
        return ("DIVERGENCE %s\n  ref  rc=%d out[:160]=%r\n"
                "  ours rc=%d out[:160]=%r"
                % (head, o_rc, o_out[:160], m_rc, m_out[:160]))
    if res["status"] == "over_limit":
        return "OVER_LIMIT %s side=%s" % (head, res["side"])
    return "CRASH %s side=%s %s" % (head, res["side"], res["error"])


def launch_counts() -> dict:
    from agrep_tpu_torch.ops import (chain_kernel, kernels, qgram_kernel,
                                     renfa_kernel, scan)
    return {k: v for c in (kernels.launches, renfa_kernel.launches,
                           chain_kernel.launches, qgram_kernel.launches,
                           scan.launches)
            for k, v in c.items()}


def sweep(runs, ref: str = "tpu", device: str = "cpu",
          limit: float = LIMIT_S, out=print, backend: str = "torch",
          stream: bool = False, skip=()) -> dict:
    """Every (mode, device_route, n_cases, seed0) of runs but the seeds
    in skip; prints each case that did not pass, and returns the summary
    of the last line.  The launch counts are those the sweep added."""
    import tempfile
    runners = sides(ref, device, backend, stream)
    before = launch_counts()
    t0 = time.perf_counter()
    cases, bad, over, skipped = {}, [], [], []
    with tempfile.TemporaryDirectory(prefix="torch_sweep_") as tmpdir:
        for mode, device_route, n, seed0 in runs:
            name = mode_name(mode, device_route)
            for i in range(n):
                if seed0 + i in skip:
                    skipped.append({"seed": seed0 + i, "mode": name})
                    continue
                cases[name] = cases.get(name, 0) + 1
                res = check_case(i, seed0 + i, tmpdir, mode, device_route,
                                 runners, limit)
                if res["status"] == "pass":
                    continue
                out(describe(res))
                if res["status"] == "over_limit":
                    over.append({"seed": res["seed"], "mode": name,
                                 "side": res["side"]})
                else:
                    bad.append(res)
    after = launch_counts()
    return {"cases": cases, "ref": ref, "device": device,
            "port_backend": backend, "stream": stream,
            "divergences": sum(r["status"] == "diverge" for r in bad),
            "crashes": sum(r["status"] == "crash" for r in bad),
            "over_limit": over, "skipped": skipped,
            "launches": {k: after[k] - before[k] for k in after},
            "seconds": round(time.perf_counter() - t0, 3)}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--stratified", action="store_true")
    group.add_argument("--regex", action="store_true")
    group.add_argument("--boolean", action="store_true")
    group.add_argument("--memory", action="store_true")
    ap.add_argument("--device-route", action="store_true")
    ap.add_argument("--ref", choices=("tpu", "numpy"), default="tpu")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--port-backend", choices=("torch", "numpy"),
                    default="torch")
    ap.add_argument("--stream", action="store_true")
    ap.add_argument("--limit", type=float, default=LIMIT_S)
    ap.add_argument("--skip", default="")
    ap.add_argument("n_cases", type=int, nargs="?", default=500)
    ap.add_argument("seed0", type=int, nargs="?", default=1000)
    a = ap.parse_args(argv)
    mode = ("stratified" if a.stratified else "regex" if a.regex
            else "boolean" if a.boolean else "memory" if a.memory
            else "uniform")
    res = sweep([(mode, a.device_route, a.n_cases, a.seed0)], a.ref,
                a.device, a.limit, out=lambda s: print(s, flush=True),
                backend=a.port_backend, stream=a.stream,
                skip={int(x) for x in a.skip.split(",") if x})
    print("sweep: " + json.dumps(res))
    return 1 if res["divergences"] or res["crashes"] else 0


if __name__ == "__main__":
    sys.exit(main())
