"""A streamed search prints what the same search prints read whole.

The port streams every file in 64 KiB chunks (AGREP_TORCH_STREAM_MB=0,
scan.STREAM_CHUNK = 64 KiB), once on its torch backend on the CPU (the
kernels' plain versions) and once on its numpy backend; agrep_tpu reads
every file whole on its numpy backend (its threshold raised for its runs
only).  Stdout and exit code must be equal.  The runners are
tools/torch_fuzz_sweep.py's with --stream.  The cases:

  * sweep seeds whose streamed print differed from the whole-file one:
    a -u -f print that wrote its records, and regex prints of lines
    across a 49,152-byte block boundary that took the whole-file walk
    with D = 0 for a search with errors (a clamped record 1,023 bytes
    too long, a residue's NULs, a -b offset one too high);
  * -u with a -f set and with booleans, on one file of short lines and
    on two (the file name prefix); and on the sgrep, bitap and regex
    engines and a count, whose streamed walks were right already;
  * lines around the block boundary at 98,304 whose previous newline
    sits 1,024, 1,025 and 1,026 bytes before it (the edge of the clamp
    of r_output's record, regex_engine.line_record), with and without a
    NUL in the line before the boundary, with D = 0 and D = 1, plain and
    with -n -b; and a NUL in the line before, within the Maxline bytes
    the D > 0 scan carries;
  * a slice of the streamed sweep in each mode, and of the sweep with
    the port's numpy backend under test, unstreamed.

The regex cases must take the streamed walk: the port's whole-file walk
(RegexEngine.search_stream) runs no time on their streamed side.
"""

from __future__ import annotations

import numpy as np
import pytest

from agrep_tpu_torch.runtime import regex_engine

from .torch_oracle import one_thread
from .torch_sweep import check, seeds, sweep

BACKENDS = ["torch", "numpy"]
_RUNNERS = {}


def runners(backend: str, stream: bool = True) -> dict:
    key = backend, stream
    if key not in _RUNNERS:
        _RUNNERS[key] = sweep.sides("tpu", "cpu", backend, stream)
    return _RUNNERS[key]


def same(run: dict, args: list) -> tuple:
    """(stdout, rc) of the port's streamed run, held to agrep_tpu's
    whole-file run."""
    with one_thread():
        want = run["ref"](args, sweep.LIMIT_S)
        got = run["ours"](args, sweep.LIMIT_S)
    assert got == want, (args, len(got[0]), len(want[0]), got[1], want[1])
    return got


# (seed, mode, device route) of tools/torch_fuzz_sweep.py
PINNED = [
    (72044, "stratified", True),    # -D3 -I1 -S2 -t -u -f
    (75054, "stratified", True),    # -D2 -I1 -S2 -t -u -f
    (82309, "stratified", True),    # -D2 -I1 -S1 -t -u -f
    (73148, "regex", True),         # -1 -t 'a(b|c)x'
    (73197, "regex", True),         # -B -y -1 -D2 -I1 -S1 -t -i
    (76021, "regex", True),         # -2 -D2 -I2 -S2 -x -n 'x*y', 2 files
    (76021, "regex", False),
    (76066, "regex", True),         # -2 -D2 -I2 -S2 -t -i '<he>(ll|xx)o'
    (81227, "uniform", True),       # -2 'x*y', NULs in the residue
    (83159, "regex", True),         # -2 -D2 -I1 -S1 -x -b 'he(l|r)*o'
]


@pytest.fixture
def regex_walks(monkeypatch):
    """The port's regex walks as they are called: "whole"
    (search_stream) or "streamed" (search_stream_chunked)."""
    calls = []
    for name, kind in (("search_stream", "whole"),
                       ("search_stream_chunked", "streamed")):
        def counted(self, *a, _real=getattr(regex_engine.RegexEngine,
                                            name), _kind=kind, **k):
            calls.append(_kind)
            return _real(self, *a, **k)
        monkeypatch.setattr(regex_engine.RegexEngine, name, counted)
    return calls


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed,mode,device_route", PINNED,
                         ids=["%s-%d%s" % (m, s, "-grown" * d)
                              for s, m, d in PINNED])
def test_pinned_seed(tmp_path, regex_walks, backend, seed, mode,
                     device_route):
    res = check(runners(backend), tmp_path, mode, device_route, seed)
    assert res["ours"][0]
    if "-u" not in res["args"]:
        assert regex_walks and set(regex_walks) == {"streamed"}, res["args"]


WORDS = [b"hello", b"world", b"lazy", b"the", b"quick", b"brown", b"fox",
         b"jumps", b"over", b"dog", b"lorem", b"ipsum"]


def short_lines(seed: int, n_lines: int) -> bytes:
    """n_lines lines of six words each."""
    rng = np.random.default_rng(seed)
    picks = rng.integers(0, len(WORDS), (n_lines, 6))
    return b"".join(b" ".join(WORDS[i] for i in row) + b"\n"
                    for row in picks)


U_QUERIES = {"f": ["-u", "-f", "{pf}"], "and": ["-u", "hello;world"],
             "or": ["-u", "hello,world"]}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n_files", [1, 2])
@pytest.mark.parametrize("query", sorted(U_QUERIES))
def test_u_prints_no_record(tmp_path, backend, n_files, query):
    paths = []
    for i in range(n_files):
        path = tmp_path / ("lines%d.txt" % i)
        path.write_bytes(short_lines(i, 5000))
        assert path.stat().st_size > 150_000
        paths.append(str(path))
    pf = tmp_path / "terms.txt"
    pf.write_bytes(b"hello\nworld\nlazy\n")
    args = [a.format(pf=pf) for a in U_QUERIES[query]] + paths
    out, rc = same(runners(backend), args)
    assert rc and out.endswith(b"match(es) found.\n")
    assert b"hello" not in out and b"world" not in out


# -u on the other engines' streamed walks, which printed the whole-file
# bytes before the -f and boolean walks were kept whole: sgrep, bitap,
# regex, and a count
U_OTHER = {"sgrep": ["-u", "hello"], "sgrep_n": ["-u", "-n", "hello"],
           "bitap": ["-1", "-u", "hello"], "regex": ["-u", "h(e|a)llo"],
           "count": ["-u", "-c", "hello"]}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("query", sorted(U_OTHER))
def test_u_on_the_other_engines(tmp_path, backend, query):
    path = tmp_path / "lines.txt"
    path.write_bytes(short_lines(7, 5000))
    out, rc = same(runners(backend), U_OTHER[query] + [str(path)])
    assert rc and b"hello" not in out


B = 2 * regex_engine.BSR           # the boundary the edge lines cross
FILLER = [b"the", b"quick", b"brown", b"fox", b"jumps", b"over", b"lazy",
          b"dog"]


def filler(rng, length: int) -> bytearray:
    """length bytes of short lines of FILLER words (no 'h(e|a)llo'
    within one error), the last byte a newline."""
    out = bytearray()
    while len(out) < length:
        out += b" ".join(FILLER[i] for i in rng.integers(
            0, len(FILLER), int(rng.integers(2, 8)))) + b"\n"
    del out[length:]
    out[-1] = 0x0A
    return out


def edge_corpus(gap: int, nul: str) -> bytes:
    """About 150 KB: its newline before the boundary B sits gap bytes
    before B, and the next line, which holds "hello" past B, crosses it.
    nul "line": a NUL in that line, 10 bytes past its start; "carry": a
    NUL in the line before, 20 bytes before that line's newline."""
    rng = np.random.default_rng(gap)
    data = filler(rng, B - gap + 1)
    assert data.rindex(b"\n") == B - gap
    line = bytearray(b"y" * (gap - 1) + b" then hello there\n")
    if nul == "line":
        line[10] = 0
    if nul == "carry":
        data[-21] = 0
    data += line
    data += filler(rng, 150_000 - len(data))
    return bytes(data)


EDGES = ([(gap, nul, d, flags) for gap in (1024, 1025, 1026)
          for nul in ("none", "line") for d in (0, 1)
          for flags in ((), ("-n", "-b"))]
         + [(1000, "carry", d, flags) for d in (0, 1)
            for flags in ((), ("-n", "-b"))])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("gap,nul,d,flags", EDGES,
                         ids=["%d-%s-D%d%s" % (g, n, d, "".join(f))
                              for g, n, d, f in EDGES])
def test_clamp_edges(tmp_path, regex_walks, backend, gap, nul, d, flags):
    path = tmp_path / "edge.txt"
    data = edge_corpus(gap, nul)
    path.write_bytes(data)
    at = data.index(b"hello")
    begin = data.rindex(b"\n", 0, at) + 1
    assert begin == B - gap + 1 and at > B
    args = list(flags) + ["-%d" % d] * (d > 0) + ["h(e|a)llo", str(path)]
    out, rc = same(runners(backend), args)
    assert rc == 1 and out
    assert regex_walks == ["streamed"]


def test_line_record_edges():
    """line_record at the clamp's edge, against the rule it states: a
    line across the boundary j that began MAXLINE or more before j
    prints clamped; one that began later prints whole."""
    for gap in (1023, 1024, 1025, 1026):
        data = np.frombuffer(edge_corpus(gap, "none"), np.uint8)
        b = B - gap + 1
        e = int(np.flatnonzero(data[b:] == 0x0A)[0]) + b
        assert regex_engine.crosses(b, e)
        for d in (0, 1):
            rec, n = regex_engine.line_record(data, b, e, d)
            rec = np.asarray(rec)
            if b <= B - regex_engine.MAXLINE:
                head = data[b:b + regex_engine.MAXLINE - 1] if d == 0 \
                    else data[:0]
                want = np.concatenate([head, data[B:e + 1]])
                assert n == len(rec)
            else:
                want = data[b:e + 1]
                assert n == len(rec) - 1
            assert rec.tobytes() == want.tobytes(), (gap, d)


# a slice of the streamed sweep in each mode, and of the unstreamed one
# with the port's numpy backend under test
STREAM_CASES = (seeds("uniform", False, 90000, 5)
                + seeds("stratified", False, 91000, 5)
                + seeds("regex", False, 92000, 5)
                + seeds("uniform", True, 93000, 4)
                + seeds("stratified", True, 94000, 4)
                + seeds("regex", True, 95000, 5))
NUMPY_CASES = (seeds("uniform", False, 96000, 5)
               + seeds("stratified", False, 97000, 5)
               + seeds("regex", False, 98000, 5))


@pytest.mark.parametrize("mode,device_route,seed", STREAM_CASES)
def test_streamed_sweep_case(tmp_path, mode, device_route, seed):
    check(runners("torch"), tmp_path, mode, device_route, seed)


@pytest.mark.parametrize("mode,device_route,seed", NUMPY_CASES)
def test_numpy_backend_sweep_case(tmp_path, mode, device_route, seed):
    check(runners("numpy", stream=False), tmp_path, mode, device_route,
          seed)
