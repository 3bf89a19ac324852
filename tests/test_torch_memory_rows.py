"""The bitap engine's memory mode (memagrep, search_buffer) on the torch
backend, on the CPU.

A machine that is not sticky takes its records from the scan:
scan_record_verdicts runs mask_scan and record_verdicts over the
caller's buffer (one zero byte appended where its length is odd, the
pair-unrolled loop's overrun; no prefilled newline, no EOF delimiter,
no glitch byte), and BitapEngine._walk_memory walks the rows of the
records that fire as the per-byte loop (_memory_search_loop) walks its
delimiter events.  Held here against agrep_tpu.api.memagrep on its
numpy backend, whose memory mode is that loop, case by case: odd and
even buffers, a leading delimiter, no leading newline, no final
delimiter, delimiters alone, an empty buffer; -l, -c, -b, -v and AND
with -v; the cost wiring; D from 0 to 8; one-byte and multi-byte -d.
The port's numpy backend takes the same walk over the native scan's
events, and is held to the same cases.
"""

from __future__ import annotations

import io

import numpy as np
import pytest

import agrep_tpu.api as j_api
from agrep_tpu.ops import scan as j_scan
import agrep_tpu_torch.api as t_api
from agrep_tpu_torch.compile.query import compile_query as t_compile
from agrep_tpu_torch.ops import kernels as t_kernels
from agrep_tpu_torch.ops import scan as t_scan
from agrep_tpu_torch.options import parse_args as t_parse
from agrep_tpu_torch.runtime import engine as t_engine

from .torch_oracle import one_thread


@pytest.fixture(autouse=True)
def _backends():
    """Port on the plain PyTorch versions (CPU), reference on its exact
    numpy backend; both restored afterwards."""
    saved = (t_scan._BACKEND, t_scan._DEVICE, j_scan._BACKEND)
    t_scan.set_backend("torch")
    t_scan.set_device("cpu")
    j_scan.set_backend("numpy")
    with one_thread():
        yield
    t_scan._BACKEND, t_scan._DEVICE = saved[:2]
    j_scan.set_backend(saved[2])


WORDS = [b"hello", b"matching", b"matchng", b"alpha", b"zz", b"koala",
         b"abcdefghijkl", b"abcdxfghijkl", b"the", b"fox", b"oo"]


def _body(seed: int, n: int, delim: bytes) -> bytes:
    """n bytes of words, each record ended by delim (now and then two)."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        k = int(rng.integers(1, 7))
        out += b" ".join(WORDS[i] for i in rng.integers(0, len(WORDS), k))
        out += delim * int(rng.integers(1, 3)) if rng.random() < 0.85 \
            else b" "
    return bytes(out[:n])


def _buffer(kind: str, delim: bytes, seed: int) -> bytes:
    """The buffer of each shape (delim: the machine's delimiter bytes;
    '$$' is '\\n\\n' to the machine)."""
    if kind == "empty":
        return b""
    if kind == "only_delims":
        return delim * 7
    if kind == "even":
        return b"\n" + _body(seed, 2999, delim)
    if kind == "odd":
        data = b"\n" + _body(seed, 3000, delim)
        return data if len(data) & 1 else data + b"x"
    if kind == "leading_delim":
        return delim + _body(seed, 2000, delim)
    if kind == "no_leading_newline":
        return b"hello " + _body(seed, 2000, delim)
    if kind == "no_final_delim":
        return (b"\n" + _body(seed, 2000, delim)).rstrip(delim) \
            + b" matching tail"
    raise ValueError(kind)


KINDS = ["even", "odd", "leading_delim", "no_leading_newline",
         "no_final_delim", "only_delims", "empty"]

# (name, argv, the machine's delimiter bytes)
CASES = [
    ("plain_sgrep", ["matching"], b"\n"),
    ("k1_n", ["-1", "-n", "matching"], b"\n"),
    ("c", ["-1", "-n", "-c", "matching"], b"\n"),
    ("l", ["-n", "-l", "hello"], b"\n"),
    ("b", ["-1", "-n", "-b", "matching"], b"\n"),
    ("v_n", ["-v", "-n", "hello"], b"\n"),
    ("and", ["-n", "hello;zz"], b"\n"),
    ("and_v", ["-v", "-n", "hello;zz"], b"\n"),
    ("and_v_k1", ["-1", "-v", "hello;zz"], b"\n"),
    ("or_c", ["-1", "-c", "alpha,koala"], b"\n"),
    ("costs", ["-2", "-D2", "-I1", "-S1", "-n", "matching"], b"\n"),
    ("d_dollar", ["-d", "$$", "-n", "hello"], b"\n\n"),
    ("d_dollar_k1_c", ["-1", "-d", "$$", "-n", "-c", "matchng"], b"\n\n"),
    ("d_o", ["-d", "o", "-n", "-1", "hello"], b"o"),
    ("d_o_v", ["-d", "o", "-v", "-n", "-b", "zz"], b"o"),
] + [("D%d" % D, ["-%d" % D, "-n", "abcdefghijkl"], b"\n")
     for D in range(9)]


def _engine(argv) -> str:
    opts, pattern, _ = t_parse(argv + ["x"])
    return t_compile(pattern, opts).engine_class


def _mem(api, argv, data):
    buf = io.BytesIO()
    rc = api.memagrep(argv, data, output=buf)
    return buf.getvalue(), rc & 0xFF


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,argv,delim", CASES,
                         ids=[c[0] for c in CASES])
def test_memory_rows_match_agrep_tpu(name, argv, delim, kind):
    """Both of the port's backends against agrep_tpu's loop."""
    data = _buffer(kind, delim, len(name))
    want = _mem(j_api, argv, data)
    for backend in ("torch", "numpy"):
        t_scan.set_backend(backend)
        assert _mem(t_api, argv, data) == want, (name, kind, backend)


def test_records_come_from_the_scan(monkeypatch):
    """On the torch backend a machine that is not sticky never runs the
    per-byte loop: one record_verdicts launch (its plain version here)
    a buffer, over the buffer and its overrun byte."""
    def refused(*a, **k):
        raise AssertionError("the torch route ran the per-byte loop")

    calls = []
    real = t_kernels.record_verdicts

    def counted(*args, **kw):
        calls.append(args[4])                 # N, the stream's bytes
        return real(*args, **kw)

    monkeypatch.setattr(t_engine.BitapEngine, "_memory_search_loop", refused)
    monkeypatch.setattr(t_kernels, "record_verdicts", counted)
    for name, argv, delim in CASES:
        for kind in ("even", "odd"):
            data = _buffer(kind, delim, 3)
            before = len(calls)
            assert _mem(t_api, argv, data) == _mem(j_api, argv, data), name
            if _engine(argv) == "bitap":
                assert calls[before:] == [len(data) + (len(data) & 1)], (
                    name, kind, calls[before:])
    assert sum(_engine(c[1]) == "bitap" for c in CASES) == len(CASES) - 1


def test_loop_is_the_route_of_a_sticky_multibyte_delimiter(monkeypatch):
    """A sticky machine with a multi-byte delimiter keeps the loop (its
    record events fire at the delimiter's subsequences); both routes
    agree with agrep_tpu."""
    calls = []
    real = t_engine.BitapEngine._memory_search_loop

    def counted(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)

    monkeypatch.setattr(t_engine.BitapEngine, "_memory_search_loop",
                        counted)
    data = _buffer("odd", b"\n\n", 4)
    for argv in (["-d", "$$", "-n", "h#o"], ["-p", "-d", "$$", "hlo"]):
        assert _mem(t_api, argv, data) == _mem(j_api, argv, data)
    assert len(calls) == 2
    for argv in (["-n", "h#o"], ["-n", "matching"]):
        assert _mem(t_api, argv, data) == _mem(j_api, argv, data)
    assert len(calls) == 2
