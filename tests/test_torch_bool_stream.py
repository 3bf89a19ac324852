"""The streamed boolean (an AND or a tree over a file past
AGREP_TORCH_STREAM_MB, printed or counted) against agrep_tpu, byte for
byte, on the CPU.

With AGREP_TORCH_STREAM_MB=0 / AGREP_TPU_STREAM_MB=0 and STREAM_CHUNK at
64 KiB in both packages, every file here takes the boolean's
search_stream_chunked in chunks.  The port runs on its torch backend (the
plain PyTorch versions of chain_scan, qgram_filter and line_terms,
AGREP_TORCH_DEVICE=cpu) and on its numpy backend (one host find a term a
chunk); agrep_tpu on its numpy backend.  Stdout and exit code must be
equal, on:

  * an AND of 2 and of 4 terms, a tree with ~, 16 terminals, -i and -c,
    within the chain caps and past them (a term of bytes 0x80-0xFF: the
    q-gram filter's plane, its anchors p_size - 1 past their starts);
  * a term across a chunk seam; a line whose terms lie on both sides of a
    seam (its mask carried across it); a line whose one occurrence starts
    in the previous chunk's halo; a file without a final newline; a file
    of 4 * 32768 + 1 bytes (no EOF rescan, a last chunk of one byte); two
    files (the file name prefix, a count a file).

The route is fixed by the backend, the query and the file's size, and the
tests hold it: on the torch backend no host find, and one plane
(chain_scan, or qgram_filter past the caps) and one line_terms a chunk,
the short last chunk included; on the numpy backend one host find a term
a chunk and no kernel.  With no CUDA device, or a launch that fails, the
streamed boolean raises.
"""

from __future__ import annotations

import io
import os

import numpy as np
import pytest
import torch

import agrep_tpu.api as j_api
from agrep_tpu.ops import scan as j_scan
import agrep_tpu_torch.api as t_api
from agrep_tpu_torch.ops import chain_kernel as t_chain
from agrep_tpu_torch.ops import qgram_kernel as t_qgram
from agrep_tpu_torch.ops import scan as t_scan
from agrep_tpu_torch.runtime import mgrep as t_mgrep
from agrep_tpu_torch.runtime import trace

from .torch_oracle import one_thread

CHUNK = 1 << 16

FILLER = [b"the", b"quick", b"brown", b"fox", b"jumps", b"over", b"lazy",
          b"dog", b"lorem", b"ipsum", b"grep", b"string"]
PLANTED = [b"kappa", b"lambda", b"engine", b"omega"]
# a term of 130 byte classes, past the chain kernel's 127
WIDE = b"wq" + bytes(range(0x80, 0x100))
PLANTS = PLANTED + [b"KAPPA", b"Omega", WIDE]
SIXTEEN = ([b"kappa", b"lambda", b"engine", b"omega"]
           + [b"absent%02d" % i for i in range(11)] + [b"lazy"])


def _arg(b: bytes) -> str:
    """A pattern argument as the CLI gets raw bytes."""
    return os.fsdecode(b)


QUERIES = {
    "and2": ["kappa;omega"],
    "and4": ["kappa;lambda;engine;omega"],
    "tree": ["{kappa,lambda};~omega"],
    "sixteen": [_arg(b"{" + b",".join(SIXTEEN[:15]) + b"};~" + SIXTEEN[15])],
    "wide_tree": [_arg(b"{kappa,lambda};~" + WIDE)],
    "wide_and": [_arg(b"omega;" + WIDE)],
}
WIDE_QUERIES = ("wide_tree", "wide_and")


def _fill(rng, length: int, plants=()) -> bytes:
    """length bytes of lines of filler words ending in a newline; with
    plants, one line in about 12 holds one or two of them, and one in
    about 60 all four planted terms."""
    out = bytearray()
    while len(out) < length:
        k = int(rng.integers(3, 9))
        words = [FILLER[i] for i in rng.integers(0, len(FILLER), k)]
        if plants and rng.random() < 0.08:
            for _ in range(int(rng.integers(1, 3))):
                words[int(rng.integers(0, k))] = plants[
                    int(rng.integers(0, len(plants)))]
        if plants and rng.random() < 0.015:
            words += list(PLANTED)
        out += b" ".join(words) + b"\n"
    del out[length:]
    out[-1:] = b"\n"
    return bytes(out)


def _corpora(name: str, seed: int = 5) -> list:
    """The files of a scenario, as bytes."""
    rng = np.random.default_rng(seed)
    if name == "plain":
        return [_fill(rng, 150_000, PLANTS)]
    if name == "seam_term":
        # "kappa" starts 3 bytes before the first seam, beside "omega"
        return [_fill(rng, CHUNK - 46) + b"omega " + b"q" * 37
                + b"kappa tail\n" + _fill(rng, 80_000, PLANTS)]
    if name == "halo_only":
        # the line begins before the seam; its one "omega" starts 2 bytes
        # after it, inside the first chunk's halo
        return [_fill(rng, CHUNK - 36) + b"kappa " + b"r" * 32 + b"omega z\n"
                + _fill(rng, 80_000, PLANTS)]
    if name == "line_across":
        # a line of ~20 KB across the second seam, its terms on both sides
        return [_fill(rng, 2 * CHUNK - 900, PLANTS) + b"s" * 400
                + b" kappa lambda " + b"t" * 20_000 + b" engine omega end\n"
                + _fill(rng, 30_000, PLANTS)]
    if name == "no_final_newline":
        return [_fill(rng, 150_000, PLANTS) + b"last kappa and omega"]
    if name == "rescan_1":
        # 4 * 32768 + 1 bytes, the last one no newline: no EOF rescan
        body = _fill(rng, 4 * 32768 - 20, PLANTS) + b"x kappa omega\n"
        body += b"z" * (4 * 32768 - len(body))
        return [body[:-1] + b"\n" + b"k"]
    if name == "two_files":
        return [_fill(rng, 140_000, PLANTS), _fill(rng, 100_000, PLANTS)]
    raise KeyError(name)


SCENARIOS = ["plain", "seam_term", "halo_only", "line_across",
             "no_final_newline", "rescan_1", "two_files"]
# (scenario, query, flags)
CASES = ([(s, k, f) for s in SCENARIOS for k in ("and2", "tree", "wide_tree")
          for f in ([], ["-c"])]
         + [("plain", k, f) for k in ("and4", "sixteen", "wide_and")
            for f in ([], ["-c"], ["-i"])]
         + [("plain", k, ["-i"]) for k in ("and2", "tree", "wide_tree")]
         + [("line_across", "and4", []), ("two_files", "and4", ["-i"])])


@pytest.fixture(autouse=True)
def _stream(monkeypatch):
    """Both packages stream every file in 64 KiB chunks; the port on the
    CPU (the plain versions), agrep_tpu on its numpy backend; counters on;
    all restored afterwards."""
    saved = (t_scan._BACKEND, t_scan._DEVICE, j_scan._BACKEND)
    monkeypatch.setenv("AGREP_TORCH_STREAM_MB", "0")
    monkeypatch.setenv("AGREP_TPU_STREAM_MB", "0")
    monkeypatch.setattr(t_scan, "STREAM_CHUNK", CHUNK)
    monkeypatch.setattr(j_scan, "STREAM_CHUNK", CHUNK)
    monkeypatch.setattr(trace, "ENABLED", True)
    t_scan.set_device("cpu")
    j_scan.set_backend("numpy")
    with one_thread():
        yield
    t_scan._BACKEND, t_scan._DEVICE = saved[:2]
    j_scan.set_backend(saved[2])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("bool_stream")
    out = {}
    for s in SCENARIOS:
        out[s] = []
        for i, data in enumerate(_corpora(s)):
            path = d / ("%s_%d.txt" % (s, i))
            path.write_bytes(data)
            out[s].append(str(path))
    return out


@pytest.fixture
def calls(monkeypatch):
    """Calls of the host find and of the kernel wrappers during a port
    run."""
    seen = {}

    def wrap(mod, name):
        real = getattr(mod, name)

        def counted(*a, **k):
            seen[name] = seen.get(name, 0) + 1
            return real(*a, **k)
        monkeypatch.setattr(mod, name, counted)

    for mod, name in ((t_mgrep, "_find_occurrences"),
                      (t_chain, "chain_scan"), (t_chain, "line_terms"),
                      (t_qgram, "qgram_filter"), (t_qgram, "qgram_lines")):
        wrap(mod, name)
    return seen


def _run(api, argv):
    buf = io.BytesIO()
    ret = api.fileagrep(argv, output=buf)
    return buf.getvalue(), ret & 0xFF


def test_the_queries_sit_where_the_routes_need_them():
    from agrep_tpu_torch.compile import boolean
    tr = np.arange(256, dtype=np.uint8)
    for k, (pattern,) in QUERIES.items():
        split = boolean.split_pattern(pattern)
        terms = [os.fsencode(t) for t in split.terminals]
        fits = t_chain.compile_chain(terms, tr) is not None
        assert fits == (k not in WIDE_QUERIES), k
        assert len(terms) == (16 if k == "sixteen" else len(terms))
    assert len(boolean.split_pattern(QUERIES["sixteen"][0]).terminals) == 16


def test_the_scenarios_cover_their_edges():
    (seam,) = _corpora("seam_term")
    assert seam.index(b"kappa") == CHUNK - 3
    (halo,) = _corpora("halo_only")
    at = halo.index(b"omega")
    begin = halo.rindex(b"\n", 0, at) + 1
    assert at == CHUNK + 2 and begin < CHUNK
    assert b"kappa" in halo[begin:at]
    (across,) = _corpora("line_across")
    begin = across.rindex(b"\n", 0, 2 * CHUNK) + 1
    end = across.index(b"\n", 2 * CHUNK)
    line = across[begin:end]
    assert begin < 2 * CHUNK and len(line) > 20_000
    assert begin + line.index(b"lambda") < 2 * CHUNK
    assert begin + line.index(b"engine") > 2 * CHUNK
    (nonl,) = _corpora("no_final_newline")
    assert not nonl.endswith(b"\n")
    (r1,) = _corpora("rescan_1")
    assert len(r1) == 4 * 32768 + 1 and r1[-1:] != b"\n"
    assert all(len(f) > t_mgrep.DEVICE_MIN for s in SCENARIOS
               for f in _corpora(s))
    (plain,) = _corpora("plain")
    assert WIDE in plain and b"kappa lambda engine omega" in plain


@pytest.mark.parametrize("backend", ["torch", "numpy"])
@pytest.mark.parametrize("scenario,name,flags", CASES,
                         ids=["%s-%s%s" % (s, k, "".join(f))
                              for s, k, f in CASES])
def test_streamed_boolean_matches_agrep_tpu(files, calls, backend, scenario,
                                            name, flags):
    paths = files[scenario]
    argv = flags + QUERIES[name] + paths
    t_scan.set_backend(backend)
    calls.clear()
    for k in ("bool_stream_chunks", "line_terms", "line_terms_rows"):
        trace.counters.pop(k, None)
    got = _run(t_api, argv)
    seen = dict(calls)
    assert got == _run(j_api, argv), argv
    assert got[0]
    want = sum(-(-os.path.getsize(p) // CHUNK) for p in paths)
    assert trace.counters.get("bool_stream_chunks", 0) == want
    if backend == "torch":
        plane = "qgram_filter" if name in WIDE_QUERIES else "chain_scan"
        assert seen.get(plane) == want, seen
        assert seen.get("line_terms") == want, seen
        assert trace.counters.get("line_terms") == want
        for k in ("_find_occurrences", "qgram_lines", "chain_scan",
                  "qgram_filter"):
            if k != plane:
                assert k not in seen, seen
        printed = 0 if "-c" in flags else got[0].count(b"\n")
        assert trace.counters.get("line_terms_rows", 0) <= printed
    else:
        live = len(QUERIES[name][0].replace("{", "").replace("}", "")
                   .replace("~", "").replace(",", ";").split(";"))
        assert seen.get("_find_occurrences") == want * live, seen
        for k in ("line_terms", "chain_scan", "qgram_filter"):
            assert k not in seen, seen


def test_no_card_raises(files):
    """The default device with no CUDA card: the streamed boolean raises
    and prints nothing; it never finishes on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    t_scan.set_backend("torch")
    t_scan.set_device("cuda")
    buf = io.BytesIO()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_api.fileagrep(QUERIES["and2"] + [files["plain"][0]], output=buf)
    assert buf.getvalue() == b""


@pytest.mark.parametrize("name,kernel", [
    ("and2", (t_chain, "line_terms")), ("and2", (t_chain, "chain_scan")),
    ("wide_tree", (t_chain, "line_terms")),
    ("wide_tree", (t_qgram, "qgram_filter"))],
    ids=["line_terms", "chain_scan", "wide-line_terms", "qgram_filter"])
def test_a_failed_launch_raises(files, monkeypatch, name, kernel):
    """A launch that fails in a chunk raises out of the boolean: no chunk
    falls back to the host find."""
    t_scan.set_backend("torch")
    finds = []
    real_find = t_mgrep._find_occurrences

    def find(*a):
        finds.append(a)
        return real_find(*a)

    def fail(*a, **k):
        raise RuntimeError("launch failed")
    monkeypatch.setattr(t_mgrep, "_find_occurrences", find)
    monkeypatch.setattr(kernel[0], kernel[1], fail)
    with pytest.raises(RuntimeError, match="launch failed"):
        _run(t_api, QUERIES[name] + [files["plain"][0]])
    assert not finds
