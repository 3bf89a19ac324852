"""The streamed flat-OR print (-f over a file past AGREP_TORCH_STREAM_MB)
against agrep_tpu, byte for byte, on the CPU.

With AGREP_TORCH_STREAM_MB=0 / AGREP_TPU_STREAM_MB=0 and STREAM_CHUNK at
64 KiB in both packages, every file here takes search_stream_chunked's
print in chunks.  The port runs on its torch backend (the plain PyTorch
versions of chain_scan, qgram_filter and qgram_lines, AGREP_TORCH_DEVICE=
cpu) and on its numpy backend (the native qgram_first_per_line); agrep_tpu
on its numpy backend (one host find a term a chunk).  Stdout and exit
code must be equal, on:

  * term sets within the chain caps and past them (byte classes 0x80-0xFF
    in most terms), each with 24 or more terms and with fewer, and -i;
  * a term that straddles a chunk seam; a line across a seam whose only
    occurrence starts in the halo; a long line across a seam whose
    occurrences lie on both sides; a line longer than a chunk (the
    precheck sends that file to the whole-file walk); a file without a
    final newline; a file of 4 * 32768 + 1 bytes (no EOF rescan, a last
    chunk of one byte); two files (the file name prefix).

The route is fixed by the backend, the set and the file's size, and the
tests hold it: on the torch backend no host find, and one chain_scan or
qgram_lines a chunk (the short last chunk included); on the numpy backend
with 24 or more terms one qgram_first_per_line a chunk and no host find.
That one first winner a line is enough is held directly too: on seeded
texts cut at random seams, the lines holding a start below the seam are
the same from every start as from each line's first winner.  With no CUDA
device, or a launch that fails, the streamed print raises.
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
from agrep_tpu_torch import native as t_native
from agrep_tpu_torch.compile.query import compile_query
from agrep_tpu_torch.ops import chain_kernel as t_chain
from agrep_tpu_torch.ops import qgram_kernel as t_qgram
from agrep_tpu_torch.ops import scan as t_scan
from agrep_tpu_torch.options import parse_args
from agrep_tpu_torch.runtime import mgrep as t_mgrep
from agrep_tpu_torch.runtime import trace

from .torch_oracle import one_thread

CHUNK = 1 << 16

FILLER = [b"the", b"quick", b"brown", b"fox", b"jumps", b"over", b"lazy",
          b"dog", b"lorem", b"ipsum", b"grep", b"string"]
PLANTED = [b"kappa", b"lambda", b"engine", b"kernel9", b"deltas", b"omega"]
# what the corpus plants: -i folds the upper-case ones onto terms
PLANTS = PLANTED + [b"KAPPA", b"Engine"]
# the longest term: a halo of 42 bytes
LONG_ABSENT = b"nosuch-" + b"long" * 9


def _wide(n: int) -> list:
    """n absent terms that together hold every byte 0x80-0xFF."""
    k = -(-128 // n)
    return [b"wq" + bytes(0x80 + (j * k + t) % 128 for t in range(k))
            + b"%d" % (j % 10) for j in range(n)]


SETS = {
    "caps_many": PLANTED + [LONG_ABSENT]
    + [b"nosuch%02d" % i for i in range(23)],
    "caps_few": PLANTED[:3] + [LONG_ABSENT],
    "wide_many": PLANTED + [LONG_ABSENT] + _wide(23),
    "wide_few": PLANTED[:3] + [LONG_ABSENT] + _wide(8),
}


def _fill(rng, length: int, plants=()) -> bytes:
    """length bytes of lines of filler words ending in a newline; with
    plants, one line in about 20 holds one of them."""
    out = bytearray()
    while len(out) < length:
        k = int(rng.integers(3, 9))
        words = [FILLER[i] for i in rng.integers(0, len(FILLER), k)]
        if plants and rng.random() < 0.05:
            words[int(rng.integers(0, k))] = plants[
                int(rng.integers(0, len(plants)))]
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
        # "kappa" starts 3 bytes before the first seam, alone on its line
        return [_fill(rng, CHUNK - 40) + b"q" * 37 + b"kappa tail\n"
                + _fill(rng, 80_000, PLANTS)]
    if name == "halo_only":
        # the line begins before the seam; its one occurrence starts 2
        # bytes after it, inside the first chunk's halo
        return [_fill(rng, CHUNK - 30) + b"r" * 32 + b"omega z\n"
                + _fill(rng, 80_000, PLANTS)]
    if name == "long_line_across":
        # a line of ~20 KB across the second seam, "lambda" on both sides
        return [_fill(rng, 2 * CHUNK - 900, PLANTS) + b"s" * 400
                + b" lambda " + b"t" * 20_000 + b" lambda end\n"
                + _fill(rng, 30_000, PLANTS)]
    if name == "line_past_a_chunk":
        # 70,000 bytes without a newline: the precheck's clamped residue
        return [_fill(rng, 10_000, PLANTS) + b"u" * 35_000 + b" engine "
                + b"u" * 35_000 + b"\n" + _fill(rng, 60_000, PLANTS)]
    if name == "no_final_newline":
        return [_fill(rng, 150_000, PLANTS) + b"last line with deltas"]
    if name == "rescan_1":
        # 4 * 32768 + 1 bytes, the last one no newline: no EOF rescan
        body = _fill(rng, 4 * 32768 - 20, PLANTS) + b"x kappa omega\n"
        body += b"z" * (4 * 32768 - len(body))
        return [body[:-1] + b"\n" + b"k"]
    if name == "two_files":
        return [_fill(rng, 140_000, PLANTS), _fill(rng, 100_000, PLANTS)]
    raise KeyError(name)


SCENARIOS = ["plain", "seam_term", "halo_only", "long_line_across",
             "line_past_a_chunk", "no_final_newline", "rescan_1",
             "two_files"]
# (scenario, set, flags)
CASES = ([(s, k, []) for s in SCENARIOS for k in ("caps_many", "wide_many")]
         + [("plain", "caps_few", []), ("plain", "wide_few", []),
            ("plain", "caps_many", ["-i"]), ("plain", "wide_many", ["-i"])])


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
    d = tmp_path_factory.mktemp("stream_print")
    out = {}
    for s in SCENARIOS:
        out[s] = []
        for i, data in enumerate(_corpora(s)):
            path = d / ("%s_%d.txt" % (s, i))
            path.write_bytes(data)
            out[s].append(str(path))
    for k, terms in SETS.items():
        path = d / ("%s.pat" % k)
        path.write_bytes(b"".join(t + b"\n" for t in terms))
        out[k] = str(path)
    return out


@pytest.fixture
def calls(monkeypatch):
    """Calls of the host find, of the kernel wrappers and of the native
    first-per-line pass during a port run."""
    seen = {}

    def wrap(mod, name):
        real = getattr(mod, name)

        def counted(*a, **k):
            seen[name] = seen.get(name, 0) + 1
            return real(*a, **k)
        monkeypatch.setattr(mod, name, counted)

    for mod, name in ((t_mgrep, "_find_occurrences"),
                      (t_chain, "chain_scan"), (t_qgram, "qgram_lines"),
                      (t_qgram, "qgram_filter"),
                      (t_native, "qgram_first_per_line")):
        wrap(mod, name)
    return seen


def _run(api, argv):
    buf = io.BytesIO()
    ret = api.fileagrep(argv, output=buf)
    return buf.getvalue(), ret & 0xFF


def test_the_sets_sit_where_the_routes_need_them():
    tr = np.arange(256, dtype=np.uint8)
    for k, terms in SETS.items():
        fits = t_chain.compile_chain(terms, tr) is not None
        assert fits == k.startswith("caps"), k
        many = len(terms) >= t_mgrep.ONE_PASS_MIN
        assert many == k.endswith("many"), k
        assert max(map(len, terms)) == len(LONG_ABSENT)


def test_the_scenarios_cover_their_edges():
    (seam,) = _corpora("seam_term")
    assert seam.index(b"kappa") == CHUNK - 3
    (halo,) = _corpora("halo_only")
    at = halo.index(b"omega")
    begin = halo.rindex(b"\n", 0, at) + 1
    assert at == CHUNK + 2 and begin < CHUNK
    assert at + len(b"omega") <= CHUNK + len(LONG_ABSENT) - 1
    (long_,) = _corpora("long_line_across")
    begin = long_.rindex(b"\n", 0, 2 * CHUNK) + 1
    end = long_.index(b"\n", 2 * CHUNK)
    line = long_[begin:end]
    assert begin > 2 * CHUNK - 1025 and len(line) > 20_000
    assert begin + line.index(b"lambda") < 2 * CHUNK
    assert begin + line.rindex(b"lambda") > 2 * CHUNK
    (past,) = _corpora("line_past_a_chunk")
    assert max(map(len, past.split(b"\n"))) > CHUNK
    (nonl,) = _corpora("no_final_newline")
    assert not nonl.endswith(b"\n")
    (r1,) = _corpora("rescan_1")
    assert len(r1) == 4 * 32768 + 1 and r1[-1:] != b"\n"
    assert all(len(f) > t_mgrep.DEVICE_MIN for s in SCENARIOS
               for f in _corpora(s))


@pytest.mark.parametrize("backend", ["torch", "numpy"])
@pytest.mark.parametrize("scenario,name,flags", CASES,
                         ids=["%s-%s%s" % (s, k, "".join(f))
                              for s, k, f in CASES])
def test_streamed_print_matches_agrep_tpu(files, calls, backend, scenario,
                                          name, flags):
    paths = files[scenario]
    argv = flags + ["-f", files[name]] + paths
    t_scan.set_backend(backend)
    calls.clear()
    trace.counters.pop("stream_print_chunks", None)
    got = _run(t_api, argv)
    seen = dict(calls)
    assert got == _run(j_api, argv), argv
    assert got[0]
    chunks = trace.counters.get("stream_print_chunks", 0)
    if scenario == "line_past_a_chunk":
        # the precheck's clamped residue: the whole-file walk prints it
        assert chunks == 0
        return
    want = sum(-(-os.path.getsize(p) // CHUNK) for p in paths)
    assert chunks == want
    many = name.endswith("many")
    if backend == "torch":
        if name.startswith("caps"):
            assert seen.get("chain_scan") == want, seen
            assert "qgram_lines" not in seen, seen
        elif many:
            assert seen.get("qgram_lines") == want, seen
            assert seen.get("qgram_filter") == want, seen
            assert "chain_scan" not in seen, seen
        else:
            # past the caps with fewer than 24 terms: one find a term
            assert seen.get("_find_occurrences") == want * len(
                SETS[name]), seen
            return
        assert "_find_occurrences" not in seen, seen
        assert "qgram_first_per_line" not in seen, seen
    elif many:
        assert seen.get("qgram_first_per_line") == want, seen
        assert "_find_occurrences" not in seen, seen
    else:
        assert "qgram_first_per_line" not in seen, seen
        assert seen.get("_find_occurrences") == want * len(SETS[name]), seen
    if backend == "numpy":
        for k in ("chain_scan", "qgram_lines", "qgram_filter"):
            assert k not in seen, seen


def _engine(terms, nocase=False):
    opts, pattern, _ = parse_args(
        (["-i"] if nocase else [])
        + ["-m", "".join(t.decode("latin-1") + "\n" for t in terms), "x"])
    return t_mgrep.MgrepEngine(compile_query(pattern, opts))


def _lines_below(text: np.ndarray, starts: np.ndarray, g1: int) -> set:
    """The ends of the lines of text that hold a start below g1."""
    nl = np.flatnonzero(text == 0x0A)
    s = starts[starts < g1]
    return set(np.searchsorted(nl, s, side="left").tolist())


@pytest.mark.parametrize("backend", ["torch", "numpy"])
@pytest.mark.parametrize("name", ["wide_many", "caps_many"])
@pytest.mark.parametrize("nocase", [False, True], ids=["exact", "i"])
def test_first_winner_per_line_is_enough(name, backend, nocase):
    """Over regions [g0, g1 + maxlen - 1) of seeded texts, the lines that
    hold a start below g1 are the same from the streamed print's source
    (chain_scan's starts; each line's first winner from qgram_lines, or
    from the native pass on the host) as from every start."""
    terms = SETS[name]
    eng = _engine(terms, nocase)
    maxlen = max(map(len, terms))
    t_scan.set_backend(backend)
    rng = np.random.default_rng(len(name) + 2 * nocase)
    text = np.frombuffer(_fill(rng, 200_000, PLANTS + [
        t for t in terms if len(t) < 20]), dtype=np.uint8)
    text = text.copy()
    # plant occurrences right at and around the cuts
    cuts = sorted(rng.integers(1, len(text) - 100, 12).tolist())
    for c in cuts:
        t = terms[int(rng.integers(0, 6))]
        at = c - int(rng.integers(0, len(t) + 2))
        text[at:at + len(t)] = np.frombuffer(t, np.uint8)
    first = eng._region_starts(len(text))
    checked = 0
    for g0, g1 in zip([0] + cuts, cuts + [len(text)]):
        region = np.ascontiguousarray(text[g0:min(g1 + maxlen - 1,
                                                  len(text))])
        starts = np.concatenate([t_mgrep._find_occurrences(region, t,
                                                           eng.tr)
                                 for t in terms])
        want = _lines_below(region, starts, g1 - g0)
        got = _lines_below(region, first(region), g1 - g0)
        assert got == want, (g0, g1)
        checked += len(want)
    assert checked > 50


def test_no_card_raises(files):
    """The default device with no CUDA card: the streamed print raises and
    prints nothing; it never finishes on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    t_scan.set_backend("torch")
    t_scan.set_device("cuda")
    buf = io.BytesIO()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_api.fileagrep(["-f", files["wide_many"], files["plain"][0]],
                        output=buf)
    assert buf.getvalue() == b""


@pytest.mark.parametrize("name,kernel", [("caps_many", (t_chain,
                                                       "chain_scan")),
                                         ("wide_many", (t_qgram,
                                                        "qgram_lines"))],
                         ids=["chain_scan", "qgram_lines"])
def test_a_failed_launch_raises(files, monkeypatch, name, kernel):
    """A launch that fails in a chunk raises out of the print: no chunk
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
        _run(t_api, ["-f", files[name], files["plain"][0]])
    assert not finds
