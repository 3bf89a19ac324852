"""The port's CLI against agrep_tpu's, byte for byte, on the CPU.

agrep_tpu_torch.api.fileagrep / memagrep run on the torch backend with
AGREP_TORCH_DEVICE=cpu (the plain PyTorch mask machine and regex
lanes), and agrep_tpu.api.fileagrep / memagrep run in-process on their
exact numpy backend.  Stdout bytes and return codes must be equal: the
argv sets of tests/test_conformance_basic.py (single-pattern, BASELINE
configs 1-3) and the regex sets of tests/test_conformance_more.py
(BASELINE config 4's engine), files over the streaming threshold with
the chunked paths shrunk to run on them, and memagrep buffers.
"""

from __future__ import annotations

import io

import numpy as np
import pytest

import agrep_tpu.api as j_api
import agrep_tpu_torch.api as t_api
from agrep_tpu.ops import scan as j_scan
from agrep_tpu.options import AgrepError as JAgrepError
from agrep_tpu.runtime.output import OutputOverflow as JOverflow
from agrep_tpu_torch.ops import kernels as t_kernels
from agrep_tpu_torch.ops import renfa_kernel as t_renfa_kernel
from agrep_tpu_torch.ops import scan as t_scan
from agrep_tpu_torch.options import AgrepError as TAgrepError
from agrep_tpu_torch.runtime.output import OutputOverflow as TOverflow

from .corpus import make_corpus


@pytest.fixture(autouse=True)
def _backends():
    saved = (t_scan._BACKEND, t_scan._DEVICE, j_scan._BACKEND)
    t_scan.set_backend("torch")
    t_scan.set_device("cpu")
    j_scan.set_backend("numpy")
    yield
    t_scan._BACKEND, t_scan._DEVICE = saved[:2]
    j_scan.set_backend(saved[2])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp("torch_cli")))


def _run(api, err, overflow, argv, data=None):
    """(stdout bytes, exit code) as tests/oracle.py's run_ours_inproc."""
    buf = io.BytesIO()
    try:
        if data is None:
            ret = api.fileagrep(argv, output=buf)
        else:
            ret = api.memagrep(argv, data, output=buf)
    except err:
        return buf.getvalue(), 2
    except overflow:
        return buf.getvalue(), 255
    return buf.getvalue(), ret & 0xFF


def _both(argv, data=None):
    got = _run(t_api, TAgrepError, TOverflow, argv, data)
    want = _run(j_api, JAgrepError, JOverflow, argv, data)
    assert got == want, "port vs agrep_tpu for %r" % (argv,)
    return got


# tests/test_conformance_basic.py: (flags, pattern, files)
BASIC_FLAGS = [
    [], ["-c"], ["-n"], ["-b"], ["-i"], ["-v"], ["-l"], ["-h"], ["-s"],
    ["-c", "-v"], ["-n", "-i"], ["-q"], ["-u", "-n"],
]
EDGE = ["nonl.txt", "empty.txt", "onlynl.txt", "leadnl.txt",
        "longline.txt", "binaryish.txt"]
ARGV_SETS = (
    [(f, p, ["text.txt"]) for p in ["hello", "world", "zzz", "o", "Hello"]
     for f in BASIC_FLAGS]
    + [([k] + f, "matching", ["text.txt"]) for k in ["-1", "-2", "-3"]
       for f in [[], ["-c"], ["-n"], ["-i"], ["-v"]]]
    + [([], p, [e]) for p in ["hello", "line"] for e in EDGE]
    + [([], "hello", ["text.txt", "nonl.txt", "leadnl.txt"]),
       (["-c"], "hello", ["text.txt", "nonl.txt"]),
       (["-l"], "hello", ["text.txt", "nonl.txt", "empty.txt"]),
       (["-h"], "hello", ["text.txt", "nonl.txt"])]
    + [(f, p, [c]) for f in [["-w"], ["-w", "-c"], ["-x"], ["-x", "-c"]]
       for p, c in [("hello", "text.txt"), ("hello world", "repeats.txt")]]
    + [(["-d", "$$"], "hello", ["dollar.txt"]),
       (["-d", "$$", "-c"], "hello", ["dollar.txt"]),
       (["-d", "From "], "hello", ["mail.txt"]),
       (["-d", "From ", "-t"], "hello", ["mail.txt"])]
    + [(["-2", "-D2", "-I1", "-S1"], "matching", ["text.txt"]),
       (["-3", "-D2", "-I1", "-S1", "-w", "-i"], "matching", ["text.txt"])]
    + [([], "^hello", ["leadnl.txt"]), ([], "hello$", ["leadnl.txt"]),
       (["-n"], "^From", ["mail.txt"])]
)


@pytest.mark.parametrize(
    "flags,pattern,files", ARGV_SETS,
    ids=["%s_%s_%s" % ("".join(f) or "plain", p, "+".join(fs))
         for f, p, fs in ARGV_SETS])
def test_cli_matches_agrep_tpu(corpus, flags, pattern, files):
    _both(flags + [pattern] + [corpus[f] for f in files])


def _big_corpus(n_bytes, seed=11):
    """Lines of filler words, with the searched words planted sparsely."""
    rng = np.random.default_rng(seed)
    words = [b"the", b"quick", b"brown", b"pattern", b"search", b"world",
             b"lorem", b"ipsum", b"grep", b"string"]
    plants = [b"hello", b"matching", b"matchng", b"Approximate",
              b"aproximate", b"HELLO"]
    lines, total = [], 0
    while total < n_bytes:
        ws = [words[i] for i in rng.integers(0, len(words), 8)]
        if rng.integers(0, 40) == 0:
            ws[int(rng.integers(0, 8))] = plants[
                int(rng.integers(0, len(plants)))]
        lines.append(b" ".join(ws) + b"\n")
        total += len(lines[-1])
    return b"".join(lines)


STREAM_ARGVS = [
    ["-c", "hello"],                                        # config 1
    ["-1", "-n", "matching"],                               # config 2
    ["-3", "-D2", "-I1", "-S1", "-w", "-i", "approximate"],  # config 3
    ["hello"],
    ["-2", "-c", "matching"],
]


@pytest.mark.parametrize("argv", STREAM_ARGVS,
                         ids=["_".join(a) for a in STREAM_ARGVS])
def test_streamed_file_matches_agrep_tpu(tmp_path, monkeypatch, argv):
    """A file over the streaming threshold takes the chunked engines
    (search_stream_chunked, scan_event_list) in both packages."""
    path = tmp_path / "big.txt"
    path.write_bytes(_big_corpus(300_000))
    monkeypatch.setenv("AGREP_TORCH_STREAM_MB", "0")
    monkeypatch.setenv("AGREP_TPU_STREAM_MB", "0")
    monkeypatch.setattr(t_scan, "STREAM_CHUNK", 64 << 10)
    monkeypatch.setattr(j_scan, "STREAM_CHUNK", 64 << 10)
    calls = []
    real = t_kernels.mask_scan

    def counted(text, m, W, L):
        calls.append(text.numel())
        return real(text, m, W, L)

    monkeypatch.setattr(t_kernels, "mask_scan", counted)
    out, rc = _both(argv + [str(path)])
    assert rc > 0 and out
    assert len(calls) > 1 and max(calls) <= (64 << 10) + 1024, \
        "the chunked path did not run"


MEM_ARGVS = [["-c", "hello"], ["hello"], ["-1", "matching"],
             ["-n", "hello"], ["-1", "-n", "matching"],
             ["-2", "-c", "pattern"]]


@pytest.mark.parametrize("argv", MEM_ARGVS,
                         ids=["_".join(a) for a in MEM_ARGVS])
@pytest.mark.parametrize("name", ["text.txt", "mail.txt"])
def test_memagrep_matches_agrep_tpu(corpus, argv, name):
    with open(corpus[name], "rb") as f:
        data = b"\n" + f.read()
    _both(argv, data)


# tests/test_conformance_more.py: the regex argv sets, on its re.txt
REGEXES = ["ab*c", "a(b|d)c", ".bc", "colou|or", "gr[ae]y",
           "h(el)*lo", "[xh]b?c", "ab.*ld"]
RE_TXT = (b"abc def\nabd xyz\nxbc q\nhello world\nab\nabcabc\n"
          b"the colour gray\nthe color grey\nhomogenous mix\n")


@pytest.mark.parametrize("pat", REGEXES)
@pytest.mark.parametrize("flags", [[], ["-c"], ["-n"], ["-v"], ["-i"],
                                   ["-1"], ["-2"], ["-b"]],
                         ids=lambda f: "_".join(f) or "plain")
def test_regex_matches_agrep_tpu(tmp_path, pat, flags):
    path = tmp_path / "re.txt"
    path.write_bytes(RE_TXT)
    _both(flags + [pat, str(path)])


def _counted_renfa_lines(monkeypatch):
    calls = []
    real = t_renfa_kernel.renfa_lines

    def counted(text, starts, lens, m, init):
        calls.append(text.numel())
        return real(text, starts, lens, m, init)

    monkeypatch.setattr(t_renfa_kernel, "renfa_lines", counted)
    return calls


REGEX_P = "appro[a-z]*mat(e|ion)"           # BASELINE config 4's pattern
STREAM_REGEX_ARGVS = [
    (["-2", "-c", REGEX_P], True),         # config 4: the streamed count
    (["-2", "-n", REGEX_P], True),         # the streamed print
    (["-v", "-c", "h(el)*lo"], True),
    (["-b", "h(el)*lo"], True),
    (["-2", "-n", REGEX_P], False),        # the whole-file path
]


@pytest.mark.parametrize("argv,streamed", STREAM_REGEX_ARGVS,
                         ids=["_".join(a) + ("" if s else "_whole")
                              for a, s in STREAM_REGEX_ARGVS])
def test_streamed_regex_matches_agrep_tpu(tmp_path, monkeypatch, argv,
                                          streamed):
    """A regex file over 49152 bytes (the re() block-overrun glitch
    byte) through the chunked regex engine, or its whole-file path,
    in both packages; every verdict of the port comes from
    renfa_lines."""
    data = _big_corpus(300_000)
    path = tmp_path / "big.txt"
    path.write_bytes(data)
    mb = "0" if streamed else "8"
    monkeypatch.setenv("AGREP_TORCH_STREAM_MB", mb)
    monkeypatch.setenv("AGREP_TPU_STREAM_MB", mb)
    monkeypatch.setattr(t_scan, "STREAM_CHUNK", 64 << 10)
    monkeypatch.setattr(j_scan, "STREAM_CHUNK", 64 << 10)
    calls = _counted_renfa_lines(monkeypatch)
    out, rc = _both(argv + [str(path)])
    assert rc > 0 and out
    if streamed:
        assert len(calls) > 1 and max(calls) <= (64 << 10) + 1024, \
            "the chunked regex path did not run"
    else:
        # one upload: the sentinel newline, the file, the glitch byte
        assert calls == [len(data) + 2]


REGEX_MEM_ARGVS = [["-c", "ab*c"], ["ab*c"], ["-1", "-n", "h(el)*lo"],
                   ["-2", "-c", REGEX_P], ["-v", "-n", "colou|or"],
                   ["-1", "-b", "a(b|d)c"]]


@pytest.mark.parametrize("argv", REGEX_MEM_ARGVS,
                         ids=["_".join(a) for a in REGEX_MEM_ARGVS])
@pytest.mark.parametrize("lead", [b"\n", b"", b"abc and hello\n"],
                         ids=["nl", "none", "line"])
def test_regex_memagrep_matches_agrep_tpu(monkeypatch, argv, lead):
    """Memory mode, with its virtual leading line: the lines and the
    leading line both go through renfa_lines."""
    calls = _counted_renfa_lines(monkeypatch)
    _both(argv, lead + RE_TXT)
    assert len(calls) == 2


def test_regex_five_errors_is_a_late_error(tmp_path):
    path = tmp_path / "re.txt"
    path.write_bytes(RE_TXT)
    out, rc = _both(["-5", "abc(d|e)fgh", str(path)])
    assert rc != 0
