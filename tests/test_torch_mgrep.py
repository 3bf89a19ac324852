"""The port's multi-pattern engine against agrep_tpu, bit for bit, on the CPU.

  * kernel modules: agrep_tpu_torch's chain_match_starts and
    qgram_candidates (the plain versions, on CPU tensors) against
    agrep_tpu's Pallas chain and q-gram kernels run in interpret mode, on
    the shapes of tests/test_chain_kernel.py and
    tests/test_multi_onepass.py; compile_chain's program (agrep_tpu's,
    each cube cover as the bytes it covers) and its None past the
    port's caps;
  * the wrapper: a CPU tensor runs the plain version, text and program
    on different devices raise;
  * the CLI: agrep_tpu_torch.api on the torch backend with
    AGREP_TORCH_DEVICE=cpu against agrep_tpu.api on its numpy backend, in
    process (as tests/test_torch_cli.py): -f with 100 and 600 patterns
    on a corpus over the device route's 64 KiB (the chain route), -d
    '$$', 600 patterns of 128 or more byte classes (past the chain caps:
    the q-gram route), -m through memagrep, boolean 'a;b', 'a,b' and a
    {..}~ tree, with a 136-byte term (the chain route) and with a term
    of 137 classes (the mask machine); a spy shows which kernel wrapper
    each route reached.

Every comparison is exact: these are integer machines.  The CUDA kernels
themselves are held against their plain versions by chip_smoke.py on the
GPU.
"""

from __future__ import annotations

import io
import os
import random
import string

import numpy as np
import pytest
import torch

import agrep_tpu.api as j_api
from agrep_tpu.compile.multi import build_qgram_tables as j_tables
from agrep_tpu.compile.multi import member_projection_1024 as j_proj
from agrep_tpu.ops import chain_kernel as j_chain
from agrep_tpu.ops import qgram_kernel as j_qgram
from agrep_tpu.ops import scan as j_scan
from agrep_tpu.options import AgrepError as JAgrepError
from agrep_tpu.runtime.output import OutputOverflow as JOverflow
import agrep_tpu_torch.api as t_api
from agrep_tpu_torch.compile import multi as t_multi
from agrep_tpu_torch.ops import chain_kernel as t_chain
from agrep_tpu_torch.ops import kernels as t_kernels
from agrep_tpu_torch.ops import qgram_kernel as t_qgram
from agrep_tpu_torch.ops import scan as t_scan
from agrep_tpu_torch.options import AgrepError as TAgrepError
from agrep_tpu_torch.runtime import mgrep as t_mgrep
from agrep_tpu_torch.runtime.output import OutputOverflow as TOverflow


@pytest.fixture(autouse=True)
def _backends():
    saved = (t_scan._BACKEND, t_scan._DEVICE, j_scan._BACKEND)
    t_scan.set_backend("torch")
    t_scan.set_device("cpu")
    j_scan.set_backend("numpy")
    yield
    t_scan._BACKEND, t_scan._DEVICE = saved[:2]
    j_scan.set_backend(saved[2])


def ident_tr():
    return np.arange(256, dtype=np.uint8)


def fold_tr():
    tr = np.arange(256, dtype=np.uint8)
    tr[65:91] += 32
    return tr


def _u8(b: bytes) -> np.ndarray:
    return np.frombuffer(b, dtype=np.uint8).copy()


def port_form(prog):
    """agrep_tpu's chain program in the port's form: each class's cube
    cover as the bytes it covers, ascending (None stays None)."""
    if prog is None:
        return None
    eq_specs, term_specs, term_ids, maxlen = prog
    classes = tuple(tuple(b for b in range(256)
                          if any(b & m == v for m, v in cubes))
                    for cubes in eq_specs)
    return classes, term_specs, term_ids, maxlen


# ---------------------------------------------------------------------
# the chain kernel
# ---------------------------------------------------------------------

def _chain_small():
    rng = np.random.default_rng(0)
    words = [b"the", b"quick", b"brown", b"fox", b"jumps"]
    s = b" ".join(words[i] for i in rng.integers(0, 5, 400))
    return _u8(s), [b"quick", b"fox", b"jumps over", b"q"], ident_tr()


def _chain_folded():
    return (_u8(b"The QUICK brown the thE fox Quick "), [b"the", b"quick"],
            fold_tr())


def _chain_lanes():
    """Terms planted across the TPU kernel's 4096-byte lane edges."""
    L = j_chain.LANE_BODY
    n = 2 * L + 100
    s = np.full(n, ord("x"), dtype=np.uint8)
    term = b"boundary_term_123456789012345"
    for edge in (L, 2 * L):
        for off in range(-len(term), 1, 7):
            if 0 <= edge + off and edge + off + len(term) <= n:
                s[edge + off:edge + off + len(term)] = _u8(term)
    return s, [term, b"zz"], ident_tr()


def _chain_long(lens):
    """Terms of the given lengths (lookahead 1, 2 and 4 words on the
    TPU), planted in a two-letter text, with -i folding."""
    def make():
        rng = np.random.default_rng(sum(lens))
        s = rng.choice(_u8(b"abAB \n"), 9000)
        terms = []
        for i, L in enumerate(lens):
            t = bytes(rng.choice(_u8(b"abAB"), L))
            terms.append(t)
            for off in rng.integers(0, len(s) - L, 3):
                s[off:off + L] = _u8(t.swapcase() if i % 2 else t)
        return s, terms, fold_tr()
    return make


def _chain_bytes():
    rng = np.random.default_rng(3)
    s = rng.integers(0, 256, 12000).astype(np.uint8)
    return s, [bytes(s[100:103]), bytes(s[5000:5009]), b"\x00\xff",
               bytes([10, 10]), bytes([0xE9, 0xC9])], ident_tr()


def _chain_edges(n):
    def make():
        rng = np.random.default_rng(n)
        return (rng.choice(_u8(b"abc \n"), n), [b"ab", b"c a", b"\na"],
                ident_tr())
    return make


def _chain_tail():
    """A term whose last bytes are NUL runs past the text's end: bytes
    past N read as 0."""
    s = _u8(b"xxab" * 10 + b"ab")
    return s, [b"ab\x00\x00", b"b\x00", b"xa"], ident_tr()


def _chain_hundred():
    rng = np.random.default_rng(7)
    vocab = [bytes(rng.integers(97, 123, int(rng.integers(3, 12)))
                   .astype(np.uint8)) for _ in range(100)]
    s = b" ".join(vocab[i] for i in rng.integers(0, 100, 1500))
    return _u8(s), vocab, ident_tr()


CHAIN_CASES = {
    "small": _chain_small, "folded": _chain_folded, "lanes": _chain_lanes,
    "look2": _chain_long([31, 32, 33, 64]), "look4": _chain_long([65, 128]),
    "full_bytes": _chain_bytes, "tail_nul": _chain_tail,
    "hundred": _chain_hundred,
    **{"n%d" % n: _chain_edges(n) for n in (1, 31, 32, 33, 4095, 4096, 4097)},
}


@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_chain_starts_equal_pallas_interpret(case):
    stream, terms, tr = CHAIN_CASES[case]()
    prog = t_chain.compile_chain(terms, tr)
    j_prog = j_chain.compile_chain(terms, tr)
    assert prog is not None
    assert prog == port_form(j_prog)
    want = j_chain.chain_match_starts(stream, j_prog, interpret=True)
    got = t_chain.chain_match_starts(torch.from_numpy(stream), prog)
    assert got.dtype == np.int64
    assert np.array_equal(got, want)
    if case in ("small", "folded", "lanes", "full_bytes", "tail_nul",
                "look2", "look4"):
        assert len(want) > 0


ONE_CUBE = [bytes([97 + (i % 26)]) * 30 for i in range(100)]
SETS = {
    "x32": [b"x" * 32], "x128": [b"x" * 128], "x129": [b"x" * 129],
    "3000_positions": ONE_CUBE,
    "2400_positions": ONE_CUBE[:80],
    "97_classes": [bytes([c]) for c in range(97)],
    "96_classes": [bytes([c]) for c in range(96)],
    "empty_slots": [b"", b"ab", b""],
    # past the port's caps (chain_kernel.fits), under either fold
    "x8193": [b"x" * 8193],
    "128_classes": [bytes([c]) for c in range(128, 256)],
    "32768_positions": [b"%07d\x80" % i for i in range(4096)],
}
PAST_TPU_CAPS = ("x129", "3000_positions", "97_classes", "x8193",
                 "128_classes", "32768_positions")
PAST_PORT_CAPS = ("x8193", "128_classes", "32768_positions")


@pytest.mark.parametrize("name", list(SETS))
@pytest.mark.parametrize("fold", [False, True], ids=["ident", "fold"])
def test_compile_chain_equals_agrep_tpu(name, fold):
    """Where agrep_tpu compiles a set the port's program equals its;
    past the TPU's caps the port compiles up to its own."""
    tr = fold_tr() if fold else ident_tr()
    got = t_chain.compile_chain(SETS[name], tr)
    want = j_chain.compile_chain(SETS[name], tr)
    assert (want is None) == (name in PAST_TPU_CAPS)
    assert (got is None) == (name in PAST_PORT_CAPS)
    if want is not None:
        assert got == port_form(want)


def test_chain_device_program_and_wrapper():
    prog = t_chain.compile_chain([b"ab", b"ab", b"Ab", b"b"], fold_tr())
    p = t_chain.device_program(prog)
    assert p.n_terms == 2 and p.n_pos == 3     # "ab" (= "Ab") and "b"
    assert int(p.class_of[ord("A")]) == int(p.class_of[ord("a")])
    assert int(p.class_of[ord("z")]) == t_chain.NO_CLASS
    plane = t_chain.chain_scan(torch.from_numpy(_u8(b"xAbab")), p)
    assert plane.dtype == torch.int32 and plane.shape == (1,)
    assert int(plane[0]) == 0b11110
    with pytest.raises(ValueError, match="empty"):
        t_chain.chain_scan(torch.zeros(0, dtype=torch.uint8), p)
    with pytest.raises(TypeError):
        t_chain.chain_scan(torch.zeros(4, dtype=torch.int32), p)
    meta = t_chain.device_program(prog, "meta")
    with pytest.raises(ValueError, match="program on meta"):
        t_chain.chain_scan(torch.from_numpy(_u8(b"ab")), meta)


# ---------------------------------------------------------------------
# the q-gram kernel
# ---------------------------------------------------------------------

def _qgram_case(n_terms, tlen, nocase, seed):
    rng = np.random.default_rng(seed)
    alpha = b"abcdEFgh \n"
    terms = [bytes(alpha[i] for i in rng.integers(0, 8, int(
        rng.integers(*tlen)))) for _ in range(n_terms)]
    stream = _u8(bytes(alpha[i] for i in
                       rng.integers(0, len(alpha), 20000)))
    for t in terms[:8]:
        off = int(rng.integers(0, len(stream) - len(t)))
        stream[off:off + len(t)] = _u8(t)
    return stream, terms, t_mgrep._fold_tr(nocase)


QGRAM_CASES = {
    "two_gram": (30, (2, 6), False, 42),
    "long": (60, (4, 10), False, 43),       # multilen > 400: LONG tables
    "nocase": (40, (3, 8), True, 44),
}


@pytest.mark.parametrize("case", list(QGRAM_CASES))
def test_qgram_candidates_equal_pallas_interpret(case):
    stream, terms, tr = _qgram_case(*QGRAM_CASES[case])
    tb = t_multi.build_qgram_tables(terms, tr)
    assert bool(tb.long_) == (case == "long")
    proj = t_multi.member_projection_1024(tb)
    assert np.array_equal(proj, j_proj(j_tables(terms, tr)))
    want = j_qgram.qgram_candidates(stream, proj, interpret=True)
    for n in (len(stream), 4097, 33, 1):
        got = t_qgram.qgram_candidates(torch.from_numpy(stream[:n]), proj)
        assert np.array_equal(got, want[want < n]), n
    # the candidates feed the sparse verify to the host filter's table
    cand = want - (tb.p_size - 1)
    got = t_multi.qgram_occurrences(stream, terms, tr, tb,
                                    cand_anchor_rel=cand)
    full = t_multi.qgram_occurrences(stream, terms, tr, tb)
    for i in range(len(terms)):
        assert np.array_equal(got[i], full[i]), (i, terms[i])


@pytest.mark.parametrize("wordbound", [False, True], ids=["plain", "w"])
@pytest.mark.parametrize("case", list(QGRAM_CASES))
def test_native_verify_of_qgram_candidates(case, wordbound, monkeypatch):
    """The q-gram route verifies the kernel's candidates in the native
    pass: its table equals the host filter's, and its winner per anchor
    the numpy _verify_at's; -w runs it in parallel slices."""
    from agrep_tpu_torch import native
    from agrep_tpu_torch.compile.query import compile_query
    from agrep_tpu_torch.options import parse_args
    assert native.get_lib() is not None
    if wordbound:
        monkeypatch.setattr(native, "OCC_AT_PAR_MIN", 1)
    stream, terms, _tr = _qgram_case(*QGRAM_CASES[case])
    flags = ((["-i"] if case == "nocase" else [])
             + (["-w"] if wordbound else []))
    opts, pattern, _ = parse_args(
        flags + ["-m", "".join(t.decode() + "\n" for t in terms), "x"])
    eng = t_mgrep.MgrepEngine(compile_query(pattern, opts))
    tb = t_multi.build_qgram_tables(eng.terms, eng.tr)
    anchors = t_qgram.qgram_candidates(
        torch.from_numpy(stream), t_multi.member_projection_1024(tb))
    anchors = anchors[anchors >= tb.p_size - 1]
    got = eng._occ_from_pairs(*eng._verified_at(stream, tb, anchors),
                              tb.p_size)
    full = t_multi.qgram_occurrences(stream, eng.terms, eng.tr, tb)
    assert sum(len(v) for v in full.values()) > 0
    for i in range(len(eng.terms)):
        assert np.array_equal(got[i], full[i]), (i, eng.terms[i])
    assert np.array_equal(eng._verify_native(stream, tb, anchors),
                          eng._verify_at(stream, tb, anchors))


def test_qgram_member_words_and_wrapper():
    member = np.zeros(1024, dtype=bool)
    member[(1 << 5) | 2] = member[(31 << 5) | 31] = True
    assert t_qgram.member_words(member) == j_qgram.member_words(member)
    words = t_qgram.words_tensor(member)
    assert words.dtype == torch.int32 and int(words[31]) == -(1 << 31)
    # 'a' (1) after 'b' (2), then 0x7f (31) after 0xff (31)
    plane = t_qgram.qgram_filter(torch.from_numpy(_u8(b"ba\xff\x7f")),
                                 words)
    assert int(plane[0]) == 0b1010
    with pytest.raises(TypeError):
        t_qgram.qgram_filter(torch.from_numpy(_u8(b"ab")), words.long())


# ---------------------------------------------------------------------
# the CLI, port against agrep_tpu
# ---------------------------------------------------------------------

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "Theta",
         "iota", "kappa", "Lambda", "search", "pattern", "match", "engine",
         "kernel", "device"]


def _write_corpus(path, n_lines, blank_every=0, seed=7):
    """tests/test_multi_onepass.py's corpus; with blank_every a blank
    line after every blank_every-th line (records for -d '$$')."""
    rnd = random.Random(seed)
    lines = []
    for k in range(n_lines):
        lines.append(" ".join(rnd.choices(WORDS, k=rnd.randint(3, 9))))
        if blank_every and k % blank_every == blank_every - 1:
            lines.append("")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _patterns_100():
    """tests/test_multi_onepass.py's 100-pattern file."""
    rnd = random.Random(11)
    pats = []
    for i in range(100):
        r = i % 3
        if r == 0:
            pats.append(rnd.choice(WORDS))
        elif r == 1:
            pats.append("nosuch%03d" % i)
        else:
            pats.append(rnd.choice(WORDS)[:3] + rnd.choice(WORDS)[-3:])
    return pats


def _patterns_600():
    """tests/test_multi_onepass.py's 600-pattern file: 3,600 term
    positions, past the TPU chain kernel's 2,400 and within the port's
    caps."""
    rnd = random.Random(3)
    words = ["alpha", "beta", "kernel", "device", "zeta"]
    pats = [rnd.choice(words) for _ in range(10)]
    return pats + ["qz" + rnd.choice(words) + str(i % 97)
                   for i in range(590)]


def _patterns_600_wide():
    """The 600 patterns with a byte 0x80-0xFF in each of the 590 absent
    ones: 128 classes more than the letters and digits, past the chain
    kernel's 127."""
    pats = _patterns_600()
    return pats[:10] + [p[:2] + chr(0x80 + i % 128) + p[2:]
                        for i, p in enumerate(pats[10:])]


@pytest.fixture(scope="module")
def mp(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mgrep")
    files = {
        "corpus": _write_corpus(d / "corpus.txt", 4000),
        "records": _write_corpus(d / "records.txt", 4000, blank_every=11),
    }
    for name, pats in (("p100", _patterns_100()), ("p600", _patterns_600()),
                       ("p600w", _patterns_600_wide())):
        (d / (name + ".txt")).write_bytes(
            "".join(p + "\n" for p in pats).encode("latin-1"))
        files[name] = str(d / (name + ".txt"))
    return files


def _run(api, err, overflow, argv, data=None):
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


@pytest.fixture
def spy(monkeypatch):
    """Counts of calls into each kernel wrapper during a port run."""
    calls = {"chain_scan": 0, "qgram_filter": 0, "mask_scan": 0}
    for mod, name in ((t_chain, "chain_scan"), (t_qgram, "qgram_filter"),
                      (t_kernels, "mask_scan")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(mod, name, counted)
    return calls


def _both(argv, spy, route, data=None):
    """Port and agrep_tpu on one argv; the port's run must reach the
    kernel wrapper `route` and no other (none when route is None)."""
    for k in spy:
        spy[k] = 0
    got = _run(t_api, TAgrepError, TOverflow, argv, data)
    reached = {k for k, v in spy.items() if v}
    want = _run(j_api, JAgrepError, JOverflow, argv, data)
    assert got == want, "port vs agrep_tpu for %r" % (argv,)
    assert reached == ({route} if route else set()), (argv, spy)
    return got


# tests/test_multi_onepass.py's flag list of its 100-pattern conformance
FLAGS_100 = [[], ["-c"], ["-n"], ["-b"], ["-i"], ["-w"], ["-P"],
             ["-v", "-c"], ["-c", "-v", "-i"], ["-l"], ["-P", "-w"]]


@pytest.mark.parametrize("flags", FLAGS_100,
                         ids=["_".join(f) or "plain" for f in FLAGS_100])
def test_100_patterns_take_the_chain_route(mp, spy, flags):
    # -f and -n are refused before any scan, in both packages
    route = None if "-n" in flags else "chain_scan"
    out, rc = _both(flags + ["-f", mp["p100"], mp["corpus"]], spy, route)
    assert out


@pytest.mark.parametrize("flags", [[], ["-c"], ["-P"], ["-i", "-c"]],
                         ids=["plain", "c", "P", "i_c"])
def test_records_take_the_chain_route(mp, spy, flags):
    """BASELINE config 5's shape: -f with 100 patterns over '$$'
    records."""
    _both(flags + ["-d", "$$", "-f", mp["p100"], mp["records"]], spy,
          "chain_scan")


@pytest.mark.parametrize("flags", [["-c"], ["-P"], ["-d", "$$"]],
                         ids=["c", "P", "d"])
def test_600_patterns_take_the_qgram_route(mp, spy, flags):
    """Past the chain caps (154 classes) 24 or more terms take the
    q-gram kernel."""
    assert t_chain.compile_chain(
        [p.encode("latin-1") for p in _patterns_600_wide()],
        ident_tr()) is None
    corpus = mp["records"] if "-d" in flags else mp["corpus"]
    _both(flags + ["-f", mp["p600w"], corpus], spy, "qgram_filter")


@pytest.mark.parametrize("flags", [["-c"], ["-P"], ["-d", "$$"]],
                         ids=["c", "P", "d"])
def test_600_patterns_take_the_chain_route(mp, spy, flags):
    """3,600 term positions, past the TPU caps, take the chain kernel."""
    corpus = mp["records"] if "-d" in flags else mp["corpus"]
    _both(flags + ["-f", mp["p600"], corpus], spy, "chain_scan")


@pytest.mark.parametrize("argv", [["-c"], [], ["-d", "$$"]],
                         ids=["c", "plain", "d"])
def test_memagrep_pattern_buffer(mp, spy, argv):
    """-m: the patterns in a buffer, searched in memory mode."""
    with open(mp["records"], "rb") as f:
        data = b"\n" + f.read()
    pats = "\n".join(_patterns_100()) + "\n"
    _both(argv + ["-m", pats], spy, "chain_scan", data)


BOOLEANS = [["-c", "alpha;kernel"], ["alpha,zeta"],
            ["-c", "{alpha,beta};~kernel"], ["-d", "$$", "delta;iota"],
            ["{search;match},~Theta"]]
BOOL_IDS = ["and_c", "or", "tree_c", "and_d", "tree"]


@pytest.mark.parametrize("argv", BOOLEANS, ids=BOOL_IDS)
def test_booleans_take_the_chain_route(mp, spy, argv):
    """A boolean's few terms take the chain kernel, as every term set
    within its caps does on the device route."""
    corpus = mp["records"] if "-d" in argv else mp["corpus"]
    _both(argv + [corpus], spy, "chain_scan")


def _with_term(term):
    return [["-c", "alpha;kernel," + term], ["alpha,zeta," + term],
            ["-c", "{alpha,beta};~" + term],
            ["-d", "$$", "delta;iota," + term],
            ["{search;match},~Theta," + term]]


# a term of 136 bytes, past the TPU chain kernel's 128, in each boolean
LONG_TERM = "kernel" + "q" * 130
# a term of 137 classes, past the chain kernel's 127: the argument as
# the CLI gets raw bytes 0xA0-0xFF from the command line
WIDE_TERM = os.fsdecode((string.ascii_uppercase + string.digits).encode()
                        + bytes(range(0xA0, 0x100)))
WIDE_TERM = "kernel" + WIDE_TERM


@pytest.mark.parametrize("argv", _with_term(LONG_TERM), ids=BOOL_IDS)
def test_booleans_with_a_long_term_take_the_chain_route(mp, spy, argv):
    corpus = mp["records"] if "-d" in argv else mp["corpus"]
    _both(argv + [corpus], spy, "chain_scan")


@pytest.mark.parametrize("argv", _with_term(WIDE_TERM), ids=BOOL_IDS)
def test_booleans_take_the_mask_machine(mp, spy, argv):
    """Past the chain caps a boolean's short terms take the mask
    machine's packed term words (the long one the native single-term
    search)."""
    assert t_chain.compile_chain([os.fsencode(WIDE_TERM)],
                                 ident_tr()) is None
    corpus = mp["records"] if "-d" in argv else mp["corpus"]
    _both(argv + [corpus], spy, "mask_scan")


def test_small_stream_stays_on_the_host(tmp_path, spy):
    """Under 64 KiB the engine runs its host passes on either
    backend."""
    path = _write_corpus(tmp_path / "small.txt", 300)
    pf = tmp_path / "p.txt"
    pf.write_text("".join(p + "\n" for p in _patterns_100()))
    for argv in (["-c", "-f", str(pf), path], ["-c", "alpha;kernel", path]):
        _both(argv, spy, None)


def test_numpy_backend_matches_agrep_tpu(mp, spy):
    t_scan.set_backend("numpy")
    for argv in (["-c", "-f", mp["p100"], mp["corpus"]],
                 ["-d", "$$", "-f", mp["p600"], mp["records"]],
                 ["-d", "$$", "-f", mp["p600w"], mp["records"]]):
        got = _run(t_api, TAgrepError, TOverflow, argv)
        assert got == _run(j_api, JAgrepError, JOverflow, argv), argv
    assert not any(spy.values()), spy
