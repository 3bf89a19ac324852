"""The chain route past the TPU's caps, and its line count, on the CPU.

  * compile_chain's caps come from csrc/chain_scan.cu's limits
    (chain_kernel.fits: 127 classes, 32,767 positions, terms of
    MAX_TERM_LEN bytes, the shared bytes of a block): on every set that
    agrep_tpu compiles the port's program equals agrep_tpu's (each cube
    cover as the bytes it covers), under codepage folds; past the TPU's caps (97 and 127 classes, 3,000 and 20,000
    positions, 129- and 8,192-byte terms, classes without a small cube
    cover under the -i# class folds of codepages 437 and 8859-1) the
    port compiles, and chain_scan_reference
    and the CPU model of the kernel (tests/test_torch_chain_buckets.py)
    give the starts of a brute-force match; past the port's caps
    compile_chain gives None and device_program or the caps refuse;
  * lines_with_starts against agrep_tpu's np.searchsorted/np.unique form;
  * pure -c -f on the torch backend with AGREP_TORCH_DEVICE=cpu: one
    chain_scan a file, a line count from the plane, no start positions
    read back and no occurrence table, equal to agrep_tpu's numpy
    backend under -c, -c -i, several files and a file over
    AGREP_TORCH_STREAM_MB; -w -c -f and sets past the caps keep their
    routes.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

import agrep_tpu.api as j_api
from agrep_tpu.ops import chain_kernel as j_chain
from agrep_tpu.ops import scan as j_scan
from agrep_tpu_torch import codepage
import agrep_tpu_torch.api as t_api
from agrep_tpu_torch.compile import multi as t_multi
from agrep_tpu_torch.ops import chain_kernel as t_chain
from agrep_tpu_torch.ops import qgram_kernel as t_qgram
from agrep_tpu_torch.ops import scan as t_scan
from agrep_tpu_torch.runtime import mgrep as t_mgrep
from tests.test_torch_chain_buckets import kernel_model, starts
from tests.test_torch_mgrep import (SETS, _patterns_100, _patterns_600_wide,
                                    _write_corpus, port_form)


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


FOLDS = {
    "ident": ident_tr,
    "ascii_i": lambda: t_mgrep._fold_tr(True),
    "cp8859_ia": lambda: codepage.build_lut(8859, "a"),
    "cp8859_i#": lambda: codepage.build_lut(8859, "#"),
    "cp437_i#": lambda: codepage.build_lut(437, "#"),
}


# ---------------------------------------------------------------------
# compile_chain against agrep_tpu, and its caps
# ---------------------------------------------------------------------

@pytest.mark.parametrize("fold", ["cp8859_ia", "cp8859_i#", "cp437_i#"])
@pytest.mark.parametrize("name", list(SETS))
def test_compile_chain_equals_agrep_tpu_where_it_compiles(name, fold):
    """tests/test_torch_mgrep.py's sets under the codepage folds (that
    file holds them under the identity and the ASCII -i fold)."""
    tr = FOLDS[fold]()
    got = t_chain.compile_chain(SETS[name], tr)
    want = j_chain.compile_chain(SETS[name], tr)
    if want is not None:
        assert got == port_form(want)
    else:
        # past the TPU's caps the port compiles up to its own
        terms = [t for t in SETS[name] if t]
        classes = {int(tr[b]) for t in terms for b in t}
        distinct = {bytes(tr[np.frombuffer(t, np.uint8)]) for t in terms}
        inside = (len(classes) <= t_chain.MAX_CLASSES
                  and sum(map(len, distinct)) <= t_chain.MAX_POSITIONS
                  and max(map(len, terms)) <= t_chain.MAX_TERM_LEN)
        assert (got is not None) == inside


def test_caps_are_the_cuda_programs():
    """The term-length cap is the longest power of two whose program at
    the other caps fits the H100's 227 KB a block; a device with less
    shared memory takes less."""
    assert t_chain.MAX_CLASSES == 127 and t_chain.MAX_POSITIONS == 32767
    L = t_chain.MAX_TERM_LEN
    assert L == 8192
    big = (t_chain.MAX_CLASSES, t_chain.MAX_POSITIONS, t_chain.MAX_POSITIONS)
    assert t_chain.smem_bytes(*big, L) <= t_chain.HOPPER_SMEM_OPTIN
    assert t_chain.smem_bytes(*big, 2 * L) > t_chain.HOPPER_SMEM_OPTIN
    assert t_chain.fits(*big, L)
    assert not t_chain.fits(128, 300, 100, 8)
    assert not t_chain.fits(20, 32768, 100, 8)
    assert not t_chain.fits(20, 9000, 2, L + 1)
    assert not t_chain.fits(*big, L, smem=100 << 10)


def _word(rng, alphabet: bytes, n: int) -> bytes:
    return bytes(rng.choice(np.frombuffer(alphabet, np.uint8), n))


def _classes_terms(lo: int, hi: int, seed: int) -> list:
    """Terms of 2-7 bytes that hold every byte lo..hi - 1 once, a few
    one-byte terms among them."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(np.arange(lo, hi, dtype=np.uint8))
    cuts = np.cumsum(rng.integers(2, 8, hi - lo))
    terms = [bytes(c) for c in np.split(order, cuts[cuts < hi - lo])
             if len(c)]
    return terms + [bytes([lo + 1]), bytes([hi - 2])]


ALNUM = b"abcdefghijklmnopqrstuvwxyz0123456789"


def _positions_terms(n_terms: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return sorted({_word(rng, ALNUM, 10) for _ in range(n_terms)})


def _long_terms(L: int) -> list:
    rng = np.random.default_rng(L)
    return [_word(rng, b"xy", L), b"xyx", b"yy\x00"]


def _fold_terms(seed: int) -> list:
    """Words of letters, accented letters and digits: under -i# a
    letter's class is every letter of the codepage, which no small cube
    cover holds."""
    rng = np.random.default_rng(seed)
    alpha = b"aeiouAEIOUxyz19" + bytes(range(0xC0, 0xE0))
    return [_word(rng, alpha, int(k)) for k in rng.integers(2, 9, 40)]


PAST_TPU = {
    "97_classes": (lambda: _classes_terms(0, 97, 1), "ident", 5000),
    "127_classes": (lambda: _classes_terms(0, 127, 2), "ident", 5000),
    "101_classes_i": (lambda: _classes_terms(0, 127, 3), "ascii_i", 5000),
    "3000_positions": (lambda: _positions_terms(300, 4), "ident", 6000),
    "20000_positions": (lambda: _positions_terms(2000, 5), "ident", 9000),
    "term_129": (lambda: _long_terms(129), "ident", 5000),
    "term_8192": (lambda: _long_terms(8192), "ident", 20000),
    "cp437_i#": (lambda: _fold_terms(6), "cp437_i#", 6000),
    "cp8859_i#": (lambda: _fold_terms(7), "cp8859_i#", 6000),
}


def _text(terms, tr, n: int, seed: int) -> np.ndarray:
    """Random bytes of the terms' alphabet (and a few others), every
    term planted at a few places, some of them in another byte of the
    same class."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(bytes(sorted({b for t in terms for b in t}))
                          + b" \n\xff", np.uint8)
    s = rng.choice(alpha, n)
    inv = {}
    for b in range(256):
        inv.setdefault(int(tr[b]), []).append(b)
    for t in terms:
        if len(t) >= n:
            continue
        for at in rng.integers(0, n - len(t), 3):
            s[at:at + len(t)] = [rng.choice(inv[int(tr[b])]) for b in t]
    return s


def brute_starts(text: np.ndarray, terms, tr) -> np.ndarray:
    """Every position where some term's folded bytes equal the folded
    text's (bytes past the end read as 0), by set lookup."""
    lens = {}
    for t in terms:
        if t:
            lens.setdefault(len(t), set()).add(
                bytes(tr[np.frombuffer(t, np.uint8)]))
    pad = max(lens)
    ft = bytes(tr[np.concatenate([text, np.zeros(pad, np.uint8)])])
    return np.asarray([i for i in range(len(text))
                       if any(ft[i:i + L] in s for L, s in lens.items())],
                      dtype=np.int64)


@pytest.mark.parametrize("name", list(PAST_TPU))
def test_sets_past_the_tpu_caps_match_brute_force(name):
    make, fold, n = PAST_TPU[name]
    terms, tr = make(), FOLDS[fold]()
    assert j_chain.compile_chain(terms, tr) is None
    prog = t_chain.compile_chain(terms, tr)
    assert prog is not None
    p = t_chain.device_program(prog)
    text = _text(terms, tr, n, len(name))
    want = brute_starts(text, terms, tr)
    assert len(want) >= 3
    plane = t_chain.chain_scan_reference(torch.from_numpy(text), p)
    assert np.array_equal(starts(plane.numpy(), n), want)
    assert np.array_equal(kernel_model(text, p), plane.numpy())
    # the shorter texts of the kernel's edges, where the terms fit
    for m in (33, 4097):
        sub = text[:m].copy()
        got = t_chain.chain_scan_reference(torch.from_numpy(sub), p)
        assert np.array_equal(starts(got.numpy(), m),
                              brute_starts(sub, terms, tr)), m
        assert np.array_equal(kernel_model(sub, p, offset=m % 16),
                              got.numpy()), m


def test_sets_past_the_port_caps_compile_to_none():
    tr = ident_tr()
    for terms in ([b"x" * (t_chain.MAX_TERM_LEN + 1)],
                  _classes_terms(0, 128, 8),
                  _positions_terms(3300, 9)):
        assert t_chain.compile_chain(terms, tr) is None
    # a program the tables cannot hold is refused; one past the caps but
    # encodable runs its plain version on the CPU only
    wide = (tuple((b,) for b in range(128)),
            tuple((2 * i, 2 * i + 1) for i in range(64)),
            tuple(range(64)), 2)
    p = t_chain.device_program(wide)
    assert not t_chain.fits(p.n_cls, p.n_pos, p.n_terms, p.maxlen)
    text = np.arange(256, dtype=np.uint8)
    got = t_chain.chain_scan(torch.from_numpy(text), p)
    assert np.array_equal(starts(got.numpy(), 256), np.arange(0, 128, 2))
    many = (((0,), (1,)), tuple((0,) * 8 + (1,) * k for k in range(300)),
            tuple(range(300)), 307)
    with pytest.raises(ValueError, match="positions"):
        t_chain.device_program(many)


# ---------------------------------------------------------------------
# the line count
# ---------------------------------------------------------------------

def _lines_agrep_tpu(text: np.ndarray, pos: np.ndarray) -> int:
    """agrep_tpu/runtime/mgrep.py _first_match_count's device count."""
    if not len(pos):
        return 0
    nl = np.flatnonzero(text == 0x0A)
    return int(len(np.unique(np.searchsorted(nl, pos, side="right"))))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 4097])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0])
def test_lines_with_starts_equals_agrep_tpu(n, density):
    rng = np.random.default_rng(n + int(100 * density))
    text = rng.choice(np.frombuffer(b"ab\n", np.uint8), n)
    hit = rng.random(n) < density
    hit[0] = hit[0] or density == 1.0
    plane = t_chain.pack_bits(torch.from_numpy(hit))
    pos = np.flatnonzero(hit)
    got = t_chain.lines_with_starts(torch.from_numpy(text), plane)
    assert got == _lines_agrep_tpu(text, pos)
    assert (got > 0) == (len(pos) > 0)


# ---------------------------------------------------------------------
# pure -c -f on the device route
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("chain_caps")
    out = {"a": _write_corpus(d / "a.txt", 4000, seed=7),
           "b": _write_corpus(d / "b.txt", 3000, seed=8),
           "small": _write_corpus(d / "small.txt", 300, seed=9)}
    for name, pats in (("p100", _patterns_100()),
                       ("p600w", _patterns_600_wide())):
        path = d / (name + ".txt")
        path.write_bytes("".join(p + "\n" for p in pats).encode("latin-1"))
        out[name] = str(path)
    return out


def _run(api, argv):
    buf = io.BytesIO()
    ret = api.fileagrep(argv, output=buf)
    return buf.getvalue(), ret & 0xFF


@pytest.fixture
def calls(monkeypatch):
    """Calls of the kernel wrappers, of the line count and of whatever
    reads starts back or builds an occurrence table, in a port run."""
    seen = {}

    def wrap(mod, name):
        real = getattr(mod, name)

        def counted(*a, **k):
            seen[name] = seen.get(name, 0) + 1
            return real(*a, **k)
        monkeypatch.setattr(mod, name, counted)

    for mod, name in ((t_chain, "chain_scan"), (t_chain, "lines_with_starts"),
                      (t_chain, "plane_positions"),
                      (t_qgram, "qgram_filter"),
                      (t_multi, "qgram_occurrences"),
                      (t_mgrep.MgrepEngine, "_all_occurrences"),
                      (t_mgrep.MgrepEngine, "_first_match_occurrences")):
        wrap(mod, name)
    return seen


def _both(argv, calls):
    calls.clear()
    got = _run(t_api, argv)
    seen = dict(calls)
    assert got == _run(j_api, argv), argv
    return got, seen


COUNTS = {
    "c": (["-c"], ["a"]),
    "c_i": (["-c", "-i"], ["a"]),
    "c_files": (["-c"], ["a", "b", "small"]),
    "c_i_files": (["-c", "-i"], ["b", "a"]),
}


@pytest.mark.parametrize("stream_mb", [None, "0"], ids=["whole", "over_mb"])
@pytest.mark.parametrize("case", list(COUNTS))
def test_pure_count_counts_the_chain_starts(files, calls, monkeypatch,
                                            case, stream_mb):
    """One chain_scan and one line count for each file the device route
    takes (64 KiB or more), no start read back, no occurrence table;
    under 64 KiB the host pass counts.  Lines hold several starts: the
    corpus words repeat on a line and a third of the patterns are
    corpus words."""
    if stream_mb is not None:
        monkeypatch.setenv("AGREP_TORCH_STREAM_MB", stream_mb)
        monkeypatch.setenv("AGREP_TPU_STREAM_MB", stream_mb)
    flags, names = COUNTS[case]
    argv = flags + ["-f", files["p100"]] + [files[k] for k in names]
    (out, _rc), seen = _both(argv, calls)
    assert out
    n_dev = sum(1 for k in names if k != "small")
    assert seen.get("chain_scan") == n_dev, seen
    assert seen.get("lines_with_starts") == n_dev, seen
    for name in ("plane_positions", "qgram_occurrences", "qgram_filter",
                 "_all_occurrences", "_first_match_occurrences"):
        assert name not in seen, seen


def test_pure_count_lines_hold_several_starts(files):
    eng_terms = [p.encode() for p in _patterns_100()]
    prog = t_chain.compile_chain(eng_terms, ident_tr())
    text = np.fromfile(files["a"], dtype=np.uint8)
    plane = t_chain.chain_scan(torch.from_numpy(text),
                               t_chain.device_program(prog))
    pos = t_chain.plane_positions(plane, len(text))
    lines = _lines_agrep_tpu(text, pos)
    assert len(pos) > 2 * lines > 0


@pytest.mark.parametrize("flags", [["-w", "-c"], ["-w", "-c", "-i"]],
                         ids=["w_c", "w_c_i"])
def test_wordbound_count_keeps_the_occurrence_route(files, calls, flags):
    argv = flags + ["-f", files["p100"], files["a"]]
    _out, seen = _both(argv, calls)
    assert seen.get("chain_scan") == 1, seen
    assert seen.get("_all_occurrences") == 1, seen
    assert "lines_with_starts" not in seen, seen


def test_count_past_the_caps_keeps_the_qgram_route(files, calls):
    argv = ["-c", "-f", files["p600w"], files["a"]]
    _out, seen = _both(argv, calls)
    assert seen.get("qgram_filter") == 1, seen
    assert "chain_scan" not in seen and "lines_with_starts" not in seen


def test_count_of_a_boolean_keeps_its_route(files, calls):
    argv = ["-c", "alpha;kernel", files["a"]]
    _out, seen = _both(argv, calls)
    assert seen.get("chain_scan") == 1, seen
    assert "lines_with_starts" not in seen, seen
