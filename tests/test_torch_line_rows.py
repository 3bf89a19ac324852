"""The regex engine's line index and verdict read-back on the scan
device, against numpy and agrep_tpu, exactly, on the CPU.

  * line_index: agrep_tpu_torch's line_index_reference (and the
    line_index wrapper, which takes it for a CPU tensor) against numpy's
    np.flatnonzero of the newlines and a stable np.argsort of the lengths'
    keys, on random texts and on the edge shapes: empty, no newline, a
    single newline, a leading newline, no final newline, lines past 8,192
    and past 49,152 bytes, and texts with a glitch byte inserted inside a
    line and before a newline; the key itself (exact below 128 bytes,
    sixteen steps an octave up to 8,191, one key past that);
  * line_rows: line_rows_reference (and the wrapper) against the numpy
    verdict walk of agrep_tpu's RegexEngine (runtime/regex_engine.py:
    verdicts ^ invert, the empty-first-line guard, the appended-newline
    guard, the rows from the newlines of the text without the glitch
    byte), counts and rows;
  * the wrappers' argument checks, and that a CPU tensor launches no
    kernel;
  * the CLI: config 4's pattern at -0 .. -4 with -c, -n, -b, -v -n and
    -i, memagrep (and the leading line's seed states on short
    machines), -l and -L, lines across a 49,152-byte block boundary (the
    residue clamp, at its 1,025-byte edge too), an empty first line at
    D > 0, a file with no
    final newline, and a chunk with no newline, through both packages
    (agrep_tpu on its numpy backend), byte for byte with the exit code,
    whole and streamed in 64 KiB chunks; and that the torch route builds
    no newline index or length sort on the host, indexes each chunk on
    the device once and reads back only the rows it prints.

Every value is an integer, so every comparison is exact.  The CUDA kernels
csrc/line_index.cu and csrc/line_rows.cu are held against their plain
versions by chip_smoke.py on the GPU.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

import agrep_tpu.api as j_api
from agrep_tpu.ops import scan as j_scan
import agrep_tpu_torch.api as t_api
from agrep_tpu_torch.ops import renfa_kernel as t_rk
from agrep_tpu_torch.ops import scan as t_scan
from agrep_tpu_torch.runtime import regex_engine as t_regex
from agrep_tpu_torch.runtime import trace as t_trace

from .torch_oracle import one_thread

BSR = 49152


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


# ---------------------------------------------------------------------
# line_index against numpy
# ---------------------------------------------------------------------

def np_key(lens: np.ndarray) -> np.ndarray:
    """The length order's key in numpy: the length below 128, then 16
    steps an octave (the four bits below the top one) up to 8,191, and
    224 from 8,192 on."""
    lens = np.asarray(lens, dtype=np.int64)
    top = np.floor(np.log2(np.maximum(lens, 1))).astype(np.int64)
    sub = (np.minimum(lens, 8191) >> np.maximum(top - 4, 0)) & 15
    key = np.where(lens < 128, lens, 128 + (top - 7) * 16 + sub)
    return np.where(lens >= 8192, 224, key)


def np_index(text: np.ndarray):
    """(newlines, starts, lens, ordinals in length order, last newline)
    by np.flatnonzero and a stable np.argsort."""
    nls = np.flatnonzero(text == 0x0A)
    starts = np.concatenate([[0], nls[:-1] + 1]).astype(np.int64)[:len(nls)]
    lens = nls - starts
    order = np.argsort(np_key(lens), kind="stable")
    return nls, starts[order], lens[order], order, \
        int(nls[-1]) if len(nls) else -1


def _random_text(n: int, seed: int, p_nl: float = 1 / 40) -> bytes:
    rng = np.random.default_rng(seed)
    t = rng.integers(32, 127, n, dtype=np.uint8)
    t[rng.random(n) < p_nl] = 0x0A
    return t.tobytes()


def _long_lines() -> bytes:
    """Short lines around lines of 127-129, 8,191-8,193, 49,153 and
    60,000 bytes."""
    rng = np.random.default_rng(3)
    parts = []
    for n in (5, 127, 128, 129, 0, 8191, 8192, 8193, 3, 49153, 0, 60000,
              7, 8192, 200, 100):
        parts.append(bytes(rng.integers(97, 123, n, dtype=np.uint8)) + b"\n")
    return b"".join(parts)


def _every_length() -> bytes:
    """One line of every length 0..600 in random order, twice."""
    rng = np.random.default_rng(4)
    lens = rng.permutation(np.r_[np.arange(601), np.arange(601)])
    return b"".join(b"y" * int(n) + b"\n" for n in lens)


TEXTS = {
    "empty": b"",
    "no_newline": b"abc def ghi",
    "one_newline": b"\n",
    "leading": b"\nabc\n\nxyz\n",
    "no_final": b"ab\ncd\n\nef",
    "only_newlines": b"\n" * 70,
    "random": _random_text(20000, 1),
    "random_dense": _random_text(3000, 2, 0.4),
    "long": _long_lines(),
    "every_length": _every_length(),
}


def _glitched(text: bytes, at: int) -> bytes:
    return text[:at] + b"\x00" + text[at:]


def _glitch_cases():
    """(name, text as scanned, glitch position or -1): every TEXTS entry
    as it is, and texts with the glitch byte inside a line and before a
    newline (the byte joins the line that newline ends)."""
    out = [(name, t, -1) for name, t in TEXTS.items()]
    r = TEXTS["random"]
    inside = next(i for i in range(7000, len(r)) if r[i] != 0x0A
                  and r[i - 1] != 0x0A)
    on_nl = r.index(b"\n", 9000)
    out.append(("glitch_inside", _glitched(r, inside), inside))
    out.append(("glitch_on_newline", _glitched(r, on_nl), on_nl))
    out.append(("glitch_line_start", _glitched(r, on_nl + 1), on_nl + 1))
    return out


GLITCH_CASES = _glitch_cases()


def _u8(b: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(b, np.uint8).copy())


@pytest.mark.parametrize("name,text,glitch", GLITCH_CASES,
                         ids=[c[0] for c in GLITCH_CASES])
def test_line_index_matches_numpy(name, text, glitch):
    arr = np.frombuffer(text, np.uint8)
    nls, starts, lens, order, last = np_index(arr)
    t = _u8(text)
    before = dict(t_rk.launches)
    for fn in (t_rk.line_index_reference, t_rk.line_index):
        idx = fn(t)
        for got, want in ((idx.nl, nls), (idx.starts, starts),
                          (idx.lens, lens), (idx.ords, order)):
            assert got.dtype == torch.int64
            assert got.tolist() == want.tolist()
        assert idx.last == last
    assert t_rk.launches == before
    # below 128 bytes the order is the stable sort by exact length
    if len(lens) and lens.max() < 128:
        assert order.tolist() == np.argsort(
            nls - np.r_[0, nls[:-1] + 1], kind="stable").tolist()


def test_len_key_orders_by_length():
    lens = np.arange(70000, dtype=np.int64)
    key = t_rk.len_key(torch.from_numpy(lens)).numpy()
    assert key.tolist() == np_key(lens).tolist()
    assert (np.diff(key) >= 0).all()
    assert key[:128].tolist() == list(range(128))
    assert (key[8192:] == t_rk.LEN_KEYS - 1).all()
    assert len(np.unique(key)) == t_rk.LEN_KEYS
    # the lengths of one key differ by at most 1/16 of the shortest
    for k in range(128, t_rk.LEN_KEYS - 1):
        ls = lens[key == k]
        assert ls.max() - ls.min() < ls.min() / 16 + 1


# ---------------------------------------------------------------------
# a model of csrc/line_index.cu's passes
# ---------------------------------------------------------------------

def index_model(text: np.ndarray, off: int, threads: int, rounds: int,
                round_lines: int):
    """csrc/line_index.cu's five passes on a text that starts `off` bytes
    past a 16-byte boundary, at a block of `threads` threads (whole warps)
    and `rounds` 16-byte pieces a thread (a warp's rounds * 32 pieces
    consecutive, a round's side by side), the scatter sorting
    `round_lines` lines a round: (nl, starts, lens, ords, last)."""
    n = len(text)
    warps, per_thread = threads // 32, round_lines // threads
    assert threads % 32 == 0 and round_lines % threads == 0
    if n == 0:                          # the wrapper launches nothing
        e = np.zeros(0, np.int64)
        return e, e, e, e, -1
    pieces = -(-(n + off) // 16)
    per_block = threads * rounds
    grid = -(-pieces // per_block)

    def piece_nl(g):
        """The text positions of piece g's newlines, in order."""
        return [16 * g + b - off for b in range(16)
                if 0 <= 16 * g + b - off < n and text[16 * g + b - off] == 10]

    # pass 1: each block's count and last newline
    counts = np.zeros(grid, np.int64)
    last = np.full(grid, -1, np.int64)
    for b in range(grid):
        for g in range(b * per_block, min((b + 1) * per_block, pieces)):
            ps = piece_nl(g)
            counts[b] += len(ps)
            if ps:
                last[b] = ps[-1]
    # pass 2: exclusive prefix sum and prefix max, K and the last newline
    offs = np.concatenate([[0], np.cumsum(counts)])
    prev = np.concatenate([[-1], np.maximum.accumulate(last)[:-1]])
    K, end = int(offs[-1]), int(max(last.max(), -1))
    nl = np.full(K, -7, np.int64)
    keys = np_key
    hist = np.zeros((t_rk.LEN_KEYS, grid), np.int64)
    # pass 3: a warp owns rounds * 32 consecutive pieces, a round's 32
    # side by side; the warps' totals and last newlines go across the
    # block, then each round's lanes scan theirs
    def warp_pieces(b, w, r):
        g0 = b * per_block + (w * rounds + r) * 32
        return [piece_nl(g) if g < pieces else [] for g in range(g0, g0 + 32)]

    for b in range(grid):
        wn = [sum(len(x) for r in range(rounds) for x in warp_pieces(b, w, r))
              for w in range(warps)]
        wl = [max([x[-1] for r in range(rounds) for x in warp_pieces(b, w, r)
                   if x] + [-1]) for w in range(warps)]
        for w in range(warps):
            base = int(offs[b]) + sum(wn[:w])
            carry = max([int(prev[b])] + wl[:w])
            for r in range(rounds):
                ps = warp_pieces(b, w, r)
                ns = np.array([len(x) for x in ps], np.int64)
                ls = np.array([x[-1] if x else -1 for x in ps], np.int64)
                first = base + np.cumsum(ns) - ns
                before = np.maximum(carry, np.concatenate(
                    [[-1], np.maximum.accumulate(ls)[:-1]]))
                for t in range(32):
                    o, p = int(first[t]), int(before[t])
                    for pos in ps[t]:
                        nl[o] = pos
                        hist[int(keys([pos - p - 1])[0]), b] += 1
                        o, p = o + 1, pos
                base += int(ns.sum())
                carry = max(carry, int(ls.max()))
    # pass 4: each key's row prefix and total
    slots = np.cumsum(hist, axis=1) - hist
    ktot = hist.sum(axis=1)
    kbase = np.cumsum(ktot) - ktot
    # pass 5: each block sorts its lines by key, round_lines at a time
    starts, lens, ords = (np.full(K, -7, np.int64) for _ in range(3))
    for b in range(grid):
        nxt = kbase + slots[:, b]
        for j0 in range(int(offs[b]), int(offs[b + 1]), round_lines):
            cnt = min(round_lines, int(offs[b + 1]) - j0)
            s_nl = [int(nl[j0 + i - 1]) if j0 + i - 1 >= 0 else -1
                    for i in range(cnt + 1)]
            key = np.full(round_lines, -1, np.int64)
            rank = np.zeros(round_lines, np.int64)
            wc = np.zeros((warps, t_rk.LEN_KEYS), np.int64)
            for w in range(warps):
                for st in range(per_thread):        # 32 lanes at a step
                    lis = [(w * per_thread + st) * 32 + ln for ln in range(32)]
                    for li in lis:
                        if li < cnt:
                            key[li] = keys([s_nl[li + 1] - s_nl[li] - 1])[0]
                    for li in lis:
                        if li < cnt:
                            k = key[li]
                            peers_below = sum(1 for x in lis if x < li
                                              and x < cnt and key[x] == k)
                            rank[li] = wc[w, k] + peers_below
                    for li in lis:
                        if li < cnt and not any(
                                x < li and x < cnt and key[x] == key[li]
                                for x in lis):
                            wc[w, key[li]] += sum(
                                1 for x in lis if x < cnt
                                and key[x] == key[li])
            tot = wc.sum(axis=0)
            wpre = np.cumsum(wc, axis=0) - wc
            kb = np.cumsum(tot) - tot
            s_sorted = np.full(cnt, -1, np.int64)
            for li in range(cnt):
                w = li // (per_thread * 32)
                pos = kb[key[li]] + wpre[w, key[li]] + rank[li]
                assert s_sorted[pos] == -1
                s_sorted[pos] = li
            for q in range(cnt):
                li = int(s_sorted[q])
                at = nxt[key[li]] + q - kb[key[li]]
                starts[at] = s_nl[li] + 1
                lens[at] = s_nl[li + 1] - s_nl[li] - 1
                ords[at] = j0 + li
            nxt = nxt + tot
    return nl, starts, lens, ords, end


def _model_texts():
    """(name, text) of the model's edge shapes at a 512-byte block (32
    threads, one piece each): lines that straddle blocks, a line longer
    than a block, every byte a newline (K = n), no newline, one key over
    many scatter rounds, and the TEXTS."""
    out = [(n, t) for n, t in TEXTS.items() if len(t) <= 4000]
    out += [("straddle", _random_text(3000, 7, 1 / 60)),
            ("longer_than_block", b"x" * 1500 + b"\n" + b"ab\n" * 40
             + b"y" * 1100 + b"\nz"),
            ("all_newlines", b"\n" * 1200),
            ("no_newline_long", b"q" * 1500),
            ("one_key_rounds", b"abcd\n" * 300)]
    return out


MODEL_TEXTS = _model_texts()


@pytest.mark.parametrize("off", [0, 1, 3, 15])
@pytest.mark.parametrize("name,text", MODEL_TEXTS,
                         ids=[m[0] for m in MODEL_TEXTS])
def test_index_model_equals_the_plain_version(name, text, off):
    """At a 512-byte block and 64 lines a scatter round; the text's start
    `off` bytes past a 16-byte boundary."""
    arr = np.frombuffer(text, np.uint8)
    want = t_rk.line_index_reference(_u8(text))
    got = index_model(arr, off, 32, 1, 64)
    for g, w in zip(got[:4], want[:4]):
        assert g.tolist() == w.tolist()
    assert got[4] == want.last


@pytest.mark.parametrize("geometry", [(64, 2, 128), (256, 16, 2048)],
                         ids=["two_warps", "kernel"])
@pytest.mark.parametrize("name", ["random", "long", "every_length",
                                  "all_newlines"])
def test_index_model_at_wider_blocks(name, geometry):
    """Several warps a block, and csrc/line_index.cu's own geometry."""
    text = {**TEXTS, **dict(MODEL_TEXTS)}[name]
    arr = np.frombuffer(text, np.uint8)
    want = t_rk.line_index_reference(_u8(text))
    got = index_model(arr, 5, *geometry)
    for g, w in zip(got[:4], want[:4]):
        assert g.tolist() == w.tolist()
    assert got[4] == want.last


# ---------------------------------------------------------------------
# line_rows against the engine's numpy verdict walk
# ---------------------------------------------------------------------

def np_walk(text: bytes, glitch: int, stream_v: np.ndarray, invert: bool,
            drop_first: bool, appended: bool):
    """agrep_tpu's regex engine on one chunk, transcribed: verdicts ^
    invert, the empty first line dropped (D > 0) and the appended line
    swallowed, then the lines that fire by the newlines of the text
    without the glitch byte: [(line, start, newline)]."""
    hits = stream_v ^ invert
    if drop_first and len(hits):
        hits = hits.copy()
        hits[0] = False
    if appended and len(hits):
        hits = hits.copy()
        hits[-1] = False
    plain = text if glitch < 0 else text[:glitch] + text[glitch + 1:]
    nls = np.flatnonzero(np.frombuffer(plain, np.uint8) == 0x0A)
    k_idx = np.flatnonzero(hits[:len(nls)])
    begins = np.where(k_idx > 0, nls[np.maximum(k_idx - 1, 0)] + 1, 0)
    return list(zip(k_idx.tolist(), begins.tolist(), nls[k_idx].tolist()))


@pytest.mark.parametrize("appended", [False, True])
@pytest.mark.parametrize("drop_first", [False, True])
@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("name,text,glitch", GLITCH_CASES,
                         ids=[c[0] for c in GLITCH_CASES])
def test_line_rows_matches_the_verdict_walk(name, text, glitch, invert,
                                            drop_first, appended):
    t = _u8(text)
    idx = t_rk.line_index(t)
    K = idx.nl.numel()
    rng = np.random.default_rng(len(text) + 2 * invert + drop_first)
    stream_v = rng.random(K) < 0.3
    v = torch.from_numpy(stream_v[idx.ords.numpy()])
    want = np_walk(text, glitch, stream_v, invert, drop_first, appended)
    args = (invert, 1 if drop_first else 0, K - 1 if appended else K,
            glitch)
    before = dict(t_rk.launches)
    for fn in (t_rk.line_rows_reference, t_rk.line_rows):
        rows, count = fn(v, idx.ords, idx.nl, *args)
        assert rows.dtype == torch.int64 and tuple(rows.shape) == (
            len(want), 3)
        assert [tuple(r) for r in rows.tolist()] == want
        assert count == len(want)
        none, count = fn(v, idx.ords, idx.nl, *args, rows=False)
        assert none is None and count == len(want)
    assert t_rk.launches == before


def test_wrappers_validate_and_launch_no_kernel_on_cpu():
    t = _u8(b"ab\n\ncde\n")
    before = dict(t_rk.launches)
    idx = t_rk.line_index(t)
    assert idx.nl.tolist() == [2, 3, 7] and idx.ords.tolist() == [1, 0, 2]
    v = torch.tensor([True, False, True])
    rows, n = t_rk.line_rows(v, idx.ords, idx.nl, False, 0, 3)
    assert rows.tolist() == [[1, 3, 3], [2, 4, 7]] and n == 2
    assert t_rk.launches == before
    with pytest.raises(TypeError):
        t_rk.line_index(t.to(torch.int32))
    with pytest.raises(TypeError):
        t_rk.line_index(t.view(2, 4))
    with pytest.raises(ValueError):
        t_rk.line_index(_u8(b"a\nb\nc\nd\n")[::2])
    with pytest.raises(TypeError):
        t_rk.line_rows(v.to(torch.uint8), idx.ords, idx.nl, False, 0, 3)
    with pytest.raises(TypeError):
        t_rk.line_rows(v, idx.ords.to(torch.int32), idx.nl, False, 0, 3)
    with pytest.raises(ValueError):
        t_rk.line_rows(v[:2], idx.ords, idx.nl, False, 0, 3)
    with pytest.raises(ValueError):
        t_rk.line_rows(v, idx.ords, idx.nl, False, -1, 3)
    with pytest.raises(ValueError):
        t_rk.line_rows(v, idx.ords, idx.nl, False, 0, 4)
    with pytest.raises(ValueError):
        t_rk.line_rows(v, idx.ords, idx.nl, False, 0, 3, glitch=-2)
    six = torch.arange(6)
    with pytest.raises(ValueError):
        t_rk.line_rows(v, six[::2], idx.nl, False, 0, 3)
    # an ordinal outside 0..K-1 names no line (the kernel skips it)
    for fn in (t_rk.line_rows, t_rk.line_rows_reference):
        rows, n = fn(v, torch.tensor([1, -1, 5]), idx.nl, False, 0, 3)
        assert rows.tolist() == [[1, 3, 3]] and n == 1


# ---------------------------------------------------------------------
# the CLI through both packages
# ---------------------------------------------------------------------

REGEX = "appro[a-z]*mat(e|ion)"          # BASELINE config 4
WORDS = (b"the quick brown fox pattern search world lorem ipsum dolor "
         b"string grep over lazy dog").split()
PLANTS = [b"approximate", b"approximation", b"aproximate", b"approxmate",
          b"appromate", b"Approximation", b"APPROXIMATE", b"apprmation"]


def _lines(n_bytes: int, seed: int) -> bytes:
    """Lines of 0-12 words, a planted word on about one in 12, and an
    empty line now and then."""
    rng = np.random.default_rng(seed)
    out, total = [], 0
    while total < n_bytes:
        ws = [WORDS[i] for i in rng.integers(0, len(WORDS),
                                             int(rng.integers(0, 13)))]
        if ws and rng.integers(0, 12) == 0:
            ws[int(rng.integers(0, len(ws)))] = PLANTS[
                int(rng.integers(0, len(PLANTS)))]
        line = b" ".join(ws) + b"\n"
        out.append(line)
        total += len(line)
    return b"".join(out)


def _corpus(kind: str) -> bytes:
    if kind == "lines":
        # an empty first line (dropped at D > 0), past 49,152 bytes, a
        # planted word holding the glitch byte's position
        data = bytearray(b"\n" + _lines(150_000, 1))
        data[BSR - 6:BSR + 8] = b" approximate\n"[:14].ljust(14, b" ")
        return bytes(data)
    if kind == "nofinal":
        return _lines(80_000, 2) + b"approximation at the end"
    if kind == "boundary":
        # lines of 3,000 and 1,500 bytes across the 2nd and 3rd block
        # boundaries, each with a hit near its end, and a NUL in the
        # carry window of the third; a line across the 4th whose
        # previous newline lies 1,025 bytes before it (the clamp's edge)
        data = bytearray(_lines(250_000, 3))
        for b, n in ((2 * BSR, 3000), (3 * BSR, 1500)):
            lo = data.rindex(b"\n", 0, b - n // 2) + 1
            line = bytearray(b"x" * n)
            line[-40:-28] = b"approximate "
            if b == 3 * BSR:
                line[n - 700] = 0
            data[lo:lo + n] = line
            data[lo + n] = 0x0A
        pn = 4 * BSR - 1025
        line = bytearray(b"w" * 1300)
        line[-40:-28] = b"approximate "
        data[pn:pn + 1302] = b"\n" + line + b"\n"
        return bytes(data)
    if kind == "no_nl_chunk":
        # 70,000 bytes without a newline: a 64 KiB window with none
        return (_lines(30_000, 4) + b"y" * 35_000 + b" approximate "
                + b"z" * 35_000 + b"\n" + _lines(40_000, 5))
    if kind == "small":
        return _lines(20_000, 6)
    raise ValueError(kind)


FLAGS = [["-c"], ["-n"], ["-b"], ["-v", "-n"], ["-i"]]
CLI_CASES = ([("d%d%s" % (d, "".join(f)), ["-%d" % d] + f, "lines")
              for d in range(5) for f in FLAGS]
             + [("nofinal_c", ["-2", "-c"], "nofinal"),
                ("nofinal_n", ["-1", "-n"], "nofinal"),
                ("nofinal_v", ["-2", "-v", "-b"], "nofinal"),
                ("boundary0", ["-0", "-n"], "boundary"),
                ("boundary2", ["-2", "-b"], "boundary"),
                ("boundary_c", ["-2", "-c"], "boundary"),
                ("no_nl_c", ["-2", "-c"], "no_nl_chunk"),
                ("no_nl_n", ["-2", "-n"], "no_nl_chunk"),
                ("plain", ["-2"], "lines"),
                ("small", ["-1", "-n"], "small"),
                ("l", ["-2", "-l"], "lines"),
                ("L", ["-2", "-L", "7:0:0"], "lines"),
                ("L_file", ["-1", "-n", "-L", "0:0:3"], "lines")])


def _fileagrep(api, argv):
    buf = io.BytesIO()
    rc = api.fileagrep(argv, output=buf)
    return buf.getvalue(), rc & 0xFF


def _stream_in_chunks(monkeypatch):
    """The port streams every file in chunks; agrep_tpu reads it whole
    (its own streamed print differs from its whole-file one on lines
    across a block boundary)."""
    monkeypatch.setenv("AGREP_TORCH_STREAM_MB", "0")
    monkeypatch.setenv("AGREP_TPU_STREAM_MB", "1048576")
    monkeypatch.setattr(t_scan, "STREAM_CHUNK", 1 << 10)


@pytest.mark.parametrize("streamed", [False, True],
                         ids=["whole", "streamed"])
@pytest.mark.parametrize("name,argv,kind", CLI_CASES,
                         ids=[c[0] for c in CLI_CASES])
def test_cli_matches_agrep_tpu(tmp_path, monkeypatch, name, argv, kind,
                               streamed):
    """Both packages on the same files: whole (search_stream) and, with
    the port's streaming threshold at 0 and its STREAM_CHUNK cut to 1 KiB
    (the engines' 64 KiB floor), the port chunked (search_stream_chunked)
    against agrep_tpu whole."""
    path = tmp_path / "corpus.txt"
    path.write_bytes(_corpus(kind))
    files = [str(path)]
    if name in ("l", "L", "L_file"):
        other = tmp_path / "other.txt"
        other.write_bytes(_lines(60_000, 10).replace(b"approx", b"apprux"))
        files = [str(other), str(path)]
    if streamed:
        _stream_in_chunks(monkeypatch)
    want = _fileagrep(j_api, argv + [REGEX] + files)
    got = _fileagrep(t_api, argv + [REGEX] + files)
    assert got == want
    assert want[0], "no output -- test is vacuous"


@pytest.mark.parametrize("argv", [["-2", "-c"], ["-2", "-n"], ["-1", "-b"],
                                  ["-0", "-v", "-n"], ["-2", "-n", "-v"]],
                         ids=["c", "n", "b", "vn0", "vn2"])
def test_memagrep_matches_agrep_tpu(argv):
    """Memory mode: the virtual leading line from the seed states (one
    single-line launch) and the lines after it."""
    data = _lines(70_000, 7)
    data = b"approximate first" + data
    for d in (data, b"\n" + data, b"\n\n" + data):
        bufs = []
        for api in (j_api, t_api):
            buf = io.BytesIO()
            rc = api.memagrep(argv + [REGEX], d, output=buf)
            bufs.append((buf.getvalue(), rc & 0xFF))
        assert bufs[1] == bufs[0]


@pytest.mark.parametrize("pattern,lead,argv", [
    ("x(a|b)bc", b"bbc", ["-1", "-n"]),
    ("x(a|b)bc", b"bbc", ["-1", "-c"]),
    ("ab(c|d)e", b"bde", ["-1", "-n"]),
    ("xy(a|b)c", b"ac", ["-2", "-c"])])
def test_memagrep_leading_line_seed(pattern, lead, argv):
    """A machine of at most 15 positions seeds memory mode's leading line
    with Init[0] at every level, no deletion closure: these leading
    lines fire from the post-newline states and not from the seed."""
    d = lead + b"\nfoo abbc\nbar\n"
    bufs = []
    for api in (j_api, t_api):
        buf = io.BytesIO()
        rc = api.memagrep(argv + [pattern], d, output=buf)
        bufs.append((buf.getvalue(), rc & 0xFF))
    assert bufs[1] == bufs[0]


def _chunk_cuts(data: bytes, chunk: int = 64 << 10) -> list:
    """The ends of the engine's line-aligned chunks: each window of
    chunk bytes cut after its last newline (the stream's end for the
    last), a window without one grown by a chunk."""
    cuts, lo = [], 0
    while lo < len(data):
        hi = min(lo + chunk, len(data))
        while hi < len(data) and data.rfind(b"\n", lo, hi) < 0:
            hi = min(hi + chunk, len(data))
        lo = len(data) if hi == len(data) else data.rfind(b"\n", lo, hi) + 1
        cuts.append(lo)
    return cuts


class _NumpyProxy:
    """The numpy module as the regex engine sees it, with the calls that
    would index a chunk's or a stream's newlines or sort its lengths
    recorded with their input sizes."""

    def __init__(self, sizes):
        self._sizes = sizes

    def __getattr__(self, name):
        real = getattr(np, name)
        if name not in ("flatnonzero", "argsort", "count_nonzero",
                        "nonzero"):
            return real

        def call(a, *args, **kw):
            self._sizes.append((name, int(np.size(a))))
            return real(a, *args, **kw)
        return call


@pytest.mark.parametrize("streamed", [False, True],
                         ids=["whole", "streamed"])
@pytest.mark.parametrize("argv", [["-2", "-c"], ["-2", "-n"],
                                  ["-2", "-v", "-n"], ["-2"]],
                         ids=["c", "n", "vn", "plain"])
def test_torch_route_builds_no_host_line_index(tmp_path, monkeypatch, argv,
                                               streamed):
    """Config 4 on the torch route: the engine calls no numpy index or
    sort over a chunk or the stream (only over the rows it prints), runs
    line_index once a chunk and line_rows once after it, and reads back
    one row a printed line (trace counter regex_rows; 0 for -c)."""
    data = _corpus("lines")
    path = tmp_path / "corpus.txt"
    path.write_bytes(data)
    if streamed:
        _stream_in_chunks(monkeypatch)
    sizes, calls = [], {"line_index": 0, "line_rows": 0}
    monkeypatch.setattr(t_regex, "np", _NumpyProxy(sizes))
    for name in calls:
        real = getattr(t_rk, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(t_rk, name, counted)
    monkeypatch.setattr(t_trace, "ENABLED", True)
    t_trace.reset()
    try:
        out, rc = _fileagrep(t_api, argv + [REGEX, str(path)])
        counters = dict(t_trace.counters)
    finally:
        t_trace.reset()
    assert (out, rc) == _fileagrep(j_api, argv + [REGEX, str(path)])
    n_lines = data.count(b"\n")
    assert counters.get("regex_lines") == n_lines + (not streamed)
    big = [s for s in sizes if s[1] >= 16384]
    assert not big, "host index or sort over %s" % big
    chunks = len(_chunk_cuts(data)) if streamed else 1
    assert calls == {"line_index": chunks, "line_rows": chunks}
    printed = 0 if "-c" in argv else sum(
        not line.startswith(b"Grand Total") for line in out.splitlines())
    assert counters.get("regex_rows") == printed
