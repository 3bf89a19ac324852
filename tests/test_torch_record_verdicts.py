"""The bitap engine's record cut on the scan device, against agrep_tpu,
exactly, on the CPU.

  * kernel module: agrep_tpu_torch's pair_records_reference (the cut of
    event pairs), and record_verdicts_reference and the record_verdicts
    wrapper (which takes it for a CPU tensor) on planes that hold the same
    pairs (planes_of_pairs: one plane a word bit, junk bits in the halo
    columns and past N), against a transcription of the per-event walk
    of agrep_tpu's BitapEngine.search_stream_chunked
    (runtime/engine.py:107-132) on random pair streams: AND and OR, with
    and without invert, with and without a dropped pair, hits on record
    ends, K = 0 and 1, no record end, every pair a record end; and random
    cuts into chunks of planes, each with a halo it drops through
    keep_from and from the carry of the ones before, against the whole
    stream;
  * scan module: scan_record_verdicts and the chunked scan_record_list
    on the torch backend (device cpu) against the same walk over
    agrep_tpu's scan_events on its numpy backend, across chunk seams;
  * the CLI: the bitap engine's searches that reach the mask machine
    (-1 -n, -2 -b, -v -n, -c, -v -c, -l, -L's limits, AND with and without -v, -c
    of an AND, -d '$$', -t -d 'From ', a leading delimiter, files over
    49,152 B, a hit on the glitch byte, a file an exact multiple of
    49,152 B, clamped long records) through
    both packages, byte for byte with the exit code, whole and streamed
    in 64 KiB chunks; and the torch route cutting its records through
    record_verdicts, once a chunk, with no event pair on the host.

Every value is an integer, so every comparison is exact.  The CUDA kernel
csrc/record_verdicts.cu is held against record_verdicts_reference by
chip_smoke.py on the GPU; tests/test_torch_plane_records.py holds a
model of its word-at-a-time fold to pair_records_reference.
"""

from __future__ import annotations

import functools
import io

import numpy as np
import pytest
import torch

import agrep_tpu.api as j_api
from agrep_tpu.compile.query import compile_query as j_compile
from agrep_tpu.ops import scan as j_scan
from agrep_tpu.options import parse_args as j_parse
import agrep_tpu_torch.api as t_api
from agrep_tpu_torch.compile.query import compile_query as t_compile
from agrep_tpu_torch.ops import kernels as t_kernels
from agrep_tpu_torch.ops import scan as t_scan
from agrep_tpu_torch.options import parse_args as t_parse

from .torch_oracle import one_thread

MAX_RECORD = 49152


@pytest.fixture(autouse=True)
def _backends():
    """Port on the plain PyTorch scan (CPU), reference on its exact
    numpy backend; both restored afterwards."""
    saved = (t_scan._BACKEND, t_scan._DEVICE, j_scan._BACKEND)
    t_scan.set_backend("torch")
    t_scan.set_device("cpu")
    j_scan.set_backend("numpy")
    with one_thread():
        yield
    t_scan._BACKEND, t_scan._DEVICE = saved[:2]
    j_scan.set_backend(saved[2])


def walk(pos, word, endpos, d_endpos, skip_pos=-1, and_flag=False,
         invert=False, acc=0):
    """agrep_tpu's per-event record walk (engine.py:107-132), transcribed,
    from a carried acc: (rows [(ordinal, end, previous end or -1)],
    (record ends, last end or -1, hit bits after it))."""
    rows, k, prev = [], 0, -1
    any_hit = (acc & endpos) != 0
    for p_m, w in zip(pos, word):
        if p_m == skip_pos:
            continue
        if w & endpos:
            any_hit = True
            acc |= w
        if not (w & d_endpos):
            continue
        if and_flag:
            verdict = ((acc & endpos) == endpos) or (False ^ invert)
        else:
            verdict = any_hit ^ invert
        if verdict:
            rows.append((k, p_m, prev))
        k += 1
        prev = p_m
        acc = 0
        any_hit = False
    return rows, (k, prev, acc & endpos)


def _tensors(pos, word):
    return (torch.as_tensor(np.asarray(pos, dtype=np.int64)),
            torch.as_tensor(np.asarray(word, dtype=np.uint32)))


# the planes' tile and halo in the pair tests: W not a multiple of 32, so
# that a stream word's bits straddle two plane words
PL, PW = 256, 40


def planes_of_pairs(pos, word, N, rng, W=PW, L=PL):
    """(planes u32 [P, T, n_words] tensor, vals u32 [P] tensor): one
    plane a bit that the words hold (value 1 << bit), its bit set at each
    position whose word has the bit, as mask_scan lays planes out
    (kernels.geometry), with random junk bits in the halo columns, the
    columns past the tile and the positions at or past N, which
    event_pairs ignores; event_pairs_reference of them gives (pos, word)
    back."""
    pos = np.asarray(pos, dtype=np.int64)
    word = np.asarray(word, dtype=np.uint32)
    assert not len(pos) or pos.max() < N
    T, nw = t_kernels.geometry(N, W, L)
    bits = [b for b in range(32)
            if np.bitwise_or.reduce(word, initial=0) >> b & 1] or [0]
    cols = np.zeros((len(bits), T, 32 * nw), dtype=bool)
    t, j = pos // L, W + pos % L
    for k, b in enumerate(bits):
        on = (word >> b & 1).astype(bool)
        cols[k, t[on], j[on]] = True
    # junk wherever no position below N lies
    body = np.zeros((T, 32 * nw), dtype=bool)
    body[:, W:W + L] = np.arange(T * L).reshape(T, L) < N
    cols |= (rng.random(cols.shape) < 0.2) & ~body
    planes = np.packbits(cols, axis=-1, bitorder="little").view(np.uint32)
    vals = np.asarray([1 << b for b in bits], dtype=np.uint32)
    return torch.from_numpy(planes.copy()), torch.from_numpy(vals)


def _check(pos, word, endpos, d_endpos, skip_pos, and_flag, invert, acc=0,
           rng=None):
    """The pair cut, and the plain version and the CPU wrapper on planes
    of the same pairs, against walk; returns the rows."""
    want_rows, want_sum = walk(pos, word, endpos, d_endpos, skip_pos,
                               and_flag, invert, acc)
    pt, wt = _tensors(pos, word)
    got = [t_kernels.pair_records_reference(pt, wt, endpos, d_endpos,
                                            skip_pos, and_flag, invert, acc)]
    N = int(pos[-1]) + 1 + int(rng.integers(0, 70)) if len(pos) else 5
    planes, vals = planes_of_pairs(pos, word, N, rng)
    for fn in (t_kernels.record_verdicts_reference,
               t_kernels.record_verdicts):
        rows, summary = fn(planes, vals, PW, PL, N, 0, endpos, d_endpos,
                           skip_pos, and_flag, invert, acc)
        assert summary[3] == len(pos)
        got.append((rows, summary[:3]))
    for rows, summary in got:
        assert rows.dtype == torch.int64 and tuple(rows.shape) == (
            len(want_rows), 3)
        assert [tuple(r) for r in rows.tolist()] == want_rows
        assert summary == want_sum
    return want_rows


# (endpos, d_endpos): one hit bit; three hit bits (an AND of three
# parts); the delimiter bit inside the word's hit bits' range
MASKS = [(0x1, 0x100), (0x2A, 0x400), (0x80000000, 0x40)]


def _stream(rng, K, endpos, d_endpos, p_hit, p_end):
    """K ascending positions and words: hits of random endpos bits with
    p_hit, record ends with p_end (a pair can be both), and noise bits
    outside both masks."""
    pos = np.sort(rng.choice(10 * K + 10, K, replace=False)).astype(np.int64)
    bits = [1 << b for b in range(32) if endpos >> b & 1]
    word = rng.integers(0, 1 << 32, K, dtype=np.uint64) \
        & ~np.uint64(endpos | d_endpos) & np.uint64(0x00F000F0)
    for i in range(K):
        if rng.random() < p_hit:
            for b in rng.choice(bits, rng.integers(1, len(bits) + 1)):
                word[i] |= np.uint64(b)
        if rng.random() < p_end:
            word[i] |= np.uint64(d_endpos)
    word = word.astype(np.uint32)
    word[word == 0] = d_endpos          # every pair has an event
    return pos, word


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("and_flag", [False, True])
@pytest.mark.parametrize("masks", MASKS)
def test_reference_matches_the_event_walk(masks, and_flag, invert, skip):
    endpos, d_endpos = masks
    rng = np.random.default_rng(endpos ^ (2 * and_flag + invert))
    fired = 0
    for K, p_hit, p_end in ((0, 0.5, 0.5), (1, 1.0, 1.0), (1, 0.0, 1.0),
                            (1, 1.0, 0.0), (40, 0.3, 0.0), (40, 0.0, 1.0),
                            (40, 1.0, 1.0), (300, 0.3, 0.2),
                            (3000, 0.05, 0.4), (3000, 0.6, 0.05)):
        pos, word = _stream(rng, K, endpos, d_endpos, p_hit, p_end)
        skip_pos = int(pos[K // 2]) if skip and K else -1
        for acc in (0, endpos):
            fired += len(_check(pos, word, endpos, d_endpos, skip_pos,
                                and_flag, invert, acc, rng))
    assert fired, "no record fired -- test is vacuous"


@pytest.mark.parametrize("and_flag,invert",
                         [(False, False), (False, True), (True, False),
                          (True, True)])
def test_random_cuts_equal_the_whole_stream(and_flag, invert):
    """Chunks of a stream's planes, each with a halo of up to 99
    positions before it that it drops through keep_from (as
    scan_record_list's chunks do) and cut from the acc the chunk before
    left, with their ordinals and previous ends carried on the host as
    scan_record_list carries them, give the whole stream's rows: chunks
    with no record end and rows whose previous end lies two chunks back
    among them."""
    endpos, d_endpos = 0x2A, 0x400
    rng = np.random.default_rng(5 + 2 * and_flag + invert)
    pos, word = _stream(rng, 2000, endpos, d_endpos, 0.3, 0.08)
    # two records over 100 pairs with no end: one holding every hit bit
    # (it fires without invert), one with no hit at all (it fires with)
    word[1000:1100] &= ~np.uint32(d_endpos)
    word[1050] |= endpos
    word[1500:1600] &= ~np.uint32(d_endpos)
    ends = np.flatnonzero(word & d_endpos)
    lo, hi = ends[ends < 1500][-1] + 1, ends[ends >= 1600][0] + 1
    word[lo:hi] &= ~np.uint32(endpos)
    skip_pos = int(pos[777])
    pt, wt = _tensors(pos, word)
    whole, whole_sum = t_kernels.pair_records_reference(
        pt, wt, endpos, d_endpos, skip_pos, and_flag, invert)
    n = int(pos[-1]) + 1
    back_two = 0
    for trial in range(6):
        cuts = np.unique(np.r_[rng.choice(np.arange(1, 2000),
                                          5 + 10 * trial), 1020, 1080,
                               1520, 1580])
        got, acc, base, last, chunks_back, events = [], 0, 0, -1, 0, 0
        for i, j in zip(np.r_[0, cuts], np.r_[cuts, 2000]):
            g0, g1 = int(pos[i]) if i else 0, int(pos[j]) if j < 2000 else n
            lo = max(0, g0 - int(rng.integers(0, 100)))
            inside = (pos >= lo) & (pos < g1)
            planes, vals = planes_of_pairs(pos[inside] - lo, word[inside],
                                           g1 - lo, rng)
            rows, (k, c_last, acc, ev) = t_kernels.record_verdicts(
                planes, vals, PW, PL, g1 - lo, g0 - lo, endpos, d_endpos,
                skip_pos - lo if skip_pos >= lo else -1, and_flag, invert,
                acc)
            events += ev
            for o, end, prev in rows.tolist():
                if prev < 0:
                    prev = last
                    back_two += chunks_back > 1
                else:
                    prev += lo
                got.append((o + base, end + lo, prev))
            chunks_back = 1 if k else chunks_back + 1
            if k:
                last = c_last + lo
            base += k
        assert got == [tuple(r) for r in whole.tolist()]
        assert (base, last, acc) == whole_sum
        assert events == np.count_nonzero(word)
    assert back_two, "no row's previous end lay two chunks back"


def test_wrapper_validates_and_counts_no_cpu_launch():
    rng = np.random.default_rng(3)
    pt, vt = planes_of_pairs([3, 9], [0x100, 0x101], 12, rng)
    args = (PW, PL, 12, 0, 1, 0x100)
    before = t_kernels.launches["record_verdicts"]
    rows, summary = t_kernels.record_verdicts(pt, vt, *args)
    assert rows.tolist() == [[1, 9, 3]] and summary == (2, 9, 0, 2)
    assert t_kernels.launches["record_verdicts"] == before
    with pytest.raises(TypeError):
        t_kernels.record_verdicts(pt.to(torch.int32), vt, *args)
    with pytest.raises(TypeError):
        t_kernels.record_verdicts(pt, vt.to(torch.int64), *args)
    with pytest.raises(ValueError):          # one value a plane
        t_kernels.record_verdicts(pt, vt[:1], *args)
    with pytest.raises(ValueError):          # not the scan's geometry
        t_kernels.record_verdicts(pt, vt, PW, PL, 3 * PL, 0, 1, 0x100)
    with pytest.raises(ValueError):
        t_kernels.record_verdicts(pt[:, :, ::2], vt, *args)


# ---------------------------------------------------------------------
# scan module: rows vs the walk over agrep_tpu's scan on its numpy backend
# ---------------------------------------------------------------------

SCAN_ARGVS = {
    "config2": ["-1", "-n", "matching"],
    "config3": ["-3", "-D2", "-I1", "-S1", "-w", "-i", "approximate"],
    "records": ["-1", "-n", "-d", "$$", "hello"],
    "and3": ["-n", "hello;matching;lazy"],
}


@functools.lru_cache(maxsize=None)
def _query(name):
    opts, pattern, _ = j_parse(SCAN_ARGVS[name] + ["x"])
    q = j_compile(pattern, opts)
    assert q.engine_class == "bitap"
    return q


def _text(n, seed):
    """Lowercase bytes, a newline about every 40 and a blank line about
    every 400, planted words."""
    rng = np.random.default_rng(seed)
    text = rng.integers(97, 123, size=n, dtype=np.uint8)
    text[rng.integers(0, n, n // 40 + 1)] = 0x0A
    for p in (b"hello", b"matching", b"matchng", b"lazy", b" aproximate ",
              b" approximate ", b"\n\n"):
        pb = np.frombuffer(p, dtype=np.uint8)
        for off in rng.integers(0, n - len(pb), max(1, n // 250)):
            text[off:off + len(pb)] = pb
    return text


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("name", list(SCAN_ARGVS))
def test_scan_rows_match_agrep_tpu(name, invert):
    """scan_record_verdicts on one stream and scan_record_list in chunks
    (with a W-byte halo each) against the walk over agrep_tpu's event
    words of the whole stream, a glitch pair dropped."""
    q = _query(name)
    c = q.consts
    text = _text(9001, len(name))
    events = j_scan.scan_events(text, q.folded_mask, c, q.D, "bitap",
                                q.costs)
    pos = np.flatnonzero(events)
    skip_pos = int(pos[len(pos) // 3])
    want, _ = walk(pos.tolist(), events[pos].tolist(), int(c["endpos"]),
                   int(c["d_endpos"]), skip_pos, q.and_flag, invert)
    assert want, "no record fired -- test is vacuous"
    args = (q.folded_mask, c, q.D, q.costs, skip_pos, q.and_flag, invert)
    got = t_scan.scan_record_verdicts(text, *args)
    assert got.dtype == np.int64
    assert [tuple(r) for r in got.tolist()] == want
    batches = list(t_scan.scan_record_list(
        lambda lo, hi: text[lo:hi], len(text), *args, chunk=700))
    assert len(batches) == 13
    assert [tuple(r) for b in batches for r in b.tolist()] == want


def test_numpy_backend_raises():
    t_scan.set_backend("numpy")
    q = _query("config2")
    with pytest.raises(ValueError):
        t_scan.scan_record_verdicts(_text(100, 1), q.folded_mask, q.consts,
                                    q.D, q.costs)
    assert not t_scan.records_on_device()


# ---------------------------------------------------------------------
# the CLI through both packages
# ---------------------------------------------------------------------

FILLER = (b"the quick brown fox pattern search world lorem ipsum dolor "
          b"string grep over dog").split()
CLI_PLANTS = [b"hello", b"matching", b"matchng", b"MATCHING", b"lazy"]


def _lines(n_bytes, seed, records=False):
    """Lines of 8 filler words, one or two planted words on about one in
    25; with records, a blank line after every 8-16 lines (-d '$$')."""
    rng = np.random.default_rng(seed)
    out, total, k = [], 0, 0
    nxt = int(rng.integers(8, 17))
    while total < n_bytes:
        ws = [FILLER[i] for i in rng.integers(0, len(FILLER), 8)]
        if rng.integers(0, 25) == 0:
            for _ in range(int(rng.integers(1, 3))):
                ws[int(rng.integers(0, 8))] = CLI_PLANTS[
                    int(rng.integers(0, len(CLI_PLANTS)))]
        line = b" ".join(ws) + b"\n"
        k += 1
        if records and k == nxt:
            line += b"\n"
            k, nxt = 0, int(rng.integers(8, 17))
        out.append(line)
        total += len(line)
    return b"".join(out)


def _corpus(kind):
    if kind == "lines":
        return _lines(100_000, 1)
    if kind == "records":
        return _lines(100_000, 2, records=True)
    if kind == "lead":                  # a leading -d delimiter
        return b"\n\n" + _lines(100_000, 3, records=True)
    if kind == "from":                  # 'From ' records, leading too
        return b"".join(b"From " + r for r in
                        _lines(100_000, 4, records=True).split(b"\n\n"))
    if kind == "glitch":
        # a -1 match whose one substitution is the glitch byte itself:
        # its only event is the pair the engines drop
        data = bytearray(_lines(100_000, 11))
        data[MAX_RECORD - 11:MAX_RECORD + 1] = b" approximat\n"
        data[30_000:30_013] = b" approximate\n"
        return bytes(data)
    if kind == "multiple":              # no appended delimiter
        data = _lines(3 * MAX_RECORD, 5)[:3 * MAX_RECORD - 1] + b"\n"
        assert len(data) == 3 * MAX_RECORD
        return data
    if kind == "long":
        # a 70,000-byte paragraph holding hits (a record over
        # Max_record, clamped in print; in 64 KiB chunks one chunk has no
        # record end) and a 60,000-byte line with a hit
        para = _lines(70_000, 6).replace(b"\n", b" ")
        line = b" ".join(FILLER[i % len(FILLER)] for i in range(9000))
        return (_lines(5_000, 7, records=True) + b"\n" + para[:35_000]
                + b" matching " + para[35_000:] + b"\n\n"
                + _lines(5_000, 8, records=True) + line[:50_000]
                + b" matching " + line[50_000:] + b"\n"
                + _lines(20_000, 9, records=True))
    raise ValueError(kind)


M = ["matching"]
CLI_CASES = [
    ("n1", ["-1", "-n"] + M, "lines"),
    ("b2", ["-2", "-i", "-b"] + M, "lines"),
    ("vn", ["-1", "-v", "-n"] + M, "lines"),
    ("c", ["-1", "-i", "-c"] + M, "lines"),
    ("vc", ["-1", "-i", "-v", "-c"] + M, "lines"),
    ("l", ["-1", "-i", "-l"] + M, "lines"),
    ("L", ["-1", "-i", "-L", "7:0:0"] + M, "lines"),
    ("L_file", ["-1", "-n", "-L", "0:0:3"] + M, "lines"),
    ("and", ["-n", "hello;matching"], "lines"),
    ("and_v", ["-v", "-d", "$$", "-n", "hello;matching"], "records"),
    ("and_c", ["-c", "-d", "$$", "-1", "hello;lazy"], "records"),
    ("d", ["-1", "-d", "$$", "-n"] + M, "records"),
    ("lead", ["-1", "-i", "-d", "$$", "-b"] + M, "lead"),
    ("t", ["-1", "-t", "-d", "From ", "-n"] + M, "from"),
    ("glitch", ["-1", "-D2", "-I1", "-S1", "-n", "approximate"], "glitch"),
    ("multiple", ["-1", "-n"] + M, "multiple"),
    ("multiple_c", ["-1", "-i", "-c"] + M, "multiple"),
    ("long", ["-1", "-d", "$$", "-n"] + M, "long"),
    ("long_line", ["-1", "-i", "-b"] + M, "long"),
]


def _run(api, argv):
    buf = io.BytesIO()
    rc = api.fileagrep(argv, output=buf)
    return buf.getvalue(), rc & 0xFF


@pytest.mark.parametrize("streamed", [False, True],
                         ids=["whole", "streamed"])
@pytest.mark.parametrize("name,argv,kind", CLI_CASES,
                         ids=[c[0] for c in CLI_CASES])
def test_cli_matches_agrep_tpu(tmp_path, monkeypatch, name, argv, kind,
                               streamed):
    """Both packages on the same files: whole (search_stream) and, with
    the streaming threshold at 0 and 64 KiB chunks in both, chunked
    (search_stream_chunked); the torch route cuts its records through
    record_verdicts and no event pair comes to the host."""
    opts, pattern, _ = t_parse(argv + ["x"])
    assert t_compile(pattern, opts).engine_class == "bitap"
    path = tmp_path / "corpus.txt"
    path.write_bytes(_corpus(kind))
    files = [str(path)]
    if name in ("l", "L", "L_file"):
        other = tmp_path / "other.txt"
        other.write_bytes(_lines(60_000, 10).replace(b"match", b"mutch"))
        files = [str(other), str(path)]
    if streamed:
        monkeypatch.setenv("AGREP_TORCH_STREAM_MB", "0")
        monkeypatch.setenv("AGREP_TPU_STREAM_MB", "0")
        monkeypatch.setattr(t_scan, "STREAM_CHUNK", 64 << 10)
        monkeypatch.setattr(j_scan, "STREAM_CHUNK", 64 << 10)
    calls = []
    real = t_kernels.record_verdicts

    def counted(*args, **kw):
        calls.append(args[0].numel())
        return real(*args, **kw)

    def refused(*args, **kw):
        raise AssertionError("the bitap engine read event pairs on the "
                             "torch route")

    monkeypatch.setattr(t_kernels, "record_verdicts", counted)
    monkeypatch.setattr(t_scan, "scan_event_list", refused)
    monkeypatch.setattr(t_scan, "scan_event_pairs", refused)
    got = _run(t_api, argv + files)
    want = _run(j_api, argv + files)
    assert got == want, "port vs agrep_tpu for %s" % name
    assert got[0], "no output -- test is vacuous"
    assert calls, "%s cut no records through record_verdicts" % name


def _machine_len(data, delim):
    """Bytes of the bitap engine's machine stream over a file: the
    prefilled newline, the glitch byte past Max_record, the appended
    delimiter unless the file is a multiple of Max_record."""
    return (1 + len(data) + (len(data) > MAX_RECORD)
            + (len(delim) if len(data) % MAX_RECORD else 0))


@pytest.mark.parametrize("kind", ["lines", "multiple"])
def test_engine_cuts_records_once_a_chunk(tmp_path, monkeypatch, kind):
    """On the torch backend the chunked engine calls record_verdicts once
    for each chunk of its machine stream and the whole-stream engine
    once; neither reads an event pair back."""
    data = _corpus(kind)
    path = tmp_path / "corpus.txt"
    path.write_bytes(data)
    calls = []
    real = t_kernels.record_verdicts

    def counted(*args, **kw):
        calls.append(args[0].numel())
        return real(*args, **kw)

    def refused(*args, **kw):
        raise AssertionError("event pairs read on the torch route")

    monkeypatch.setattr(t_kernels, "record_verdicts", counted)
    monkeypatch.setattr(t_scan, "scan_event_list", refused)
    monkeypatch.setattr(t_scan, "scan_event_pairs", refused)
    _run(t_api, ["-1", "-n", "matching", str(path)])
    assert len(calls) == 1
    calls.clear()
    monkeypatch.setenv("AGREP_TORCH_STREAM_MB", "0")
    monkeypatch.setattr(t_scan, "STREAM_CHUNK", 16 << 10)
    _run(t_api, ["-1", "-n", "matching", str(path)])
    assert len(calls) == -(-_machine_len(data, b"\n") // (16 << 10))
    assert min(calls) > 0
