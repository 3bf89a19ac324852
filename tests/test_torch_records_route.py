"""The -d records route on the device route, against agrep_tpu, on the CPU.

A `-d` flat-OR search of a stream of 64 KiB or more takes the card's
anchors: chain_scan's start plane (qgram_filter's candidate plane past
the chain caps, with 24 or more terms) feeds the native pass
qgram_first_per_anchor_at, which gives the record replay one max-term
row an anchor; booleans, -M and memory mode keep the occurrence table,
verified by the native qgram_occ_at.  Neither calls compile/multi.py's
qgram_occurrences.  Here the kernels run their plain versions (the
torch backend on CPU tensors) and each run is held to agrep_tpu on its
numpy backend, stdout byte for byte and exit code:

  * -d '$$', '\\n', '%%' and '$' with every flag of FLAGS over records
    corpora that start with a match in the delimiter's context before
    the stream and end in a match running into the EOF rescan's
    appended delimiter, and with a term matched at the 32 KB block
    seams;
  * records over 1 KB (the clamped-residue simulation's stream);
  * 600 patterns past the chain caps (qgram_filter);
  * booleans, -M and memagrep on the occurrence table;
  * the native pass at every position against qgram_first_per_anchor
    over the whole stream, row for row, with -w on and off and with
    region marks, and at the true starts only.
"""

from __future__ import annotations

import io
import random

import numpy as np
import pytest

import agrep_tpu.api as j_api
from agrep_tpu.ops import scan as j_scan
from agrep_tpu.options import AgrepError as JAgrepError
from agrep_tpu.runtime.output import OutputOverflow as JOverflow
import agrep_tpu_torch.api as t_api
from agrep_tpu_torch import native as t_native
from agrep_tpu_torch.compile import multi as t_multi
from agrep_tpu_torch.ops import chain_kernel as t_chain
from agrep_tpu_torch.ops import kernels as t_kernels
from agrep_tpu_torch.ops import qgram_kernel as t_qgram
from agrep_tpu_torch.ops import scan as t_scan
from agrep_tpu_torch.options import AgrepError as TAgrepError
from agrep_tpu_torch.runtime import mgrep as t_mgrep
from agrep_tpu_torch.runtime.output import OutputOverflow as TOverflow

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "Theta",
         "iota", "kappa", "Lambda", "search", "pattern", "match", "engine",
         "kernel", "device"]

# (id, the -d argument as typed, the separator written after each
# record): '$$' is a blank line ("\n\n"), '\n' as typed the two bytes
# "nn", '%%' itself, and '$' a newline kept at each record's tail
DELIMS = [("blank", "$$", "\n"), ("backslash_n", "\\n", "nn\n"),
          ("percents", "%%", "%%\n"), ("eol", "$", "")]

FLAGS = [[], ["-c"], ["-w"], ["-i"], ["-P"], ["-b"], ["-l"], ["-t"],
         ["-v", "-c"]]

# terms that match only in the delimiter's context before the stream's
# first bytes (the file starts with "omicron alphq", whose first bytes
# the block loop overwrites with the delimiter, after the delimiter
# copied before them) and only into the EOF rescan's appended delimiter
# (the file ends with "omega upsilo", no newline); a leading '^' or a
# trailing '$' is a newline
EDGE_TERMS = {
    "blank": ["^icron", "upsilo$"],
    "backslash_n": ["nnicron", "nicro", "nnnnic", "upsilonn", "silon"],
    "percents": ["%%icron", "%%%%ic", "upsilo%", "silo%%"],
    "eol": ["^micron", "upsilo$"],
}

# a term whose first byte is the delimiter's last, matched at each 32 KB
# block seam only with the spliced delimiter's byte before the region's
# first byte: "\na" (a line's last 'a'), "n\n", "%\n", "\n\n"
SEAM_TERMS = {"blank": "^a", "backslash_n": "n$", "percents": "%$",
              "eol": "^$"}


@pytest.fixture(autouse=True)
def _backends():
    saved = (t_scan._BACKEND, t_scan._DEVICE, j_scan._BACKEND)
    t_scan.set_backend("torch")
    t_scan.set_device("cpu")
    j_scan.set_backend("numpy")
    yield
    t_scan._BACKEND, t_scan._DEVICE = saved[:2]
    j_scan.set_backend(saved[2])


def _records(sep: str, n_bytes: int, seed: int, lines=(1, 4),
             words=(3, 9)) -> bytes:
    """Records of 1-4 lines of WORDS, sep after each, about n_bytes
    long; around each 32 KB seam a run of short records whose words
    and separators straddle the seam at many offsets.  Starts with
    "omicron alphq" and ends with "omega upsilo" (no newline)."""
    rnd = random.Random(seed)
    out = ["omicron alphq\n" + sep]
    size = len(out[0])
    seam = 1 << 15
    while size < n_bytes:
        if size > seam - 300:
            # dense short records across the seam
            while size < seam + 300:
                rec = " ".join(rnd.choices(WORDS, k=rnd.randint(1, 2)))
                rec += "\n" + sep
                out.append(rec)
                size += len(rec)
            seam += 1 << 15
            continue
        rec = "\n".join(
            " ".join(rnd.choices(WORDS, k=rnd.randint(*words)))
            for _ in range(rnd.randint(*lines))) + "\n" + sep
        out.append(rec)
        size += len(rec)
    out.append("omega upsilo")
    return "".join(out).encode()


def _patterns(delim_id: str) -> list:
    """tests/test_torch_mgrep.py's 100 patterns (none matches in
    "omicron alphq" or "omega upsilo") and the delimiter's edge
    terms."""
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
    return pats + EDGE_TERMS[delim_id]


def _patterns_600_wide() -> list:
    """tests/test_torch_mgrep.py's 600 patterns of 154 byte classes,
    past the chain caps."""
    rnd = random.Random(3)
    words = ["alpha", "beta", "kernel", "device", "zeta"]
    pats = [rnd.choice(words) for _ in range(10)]
    pats += ["qz" + rnd.choice(words) + str(i % 97) for i in range(590)]
    return pats[:10] + [p[:2] + chr(0x80 + i % 128) + p[2:]
                        for i, p in enumerate(pats[10:])]


def _write_pats(path, pats):
    path.write_bytes("".join(p + "\n" for p in pats).encode("latin-1"))
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_records_route")
    out = {}
    for delim_id, _arg, sep in DELIMS:
        corpus = d / ("records_%s.txt" % delim_id)
        corpus.write_bytes(_records(sep, 100_000, seed=len(delim_id)))
        out[delim_id] = (str(corpus), _write_pats(
            d / ("pats_%s.txt" % delim_id), _patterns(delim_id)))
        out["seam_" + delim_id] = _write_pats(
            d / ("seam_%s.txt" % delim_id),
            _patterns(delim_id) + [SEAM_TERMS[delim_id]])
    long_recs = d / "long_records.txt"
    long_recs.write_bytes(_records("\n", 90_000, seed=5, lines=(20, 40)))
    out["long"] = str(long_recs)
    out["p600w"] = _write_pats(d / "p600w.txt", _patterns_600_wide())
    # every stream takes the device route
    assert min(f.stat().st_size for f in d.glob("*records*")) \
        >= t_mgrep.DEVICE_MIN
    return out


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
def calls(monkeypatch):
    """Counts of calls into each kernel wrapper, the native passes of
    the route and compile/multi.py's qgram_occurrences during a port
    run."""
    counts = {}
    for mod, name in ((t_chain, "chain_scan"), (t_qgram, "qgram_filter"),
                      (t_kernels, "mask_scan"),
                      (t_native, "qgram_first_per_anchor_at"),
                      (t_native, "qgram_occ_at"),
                      (t_multi, "qgram_occurrences")):
        real = getattr(mod, name)
        counts[name] = 0

        def counted(*a, _real=real, _name=name, **kw):
            counts[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    return counts


def _both(argv, calls, data=None):
    """The port's run and agrep_tpu's on one argv, equal; the port's
    call counts."""
    for k in calls:
        calls[k] = 0
    got = _run(t_api, TAgrepError, TOverflow, argv, data)
    seen = dict(calls)
    want = _run(j_api, JAgrepError, JOverflow, argv, data)
    assert got == want, "port vs agrep_tpu for %r" % (argv,)
    assert seen["qgram_occurrences"] == 0, (argv, seen)
    return seen


@pytest.mark.parametrize("flags", FLAGS,
                         ids=["_".join(f) or "plain" for f in FLAGS])
@pytest.mark.parametrize("delim_id,delim",
                         [(d[0], d[1]) for d in DELIMS],
                         ids=[d[0] for d in DELIMS])
def test_records_take_the_card_anchors(files, calls, delim_id, delim,
                                       flags):
    corpus, pats = files[delim_id]
    seen = _both(flags + ["-d", delim, "-f", pats, corpus], calls)
    assert seen["chain_scan"] == 1, seen
    assert seen["qgram_first_per_anchor_at"] == 1, seen
    assert seen["qgram_filter"] == seen["mask_scan"] == 0, seen


@pytest.mark.parametrize("flags", [[], ["-c"], ["-P"]],
                         ids=["plain", "c", "P"])
@pytest.mark.parametrize("delim_id,delim",
                         [(d[0], d[1]) for d in DELIMS],
                         ids=[d[0] for d in DELIMS])
def test_seam_matches_take_the_card_anchors(files, calls, delim_id, delim,
                                            flags):
    corpus, _ = files[delim_id]
    seen = _both(flags + ["-d", delim, "-f", files["seam_" + delim_id],
                          corpus], calls)
    assert seen["chain_scan"] == 1, seen
    assert seen["qgram_first_per_anchor_at"] == 1, seen


@pytest.mark.parametrize("flags", [[], ["-c"], ["-w", "-c"]],
                         ids=["plain", "c", "w_c"])
def test_long_records_take_the_card_anchors(files, calls, flags):
    """Records over 1 KB: the clamped residues' virtual stream."""
    _, pats = files["blank"]
    seen = _both(flags + ["-d", "$$", "-f", pats, files["long"]], calls)
    assert seen["chain_scan"] >= 1, seen
    assert seen["qgram_first_per_anchor_at"] >= 1, seen


@pytest.mark.parametrize("flags", [[], ["-c"], ["-w"]],
                         ids=["plain", "c", "w"])
def test_past_the_caps_take_the_qgram_plane(files, calls, flags):
    assert t_chain.compile_chain(
        [p.encode("latin-1") for p in _patterns_600_wide()],
        np.arange(256, dtype=np.uint8)) is None
    corpus, _ = files["blank"]
    seen = _both(flags + ["-d", "$$", "-f", files["p600w"], corpus], calls)
    assert seen["qgram_filter"] == 1 and seen["chain_scan"] == 0, seen
    assert seen["qgram_first_per_anchor_at"] == 1, seen


@pytest.mark.parametrize("argv", [
    ["-d", "$$", "delta;iota"], ["-c", "-d", "$$", "{alpha,beta};~kernel"],
    ["-M", "-d", "$$", "-f", "{pats}"], ["-d", "$$", "-m", "{pats_m}"]],
    ids=["and", "tree_c", "M", "memagrep"])
def test_occurrence_table_takes_the_native_verify(files, calls, argv):
    """Booleans, -M and memory mode build the whole occurrence table from
    chain_scan's starts through qgram_occ_at."""
    corpus, pats = files["blank"]
    data = None
    if "{pats_m}" in argv:
        with open(corpus, "rb") as f:
            data = b"\n" + f.read()
        with open(pats, "rb") as f:
            pats_m = f.read().decode("latin-1")
        argv = [a.replace("{pats_m}", pats_m) for a in argv]
    else:
        argv = [a.replace("{pats}", pats) for a in argv] + [corpus]
    seen = _both(argv, calls, data)
    assert seen["chain_scan"] >= 1 and seen["qgram_occ_at"] >= 1, seen
    assert seen["qgram_first_per_anchor_at"] == 0, seen


# ---------------------------------------------------------------------
# the native pass against the whole-stream pass
# ---------------------------------------------------------------------

def _tables(terms, tr):
    tb = t_multi.build_qgram_tables(terms, tr)
    b_off = np.zeros(len(tb.bucket_list) + 1, dtype=np.int64)
    for i, ids in enumerate(tb.bucket_list):
        b_off[i + 1] = b_off[i] + len(ids)
    b_tids = np.concatenate(tb.bucket_list).astype(np.int64)
    t_off = np.zeros(len(terms) + 1, dtype=np.int64)
    for i, t in enumerate(terms):
        t_off[i + 1] = t_off[i] + len(t)
    t_bytes = np.frombuffer(b"".join(terms), dtype=np.uint8).copy()
    return tb, (tb.member, tb.hash_id, b_off, b_tids, t_bytes, t_off, tr,
                tb.p_size, bool(tb.long_), bool(tb.short))


def _plane(positions, n):
    """u32 bit plane of ceil(n / 32) words with the given bits set."""
    bits = np.zeros(-(-n // 32) * 32, dtype=np.uint64)
    bits[positions] = 1
    return (bits.reshape(-1, 32) << np.arange(32, dtype=np.uint64)).sum(
        axis=1).astype(np.uint32)


@pytest.mark.parametrize("chunked", [False, True],
                         ids=["serial", "chunked"])
@pytest.mark.parametrize("wordbound", [False, True], ids=["plain", "w"])
@pytest.mark.parametrize("delim", [None, b"$$", b"\n\n", b"\n"],
                         ids=["no_jump", "dollars", "blank", "newline"])
def test_native_pass_at_the_plane_equals_the_whole_stream(
        delim, wordbound, chunked, monkeypatch):
    """Chunked: both passes split the stream at the same region marks
    and run the chunks side by side, as past AGREP_TORCH_PAR_MIN."""
    assert t_native.get_lib() is not None
    if chunked:
        monkeypatch.setenv("AGREP_TORCH_PAR_MIN", "1024")
    rnd = random.Random(1)
    pieces = [b"alpha", b"beta", b"gam", b"de", b"x", b"kernel", b"$$",
              b" ", b"\n", b"$$\n", b"a1", b"Alpha"]
    for trial in range(12):
        s = np.frombuffer(b"".join(rnd.choices(pieces, k=4000)),
                          dtype=np.uint8).copy()
        terms = [rnd.choice(pieces[:6]) + rnd.choice([b"", b"a", b" b"])
                 for _ in range(rnd.randint(1, 40))]
        tr = np.arange(256, dtype=np.uint8)
        if trial % 3 == 2:
            tr[65:91] += 32                     # -i
        tb, tables = _tables(terms, tr)
        marks = (np.flatnonzero(s == 0x0A)[::5]
                 if delim is not None else None)
        kw = dict(delim=delim, marks=marks, maxs=tb.p_size)
        want = t_native.qgram_first_per_anchor(s, *tables, wordbound, **kw)
        every = np.full(-(-len(s) // 32), 0xFFFFFFFF, dtype=np.uint32)
        got = t_native.qgram_first_per_anchor_at(s, every, 0, *tables,
                                                 wordbound, **kw)
        assert np.array_equal(got[0], want[0]), trial
        assert np.array_equal(got[1], want[1]), trial
        # the true starts only, as the chain kernel's plane gives them
        occ = t_native.qgram_occ_all(s, *tables)
        starts = np.unique(occ[0]) - (tb.p_size - 1)
        got = t_native.qgram_first_per_anchor_at(
            s, _plane(starts, len(s)), tb.p_size - 1, *tables, wordbound,
            **kw)
        assert np.array_equal(got[0], want[0]), trial
        assert np.array_equal(got[1], want[1]), trial


def test_the_route_stays_off_the_numpy_backend(files, calls):
    """The numpy backend keeps the whole-stream native pass."""
    t_scan.set_backend("numpy")
    corpus, pats = files["blank"]
    seen = _both(["-d", "$$", "-f", pats, corpus], calls)
    assert seen["qgram_first_per_anchor_at"] == 0, seen
    assert seen["chain_scan"] == 0, seen
