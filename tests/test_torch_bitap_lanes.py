"""The sticky machines' record lanes on the torch backend, on the CPU.

-p (Init1 = ~0) and '#' wildcards keep bits sticky with no bound on
their reach, so the bitap engine scans them a record a lane.  On the
torch backend ops/scan.py's scan_lane_rows cuts the records at a
one-byte delimiter (renfa_kernel.line_index with the delimiter byte),
steps them through bitap_lanes (csrc/bitap_lanes.cu on the card; here
its plain version, bitap_lanes_reference) and reads back only the rows
of those that fire (renfa_kernel.line_rows).  Held here against
agrep_tpu:

- bitap_lanes_reference bit for bit against agrep_tpu.ops.scan.scan_lanes
  on seeded lanes (D 0-8, uniform and cost wiring, -p, '#', AND, lanes
  of 0 to 8 KiB), both of its walks (tensors and Python ints);
- line_index with a delimiter byte against a numpy cut, and unchanged
  for '\\n';
- the CLI's -p and '#' file searches and memagrep's sticky searches
  against agrep_tpu on its numpy backend, with one-byte and multi-byte
  -d, on both of the port's backends;
- the torch backend's sticky route never calls the host's scan_lanes.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

import agrep_tpu.api as j_api
from agrep_tpu.ops import scan as j_scan
import agrep_tpu_torch.api as t_api
from agrep_tpu_torch.compile.query import compile_query as t_compile
from agrep_tpu_torch.ops import renfa_kernel as t_renfa_kernel
from agrep_tpu_torch.ops import scan as t_scan
from agrep_tpu_torch.options import parse_args as t_parse
from agrep_tpu_torch.runtime import engine as t_engine

from .torch_oracle import one_thread

LOOP = t_engine.BitapEngine._memory_search_loop


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


def _query(argv):
    opts, pattern, _ = t_parse(argv + ["x"])
    q = t_compile(pattern, opts)
    assert q.engine_class == "bitap" and t_engine.BitapEngine(q).sticky()
    return q


# (name, argv): sticky machines of every wiring the lanes take
MACHINES = [
    ("p_k0", ["-p", "aproximat"]),
    ("p_k2", ["-2", "-p", "hello"]),
    ("wild_k0", ["appr#mate"]),
    ("wild_k1", ["-1", "h#o"]),
    ("wild_and", ["al#ha;ko#la"]),
    ("wild_or", ["-1", "br#vo,zz"]),
    ("wild_costs", ["-2", "-D2", "-I1", "-S1", "br#vo"]),
    ("wild_costs_i2", ["-3", "-I2", "-S1", "-D3", "ma#ing"]),
    ("wild_k8", ["-8", "abcdefgh#ijklm"]),
    ("p_k8", ["-8", "-p", "abcdefghijkl"]),
]
WORDS = [b"hello", b"aproximate", b"approximately", b"koala", b"alpha",
         b"bravo", b"zz", b"matching", b"abcdefghijklm", b"xyz"]


def _lanes(rng, R: int, long: bool):
    """R lanes of seeded bytes, each ended by '\\n': planted words among
    letters, lengths 0-200, and with `long` some of up to 8 KiB."""
    lanes = []
    for r in range(R):
        n = int(rng.integers(0, 200))
        if long and r % 7 == 0:
            n = int(rng.choice([1023, 1024, 4097, 8191, 8192]))
        t = bytearray(rng.integers(97, 123, n, dtype=np.uint8).tobytes())
        for _ in range(int(rng.integers(0, 3))):
            w = WORDS[int(rng.integers(0, len(WORDS)))]
            if len(t) > len(w):
                at = int(rng.integers(0, len(t) - len(w)))
                t[at:at + len(w)] = w
        lanes.append(bytes(t) + b"\n")
    if R > 2:
        lanes[1] = b"\n"                      # an empty record
    return lanes


def _text_of(lanes):
    text = np.frombuffer(b"".join(lanes), dtype=np.uint8)
    lens = np.asarray([len(x) - 1 for x in lanes], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lens + 1)[:-1]]).astype(np.int64)
    return text, starts, lens


def _scan_lanes_hits(q, lanes, init):
    """agrep_tpu's scan_lanes over the lanes as a zero-padded matrix."""
    consts = t_engine._sticky_consts(q)
    lens = np.asarray([len(x) - 1 for x in lanes], dtype=np.int64)
    mat = np.zeros((len(lanes), int(lens.max()) + 1), dtype=np.uint8)
    for r, x in enumerate(lanes):
        mat[r, :len(x)] = np.frombuffer(x, dtype=np.uint8)
    return j_scan.scan_lanes(mat, lens, q.folded_mask, consts, q.D, q.costs,
                             np.asarray(init, dtype=np.uint32),
                             sticky_endpos=True)


@pytest.mark.parametrize("long", [False, True], ids=["short", "long"])
@pytest.mark.parametrize("name,argv", MACHINES, ids=[m[0] for m in MACHINES])
def test_reference_matches_scan_lanes(name, argv, long):
    """hits equal scan_lanes' on every lane, through both walks of the
    plain version, and the verdicts are the record walk's."""
    q = _query(argv)
    rng = np.random.default_rng(2 * MACHINES.index((name, argv)) + long)
    lanes = _lanes(rng, 40 if long else 120, long)
    init = t_engine._lane_inits(q, q.D)
    want = _scan_lanes_hits(q, lanes, init)
    text, starts, lens = _text_of(lanes)
    m = t_scan.lanes_machine(q.folded_mask, t_engine._sticky_consts(q), q.D,
                             q.costs, "cpu")
    args = (torch.from_numpy(text.copy()), torch.from_numpy(starts),
            torch.from_numpy(lens), m, init)
    endpos = int(q.consts["endpos"])
    for scalar in (0, 1 << 30):
        for invert in (False, True):
            v, hits = t_scan.bitap_lanes_reference(
                *args, None, q.and_flag, invert, scalar_lanes=scalar)
            assert hits.dtype == torch.uint32
            assert np.array_equal(hits.numpy(), want), (name, scalar)
            h = want.astype(np.int64)
            fire = (((h == endpos) | invert) if q.and_flag
                    else ((h != 0) ^ invert))
            assert np.array_equal(v.numpy(), fire), (name, invert)
    assert want.any(), "no lane hits: the case is vacuous"


@pytest.mark.parametrize("name,argv", MACHINES[:6],
                         ids=[m[0] for m in MACHINES[:6]])
def test_first_lane_takes_its_own_states(name, argv):
    """The lane that starts at 0 steps from `first` (memory mode's
    Init0), every other from init."""
    q = _query(argv)
    lanes = _lanes(np.random.default_rng(5), 30, False)
    lanes[0] = b"hello aproximate alpha koala bravo zz\n"
    init = t_engine._lane_inits(q, q.D)
    first = [int(q.consts["init0"])] * (q.D + 1)
    want = _scan_lanes_hits(q, lanes, init)
    want[0] = _scan_lanes_hits(q, lanes[:1], first)[0]
    text, starts, lens = _text_of(lanes)
    m = t_scan.lanes_machine(q.folded_mask, t_engine._sticky_consts(q), q.D,
                             q.costs, "cpu")
    for scalar in (0, 1 << 30):
        _v, hits = t_scan.bitap_lanes_reference(
            torch.from_numpy(text.copy()), torch.from_numpy(starts),
            torch.from_numpy(lens), m, init, first, scalar_lanes=scalar)
        assert np.array_equal(hits.numpy(), want)


def test_wrapper_validates_and_runs_the_plain_version_on_the_cpu():
    q = _query(["-p", "hello"])
    m = t_scan.lanes_machine(q.folded_mask, t_engine._sticky_consts(q), q.D,
                             q.costs, "cpu")
    text = torch.frombuffer(bytearray(b"xhelloy\nhel\n"), dtype=torch.uint8)
    starts = torch.tensor([0, 8], dtype=torch.int64)
    lens = torch.tensor([7, 3], dtype=torch.int64)
    init = t_engine._lane_inits(q, q.D)
    before = dict(t_scan.launches)
    v, hits = t_scan.bitap_lanes(text, starts, lens, m, init)
    assert v.tolist() == [True, False] and t_scan.launches == before
    with pytest.raises(ValueError):
        t_scan.bitap_lanes(text, starts, lens + 1, m, init)
    with pytest.raises(ValueError):
        t_scan.bitap_lanes(text, starts, lens, m, init + [0])
    with pytest.raises(TypeError):
        t_scan.bitap_lanes(text, starts.int(), lens, m, init)
    with pytest.raises(ValueError):
        t_scan.lanes_machine(q.folded_mask, t_engine._sticky_consts(q), 9,
                             None, "cpu")


# ---------------------------------------------------------------------
# line_index with a delimiter byte
# ---------------------------------------------------------------------

@pytest.mark.parametrize("delim", [0x0A, ord("o"), ord("$"), 0])
@pytest.mark.parametrize("n", [0, 1, 17, 4096, 70001])
def test_line_index_cuts_at_the_delimiter(delim, n):
    """The reference's lines equal a numpy cut at the byte, in length
    order by len_key, stable."""
    rng = np.random.default_rng(n + delim)
    text = rng.choice(np.frombuffer(b"ab\nxyo$\x00", np.uint8), n)
    idx = t_renfa_kernel.line_index(torch.from_numpy(text.copy()), delim)
    nl = np.flatnonzero(text == delim)
    starts = np.concatenate([[0], nl[:-1] + 1]) if len(nl) else nl
    lens = nl - starts
    order = np.argsort(t_renfa_kernel.len_key(torch.from_numpy(lens))
                       .numpy(), kind="stable")
    assert np.array_equal(idx.nl.numpy(), nl)
    assert np.array_equal(idx.starts.numpy(), starts[order])
    assert np.array_equal(idx.lens.numpy(), lens[order])
    assert np.array_equal(idx.ords.numpy(), order)
    assert idx.last == (int(nl[-1]) if len(nl) else -1)


def test_line_index_default_is_the_newline():
    text = torch.from_numpy(np.frombuffer(b"ab\n\ncd o\nx", np.uint8).copy())
    a, b = t_renfa_kernel.line_index(text), t_renfa_kernel.line_index(
        text, 0x0A)
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)
    assert a.last == b.last == 8
    with pytest.raises(ValueError):
        t_renfa_kernel.line_index(text, 256)


# ---------------------------------------------------------------------
# the CLI and memagrep against agrep_tpu
# ---------------------------------------------------------------------

def _corpus(seed: int, n: int, delim: bytes = b"\n") -> bytes:
    rng = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        k = int(rng.integers(1, 9))
        out += b" ".join(WORDS[i] for i in rng.integers(0, len(WORDS), k))
        out += delim if rng.random() < 0.8 else b" "
    return bytes(out[:n])


def _file(api, argv):
    buf = io.BytesIO()
    rc = api.fileagrep(argv, output=buf)
    return buf.getvalue(), rc & 0xFF


def _mem(api, argv, data):
    buf = io.BytesIO()
    rc = api.memagrep(argv, data, output=buf)
    return buf.getvalue(), rc & 0xFF


CLI_CASES = [
    ("wild_n", ["-n", "appr#mate"]),
    ("wild_c", ["-c", "h#o"]),
    ("wild_v_b", ["-v", "-b", "ko#la"]),
    ("p_c", ["-p", "-c", "aproximat"]),
    ("p_k1_n", ["-1", "-p", "-n", "hlo"]),
    ("wild_and", ["-n", "al#ha;ko#la"]),
    ("wild_and_v", ["-v", "-c", "al#ha;zz"]),
    ("wild_costs", ["-2", "-D2", "-I1", "-S1", "-n", "br#vo"]),
    ("wild_l", ["-l", "br#vo"]),
    ("wild_d_o", ["-d", "o", "-n", "h#l"]),
    ("p_d_dollar", ["-p", "-d", "$$", "-n", "aproximat"]),
    ("wild_d_ll", ["-d", "ll", "-c", "ko#la"]),
]


@pytest.mark.parametrize("backend", ["torch", "numpy"])
@pytest.mark.parametrize("size", [3000, 70000], ids=["small", "past_49152"])
@pytest.mark.parametrize("name,argv", CLI_CASES, ids=[c[0] for c in CLI_CASES])
def test_cli_matches_agrep_tpu(tmp_path, name, argv, size, backend):
    """fileagrep on both packages over the same file (past 49,152 bytes
    the glitch byte lies in a lane)."""
    t_scan.set_backend(backend)
    path = tmp_path / "corpus.txt"
    path.write_bytes(_corpus(size, size))
    got = _file(t_api, argv + [str(path)])
    want = _file(j_api, argv + [str(path)])
    assert got == want, name


MEM_CASES = CLI_CASES + [
    ("wild_lead", ["-n", "h#o"]),
    ("p_k2", ["-2", "-p", "-n", "hello"]),
]


@pytest.mark.parametrize("backend", ["torch", "numpy"])
@pytest.mark.parametrize("lead", [b"\n", b"", b"hello "],
                         ids=["newline", "none", "text"])
@pytest.mark.parametrize("name,argv", MEM_CASES, ids=[c[0] for c in MEM_CASES])
def test_memagrep_matches_agrep_tpu(name, argv, lead, backend):
    """memagrep's sticky searches on both packages: the first record
    from Init0, odd and even buffers, with and without a leading
    delimiter."""
    t_scan.set_backend(backend)
    for n in (2999, 3000):
        data = lead + _corpus(n, n)
        assert _mem(t_api, argv, data) == _mem(j_api, argv, data), (name, n)


def test_torch_route_never_calls_the_host_lanes(tmp_path, monkeypatch):
    """On the torch backend a one-byte delimiter's sticky machine runs
    line_index, bitap_lanes and line_rows, in the file path and in
    memory mode, and never the host's scan_lanes or its lane events; a
    multi-byte delimiter keeps the host's sequential scan."""
    def refused(*a, **k):
        raise AssertionError("the torch route called the host lanes")

    calls = {"bitap_lanes": 0, "line_index": 0, "line_rows": 0}
    for mod, name in ((t_scan, "bitap_lanes"),
                      (t_renfa_kernel, "line_index"),
                      (t_renfa_kernel, "line_rows")):
        def counted(*a, _fn=getattr(mod, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    monkeypatch.setattr(t_scan, "scan_lanes", refused)
    monkeypatch.setattr(t_engine, "_bitap_record_lane_events", refused)
    monkeypatch.setattr(t_engine.BitapEngine, "_memory_search_loop", refused)
    data = _corpus(7, 5000)
    path = tmp_path / "c.txt"
    path.write_bytes(data)
    for argv in (["-n", "h#o"], ["-p", "-c", "hlo"], ["-d", "o", "br#vo"]):
        assert _file(t_api, argv + [str(path)]) == _file(
            j_api, argv + [str(path)])
        assert _mem(t_api, argv, data) == _mem(j_api, argv, data)
    assert calls == {"bitap_lanes": 6, "line_index": 6, "line_rows": 6}
    # the multi-byte delimiter: the sequential host scan, no lanes
    monkeypatch.setattr(t_engine.BitapEngine, "_memory_search_loop", LOOP)
    before = dict(calls)
    argv = ["-d", "ll", "-n", "h#o"]
    assert _file(t_api, argv + [str(path)]) == _file(j_api,
                                                     argv + [str(path)])
    assert _mem(t_api, argv, data) == _mem(j_api, argv, data)
    assert calls == before

