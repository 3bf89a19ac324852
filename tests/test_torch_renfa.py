"""The port's regex lanes against agrep_tpu, bit for bit, on the CPU.

  * kernel module: agrep_tpu_torch's renfa_lines_reference verdicts
    (renfa_lines on CPU tensors, launched as the regex engine launches
    it) against agrep_tpu's Pallas lanes kernel run in interpret mode
    (pallas_scan_records) and against its numpy lanes
    (renfa._scan_records_np), as are the port's numpy lanes
    (renfa.scan_records): the patterns of tests/test_renfa_kernel.py
    and the REGEXES of tests/test_conformance_more.py, D = 0..4, -i,
    ^/$ anchors, empty lines, a machine near the 30-position limit;
  * compiled state: the port's re_mc against agrep_tpu's, field by
    field, and machine_from_mc on either;
  * the four nxt byte tables against the scalar nxt;
  * the wrapper: a CPU tensor runs the plain version, another device
    raises; the numpy backend answers a regex -c through the native C
    twin (native.renfa_scan_lines).

A verdict is one bit, so every comparison is exact.  The CUDA kernel
itself is held against renfa_lines_reference by chip_smoke.py on the
GPU.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

from agrep_tpu.compile.query import compile_query as j_compile
from agrep_tpu.ops import renfa as j_renfa
from agrep_tpu.ops.renfa_kernel import pallas_scan_records
from agrep_tpu.options import Options as JOptions
import agrep_tpu_torch.api as t_api
from agrep_tpu_torch import native as t_native
from agrep_tpu_torch.compile.query import compile_query as t_compile
from agrep_tpu_torch.ops import renfa as t_renfa
from agrep_tpu_torch.ops import renfa_kernel as t_rk
from agrep_tpu_torch.ops import scan as t_scan
from agrep_tpu_torch.options import Options as TOptions

# tests/test_renfa_kernel.py's patterns, then the REGEXES of
# tests/test_conformance_more.py that compile to the regex engine (".bc",
# "gr[ae]y" and "[xh]b?c" go to bitap), each at the D it runs with here
MACHINES = [
    ("ab*c", 0, False), ("a(bc|de)f", 1, False), ("[a-d]x*[0-9]", 1, False),
    ("ab*c", 2, False), ("x.*y", 1, False), ("wo(r|t)king", 2, False),
    ("ab*c", 1, False), ("a(b|d)c", 0, False), ("a(b|d)c", 3, False),
    ("colou|or", 2, False), ("h(el)*lo", 2, False), ("ab.*ld", 0, False),
    ("ab.*ld", 4, False),
    ("appro[a-z]*mat(e|ion)", 0, False), ("appro[a-z]*mat(e|ion)", 1, False),
    ("appro[a-z]*mat(e|ion)", 2, False), ("appro[a-z]*mat(e|ion)", 3, False),
    ("appro[a-z]*mat(e|ion)", 4, False), ("appro[a-z]*mat(e|ion)", 2, True),
    ("h(el)*lo", 1, True), ("^wo(r|t)king", 1, False), ("ab*c$", 0, False),
    ("^a(b|d)c$", 2, False), ("^h(el)*lo", 3, True),
    ("abcdefghijklmnopqrstuvwxy(z|0)", 0, False),
    ("abcdefghijklmnopqrstuvwxy(z|0)", 3, False),
]
IDS = ["%s_D%d%s" % (p, d, "_i" if i else "") for p, d, i in MACHINES]
ALPHA = b"abcdefghijklmnopqrstuvwxyz0189 .ABCXY\t"
PLANTS = [b"abbbc", b"abc", b"adc", b"adef", b"ax3", b"xqqy", b"working",
          b"grey", b"colour", b"hellello", b"approximate", b"APPROXIMATION",
          b"aproxmation", b"abd", b"hbc", b"abxyzld",
          b"abcdefghijklmnopqrstuvwxy0"]


@pytest.fixture(autouse=True)
def _backend():
    saved = (t_scan._BACKEND, t_scan._DEVICE)
    t_scan.set_backend("torch")
    t_scan.set_device("cpu")
    yield
    t_scan._BACKEND, t_scan._DEVICE = saved


def _opts(cls, d, nocase):
    return cls(D=d, approx=d > 0, nocase="i" if nocase else None)


def _mcs(pattern, d, nocase):
    tq = t_compile(pattern, _opts(TOptions, d, nocase))
    jq = j_compile(pattern, _opts(JOptions, d, nocase))
    assert tq.engine_class == jq.engine_class == "regex"
    return tq.re_mc, jq.re_mc


def _lanes(seed, R=121, L=48):
    """u8[R, L] lanes (line bytes, '\\n', zero padding) and their
    lengths: random lines from ALPHA, every PLANTS entry planted
    twice, once at a line's start and once at its end, and every other
    seventh line empty."""
    rng = np.random.default_rng(seed)
    lanes = np.zeros((R, L), dtype=np.uint8)
    lens = rng.integers(1, L - 1, R).astype(np.int64)
    lens[::7] = 0
    for r in range(R):
        plant = r % 3 == 1
        if plant:
            q = r // 3
            p = PLANTS[q % len(PLANTS)]
            lens[r] = max(int(lens[r]), len(p) + 2)
        n = int(lens[r])
        lanes[r, :n] = np.frombuffer(ALPHA, np.uint8)[
            rng.integers(0, len(ALPHA), n)]
        if plant:
            off = 0 if q % 2 else n - len(p)
            lanes[r, off:off + len(p)] = np.frombuffer(p, np.uint8)
        lanes[r, n] = 0x0A
    return lanes, lens


def _port_verdicts(lanes, lens, mc, init):
    """renfa_lines on a CPU tensor (its plain version), as the regex
    engine launches it: the lanes flattened into one text, line r
    starting at r * L, every line from init."""
    R, L = lanes.shape
    text = torch.from_numpy(np.ascontiguousarray(lanes).reshape(-1))
    starts = torch.arange(R, dtype=torch.int64) * L
    return t_rk.renfa_lines(text, starts, torch.from_numpy(lens),
                            t_rk.machine_from_mc(mc, "cpu"), init).numpy()


@pytest.mark.parametrize("pattern,d,nocase", MACHINES, ids=IDS)
def test_reference_matches_numpy_lanes(pattern, d, nocase):
    t_mc, j_mc = _mcs(pattern, d, nocase)
    lanes, lens = _lanes(len(pattern) * 10 + d)
    cont, _ = j_renfa.step_newline(list(j_mc["inits"]),
                                   int(j_mc["mask"][0x0A]), j_mc)
    n_hits = 0
    for init in (cont, list(j_mc["inits"])):
        want = j_renfa._scan_records_np(lanes, lens, j_mc, init, init)
        got = _port_verdicts(lanes, lens, t_mc, init)
        assert np.array_equal(got, want), (pattern, d, nocase, init)
        assert np.array_equal(
            t_renfa.scan_records(lanes, lens, t_mc, init, init), want)
        n_hits += int(want.sum())
    assert n_hits
    # lane 0 from other states than the rest: a launch of its own, as
    # memory mode's leading line
    seed = list(j_mc["inits"])
    want = j_renfa._scan_records_np(lanes, lens, j_mc, seed, cont)
    got = _port_verdicts(lanes, lens, t_mc, cont)
    got[0] = _port_verdicts(lanes[:1], lens[:1], t_mc, seed)[0]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("pattern,d,nocase",
                         [("ab*c", 0, False), ("a(bc|de)f", 1, True)])
def test_reference_matches_pallas_interpret(pattern, d, nocase):
    """The Pallas TPU kernel in interpret mode: every lane starts from
    the post-newline states, the kernel's own contract."""
    t_mc, j_mc = _mcs(pattern, d, nocase)
    lanes, lens = _lanes(d + 5, R=40, L=32)
    cont, _ = j_renfa.step_newline(list(j_mc["inits"]),
                                   int(j_mc["mask"][0x0A]), j_mc)
    want = pallas_scan_records(lanes, lens, j_mc, interpret=True)
    assert want is not None
    got = _port_verdicts(lanes, lens, t_mc, cont)
    assert np.array_equal(got, want)
    assert np.array_equal(
        got, j_renfa._scan_records_np(lanes, lens, j_mc, cont, cont))


@pytest.mark.parametrize("pattern,d,nocase", MACHINES, ids=IDS)
def test_compiled_machine_matches_agrep_tpu(pattern, d, nocase):
    t_mc, j_mc = _mcs(pattern, d, nocase)
    for k in ("M", "D", "init0", "init1", "no_err", "tail"):
        assert t_mc[k] == j_mc[k], k
    assert [int(x) for x in t_mc["inits"]] == [int(x) for x in j_mc["inits"]]
    assert int(t_mc["head_bit"]) == int(j_mc["head_bit"])
    for k in ("follow_bits", "mask"):
        assert np.array_equal(t_mc[k], j_mc[k]), k
    a = t_rk.machine_from_mc(t_mc, "cpu")
    b = t_rk.machine_from_mc(j_mc, "cpu")
    assert torch.equal(a.tables, b.tables)
    assert a.tables.shape == (5, 256) and a.tables.dtype == torch.uint32
    assert (a.head_bit, a.init1, a.no_err, a.D, a.tail, a.M) == (
        b.head_bit, b.init1, b.no_err, b.D, b.tail, b.M)


@pytest.mark.parametrize("pattern,d,nocase", MACHINES[::3],
                         ids=IDS[::3])
def test_nxt_byte_tables_equal_scalar_nxt(pattern, d, nocase):
    t_mc, _ = _mcs(pattern, d, nocase)
    tabs = t_renfa.nxt_byte_tables(t_mc).astype(np.int64)
    rng = np.random.default_rng(7)
    states = rng.integers(0, 1 << 32, 500, dtype=np.int64)
    states[:3] = (0, 0xFFFFFFFF, t_mc["init0"])
    got = (int(t_mc["head_bit"]) | tabs[0][states & 255]
           | tabs[1][(states >> 8) & 255] | tabs[2][(states >> 16) & 255]
           | tabs[3][states >> 24])
    want = [t_mc["nxt"](int(s)) for s in states]
    assert got.tolist() == want


def test_renfa_lines_on_cpu_runs_the_plain_version():
    t_mc, _ = _mcs("h(el)*lo", 1, False)
    m = t_rk.machine_from_mc(t_mc, "cpu")
    text = torch.from_numpy(np.frombuffer(
        b"\nhello\nhelo world\n\nhellelo\nxyz\n", np.uint8).copy())
    starts = torch.tensor([1, 7, 18, 19, 27])
    lens = torch.tensor([5, 10, 0, 7, 3])
    before = dict(t_rk.launches)
    got = t_rk.renfa_lines(text, starts, lens, m, t_mc["inits"])
    assert got.dtype == torch.bool
    assert got.tolist() == [True, True, False, True, False]
    assert torch.equal(got, t_rk.renfa_lines_reference(
        text, starts, lens, m, t_mc["inits"]))
    assert t_rk.launches == before
    # an empty line takes its verdict straight from init
    assert t_rk.renfa_lines(text, starts[:0], lens[:0], m,
                            t_mc["inits"]).shape == (0,)


def test_renfa_lines_refuses_what_it_does_not_take():
    t_mc, _ = _mcs("h(el)*lo", 1, False)
    m = t_rk.machine_from_mc(t_mc, "cpu")
    text = torch.from_numpy(np.frombuffer(b"hello\n", np.uint8).copy())
    one = torch.tensor([0])
    with pytest.raises(ValueError, match="no regex lanes kernel"):
        t_rk.renfa_lines(text.to("meta"), one.to("meta"),
                         torch.tensor([5]).to("meta"),
                         t_rk.machine_from_mc(t_mc, "meta"), t_mc["inits"])
    with pytest.raises(ValueError, match="outside"):
        t_rk.renfa_lines(text, one, torch.tensor([6]), m, t_mc["inits"])
    with pytest.raises(ValueError, match="D\\+1"):
        t_rk.renfa_lines(text, one, torch.tensor([5]), m, [0])
    with pytest.raises(TypeError):
        t_rk.renfa_lines(text, one.int(), torch.tensor([5]), m,
                         t_mc["inits"])
    with pytest.raises(ValueError, match="D=5"):
        t_rk.machine_from_mc(dict(t_mc, D=5), "cpu")


def test_numpy_backend_regex_count_uses_the_native_twin(tmp_path,
                                                        monkeypatch):
    if t_native.get_lib() is None:
        pytest.skip("no C++ compiler for the native host library")
    f = tmp_path / "re.txt"
    f.write_bytes(b"abc def\nabd xyz\nxbc q\nhello world\nab\nabcabc\n")
    calls = []
    real = t_native.renfa_scan_lines

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(t_native, "renfa_scan_lines", counted)
    t_scan.set_backend("numpy")
    buf = io.BytesIO()
    assert t_api.fileagrep(["-c", "ab*c", str(f)], output=buf) == 2
    assert buf.getvalue().startswith(b"2\n")
    assert calls


def test_regex_compiles_and_runs_while_mgrep_still_raises():
    """The regex and the multi-pattern (mgrep) engines both compile and
    run now: a boolean query and a -m pattern buffer build MgrepEngine
    and search a buffer."""
    from agrep_tpu_torch.runtime.engine import Executor
    from agrep_tpu_torch.runtime.mgrep import MgrepEngine
    from agrep_tpu_torch.runtime.output import Sink
    from agrep_tpu_torch.runtime.regex_engine import RegexEngine
    q = t_compile("appro[a-z]*mat(e|ion)", TOptions(D=2, approx=True))
    assert isinstance(Executor(q, Sink(lambda b: None, q.opts)).engine,
                      RegexEngine)
    data = np.frombuffer(b"\nhello world\nworld\nhello\n", np.uint8)
    for q, want in ((t_compile("hello;world", TOptions()), 1),
                    (t_compile(None, TOptions(pat_buffer="world\nbye\n")),
                     2)):
        assert q.engine_class == "mgrep"
        out = []
        ex = Executor(q, Sink(out.append, q.opts))
        assert isinstance(ex.engine, MgrepEngine)
        assert ex.run_buffer(data) == want
        assert b"".join(out).count(b"world") == want
