"""The port's sparse event read-back against agrep_tpu, exactly, on the CPU.

  * kernel module: agrep_tpu_torch's event_pairs_reference (and the
    event_pairs wrapper, which takes it for a CPU tensor) against
    agrep_tpu.ops.kernels.planes_to_events followed by np.flatnonzero, on
    the same planes: the sgrep pulse, bitap with a delimiter plane, the
    cost wiring, an AND pattern's hit planes and 32 random hit planes;
    N = 0, 1, L-1, L, L+1 and 3L+17 with keep_from 0 and W; empty planes
    and planes with every bit set;
  * scan module: scan_event_pairs and the chunked scan_event_list on the
    torch backend (device cpu) against agrep_tpu's scan_events plus
    np.flatnonzero on its numpy backend, for BASELINE configs 1-3's
    machines and a -d record machine, across chunk seams;
  * the CLI: configs 1-3 (streamed), memagrep -c hello and bool5m at a
    small size through both packages, byte for byte, with the torch route
    never calling planes_to_events: config 1, memagrep and bool5m read
    their events through event_pairs, and configs 2-3 (the bitap
    engine) cut their records from the planes through record_verdicts
    without it.

Every value is an integer, so every comparison is exact.  The CUDA kernel
csrc/event_pairs.cu is held against event_pairs_reference by
chip_smoke.py on the GPU.
"""

from __future__ import annotations

import functools
import io
import os

import numpy as np
import pytest
import torch

import agrep_tpu.api as j_api
from agrep_tpu.compile.query import compile_query as j_compile
from agrep_tpu.ops import kernels as j_kernels
from agrep_tpu.ops import scan as j_scan
from agrep_tpu.options import parse_args as j_parse
import agrep_tpu_torch.api as t_api
from agrep_tpu_torch.ops import kernels as t_kernels
from agrep_tpu_torch.ops import scan as t_scan

L = t_scan.DEFAULT_TILE


@pytest.fixture(autouse=True)
def _backends():
    """Port on the plain PyTorch scan (CPU), reference on its exact
    numpy backend; both restored afterwards."""
    saved = (t_scan._BACKEND, t_scan._DEVICE, j_scan._BACKEND)
    t_scan.set_backend("torch")
    t_scan.set_device("cpu")
    j_scan.set_backend("numpy")
    yield
    t_scan._BACKEND, t_scan._DEVICE = saved[:2]
    j_scan.set_backend(saved[2])


def _halo(consts, D):
    return min(max(consts.get("m", 32) + D + 2, 48), L)


# (name, argv): BASELINE configs 1-3, a -d record machine (bitap) and an
# AND pattern of 12 parts (12 hit planes)
ARGVS = {
    "config1": ["-c", "hello"],
    "config2": ["-1", "-n", "matching"],
    "config3": ["-3", "-D2", "-I1", "-S1", "-w", "-i", "approximate"],
    "records": ["-1", "-n", "-d", "$$", "hello"],
    "parts12": ["-n", "a;b;c;d;e;f;g;h;i;j;k;l"],
}
PLANTS = (b"hello", b"helo", b"matching", b"matchng", b"approximate",
          b"APPROXIMATE", b"aproximate", b"\n\n")


@functools.lru_cache(maxsize=None)
def _machine(name):
    """(mask, consts, D, variant, costs) of agrep_tpu's compiled query."""
    opts, pattern, _ = j_parse(ARGVS[name] + ["x"])
    q = j_compile(pattern, opts)
    if q.engine_class == "sgrep":
        return q.sg_mask, dict(q.sg_consts), q.D, "sgrep", None
    return q.folded_mask, dict(q.consts), q.D, "bitap", q.costs


def _text(n, seed):
    """Printable bytes, a newline about every 40, planted words."""
    rng = np.random.default_rng(seed)
    text = rng.integers(97, 123, size=n, dtype=np.uint8)
    text[rng.integers(0, max(n, 1), n // 40 + 1) % max(n, 1)] = 0x0A
    for p in PLANTS:
        pb = np.frombuffer(p, dtype=np.uint8)
        if n > len(pb):
            for off in rng.integers(0, n - len(pb), max(1, n // 300)):
                text[off:off + len(pb)] = pb
    return text[:n]


def _want(planes, vals, W, N, keep_from):
    """agrep_tpu's read-back of the planes: planes_to_events a plane at
    a time, OR-ed as its _scan_pallas ORs them, then np.flatnonzero."""
    zero = np.zeros_like(planes[0])
    ev = np.zeros(N, dtype=np.uint32)
    for i, v in enumerate(vals):
        d, h, c = ((planes[0], zero, {"d_endpos": v, "endpos": 0}) if i == 0
                   else (zero, planes[i], {"d_endpos": 0, "endpos": v}))
        ev |= j_kernels.planes_to_events(d, h, c, W, L, N)
    pos = np.flatnonzero(ev[keep_from:]) + keep_from
    return pos, ev[pos]


def _check(planes, vals, W, N, keep_from):
    """event_pairs_reference and the CPU wrapper against _want; returns
    K."""
    pt = torch.from_numpy(planes)
    vt = torch.from_numpy(np.asarray(vals, dtype=np.uint32))
    want_p, want_w = _want(planes, vals, W, N, keep_from)
    for fn in (t_kernels.event_pairs_reference, t_kernels.event_pairs):
        pos, word = fn(pt, vt, W, L, N, keep_from)
        assert pos.dtype == torch.int64 and word.dtype == torch.uint32
        np.testing.assert_array_equal(pos.numpy(), want_p)
        np.testing.assert_array_equal(word.numpy(), want_w)
    return len(want_p)


SIZES = [0, 1, L - 1, L, L + 1, 3 * L + 17]


@functools.lru_cache(maxsize=None)
def _planes(name, N):
    """mask_scan_reference's planes of a machine over N bytes, and their
    values (kernels.event_vals); an empty text has no scan, so zero
    planes of its geometry."""
    mask, consts, D, variant, costs = _machine(name)
    m = t_kernels.machine_from_arrays(mask, consts, D, variant, costs)
    W = _halo(consts, D)
    vals = t_kernels.event_vals(m)
    if N == 0:
        T, nw = t_kernels.geometry(0, W, L)
        return np.zeros((len(vals), T, nw), dtype=np.uint32), vals, W
    text = torch.from_numpy(_text(N, N + len(name)))
    planes = t_kernels.mask_scan_reference(text, m, W, L).numpy()
    return planes, vals, W


@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("name", list(ARGVS))
def test_reference_matches_planes_to_events(name, N):
    planes, vals, W = _planes(name, N)
    got = [_check(planes, vals, W, N, kf) for kf in (0, W)]
    if N >= L:
        assert got[0] > 0, "no events -- test is vacuous"
    if name in ("config2", "config3", "records") and N >= L:
        assert planes[0].any(), "no delimiter events"


@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("fill", ["empty", "full", "random33"])
def test_reference_on_synthetic_planes(fill, N):
    """Planes with no bit, every bit (K = N - keep_from) and random bits,
    halo and padding columns included, which must be ignored; 33 planes
    with the delimiter value and 32 single-bit hit values."""
    W = 56
    T, nw = t_kernels.geometry(N, W, L)
    rng = np.random.default_rng(N)
    if fill == "random33":
        vals = [0x4000] + [1 << b for b in range(32)]
        planes = rng.integers(0, 1 << 32, (33, T, nw), dtype=np.uint64)
        planes &= rng.integers(0, 1 << 32, (33, T, nw), dtype=np.uint64)
        planes = planes.astype(np.uint32)
    else:
        vals = [0x200, 1]
        planes = np.full((2, T, nw), 0xFFFFFFFF if fill == "full" else 0,
                         dtype=np.uint32)
    for kf in (0, W):
        K = _check(planes, vals, W, N, kf)
        if fill == "full":
            assert K == max(N - kf, 0)
        if fill == "empty":
            assert K == 0


def test_planes_with_value_zero_add_nothing():
    planes, vals, W = _planes("config2", 3 * L + 17)
    assert planes[0].any() and planes[1].any()
    for v in ([0, vals[1]], [vals[0], 0], [0, 0]):
        _check(planes, v, W, 3 * L + 17, 0)


def test_wrapper_validates_and_counts_no_cpu_launch():
    planes, vals, W = _planes("config2", L + 1)
    pt = torch.from_numpy(planes)
    vt = torch.from_numpy(np.asarray(vals, dtype=np.uint32))
    before = t_kernels.launches["event_pairs"]
    t_kernels.event_pairs(pt, vt, W, L, L + 1)
    assert t_kernels.launches["event_pairs"] == before
    with pytest.raises(TypeError):
        t_kernels.event_pairs(pt.to(torch.int32), vt, W, L, L + 1)
    with pytest.raises(TypeError):
        t_kernels.event_pairs(pt, vt.to(torch.int64), W, L, L + 1)
    with pytest.raises(ValueError):          # not the scan's geometry
        t_kernels.event_pairs(pt, vt, W, L, 3 * L)
    with pytest.raises(ValueError):          # one value a plane
        t_kernels.event_pairs(pt, vt[:1], W, L, L + 1)
    with pytest.raises(ValueError):          # L a multiple of 32
        t_kernels.event_pairs(pt, vt, W, L - 8, L + 1)
    with pytest.raises(ValueError):
        t_kernels.event_pairs(pt[:, :, ::2], vt, W, L, L + 1)
    big = torch.zeros((34,) + tuple(pt.shape[1:]), dtype=torch.uint32)
    with pytest.raises(ValueError):          # 33 planes at most
        t_kernels.event_pairs(big, torch.zeros(34, dtype=torch.uint32), W,
                              L, L + 1)
    with pytest.raises(ValueError):
        t_kernels.event_pairs(pt, vt, W, L, L + 1, keep_from=-1)


# ---------------------------------------------------------------------
# scan module: pairs vs agrep_tpu's scan_events on its numpy backend
# ---------------------------------------------------------------------

SCAN_NAMES = ["config1", "config2", "config3", "records"]


@pytest.mark.parametrize("name", SCAN_NAMES)
def test_scan_event_pairs_match_agrep_tpu(name):
    mask, consts, D, variant, costs = _machine(name)
    W = _halo(consts, D)
    for n in (1, W - 1, L + 1, 3 * L + 17):
        text = _text(n, 7 * n)
        want = j_scan.scan_events(text, mask, consts, D, variant, costs)
        for kf in (0, min(W, n)):
            pos, ev = t_scan.scan_event_pairs(text, mask, consts, D,
                                              variant, costs, kf)
            assert pos.dtype == np.int64 and ev.dtype == np.uint32
            p = np.flatnonzero(want[kf:]) + kf
            np.testing.assert_array_equal(pos, p, err_msg="n=%d" % n)
            np.testing.assert_array_equal(ev, want[p], err_msg="n=%d" % n)
        np.testing.assert_array_equal(
            t_scan.scan_events(text, mask, consts, D, variant, costs), want)


@pytest.mark.parametrize("name", SCAN_NAMES)
def test_chunked_stream_matches_agrep_tpu(name, monkeypatch):
    """scan_event_list's chunks (each after the first with a W-byte halo
    it drops through keep_from) against agrep_tpu's whole-stream scan;
    the torch route reads back through event_pairs alone."""
    mask, consts, D, variant, costs = _machine(name)
    calls = []
    real = t_kernels.event_pairs

    def counted(*args):
        calls.append(args[5] if len(args) > 5 else 0)
        return real(*args)

    def refused(*args):
        raise AssertionError("the torch route called planes_to_events")

    monkeypatch.setattr(t_kernels, "event_pairs", counted)
    monkeypatch.setattr(t_kernels, "planes_to_events", refused)
    text = _text(9001, 11)
    batches = list(t_scan.scan_event_list(
        lambda lo, hi: text[lo:hi], len(text), mask, consts, D, variant,
        costs, chunk=2500))
    assert len(batches) == 4 and len(calls) == 4
    assert calls[0] == 0 and all(kf == _halo(consts, D) for kf in calls[1:])
    pos = np.concatenate([p for p, _ in batches])
    ev = np.concatenate([e for _, e in batches])
    want = j_scan.scan_events(text, mask, consts, D, variant, costs)
    np.testing.assert_array_equal(pos, np.flatnonzero(want))
    np.testing.assert_array_equal(ev, want[pos])
    assert len(pos), "no events -- test is vacuous"


# ---------------------------------------------------------------------
# the CLI: configs 1-3, memagrep and bool5m through both packages
# ---------------------------------------------------------------------

FILLER = (b"the quick brown fox pattern search world lorem ipsum dolor "
          b"string grep over lazy dog").split()
CLI_PLANTS = [b"hello", b"matching", b"matchng", b"Approximate",
              b"aproximate", b"approximately", b"HELLO"]
# bool5m's term of 136 byte classes, as the CLI gets it from the command
# line
WIDE_TERM = "hello" + os.fsdecode(b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
                                  + bytes(range(0xA0, 0x100)))


def _lines(n_bytes, seed, records=False):
    """Lines of 8 filler words, a planted word on about one in 30; with
    records, a blank line after every 8-16 lines (-d '$$')."""
    rng = np.random.default_rng(seed)
    out, total, k = [], 0, 0
    nxt = int(rng.integers(8, 17))
    while total < n_bytes:
        ws = [FILLER[i] for i in rng.integers(0, len(FILLER), 8)]
        if rng.integers(0, 30) == 0:
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


def _run(api, argv, data=None):
    buf = io.BytesIO()
    rc = (api.fileagrep(argv, output=buf) if data is None
          else api.memagrep(argv, data, output=buf))
    return buf.getvalue(), rc & 0xFF


# the runs of the bitap engine, which cut their records from the planes
RECORD_RUNS = ("config2", "config3")
CLI_RUNS = [
    ("config1", ARGVS["config1"], False, None),
    ("config2", ARGVS["config2"], False, None),
    ("config3", ARGVS["config3"], False, None),
    ("memagrep", ["-c", "hello"], False, "mem"),
    ("bool5m", ["-d", "$$", "hello;matching," + WIDE_TERM], True, None),
]


@pytest.mark.parametrize("name,argv,records,mode", CLI_RUNS,
                         ids=[r[0] for r in CLI_RUNS])
def test_cli_matches_agrep_tpu(tmp_path, monkeypatch, name, argv, records,
                               mode):
    """Files over the streaming threshold (shrunk, in both packages) take
    the chunked engines; bool5m's records stream is over the device
    route's 64 KiB, so its packed term words scan on the mask machine.
    The bitap engine's records (configs 2-3) come from the planes through
    record_verdicts, with no event_pairs call."""
    data = _lines(150_000, len(name), records)
    monkeypatch.setenv("AGREP_TORCH_STREAM_MB", "0")
    monkeypatch.setenv("AGREP_TPU_STREAM_MB", "0")
    monkeypatch.setattr(t_scan, "STREAM_CHUNK", 64 << 10)
    monkeypatch.setattr(j_scan, "STREAM_CHUNK", 64 << 10)
    calls = {"event_pairs": [], "record_verdicts": []}

    def counted(kname):
        real = getattr(t_kernels, kname)

        def call(*args, **kw):
            calls[kname].append(args[4])
            return real(*args, **kw)
        return call

    def refused(*args):
        raise AssertionError("the torch route called planes_to_events")

    for kname in calls:
        monkeypatch.setattr(t_kernels, kname, counted(kname))
    monkeypatch.setattr(t_kernels, "planes_to_events", refused)
    if mode == "mem":
        got = _run(t_api, argv, b"\n" + data)
        want = _run(j_api, argv, b"\n" + data)
    else:
        path = tmp_path / "corpus.txt"
        path.write_bytes(data)
        got = _run(t_api, argv + [str(path)])
        want = _run(j_api, argv + [str(path)])
    assert got == want, "port vs agrep_tpu for %s" % name
    assert got[0], "no output -- test is vacuous"
    kname = "record_verdicts" if name in RECORD_RUNS else "event_pairs"
    assert calls[kname], "%s read nothing through %s" % (name, kname)
    if name in RECORD_RUNS:
        assert not calls["event_pairs"], "%s wrote event pairs" % name
    if mode is None and name != "bool5m":
        sizes = calls[kname]
        assert len(sizes) > 1 and max(sizes) <= (64 << 10) + L, \
            "the chunked path did not run"
