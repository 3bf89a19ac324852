"""The port's span recorder (agrep_tpu_torch/runtime/trace.py) on the CPU
torch backend (the plain PyTorch versions, AGREP_TORCH_DEVICE=cpu).

Through Query.search_buffer, with the two Glimpse queries the benchmark
runs (-1 -n matching, and -2 'appro[a-z]*mat(e|ion)'), each search must
open one root `search` span and every other span carry its id; a child
lies inside its parent in time; `upload` and `readback` lie under
`device_layer`, `walk` under `search` and outside the device layer; the
timers are the spans' sums by name; and the sink's records_printed and
bytes_printed are what the search printed.  With tracing off nothing is
recorded and no counter moves; trace.enable switches the level without
the environment; a span inside another of its name is not recorded; two
threads searching at once keep their own trees; with AGREP_TORCH_PROFILE
each span opens a torch.profiler record_function of its name.
"""

from __future__ import annotations

import io
import sys
import threading

import numpy as np
import pytest

import agrep_tpu_torch.api as t_api
from agrep_tpu_torch.ops import scan as t_scan
from agrep_tpu_torch.runtime import trace

from .torch_oracle import one_thread

QUERIES = [["-1", "-n", "matching"], ["-2", "appro[a-z]*mat(e|ion)"]]
WORDS = [b"hello", b"world", b"matching", b"matchng", b"approximate",
         b"aproximate", b"approximation", b"the", b"fox", b"barbaz"]


@pytest.fixture(autouse=True)
def _cpu_traced():
    """The torch backend on the CPU, tracing at level 2 with nothing
    recorded before the test; the level, backend and device restored."""
    saved = (t_scan._BACKEND, t_scan._DEVICE, trace.ENABLED,
             trace.DETAILED, trace.PROFILE_DIR)
    t_scan.set_backend("torch")
    t_scan.set_device("cpu")
    trace.enable(2)
    trace.reset()
    with one_thread():
        yield
    trace.reset()
    (t_scan._BACKEND, t_scan._DEVICE, trace.ENABLED, trace.DETAILED,
     trace.PROFILE_DIR) = saved


def _buffer(seed: int, lines: int = 2000) -> bytes:
    """A Glimpse buffer: a newline, then lines of five seeded words."""
    rng = np.random.default_rng(seed)
    body = b"\n".join(b" ".join(rng.choice(WORDS, 5)) for _ in range(lines))
    return b"\n" + body + b"\n"


def _search(q, buf: bytes) -> tuple:
    out = io.BytesIO()
    n = q.search_buffer(buf, output=out)
    return n, out.getvalue()


def _ancestors(rec, by_id) -> list:
    names = []
    while rec[2] is not None:
        rec = by_id[rec[2]]
        names.append(rec[3])
    return names


@pytest.mark.parametrize("argv", QUERIES, ids=["bitap", "regex"])
def test_one_span_tree_a_search(argv):
    q = t_api.Query(argv=argv)
    trace.reset()
    outs = [_search(q, _buffer(seed)) for seed in (1, 2)]
    spans = trace.take_spans()
    assert trace.take_spans() == []
    roots = [s for s in spans if s[2] is None]
    assert [s[3] for s in roots] == ["search", "search"]
    assert roots[0][0] != roots[1][0]
    by_id = {s[1]: s for s in spans}
    for root in roots:
        assert root[0] == root[1]
        mine = [s for s in spans if s[0] == root[0]]
        names = {s[3] for s in mine}
        assert {"search", "scan", "device_layer", "upload", "readback",
                "walk"} <= names, names
        for s in mine:
            if s[2] is None:
                continue
            parent = by_id[s[2]]
            assert parent[0] == root[0]
            assert parent[4] <= s[4] <= s[5] <= parent[5], (s, parent)
            up = _ancestors(s, by_id)
            assert up[-1] == "search"
            if s[3] in ("upload", "readback"):
                assert "device_layer" in up, (s, up)
                assert s[6] > 0
            if s[3] == "walk":
                assert "device_layer" not in up
            if s[3] == "device_layer":
                assert "device_layer" not in up
    assert len(spans) == len({s[1] for s in spans})
    for name in {s[3] for s in spans}:
        assert trace.timers[name] == pytest.approx(
            sum(s[5] - s[4] for s in spans if s[3] == name), abs=1e-12)
    matched = sum(n for n, _ in outs)
    printed = b"".join(o for _, o in outs)
    assert matched > 0
    assert trace.counters["records_printed"] == matched
    assert trace.counters["records_printed"] == printed.count(b"\n")
    assert trace.counters["bytes_printed"] == len(printed)


@pytest.mark.parametrize("argv", QUERIES, ids=["bitap", "regex"])
def test_off_records_nothing(argv):
    q = t_api.Query(argv=argv)
    buf = _buffer(3)
    want = _search(q, buf)
    trace.reset()
    trace.enable(0)
    counters, timers = dict(trace.counters), dict(trace.timers)
    assert _search(q, buf) == want
    assert trace.take_spans() == []
    assert trace.counters == counters and trace.timers == timers
    off = trace.span("upload", 5)
    assert off is trace.span("walk") is trace.search()
    with off:
        pass


def test_enable_sets_the_level_without_the_environment():
    q = t_api.Query(argv=QUERIES[0])
    buf = _buffer(4)
    trace.take_spans()
    trace.enable(0)
    assert not trace.ENABLED and not trace.DETAILED
    _search(q, buf)
    assert trace.take_spans() == []
    trace.enable(1)
    assert trace.ENABLED and not trace.DETAILED
    _search(q, buf)
    assert [s[3] for s in trace.take_spans()].count("search") == 1
    trace.enable(2)
    assert trace.ENABLED and trace.DETAILED
    _search(q, buf)
    assert [s[3] for s in trace.take_spans()].count("search") == 1


def test_only_the_outermost_span_of_a_name_is_recorded():
    with trace.span("device_layer"):
        with trace.span("device_layer"):
            with trace.span("upload", 7):
                pass
    (up, layer) = trace.take_spans()
    assert (layer[3], up[3], up[6]) == ("device_layer", "upload", 7)
    assert up[2] == layer[1] and layer[2] is None
    assert up[0] == layer[0] == layer[1]
    assert set(trace.timers) == {"device_layer", "upload"}


def test_threads_keep_their_own_trees():
    """Thread a holds a root open while thread b runs a whole search,
    then both search at once: no span is parented across threads."""
    q = t_api.Query(argv=QUERIES[1])
    buf = _buffer(5)
    trace.take_spans()
    opened, b_done = threading.Event(), threading.Event()
    outs = {}

    def a():
        with trace.search():
            opened.set()
            b_done.wait(60)
            with trace.span("walk"):
                pass

    def b():
        opened.wait(60)
        outs["b"] = _search(q, buf)
        b_done.set()

    ts = [threading.Thread(target=f) for f in (a, b)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    spans = trace.take_spans()
    roots = {s[1]: s for s in spans if s[2] is None}
    assert len(roots) == 2
    a_root = next(s for s in spans if s[3] == "walk"
                  and s[2] in roots)[2]
    b_spans = [s for s in spans if s[0] != a_root]
    assert len(b_spans) > 3 and all(s[2] != a_root for s in b_spans)
    assert outs["b"] == _search(q, buf)
    trace.take_spans()

    barrier = threading.Barrier(2)
    got = {}

    def both(k):
        barrier.wait(60)
        got[k] = _search(q, _buffer(6 + k))

    ts = [threading.Thread(target=both, args=(k,)) for k in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    spans = trace.take_spans()
    by_id = {s[1]: s for s in spans}
    roots = [s for s in spans if s[2] is None]
    assert sorted(s[3] for s in roots) == ["search", "search"]
    for s in spans:
        if s[2] is not None:
            assert by_id[s[2]][0] == s[0]
    for k in (0, 1):
        assert got[k] == _search(q, _buffer(6 + k))


def test_threads_lose_no_span():
    """More threads than cores, switching every microsecond, each opening
    nested spans: every span is recorded once, under its own thread's
    root, and the timers hold every span's time."""
    n_threads, rounds = 24, 200
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(rounds):
                with trace.search():
                    with trace.span("device_layer"):
                        with trace.span("upload", 1):
                            pass
                        with trace.span("readback", 2):
                            pass
        ts = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(saved)
    spans = trace.take_spans()
    assert len(spans) == 4 * n_threads * rounds
    by_id = {s[1]: s for s in spans}
    for s in spans:
        if s[2] is None:
            assert s[3] == "search" and s[0] == s[1]
        else:
            assert by_id[s[2]][0] == s[0]
            assert by_id[s[2]][4] <= s[4] <= s[5] <= by_id[s[2]][5]
    for name in ("search", "device_layer", "upload", "readback"):
        assert trace.timers[name] == pytest.approx(
            sum(s[5] - s[4] for s in spans if s[3] == name), rel=1e-9)


def test_profiler_sees_each_span(tmp_path):
    import torch
    from torch.profiler import ProfilerActivity, profile
    trace.PROFILE_DIR = str(tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("device_layer"):
            with trace.span("upload", 3):
                torch.zeros(4).add_(1)
    names = {e.name for e in prof.events()}
    assert {"device_layer", "upload"} <= names
    assert [s[3] for s in trace.take_spans()] == ["upload", "device_layer"]
