"""The harness's arithmetic: the rate over the window, the p95 with its
sample count, the idle share from two clients' device events put on one
clock, and the roofline counts against hand counts."""

import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

import client  # noqa: E402
from agbench import harness, layout, roofline, stats  # noqa: E402


def test_rate_runs_from_the_barrier_to_the_last_completion():
    searches = [{"t1": 10.5, "bytes": 100}, {"t1": 12.0, "bytes": 300},
                {"t1": 11.0, "bytes": 200}, {"t1": None, "bytes": 999}]
    rate, span = stats.search_rate(10.0, searches)
    assert span == pytest.approx(2.0)
    assert rate == pytest.approx(600 / 2.0)
    assert stats.search_rate(10.0, []) == (None, None)


def test_p95_by_nearest_rank_with_its_count():
    assert stats.percentile(range(1, 101), 95) == (95, 100)
    assert stats.percentile([5.0], 95) == (5.0, 1)
    assert stats.percentile([3, 1, 2], 95) == (3, 3)
    assert stats.percentile([], 95) == (None, 0)


def test_union_busy_and_gaps():
    ivs = [(1.0, 3.0), (2.0, 4.0), (6.0, 7.0), (8.0, 8.0)]
    assert stats.union(ivs) == [(1.0, 4.0), (6.0, 7.0)]
    assert stats.busy(ivs, 0.0, 10.0) == pytest.approx(4.0)
    assert stats.busy(ivs, 2.5, 6.5) == pytest.approx(2.0)
    assert stats.gaps(ivs, 0.0, 10.0) == [(0.0, 1.0), (4.0, 6.0),
                                          (7.0, 10.0)]


def _trace(path, marker_ts, events):
    with open(path, "w") as fh:
        json.dump({"traceEvents": [
            {"ph": "X", "cat": "user_annotation", "name": "agbench.marker",
             "ts": marker_ts, "dur": 1}] + events}, fh)


def test_two_clients_with_offset_clocks_share_one_window(tmp_path):
    """Each client's profiler counts from its own origin; its marker,
    stamped at a known perf_counter time, puts its events on the shared
    clock.  Client a runs a kernel on [1.0, 2.0] s and a copy on [2.5,
    3.0]; client b a kernel on [1.5, 2.2]: busy 1.7 s of a 4 s window."""
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    _trace(a, 5e6, [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 5e6 + 1e6,
         "dur": 1e6},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable)",
         "ts": 5e6 + 2.5e6, "dur": 0.5e6},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 5e6,
         "dur": 9e6}])
    _trace(b, 123.0, [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 123.0 + 1.5e6,
         "dur": 0.7e6}])
    ev_a = client._device_events(str(a), 0.0)      # marker at t = 0.0
    ev_b = client._device_events(str(b), 0.0)
    assert [e[2] for e in ev_a] == ["kernel", "h2d"]
    assert ev_a[0][:2] == pytest.approx((1.0, 2.0))
    assert ev_b[0][:2] == pytest.approx((1.5, 2.2))
    ev = [(s, e) for s, e, _k, _n in ev_a + ev_b]
    assert stats.busy(ev, 0.0, 4.0) == pytest.approx(1.7)
    bundle = {"window": (0.0, 4.0),
              "device": [(s, e, k, n, 0) for s, e, k, n in ev_a]
              + [(s, e, k, n, 1) for s, e, k, n in ev_b],
              "searches": [{"key": "f"}, {"key": "f"}],
              "spans": [(0, "search", 0.0, 4.0),
                        (0, "device_layer", 2.2, 2.6),
                        (1, "search", 0.0, 3.5)]}
    idle = layout.metric("device_idle_pct").read(bundle)
    assert idle == pytest.approx(100 * (1 - 1.7 / 4.0))
    assert layout.metric("kernel_ms").read(bundle) == \
        pytest.approx(1e3 * 1.7 / 2)
    assert layout.metric("h2d_ms").read(bundle) == pytest.approx(250.0)
    out = harness.breakdown(bundle)
    assert out["idle_gaps"][0] == ["host", pytest.approx(1.0)]
    assert ["device_layer+host", pytest.approx(0.3)] in out["idle_gaps"]
    assert out["device_ops"][0][0] == "k"


def test_trace_without_marker_is_refused(tmp_path):
    p = tmp_path / "t.json"
    with open(p, "w") as fh:
        json.dump({"traceEvents": []}, fh)
    with pytest.raises(RuntimeError):
        client._device_events(str(p), 0.0)


def test_bitap_counts_by_hand():
    # -1 matching: D = 1, no costs, one hit mask, a delimiter:
    # 2 + (3 + 6) + 2 + 2 + 2 = 17 operations a byte
    m = {"kind": "bitap", "D": 1, "costs": None, "hit_masks": 1,
         "delimiter": True}
    n = 1000
    want = max((n + 24 * 3 + 1024) / roofline.HBM_BYTES_PER_S,
               17 * n / roofline.INT32_OPS_PER_S,
               n / roofline.SHARED_LOADS_PER_S)
    assert roofline.least_seconds(m, n, 20, 980, 3) == pytest.approx(want)
    assert roofline.least_seconds(m, 100 << 20, 0, 0, 0) == \
        pytest.approx(17 * (100 << 20) / roofline.INT32_OPS_PER_S)


def test_regex_counts_by_hand():
    # D = 2, M = 14 (13 positions, <= 15: one table load a step):
    # a byte 2 + 2 + 2 + 2 * (4 + 2) = 18 operations and 1 + 3 = 4
    # loads; a line's verdict 3 operations
    m = {"kind": "regex", "D": 2, "M": 14}
    lines, line_bytes, rows = 10, 480, 2
    n = line_bytes + lines
    want = max((n + 24 * rows + 1024 + 56) / roofline.HBM_BYTES_PER_S,
               (18 * line_bytes + 3 * lines) / roofline.INT32_OPS_PER_S,
               4 * line_bytes / roofline.SHARED_LOADS_PER_S)
    assert roofline.least_seconds(m, n, lines, line_bytes, rows) == \
        pytest.approx(want)


def test_config_machines_match_their_patterns():
    sys.path.insert(0, os.path.join(BENCH, "reference"))
    import ref_approx
    bench = layout.benchmark()
    for c in bench["configs"]:
        cfg = layout.config(bench, c["name"])
        m = cfg["roofline"]
        if m["kind"] == "regex":
            assert m["M"] == ref_approx.Regex(cfg["pattern"].encode()).n
            assert m["D"] == cfg["k"]
        if m["kind"] == "bitap":
            assert m["D"] == cfg["k"]


def test_layer_means_leave_out_compile_and_device_layer():
    s = [{"t0": 0.0, "t1": 0.010, "compile_s": 0.001, "layer_s": 0.004},
         {"t0": 1.0, "t1": 1.030, "compile_s": 0.003, "layer_s": 0.006}]
    bundle = {"searches": s}
    assert layout.metric("device_layer_ms").read(bundle) == \
        pytest.approx(5.0)
    assert layout.metric("host_ms").read(bundle) == pytest.approx(13.0)
    for x in s:
        x["compile_s"] = 0.0
    assert layout.metric("host_ms").read(bundle) == pytest.approx(15.0)
    assert layout.metric("search_p95_ms").read(bundle) == \
        (pytest.approx(30.0), {"samples": 2})


def test_roofline_share_reads_nothing_without_kernels():
    machine = {"kind": "bitap", "D": 0, "costs": None, "hit_masks": 1,
               "delimiter": True}
    bundle = {"window": (0.0, 1.0), "device": [(0.1, 0.2, "h2d", "c", 0)],
              "config": {"roofline": machine},
              "searches": [{"key": "f"}],
              "inputs": {"f": {"n_bytes": 1 << 20, "n_lines": 1,
                               "line_bytes": 1, "rows": 0}}}
    assert layout.metric("scan_roofline_pct").read(bundle) is None
    bundle["device"].append((0.3, 0.3 + 1e-3, "kernel", "k", 0))
    least = roofline.least_seconds(machine, 1 << 20, 1, 1, 0)
    assert layout.metric("scan_roofline_pct").read(bundle) == \
        pytest.approx(100 * least / 1e-3)
