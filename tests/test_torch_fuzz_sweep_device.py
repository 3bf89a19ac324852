"""tools/torch_fuzz_sweep.py --device-route on the CPU: corpora grown
past mgrep.DEVICE_MIN, so that -f sets and booleans take the port's
device route (the plain versions of chain_scan, qgram_filter and the
mask machine's packed term words), with the past-caps stratum (every
seed divisible by 3), against agrep_tpu on its numpy backend.  Seeds:
uniform 16000-16019, stratified 7000-7019; and the boolean stratum
(seeds 18000-18015) streamed in 64 KiB chunks (--stream) against
agrep_tpu reading each file whole, so that its booleans reach
line_terms' plain version; and the memory stratum (--memory: memagrep
cases drawn as tests/test_memagrep_oracle.py's test_memagrep_fuzz_wide
draws them, its seeds 951000-951015) against the port's per-byte
memory-mode loop."""

import collections

import pytest

from agrep_tpu_torch.ops import chain_kernel, kernels, qgram_kernel

from .torch_sweep import check, seeds, sweep

CASES = (seeds("uniform", True, 16000, 20)
         + seeds("stratified", True, 7000, 20))
BOOL_CASES = seeds("boolean", True, 18000, 16)
MEMORY_CASES = seeds("memory", False, 951000, 16)


@pytest.fixture(scope="module")
def runners():
    return sweep.sides("tpu", "cpu")


@pytest.mark.parametrize("mode,device_route,seed", CASES)
def test_sweep_case(runners, tmp_path, mode, device_route, seed):
    check(runners, tmp_path, mode, device_route, seed)


@pytest.fixture(scope="module")
def stream_runners():
    return sweep.sides("tpu", "cpu", stream=True)


@pytest.mark.parametrize("mode,device_route,seed", BOOL_CASES)
def test_boolean_stream_case(stream_runners, tmp_path, mode, device_route,
                             seed):
    check(stream_runners, tmp_path, mode, device_route, seed)


@pytest.mark.parametrize("mode,device_route,seed", MEMORY_CASES)
def test_memory_case(runners, tmp_path, mode, device_route, seed):
    check(runners, tmp_path, mode, device_route, seed)


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Calls of each kernel wrapper (on the CPU: of its plain version),
    counted where the routes call them."""
    calls = collections.Counter()
    for mod, name in ((kernels, "mask_scan"), (chain_kernel, "chain_scan"),
                      (qgram_kernel, "qgram_filter")):
        def counted(*a, _fn=getattr(mod, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


def test_device_route_takes_the_multi_pattern_kernels(runners, tmp_path,
                                                      wrapper_calls):
    """Three of the seeds above, picked for their routes: 7007 (-f
    within the chain caps: chain_scan), 7011 (the past-caps stratum's
    30 wide terms: qgram_filter) and 16008 (its 12 wide terms: the mask
    machine's packed term words)."""
    want = {7007: "chain_scan", 7011: "qgram_filter", 16008: "mask_scan"}
    for seed, kernel in want.items():
        before = wrapper_calls[kernel]
        mode = "stratified" if seed < 16000 else "uniform"
        check(runners, tmp_path, mode, True, seed)
        assert wrapper_calls[kernel] > before, (seed, dict(wrapper_calls))


def test_boolean_stratum_streams_through_line_terms(stream_runners,
                                                   tmp_path, monkeypatch):
    """The boolean stratum's streamed cases call line_terms (its plain
    version on the CPU) a chunk: seeds 18000-18015 hold ANDs and trees
    that stream, and their chunks' lines come from line_terms."""
    calls = collections.Counter()

    def counted(*a, _fn=chain_kernel.line_terms, **k):
        calls["line_terms"] += 1
        return _fn(*a, **k)
    monkeypatch.setattr(chain_kernel, "line_terms", counted)
    streamed = 0
    for _mode, _route, seed in (c.values for c in BOOL_CASES):
        before = calls["line_terms"]
        check(stream_runners, tmp_path, "boolean", True, seed)
        streamed += calls["line_terms"] > before
    assert streamed >= 4, (streamed, dict(calls))


def test_seed_7040_runs_over_its_limit(runners, tmp_path):
    """The grown stratified seed 7040 (-D2 -I2 -S2 -d '\\n' -t -c -f, 120
    terms over 168 KB of dense short records) runs into the reference's
    own -d -t infinite loop, which agrep_tpu reproduces faithfully
    (docs/CONFORMANCE.md, "-d -t infinite-loop pathology"): its record
    replay stays at one anchor at the end of a 32 KB block and never
    advances (ROADMAP Queue 3, not a port fault).  The sweep reports it
    as over its limit, with its seed and side, and not as a pass or a
    divergence."""
    res = sweep.check_case(0, 7040, str(tmp_path), "stratified", True,
                           runners, limit=2.0)
    assert res["status"] == "over_limit" and res["side"] == "ref", res
    assert "OVER_LIMIT seed=7040" in sweep.describe(res)
