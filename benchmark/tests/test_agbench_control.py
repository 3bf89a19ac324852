"""The comparison that decides `correct`, shown to fail: the control
(the reference with one guarantee broken) on every cell, and a whole
run with the timed path broken underneath (an answer altered where it
is produced; half of each input left out).  A run whose clients load jax
is refused.  The runs drive the clients and the port on the CPU (its plain kernels) at a small size; the look
for a card is skipped, all else is a run."""

import os
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

import control  # noqa: E402
from agbench import harness, layout  # noqa: E402

CELLS = [w["name"] for w in layout.benchmark()["workloads"]]
SEED = 2**31 + 77


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    nums = control.control_numbers(layout.benchmark(), cell, SEED,
                                   scale=0.05)
    assert nums["searches_wrong"] > 0 and nums["records_off"] > 0


def _run(cell, fault=None, trace=False):
    bench = layout.benchmark()
    w = layout.cell(bench, cell)
    return harness.run_cell(bench, w, layout.config(bench, w["config"]),
                            layout.traffic(w["traffic"]), SEED, 1.0, trace,
                            time.perf_counter(), device="cpu", scale=0.01,
                            fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"] is True, out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "compared"


@pytest.mark.parametrize("fault", ["alter_answer", "half_input"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(cell, fault):
    out = _run(cell, fault)
    assert out["correct"] is False
    assert out["compared"]["searches_wrong"]["value"] > 0


def test_a_search_that_loads_jax_fails_the_run():
    """A client whose search imports a module named jax (a stub) makes
    the run fail with no result, naming the client and the module."""
    with pytest.raises(harness.RunError, match=r"client \d: jax"):
        _run(CELLS[0], "import_jax")


def test_traced_run_reports_per_layer_metrics():
    out = _run(CELLS[0], trace=True)
    assert out["correct"] is True
    for name in ("search_p95_ms", "host_ms", "device_layer_ms"):
        assert name in out["metrics"]
    assert out["metrics"]["search_p95_ms"]["samples"] > 0
    assert "breakdown" in out


@pytest.mark.card
def test_each_cell_runs_on_the_card(card):
    import json
    import subprocess
    for cell in CELLS:
        got = subprocess.run(
            [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
             cell, "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
            capture_output=True, text=True, cwd=layout.ROOT, timeout=900)
        assert got.returncode == 0, got.stderr[-3000:]
        out = json.loads(got.stdout.strip().splitlines()[-1])
        assert out["correct"] is True and out["device"]["kind"] == card
