"""BENCHMARK.json against the benchmark's contract, and the rule that
nothing the benchmark runs holds jax or agrep_tpu."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)

from agbench import harness, layout  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "agrep_tpu"}


def _bench():
    return layout.benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_names():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert all(_line(w) for w in b["command"]) and len(b["command"]) <= 32
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_are_used_and_stand_alone():
    b = _bench()
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        assert _line(c["source"]) and _line(c["why"])
        cfg = layout.config(b, c["name"])
        assert cfg["name"] == c["name"]
        assert all(k in cfg for k in c["reduced"])
        assert os.path.exists(os.path.join(BENCH, "reference",
                                           cfg["reference"] + ".py"))


def test_cells():
    b = _bench()
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        layout.traffic(w["traffic"])
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


def test_metrics():
    b = _bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        assert hasattr(layout.metric(m["name"]), "read")
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    for dirpath, _dirs, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                got = set(_imports(os.path.join(dirpath, f)))
                assert not got & FORBIDDEN, (f, got & FORBIDDEN)


def test_references_import_nothing_of_the_program():
    for f in os.listdir(os.path.join(BENCH, "reference")):
        if f.endswith(".py"):
            got = set(_imports(os.path.join(BENCH, "reference", f)))
            assert got <= {"__future__", "numpy", "os", "sys", "ref_approx",
                           "ref_lines"}, (f, got)


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "agrep_tpu_torch_x", sys)
    assert "agrep_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "agrep_tpu.ops", sys)
    assert "agrep_tpu" in harness.forbidden_modules()


def test_what_the_clients_load_holds_no_jax():
    """The modules a client loads (the port, torch, the harness) leave no
    jax, jaxlib, flax or agrep_tpu in sys.modules."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import client, run\n"
            "from agrep_tpu_torch import api, native\n"
            "from agrep_tpu_torch.ops import scan, _cuda, renfa_kernel\n"
            "from agrep_tpu_torch.runtime import engine, regex_engine, mgrep\n"
            "from agbench import harness\n"
            "print(','.join(harness.forbidden_modules()))\n"
            % (ROOT, BENCH))
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["AGREP_TORCH_DEVICE"] = "cpu"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_run_refuses_a_tree_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and benchmark/, a run
    exits non-zero and prints no result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cell = _bench()["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "4294967311", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
