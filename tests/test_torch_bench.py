"""agrep_tpu_torch.bench on the CPU, at small sizes.

  * its inputs equal the repo-root bench.py's, byte for byte;
  * every gate passes, and each CLI gate's port output (torch backend,
    AGREP_TORCH_DEVICE=cpu: the plain PyTorch versions) equals
    agrep_tpu's on its numpy backend for the same argv;
  * a plain version that flips one bit fails its gate: conformance reads
    "FAIL:<label>" and main exits 1;
  * the JSON line carries every key and row name of bench.py's, plus
    device, gate_ref, bound_ms and share_of_bound;
  * without CUDA and without --device cpu, the bench raises;
  * every attribute that a tools/torch_*.py script reads from a port
    module (the timing module among them) or from chip_smoke exists.

The bench's CUDA rows run on the GPU only (chip_smoke.py phase 7).
"""

from __future__ import annotations

import ast
import glob
import importlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

import agrep_tpu.api as j_api
import bench as j_bench
from agrep_tpu.ops import scan as j_scan
from agrep_tpu_torch import bench
from agrep_tpu_torch.ops import chain_kernel, kernels, renfa_kernel
from agrep_tpu_torch.ops import scan as t_scan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--mb", "0.25", "--gate-mb", "0.25",
         "--para-mb", "1"]
GATE_BYTES = 1 << 18


@pytest.fixture(autouse=True)
def _backends():
    saved = (t_scan._BACKEND, t_scan._DEVICE, j_scan._BACKEND)
    t_scan.set_backend("torch")
    t_scan.set_device("cpu")
    j_scan.set_backend("numpy")
    yield
    t_scan._BACKEND, t_scan._DEVICE = saved[:2]
    j_scan.set_backend(saved[2])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_bench"))
    conf = os.path.join(d, "conf.txt")
    bench.make_text(GATE_BYTES).tofile(conf)
    return {"conf": conf, "pats": bench.make_patfile(d),
            "para": bench.make_para_corpus(d, 1, "conf_para.txt")}


def _main(argv, capsys) -> tuple:
    rc = bench.main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# ---------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------

def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("what", ["text", "patfile", "para"])
def test_inputs_equal_bench_py(what, tmp_path):
    if what == "text":
        for n in (1, 1000, (1 << 20) + 17, 3 << 20):
            assert np.array_equal(bench.make_text(n), j_bench.make_text(n))
        return
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    mine.mkdir()
    theirs.mkdir()
    if what == "patfile":
        a = bench.make_patfile(str(mine))
        b = j_bench.make_patfile(str(theirs))
    else:
        a = bench.make_para_corpus(str(mine), 2, "p.txt")
        b = j_bench.make_para_corpus(str(theirs), 2, "p.txt")
    assert _read(a) == _read(b) and len(_read(a)) > 0


# ---------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------

def _kernel_gate(label, files, failures):
    text = bench.make_text(GATE_BYTES)
    ktext = bench.kernel_gate_text(text, GATE_BYTES)
    terms = bench.read_terms(files["pats"])
    run = {
        "kernel_k0": lambda: bench.gate_kernel_events(ktext, 0, None,
                                                      label, failures),
        "kernel_k2": lambda: bench.gate_kernel_events(ktext, 2, None,
                                                      label, failures),
        "kernel_costs": lambda: bench.gate_kernel_events(
            ktext, 3, (1, 1, 2), label, failures),
        "kernel_class18": lambda: bench.gate_kernel_events(
            ktext, 1, None, label, failures, pattern=bench.FB_PAT),
        "kernel_regex": lambda: bench.gate_regex_lanes(ktext, label,
                                                       failures, "cpu"),
        "kernel_qgram": lambda: bench.gate_qgram(text, terms, label,
                                                 failures, "cpu"),
        "kernel_chain": lambda: bench.gate_chain(ktext, terms, label,
                                                 failures, "cpu"),
    }
    run[label]()


KERNEL_GATES = ["kernel_k0", "kernel_k2", "kernel_costs", "kernel_class18",
                "kernel_regex", "kernel_qgram", "kernel_chain"]


@pytest.mark.parametrize("label", KERNEL_GATES)
def test_kernel_gate_passes(label, files):
    failures = []
    _kernel_gate(label, files, failures)
    assert failures == []


def _j_fileagrep(argv) -> tuple:
    buf = io.BytesIO()
    rc = j_api.fileagrep(list(argv), output=buf)
    return buf.getvalue(), rc & 0xFF


@pytest.mark.parametrize("label,argv", bench.CLI_GATES,
                         ids=[g[0] for g in bench.CLI_GATES])
def test_cli_gate_passes_and_equals_agrep_tpu(label, argv, files):
    argv = [a.format(**files) for a in argv]
    failures = []
    bench.gate_cli(argv, label, failures, None)
    assert failures == []
    got = bench._fileagrep(argv)
    assert got == _j_fileagrep(argv), "port vs agrep_tpu for %r" % (argv,)
    assert got[0], "the gate's search printed nothing"


def _flip_mask(real):
    # a bit of the first hit plane, in tile 0's body: an event word of
    # the kernel gate's text (its size differs from every CLI gate's)
    def fn(text, m, W, L):
        out = real(text, m, W, L)
        if m.D == 2 and text.numel() == 2 * (GATE_BYTES // 4):
            out.view(torch.int32)[1, 0, -1] ^= 1
        return out
    return kernels, "mask_scan_reference", fn


def _flip_regex(real):
    def fn(text, starts, lens, m, init):
        out = real(text, starts, lens, m, init)
        if starts.numel() == 512:
            out[0] = ~out[0]
        return out
    return renfa_kernel, "renfa_lines_reference", fn


def _flip_chain(real):
    def fn(text, p):
        out = real(text, p)
        if text.numel() == 2 * (GATE_BYTES // 4):
            out[0] ^= 1
        return out
    return chain_kernel, "chain_scan_reference", fn


@pytest.mark.parametrize("label,flip,real", [
    ("kernel_k2", _flip_mask, kernels.mask_scan_reference),
    ("kernel_regex", _flip_regex, renfa_kernel.renfa_lines_reference),
    ("kernel_chain", _flip_chain, chain_kernel.chain_scan_reference),
], ids=["kernel_k2", "kernel_regex", "kernel_chain"])
def test_a_wrong_kernel_result_fails_the_gate(label, flip, real,
                                              monkeypatch, capsys):
    mod, name, fn = flip(real)
    monkeypatch.setattr(mod, name, fn)
    rc, out = _main(SMALL, capsys)
    assert out["conformance"] == "FAIL:" + label
    assert rc == 1
    assert out["configs"] == {} and out["value"] is None


# ---------------------------------------------------------------------
# the JSON line
# ---------------------------------------------------------------------

def _bench_py_keys() -> tuple:
    """(top-level keys, row names, row keys) of bench.py's JSON line, read
    from its main()."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    top, rows, row_keys = set(), set(), set()
    for node in ast.walk(main):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "dumps"):
            top = {k.value for k in node.args[0].keys}
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "cfg"):
            rows.add(node.args[0].value)
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.value, ast.Name)
              and node.value.id == "configs"
              and isinstance(node.slice, ast.Constant)):
            rows.add(node.slice.value)
        elif isinstance(node, ast.Assign):
            t = node.targets[0]
            if not isinstance(t, ast.Subscript):
                continue
            if (isinstance(t.value, ast.Name) and t.value.id == "configs"
                    and isinstance(node.value, ast.Dict)):
                row_keys |= {k.value for k in node.value.keys}
            elif (isinstance(t.value, ast.Name)
                  and isinstance(t.slice, ast.Constant)):
                row_keys.add(t.slice.value)
    return top, rows, row_keys


def test_json_line_has_bench_py_keys_and_rows(capsys):
    top, rows, row_keys = _bench_py_keys()
    assert {"metric", "value", "vs_baseline", "conformance",
            "configs"} <= top
    assert len(rows) == 8 and {"gbs", "ref_gbs", "vs_ref",
                               "link_gbs"} <= row_keys
    rc, out = _main(SMALL, capsys)
    assert rc == 0 and out["conformance"] == "pass"
    assert top | {"device", "gate_ref", "baseline"} <= set(out)
    assert out["metric"] == "k2_scan_throughput_per_chip"
    assert out["device"] == "cpu" and out["gate_ref"]
    configs = out["configs"]
    assert rows | {"k2"} <= set(configs)
    assert row_keys <= set().union(*map(set, configs.values()))
    assert out["value"] == configs["k2"]["gbs"] > 0
    for name, row in configs.items():
        assert row["gbs"] > 0, name
        assert {"gbs", "ref_gbs", "vs_ref"} <= set(row), name
    assert {"conformance", "link_gbs", "note"} <= set(
        configs["f100_device_e2e"])
    assert configs["f100_device_e2e"]["conformance"] == "pass"
    for name in ("k2", "exact_k0", "costs_k3_D2I1S1", "fallback_class18",
                 "regex_k2", "f100_chain_kernel"):
        row = configs[name]
        assert row["min_ms"] <= row["ms"] <= row["max_ms"], name
        assert row["bound_ms"] > 0 and row["bound_by"] in ("bytes",
                                                           "operations")
        # a CPU time is no share of the card's bound
        assert "share_of_bound" in row and row["share_of_bound"] is None
    for name in ("f100_onepass", "f100_records", "f100_device_e2e"):
        assert configs[name]["host_gbs"] > 0, name
    if out["baseline"] == "absent":
        assert out["vs_baseline"] is None
        assert all(r["ref_gbs"] is None for r in configs.values())


def test_without_cuda_the_bench_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main(["--mb", "0.25", "--gate-mb", "0.25", "--para-mb", "1"])


# ---------------------------------------------------------------------
# the mask_scan bound counts the function's work, not the windows'
# ---------------------------------------------------------------------

@pytest.mark.parametrize("N", [1, 47, 1024, 1025, 3 * 1024 + 17])
def test_mask_bound_counts_the_text_columns_only(N):
    """timing.text_bits counts the delimiter plane's bits at the text's N
    columns, as planes_to_events reads them, and none of a tile's W
    warm-up columns (dense newlines put bits there); bound counts N
    columns of LOP3-fused levels."""
    from agrep_tpu_torch.ops import timing
    rng = np.random.default_rng(N)
    text = rng.choice(np.frombuffer(b"matching\n\n xyz", np.uint8), N)
    m, W, L = bench.mask_machine("matching", 2, None, "cpu")
    planes = kernels.mask_scan(torch.from_numpy(text), m, W, L)
    p = planes.numpy()
    ev = kernels.planes_to_events(p[0], p[1], {"d_endpos": 1}, W, L, N)
    n = int((ev & 1).sum())
    assert N <= L or p[0][1:, :2].any()      # warm-up bits to leave out
    assert timing.text_bits(planes[0], N, W, L) == n
    assert timing.level_ops(m) == 3 + 6 * m.D
    ops = N * timing.ops_per_column(m) + n * timing.restart_ops(m)
    want = max(ops / timing.INT32_OPS_PER_S,
               N / timing.SHARED_LOADS_PER_S,
               (N + 1024 + 8 * -(-N // 32)) / timing.HBM_BYTES_PER_S)
    assert timing.bound(m, N, W, L, planes)[0] == pytest.approx(want * 1e3)


# ---------------------------------------------------------------------
# the tools read only names that exist
# ---------------------------------------------------------------------

def _is_module(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except ModuleNotFoundError:
        return False


# what torch_kernel_ab's _helpers() returns, loaded by path
HELPERS = ("chip_smoke", "agrep_tpu_torch.ops.timing")


def _module_aliases(tree) -> dict:
    """{local name: module name} of every port module or chip_smoke the
    file imports, and of the modules _helpers() loads by path
    (`cs, timing = _helpers()`, `timing = _helpers()[1]`)."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "chip_smoke" or a.name.startswith(
                        "agrep_tpu_torch"):
                    out[a.asname or a.name] = a.name
        elif (isinstance(node, ast.ImportFrom) and node.module
              and node.module.startswith("agrep_tpu_torch")):
            for a in node.names:
                full = node.module + "." + a.name
                if _is_module(full):
                    out[a.asname or a.name] = full
        elif isinstance(node, ast.Assign):
            v, t = node.value, node.targets[0]
            if (isinstance(v, ast.Subscript) and isinstance(v.value, ast.Call)
                    and getattr(v.value.func, "id", None) == "_helpers"):
                out[t.id] = HELPERS[v.slice.value]
            elif (isinstance(v, ast.Call)
                  and getattr(v.func, "id", None) == "_helpers"):
                for e, mod in zip(t.elts, HELPERS):
                    out[e.id] = mod
    return out


TOOLS = sorted(glob.glob(os.path.join(REPO, "tools", "torch_*.py")))


@pytest.mark.parametrize("path", TOOLS, ids=[os.path.basename(p)
                                             for p in TOOLS])
def test_tools_read_only_names_that_exist(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    aliases = _module_aliases(tree)
    assert aliases, "%s imports no port module" % path
    missing, read = [], 0
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in aliases):
            read += 1
            mod = importlib.import_module(aliases[node.value.id])
            if not hasattr(mod, node.attr):
                missing.append("%s.%s (line %d)" % (node.value.id,
                                                    node.attr, node.lineno))
    assert read and missing == [], missing
