"""agrep_tpu_torch and chip_smoke.py stand alone: no JAX, no agrep_tpu,
nothing of the repo-root bench.py, and no quiet CPU run when the GPU is
asked for and missing."""

from __future__ import annotations

import io
import os
import re
import subprocess
import sys

import pytest
import torch

import agrep_tpu_torch.api as t_api
from agrep_tpu_torch.ops import scan as t_scan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "agrep_tpu_torch")

FORBIDDEN = [
    re.compile(r"^\s*import\s+jax\b", re.M),
    re.compile(r"^\s*from\s+jax\b", re.M),
    re.compile(r"\bagrep_tpu\."),
    re.compile(r"\bfrom\s+agrep_tpu\b(?!_torch)"),
    re.compile(r"\bimport\s+agrep_tpu\b(?!_torch)"),
    re.compile(r"^\s*import\s+bench\b", re.M),
    re.compile(r"^\s*from\s+bench\b", re.M),
]


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_sources_name_no_jax_and_no_agrep_tpu():
    srcs = _sources()
    assert len(srcs) > 20
    for path in srcs:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        for pat in FORBIDDEN:
            m = pat.search(text)
            assert m is None, "%s: %r" % (os.path.relpath(path, REPO),
                                          m.group(0))


IMPORT_ALL = r"""
import importlib, sys
sys.modules["jax"] = None            # any import of jax now fails
sys.modules["agrep_tpu"] = None      # and so does any of agrep_tpu
sys.modules["bench"] = None          # and of the repo-root bench.py
sys.path.insert(0, {repo!r})
names = {names!r}
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib", "agrep_tpu."))
             or k in ("agrep_tpu", "bench"))
bad = [k for k in bad if sys.modules[k] is not None]
print(len(names), bad)
"""


def test_every_module_imports_without_jax_or_agrep_tpu():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    names = [os.path.relpath(f, REPO)[:-3].replace(os.sep, ".")
             .replace(".__init__", "") for f in _sources()
             if f.startswith(PKG)]
    p = subprocess.run([sys.executable, "-c",
                        IMPORT_ALL.format(repo=REPO, names=names)],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=120)
    assert p.returncode == 0, p.stderr
    n, bad = p.stdout.strip().split(" ", 1)
    assert int(n) >= 25 and bad == "[]", p.stdout


@pytest.fixture
def no_gpu(monkeypatch):
    """The default torch backend asking for cuda on a host without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    saved = (t_scan._BACKEND, t_scan._DEVICE)
    t_scan.set_backend("torch")
    t_scan.set_device("cuda")
    yield
    t_scan._BACKEND, t_scan._DEVICE = saved


def test_cuda_without_a_gpu_raises(no_gpu, tmp_path):
    f = tmp_path / "t.txt"
    f.write_bytes(b"hello world\nbye\n")
    buf = io.BytesIO()
    for call in (lambda: t_api.fileagrep(["-c", "hello", str(f)],
                                         output=buf),
                 lambda: t_api.memagrep(["-c", "hello"], b"\nhello\n",
                                        output=buf),
                 lambda: t_api.Query("hello"),
                 # a regex query (the lanes kernel's path)
                 lambda: t_api.fileagrep(["-2", "-c", "h(el)*lo", str(f)],
                                         output=buf),
                 lambda: t_api.memagrep(["ab*c"], b"\nabc\n", output=buf),
                 lambda: t_api.Query(argv=["-2", "appro[a-z]*mat(e|ion)",
                                           str(f)]),
                 # multi-pattern queries (the chain and q-gram kernels'
                 # engine)
                 lambda: t_api.fileagrep(["-c", "hello;bye", str(f)],
                                         output=buf),
                 lambda: t_api.memagrep(["-m", "hello\nbye\n"],
                                        b"\nhello\n", output=buf)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    assert buf.getvalue() == b""
    import numpy as np
    with pytest.raises(RuntimeError, match="is_available"):
        t_scan.scan_events(np.frombuffer(b"hello", np.uint8),
                           np.zeros(256, np.uint32), {"endpos": 1}, 0,
                           "sgrep")


def test_cli_without_a_gpu_exits_nonzero(tmp_path):
    f = tmp_path / "t.txt"
    f.write_bytes(b"hello world\n")
    env = dict(os.environ, AGREP_TORCH_DEVICE="cuda",
               AGREP_TORCH_BACKEND="torch", CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "agrep_tpu_torch.cli",
                        "hello", str(f)], capture_output=True, cwd=REPO,
                       env=env, timeout=120)
    assert p.returncode != 0
    assert p.stdout == b""
    assert b"is_available() is False" in p.stderr


def test_numpy_backend_is_an_explicit_host_choice(no_gpu, tmp_path):
    f = tmp_path / "t.txt"
    f.write_bytes(b"hello world\nbye\nhello\n")
    t_scan.set_backend("numpy")
    buf = io.BytesIO()
    assert t_api.fileagrep(["-c", "hello", str(f)], output=buf) == 2
    assert buf.getvalue().startswith(b"2\n")


def test_unknown_backend_or_device_is_refused():
    with pytest.raises(ValueError):
        t_scan.set_backend("jax")
    with pytest.raises(ValueError):
        t_scan.set_device("tpu")
