"""Two ranks of agrep_tpu_torch on torch.distributed (gloo, localhost),
against agrep_tpu's single-process run.

Every search of tests/test_multihost_integration.py, a regex with
errors, -r, -B and a run with fewer files than ranks run in ONE pair of
ranks, through a runner that loops agrep_tpu_torch.api.fileagrep over
them (a process pays about 4 s to import torch here); one real
`python -m agrep_tpu_torch.cli` pair takes its ranks from the
environment alone.  Rank 0's output and both ranks' return codes must
equal agrep_tpu.api.fileagrep run in-process on its numpy backend, byte
for byte; rank 1 prints nothing.  A rank that dies, or a rendezvous that
never completes, makes the others raise."""

from __future__ import annotations

import io
import json
import os
import random
import socket
import subprocess
import sys

import pytest

from agrep_tpu import api as j_api
from agrep_tpu.ops import scan as j_scan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240

RUNNER = r"""
import io, json, sys
sys.path.insert(0, {repo!r})
from agrep_tpu_torch import api
with open(sys.argv[1]) as f:
    cases = json.load(f)
out = []
for argv in cases:
    buf = io.BytesIO()
    rc = api.fileagrep(argv, output=buf)
    out.append([rc & 0xFF, buf.getvalue().hex()])
with open(sys.argv[2], "w") as f:
    json.dump(out, f)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(rank: int, port: int) -> dict:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update(AGREP_TORCH_DEVICE="cpu", AGREP_TORCH_BACKEND="torch",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
               OMP_NUM_THREADS="1")
    return env


def _two_ranks(cmd_of_rank, timeout=TIMEOUT):
    """Start both ranks, wait for both; [(stdout, stderr, rc)] by rank."""
    port = _free_port()
    procs = [subprocess.Popen(cmd_of_rank(r), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE,
                              stdin=subprocess.DEVNULL, env=_env(r, port),
                              cwd=REPO) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((out, err, p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _want(argv):
    """agrep_tpu's single-process run on its numpy host backend."""
    saved = j_scan._BACKEND
    j_scan.set_backend("numpy")
    try:
        buf = io.BytesIO()
        rc = j_api.fileagrep(argv, output=buf)
    finally:
        j_scan.set_backend(saved)
    return rc & 0xFF, buf.getvalue()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_multihost_integration.py's files and pattern file,
    and its '$$' records."""
    d = tmp_path_factory.mktemp("tmh")
    rnd = random.Random(31)
    words = ["alpha", "beta", "kernel", "device", "zeta", "engine",
             "matching", "hello"]
    files = []
    for k in range(5):
        f = d / ("f%d.txt" % k)
        with open(f, "w") as fh:
            for _ in range(300 + 40 * k):
                fh.write(" ".join(rnd.choices(words,
                                              k=rnd.randint(2, 7)))
                         + "\n")
        files.append(str(f))
    pf = d / "pats.txt"
    pf.write_text("".join(w + "\n" for w in words[:6] * 5))
    rnd = random.Random(7)
    recs = []
    for k in range(4):
        f = d / ("r%d.txt" % k)
        paras = []
        for _ in range(30):
            lines = ["line %d %s" % (i, "matching" if
                     rnd.random() < 0.3 else "other")
                     for i in range(rnd.randint(1, 4))]
            paras.append("\n".join(lines) + "\n$$\n")
        f.write_text("".join(paras))
        recs.append(str(f))
    tree = d / "tree"
    tree.mkdir()
    for k in range(3):
        (tree / ("t%d.txt" % k)).write_text(
            "hello there\nnothing\nhello again %d\n" % k)
    return {"files": files, "pf": str(pf), "recs": recs, "tree": str(tree)}


MODES = {
    "print": lambda c: ["matching", *c["files"]],
    "count": lambda c: ["-c", "matching", *c["files"]],
    "linenum": lambda c: ["-n", "-i", "MATCHING", *c["files"]],
    "inverse_count": lambda c: ["-v", "-c", "matching", *c["files"]],
    "mgrep_count": lambda c: ["-c", "-f", c["pf"], *c["files"]],
    "mgrep_print": lambda c: ["-f", c["pf"], *c["files"]],
    "approx_print": lambda c: ["-1", "matching", *c["files"]],
    "filename_only": lambda c: ["-l", "matching", *c["files"]],
    "grand_total": lambda c: ["-V1", "-c", "matching", *c["files"]],
    "limit_print": lambda c: ["-L", "7:0:0", "matching", *c["files"]],
    "records": lambda c: ["-d", "$$", "matching", *c["recs"]],
    "limit_output": lambda c: ["-L", "7:0:0", "-c", "matching",
                               *c["files"]],
    "limit_output_cut": lambda c: ["-L", "9:0:0", "matching", *c["files"]],
    "limit_total_file": lambda c: ["-L", "0:2:0", "-c", "matching",
                                   *c["files"]],
    "mgrep_inverse_count": lambda c: ["-v", "-c", "-f", c["pf"],
                                      *c["files"]],
    "mgrep_inverse_print": lambda c: ["-v", "-f", c["pf"], *c["files"]],
    "regex": lambda c: ["-2", "-n", "ke(rn|y)el", *c["files"]],
    "recursive": lambda c: ["-r", "-n", "hello", c["tree"]],
    "bestmatch": lambda c: ["-B", "-y", "zetta", *c["files"]],
    "one_file": lambda c: ["-n", "matching", c["files"][0]],
}


@pytest.fixture(scope="module")
def ranked(corpus, tmp_path_factory):
    """Every mode through one pair of ranks: {mode: [(rc, output) of
    rank 0, of rank 1]}."""
    d = tmp_path_factory.mktemp("ranked")
    names = sorted(MODES)
    cases = d / "cases.json"
    cases.write_text(json.dumps([MODES[n](corpus) for n in names]))
    results = [d / ("rank%d.json" % r) for r in range(2)]
    code = RUNNER.format(repo=REPO)
    ranks = _two_ranks(lambda r: [sys.executable, "-c", code, str(cases),
                                  str(results[r])])
    for r, (out, err, rc) in enumerate(ranks):
        assert rc == 0, "rank %d failed:\n%s" % (r, err.decode()[-3000:])
        assert out == b"", "rank %d wrote to stdout" % r
    got = [json.loads(p.read_text()) for p in results]
    return {n: [(rc, bytes.fromhex(out)) for rc, out in (got[0][i],
                                                         got[1][i])]
            for i, n in enumerate(names)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_two_ranks_equal_agrep_tpu(corpus, ranked, mode):
    want_rc, want_out = _want(MODES[mode](corpus))
    (rc0, out0), (rc1, out1) = ranked[mode]
    assert out0 == want_out
    assert out1 == b""
    assert rc0 == rc1 == want_rc
    assert want_out


def test_cli_ranks_from_the_environment(corpus):
    argv = ["-n", "-i", "MATCHING", *corpus["files"]]
    ranks = _two_ranks(lambda r: [sys.executable, "-m",
                                  "agrep_tpu_torch.cli", *argv])
    want_rc, want_out = _want(argv)
    (out0, err0, rc0), (out1, err1, rc1) = ranks
    assert out0 == want_out, err0.decode()[-3000:]
    assert out1 == b"", err1.decode()[-3000:]
    assert rc0 == rc1 == want_rc


DIES = r"""
import os, sys, time
sys.path.insert(0, {repo!r})
from agrep_tpu_torch.parallel import multihost
rank, n = multihost.init_multihost()
if rank == 1:
    os._exit(3)
t0 = time.perf_counter()
try:
    multihost.merge_outputs(b"piece", [(0, 0)], 1)
except RuntimeError as e:
    print("raised %.1f" % (time.perf_counter() - t0))
    sys.exit(4)
"""


def test_a_rank_that_dies_fails_its_peer_at_once():
    ranks = _two_ranks(lambda r: [sys.executable, "-c",
                                  DIES.format(repo=REPO)], timeout=120)
    (out0, err0, rc0), (_out1, _err1, rc1) = ranks
    assert rc1 == 3
    assert rc0 == 4, err0.decode()[-3000:]
    # well inside the collectives' timeout
    assert float(out0.split()[1]) < 30


LONE = r"""
import sys, time
sys.path.insert(0, {repo!r})
from agrep_tpu_torch.parallel import multihost
t0 = time.perf_counter()
try:
    multihost.RENDEZVOUS_S = 2
    multihost.init_multihost()
except Exception as e:
    print("raised %.1f %s" % (time.perf_counter() - t0, type(e).__name__))
    sys.exit(4)
"""


def test_a_rendezvous_without_its_peer_raises():
    env = _env(0, _free_port())
    p = subprocess.run([sys.executable, "-c", LONE.format(repo=REPO)],
                       capture_output=True, env=env, cwd=REPO, timeout=120)
    assert p.returncode == 4, p.stderr.decode()[-3000:]
    assert float(p.stdout.split()[1]) < 30
