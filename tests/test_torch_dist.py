"""agrep_tpu_torch.parallel against agrep_tpu.parallel on the CPU.

The port's sharded scan runs every shard through the mask machine's
plain PyTorch version on an 8-entry CPU mesh; agrep_tpu's runs its
lax.scan machine under shard_map on the conftest's 8-device CPU mesh.
Counts, per-shard counts and global offsets must be equal, exactly, and
equal to the single-stream scan.  Also: entry.py's entry points, the
multi-process helpers that need no peer, a run under WORLD_SIZE=2 whose
initialisation fails, and the kernel wrappers' device index."""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

from agrep_tpu.compile.query import compile_query as j_compile
from agrep_tpu.ops import scan as j_scan
from agrep_tpu.options import parse_args as j_parse
from agrep_tpu.parallel import dist as j_dist
from agrep_tpu.parallel import multihost as j_mh
from agrep_tpu_torch import api as t_api
from agrep_tpu_torch import entry as t_entry
from agrep_tpu_torch.compile.query import compile_query as t_compile
from agrep_tpu_torch.ops import _cuda, chain_kernel, kernels, qgram_kernel
from agrep_tpu_torch.ops import renfa_kernel
from agrep_tpu_torch.ops import scan as t_scan
from agrep_tpu_torch.options import parse_args as t_parse
from agrep_tpu_torch.parallel import dist as t_dist
from agrep_tpu_torch.parallel import multihost as t_mh


@pytest.fixture(autouse=True)
def cpu_device():
    saved = (t_scan._BACKEND, t_scan._DEVICE)
    t_scan.set_backend("torch")
    t_scan.set_device("cpu")
    yield
    t_scan._BACKEND, t_scan._DEVICE = saved


@pytest.mark.parametrize("n_shards,overlap", [(1, 0), (3, 7), (8, 256),
                                              (5, 49152)])
def test_shard_corpus_equals_agrep_tpu(n_shards, overlap):
    rng = np.random.default_rng(n_shards)
    data = rng.integers(0, 256, size=10007, dtype=np.uint8)
    got = t_dist.shard_corpus(data, n_shards, overlap)
    want = j_dist.shard_corpus(data, n_shards, overlap)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert t_dist.MAX_RECORD == j_dist.MAX_RECORD


def _planted_text():
    """tests/test_dist.py's text: matches planted dead on shard
    boundaries of 8 shards."""
    rng = np.random.default_rng(11)
    text = rng.integers(32, 127, size=64 * 1024, dtype=np.uint8)
    text[::64] = 0x0A
    pat = np.frombuffer(b"matching", dtype=np.uint8)
    shard_len = -(-len(text) // 8)
    for off in (5, 1000, shard_len - 3, shard_len + 1,
                3 * shard_len - len(pat) // 2, len(text) - 40):
        text[off:off + len(pat)] = pat
    # matches ENDING on a shard's first and last body byte, and on the
    # first and last column of a tile (the shards carry a 256-byte halo,
    # so tiles start 768 bytes into a body)
    for end in (2 * shard_len, 4 * shard_len - 1, 5 * shard_len + 768,
                6 * shard_len + 767):
        text[end - len(pat) + 1:end + 1] = pat
    # a pattern cut short by the text's end: only errors complete it
    text[-5:] = pat[:5]
    return text


def _query(compile_query, parse_args, argv):
    opts, pattern, _files = parse_args(argv + ["x"])
    return compile_query(pattern, opts)


MACHINES = {
    "D0": ["-n", "matching"],
    "D2": ["-2", "-n", "matching"],
    "costs": ["-3", "-D2", "-I1", "-S1", "-n", "matching"],
}


@pytest.mark.parametrize("name", sorted(MACHINES))
def test_sharded_scan_equals_agrep_tpu_and_single_stream(name):
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 virtual CPU devices")
    text = _planted_text()
    jq = _query(j_compile, j_parse, MACHINES[name])
    tq = _query(t_compile, t_parse, MACHINES[name])
    assert (jq.engine_class, tq.engine_class) == ("bitap", "bitap")
    assert np.array_equal(jq.folded_mask, tq.folded_mask)
    assert (name == "costs") == (tq.costs is not None)
    D = tq.D
    halo = 256
    consts = dict(tq.consts)
    consts["shard_halo"] = halo
    shards, starts = t_dist.shard_corpus(text, 8, overlap=halo)
    mesh = t_dist.make_mesh(8)
    assert mesh == [torch.device("cpu")] * 8
    total, locals_ = t_dist.distributed_scan_count(
        shards, tq.folded_mask, consts, D, mesh=mesh, costs=tq.costs,
        n_bytes=len(text))
    pos = t_dist.distributed_scan_offsets(
        shards, starts, len(text), tq.folded_mask, consts, D, mesh=mesh,
        costs=tq.costs)

    jconsts = dict(jq.consts)
    jconsts["shard_halo"] = halo
    jmesh = j_dist.make_mesh(8)
    j_total, j_locals = j_dist.distributed_scan_count(
        shards, jq.folded_mask, jconsts, D, mesh=jmesh, costs=jq.costs,
        n_bytes=len(text))
    j_pos = j_dist.distributed_scan_offsets(
        shards, starts, len(text), jq.folded_mask, jconsts, D, mesh=jmesh,
        costs=jq.costs)

    # the single-stream scan of the port (plain version) and of
    # agrep_tpu's host backend
    endpos = np.uint32(tq.consts["endpos"])
    ev = t_scan.scan_events(text, tq.folded_mask, tq.consts, D, "bitap",
                            tq.costs)
    ref = np.flatnonzero(ev & endpos)
    j_scan.set_backend("numpy")
    j_ev = j_scan.scan_events(text, jq.folded_mask, jq.consts, D, "bitap",
                              jq.costs)
    assert np.array_equal(np.flatnonzero(j_ev & endpos), ref)

    assert total == j_total == len(ref) == int(locals_.sum()) >= 5
    assert np.array_equal(locals_, np.asarray(j_locals).reshape(-1))
    assert np.array_equal(pos, j_pos) and np.array_equal(pos, ref)
    # the planted matches on shard boundaries are among them
    assert any(abs(int(p) - b) < 16 for p in pos
               for b in starts[1:])


def test_sharded_count_excludes_the_trailing_fill():
    text = _planted_text()[:-3]      # 8 does not divide it: a zero fill
    q = _query(t_compile, t_parse, ["-n", "matching"])
    consts = dict(q.consts)
    consts["shard_halo"] = 64
    shards, starts = t_dist.shard_corpus(text, 8, overlap=64)
    mesh = t_dist.make_mesh(3)
    total, _ = t_dist.distributed_scan_count(
        shards, q.folded_mask, consts, 0, mesh=mesh, n_bytes=len(text))
    pos = t_dist.distributed_scan_offsets(
        shards, starts, len(text), q.folded_mask, consts, 0, mesh=mesh)
    ev = t_scan.scan_events(text, q.folded_mask, q.consts, 0, "bitap")
    ref = np.flatnonzero(ev & np.uint32(q.consts["endpos"]))
    assert total == len(ref) and np.array_equal(pos, ref)


def test_make_mesh_on_the_card_or_raises(monkeypatch):
    t_scan.set_device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_dist.make_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert t_dist.make_mesh() == [torch.device("cuda", i) for i in range(3)]
    assert t_dist.make_mesh(2) == [torch.device("cuda", 0),
                                   torch.device("cuda", 1)]


def test_entry_is_one_mask_scan_step():
    fn, args = t_entry.entry()
    text, mach = args
    assert text.device.type == "cpu" and mach.D == 2
    planes = fn(*args)
    assert torch.equal(planes, kernels.mask_scan_reference(
        text, mach, t_entry.W, t_entry.L))
    assert int(planes[1:].to(torch.int64).count_nonzero()) > 0


def test_dryrun_multichip_runs_on_the_cpu(capsys):
    t_entry.dryrun_multichip(4)
    out = capsys.readouterr().out
    assert "dryrun_multichip: 4 shards on cpu" in out
    assert t_scan._BACKEND == "torch"


# -- multi-process helpers that need no peer -------------------------------

def test_init_multihost_single_process(monkeypatch):
    for var in ("WORLD_SIZE", "MASTER_ADDR", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not t_mh.requested()
    assert t_mh.init_multihost() == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    assert not t_mh.requested()
    assert t_mh.init_multihost() == (0, 1)
    assert (t_mh.process_index(), t_mh.process_count()) == (0, 1)
    assert t_mh.is_primary()
    assert t_mh.global_count(42) == 42
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert t_mh.requested()


@pytest.mark.parametrize("n_files,nproc", [(0, 2), (1, 2), (5, 2),
                                           (23, 4), (3, 8)])
def test_assign_files_equals_agrep_tpu(n_files, nproc):
    files = ["f%02d" % i for i in range(n_files)]
    seen = []
    for p in range(nproc):
        got = t_mh.assign_files(files, nproc, p)
        assert got == j_mh.assign_files(files, nproc, p)
        seen += [gi for gi, _ in got]
    assert sorted(seen) == list(range(n_files))


def test_run_with_requeue_retries_then_raises():
    calls = {"a": 0, "b": 0}

    def worker(x):
        calls[x] += 1
        if x == "b" and calls[x] <= 1:
            raise RuntimeError("preempted")
        return x.upper()

    assert t_mh.run_with_requeue(["a", "b"], worker) == ["A", "B"]
    assert calls == {"a": 1, "b": 2}

    n = {"c": 0}

    def always_fail(x):
        n["c"] += 1
        raise RuntimeError("dead host")

    with pytest.raises(RuntimeError, match="dead host"):
        t_mh.run_with_requeue(["x"], always_fail, retries=2)
    assert n["c"] == 3


@pytest.mark.parametrize("argv", [["-c", "hello"], ["-B", "helo"],
                                  ["-r", "hello"]])
def test_failed_init_raises_rather_than_searching_alone(tmp_path,
                                                        monkeypatch, argv):
    f = tmp_path / "t.txt"
    f.write_bytes(b"hello world\nbye\nhello\n")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")

    def fail(*a, **k):
        raise RuntimeError("rendezvous failed")

    monkeypatch.setattr(t_mh, "init_multihost", fail)
    target = str(tmp_path) if "-r" in argv else str(f)
    buf = io.BytesIO()
    with pytest.raises(RuntimeError, match="rendezvous failed"):
        t_api.fileagrep(argv + [target], output=buf)
    assert buf.getvalue() == b""


# -- the kernel wrappers' device index -------------------------------------

def test_kernel_wrappers_take_the_device_of_the_tensor(monkeypatch):
    """The launch geometry is asked of the tensor's own device, or of
    the current device for a bare "cuda", never of device 0."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert _cuda.device_index(torch.device("cuda", 3)) == 3
    assert _cuda.device_index("cuda:1") == 1
    assert _cuda.device_index("cuda") == 2
    seen = []

    def sm_count(index):
        seen.append(("sm", index))
        return 132

    def query(lib, kernel, fn, index, n_out, *args):
        seen.append((kernel, index))
        if fn == "chain_scan_smem_optin":
            return (chain_kernel.HOPPER_SMEM_OPTIN,)
        return (256, 32768, 4)

    for mod in (kernels, renfa_kernel, chain_kernel, qgram_kernel):
        monkeypatch.setattr(mod, "_sm_count", sm_count)
    monkeypatch.setattr(_cuda, "query", query)
    monkeypatch.setattr(chain_kernel, "_bind", lambda: None)
    monkeypatch.setattr(renfa_kernel, "_kernel_geometry",
                        lambda D, M, form, threads, index:
                        seen.append(("renfa_lanes", index))
                        or (70000, 2, 60, 0))
    monkeypatch.setattr(qgram_kernel, "_kernel_geometry",
                        lambda index: seen.append(("qgram_filter", index))
                        or (256, 8))
    q = _query(t_compile, t_parse, ["-n", "matching"])
    m = kernels.machine_from_arrays(q.folded_mask, q.consts, q.D)
    prog = chain_kernel.device_program(
        chain_kernel.compile_chain([b"abc"], np.arange(256, dtype=np.uint8)),
        "cpu")
    rq = _query(t_compile, t_parse, ["-2", "ke(rn|y)el"])
    rm = renfa_kernel.machine_from_mc(rq.re_mc, "cpu")
    for dev, want in ((torch.device("cuda", 3), 3), ("cuda", 2)):
        seen.clear()
        kernels.launch_geometry(1 << 20, m, 48, 1024, dev)
        chain_kernel.launch_geometry(1 << 20, prog, dev)
        renfa_kernel.launch_geometry(1000, rm, dev)
        qgram_kernel.launch_geometry(1 << 20, dev)
        assert seen == [("sm", want), ("chain_scan", want),
                        ("chain_scan", want), ("sm", want),
                        ("renfa_lanes", want), ("sm", want),
                        ("qgram_filter", want), ("sm", want)], seen
