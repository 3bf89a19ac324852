"""The port's mask-machine scan against agrep_tpu, bit for bit, on the CPU.

  * kernel module: agrep_tpu_torch's mask_scan_reference planes against
    agrep_tpu's Pallas kernel run in interpret mode (pallas_scan_packed);
  * scan module: agrep_tpu_torch.ops.scan.scan_events on the torch
    backend (device cpu) against agrep_tpu.ops.scan.scan_events on its
    numpy backend: bitap and sgrep, D = 0..8, costs, multi-bit endpos up
    to and beyond 12 bits, -d resets, N < W;
  * compiled state: agrep_tpu_torch's compile_query against agrep_tpu's
    over the flag matrix, and machine_from_arrays on agrep_tpu's arrays.

The machine is integer-only, so every comparison is exact.  The CUDA
kernel itself is held against mask_scan_reference by chip_smoke.py on
the GPU.
"""

from __future__ import annotations

import string

import numpy as np
import pytest
import torch

from agrep_tpu.compile.query import compile_query as j_compile
from agrep_tpu.ops import kernels as j_kernels
from agrep_tpu.ops import scan as j_scan
from agrep_tpu.options import AgrepError as JAgrepError
from agrep_tpu.options import Options as JOptions
from agrep_tpu.options import parse_args as j_parse
from agrep_tpu_torch.compile.query import compile_query as t_compile
from agrep_tpu_torch.ops import kernels as t_kernels
from agrep_tpu_torch.ops import scan as t_scan
from agrep_tpu_torch.options import AgrepError as TAgrepError
from agrep_tpu_torch.options import parse_args as t_parse

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


def _corpus(rng, n, plants=(), nl_every=61, delim=None):
    """Random printable bytes + newline structure + planted strings."""
    text = rng.integers(32, 127, size=n, dtype=np.uint8)
    text[::nl_every] = 0x0A
    if delim and n > len(delim):
        d = np.frombuffer(delim, dtype=np.uint8)
        for off in rng.integers(0, n - len(d), 13):
            text[off:off + len(d)] = d
    for p in plants:
        pb = np.frombuffer(p, dtype=np.uint8)
        if n > len(pb):
            for off in rng.integers(0, n - len(pb), 17):
                text[off:off + len(pb)] = pb
    return text


def _halo(consts, D):
    return min(max(consts.get("m", 32) + D + 2, 48), L)


# ---------------------------------------------------------------------
# kernel module: planes vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------

CASES = [
    # tests/test_pallas_kernel.py CASES: (pattern, opts, D, sizes)
    ("matching", dict(D=2, approx=True, linenum=True), 2, [3000, 5003]),
    ("hello", dict(linenum=True), 0, [2500]),
    ("wor[kd]s", dict(D=1, approx=True, linenum=True), 1, [4096]),
]


@pytest.mark.parametrize("pattern,kw,D,sizes", CASES,
                         ids=[c[0] for c in CASES])
def test_reference_planes_match_pallas_kernel(pattern, kw, D, sizes):
    q = j_compile(pattern, JOptions(**kw))
    assert q.engine_class == "bitap"
    W = _halo(q.consts, D)
    m = t_kernels.machine_from_arrays(q.folded_mask, q.consts, D, "bitap",
                                      q.costs)
    rng = np.random.default_rng(sum(pattern.encode()))
    for n in sizes:
        text = _corpus(rng, n, plants=(b"matching", b"hello", b"works",
                                       b"matchxng", b"hellp"))
        windows, T = j_scan._pad_and_window(text, W, L)
        d_p, h_ps = j_kernels.pallas_scan_packed(
            windows, q.folded_mask, q.consts, D, W, "bitap", (),
            interpret=True, costs=q.costs)
        got = t_kernels.mask_scan_reference(torch.from_numpy(text), m, W,
                                            L).numpy()
        assert got.shape == (2, T, -(-(W + L) // 32))
        # the Pallas kernel also steps through the zero padding past
        # column W+L-1; the port leaves those bits 0
        valid = np.full(got.shape[2], 0xFFFFFFFF, dtype=np.uint32)
        valid[-1] = (1 << ((W + L) - 32 * (got.shape[2] - 1))) - 1
        np.testing.assert_array_equal(got[0], d_p & valid)
        np.testing.assert_array_equal(got[1], h_ps[0] & valid)
        assert got[1].any(), "no hits -- test is vacuous"


# ---------------------------------------------------------------------
# scan module: event words vs agrep_tpu's numpy backend
# ---------------------------------------------------------------------

def _machine(kind, D):
    """(mask, consts, D, variant, costs, plants) of a named shape."""
    if kind == "bitap":
        q = j_compile("approximate", JOptions(D=D, approx=D > 0,
                                              linenum=True))
        return (q.folded_mask, q.consts, D, "bitap", None,
                (b"approximate", b"aproximate", b"approxjmate"))
    if kind == "sgrep":
        q = j_compile("approximate", JOptions(D=D, approx=D > 0))
        assert q.engine_class == "sgrep"
        return (q.sg_mask, q.sg_consts, D, "sgrep", None,
                (b"approximate", b"aproximate", b"appro\nximate"))
    if kind.startswith("costs"):
        ci, cs, cd = (int(c) for c in kind[5:])
        q = j_compile("matching", JOptions(
            D=D, approx=True, linenum=True, jump=True, cost_insert=ci,
            cost_subst=cs, cost_delete=cd))
        assert q.costs is not None
        return (q.folded_mask, q.consts, D, "bitap", q.costs,
                (b"matching", b"matchng", b"matxching", b"mitchong"))
    if kind.startswith("parts"):
        n = int(kind[5:])
        q = j_compile(";".join(string.ascii_lowercase[:min(n, 12)]),
                      JOptions(linenum=True))
        consts = dict(q.consts)
        if n > 12:
            # no AND pattern of n > 12 terms fits 32 bits: widen endpos
            consts["endpos"] = sum(1 << b for b in range(2, 2 + n))
        assert bin(consts["endpos"]).count("1") == n
        return (q.folded_mask, consts, 0, "bitap", None, (b"abc", b"kl"))
    if kind == "delim":
        q = j_compile("hello", JOptions(linenum=True, delimiter="$$"))
        assert q.consts["d_endpos"] and q.consts["d_mask"] != 0xFFFFFFFF
        return (q.folded_mask, q.consts, 0, "bitap", None,
                (b"hello", b"he\n\nllo", b"\nhello\n"))
    if kind == "delim_from":
        q = j_compile("alice", JOptions(D=D, approx=D > 0, linenum=True,
                                        delimiter="From "))
        return (q.folded_mask, q.consts, D, "bitap", None,
                (b"alice", b"From ", b"alace"))
    raise ValueError(kind)


SCAN_SHAPES = ([("bitap", D) for D in range(9)]
               + [("sgrep", D) for D in range(9)]
               + [("costs211", 3), ("costs123", 3), ("costs312", 2)]
               + [("parts3", 0), ("parts12", 0), ("parts13", 0),
                  ("parts20", 0)]
               + [("delim", 0), ("delim_from", 1)])


@pytest.mark.parametrize("kind,D", SCAN_SHAPES,
                         ids=["%s-D%d" % s for s in SCAN_SHAPES])
def test_scan_events_match_numpy_backend(kind, D):
    mask, consts, D, variant, costs, plants = _machine(kind, D)
    W = _halo(consts, D)
    rng = np.random.default_rng(len(kind) * 16 + D)
    fired = 0
    for n in (1, W - 1, L + 1, 3 * L + 17):
        # agrep reads '$' in -d as a newline: -d '$$' ends a record at
        # an empty line
        text = _corpus(rng, n, plants=plants,
                       delim=b"\n\n" if kind == "delim" else None)
        ev_t = t_scan.scan_events(text, mask, consts, D, variant, costs)
        ev_j = j_scan.scan_events(text, mask, consts, D, variant, costs)
        assert ev_t.dtype == np.uint32 and ev_t.shape == (n,)
        np.testing.assert_array_equal(ev_t, ev_j, err_msg="n=%d" % n)
        fired |= int(np.bitwise_or.reduce(ev_j)) if n else 0
    assert fired, "no events -- test is vacuous"
    if kind.startswith("parts"):
        assert fired & consts["endpos"] == consts["endpos"] or \
            kind == "parts20"
    if kind.startswith("delim"):
        assert fired & consts["d_endpos"]


def test_scan_event_list_chunks_match_whole_scan():
    """The chunked stream (halo carry between chunks) yields the same
    events as one whole-stream scan of the reference backend."""
    mask, consts, D, variant, costs, plants = _machine("bitap", 2)
    rng = np.random.default_rng(3)
    text = _corpus(rng, 9000, plants=plants)
    batches = list(t_scan.scan_event_list(
        lambda lo, hi: text[lo:hi], len(text), mask, consts, D, variant,
        costs, chunk=2500))
    assert len(batches) == 4
    pos = np.concatenate([p for p, _ in batches])
    ev = np.concatenate([e for _, e in batches])
    want = j_scan.scan_events(text, mask, consts, D, variant, costs)
    np.testing.assert_array_equal(pos, np.flatnonzero(want))
    np.testing.assert_array_equal(ev, want[pos])


def test_numpy_backend_is_the_copied_host_path():
    mask, consts, D, variant, costs, plants = _machine("costs211", 3)
    text = _corpus(np.random.default_rng(4), 5000, plants=plants)
    t_scan.set_backend("numpy")
    np.testing.assert_array_equal(
        t_scan.scan_events(text, mask, consts, D, variant, costs),
        j_scan.scan_events(text, mask, consts, D, variant, costs))


def test_wrapper_takes_plain_version_only_for_cpu_tensors():
    mask, consts, D, variant, costs, _ = _machine("bitap", 1)
    m = t_kernels.machine_from_arrays(mask, consts, D, variant, costs)
    text = torch.from_numpy(_corpus(np.random.default_rng(5), 3000))
    W = _halo(consts, D)
    before = t_kernels.launches["mask_scan"]
    planes = t_kernels.mask_scan(text, m, W, L)
    assert t_kernels.launches["mask_scan"] == before
    assert planes.dtype == torch.uint32
    assert torch.equal(planes, t_kernels.mask_scan_reference(text, m, W, L))
    with pytest.raises(TypeError):
        t_kernels.mask_scan(text.to(torch.int32), m, W, L)
    with pytest.raises(ValueError):
        t_kernels.mask_scan(text[::2], m, W, L)
    with pytest.raises(ValueError):
        t_kernels.machine_from_arrays(mask, consts, 9, variant)
    with pytest.raises(ValueError):
        t_kernels.machine_from_arrays(mask, consts, 1, "regex")


# ---------------------------------------------------------------------
# compiled state: compile_query vs agrep_tpu, and machine_from_arrays
# ---------------------------------------------------------------------

# tests/test_flag_matrix.py's flags, plus its -e / -d / -y -B cases and
# BASELINE configs 1-3
FLAG_SETS = ([[f] for f in [
    "-c", "-n", "-b", "-i", "-ia", "-i#", "-i0", "-v", "-l", "-h", "-s",
    "-w", "-x", "-y", "-u", "-q", "-p", "-t", "-A", "-G", "-L", "-M",
    "-O", "-P", "-Z", "-k", "-1", "-2", "-V0", "-V1", "-CP437", "-CP850",
    "-g", "-a"]]
    + [["-e"], ["-d", "$$"], ["-y", "-B"], ["-c"], ["-1", "-n"],
       ["-3", "-D2", "-I1", "-S1", "-w", "-i"]])


def _compiled(parse, compile_, err, argv):
    try:
        opts, pattern, _files = parse(argv)
        return compile_(pattern, opts)
    except err as e:
        return "AgrepError: %s" % e


@pytest.mark.parametrize("flags", FLAG_SETS,
                         ids=["_".join(f) for f in FLAG_SETS])
def test_compiled_state_matches(flags):
    argv = flags + ["hello", "c.txt"]
    qt = _compiled(t_parse, t_compile, TAgrepError, argv)
    qj = _compiled(j_parse, j_compile, JAgrepError, argv)
    if isinstance(qj, str):
        assert qt == qj
        return
    assert qt.engine_class == qj.engine_class
    assert qt.D == qj.D and qt.costs == qj.costs
    for name in ("folded_mask", "sg_mask"):
        a, b = getattr(qt, name), getattr(qj, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert qt.consts == qj.consts
    assert qt.sg_consts == qj.sg_consts
    # both packages' arrays give the port one and the same machine
    if qj.engine_class == "bitap":
        arrays = [(q.folded_mask, q.consts, "bitap", q.costs)
                  for q in (qt, qj)]
    else:
        arrays = [(q.sg_mask, q.sg_consts, "sgrep", None) for q in (qt, qj)]
    mt, mj = (t_kernels.machine_from_arrays(a, c, qj.D, v, co)
              for a, c, v, co in arrays)
    assert torch.equal(mt.table, mj.table)
    assert mt.table.dtype == torch.uint32 and mt.table.shape == (256,)
    assert (mt.init0, mt.init1_ns, mt.noerr, mt.d_endpos, mt.d_mask,
            mt.hit_masks, mt.costs, mt.variant) == \
        (mj.init0, mj.init1_ns, mj.noerr, mj.d_endpos, mj.d_mask,
         mj.hit_masks, mj.costs, mj.variant)
