"""The segment maps of the sticky machines' long lanes, on the CPU.

A lane longer than ops/scan.py's LANES_LONG is cut into segments on the
card (csrc/bitap_lanes.cu's maps kernel): the step is linear over (OR,
AND), so each segment is a Boolean map with one column a relevant node
(ops.scan.relevant_nodes), and the maps compose exactly.  Held here:

- lane_maps_reference (the maps and their composition in plain torch)
  against agrep_tpu.ops.scan.scan_lanes, case by case, on every machine
  of tests/test_torch_bitap_lanes.py's MACHINES, on lanes of 2-64 KiB
  with no delimiter inside, cut at segment lengths 1, 7, 64 and 4096 and
  at random points, the lane at 0 from Init0, with -v;
- that projecting the states onto the relevant nodes leaves the serial
  walk's hits unchanged;
- with hypothesis, that composing A's and B's maps gives the map of A
  followed by B, on random entry states;
- the split and the columns that lanes_geometry reports, and the chunk
  count that the wrapper reads back with its bounds check.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from agrep_tpu.ops import scan as j_scan
from agrep_tpu_torch.ops import scan as t_scan
from agrep_tpu_torch.runtime import engine as t_engine

from .test_torch_bitap_lanes import MACHINES, WORDS, _query
from .torch_oracle import one_thread

U32 = 0xFFFFFFFF
# the relevant nodes the code fixes for each machine
NODES = {"p_k0": 10, "p_k2": 23, "wild_k0": 9, "wild_k1": 8, "wild_and": 10,
         "wild_or": 18, "wild_costs": 20, "wild_costs_i2": 30,
         "wild_k8": 149, "p_k8": 140}
# filler without most patterns' letters, so that hits stay sparse
FILLER = np.frombuffer(b"xyzqwj -", np.uint8)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _machine(argv):
    q = _query(argv)
    m = t_scan.lanes_machine(q.folded_mask, t_engine._sticky_consts(q), q.D,
                             q.costs, "cpu")
    return q, m


def _lane(rng, n: int) -> bytes:
    """n bytes of filler and letters with a few words planted, no
    newline, then the newline that ends the lane."""
    t = rng.choice(FILLER, n)
    letters = rng.random(n) < 0.3
    t[letters] = rng.integers(97, 123, int(letters.sum()), dtype=np.uint8)
    t = bytearray(t.tobytes())
    for _ in range(int(rng.integers(0, 3))):
        w = WORDS[int(rng.integers(0, len(WORDS)))]
        if n > len(w):
            at = int(rng.integers(0, n - len(w)))
            t[at:at + len(w)] = w
    return bytes(t) + b"\n"


def _walk(m, data: bytes, s) -> tuple:
    """The serial walk on Python ints: (exit states, hits)."""
    tab = m.table.tolist()
    s, acc = [int(v) & U32 for v in s], 0
    for b in data:
        s = t_scan._lane_levels(s, tab[b], m)
        acc |= s[m.D]
    return s, acc & m.endpos


# segment lengths and, for each, the lanes' lengths at D 0 and above
# (the levels' column walks are slower, so their lanes are shorter)
CUTS = {1: ((2048, 2100), (2048,)), 7: ((2048, 4500), (2048, 3000)),
        64: ((2048, 12000), (2048, 8000)),
        4096: ((2048, 20000, 65535), (2048, 8200)),
        "random": ((2048, 12000), (2048, 8000))}


@pytest.mark.parametrize("cut", list(CUTS), ids=[str(c) for c in CUTS])
@pytest.mark.parametrize("name,argv", MACHINES, ids=[m[0] for m in MACHINES])
def test_lane_maps_match_scan_lanes(name, argv, cut):
    """lane_maps_reference's hits and verdicts equal scan_lanes' on lanes
    with no delimiter inside, the lane at 0 from Init0."""
    q, m = _machine(argv)
    rng = np.random.default_rng(100 * MACHINES.index((name, argv))
                                + list(CUTS).index(cut))
    sizes = CUTS[cut][q.D > 0]
    lanes = [_lane(rng, n) for n in sizes]
    lens = np.asarray([len(x) - 1 for x in lanes], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lens + 1)[:-1]]).astype(np.int64)
    text = np.frombuffer(b"".join(lanes), dtype=np.uint8)
    init = t_engine._lane_inits(q, q.D)
    first = [int(q.consts["init0"])] * (q.D + 1)
    consts = t_engine._sticky_consts(q)
    mat = np.zeros((len(lanes), int(lens.max()) + 1), dtype=np.uint8)
    for r, x in enumerate(lanes):
        mat[r, :len(x)] = np.frombuffer(x, dtype=np.uint8)
    want = j_scan.scan_lanes(mat, lens, q.folded_mask, consts, q.D, q.costs,
                             np.asarray(init, dtype=np.uint32), True)
    want[0] = j_scan.scan_lanes(mat[:1], lens[:1], q.folded_mask, consts,
                                q.D, q.costs,
                                np.asarray(first, dtype=np.uint32), True)[0]
    kw = {"seg": cut} if cut != "random" else {
        "cuts": [sorted(rng.integers(1, n + 1, int(rng.integers(3, 12))))
                 for n in lens]}
    endpos = int(q.consts["endpos"])
    for invert, groups in ((False, None), (True, 3)):
        v, hits = t_scan.lane_maps_reference(
            torch.from_numpy(text.copy()), torch.from_numpy(starts),
            torch.from_numpy(lens), m, init, first, q.and_flag, invert,
            groups=groups, **kw)
        assert hits.dtype == torch.uint32
        assert np.array_equal(hits.numpy(), want), (name, cut)
        h = want.astype(np.int64)
        fire = (((h == endpos) | invert) if q.and_flag
                else ((h != 0) ^ invert))
        assert np.array_equal(v.numpy(), fire), (name, cut, invert)


@pytest.mark.parametrize("name,argv", MACHINES, ids=[m[0] for m in MACHINES])
def test_projection_keeps_the_hits(name, argv):
    """The serial walk from random states, and from the same states
    projected onto the relevant nodes (ANDed with their masks at every
    column too), give the same hits and agree on the relevant nodes."""
    q, m = _machine(argv)
    assert m.nodes == NODES[name]
    assert m.nodes == sum(bin(r).count("1") for r in m.relevant)
    rng = np.random.default_rng(7 + MACHINES.index((name, argv)))
    tab = m.table.tolist()
    for _ in range(6):
        data = _lane(rng, int(rng.integers(1, 400)))
        s = [int(x) for x in rng.integers(0, 1 << 32, q.D + 1)]
        full, hits = _walk(m, data, s)
        p = [v & r for v, r in zip(s, m.relevant)]
        acc = 0
        for b in data:
            p = [v & r for v, r in
                 zip(t_scan._lane_levels(p, tab[b], m), m.relevant)]
            acc |= p[m.D]
        assert acc & m.endpos == hits
        assert [v & r for v, r in zip(full, m.relevant)] == p


def _map_of(m, data: bytes):
    text = torch.frombuffer(bytearray(data + b"\0"), dtype=torch.uint8)
    mp = t_scan.segment_maps(text, torch.zeros(1, dtype=torch.int64),
                             torch.tensor([len(data)]), m)
    return t_scan.LaneMap(mp.cols[0], mp.hits[0])


MACHINE_CACHE: dict = {}


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(which=st.integers(0, len(MACHINES) - 1),
       a=st.binary(max_size=24), b=st.binary(max_size=24),
       states=st.lists(st.integers(0, U32), min_size=9, max_size=9))
def test_composition_is_the_walk_of_both(which, a, b, states):
    """compose_maps(map(A), map(B)) applied to a random entry state's
    projection gives the projection of the serial walk of A then B and
    its hits; so does stepping the vector through map(A), then map(B)."""
    name, argv = MACHINES[which]
    if name not in MACHINE_CACHE:
        MACHINE_CACHE[name] = _machine(argv)[1]
    m = MACHINE_CACHE[name]
    # the machine's letters with the test's bytes, so that words form
    alpha = bytes(sorted(set(b"".join(w for w in WORDS))))
    a = bytes(alpha[x % len(alpha)] if x & 1 else x for x in a)
    b = bytes(alpha[x % len(alpha)] if x & 1 else x for x in b)
    s = states[:m.D + 1]
    full, hits = _walk(m, a + b, s)
    want = t_scan.project_state(full, m)
    ma, mb = _map_of(m, a), _map_of(m, b)
    v0 = t_scan.project_state(s, m)
    v, h = t_scan.apply_map(t_scan.compose_maps(ma, mb), v0)
    assert torch.equal(v, want) and h == hits
    va, ha = t_scan.apply_map(ma, v0)
    vb, hb = t_scan.apply_map(mb, va)
    assert torch.equal(vb, want) and ha | hb == hits


@pytest.mark.parametrize("name,argv", MACHINES, ids=[m[0] for m in MACHINES])
def test_geometry_fixes_the_split_and_the_columns(name, argv, monkeypatch):
    """lanes_geometry reports LANES_LONG, the machine's n relevant nodes
    and maps_plan's segment and block: nothing of them is measured."""
    from agrep_tpu_torch.ops import _cuda, kernels
    _q, m = _machine(argv)
    monkeypatch.setattr(t_scan, "_lanes_occupancy",
                        lambda *a: (2, 40, 0))
    monkeypatch.setattr(kernels, "_sm_count", lambda index: 132)
    monkeypatch.setattr(_cuda, "device_index", lambda device: 0)
    geo = t_scan.lanes_geometry(5, m, "cuda", 7)
    plan = t_scan.maps_plan(m.nodes)
    assert t_scan.LANES_LONG == 4096 and geo["long"] == 4096
    assert geo["n"] == m.nodes == NODES[name]
    assert (geo["seg"], geo["groups"], geo["maps_threads"],
            geo["maps_smem"], geo["maps_grid"]) == (
        plan["seg"], plan["groups"], plan["threads"], plan["smem"], 7)
    # the kernel's block: groups of n threads, 32 // n a warp up to 16,
    # else ceil(n / 32) warps a group; the chunk's map no larger than it
    words = -(-m.nodes // 32)
    if m.nodes <= 16:
        assert plan["threads"] * (32 // m.nodes) == 32 * plan["groups"]
    else:
        assert plan["threads"] == 32 * words * plan["groups"]
    assert plan["threads"] <= 32 * t_scan.MAPS_WARPS
    assert 4 * (words + 1) * m.nodes <= plan["chunk"]
    assert plan["seg"] >= t_scan.MAPS_MIN_SEG


def test_relevant_nodes_of_two_machines():
    """-p aproximat keeps its ten pattern bits; a 2-error -p hello keeps
    at each level the bits that still reach level 2's endpos."""
    _q, m = _machine(["-p", "aproximat"])
    assert m.relevant == (0x3FF,)
    _q, m = _machine(["-2", "-p", "hello"])
    assert m.relevant == (0x1FF, 0xFF, 0x3F)


def test_wrapper_reads_the_chunks_with_its_bounds_check():
    """lane_chunks counts a long lane's chunks (none at LANES_LONG record
    bytes, one from LANES_LONG + 1 to a chunk, two past it) and raises
    for a lane outside the text; on the CPU bitap_lanes gives the plain
    version's output for any length."""
    q, m = _machine(["-p", "aproximat"])
    T, chunk = t_scan.LANES_LONG, t_scan.maps_plan(m.nodes)["chunk"]
    n = 2 * chunk + 10
    text = torch.from_numpy(np.frombuffer(
        _lane(np.random.default_rng(3), n - 1), np.uint8).copy())
    lens = torch.tensor([0, T, T + 1, chunk - 1, chunk, n - 1])
    starts = torch.zeros_like(lens)
    assert t_scan.lane_chunks(text, starts, lens, m) == 0 + 0 + 1 + 1 + 2 + 3
    with pytest.raises(ValueError):
        t_scan.lane_chunks(text, starts, lens + 1, m)
    init = t_engine._lane_inits(q, q.D)
    before = dict(t_scan.launches)
    got = t_scan.bitap_lanes(text, starts, lens, m, init)
    want = t_scan.bitap_lanes_reference(text, starts, lens, m, init)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert t_scan.launches == before
