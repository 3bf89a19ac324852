"""Windowed-parallel shift-or scan (production path).

The sequential bit-parallel automaton has a bounded dependence window:
any state bit after byte i is determined by at most m+D preceding bytes
(plus statically-on bits), and delimiter resets only shorten chains.
So the stream is cut into T tiles of L bytes, each prefixed with a halo
of W >= m+D+1 real preceding bytes, and all tiles are scanned in
parallel from a cold state -- by the end of the halo every tile's state
is exact.  This turns the reference's strictly sequential loops
(bitap.c:169-283, asearch.c:94-232) into an embarrassingly parallel
computation: one GPU thread per tile, with no cross-tile communication
at all.

Variants:
  'bitap'  -- the mask machine: exact / k-error / non-uniform costs,
              record resets at exact delimiter completion.
  'sgrep'  -- the simple-pattern engine: k-error shift-or with newline
              reset (sgrep.c agrep():1177-1237 semantics).

Backends (AGREP_TORCH_BACKEND, or set_backend()):
  'torch' (default) -- the mask-machine kernel of ops/kernels.py on
              AGREP_TORCH_DEVICE (set_device()): 'cuda' (default), the
              hand-written CUDA kernel, or 'cpu', its plain PyTorch
              version.  With 'cuda' and no usable card, the scan raises.
  'numpy'   -- the exact host backend (vectorized numpy, plus the native
              C twin for large inputs), chosen explicitly.

Output: scan_event_pairs gives the sparse (position, event word) pairs
of the bytes whose word is not 0, in stream order; scan_events the
dense uint32 event word per input byte, built from them.  The word's bit
layout equals the mask machine's (delimiter bit = d_endpos, part pulses
= endposition bits).  For 'sgrep', bit 0 = match pulse.  On the torch
backend the pairs are compacted where the planes lie (ops/kernels.py
event_pairs), and only they cross to the host.  For the bitap engine,
scan_record_verdicts and scan_record_list go one step further on the
torch backend: the planes are cut into records on the scan device
(ops/kernels.py record_verdicts, no pair written), and only the rows of
the records that fire cross to the host.

Sticky machines (-p, '#' wildcards) have no bounded window, so they are
scanned a record a lane: scan_lanes on the numpy backend; on the torch
backend scan_lane_rows cuts the records at a one-byte delimiter on the
scan device (renfa_kernel.line_index), steps them there (bitap_lanes:
csrc/bitap_lanes.cu, or its plain version bitap_lanes_reference on the
CPU) and sends back only the rows of the records that fire
(renfa_kernel.line_rows).  The step is linear over (OR, AND), so a
record longer than LANES_LONG is cut into segments whose Boolean maps
(one column a relevant node) compose exactly: no sticky bit is lost at
a cut (lane_maps_reference is the plain version of that route).
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np

DEFAULT_TILE = 1024
U32 = 0xFFFFFFFF

BACKENDS = ("torch", "numpy")
DEVICES = ("cuda", "cpu")
_BACKEND = os.environ.get("AGREP_TORCH_BACKEND", "torch")
_DEVICE = os.environ.get("AGREP_TORCH_DEVICE", "cuda")


def set_backend(name: str) -> None:
    global _BACKEND
    if name not in BACKENDS:
        raise ValueError("backend must be one of %s, got %r"
                         % (BACKENDS, name))
    _BACKEND = name


def set_device(name: str) -> None:
    global _DEVICE
    if name not in DEVICES:
        raise ValueError("device must be one of %s, got %r"
                         % (DEVICES, name))
    _DEVICE = name


def require_device() -> None:
    """Raise unless the configured backend and device can run: the
    default torch+cuda setting needs a CUDA card, and never carries on
    quietly on the CPU."""
    if _BACKEND not in BACKENDS:
        raise ValueError("AGREP_TORCH_BACKEND must be one of %s, got %r"
                         % (BACKENDS, _BACKEND))
    if _DEVICE not in DEVICES:
        raise ValueError("AGREP_TORCH_DEVICE must be one of %s, got %r"
                         % (DEVICES, _DEVICE))
    if _BACKEND == "torch" and _DEVICE == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError(
                "agrep_tpu_torch scans on a CUDA GPU by default, but "
                "torch.cuda.is_available() is False.  Set "
                "AGREP_TORCH_DEVICE=cpu for the plain PyTorch scan, or "
                "AGREP_TORCH_BACKEND=numpy for the host backend.")


def _pad_and_window(text: np.ndarray, W: int, L: int):
    """Return (windows u8[T, W+L], n_tiles) built on host."""
    N = text.shape[0]
    T = max(1, -(-N // L))
    total = T * L
    padded = np.zeros(W + total, dtype=np.uint8)
    padded[W:W + N] = text
    body = padded[W:].reshape(T, L)
    halo = padded[:total].reshape(T, L)[:, :W]
    return np.concatenate([halo, body], axis=1), T


def _halo(consts: dict, D: int, tile: int) -> int:
    return min(max(consts.get("m", 32) + D + 2, 48), tile)


def _bounded(consts: dict, variant: str) -> bool:
    """True when a cold start W bytes early gives the exact state: no
    sticky/wildcard bits (init1_ns == init0); the sgrep machine always."""
    return (variant == "sgrep"
            or consts.get("init1_ns") == consts.get("init0"))


def scan_event_pairs(text: np.ndarray, mask_table: np.ndarray,
                     consts: dict, D: int, variant: str = "bitap",
                     costs: tuple | None = None, keep_from: int = 0,
                     tile: int = DEFAULT_TILE) -> tuple:
    """Scan a byte stream; returns the sparse events (pos int64[],
    ev uint32[]) at positions >= keep_from, ascending, one pair for each
    byte whose event word is not 0.

    text: uint8[N] (host); mask_table: uint32[256] (pre-folded);
    consts: dict from bitword.machine_constants (bitap) or
    {'endpos': final-bit, 'm': m} (sgrep).
    """
    N = int(text.shape[0])
    if N <= keep_from:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.uint32)
    W = _halo(consts, D, tile)
    L = tile
    if _BACKEND == "torch":
        from ..runtime import trace
        with trace.span("device_layer"):
            return _scan_torch(text, mask_table, consts, D, W, L, N,
                               variant, costs, keep_from)
    if _BACKEND != "numpy":
        raise ValueError("AGREP_TORCH_BACKEND must be one of %s, got %r"
                         % (BACKENDS, _BACKEND))
    if N >= (1 << 20) and _bounded(consts, variant):
        # sequential C twin of the windowed machine: exact whenever
        # the dependence window is bounded
        from .. import native
        pairs = native.bitap_scan_events(text, mask_table, consts,
                                         D, variant, costs)
        if pairs is not None:
            pos, words = pairs
            keep = pos >= keep_from
            return pos[keep].astype(np.int64), words[keep].copy()
    windows, T = _pad_and_window(text, W, L)
    cvec = np.asarray([
        consts.get("init0", 0), consts.get("init1_ns", 0),
        consts.get("noerr", 0), consts.get("d_endpos", 0),
        consts.get("endpos", 0), consts.get("d_mask", 0xFFFFFFFF),
        0, 0], dtype=np.uint32)
    ev = _scan_windows_np(windows, mask_table, cvec, D, W, variant, costs)
    ev = np.asarray(ev)[:, W:].reshape(-1)[:N]
    pos = np.flatnonzero(ev[keep_from:]) + keep_from
    return pos.astype(np.int64), ev[pos]


def scan_events(text: np.ndarray, mask_table: np.ndarray, consts: dict,
                D: int, variant: str = "bitap",
                costs: tuple | None = None,
                tile: int = DEFAULT_TILE) -> np.ndarray:
    """Scan a byte stream; returns a uint32 event word per byte: the
    pairs of scan_event_pairs, written into zeros."""
    N = int(text.shape[0])
    pos, ev = scan_event_pairs(text, mask_table, consts, D, variant,
                               costs, 0, tile)
    events = np.zeros(N, dtype=np.uint32)
    events[pos] = ev
    return events


STREAM_CHUNK = int(os.environ.get("AGREP_TORCH_CHUNK_MB", "32")) << 20


def scan_event_list(reader, n: int, mask_table: np.ndarray, consts: dict,
                    D: int, variant: str = "bitap",
                    costs: tuple | None = None,
                    tile: int = DEFAULT_TILE, chunk: int | None = None):
    """Chunked scan over a random-access byte source; yields sparse
    (pos int64[], ev uint32[]) event batches in stream order using
    O(chunk) memory (the streaming path for large files).

    reader(lo, hi) -> uint8[hi-lo].  Every chunk after the first is
    scanned with a W-byte halo of real preceding bytes and its first W
    events dropped: by the halo-warmup argument (module docstring) the
    states at the chunk body are exact, so the concatenated event
    stream equals a whole-stream scan bit-for-bit.  A failed chunk scan
    raises; nothing is re-run on another backend."""
    if chunk is None:
        chunk = STREAM_CHUNK
    W = _halo(consts, D, tile)
    bounded = _bounded(consts, variant)
    g0 = 0
    while g0 < n:
        g1 = min(n, g0 + chunk)
        lo = g0 - W if g0 >= W else 0
        text = reader(lo, g1)
        if _BACKEND == "numpy" and bounded:
            # sparse C scan: skip the dense event array round-trip
            from .. import native
            pairs = native.bitap_scan_events(text, mask_table, consts,
                                             D, variant, costs)
            if pairs is not None:
                pos, words = pairs
                keep = pos >= (g0 - lo)
                yield (pos[keep] + lo).astype(np.int64), \
                    words[keep].copy()
                g0 = g1
                continue
        pos, ev = scan_event_pairs(text, mask_table, consts, D, variant,
                                   costs, g0 - lo, tile)
        yield pos + lo, ev
        g0 = g1


def records_on_device() -> bool:
    """True where the bitap engine takes its records from the scan
    (scan_record_verdicts, scan_record_list: the torch backend), False
    where it cuts the scan's events into records itself (the numpy
    backend)."""
    if _BACKEND not in BACKENDS:
        raise ValueError("AGREP_TORCH_BACKEND must be one of %s, got %r"
                         % (BACKENDS, _BACKEND))
    return _BACKEND == "torch"


def scan_record_list(reader, n: int, mask_table: np.ndarray, consts: dict,
                     D: int, costs: tuple | None = None, skip_pos: int = -1,
                     and_flag: bool = False, invert: bool = False,
                     tile: int = DEFAULT_TILE, chunk: int | None = None):
    """The bitap engine's records of a byte source that fire, chunk by
    chunk as scan_event_list scans it: yields int64 [R, 3] rows a chunk,
    in stream order, each (ordinal of the record's end among the
    stream's record ends, the end's stream position, the stream position
    of the end before it or -1 where there is none).

    The scan's planes are cut into records on the scan device
    (kernels.record_verdicts, with the event at skip_pos dropped,
    and_flag and invert its verdict), each chunk from the carry of the
    chunks before it, its rows allocated at twice the rows of the chunk
    before it (kernels.rows_capacity); only the rows cross to the host.
    Torch backend only: the numpy backend's engines cut the events
    themselves."""
    if _BACKEND != "torch":
        raise ValueError("the record verdicts run on the torch backend, "
                         "not on %r" % (_BACKEND,))
    if chunk is None:
        chunk = STREAM_CHUNK
    from . import kernels
    from ..runtime import trace
    W = _halo(consts, D, tile)
    acc, base, last, capacity = 0, 0, -1, None
    g0 = 0
    while g0 < n:
        g1 = min(n, g0 + chunk)
        lo = g0 - W if g0 >= W else 0
        text = reader(lo, g1)
        with trace.span("device_layer"):
            rows, (n_ends, c_last, acc) = _records_torch(
                text, mask_table, consts, D, W, tile, len(text), costs,
                g0 - lo, skip_pos - lo if skip_pos >= lo else -1, and_flag,
                invert, acc, capacity)
        capacity = kernels.rows_capacity(len(text), len(rows))
        if len(rows):
            rows[:, :2] += (base, lo)
            first = rows[:, 2] < 0
            rows[:, 2] += lo
            rows[first, 2] = last
        if n_ends:
            last = c_last + lo
        base += n_ends
        yield rows
        g0 = g1


def scan_record_verdicts(text: np.ndarray, mask_table: np.ndarray,
                         consts: dict, D: int, costs: tuple | None = None,
                         skip_pos: int = -1, and_flag: bool = False,
                         invert: bool = False,
                         tile: int = DEFAULT_TILE) -> np.ndarray:
    """scan_record_list's rows of one whole stream (one chunk)."""
    n = int(text.shape[0])
    batches = list(scan_record_list(lambda lo, hi: text[lo:hi], n,
                                    mask_table, consts, D, costs, skip_pos,
                                    and_flag, invert, tile, max(n, 1)))
    return batches[0] if batches else np.zeros((0, 3), dtype=np.int64)


# ---------------------------------------------------------------------
# torch backend
# ---------------------------------------------------------------------

def _planes_torch(text, mask_table, consts, D, W, L, variant, costs):
    """The mask-machine kernel (CUDA) or its plain PyTorch version (CPU)
    over text: its planes and their event values (kernels.event_vals),
    on the scan device."""
    import torch

    from . import kernels
    if variant not in ("bitap", "sgrep"):
        raise ValueError("unknown scan variant %r" % (variant,))
    require_device()
    dev = torch.device(_DEVICE)
    mach = kernels.machine_from_arrays(mask_table, consts, D, variant,
                                       costs, dev)
    planes = kernels.mask_scan(kernels.to_device(text, dev), mach, W, L)
    vals = kernels.upload(torch.from_numpy(np.asarray(
        kernels.event_vals(mach), dtype=np.uint32)), dev)
    return planes, vals


def _pairs_torch(text, mask_table, consts, D, W, L, N, variant, costs,
                 keep_from):
    """_planes_torch's planes compacted into (position, event word) pairs
    where they lie (kernels.event_pairs); the pairs stay on the scan
    device."""
    from . import kernels
    planes, vals = _planes_torch(text, mask_table, consts, D, W, L,
                                 variant, costs)
    return kernels.event_pairs(planes, vals, W, L, N, keep_from)


def _scan_torch(text, mask_table, consts, D, W, L, N, variant, costs,
                keep_from):
    """_pairs_torch's pairs, brought to the host."""
    from . import kernels
    pos, ev = _pairs_torch(text, mask_table, consts, D, W, L, N, variant,
                           costs, keep_from)
    return kernels.to_host(pos), kernels.to_host(ev)


def _records_torch(text, mask_table, consts, D, W, L, N, costs, keep_from,
                   skip_pos, and_flag, invert, acc, capacity=None):
    """_planes_torch's bitap planes cut into records where they lie
    (kernels.record_verdicts, its rows allocated at capacity); no pair is
    written, and only the rows of the records that fire, and the
    summary, come to the host."""
    from . import kernels
    from ..runtime import trace
    planes, vals = _planes_torch(text, mask_table, consts, D, W, L, "bitap",
                                 costs)
    rows, (n_ends, last, acc, pairs) = kernels.record_verdicts(
        planes, vals, W, L, N, keep_from, consts["endpos"],
        consts["d_endpos"], skip_pos, and_flag, invert, acc,
        capacity=capacity)
    rows = kernels.to_host(rows)
    if trace.ENABLED:
        trace.add("record_pairs", pairs)
        trace.add("record_rows", len(rows))
    return rows, (n_ends, last, acc)


# ---------------------------------------------------------------------
# the sticky machines' record lanes (torch backend)
# ---------------------------------------------------------------------

LANES_MAX_D = 8
# Threads a block of csrc/bitap_lanes.cu's one-thread walk.
LANES_THREADS = 256
# A lane whose record is longer than this takes the segment maps
# (bitap_lane_maps_kernel), every other the one-thread walk.  Both give
# the same hits; the constant comes from tools/torch_lanes_sweep.py's
# sweep on the card (PERF.md) and is never measured at run time.
LANES_LONG = 4096
# Warps a block of the maps kernel at most (kMapsThreads / 32), and the
# least bytes of a segment.
MAPS_WARPS = 16
MAPS_MIN_SEG = 1024
# plain version: lane cells a vectorized pass, and the fewest lanes of a
# length bucket it steps as tensors (fewer walk on Python ints)
_LANE_CELLS = 1 << 22
_SCALAR_LANES = 16
_LANE_BUCKETS = (64, 256, 1024, 8192, 49152 + 64)

# Calls of bitap_lanes that launched on the card, and launches of its
# segment maps kernel, since the counts were last set to 0.
launches = {"bitap_lanes": 0, "bitap_lane_maps": 0}


class LanesMachine(NamedTuple):
    """A sticky bitap machine as bitap_lanes takes it."""
    table: "object"         # torch u32[256], the folded mask table, on
                            # the scan device
    init1: int              # the sticky Init1 (~0 for -p)
    noerr: int
    endpos: int
    D: int
    costs: tuple | None     # (I, S, DD), each 1..D+1; None: uniform
    relevant: tuple         # D+1 masks: the nodes that reach a hit
                            # (relevant_nodes)
    nodes: int              # how many: the segment maps' columns


def relevant_nodes(table: np.ndarray, noerr: int, endpos: int, D: int,
                   costs: tuple | None) -> tuple:
    """The (level, bit) nodes of a sticky machine from which the step's
    edges reach an endpos bit of level D, as D+1 masks.  The edges: a
    bit to the next lower one through the union of the mask table (the
    >> 1 & cm) and, from a lower level, through noerr (the error terms
    after >> 1); level k - 1 to k (uniform), or k - I to k and, through
    noerr, k - S and k - DD to k (costs).  Every edge into a relevant
    node starts at one, so the levels ANDed with these masks step to the
    same hits: the segment maps keep a column a node."""
    union = int(np.bitwise_or.reduce(np.asarray(table, dtype=np.uint32)))
    rel = [0] * D + [int(endpos) & U32]
    while True:
        old = list(rel)
        for k in range(D, -1, -1):
            down = (rel[k] << 1) & U32
            rel[k] |= down & (union << 1)
            err = down & ((int(noerr) << 1) & U32)
            if costs is None:
                if k:
                    rel[k - 1] |= rel[k] | err
            else:
                ci, cs, cd = costs
                if k - ci >= 0:
                    rel[k - ci] |= rel[k]
                for c in (cs, cd):
                    if k - c >= 0:
                        rel[k - c] |= err
        if rel == old:
            return tuple(rel)


def lanes_machine(mask_table: np.ndarray, consts: dict, D: int,
                  costs: tuple | None, device) -> LanesMachine:
    """bitap_lanes' machine from a compiled query's folded mask table and
    its sticky consts (consts["init1"] is the Init1 the lanes step
    with), with its relevant nodes."""
    import torch

    from . import kernels
    if not 0 <= int(D) <= LANES_MAX_D:
        raise ValueError("D=%r outside 0..%d" % (D, LANES_MAX_D))
    table = np.ascontiguousarray(np.asarray(mask_table, dtype=np.uint32))
    if table.shape != (256,):
        raise ValueError("mask table must be u32[256], got %r"
                         % (table.shape,))
    if costs is not None and not all(1 <= int(c) <= D + 1 for c in costs):
        raise ValueError("costs %r outside 1..D+1 = %d" % (costs, D + 1))
    costs = None if costs is None else tuple(int(c) for c in costs)
    noerr, endpos = int(consts["noerr"]) & U32, int(consts["endpos"]) & U32
    if not endpos:
        raise ValueError("a machine without endpos bits never hits")
    rel = relevant_nodes(table, noerr, endpos, int(D), costs)
    return LanesMachine(
        table=kernels.upload(torch.from_numpy(table.copy()), device),
        init1=int(consts["init1"]) & U32, noerr=noerr, endpos=endpos,
        D=int(D), costs=costs, relevant=rel,
        nodes=sum(bin(r).count("1") for r in rel))


def maps_plan(nodes: int) -> dict:
    """The maps kernel's shape for a machine of `nodes` relevant nodes
    (at least 1): a map's u32 `size` ((ceil(nodes / 32) + 1) x nodes);
    `groups` segments a block (32 // nodes a warp of MAPS_WARPS for
    nodes <= 16, else one a ceil(nodes / 32) warps, as many as MAPS_WARPS
    warps hold), `threads` a block and its shared bytes (`smem`, the
    groups' maps); `seg`, the bytes a segment: the least power of two
    from MAPS_MIN_SEG with a chunk's map no larger than the chunk
    (`chunk`, groups x seg bytes)."""
    words = -(-nodes // 32)
    if nodes <= 16:
        groups, threads = MAPS_WARPS * (32 // nodes), 32 * MAPS_WARPS
    else:
        groups = max(1, MAPS_WARPS // words)
        threads = 32 * words * groups
    size = (words + 1) * nodes
    seg = MAPS_MIN_SEG
    while seg * groups < 4 * size:
        seg *= 2
    return {"size": size, "groups": groups, "threads": threads,
            "smem": 4 * size * groups, "seg": seg, "chunk": seg * groups}


def bitap_lanes(text, starts, lens, m: LanesMachine, init, first=None,
                and_flag: bool = False, invert: bool = False) -> tuple:
    """The R lanes of a 1-D uint8 text through a sticky machine: lane r
    is the lens[r] + 1 bytes text[starts[r] .. starts[r] + lens[r]], a
    record and its one-byte delimiter, stepped from the D+1 states init
    (the lane that starts at 0 from `first`, init where None) without a
    reset.  Returns (verdicts bool[R], hits u32[R]) on the text's device:
    hits the OR over the lane's columns of (state_D & endpos), scan_lanes'
    value; the verdict, with and_flag, hits == endpos or invert, else
    (hits != 0) ^ invert.  A CUDA tensor goes to the kernels
    (csrc/bitap_lanes.cu): a lane of at most LANES_LONG record bytes is
    walked by one thread, a longer one is cut into segments whose maps
    (one column a relevant node) are composed on the card; a CPU tensor
    goes to bitap_lanes_reference.  The bounds check and the long lanes'
    chunk count come back in one read."""
    import torch
    if text.dtype != torch.uint8 or text.dim() != 1:
        raise TypeError("text must be a 1-D uint8 tensor, got %s %r"
                        % (text.dtype, tuple(text.shape)))
    for name, t in (("starts", starts), ("lens", lens)):
        if t.dtype != torch.int64 or t.dim() != 1:
            raise TypeError("%s must be a 1-D int64 tensor, got %s %r"
                            % (name, t.dtype, tuple(t.shape)))
    if starts.shape != lens.shape:
        raise ValueError("starts %r and lens %r differ in shape"
                         % (tuple(starts.shape), tuple(lens.shape)))
    if not (text.is_contiguous() and starts.is_contiguous()
            and lens.is_contiguous()):
        raise ValueError("text, starts and lens must be contiguous")
    dev = text.device
    if starts.device != dev or lens.device != dev or m.table.device != dev:
        raise ValueError("text on %s, starts on %s, lens on %s, the "
                         "machine on %s" % (dev, starts.device, lens.device,
                                            m.table.device))
    first = init if first is None else first
    if len(init) != m.D + 1 or len(first) != m.D + 1:
        raise ValueError("init and first take D+1 = %d states, got %d and "
                         "%d" % (m.D + 1, len(init), len(first)))
    if not (text.is_cuda or dev.type == "cpu"):
        raise ValueError("no bitap lanes kernel for device %s" % dev)
    if starts.numel() == 0:
        return (torch.zeros(0, dtype=torch.bool, device=dev),
                torch.zeros(0, dtype=torch.uint32, device=dev))
    chunks = lane_chunks(text, starts, lens, m)
    if text.is_cuda:
        return _lanes_launch(text, starts, lens, m, init, first, and_flag,
                             invert, chunks)
    return bitap_lanes_reference(text, starts, lens, m, init, first,
                                 and_flag, invert)


def _lane_chunk_counts(lens, m: LanesMachine):
    """Each lane's chunks of the maps kernel (maps_plan's chunk bytes): 0
    for a lane of at most LANES_LONG record bytes."""
    import torch
    chunk = maps_plan(m.nodes)["chunk"]
    return torch.where(lens > LANES_LONG,
                       torch.div(lens, chunk, rounding_mode="floor") + 1, 0)


def lane_chunks(text, starts, lens, m: LanesMachine) -> int:
    """The maps kernel's chunks over the lanes (its grid; 0 when no lane
    is longer than LANES_LONG), read back in one read with the check
    that every lane lies inside the text (ValueError if not)."""
    import torch

    from . import kernels
    bad = ((starts < 0) | (lens < 0) | (starts + lens >= text.numel())).any()
    both = torch.stack([bad.to(torch.int64),
                        _lane_chunk_counts(lens, m).sum()])
    bad, chunks = kernels.read(both)
    if bad:
        raise ValueError("a lane [start, start + len] lies outside the "
                         "%d-byte text" % text.numel())
    return int(chunks)


def _lane_levels(s: list, cm, m: LanesMachine) -> list:
    """One column of every level (states list of D+1, ints or int64
    tensors holding u32 values: only >>, & and | touch them)."""
    init1, noerr, D = m.init1, m.noerr, m.D
    if m.costs is None:
        new = [((s[0] >> 1) & cm) | (init1 & s[0])]
        for k in range(1, D + 1):
            new.append(((s[k] >> 1) & cm) | (init1 & s[k]) | s[k - 1]
                       | (((new[k - 1] | s[k - 1]) >> 1) & noerr))
        return new
    ci, cs, cd = m.costs
    new = []
    for k in range(D + 1):
        r = ((s[k] >> 1) & cm) | (init1 & s[k])
        if k - ci >= 0:
            r = r | s[k - ci]
        err = 0
        if k - cd >= 0:
            err = err | new[k - cd]
        if k - cs >= 0:
            err = err | s[k - cs]
        new.append(r | ((err >> 1) & noerr))
    return new


def _lane_bucket(n: int) -> int:
    for b in _LANE_BUCKETS:
        if n <= b:
            return b
    return n


def bitap_lanes_reference(text, starts, lens, m: LanesMachine, init,
                          first=None, and_flag: bool = False,
                          invert: bool = False,
                          scalar_lanes: int = _SCALAR_LANES) -> tuple:
    """Plain PyTorch version of the kernel, on any device: the lanes
    bucketed by length, each bucket stepped as tensors over its lanes
    with one Python step a column, and a bucket of fewer than
    scalar_lanes lanes walked a lane at a time on Python ints.  States
    are int64 holding u32 values (CPU torch has no >> on uint32)."""
    import torch
    dev = text.device
    R = starts.numel()
    first = init if first is None else first
    hits = torch.zeros(R, dtype=torch.int64, device=dev)
    tab = m.table.to(torch.int64)
    tab_list = None
    init_v = [int(v) & U32 for v in init]
    first_v = [int(v) & U32 for v in first]
    lens_h = lens.cpu().numpy()
    starts_h = starts.cpu().numpy()
    order = np.argsort(lens_h, kind="stable")
    sorted_lens = lens_h[order]
    i = 0
    while i < R:
        L = _lane_bucket(int(sorted_lens[i]) + 1)
        j = int(np.searchsorted(sorted_lens, L - 1, side="right"))
        if j - i < scalar_lanes:
            if tab_list is None:
                tab_list = tab.tolist()
            for r in order[i:j].tolist():
                st, n = int(starts_h[r]), int(lens_h[r])
                s = list(first_v if st == 0 else init_v)
                acc = 0
                for b in text[st:st + n + 1].tolist():
                    s = _lane_levels(s, tab_list[b], m)
                    acc |= s[m.D]
                hits[r] = acc
            i = j
            continue
        rows = max(1, _LANE_CELLS // L)
        for s0 in range(i, j, rows):
            idx_h = order[s0:min(s0 + rows, j)]
            idx = torch.from_numpy(idx_h).to(dev)
            st, ln = starts[idx], lens[idx]
            n_col = int(lens_h[idx_h].max()) + 1
            # columns past a lane's delimiter read the delimiter again:
            # every read stays inside the lane, and the hits ignore them
            pos = torch.minimum(
                st[:, None] + torch.arange(n_col, device=dev)[None, :],
                (st + ln)[:, None])
            cms = tab[text[pos].long()]                   # [rows, n_col]
            at0 = st == 0
            s = [torch.where(at0, f, v) for f, v in zip(
                torch.tensor(first_v, dtype=torch.int64, device=dev),
                torch.tensor(init_v, dtype=torch.int64, device=dev))]
            acc = torch.zeros(len(idx_h), dtype=torch.int64, device=dev)
            for col in range(n_col):
                s = _lane_levels(s, cms[:, col], m)
                acc = torch.where(ln >= col, acc | s[m.D], acc)
            hits[idx] = acc
        i = j
    hits &= m.endpos
    if and_flag:
        fire = (hits == m.endpos) | bool(invert)
    else:
        fire = (hits != 0) ^ bool(invert)
    return fire, hits.to(torch.uint32)


class LaneMap(NamedTuple):
    """The Boolean map of a stretch of lane bytes (or a batch of them,
    over leading dimensions): cols[i, j] is set where node j (of
    lane_nodes) is set after the stretch from node i's one-bit state;
    hits[i] is that walk's OR of (state_D & endpos)."""
    cols: "object"          # torch bool [..., n, n]
    hits: "object"          # torch int64 [..., n], holding u32


def lane_nodes(m: LanesMachine) -> list:
    """The relevant nodes (level, bit), level by level from 0 and bit by
    bit from 0: node j is bit j of a projected vector."""
    return [(k, b) for k in range(m.D + 1) for b in range(32)
            if (m.relevant[k] >> b) & 1]


def project_state(states, m: LanesMachine):
    """The D+1 states projected onto the relevant nodes: torch bool[n]."""
    import torch
    return torch.tensor([(int(states[k]) >> b) & 1 for k, b in lane_nodes(m)],
                        dtype=torch.bool)


def segment_maps(text, starts, cnts, m: LanesMachine) -> LaneMap:
    """The maps of the stretches text[starts[q] .. starts[q] + cnts[q])
    (int64 tensors; a stretch of 0 bytes is the identity), batched over
    q: every node's one-bit state stepped as int64 tensors holding u32,
    one Python step a column."""
    import torch
    dev = text.device
    nodes = lane_nodes(m)
    Q = starts.numel()
    lv = torch.tensor([k for k, _b in nodes], device=dev)
    one = torch.tensor([1 << b for _k, b in nodes], dtype=torch.int64,
                       device=dev)
    s = [torch.where(lv == k, one, 0).repeat(Q, 1) for k in range(m.D + 1)]
    acc = torch.zeros_like(s[0])
    tab = m.table.to(torch.int64)
    last = text.numel() - 1
    for t in range(int(cnts.max()) if Q else 0):
        active = (cnts > t)[:, None]
        cm = tab[text[(starts + t).clamp(max=last)].long()][:, None]
        s = [torch.where(active, x, y)
             for x, y in zip(_lane_levels(s, cm, m), s)]
        acc = torch.where(active, acc | s[m.D], acc)
    cols = torch.stack([(s[k] >> b) & 1 for k, b in nodes], -1).bool()
    return LaneMap(cols, acc & m.endpos)


def _hit_bits(hits):
    import torch
    return ((hits[..., None] >> torch.arange(32, device=hits.device)) & 1
            ).float()


def _pack_bits(bits):
    import torch
    return (bits.long() << torch.arange(32, device=bits.device)).sum(-1)


def compose_maps(a: LaneMap, b: LaneMap) -> LaneMap:
    """The map of a's stretch followed by b's (batched alike): column i
    is the OR of b's columns j over the set j of a's column i, a Boolean
    product; the hits a.hits[i] | OR_j b.hits[j]."""
    af = a.cols.float()
    return LaneMap((af @ b.cols.float()) > 0,
                   a.hits | _pack_bits((af @ _hit_bits(b.hits)) > 0))


def apply_map(mp: LaneMap, v) -> tuple:
    """(the vector after the map's stretch from the projected vector v,
    bool[n]; the stretch's hits from v)."""
    vf = v.to(mp.cols.device).float()
    return ((vf @ mp.cols.float()) > 0,
            int(_pack_bits((vf @ _hit_bits(mp.hits)) > 0)))


def _tree(maps: LaneMap) -> LaneMap:
    """The maps [S, n, n] composed in order, pairwise as a tree."""
    import torch
    cols, hits = maps
    while cols.shape[0] > 1:
        if cols.shape[0] & 1:
            cols = torch.cat([cols, torch.eye(cols.shape[1], dtype=torch.bool,
                                              device=cols.device)[None]])
            hits = torch.cat([hits, torch.zeros_like(hits[:1])])
        cols, hits = compose_maps(LaneMap(cols[0::2], hits[0::2]),
                                  LaneMap(cols[1::2], hits[1::2]))
    return LaneMap(cols[0], hits[0])


def lane_maps_reference(text, starts, lens, m: LanesMachine, init,
                        first=None, and_flag: bool = False,
                        invert: bool = False, seg: int | None = None,
                        groups: int | None = None,
                        cuts: list | None = None) -> tuple:
    """Plain PyTorch version of the segment maps route, on any device:
    each lane (its lens[r] + 1 bytes) cut into segments of seg bytes
    (maps_plan's where None), or at the offsets cuts[r] inside it; each
    segment's map (segment_maps); `groups` consecutive maps (maps_plan's
    where None) composed into a chunk's map, a tree of Boolean products;
    the lane's projected entry vector (init, the lane at 0 from first)
    carried across its chunks' maps in order, its hits the OR of theirs.
    Returns (verdicts bool[R], hits u32[R]) as bitap_lanes_reference."""
    import torch
    plan = maps_plan(m.nodes)
    seg = plan["seg"] if seg is None else int(seg)
    groups = plan["groups"] if groups is None else int(groups)
    first = init if first is None else first
    dev = text.device
    R = starts.numel()
    hits = torch.zeros(R, dtype=torch.int64)
    for r in range(R):
        st, cnt = int(starts[r]), int(lens[r]) + 1
        at = (sorted({int(c) for c in cuts[r] if 0 < int(c) < cnt})
              if cuts is not None else list(range(seg, cnt, seg)))
        bounds = [0] + at + [cnt]
        seg_starts = torch.tensor(bounds[:-1], dtype=torch.int64,
                                  device=dev) + st
        seg_cnts = torch.tensor(np.diff(bounds), dtype=torch.int64,
                                device=dev)
        maps = segment_maps(text, seg_starts, seg_cnts, m)
        v = project_state(first if st == 0 else init, m)
        h = 0
        for c in range(0, len(bounds) - 1, groups):
            step, hc = apply_map(_tree(LaneMap(maps.cols[c:c + groups],
                                               maps.hits[c:c + groups])), v)
            v, h = step, h | hc
        hits[r] = h
    if and_flag:
        fire = (hits == m.endpos) | bool(invert)
    else:
        fire = (hits != 0) ^ bool(invert)
    return fire.to(dev), hits.to(torch.uint32).to(dev)


def _lanes_bind():
    import ctypes

    from . import _cuda
    lib = _cuda.load("bitap_lanes")
    if not getattr(lib, "_bound", False):
        p, i, u, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                       ctypes.c_longlong)
        up, ip = ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int)
        common = [p, ll, p, p, ll, p, u, u, u, i, i, i, i, up, up, i, i, p, p,
                  ll]
        lib.bitap_lanes_launch.restype = i
        lib.bitap_lanes_launch.argtypes = common + [i, i, p]
        lib.bitap_lane_maps_launch.restype = i
        lib.bitap_lane_maps_launch.argtypes = common + [
            up, i, i, i, p, p, p, i, i, i, p]
        lib.bitap_lanes_geometry.restype = i
        lib.bitap_lanes_geometry.argtypes = [i, i, i, i, i, ip, ip, ip]
        lib.bitap_lanes_error_string.restype = ctypes.c_char_p
        lib.bitap_lanes_error_string.argtypes = [i]
        lib._bound = True
    return lib


@functools.lru_cache(maxsize=None)
def _lanes_occupancy(index: int, D: int, cost: bool, maps: bool,
                     threads: int, smem: int) -> tuple:
    """(blocks an SM, registers a thread, local bytes) of a kernel: the
    one-thread walk, or with maps the segment maps kernel."""
    from . import _cuda
    return _cuda.query(_lanes_bind(), "bitap_lanes", "bitap_lanes_geometry",
                       index, 3, D, int(cost), int(maps), threads, smem)


def lanes_geometry(R: int, m: LanesMachine, device, chunks: int = 0) -> dict:
    """What _lanes_launch runs for R lanes on a CUDA device: the
    one-thread walk's LANES_THREADS a block, the blocks an SM holds (the
    occupancy calculator's), its grid (a persistent one, no larger than
    the lanes need), registers and local bytes; the split, `long`
    (LANES_LONG); and the segment maps kernel's shape (maps_plan: `n`
    columns, `seg` bytes a segment, `groups` a block) with its
    `maps_`-prefixed threads, blocks an SM, registers, local bytes and
    grid (one block a chunk: `chunks`, lane_chunks' count)."""
    from . import _cuda
    from .kernels import _sm_count
    index = _cuda.device_index(device)
    cost = m.costs is not None
    bps, regs, local = _lanes_occupancy(index, m.D, cost, False,
                                        LANES_THREADS, 0)
    grid = max(1, min(_sm_count(index) * max(bps, 1),
                      -(-R // LANES_THREADS)))
    plan = maps_plan(m.nodes)
    mbps, mregs, mlocal = _lanes_occupancy(index, m.D, cost, True,
                                           plan["threads"], plan["smem"])
    return {"threads": LANES_THREADS, "blocks_per_sm": bps, "grid": grid,
            "regs": regs, "local_bytes": local, "long": LANES_LONG,
            "n": m.nodes, "seg": plan["seg"], "groups": plan["groups"],
            "maps_threads": plan["threads"], "maps_smem": plan["smem"],
            "maps_blocks_per_sm": mbps, "maps_regs": mregs,
            "maps_local_bytes": mlocal, "maps_grid": chunks}


def _lanes_launch(text, starts, lens, m: LanesMachine, init, first,
                  and_flag: bool, invert: bool, chunks: int) -> tuple:
    """The kernels on text's device: with chunks (lane_chunks' count of
    these lanes) the lanes of at most LANES_LONG record bytes through the
    one-thread walk at lanes_geometry's grid and the longer ones through
    the segment maps, one block a chunk; with chunks 0 every lane
    through the one-thread walk.  The lane at 0 from first (init where
    None)."""
    import ctypes

    import torch

    from . import _cuda
    from ..runtime import trace
    lib = _lanes_bind()
    R = starts.numel()
    dev = text.device
    first = init if first is None else first
    geo = lanes_geometry(R, m, dev, chunks)
    verdicts = torch.empty(R, dtype=torch.uint8, device=dev)
    hits = torch.empty(R, dtype=torch.uint32, device=dev)
    states = [(ctypes.c_uint32 * (LANES_MAX_D + 1))(
        *[int(v) & U32 for v in vs]) for vs in (init, first)]
    ci, cs, cd = (0, 0, 0) if m.costs is None else m.costs
    long_len = LANES_LONG if chunks else (1 << 62)
    common = (text.data_ptr(), text.numel(), starts.data_ptr(),
              lens.data_ptr(), R, m.table.data_ptr(), m.init1, m.noerr,
              m.endpos, m.D, ci, cs, cd, *states, int(and_flag),
              int(invert), verdicts.data_ptr(), hits.data_ptr(), long_len)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the runtime launches on its current device: make it the tensor's
    with torch.cuda.device(_cuda.device_index(dev)):
        with trace.span("launch"):
            _cuda.check(lib, "bitap_lanes", lib.bitap_lanes_launch(
                *common, geo["threads"], geo["grid"], stream),
                "kernel launch")
        if chunks:
            cum = torch.cumsum(_lane_chunk_counts(lens, m), 0)
            done = torch.zeros(chunks, dtype=torch.int32, device=dev)
            maps = torch.empty(chunks * maps_plan(m.nodes)["size"],
                               dtype=torch.uint32, device=dev)
            rel = (ctypes.c_uint32 * (LANES_MAX_D + 1))(*m.relevant)
            with trace.span("launch"):
                _cuda.check(lib, "bitap_lanes", lib.bitap_lane_maps_launch(
                    *common, rel, m.nodes, geo["seg"], geo["groups"],
                    cum.data_ptr(), done.data_ptr(), maps.data_ptr(),
                    geo["maps_threads"], chunks, geo["maps_smem"], stream),
                    "maps kernel launch")
            launches["bitap_lane_maps"] += 1
    launches["bitap_lanes"] += 1
    return verdicts.view(torch.bool), hits


def scan_lane_rows(text: np.ndarray, delim: int, mask_table: np.ndarray,
                   consts: dict, D: int, costs: tuple | None, init,
                   first=None, and_flag: bool = False,
                   invert: bool = False) -> np.ndarray:
    """The records of a stream (each ended by the byte delim) that fire
    in a sticky machine, cut and stepped on the scan device: int64 [R,
    3] rows in stream order, each (ordinal of the record, its
    delimiter's position, the previous delimiter's or -1), as
    scan_record_list gives them.  renfa_kernel.line_index cuts the
    records at delim, bitap_lanes steps them (lanes_machine(mask_table,
    consts, D, costs), from the states init, the record at 0 from
    first) and renfa_kernel.line_rows sends back the rows of those that
    fire; bytes after the last delimiter end no record.  Torch backend
    only: the numpy backend steps its lanes with scan_lanes."""
    if _BACKEND != "torch":
        raise ValueError("the record lanes run on the torch backend, not "
                         "on %r" % (_BACKEND,))
    import torch

    from . import kernels, renfa_kernel
    from ..runtime import trace
    require_device()
    dev = torch.device(_DEVICE)
    with trace.span("device_layer"):
        t = kernels.to_device(text, dev)
        idx = renfa_kernel.line_index(t, delim)
        K = idx.nl.numel()
        if K == 0:
            return np.zeros((0, 3), dtype=np.int64)
        m = lanes_machine(mask_table, consts, D, costs, dev)
        v, _hits = bitap_lanes(t, idx.starts, idx.lens, m, init, first,
                               and_flag, invert)
        rows, _n = renfa_kernel.line_rows(v, idx.ords, idx.nl, False, 0, K)
        rows = kernels.to_host(rows)
    if trace.ENABLED:
        trace.add("lane_records", K)
        trace.add("lane_rows", len(rows))
    # (ordinal, start, delimiter) -> (ordinal, delimiter, previous
    # delimiter): a record starts one past the delimiter before it, the
    # first at 0
    return np.stack([rows[:, 0], rows[:, 2], rows[:, 1] - 1], 1)


def scan_lanes(lanes: np.ndarray, lens: np.ndarray, mask_table: np.ndarray,
               consts: dict, D: int, costs: tuple | None,
               init_states: np.ndarray, sticky_endpos: bool):
    """Record-parallel bitap scan for machines whose sticky bits make
    the dependence window unbounded (-p supersequence: Init1 == ~0;
    FASTREGEX '#' wildcards: wildmask stickies -- bitap.c:123,
    agrep.h WILDCD).  Each lane is one record (content + trailing
    delimiter bytes), starting from the post-reset state.

    Returns hits u32[R]: OR of (state_D & endpos) over the lane's
    columns 0..lens[r] (the reference's sticky accumulation, evaluated
    at the record end)."""
    R, L = lanes.shape
    init1 = np.uint32(consts["init1"] if sticky_endpos
                      else consts["init1_ns"])
    noerr = np.uint32(consts["noerr"])
    endpos = np.uint32(consts["endpos"])
    cmasks = mask_table[lanes].astype(np.uint32)
    states = np.broadcast_to(init_states[:, None], (D + 1, R)) \
        .astype(np.uint32).copy()
    hits = np.zeros(R, dtype=np.uint32)
    for j in range(L):
        cm = cmasks[:, j]
        new0 = ((states[0] >> 1) & cm) | (init1 & states[0])
        new = [new0]
        if costs is None:
            for k in range(1, D + 1):
                r2 = states[k - 1] | (((new[k - 1] | states[k - 1]) >> 1)
                                     & noerr)
                new.append(((states[k] >> 1) & cm)
                           | (init1 & states[k]) | r2)
        else:
            ci, cs, cd = costs
            new = []
            for k in range(0, D + 1):
                r = ((states[k] >> 1) & cm) | (init1 & states[k])
                if k - ci >= 0:
                    r = r | states[k - ci]
                err = np.uint32(0)
                if k - cd >= 0:
                    err = err | new[k - cd]
                if k - cs >= 0:
                    err = err | states[k - cs]
                r = r | ((err >> 1) & noerr)
                new.append(r)
        active = j <= lens
        hits = np.where(active, hits | (new[D] & endpos), hits)
        states = np.stack(new)
    return hits


# ---------------------------------------------------------------------
# numpy backend
# ---------------------------------------------------------------------

def _scan_windows_np(windows, mask_table, cvec, D, W, variant, costs):
    T, S = windows.shape
    init0, init1_ns, noerr, d_endpos, endpos, d_mask = (
        np.uint32(cvec[i]) for i in range(6))
    cmasks = mask_table[windows]                       # u32[T, S]
    events = np.zeros((T, S), dtype=np.uint32)

    if variant == "bitap":
        states = np.broadcast_to(init0, (D + 1, T)).astype(np.uint32).copy()
        init_states = states.copy()
    else:
        levels = [np.uint32(0)]
        for _ in range(D):
            prev = int(levels[-1])
            levels.append(np.uint32(((prev >> 1) | prev | 0x80000000)
                                    & 0xFFFFFFFF))
        init_states = np.broadcast_to(
            np.asarray(levels, dtype=np.uint32)[:, None], (D + 1, T)).copy()
        states = init_states.copy()

    def bitap_levels(sts, cm):
        new0 = ((sts[0] >> 1) & cm) | (init1_ns & sts[0])
        new = [new0]
        if costs is None:
            for k in range(1, D + 1):
                r2 = sts[k - 1] | (((new[k - 1] | sts[k - 1]) >> 1) & noerr)
                new.append(((sts[k] >> 1) & cm) | (init1_ns & sts[k]) | r2)
        else:
            ci, cs, cd = costs
            new = []
            for k in range(0, D + 1):
                r = ((sts[k] >> 1) & cm) | (init1_ns & sts[k])
                if k - ci >= 0:
                    r = r | sts[k - ci]
                err = np.uint32(0)
                if k - cd >= 0:
                    err = err | new[k - cd]
                if k - cs >= 0:
                    err = err | sts[k - cs]
                r = r | ((err >> 1) & noerr)
                new.append(r)
        return new

    top = np.uint32(0x80000000)
    for j in range(S):
        cm = cmasks[:, j]
        if j == W:
            states[:, 0] = init_states[:, 0]   # stream start: tile 0 only
        if variant == "bitap":
            new = bitap_levels(states, cm)
            ev = (new[0] & d_endpos) | (new[D] & endpos)
            trig = (new[0] & d_endpos) != 0
            if trig.any():
                b0 = np.broadcast_to(init0, cm.shape).astype(np.uint32)
                rs = bitap_levels(np.stack([b0] * (D + 1)), cm)
                rs[0] = rs[0] & d_mask
                for k in range(D + 1):
                    new[k] = np.where(trig, rs[k], new[k])
            states = np.stack(new)
        else:
            # the \n state reset exists only in the D>0 engine
            # (sgrep.c agrep():1179-1181); bm/monkey (D==0) are plain
            # comparisons and match straight across newlines -- needed
            # when the pattern itself contains \n (-x wrap, ^/$).
            if D > 0:
                nl = windows[:, j] == 0x0A
                if nl.any():
                    states = np.where(nl[None, :], init_states, states)
            new0 = ((states[0] >> 1) | top) & cm
            new = [new0]
            for k in range(1, D + 1):
                new.append((((states[k] >> 1) | top) & cm)
                           | states[k - 1]
                           | (((new[k - 1] | states[k - 1]) >> 1) | top))
            ev = np.where((new[D] & endpos) != 0, np.uint32(1),
                          np.uint32(0))
            states = np.stack(new)
        events[:, j] = ev
    return events
