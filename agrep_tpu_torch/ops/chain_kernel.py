"""The chain kernel: exact multi-term match starts for the -f engine.

chain_scan() marks, at every byte position i of a flat u8 text tensor,
whether some term of a compiled term set starts there:

    start[i] = OR_term AND_t (tr[text[i+t]] == tr[term[t]]),

bytes past the end of the text read as 0, packed 32 positions to a word
(bit r of word w is position 32*w + r).  On a CUDA tensor it launches the
hand-written Hopper kernel csrc/chain_scan.cu (built and loaded by
ops/_cuda.py) or raises; on a CPU tensor it runs chain_scan_reference(),
the plain PyTorch version of the same function.  chain_match_starts()
turns the plane into positions.

The match is exact: the engine (runtime/mgrep.py) only attributes term
ids at true hits (compile/multi.py qgram_occurrences consumes the starts
as cand_anchor_rel).  compile_chain() keeps the TPU engine's static caps:
a term set past them compiles to None, and the engine then takes the
q-gram filter (ops/qgram_kernel.py).  Planes are int32 tensors holding
u32 words.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import _cuda
from .kernels import _sm_count

# compile caps of the -f engine's chain program; past them the q-gram
# filter takes the term set
MAX_POSITIONS = 2400      # total pattern chars across all terms
MAX_EQ_SETS = 96          # distinct folded character classes
MAX_CUBES = 8             # OR-of-AND cover terms per class
MAX_TERM_LEN = 128
NO_CLASS = 255            # class id of a byte that no term holds

# Start positions a tile of the kernel's launch;
# tools/torch_chain_scan_time.py times every tile and blocks an SM at the
# main path's shapes.
TILE = 8192

# Launches of each kernel since the counts were last set to 0.
launches = {"chain_scan": 0}


def _cube_cover(byte_set: frozenset) -> tuple | None:
    """Cover a byte set by (mask, value) cubes: the cube contains all
    bytes b with (b & mask) == value.  Greedy largest-cube-first;
    returns None when the cover needs more than MAX_CUBES cubes."""
    remaining = set(byte_set)
    cubes = []
    while remaining:
        seed = min(remaining)
        mask = 0xFF
        # try to free each bit (largest win first is moot at 8 bits)
        for b in range(8):
            trial = mask & ~(1 << b)
            # cube (trial, seed & trial) must lie inside the SET (not
            # just inside `remaining`: overlap with prior cubes is fine)
            width = 1 << (8 - bin(trial).count("1"))
            val = seed & trial
            members = [v for v in range(256)
                       if (v & trial) == val]
            if len(members) == width and all(m in byte_set
                                             for m in members):
                mask = trial
        val = seed & mask
        cubes.append((mask, val))
        for v in range(256):
            if (v & mask) == val:
                remaining.discard(v)
        if len(cubes) > MAX_CUBES:
            return None
    return tuple(cubes)


def compile_chain(terms: list, tr: np.ndarray):
    """Static chain program for a term set under fold table tr.

    Returns (eq_specs, term_specs, term_ids, maxlen) or None when the
    set exceeds the caps.  eq_specs[e] is the cube cover of folded
    class e; term_specs[i] is the tuple of class indices of term_ids[i]'s
    byte positions."""
    tr = np.asarray(tr, dtype=np.uint8)
    # preimage classes of the fold map, computed once
    inv: dict = {}
    for b in range(256):
        inv.setdefault(int(tr[b]), []).append(b)
    eq_index: dict = {}
    eq_specs: list = []
    term_specs: list = []
    term_ids: list = []
    total = 0
    maxlen = 0
    for tid, t in enumerate(terms):
        if not t:
            continue
        if len(t) > MAX_TERM_LEN:
            return None
        spec = []
        for ch in t:
            f = int(tr[ch])
            if f not in eq_index:
                cubes = _cube_cover(frozenset(inv[f]))
                if cubes is None:
                    return None
                eq_index[f] = len(eq_specs)
                eq_specs.append(cubes)
            spec.append(eq_index[f])
        total += len(spec)
        maxlen = max(maxlen, len(spec))
        term_specs.append(tuple(spec))
        term_ids.append(tid)
    if (not term_specs or total > MAX_POSITIONS
            or len(eq_specs) > MAX_EQ_SETS):
        return None
    return tuple(eq_specs), tuple(term_specs), tuple(term_ids), maxlen


@dataclass(frozen=True)
class ChainProgram:
    """A compiled chain program as the kernel takes it, on one device.

    The terms are sorted by their first two classes, the one-byte terms
    after all longer ones.  A position whose class has a one-byte term
    starts a match whatever follows; any other position tests only the
    terms of its pair (its class, the next byte's class), NO_CLASS
    counting as class n_cls."""
    class_of: torch.Tensor    # u8[256]: byte -> class id (NO_CLASS: none)
    term_cls: torch.Tensor    # u8[n_pos]: distinct terms' class ids,
                              # concatenated in the order above
    term_off: torch.Tensor    # i16[n_terms + 1]: term t's range in term_cls
    pair: torch.Tensor        # i16[(n_cls + 1)**2 + 1]: the terms whose
                              # first two classes are (a, b) are pair[q]
                              # .. pair[q + 1] - 1, q = a * (n_cls + 1) + b
    single: torch.Tensor      # u8[n_cls]: 1 where a one-byte term has
                              # that class
    n_cls: int
    n_terms: int
    n_pos: int
    maxlen: int


def device_program(prog, device="cpu") -> ChainProgram:
    """Kernel inputs from compile_chain's program: each cube cover gives
    its class's bytes, duplicate terms collapse (the match is an OR)."""
    eq_specs, term_specs, _tids, maxlen = prog
    n_cls = len(eq_specs)
    if n_cls > MAX_EQ_SETS:
        raise ValueError("%d classes, the kernel takes %d"
                         % (n_cls, MAX_EQ_SETS))
    class_of = np.full(256, NO_CLASS, dtype=np.uint8)
    for e, cubes in enumerate(eq_specs):
        for mask, val in cubes:
            for b in range(256):
                if b & mask == val:
                    class_of[b] = e
    specs = sorted(set(term_specs), key=lambda s: (len(s) == 1, s))
    if sum(len(s) for s in specs) > MAX_POSITIONS or maxlen > MAX_TERM_LEN:
        raise ValueError("term set past the chain kernel's caps")
    term_cls = np.asarray([c for s in specs for c in s], dtype=np.uint8)
    term_off = np.concatenate(
        [[0], np.cumsum([len(s) for s in specs])]).astype(np.int16)
    stride = n_cls + 1
    keys = np.asarray([s[0] * stride + s[1] for s in specs if len(s) > 1],
                      dtype=np.int64)
    pair = np.searchsorted(keys, np.arange(stride * stride + 1),
                           side="left").astype(np.int16)
    single = np.zeros(n_cls, dtype=np.uint8)
    single[[s[0] for s in specs if len(s) == 1]] = 1

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return ChainProgram(class_of=dev(class_of), term_cls=dev(term_cls),
                        term_off=dev(term_off), pair=dev(pair),
                        single=dev(single), n_cls=n_cls,
                        n_terms=len(specs), n_pos=len(term_cls),
                        maxlen=int(maxlen))


def chain_scan(text: torch.Tensor, p: ChainProgram) -> torch.Tensor:
    """Start plane int32[ceil(N/32)] of the program over text (module
    docstring).  A CUDA tensor goes to the kernel, a CPU tensor to
    chain_scan_reference.  The text may start at any byte address."""
    if text.dtype != torch.uint8 or text.dim() != 1:
        raise TypeError("text must be a 1-D uint8 tensor, got %s %r"
                        % (text.dtype, tuple(text.shape)))
    if not text.is_contiguous():
        raise ValueError("text must be contiguous")
    if text.numel() == 0:
        raise ValueError("empty text")
    if text.device != p.class_of.device:
        raise ValueError("text on %s but the program on %s"
                         % (text.device, p.class_of.device))
    if text.is_cuda:
        return _launch(text, p)
    if text.device.type == "cpu":
        return chain_scan_reference(text, p)
    raise ValueError("no chain kernel for device %s" % text.device)


def _bind():
    lib = _cuda.load("chain_scan")
    if not getattr(lib, "_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ip = ctypes.POINTER(ctypes.c_int)
        lib.chain_scan_launch.restype = i
        lib.chain_scan_launch.argtypes = [p, ll, p, p, i, p, i, p, i, p, i,
                                          p, i, i, p]
        lib.chain_scan_geometry.restype = i
        lib.chain_scan_geometry.argtypes = [i, i, i, i, ip, ip, ip]
        lib.chain_scan_error_string.restype = ctypes.c_char_p
        lib.chain_scan_error_string.argtypes = [i]
        lib._bound = True
    return lib


def launch_geometry(N: int, p: ChainProgram, device,
                    tile: int | None = None,
                    blocks_per_sm: int | None = None) -> dict:
    """What _launch runs for a scan of N bytes on a CUDA device: start
    positions a tile, threads a block, blocks an SM (by default all
    that the SM holds, from the CUDA occupancy calculator), the grid
    (never more blocks than tiles) and dynamic shared bytes a block."""
    lib = _bind()
    tile = TILE if tile is None else tile
    threads, smem, fits = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _cuda.check(lib, "chain_scan", lib.chain_scan_geometry(
        p.n_cls, p.n_pos, p.n_terms, tile, ctypes.byref(threads),
        ctypes.byref(smem), ctypes.byref(fits)), "geometry")
    if blocks_per_sm is None:
        blocks_per_sm = fits.value
    n_tiles = -(-N // tile)
    dev = torch.device(device)
    return {"tile": tile, "threads": threads.value, "smem_bytes": smem.value,
            "blocks_per_sm": blocks_per_sm, "fits_per_sm": fits.value,
            "tiles": n_tiles,
            "grid": min(n_tiles, blocks_per_sm * _sm_count(dev.index or 0))}


def _launch(text: torch.Tensor, p: ChainProgram, tile: int | None = None,
            blocks_per_sm: int | None = None) -> torch.Tensor:
    """The kernel on text's device; tile and blocks_per_sm default to
    launch_geometry's choice."""
    lib = _bind()
    N = text.numel()
    geo = launch_geometry(N, p, text.device, tile, blocks_per_sm)
    out = torch.empty(-(-N // 32), dtype=torch.int32, device=text.device)
    stream = torch.cuda.current_stream(text.device).cuda_stream
    _cuda.check(lib, "chain_scan", lib.chain_scan_launch(
        text.data_ptr(), N, p.class_of.data_ptr(), p.single.data_ptr(),
        p.n_cls, p.term_cls.data_ptr(), p.n_pos, p.term_off.data_ptr(),
        p.n_terms, p.pair.data_ptr(), p.maxlen, out.data_ptr(), geo["tile"],
        geo["grid"], stream), "kernel launch")
    launches["chain_scan"] += 1
    return out


def pack_bits(hit: torch.Tensor) -> torch.Tensor:
    """bool[N] -> int32[ceil(N/32)] holding u32 words, bit r of word w
    from hit[32*w + r]."""
    n_words = -(-hit.numel() // 32)
    bits = torch.zeros(n_words * 32, dtype=torch.int64, device=hit.device)
    bits[:hit.numel()] = hit
    shifts = torch.arange(32, dtype=torch.int64, device=hit.device)
    words = (bits.view(n_words, 32) << shifts).sum(dim=1)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def plane_positions(plane: torch.Tensor, N: int) -> np.ndarray:
    """Set-bit positions (< N) of an int32 plane, ascending, as int64 on
    the host; only nonzero words are expanded."""
    nz = torch.nonzero(plane).flatten()
    words = plane[nz].to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, dtype=torch.int64, device=plane.device)
    bits = ((words[:, None] >> shifts) & 1) != 0
    pos = (nz[:, None] * 32 + shifts)[bits]
    pos = pos.cpu().numpy().astype(np.int64)
    return pos[pos < N]


def chain_scan_reference(text: torch.Tensor, p: ChainProgram
                         ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the text's
    class ids (padded with byte 0's class), then per term one
    vectorized compare and AND per position, ORed over the terms."""
    dev = text.device
    N = text.numel()
    cls = torch.full((N + p.maxlen,), int(p.class_of[0]),
                     dtype=torch.uint8, device=dev)
    cls[:N] = p.class_of[text.long()]
    hit = torch.zeros(N, dtype=torch.bool, device=dev)
    term_cls = p.term_cls.cpu().tolist()
    off = p.term_off.cpu().tolist()
    for t in range(p.n_terms):
        m = torch.ones(N, dtype=torch.bool, device=dev)
        for k, c in enumerate(term_cls[off[t]:off[t + 1]]):
            m &= cls[k:k + N] == c
        hit |= m
    return pack_bits(hit)


def chain_match_starts(text: torch.Tensor, prog) -> np.ndarray:
    """Exact match-start positions (any term) in text coordinates, int64
    on the host.  text: a u8 tensor (CUDA: the kernel; CPU: the plain
    version); prog: compile_chain's program, or its ChainProgram on
    text's device."""
    if not isinstance(prog, ChainProgram):
        prog = device_program(prog, text.device)
    return plane_positions(chain_scan(text, prog), text.numel())
