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
as cand_anchor_rel), or counts the lines that hold a start where the
plane is (lines_with_starts).  compile_chain() gives None past the CUDA
program's caps (fits(): its i16 offsets, 7-bit class ids and the shared
memory a block may take), and the engine then takes the q-gram filter
(ops/qgram_kernel.py) or the mask machine.  Planes are int32 tensors
holding u32 words.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import _cuda
from .kernels import _sm_count

NO_CLASS = 255            # class id of a byte that no term holds

# Start positions a tile of the kernel's launch;
# tools/torch_chain_scan_time.py times every tile and blocks an SM at the
# main path's shapes.
TILE = 8192

# The caps of a chain program, from what csrc/chain_scan.cu can hold; the
# one place they live.  compile_chain gives None past them and the
# launcher refuses a program past them (fits()).
MAX_POSITIONS = (1 << 15) - 1   # term_off and pair are i16
# A class id has 7 bits in shared memory (bit 7 flags a class with a
# one-byte term) and NO_CLASS counts as class n_cls: 127 classes, whose
# 128 ids the candidate bitmap's rows of four words cover.
MAX_CLASSES = 127
# cudaDevAttrMaxSharedMemoryPerBlockOptin of the H100 (227 KB), which
# sizes MAX_TERM_LEN; the launcher checks the device's own.
HOPPER_SMEM_OPTIN = 227 << 10


def smem_bytes(n_cls: int, n_pos: int, n_terms: int, maxlen: int,
               tile: int = TILE) -> int:
    """Dynamic shared bytes a block of the kernel takes (csrc/chain_scan.cu
    layout(): two raw buffers of a tile and its halo, the class buffer,
    the candidate bitmap, the pair table, the term offsets, the byte map,
    the term classes)."""
    def a16(x):
        return (x + 15) & ~15
    halo = max(maxlen, 2) - 1
    raw = tile + a16(halo + 32)
    cw = (tile + halo + 3) // 4 + 1
    row_words = 32 if n_cls < 32 else 4
    return (2 * raw + a16(4 * (cw + cw // 8 + 1))
            + a16(4 * (n_cls + 1) * row_words) + 4 * (n_cls + 1) ** 2
            + a16(2 * (n_terms + 1)) + 4 * 256 + a16(n_pos))


def _term_len_cap(smem: int) -> int:
    """The longest term, a power of two, of a program that fits smem at
    the class and position caps."""
    cap = 1
    while (2 * cap <= MAX_POSITIONS
           and smem_bytes(MAX_CLASSES, MAX_POSITIONS, MAX_POSITIONS,
                          2 * cap) <= smem):
        cap *= 2
    return cap


MAX_TERM_LEN = _term_len_cap(HOPPER_SMEM_OPTIN)    # 8192


def fits(n_cls: int, n_pos: int, n_terms: int, maxlen: int,
         smem: int = HOPPER_SMEM_OPTIN, tile: int = TILE) -> bool:
    """Whether the kernel takes a program of this size on a device whose
    blocks may take smem shared bytes."""
    return (1 <= n_cls <= MAX_CLASSES and 1 <= n_terms <= n_pos
            and n_pos <= MAX_POSITIONS and 1 <= maxlen <= MAX_TERM_LEN
            and smem_bytes(n_cls, n_pos, n_terms, maxlen, tile) <= smem)


# Launches of each kernel since the counts were last set to 0.
launches = {"chain_scan": 0}


def compile_chain(terms: list, tr: np.ndarray):
    """Static chain program for a term set under fold table tr.

    Returns (eq_specs, term_specs, term_ids, maxlen) or None when the
    set is past the caps (fits()).  eq_specs[e] is folded class e, its
    bytes ascending (the preimage under tr of one folded byte);
    term_specs[i] is the tuple of class indices of term_ids[i]'s byte
    positions.  Classes and terms are numbered as agrep_tpu's
    compile_chain numbers them."""
    tr = np.asarray(tr, dtype=np.uint8)
    # preimage classes of the fold map, computed once
    inv: dict = {}
    for b in range(256):
        inv.setdefault(int(tr[b]), []).append(b)
    eq_index: dict = {}
    eq_specs: list = []
    term_specs: list = []
    term_ids: list = []
    maxlen = 0
    for tid, t in enumerate(terms):
        if not t:
            continue
        spec = []
        for ch in t:
            f = int(tr[ch])
            if f not in eq_index:
                eq_index[f] = len(eq_specs)
                eq_specs.append(tuple(inv[f]))
            spec.append(eq_index[f])
        maxlen = max(maxlen, len(spec))
        term_specs.append(tuple(spec))
        term_ids.append(tid)
    # the kernel holds each distinct term once
    distinct = set(term_specs)
    if not term_specs or not fits(len(eq_specs),
                                  sum(len(s) for s in distinct),
                                  len(distinct), maxlen):
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
    """Kernel inputs from compile_chain's program: each class's bytes
    map to its id, duplicate terms collapse (the match is an OR).
    Raises for a program whose class ids or term offsets the u8 and i16
    tables cannot hold; the caps inside those are fits()'s."""
    eq_specs, term_specs, _tids, maxlen = prog
    n_cls = len(eq_specs)
    specs = sorted(set(term_specs), key=lambda s: (len(s) == 1, s))
    n_pos = sum(len(s) for s in specs)
    if n_cls >= NO_CLASS or n_pos > MAX_POSITIONS:
        raise ValueError("%d classes and %d positions: the program's "
                         "tables hold fewer than %d and at most %d"
                         % (n_cls, n_pos, NO_CLASS, MAX_POSITIONS))
    class_of = np.full(256, NO_CLASS, dtype=np.uint8)
    for e, members in enumerate(eq_specs):
        class_of[list(members)] = e
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
                        n_terms=len(specs), n_pos=n_pos,
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
        lib.chain_scan_geometry.argtypes = [i, i, i, i, i, ip, ip, ip]
        lib.chain_scan_smem_optin.restype = i
        lib.chain_scan_smem_optin.argtypes = [ip]
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
    (never more blocks than tiles) and dynamic shared bytes a block.
    Raises ValueError for a program past the caps (fits(), with the
    shared bytes a block of this device may take)."""
    tile = TILE if tile is None else tile
    index = _cuda.device_index(device)
    lib = _bind()
    optin, = _cuda.query(lib, "chain_scan", "chain_scan_smem_optin", index,
                         1)
    if not fits(p.n_cls, p.n_pos, p.n_terms, p.maxlen, optin, tile):
        raise ValueError(
            "chain program of %d classes, %d positions, %d terms, a "
            "%d-byte term is past the kernel's caps (%d classes, %d "
            "positions, %d-byte terms, %d shared bytes a block)"
            % (p.n_cls, p.n_pos, p.n_terms, p.maxlen, MAX_CLASSES,
               MAX_POSITIONS, MAX_TERM_LEN, optin))
    threads, smem, per_sm = _cuda.query(
        lib, "chain_scan", "chain_scan_geometry", index, 3, p.n_cls,
        p.n_pos, p.n_terms, p.maxlen, tile)
    if blocks_per_sm is None:
        blocks_per_sm = per_sm
    n_tiles = -(-N // tile)
    return {"tile": tile, "threads": threads, "smem_bytes": smem,
            "blocks_per_sm": blocks_per_sm, "fits_per_sm": per_sm,
            "tiles": n_tiles,
            "grid": min(n_tiles, blocks_per_sm * _sm_count(index))}


def _launch(text: torch.Tensor, p: ChainProgram, tile: int | None = None,
            blocks_per_sm: int | None = None) -> torch.Tensor:
    """The kernel on text's device; tile and blocks_per_sm default to
    launch_geometry's choice."""
    lib = _bind()
    N = text.numel()
    geo = launch_geometry(N, p, text.device, tile, blocks_per_sm)
    out = torch.empty(-(-N // 32), dtype=torch.int32, device=text.device)
    stream = torch.cuda.current_stream(text.device).cuda_stream
    # the runtime launches on its current device: make it the tensor's
    index = _cuda.device_index(text.device)
    with torch.cuda.device(index):
        _cuda.check(lib, "chain_scan", lib.chain_scan_launch(
            text.data_ptr(), N, p.class_of.data_ptr(), p.single.data_ptr(),
            p.n_cls, p.term_cls.data_ptr(), p.n_pos, p.term_off.data_ptr(),
            p.n_terms, p.pair.data_ptr(), p.maxlen, out.data_ptr(),
            geo["tile"], geo["grid"], stream), "kernel launch")
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
    class ids (padded with byte 0's class), then for the terms of each
    length, a block of them at a time, one vectorized compare of every
    term's k-th class with the classes k bytes on, ANDed over k and
    ORed over the terms."""
    dev = text.device
    N = text.numel()
    cls = torch.full((N + p.maxlen,), int(p.class_of[0]),
                     dtype=torch.uint8, device=dev)
    cls[:N] = p.class_of[text.long()]
    hit = torch.zeros(N, dtype=torch.bool, device=dev)
    term_cls = p.term_cls.cpu().tolist()
    off = p.term_off.cpu().tolist()
    by_len: dict = {}
    for t in range(p.n_terms):
        by_len.setdefault(off[t + 1] - off[t], []).append(
            term_cls[off[t]:off[t + 1]])
    rows = max(1, (1 << 24) // N)       # at most 16 M compares a step
    for length, terms in by_len.items():
        for i in range(0, len(terms), rows):
            block = torch.tensor(terms[i:i + rows], dtype=torch.uint8,
                                 device=dev)
            m = torch.ones((len(block), N), dtype=torch.bool, device=dev)
            for k in range(length):
                m &= cls[None, k:k + N] == block[:, k:k + 1]
            hit |= m.any(dim=0)
    return pack_bits(hit)


def lines_with_starts(text: torch.Tensor, plane: torch.Tensor) -> int:
    """Number of lines of text that hold a set bit of the start plane,
    computed on the plane's device; one integer comes back.  A line ends
    at each newline byte, and a start at position p lies in line
    (newlines at positions <= p), as agrep_tpu counts `-c -f`
    (np.searchsorted(nl, starts, side="right") and np.unique): a start
    counts when the start before it lies in an earlier line."""
    N = text.numel()
    nz = torch.nonzero(plane).flatten()
    shifts = torch.arange(32, dtype=torch.int32, device=plane.device)
    bits = ((plane[nz, None] >> shifts) & 1) != 0
    pos = (nz[:, None] * 32 + shifts)[bits]
    pos = pos[pos < N]
    line = torch.cumsum(text == 0x0A, 0, dtype=torch.int32)[pos]
    new = torch.ones_like(line, dtype=torch.bool)
    new[1:] = line[1:] != line[:-1]
    return int(new.sum())


def chain_match_starts(text: torch.Tensor, prog) -> np.ndarray:
    """Exact match-start positions (any term) in text coordinates, int64
    on the host.  text: a u8 tensor (CUDA: the kernel; CPU: the plain
    version); prog: compile_chain's program, or its ChainProgram on
    text's device."""
    if not isinstance(prog, ChainProgram):
        prog = device_program(prog, text.device)
    return plane_positions(chain_scan(text, prog), text.numel())
