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

line_terms() folds a chunk's candidate starts (chain_scan's start plane,
or qgram_filter's candidate plane past the caps) into each line's
terminal mask and reads each line's verdict from a boolean's truth table
on the scan device (csrc/line_terms.cu): the streamed boolean's count, or
the rows of its lines that fire; line_terms_reference() is its plain
PyTorch version, term_tables() the terms and tables as it takes them.

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
import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import _cuda
from .kernels import _sm_count, read, to_host, upload
from ..runtime import trace

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
launches = {"chain_scan": 0, "line_terms": 0}


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
        return upload(torch.from_numpy(np.ascontiguousarray(a)), device)

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
    with torch.cuda.device(index), trace.span("launch"):
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
    pos = to_host(pos).astype(np.int64)
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
    return read(new.sum())


def chain_match_starts(text: torch.Tensor, prog) -> np.ndarray:
    """Exact match-start positions (any term) in text coordinates, int64
    on the host.  text: a u8 tensor (CUDA: the kernel; CPU: the plain
    version); prog: compile_chain's program, or its ChainProgram on
    text's device."""
    if not isinstance(prog, ChainProgram):
        prog = device_program(prog, text.device)
    return plane_positions(chain_scan(text, prog), text.numel())


# ---------------------------------------------------------------------
# line_terms: the streamed boolean's lines that fire
# ---------------------------------------------------------------------

MAX_TERMS = 16           # a boolean's terminals (compile/boolean.py)


@dataclass
class TermTables:
    """A boolean's terms and truth table on one device, as line_terms
    takes them."""
    t_bytes: torch.Tensor      # uint8: the terms' bytes, folded by tr
    t_off: torch.Tensor        # int32 [terms + 1]; an empty term is dead
    tr: torch.Tensor           # uint8 [256]: the fold
    table: torch.Tensor        # int32: the truth table's u32 words
    min_len: int               # the shortest live term
    max_len: int               # the longest term

    @property
    def device(self) -> torch.device:
        return self.t_off.device

    @property
    def n_terms(self) -> int:
        return self.t_off.numel() - 1

    @property
    def n_bytes(self) -> int:
        """Bytes of the tables on the device."""
        return sum(t.numel() * t.element_size()
                   for t in (self.t_bytes, self.t_off, self.tr, self.table))


def term_tables(terms: list, tr: np.ndarray, table: np.ndarray,
                device="cpu") -> TermTables:
    """The terms (bytes, at most MAX_TERMS, none holding a newline), the
    fold tr and the truth table's u32 words (compile/boolean.py
    truth_table: bit m is the verdict of terminal mask m) on device."""
    tr = np.asarray(tr, dtype=np.uint8)
    NT = len(terms)
    if not 1 <= NT <= MAX_TERMS:
        raise ValueError("%d terms: line_terms takes 1 to %d"
                         % (NT, MAX_TERMS))
    if any(b"\n" in t for t in terms):
        raise ValueError("a term holds a newline")
    table = np.asarray(table, dtype=np.uint32)
    if table.shape != (max(1, (1 << NT) // 32),):
        raise ValueError("a truth table of %d terms has %d words, got %r"
                         % (NT, max(1, (1 << NT) // 32), table.shape))
    live = [len(t) for t in terms if t]
    if not live:
        raise ValueError("no live term")
    t_bytes = np.frombuffer(b"".join(terms) or b"\0", dtype=np.uint8)
    off = np.concatenate([[0], np.cumsum([len(t) for t in terms])])

    def dev(a, dtype):
        return upload(torch.from_numpy(np.array(a, dtype=dtype)), device)
    return TermTables(dev(tr[t_bytes], np.uint8), dev(off, np.int32),
                      dev(tr, np.uint8), dev(table.view(np.int32), np.int32),
                      min(live), max(live))


def line_terms(text: torch.Tensor, plane: torch.Tensor, shift: int,
               tables: TermTables, body: int, carry: int = 0,
               begin: int = 0, cap_e: int | None = None, last: bool = False,
               count_only: bool = False, base: int = 0) -> tuple:
    """The lines of a chunk that fire, from its candidate plane: (rows,
    count, carry_out, last_nl).

    text: the region (the chunk's body bytes [0, body) and its halo);
    plane: int32 [ceil(N / 32)] over it, a set bit at a a candidate start
    a - shift.  Term t is present at a start s when 0 <= s < body, s +
    len_t <= N and its folded bytes equal the term's.  A start belongs
    to the line of the first newline at or after it in the body; line 0
    also holds the mask carried in (carry).  A line fires when its mask's
    truth-table bit is set; the body's tail after its last newline is a
    line ending at cap_e (default base + N) where last, and otherwise its
    mask is carried out (carry_out).  rows: int64 [count, 2] on text's
    device, one (begin, end) stream position pair a line that fires, in
    order (line 0 begins at begin, line j > 0 at base + its previous
    newline + 1, and ends at base + its newline + 1); None where
    count_only.  last_nl: base + the body's last newline, or -1.  A CUDA
    tensor goes to the kernel, a CPU tensor to line_terms_reference."""
    if text.dtype != torch.uint8 or text.dim() != 1:
        raise TypeError("text must be a 1-D uint8 tensor, got %s %r"
                        % (text.dtype, tuple(text.shape)))
    N = text.numel()
    if N == 0:
        raise ValueError("empty text")
    if plane.dtype != torch.int32 or tuple(plane.shape) != (-(-N // 32),):
        raise TypeError("plane must be int32[%d], got %s %r"
                        % (-(-N // 32), plane.dtype, tuple(plane.shape)))
    if not (text.is_contiguous() and plane.is_contiguous()):
        raise ValueError("text and plane must be contiguous")
    if plane.device != text.device or tables.device != text.device:
        raise ValueError("text on %s, plane on %s, tables on %s"
                         % (text.device, plane.device, tables.device))
    if not 1 <= body <= N or shift < 0:
        raise ValueError("body %d of a %d-byte region, shift %d"
                         % (body, N, shift))
    if not 0 <= carry < 1 << tables.n_terms:
        raise ValueError("carried mask %#x of %d terms"
                         % (carry, tables.n_terms))
    args = (int(shift), tables, int(body), int(carry), int(begin),
            int(base + N if cap_e is None else cap_e), bool(last),
            bool(count_only), int(base))
    if text.is_cuda:
        return _terms_launch(text, plane, *args)
    if text.device.type == "cpu":
        return line_terms_reference(text, plane, *args)
    raise ValueError("no line-terms kernel for device %s" % text.device)


def terms_present(text: torch.Tensor, s: torch.Tensor,
                  tables: TermTables) -> torch.Tensor:
    """The terminal mask (int64, bit t for term t) of the terms present
    at each start s: a loop over the terms and their bytes, vectorized
    across the starts still matching."""
    N = text.numel()
    b = text.long()
    tr = tables.tr.long()
    tb = tables.t_bytes.long()
    off = tables.t_off.cpu().tolist()
    mask = torch.zeros_like(s)
    for t in range(tables.n_terms):
        o, L = off[t], off[t + 1] - off[t]
        if L == 0:
            continue
        ok = s + L <= N
        for k in range(L):
            at = torch.nonzero(ok).flatten()
            if not len(at):
                break
            ok[at[tr[b[s[at] + k]] != tb[o + k]]] = False
        mask |= ok.long() << t
    return mask


def line_terms_reference(text: torch.Tensor, plane: torch.Tensor,
                         shift: int, tables: TermTables, body: int,
                         carry: int, begin: int, cap_e: int, last: bool,
                         count_only: bool, base: int) -> tuple:
    """Plain PyTorch version of the kernel, on any device: torch.nonzero
    of the plane, each start's terminal mask (terms_present), each
    start's line by torch.searchsorted over the body's newlines, the
    lines' masks ORed a term at a time, their verdicts gathered from the
    truth table."""
    dev = text.device
    w = plane.to(torch.int64) & 0xFFFFFFFF
    nz = torch.nonzero(w).flatten()
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    bits = ((w[nz, None] >> shifts) & 1) != 0
    s = (nz[:, None] * 32 + shifts)[bits] - shift
    s = s[(s >= 0) & (s < body)]
    m = terms_present(text, s, tables)
    s, m = s[m != 0], m[m != 0]
    nl = torch.nonzero(text[:body] == 0x0A).flatten()
    K = nl.numel()
    line = torch.searchsorted(nl, s)           # K: the tail
    lm = torch.zeros(K + 1, dtype=torch.int64, device=dev)
    for t in range(tables.n_terms):
        hit = torch.zeros(K + 1, dtype=torch.bool, device=dev)
        hit[line[((m >> t) & 1) != 0]] = True
        lm |= hit.long() << t
    lm[0] |= carry
    tw = tables.table.to(torch.int64) & 0xFFFFFFFF
    fire = (((tw[lm >> 5] >> (lm & 31)) & 1) != 0) & (lm != 0)
    tail_fires = bool(last) and bool(fire[K])
    carry_out = 0 if last else int(lm[K])
    last_nl = base + int(nl[-1]) if K else -1
    j = torch.nonzero(fire[:K]).flatten()
    count = j.numel() + tail_fires
    if count_only:
        return None, count, carry_out, last_nl
    prev = torch.where(j > 0, base + nl[(j - 1).clamp(min=0)] + 1,
                       torch.full_like(j, begin))
    rows = torch.stack([prev, base + nl[j] + 1], 1)
    if tail_fires:
        tail = torch.tensor([[last_nl + 1 if K else begin, cap_e]],
                            dtype=torch.int64, device=dev)
        rows = torch.cat([rows, tail])
    return rows, count, carry_out, last_nl


def _terms_bind():
    lib = _cuda.load("line_terms")
    if not getattr(lib, "_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ip = ctypes.POINTER(ctypes.c_int)
        lib.line_terms_launch.restype = i
        lib.line_terms_launch.argtypes = [p, ll, ll, p, i, p, ll, p, i, i, p,
                                          p, ll, ll, ll, ll, i, p, ll, p, ll,
                                          ll, ll, p, i, p]
        lib.line_terms_geometry.restype = i
        lib.line_terms_geometry.argtypes = [i, ip, ip, ip]
        lib.line_terms_error_string.restype = ctypes.c_char_p
        lib.line_terms_error_string.argtypes = [i]
        lib._bound = True
    return lib


@functools.lru_cache(maxsize=None)
def _terms_geometry(index: int, rows: bool) -> tuple:
    """(threads a block, blocks the device holds at once, text bytes a
    tile) of the kernel's rows form or count form."""
    return _cuda.query(_terms_bind(), "line_terms", "line_terms_geometry",
                       index, 3, int(rows))


def terms_capacity(body: int, min_len: int) -> int:
    """Rows a chunk's print can give: a line that fires holds a whole
    occurrence (min_len bytes at least, no newline) and its newline
    within the body, but for the first line (its mask may be carried in)
    and the tail line."""
    return 2 + body // (min_len + 1)


@dataclass
class _TermsScratch:
    """The kernel's scratch on one device and stream: int64 [2 + 2 *
    tiles] (the ticket counter and a pad, then a 16-byte status a tile),
    zeroed when allocated; the epoch of its last launch and the tickets
    its launches took."""
    buf: torch.Tensor
    tiles: int
    epoch: int = 0
    taken: int = 0


_EPOCHS = 1 << 30           # a status holds 30 bits of its launch's epoch
_terms_scratch: dict = {}   # (device index, stream) -> _TermsScratch


def _scratch_for(dev, stream: int, tiles: int) -> _TermsScratch:
    """The scratch of (dev, stream) for a launch of `tiles` tiles,
    allocated anew (zeroed) where it holds fewer or its epochs would
    wrap.  Each launch on it raises the epoch, so its status words need
    no clearing; a second stream gets a scratch of its own."""
    key = (_cuda.device_index(dev), stream)
    sc = _terms_scratch.get(key)
    if sc is None or sc.tiles < tiles or sc.epoch + 1 >= _EPOCHS:
        cap = max(tiles, 64, 2 * sc.tiles if sc else 0)
        sc = _TermsScratch(torch.zeros(2 + 2 * cap, dtype=torch.int64,
                                       device=dev), cap)
        _terms_scratch[key] = sc
    return sc


def _terms_call(text, plane, shift, tables: TermTables, body, carry, begin,
                cap_e, last, base, rows, grid: int) -> torch.Tensor:
    """The kernel's one launch of `grid` blocks on text's device and
    current stream: the rows into `rows` where it is not None (its rows
    past its capacity are not written); returns the int64 [4] tensor that
    it fills with the count, the carried-out mask, the last newline and
    the tail line's verdict."""
    lib = _terms_bind()
    dev = text.device
    out = torch.empty(4, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tiles = -(-body // _terms_geometry(_cuda.device_index(dev),
                                       rows is not None)[2])
    sc = _scratch_for(dev, stream, tiles)
    with torch.cuda.device(_cuda.device_index(dev)), trace.span("launch"):
        _cuda.check(lib, "line_terms", lib.line_terms_launch(
            text.data_ptr(), text.numel(), body, plane.data_ptr(), shift,
            tables.t_bytes.data_ptr(), tables.t_bytes.numel(),
            tables.t_off.data_ptr(), tables.n_terms, tables.max_len,
            tables.tr.data_ptr(), tables.table.data_ptr(),
            carry, base, begin, cap_e, int(last),
            None if rows is None else rows.data_ptr(),
            0 if rows is None else rows.shape[0], sc.buf.data_ptr(),
            sc.tiles, sc.epoch + 1, sc.taken, out.data_ptr(), grid,
            stream), "kernel launch")
    sc.epoch += 1
    sc.taken += tiles + grid
    return out


def terms_grid(body: int, rows: bool, device) -> int:
    """Blocks of line_terms' launch over a body of `body` bytes on the
    device: one a tile, no more than the device holds at once (each
    block then takes tile after tile)."""
    _threads, max_blocks, tile = _terms_geometry(_cuda.device_index(device),
                                                 rows)
    return max(1, min(max_blocks, -(-body // tile)))


def _terms_launch(text, plane, shift, tables: TermTables, body, carry, begin,
                  cap_e, last, count_only, base) -> tuple:
    """The kernel's one launch, the rows allocated at terms_capacity (the
    count never exceeds it: never a second launch), then the host's one
    read of the count, the carried mask and the last newline."""
    dev = text.device
    rows = None if count_only else torch.empty(
        (terms_capacity(body, tables.min_len), 2), dtype=torch.int64,
        device=dev)
    out = _terms_call(text, plane, shift, tables, body, carry, begin, cap_e,
                      last, base, rows, terms_grid(body, not count_only, dev))
    K, carry_out, last_nl, _tail = read(out)
    launches["line_terms"] += 1
    if rows is not None and K > rows.shape[0]:
        raise RuntimeError("line_terms: %d rows past the capacity %d"
                           % (K, rows.shape[0]))
    return (None if rows is None else rows[:K]), K, carry_out, last_nl
