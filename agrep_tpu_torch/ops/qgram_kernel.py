"""The q-gram kernel: dense 2-gram membership filter for the -f engine.

qgram_filter() marks, at every byte position i of a flat u8 text tensor,
whether the folded 2-gram hash

    h = ((text[i] & 31) << 5) | (text[i-1] & 31)      (text[-1] read as 0)

belongs to a 1024-bit member set, packed 32 positions to a word (bit r of
word w is position 32*w + r).  On a CUDA tensor it launches the
hand-written Hopper kernel csrc/qgram_filter.cu (built and loaded by
ops/_cuda.py) or raises; on a CPU tensor it runs qgram_reference(), the
plain PyTorch version of the same function.  qgram_candidates() turns the
plane into positions.

qgram_lines() verifies the candidate plane on the scan device and folds
it by line (csrc/qgram_lines.cu): the count of lines that hold a winning
term, or one (anchor, term id) row a such line, as the native
qgram_first_per_line gives them; qgram_lines_reference() is its plain
PyTorch version, line_tables() the q-gram tables as it takes them.

The hash is the non-LONG prepf 2-gram (newmgrep.c:1741-1743); for LONG
(3-gram) tables compile/multi.py member_projection_1024 gives the sound
tail-2-gram superset, and the engine's sparse verify stays exact.  The
member set travels as 32 u32 words (bit p of word c is member (c << 5) |
p), held in an int32 tensor.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import _cuda
from .chain_kernel import pack_bits, plane_positions
from .kernels import _sm_count, read, upload
from ..runtime import trace

# Launches of each kernel since the counts were last set to 0.
launches = {"qgram_filter": 0, "qgram_lines": 0}


def member_words(member: np.ndarray) -> tuple:
    """bool[1024] -> 32 u32 words; bit p of word c == member of hash
    (c << 5) | p."""
    if member.shape != (1024,):
        raise ValueError("member set must be bool[1024], got %r"
                         % (member.shape,))
    out = []
    for c in range(32):
        w = 0
        for p in range(32):
            if member[(c << 5) | p]:
                w |= 1 << p
        out.append(w)
    return tuple(out)


def words_tensor(member: np.ndarray, device="cpu") -> torch.Tensor:
    """The member set as the kernel takes it: int32[32] holding the u32
    words of member_words."""
    w = np.asarray(member_words(np.asarray(member, dtype=bool)),
                   dtype=np.uint32)
    return upload(torch.from_numpy(w.view(np.int32).copy()), device)


def qgram_filter(text: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Candidate plane int32[ceil(N/32)] of the member words over text
    (module docstring).  A CUDA tensor goes to the kernel, a CPU tensor
    to qgram_reference."""
    if text.dtype != torch.uint8 or text.dim() != 1:
        raise TypeError("text must be a 1-D uint8 tensor, got %s %r"
                        % (text.dtype, tuple(text.shape)))
    if not text.is_contiguous():
        raise ValueError("text must be contiguous")
    if text.numel() == 0:
        raise ValueError("empty text")
    if words.dtype != torch.int32 or tuple(words.shape) != (32,):
        raise TypeError("words must be int32[32], got %s %r"
                        % (words.dtype, tuple(words.shape)))
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    if text.device != words.device:
        raise ValueError("text on %s but the member words on %s"
                         % (text.device, words.device))
    if text.is_cuda:
        return _launch(text, words)
    if text.device.type == "cpu":
        return qgram_reference(text, words)
    raise ValueError("no q-gram kernel for device %s" % text.device)


def _bind():
    lib = _cuda.load("qgram_filter")
    if not getattr(lib, "_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ip = ctypes.POINTER(ctypes.c_int)
        lib.qgram_filter_launch.restype = i
        lib.qgram_filter_launch.argtypes = [p, ll, p, p, i, p]
        lib.qgram_filter_geometry.restype = i
        lib.qgram_filter_geometry.argtypes = [ip, ip]
        lib.qgram_filter_error_string.restype = ctypes.c_char_p
        lib.qgram_filter_error_string.argtypes = [i]
        lib._bound = True
    return lib


@functools.lru_cache(maxsize=None)
def _kernel_geometry(index: int) -> tuple:
    """(threads a block, blocks an SM holds) on device `index`, asked of
    the CUDA runtime once."""
    return _cuda.query(_bind(), "qgram_filter", "qgram_filter_geometry",
                       index, 2)


def launch_geometry(N: int, device, blocks_per_sm: int | None = None
                    ) -> dict:
    """What _launch runs for a filter of N bytes on a CUDA device:
    threads a block (a thread a 32-position word), blocks an SM (by
    default all that the SM holds, from the CUDA occupancy calculator)
    and the grid (never more blocks than the words fill)."""
    index = _cuda.device_index(device)
    threads, fits = _kernel_geometry(index)
    if blocks_per_sm is None:
        blocks_per_sm = fits
    n_words = -(-N // 32)
    return {"threads": threads, "blocks_per_sm": blocks_per_sm,
            "fits_per_sm": fits, "words": n_words,
            "grid": max(1, min(-(-n_words // threads),
                               blocks_per_sm * _sm_count(index)))}


def _launch(text: torch.Tensor, words: torch.Tensor,
            blocks_per_sm: int | None = None) -> torch.Tensor:
    """The kernel on text's device; blocks_per_sm defaults to
    launch_geometry's choice."""
    lib = _bind()
    N = text.numel()
    geo = launch_geometry(N, text.device, blocks_per_sm)
    out = torch.empty(-(-N // 32), dtype=torch.int32, device=text.device)
    stream = torch.cuda.current_stream(text.device).cuda_stream
    # the runtime launches on its current device: make it the tensor's
    index = _cuda.device_index(text.device)
    with torch.cuda.device(index), trace.span("launch"):
        _cuda.check(lib, "qgram_filter", lib.qgram_filter_launch(
            text.data_ptr(), N, words.data_ptr(), out.data_ptr(), geo["grid"],
            stream), "kernel launch")
    launches["qgram_filter"] += 1
    return out


def qgram_reference(text: torch.Tensor, words: torch.Tensor
                    ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: a gather of
    every position's hash from the 1024-entry member table."""
    dev = text.device
    w = words.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    table = (((w[:, None] >> shifts) & 1) != 0).flatten()      # [1024]
    f = (text & 31).long()
    prev = torch.zeros_like(f)
    prev[1:] = f[:-1]
    return pack_bits(table[(f << 5) | prev])


def qgram_candidates(text: torch.Tensor,
                     member1024: np.ndarray) -> np.ndarray:
    """Candidate positions i (text coords) where the 2-gram (text[i-1],
    text[i]) is a member, int64 on the host; position 0 is tested
    against a zero previous byte.  text: a u8 tensor (CUDA: the kernel;
    CPU: the plain version)."""
    words = words_tensor(member1024, text.device)
    return plane_positions(qgram_filter(text, words), text.numel())


# ---------------------------------------------------------------------
# qgram_lines: the lines that hold a verified candidate
# ---------------------------------------------------------------------

MAXHASH = 32768            # gram hashes (compile/multi.py MAXHASH)


@dataclasses.dataclass
class LineTables:
    """The q-gram tables on one device, as qgram_lines takes them."""
    member: torch.Tensor       # int32 [1024]: bit h & 31 of word h >> 5
    hash_id: torch.Tensor      # int32 [MAXHASH]: hash -> bucket
    b_off: torch.Tensor        # int64 [buckets + 1]
    b_tids: torch.Tensor       # int64: each bucket's term ids, ascending
    t_bytes: torch.Tensor      # uint8: the terms' bytes
    t_off: torch.Tensor        # int64 [terms + 1]
    tr: torch.Tensor           # uint8 [256]: the fold
    p: int                     # p_size: the anchor is a term's byte p - 1
    long_: bool                # 3-gram hashes
    wordbound: bool            # -w

    @property
    def device(self) -> torch.device:
        return self.member.device


def line_tables(member, hash_id, b_off, b_tids, t_bytes, t_off, tr, p: int,
                long_: bool, wordbound: bool, device="cpu") -> LineTables:
    """The tables of compile/multi.py (member bool[MAXHASH] or [1024],
    hash_id, the bucket CSR b_off/b_tids and term CSR t_off/t_bytes of
    the native passes, the fold tr) on device.  SHORT tables (p 1) have
    no gram hash: they are refused."""
    if p < 2 or (long_ and p < 3):
        raise ValueError("no gram hash for p_size %d (LONG %d)"
                         % (p, long_))
    mem = np.zeros(MAXHASH, dtype=bool)
    m = np.asarray(member, dtype=bool)
    mem[:len(m)] = m
    words = np.packbits(mem, bitorder="little").view("<u4").view(np.int32)
    hid = np.full(MAXHASH, -1, dtype=np.int32)
    hid[:len(hash_id)] = np.asarray(hash_id, dtype=np.int32)
    t_bytes = np.asarray(t_bytes, dtype=np.uint8)
    if not len(t_bytes):
        t_bytes = np.zeros(1, dtype=np.uint8)

    def dev(a, dtype):
        return upload(torch.from_numpy(np.array(a, dtype=dtype)), device)
    return LineTables(dev(words, np.int32), dev(hid, np.int32),
                      dev(b_off, np.int64), dev(b_tids, np.int64),
                      dev(t_bytes, np.uint8), dev(t_off, np.int64),
                      dev(tr, np.uint8), int(p), bool(long_),
                      bool(wordbound))


def qgram_lines(text: torch.Tensor, plane: torch.Tensor, tables: LineTables,
                count_only: bool = False) -> tuple:
    """The lines of text that hold a winner at a set bit of qgram_filter's
    candidate plane: (rows, count).  At a set bit a >= p - 1 the winner is
    the highest term of the gram's bucket that matches at a - (p - 1)
    under the fold (and -w), as agrep_host.cpp's qgram_first_win gives
    it; anchor a lies in line (newlines at positions <= a).  count: the
    lines that hold a winner; rows: int64 [count, 2] on text's device,
    each such line's first (anchor, term id) in stream order, None where
    count_only.  A CUDA tensor goes to the kernel, a CPU tensor to
    qgram_lines_reference."""
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
    if text.is_cuda:
        return _lines_launch(text, plane, tables, count_only)
    if text.device.type == "cpu":
        return qgram_lines_reference(text, plane, tables, count_only)
    raise ValueError("no q-gram lines kernel for device %s" % text.device)


def _is_alnum(c: torch.Tensor) -> torch.Tensor:
    low = c | 0x20
    return ((c >= 48) & (c <= 57)) | ((low >= 97) & (low <= 122))


def anchor_winners(text: torch.Tensor, a: torch.Tensor,
                   tables: LineTables) -> torch.Tensor:
    """The winning term id at each anchor a (int64, p - 1 <= a < N), -1
    where none: the exact member test of the gram hash, then its bucket
    from the highest term down, a loop over the bucket depth and the term
    bytes, vectorized across anchors."""
    b = text.long()
    N, p = b.numel(), tables.p
    h = ((b[a] & 31) << 5) | (b[a - 1] & 31)
    if tables.long_:
        h = ((h << 5) | (b[a - 2] & 31)) & (MAXHASH - 1)
    mw = tables.member.long() & 0xFFFFFFFF
    member = torch.nonzero(((mw[h >> 5] >> (h & 31)) & 1) != 0).flatten()
    out = torch.full_like(a, -1)
    a, h = a[member], h[member]
    tr = tables.tr.long()
    tb = tables.t_bytes.long()
    bk = tables.hash_id[h].long()
    lo, hi = tables.b_off[bk], tables.b_off[bk + 1]
    s = a - (p - 1)
    win = torch.full_like(a, -1)
    for d in range(int((hi - lo).max()) if len(a) else 0):
        idx = torch.nonzero((hi - 1 - d >= lo) & (win < 0)).flatten()
        if not len(idx):
            break
        tid = tables.b_tids[hi[idx] - 1 - d]
        ss = s[idx]
        o = tables.t_off[tid]
        L = tables.t_off[tid + 1] - o
        ok = ss + L <= N
        for k in range(int(L.max())):
            live = ok & (k < L)
            if not live.any():
                break
            at = torch.nonzero(live).flatten()
            same = tr[b[ss[at] + k]] == tr[tb[o[at] + k]]
            ok[at[~same]] = False
        if tables.wordbound:
            end = ss + L
            after = torch.where(end < N, b[end.clamp(max=N - 1)], 0)
            before = torch.where(ss > 0, b[(ss - 1).clamp(min=0)], 0)
            ok &= ~_is_alnum(after) & ~_is_alnum(before)
        win[idx[ok]] = tid[ok]
    out[member] = win
    return out


def qgram_lines_reference(text: torch.Tensor, plane: torch.Tensor,
                          tables: LineTables,
                          count_only: bool = False) -> tuple:
    """Plain PyTorch version of the kernel, on any device: torch.nonzero
    of the plane, each anchor's winner (anchor_winners), and each line's
    first anchor through a cumsum of the newlines."""
    dev = text.device
    N, p = text.numel(), tables.p
    w = plane.to(torch.int64) & 0xFFFFFFFF
    nz = torch.nonzero(w).flatten()
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    bits = ((w[nz, None] >> shifts) & 1) != 0
    a = (nz[:, None] * 32 + shifts)[bits]
    a = a[(a >= p - 1) & (a < N)]
    win = anchor_winners(text, a, tables)
    a, win = a[win >= 0], win[win >= 0]
    line = torch.cumsum(text == 0x0A, 0)[a]
    first = torch.ones_like(a, dtype=torch.bool)
    first[1:] = line[1:] != line[:-1]
    K = int(first.sum())
    if count_only:
        return None, K
    return torch.stack([a[first], win[first]], 1), K


def _lines_bind():
    lib = _cuda.load("qgram_lines")
    if not getattr(lib, "_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ip = ctypes.POINTER(ctypes.c_int)
        head = [p, ll, p, p, p, p, p, p, p, p, ll, i, i]
        for fn, args in (("sums", head + [p, p, p, p, ll, p]),
                         ("rows", head + [p, p, p, p, p, ll, p])):
            getattr(lib, "qgram_lines_" + fn).restype = i
            getattr(lib, "qgram_lines_" + fn).argtypes = args
        lib.qgram_lines_scan.restype = i
        lib.qgram_lines_scan.argtypes = [p, p, ll, p, p, p, p]
        lib.qgram_lines_geometry.restype = i
        lib.qgram_lines_geometry.argtypes = [ip]
        lib.qgram_lines_error_string.restype = ctypes.c_char_p
        lib.qgram_lines_error_string.argtypes = [i]
        lib._bound = True
    return lib


@functools.lru_cache(maxsize=None)
def _lines_tile_words(index: int) -> int:
    return _cuda.query(_lines_bind(), "qgram_lines", "qgram_lines_geometry",
                       index, 1)[0]


def lines_tile_words(device) -> int:
    """Plane words a tile of the kernel's passes 1 and 3 on device."""
    return _lines_tile_words(_cuda.device_index(device))


def lines_tiles(N: int, tile_words: int) -> int:
    """Tiles of qgram_lines' passes 1 and 3 over a text of N bytes."""
    return -(-(-(-N // 32)) // tile_words)


def _lines_call(fn: str, text, *args) -> None:
    """One pass of the kernel on text's device and current stream."""
    lib = _lines_bind()
    dev = text.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(_cuda.device_index(dev)), trace.span("launch"):
        _cuda.check(lib, "qgram_lines", getattr(lib, "qgram_lines_" + fn)(
            *args, stream), fn + " launch")


def _table_args(text, plane, t: LineTables) -> tuple:
    return (text.data_ptr(), text.numel(), plane.data_ptr(),
            t.member.data_ptr(), t.hash_id.data_ptr(), t.b_off.data_ptr(),
            t.b_tids.data_ptr(), t.t_bytes.data_ptr(), t.t_off.data_ptr(),
            t.tr.data_ptr(), t.p, int(t.long_), int(t.wordbound))


def _prefix(text, plane, tables: LineTables, masks: bool) -> tuple:
    """Passes 1-2: (the count as a device tensor, the tiles' prefix
    summaries pf and pmid, the words' newline and winner masks where
    masks (the print form) or None, the tiles, the tables' arguments)."""
    dev = text.device
    tiles = lines_tiles(text.numel(), lines_tile_words(dev))
    args = _table_args(text, plane, tables)
    bf = torch.empty(tiles, dtype=torch.int32, device=dev)
    bmid = torch.empty(tiles, dtype=torch.int32, device=dev)
    pf = torch.empty(tiles + 1, dtype=torch.int32, device=dev)
    pmid = torch.empty(tiles + 1, dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    nlm = winm = None
    if masks:
        nlm, winm = (torch.empty(plane.numel(), dtype=torch.int32,
                                 device=dev) for _ in range(2))
    _lines_call("sums", text, *args, bf.data_ptr(), bmid.data_ptr(),
                None if nlm is None else nlm.data_ptr(),
                None if winm is None else winm.data_ptr(), tiles)
    _lines_call("scan", text, bf.data_ptr(), bmid.data_ptr(), tiles,
                pf.data_ptr(), pmid.data_ptr(), total.data_ptr())
    return total, pf, pmid, (nlm, winm), tiles, args


def _rows(text, args, pf, pmid, masks, rows, tiles) -> None:
    """Pass 3 into rows."""
    _lines_call("rows", text, *args, pf.data_ptr(), pmid.data_ptr(),
                masks[0].data_ptr(), masks[1].data_ptr(), rows.data_ptr(),
                tiles)


def lines_passes(text, plane, tables: LineTables, out=None) -> None:
    """Passes 1-2 and, into out (an earlier call's rows of the same
    inputs; None for a count), pass 3: the kernel's device work without
    the host's read of the count (for timing it on the card)."""
    _total, pf, pmid, masks, tiles, args = _prefix(text, plane, tables,
                                                   out is not None)
    if out is not None and out.shape[0]:
        _rows(text, args, pf, pmid, masks, out, tiles)


def _lines_launch(text, plane, tables: LineTables, count_only: bool) -> tuple:
    """The kernel's passes on text's device, with the host's read of the
    count after the second."""
    total, pf, pmid, masks, tiles, args = _prefix(text, plane, tables,
                                                  not count_only)
    K = read(total[0])
    rows = None
    if not count_only:
        rows = torch.empty((K, 2), dtype=torch.int64, device=text.device)
        if K:
            _rows(text, args, pf, pmid, masks, rows, tiles)
    launches["qgram_lines"] += 1
    return rows, K
