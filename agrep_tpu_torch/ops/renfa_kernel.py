"""The regex lanes kernel: wrapper, plain PyTorch version, machine.

renfa_lines() runs the record-parallel regex-with-errors automaton of
ops/renfa.py over lines of a flat u8 text tensor and returns one
verdict per line.  On a CUDA tensor it launches the hand-written Hopper
kernel csrc/renfa_lanes.cu (built and loaded by ops/_cuda.py) or
raises; on a CPU tensor it runs renfa_lines_reference(), the plain
PyTorch version of the same function.

Line r is text[starts[r] : starts[r] + lens[r] + 1]: lens[r] bytes, then
the newline at offset lens[r].  From the D+1 states `init`, the machine
steps the lens[r] bytes with renfa.step_char; at the newline column it
forms
    ad = (nxt(s[D]) & cm) | (init1 & s[D]),  then ad |= nxt(ad) if tail,
with cm the mask of the byte there, and the verdict is ad & 1 -- the
bit renfa.scan_records reads at a lane's newline column.  An empty
line (lens[r] == 0) takes its verdict straight from init.

line_index() cuts a text into its newline-terminated lines on the text's
device and orders them for renfa_lines (csrc/line_index.cu), and
line_rows() turns renfa_lines' verdicts into the count of the lines that
fire and, for a print, their rows in stream order (csrc/line_rows.cu):
the regex engine's line index, length sort and verdict read-back, kept
where the text lies.  Each launches its kernel on a CUDA tensor and runs
its plain PyTorch version (line_index_reference, line_rows_reference) on
a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from . import _cuda, renfa
from .kernels import _sm_count, read, upload
from ..runtime import trace

MAX_D = 4                       # compile/query.py's late error caps D
_CELLS = 1 << 24                # plain version: lane cells per pass
# plain version: a group of fewer lines walks each line on Python ints
# (a torch step a column costs more than the ints' walk below this)
_SCALAR_ROWS = 16

# Forms of the kernel's Next tables (csrc/renfa_lanes.cu): one table of
# 2^(M-1) words, or four byte tables.
FORMS = {"one": 0, "bytes": 1}
MAX_ONE_BITS = 15               # one table: at most 2^15 words, 128 KB
# Threads a block; tools/torch_renfa_lanes_time.py times both forms,
# every block size and blocks an SM at the main path's shapes.
THREADS = 512

# Launches of each kernel since the counts were last set to 0.
launches = {"renfa_lanes": 0, "line_index": 0, "line_rows": 0}


@dataclass(frozen=True)
class RegexMachine:
    """A compiled regex machine as the lanes kernel takes it."""
    tables: torch.Tensor    # u32[5, 256] on the scan device: row 0 the
                            # cmask table, rows 1-4 renfa.nxt_byte_tables
    head_bit: int
    init1: int
    no_err: int
    D: int
    tail: bool
    M: int


def machine_from_mc(mc, device="cpu") -> RegexMachine:
    """Kernel inputs from a compiled query's re_mc (compile/query.py,
    of this package or of the JAX one: numpy arrays and ints)."""
    D = int(mc["D"])
    if not 0 <= D <= MAX_D:
        raise ValueError("D=%r outside 0..%d" % (D, MAX_D))
    cmask = np.asarray(mc["mask"], dtype=np.uint32)
    if cmask.shape != (256,):
        raise ValueError("mask table must be u32[256], got %r"
                         % (cmask.shape,))
    tables = np.concatenate([cmask[None, :], renfa.nxt_byte_tables(mc)])
    return RegexMachine(
        tables=upload(torch.from_numpy(np.ascontiguousarray(tables)), device),
        head_bit=int(mc["head_bit"]) & renfa.U32,
        init1=int(mc["init1"]) & renfa.U32,
        no_err=int(mc["no_err"]) & renfa.U32,
        D=D, tail=bool(mc["tail"]), M=int(mc["M"]))


def renfa_lines(text: torch.Tensor, starts: torch.Tensor,
                lens: torch.Tensor, m: RegexMachine, init
                ) -> torch.Tensor:
    """Verdicts bool[R] of the R lines (module docstring), every line
    starting from the D+1 states init.  A CUDA tensor goes to the
    kernel, a CPU tensor to renfa_lines_reference."""
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
    if (starts.device != dev or lens.device != dev
            or m.tables.device != dev):
        raise ValueError("text on %s, starts on %s, lens on %s, the "
                         "machine on %s" % (dev, starts.device,
                                            lens.device, m.tables.device))
    if len(init) != m.D + 1:
        raise ValueError("init has %d states, the machine takes D+1 = %d"
                         % (len(init), m.D + 1))
    if not (text.is_cuda or dev.type == "cpu"):
        raise ValueError("no regex lanes kernel for device %s" % dev)
    if starts.numel() == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    if read(((starts < 0) | (lens < 0)
            | (starts + lens >= text.numel())).any()):
        raise ValueError("a line (start, start + len] lies outside the "
                         "%d-byte text" % text.numel())
    if text.is_cuda:
        return _launch(text, starts, lens, m, init)
    return renfa_lines_reference(text, starts, lens, m, init)


def forms(M: int) -> list:
    """Every Next form the kernel takes for a machine of M positions:
    the one table up to MAX_ONE_BITS index bits (M - 1), the byte tables
    at any M (csrc/renfa_lanes.cu form_ok)."""
    return (["one"] if max(M - 1, 0) <= MAX_ONE_BITS else []) + ["bytes"]


def table_form(M: int) -> str:
    """The Next form the wrapper launches for M positions: the first of
    forms(M)."""
    return forms(M)[0]


def _bind():
    lib = _cuda.load("renfa_lanes")
    if not getattr(lib, "_bound", False):
        p, i, u, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                       ctypes.c_longlong)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.renfa_lanes_launch.restype = i
        lib.renfa_lanes_launch.argtypes = [
            p, ll, p, p, ll, p, u, u, u, i, i,
            ctypes.POINTER(ctypes.c_uint32), p, i, i, i, i, p]
        lib.renfa_lanes_geometry.restype = i
        lib.renfa_lanes_geometry.argtypes = [i, i, i, i, ip, ip, ip, ip]
        lib.renfa_lanes_error_string.restype = ctypes.c_char_p
        lib.renfa_lanes_error_string.argtypes = [i]
        lib._bound = True
    return lib


@functools.lru_cache(maxsize=None)
def _kernel_geometry(D: int, M: int, form: str, threads: int,
                     index: int) -> tuple:
    """(dynamic shared bytes, blocks an SM holds, registers, local bytes)
    of the kernel of D and form on device `index`, asked of the CUDA
    runtime once."""
    return _cuda.query(_bind(), "renfa_lanes", "renfa_lanes_geometry",
                       index, 4, D, M, FORMS[form], threads)


def launch_geometry(R: int, m: RegexMachine, device, form: str | None = None,
                    threads: int | None = None,
                    blocks_per_sm: int | None = None) -> dict:
    """What _launch runs for R lines on a CUDA device: the Next form, its
    table bytes, threads a block, blocks an SM (by default all that the
    SM holds at the form's shared bytes, from the CUDA occupancy
    calculator), the grid (never more blocks than the lines fill), and
    the kernel's registers and local (spill) bytes a thread."""
    form = table_form(m.M) if form is None else form
    threads = THREADS if threads is None else threads
    index = _cuda.device_index(device)
    smem, fits, regs, local = _kernel_geometry(m.D, m.M, form, threads,
                                               index)
    if blocks_per_sm is None:
        blocks_per_sm = fits
    return {"form": form, "table_bytes": smem - 4 * 256,
            "smem_bytes": smem, "threads": threads,
            "blocks_per_sm": blocks_per_sm, "fits_per_sm": fits,
            "grid": max(1, min(-(-R // threads),
                               blocks_per_sm * _sm_count(index))),
            "regs": regs, "local_bytes": local}


def _launch(text, starts, lens, m: RegexMachine, init,
            form: str | None = None, threads: int | None = None,
            blocks_per_sm: int | None = None) -> torch.Tensor:
    """The kernel on text's device; form, threads and blocks_per_sm
    default to launch_geometry's choice."""
    lib = _bind()
    R = starts.numel()
    geo = launch_geometry(R, m, text.device, form, threads, blocks_per_sm)
    out = torch.empty(R, dtype=torch.uint8, device=text.device)
    ini = (ctypes.c_uint32 * (MAX_D + 1))(
        *[int(v) & renfa.U32 for v in init])
    stream = torch.cuda.current_stream(text.device).cuda_stream
    # the runtime launches on its current device: make it the tensor's
    index = _cuda.device_index(text.device)
    with torch.cuda.device(index), trace.span("launch"):
        _cuda.check(lib, "renfa_lanes", lib.renfa_lanes_launch(
            text.data_ptr(), text.numel(), starts.data_ptr(), lens.data_ptr(),
            R, m.tables.data_ptr(), m.head_bit, m.init1, m.no_err,
            int(m.tail), m.D, ini, out.data_ptr(), m.M, FORMS[geo["form"]],
            geo["threads"], geo["grid"], stream), "kernel launch")
    launches["renfa_lanes"] += 1
    return out.view(torch.bool)


def _bucket(n: int) -> int:
    for b in renfa.MAXLINE_BUCKETS:
        if n <= b:
            return b
    return n


def _walk_line(cms: list, n: int, tabs: list, m: RegexMachine,
               init) -> bool:
    """One line of n bytes (cms: the class masks of its bytes and of the
    newline after them) through the machine on Python ints: the steps
    and the verdict of renfa_lines_reference's columns."""
    t0, t1, t2, t3 = tabs
    head, init1, noerr, D = m.head_bit, m.init1, m.no_err, m.D

    def nxt(s):
        return (t0[s & 255] | t1[(s >> 8) & 255] | t2[(s >> 16) & 255]
                | t3[s >> 24] | head)

    s = [int(v) & renfa.U32 for v in init]
    for col in range(n):
        cm = cms[col]
        new = [(nxt(s[0]) & cm) | (init1 & s[0])]
        for k in range(1, D + 1):
            r0 = s[k - 1] | new[k - 1]
            new.append((nxt(s[k]) & cm) | ((s[k - 1] | nxt(r0)) & noerr)
                       | (init1 & s[k]))
        s = new
    ad = (nxt(s[D]) & cms[n]) | (init1 & s[D])
    if m.tail:
        ad = nxt(ad) | ad
    return bool(ad & 1)


def renfa_lines_reference(text: torch.Tensor, starts: torch.Tensor,
                          lens: torch.Tensor, m: RegexMachine, init,
                          scalar_rows: int = _SCALAR_ROWS
                          ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the lines
    bucketed by length (renfa.MAXLINE_BUCKETS), each bucket vectorized
    over its lines with one Python step per column, and a group of
    fewer than scalar_rows lines (a long line's bucket) walked a line
    at a time on Python ints (_walk_line).  nxt is gathered from the
    same four byte tables as the kernel's.  States are int64 holding u32
    values (CPU torch has no >>, << or ~ on uint32); only >>, & and |
    touch them, so they stay below 2**32."""
    dev = text.device
    R = starts.numel()
    out = torch.zeros(R, dtype=torch.bool, device=dev)
    if R == 0:
        return out
    cmask, t0, t1, t2, t3 = m.tables.to(torch.int64)
    head, init1, noerr, D = m.head_bit, m.init1, m.no_err, m.D

    def nxt(s):
        return (t0[s & 255] | t1[(s >> 8) & 255] | t2[(s >> 16) & 255]
                | t3[s >> 24] | head)

    tabs = None
    lens_h = lens.cpu().numpy()
    order = np.argsort(lens_h, kind="stable")
    sorted_lens = lens_h[order]
    i = 0
    while i < R:
        L = _bucket(int(sorted_lens[i]) + 1)
        j = int(np.searchsorted(sorted_lens, L - 1, side="right"))
        rows = max(1, _CELLS // L)
        for s0 in range(i, j, rows):
            idx_h = order[s0:min(s0 + rows, j)]
            if len(idx_h) < scalar_rows:
                if tabs is None:
                    tabs = [t.tolist() for t in (t0, t1, t2, t3)]
                for r in idx_h.tolist():
                    st, n = int(starts[r]), int(lens_h[r])
                    cms = cmask[text[st:st + n + 1].long()].tolist()
                    out[r] = _walk_line(cms, n, tabs, m, init)
                continue
            idx = torch.from_numpy(idx_h).to(dev)
            st, ln = starts[idx], lens[idx]
            n_col = int(lens_h[idx_h].max()) + 1
            # columns past a line's newline read the newline again:
            # every read stays inside the line
            pos = torch.minimum(
                st[:, None] + torch.arange(n_col, device=dev)[None, :],
                (st + ln)[:, None])
            cms = cmask[text[pos].long()]                 # [rows, n_col]
            s = [torch.full((len(idx_h),), int(v) & renfa.U32,
                            dtype=torch.int64, device=dev) for v in init]
            verdict = torch.zeros(len(idx_h), dtype=torch.bool,
                                  device=dev)
            stops = set(np.unique(lens_h[idx_h]).tolist())
            for col in range(n_col):
                cm = cms[:, col]
                if col in stops:
                    ad = (nxt(s[D]) & cm) | (init1 & s[D])
                    if m.tail:
                        ad = nxt(ad) | ad
                    verdict = torch.where(ln == col, (ad & 1) != 0,
                                          verdict)
                if col == n_col - 1:
                    break
                new = [(nxt(s[0]) & cm) | (init1 & s[0])]
                for k in range(1, D + 1):
                    r0 = s[k - 1] | new[k - 1]
                    new.append((nxt(s[k]) & cm)
                               | ((s[k - 1] | nxt(r0)) & noerr)
                               | (init1 & s[k]))
                s = new
            out[idx] = verdict
        i = j
    return out


# ---------------------------------------------------------------------
# line_index: a text's lines, in the order renfa_lines takes them
# ---------------------------------------------------------------------

# The length order's keys (csrc/line_index.cu len_key): the exact length
# below EXACT_LEN, sixteen steps an octave up to LONG_LEN - 1, and every
# line of LONG_LEN bytes or more in the last key.
EXACT_LEN = 128
LONG_LEN = 8192
LEN_KEYS = 225


class LineIndex(NamedTuple):
    """A text's K newline-terminated lines (line j is [start_j, nl[j]),
    start_0 = 0, start_j = nl[j-1] + 1 after), on the text's device."""
    nl: torch.Tensor        # int64 [K]: the newlines' positions, in order
    starts: torch.Tensor    # int64 [K]: the lines' starts in length order
    lens: torch.Tensor      # int64 [K]: their lengths
    ords: torch.Tensor      # int64 [K]: their stream ordinals
    last: int               # nl[K-1], where the next chunk starts; -1


def len_key(lens: torch.Tensor) -> torch.Tensor:
    """The sort key of each length (int64): the length below EXACT_LEN;
    EXACT_LEN + 16 (e - 7) + the four bits below the top one for a
    length of top bit e up to LONG_LEN - 1; LEN_KEYS - 1 past that."""
    e = 7 + sum((lens >= (1 << b)).to(torch.int64) for b in range(8, 13))
    sub = torch.bitwise_right_shift(lens.clamp(max=LONG_LEN - 1), e - 4) & 15
    key = torch.where(lens < EXACT_LEN, lens, EXACT_LEN + (e - 7) * 16 + sub)
    return torch.where(lens >= LONG_LEN, torch.full_like(lens, LEN_KEYS - 1),
                       key)


def line_index(text: torch.Tensor, delim: int = 0x0A) -> LineIndex:
    """The lines of a 1-D uint8 text, cut at the byte delim (the regex
    engine's newline; the bitap engine's one-byte -d for bitap_lanes):
    their delimiters ("newlines") in stream order, and their starts,
    lengths and ordinals in length order, a stable sort by len_key (a
    warp of renfa_lines or bitap_lanes walks lines of close lengths).  A
    CUDA tensor goes to the kernel, a CPU tensor to
    line_index_reference."""
    if text.dtype != torch.uint8 or text.dim() != 1:
        raise TypeError("text must be a 1-D uint8 tensor, got %s %r"
                        % (text.dtype, tuple(text.shape)))
    if not text.is_contiguous():
        raise ValueError("text must be contiguous")
    if not 0 <= delim <= 255:
        raise ValueError("delim must be a byte value, got %r" % (delim,))
    if text.is_cuda:
        return _index_launch(text, delim)
    if text.device.type == "cpu":
        return line_index_reference(text, delim)
    raise ValueError("no line-index kernel for device %s" % text.device)


def line_index_reference(text: torch.Tensor,
                         delim: int = 0x0A) -> LineIndex:
    """Plain PyTorch version of the kernel, on any device: torch.nonzero
    of the delimiters, then a stable torch.sort of the lengths' keys."""
    nl = torch.nonzero(text == delim).flatten()
    starts = torch.cat([nl.new_zeros(min(1, nl.numel())), nl[:-1] + 1])
    lens = nl - starts
    order = torch.sort(len_key(lens), stable=True).indices
    return LineIndex(nl, starts[order], lens[order], order,
                     int(nl[-1].item()) if nl.numel() else -1)


def _index_bind():
    lib = _cuda.load("line_index")
    if not getattr(lib, "_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ip = ctypes.POINTER(ctypes.c_int)
        lib.line_index_text_grid.restype = ll
        lib.line_index_text_grid.argtypes = [p, ll]
        for fn, args in (("count", [p, ll, p, p, p, i, i, p]),
                         ("offsets", [p, p, i, p, p, p, p]),
                         ("write", [p, ll, p, p, p, p, p, i, p]),
                         ("keys", [p, i, p, p, p]),
                         ("scatter", [p, p, p, p, p, p, p, i, p])):
            getattr(lib, "line_index_" + fn).restype = i
            getattr(lib, "line_index_" + fn).argtypes = args
        lib.line_index_geometry.restype = i
        lib.line_index_geometry.argtypes = [ip, ip, ip, ip]
        lib.line_index_error_string.restype = ctypes.c_char_p
        lib.line_index_error_string.argtypes = [i]
        lib._bound = True
    return lib


@functools.lru_cache(maxsize=None)
def _index_geometry(index: int) -> tuple:
    return _cuda.query(_index_bind(), "line_index", "line_index_geometry",
                       index, 4)


def index_geometry(device) -> tuple:
    """(threads a block, text bytes a block, lines a scatter round, keys)
    of the kernel on device."""
    return _index_geometry(_cuda.device_index(device))


def index_grid(text: torch.Tensor) -> int:
    """Blocks of line_index's passes over the text (all but its two
    one-grid scans): a block a text_bytes share of the 16-byte pieces
    from the aligned address at or below the text."""
    return _index_bind().line_index_text_grid(text.data_ptr(), text.numel())


def _index_call(fn: str, dev, *args) -> None:
    """One pass of the kernel on dev's current stream."""
    lib = _index_bind()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(_cuda.device_index(dev)), trace.span("launch"):
        _cuda.check(lib, "line_index", getattr(lib, "line_index_" + fn)(
            *args, stream), fn + " launch")


def _index_head(text, grid, delim: int = 0x0A) -> tuple:
    """Passes 1-2: (each 16-byte piece's newline bits, offs int64 [grid +
    1], prev int64 [grid], meta int64 [2] = (K, the last newline)), on
    the card; the newlines are the bytes equal to delim."""
    dev = text.device
    counts, last, prev = (torch.empty(grid, dtype=torch.int64, device=dev)
                          for _ in range(3))
    offs = torch.empty(grid + 1, dtype=torch.int64, device=dev)
    meta = torch.empty(2, dtype=torch.int64, device=dev)
    masks = torch.empty(grid * (index_geometry(dev)[1] // 16),
                        dtype=torch.int16, device=dev)
    _index_call("count", dev, text.data_ptr(), text.numel(),
                counts.data_ptr(), last.data_ptr(), masks.data_ptr(), grid,
                delim)
    _index_call("offsets", dev, counts.data_ptr(), last.data_ptr(), grid,
                offs.data_ptr(), prev.data_ptr(), meta.data_ptr())
    return masks, offs, prev, meta


def _index_lines(text, head, idx: LineIndex, grid) -> None:
    """Passes 3-5 into idx's tensors (K = idx.nl.numel() > 0), after
    _index_head's passes."""
    dev = text.device
    masks, offs, prev, _meta = head
    hist = torch.empty(LEN_KEYS * grid, dtype=torch.int32, device=dev)
    slots = torch.empty(LEN_KEYS * grid, dtype=torch.int64, device=dev)
    ktot = torch.empty(LEN_KEYS, dtype=torch.int64, device=dev)
    _index_call("write", dev, text.data_ptr(), text.numel(),
                masks.data_ptr(), offs.data_ptr(), prev.data_ptr(),
                idx.nl.data_ptr(), hist.data_ptr(), grid)
    _index_call("keys", dev, hist.data_ptr(), grid, slots.data_ptr(),
                ktot.data_ptr())
    _index_call("scatter", dev, idx.nl.data_ptr(), offs.data_ptr(),
                slots.data_ptr(), ktot.data_ptr(), idx.starts.data_ptr(),
                idx.lens.data_ptr(), idx.ords.data_ptr(), grid)


def index_passes(text: torch.Tensor, idx: LineIndex,
                 delim: int = 0x0A) -> None:
    """Every pass into idx, an earlier call's index of the same text
    (and delimiter): the kernel's device work without the host's read of
    K (for timing it on the card)."""
    grid = index_grid(text)
    head = _index_head(text, grid, delim)
    if idx.nl.numel():
        _index_lines(text, head, idx, grid)


def _index_launch(text: torch.Tensor, delim: int = 0x0A) -> LineIndex:
    """The kernel's passes on the text's device, with the host's read of
    K and the last newline after the second."""
    dev = text.device
    empty = torch.empty(0, dtype=torch.int64, device=dev)
    if text.numel() == 0:
        return LineIndex(empty, empty, empty, empty, -1)
    grid = index_grid(text)
    head = _index_head(text, grid, delim)
    K, end = read(head[3])
    idx = LineIndex(*(torch.empty(K, dtype=torch.int64, device=dev)
                      for _ in range(4)), end)
    if K:
        _index_lines(text, head, idx, grid)
    launches["line_index"] += 1
    return idx


# ---------------------------------------------------------------------
# line_rows: the lines that fire, in stream order
# ---------------------------------------------------------------------

def line_rows(verdicts: torch.Tensor, ords: torch.Tensor, nl: torch.Tensor,
              invert: bool, first: int, end: int, glitch: int = -1,
              rows: bool = True) -> tuple:
    """The lines that fire, from renfa_lines' verdicts over line_index's
    order: (rows, count).  Line j fires when first <= j < end and its
    verdict ^ invert.  verdicts: bool [K] in launch order; ords: int64
    [K], each launched line's stream ordinal (a permutation of 0..K-1;
    a value outside 0..K-1 names no line);
    nl: int64 [K], the newlines in stream order.  rows: int64 [count, 3]
    on the verdicts' device, one (j, start_j, nl[j]) a line that fires in
    stream order, each position p past glitch (a byte the caller inserted
    into the text, or -1) as p - 1; None where rows is False.  A CUDA
    tensor goes to the kernel, a CPU tensor to line_rows_reference."""
    if verdicts.dtype != torch.bool or verdicts.dim() != 1:
        raise TypeError("verdicts must be a 1-D bool tensor, got %s %r"
                        % (verdicts.dtype, tuple(verdicts.shape)))
    for name, t in (("ords", ords), ("nl", nl)):
        if t.dtype != torch.int64 or t.dim() != 1:
            raise TypeError("%s must be a 1-D int64 tensor, got %s %r"
                            % (name, t.dtype, tuple(t.shape)))
    if not (verdicts.shape == ords.shape == nl.shape):
        raise ValueError("verdicts %r, ords %r and nl %r differ in shape"
                         % (tuple(verdicts.shape), tuple(ords.shape),
                            tuple(nl.shape)))
    if not (verdicts.is_contiguous() and ords.is_contiguous()
            and nl.is_contiguous()):
        raise ValueError("verdicts, ords and nl must be contiguous")
    dev = verdicts.device
    if ords.device != dev or nl.device != dev:
        raise ValueError("verdicts on %s, ords on %s, nl on %s"
                         % (dev, ords.device, nl.device))
    if first < 0 or end > nl.numel() or glitch < -1:
        raise ValueError("kept ordinals [%d, %d) of %d lines, glitch %d"
                         % (first, end, nl.numel(), glitch))
    args = (bool(invert), int(first), int(end), int(glitch), bool(rows))
    if verdicts.is_cuda:
        return _rows_launch(verdicts, ords, nl, *args)
    if dev.type == "cpu":
        return line_rows_reference(verdicts, ords, nl, *args)
    raise ValueError("no line-rows kernel for device %s" % dev)


def line_rows_reference(verdicts: torch.Tensor, ords: torch.Tensor,
                        nl: torch.Tensor, invert: bool, first: int,
                        end: int, glitch: int = -1,
                        rows: bool = True) -> tuple:
    """Plain PyTorch version of the kernel, on any device: the verdicts
    scattered to their ordinals, torch.nonzero of those that fire, their
    lines' starts and newlines gathered."""
    K = nl.numel()
    keep = (verdicts ^ bool(invert)) & (ords >= first) & (ords < end)
    fire = torch.zeros(K, dtype=torch.bool, device=nl.device)
    line = (ords >= 0) & (ords < K)        # a value past 0..K-1: no line
    fire[ords[line]] = keep[line]
    j = torch.nonzero(fire).flatten()
    if not rows:
        return None, j.numel()
    start = torch.where(j > 0, nl[(j - 1).clamp(min=0)] + 1,
                        torch.zeros_like(j))
    pos = torch.stack([j, start, nl[j]], 1)
    if glitch >= 0:
        pos[:, 1:] -= (pos[:, 1:] > glitch).to(torch.int64)
    return pos, j.numel()


def _rows_bind():
    lib = _cuda.load("line_rows")
    if not getattr(lib, "_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ip = ctypes.POINTER(ctypes.c_int)
        lib.line_rows_launch.restype = i
        lib.line_rows_launch.argtypes = [p, p, p, ll, i, ll, ll, ll, p, p,
                                         i, p]
        lib.line_rows_geometry.restype = i
        lib.line_rows_geometry.argtypes = [i, ip, ip, ip]
        lib.line_rows_error_string.restype = ctypes.c_char_p
        lib.line_rows_error_string.argtypes = [i]
        lib._bound = True
    return lib


@functools.lru_cache(maxsize=None)
def _rows_geometry(index: int, rows: bool) -> tuple:
    """(threads a block, lines a thread's piece, blocks the device holds
    at once) of the kernel's rows form or count form."""
    return _cuda.query(_rows_bind(), "line_rows", "line_rows_geometry",
                       index, 3, int(rows))


def rows_blocks(K: int, threads: int, piece: int, max_blocks: int) -> int:
    """Blocks of a launch of csrc/line_rows.cu over K lines: one piece of
    `piece` lines a thread at most, no more than max_blocks."""
    return max(1, min(max_blocks, -(-K // (piece * threads))))


def rows_grid(K: int, rows: bool, device) -> int:
    """Blocks of line_rows' launch over K lines on the device."""
    return rows_blocks(K, *_rows_geometry(_cuda.device_index(device), rows))


def _rows_call(name: str, verdicts, ords, nl, args, out,
               grid) -> torch.Tensor:
    """The kernel's one launch on the verdicts' device and current stream
    (`name` labels it for timing.pass_split): the rows into out where it
    is not None; returns the scratch tensor that holds R at [grid]."""
    lib = _rows_bind()
    dev, K = nl.device, nl.numel()
    scratch = torch.empty(grid + 1 + -(-K // 64), dtype=torch.int64,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(_cuda.device_index(dev)), trace.span("launch"):
        _cuda.check(lib, "line_rows", lib.line_rows_launch(
            verdicts.data_ptr(), ords.data_ptr(), nl.data_ptr(), K, *args,
            None if out is None else out.data_ptr(), scratch.data_ptr(),
            grid, stream), name + " launch")
    return scratch


def rows_passes(verdicts, ords, nl, invert, first, end, glitch,
                out) -> None:
    """The kernel's launch into out, an earlier call's rows of the same
    lines (None for a count): its device work without the host's read of
    the count (for timing it on the card)."""
    K = nl.numel()
    if K:
        _rows_call("rows" if out is not None else "count", verdicts, ords,
                   nl, (int(invert), first, end, glitch), out,
                   rows_grid(K, out is not None, nl.device))


def _rows_launch(verdicts, ords, nl, invert, first, end, glitch,
                 rows) -> tuple:
    """The kernel's one launch on the verdicts' device, the rows
    allocated at K (R <= K: never a second launch), then the host's one
    read of the count."""
    dev, K = nl.device, nl.numel()
    if K == 0:
        return (torch.empty((0, 3), dtype=torch.int64, device=dev)
                if rows else None), 0
    out = torch.empty((K, 3), dtype=torch.int64, device=dev) if rows \
        else None
    grid = rows_grid(K, rows, dev)
    scratch = _rows_call("rows" if rows else "count", verdicts, ords, nl,
                         (int(invert), first, end, glitch), out, grid)
    R = read(scratch[grid])
    launches["line_rows"] += 1
    return (out[:R] if rows else None), R
