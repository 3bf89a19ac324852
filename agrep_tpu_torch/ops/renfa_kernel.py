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
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import _cuda, renfa
from .kernels import _sm_count

MAX_D = 4                       # compile/query.py's late error caps D
_CELLS = 1 << 24                # plain version: lane cells per pass

# Forms of the kernel's Next tables (csrc/renfa_lanes.cu): one table of
# 2^(M-1) words, or four byte tables.
FORMS = {"one": 0, "bytes": 1}
MAX_ONE_BITS = 15               # one table: at most 2^15 words, 128 KB
# Threads a block; tools/torch_renfa_lanes_time.py times both forms,
# every block size and blocks an SM at the main path's shapes.
THREADS = 512

# Launches of each kernel since the counts were last set to 0.
launches = {"renfa_lanes": 0}


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
        tables=torch.from_numpy(np.ascontiguousarray(tables)).to(device),
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
    if bool(((starts < 0) | (lens < 0)
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
    with torch.cuda.device(index):
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


def renfa_lines_reference(text: torch.Tensor, starts: torch.Tensor,
                          lens: torch.Tensor, m: RegexMachine, init
                          ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the lines
    bucketed by length (renfa.MAXLINE_BUCKETS), each bucket vectorized
    over its lines with one Python step per column.  nxt is gathered
    from the same four byte tables as the kernel's.  States are int64
    holding u32 values (CPU torch has no >>, << or ~ on uint32); only
    >>, & and | touch them, so they stay below 2**32."""
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
