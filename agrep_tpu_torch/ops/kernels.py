"""The mask-machine kernel: wrapper, plain PyTorch version, readback.

mask_scan() runs the windowed shift-or mask machine of ops/scan.py over a
flat u8 text tensor and returns bit-packed planes.  On a CUDA tensor it
launches the hand-written Hopper kernel csrc/mask_scan.cu (built and
loaded by ops/_cuda.py) or raises; on a CPU tensor it runs
mask_scan_reference(), the plain PyTorch version of the same function.

Planes: u32 [1 + n_hit, T, n_words] with T = ceil(N/L) tiles and
n_words = ceil((W+L)/32); bit j of word w is window column 32*w + j, and
window column j of tile t holds text[t*L - W + j] (0 outside the text).
Plane 0 marks "delimiter completed" (new[0] & d_endpos, bitap only);
planes 1.. mark hits: one per endpos bit when a bitap endpos has several
bits, else one plane for the whole of endpos.  Bits past column W+L-1
are 0.

The kernel splits each tile's words over s threads (subtile_plan); the
wrapper picks s with choose_split: 1 for a machine whose dependence
window is unbounded, else the least s with which every SM holds
FILL_THREADS_PER_SM threads at once.  A block stages its tiles' bytes in
shared memory, so the threads an SM holds grow with s.

event_pairs() reads the planes back as sparse (position, event word)
pairs in stream order: on a CUDA tensor through csrc/event_pairs.cu (one
cooperative launch), so that only the pairs cross to the host, on a CPU
tensor through event_pairs_reference().  planes_to_events() is the dense
host read-back that agrep_tpu runs, kept as the plain form the tests
compare with.

record_verdicts() cuts the same events into the bitap engine's records
straight from the planes, without writing a pair, and returns only the
rows of the records that fire: on a CUDA tensor through
csrc/record_verdicts.cu (one cooperative launch), on a CPU tensor
through record_verdicts_reference(), which is pair_records_reference()
over event_pairs_reference()'s pairs.

Both kernels allocate their output at a capacity before the launch and
read its true size once after it; past the capacity they launch again at
the exact size (counted in `relaunches`).
"""

from __future__ import annotations

import ctypes
import functools
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from . import _cuda
from ..runtime import trace

MAX_D = 8
MAX_PLANES = 32
_VARIANT_CODE = {"sgrep": 0, "bitap": 1}     # the cost wiring is code 2

# Sub-tile splits the wrapper chooses from, the tiles a block takes, and
# the threads an SM must hold at once for a split to count as filling the
# card (tools/torch_mask_scan_time.py measures the candidates).
SPLITS = (1, 2, 4, 8)
TILES_PER_BLOCK = 32
FILL_THREADS_PER_SM = 1536
# an H100 SM: 228 KB of shared memory, of which each block also takes
# the 1 KB mask table and 1 KB the runtime reserves; 2048 threads and
# 32 blocks at most
SM_SHARED_BYTES = 233472
BLOCK_SHARED_EXTRA = 2048
SM_THREADS = 2048
SM_BLOCKS = 32

# Launches of each kernel since the counts were last set to 0.
launches = {"mask_scan": 0, "event_pairs": 0, "record_verdicts": 0}
# Second launches of the stages whose output outgrew the capacity they
# allocated before the first (event_pairs' pairs, record_verdicts' rows).
relaunches = {"event_pairs": 0, "record_verdicts": 0}


@dataclass(frozen=True)
class Machine:
    """A compiled mask machine as the kernel takes it."""
    table: torch.Tensor           # u32[256] on the scan device
    D: int
    variant: str                  # "bitap" | "sgrep"
    costs: tuple | None           # (I, S, DD) asearch1 wiring, bitap only
    init0: int
    init1_ns: int
    noerr: int
    d_endpos: int
    d_mask: int
    hit_masks: tuple              # one endpos mask per hit plane


def _u32(v) -> int:
    return int(v) & 0xFFFFFFFF


def machine_from_arrays(mask_table, consts: dict, D: int,
                        variant: str = "bitap", costs=None,
                        device="cpu") -> Machine:
    """Kernel inputs from a compiled query's arrays: the folded mask
    table (numpy u32[256]) and the consts dict of
    bitword.machine_constants (bitap) or {'endpos', 'm'} (sgrep).  The
    sgrep machine takes no costs and only endpos."""
    if variant not in _VARIANT_CODE:
        raise ValueError("unknown mask-machine variant %r" % (variant,))
    if not 0 <= int(D) <= MAX_D:
        raise ValueError("D=%r outside 0..%d" % (D, MAX_D))
    table = np.ascontiguousarray(np.asarray(mask_table, dtype=np.uint32))
    if table.shape != (256,):
        raise ValueError("mask table must be u32[256], got %r"
                         % (table.shape,))
    endpos = _u32(consts.get("endpos", 0))
    bits = tuple(1 << b for b in range(32) if endpos >> b & 1)
    multi = variant == "bitap" and len(bits) > 1
    return Machine(
        table=upload(torch.from_numpy(table.copy()), device),
        D=int(D), variant=variant,
        costs=(tuple(int(c) for c in costs)
               if costs is not None and variant == "bitap" else None),
        init0=_u32(consts.get("init0", 0)),
        init1_ns=_u32(consts.get("init1_ns", 0)),
        noerr=_u32(consts.get("noerr", 0)),
        d_endpos=_u32(consts.get("d_endpos", 0)),
        d_mask=_u32(consts.get("d_mask", 0xFFFFFFFF)),
        hit_masks=bits if multi else (endpos,))


def host_tensor(text: np.ndarray) -> torch.Tensor:
    """u8[N] numpy (possibly read-only, e.g. a file mapping) as a host
    tensor over the same bytes.  The scan only reads it."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(np.ascontiguousarray(text, dtype=np.uint8))


def to_device(text: np.ndarray, device) -> torch.Tensor:
    """u8[N] numpy (host_tensor's) -> tensor on device."""
    return upload(host_tensor(text), device)


def upload(t: torch.Tensor, device) -> torch.Tensor:
    """The host tensor t on device: a host-to-card copy (an `upload`
    span of its bytes, runtime/trace.py)."""
    with trace.span("upload", t.numel() * t.element_size()):
        return t.to(device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """t as a numpy array on the host: a read that waits for the card (a
    `readback` span of its bytes)."""
    with trace.span("readback", t.numel() * t.element_size()):
        return t.cpu().numpy()


def read(t: torch.Tensor):
    """t.tolist(): a scalar, or a list of Python numbers, read from the
    card (a `readback` span of its bytes)."""
    with trace.span("readback", t.numel() * t.element_size()):
        return t.tolist()


def geometry(N: int, W: int, L: int) -> tuple:
    """(T, n_words) of a scan of N bytes."""
    return max(1, -(-N // L)), -(-(W + L) // 32)


def subtile_plan(W: int, L: int, n_words: int, s: int) -> list:
    """[(start column, first word, end word)] of each of a tile's s
    sub-tiles, as csrc/mask_scan.cu's plan_word computes them.

    Sub-tile 0 emits words [0, w_1) from a cold start at column 0, so it
    must cover the halo (32*w_1 >= W); sub-tile i > 0 emits [w_i, w_i+1)
    after a cold start at column 32*w_i - W.  Sub-tile 0 takes about
    ceil(W/32) words more than the others, since they spend W columns
    warming up.  Raises ValueError for an s that leaves a sub-tile no
    word."""
    if n_words != -(-(W + L) // 32):
        raise ValueError("n_words=%d is not ceil((W+L)/32) for W=%d L=%d"
                         % (n_words, W, L))
    h = -(-W // 32)
    X = n_words + (s - 1) * h

    def word(i):
        return 0 if i <= 0 else i * X // s - (i - 1) * h
    bounds = [word(i) for i in range(s + 1)]
    if s < 1 or any(b <= a for a, b in zip(bounds, bounds[1:])) \
            or (s > 1 and 32 * bounds[1] < W):
        raise ValueError("no plan of %d sub-tiles for W=%d, %d words"
                         % (s, W, n_words))
    return [(0 if i == 0 else 32 * bounds[i] - W, bounds[i], bounds[i + 1])
            for i in range(s)]


def bounded(m: Machine) -> bool:
    """True when a cold start W columns early gives the machine's exact
    state (no sticky bits), as ops/scan.py's streaming halos assume:
    the sgrep machine, or bitap with init1_ns == init0."""
    return m.variant == "sgrep" or m.init1_ns == m.init0


def shared_bytes(W: int, L: int, s: int, tpb: int, n_hit: int) -> int:
    """Dynamic shared memory of one block, as csrc/mask_scan.cu's
    smem_bytes counts it: the staged bytes of tpb tiles (15 bytes of
    alignment before them, 8 after) with one word of skew every row of
    L/4 words, and n_hit - 1 accumulator words a thread."""
    rs = 5
    while rs < 30 and (1 << (rs + 1)) <= L // 4:
        rs += 1
    q = (15 + (tpb - 1) * L + W + L + 8 + 15) // 16 * 4
    planes = (n_hit - 1) * s * tpb if n_hit > 1 else 0
    return 4 * (q + (q >> rs) + 1 + planes)


def busy_threads(T: int, W: int, L: int, s: int, tpb: int, n_hit: int,
                 n_sm: int) -> float:
    """Threads an SM holds at once in a launch of T tiles split s ways:
    as many blocks as its shared memory, threads and block slots allow,
    and no more than the launch's T*s threads over n_sm SMs."""
    threads = s * tpb
    blocks = min(SM_BLOCKS, SM_THREADS // threads,
                 SM_SHARED_BYTES // (shared_bytes(W, L, s, tpb, n_hit)
                                     + BLOCK_SHARED_EXTRA))
    return min(blocks * threads, T * s / n_sm)


def choose_split(m: Machine, T: int, W: int, L: int, n_sm: int,
                 tpb: int = TILES_PER_BLOCK) -> int:
    """Sub-tiles a tile for a launch of T tiles on n_sm SMs: 1 for an
    unbounded machine; else the least split in SPLITS with which every SM
    holds FILL_THREADS_PER_SM threads at once, or, where none does, the
    one with which it holds the most."""
    if not bounded(m):
        return 1
    n_words = -(-(W + L) // 32)
    best = None
    for s in SPLITS:
        try:
            subtile_plan(W, L, n_words, s)
        except ValueError:
            continue
        busy = busy_threads(T, W, L, s, tpb, len(m.hit_masks), n_sm)
        if busy >= FILL_THREADS_PER_SM:
            return s
        if best is None or busy > best[0]:
            best = (busy, s)
    return best[1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_geometry(N: int, m: Machine, W: int, L: int, device,
                    s: int | None = None, tpb: int | None = None) -> dict:
    """What _launch runs for a scan of N bytes on a CUDA device: split,
    tiles a block, threads a block, blocks, dynamic shared bytes a
    block."""
    T, _ = geometry(N, W, L)
    if tpb is None:
        tpb = TILES_PER_BLOCK
    if s is None:
        s = choose_split(m, T, W, L,
                         _sm_count(_cuda.device_index(device)), tpb)
    return {"s": s, "tiles_per_block": tpb, "threads": s * tpb,
            "blocks": -(-T // tpb),
            "smem_bytes": shared_bytes(W, L, s, tpb, len(m.hit_masks))}


def mask_scan(text: torch.Tensor, m: Machine, W: int, L: int
              ) -> torch.Tensor:
    """Packed planes of the mask machine over text (see module
    docstring).  A CUDA tensor goes to the kernel, a CPU tensor to
    mask_scan_reference."""
    if text.dtype != torch.uint8 or text.dim() != 1:
        raise TypeError("text must be a 1-D uint8 tensor, got %s %r"
                        % (text.dtype, tuple(text.shape)))
    if not text.is_contiguous():
        raise ValueError("text must be contiguous")
    if text.device != m.table.device:
        raise ValueError("text on %s but the machine on %s"
                         % (text.device, m.table.device))
    if text.numel() == 0:
        raise ValueError("empty text")
    if not 0 <= W <= L:
        raise ValueError("halo W=%d must lie in [0, L=%d]" % (W, L))
    if text.is_cuda:
        return _launch(text, m, W, L)
    if text.device.type == "cpu":
        return mask_scan_reference(text, m, W, L)
    raise ValueError("no mask-scan kernel for device %s" % text.device)


def _bind():
    lib = _cuda.load("mask_scan")
    if not getattr(lib, "_bound", False):
        p, i, u, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                       ctypes.c_longlong)
        lib.mask_scan_launch.restype = i
        lib.mask_scan_launch.argtypes = [
            p, ll, p, p, ll, i, i, i, i, u, u, u, u, u, u, i, i, i, i,
            ctypes.POINTER(ctypes.c_int), i, i, p]
        lib.mask_scan_error_string.restype = ctypes.c_char_p
        lib.mask_scan_error_string.argtypes = [i]
        lib._bound = True
    return lib


def _launch(text: torch.Tensor, m: Machine, W: int, L: int,
            s: int | None = None, tpb: int | None = None) -> torch.Tensor:
    """The kernel on text's device; s and tpb (sub-tiles a tile, tiles a
    block) default to launch_geometry's choice."""
    lib = _bind()
    N = text.numel()
    T, n_words = geometry(N, W, L)
    geo = launch_geometry(N, m, W, L, text.device, s, tpb)
    n_hit = len(m.hit_masks)
    out = torch.empty((1 + n_hit, T, n_words), dtype=torch.uint32,
                      device=text.device)
    code = _VARIANT_CODE[m.variant]
    ci = cs = cd = 0
    if m.costs is not None:
        code = 2
        ci, cs, cd = m.costs
    pos = (ctypes.c_int * MAX_PLANES)(
        *[hm.bit_length() - 1 for hm in m.hit_masks])
    stream = torch.cuda.current_stream(text.device).cuda_stream
    # the runtime launches on its current device: make it the tensor's
    index = _cuda.device_index(text.device)
    with torch.cuda.device(index), trace.span("launch"):
        err = lib.mask_scan_launch(
            text.data_ptr(), N, m.table.data_ptr(), out.data_ptr(), T, W, L,
            m.D, code, m.init0, m.init1_ns, m.noerr, m.d_endpos, m.d_mask,
            m.hit_masks[0], ci, cs, cd, n_hit, pos, geo["s"],
            geo["tiles_per_block"], stream)
    if err != 0:
        raise RuntimeError("mask_scan kernel launch failed: %s (%d)"
                           % (lib.mask_scan_error_string(err).decode(),
                              err))
    launches["mask_scan"] += 1
    return out


def _init_levels(m: Machine) -> list:
    if m.variant == "bitap":
        return [m.init0] * (m.D + 1)
    lv = [0]
    for _ in range(m.D):
        lv.append(((lv[-1] >> 1) | lv[-1] | 0x80000000) & 0xFFFFFFFF)
    return lv


def _levels(m: Machine, s: list, cm):
    """One transition of every level; states are int64 holding u32
    values (CPU torch has no >>, << or ~ on uint32), and only >>, & and
    | touch them, so they stay below 2**32 without masking."""
    D = m.D
    if m.variant == "sgrep":
        new = [((s[0] >> 1) | 0x80000000) & cm]
        for k in range(1, D + 1):
            new.append((((s[k] >> 1) | 0x80000000) & cm) | s[k - 1]
                       | (((new[k - 1] | s[k - 1]) >> 1) | 0x80000000))
        return new
    init1, noerr = m.init1_ns, m.noerr
    if m.costs is None:
        new = [((s[0] >> 1) & cm) | (s[0] & init1)]
        for k in range(1, D + 1):
            new.append(((s[k] >> 1) & cm) | (s[k] & init1) | s[k - 1]
                       | (((new[k - 1] | s[k - 1]) >> 1) & noerr))
        return new
    ci, cs, cd = m.costs
    new = []
    for k in range(D + 1):
        r = ((s[k] >> 1) & cm) | (s[k] & init1)
        if k - ci >= 0:
            r = r | s[k - ci]
        err = None
        if k - cd >= 0:
            err = new[k - cd]
        if k - cs >= 0:
            err = s[k - cs] if err is None else err | s[k - cs]
        if err is not None:
            r = r | ((err >> 1) & noerr)
        new.append(r)
    return new


def mask_scan_reference(text: torch.Tensor, m: Machine, W: int, L: int
                        ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: vectorized
    over tiles, one Python step per window column.  Same planes as the
    kernel, bit for bit."""
    dev = text.device
    N = text.numel()
    T, n_words = geometry(N, W, L)
    S = W + L
    padded = torch.zeros(W + T * L, dtype=torch.uint8, device=dev)
    padded[W:W + N] = text
    halo = padded[:T * L].view(T, L)[:, :W]
    windows = torch.cat([halo, padded[W:].view(T, L)], dim=1)   # [T, S]
    cms = m.table.to(torch.int64)[windows.long()]               # [T, S]
    ini = _init_levels(m)
    ini_t = [torch.full((T,), v, dtype=torch.int64, device=dev)
             for v in ini]
    # the restart chain depends only on the column's mask: every column
    # at once
    rs = None
    if m.variant == "bitap" and m.d_endpos:
        rs = _levels(m, [torch.full_like(cms, v) for v in ini], cms)
        rs[0] = rs[0] & m.d_mask
    nl = windows == 0x0A
    n_hit = len(m.hit_masks)
    planes = torch.zeros((1 + n_hit, T, n_words), dtype=torch.int64,
                         device=dev)
    states = [x.clone() for x in ini_t]
    acc = [torch.zeros(T, dtype=torch.int64, device=dev)
           for _ in range(1 + n_hit)]
    for j in range(S):
        if j == W:
            for k in range(m.D + 1):
                states[k][0] = ini[k]
        cm = cms[:, j]
        if m.variant == "sgrep":
            if m.D > 0:
                states = [torch.where(nl[:, j], ini_t[k], states[k])
                          for k in range(m.D + 1)]
            new = _levels(m, states, cm)
            fin = new[m.D]
            states = new
        else:
            new = _levels(m, states, cm)
            fin = new[m.D]
            if rs is not None:
                trig = (new[0] & m.d_endpos) != 0
                states = [torch.where(trig, rs[k][:, j], new[k])
                          for k in range(m.D + 1)]
                acc[0] |= trig.long() << (j & 31)
            else:
                states = new
        for e, hm in enumerate(m.hit_masks):
            acc[1 + e] |= ((fin & hm) != 0).long() << (j & 31)
        if j & 31 == 31 or j == S - 1:
            for p in range(1 + n_hit):
                planes[p, :, j >> 5] = acc[p]
                acc[p] = torch.zeros_like(acc[p])
    return planes.to(torch.uint32)


# the planes event_pairs takes: the delimiter plane and MAX_PLANES hit
# planes
EVENT_PLANES = 1 + MAX_PLANES


def event_vals(m: Machine) -> list:
    """The event word each of mask_scan's planes adds to a column whose
    bit is set: d_endpos for plane 0 (0 for sgrep, whose events are the
    0/1 pulse), and each hit mask (1 for sgrep) for the hit planes."""
    if m.variant == "sgrep":
        return [0, 1]
    return [m.d_endpos] + list(m.hit_masks)


def _check_pairs_args(planes, vals, W: int, L: int, N: int,
                      keep_from: int) -> None:
    if planes.dtype != torch.uint32 or planes.dim() != 3:
        raise TypeError("planes must be a 3-D uint32 tensor, got %s %r"
                        % (planes.dtype, tuple(planes.shape)))
    if vals.dtype != torch.uint32 or vals.dim() != 1:
        raise TypeError("vals must be a 1-D uint32 tensor, got %s %r"
                        % (vals.dtype, tuple(vals.shape)))
    if not (planes.is_contiguous() and vals.is_contiguous()):
        raise ValueError("planes and vals must be contiguous")
    if planes.device != vals.device:
        raise ValueError("planes on %s but vals on %s"
                         % (planes.device, vals.device))
    P = planes.shape[0]
    if not 1 <= P <= EVENT_PLANES or vals.numel() != P:
        raise ValueError("%d planes and %d values: need 1..%d planes and "
                         "one value each" % (P, vals.numel(), EVENT_PLANES))
    if L < 32 or L % 32 or not 0 <= W <= L:
        raise ValueError("tile L=%d must be a multiple of 32 and the halo "
                         "W=%d lie in [0, L]" % (L, W))
    if N < 0 or keep_from < 0:
        raise ValueError("N=%d and keep_from=%d must not be negative"
                         % (N, keep_from))
    if tuple(planes.shape[1:]) != geometry(N, W, L):
        raise ValueError("planes %r are not [P, T, n_words] = [P, %d, %d] "
                         "of a scan of %d bytes"
                         % ((tuple(planes.shape),) + geometry(N, W, L)
                            + (N,)))


def event_pairs(planes: torch.Tensor, vals: torch.Tensor, W: int, L: int,
                N: int, keep_from: int = 0) -> tuple:
    """(pos int64[K], word uint32[K]) on the planes' device: one pair for
    each text position p in [keep_from, N) whose OR of vals[i] over the
    planes i with p's bit set is not 0, ascending by p (module
    docstring for the planes' layout).  A CUDA tensor goes to the kernel,
    a CPU tensor to event_pairs_reference."""
    _check_pairs_args(planes, vals, W, L, N, keep_from)
    if planes.is_cuda:
        return _pairs_launch(planes, vals, W, L, N, keep_from)
    if planes.device.type == "cpu":
        return event_pairs_reference(planes, vals, W, L, N, keep_from)
    raise ValueError("no event-pairs kernel for device %s" % planes.device)


def _pairs_bind():
    lib = _cuda.load("event_pairs")
    if not getattr(lib, "_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ip = ctypes.POINTER(ctypes.c_int)
        lib.event_pairs_launch.restype = i
        lib.event_pairs_launch.argtypes = [p, i, ll, i, p, i, i, ll, ll, p,
                                           p, ll, p, i, ll, p]
        lib.event_pairs_geometry.restype = i
        lib.event_pairs_geometry.argtypes = [i, ip, ip, ip]
        lib.event_pairs_error_string.restype = ctypes.c_char_p
        lib.event_pairs_error_string.argtypes = [i]
        lib._bound = True
    return lib


# event_pairs' pairs allocated before a launch: one a PAIRS_SHARE kept
# positions, at least PAIRS_MIN (the corpus has one pair in ~49 bytes)
PAIRS_MIN = 4096
PAIRS_SHARE = 16


def pairs_capacity(N: int, keep_from: int) -> int:
    """Pairs event_pairs allocates before its launch."""
    return max(PAIRS_MIN, max(N - keep_from, 0) // PAIRS_SHARE)


def plane_grid(N: int, keep_from: int, threads: int, max_blocks: int,
               step: int) -> tuple:
    """(blocks, stream words a warp) of a launch of csrc/event_pairs.cu
    or csrc/record_verdicts.cu over the stream words (32 positions each)
    from keep_from's to N's: at most max_blocks blocks of threads
    threads, each warp a run of a multiple of step words, no block
    without a word; (0, 0) when no position is kept."""
    if N <= keep_from:
        return 0, 0
    words = -(-N // 32) - keep_from // 32
    warps = threads // 32
    grid = min(max_blocks, -(-words // (step * warps)))
    warp_words = step * -(-words // (step * warps * grid))
    return -(-words // (warps * warp_words)), warp_words


@functools.lru_cache(maxsize=None)
def _pairs_geometry(index: int, n_planes: int) -> tuple:
    """(threads a block, blocks the device holds at once, stream words a
    warp's step) of event_pairs over n_planes planes."""
    return _cuda.query(_pairs_bind(), "event_pairs", "event_pairs_geometry",
                       index, 3, n_planes)


def pairs_grid(N: int, keep_from: int, n_planes: int, device) -> tuple:
    """(blocks, stream words a warp) of event_pairs' launch."""
    return plane_grid(N, keep_from, *_pairs_geometry(
        _cuda.device_index(device), n_planes))


def _pairs_call(name: str, planes, vals, W, L, N, keep_from, pos, word,
                scratch) -> None:
    """The kernel's one launch on the planes' device and current stream
    (`name` labels it for timing.pass_split): the pairs into pos and
    word, as many as they hold, and K into scratch[-1]."""
    lib = _pairs_bind()
    P, T, n_words = planes.shape
    grid, warp_words = pairs_grid(N, keep_from, P, planes.device)
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    with torch.cuda.device(_cuda.device_index(planes.device)), \
            trace.span("launch"):
        _cuda.check(lib, "event_pairs", lib.event_pairs_launch(
            planes.data_ptr(), P, T, n_words, vals.data_ptr(), W, L, N,
            keep_from, pos.data_ptr(), word.data_ptr(), pos.numel(),
            scratch.data_ptr(), grid, warp_words, stream), name + " launch")


def _pairs_run(name, planes, vals, W, L, N, keep_from, cap) -> tuple:
    """(pos, word, scratch) of one launch with the pairs allocated at cap;
    K is scratch[-1]."""
    dev = planes.device
    grid = pairs_grid(N, keep_from, planes.shape[0], dev)[0]
    pos = torch.empty(cap, dtype=torch.int64, device=dev)
    word = torch.empty(cap, dtype=torch.uint32, device=dev)
    scratch = torch.empty(grid + 1, dtype=torch.int64, device=dev)
    _pairs_call(name, planes, vals, W, L, N, keep_from, pos, word, scratch)
    return pos, word, scratch


def pairs_passes(planes, vals, W, L, N, keep_from, pos, word) -> None:
    """The kernel's launch into pos and word, which hold the K pairs of
    an earlier call: its device work without the host's read of K (for
    timing it on the card)."""
    if N <= keep_from:
        return
    grid = pairs_grid(N, keep_from, planes.shape[0], planes.device)[0]
    scratch = torch.empty(grid + 1, dtype=torch.int64, device=planes.device)
    _pairs_call("pairs", planes, vals, W, L, N, keep_from, pos, word,
                scratch)


def _pairs_launch(planes, vals, W, L, N, keep_from,
                  capacity: int | None = None) -> tuple:
    """The kernel on the planes' device, its pairs allocated at capacity
    (pairs_capacity by default), then the host's one read of K; a second
    launch at capacity K where K exceeds it (counted in relaunches)."""
    dev = planes.device
    if N <= keep_from:
        return (torch.empty(0, dtype=torch.int64, device=dev),
                torch.empty(0, dtype=torch.uint32, device=dev))
    cap = pairs_capacity(N, keep_from) if capacity is None else capacity
    pos, word, scratch = _pairs_run("pairs", planes, vals, W, L, N,
                                    keep_from, cap)
    K = read(scratch[-1])
    launches["event_pairs"] += 1
    if K > cap:
        pos, word, _ = _pairs_run("relaunch", planes, vals, W, L, N,
                                  keep_from, K)
        relaunches["event_pairs"] += 1
    return pos[:K], word[:K]


def event_pairs_reference(planes: torch.Tensor, vals: torch.Tensor, W: int,
                          L: int, N: int, keep_from: int = 0) -> tuple:
    """Plain PyTorch version of the kernel, on any device: the nonzero
    words of the OR of the planes whose value is not 0, expanded to
    their 32 columns.  Words are int64 holding u32 values (CPU torch has
    no >> on uint32)."""
    dev = planes.device
    v = [int(x) & 0xFFFFFFFF for x in vals.tolist()]
    active = [i for i, x in enumerate(v) if x]
    if not active or N <= keep_from:
        return (torch.empty(0, dtype=torch.int64, device=dev),
                torch.empty(0, dtype=torch.uint32, device=dev))
    # [T, nw] each; CUDA has no advanced indexing of uint32
    words = [planes[i].to(torch.int64) & 0xFFFFFFFF for i in active]
    any_w = words[0]
    for w in words[1:]:
        any_w = any_w | w
    nz = torch.nonzero(any_w)                                # [M, 2]
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    ev = torch.zeros((len(nz), 32), dtype=torch.int64, device=dev)
    for k, i in enumerate(active):
        bits = (words[k][nz[:, 0], nz[:, 1]][:, None] >> shifts) & 1
        ev = ev | bits * v[i]
    col = nz[:, 1:] * 32 + shifts                            # [M, 32]
    pos = nz[:, :1] * L + col - W
    keep = ((ev != 0) & (col >= W) & (col < W + L) & (pos < N)
            & (pos >= keep_from))
    return pos[keep], ev[keep].to(torch.uint32)


def record_verdicts(planes: torch.Tensor, vals: torch.Tensor, W: int,
                    L: int, N: int, keep_from: int, endpos: int,
                    d_endpos: int, skip_pos: int = -1,
                    and_flag: bool = False, invert: bool = False,
                    acc: int = 0, capacity: int | None = None) -> tuple:
    """The records of a stream's events that fire, as the bitap engine
    cuts them, from mask_scan's planes: (rows int64 [R, 3] on the
    planes' device, summary).

    The events are event_pairs(planes, vals, W, L, N, keep_from)'s
    pairs, never written.  The event at skip_pos (the glitch byte, or -1)
    is dropped first.  An event ORs word & endpos into its record's acc,
    and an event with word & d_endpos set ends the record (its own hit
    counts in it).  A record fires when, with and_flag, (acc & endpos) ==
    endpos or invert, and else when (acc != 0) ^ invert.  acc is the
    carry from the stream's earlier events: the hit bits since their
    last record end.

    Each row is (ordinal of the record's end among this call's ends, the
    end's position, the position of the end before it or -1), in stream
    order.  summary = (record ends, last end's position or -1, the hit
    bits after it: the next call's acc, the events: the pairs event_pairs
    would give).  A CUDA tensor goes to the kernel, its rows allocated at
    capacity (rows_capacity(N) by default); a CPU tensor to
    record_verdicts_reference."""
    _check_pairs_args(planes, vals, W, L, N, keep_from)
    args = _records_args(endpos, d_endpos, skip_pos, and_flag, invert, acc)
    if planes.is_cuda:
        return _records_launch(planes, vals, W, L, N, keep_from, *args,
                               capacity=capacity)
    if planes.device.type == "cpu":
        return record_verdicts_reference(planes, vals, W, L, N, keep_from,
                                         *args)
    raise ValueError("no record-verdicts kernel for device %s"
                     % planes.device)


def _records_args(endpos, d_endpos, skip_pos, and_flag, invert,
                  acc) -> tuple:
    """The scalar arguments as the kernel takes them: u32 masks, the acc
    held to endpos' bits."""
    return (_u32(endpos), _u32(d_endpos), int(skip_pos), int(and_flag),
            int(invert), _u32(acc) & _u32(endpos))


# record_verdicts' rows allocated before a launch: twice the rows of the
# stream's previous chunk, at least ROWS_MIN; on a first chunk one a
# ROWS_SHARE bytes, at least ROWS_MIN
ROWS_MIN = 1024
ROWS_SHARE = 1024


def rows_capacity(N: int, prev_rows: int | None = None) -> int:
    """Rows record_verdicts allocates before its launch over a chunk of N
    bytes, after a chunk of prev_rows rows (None: the stream's first)."""
    if prev_rows is None:
        return max(ROWS_MIN, N // ROWS_SHARE)
    return max(ROWS_MIN, 2 * prev_rows)


def _records_bind():
    lib = _cuda.load("record_verdicts")
    if not getattr(lib, "_bound", False):
        p, i, u, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                       ctypes.c_longlong)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.record_verdicts_launch.restype = i
        lib.record_verdicts_launch.argtypes = [
            p, i, ll, i, p, i, i, ll, ll, u, u, ll, i, i, u, p, ll, p, i, ll,
            p]
        lib.record_verdicts_geometry.restype = i
        lib.record_verdicts_geometry.argtypes = [i, ip, ip, ip, ip]
        lib.record_verdicts_error_string.restype = ctypes.c_char_p
        lib.record_verdicts_error_string.argtypes = [i]
        lib._bound = True
    return lib


@functools.lru_cache(maxsize=None)
def _records_geometry(index: int, n_planes: int) -> tuple:
    """(threads a block, blocks the device holds at once, stream words a
    warp's step) of record_verdicts over n_planes planes."""
    return _cuda.query(_records_bind(), "record_verdicts",
                       "record_verdicts_geometry", index, 4, n_planes)[:3]


def records_grid(N: int, keep_from: int, n_planes: int, device) -> tuple:
    """(blocks, stream words a warp) of record_verdicts' launch."""
    return plane_grid(N, keep_from, *_records_geometry(
        _cuda.device_index(device), n_planes))


def _records_call(name: str, planes, vals, W, L, N, keep_from, args, rows,
                  scratch) -> None:
    """The kernel's one launch on the planes' device and current stream
    (`name` labels it for timing.pass_split): the rows into rows, as
    many as it holds, and the summary into scratch[-5:]."""
    lib = _records_bind()
    P, T, n_words = planes.shape
    grid, warp_words = records_grid(N, keep_from, P, planes.device)
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    with torch.cuda.device(_cuda.device_index(planes.device)), \
            trace.span("launch"):
        _cuda.check(lib, "record_verdicts", lib.record_verdicts_launch(
            planes.data_ptr(), P, T, n_words, vals.data_ptr(), W, L, N,
            keep_from, *args, rows.data_ptr(), rows.shape[0],
            scratch.data_ptr(), grid, warp_words, stream), name + " launch")


def _records_run(name, planes, vals, W, L, N, keep_from, args,
                 cap) -> tuple:
    """(rows, scratch) of one launch with the rows allocated at cap; the
    summary is scratch[-5:]."""
    dev = planes.device
    grid = records_grid(N, keep_from, planes.shape[0], dev)[0]
    rows = torch.empty((cap, 3), dtype=torch.int64, device=dev)
    scratch = torch.empty(5 * grid + 5, dtype=torch.int64, device=dev)
    _records_call(name, planes, vals, W, L, N, keep_from, args, rows,
                  scratch)
    return rows, scratch


def records_passes(planes, vals, W, L, N, keep_from, endpos, d_endpos,
                   skip_pos, and_flag, invert, acc, rows) -> None:
    """The kernel's launch into rows, which holds the rows of an earlier
    call on the same planes: its device work without the host's read of
    the summary (for timing it on the card)."""
    if N <= keep_from:
        return
    args = _records_args(endpos, d_endpos, skip_pos, and_flag, invert, acc)
    grid = records_grid(N, keep_from, planes.shape[0], planes.device)[0]
    scratch = torch.empty(5 * grid + 5, dtype=torch.int64,
                          device=planes.device)
    _records_call("records", planes, vals, W, L, N, keep_from, args, rows,
                  scratch)


def _records_launch(planes, vals, W, L, N, keep_from, endpos, d_endpos,
                    skip_pos, and_flag, invert, acc,
                    capacity: int | None = None) -> tuple:
    """The kernel on the planes' device, its rows allocated at capacity
    (rows_capacity(N) by default), then the host's one read of the
    summary; a second launch with the exact rows where they exceed it
    (counted in relaunches)."""
    dev = planes.device
    args = _records_args(endpos, d_endpos, skip_pos, and_flag, invert, acc)
    if N <= keep_from:
        return torch.empty((0, 3), dtype=torch.int64, device=dev), \
            (0, -1, args[-1], 0)
    cap = rows_capacity(N) if capacity is None else capacity
    rows, scratch = _records_run("records", planes, vals, W, L, N,
                                 keep_from, args, cap)
    n_ends, last, acc_out, R, pairs = read(scratch[-5:])
    launches["record_verdicts"] += 1
    if R > cap:
        rows, _ = _records_run("relaunch", planes, vals, W, L, N, keep_from,
                               args, R)
        relaunches["record_verdicts"] += 1
    return rows[:R], (n_ends, last, acc_out, pairs)


def record_verdicts_reference(planes: torch.Tensor, vals: torch.Tensor,
                              W: int, L: int, N: int, keep_from: int,
                              endpos: int, d_endpos: int,
                              skip_pos: int = -1, and_flag: bool = False,
                              invert: bool = False, acc: int = 0) -> tuple:
    """Plain PyTorch version of the kernel, on any device: the pairs of
    event_pairs_reference cut by pair_records_reference, and their
    number."""
    pos, word = event_pairs_reference(planes, vals, W, L, N, keep_from)
    rows, summary = pair_records_reference(pos, word, endpos, d_endpos,
                                           skip_pos, and_flag, invert, acc)
    return rows, summary + (pos.numel(),)


def pair_records_reference(pos: torch.Tensor, word: torch.Tensor,
                           endpos: int, d_endpos: int, skip_pos: int = -1,
                           and_flag: bool = False, invert: bool = False,
                           acc: int = 0) -> tuple:
    """record_verdicts' cut of event pairs (pos, word), ascending, in
    plain PyTorch on any device, with its rows and its summary less the
    events: each pair's record is the number of record ends before it,
    and a record's acc is the OR of its pairs' hit bits, taken a bit of
    endpos at a time by a scatter_reduce.  Words are int64 holding u32
    values (CPU torch has no >> on uint32)."""
    dev = pos.device
    endpos, d_endpos = _u32(endpos), _u32(d_endpos)
    keep = pos != skip_pos
    p = pos[keep]
    w = word.to(torch.int64)[keep] & 0xFFFFFFFF
    is_end = (w & d_endpos) != 0
    ends = torch.nonzero(is_end).flatten()
    E = ends.numel()
    before = torch.cumsum(is_end.to(torch.int64), 0) - is_end.to(torch.int64)
    accs = torch.zeros(E + 1, dtype=torch.int64, device=dev)
    accs[0] = _u32(acc) & endpos
    for b in range(32):
        if endpos >> b & 1:
            bit = (w >> b) & 1
            anyb = torch.zeros(E + 1, dtype=torch.int64, device=dev)
            anyb.scatter_reduce_(0, before, bit, "amax")
            accs |= anyb << b
    rec = accs[:E]
    if and_flag:
        fire = ((rec & endpos) == endpos) | bool(invert)
    else:
        fire = (rec != 0) ^ bool(invert)
    k = torch.nonzero(fire).flatten()
    end_pos = p[ends]
    prev = torch.cat([torch.full((1,), -1, dtype=torch.int64, device=dev),
                      end_pos[:-1]])
    rows = torch.stack([k, end_pos[k], prev[k]], 1)
    last = int(end_pos[-1].item()) if E else -1
    return rows, (E, last, int(accs[E].item()))


def planes_to_events(delim_p: np.ndarray, hit_p: np.ndarray,
                     consts: dict, W: int, L: int, N: int) -> np.ndarray:
    """Rebuild the dense u32 event stream from packed bit planes.

    Work is O(set bits): only words with any event touch the output.
    Valid when endpos is a single bit (the hit plane cannot say WHICH
    part bit fired); callers gate on that."""
    d_endpos = np.uint32(consts.get("d_endpos", 0))
    endpos = np.uint32(consts.get("endpos", 0))
    events = np.zeros(N, dtype=np.uint32)
    for plane, val in ((delim_p, d_endpos), (hit_p, endpos)):
        if val == 0:
            continue
        # u32 words -> per-column bits, LSB first (bit j of word w is
        # column w*32+j); drop the cold-start halo columns, flatten to
        # stream order.  Three vectorized passes over ~N bytes.
        bits = np.unpackbits(
            np.ascontiguousarray(plane).view(np.uint8)
            .reshape(plane.shape[0], -1),
            axis=1, bitorder="little")
        sel = bits[:, W:W + L].reshape(-1)[:N] != 0
        events[sel] |= val
    return events
