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
"""

from __future__ import annotations

import ctypes
import functools
import warnings
from dataclasses import dataclass

import numpy as np
import torch

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
launches = {"mask_scan": 0}


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
        table=torch.from_numpy(table.copy()).to(device),
        D=int(D), variant=variant,
        costs=(tuple(int(c) for c in costs)
               if costs is not None and variant == "bitap" else None),
        init0=_u32(consts.get("init0", 0)),
        init1_ns=_u32(consts.get("init1_ns", 0)),
        noerr=_u32(consts.get("noerr", 0)),
        d_endpos=_u32(consts.get("d_endpos", 0)),
        d_mask=_u32(consts.get("d_mask", 0xFFFFFFFF)),
        hit_masks=bits if multi else (endpos,))


def to_device(text: np.ndarray, device) -> torch.Tensor:
    """u8[N] numpy (possibly read-only, e.g. a file mapping) -> tensor
    on device.  The scan only reads it."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        t = torch.from_numpy(np.ascontiguousarray(text, dtype=np.uint8))
    return t.to(device)


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
    dev = torch.device(device)
    if tpb is None:
        tpb = TILES_PER_BLOCK
    if s is None:
        s = choose_split(m, T, W, L, _sm_count(dev.index or 0), tpb)
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
    from . import _cuda
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
