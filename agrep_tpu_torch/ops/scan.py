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

Output: a uint32 event word per input byte; bit layout equals the mask
machine's word (delimiter bit = d_endpos, part pulses = endposition
bits).  For 'sgrep', bit 0 = match pulse.
"""

from __future__ import annotations

import os

import numpy as np

DEFAULT_TILE = 1024

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


def scan_events(text: np.ndarray, mask_table: np.ndarray, consts: dict,
                D: int, variant: str = "bitap",
                costs: tuple | None = None,
                tile: int = DEFAULT_TILE) -> np.ndarray:
    """Scan a byte stream; returns a uint32 event word per byte.

    text: uint8[N] (host); mask_table: uint32[256] (pre-folded);
    consts: dict from bitword.machine_constants (bitap) or
    {'endpos': final-bit, 'm': m} (sgrep).
    """
    N = int(text.shape[0])
    if N == 0:
        return np.zeros(0, dtype=np.uint32)
    from ..runtime import trace
    if trace.ENABLED:
        trace.add("device_scans")
        trace.add("scan_bytes", N)
    m = consts.get("m", 32)
    W = min(max(m + D + 2, 48), tile)
    L = tile
    if _BACKEND == "torch":
        if trace.ENABLED:
            trace.add("kernel_scans")
        return _scan_torch(text, mask_table, consts, D, W, L, N, variant,
                           costs)
    if _BACKEND != "numpy":
        raise ValueError("AGREP_TORCH_BACKEND must be one of %s, got %r"
                         % (BACKENDS, _BACKEND))
    if N >= (1 << 20):
        # sequential C twin of the windowed machine: exact whenever
        # the dependence window is bounded (no sticky/wildcard bits,
        # i.e. init1_ns == init0; the sgrep machine is always bounded)
        bounded = (variant == "sgrep"
                   or consts.get("init1_ns") == consts.get("init0"))
        if bounded:
            from .. import native
            pairs = native.bitap_scan_events(text, mask_table, consts,
                                             D, variant, costs)
            if pairs is not None:
                pos, words = pairs
                ev_out = np.zeros(N, dtype=np.uint32)
                ev_out[pos] = words
                return ev_out
    windows, T = _pad_and_window(text, W, L)
    cvec = np.asarray([
        consts.get("init0", 0), consts.get("init1_ns", 0),
        consts.get("noerr", 0), consts.get("d_endpos", 0),
        consts.get("endpos", 0), consts.get("d_mask", 0xFFFFFFFF),
        0, 0], dtype=np.uint32)
    ev = _scan_windows_np(windows, mask_table, cvec, D, W, variant, costs)
    return np.asarray(ev)[:, W:].reshape(-1)[:N]


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
    m = consts.get("m", 32)
    W = min(max(m + D + 2, 48), tile)
    bounded = (variant == "sgrep"
               or consts.get("init1_ns") == consts.get("init0"))
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
        ev = scan_events(text, mask_table, consts, D, variant, costs,
                         tile)
        ev = ev[g0 - lo:]
        p = np.flatnonzero(ev)
        yield p.astype(np.int64) + g0, ev[p]
        g0 = g1


# ---------------------------------------------------------------------
# torch backend
# ---------------------------------------------------------------------

def _scan_torch(text, mask_table, consts, D, W, L, N, variant, costs):
    """The mask-machine kernel (CUDA) or its plain PyTorch version
    (CPU), then the packed planes rebuilt into event words on the host,
    exactly as the TPU path rebuilds them."""
    import torch

    from . import kernels
    if variant not in ("bitap", "sgrep"):
        raise ValueError("unknown scan variant %r" % (variant,))
    require_device()
    dev = torch.device(_DEVICE)
    mach = kernels.machine_from_arrays(mask_table, consts, D, variant,
                                       costs, dev)
    planes = kernels.mask_scan(kernels.to_device(text, dev), mach, W, L)
    planes = planes.cpu().numpy()
    d, hs = planes[0], planes[1:]
    if variant == "sgrep":
        # sgrep events are the 0/1 pulse convention (bit 0)
        return kernels.planes_to_events(
            np.zeros_like(d), hs[0], {"d_endpos": 0, "endpos": 1},
            W, L, N)
    if len(hs) == 1:
        return kernels.planes_to_events(d, hs[0], consts, W, L, N)
    ev = kernels.planes_to_events(
        d, np.zeros_like(d), {"d_endpos": consts.get("d_endpos", 0),
                              "endpos": 0}, W, L, N)
    for bv, hp in zip(mach.hit_masks, hs):
        ev |= kernels.planes_to_events(
            np.zeros_like(d), hp, {"d_endpos": 0, "endpos": bv},
            W, L, N)
    return ev


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
