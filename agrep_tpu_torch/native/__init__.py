"""ctypes bindings for the native host runtime (agrep_host.cpp).

The library is built on demand by _build() below (one g++ -O3 -shared
invocation, re-run whenever the source is newer than the .so); when no
compiler is available, callers fall back to the pure-Python
implementations in runtime/sgrep_sim.py -- identical semantics, just
slower on large inputs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_HERE, "libagrep_host.so")
_lib = None
_tried = False


def _build() -> bool:
    # compile to a private name and rename into place, so a concurrent
    # process never loads a half-written library
    src = os.path.join(_HERE, "agrep_host.cpp")
    tmp = "%s.tmp%d" % (_LIB_PATH, os.getpid())
    try:
        subprocess.check_call(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
             "-o", tmp, src],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        os.replace(tmp, _LIB_PATH)
        return True
    except Exception:
        return False


def get_lib():
    """Returns the loaded library or None."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    src = os.path.join(_HERE, "agrep_host.cpp")
    stale = (not os.path.exists(_LIB_PATH)
             or (os.path.exists(src) and os.path.getmtime(src)
                 > os.path.getmtime(_LIB_PATH)))
    if stale:
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    i64 = ctypes.c_int64
    u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")

    lib.find_delims.restype = i64
    lib.find_delims.argtypes = [u8p, i64, u8p, i64, i64p, i64]
    lib.find_occurrences.restype = i64
    lib.find_occurrences.argtypes = [u8p, i64, u8p, i64, u8p, i64p, i64]
    lib.bm_inverse_survives.restype = ctypes.c_int
    lib.bm_inverse_survives.argtypes = [u8p, i64, i64, i64, u8p, i64,
                                        i32p, ctypes.c_int32, u8p,
                                        i64p, i64, ctypes.c_int32]
    lib.agrep_candidates.restype = i64
    lib.agrep_candidates.argtypes = [u8p, i64, i64, i64, u8p, i64, i64,
                                     i32p, ctypes.c_int32, u8p, i64p,
                                     i64]
    lib.verify_dp.restype = i64
    lib.verify_dp.argtypes = [i64, i64, i64, u8p, u8p, i64]
    u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
    lib.agrep_count_walk.restype = i64
    lib.agrep_count_walk.argtypes = [i64p, i64p, i64, i64p, i64, i64,
                                     i64, i64, u8p, i64, i64, u32p,
                                     ctypes.c_uint32]
    lib.agrep_rounds.restype = i64
    lib.agrep_rounds.argtypes = [u8p, i64, i64, i64, i64p, i64, u32p,
                                 ctypes.c_uint32, i64, u8p, i64,
                                 ctypes.c_int, ctypes.c_int, i64p, u8p,
                                 i64p, i64p, i64]
    lib.a_monkey_block.restype = i64
    lib.a_monkey_block.argtypes = [u8p, i64, i64, i64, u8p, i64, i64,
                                   u8p, u8p, i64, i64p, i64]
    lib.monkey4_block.restype = i64
    lib.monkey4_block.argtypes = [u8p, i64, i64, i64, u8p, i64, i64,
                                  i64p, u8p, i64, u8p, i64, i64p, i64]
    lib.qgram_first_per_line.restype = i64
    lib.qgram_first_per_line.argtypes = [
        u8p, i64, u8p, i32p, i64p, i64p, u8p, i64p, u8p, i64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i64p, i64p,
        i64]
    lib.qgram_occ_all.restype = i64
    lib.qgram_occ_all.argtypes = [
        u8p, i64, u8p, i32p, i64p, i64p, u8p, i64p, u8p, i64,
        ctypes.c_int32, ctypes.c_int32, i64p, i64p, i64]
    lib.qgram_occ_at.restype = i64
    lib.qgram_occ_at.argtypes = [
        u8p, i64, i64p, i64, u8p, i32p, i64p, i64p, u8p, i64p, u8p, i64,
        ctypes.c_int32, ctypes.c_int32, i64p, i64p, i64]
    lib.pack_lines.restype = None
    lib.pack_lines.argtypes = [u8p, i64, i64p, i64p, i64, i64, u8p]
    u32 = ctypes.c_uint32
    lib.exact_scan_events.restype = i64
    lib.exact_scan_events.argtypes = [u8p, i64, u8p, i64, i64p, u32p,
                                      i64]
    lib.folded_exact_scan.restype = i64
    lib.folded_exact_scan.argtypes = [u8p, i64, u8p, i64, u8p, i64p,
                                      u32p, i64]
    lib.bitap_scan_events.restype = i64
    lib.bitap_scan_events.argtypes = [u8p, i64, u32p, u32, u32, u32,
                                      u32, u32, u32, i64,
                                      ctypes.c_int32, i64, i64, i64,
                                      i64p, u32p, i64]
    lib.renfa_scan_lines.restype = i64
    lib.renfa_scan_lines.argtypes = [u8p, i64, u32p, u32p, u32p, i64,
                                     i64, u32, u32, i64,
                                     ctypes.c_int32, u32p, i64, u8p,
                                     i64]
    lib.qgram_first_per_anchor.restype = i64
    lib.qgram_first_per_anchor.argtypes = [
        u8p, i64, u8p, i32p, i64p, i64p, u8p, i64p, u8p, i64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        u8p, i64, i64p, i64, i64, i64p, i64p, i64]
    lib.qgram_first_per_anchor_at.restype = i64
    lib.qgram_first_per_anchor_at.argtypes = [
        u8p, i64, u32p, i64, i64, u8p, i32p, i64p, i64p, u8p, i64p, u8p,
        i64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        u8p, i64, i64p, i64, i64, i64p, i64p, i64]
    lib.mgrep_or_count_walk.restype = i64
    lib.mgrep_or_count_walk.argtypes = [
        u8p, i64, u8p, i64, u8p, i32p, ctypes.c_int32, i64,
        i64p, i64, i64p, i64, i64p, i64, i64, i64, i64, i64,
        ctypes.c_int32]
    _lib = lib
    return lib


_SCRATCH: dict = {}


def _scratch(key: str, min_len: int, dtype=np.int64) -> np.ndarray:
    """Grow-only scratch buffer (avoids re-faulting fresh pages on
    every call; see qgram_first_per_line)."""
    buf = _SCRATCH.get(key)
    if buf is None or len(buf) < min_len:
        buf = np.empty(min_len, dtype=dtype)
        _SCRATCH[key] = buf
    return buf


def _exact_bytes_from_mask(mask_table: np.ndarray,
                           m: int) -> bytes | None:
    """Reconstruct the literal pattern when every sgrep-machine
    position is matched by exactly ONE byte (no fold/class): position
    p's byte is the unique c with bit (31 - p) set in mask[c]."""
    mt = mask_table.astype(np.uint32)
    out = bytearray()
    for p in range(m):
        bit = np.uint32(1 << (31 - p))
        sel = np.flatnonzero((mt & bit) != 0)
        if len(sel) != 1:
            return None
        out.append(int(sel[0]))
    return bytes(out)


def _folded_exact_from_mask(mask_table: np.ndarray, m: int):
    """(pattern-under-fold, fold table u8[256]) when every position's
    byte set is a singleton or a case pair {c, c^0x20}, with one
    consistent global fold; None otherwise."""
    mt = mask_table.astype(np.uint32)
    fold_map: dict = {}
    patf = bytearray()

    def bind(b, target):
        if fold_map.setdefault(b, target) != target:
            raise ValueError

    singles = set()
    try:
        for p in range(m):
            bit = np.uint32(1 << (31 - p))
            sel = np.flatnonzero((mt & bit) != 0)
            if len(sel) == 1:
                c = int(sel[0])
                bind(c, c)
                singles.add(c)
                patf.append(c)
            elif len(sel) == 2:
                a, b = int(sel[0]), int(sel[1])
                if a ^ b != 0x20:
                    return None
                lo = a | 0x20
                bind(a, lo)
                bind(b, lo)
                patf.append(lo)
            else:
                return None
    except ValueError:
        return None
    # a singleton's byte must not be the fold TARGET of any other
    # byte, or the fold would admit that byte at the exact position
    for b, t in fold_map.items():
        if b != t and t in singles:
            return None
    fold = np.arange(256, dtype=np.uint8)
    for b, t in fold_map.items():
        fold[b] = t
    return bytes(patf), fold


def bitap_scan_events(text: np.ndarray, mask_table: np.ndarray,
                      consts: dict, D: int, variant: str,
                      costs) -> tuple | None:
    """Sequential C scan of the bitap/sgrep machine; returns sparse
    (positions i64, event words u32); None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if (variant == "sgrep" and D == 0
            and int(consts.get("endpos", 0)) != 0):
        m = int(consts.get("m", 0))
        fx = _folded_exact_from_mask(mask_table, m) if m else None
        if fx is not None:
            patf, fold = fx
            tx = np.ascontiguousarray(text)
            pt = np.ascontiguousarray(np.frombuffer(patf,
                                                    dtype=np.uint8))
            fd = np.ascontiguousarray(fold)

            def frun(buf, key):
                out_p = _scratch(("ev_pos", key), 1 << 20)
                out_w = _scratch(("ev_word", key), 1 << 20,
                                 dtype=np.uint32)
                cnt = lib.folded_exact_scan(buf, len(buf), pt, m, fd,
                                            out_p, out_w, len(out_p))
                if cnt > len(out_p):
                    out_p = _scratch(("ev_pos", key), int(cnt) + 16)
                    out_w = _scratch(("ev_word", key), int(cnt) + 16,
                                     dtype=np.uint32)
                    cnt = lib.folded_exact_scan(buf, len(buf), pt, m,
                                                fd, out_p, out_w,
                                                len(out_p))
                return out_p[:cnt], out_w[:cnt]

            n_s = len(tx)
            nthreads = min(4, os.cpu_count() or 1)
            par_min = int(os.environ.get("AGREP_TORCH_PAR_MIN",
                                         str(8 << 20)))
            if n_s < par_min or nthreads <= 1:
                return frun(tx, 0)
            # stateless exact match: m-1 bytes of halo make chunked
            # scanning trivially exact
            cuts = [n_s * k // nthreads for k in range(nthreads + 1)]

            def fchunk(k):
                lo, hi = cuts[k], cuts[k + 1]
                lo_e = max(lo - (m - 1), 0)
                pp, ww = frun(tx[lo_e:hi], k)
                keep = pp >= (lo - lo_e)
                return (pp[keep] + lo_e).copy(), ww[keep].copy()

            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(nthreads) as ex:
                parts = list(ex.map(fchunk, range(nthreads)))
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
    ci, cs, cd = costs if costs is not None else (0, 0, 0)
    mt = np.ascontiguousarray(mask_table.astype(np.uint32))
    tx = np.ascontiguousarray(text)
    margs = (mt,
             int(consts.get("init0", 0)) & 0xFFFFFFFF,
             int(consts.get("init1_ns", 0)) & 0xFFFFFFFF,
             int(consts.get("noerr", 0)) & 0xFFFFFFFF,
             int(consts.get("d_endpos", 0)) & 0xFFFFFFFF,
             int(consts.get("endpos", 0)) & 0xFFFFFFFF,
             int(consts.get("d_mask", 0xFFFFFFFF)) & 0xFFFFFFFF,
             int(D), 0 if variant == "bitap" else 1,
             int(ci), int(cs), int(cd))

    def run(buf, key):
        out_p = _scratch(("ev_pos", key), 1 << 20)
        out_w = _scratch(("ev_word", key), 1 << 20, dtype=np.uint32)
        cnt = lib.bitap_scan_events(buf, len(buf), *margs, out_p,
                                    out_w, len(out_p))
        if cnt < 0:
            return None
        if cnt > len(out_p):
            out_p = _scratch(("ev_pos", key), int(cnt) + 16)
            out_w = _scratch(("ev_word", key), int(cnt) + 16,
                             dtype=np.uint32)
            cnt = lib.bitap_scan_events(buf, len(buf), *margs, out_p,
                                        out_w, len(out_p))
        return out_p[:cnt], out_w[:cnt]

    n_s = len(tx)
    nthreads = min(4, os.cpu_count() or 1)
    par_min = int(os.environ.get("AGREP_TORCH_PAR_MIN", str(8 << 20)))
    if n_s < par_min or nthreads <= 1:
        return run(tx, 0)
    # parallel chunk scan with a W-byte halo restart: callers only use
    # this function for bounded machines (no sticky/wildcard bits), so
    # a chunk scanned from the cold state converges to the true state
    # within W = m + D + 2 bytes -- the exact argument the windowed
    # tile+halo backend is built on (ops/scan.py module docstring)
    W = max(int(consts.get("m", 32)) + int(D) + 2, 48)
    cuts = [n_s * k // nthreads for k in range(nthreads + 1)]

    def chunk(k):
        lo, hi = cuts[k], cuts[k + 1]
        lo_e = max(lo - W, 0)
        out = run(tx[lo_e:hi], k)
        if out is None:
            return None
        pp, ww = out
        keep = pp >= (lo - lo_e)
        return (pp[keep] + lo_e).copy(), ww[keep].copy()

    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(nthreads) as ex:
        parts = list(ex.map(chunk, range(nthreads)))
    if any(p is None for p in parts):
        return run(tx, 0)
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def renfa_scan_lines(buf: np.ndarray, mc: dict, cont_states,
                     inject: int = -1,
                     n_lines_hint: int | None = None
                     ) -> np.ndarray | None:
    """Per-line regex-NFA verdicts over a stream that starts one past
    a newline; None when the native library is unavailable.  inject
    processes one extra 0x00 byte before buf[inject] (the re()
    block-boundary glitch)."""
    lib = get_lib()
    if lib is None:
        return None
    from ..ops.renfa import next_tables_arrays
    lo_tab, hi_tab, h, rel = next_tables_arrays(mc)
    if hi_tab is None:
        hi_tab = np.zeros(1, dtype=np.uint32)
    D = int(mc["D"])
    cont = np.asarray([int(x) & 0xFFFFFFFF for x in cont_states],
                      dtype=np.uint32)
    cap = (n_lines_hint if n_lines_hint is not None
           else int(np.count_nonzero(buf == 0x0A))) + 1
    out = np.empty(max(cap, 1), dtype=np.uint8)
    n = lib.renfa_scan_lines(
        np.ascontiguousarray(buf), len(buf),
        np.ascontiguousarray(mc["mask"].astype(np.uint32)),
        np.ascontiguousarray(lo_tab), np.ascontiguousarray(hi_tab),
        h, rel, int(mc["init1"]) & 0xFFFFFFFF,
        int(mc["no_err"]) & 0xFFFFFFFF, D, int(bool(mc["tail"])),
        cont, int(inject), out, len(out))
    return out[:min(n, len(out))].astype(bool)


def pack_lines(stream: np.ndarray, starts: np.ndarray,
               lens: np.ndarray, L: int) -> np.ndarray | None:
    """Zero-padded u8[R, L] lane matrix (returns a reused scratch
    view); None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    R = len(starts)
    flat = _scratch("lanes", R * L, dtype=np.uint8)
    lib.pack_lines(np.ascontiguousarray(stream), len(stream),
                   np.ascontiguousarray(starts, dtype=np.int64),
                   np.ascontiguousarray(lens, dtype=np.int64),
                   R, L, flat)
    return flat[:R * L].reshape(R, L)


def find_delims_all(stream: np.ndarray,
                    delim: bytes) -> np.ndarray | None:
    """All (overlapping) delimiter END positions; None when the native
    library is unavailable.  Large streams split across a thread pool
    (delimiter search is position-local up to dl-1 bytes of overlap;
    ctypes releases the GIL)."""
    lib = get_lib()
    if lib is None:
        return None
    d = np.ascontiguousarray(np.frombuffer(delim, dtype=np.uint8))
    s = np.ascontiguousarray(stream)
    dl = len(d)
    n_s = len(s)
    nthreads = min(4, os.cpu_count() or 1)
    if n_s >= (8 << 20) and nthreads > 1:
        cuts = [n_s * k // nthreads for k in range(nthreads + 1)]

        def one(k):
            lo = max(cuts[k] - (dl - 1), 0)
            hi = cuts[k + 1]
            sub = s[lo:hi]
            out = _scratch(("delims", k), 1 << 20)
            while True:
                cap = len(out)
                cnt = lib.find_delims(sub, len(sub), d, dl, out, cap)
                if cnt < cap:
                    break
                out = _scratch(("delims", k), 2 * cap)
            # no dedupe needed: the dl-1 overlap means chunk k's
            # earliest possible END is exactly cuts[k], one past the
            # previous chunk's last reportable END (cuts[k]-1)
            return (out[:cnt] + lo).copy()

        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(nthreads) as ex:
            parts = list(ex.map(one, range(nthreads)))
        return np.concatenate(parts)
    out = _scratch("delims", 1 << 20)
    while True:
        cap = len(out)
        n = lib.find_delims(s, len(s), d, len(d), out, cap)
        if n < cap:
            return out[:n].copy()
        out = _scratch("delims", 2 * cap)


def find_occurrences(stream: np.ndarray, term: bytes,
                     tr: np.ndarray) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    cap = max(16, len(stream))
    out = np.empty(cap, dtype=np.int64)
    t = np.frombuffer(term, dtype=np.uint8)
    n = lib.find_occurrences(np.ascontiguousarray(stream),
                             len(stream), np.ascontiguousarray(t),
                             len(t), np.ascontiguousarray(tr), out, cap)
    return out[:n].copy()


def verify_dp(m, n, D, pat: bytes, window: bytes) -> int | None:
    lib = get_lib()
    if lib is None:
        return None
    p = np.frombuffer(pat, dtype=np.uint8)
    w = np.frombuffer(window, dtype=np.uint8)
    return int(lib.verify_dp(m, n, D,
                             np.ascontiguousarray(p),
                             np.ascontiguousarray(w), len(w)))


def agrep_candidates(buf: np.ndarray, start: int, end: int, pat: bytes,
                     D: int, shift_tab: np.ndarray, d1: int,
                     member: np.ndarray):
    """Candidate ranges [(lo, hi)] relative to start, or None."""
    lib = get_lib()
    if lib is None:
        return None
    cap = 4096
    out = np.empty(2 * cap, dtype=np.int64)
    p = np.frombuffer(pat, dtype=np.uint8)
    n = lib.agrep_candidates(
        np.ascontiguousarray(buf), len(buf), start, end,
        np.ascontiguousarray(p), len(pat), D,
        np.ascontiguousarray(shift_tab.astype(np.int32)), int(d1),
        np.ascontiguousarray(member.astype(np.uint8)), out, cap)
    return out[:2 * n].reshape(-1, 2)


def agrep_rounds(buf: np.ndarray, tb: int, te: int, cands: np.ndarray,
                 mask: np.ndarray, endpos: int, D: int, delim: bytes,
                 outtail: bool, silent: bool):
    """Exact agrep() round-machine replay over one block.  Returns
    (idx, flag, begin, end) arrays of counted events, or None.
    begin/end are s_output's record span in block idx coords (-1 for
    counted-only events)."""
    lib = get_lib()
    if lib is None:
        return None
    cap = max(64, 2 * (te - tb) + 16)
    dl = np.frombuffer(delim if delim else b"\n", dtype=np.uint8)
    while True:
        out_idx = np.empty(cap, dtype=np.int64)
        out_flag = np.empty(cap, dtype=np.uint8)
        out_begin = np.empty(cap, dtype=np.int64)
        out_end = np.empty(cap, dtype=np.int64)
        n = lib.agrep_rounds(
            np.ascontiguousarray(buf), len(buf), int(tb), int(te),
            np.ascontiguousarray(np.asarray(cands).reshape(-1),
                                 dtype=np.int64),
            len(cands), np.ascontiguousarray(mask, dtype=np.uint32),
            int(endpos) & 0xFFFFFFFF, int(D), np.ascontiguousarray(dl),
            len(delim), int(bool(outtail)), int(bool(silent)), out_idx,
            out_flag, out_begin, out_end, cap)
        if n < cap:
            break
        # n == cap means the C walk returned early at the capacity
        # check -- indistinguishable from an exact fit, so re-walk with
        # a larger buffer until the count comes back under it
        cap *= 4
    return (out_idx[:n].copy(), out_flag[:n].copy(),
            out_begin[:n].copy(), out_end[:n].copy())


def agrep_count_walk(events: np.ndarray, rec_ends: np.ndarray,
                     cands: np.ndarray, lo_g: int, m_pat: int,
                     D: int, buf: np.ndarray, tb: int,
                     maskI: np.ndarray, endpos: int) -> int | None:
    lib = get_lib()
    if lib is None:
        return None
    return int(lib.agrep_count_walk(
        np.ascontiguousarray(events, dtype=np.int64),
        np.ascontiguousarray(rec_ends, dtype=np.int64), len(events),
        np.ascontiguousarray(cands.reshape(-1), dtype=np.int64),
        len(cands), lo_g, m_pat, D,
        np.ascontiguousarray(buf, dtype=np.uint8), len(buf), tb,
        np.ascontiguousarray(maskI, dtype=np.uint32), endpos))


def qgram_occ_all(stream: np.ndarray, member: np.ndarray,
                  hash_id: np.ndarray, bucket_off: np.ndarray,
                  bucket_tids: np.ndarray, term_bytes: np.ndarray,
                  term_off: np.ndarray, tr: np.ndarray, p: int,
                  longf: bool, shortf: bool):
    """All verified (anchor, tid) pairs in one C pass; None when the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out_a = _scratch("qgram_a", 1 << 20)
    out_t = _scratch("qgram_t", 1 << 20)
    args_fixed = (
        np.ascontiguousarray(stream), len(stream),
        np.ascontiguousarray(member.astype(np.uint8)),
        np.ascontiguousarray(hash_id.astype(np.int32)),
        np.ascontiguousarray(bucket_off.astype(np.int64)),
        np.ascontiguousarray(bucket_tids.astype(np.int64)),
        np.ascontiguousarray(term_bytes),
        np.ascontiguousarray(term_off.astype(np.int64)),
        np.ascontiguousarray(tr), p, int(longf), int(shortf))
    cnt = lib.qgram_occ_all(*args_fixed, out_a, out_t, len(out_a))
    if cnt > len(out_a):
        out_a = _scratch("qgram_a", int(cnt) + 16)
        out_t = _scratch("qgram_t", int(cnt) + 16)
        cnt = lib.qgram_occ_all(*args_fixed, out_a, out_t, len(out_a))
    return out_a[:cnt], out_t[:cnt]


# Candidate count from which qgram_occ_at verifies in parallel slices.
OCC_AT_PAR_MIN = 1 << 20


def qgram_occ_at(stream: np.ndarray, anchors: np.ndarray,
                 member: np.ndarray, hash_id: np.ndarray,
                 bucket_off: np.ndarray, bucket_tids: np.ndarray,
                 term_bytes: np.ndarray, term_off: np.ndarray,
                 tr: np.ndarray, p: int, longf: bool, shortf: bool):
    """qgram_occ_all's verified (anchor, tid) pairs at the given
    ascending candidate anchors only (e.g. the device q-gram filter's);
    None when the native library is unavailable.  Long candidate lists
    are split into up to four slices verified side by side (ctypes
    releases the GIL); the rows keep anchor order."""
    lib = get_lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(stream)
    tables = (
        np.ascontiguousarray(member.astype(np.uint8)),
        np.ascontiguousarray(hash_id.astype(np.int32)),
        np.ascontiguousarray(bucket_off.astype(np.int64)),
        np.ascontiguousarray(bucket_tids.astype(np.int64)),
        np.ascontiguousarray(term_bytes),
        np.ascontiguousarray(term_off.astype(np.int64)),
        np.ascontiguousarray(tr), p, int(longf), int(shortf))

    def one(cand):
        # hits are sparse among the candidates: a list past the first
        # guess is walked once more at its exact size
        cap = min(len(cand), 1 << 20) + 16
        while True:
            out_a = np.empty(cap, dtype=np.int64)
            out_t = np.empty(cap, dtype=np.int64)
            cnt = lib.qgram_occ_at(s, len(s), cand, len(cand), *tables,
                                   out_a, out_t, cap)
            if cnt <= cap:
                return out_a[:cnt], out_t[:cnt]
            cap = int(cnt) + 16

    cand = np.ascontiguousarray(anchors, dtype=np.int64)
    nthreads = min(4, os.cpu_count() or 1)
    if nthreads <= 1 or len(cand) < OCC_AT_PAR_MIN:
        return one(cand)
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(nthreads) as ex:
        parts = list(ex.map(one, np.array_split(cand, nthreads)))
    return (np.concatenate([x[0] for x in parts]),
            np.concatenate([x[1] for x in parts]))


def _per_anchor_tables(member, hash_id, bucket_off, bucket_tids,
                       term_bytes, term_off, tr, p, longf, shortf,
                       wordbound, delim):
    """The q-gram tables and delimiter arguments of the per-anchor
    passes, as the C ABI takes them."""
    dp = np.ascontiguousarray(np.frombuffer(
        delim if delim else b"\n", dtype=np.uint8))
    return (np.ascontiguousarray(member.astype(np.uint8)),
            np.ascontiguousarray(hash_id.astype(np.int32)),
            np.ascontiguousarray(bucket_off.astype(np.int64)),
            np.ascontiguousarray(bucket_tids.astype(np.int64)),
            np.ascontiguousarray(term_bytes),
            np.ascontiguousarray(term_off.astype(np.int64)),
            np.ascontiguousarray(tr), p, int(longf), int(shortf),
            int(wordbound), dp, len(delim) if delim else 0)


def _per_anchor_rows(fn, key, n_s, marks, dlen, maxs, term_off, p, view):
    """Rows of the C pass fn over [0, n_s): view(lo, hi) gives fn's
    leading arguments for the stream's bytes [lo, hi); with a delimiter
    and a stream of AGREP_TORCH_PAR_MIN bytes or more, chunked at region
    marks and run side by side (ctypes releases the GIL)."""
    mk = (np.ascontiguousarray(marks, dtype=np.int64)
          if marks is not None else np.zeros(0, dtype=np.int64))

    def one(lo, hi, mk_loc, k):
        out_a = _scratch((key, "a", k), 1 << 20)
        out_t = _scratch((key, "t", k), 1 << 20)
        args = view(lo, hi) + (mk_loc, len(mk_loc), int(maxs))
        cnt = fn(*args, out_a, out_t, len(out_a))
        if cnt > len(out_a):
            out_a = _scratch((key, "a", k), int(cnt) + 16)
            out_t = _scratch((key, "t", k), int(cnt) + 16)
            cnt = fn(*args, out_a, out_t, len(out_a))
        return out_a[:cnt], out_t[:cnt]

    nthreads = min(4, os.cpu_count() or 1)
    par_min = int(os.environ.get("AGREP_TORCH_PAR_MIN", str(8 << 20)))
    if dlen == 0 or nthreads <= 1 or n_s < par_min or len(mk) < \
            4 * nthreads:
        a, t = one(0, n_s, mk, 0)
        return a.copy(), t.copy()
    # Chunk at region-mark boundaries: jump pruning never crosses a
    # region end (bound < te1), and detection is position-local, so a
    # chunk scanned with ctx bytes of overlap emits, for anchors in
    # its own span, the same rows or a safe superset (pruning bounds
    # shrink when the next delimiter/mark falls outside the local
    # view -- keeping extra anchors is always safe, see the C comment)
    maxlen = int(np.max(np.diff(term_off))) if len(term_off) > 1 else p
    ctx = maxlen + dlen + int(maxs) + 8
    cut_idx = [len(mk) * k // nthreads for k in range(1, nthreads)]
    cuts = [0] + [int(mk[i]) + 1 for i in cut_idx] + [n_s]
    cuts = sorted(set(cuts))

    def chunk(k):
        lo, hi = cuts[k], cuts[k + 1]
        lo_e = max(lo - ctx, 0)
        hi_e = min(hi + maxlen + dlen + 8, n_s)
        mk_loc = mk[(mk > lo_e) & (mk < hi_e)] - lo_e
        a, t = one(lo_e, hi_e, np.ascontiguousarray(mk_loc), k)
        a = a + lo_e
        keep = (a >= lo) & (a < hi)
        return a[keep].copy(), t[keep].copy()

    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(cuts) - 1) as ex:
        parts = list(ex.map(chunk, range(len(cuts) - 1)))
    return (np.concatenate([x[0] for x in parts]),
            np.concatenate([x[1] for x in parts]))


def qgram_first_per_anchor(stream: np.ndarray, member: np.ndarray,
                           hash_id: np.ndarray, bucket_off: np.ndarray,
                           bucket_tids: np.ndarray,
                           term_bytes: np.ndarray,
                           term_off: np.ndarray, tr: np.ndarray,
                           p: int, longf: bool, shortf: bool,
                           wordbound: bool,
                           delim: bytes | None = None,
                           marks: np.ndarray | None = None,
                           maxs: int = 0):
    """Highest-tid verified win per anchor; None when the native
    library is unavailable.  delim+marks enable the replay-invisible
    skip (see the C comment)."""
    lib = get_lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(stream)
    tables = _per_anchor_tables(member, hash_id, bucket_off, bucket_tids,
                                term_bytes, term_off, tr, p, longf, shortf,
                                wordbound, delim)

    def view(lo, hi):
        return (s[lo:hi], hi - lo) + tables

    return _per_anchor_rows(lib.qgram_first_per_anchor, "qgram_fpa",
                            len(s), marks, tables[-1], maxs, term_off, p,
                            view)


def qgram_first_per_anchor_at(stream: np.ndarray, plane: np.ndarray,
                              shift: int, member: np.ndarray,
                              hash_id: np.ndarray, bucket_off: np.ndarray,
                              bucket_tids: np.ndarray,
                              term_bytes: np.ndarray,
                              term_off: np.ndarray, tr: np.ndarray,
                              p: int, longf: bool, shortf: bool,
                              wordbound: bool,
                              delim: bytes | None = None,
                              marks: np.ndarray | None = None,
                              maxs: int = 0):
    """qgram_first_per_anchor's rows at the candidate anchors of a bit
    plane only (u32 words; bit b of word w is anchor 32 w + b + shift),
    e.g. the device chain kernel's start plane with shift p - 1: the
    rows the whole-stream pass gives where the plane holds every anchor
    that verifies, chunked alike; None when the native library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(stream)
    words = np.ascontiguousarray(plane).view(np.uint32)
    tables = _per_anchor_tables(member, hash_id, bucket_off, bucket_tids,
                                term_bytes, term_off, tr, p, longf, shortf,
                                wordbound, delim)

    def view(lo, hi):
        # the words holding anchors [lo, hi), re-based on lo
        w0 = max((lo - shift) // 32, 0)
        w1 = min(-(-(hi - shift) // 32), len(words))
        return ((s[lo:hi], hi - lo, words[w0:max(w0, w1)],
                 max(w1 - w0, 0), 32 * w0 + shift - lo) + tables)

    return _per_anchor_rows(lib.qgram_first_per_anchor_at, "qgram_fpa_at",
                            len(s), marks, tables[-1], maxs, term_off, p,
                            view)


def mgrep_or_count_walk(stream: np.ndarray, delim: bytes,
                        tr: np.ndarray, shift1: np.ndarray,
                        longf: bool, m1w: int, wa: np.ndarray,
                        de: np.ndarray, bounds: np.ndarray,
                        base: int, final_end: int,
                        outtail: bool) -> int | None:
    """Matched-record count of the flat-OR -d replay (C twin of
    runtime/mgrep.py walk_region in count mode); None when the native
    library is unavailable.  Regions are independent, so large walks
    split contiguous region ranges across a thread pool."""
    lib = get_lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(stream)
    d = np.ascontiguousarray(np.frombuffer(delim, dtype=np.uint8))
    trc = np.ascontiguousarray(tr)
    sh = np.ascontiguousarray(shift1, dtype=np.int32)
    wac = np.ascontiguousarray(wa, dtype=np.int64)
    dec = np.ascontiguousarray(de, dtype=np.int64)
    bnd = np.ascontiguousarray(bounds, dtype=np.int64)
    nb = len(bnd)
    n_regions = nb + 1

    def run(r_lo, r_hi):
        return int(lib.mgrep_or_count_walk(
            s, len(s), d, len(d), trc, sh, int(bool(longf)),
            int(m1w), wac, len(wac), dec, len(dec), bnd, nb,
            int(r_lo), int(r_hi), int(base), int(final_end),
            int(bool(outtail))))

    nthreads = min(4, os.cpu_count() or 1)
    if n_regions < 8 * nthreads or nthreads <= 1 or len(wac) < 4096:
        return run(0, n_regions)
    cuts = [n_regions * k // nthreads for k in range(nthreads + 1)]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(nthreads) as ex:
        return sum(ex.map(lambda k: run(cuts[k], cuts[k + 1]),
                          range(nthreads)))


def a_monkey_block(buf: np.ndarray, start: int, end: int, pat: bytes,
                   D: int, member1: np.ndarray,
                   d_pattern: bytes | None) -> np.ndarray | None:
    """Match-end positions from a_monkey's filter walk over one block
    (C twin of the sgrep_sim loop); None when the lib is unavailable.
    d_pattern None means newline records."""
    lib = get_lib()
    if lib is None:
        return None
    p = np.ascontiguousarray(np.frombuffer(pat, dtype=np.uint8))
    dp = np.ascontiguousarray(np.frombuffer(
        d_pattern if d_pattern else b"\n", dtype=np.uint8))
    dl = len(d_pattern) if d_pattern else 0
    bufc = np.ascontiguousarray(buf)
    mem = np.ascontiguousarray(member1.astype(np.uint8))
    cap = 1024
    while True:
        out = np.empty(cap, dtype=np.int64)
        n = lib.a_monkey_block(bufc, len(bufc), int(start), int(end),
                               p, len(pat), int(D), mem, dp, dl, out,
                               cap)
        if n <= cap:
            return out[:n].copy()
        cap = int(n) + 16


def monkey4_block(buf: np.ndarray, start: int, end: int, pat: bytes,
                  D: int, char_map: np.ndarray, member: np.ndarray,
                  hashmask: int,
                  d_pattern: bytes | None) -> np.ndarray | None:
    """Match-end positions from monkey4's DNA filter walk over one
    block; None when the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    p = np.ascontiguousarray(np.frombuffer(pat, dtype=np.uint8))
    dp = np.ascontiguousarray(np.frombuffer(
        d_pattern if d_pattern else b"\n", dtype=np.uint8))
    dl = len(d_pattern) if d_pattern else 0
    bufc = np.ascontiguousarray(buf)
    cm = np.ascontiguousarray(char_map.astype(np.int64))
    mem = np.ascontiguousarray(member.astype(np.uint8))
    cap = 1024
    while True:
        out = np.empty(cap, dtype=np.int64)
        n = lib.monkey4_block(bufc, len(bufc), int(start), int(end),
                              p, len(pat), int(D), cm, mem,
                              int(hashmask), dp, dl, out, cap)
        if n <= cap:
            return out[:n].copy()
        cap = int(n) + 16


def qgram_first_per_line(stream: np.ndarray, member: np.ndarray,
                         hash_id: np.ndarray, bucket_off: np.ndarray,
                         bucket_tids: np.ndarray, term_bytes: np.ndarray,
                         term_off: np.ndarray, tr: np.ndarray, p: int,
                         longf: bool, shortf: bool, wordbound: bool,
                         count_only: bool = False):
    """First verified (anchor, term_id) per newline record; None when
    the native library is unavailable.  count_only returns just the
    int total (no buffer growth, at most one corpus walk)."""
    lib = get_lib()
    if lib is None:
        return None
    # grow-only cached output buffers: first-touch page faults on a
    # fresh multi-MB allocation cost more than the scan itself on this
    # class of host.  Returned slices are views into the scratch --
    # callers consume them before the next call (single-threaded
    # executor).  count_only passes cap=0: the C walk still counts
    # every pair but never writes.
    if count_only:
        out_a = out_t = np.zeros(1, dtype=np.int64)
    else:
        out_a = _scratch("qgram_a", 1 << 20)
        out_t = _scratch("qgram_t", 1 << 20)
    args_fixed = (
        np.ascontiguousarray(stream), len(stream),
        np.ascontiguousarray(member.astype(np.uint8)),
        np.ascontiguousarray(hash_id.astype(np.int32)),
        np.ascontiguousarray(bucket_off.astype(np.int64)),
        np.ascontiguousarray(bucket_tids.astype(np.int64)),
        np.ascontiguousarray(term_bytes),
        np.ascontiguousarray(term_off.astype(np.int64)),
        np.ascontiguousarray(tr), p, int(longf), int(shortf),
        int(wordbound))
    cap = 0 if count_only else len(out_a)
    cnt = lib.qgram_first_per_line(*args_fixed, out_a, out_t, cap)
    if count_only:
        return int(cnt)
    if cnt <= cap:
        return out_a[:cnt], out_t[:cnt]
    # the walk found more pairs than fit: one re-walk at exact size
    out_a = _scratch("qgram_a", int(cnt) + 16)
    out_t = _scratch("qgram_t", int(cnt) + 16)
    cnt = lib.qgram_first_per_line(*args_fixed, out_a, out_t,
                                   len(out_a))
    return out_a[:cnt], out_t[:cnt]
