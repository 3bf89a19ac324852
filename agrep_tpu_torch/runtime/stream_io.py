"""Streaming block I/O (reference bitap.c:450-505 reborn).

The reference refills a 48KB buffer forever, so a 10GB file scans in
constant memory; round 1's engines slurped whole files.  This module
restores O(chunk) scanning:

  * ByteStream -- a random-access view over a list of byte segments
    (numpy arrays, memmaps, bytes) WITHOUT concatenating them: the
    engines' virtual streams ("\\n" + file + delimiter [+ the
    block-glitch byte]) become zero-copy views over a read-only
    np.memmap of the file.
  * open_bytes -- np.memmap a file read-only (np.fromfile for empty
    files, which memmap rejects).

The chunked scan itself lives in ops.scan.scan_event_list: each chunk
is scanned with a W-byte halo of real preceding bytes (the same
tile+halo restart argument as in-chunk tiling, applied at chunk
granularity), so carried machine state never crosses a chunk host-side.

Bulk reads from memmap segments go through os.pread rather than the
page-fault path: on hosts with weak fault readahead (or an actively
trimmed page cache) faulting a cold mapping sustains ~20 MB/s while a
positioned read of the same range runs at disk speed -- measured 50x
on the round-5 bench VM.  The mapping itself is kept for cheap random
single-byte access and as the zero-copy ndarray the whole-file walks
expect (open_bytes issues no MADV_WILLNEED: see its docstring).
"""

from __future__ import annotations

import mmap
import os

import numpy as np

_PREAD_CHUNK = 2 << 20


def _file_window(seg):
    """(filename, file_offset_of_seg0) for a contiguous uint8 view
    backed by an np.memmap, or None when it cannot be derived (then
    reads fall back to the mapping)."""
    if not isinstance(seg, np.memmap):
        return None
    mm = getattr(seg, "_mmap", None)
    fn = getattr(seg, "filename", None)
    if (mm is None or fn is None or seg.dtype != np.uint8
            or seg.ndim != 1 or not seg.flags["C_CONTIGUOUS"]):
        return None
    try:
        base = np.frombuffer(mm, dtype=np.uint8)
        d0 = base.__array_interface__["data"][0]
        s0 = seg.__array_interface__["data"][0]
        # np.memmap(offset=k) maps from the granularity-aligned floor
        # of k; the mapping's first byte is file offset k - k%gran
        aligned = (int(getattr(seg, "offset", 0))
                   // mmap.ALLOCATIONGRANULARITY
                   * mmap.ALLOCATIONGRANULARITY)
        return os.fspath(fn), aligned + (s0 - d0)
    except (TypeError, ValueError, AttributeError):
        return None


class ByteStream:
    """Concatenated random-access byte source over segments.

    Supports len(), integer indexing, step-1 slicing, and bulk read();
    every access materializes only the requested range (memmap segments
    are pread() from the file in O(range))."""

    def __init__(self, segments):
        self.segs = []
        offs = [0]
        for s in segments:
            if isinstance(s, (bytes, bytearray)):
                s = np.frombuffer(bytes(s), dtype=np.uint8)
            if len(s) == 0:
                continue
            self.segs.append(s)
            offs.append(offs[-1] + len(s))
        if not self.segs:
            offs = [0, 0]
            self.segs = [np.zeros(0, dtype=np.uint8)]
        self.offs = np.asarray(offs, dtype=np.int64)
        self.n = int(self.offs[-1])
        # per-segment (fd, base_file_offset) for memmap-backed
        # segments; fds are owned by this stream and closed on GC
        self._wins = []
        self._fds = {}
        for s in self.segs:
            w = _file_window(s)
            if w is None:
                self._wins.append(None)
                continue
            fn, off0 = w
            fd = self._fds.get(fn)
            if fd is None:
                try:
                    fd = os.open(fn, os.O_RDONLY)
                except OSError:
                    self._wins.append(None)
                    continue
                self._fds[fn] = fd
            self._wins.append((fd, off0))

    def __del__(self):
        for fd in getattr(self, "_fds", {}).values():
            try:
                os.close(fd)
            except OSError:
                pass

    def __len__(self) -> int:
        return self.n

    def read(self, lo: int, hi: int) -> np.ndarray:
        """uint8 copy of [lo, hi) clamped to the stream bounds."""
        lo = max(0, min(int(lo), self.n))
        hi = max(lo, min(int(hi), self.n))
        out = np.empty(hi - lo, dtype=np.uint8)
        i = int(np.searchsorted(self.offs, lo, side="right")) - 1
        pos = lo
        while pos < hi:
            seg = self.segs[i]
            s0 = int(self.offs[i])
            take = min(hi, s0 + len(seg)) - pos
            win = self._wins[i] if i < len(self._wins) else None
            done = False
            if win is not None:
                fd, off0 = win
                # 2MB pieces: a single huge pread serializes behind
                # its own readahead; ~1-4MB sustains disk speed
                done = True
                got = 0
                while got < take:
                    piece = min(take - got, _PREAD_CHUNK)
                    try:
                        b = os.pread(fd, piece,
                                     off0 + (pos - s0) + got)
                    except OSError:
                        b = b""
                    if len(b) != piece:
                        done = False
                        break
                    out[pos - lo + got:pos - lo + got + piece] = \
                        np.frombuffer(b, dtype=np.uint8)
                    got += piece
            if not done:
                out[pos - lo:pos - lo + take] = \
                    seg[pos - s0:pos - s0 + take]
            pos += take
            i += 1
        return out

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(self.n)
            if step != 1:
                raise ValueError("ByteStream slices must be step-1")
            return self.read(start, stop)
        key = int(key)
        if key < 0:
            key += self.n
        if not (0 <= key < self.n):
            raise IndexError(key)
        i = int(np.searchsorted(self.offs, key, side="right")) - 1
        return int(self.segs[i][key - int(self.offs[i])])


def open_bytes(path: str) -> np.ndarray:
    """Read-only byte view of a file: memmap when possible (O(1)
    memory), tiny array for empty files.  (No blanket MADV_WILLNEED:
    it schedules a whole-file readahead through the slow fault path
    that then races the preads the streaming engines actually use.)"""
    if os.path.getsize(path) == 0:
        return np.zeros(0, dtype=np.uint8)
    return np.memmap(path, dtype=np.uint8, mode="r")
