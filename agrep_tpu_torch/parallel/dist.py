"""Distributed scan: corpus shards over a list of devices.

Design (SURVEY.md sections 2.3, 5):
  * the corpus is split into byte shards, each with a `max_record`-byte
    halo of the bytes before it (the reference's residue-copy logic,
    bitap.c:286-297, reborn as a halo);
  * every shard runs the same mask machine as the single-stream path,
    ops/kernels.mask_scan: the CUDA kernel on a GPU, its plain PyTorch
    version on the CPU.  Nothing is exchanged during a scan: the carried
    state is O(k) words and lives inside a tile;
  * shard i runs on mesh[i % len(mesh)], so one card can hold every
    shard of a run, and a host with a card for each shard places one
    shard on each;
  * every shard's launch is queued before anything is read back; the
    counts are reduced on the device and read once, and the offsets are
    expanded from the nonzero words of each shard's hit plane only, then
    merged on the host in shard order, which is the reference's global
    byte order.
"""

from __future__ import annotations

import numpy as np

from ..ops.scan import DEFAULT_TILE as TILE

MAX_RECORD = 49152  # agrep.h:49


def make_mesh(n_devices: int | None = None) -> list:
    """The devices shards run on, by the scan device of ops/scan.py
    (AGREP_TORCH_DEVICE): every visible CUDA device (the first n_devices
    of them), or, when the caller asks for the CPU, n_devices entries of
    the CPU (the plain version).  Raises when no CUDA device is
    visible."""
    import torch

    from ..ops import scan as scan_ops
    if scan_ops._DEVICE == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("make_mesh: no CUDA device is visible")
    return [torch.device("cuda", i) for i in range(n)][:n_devices]


def shard_corpus(data: np.ndarray, n_shards: int,
                 overlap: int = MAX_RECORD):
    """Split a byte stream into n_shards equal shards plus a halo of
    `overlap` preceding bytes each (shard 0's halo is a newline
    sentinel pad).  Returns (shards u8[n, halo+shard_len], starts)."""
    N = len(data)
    shard_len = -(-N // n_shards)
    total = shard_len * n_shards
    padded = np.full(overlap + total, 0x0A, dtype=np.uint8)
    padded[overlap:overlap + N] = data
    shards = np.stack([
        padded[i * shard_len:overlap + (i + 1) * shard_len]
        for i in range(n_shards)])
    starts = np.arange(n_shards) * shard_len
    return shards, starts


def _scan_shards(shards: np.ndarray, mask_table: np.ndarray, consts: dict,
                 D: int, mesh, costs) -> tuple:
    """Queue every shard's mask_scan on its device; returns ([each
    shard's hit words int64[T, n_words], the OR of its hit planes], W)."""
    import torch

    from ..ops import kernels
    W = max(consts.get("m", 32) + D + 2, 48)
    machines = {}
    hits = []
    for i in range(shards.shape[0]):
        dev = mesh[i % len(mesh)]
        if dev not in machines:
            machines[dev] = kernels.machine_from_arrays(
                mask_table, consts, D, "bitap", costs, dev)
        planes = kernels.mask_scan(kernels.to_device(shards[i], dev),
                                   machines[dev], W, TILE)
        words = planes[1:].to(torch.int64)
        for p in range(1, words.shape[0]):
            words[0] |= words[p]
        hits.append(words[0])
    return hits, W


def _body_mask(T: int, n_words: int, W: int, lo: int, hi: int, device):
    """int64[T, n_words] of u32 masks selecting the window columns that
    hold shard bytes [lo, hi): tile t's column c holds byte t*TILE - W + c,
    and only its body columns W..W+TILE-1 count."""
    import torch
    t = torch.arange(T, dtype=torch.int64, device=device)[:, None] * TILE
    c_lo = W + torch.clamp(lo - t, 0, TILE)
    c_hi = W + torch.clamp(hi - t, 0, TILE)
    w = torch.arange(n_words, dtype=torch.int64, device=device)[None] * 32
    a = torch.clamp(c_lo - w, 0, 32)
    b = torch.clamp(torch.maximum(c_hi, c_lo) - w, 0, 32)
    return ((1 << b) - 1) & ~((1 << a) - 1)


def _popcount(x):
    """Set bits of each int64 entry holding a u32 value."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 & 0xFFFFFFFF) >> 24


def distributed_scan_count(shards: np.ndarray, mask_table: np.ndarray,
                           consts: dict, D: int, mesh=None,
                           costs: tuple | None = None,
                           n_bytes: int | None = None):
    """Scan shards over the mesh; returns (total_event_count,
    per_shard_event_counts int64[n]).

    Each shard counts its part-pulse events (state_D & endpos) past its
    halo, in bytes [halo, halo + valid) of the shard, valid being its
    share of the first n_bytes stream bytes (default: all), so that
    events in the trailing fill are not counted.  The halo length is
    consts["shard_halo"] (default MAX_RECORD)."""
    import torch
    if mesh is None:
        mesh = make_mesh()
    n = shards.shape[0]
    halo = consts.get("shard_halo", MAX_RECORD)
    shard_len = shards.shape[1] - halo
    if n_bytes is None:
        n_bytes = n * shard_len
    hits, W = _scan_shards(shards, mask_table, consts, D, mesh, costs)
    counts = []
    for i, h in enumerate(hits):
        valid = int(np.clip(n_bytes - i * shard_len, 0, shard_len))
        mask = _body_mask(h.shape[0], h.shape[1], W, halo, halo + valid,
                          h.device)
        counts.append(_popcount(h & mask).sum().to(mesh[0]))
    locals_ = torch.stack(counts).cpu().numpy()
    return int(locals_.sum()), locals_


def distributed_scan_offsets(shards: np.ndarray, starts: np.ndarray,
                             n_bytes: int, mask_table: np.ndarray,
                             consts: dict, D: int, mesh=None,
                             costs: tuple | None = None) -> np.ndarray:
    """Scan shards over the mesh and return the GLOBAL sorted offsets of
    part-pulse events -- the reference's output ordering (byte order
    within the stream), imposed by a host merge.

    Each shard keeps only the events of its own body (halo columns
    dropped), so an event in an overlap is reported once, by the shard
    that owns its byte."""
    import torch
    if mesh is None:
        mesh = make_mesh()
    halo = consts.get("shard_halo", MAX_RECORD)
    shard_len = shards.shape[1] - halo
    hits, W = _scan_shards(shards, mask_table, consts, D, mesh, costs)
    outs = []
    for i, h in enumerate(hits):
        T, n_words = h.shape
        h = (h & _body_mask(T, n_words, W, halo, halo + shard_len,
                            h.device)).flatten()
        nz = torch.nonzero(h).flatten()
        shifts = torch.arange(32, dtype=torch.int64, device=h.device)
        bits = ((h[nz][:, None] >> shifts) & 1) != 0
        col = ((nz % n_words) * 32)[:, None] + shifts
        pos = ((nz // n_words) * TILE)[:, None] + col - W - halo
        pos = pos[bits].cpu().numpy() + int(starts[i])
        outs.append(pos[pos < n_bytes])
    return np.concatenate(outs)   # shard order == byte order
