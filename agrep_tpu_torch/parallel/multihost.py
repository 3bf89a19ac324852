"""Multi-process search on torch.distributed (SURVEY.md sections 2.3, 5).

The scan itself never communicates (each shard carries its own halo,
parallel/dist.py); a run of several processes only needs
  * a process group, initialised from torchrun's env:// contract
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, and LOCAL_RANK where
    set), with each rank bound to its own CUDA device before any tensor
    is made: cuda:(LOCAL_RANK % device_count), so that two ranks may
    share one card;
  * a deterministic file partition, so that the merge can impose the
    reference's global ordering (file order x byte offset,
    agrep.c:3229-3231);
  * a few collectives of host data: every rank's output bytes, its
    (file, count, total_line) rows and its match count.

The process group is gloo, with fixed timeouts.  Every collective of
this layer moves host data -- output byte blobs, int64 rows, one count --
so a CPU transport fits; gloo also joins two ranks that share one GPU,
which NCCL refuses, and runs the CPU tests.  The scans themselves stay on
each rank's card.  A peer that dies closes its sockets and the others
raise at their next collective; a peer that hangs fails them after
TIMEOUT_S, not after torch's 30-minute default.  The rendezvous gives up
after RENDEZVOUS_S (a rank that never finds its master retries its
connect once, so it raises after about twice that).

There is no quiet single-process run: without WORLD_SIZE (or with
WORLD_SIZE=1) init_multihost() is (0, 1), and with WORLD_SIZE > 1 a
failed initialisation raises.
"""

from __future__ import annotations

import atexit
import os
from datetime import timedelta

import numpy as np

# seconds a rank waits for its peers at a collective (a serial mode's
# ranks wait there while rank 0 searches alone), and at the rendezvous
TIMEOUT_S = 600
RENDEZVOUS_S = 60


def requested() -> bool:
    """True when the environment asks for a run of several processes:
    MASTER_ADDR set and WORLD_SIZE above 1."""
    return (bool(os.environ.get("MASTER_ADDR"))
            and int(os.environ.get("WORLD_SIZE", "1")) > 1)


def _dist():
    import torch.distributed as dist
    return dist


def _active() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def init_multihost() -> tuple[int, int]:
    """Initialise the gloo process group from the env:// variables and
    bind this rank's CUDA device.  Returns (rank, world size); (0, 1)
    when WORLD_SIZE is unset or 1.  Idempotent: later calls return the
    group's (rank, size).  Raises on any failure."""
    dist = _dist()
    if _active():
        return dist.get_rank(), dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 0, 1
    rank = int(os.environ["RANK"])
    from ..ops import scan as scan_ops
    scan_ops.require_device()
    if scan_ops._BACKEND == "torch" and scan_ops._DEVICE == "cuda":
        import torch
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    store = dist.TCPStore(os.environ["MASTER_ADDR"],
                          int(os.environ["MASTER_PORT"]), world, rank == 0,
                          timedelta(seconds=RENDEZVOUS_S))
    dist.init_process_group("gloo", store=store, world_size=world, rank=rank,
                            timeout=timedelta(seconds=TIMEOUT_S))
    atexit.register(dist.destroy_process_group)
    return rank, world


def process_index() -> int:
    return _dist().get_rank() if _active() else 0


def process_count() -> int:
    return _dist().get_world_size() if _active() else 1


def is_primary() -> bool:
    """True on the output-owning process (rank 0), and always True
    single-process -- gates the Grand Total line and stdout writes."""
    return process_index() == 0


def assign_files(files: list[str], num_processes: int,
                 process_id: int) -> list[tuple[int, str]]:
    """Deterministic per-rank file assignment: file i goes to rank
    i % num_processes.  Returns (global_index, path) pairs so each
    rank's results can be merged back in file order."""
    return [(i, f) for i, f in enumerate(files)
            if i % num_processes == process_id]


def run_with_requeue(items: list, worker, retries: int = 1) -> list:
    """Run worker(item) over items with failure re-queueing: a failed
    item is retried `retries` times, then its error propagates -- there
    is no switch to another backend (SURVEY section 5 'a failed host's
    file shards get re-queued').  Returns results in item order."""
    results = [None] * len(items)
    queue = [(i, 0) for i in range(len(items))]
    while queue:
        i, attempt = queue.pop(0)
        try:
            results[i] = worker(items[i])
        except Exception:
            if attempt >= retries:
                raise
            queue.append((i, attempt + 1))
    return results


def _allgather(arr: np.ndarray) -> np.ndarray:
    """Every rank's array of one shape and dtype, stacked in rank order."""
    import torch
    dist = _dist()
    t = torch.from_numpy(np.ascontiguousarray(arr))
    outs = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(outs, t)
    return torch.stack(outs).numpy()


def gather_pieces(local_blob: bytes, marks: list,
                  local_count: int) -> tuple[list, int]:
    """All-gather every rank's per-file output chunks; returns
    ((global_file_index, bytes) pairs sorted in global file order,
    global_match_count) -- identical on every rank."""
    arr = np.frombuffer(local_blob, dtype=np.uint8)
    meta = np.asarray([len(arr), len(marks), local_count], dtype=np.int64)
    metas = _allgather(meta)
    total = int(metas[:, 2].sum())
    maxb = max(1, int(metas[:, 0].max()))
    maxm = max(1, int(metas[:, 1].max()))
    pb = np.zeros(maxb, dtype=np.uint8)
    pb[:len(arr)] = arr
    blobs = _allgather(pb)
    mk = np.full((maxm, 2), -1, dtype=np.int64)
    for i, (gi, off) in enumerate(marks):
        mk[i] = (gi, off)
    mks = _allgather(mk)
    pieces = []
    for p in range(len(metas)):
        nb, nm = int(metas[p, 0]), int(metas[p, 1])
        for i in range(nm):
            gi, off = int(mks[p, i, 0]), int(mks[p, i, 1])
            end = int(mks[p, i + 1, 1]) if i + 1 < nm else nb
            pieces.append((gi, blobs[p, off:end].tobytes()))
    pieces.sort(key=lambda t: t[0])
    return pieces, total


def merge_outputs(local_blob: bytes, marks: list,
                  local_count: int) -> tuple[bytes, int]:
    """All-gather every rank's per-file output chunks and rebuild the
    single stream in GLOBAL file order (the reference's ordering
    contract: file order x byte offset, agrep.c:3229-3231).

    local_blob: this rank's concatenated per-file output;
    marks: (global_file_index, start_offset_in_blob) pairs, ascending.
    Returns (merged_bytes, global_match_count) -- identical on every
    rank; only rank 0 should write the bytes."""
    pieces, total = gather_pieces(local_blob, marks, local_count)
    return b"".join(b for _, b in pieces), total


def allgather_rows(rows: np.ndarray) -> np.ndarray:
    """All-gather variable-count int64 rows from every rank.
    rows: (n, k) local array; returns the concatenation over all ranks
    (padded exchange, then trimmed); a 1-D array is one column.  A rank
    with no rows passes an empty array."""
    rows = np.asarray(rows, dtype=np.int64)
    if rows.ndim == 1:
        rows = rows[:, None]
    k = rows.shape[1] if rows.size else 1
    metas = _allgather(np.asarray([len(rows), k], dtype=np.int64))
    maxn = max(1, int(metas[:, 0].max()))
    k = max(k, int(metas[:, 1].max()))
    pad = np.zeros((maxn, k), dtype=np.int64)
    if rows.size:
        pad[:len(rows), :rows.shape[1]] = rows
    alls = _allgather(pad)
    return np.concatenate([alls[p, :int(metas[p, 0])]
                           for p in range(alls.shape[0])])


def global_count(local_count: int) -> int:
    """The Grand Total: an all_reduce of every rank's match count
    (single-process: identity)."""
    if not _active():
        return int(local_count)
    import torch
    t = torch.tensor([int(local_count)], dtype=torch.int64)
    _dist().all_reduce(t)
    return int(t.item())
