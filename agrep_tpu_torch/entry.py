"""Entry points: one step of the flagship scan, and a dry run of
the sharded search.

The "flagship model" of this system is the k-error bit-parallel scan
machine (the Wu-Manber automaton, here csrc/mask_scan.cu); its "step" is
one mask_scan launch over a tiled text.  The sharded search cuts a
corpus into halo-carrying shards, scans each on a device of the mesh
and merges the counts on the host.  Both run on the scan device of
ops/scan.py: the card unless the caller asks for the CPU.

    python -m agrep_tpu_torch.entry [n_shards]
"""

from __future__ import annotations

import io
import os
import sys
import tempfile

import numpy as np

W, L = 48, 1024


def _example_query():
    from .compile.query import compile_query
    from .options import Options
    # linenum forces the full mask-machine (bitap) path, the flagship
    # kernel (checksg.c:132 bars the simple path when -n is on)
    q = compile_query("matching", Options(D=2, approx=True, linenum=True))
    if q.engine_class != "bitap":
        raise RuntimeError("-2 -n matching compiled to %s, not bitap"
                           % q.engine_class)
    return q


def _planted_text(n: int, seed: int, every: int, offsets) -> np.ndarray:
    rng = np.random.default_rng(seed)
    text = rng.integers(32, 127, size=n, dtype=np.uint8)
    text[::every] = 0x0A
    pat = np.frombuffer(b"matching", dtype=np.uint8)
    for off in offsets:
        text[off:off + len(pat)] = pat
    return text


def entry():
    """Returns (fn, example_args): fn(text, machine) is one mask_scan
    launch of the flagship -2 -n matching bitap machine over 8 KB of
    text, on the scan device."""
    import torch

    from .ops import kernels
    from .ops import scan as scan_ops
    scan_ops.require_device()
    dev = torch.device(scan_ops._DEVICE)
    q = _example_query()
    mach = kernels.machine_from_arrays(q.folded_mask, q.consts, q.D,
                                       "bitap", None, dev)
    text = kernels.to_device(_planted_text(8192, 0, 70, (300, 5000)), dev)

    def fn(text, machine):
        return kernels.mask_scan(text, machine, W, L)

    return fn, (text, mach)


def dryrun_multichip(n_shards: int) -> None:
    """Three checks of the sharded search over n_shards shards on
    make_mesh(), each raising on any difference:
      * distributed_scan_count over a text with planted matches, against
        the single-stream scan;
      * the engine end to end (fileagrep -2 -n matching) on the torch
        backend against the numpy host backend;
      * the chain kernel over n_shards pieces of a text, each carrying a
        tail halo of the longest term less one byte, on its mesh device:
        the merged starts against chain_scan_reference over the whole
        text."""
    import torch

    from . import api
    from .ops import chain_kernel as CK
    from .ops import scan as scan_ops
    from .parallel.dist import (distributed_scan_count, make_mesh,
                                shard_corpus)

    mesh = make_mesh()
    q = _example_query()
    n = n_shards * 4096
    text = _planted_text(n, 1, 60, (100, 5000, n - 300))

    halo = 256
    shards, _ = shard_corpus(text, n_shards, overlap=halo)
    consts = dict(q.consts)
    consts["shard_halo"] = halo
    total, locals_ = distributed_scan_count(shards, q.folded_mask, consts,
                                            q.D, mesh=mesh)
    ev = scan_ops.scan_events(text, q.folded_mask, q.consts, q.D, "bitap")
    want = int(np.count_nonzero(ev & np.uint32(q.consts["endpos"])))
    if total != want or int(locals_.sum()) != total or total < 3:
        raise RuntimeError("sharded count %d (shards %s) against %d from "
                           "the single-stream scan"
                           % (total, locals_.tolist(), want))

    # the engine end to end on the scan device, against the host backend
    fd, path = tempfile.mkstemp(suffix=".txt")
    backend = scan_ops._BACKEND
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(text.tobytes())
        outs = {}
        for b in ("torch", "numpy"):
            scan_ops.set_backend(b)
            buf = io.BytesIO()
            outs[b] = (api.fileagrep(["-2", "-n", "matching", path],
                                     output=buf), buf.getvalue())
    finally:
        scan_ops.set_backend(backend)
        os.unlink(path)
    if outs["torch"] != outs["numpy"] or outs["torch"][0] < 3:
        raise RuntimeError("engine output on the torch backend (%d "
                           "records) differs from the numpy backend's (%d)"
                           % (outs["torch"][0], outs["numpy"][0]))

    # the chain kernel over pieces with tail halos, one a mesh device
    terms = [b"matching", b"alpha", b"qqz"]
    prog = CK.compile_chain(terms, np.arange(256, dtype=np.uint8))
    if prog is None:
        raise RuntimeError("the chain program did not compile")
    rng = np.random.default_rng(3)
    ctext = rng.choice(np.frombuffer(b"matching alpha x\n", np.uint8),
                       n_shards * 16384)
    tail = max(len(t) for t in terms) - 1
    piece = -(-len(ctext) // n_shards)
    # every term at random offsets and straddling every piece boundary
    for k, t in enumerate(terms):
        tb = np.frombuffer(t, dtype=np.uint8)
        for off in [*rng.integers(0, len(ctext) - len(t), 16),
                    *(b - 1 - k for b in range(piece, len(ctext), piece))]:
            ctext[off:off + len(t)] = tb
    got = []
    for i in range(n_shards):
        lo = i * piece
        hi = min(len(ctext), lo + piece)
        dev = mesh[i % len(mesh)]
        seg = torch.from_numpy(ctext[lo:min(len(ctext), hi + tail)]).to(dev)
        starts = CK.chain_match_starts(seg, CK.device_program(prog, dev))
        got.append(starts[starts < hi - lo] + lo)
    got = np.concatenate(got)
    whole = torch.from_numpy(ctext)
    want_c = CK.plane_positions(
        CK.chain_scan_reference(whole, CK.device_program(prog, "cpu")),
        len(ctext))
    if not np.array_equal(got, want_c) or len(want_c) == 0:
        raise RuntimeError("sharded chain starts (%d) differ from "
                           "chain_scan_reference over the whole text (%d)"
                           % (len(got), len(want_c)))
    print("dryrun_multichip: %d shards on %s, %d events, engine path ok "
          "(%d records), chain kernel sharded ok (%d starts)"
          % (n_shards, ", ".join(sorted({str(d) for d in mesh})), total,
             outs["torch"][0], len(want_c)))


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", tuple(fn(*args).shape))
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
