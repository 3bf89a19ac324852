"""Scaling out: corpus shards over devices, files over processes.

The reference is single-threaded C (SURVEY.md section 2.3); this layer
is new design.  dist: a corpus is cut into byte shards with a
max-record halo each, every shard is scanned by the mask-machine kernel
on its device, and the counts and match offsets are merged on the host.
multihost: files are partitioned over torch.distributed ranks, and each
rank's output is gathered and re-assembled in global file order.
"""

from .dist import (distributed_scan_count, distributed_scan_offsets,
                   make_mesh, shard_corpus)

__all__ = ["make_mesh", "distributed_scan_count",
           "distributed_scan_offsets", "shard_corpus"]
