"""agrep_tpu_torch -- the PyTorch/CUDA port of the agrep_tpu
package.

The same capability surface as agrep_tpu (agrep 3.41.5/TG, Wu/Manber/
Gopal/Gries): the CLI, the library API (Query/fileagrep/memagrep) and
byte-exact output and exit codes.  The host modules (options, compile,
runtime, native, api, cli) are agrep_tpu's, copied with their logic
unchanged; the device layer (ops.scan, ops.kernels) is rewritten for an
NVIDIA Hopper GPU:

* the windowed shift-or mask machine runs as a hand-written CUDA kernel
  (csrc/mask_scan.cu) over tiled byte streams with bounded-window halos,
* its plain PyTorch version (ops.kernels.mask_scan_reference) runs on
  the CPU when the caller asks for it (AGREP_TORCH_DEVICE=cpu),
* AGREP_TORCH_BACKEND=numpy selects the exact host backend instead.

There is no silent fallback: with the default backend and device, a
missing GPU or a failed kernel build or launch raises.
"""

def _tune_malloc() -> None:
    """Keep large numpy temporaries on the retained heap.

    glibc services every allocation above MMAP_THRESHOLD (128KB) with
    a fresh mmap and returns it on free, so each multi-MB scan
    temporary pays first-touch page faults -- on virtualized hosts
    that costs more than the scan itself.  Raising the threshold and
    the trim threshold makes the heap grow once and be reused
    (M_MMAP_THRESHOLD = -3, M_TRIM_THRESHOLD = -1)."""
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-3, 1 << 30)
        libc.mallopt(-1, 1 << 30)
    except Exception:
        pass


_tune_malloc()

from .version import __version__
from .api import Query, fileagrep, memagrep, search_buffer, search_files

__all__ = [
    "__version__",
    "Query",
    "fileagrep",
    "memagrep",
    "search_buffer",
    "search_files",
]
