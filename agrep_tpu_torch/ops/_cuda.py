"""Build the CUDA sources under csrc/ with nvcc and load them with ctypes.

Each source becomes one shared library with a plain C interface, built
on first use into build/kernels/ at the root of the checkout (a directory
.gitignore lists).  A source listed in UNITS is compiled as several
objects, one nvcc process each with its own -D flags, all started
together, and then linked:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c [-D...] -o <unit>.o csrc/<name>.cu
    nvcc -shared -o lib<name>-<hash>.so <unit>.o ...

The library's name carries a hash of the source and of every header
under csrc/ (*.cuh), so an edited source is never served by a stale
library.  The link goes to a temporary name that is renamed into place,
so concurrent processes never load half a file.  A missing nvcc or a
failed compile raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v")

# Every kernel source under csrc/; build_all(SOURCES) builds them all at
# once.
SOURCES = ("mask_scan", "renfa_lanes", "chain_scan", "qgram_filter",
           "event_pairs", "record_verdicts", "line_index", "line_rows",
           "qgram_lines", "line_terms", "bitap_lanes")

# Compile units of each source: the kernels of each D in an object of
# their own, so their compiles run side by side.  A source not listed is
# one compile unit.
UNITS = {
    "mask_scan": [()] + [("-DMASK_SCAN_D=%d" % d,) for d in range(9)],
    "renfa_lanes": [()] + [("-DRENFA_D=%d" % d,) for d in range(5)],
    "bitap_lanes": [()] + [("-DBITAP_D=%d" % d,) for d in range(9)],
}

_lock = threading.Lock()
_libs: dict = {}
build_logs: dict = {}       # name -> nvcc/ptxas output of this process's build


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "$CUDA_HOME/bin): the CUDA kernels of "
                           "agrep_tpu_torch are built from source at "
                           "first use")
    return path


def library_path(name: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name, h.hexdigest()[:16]))


def _check(proc, what: str, log: str) -> None:
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on %s (exit %d):\n%s"
                           % (what, proc.returncode, log))


def build_all(names) -> dict:
    """Compile every unit of every named source at once (each unless its
    library exists), link each library; returns {name: library path}."""
    nvcc = _nvcc()
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for n in todo:
        src = os.path.join(CSRC, n + ".cu")
        for i, flags in enumerate(UNITS.get(n, [()])):
            obj = "%s.%d.%d.o" % (paths[n], i, os.getpid())
            cmd = [nvcc, *NVCC_FLAGS, *flags, "-c", "-o", obj, src]
            jobs.append((n, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    # wait for every compile before reporting any failure, so that no
    # nvcc outlives this call
    outs = [proc.communicate()[0] for _n, _obj, proc in jobs]
    logs = {n: [] for n in todo}
    objs = {n: [] for n in todo}
    for (n, obj, proc), out in zip(jobs, outs):
        _check(proc, os.path.basename(obj), out)
        logs[n].append(out)
        objs[n].append(obj)
    for n in todo:
        tmp = "%s.tmp%d" % (paths[n], os.getpid())
        proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp,
                               *objs[n]], capture_output=True, text=True)
        _check(proc, "the link of " + n, proc.stdout + proc.stderr)
        os.replace(tmp, paths[n])
        for obj in objs[n]:
            os.remove(obj)
        build_logs[n] = "".join(logs[n])
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all([name])[name])
            _libs[name] = lib
        return lib


def check(lib, kernel: str, err: int, what: str) -> None:
    """Raises on a non-zero cudaError_t from the C entry point of
    kernel's library (its <kernel>_error_string names the error)."""
    if err != 0:
        msg = getattr(lib, kernel + "_error_string")(err).decode()
        raise RuntimeError("%s %s failed: %s (%d)" % (kernel, what, msg, err))


def device_index(device) -> int:
    """The CUDA device of a tensor's device or a device spec: its own
    index, or the current device where it names none ("cuda")."""
    import torch
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def query(lib, kernel: str, fn: str, index: int, n_out: int, *args) -> tuple:
    """The n_out ints that the library's C function fn(*args, int*, ...)
    writes, called on CUDA device `index` (a geometry query)."""
    import torch
    vals = [ctypes.c_int() for _ in range(n_out)]
    with torch.cuda.device(index):
        check(lib, kernel, getattr(lib, fn)(
            *args, *(ctypes.byref(v) for v in vals)), "geometry")
    return tuple(v.value for v in vals)
