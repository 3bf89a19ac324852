"""Scan operators: the bit-parallel automata.

bitword  -- scalar (python int) per-byte step functions; the executable
            spec used by unit tests.
scan     -- the windowed-parallel shift-or scan over tiled byte streams;
            routes to the CUDA kernel, its plain PyTorch version, or the
            numpy/native host backend.
kernels  -- the mask-machine kernel's wrapper (csrc/mask_scan.cu), its
            plain PyTorch version and the packed-plane readback.
_cuda    -- builds the CUDA sources with nvcc and loads them with ctypes.
"""
