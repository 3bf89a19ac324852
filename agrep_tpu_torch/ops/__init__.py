"""Scan operators: the bit-parallel automata.

bitword  -- scalar (python int) per-byte step functions; the executable
            spec used by unit tests.
scan     -- the windowed-parallel shift-or scan over tiled byte streams;
            routes to the CUDA kernel, its plain PyTorch version, or the
            numpy/native host backend.
kernels  -- the mask-machine kernel's wrapper (csrc/mask_scan.cu), its
            plain PyTorch version and the packed-plane readback.
renfa_kernel -- the regex lanes kernel (csrc/renfa_lanes.cu) and its
            plain version.
chain_kernel -- the -f engine's exact multi-term start scan
            (csrc/chain_scan.cu), its compiler and plain version.
qgram_kernel -- the -f engine's 2-gram membership filter
            (csrc/qgram_filter.cu) and its plain version.
_cuda    -- builds the CUDA sources with nvcc and loads them with ctypes.
timing   -- the card's clock (CUDA events after a spin, torch.profiler)
            and each kernel's bound.
"""
