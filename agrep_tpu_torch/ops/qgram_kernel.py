"""The q-gram kernel: dense 2-gram membership filter for the -f engine.

qgram_filter() marks, at every byte position i of a flat u8 text tensor,
whether the folded 2-gram hash

    h = ((text[i] & 31) << 5) | (text[i-1] & 31)      (text[-1] read as 0)

belongs to a 1024-bit member set, packed 32 positions to a word (bit r of
word w is position 32*w + r).  On a CUDA tensor it launches the
hand-written Hopper kernel csrc/qgram_filter.cu (built and loaded by
ops/_cuda.py) or raises; on a CPU tensor it runs qgram_reference(), the
plain PyTorch version of the same function.  qgram_candidates() turns the
plane into positions.

The hash is the non-LONG prepf 2-gram (newmgrep.c:1741-1743); for LONG
(3-gram) tables compile/multi.py member_projection_1024 gives the sound
tail-2-gram superset, and the engine's sparse verify stays exact.  The
member set travels as 32 u32 words (bit p of word c is member (c << 5) |
p), held in an int32 tensor.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _cuda
from .chain_kernel import pack_bits, plane_positions
from .kernels import _sm_count

# Launches of each kernel since the counts were last set to 0.
launches = {"qgram_filter": 0}


def member_words(member: np.ndarray) -> tuple:
    """bool[1024] -> 32 u32 words; bit p of word c == member of hash
    (c << 5) | p."""
    if member.shape != (1024,):
        raise ValueError("member set must be bool[1024], got %r"
                         % (member.shape,))
    out = []
    for c in range(32):
        w = 0
        for p in range(32):
            if member[(c << 5) | p]:
                w |= 1 << p
        out.append(w)
    return tuple(out)


def words_tensor(member: np.ndarray, device="cpu") -> torch.Tensor:
    """The member set as the kernel takes it: int32[32] holding the u32
    words of member_words."""
    w = np.asarray(member_words(np.asarray(member, dtype=bool)),
                   dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32).copy()).to(device)


def qgram_filter(text: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Candidate plane int32[ceil(N/32)] of the member words over text
    (module docstring).  A CUDA tensor goes to the kernel, a CPU tensor
    to qgram_reference."""
    if text.dtype != torch.uint8 or text.dim() != 1:
        raise TypeError("text must be a 1-D uint8 tensor, got %s %r"
                        % (text.dtype, tuple(text.shape)))
    if not text.is_contiguous():
        raise ValueError("text must be contiguous")
    if text.numel() == 0:
        raise ValueError("empty text")
    if words.dtype != torch.int32 or tuple(words.shape) != (32,):
        raise TypeError("words must be int32[32], got %s %r"
                        % (words.dtype, tuple(words.shape)))
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    if text.device != words.device:
        raise ValueError("text on %s but the member words on %s"
                         % (text.device, words.device))
    if text.is_cuda:
        return _launch(text, words)
    if text.device.type == "cpu":
        return qgram_reference(text, words)
    raise ValueError("no q-gram kernel for device %s" % text.device)


def _bind():
    lib = _cuda.load("qgram_filter")
    if not getattr(lib, "_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ip = ctypes.POINTER(ctypes.c_int)
        lib.qgram_filter_launch.restype = i
        lib.qgram_filter_launch.argtypes = [p, ll, p, p, i, p]
        lib.qgram_filter_geometry.restype = i
        lib.qgram_filter_geometry.argtypes = [ip, ip]
        lib.qgram_filter_error_string.restype = ctypes.c_char_p
        lib.qgram_filter_error_string.argtypes = [i]
        lib._bound = True
    return lib


@functools.lru_cache(maxsize=None)
def _kernel_geometry(index: int) -> tuple:
    """(threads a block, blocks an SM holds) on device `index`, asked of
    the CUDA runtime once."""
    return _cuda.query(_bind(), "qgram_filter", "qgram_filter_geometry",
                       index, 2)


def launch_geometry(N: int, device, blocks_per_sm: int | None = None
                    ) -> dict:
    """What _launch runs for a filter of N bytes on a CUDA device:
    threads a block (a thread a 32-position word), blocks an SM (by
    default all that the SM holds, from the CUDA occupancy calculator)
    and the grid (never more blocks than the words fill)."""
    index = torch.device(device).index or 0
    threads, fits = _kernel_geometry(index)
    if blocks_per_sm is None:
        blocks_per_sm = fits
    n_words = -(-N // 32)
    return {"threads": threads, "blocks_per_sm": blocks_per_sm,
            "fits_per_sm": fits, "words": n_words,
            "grid": max(1, min(-(-n_words // threads),
                               blocks_per_sm * _sm_count(index)))}


def _launch(text: torch.Tensor, words: torch.Tensor,
            blocks_per_sm: int | None = None) -> torch.Tensor:
    """The kernel on text's device; blocks_per_sm defaults to
    launch_geometry's choice."""
    lib = _bind()
    N = text.numel()
    geo = launch_geometry(N, text.device, blocks_per_sm)
    out = torch.empty(-(-N // 32), dtype=torch.int32, device=text.device)
    stream = torch.cuda.current_stream(text.device).cuda_stream
    _cuda.check(lib, "qgram_filter", lib.qgram_filter_launch(
        text.data_ptr(), N, words.data_ptr(), out.data_ptr(), geo["grid"],
        stream), "kernel launch")
    launches["qgram_filter"] += 1
    return out


def qgram_reference(text: torch.Tensor, words: torch.Tensor
                    ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: a gather of
    every position's hash from the 1024-entry member table."""
    dev = text.device
    w = words.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    table = (((w[:, None] >> shifts) & 1) != 0).flatten()      # [1024]
    f = (text & 31).long()
    prev = torch.zeros_like(f)
    prev[1:] = f[:-1]
    return pack_bits(table[(f << 5) | prev])


def qgram_candidates(text: torch.Tensor,
                     member1024: np.ndarray) -> np.ndarray:
    """Candidate positions i (text coords) where the 2-gram (text[i-1],
    text[i]) is a member, int64 on the host; position 0 is tested
    against a zero previous byte.  text: a u8 tensor (CUDA: the kernel;
    CPU: the plain version)."""
    words = words_tensor(member1024, text.device)
    return plane_positions(qgram_filter(text, words), text.numel())
