// 16-byte loads of a text that may start at any address, for the
// kernels that read a text in aligned 16-byte pieces (renfa_lanes.cu,
// qgram_filter.cu).  Included by their sources; ops/_cuda.py hashes
// every header under csrc/ into each library's name.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// The 16 bytes at address a (16-byte aligned), as four words: one
// 16-byte load when they lie inside [lo, hi), else byte loads, with the
// bytes outside as 0.
__device__ __forceinline__ uint4 text_piece(uintptr_t a, uintptr_t lo,
                                            uintptr_t hi) {
    if (a >= lo && a + 16 <= hi)
        return __ldg(reinterpret_cast<const uint4*>(a));
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 16; ++b)
        if (a + b >= lo && a + b < hi)
            w[b >> 2] |= (uint32_t)__ldg(reinterpret_cast<const uint8_t*>(
                             a + b)) << (8 * (b & 3));
    return make_uint4(w[0], w[1], w[2], w[3]);
}
