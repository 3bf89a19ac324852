// 16-byte loads of a text that may start at any address, for the
// kernels that read a text in aligned 16-byte pieces (renfa_lanes.cu,
// qgram_filter.cu, qgram_lines.cu).  Included by their sources; ops/_cuda.py hashes
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

// The 32 bytes of word w of the text [lo, hi) (positions 32 w .. 32 w +
// 31), as eight words in x; sh = lo & 15.  It loads the two aligned
// pieces that hold them, or the three around them when the text does
// not start on a 16-byte boundary, and funnel-shifts the 32 bytes out;
// bytes outside the text are 0.
__device__ __forceinline__ void text_word32(uintptr_t lo, uintptr_t hi,
                                            int sh, long long w,
                                            uint32_t x[8]) {
    const uintptr_t a = lo + 32 * (uintptr_t)w - sh;
    const uint4 p0 = text_piece(a, lo, hi);
    const uint4 p1 = text_piece(a + 16, lo, hi);
    if (sh == 0) {
        x[0] = p0.x; x[1] = p0.y; x[2] = p0.z; x[3] = p0.w;
        x[4] = p1.x; x[5] = p1.y; x[6] = p1.z; x[7] = p1.w;
        return;
    }
    const uint4 p2 = text_piece(a + 32, lo, hi);
    const uint32_t v[12] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w,
                            p2.x, p2.y, p2.z, p2.w};
    uint32_t y[10], z[9];
#pragma unroll
    for (int k = 0; k < 10; ++k)
        y[k] = (sh & 8) ? v[k + 2] : v[k];
#pragma unroll
    for (int k = 0; k < 9; ++k)
        z[k] = (sh & 4) ? y[k + 1] : y[k];
#pragma unroll
    for (int k = 0; k < 8; ++k)
        x[k] = __funnelshift_r(z[k], z[k + 1], 8 * (sh & 3));
}
