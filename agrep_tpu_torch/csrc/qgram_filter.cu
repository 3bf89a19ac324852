// Dense 2-gram membership filter for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// agrep_tpu/ops/qgram_kernel.py::_get_qgram_kernel (the `run` it returns,
// pl.pallas_call at qgram_kernel.py:102).  It computes the same function,
//     cand[i] = member[((text[i] & 31) << 5) | (i > 0 ? text[i-1] & 31 : 0)],
// packed 32 positions to a u32 word (bit r of word w: position 32*w + r),
// with the 1024-bit member set given as 32 u32 words (bit p of word c is
// member (c << 5) | p).  The TPU kernel selected the word through a
// 5-level blend tree over 32 constants and carried the previous byte in
// scratch across grid steps; neither carries over.
//
// What bounds it on an H100: bytes.  The function reads N bytes and
// writes N/8, 0.0352 ms per 100 MB at 3.35 TB/s; its least work, about
// four int32 operations and one shared load a byte (chip_smoke.py
// qgram_ops), takes a little less.  What the design does about it:
//
//   * A thread owns one 32-position output word.  It reads its 32 bytes
//     as two 16-byte loads (a warp's two loads cover 1 KB of text).  When
//     the text does not start on a 16-byte boundary, it loads the three
//     aligned pieces around them and funnel-shifts the 32 bytes out; a
//     piece that is not wholly inside [text, text + n) is read byte by
//     byte, bytes outside as 0, so no load leaves the text.
//   * The previous byte of the word's first position is the last byte of
//     the neighbouring lane's word (__shfl_up_sync); lane 0 loads it
//     itself, and position 0 reads it as 0.
//   * The 32 member words sit in shared memory, one per bank, so a warp's
//     lookups never conflict (equal words broadcast).  A byte costs a
//     byte extract (its low 5 bits times 4: the word's address), the
//     load, a rotate of the word by the previous byte's low 5 bits (a
//     wrapping funnel shift, which reads only those bits) and a funnel
//     shift of the result's bit 0 into the output word.
//   * One coalesced 4-byte store a word; bits past n are 0.  A grid-stride
//     loop over a warp's 32 words at a time, with as many blocks as the
//     SMs hold.
//
// Built by ops/_cuda.py as one object with a plain C interface:
// nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
// -fPIC.

#include <cstdint>
#include <cuda_runtime.h>

#include "text_piece.cuh"

namespace qgram_filter {

constexpr int kThreads = 256;

namespace {

__global__ void __launch_bounds__(kThreads)
qgram_filter_kernel(const uint8_t* __restrict__ text, long long n,
                    const uint32_t* __restrict__ words,
                    uint32_t* __restrict__ out, long long n_words) {
    __shared__ uint32_t s_words[32];
    if (threadIdx.x < 32) s_words[threadIdx.x] = words[threadIdx.x];
    __syncthreads();
    const uintptr_t lo = reinterpret_cast<uintptr_t>(text);
    const uintptr_t hi = lo + (uintptr_t)n;
    const int sh = (int)(lo & 15);      // the same for every word
    const int lane = threadIdx.x & 31;
    const long long step = ((long long)gridDim.x * kThreads) & ~31LL;
    for (long long w0 = ((long long)blockIdx.x * kThreads + threadIdx.x)
                        & ~31LL;
         w0 < n_words; w0 += step) {
        const long long w = w0 + lane;
        uint32_t x[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
        if (w < n_words) text_word32(lo, hi, sh, w, x);
        // the byte before position 32 w: lane - 1's last byte
        uint32_t rot = __shfl_up_sync(0xffffffffu, x[7] >> 24, 1);
        if (lane == 0)
            rot = w > 0 && w < n_words ? __ldg(text + 32 * w - 1) : 0u;
        uint32_t res = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const uint32_t c4 = (x[i] & 0x1f1f1f1fu) << 2;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const uint32_t m = *reinterpret_cast<const uint32_t*>(
                    reinterpret_cast<const uint8_t*>(s_words)
                    + __byte_perm(c4, 0, 0x4440 + k));
                // bit (previous byte & 31) of m, shifted in from the top
                res = __funnelshift_r(res, __funnelshift_r(m, m, rot), 1);
                rot = x[i] >> (8 * k);
            }
        }
        if (w < n_words) {
            const long long left = n - 32 * w;
            if (left < 32) res &= (1u << left) - 1u;
            out[w] = res;
        }
    }
}

}  // namespace
}  // namespace qgram_filter

using namespace qgram_filter;

extern "C" {

// Threads a block, and how many such blocks one SM of the current device
// holds.  Returns a cudaError_t.
int qgram_filter_geometry(int* threads, int* blocks_per_sm) {
    *threads = kThreads;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, qgram_filter_kernel, kThreads, 0);
}

// Launches the filter on `stream` with `grid` blocks (at most one thread
// a word); returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).  All
// pointers are device pointers; text u8[n] may start at any address,
// words u32[32], out u32[ceil(n / 32)].
int qgram_filter_launch(const uint8_t* text, long long n,
                        const uint32_t* words, uint32_t* out, int grid,
                        void* stream) {
    if (n < 1 || grid < 1) return (int)cudaErrorInvalidValue;
    const long long n_words = (n + 31) / 32;
    const long long need = (n_words + kThreads - 1) / kThreads;
    if (grid > need) grid = (int)need;
    qgram_filter_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        text, n, words, out, n_words);
    return (int)cudaGetLastError();
}

const char* qgram_filter_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
