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
// scratch across grid steps; neither carries over:
//
//   * The 32 member words sit in shared memory, one per bank, so a warp's
//     32 lookups never conflict (equal words broadcast).
//   * One thread tests one byte, reading text[i] and text[i-1] (the
//     second load hits the line its neighbour lane just brought into L1),
//     and __ballot_sync packs the warp's 32 verdicts into the output
//     word, which lane 0 writes.  A grid-stride loop over 32-aligned
//     groups keeps every lane of a warp in every iteration.
//
// What bounds it on an H100: bytes.  The function reads N bytes and
// writes N/8; a few integer operations a byte leave it far from the
// int32 rate.  Known slack left for a later change: byte-wide loads (a
// thread taking 16 bytes with one load, and the packing done with shifts
// instead of a ballot, would issue far fewer load instructions).
//
// Built by ops/_cuda.py as one object with a plain C interface:
// nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
// -fPIC.

#include <cstdint>
#include <cuda_runtime.h>

namespace qgram_filter {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

namespace {

__global__ void __launch_bounds__(kThreads)
qgram_filter_kernel(const uint8_t* __restrict__ text, long long n,
                    const uint32_t* __restrict__ words,
                    uint32_t* __restrict__ out, long long n_words) {
    __shared__ uint32_t s_words[32];
    if (threadIdx.x < 32) s_words[threadIdx.x] = words[threadIdx.x];
    __syncthreads();
    const long long stride = (long long)gridDim.x * kThreads;
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
         i < n_words * 32; i += stride) {
        bool hit = false;
        if (i < n) {
            const uint32_t c = __ldg(text + i) & 31u;
            const uint32_t p = i > 0 ? __ldg(text + i - 1) & 31u : 0u;
            hit = (s_words[c] >> p) & 1u;
        }
        const unsigned word = __ballot_sync(0xffffffffu, hit);
        if ((threadIdx.x & 31) == 0) out[i >> 5] = word;
    }
}

}  // namespace
}  // namespace qgram_filter

using namespace qgram_filter;

extern "C" {

// Launches the filter on `stream`; returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments the kernel does not take).
// All pointers are device pointers: text u8[n], words u32[32], out
// u32[ceil(n / 32)].
int qgram_filter_launch(const uint8_t* text, long long n,
                        const uint32_t* words, uint32_t* out,
                        void* stream) {
    if (n < 1) return (int)cudaErrorInvalidValue;
    const long long n_words = (n + 31) / 32;
    long long blocks = (n_words * 32 + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    qgram_filter_kernel<<<(unsigned)blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        text, n, words, out, n_words);
    return (int)cudaGetLastError();
}

const char* qgram_filter_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
