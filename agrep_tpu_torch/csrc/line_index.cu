// Line index of a text chunk, in length order, for NVIDIA Hopper (sm_90a).
//
// Replaces the regex engine's host line index
// (agrep_tpu/runtime/regex_engine.py: `np.flatnonzero(seg == 0x0A)` of a
// chunk, :116 and :149, or of the whole stream, :339 and :349, then
// `np.argsort(line_len, kind="stable")`, :375), which reads every byte of
// the chunk twice on the host and sorts every line length before the lines
// go to the card.  Here the text already lies on the card, and the lines
// are cut and ordered there for renfa_lanes.
//
// The function.  Input: a u8 text of n bytes.  Output, with K the text's
// newlines and nl[j] the position of the j-th (line j is
// [start_j, nl[j]), start_0 = 0 and start_j = nl[j-1] + 1 after):
//   * nl, int64 [K], in stream order; the last newline, nl[K-1], is where
//     the caller cuts the next chunk;
//   * the lines in length order: starts, lens and ords, int64 [K] each,
//     ords[q] the stream ordinal of the q-th line in that order.
// The order is a stable counting sort by len_key(len): the exact length
// below 128 bytes, sixteen steps an octave from 128 to 8,191 bytes (a
// step's lengths differ by at most 1/16), and every line of 8,192 bytes
// or more last, in stream order.  renfa_lanes walks a warp's 32 lines
// side by side, so neighbours of close lengths end together; 225 keys keep
// the sort one pass with a histogram a block, where exact lengths up to
// 8,192 would need 8,193 bins a block or two radix passes.
//
// What bounds it on an H100: bytes.  It must read the text once and write
// 32 bytes a line: at config 4's 32 MB chunk (684,929 lines) about 55 MB,
// 16 us at 3.35 TB/s.  The design is the simple one:
//
//   * Pass 1 (count_kernel): each block counts the newlines of its
//     kBytesPerBlock bytes, read as aligned 16-byte pieces (text_piece.cuh:
//     the bytes outside the text read as 0), and the last one's position.
//   * The wrapper takes the exclusive prefix sum of the block counts on
//     the card (one torch.cumsum) and reads K and the last newline.
//   * Pass 2 (write_kernel) counts again, scans the threads' counts across
//     the block (warp shuffles, then the warps' totals in shared memory),
//     and each thread writes its newlines' positions from its offset.
//   * Pass 3 (hist_kernel): each block histograms the keys of its
//     kLinesPerBlock lines in shared memory and writes them key-major,
//     hist[key * grid + block], so that one exclusive torch.cumsum over
//     the flat array gives each (key, block) its first slot.
//   * Pass 4 (scatter_kernel): each block walks its lines in rounds of one
//     a thread, in stream order.  A warp ranks its lanes of equal key
//     (__match_any_sync), the warps' counts of each key go through shared
//     memory, and a running count a key carries the block's earlier
//     rounds: each line lands after every earlier line of its key, so the
//     sort is stable.
//
// Built by ops/_cuda.py as one object with a plain C interface:
// nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
// -fPIC.

#include <cstdint>
#include <cuda_runtime.h>

#include "text_piece.cuh"

namespace line_index {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;
constexpr int kBytesPerBlock = kThreads * 16 * kRounds;
constexpr int kLineRounds = 8;
constexpr int kLinesPerBlock = kThreads * kLineRounds;
constexpr int kKeys = 225;

struct Text {
    const uint8_t* text;
    long long n;
    uintptr_t lo, hi, base;         // [lo, hi) the text; base = lo & ~15
    long long pieces;               // 16-byte pieces from base to hi
};

namespace {

Text make_text(const uint8_t* text, long long n) {
    Text t;
    t.text = text;
    t.n = n;
    t.lo = reinterpret_cast<uintptr_t>(text);
    t.hi = t.lo + (uintptr_t)n;
    t.base = t.lo & ~(uintptr_t)15;
    t.pieces = (long long)((t.hi - t.base + 15) / 16);
    return t;
}

// Bit b set where byte b of piece g is a newline of the text.
__device__ __forceinline__ uint32_t newline_bits(const Text& t, long long g) {
    const uint4 v = text_piece(t.base + 16 * (uintptr_t)g, t.lo, t.hi);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t m = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const uint32_t e = __vcmpeq4(w[i], 0x0a0a0a0au);   // 0xff a match
        m |= ((e >> 7 & 1u) | (e >> 14 & 2u) | (e >> 21 & 4u)
              | (e >> 28 & 8u)) << (4 * i);
    }
    return m;
}

// Text position of byte b of piece g.
__device__ __forceinline__ long long piece_pos(const Text& t, long long g,
                                               int b) {
    return (long long)(t.base + 16 * (uintptr_t)g + b - t.lo);
}

__global__ void __launch_bounds__(kThreads)
count_kernel(Text t, long long* __restrict__ counts,
             long long* __restrict__ last) {
    __shared__ int s_warp[kWarps];
    __shared__ long long s_last[kWarps];
    const long long g0 = (long long)blockIdx.x * (kBytesPerBlock / 16);
    int c = 0;
    long long mx = -1;
    for (int r = 0; r < kRounds; ++r) {
        const long long g = g0 + r * kThreads + threadIdx.x;
        if (g >= t.pieces) break;
        const uint32_t m = newline_bits(t, g);
        c += __popc(m);
        if (m) mx = piece_pos(t, g, 31 - __clz(m));
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
        c += __shfl_down_sync(0xffffffffu, c, o);
        const long long y = __shfl_down_sync(0xffffffffu, mx, o);
        mx = y > mx ? y : mx;
    }
    if ((threadIdx.x & 31) == 0) {
        s_warp[threadIdx.x >> 5] = c;
        s_last[threadIdx.x >> 5] = mx;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        long long s = 0, l = -1;
        for (int w = 0; w < kWarps; ++w) {
            s += s_warp[w];
            l = s_last[w] > l ? s_last[w] : l;
        }
        counts[blockIdx.x] = s;
        last[blockIdx.x] = l;
    }
}

__global__ void __launch_bounds__(kThreads)
write_kernel(Text t, const long long* __restrict__ offsets,
             long long* __restrict__ nl) {
    __shared__ int s_warp[kWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    long long base = offsets[blockIdx.x];
    const long long g0 = (long long)blockIdx.x * (kBytesPerBlock / 16);
    for (int r = 0; r < kRounds; ++r) {
        const long long g = g0 + r * kThreads + threadIdx.x;
        const uint32_t m = g < t.pieces ? newline_bits(t, g) : 0u;
        // this thread's first newline: those of the block's earlier
        // rounds, earlier warps and earlier lanes
        const int n = __popc(m);
        int x = n;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, x, o);
            if (lane >= o) x += y;
        }
        if (lane == 31) s_warp[warp] = x;
        __syncthreads();
        int before = 0, total = 0;
        for (int w = 0; w < kWarps; ++w) {
            const int s = s_warp[w];
            if (w < warp) before += s;
            total += s;
        }
        long long o = base + before + x - n;
        for (uint32_t k = m; k; k &= k - 1)
            nl[o++] = piece_pos(t, g, __ffs(k) - 1);
        base += total;
        __syncthreads();                // s_warp is rewritten next round
    }
}

__device__ __forceinline__ int len_key(long long len) {
    if (len < 128) return (int)len;
    if (len >= 8192) return kKeys - 1;
    const int e = 63 - __clzll(len);                   // 7 .. 12
    return 128 + (e - 7) * 16 + (int)((len >> (e - 4)) & 15);
}

__device__ __forceinline__ long long line_start(const long long* nl,
                                                long long j) {
    return j ? nl[j - 1] + 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
hist_kernel(const long long* __restrict__ nl, long long K,
            int* __restrict__ hist) {
    __shared__ int s_hist[kKeys];
    for (int k = threadIdx.x; k < kKeys; k += kThreads) s_hist[k] = 0;
    __syncthreads();
    const long long j0 = (long long)blockIdx.x * kLinesPerBlock;
    for (int r = 0; r < kLineRounds; ++r) {
        const long long j = j0 + r * kThreads + threadIdx.x;
        if (j < K) atomicAdd(&s_hist[len_key(nl[j] - line_start(nl, j))], 1);
    }
    __syncthreads();
    for (int k = threadIdx.x; k < kKeys; k += kThreads)
        hist[(long long)k * gridDim.x + blockIdx.x] = s_hist[k];
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const long long* __restrict__ nl, long long K,
               const long long* __restrict__ slots,
               long long* __restrict__ starts, long long* __restrict__ lens,
               long long* __restrict__ ords) {
    __shared__ long long s_next[kKeys];     // the block's next slot a key
    __shared__ int s_wcount[kWarps][kKeys]; // a round's lines a warp a key
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int k = threadIdx.x; k < kKeys; k += kThreads) {
        s_next[k] = slots[(long long)k * gridDim.x + blockIdx.x];
        for (int w = 0; w < kWarps; ++w) s_wcount[w][k] = 0;
    }
    __syncthreads();
    const unsigned below = (1u << lane) - 1u;
    const long long j0 = (long long)blockIdx.x * kLinesPerBlock;
    for (int r = 0; r < kLineRounds; ++r) {
        const long long j = j0 + r * kThreads + threadIdx.x;
        const bool valid = j < K;
        long long st = 0, len = 0;
        int key = -1;                   // the lanes past K rank apart
        if (valid) {
            st = line_start(nl, j);
            len = nl[j] - st;
            key = len_key(len);
        }
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        const bool leader = (__ffs(peers) - 1) == lane;
        if (valid && leader) s_wcount[warp][key] = __popc(peers);
        __syncthreads();
        if (valid) {
            long long q = s_next[key] + __popc(peers & below);
            for (int w = 0; w < warp; ++w) q += s_wcount[w][key];
            starts[q] = st;
            lens[q] = len;
            ords[q] = j;
        }
        __syncthreads();
        if (valid && leader) {
            atomicAdd(reinterpret_cast<unsigned long long*>(&s_next[key]),
                      (unsigned long long)__popc(peers));
            s_wcount[warp][key] = 0;
        }
        __syncthreads();
    }
}

}  // namespace
}  // namespace line_index

using namespace line_index;

extern "C" {

// Threads a block, text bytes a block (passes 1-2), lines a block (passes
// 3-4) and the sort's keys.
int line_index_geometry(int* threads, int* bytes_per_block,
                        int* lines_per_block, int* keys) {
    *threads = kThreads;
    *bytes_per_block = kBytesPerBlock;
    *lines_per_block = kLinesPerBlock;
    *keys = kKeys;
    return 0;
}

// Blocks of passes 1-2 for a text of n bytes at `text`: its 16-byte
// pieces from the aligned address at or below text, a block's share at a
// time.
long long line_index_text_grid(const uint8_t* text, long long n) {
    if (n < 1) return 0;
    const Text t = make_text(text, n);
    return (t.pieces + kBytesPerBlock / 16 - 1) / (kBytesPerBlock / 16);
}

// Pass 1 on `stream`: counts[b] and last[b] (int64 [grid] each) = the
// newlines of block b's bytes and the last one's position (-1 without
// one), with grid = line_index_text_grid(text, n).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take).  All pointers are device pointers.
int line_index_count(const uint8_t* text, long long n, long long* counts,
                     long long* last, int grid, void* stream) {
    if (n < 1 || grid != line_index_text_grid(text, n))
        return (int)cudaErrorInvalidValue;
    count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        make_text(text, n), counts, last);
    return (int)cudaGetLastError();
}

// Pass 2 on `stream`, the same text and grid as pass 1, with offsets
// int64 [grid] the exclusive prefix sum of pass 1's counts: the newlines'
// positions into nl int64 [K], in stream order.
int line_index_write(const uint8_t* text, long long n,
                     const long long* offsets, long long* nl, int grid,
                     void* stream) {
    if (n < 1 || grid != line_index_text_grid(text, n))
        return (int)cudaErrorInvalidValue;
    write_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        make_text(text, n), offsets, nl);
    return (int)cudaGetLastError();
}

// Pass 3 on `stream`: hist int32 [keys * grid], key-major, the lines of
// each key in each block, with grid = ceil(K / lines_per_block).
int line_index_hist(const long long* nl, long long K, int* hist, int grid,
                    void* stream) {
    if (K < 1 || grid != (K + kLinesPerBlock - 1) / kLinesPerBlock)
        return (int)cudaErrorInvalidValue;
    hist_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        nl, K, hist);
    return (int)cudaGetLastError();
}

// Pass 4 on `stream`, the grid of pass 3, with slots int64 [keys * grid]
// the exclusive prefix sum of pass 3's hist: the lines' starts, lengths
// and stream ordinals into starts, lens and ords (int64 [K] each), in
// length order.
int line_index_scatter(const long long* nl, long long K,
                       const long long* slots, long long* starts,
                       long long* lens, long long* ords, int grid,
                       void* stream) {
    if (K < 1 || grid != (K + kLinesPerBlock - 1) / kLinesPerBlock)
        return (int)cudaErrorInvalidValue;
    scatter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        nl, K, slots, starts, lens, ords);
    return (int)cudaGetLastError();
}

const char* line_index_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
