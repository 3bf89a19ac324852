// The regex engine's lines that fire, in stream order, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the regex engine's host read-back of renfa_lanes' verdicts
// (agrep_tpu/runtime/regex_engine.py: the verdicts scattered back from
// length order, `(v != 0) ^ o.invert`, the guards that drop an empty first
// line at D > 0, :169 and :451, and a line whose newline the engine
// appended, :459 and :488, then `np.count_nonzero(hits)` for a count,
// :170 and :460, or `np.flatnonzero(hit)` for a print, :233 and :486),
// which brings a verdict for every line of the chunk to the host.  Here
// the verdicts stay on the card: a count crosses as one number, a print
// as the rows of the lines that fire.
//
// The function.  Input: renfa_lanes' verdicts v, u8 [K], in launch order,
// with ords, int64 [K], the stream ordinal of each launched line (a
// permutation of 0 .. K-1: line_index.cu's order; a value outside it
// names no line and is skipped); nl, int64 [K], the
// newlines' positions in stream order (line j is [start_j, nl[j]),
// start_0 = 0, start_j = nl[j-1] + 1); invert; [first, end), the
// ordinals kept (the guards drop the lines outside); glitch, the text
// position of a byte the engine inserted (agrep's 49,152-byte overrun
// glitch), or -1.  Line j fires when first <= j < end and v ^ invert.
// Output: the count of lines that fire and, for a print, one row
// (j, start_j, nl[j]) each, in stream order, with each position p moved
// back past the inserted byte (p - 1 where glitch >= 0 and p > glitch), so
// that the rows index the text without it.
//
// What bounds it on an H100: bytes.  It must read 9 bytes a line
// (verdict and ordinal) and, a row, two newline positions, and write 24
// bytes a row: at config 4's 32 MB chunk (684,929 lines, a few hundred
// rows) about 6.2 MB, 1.8 us at 3.35 TB/s, so the launches' fixed cost
// and the host's read of the count are its time.  The design is the
// simple one:
//
//   * Pass 1 (flags_kernel): each launched line's flag, (v ^ invert) and
//     its ordinal kept, is scattered to its ordinal: a u8 flag a line in
//     stream order.
//   * Pass 2 (count_kernel): each block counts the flags of its
//     kFlagsPerBlock lines, read as 16-byte pieces.
//   * The wrapper takes the exclusive prefix sum of the block counts on
//     the card (one torch.cumsum) and reads the total: a count stops here.
//   * Pass 3 (write_kernel) counts again, scans the threads' counts across
//     the block (warp shuffles, then the warps' totals in shared memory),
//     and each thread writes its rows from its offset.
//
// Built by ops/_cuda.py as one object with a plain C interface:
// nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
// -fPIC.

#include <cstdint>
#include <cuda_runtime.h>

namespace line_rows {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;
constexpr int kFlagsPerBlock = kThreads * 16 * kRounds;
constexpr int kScatterPerThread = 4;
constexpr int kScatterPerBlock = kThreads * kScatterPerThread;

struct Params {
    const uint8_t* v;               // [K], launch order
    const long long* ords;          // [K]
    const long long* nl;            // [K], stream order
    long long K;
    long long first, end;           // the ordinals kept
    long long glitch;               // the inserted byte's position, or -1
    int invert;
};

namespace {

__global__ void __launch_bounds__(kThreads)
flags_kernel(Params p, uint8_t* __restrict__ flags) {
    const long long i0 = (long long)blockIdx.x * kScatterPerBlock;
    for (int r = 0; r < kScatterPerThread; ++r) {
        const long long i = i0 + r * kThreads + threadIdx.x;
        if (i >= p.K) break;
        const long long j = p.ords[i];
        if (j < 0 || j >= p.K) continue;    // not an ordinal: no line
        flags[j] = (uint8_t)(((p.v[i] != 0) != (p.invert != 0))
                             && j >= p.first && j < p.end);
    }
}

// Bit b set where flag 16g + b (< K) is set.
__device__ __forceinline__ uint32_t flag_bits(const Params& p,
                                              const uint8_t* flags,
                                              long long g) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(flags) + g);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t m = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const uint32_t e = __vcmpne4(w[i], 0u);             // 0xff a flag
        m |= ((e >> 7 & 1u) | (e >> 14 & 2u) | (e >> 21 & 4u)
              | (e >> 28 & 8u)) << (4 * i);
    }
    const long long left = p.K - 16 * g;
    return left >= 16 ? m : m & ((1u << (int)left) - 1u);
}

__global__ void __launch_bounds__(kThreads)
count_kernel(Params p, const uint8_t* __restrict__ flags,
             long long* __restrict__ counts) {
    __shared__ int s_warp[kWarps];
    const long long pieces = (p.K + 15) / 16;
    const long long g0 = (long long)blockIdx.x * (kFlagsPerBlock / 16);
    int c = 0;
    for (int r = 0; r < kRounds; ++r) {
        const long long g = g0 + r * kThreads + threadIdx.x;
        if (g >= pieces) break;
        c += __popc(flag_bits(p, flags, g));
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
    if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = c;
    __syncthreads();
    if (threadIdx.x == 0) {
        long long s = 0;
        for (int w = 0; w < kWarps; ++w) s += s_warp[w];
        counts[blockIdx.x] = s;
    }
}

__device__ __forceinline__ long long unglitch(const Params& p, long long q) {
    return q - (p.glitch >= 0 && q > p.glitch);
}

__global__ void __launch_bounds__(kThreads)
write_kernel(Params p, const uint8_t* __restrict__ flags,
             const long long* __restrict__ offsets,
             long long* __restrict__ rows) {
    __shared__ int s_warp[kWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long pieces = (p.K + 15) / 16;
    long long base = offsets[blockIdx.x];
    const long long g0 = (long long)blockIdx.x * (kFlagsPerBlock / 16);
    for (int r = 0; r < kRounds; ++r) {
        const long long g = g0 + r * kThreads + threadIdx.x;
        const uint32_t m = g < pieces ? flag_bits(p, flags, g) : 0u;
        // this thread's first row: those of the block's earlier rounds,
        // earlier warps and earlier lanes
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
        for (uint32_t k = m; k; k &= k - 1) {
            const long long j = 16 * g + __ffs(k) - 1;
            long long* row = rows + 3 * o++;
            row[0] = j;
            row[1] = j ? unglitch(p, p.nl[j - 1] + 1) : 0;
            row[2] = unglitch(p, p.nl[j]);
        }
        base += total;
        __syncthreads();                // s_warp is rewritten next round
    }
}

bool make_params(const uint8_t* v, const long long* ords,
                 const long long* nl, long long K, int invert,
                 long long first, long long end, long long glitch,
                 Params* p) {
    if (K < 1 || first < 0 || end > K || glitch < -1) return false;
    p->v = v;
    p->ords = ords;
    p->nl = nl;
    p->K = K;
    p->first = first;
    p->end = end;
    p->glitch = glitch;
    p->invert = invert;
    return true;
}

}  // namespace
}  // namespace line_rows

using namespace line_rows;

extern "C" {

// Threads a block, lines a block of pass 1 and of passes 2-3.
int line_rows_geometry(int* threads, int* scatter_per_block,
                       int* flags_per_block) {
    *threads = kThreads;
    *scatter_per_block = kScatterPerBlock;
    *flags_per_block = kFlagsPerBlock;
    return 0;
}

// Pass 1 on `stream`: flags u8 [ceil(K / 16) * 16] (16-byte aligned), a
// flag a line in stream order, with grid = ceil(K / scatter_per_block).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernels do not take).  All pointers are device pointers:
// v u8 [K], ords and nl int64 [K].
int line_rows_flags(const uint8_t* v, const long long* ords,
                    const long long* nl, long long K, int invert,
                    long long first, long long end, long long glitch,
                    uint8_t* flags, int grid, void* stream) {
    Params p;
    if (!make_params(v, ords, nl, K, invert, first, end, glitch, &p)
        || grid != (K + kScatterPerBlock - 1) / kScatterPerBlock
        || reinterpret_cast<uintptr_t>(flags) % 16)
        return (int)cudaErrorInvalidValue;
    flags_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        p, flags);
    return (int)cudaGetLastError();
}

// Pass 2 on `stream`: counts int64 [grid], the lines that fire in each
// block of flags, with grid = ceil(K / flags_per_block).
int line_rows_count(const uint8_t* v, const long long* ords,
                    const long long* nl, long long K, int invert,
                    long long first, long long end, long long glitch,
                    const uint8_t* flags, long long* counts, int grid,
                    void* stream) {
    Params p;
    if (!make_params(v, ords, nl, K, invert, first, end, glitch, &p)
        || grid != (K + kFlagsPerBlock - 1) / kFlagsPerBlock
        || reinterpret_cast<uintptr_t>(flags) % 16)
        return (int)cudaErrorInvalidValue;
    count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        p, flags, counts);
    return (int)cudaGetLastError();
}

// Pass 3 on `stream`, the arguments and grid of pass 2, with offsets
// int64 [grid] the exclusive prefix sum of its counts: the rows, int64
// [R, 3], R the counts' sum.
int line_rows_write(const uint8_t* v, const long long* ords,
                    const long long* nl, long long K, int invert,
                    long long first, long long end, long long glitch,
                    const uint8_t* flags, const long long* offsets,
                    long long* rows, int grid, void* stream) {
    Params p;
    if (!make_params(v, ords, nl, K, invert, first, end, glitch, &p)
        || grid != (K + kFlagsPerBlock - 1) / kFlagsPerBlock
        || reinterpret_cast<uintptr_t>(flags) % 16)
        return (int)cudaErrorInvalidValue;
    write_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        p, flags, offsets, rows);
    return (int)cudaGetLastError();
}

const char* line_rows_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
