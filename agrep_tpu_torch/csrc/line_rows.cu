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
// Output: the count R of lines that fire and, for a print, one row
// (j, start_j, nl[j]) each, in stream order, with each position p moved
// back past the inserted byte (p - 1 where glitch >= 0 and p > glitch), so
// that the rows index the text without it.
//
// What bounds it on an H100: bytes.  It must read the verdicts (1 byte a
// line), the ordinal of each line whose verdict ^ invert is set (8 bytes)
// and, a row, two newline positions, and write 24 bytes a row: at config
// 4's 32 MB window (684,929 lines, a few hundred rows) under 1 MB, well
// under a microsecond at 3.35 TB/s.  So fixed costs are its time -- each
// launch boundary, torch kernel and host read -- and the design spends
// one of each a call:
//
//   * One launch.  The grid is persistent and cooperative: at most as
//     many blocks as the SMs hold at once (cudaLaunchCooperativeKernel),
//     no more than one 16-line piece a thread needs, so that a grid-wide
//     barrier (cooperative_groups' grid sync) stands where torch kernels
//     and the host's read stood.
//   * The launch-order walk (both forms): each thread reads 16 verdicts
//     as one 16-byte load (from v's 16-byte aligned address below, the
//     bytes outside [0, K) masked) and, for each one set after invert,
//     its ordinal; a line fires when first <= ordinal < end.
//   * Count form: phase 1 is that walk, each block writes its sum, one
//     grid sync, and block 0 sums the blocks' and writes R.  No flag is
//     scattered: a count does not depend on the lines' order.
//   * Rows form: phase 0 zeroes a bitmap of K bits (u32 words, stream
//     order; 86 KB at config 4's window, so it stays in L2); grid sync;
//     phase 1, the walk, sets each firing line's bit by atomicOr; grid
//     sync; phase 2: each block owns an equal run of consecutive bitmap
//     words, each of its warps an equal run of those, lane l word l of
//     each 32-word step, and each block writes the popcount of its
//     warps' runs (the words kept in registers); grid sync; phase 3:
//     each block sums the counts of the blocks before it (out of L2,
//     spread over its threads), each warp adds its block's warps before
//     it, a warp-shuffle scan a step gives each lane its first row, and
//     the lanes put their rows' ordinals, in order, into the warp's
//     stage in shared memory (256 rows); then each lane builds 8 rows of
//     the stage, their newline loads issued together, and the warp
//     stores them, neighbouring lanes to neighbouring addresses.  The
//     last block writes R.
//   * The rows are allocated at K before the launch (R <= end - first <=
//     K), so no count is read before the rows are written and there is
//     never a second launch.
//
// Built by ops/_cuda.py as one object with a plain C interface:
// nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
// -fPIC.  The grid sync needs no -rdc with CUDA 12.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "plane_words.cuh"

namespace line_rows {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// Lines a piece: one 16-byte load of verdicts.
constexpr int kPiece = 16;
// Steps of a warp's run whose bitmap words phase 2 keeps in registers for
// phase 3 (a later step reloads its word out of L2), the rows a warp
// stages in shared memory before it stores them (a dense 32-word step
// holds 1,024 rows: 4 stages, each with 8 rows' newline loads a lane in
// flight at once), and the rows form's dynamic shared bytes.
constexpr int kKeptSteps = 4;
constexpr int kStage = 256;
constexpr int kLaneRows = kStage / 32;
constexpr size_t kShared = sizeof(long long) * 3 * kStage * kWarps;

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

__device__ __forceinline__ long long warp_sum(long long x) {
#pragma unroll
    for (int o = 16; o; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    return x;
}

// Sum of x over the block, in thread 0 (s: kWarps longs of shared memory;
// every thread must call it).
__device__ __forceinline__ long long block_sum(long long x, long long* s) {
    x = warp_sum(x);
    if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = x;
    __syncthreads();
    long long t = 0;
    if (threadIdx.x == 0)
        for (int w = 0; w < kWarps; ++w) t += s[w];
    return t;
}

// The launch-order walk: for each line i of piece g (launch indices
// 16 g - a .. 16 g - a + 15, a = v's address mod 16) whose verdict ^
// invert is set and whose ordinal j lies in [first, end), calls
// fire(j).  Every ordinal load is issued before any is used.
template <typename Fire>
__device__ __forceinline__ void walk_piece(const Params& p, long long g,
                                           int a, Fire fire) {
    // the piece's 16-byte aligned verdicts: a load that holds a byte of
    // v lies within v's allocation's pages
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(p.v - a) + g);
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
    uint32_t m = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const uint32_t e = __vcmpne4(x[i], 0u);             // 0xff a byte
        m |= ((e >> 7 & 1u) | (e >> 14 & 2u) | (e >> 21 & 4u)
              | (e >> 28 & 8u)) << (4 * i);
    }
    if (p.invert) m = ~m & 0xffffu;
    const long long i0 = kPiece * g - a;
    if (i0 < 0) m &= 0xffffu << (int)-i0;
    const long long left = p.K - i0;
    if (left < kPiece) m &= (1u << (int)left) - 1u;
    if (!m) return;
    long long j[kPiece];
#pragma unroll
    for (int b = 0; b < kPiece; ++b)
        j[b] = m >> b & 1u ? __ldg(p.ords + i0 + b) : -1;
#pragma unroll
    for (int b = 0; b < kPiece; ++b)
        if (j[b] >= p.first && j[b] < p.end) fire(j[b]);
}

// scratch: int64 [gridDim.x + 1]: each block's count, then R.
__global__ void __launch_bounds__(kThreads)
count_kernel(Params p, long long* __restrict__ scratch) {
    __shared__ long long s_warp[kWarps];
    const int a = (int)(reinterpret_cast<uintptr_t>(p.v) & 15);
    const long long pieces = (p.K + a + kPiece - 1) / kPiece;
    long long c = 0;
    for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
         g < pieces; g += (long long)gridDim.x * kThreads)
        walk_piece(p, g, a, [&](long long) { ++c; });
    c = block_sum(c, s_warp);
    if (threadIdx.x == 0) scratch[blockIdx.x] = c;
    cg::this_grid().sync();
    if (blockIdx.x) return;
    long long t = 0;
    for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads)
        t += __ldcg(scratch + b);
    t = block_sum(t, s_warp);
    if (threadIdx.x == 0) scratch[gridDim.x] = t;
}

__device__ __forceinline__ long long unglitch(const Params& p, long long q) {
    return q - (p.glitch >= 0 && q > p.glitch);
}

// scratch: int64 [gridDim.x + 1], as count_kernel's; bits: u32
// [ceil(K / 32)], the bitmap; rows: int64 [R, 3].  Block b owns the
// bitmap words from b * block_words, each of its warps a run of
// warp_words of them (both multiples of 32).
__global__ void __launch_bounds__(kThreads)
rows_kernel(Params p, long long* __restrict__ scratch,
            uint32_t* __restrict__ bits, long long* __restrict__ rows,
            long long block_words, long long warp_words) {
    __shared__ long long s_warp[kWarps];
    __shared__ long long s_part[kWarps];
    __shared__ long long s_off[kWarps];
    extern __shared__ __align__(16) long long s_dyn[];
    cg::grid_group grid = cg::this_grid();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long words = (p.K + 31) / 32;
    const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long stride = (long long)gridDim.x * kThreads;

    // phase 0: the bitmap zeroed
    for (long long w = tid; w < words; w += stride) bits[w] = 0u;
    grid.sync();

    // phase 1: each firing line's bit set, read in launch order
    const int a = (int)(reinterpret_cast<uintptr_t>(p.v) & 15);
    const long long pieces = (p.K + a + kPiece - 1) / kPiece;
    for (long long g = tid; g < pieces; g += stride)
        walk_piece(p, g, a, [&](long long j) {
            atomicOr(bits + (j >> 5), 1u << (j & 31));
        });
    grid.sync();

    // phase 2: the rows of this block's warps' runs
    const long long b1 = min((long long)(blockIdx.x + 1) * block_words,
                             words);
    const long long w0 = (long long)blockIdx.x * block_words
                         + warp * warp_words;
    const long long w1 = min(w0 + warp_words, b1);
    const int steps = w0 < w1 ? (int)((w1 - w0 + 31) / 32) : 0;
    uint32_t kept[kKeptSteps];
    long long c = 0;
#pragma unroll
    for (int s = 0; s < kKeptSteps; ++s) {
        const long long w = w0 + 32 * s + lane;
        kept[s] = s < steps && w < w1 ? __ldcg(bits + w) : 0u;
        c += __popc(kept[s]);
    }
    for (int s = kKeptSteps; s < steps; ++s) {
        const long long w = w0 + 32 * s + lane;
        if (w < w1) c += __popc(__ldcg(bits + w));
    }
    c = warp_sum(c);
    if (lane == 0) s_warp[warp] = c;
    __syncthreads();
    if (threadIdx.x == 0) {
        long long t = 0;
        for (int w = 0; w < kWarps; ++w) t += s_warp[w];
        scratch[blockIdx.x] = t;
    }
    grid.sync();

    // phase 3: the rows before this block, then before each warp
    long long before = 0;
    for (int b = threadIdx.x; b < (int)blockIdx.x; b += kThreads)
        before += __ldcg(scratch + b);
    before = warp_sum(before);
    if (lane == 0) s_part[warp] = before;
    __syncthreads();
    if (threadIdx.x == 0) {
        long long o = 0;
        for (int w = 0; w < kWarps; ++w) o += s_part[w];
        for (int w = 0; w < kWarps; ++w) {
            s_off[w] = o;
            o += s_warp[w];
        }
        if (blockIdx.x == gridDim.x - 1) scratch[gridDim.x] = o;
    }
    __syncthreads();
    if (!s_warp[warp]) return;      // a warp without a row: no store
    long long o = s_off[warp];
    // the warp's stage: rows [3 * kStage], its last third first holding
    // the rows' ordinals
    long long* srow = s_dyn + 3 * kStage * warp;
    long long* sj = srow + 2 * kStage;
    for (int s = 0; s < steps; ++s) {
        const long long w = w0 + 32 * s + lane;
        uint32_t m = 0;
#pragma unroll
        for (int k = 0; k < kKeptSteps; ++k)
            if (k == s) m = kept[k];
        if (s >= kKeptSteps && w < w1) m = __ldcg(bits + w);
        const int n = __popc(m);
        int x = n;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, x, d);
            if (lane >= d) x += y;
        }
        const int total = __shfl_sync(0xffffffffu, x, 31);
        // the step's rows kStage at a time: each lane puts the ordinals
        // of its next rows in the stage (its rows are the step's
        // [x - n, x), taken in order), then each lane builds kLaneRows
        // rows of the stage, their loads issued together, and the warp
        // stores them, neighbouring lanes to neighbouring addresses
        int k = x - n;
        for (int lo = 0; lo < total; lo += kStage) {
            for (; m && k < lo + kStage; m &= m - 1, ++k)
                sj[k - lo] = 32 * w + __ffs(m) - 1;
            __syncwarp();
            const int cnt = min(kStage, total - lo);
            long long j[kLaneRows], prev[kLaneRows], here[kLaneRows];
#pragma unroll
            for (int u = 0; u < kLaneRows; ++u) {
                const int q = lane + 32 * u;
                j[u] = q < cnt ? sj[q] : -1;
            }
            __syncwarp();           // every ordinal read before a row
#pragma unroll
            for (int u = 0; u < kLaneRows; ++u) {
                prev[u] = j[u] > 0 ? __ldg(p.nl + j[u] - 1) : -1;
                here[u] = j[u] >= 0 ? __ldg(p.nl + j[u]) : 0;
            }
#pragma unroll
            for (int u = 0; u < kLaneRows; ++u) {
                if (j[u] < 0) continue;
                long long* row = srow + 3 * (lane + 32 * u);
                row[0] = j[u];
                row[1] = unglitch(p, prev[u] + 1);
                row[2] = unglitch(p, here[u]);
            }
            __syncwarp();
            long long* dst = rows + 3 * (o + lo);
            for (int e = lane; e < 3 * cnt; e += 32) dst[e] = srow[e];
            __syncwarp();
        }
        o += total;
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

const void* kernel(int rows) {
    return rows ? reinterpret_cast<const void*>(rows_kernel)
                : reinterpret_cast<const void*>(count_kernel);
}

}  // namespace
}  // namespace line_rows

using namespace line_rows;

extern "C" {

// Threads a block, lines a thread's piece, and the blocks of a launch
// of the rows form (rows != 0) or the count form that the current
// device holds at once (the most a cooperative launch takes).  Returns a
// cudaError_t.
int line_rows_geometry(int rows, int* threads, int* piece, int* max_blocks) {
    *threads = kThreads;
    *piece = kPiece;
    return plane_words::resident_blocks(kernel(rows), kThreads,
                                        rows ? kShared : 0, max_blocks);
}

// One cooperative launch on `stream` of grid blocks (at most
// line_rows_geometry's max_blocks): R into scratch[grid] (scratch int64
// [grid + 1 + ceil(K / 64)]: the blocks' counts, R, and for the rows
// form the bitmap) and, where out is not null, the rows into out int64
// [R, 3] (R <= end - first).  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments the kernel does not
// take).  All pointers are device pointers: v u8 [K], ords and nl int64
// [K].
int line_rows_launch(const uint8_t* v, const long long* ords,
                     const long long* nl, long long K, int invert,
                     long long first, long long end, long long glitch,
                     long long* out, long long* scratch, int grid,
                     void* stream) {
    Params p;
    if (!make_params(v, ords, nl, K, invert, first, end, glitch, &p)
        || grid < 1)
        return (int)cudaErrorInvalidValue;
    // each block an equal share of the bitmap words, each warp of the
    // block an equal share of that (multiples of a 32-word step)
    const long long words = (K + 31) / 32;
    long long block_words = 32 * ((words + 32LL * grid - 1) / (32LL * grid));
    long long warp_words = 32 * ((block_words + 32 * kWarps - 1)
                                 / (32 * kWarps));
    uint32_t* bits = reinterpret_cast<uint32_t*>(scratch + grid + 1);
    void* count_args[] = {&p, &scratch};
    void* rows_args[] = {&p, &scratch, &bits, &out, &block_words,
                         &warp_words};
    const size_t shared = out ? kShared : 0;
    cudaError_t err = plane_words::allow_shared(kernel(out != nullptr),
                                                shared);
    if (err != cudaSuccess) return (int)err;
    err = cudaLaunchCooperativeKernel(
        kernel(out != nullptr), dim3(grid), dim3(kThreads),
        out ? rows_args : count_args, shared,
        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

const char* line_rows_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
