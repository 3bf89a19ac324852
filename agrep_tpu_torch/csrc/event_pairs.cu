// Sparse event read-back of mask_scan's planes for NVIDIA Hopper (sm_90a).
//
// Replaces the host read-back agrep_tpu/ops/kernels.py::planes_to_events
// (:521), which copies every packed plane to the host, unpacks each bit
// into a dense u32 event word per text byte (np.zeros(N) and a boolean
// scatter a plane) and leaves its callers to compact that array again
// with np.flatnonzero.  This kernel compacts the planes where they
// already lie, and only the pairs cross to the host.
//
// The function.  Input: mask_scan's planes and their values (see
// plane_words.cuh), and keep_from, the first position kept.  Output: one
// (pos int64, word u32) pair for each kept position whose OR of values
// is not 0, ascending by position, and K, the number of pairs.
//
// What bounds it on an H100: bytes.  It must read the body words of the
// planes whose value is not 0 and write 12 bytes a pair, a few int32
// operations a 32-position word: at config 2's 32 MB chunk about 4.3 MB
// of plane words, 1.3 us at 3.35 TB/s.  So fixed costs are its time:
// every launch boundary, torch kernel or host read between two passes
// costs more than the bytes, and the design spends none of them:
//
//   * One launch.  The grid is persistent and cooperative: as many blocks
//     as the SMs hold at once (cudaLaunchCooperativeKernel), so that a
//     grid-wide barrier (cooperative_groups' grid sync) can stand where
//     the torch kernels and the host's read stood.  Each warp owns a run
//     of consecutive stream words, a lane R consecutive words of each of
//     its steps, their plane bits in registers (plane_words.cuh).
//   * Phase 1: each lane counts the set bits of the OR of the active
//     planes over its words, masked to [keep_from, n); the block writes
//     one count.  Grid sync.
//   * Phase 2: each block sums the counts of the blocks before it (a few
//     hundred words out of L2, spread over its threads), each warp adds
//     its block's warps before it, and each lane with a pair reloads its
//     words' bits (the planes, 4-13 MB, were just read and sit in the 50
//     MB L2; phase 1 kept its lanes' counts in shared memory) and puts
//     its pairs in order, its offset from a warp-shuffle scan a step,
//     into its warp's stage in shared memory, whence the warp stores
//     them, neighbouring lanes to neighbouring addresses: no block
//     barrier in the walk.
//   * The last block writes K.  The wrapper allocates the pairs at a
//     capacity before the launch; the kernel writes no pair at or past
//     it and always reports the true K, and the wrapper launches again
//     with the capacity K only where K exceeds it.
//
// Built by ops/_cuda.py as one object with a plain C interface:
// nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
// -fPIC.  The grid sync needs no -rdc with CUDA 12.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "plane_words.cuh"

namespace event_pairs {

using namespace plane_words;
namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// Steps whose lane counts phase 1 keeps in shared memory for phase 2 (a
// lane without a pair there loads nothing), and the pairs a warp stages
// in shared memory before it stores them, neighbouring lanes to
// neighbouring addresses.
constexpr int kKeptSteps = 8;
constexpr int kStage = 256;
constexpr size_t kCountBytes = sizeof(int) * kKeptSteps * kThreads;
constexpr size_t kShared = kCountBytes
    + (sizeof(long long) + sizeof(uint32_t)) * kWarps * kStage;

namespace {

// scratch: int64 [gridDim.x + 1]: each block's pairs, then K.
template <int MAXP, int R>
__global__ void __launch_bounds__(kThreads)
pairs_kernel(Planes p, long long cap, long long* __restrict__ scratch,
             long long* __restrict__ pos, uint32_t* __restrict__ word) {
    extern __shared__ __align__(16) unsigned char s_dyn[];
    __shared__ Active a;
    __shared__ long long s_warp[kWarps];
    __shared__ long long s_part[kWarps];
    __shared__ long long s_off[kWarps];
    load_active(p, a);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int* s_cnt = reinterpret_cast<int*>(s_dyn) + threadIdx.x;
    long long* s_pos = reinterpret_cast<long long*>(s_dyn + kCountBytes)
                       + warp * kStage;
    uint32_t* s_word = reinterpret_cast<uint32_t*>(
        s_dyn + kCountBytes + sizeof(long long) * kWarps * kStage)
        + warp * kStage;
    const long long g0 = run_start(p, kWarps, warp);
    const int steps = run_steps(p, g0, 32 * R);
    uint32_t bits[MAXP][R];

    // phase 1: this block's pairs
    long long c = 0;
    for (int s = 0; s < steps; ++s) {
        load_words<MAXP, R>(p, a, g0 + (long long)s * 32 * R + lane * R,
                            bits);
        int n = 0;
#pragma unroll
        for (int i = 0; i < R; ++i) {
            uint32_t any = 0;
#pragma unroll
            for (int q = 0; q < MAXP; ++q) any |= bits[q][i];
            n += __popc(any);
        }
        if (s < kKeptSteps) s_cnt[s * kThreads] = n;
        c += n;
    }
    c = warp_sum(c);
    if (lane == 0) s_warp[warp] = c;
    __syncthreads();
    if (threadIdx.x == 0) {
        long long t = 0;
        for (int w = 0; w < kWarps; ++w) t += s_warp[w];
        scratch[blockIdx.x] = t;
    }
    cg::this_grid().sync();

    // phase 2: the pairs before this block, then before each warp
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
    long long o = s_off[warp];
    for (int s = 0; s < steps; ++s) {
        const long long g = g0 + (long long)s * 32 * R + lane * R;
        const bool kept_count = s < kKeptSteps;
        int n = kept_count ? s_cnt[s * kThreads] : 1;
        uint32_t any[R];
        if (n) {
            load_words<MAXP, R>(p, a, g, bits);
            n = 0;
#pragma unroll
            for (int i = 0; i < R; ++i) {
                any[i] = 0;
#pragma unroll
                for (int q = 0; q < MAXP; ++q) any[i] |= bits[q][i];
                n += __popc(any[i]);
            }
        }
        int x = n;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, x, d);
            if (lane >= d) x += y;
        }
        const int total = __shfl_sync(0xffffffffu, x, 31);
        const int first = x - n;
        // the step's pairs through the warp's stage, kStage at a time
        for (int lo = 0; lo < total; lo += kStage) {
            if (n && first < lo + kStage && first + n > lo) {
                int k = first - lo;
#pragma unroll
                for (int i = 0; i < R; ++i) {
                    for (uint32_t m = any[i]; m; m &= m - 1, ++k) {
                        if (k < 0 || k >= kStage) continue;
                        const int b = __ffs(m) - 1;
                        uint32_t v = 0;
#pragma unroll
                        for (int q = 0; q < MAXP; ++q)
                            if (bits[q][i] >> b & 1u) v |= a.val[q];
                        s_pos[k] = 32 * (g + i) + b;
                        s_word[k] = v;
                    }
                }
            }
            __syncwarp();
            const int cnt = min(kStage, total - lo);
            for (int j = lane; j < cnt; j += 32) {
                const long long at = o + lo + j;
                if (at < cap) {
                    pos[at] = s_pos[j];
                    word[at] = s_word[j];
                }
            }
            __syncwarp();
        }
        o += total;
    }
}

// The instantiation of a launch over n_planes planes: its kernel and
// the words a lane takes a step.
struct Form {
    const void* kernel;
    int r;
};

Form form(int n_planes) {
    if (n_planes <= 2)
        return {reinterpret_cast<const void*>(pairs_kernel<2, 8>), 8};
    if (n_planes <= 4)
        return {reinterpret_cast<const void*>(pairs_kernel<4, 8>), 8};
    return {reinterpret_cast<const void*>(pairs_kernel<kMaxPlanes, 1>), 1};
}

}  // namespace
}  // namespace event_pairs

using namespace event_pairs;

extern "C" {

// Threads a block, the blocks of a launch over n_planes planes that the
// current device holds at once (the most a cooperative launch takes),
// and the stream words of a warp's step (a warp's run is a multiple of
// it).  Returns a cudaError_t.
int event_pairs_geometry(int n_planes, int* threads, int* max_blocks,
                         int* step_words) {
    if (n_planes < 1 || n_planes > kMaxPlanes)
        return (int)cudaErrorInvalidValue;
    const Form f = form(n_planes);
    *threads = kThreads;
    *step_words = 32 * f.r;
    return resident_blocks(f.kernel, kThreads, kShared, max_blocks);
}

// One cooperative launch on `stream`: grid blocks (at most
// event_pairs_geometry's max_blocks), each warp a run of warp_words
// stream words (a multiple of its step_words) from keep_from / 32's
// (grid * 16 runs must cover the words to ceil(n / 32), grid - 1 must
// not); the pairs [0, min(K, cap)) into pos int64 and word u32, and K
// into scratch[grid] (scratch int64 [grid + 1]).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take).  All pointers are device
// pointers: planes u32 [n_planes, T, n_words], vals u32 [n_planes].
int event_pairs_launch(const uint32_t* planes, int n_planes, long long T,
                       int n_words, const uint32_t* vals, int W, int L,
                       long long n, long long keep_from, long long* pos,
                       uint32_t* word, long long cap, long long* scratch,
                       int grid, long long warp_words, void* stream) {
    Planes p;
    if (n_planes < 1 || n_planes > kMaxPlanes)
        return (int)cudaErrorInvalidValue;
    const Form f = form(n_planes);
    if (!make_planes(planes, n_planes, T, n_words, vals, W, L, n, keep_from,
                     grid, warp_words, kWarps, 32 * f.r, &p) || cap < 0)
        return (int)cudaErrorInvalidValue;
    void* args[] = {&p, &cap, &scratch, &pos, &word};
    cudaError_t err = allow_shared(f.kernel, kShared);
    if (err != cudaSuccess) return (int)err;
    err = cudaLaunchCooperativeKernel(f.kernel, dim3(grid), dim3(kThreads),
                                      args, kShared,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

const char* event_pairs_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
