// Sparse event read-back of mask_scan's planes for NVIDIA Hopper (sm_90a).
//
// Replaces the host read-back agrep_tpu/ops/kernels.py::planes_to_events
// (:521), which copies every packed plane to the host, unpacks each bit
// into a dense u32 event word per text byte (np.zeros(N) and a boolean
// scatter a plane) and leaves its callers to compact that array again
// with np.flatnonzero.  This kernel compacts the planes where they
// already lie, and only the pairs cross to the host.
//
// The function.  Input: mask_scan's planes, u32 [n_planes, T, n_words]
// (ops/kernels.py docstring): window column j of tile t is stream
// position t*L - W + j, bit j of word w is column 32*w + j; only body
// columns [W, W + L) with position < n count.  vals[i] is the word plane
// i adds to a column whose bit is set (0: the plane adds nothing), and
// keep_from the first position kept.  Output: one (pos int64, word u32)
// pair for each kept position whose OR of values is not 0, ascending by
// position.
//
// What bounds it on an H100: bytes.  It must read the body words of the
// planes whose value is not 0 and write 12 bytes a pair, a few int32
// operations a 32-position word; at config 2's 32 MB chunk that is about
// 4.3 MB of plane words, 1.3 us at 3.35 TB/s, so two launches' fixed
// cost and the host's read of K dominate.  The design is the simple one:
//
//   * A stream word g (positions 32g .. 32g + 31) lies in one tile, since
//     L is a multiple of 32 (the launcher refuses any other L): its bits
//     are one funnel shift of two neighbouring plane words, per plane.
//     A thread takes one stream word a round; neighbouring threads read
//     neighbouring plane words.
//   * Pass 1 (count_kernel): each block counts the set bits of the OR of
//     the active planes over its kWordsPerBlock stream words, masked to
//     [keep_from, n), and writes one int64 count.
//   * The wrapper takes an exclusive prefix sum of the block counts on
//     the card (one torch.cumsum) and reads K, the total, to size the
//     outputs.
//   * Pass 2 (write_kernel) recomputes each word's bits the same way,
//     scans the threads' popcounts across the block (warp shuffles, then
//     the warps' totals in shared memory), and each thread writes its
//     pairs from its offset in stream order, OR-ing the values of the
//     planes whose bit is set (their bits kept in shared memory a
//     thread).
//
// Built by ops/_cuda.py as one object with a plain C interface:
// nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
// -fPIC.

#include <cstdint>
#include <cuda_runtime.h>

namespace event_pairs {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;
constexpr int kWordsPerBlock = kThreads * kRounds;
constexpr int kMaxPlanes = 33;      // the delimiter plane and 32 hit planes

struct Params {
    const uint32_t* planes;         // [n_planes, T, n_words]
    const uint32_t* vals;           // [n_planes]
    long long T;
    int n_words, n_planes, W, L;
    long long n, keep_from;
    long long g_lo, g_hi;           // the stream words [g_lo, g_hi) covered
};

namespace {

// The planes whose value is not 0, and their values.
struct Active {
    int n;
    int plane[kMaxPlanes];
    uint32_t val[kMaxPlanes];
};

__device__ void load_active(const Params& p, Active& a) {
    if (threadIdx.x == 0) {
        int k = 0;
        for (int i = 0; i < p.n_planes; ++i) {
            const uint32_t v = p.vals[i];
            if (v) {
                a.plane[k] = i;
                a.val[k] = v;
                ++k;
            }
        }
        a.n = k;
    }
    __syncthreads();
}

// Mask of the positions of stream word g that are kept: >= keep_from
// and < n.
__device__ __forceinline__ uint32_t kept(const Params& p, long long g) {
    const long long p0 = 32 * g;
    uint32_t m = 0xffffffffu;
    const long long below = p.keep_from - p0;
    if (below > 0) m = below >= 32 ? 0u : m << (int)below;
    const long long left = p.n - p0;
    if (left < 32) m &= left <= 0 ? 0u : (1u << (int)left) - 1u;
    return m;
}

// Bits of stream word g in plane i: columns j0 .. j0 + 31 of tile t.
__device__ __forceinline__ uint32_t plane_bits(const Params& p, int i,
                                               long long t, int j0) {
    const uint32_t* row = p.planes + ((long long)i * p.T + t) * p.n_words;
    const int w = j0 >> 5, sh = j0 & 31;
    const uint32_t lo = __ldg(row + w);
    // sh > 0 means column j0 + 31 < W + L lies in word w + 1 < n_words
    return sh ? __funnelshift_r(lo, __ldg(row + w + 1), sh) : lo;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(Params p, long long* __restrict__ counts) {
    __shared__ Active a;
    __shared__ int s_warp[kWarps];
    load_active(p, a);
    const long long g0 = p.g_lo + (long long)blockIdx.x * kWordsPerBlock;
    int c = 0;
    for (int r = 0; r < kRounds; ++r) {
        const long long g = g0 + r * kThreads + threadIdx.x;
        if (g >= p.g_hi) break;
        const long long t = 32 * g / p.L;
        const int j0 = p.W + (int)(32 * g - t * p.L);
        uint32_t any = 0;
        for (int q = 0; q < a.n; ++q) any |= plane_bits(p, a.plane[q], t, j0);
        c += __popc(any & kept(p, g));
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

__global__ void __launch_bounds__(kThreads)
write_kernel(Params p, const long long* __restrict__ offsets,
             long long* __restrict__ pos, uint32_t* __restrict__ word) {
    __shared__ Active a;
    __shared__ uint32_t s_bits[kMaxPlanes][kThreads];
    __shared__ int s_warp[kWarps];
    load_active(p, a);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    long long base = offsets[blockIdx.x];
    const long long g0 = p.g_lo + (long long)blockIdx.x * kWordsPerBlock;
    for (int r = 0; r < kRounds; ++r) {
        const long long g = g0 + r * kThreads + threadIdx.x;
        uint32_t any = 0;
        if (g < p.g_hi) {
            const long long t = 32 * g / p.L;
            const int j0 = p.W + (int)(32 * g - t * p.L);
            for (int q = 0; q < a.n; ++q) {
                const uint32_t b = plane_bits(p, a.plane[q], t, j0);
                s_bits[q][threadIdx.x] = b;
                any |= b;
            }
            any &= kept(p, g);
        }
        // this thread's first pair: the pairs of the block's earlier
        // rounds, earlier warps and earlier lanes
        const int n = __popc(any);
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
        for (uint32_t m = any; m; m &= m - 1) {
            const int b = __ffs(m) - 1;
            uint32_t v = 0;
            for (int q = 0; q < a.n; ++q)
                if (s_bits[q][threadIdx.x] >> b & 1u) v |= a.val[q];
            pos[o] = 32 * g + b;
            word[o] = v;
            ++o;
        }
        base += total;
        __syncthreads();                // s_warp is rewritten next round
    }
}

// The Params of a call, or false for arguments the kernels do not take.
bool make_params(const uint32_t* planes, int n_planes, long long T,
                 int n_words, const uint32_t* vals, int W, int L,
                 long long n, long long keep_from, int grid, Params* p) {
    if (n_planes < 1 || n_planes > kMaxPlanes || L < 32 || L % 32 != 0
        || W < 0 || W > L || n_words != (W + L + 31) / 32 || n < 1
        || keep_from < 0 || keep_from >= n || T < 1
        || T * (long long)L < n)
        return false;
    p->planes = planes;
    p->vals = vals;
    p->T = T;
    p->n_words = n_words;
    p->n_planes = n_planes;
    p->W = W;
    p->L = L;
    p->n = n;
    p->keep_from = keep_from;
    p->g_lo = keep_from / 32;
    p->g_hi = (n + 31) / 32;
    return grid == (p->g_hi - p->g_lo + kWordsPerBlock - 1) / kWordsPerBlock;
}

}  // namespace
}  // namespace event_pairs

using namespace event_pairs;

extern "C" {

// Threads a block and stream words (32 positions each) a block.
int event_pairs_geometry(int* threads, int* words_per_block) {
    *threads = kThreads;
    *words_per_block = kWordsPerBlock;
    return 0;
}

// Pass 1 on `stream`: counts[b] = the pairs of block b's stream words,
// with grid = ceil((ceil(n / 32) - keep_from / 32) / words_per_block)
// blocks.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).  All
// pointers are device pointers: planes u32 [n_planes, T, n_words], vals
// u32 [n_planes], counts int64 [grid].
int event_pairs_count(const uint32_t* planes, int n_planes, long long T,
                      int n_words, const uint32_t* vals, int W, int L,
                      long long n, long long keep_from, long long* counts,
                      int grid, void* stream) {
    Params p;
    if (!make_params(planes, n_planes, T, n_words, vals, W, L, n, keep_from,
                     grid, &p))
        return (int)cudaErrorInvalidValue;
    count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        p, counts);
    return (int)cudaGetLastError();
}

// Pass 2 on `stream`, the same arguments and grid as pass 1, with
// offsets int64 [grid] the exclusive prefix sum of pass 1's counts: the
// pairs into pos int64 [K] and word u32 [K], K the counts' sum.
int event_pairs_write(const uint32_t* planes, int n_planes, long long T,
                      int n_words, const uint32_t* vals, int W, int L,
                      long long n, long long keep_from,
                      const long long* offsets, long long* pos,
                      uint32_t* word, int grid, void* stream) {
    Params p;
    if (!make_params(planes, n_planes, T, n_words, vals, W, L, n, keep_from,
                     grid, &p))
        return (int)cudaErrorInvalidValue;
    write_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        p, offsets, pos, word);
    return (int)cudaGetLastError();
}

const char* event_pairs_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
