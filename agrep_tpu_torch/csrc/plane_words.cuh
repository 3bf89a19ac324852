// mask_scan's planes read a stream word at a time, on a persistent
// cooperative grid of warp runs: what event_pairs.cu and
// record_verdicts.cu share.
//
// The planes (ops/kernels.py docstring): u32 [n_planes, T, n_words];
// window column j of tile t is stream position t*L - W + j, bit j of word
// w is column 32*w + j; only body columns [W, W + L) with position < n
// count.  vals[i] is the word plane i adds to a position whose bit is set
// (0: the plane adds nothing).  A stream word g holds positions 32g ..
// 32g + 31.  Since L is a multiple of 32 (the launchers refuse any other
// L), a stream word lies in one tile, and its bits in a plane are one
// funnel shift of two neighbouring plane words.
//
// The grid: every block of a launch is resident at once (a cooperative
// launch, as many blocks as the SMs hold), and each warp owns a run of
// warp_words consecutive stream words, walked in steps of 32 * R words:
// lane l takes the R consecutive words step + R*l .. step + R*l + R - 1.
// A lane issues the loads of all its words' plane words (R + 1 a plane)
// before it uses one, so that each SM keeps enough bytes in flight to
// stream the planes, and folds its R words alone before the warp meets
// (one shuffle scan a step).  A lane keeps the bits of each active plane
// in registers, for at most MAXP active planes (the kernels are
// instantiated for a few MAXP; the launcher takes the least that holds
// the planes given).  A warp's steps are the same for its 32 lanes, so
// its shuffles never diverge.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace plane_words {

constexpr int kMaxPlanes = 33;      // the delimiter plane and 32 hit planes

// The planes and the stream words of a launch.
struct Planes {
    const uint32_t* planes;         // [n_planes, T, n_words]
    const uint32_t* vals;           // [n_planes]
    long long T;
    int n_words, n_planes, W, L;
    long long n, keep_from;
    long long g_lo, g_hi;           // the stream words [g_lo, g_hi)
    long long warp_words;           // stream words of a warp's run
};

// The planes whose value is not 0, and their values.
struct Active {
    int n;
    int plane[kMaxPlanes];
    uint32_t val[kMaxPlanes];
};

// Fills a (shared) with the active planes, in plane order: warp 0 reads
// the values, one lane a plane, and ranks the nonzero ones by ballot.
// Every thread of the block must call it.
__device__ __forceinline__ void load_active(const Planes& p, Active& a) {
    if (threadIdx.x < 32) {
        const int l = threadIdx.x;
        const uint32_t v0 = l < p.n_planes ? __ldg(p.vals + l) : 0u;
        const uint32_t v1 = 32 + l < p.n_planes ? __ldg(p.vals + 32 + l)
                                                : 0u;
        const unsigned b0 = __ballot_sync(0xffffffffu, v0 != 0);
        const unsigned b1 = __ballot_sync(0xffffffffu, v1 != 0);
        const unsigned below = (1u << l) - 1u;
        if (v0) {
            const int k = __popc(b0 & below);
            a.plane[k] = l;
            a.val[k] = v0;
        }
        if (v1) {
            const int k = __popc(b0) + __popc(b1 & below);
            a.plane[k] = 32 + l;
            a.val[k] = v1;
        }
        if (l == 0) a.n = __popc(b0) + __popc(b1);
    }
    __syncthreads();
}

// Mask of the positions of stream word g that are kept: >= keep_from
// and < n.
__device__ __forceinline__ uint32_t kept(const Planes& p, long long g) {
    const long long p0 = 32 * g;
    uint32_t m = 0xffffffffu;
    const long long below = p.keep_from - p0;
    if (below > 0) m = below >= 32 ? 0u : m << (int)below;
    const long long left = p.n - p0;
    if (left < 32) m &= left <= 0 ? 0u : (1u << (int)left) - 1u;
    return m;
}

// The kept bits of stream words g .. g + R - 1 in each of the first
// MAXP active planes: bits[q][i] for word g + i (0 for a word past g_hi
// and for q >= a.n).  Every load is issued before any is used.
template <int MAXP, int R>
__device__ __forceinline__ void load_words(const Planes& p, const Active& a,
                                           long long g,
                                           uint32_t (&bits)[MAXP][R]) {
    // the plane word of each word's first column: word c of tile t lies
    // at t * n_words + W / 32 + c (g < 2^32: make_planes)
    const unsigned per = (unsigned)p.L >> 5;
    const unsigned t = (unsigned)g / per;
    unsigned c = (unsigned)g - t * per;
    long long o = (long long)t * p.n_words + (p.W >> 5) + c;
    long long off[R];
    uint32_t km[R];
    // every position of the words kept, as for all but the run's ends
    const bool inner = 32 * g >= p.keep_from && 32 * (g + R) <= p.n;
#pragma unroll
    for (int i = 0; i < R; ++i) {
        off[i] = o;
        km[i] = inner ? 0xffffffffu
                      : g + i < p.g_hi ? kept(p, g + i) : 0u;
        if (++c == per) {
            c = 0;
            o += p.n_words - per + 1;
        } else {
            ++o;
        }
    }
    // sh > 0 means a word's last column, below W + L, lies in the next
    // plane word of the same row
    const int sh = p.W & 31;
#pragma unroll
    for (int q = 0; q < MAXP; ++q) {
        const uint32_t* base = p.planes
            + (long long)(q < a.n ? a.plane[q] : 0) * p.T * p.n_words;
#pragma unroll
        for (int i = 0; i < R; ++i) {
            uint32_t b = 0;
            if (q < a.n && km[i]) {
                const uint32_t lo = __ldg(base + off[i]);
                b = (sh ? __funnelshift_r(lo, __ldg(base + off[i] + 1), sh)
                        : lo) & km[i];
            }
            bits[q][i] = b;
        }
    }
}

// The first stream word of warp `warp` (of `warps`) of this block's run.
__device__ __forceinline__ long long run_start(const Planes& p, int warps,
                                               int warp) {
    return p.g_lo + ((long long)blockIdx.x * warps + warp) * p.warp_words;
}

// Steps of `step` words of a warp's run starting at g0 (0 past the end).
__device__ __forceinline__ int run_steps(const Planes& p, long long g0,
                                         int step) {
    const long long left = min(p.warp_words, p.g_hi - g0);
    return left > 0 ? (int)((left + step - 1) / step) : 0;
}

__device__ __forceinline__ long long warp_sum(long long x) {
#pragma unroll
    for (int o = 16; o; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    return x;
}

// Checks the geometry of a launch and fills p (false for arguments the
// kernels do not take): grid blocks of `warps` warps, each a run of
// warp_words stream words (a multiple of `step`), must cover the kept
// stream words, and grid - 1 blocks must not; n below 2^36 keeps a
// stream word's index in 32 bits.
inline bool make_planes(const uint32_t* planes, int n_planes, long long T,
                        int n_words, const uint32_t* vals, int W, int L,
                        long long n, long long keep_from, int grid,
                        long long warp_words, int warps, int step,
                        Planes* p) {
    if (n_planes < 1 || n_planes > kMaxPlanes || L < 32 || L % 32 != 0
        || W < 0 || W > L || n_words != (W + L + 31) / 32 || n < 1
        || n >= (1LL << 36) || keep_from < 0 || keep_from >= n || T < 1
        || T * (long long)L < n || grid < 1 || warp_words < step
        || warp_words % step != 0)
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
    p->warp_words = warp_words;
    return (long long)grid * warps * warp_words >= p->g_hi - p->g_lo
           && (long long)(grid - 1) * warps * warp_words
                  < p->g_hi - p->g_lo;
}

// Lets kernel take dyn bytes of dynamic shared memory (above 48 KB only
// after this).
inline cudaError_t allow_shared(const void* kernel, size_t dyn) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)dyn);
}

// The blocks of `threads` threads and dyn shared bytes that the current
// device holds at once (cudaErrorNotSupported without cooperative
// launch).
inline int resident_blocks(const void* kernel, int threads, size_t dyn,
                           int* blocks) {
    int dev = 0, coop = 0, sms = 0, per = 0;
    cudaError_t err = allow_shared(kernel, dyn);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                     dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel,
                                                            threads, dyn);
    if (err != cudaSuccess) return (int)err;
    if (!coop) return (int)cudaErrorNotSupported;
    *blocks = per * sms;
    return 0;
}

}  // namespace plane_words
