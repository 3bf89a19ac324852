// Record lanes of the sticky bitap machines for NVIDIA Hopper (sm_90a).
//
// Replaces the host lane scan of agrep_tpu (agrep_tpu/ops/scan.py:337
// `scan_lanes`, a numpy column loop, fed by
// agrep_tpu/runtime/engine.py:721 `_bitap_record_lane_events`, which
// copies each record into a lane matrix in a Python loop).  The machines
// it serves keep bits sticky with no bound on their reach: -p (Init1 =
// ~0, bitap.c:123) and '#' wildcards (the wildmask in Init1), so the
// windowed restart of mask_scan.cu is invalid for them, and a record is
// the unit of independent work: each starts from the machine's
// post-reset state (or, in memory mode, the first from Init0), and only
// the delimiter ends it.
//
// The function.  Input: a u8 text, R lanes (start, len) -- lane r is the
// len + 1 bytes text[start .. start + len], its record and then its
// one-byte delimiter -- the folded mask table u32[256], Init1, the
// no-error mask, endpos, D (0..8), the uniform k-error wiring (asearch.c)
// or the cost wiring (I, S, DD; asearch1.c), the D+1 start states, and
// those of the lane that starts at 0.  Output a lane: hits, the OR over
// its columns 0..len of (state_D & endpos), and its verdict as the
// record walk reads it: with AND, (hits == endpos) or -v; else
// (hits != 0) xor -v.  The columns step
//     s0' = ((s0 >> 1) & cm) | (Init1 & s0)
//     sk' = ((sk >> 1) & cm) | (Init1 & sk) | s(k-1)
//           | (((s(k-1)' | s(k-1)) >> 1) & noerr)              (uniform)
// or level k drawing insertions from k - I, substitutions from k - S
// and deletions from the new level k - DD (costs), with no delimiter
// reset inside a lane: its one delimiter is its last byte.
//
// What bounds it on an H100: int32 operations.  A byte takes the level
// pass (3 + 6D operations, uniform), its extract and CMask address (2),
// the hit OR (1) and one shared load.  The design:
//
//   * One thread a lane.  The host gives the lanes in length order
//     (line_index.cu with the delimiter byte), so a warp's 32 lanes end
//     together; warp w takes the runs of 32 lanes w, w + warps, ... of a
//     persistent grid (as many blocks as the SMs hold), and reads its
//     next run's starts and lengths while it steps this one.
//   * The mask table in shared memory, 1 KB a block; a byte's CMask is one
//     shared load at the byte times 4.
//   * 16-byte loads: each thread reads its lane as aligned 16-byte pieces,
//     one piece ahead of its use, and funnel-shifts each 16 lane bytes out
//     of two of them (text_piece.cuh: a piece not wholly inside the text
//     is read byte by byte, so no load leaves it).
//   * The D+1 states in registers; D a template parameter (one compile
//     unit each), the wiring another.  The cost wiring's edges are masks
//     set once a thread, as in mask_scan.cu, so a column spends a logic op
//     an edge and no compare.
//   * A record without a delimiter in it is one lane, walked serially by
//     one thread: the sticky bits make its dependence unbounded, so no
//     split of the lane is exact.
//
// Built by ops/_cuda.py as ten objects compiled in parallel and linked
// into one shared library with a plain C interface: -DBITAP_D=0..8
// compiles the kernels of one D each (both wirings), and the object
// without it holds the C entry points.  Flags: nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC.

#include <cstdint>
#include <cuda_runtime.h>

#include "text_piece.cuh"

namespace bitap_lanes {

constexpr int kMaxD = 8;
constexpr int kMaxThreads = 1024;

struct Params {
    const uint8_t* text;
    long long n;
    const long long* starts;
    const long long* lens;
    long long R;
    const uint32_t* mask;        // u32[256], device
    uint32_t init1, noerr, endpos;
    int ci, cs, cd;              // the cost wiring; 0: uniform
    uint32_t init[kMaxD + 1];    // a lane's start states
    uint32_t first[kMaxD + 1];   // those of the lane that starts at 0
    int and_flag, invert;
    uint8_t* verdicts;
    uint32_t* hits;
};

// Defined in the object built with BITAP_D=D.
template <int D>
cudaError_t launch_d(const Params& p, int threads, int grid,
                     cudaStream_t stream);
template <int D>
cudaError_t geometry_d(int cost, int threads, int* blocks_per_sm, int* regs,
                       int* local_bytes);

}  // namespace bitap_lanes

#ifdef BITAP_D

namespace bitap_lanes {
namespace {

// The cost wiring's edges as masks, one per level distance d = 0..D:
// all ones where level k draws from level k - d, else 0.
template <int D>
struct CostMasks {
    uint32_t ins[D + 1], sub[D + 1], del[D + 1];

    __device__ __forceinline__ void set(const Params& p) {
#pragma unroll
        for (int d = 0; d <= D; ++d) {
            ins[d] = p.ci == d ? ~0u : 0u;
            sub[d] = p.cs == d ? ~0u : 0u;
            del[d] = p.cd == d ? ~0u : 0u;
        }
    }
};

// One column: the levels stepped on cm, and state_D ORed into acc.
template <int D, bool C>
__device__ __forceinline__ void step(uint32_t (&s)[D + 1], uint32_t& acc,
                                     uint32_t cm, uint32_t init1,
                                     uint32_t noerr, const CostMasks<D>& cw) {
    uint32_t nw[D + 1];
    if (!C) {
        nw[0] = ((s[0] >> 1) & cm) | (init1 & s[0]);
#pragma unroll
        for (int k = 1; k <= D; ++k)
            nw[k] = ((s[k] >> 1) & cm) | (init1 & s[k]) | s[k - 1]
                    | (((nw[k - 1] | s[k - 1]) >> 1) & noerr);
    } else {
#pragma unroll
        for (int k = 0; k <= D; ++k) {
            uint32_t r = ((s[k] >> 1) & cm) | (init1 & s[k]);
            uint32_t err = 0;
#pragma unroll
            for (int j = 0; j <= k; ++j) {
                r |= s[j] & cw.ins[k - j];
                err |= s[j] & cw.sub[k - j];
                if (j < k) err |= nw[j] & cw.del[k - j];
            }
            nw[k] = r | ((err >> 1) & noerr);
        }
    }
#pragma unroll
    for (int k = 0; k <= D; ++k) s[k] = nw[k];
    acc |= s[D];
}

// Bytes sh .. sh + 15 (sh < 16) of the 32 bytes p:q, as four words.
__device__ __forceinline__ void window(const uint4& p, const uint4& q,
                                       int sh, uint32_t (&w)[4]) {
    const uint32_t x[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
    uint32_t y[6], z[5];
#pragma unroll
    for (int k = 0; k < 6; ++k) y[k] = (sh & 8) ? x[k + 2] : x[k];
#pragma unroll
    for (int k = 0; k < 5; ++k) z[k] = (sh & 4) ? y[k + 1] : y[k];
#pragma unroll
    for (int k = 0; k < 4; ++k)
        w[k] = __funnelshift_r(z[k], z[k + 1], 8 * (sh & 3));
}

// The CMask of byte B (0..3) of word w: its table entry's byte offset is
// the byte times 4.
template <int B>
__device__ __forceinline__ uint32_t cmask_of(const uint32_t* s_cm,
                                             uint32_t w) {
    const uint32_t off = B == 0 ? (w << 2) & 0x3fcu
                                : (w >> (8 * B - 2)) & 0x3fcu;
    return *reinterpret_cast<const uint32_t*>(
        reinterpret_cast<const uint8_t*>(s_cm) + off);
}

// hits of the lane of cnt bytes at text + start (its record and its
// delimiter), stepped from the start states.
template <int D, bool C>
__device__ __forceinline__ uint32_t lane_hits(
        const Params& p, const uint32_t* s_cm, const CostMasks<D>& cw,
        uintptr_t lo, uintptr_t hi, long long start, long long cnt) {
    const uint32_t init1 = p.init1, noerr = p.noerr;
    uint32_t s[D + 1];
#pragma unroll
    for (int k = 0; k <= D; ++k) s[k] = start == 0 ? p.first[k] : p.init[k];
    uint32_t acc = 0u;
    const uintptr_t s0 = lo + (uintptr_t)start;
    const uintptr_t e = s0 + (uintptr_t)cnt;       // one past the lane
    const int sh = (int)(s0 & 15);
    // lane bytes j .. j + 15 lie in the pieces at a and a + 16; a piece
    // is loaded when it holds a byte of the lane, one window ahead of its
    // use
    uintptr_t a = s0 - sh;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    uint4 cur = a < e ? text_piece(a, lo, hi) : zero;
    uint4 nx = a + 16 < e ? text_piece(a + 16, lo, hi) : zero;
    long long j = 0;
    uint32_t w[4];
    for (; j + 16 <= cnt; j += 16) {
        const uint4 ahead = a + 32 < e ? text_piece(a + 32, lo, hi) : zero;
        window(cur, nx, sh, w);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            step<D, C>(s, acc, cmask_of<0>(s_cm, w[q]), init1, noerr, cw);
            step<D, C>(s, acc, cmask_of<1>(s_cm, w[q]), init1, noerr, cw);
            step<D, C>(s, acc, cmask_of<2>(s_cm, w[q]), init1, noerr, cw);
            step<D, C>(s, acc, cmask_of<3>(s_cm, w[q]), init1, noerr, cw);
        }
        a += 16;
        cur = nx;
        nx = ahead;
    }
    if (j < cnt) {                  // the last cnt - j < 16 bytes
        const int rem = (int)(cnt - j);
        window(cur, nx, sh, w);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            if (4 * q >= rem) break;
            step<D, C>(s, acc, cmask_of<0>(s_cm, w[q]), init1, noerr, cw);
            if (4 * q + 1 >= rem) break;
            step<D, C>(s, acc, cmask_of<1>(s_cm, w[q]), init1, noerr, cw);
            if (4 * q + 2 >= rem) break;
            step<D, C>(s, acc, cmask_of<2>(s_cm, w[q]), init1, noerr, cw);
            if (4 * q + 3 >= rem) break;
            step<D, C>(s, acc, cmask_of<3>(s_cm, w[q]), init1, noerr, cw);
        }
    }
    return acc & p.endpos;
}

template <int D, bool C>
__global__ void __launch_bounds__(kMaxThreads)
bitap_lanes_kernel(const Params p) {
    __shared__ uint32_t s_cm[256];
    for (int i = threadIdx.x; i < 256; i += blockDim.x) s_cm[i] = p.mask[i];
    __syncthreads();
    CostMasks<D> cw;
    if (C) cw.set(p);

    const uintptr_t lo = reinterpret_cast<uintptr_t>(p.text);
    const uintptr_t hi = lo + (uintptr_t)p.n;
    const int lane = threadIdx.x & 31;
    const long long n_runs = (p.R + 31) >> 5;
    const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
    // warp w takes the runs of 32 lanes w, w + warps, ...; each thread's
    // lane of the warp's next run is read while it steps this one
    long long run = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    long long r = (run << 5) + lane;
    long long start = 0, len = 0;
    if (run < n_runs && r < p.R) {
        start = p.starts[r];
        len = p.lens[r];
    }
    while (run < n_runs) {
        const long long run2 = run + warps;
        const long long r2 = (run2 << 5) + lane;
        long long start2 = 0, len2 = 0;
        if (run2 < n_runs && r2 < p.R) {
            start2 = p.starts[r2];
            len2 = p.lens[r2];
        }
        if (r < p.R) {
            const uint32_t h = lane_hits<D, C>(p, s_cm, cw, lo, hi, start,
                                               len + 1);
            const bool fire = p.and_flag
                                  ? (h == p.endpos) || p.invert
                                  : (h != 0u) != (p.invert != 0);
            p.hits[r] = h;
            p.verdicts[r] = (uint8_t)fire;
        }
        run = run2;
        r = r2;
        start = start2;
        len = len2;
    }
}

template <int D>
const void* kernel_for(int cost) {
    if (cost)
        return reinterpret_cast<const void*>(bitap_lanes_kernel<D, true>);
    return reinterpret_cast<const void*>(bitap_lanes_kernel<D, false>);
}

}  // namespace

template <int D>
cudaError_t geometry_d(int cost, int threads, int* blocks_per_sm, int* regs,
                       int* local_bytes) {
    const void* k = kernel_for<D>(cost);
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, k);
    if (err != cudaSuccess) return err;
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k,
                                                         threads, 0);
}

template <int D>
cudaError_t launch_d(const Params& p, int threads, int grid,
                     cudaStream_t stream) {
    if (p.ci > 0)
        bitap_lanes_kernel<D, true><<<grid, threads, 0, stream>>>(p);
    else
        bitap_lanes_kernel<D, false><<<grid, threads, 0, stream>>>(p);
    return cudaGetLastError();
}

template cudaError_t launch_d<BITAP_D>(const Params&, int, int,
                                       cudaStream_t);
template cudaError_t geometry_d<BITAP_D>(int, int, int*, int*, int*);

}  // namespace bitap_lanes

#else  // the C entry points

using namespace bitap_lanes;

namespace {

bool shape_ok(int D, int threads) {
    return D >= 0 && D <= kMaxD && threads >= 32 && threads <= kMaxThreads
        && threads % 32 == 0;
}

// The cost wiring takes costs 1 .. D + 1 (compile/query.py clamps them;
// agrep refuses a cost of 0 with -I/-S/-D), or all three 0: uniform.
bool costs_ok(int D, int ci, int cs, int cd) {
    if (ci == 0 && cs == 0 && cd == 0) return true;
    return ci >= 1 && ci <= D + 1 && cs >= 1 && cs <= D + 1 && cd >= 1
        && cd <= D + 1;
}

}  // namespace

extern "C" {

// Geometry of a launch of the kernel of D and wiring (cost 0 uniform, 1
// costs) with `threads` a block: how many such blocks one SM of the
// current device holds, and the kernel's registers a thread and local
// (spill) bytes.  Returns a cudaError_t (cudaErrorInvalidValue for
// arguments the kernel does not take).
int bitap_lanes_geometry(int D, int cost, int threads, int* blocks_per_sm,
                         int* regs, int* local_bytes) {
    if (!shape_ok(D, threads)) return (int)cudaErrorInvalidValue;
    switch (D) {
#define CASE(DV) \
        case DV: return (int)geometry_d<DV>(cost, threads, blocks_per_sm, \
                                            regs, local_bytes);
        CASE(0) CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7)
        CASE(8)
#undef CASE
        default: return (int)cudaErrorInvalidValue;
    }
}

// Launches the lanes kernel on `stream` with `grid` blocks of `threads`
// (at most one thread a lane); returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments the kernel does not take).
// All pointers are device pointers except init and first (host, D+1
// entries each).  The caller guarantees 0 <= starts[r] and starts[r] +
// lens[r] < n for every lane; the text may start at any address;
// verdicts holds R bytes (0 or 1), hits R words.
int bitap_lanes_launch(const uint8_t* text, long long n,
                       const long long* starts, const long long* lens,
                       long long R, const uint32_t* mask, uint32_t init1,
                       uint32_t noerr, uint32_t endpos, int D, int ci, int cs,
                       int cd, const uint32_t* init, const uint32_t* first,
                       int and_flag, int invert, uint8_t* verdicts,
                       uint32_t* hits, int threads, int grid, void* stream) {
    if (n < 1 || R < 1 || grid < 1 || !shape_ok(D, threads)
        || !costs_ok(D, ci, cs, cd))
        return (int)cudaErrorInvalidValue;
    const long long need = (R + threads - 1) / threads;
    if (grid > need) grid = (int)need;
    Params p;
    p.text = text;
    p.n = n;
    p.starts = starts;
    p.lens = lens;
    p.R = R;
    p.mask = mask;
    p.init1 = init1;
    p.noerr = noerr;
    p.endpos = endpos;
    p.ci = ci;
    p.cs = cs;
    p.cd = cd;
    for (int k = 0; k <= kMaxD; ++k) {
        p.init[k] = k <= D ? init[k] : 0u;
        p.first[k] = k <= D ? first[k] : 0u;
    }
    p.and_flag = and_flag;
    p.invert = invert;
    p.verdicts = verdicts;
    p.hits = hits;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
#define CASE(DV) case DV: return (int)launch_d<DV>(p, threads, grid, s);
        CASE(0) CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7)
        CASE(8)
#undef CASE
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* bitap_lanes_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

#endif  // BITAP_D
