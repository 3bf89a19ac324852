// Record-parallel regex-with-errors lanes for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// agrep_tpu/ops/renfa_kernel.py::_get_lanes_kernel (the `run` it returns,
// pl.pallas_call at renfa_kernel.py:188).  It computes the same verdict
// per line -- the Glushkov position automaton with the re1 k-error
// recurrence (agrep.c:802-906), read at the line's newline with the tail
// epsilon step -- and none of the TPU layout carries over: no zero-padded
// lane matrix, no length buckets, no compare tree for CMask, no
// sign-spread selects for nxt.
//
// What bounds it on an H100: integer operations, not HBM.  At its least
// (chip_smoke.py regex_byte_ops) a text byte takes D+1 nxt, each one
// shared-memory load from the tabulated Next and two int32 operations,
// and 4 + 4D more operations to extract the byte, look up its CMask and
// combine the levels.  What each part of the design does about it:
//
//   * One nxt a level a byte.  re1's recurrence reads nxt(s[k]) and
//     nxt(s[k-1] | nw[k-1]) at level k; nxt is an OR over the set bits
//     of its argument, so the second is nxt(s[k-1]) | nxt(nw[k-1]), and
//     nxt(nw[k-1]) is the next byte's nxt(s[k-1]).  The thread carries
//     each state's nxt beside it: D+1 lookups a byte, not 2D+1.
//   * Tabulated Next in shared memory, the reference's own design
//     (ops/renfa.py next_tables_arrays): nxt(S) = T[(S >> 1) &
//     (2^rel - 1)], with rel = M - 1 index bits and the head bit folded
//     into T.  Two forms, a template parameter each:
//       kOne    one table of 2^rel words, rel <= 15 (128 KB at most;
//               config 4's M = 15 takes 64 KB);
//       kBytes  four 256-word tables, one a byte of S (the first
//               port's form), for any M (up to 31: a '?' can make it).
//     A machine of more than 16 positions takes kBytes; no main-path
//     run has one.
//     Each block builds its tables once, from the four byte tables the
//     machine already carries (RegexMachine.tables rows 1-4, read
//     through L1), so the host uploads nothing new and the wrapper's
//     interface is unchanged.  The byte -> CMask table sits beside them.
//     A warp's 32 table loads meet 2.2 shared accesses on the busiest
//     bank at config 4 (counted by tools/torch_renfa_lanes_time.py);
//     the index is the automaton's state, so no layout spreads them.
//   * A persistent grid: as many blocks as the SMs hold at the table's
//     size (the occupancy calculator), never more than the lines need.
//     Warp w takes the runs of 32 consecutive lines w, w + warps, ...
//     in the launch's order; the host passes the lines in length order,
//     so a warp's lines have close (on the main path equal) lengths.
//   * 16-byte line loads: each thread reads its line as aligned 16-byte
//     pieces, one piece ahead of its use, and funnel-shifts each 16
//     bytes of the line out of two of them, so the unrolled steps take
//     their bytes from registers.  A piece is loaded only when it holds
//     a byte of the line; one that is not wholly inside [text, text + n)
//     is read byte by byte, so no load leaves the text and the text may
//     start at any address.  The start and length of the lane's line in
//     the warp's next run are read while it steps this one.
//   * The D+1 u32 states stay in registers; D (0..4) is a template
//     parameter, one compile unit each.  `init`, the start states, is a
//     launch argument (the memory-mode leading line launches with its
//     own seed, one line and so one block).
//
// Built by ops/_cuda.py as six objects compiled in parallel and linked
// into one shared library with a plain C interface: -DRENFA_D=0..4
// compiles the kernels of one D each (both forms), and the object
// without it holds the C entry points.  Flags: nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC.

#include <cstdint>
#include <cuda_runtime.h>

#include "text_piece.cuh"

namespace renfa_lanes {

constexpr int kMaxD = 4;
constexpr int kMaxThreads = 1024;
constexpr int kCMask = 256;          // u32 words of the CMask table

enum Form { kOne = 0, kBytes = 1 };

struct Params {
    const uint8_t* text;
    long long n;
    const long long* starts;
    const long long* lens;
    long long R;
    const uint32_t* tables;      // u32[5][256]: CMask, then T0..T3
    uint32_t head, init1, noerr;
    int tail;
    int rel;                     // index bits of the Next: max(M - 1, 0)
    uint32_t init[kMaxD + 1];
    uint8_t* out;
};

// u32 words of a form's Next tables.
inline int table_words(int form, int rel) {
    return form == kOne ? 1 << rel : 4 * 256;
}

inline int shared_bytes(int form, int rel) {
    return 4 * (kCMask + table_words(form, rel));
}

// ops/renfa_kernel.py forms() states the same rule.
inline bool form_ok(int form, int rel) {
    return rel >= 0 && rel <= 31
        && (form == kBytes || (form == kOne && rel <= 15));
}

// Defined in the object built with RENFA_D=D.
template <int D>
cudaError_t launch_d(const Params& p, int form, int threads, int grid,
                     cudaStream_t stream);
template <int D>
cudaError_t geometry_d(int form, int rel, int threads, int* blocks_per_sm,
                       int* regs, int* local_bytes);

}  // namespace renfa_lanes

#ifdef RENFA_D

namespace renfa_lanes {
namespace {

template <int F> struct Next;

template <> struct Next<kOne> {
    const uint32_t* tab;
    uint32_t off_mask;          // the index mask times 4
    __device__ __forceinline__ uint32_t operator()(uint32_t s) const {
        // entry (s >> 1) & mask, at byte offset (s << 1) & (mask << 2)
        return *reinterpret_cast<const uint32_t*>(
            reinterpret_cast<const uint8_t*>(tab) + ((s << 1) & off_mask));
    }
};

template <> struct Next<kBytes> {
    const uint32_t* tab;
    uint32_t head;
    __device__ __forceinline__ uint32_t operator()(uint32_t s) const {
        return head | tab[s & 255u] | tab[256 + ((s >> 8) & 255u)]
               | tab[512 + ((s >> 16) & 255u)] | tab[768 + (s >> 24)];
    }
};

// nxt(s) without the head bit, from the byte tables in device memory.
__device__ __forceinline__ uint32_t byte_nxt(const uint32_t* t,
                                             uint32_t s) {
    return __ldg(t + 256 + (s & 255u))
           | __ldg(t + 512 + ((s >> 8) & 255u))
           | __ldg(t + 768 + ((s >> 16) & 255u))
           | __ldg(t + 1024 + (s >> 24));
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

// The CMask of byte b (0..3) of word w: its table entry's byte offset
// is the byte times 4.
template <int B>
__device__ __forceinline__ uint32_t cmask_of(const uint32_t* s_cm,
                                             uint32_t w) {
    const uint32_t off = B == 0 ? (w << 2) & 0x3fcu
                                : (w >> (8 * B - 2)) & 0x3fcu;
    return *reinterpret_cast<const uint32_t*>(
        reinterpret_cast<const uint8_t*>(s_cm) + off);
}

// re1 char step (agrep.c:802-856; ops/renfa.py step_char) on the states
// s and their nxt values n = nxt(s).  nxt is an OR over the set bits of
// its argument, so nxt(s[k-1] | nw[k-1]) = n[k-1] | nxt(nw[k-1]), and
// nxt(nw[k-1]) is the next byte's n[k-1]: a byte takes D+1 nxt, not
// 2D+1.
template <int D, class N>
__device__ __forceinline__ void step(uint32_t (&s)[D + 1],
                                     uint32_t (&n)[D + 1], uint32_t cm,
                                     const N& nxt, uint32_t init1,
                                     uint32_t noerr) {
    uint32_t nw[D + 1], nn[D + 1];
    nw[0] = (n[0] & cm) | (init1 & s[0]);
    nn[0] = nxt(nw[0]);
#pragma unroll
    for (int k = 1; k <= D; ++k) {
        nw[k] = (n[k] & cm) | ((s[k - 1] | n[k - 1] | nn[k - 1]) & noerr)
                | (init1 & s[k]);
        nn[k] = nxt(nw[k]);
    }
#pragma unroll
    for (int k = 0; k <= D; ++k) {
        s[k] = nw[k];
        n[k] = nn[k];
    }
}

template <int F>
__device__ __forceinline__ Next<F> fill(const Params& p, uint32_t* tab);

template <>
__device__ __forceinline__ Next<kOne> fill<kOne>(const Params& p,
                                                uint32_t* tab) {
    for (int i = threadIdx.x; i < 1 << p.rel; i += blockDim.x)
        tab[i] = p.head | byte_nxt(p.tables, (uint32_t)i << 1);
    return Next<kOne>{tab, ((1u << p.rel) - 1u) << 2};
}

template <>
__device__ __forceinline__ Next<kBytes> fill<kBytes>(const Params& p,
                                                    uint32_t* tab) {
    for (int i = threadIdx.x; i < 4 * 256; i += blockDim.x)
        tab[i] = p.tables[kCMask + i];
    return Next<kBytes>{tab, p.head};
}

// The verdict of the line of len bytes at text + start: its bytes
// stepped from the start states, read at its newline.
template <int D, class N>
__device__ __forceinline__ uint32_t line_verdict(
        const Params& p, const uint32_t* s_cm, const N& nxt,
        const uint32_t (&n_init)[D + 1], uintptr_t lo, uintptr_t hi,
        long long start, long long len) {
    const uint32_t init1 = p.init1, noerr = p.noerr;
    uint32_t s[D + 1], n[D + 1];
#pragma unroll
    for (int k = 0; k <= D; ++k) {
        s[k] = p.init[k];
        n[k] = n_init[k];
    }
    const uintptr_t s0 = lo + (uintptr_t)start;
    const uintptr_t e = s0 + (uintptr_t)len;    // the newline
    const int sh = (int)(s0 & 15);
    // line bytes j .. j + 15 lie in the pieces at a and a + 16; a piece
    // is loaded when it holds a byte of the line, one window ahead of
    // its use
    uintptr_t a = s0 - sh;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    uint4 cur = a < e ? text_piece(a, lo, hi) : zero;
    uint4 nx = a + 16 < e ? text_piece(a + 16, lo, hi) : zero;
    long long j = 0;
    uint32_t w[4];
    for (; j + 16 <= len; j += 16) {
        const uint4 ahead =
            a + 32 < e ? text_piece(a + 32, lo, hi) : zero;
        window(cur, nx, sh, w);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            step<D>(s, n, cmask_of<0>(s_cm, w[q]), nxt, init1, noerr);
            step<D>(s, n, cmask_of<1>(s_cm, w[q]), nxt, init1, noerr);
            step<D>(s, n, cmask_of<2>(s_cm, w[q]), nxt, init1, noerr);
            step<D>(s, n, cmask_of<3>(s_cm, w[q]), nxt, init1, noerr);
        }
        a += 16;
        cur = nx;
        nx = ahead;
    }
    if (j < len) {                  // the last len - j < 16 bytes
        const int rem = (int)(len - j);
        window(cur, nx, sh, w);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            if (4 * q >= rem) break;
            step<D>(s, n, cmask_of<0>(s_cm, w[q]), nxt, init1, noerr);
            if (4 * q + 1 >= rem) break;
            step<D>(s, n, cmask_of<1>(s_cm, w[q]), nxt, init1, noerr);
            if (4 * q + 2 >= rem) break;
            step<D>(s, n, cmask_of<2>(s_cm, w[q]), nxt, init1, noerr);
            if (4 * q + 3 >= rem) break;
            step<D>(s, n, cmask_of<3>(s_cm, w[q]), nxt, init1, noerr);
        }
    }
    // the newline column: verdict before the char step (re1:858-906)
    const uint32_t cm =
        s_cm[__ldg(reinterpret_cast<const uint8_t*>(e))];
    uint32_t ad = (n[D] & cm) | (init1 & s[D]);
    if (p.tail) ad |= nxt(ad);
    return ad & 1u;
}

template <int D, int F>
__global__ void __launch_bounds__(kMaxThreads)
renfa_lanes_kernel(const Params p) {
    extern __shared__ uint32_t smem[];    // CMask, then the Next tables
    uint32_t* s_cm = smem;
    for (int i = threadIdx.x; i < kCMask; i += blockDim.x)
        s_cm[i] = p.tables[i];
    const Next<F> nxt = fill<F>(p, smem + kCMask);
    __syncthreads();

    uint32_t n_init[D + 1];         // nxt of the start states
#pragma unroll
    for (int k = 0; k <= D; ++k) n_init[k] = nxt(p.init[k]);
    const uintptr_t lo = reinterpret_cast<uintptr_t>(p.text);
    const uintptr_t hi = lo + (uintptr_t)p.n;
    const int lane = threadIdx.x & 31;
    const long long n_runs = (p.R + 31) >> 5;
    const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
    // warp w takes the runs of 32 lines w, w + warps, ...; each lane's
    // line of the warp's next run is read while it steps the line of
    // this one
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
        if (r < p.R)
            p.out[r] = (uint8_t)line_verdict<D>(p, s_cm, nxt, n_init, lo,
                                                hi, start, len);
        run = run2;
        r = r2;
        start = start2;
        len = len2;
    }
}

template <int D>
const void* kernel_for(int form) {
    if (form == kOne)
        return reinterpret_cast<const void*>(renfa_lanes_kernel<D, kOne>);
    return reinterpret_cast<const void*>(renfa_lanes_kernel<D, kBytes>);
}

}  // namespace

template <int D>
cudaError_t geometry_d(int form, int rel, int threads, int* blocks_per_sm,
                       int* regs, int* local_bytes) {
    const void* k = kernel_for<D>(form);
    const int smem = shared_bytes(form, rel);
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, k);
    if (err != cudaSuccess) return err;
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k,
                                                         threads, smem);
}

template <int D>
cudaError_t launch_d(const Params& p, int form, int threads, int grid,
                     cudaStream_t stream) {
    const int smem = shared_bytes(form, p.rel);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel_for<D>(form), cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    if (form == kOne)
        renfa_lanes_kernel<D, kOne><<<grid, threads, smem, stream>>>(p);
    else
        renfa_lanes_kernel<D, kBytes><<<grid, threads, smem, stream>>>(p);
    return cudaGetLastError();
}

template cudaError_t launch_d<RENFA_D>(const Params&, int, int, int,
                                       cudaStream_t);
template cudaError_t geometry_d<RENFA_D>(int, int, int, int*, int*, int*);

}  // namespace renfa_lanes

#else  // the C entry points

using namespace renfa_lanes;

namespace {

bool shape_ok(int D, int M, int form, int threads) {
    return D >= 0 && D <= kMaxD && M >= 0 && M <= 32
        && form_ok(form, M > 1 ? M - 1 : 0) && threads >= 32
        && threads <= kMaxThreads && threads % 32 == 0;
}

}  // namespace

extern "C" {

// Geometry of a launch of the kernel of D and form (0 one table, 1 four
// byte tables) for a machine of M positions with
// `threads` a block: dynamic shared bytes a block, how many such blocks
// one SM of the current device holds, and the kernel's registers a
// thread and local (spill) bytes.  Returns a cudaError_t
// (cudaErrorInvalidValue for arguments the kernel does not take).
int renfa_lanes_geometry(int D, int M, int form, int threads,
                         int* smem_bytes, int* blocks_per_sm, int* regs,
                         int* local_bytes) {
    if (!shape_ok(D, M, form, threads)) return (int)cudaErrorInvalidValue;
    const int rel = M > 1 ? M - 1 : 0;
    *smem_bytes = shared_bytes(form, rel);
    switch (D) {
        case 0: return (int)geometry_d<0>(form, rel, threads, blocks_per_sm,
                                          regs, local_bytes);
        case 1: return (int)geometry_d<1>(form, rel, threads, blocks_per_sm,
                                          regs, local_bytes);
        case 2: return (int)geometry_d<2>(form, rel, threads, blocks_per_sm,
                                          regs, local_bytes);
        case 3: return (int)geometry_d<3>(form, rel, threads, blocks_per_sm,
                                          regs, local_bytes);
        default: return (int)geometry_d<4>(form, rel, threads, blocks_per_sm,
                                           regs, local_bytes);
    }
}

// Launches the lanes kernel on `stream` with `grid` blocks of `threads`
// (at most one thread a line); returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments the kernel does not take).
// All pointers are device pointers except init (host, D+1 entries).  The
// caller guarantees 0 <= starts[r] and starts[r] + lens[r] < n for every
// line; the text may start at any address; out holds R bytes (0 or 1).
int renfa_lanes_launch(const uint8_t* text, long long n,
                       const long long* starts, const long long* lens,
                       long long R, const uint32_t* tables, uint32_t head,
                       uint32_t init1, uint32_t noerr, int tail, int D,
                       const uint32_t* init, uint8_t* out, int M, int form,
                       int threads, int grid, void* stream) {
    if (n < 1 || R < 1 || grid < 1 || !shape_ok(D, M, form, threads))
        return (int)cudaErrorInvalidValue;

    const long long need = (R + threads - 1) / threads;
    if (grid > need) grid = (int)need;
    Params p;
    p.text = text;
    p.n = n;
    p.starts = starts;
    p.lens = lens;
    p.R = R;
    p.tables = tables;
    p.head = head;
    p.init1 = init1;
    p.noerr = noerr;
    p.tail = tail;
    p.rel = M > 1 ? M - 1 : 0;
    for (int k = 0; k <= kMaxD; ++k) p.init[k] = k <= D ? init[k] : 0u;
    p.out = out;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 0: return (int)launch_d<0>(p, form, threads, grid, s);
        case 1: return (int)launch_d<1>(p, form, threads, grid, s);
        case 2: return (int)launch_d<2>(p, form, threads, grid, s);
        case 3: return (int)launch_d<3>(p, form, threads, grid, s);
        default: return (int)launch_d<4>(p, form, threads, grid, s);
    }
}

const char* renfa_lanes_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

#endif  // RENFA_D
