// Record-parallel regex-with-errors lanes for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// agrep_tpu/ops/renfa_kernel.py::_get_lanes_kernel (the `run` it returns,
// pl.pallas_call at renfa_kernel.py:188).  It computes the same verdict
// per line -- the Glushkov position automaton with the re1 k-error
// recurrence (agrep.c:802-906), read at the line's newline with the tail
// epsilon step -- and none of the TPU layout carries over:
//
//   * One thread runs one line r = 0..R-1, reading its bytes straight
//     from text + starts[r]: no zero-padded lane matrix, no length
//     buckets.  The host passes the lines in length order, so the 32
//     lines of a warp have close lengths and little of the warp idles.
//   * nxt(S) = head | T0[S & 255] | T1[(S >> 8) & 255]
//                   | T2[(S >> 16) & 255] | T3[S >> 24]
//     from four 256-entry byte tables (ops/renfa.py nxt_byte_tables), and
//     the byte -> CMask lookup is one more table: 5 KB of shared memory.
//     This replaces the TPU kernel's compare tree for CMask and its
//     sign-spread selects for nxt, and so takes every machine the
//     compiler makes (the TPU path gave up on masks with many ranges).
//   * The D+1 u32 states stay in registers; D (0..4) is a template
//     parameter, one compile unit each.
//   * `init`, the start states, is a launch argument: every line of a
//     launch starts from it (the memory-mode leading line launches with
//     its own seed).
//
// What bounds it on an H100: integer operations, not HBM.  Per text byte
// the function evaluates nxt 2D+1 times.  At its least (chip_smoke.py's
// bound) an nxt is one shared-memory load from the reference's tabulated
// Next (2^(M-1) entries; up to M = 16 it fits a block's shared memory)
// and two int32 operations, and a byte is 6 + 7*D operations and 2 + 2*D
// loads against one byte read from HBM: at 3.35 TB/s, ~16.7 T int32 op/s
// and ~8.4 T shared loads/s the operations take 1.2x (D=0) to 6.8x (D=4)
// longer than the bytes.  This kernel does more than that least: its nxt
// is four byte-table loads and about ten shifts, masks and ORs, which
// keeps one 5 KB table set for every M <= 30 and makes each block's
// table fill cheap.  Threads of a warp whose table indices differ within
// a bank also cost bank conflicts.  Known slack left for a later change:
// the tabulated Next in shared memory under a persistent grid (one table
// fill per block, blocks looping over the lines), a warp's threads
// reading 32 different lines byte by byte (uncoalesced; 16-byte loads
// staged through shared memory would fix that), and one long line as one
// long thread (a warp sharing a long line would fix that).
//
// Built by ops/_cuda.py as six objects compiled in parallel and linked
// into one shared library with a plain C interface: -DRENFA_D=0..4
// compiles the kernel of one D each, and the object without it holds the
// C entry points.  Flags: nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 -Xcompiler -fPIC.

#include <cstdint>
#include <cuda_runtime.h>

namespace renfa_lanes {

constexpr int kMaxD = 4;
constexpr int kThreads = 128;
constexpr int kTables = 5;       // CMask, then the nxt tables T0..T3

struct Params {
    const uint8_t* text;
    long long n;
    const long long* starts;
    const long long* lens;
    long long R;
    const uint32_t* tables;      // u32[5][256]
    uint32_t head, init1, noerr;
    int tail;
    uint32_t init[kMaxD + 1];
    uint8_t* out;
};

// Launches the kernel of one D (defined in the object built with
// RENFA_D=D).
template <int D>
cudaError_t launch_d(const Params& p, cudaStream_t stream);

}  // namespace renfa_lanes

#ifdef RENFA_D

namespace renfa_lanes {
namespace {

__device__ __forceinline__ uint32_t nxt(uint32_t s,
                                        const uint32_t (*tab)[256],
                                        uint32_t head) {
    return head | tab[1][s & 255u] | tab[2][(s >> 8) & 255u]
           | tab[3][(s >> 16) & 255u] | tab[4][s >> 24];
}

template <int D>
__global__ void __launch_bounds__(kThreads)
renfa_lanes_kernel(const Params p) {
    __shared__ uint32_t tab[kTables][256];
    for (int i = threadIdx.x; i < kTables * 256; i += blockDim.x)
        tab[i >> 8][i & 255] = p.tables[i];
    __syncthreads();
    const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= p.R) return;

    const uint32_t head = p.head, init1 = p.init1, noerr = p.noerr;
    uint32_t s[D + 1];
#pragma unroll
    for (int k = 0; k <= D; ++k) s[k] = p.init[k];

    const uint8_t* __restrict__ line = p.text + p.starts[r];
    const long long len = p.lens[r];
#pragma unroll 4
    for (long long j = 0; j < len; ++j) {
        const uint32_t cm = tab[0][__ldg(line + j)];
        // re1 char step (agrep.c:802-856); ops/renfa.py step_char
        uint32_t nw[D + 1];
        nw[0] = (nxt(s[0], tab, head) & cm) | (init1 & s[0]);
#pragma unroll
        for (int k = 1; k <= D; ++k) {
            const uint32_t r0 = s[k - 1] | nw[k - 1];
            nw[k] = (nxt(s[k], tab, head) & cm)
                    | ((s[k - 1] | nxt(r0, tab, head)) & noerr)
                    | (init1 & s[k]);
        }
#pragma unroll
        for (int k = 0; k <= D; ++k) s[k] = nw[k];
    }
    // the newline column: verdict before the char step (re1:858-906)
    const uint32_t cm = tab[0][__ldg(line + len)];
    uint32_t ad = (nxt(s[D], tab, head) & cm) | (init1 & s[D]);
    if (p.tail) ad |= nxt(ad, tab, head);
    p.out[r] = (uint8_t)(ad & 1u);
}

}  // namespace

template <int D>
cudaError_t launch_d(const Params& p, cudaStream_t stream) {
    const long long blocks = (p.R + kThreads - 1) / kThreads;
    renfa_lanes_kernel<D><<<(unsigned)blocks, kThreads, 0, stream>>>(p);
    return cudaGetLastError();
}

template cudaError_t launch_d<RENFA_D>(const Params&, cudaStream_t);

}  // namespace renfa_lanes

#else  // the C entry points

using namespace renfa_lanes;

extern "C" {

// Launches the lanes kernel on `stream`; returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments the kernel does
// not take).  All pointers are device pointers except init (host, D+1
// entries).  The caller guarantees 0 <= starts[r] and
// starts[r] + lens[r] < n for every line; out holds R bytes (0 or 1).
int renfa_lanes_launch(const uint8_t* text, long long n,
                       const long long* starts, const long long* lens,
                       long long R, const uint32_t* tables, uint32_t head,
                       uint32_t init1, uint32_t noerr, int tail, int D,
                       const uint32_t* init, uint8_t* out, void* stream) {
    if (n < 1 || R < 1 || D < 0 || D > kMaxD
        || (R + kThreads - 1) / kThreads > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
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
    for (int k = 0; k <= kMaxD; ++k) p.init[k] = k <= D ? init[k] : 0u;
    p.out = out;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 0: return (int)launch_d<0>(p, s);
        case 1: return (int)launch_d<1>(p, s);
        case 2: return (int)launch_d<2>(p, s);
        case 3: return (int)launch_d<3>(p, s);
        case 4: return (int)launch_d<4>(p, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* renfa_lanes_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

#endif  // RENFA_D
