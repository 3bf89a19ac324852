// Windowed shift-or mask machine for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel agrep_tpu/ops/kernels.py::_get_pallas_scan
// (the `run` it returns, pl.pallas_call at kernels.py:386).  It computes
// the same function; none of the TPU layout carries over:
//
//   * One thread scans one tile t = 0..T-1 of L body bytes, preceded by a
//     W-byte halo of the real preceding bytes, from a cold state (the
//     halo-warmup argument in ops/scan.py).  The thread reads
//     text[t*L - W + j] for j in [0, W+L) straight from the flat text,
//     as 0 outside [0, N), so no window array is packed first.
//   * The 256-entry u32 mask table lives in shared memory (1 KB) and is
//     looked up per byte -- no static compare tree.
//   * The D+1 u32 states stay in registers; D and the variant are
//     template parameters dispatched by a switch.
//   * Output: u32 planes [n_planes, T, n_words], n_words = ceil((W+L)/32);
//     bit j of word w is column 32*w + j.  Plane 0 is "delimiter
//     completed" (bitap) and stays 0 for sgrep; planes 1.. are hit planes,
//     one per endpos bit when endpos has several bits (bitap), else one
//     combined plane.  Bits past column W+L-1 in the last word are 0.
//   * Tile 0 is forced to the init state at column W (its halo is the
//     zero padding before the stream start).
//
// What bounds it on an H100: the kernel reads N*(1 + W/L) bytes and
// writes (1 + n_hit)*N/8 bytes, and does about 20 + 10*D int32 operations
// per byte.  At 3.35 TB/s and ~16.7 T int32 op/s the operations take
// longer than the bytes for every D >= 0, so it is bounded by integer
// throughput, not by HBM.  Known slack left for a later change: the
// threads of a warp read at stride L, so byte loads are uncoalesced
// (staging byte blocks through shared memory, or several lanes per warp
// on one tile, would fix that), and T = N/L threads fill the card only
// for inputs of tens of megabytes.
//
// Built by ops/_cuda.py as ten objects compiled in parallel and linked
// into one shared library with a plain C interface: -DMASK_SCAN_D=0..8
// compiles the kernels of one D each, and the object without it holds
// the C entry points.  Flags: nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 -Xcompiler -fPIC.

#include <cstdint>
#include <cuda_runtime.h>

namespace mask_scan {

constexpr int kSgrep = 0;       // sgrep.c agrep():1183-1186, inverted bits
constexpr int kBitap = 1;       // asearch.c:100-115, uniform costs
constexpr int kBitapCost = 2;   // asearch1.c:90-97, costs (I, S, DD)
constexpr int kThreads = 128;
constexpr int kMaxPlanes = 32;

struct Params {
    const uint8_t* text;
    long long n;
    const uint32_t* table;
    uint32_t* out;
    long long T;
    int W, L, n_words;
    uint32_t init0, init1, noerr, d_endpos, d_mask, hit_mask;
    int ci, cs, cd;
    int n_hit;
    int hit_pos[kMaxPlanes];
};

// Launches the kernel of one D (defined in the object built with
// MASK_SCAN_D=D).
template <int D>
cudaError_t launch_d(const Params& p, int variant, cudaStream_t stream);

}  // namespace mask_scan

#ifdef MASK_SCAN_D

namespace mask_scan {
namespace {

// One level pass of the mask machine: nw = levels(s, cm).
template <int D, int V>
__device__ __forceinline__ void levels(const uint32_t (&s)[D + 1],
                                       uint32_t (&nw)[D + 1], uint32_t cm,
                                       const Params& p) {
    if (V == kSgrep) {
        nw[0] = ((s[0] >> 1) | 0x80000000u) & cm;
#pragma unroll
        for (int k = 1; k <= D; ++k)
            nw[k] = (((s[k] >> 1) | 0x80000000u) & cm) | s[k - 1]
                    | (((nw[k - 1] | s[k - 1]) >> 1) | 0x80000000u);
    } else if (V == kBitap) {
        nw[0] = ((s[0] >> 1) & cm) | (p.init1 & s[0]);
#pragma unroll
        for (int k = 1; k <= D; ++k)
            nw[k] = ((s[k] >> 1) & cm) | (p.init1 & s[k]) | s[k - 1]
                    | (((nw[k - 1] | s[k - 1]) >> 1) & p.noerr);
    } else {
        // level k draws insertions from k-I, substitutions from k-S and
        // deletions from the new level k-DD; the runtime offsets pick a
        // register by predicate, never by a dynamic index
#pragma unroll
        for (int k = 0; k <= D; ++k) {
            uint32_t r = ((s[k] >> 1) & cm) | (p.init1 & s[k]);
            uint32_t err = 0;
#pragma unroll
            for (int j = 0; j <= k; ++j) {
                if (j == k - p.ci) r |= s[j];
                if (j == k - p.cs) err |= s[j];
                if (j < k && j == k - p.cd) err |= nw[j];
            }
            nw[k] = r | ((err >> 1) & p.noerr);
        }
    }
}

// Per-thread machine state and the bits of the current 32-column word.
// Hit planes past the first (multi-bit endpos) accumulate in shared
// memory, one column of acc per thread, so the rare multi-plane scan
// costs no registers in the common single-plane one.
template <int D, int V>
struct Scanner {
    uint32_t s[D + 1];
    uint32_t ini[D + 1];
    uint32_t dword, hword;

    __device__ __forceinline__ void step(uint32_t c, int j, int reset_col,
                                         int b, const uint32_t* tab,
                                         uint32_t (*acc)[kThreads],
                                         const Params& p) {
        if (j == reset_col) {
#pragma unroll
            for (int k = 0; k <= D; ++k) s[k] = ini[k];
        }
        const uint32_t cm = tab[c];
        uint32_t nw[D + 1];
        uint32_t fin;
        if (V == kSgrep) {
            if (D > 0 && c == 0x0Au) {
#pragma unroll
                for (int k = 0; k <= D; ++k) s[k] = ini[k];
            }
            levels<D, V>(s, nw, cm, p);
            fin = nw[D];
#pragma unroll
            for (int k = 0; k <= D; ++k) s[k] = nw[k];
        } else {
            levels<D, V>(s, nw, cm, p);
            fin = nw[D];
            const bool trig = (nw[0] & p.d_endpos) != 0u;
            if (trig) {
                // delimiter completed: restart every level from init0,
                // level 0 gated by d_mask
                uint32_t rs[D + 1];
                levels<D, V>(ini, rs, cm, p);
                rs[0] &= p.d_mask;
#pragma unroll
                for (int k = 0; k <= D; ++k) s[k] = rs[k];
            } else {
#pragma unroll
                for (int k = 0; k <= D; ++k) s[k] = nw[k];
            }
            dword |= (uint32_t)trig << b;
        }
        if (p.n_hit == 1) {
            hword |= (uint32_t)((fin & p.hit_mask) != 0u) << b;
        } else {
            for (int e = 0; e < p.n_hit; ++e)
                acc[e][threadIdx.x] |= ((fin >> p.hit_pos[e]) & 1u) << b;
        }
    }
};

template <int D, int V>
__global__ void __launch_bounds__(kThreads)
mask_scan_kernel(const Params p) {
    __shared__ uint32_t tab[256];
    __shared__ uint32_t acc[kMaxPlanes][kThreads];
    for (int i = threadIdx.x; i < 256; i += blockDim.x) tab[i] = p.table[i];
    __syncthreads();
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= p.T) return;

    Scanner<D, V> sc;
    if (V == kSgrep) {
        uint32_t lvl = 0;
        sc.ini[0] = 0;
#pragma unroll
        for (int k = 1; k <= D; ++k) {
            lvl = (lvl >> 1) | lvl | 0x80000000u;
            sc.ini[k] = lvl;
        }
    } else {
#pragma unroll
        for (int k = 0; k <= D; ++k) sc.ini[k] = p.init0;
    }
#pragma unroll
    for (int k = 0; k <= D; ++k) sc.s[k] = sc.ini[k];

    const uint8_t* __restrict__ text = p.text;
    const unsigned long long n = (unsigned long long)p.n;
    const long long base = t * p.L - p.W;
    const int wl = p.W + p.L;
    const int reset_col = (t == 0) ? p.W : -1;
    const long long plane = p.T * p.n_words;
    uint32_t* out = p.out + t * p.n_words;

    for (int w = 0; w < p.n_words; ++w) {
        const int j0 = w * 32;
        const int nb = min(32, wl - j0);
        sc.dword = 0;
        sc.hword = 0;
        if (p.n_hit > 1)
            for (int e = 0; e < p.n_hit; ++e) acc[e][threadIdx.x] = 0;
#pragma unroll 4
        for (int b = 0; b < nb; ++b) {
            const unsigned long long g = (unsigned long long)(base + j0 + b);
            const uint32_t c = g < n ? __ldg(text + g) : 0u;
            sc.step(c, j0 + b, reset_col, b, tab, acc, p);
        }
        out[w] = sc.dword;
        if (p.n_hit == 1) {
            out[plane + w] = sc.hword;
        } else {
            for (int e = 0; e < p.n_hit; ++e)
                out[(long long)(1 + e) * plane + w] = acc[e][threadIdx.x];
        }
    }
}

}  // namespace

template <int D>
cudaError_t launch_d(const Params& p, int variant, cudaStream_t stream) {
    const long long blocks = (p.T + kThreads - 1) / kThreads;
    const dim3 grid((unsigned)blocks), block(kThreads);
    if (variant == kSgrep)
        mask_scan_kernel<D, kSgrep><<<grid, block, 0, stream>>>(p);
    else if (variant == kBitap)
        mask_scan_kernel<D, kBitap><<<grid, block, 0, stream>>>(p);
    else
        mask_scan_kernel<D, kBitapCost><<<grid, block, 0, stream>>>(p);
    return cudaGetLastError();
}

template cudaError_t launch_d<MASK_SCAN_D>(const Params&, int, cudaStream_t);

}  // namespace mask_scan

#else  // the C entry points

using namespace mask_scan;

extern "C" {

// Launches the mask machine on `stream`; returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for arguments the kernel does not
// take).  All pointers are device pointers except hit_pos (host, n_hit
// entries); out holds (1 + n_hit) * T * ceil((W+L)/32) words.
int mask_scan_launch(const uint8_t* text, long long n,
                     const uint32_t* table, uint32_t* out, long long T,
                     int W, int L, int D, int variant, uint32_t init0,
                     uint32_t init1, uint32_t noerr, uint32_t d_endpos,
                     uint32_t d_mask, uint32_t hit_mask, int ci, int cs,
                     int cd, int n_hit, const int* hit_pos, void* stream) {
    if (n < 1 || T < 1 || W < 0 || L < 1 || T * L < n || n_hit < 1
        || n_hit > kMaxPlanes || (variant == kSgrep && n_hit != 1)
        || variant < kSgrep || variant > kBitapCost
        || (T + kThreads - 1) / kThreads > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    Params p;
    p.text = text;
    p.n = n;
    p.table = table;
    p.out = out;
    p.T = T;
    p.W = W;
    p.L = L;
    p.n_words = (W + L + 31) / 32;
    p.init0 = init0;
    p.init1 = init1;
    p.noerr = noerr;
    p.d_endpos = d_endpos;
    p.d_mask = d_mask;
    p.hit_mask = hit_mask;
    p.ci = ci;
    p.cs = cs;
    p.cd = cd;
    p.n_hit = n_hit;
    for (int e = 0; e < kMaxPlanes; ++e)
        p.hit_pos[e] = e < n_hit ? hit_pos[e] : 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 0: return (int)launch_d<0>(p, variant, s);
        case 1: return (int)launch_d<1>(p, variant, s);
        case 2: return (int)launch_d<2>(p, variant, s);
        case 3: return (int)launch_d<3>(p, variant, s);
        case 4: return (int)launch_d<4>(p, variant, s);
        case 5: return (int)launch_d<5>(p, variant, s);
        case 6: return (int)launch_d<6>(p, variant, s);
        case 7: return (int)launch_d<7>(p, variant, s);
        case 8: return (int)launch_d<8>(p, variant, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* mask_scan_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

#endif  // MASK_SCAN_D
