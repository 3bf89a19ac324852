// Windowed shift-or mask machine for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel agrep_tpu/ops/kernels.py::_get_pallas_scan
// (the `run` it returns, pl.pallas_call at kernels.py:386).  It computes
// the same function; none of the TPU layout carries over.
//
// The function.  Tile t = 0..T-1 holds L body bytes preceded by a W-byte
// halo of the real preceding bytes: window column j of tile t is
// text[t*L - W + j] for j in [0, W+L), 0 outside [0, N).  Each tile is
// scanned from a cold state (the halo-warmup argument of ops/scan.py);
// tile 0 is forced to the init state at column W (its halo is the zero
// padding before the stream start).  Output: u32 planes
// [n_planes, T, n_words], n_words = ceil((W+L)/32); bit j of word w is
// column 32*w + j.  Plane 0 is "delimiter completed" (bitap) and stays 0
// for sgrep; planes 1.. are hit planes, one per endpos bit when endpos
// has several bits (bitap), else one combined plane.  Bits past column
// W+L-1 in the last word are 0.
//
// What bounds it on an H100: it must read N bytes and write
// (1 + n_hit) * T * n_words words, and do about 14 + 10*D (bitap) or
// 8 + 8*D (sgrep) int32 operations on each of the T*(W+L) window
// columns.  At 3.35 TB/s and ~16.7 T int32 op/s the operations take
// longer than the bytes for every D, so it is bounded by integer
// throughput.  What the design does about it:
//
//   * Sub-tile threads.  One thread per tile leaves most of the card idle
//     (a 32 MB chunk is 32,768 tiles, 8 warps an SM) with nothing to hide
//     the latency of each column's table lookup.  So each tile's n_words
//     output words are split over s threads (plan_word below; the same
//     formula as kernels.subtile_plan in Python).  Sub-tile 0 emits words
//     [0, w_1) from a cold start at column 0, as the whole-tile scan does
//     (32*w_1 >= W, so it covers the halo).  Sub-tile i > 0 emits words
//     [w_i, w_{i+1}) and starts cold at column 32*w_i - W: after W warm-up
//     columns of real bytes its state is the whole-tile scan's, which is
//     the same halo-warmup argument the tiles rest on.  It holds only for
//     machines whose dependence window is bounded (sgrep, or bitap with
//     init1_ns == init0); the launcher refuses s > 1 for any other.  Every
//     thread of tile 0 applies the stream-start reset at column W.
//   * Coalesced staging.  A block takes tpb consecutive tiles and first
//     copies their bytes into shared memory with 16-byte loads,
//     neighbouring threads on neighbouring addresses, from a 16-byte
//     aligned floor; bytes outside [0, N) are staged as 0.  Each thread
//     then reads its columns four bytes at a time (one shared load and a
//     funnel shift per four columns) instead of one byte-wide global load
//     per column at stride L across the warp.
//   * No bank conflicts on the staged bytes.  Thread x of a block takes
//     tile x % tpb and sub-tile x / tpb, so the 32 lanes of a warp are 32
//     tiles at the same column, L bytes apart.  Staged word q lives at
//     q + (q >> row_shift), with rows of L/4 words: one word of skew per
//     tile puts those 32 lanes on 32 banks.  The staging stores rotate the
//     four words of each 16-byte chunk so that they are conflict-free too.
//   * The 256-entry u32 mask table lives in shared memory (1 KB); the D+1
//     states stay in registers; D and the variant are template parameters
//     dispatched by a switch.  The hit word of plane 1 is a register;
//     further hit planes (multi-bit endpos) accumulate in dynamic shared
//     memory, taken only by launches with n_hit > 1.
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
constexpr int kMaxThreads = 256;
constexpr int kMaxPlanes = 32;
constexpr int kMaxSplit = 32;
// an H100 block takes 227 KB of shared memory; 1 KB is the static table
constexpr long long kMaxDynamicShared = 232448 - 1024;

struct Params {
    const uint8_t* text;
    long long n;
    const uint32_t* table;
    uint32_t* out;
    long long T;
    int W, L, n_words;
    int s, tpb;          // sub-tiles a tile, tiles a block
    int row_shift;       // staged word q sits at q + (q >> row_shift)
    uint32_t init0, init1, noerr, d_endpos, d_mask, hit_mask;
    int ci, cs, cd;
    int n_hit;
    int hit_pos[kMaxPlanes];
};

// First output word of sub-tile i of s (i = s gives n_words): sub-tile 0
// takes about h = ceil(W/32) words more than the others, since they
// spend W columns warming up.  Python: kernels.subtile_plan.
__host__ __device__ inline int plan_word(int i, int s, int n_words, int W) {
    if (i <= 0) return 0;
    const long long h = (W + 31) / 32;
    const long long X = n_words + (s - 1) * h;
    return (int)(i * X / s - (i - 1) * h);
}

// Staged word q's place in shared memory.
__device__ __forceinline__ int phys(int q, int row_shift) {
    return q + (q >> row_shift);
}

// Bytes of dynamic shared memory one block takes: the staged bytes of
// tpb tiles (up to 15 bytes of alignment before them, 8 after for the
// last four-byte read) with their skew, and the hit planes past the
// first.  Python: kernels.shared_bytes.
inline long long smem_bytes(int W, int L, int s, int tpb, int n_hit,
                            int row_shift) {
    const long long bytes =
        (15 + (long long)(tpb - 1) * L + W + L + 8 + 15) / 16 * 16;
    const long long q = bytes / 4;
    const long long planes = n_hit > 1 ? (long long)(n_hit - 1) * s * tpb : 0;
    return 4 * (q + (q >> row_shift) + 1 + planes);
}

inline int row_shift_for(int L) {
    int rs = 5;
    while (rs < 30 && (1 << (rs + 1)) <= L / 4) ++rs;
    return rs;
}

// Launches the kernel of one D (defined in the object built with
// MASK_SCAN_D=D).
template <int D>
cudaError_t launch_d(const Params& p, int variant, long long smem,
                     cudaStream_t stream);

}  // namespace mask_scan

#ifdef MASK_SCAN_D

namespace mask_scan {
namespace {

// The cost wiring's edges as masks, one per level distance d = 0..D:
// all ones where level k draws from level k - d (insertions ci,
// substitutions cs, deletions cd), else 0.  Set once a thread, so that a
// column spends one logic op on each edge and no compare.
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

// One level pass of the mask machine: nw = levels(s, cm).
template <int D, int V>
__device__ __forceinline__ void levels(const uint32_t (&s)[D + 1],
                                       uint32_t (&nw)[D + 1], uint32_t cm,
                                       const Params& p,
                                       const CostMasks<D>& cw) {
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
        // deletions from the new level k-DD, each picked by its mask
#pragma unroll
        for (int k = 0; k <= D; ++k) {
            uint32_t r = ((s[k] >> 1) & cm) | (p.init1 & s[k]);
            uint32_t err = 0;
#pragma unroll
            for (int j = 0; j <= k; ++j) {
                r |= s[j] & cw.ins[k - j];
                err |= s[j] & cw.sub[k - j];
                if (j < k) err |= nw[j] & cw.del[k - j];
            }
            nw[k] = r | ((err >> 1) & p.noerr);
        }
    }
}

// Per-thread machine state and the bits of the current 32-column word:
// dword (plane 0), hword (plane 1) and, when M, planes 2.. in shared
// memory (acc[(e - 1) * stride] for plane 1 + e).  Each column's bit
// enters at the top of its word and moves down one place a column, so
// after 32 columns bit j is column j; a word of nb < 32 columns is
// shifted down by 32 - nb at its end.
template <int D, int V, bool M>
struct Scanner {
    uint32_t st[D + 1];
    uint32_t ini[D + 1];
    uint32_t dword, hword;
    CostMasks<D> cw;

    __device__ __forceinline__ void reset() {
#pragma unroll
        for (int k = 0; k <= D; ++k) st[k] = ini[k];
    }

    __device__ __forceinline__ void step(uint32_t c, const uint32_t* tab,
                                         uint32_t* acc,
                                         int stride, const Params& p) {
        const uint32_t cm = tab[c];
        uint32_t nw[D + 1];
        uint32_t fin;
        if (V == kSgrep) {
            if (D > 0 && c == 0x0Au) reset();
            levels<D, V>(st, nw, cm, p, cw);
            fin = nw[D];
#pragma unroll
            for (int k = 0; k <= D; ++k) st[k] = nw[k];
        } else {
            levels<D, V>(st, nw, cm, p, cw);
            fin = nw[D];
            const bool trig = (nw[0] & p.d_endpos) != 0u;
            if (trig) {
                // delimiter completed: restart every level from init0,
                // level 0 gated by d_mask
                uint32_t rs[D + 1];
                levels<D, V>(ini, rs, cm, p, cw);
                rs[0] &= p.d_mask;
#pragma unroll
                for (int k = 0; k <= D; ++k) st[k] = rs[k];
            } else {
#pragma unroll
                for (int k = 0; k <= D; ++k) st[k] = nw[k];
            }
            dword = __funnelshift_r(dword, (uint32_t)trig, 1);
        }
        if (!M) {
            const uint32_t hit = (fin & p.hit_mask) != 0u;
            hword = __funnelshift_r(hword, hit, 1);
        } else {
            hword = __funnelshift_r(hword, fin >> p.hit_pos[0], 1);
            for (int e = 1; e < p.n_hit; ++e) {
                uint32_t& a = acc[(e - 1) * stride];
                a = __funnelshift_r(a, fin >> p.hit_pos[e], 1);
            }
        }
    }
};

// Byte b (0..3) of a word, zero-extended.
__device__ __forceinline__ uint32_t byte_of(uint32_t w, int b) {
    return __byte_perm(w, 0u, 0x4440u | (uint32_t)b);
}

// The four staged bytes from byte k on.
__device__ __forceinline__ uint32_t read4(const uint32_t* stage, int k,
                                          int row_shift) {
    const int q = k >> 2;
    return __funnelshift_r(stage[phys(q, row_shift)],
                           stage[phys(q + 1, row_shift)], (k & 3) * 8);
}

// Columns [c0, c1) of this thread's tile (staged from byte kbase on),
// with the tile-0 reset checked at every column.
template <int D, int V, bool M>
__device__ __forceinline__ void scan_cols(Scanner<D, V, M>& sc,
                                          const uint32_t* stage, int kbase,
                                          int c0, int c1, int reset_col,
                                          const uint32_t* tab, uint32_t* acc,
                                          int stride, const Params& p) {
    for (int c = c0; c < c1; c += 4) {
        const uint32_t four = read4(stage, kbase + c, p.row_shift);
        const int nb = min(4, c1 - c);
        for (int b = 0; b < nb; ++b) {
            if (c + b == reset_col) sc.reset();
            sc.step(byte_of(four, b), tab, acc, stride, p);
        }
    }
}

template <int D, int V, bool M>
__global__ void __launch_bounds__(kMaxThreads)
mask_scan_kernel(const Params p) {
    __shared__ uint32_t tab[256];
    extern __shared__ uint32_t dyn[];
    const int nthreads = blockDim.x;
    uint32_t* const stage = dyn + (M ? (p.n_hit - 1) * nthreads : 0);
    for (int i = threadIdx.x; i < 256; i += nthreads) tab[i] = p.table[i];

    // stage the block's bytes: text index `first` is column 0 of tile t0;
    // staged byte 0 is text index g0 = first - pre, 16-byte aligned in the
    // address space
    const long long t0 = (long long)blockIdx.x * p.tpb;
    const int tiles = (int)min((long long)p.tpb, p.T - t0);
    const long long first = t0 * p.L - p.W;
    const int pre = (int)((reinterpret_cast<uintptr_t>(p.text)
                           + (uintptr_t)first) & 15u);
    const long long g0 = first - pre;
    const int n_chunks = (pre + (tiles - 1) * p.L + p.W + p.L + 8 + 15) >> 4;
    for (int c = threadIdx.x; c < n_chunks; c += nthreads) {
        const long long g = g0 + 16LL * c;
        uint32_t v0, v1, v2, v3;
        if (g >= 0 && g + 16 <= p.n) {
            const uint4 x = __ldg(reinterpret_cast<const uint4*>(p.text + g));
            v0 = x.x; v1 = x.y; v2 = x.z; v3 = x.w;
        } else {
            uint32_t v[4];
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                uint32_t w = 0;
#pragma unroll
                for (int b = 0; b < 4; ++b) {
                    const long long gi = g + 4 * m + b;
                    if (gi >= 0 && gi < p.n)
                        w |= (uint32_t)p.text[gi] << (8 * b);
                }
                v[m] = w;
            }
            v0 = v[0]; v1 = v[1]; v2 = v[2]; v3 = v[3];
        }
        const int rot = (c >> 3) & 3;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            const int mm = (m + rot) & 3;
            const uint32_t val =
                mm == 0 ? v0 : mm == 1 ? v1 : mm == 2 ? v2 : v3;
            stage[phys(4 * c + mm, p.row_shift)] = val;
        }
    }
    __syncthreads();

    const int tl = threadIdx.x % p.tpb;
    const int sub = threadIdx.x / p.tpb;
    if (tl >= tiles) return;
    const long long t = t0 + tl;
    const int w_lo = plan_word(sub, p.s, p.n_words, p.W);
    const int w_hi = plan_word(sub + 1, p.s, p.n_words, p.W);
    const int start = sub == 0 ? 0 : 32 * w_lo - p.W;
    const int kbase = pre + tl * p.L;
    const int S = p.W + p.L;
    const int reset_col = (t == 0) ? p.W : -1;
    uint32_t* const acc = dyn + threadIdx.x;

    Scanner<D, V, M> sc;
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
    sc.reset();
    if (V == kBitapCost) sc.cw.set(p);
    sc.dword = 0;
    sc.hword = 0;

    // warm-up: columns before the first word this thread emits
    scan_cols(sc, stage, kbase, start, 32 * w_lo, reset_col, tab, acc,
              nthreads, p);

    const long long plane = p.T * p.n_words;
    uint32_t* const row = p.out + t * p.n_words;
    for (int w = w_lo; w < w_hi; ++w) {
        const int j0 = 32 * w;
        sc.dword = 0;
        sc.hword = 0;
        if (M)
            for (int e = 1; e < p.n_hit; ++e) acc[(e - 1) * nthreads] = 0;
        const int nb = min(32, S - j0);
        if (nb == 32 && (reset_col >> 5) != w) {
            // a whole word without the reset: nine shared loads
            const int k0 = kbase + j0;
            const int q = k0 >> 2;
            const int sh = (k0 & 3) * 8;
            uint32_t lo = stage[phys(q, p.row_shift)];
            // not unrolled in full: with all 32 columns unrolled, the
            // uniform-cost kernels of D >= 1 wrote wrong delimiter bits on
            // the card at every ptxas level, while the same source run
            // column by column on the CPU, and this form, are exact
#pragma unroll 2
            for (int g = 0; g < 8; ++g) {
                const uint32_t hi = stage[phys(q + g + 1, p.row_shift)];
                const uint32_t four = __funnelshift_r(lo, hi, sh);
                lo = hi;
#pragma unroll
                for (int b = 0; b < 4; ++b)
                    sc.step(byte_of(four, b), tab, acc, nthreads, p);
            }
        } else {
            scan_cols(sc, stage, kbase, j0, j0 + nb, reset_col, tab, acc,
                      nthreads, p);
            if (nb < 32) {
                sc.dword >>= 32 - nb;
                sc.hword >>= 32 - nb;
                if (M)
                    for (int e = 1; e < p.n_hit; ++e)
                        acc[(e - 1) * nthreads] >>= 32 - nb;
            }
        }
        row[w] = sc.dword;
        row[plane + w] = sc.hword;
        if (M)
            for (int e = 1; e < p.n_hit; ++e)
                row[(long long)(1 + e) * plane + w] = acc[(e - 1) * nthreads];
    }
}

template <int D, int V, bool M>
cudaError_t launch_one(const Params& p, long long smem, cudaStream_t stream) {
    const void* k = reinterpret_cast<const void*>(&mask_scan_kernel<D, V, M>);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    const dim3 grid((unsigned)((p.T + p.tpb - 1) / p.tpb));
    const dim3 block((unsigned)(p.s * p.tpb));
    Params q = p;
    void* args[] = {&q};
    const cudaError_t e = cudaLaunchKernel(k, grid, block, args,
                                           (size_t)smem, stream);
    return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

template <int D>
cudaError_t launch_d(const Params& p, int variant, long long smem,
                     cudaStream_t stream) {
    const bool multi = p.n_hit > 1;
    if (variant == kSgrep)
        return launch_one<D, kSgrep, false>(p, smem, stream);
    if (variant == kBitap)
        return multi ? launch_one<D, kBitap, true>(p, smem, stream)
                     : launch_one<D, kBitap, false>(p, smem, stream);
    return multi ? launch_one<D, kBitapCost, true>(p, smem, stream)
                 : launch_one<D, kBitapCost, false>(p, smem, stream);
}

template cudaError_t launch_d<MASK_SCAN_D>(const Params&, int, long long,
                                           cudaStream_t);

}  // namespace mask_scan

#else  // the C entry points

using namespace mask_scan;

namespace {

// True when sub-tile split s is a valid plan: every sub-tile emits a
// word, and sub-tile 0 covers the halo.
bool plan_ok(int W, int n_words, int s) {
    if (s < 1 || s > kMaxSplit) return false;
    for (int i = 0; i < s; ++i)
        if (plan_word(i + 1, s, n_words, W) <= plan_word(i, s, n_words, W))
            return false;
    return s == 1 || 32 * plan_word(1, s, n_words, W) >= W;
}

}  // namespace

extern "C" {

// Launches the mask machine on `stream` with s sub-tiles a tile and tpb
// tiles a block; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take: s > 1
// for an unbounded machine, a split without a plan, more than
// kMaxThreads threads or kMaxDynamicShared bytes a block).  All pointers
// are device pointers except hit_pos (host, n_hit entries); out holds
// (1 + n_hit) * T * ceil((W+L)/32) words.
int mask_scan_launch(const uint8_t* text, long long n,
                     const uint32_t* table, uint32_t* out, long long T,
                     int W, int L, int D, int variant, uint32_t init0,
                     uint32_t init1, uint32_t noerr, uint32_t d_endpos,
                     uint32_t d_mask, uint32_t hit_mask, int ci, int cs,
                     int cd, int n_hit, const int* hit_pos, int s, int tpb,
                     void* stream) {
    const bool bounded = variant == kSgrep || init1 == init0;
    if (n < 1 || T < 1 || W < 0 || L < 1 || W > L || T * L < n
        || n_hit < 1 || n_hit > kMaxPlanes
        || (variant == kSgrep && n_hit != 1)
        || variant < kSgrep || variant > kBitapCost
        || (s > 1 && !bounded) || tpb < 1
        || (long long)s * tpb > kMaxThreads
        || !plan_ok(W, (W + L + 31) / 32, s)
        || (T + tpb - 1) / tpb > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    const long long smem = smem_bytes(W, L, s, tpb, n_hit, row_shift_for(L));
    if (smem > kMaxDynamicShared) return (int)cudaErrorInvalidValue;
    Params p;
    p.text = text;
    p.n = n;
    p.table = table;
    p.out = out;
    p.T = T;
    p.W = W;
    p.L = L;
    p.n_words = (W + L + 31) / 32;
    p.s = s;
    p.tpb = tpb;
    p.row_shift = row_shift_for(L);
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
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 0: return (int)launch_d<0>(p, variant, smem, st);
        case 1: return (int)launch_d<1>(p, variant, smem, st);
        case 2: return (int)launch_d<2>(p, variant, smem, st);
        case 3: return (int)launch_d<3>(p, variant, smem, st);
        case 4: return (int)launch_d<4>(p, variant, smem, st);
        case 5: return (int)launch_d<5>(p, variant, smem, st);
        case 6: return (int)launch_d<6>(p, variant, smem, st);
        case 7: return (int)launch_d<7>(p, variant, smem, st);
        case 8: return (int)launch_d<8>(p, variant, smem, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* mask_scan_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

#endif  // MASK_SCAN_D
