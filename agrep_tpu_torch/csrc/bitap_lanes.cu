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
// the hit OR (1) and one shared load.  Two kernels, split by a lane's
// length at long_len (ops/scan.py's LANES_LONG, a constant fixed by a
// sweep on the card):
//
// bitap_lanes_kernel, the lanes of at most long_len record bytes:
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
//
// bitap_lane_maps_kernel, the longer lanes, cut into segments of seg
// bytes.  The step is linear over (OR, AND): every term is a state word
// shifted right or ANDed with a constant, and no constant is ORed in.  So
// a segment's exit state from an entry state s is the OR of its exit
// states from the one-bit states e_i over the set bits i of s, and so
// are its hits: a segment is a Boolean map, one column a state bit, and
// maps compose exactly.  A restart from a fixed state (mask_scan's halo)
// is not exact for a sticky machine; carrying the whole map is.  Only the
// relevant (level, bit) nodes need a column: those with a path of the
// step's edges to an endpos bit of level D (ops/scan.py's
// relevant_nodes); every edge into a relevant node comes from a relevant
// node, so the states projected onto them give the same hits.  With n
// such nodes (10 for -p aproximat, 140 for -8 -p abcdefghijkl):
//   * A group of n threads walks one segment, thread i from its node's
//     one-bit state, with the D+1 states and the hits in registers and
//     the walk of bitap_lanes_kernel (all of a group read the same
//     pieces, so each CMask load is a broadcast); floor(32 / n) groups a
//     warp for n <= 16, ceil(n / 32) warps a group above.  Each thread
//     writes its column: the exit state projected onto the nodes (n bits,
//     by a software pext a level) and the hits.
//   * A block's `groups` segments (one chunk of the lane) are composed
//     into one map in shared memory, a tree of Boolean products: column i
//     of B after A is the OR of B's columns j over the bits j of A's
//     column i, and its hits A.h_i | OR_j B.h_j.  The chunk's map goes to
//     device memory.
//   * The last block of a lane to finish (a counter a lane, after a
//     fence) carries the lane's entry vector across its chunks' maps in
//     order: the maps staged in shared memory `groups` at a time by the
//     whole block, one warp stepping the vector (a lane a column, a
//     __reduce_or_sync a word), and writes the lane's hits and verdict.
//   * The grid is one block a chunk; the host builds the chunks' prefix
//     sum on the card from the lengths, and a block finds its lane by a
//     binary search of it.
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
// blocks of the maps kernel hold at most this many threads
constexpr int kMapsThreads = 512;

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
    long long long_len;          // lanes with len > long_len: the maps
                                 // kernel's; bitap_lanes_kernel skips them
    // the maps kernel's
    uint32_t rel[kMaxD + 1];     // the relevant nodes of each level
    int n_nodes, words;          // n and ceil(n / 32)
    int seg, groups;             // bytes a segment, segments a block
    const long long* cum;        // inclusive prefix sum of the chunks a
                                 // lane (0 for a lane of len <= long_len)
    int* done;                   // chunks finished, at a lane's first
    uint32_t* maps;              // a chunk's map: (words + 1) x n words
};

// Defined in the object built with BITAP_D=D.
template <int D>
cudaError_t launch_d(const Params& p, int threads, int grid,
                     cudaStream_t stream);
template <int D>
cudaError_t maps_launch_d(const Params& p, int threads, int grid,
                          int smem, cudaStream_t stream);
template <int D>
cudaError_t geometry_d(int cost, int maps, int threads, int smem,
                       int* blocks_per_sm, int* regs, int* local_bytes);

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

// The cnt bytes at text + start stepped from the states s (left in s),
// each column's state_D ORed into acc.
template <int D, bool C>
__device__ __forceinline__ void walk(
        const Params& p, const uint32_t* s_cm, const CostMasks<D>& cw,
        uintptr_t lo, uintptr_t hi, long long start, long long cnt,
        uint32_t (&s)[D + 1], uint32_t& acc) {
    const uint32_t init1 = p.init1, noerr = p.noerr;
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
}

// hits of the lane of cnt bytes at text + start (its record and its
// delimiter), stepped from the start states.
template <int D, bool C>
__device__ __forceinline__ uint32_t lane_hits(
        const Params& p, const uint32_t* s_cm, const CostMasks<D>& cw,
        uintptr_t lo, uintptr_t hi, long long start, long long cnt) {
    uint32_t s[D + 1];
#pragma unroll
    for (int k = 0; k <= D; ++k) s[k] = start == 0 ? p.first[k] : p.init[k];
    uint32_t acc = 0u;
    walk<D, C>(p, s_cm, cw, lo, hi, start, cnt, s, acc);
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
        if (r < p.R && len <= p.long_len) {
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


// ---------------------------------------------------------------------
// the segment maps of the long lanes
// ---------------------------------------------------------------------

// The bits of x at the set bits of m, packed from bit 0 up.
__device__ __forceinline__ uint32_t pext(uint32_t x, uint32_t m) {
    const uint32_t low = m & (0u - m);
    if (((m + low) & m) == 0u)          // one run of bits (or none)
        return m ? (x & m) >> (__ffs(m) - 1) : 0u;
    uint32_t r = 0u;
    for (uint32_t bit = 1u; m; bit <<= 1) {
        const uint32_t b = m & (0u - m);
        if (x & b) r |= bit;
        m ^= b;
    }
    return r;
}

// The state s projected onto the relevant nodes, as the words of an
// n-bit vector: node j (level by level from 0, bit by bit from 0) is bit
// j & 31 of word j >> 5.
template <int D>
__device__ __forceinline__ void project(const Params& p,
                                        const uint32_t (&s)[D + 1],
                                        uint32_t (&v)[D + 1]) {
    uint32_t x[D + 1];
    int off[D + 1];
    int base = 0;
#pragma unroll
    for (int k = 0; k <= D; ++k) {
        x[k] = pext(s[k], p.rel[k]);
        off[k] = base;
        base += __popc(p.rel[k]);
    }
#pragma unroll
    for (int t = 0; t <= D; ++t) {
        uint32_t w = 0u;
#pragma unroll
        for (int k = 0; k <= D; ++k) {
            const int sh = off[k] - 32 * t;   // a level spans <= 2 words
            if (sh >= 0 && sh < 32) w |= x[k] << sh;
            else if (sh < 0 && sh > -32) w |= x[k] >> -sh;
        }
        v[t] = w;
    }
}

// The one-bit state of node i.
template <int D>
__device__ __forceinline__ void basis(const Params& p, int i,
                                      uint32_t (&s)[D + 1]) {
    int base = 0;
#pragma unroll
    for (int k = 0; k <= D; ++k) {
        const uint32_t m = p.rel[k];
        const int c = __popc(m);
        uint32_t b = 0u;
        if (i >= base && i < base + c) {
            b = m;
            for (int q = i - base; q > 0; --q) b &= b - 1;
            b &= 0u - b;
        }
        s[k] = b;
        base += c;
    }
}

// Map a := b after a (a's segments first), column i: the OR of b's
// columns j over the bits j of a's column i, and the hits a.h_i | OR_j
// b.h_j.  A map is (words + 1) rows of n words: row w < words holds word
// w of each column's exit vector, row `words` its hits.  Only the thread
// of column i touches a's column i.
template <int D>
__device__ __forceinline__ void compose_col(uint32_t* a, const uint32_t* b,
                                            int i, int n, int words) {
    uint32_t acc[D + 1];
#pragma unroll
    for (int w = 0; w <= D; ++w) acc[w] = 0u;
    uint32_t h = a[words * n + i];
#pragma unroll
    for (int t = 0; t <= D; ++t) {
        if (t >= words) break;
        uint32_t bits = a[t * n + i];
        while (bits) {
            const int j = 32 * t + __ffs(bits) - 1;
            bits &= bits - 1;
#pragma unroll
            for (int w = 0; w <= D; ++w)
                if (w < words) acc[w] |= b[w * n + j];
            h |= b[words * n + j];
        }
    }
#pragma unroll
    for (int w = 0; w <= D; ++w)
        if (w < words) a[w * n + i] = acc[w];
    a[words * n + i] = h;
}

// One warp steps the vector v (every lane holds it) through the map m:
// lane l ORs the columns l, l + 32, ... whose bit is set in v, and the
// warp's ORs give the new vector; its hits are ORed into h.
template <int D>
__device__ __forceinline__ void apply_map(const uint32_t* m, int n,
                                          int words, int lane,
                                          uint32_t (&v)[D + 1],
                                          uint32_t& h) {
    uint32_t acc[D + 1];
    uint32_t hh = 0u;
#pragma unroll
    for (int t = 0; t <= D; ++t) {
        acc[t] = 0u;
    }
#pragma unroll
    for (int t = 0; t <= D; ++t) {
        if (t >= words) break;
        const int j = 32 * t + lane;
        if (j < n && ((v[t] >> lane) & 1u)) {
#pragma unroll
            for (int w = 0; w <= D; ++w)
                if (w < words) acc[w] |= m[w * n + j];
            hh |= m[words * n + j];
        }
    }
#pragma unroll
    for (int w = 0; w <= D; ++w)
        if (w < words) v[w] = __reduce_or_sync(0xffffffffu, acc[w]);
    h |= __reduce_or_sync(0xffffffffu, hh);
}

template <int D, bool C>
__global__ void __launch_bounds__(kMapsThreads)
bitap_lane_maps_kernel(const Params p) {
    __shared__ uint32_t s_cm[256];
    __shared__ long long s_lane[3];     // lane, its first chunk, chunks
    __shared__ int s_last;
    extern __shared__ uint32_t slots[];  // groups maps
    const int n = p.n_nodes, words = p.words;
    const int msize = (words + 1) * n;
    const long long b = blockIdx.x;
    if (threadIdx.x == 0) {
        // the lane of chunk b: the least r with cum[r] > b
        long long a = 0, z = p.R - 1;
        while (a < z) {
            const long long mid = (a + z) >> 1;
            if (p.cum[mid] > b) z = mid;
            else a = mid + 1;
        }
        const long long c0 = a ? p.cum[a - 1] : 0;
        s_lane[0] = a;
        s_lane[1] = c0;
        s_lane[2] = p.cum[a] - c0;
    }
    for (int i = threadIdx.x; i < 256; i += blockDim.x) s_cm[i] = p.mask[i];
    __syncthreads();
    const long long r = s_lane[0], c0 = s_lane[1], nch = s_lane[2];
    const long long start = p.starts[r], cnt = p.lens[r] + 1;

    // this thread's group (segment) and node
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int g, i;
    bool active;
    if (n <= 16) {
        const int per = 32 / n, gi = lane / n;
        g = warp * per + gi;
        i = lane - gi * n;
        active = gi < per;
    } else {
        const int wpg = (n + 31) >> 5;
        g = warp / wpg;
        i = (warp % wpg) * 32 + lane;
        active = i < n;
    }
    active = active && g < p.groups;
    if (active) {
        uint32_t* col = slots + g * msize;
        const long long at = ((b - c0) * p.groups + g) * (long long)p.seg;
        const long long len = min((long long)p.seg, cnt - at);
        if (len > 0) {
            CostMasks<D> cw;
            if (C) cw.set(p);
            const uintptr_t lo = reinterpret_cast<uintptr_t>(p.text);
            uint32_t s[D + 1], v[D + 1];
            uint32_t acc = 0u;
            basis<D>(p, i, s);
            walk<D, C>(p, s_cm, cw, lo, lo + (uintptr_t)p.n, start + at, len,
                       s, acc);
            project<D>(p, s, v);
#pragma unroll
            for (int w = 0; w <= D; ++w)
                if (w < words) col[w * n + i] = v[w];
            col[words * n + i] = acc & p.endpos;
        } else {                         // past the lane: the identity
#pragma unroll
            for (int w = 0; w <= D; ++w)
                if (w < words)
                    col[w * n + i] = (i >> 5) == w ? 1u << (i & 31) : 0u;
            col[words * n + i] = 0u;
        }
    }
    __syncthreads();
    // the chunk's map: the groups' maps composed in order, a tree
    for (int h = 1; h < p.groups; h <<= 1) {
        const int pairs = (p.groups - h + 2 * h - 1) / (2 * h);
        for (int it = threadIdx.x; it < pairs * n; it += blockDim.x) {
            const int q = it / n, a = 2 * h * q;
            compose_col<D>(slots + a * msize, slots + (a + h) * msize,
                           it - q * n, n, words);
        }
        __syncthreads();
    }
    uint32_t* out = p.maps + (size_t)b * msize;
    for (int x = threadIdx.x; x < msize; x += blockDim.x) out[x] = slots[x];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(p.done + c0, 1) == nch - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();

    // the last block of the lane: its entry vector through its chunks'
    // maps in order, staged `groups` maps at a time
    uint32_t v[D + 1], h = 0u;
    if (warp == 0) {
        uint32_t e[D + 1];
#pragma unroll
        for (int k = 0; k <= D; ++k)
            e[k] = start == 0 ? p.first[k] : p.init[k];
        project<D>(p, e, v);
    }
    for (long long base = 0; base < nch; base += p.groups) {
        const int k = (int)min((long long)p.groups, nch - base);
        const uint32_t* src = p.maps + (size_t)(c0 + base) * msize;
        __syncthreads();
        for (int x = threadIdx.x; x < k * msize; x += blockDim.x)
            slots[x] = __ldcg(src + x);
        __syncthreads();
        if (warp == 0)
            for (int q = 0; q < k; ++q)
                apply_map<D>(slots + q * msize, n, words, lane, v, h);
    }
    if (threadIdx.x == 0) {
        const bool fire = p.and_flag ? (h == p.endpos) || p.invert
                                     : (h != 0u) != (p.invert != 0);
        p.hits[r] = h;
        p.verdicts[r] = (uint8_t)fire;
    }
}

template <int D>
const void* kernel_for(int cost, int maps) {
    if (maps)
        return cost ? reinterpret_cast<const void*>(
                          bitap_lane_maps_kernel<D, true>)
                    : reinterpret_cast<const void*>(
                          bitap_lane_maps_kernel<D, false>);
    if (cost)
        return reinterpret_cast<const void*>(bitap_lanes_kernel<D, true>);
    return reinterpret_cast<const void*>(bitap_lanes_kernel<D, false>);
}

}  // namespace

template <int D>
cudaError_t geometry_d(int cost, int maps, int threads, int smem,
                       int* blocks_per_sm, int* regs, int* local_bytes) {
    const void* k = kernel_for<D>(cost, maps);
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, k);
    if (err != cudaSuccess) return err;
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k,
                                                         threads, smem);
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

template <int D>
cudaError_t maps_launch_d(const Params& p, int threads, int grid, int smem,
                          cudaStream_t stream) {
    if (p.ci > 0)
        bitap_lane_maps_kernel<D, true><<<grid, threads, smem, stream>>>(p);
    else
        bitap_lane_maps_kernel<D, false><<<grid, threads, smem, stream>>>(p);
    return cudaGetLastError();
}

template cudaError_t launch_d<BITAP_D>(const Params&, int, int,
                                       cudaStream_t);
template cudaError_t maps_launch_d<BITAP_D>(const Params&, int, int, int,
                                            cudaStream_t);
template cudaError_t geometry_d<BITAP_D>(int, int, int, int, int*, int*,
                                         int*);

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

// The fields both kernels read.
Params lanes_params(const uint8_t* text, long long n, const long long* starts,
                    const long long* lens, long long R, const uint32_t* mask,
                    uint32_t init1, uint32_t noerr, uint32_t endpos, int D,
                    int ci, int cs, int cd, const uint32_t* init,
                    const uint32_t* first, int and_flag, int invert,
                    uint8_t* verdicts, uint32_t* hits, long long long_len) {
    Params p = {};
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
    p.long_len = long_len;
    return p;
}

// The maps kernel's block: `groups` segments of n threads each (32 / n
// groups a warp for n <= 16, ceil(n / 32) warps a group above), its
// shared bytes the groups' maps.
bool maps_shape_ok(int D, int n, int groups, int threads, int smem) {
    if (n < 1 || n > 32 * (D + 1) || groups < 1 || threads > kMapsThreads)
        return false;
    const int words = (n + 31) / 32;
    const int want = n <= 16 ? 32 * ((groups + 32 / n - 1) / (32 / n))
                             : 32 * words * groups;
    return threads == want && smem == 4 * groups * (words + 1) * n;
}

}  // namespace

extern "C" {

// Geometry of a launch of the kernel of D and wiring (cost 0 uniform, 1
// costs), bitap_lanes_kernel (maps 0) or bitap_lane_maps_kernel (maps
// 1), with `threads` a block and `smem` dynamic shared bytes: how many
// such blocks one SM of the current device holds, and the kernel's
// registers a thread and local (spill) bytes.  Returns a cudaError_t
// (cudaErrorInvalidValue for arguments the kernel does not take).
int bitap_lanes_geometry(int D, int cost, int maps, int threads, int smem,
                         int* blocks_per_sm, int* regs, int* local_bytes) {
    if (!shape_ok(D, threads) || (maps && threads > kMapsThreads))
        return (int)cudaErrorInvalidValue;
    switch (D) {
#define CASE(DV) \
        case DV: return (int)geometry_d<DV>(cost, maps, threads, smem, \
                                            blocks_per_sm, regs, local_bytes);
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
// verdicts holds R bytes (0 or 1), hits R words.  A lane with lens[r] >
// long_len is left to bitap_lane_maps_launch: neither output is written.
int bitap_lanes_launch(const uint8_t* text, long long n,
                       const long long* starts, const long long* lens,
                       long long R, const uint32_t* mask, uint32_t init1,
                       uint32_t noerr, uint32_t endpos, int D, int ci, int cs,
                       int cd, const uint32_t* init, const uint32_t* first,
                       int and_flag, int invert, uint8_t* verdicts,
                       uint32_t* hits, long long long_len, int threads,
                       int grid, void* stream) {
    if (n < 1 || R < 1 || grid < 1 || !shape_ok(D, threads)
        || !costs_ok(D, ci, cs, cd))
        return (int)cudaErrorInvalidValue;
    const long long need = (R + threads - 1) / threads;
    if (grid > need) grid = (int)need;
    const Params p = lanes_params(text, n, starts, lens, R, mask, init1,
                                  noerr, endpos, D, ci, cs, cd, init, first,
                                  and_flag, invert, verdicts, hits, long_len);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
#define CASE(DV) case DV: return (int)launch_d<DV>(p, threads, grid, s);
        CASE(0) CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7)
        CASE(8)
#undef CASE
        default: return (int)cudaErrorInvalidValue;
    }
}

// Launches the maps kernel on `stream`: the lanes with lens[r] >
// long_len, one block a chunk of groups x seg lane bytes (grid = the
// chunks, cum[R - 1]), `threads` a block and `smem` dynamic shared bytes
// (maps_shape_ok).  rel (host, D+1 words) holds the relevant nodes, n of
// them; cum (device, R int64) the inclusive prefix sum of the chunks a
// lane (lens[r] / (groups x seg) + 1 for a long lane, else 0); done
// (device, grid int32) zeros; maps (device) grid x (ceil(n / 32) + 1) x
// n words of scratch.  The other arguments are bitap_lanes_launch's, and
// the lanes' hits and verdicts the same.  Returns cudaGetLastError()
// after the launch.
int bitap_lane_maps_launch(const uint8_t* text, long long n,
                           const long long* starts, const long long* lens,
                           long long R, const uint32_t* mask, uint32_t init1,
                           uint32_t noerr, uint32_t endpos, int D, int ci,
                           int cs, int cd, const uint32_t* init,
                           const uint32_t* first, int and_flag, int invert,
                           uint8_t* verdicts, uint32_t* hits,
                           long long long_len, const uint32_t* rel,
                           int n_nodes, int seg, int groups,
                           const long long* cum, int* done, uint32_t* maps,
                           int threads, int grid, int smem, void* stream) {
    if (n < 1 || R < 1 || grid < 1 || seg < 1 || long_len < 0
        || !shape_ok(D, threads) || !costs_ok(D, ci, cs, cd)
        || !maps_shape_ok(D, n_nodes, groups, threads, smem))
        return (int)cudaErrorInvalidValue;
    Params p = lanes_params(text, n, starts, lens, R, mask, init1, noerr,
                            endpos, D, ci, cs, cd, init, first, and_flag,
                            invert, verdicts, hits, long_len);
    int count = 0;
    for (int k = 0; k <= kMaxD; ++k) {
        p.rel[k] = k <= D ? rel[k] : 0u;
        count += __builtin_popcount(p.rel[k]);
    }
    if (count != n_nodes) return (int)cudaErrorInvalidValue;
    p.n_nodes = n_nodes;
    p.words = (n_nodes + 31) / 32;
    p.seg = seg;
    p.groups = groups;
    p.cum = cum;
    p.done = done;
    p.maps = maps;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
#define CASE(DV) \
        case DV: return (int)maps_launch_d<DV>(p, threads, grid, smem, s);
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
