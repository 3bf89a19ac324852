// The streamed boolean's lines that fire, for NVIDIA Hopper (sm_90a).
//
// Replaces the streamed boolean's host work a chunk (agrep_tpu/runtime/
// mgrep.py: one host find a term, :336, and the fold of the occurrences
// into each line's terminal mask and the tree's verdict, :363-379): here
// the chunk's starts come from chain_scan's start plane (within the chain
// caps) or qgram_filter's candidate plane (past them), and the
// verification, the fold and the verdict stay on the card, so that only
// the count, or the rows of the lines that fire, come back.
//
// The function.  Input: the region, u8 [N] (a chunk's body bytes
// [0, body) and its halo); a u32 candidate plane over the region (bit b of
// word w is position 32 w + b) and its shift (a set bit at position a is a
// candidate start s = a - shift); at most 16 terms, folded, as bytes and
// int32 offsets (an empty term is dead); the fold tr; the truth table
// (bit m of the u32 words is the tree's verdict for terminal mask m, 0 at
// m = 0); the mask carried in from the previous chunk's unterminated
// line; base (the region's stream offset), begin (the stream position of
// the region's first line), cap_e (the end of an unterminated final
// line); a last-chunk flag.  Term t is present at s when 0 <= s < body,
// s + len_t <= N and tr[text[s + k]] == term_t[k] for every k.  A start
// belongs to the line of the first newline at or after it in the body.
// Line j (the body's j-th newline at q_j) has as mask the OR of its
// starts' terms (the carried mask too, for j = 0) and fires when its
// truth-table bit is set.  The body's tail after its last newline is, in
// a last chunk, a line that ends at cap_e; otherwise its mask is carried
// out.  Output: the count R of lines that fire, the carried-out mask, the
// stream position of the body's last newline (-1 for none) and, for a
// print, one row (begin, end) a line that fires, in stream order: begin
// = base + q_{j-1} + 1 (begin for j = 0), end = base + q_j + 1 (cap_e for
// the tail line).
//
// What bounds it on an H100: bytes.  It must read the region (1 byte a
// position) and the plane (1 bit a position) once, and write 16 bytes a
// row: at a 32 MB chunk about 36 MB, 0.011 ms at 3.35 TB/s.  The
// verification of a start reads its term's bytes again, but the starts
// are few (on the main path's corpus 1-4 % of the positions).
//
// The design: one pass over the body in tiles of kTile bytes, with a
// decoupled look-back (Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", NVIDIA 2016) in place of grid barriers.
// A tile's aggregate -- the OR of the starts up to its first newline (its
// head), whether it holds a newline, the OR after its last one (its tail),
// the last one's position, and the count of the lines wholly inside it
// that fire -- combines associatively with its neighbours' (the verdict of
// the line between two aggregates is taken where they meet), and a
// prefix (the mask of the open line, the last newline, the rows before)
// takes an aggregate to the next prefix.
//
//   * Tiles: an ordinary grid of persistent blocks takes tiles by an
//     atomic ticket, so every tile's predecessors have started, and a
//     block always finishes its earlier tile first: the wait for a
//     predecessor always ends.
//   * Staging: a block's first thread copies a tile's text (and a halo of
//     min(longest term - 1, kHalo) bytes) and the plane words over
//     [t0 + shift, t1 + shift) into shared memory with TMA bulk copies
//     that complete on an mbarrier, two stages a block: the next tile's
//     copy is in flight while this one is worked.  The copies take the
//     16-byte-aligned inside of each range; the threads load the ragged
//     ends.  The chunk's text and plane are read from HBM once.
//   * Warps: eight compute warps work the tiles, and a ninth, the
//     look-back warp, takes each folded tile from a stash of two slots in
//     shared memory (mbarriers hand them over): the compute warps never
//     wait for a look-back, and a tile costs them two barriers.
//   * Verify: each compute thread takes two 32-byte text words (a word's
//     newline mask from two 16-byte shared loads, its candidate bits by
//     one funnel shift of two plane words); in a round a word of the
//     lanes, each warp's candidates are compacted into its part of a list
//     in shared memory (a scan of the words' popcounts), and the warp's
//     lanes take the list's starts in turn, each verified once from
//     shared memory through a first-byte filter and tr (a term past the
//     staged halo reads the rest from global memory).
//   * Fold: each thread folds each word's starts and newlines into a word
//     aggregate (the fire bits of the lines inside the word beside it)
//     and its words' into its own, and a scan of those (a warp's, then
//     the warps' totals, behind one barrier) gives each word what
//     precedes it in the tile and the tile's aggregate, which the tile
//     publishes.
//   * Look-back: the look-back warp reads the statuses of the 128 tiles
//     before the tile at a time (four a lane, one round trip), combines
//     the aggregates up to the nearest inclusive prefix (the launch's
//     carried mask before tile 0) by a lane's own and then a shuffle
//     reduction, and publishes the tile's inclusive prefix; a status is 16
//     bytes written whole, so no fence is needed.  The resident blocks
//     hold several hundred tiles at once, so a look-back may have to
//     reach far back: a window of 128 lets the prefixes run on 128 tiles a
//     round trip.  The status words carry the launch's epoch (from the
//     host, one a launch on the scratch), so a status of an earlier launch
//     reads as not yet published and the scratch is never cleared between
//     launches; the tickets run on from the count of earlier launches'
//     tickets.
//   * Rows: knowing its prefix, the look-back warp knows the tile's first
//     line's verdict and its rows' offset, and writes the rows from the
//     stash (the compute warps left each word's fire bits, its rows'
//     offset in the tile and the newline before it).  The last tile
//     writes R, the carried-out mask, the last newline and the tail
//     line's verdict (and its row) into out[0..3].
//
// The rows are allocated before the launch at a bound of the lines that
// can fire (a firing line holds a whole occurrence and its newline, the
// first and the tail line aside), so no count is read before the rows are
// written and there is never a second launch.
//
// The LT_* hooks are empty; tools/torch_terms_phases.py defines them to
// stamp each block's phases.
//
// Built by ops/_cuda.py as one object with a plain C interface:
// nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
// -fPIC.

#include <cstdint>
#include <cuda_runtime.h>

#ifndef LT_STAMP
#define LT_STAMP(k)
#define LT_SPAN_BEGIN(v)
#define LT_SPAN_END(k, v)
#define LT_TICK(k)
#endif

namespace line_terms {

constexpr int kThreads = 256;             // the compute warps' threads
constexpr int kWarps = kThreads / 32;
constexpr int kBlockThreads = kThreads + 32;  // and the look-back warp
constexpr int kMinBlocks = 3;             // blocks an SM: 72 registers
constexpr int kPerThread = 2;             // 32-byte text words a thread
constexpr int kWords = kThreads * kPerThread;  // a tile's
constexpr int kTile = 32 * kWords;        // text bytes a tile
constexpr int kStages = 2;
constexpr int kHalo = 256;                // term bytes staged past a tile
constexpr int kTermSmem = 256;            // term bytes staged in shared memory
constexpr int kMaxTerms = 16;
// a stage's text: a 16-byte lead, the tile, its halo, and the aligned
// 32-byte chunk after the tile that the last word's funnel reads
constexpr int kTextBytes = kTile + kHalo + 32;
constexpr int kPlaneWords = kWords + 8;   // 4 lead words, the tile's, one on
static_assert(kTile < 32767, "a stash holds 16-bit positions");

struct Params {
    const uint8_t* text;            // [N], the region
    const uint32_t* plane;          // [pw = ceil(N / 32)]
    const uint8_t* t_bytes;         // the folded terms' bytes [tb_len]
    const int* t_off;               // [n_terms + 1]
    const uint8_t* tr;              // [256]
    const uint32_t* table;          // [max(1, 2^n_terms / 32)]
    long long* rows;                // [capacity, 2]; null for a count
    long long* out;                 // [4]: R, carry out, last newline, tail
    unsigned long long* ticket;     // the scratch: its ticket counter,
    uint32_t* status;               // and a status (4 u32) a tile
    long long N, body, pw;
    long long base, begin, cap_e;
    long long capacity;             // rows the output holds
    long long tiles, ticket_base;
    uint32_t epoch;                 // below 2^30
    int shift, n_terms, halo, tb_len;
    uint32_t carry;
    int last;
};

// An aggregate inside a tile (positions relative to the tile): the OR of
// the terms of the starts up to and at the first newline (all of them where
// there is none), the OR after the last newline, the last newline (-1:
// none) and the lines that end after the first newline and fire.
struct Agg {
    uint32_t head, tail;
    int last, cnt;
};

// A prefix: the open line's mask, the last newline (a region position, or
// -1) and the rows (lines that fire) before.
struct Pre {
    uint32_t mask;
    long long last, rows;
};

struct alignas(16) Stage {
    uint8_t text[kTextBytes];
    uint32_t plane[kPlaneWords];
};

// What the compute warps leave the look-back warp of a tile (T < 0: no
// more tiles): the tile's aggregate and its first newline; each word's
// newlines, the fire bits of its lines but the tile's first (that line's
// verdict needs the tile's prefix), the rows before them in the tile (but
// the first line's) and the tile's last newline before the word (-1:
// none).
struct Stash {
    long long T;
    Agg all;
    int first_nl;
    uint32_t nl[kWords], fire[kWords];
    uint16_t roff[kWords];
    int16_t last[kWords];
};

struct alignas(16) Smem {
    Stage stage[kStages];
    Stash stash[2];
    uint16_t list[kWarps * 1024];   // each warp's candidate offsets, then
                                    // their masks (1024, a word a lane)
    uint16_t first[256];            // the terms whose folded first byte it is
    uint8_t tr[256];
    uint8_t tb[kTermSmem];
    int off[kMaxTerms + 1];
    unsigned long long bar[kStages];   // a stage's copies landed
    unsigned long long full[2], empty[2];  // a stash written, read
    long long tile[kStages];        // each stage's tile (its ticket)
    Agg wagg[kWarps];
    const uint32_t* table;          // the truth table (global, read by __ldg)
};

__device__ __forceinline__ Agg identity() { return Agg{0u, 0u, -1, 0}; }

__device__ __forceinline__ bool fires(const Smem& s, uint32_t m) {
    return m && (__ldg(s.table + (m >> 5)) >> (m & 31) & 1u);
}

// combine(a, b): a followed by b.  An aggregate without a newline has
// tail 0 and cnt 0.
__device__ __forceinline__ Agg combine(const Smem& s, Agg a, Agg b) {
    if (a.last < 0) return Agg{a.head | b.head, b.tail, b.last, b.cnt};
    if (b.last < 0) return Agg{a.head, a.tail | b.head, a.last, a.cnt};
    return Agg{a.head, b.tail, b.last,
               a.cnt + (int)fires(s, a.tail | b.head) + b.cnt};
}

// The region-wide aggregate, as the look-back combines it.
struct Lb {
    uint32_t head, tail;
    long long last, cnt;
};

__device__ __forceinline__ Lb lb_identity() { return Lb{0u, 0u, -1, 0}; }

__device__ __forceinline__ Lb combine(const Smem& s, Lb a, Lb b) {
    if (a.last < 0) return Lb{a.head | b.head, b.tail, b.last, b.cnt};
    if (b.last < 0) return Lb{a.head, a.tail | b.head, a.last, a.cnt};
    return Lb{a.head, b.tail, b.last,
              a.cnt + (long long)fires(s, a.tail | b.head) + b.cnt};
}

// The prefix after an aggregate.
__device__ __forceinline__ Pre apply(const Smem& s, Pre p, Lb a) {
    if (a.last < 0) return Pre{p.mask | a.head, p.last, p.rows};
    return Pre{a.tail, a.last,
               p.rows + (long long)fires(s, p.mask | a.head) + a.cnt};
}

__device__ __forceinline__ Agg shfl(Agg x, int l) {
    return Agg{__shfl_sync(0xffffffffu, x.head, l),
               __shfl_sync(0xffffffffu, x.tail, l),
               __shfl_sync(0xffffffffu, x.last, l),
               __shfl_sync(0xffffffffu, x.cnt, l)};
}

__device__ __forceinline__ Agg shfl_up(Agg x, int d) {
    return Agg{__shfl_up_sync(0xffffffffu, x.head, d),
               __shfl_up_sync(0xffffffffu, x.tail, d),
               __shfl_up_sync(0xffffffffu, x.last, d),
               __shfl_up_sync(0xffffffffu, x.cnt, d)};
}

__device__ __forceinline__ Lb shfl(Lb x, int l) {
    return Lb{__shfl_sync(0xffffffffu, x.head, l),
              __shfl_sync(0xffffffffu, x.tail, l),
              __shfl_sync(0xffffffffu, x.last, l),
              __shfl_sync(0xffffffffu, x.cnt, l)};
}

__device__ __forceinline__ Pre shfl(Pre x, int l) {
    return Pre{__shfl_sync(0xffffffffu, x.mask, l),
               __shfl_sync(0xffffffffu, x.last, l),
               __shfl_sync(0xffffffffu, x.rows, l)};
}

// A barrier of the compute warps alone (the look-back warp runs on).
__device__ __forceinline__ void sync_compute() {
    asm volatile("bar.sync 1, %0;\n" :: "n"(kThreads) : "memory");
}

// The thread that the phase hooks (LT_*) stamp for: the first compute
// thread and the look-back warp's first.
__device__ __forceinline__ bool lead_thread() {
    return threadIdx.x == 0 || threadIdx.x == kThreads;
}

// The inclusive scan of x over the warp's lanes, in lane order.
__device__ __forceinline__ Agg warp_scan(const Smem& s, Agg x, int lane) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const Agg y = shfl_up(x, d);
        if (lane >= d) x = combine(s, y, x);
    }
    return x;
}

// The compute warps' exclusive scan of x (in thread order) and its total,
// behind one barrier: each warp scans its lanes, and then the warps'
// totals again for itself.
__device__ __forceinline__ Agg block_scan(Smem& s, Agg x, Agg& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const Agg incl = warp_scan(s, x, lane);
    if (lane == 31) s.wagg[warp] = incl;
    sync_compute();
    Agg v = lane < kWarps ? s.wagg[lane] : identity();
    v = warp_scan(s, v, lane);
    total = shfl(v, kWarps - 1);
    const Agg before = shfl(v, warp ? warp - 1 : 0);
    const Agg up = shfl_up(incl, 1);
    return combine(s, warp ? before : identity(), lane ? up : identity());
}

// The warp's exclusive scan of x (in lane order) and its total.
__device__ __forceinline__ int warp_excl(int x, int& total) {
    const int lane = threadIdx.x & 31;
    int incl = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
    }
    total = __shfl_sync(0xffffffffu, incl, 31);
    return incl - x;
}

// ---------------------------------------------------------------------
// staging
// ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar,
                                         uint32_t arrivals) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(arrivals) : "memory");
}

__device__ __forceinline__ void bar_expect(unsigned long long* bar,
                                           uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         uint32_t parity) {
    uint32_t done;
    do {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                     : "memory");
    } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes,
                                          unsigned long long* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                 "::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                    "r"(smem_addr(bar))
                 : "memory");
}

// A tile's ranges: its text [t0, t1) staged over [t0, end) at shared
// index lead + (x - t0), and its plane words [q0, q1) (then zeros to
// q0 + kWords + 1) at shared index plead + (q - q0); each range's
// 16-byte-aligned inside [a0, a1) goes by TMA, the rest by the threads.
struct Ranges {
    long long t0, t1, end;
    uintptr_t g0, a0, a1, g1;       // text bytes
    long long q0, q1;
    uintptr_t pg0, pa0, pa1, pg1;   // plane bytes
};

__device__ __forceinline__ Ranges ranges(const Params& p, long long T) {
    Ranges r;
    r.t0 = T * kTile;
    r.t1 = min(r.t0 + kTile, p.body);
    r.end = min(r.t1 + p.halo, p.N);
    r.g0 = reinterpret_cast<uintptr_t>(p.text + r.t0);
    r.g1 = reinterpret_cast<uintptr_t>(p.text + r.end);
    r.a0 = (r.g0 + 15) & ~uintptr_t(15);
    r.a1 = r.g1 & ~uintptr_t(15);
    if (r.a1 <= r.a0) r.a0 = r.a1 = r.g1;       // no inside: all ragged
    r.q0 = r.t0 / 32 + (p.shift >> 5);
    r.q1 = max(r.q0, min(r.q0 + kWords + 1, p.pw));
    r.pg0 = reinterpret_cast<uintptr_t>(p.plane + r.q0);
    r.pg1 = reinterpret_cast<uintptr_t>(p.plane + r.q1);
    r.pa0 = (r.pg0 + 15) & ~uintptr_t(15);
    r.pa1 = r.pg1 & ~uintptr_t(15);
    if (r.pa1 <= r.pa0) r.pa0 = r.pa1 = r.pg1;
    return r;
}

// The next ticket: a tile index (past the tiles: none left).
__device__ __forceinline__ long long take(const Params& p) {
    return (long long)(atomicAdd(p.ticket, 1ull) - p.ticket_base);
}

// The first compute thread: the TMA copies of tile T into stage k.
__device__ __forceinline__ void issue(const Params& p, Smem& s, int k,
                                      long long T) {
    const Ranges r = ranges(p, T);
    Stage& st = s.stage[k];
    const uint32_t tb = (uint32_t)(r.a1 - r.a0);
    const uint32_t pb = (uint32_t)(r.pa1 - r.pa0);
    // the stage's earlier reads (generic proxy) before the copies' writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_expect(&s.bar[k], tb + pb);
    if (tb)
        bulk_copy(st.text + (r.a0 - (r.g0 & ~uintptr_t(15))),
                  reinterpret_cast<const void*>(r.a0), tb, &s.bar[k]);
    if (pb)
        bulk_copy(reinterpret_cast<uint8_t*>(st.plane)
                      + (r.pa0 - (r.pg0 & ~uintptr_t(15))),
                  reinterpret_cast<const void*>(r.pa0), pb, &s.bar[k]);
}

// A compute thread's share of a tile's ragged ends: the text bytes and
// the plane words outside the copies' aligned insides, one a thread (the
// thread's load and its shared index: a text byte's, -2 - a plane word's,
// or -1 for none).  The loads are issued when the tile before starts and
// stored when it ends, so that their latency hides behind its work; the
// plane's zeros past its end are stored at once (every thread, no load).
struct Ragged {
    int at;
    uint32_t v;
};

__device__ __forceinline__ Ragged ragged_load(const Params& p, Stage& st,
                                              long long T) {
    const Ranges r = ranges(p, T);
    const int i = threadIdx.x;
    const int plead = (int)((r.pg0 & 15) >> 2);
    for (int j = (int)(r.q1 - r.q0) + i; j <= kWords; j += kThreads)
        st.plane[plead + j] = 0u;
    const int head = (int)(r.a0 - r.g0), tail = (int)(r.g1 - r.a1);
    const int phead = (int)((r.pa0 - r.pg0) >> 2);
    const int ptail = (int)((r.pg1 - r.pa1) >> 2);
    Ragged g{-1, 0u};
    if (i < head + tail) {
        const uintptr_t at = i < head ? r.g0 + i : r.a1 + (i - head);
        g.at = (int)(at - (r.g0 & ~uintptr_t(15)));
        g.v = __ldg(reinterpret_cast<const uint8_t*>(at));
    } else if (i < head + tail + phead + ptail) {
        const int k = i - head - tail;
        const int j = k < phead ? k : (int)(r.q1 - r.q0) - ptail + (k - phead);
        g.at = -2 - (plead + j);
        g.v = __ldg(p.plane + r.q0 + j);
    }
    return g;
}

__device__ __forceinline__ void ragged_store(Stage& st, Ragged g) {
    if (g.at >= 0)
        st.text[g.at] = (uint8_t)g.v;
    else if (g.at < -1)
        st.plane[-2 - g.at] = g.v;
}

// ---------------------------------------------------------------------
// a tile
// ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t nl_bits4(uint32_t x) {
    const uint32_t e = __vcmpeq4(x, 0x0a0a0a0au);            // 0xff a byte
    return (e >> 7 & 1u) | (e >> 14 & 2u) | (e >> 21 & 4u) | (e >> 28 & 8u);
}

// The newline mask of the 32 shared bytes at c (16-byte aligned).
__device__ __forceinline__ uint32_t nl_chunk(const uint8_t* c) {
    const uint4 a = *reinterpret_cast<const uint4*>(c);
    const uint4 b = *reinterpret_cast<const uint4*>(c + 16);
    const uint32_t x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    uint32_t nl = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) nl |= nl_bits4(x[i]) << (4 * i);
    return nl;
}

// The terms present at region position x of the tile staged in st: only
// the terms whose first byte is x's, folded, are compared past it; a byte
// past the staged end comes from global memory.
__device__ __forceinline__ uint32_t terms_at(const Params& p, const Smem& s,
                                             const Stage& st, int lead,
                                             long long t0, long long end,
                                             long long x) {
    const int sx = lead + (int)(x - t0);
    // byte k of the term at o matches the text (four compares at a time,
    // so that the loads of a step do not wait on each other)
    auto same = [&](int o, int k) {
        const uint8_t v = x + k < end ? st.text[sx + k]
                                      : __ldg(p.text + x + k);
        const uint8_t w = o + k < kTermSmem ? s.tb[o + k]
                                            : __ldg(p.t_bytes + o + k);
        return s.tr[v] == w;
    };
    uint32_t m = 0;
    for (uint32_t c = s.first[s.tr[st.text[sx]]]; c; c &= c - 1) {
        const int t = __ffs(c) - 1;
        const int o = s.off[t], L = s.off[t + 1] - o;
        if (x + L > p.N) continue;
        bool ok = true;
        int k = 1;
        for (; ok && k + 3 < L; k += 4)
            ok = same(o, k) & same(o, k + 1) & same(o, k + 2) & same(o, k + 3);
        for (; ok && k < L; ++k) ok = same(o, k);
        if (ok) m |= 1u << t;
    }
    return m;
}

__device__ __forceinline__ void put_row(const Params& p, long long i,
                                        long long b, long long e) {
    if (i < p.capacity) {
        p.rows[2 * i] = b;
        p.rows[2 * i + 1] = e;
    }
}

// A tile's status: 16 bytes written and read whole (as CUB's look-back
// relies on): the launch's epoch << 2 | flag, then either (flag 1) the
// tile's aggregate, head | tail << 16 and (last + 1) | cnt << 16 with last
// relative to the tile, or (flag 2) its inclusive prefix, the mask, the
// last newline + 1 (0: none) and the rows.  The epoch is below 2^30 (the
// wrapper allocates the scratch anew, zeroed, before it would wrap) and
// the region below 2^32 - 1 bytes.
struct Status {
    uint32_t tag, a, b, c;
};

__device__ __forceinline__ Status load_status(const Params& p, long long T) {
    Status v;
    asm volatile("ld.global.cg.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.tag), "=r"(v.a), "=r"(v.b), "=r"(v.c)
                 : "l"(p.status + 4 * T) : "memory");
    return v;
}

__device__ __forceinline__ void store_status(const Params& p, long long T,
                                             int flag, uint32_t a,
                                             uint32_t b, uint32_t c) {
    asm volatile("st.global.cg.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "l"(p.status + 4 * T), "r"(p.epoch << 2 | flag), "r"(a),
                    "r"(b), "r"(c)
                 : "memory");
}

__device__ __forceinline__ void publish_agg(const Params& p, long long T,
                                            Agg a) {
    store_status(p, T, 1, a.head | a.tail << 16,
                 (uint32_t)(a.last + 1) | (uint32_t)a.cnt << 16, 0u);
}

__device__ __forceinline__ void publish_inc(const Params& p, long long T,
                                            Pre q) {
    store_status(p, T, 2, q.mask, (uint32_t)(q.last + 1), (uint32_t)q.rows);
}

// Tile T's aggregate, its positions in the region.
__device__ __forceinline__ Lb agg_of(Status v, long long T) {
    const int l = (int)(v.b & 0xffffu);
    return Lb{v.a & 0xffffu, v.a >> 16, l ? T * kTile + l - 1 : -1,
              (long long)(v.b >> 16)};
}

__device__ __forceinline__ Pre inc_of(Status v) {
    return Pre{v.a, (long long)v.b - 1, (long long)v.c};
}

__device__ __forceinline__ Lb shfl_down(Lb x, int d) {
    return Lb{__shfl_down_sync(0xffffffffu, x.head, d),
              __shfl_down_sync(0xffffffffu, x.tail, d),
              __shfl_down_sync(0xffffffffu, x.last, d),
              __shfl_down_sync(0xffffffffu, x.cnt, d)};
}

// The look-back warp: the prefix before tile T (T > 0).  A window holds
// the kBack tiles before `top`, kBackLane a lane (lane l the entries e =
// kBackLane l + j, tile top - e); the lanes read their statuses,
// re-reading those not yet of this launch until every entry nearer than
// the nearest inclusive prefix (the launch's carried mask before tile 0)
// is there, and the aggregates up to that prefix are combined in tile
// order; without a prefix in the window all kBack aggregates are, and the
// window moves on.
constexpr int kBackLane = 4;
constexpr int kBack = 32 * kBackLane;

__device__ Pre look_back(const Params& p, const Smem& s, long long T) {
    const int lane = threadIdx.x & 31;
    Lb x = lb_identity();
    for (long long top = T - 1;; top -= kBack) {
        Status v[kBackLane];
        bool ok[kBackLane];
#pragma unroll
        for (int j = 0; j < kBackLane; ++j)
            ok[j] = top - (kBackLane * lane + j) < 0;
        int pe, ie;                 // the nearest prefix, the nearest gap
        for (;;) {
#pragma unroll
            for (int j = 0; j < kBackLane; ++j) {
                const long long i = top - (kBackLane * lane + j);
                if (!ok[j]) {
                    v[j] = load_status(p, i);
                    ok[j] = v[j].tag >> 2 == p.epoch;
                }
            }
            pe = ie = kBack;
#pragma unroll
            for (int j = kBackLane - 1; j >= 0; --j) {
                const int e = kBackLane * lane + j;
                const long long i = top - e;
                if (i == -1 || (i >= 0 && ok[j] && (v[j].tag & 3) == 2))
                    pe = e;
                if (!ok[j]) ie = e;
            }
            pe = __reduce_min_sync(0xffffffffu, pe);
            ie = __reduce_min_sync(0xffffffffu, ie);
            if (ie > pe || ie == kBack) break;
        }
        // the aggregates nearer than pe: a lane's own, then the lanes'
        // (lane l + d holds earlier tiles than lane l)
        Lb w = lb_identity();
#pragma unroll
        for (int j = kBackLane - 1; j >= 0; --j) {
            const int e = kBackLane * lane + j;
            if (e < pe) w = combine(s, w, agg_of(v[j], top - e));
        }
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const Lb y = shfl_down(w, d);
            if (lane + d < 32) w = combine(s, y, w);
        }
        x = combine(s, shfl(w, 0), x);
        if (pe < kBack) {
            Pre q = Pre{p.carry, -1, 0};
            if (top - pe >= 0) {
#pragma unroll
                for (int j = 0; j < kBackLane; ++j)
                    if (kBackLane * lane + j == pe) q = inc_of(v[j]);
            }
            return apply(s, shfl(q, pe / kBackLane), x);
        }
    }
}

// Rows form, word j of the stash's tile, whose rows begin at rows0
// (after the tile's first line's): the rows of the lines that fire and
// end in the word.
__device__ __forceinline__ void put_rows(const Params& p, const Stash& sh,
                                         int j, long long rows0) {
    const uint32_t nl = sh.nl[j];
    const long long t0 = sh.T * kTile;
    const long long w0 = p.base + t0 + 32 * j;   // the word's stream offset
    long long o = rows0 + sh.roff[j];
    for (uint32_t m = sh.fire[j]; m; m &= m - 1) {
        const int b = __ffs(m) - 1;
        const uint32_t below = nl & ((1u << b) - 1u);
        put_row(p, o++, below ? w0 + (31 - __clz(below)) + 1
                              : p.base + t0 + sh.last[j] + 1, w0 + b + 1);
    }
}

// The compute warps: tile T, staged in stage k, folded into the stash sh
// (its aggregate published where T > 0).  Thread i takes the tile's words
// kPerThread i .. kPerThread i + kPerThread - 1.
__device__ __forceinline__ void fold_tile(const Params& p, Smem& s, int k,
                                          long long T, Stash& sh,
                                          unsigned long long* empty,
                                          uint32_t parity) {
    const int i = threadIdx.x, lane = i & 31;
    const int wi = kPerThread * i;  // the thread's first word
    const Stage& st = s.stage[k];
    LT_SPAN_BEGIN(fold_t);
    const Ranges r = ranges(p, T);
    const long long t0 = r.t0;
    const int lead = (int)(r.g0 & 15);
    // word w: region positions t0 + 32 w .. t0 + 32 w + 31, cut from the
    // aligned chunks w and w + 1 (the last lane's next from shared memory)
    uint32_t a[kPerThread + 1];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
        a[j] = nl_chunk(st.text + 32 * (wi + j));
    a[kPerThread] = __shfl_down_sync(0xffffffffu, a[0], 1);
    if (lane == 31) a[kPerThread] = nl_chunk(st.text + 32 * (wi + kPerThread));
    const int plead = (int)((r.pg0 & 15) >> 2);
    const int sh_bits = p.shift & 31;
    uint32_t nl[kPerThread], cand[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
        nl[j] = lead ? a[j] >> lead | a[j + 1] << (32 - lead) : a[j];
        uint32_t c = st.plane[plead + wi + j];
        if (sh_bits) c = __funnelshift_r(c, st.plane[plead + wi + j + 1],
                                         sh_bits);
        const long long left = r.t1 - (t0 + 32 * (wi + j));
        const uint32_t keep = left >= 32 ? 0xffffffffu
                              : left > 0 ? (1u << (int)left) - 1u : 0u;
        nl[j] &= keep;
        cand[j] = c & keep;
    }
    LT_SPAN_END(9, fold_t);

    // a round a word of the lanes: the warp's candidates of that word
    // compacted into its part of the list, verified once each (its lanes
    // taking them in turn), then the word folded into its aggregate and
    // the fire bits of the lines inside it
    uint16_t* list = s.list + 1024 * (i >> 5);
    Agg w[kPerThread];
    uint32_t fire[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
        LT_SPAN_BEGIN(verify_t);
        const int wj = wi + j;
        int n_cand;
        const int at = warp_excl(__popc(cand[j]), n_cand);
        {
            int e = at;
            for (uint32_t c = cand[j]; c; c &= c - 1)
                list[e++] = (uint16_t)(32 * wj + __ffs(c) - 1);
        }
        __syncwarp();
        for (int e = lane; e < n_cand; e += 32)
            list[e] = (uint16_t)terms_at(p, s, st, lead, t0, r.end,
                                         t0 + list[e]);
        __syncwarp();
        LT_SPAN_END(10, verify_t);
        LT_SPAN_BEGIN(word_t);
        w[j] = identity();
        fire[j] = 0;
        uint32_t acc = 0;
        int e = at;
        bool seen = false;
        for (uint32_t ev = nl[j] | cand[j]; ev; ev &= ev - 1) {
            const int b = __ffs(ev) - 1;
            if (cand[j] >> b & 1u) acc |= list[e++];
            if (nl[j] >> b & 1u) {
                if (!seen) {
                    w[j].head = acc;
                    seen = true;
                } else if (fires(s, acc)) {
                    fire[j] |= 1u << b;
                    ++w[j].cnt;
                }
                w[j].last = 32 * wj + b;
                acc = 0;
            }
        }
        if (seen)
            w[j].tail = acc;
        else
            w[j].head = acc;
        __syncwarp();               // the list free for the next round
        LT_SPAN_END(11, word_t);
    }
    LT_SPAN_BEGIN(scan_t);
    Agg mine = w[0];
#pragma unroll
    for (int j = 1; j < kPerThread; ++j) mine = combine(s, mine, w[j]);
    Agg all;
    Agg x = block_scan(s, mine, all);
    LT_SPAN_END(12, scan_t);
    // a status of flag 1 that lands after the look-back warp's flag 2
    // only sends later look-backs further back: no fence is needed
    if (i == 0 && T > 0) publish_agg(p, T, all);
    LT_SPAN_END(3, fold_t);
    {
        LT_SPAN_BEGIN(stash_t);
        bar_wait(empty, parity);    // the look-back warp is done with sh
        LT_SPAN_END(7, stash_t);
    }
    LT_SPAN_BEGIN(write_t);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
        // the word's first line: the tile's first (x.last < 0), or known
        // here
        const int wj = wi + j;
        uint32_t f = fire[j];
        if (nl[j] && x.last >= 0 && fires(s, x.tail | w[j].head))
            f |= nl[j] & -nl[j];
        if (nl[j] && x.last < 0) sh.first_nl = 32 * wj + __ffs(nl[j]) - 1;
        sh.nl[wj] = nl[j];
        sh.fire[wj] = f;
        sh.roff[wj] = (uint16_t)x.cnt;
        sh.last[wj] = (int16_t)x.last;
        x = combine(s, x, w[j]);
    }
    if (i == 0) {
        sh.T = T;
        sh.all = all;
    }
    LT_SPAN_END(15, write_t);
}

// The look-back warp: tile sh.T's prefix, its inclusive prefix published
// (and the launch's outputs from the last tile), its rows written.
template <bool kRows>
__device__ __forceinline__ void finish_tile(const Params& p, const Smem& s,
                                            const Stash& sh) {
    const int lane = threadIdx.x & 31;
    const long long T = sh.T;
    const Agg all = sh.all;
    LT_SPAN_BEGIN(back_t);
    const Lb a = Lb{all.head, all.tail,
                    all.last >= 0 ? T * kTile + all.last : -1, all.cnt};
    const Pre pre = T > 0 ? look_back(p, s, T) : Pre{p.carry, -1, 0};
    const Pre inc = apply(s, pre, a);
    if (lane == 0) {
        publish_inc(p, T, inc);
        if (T == p.tiles - 1) {
            const bool tail = p.last && fires(s, inc.mask);
            if (kRows && tail)
                put_row(p, inc.rows, inc.last >= 0 ? p.base + inc.last + 1
                                                   : p.begin, p.cap_e);
            p.out[0] = inc.rows + tail;
            p.out[1] = p.last ? 0 : inc.mask;
            p.out[2] = inc.last >= 0 ? p.base + inc.last : -1;
            p.out[3] = tail;
        }
    }
    LT_SPAN_END(4, back_t);
    if (kRows) {
        LT_SPAN_BEGIN(rows_t);
        const bool f0 = all.last >= 0 && fires(s, pre.mask | all.head);
        if (f0 && lane == 0)
            put_row(p, pre.rows, pre.last >= 0 ? p.base + pre.last + 1
                                               : p.begin,
                    p.base + T * kTile + sh.first_nl + 1);
        for (int j = lane; j < kWords; j += 32)
            if (sh.fire[j]) put_rows(p, sh, j, pre.rows + f0);
        LT_SPAN_END(5, rows_t);
    }
}

template <bool kRows>
__global__ void __launch_bounds__(kBlockThreads, kMinBlocks)
terms_kernel(Params p) {
    extern __shared__ __align__(128) uint8_t smem_raw[];
    Smem& s = *reinterpret_cast<Smem*>(smem_raw);
    const int i = threadIdx.x;
    LT_STAMP(0);
    if (i == 0) {
        for (int k = 0; k < kStages; ++k) bar_init(&s.bar[k], 1);
        for (int k = 0; k < 2; ++k) {
            bar_init(&s.full[k], kThreads);
            bar_init(&s.empty[k], 1);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        // the first two tickets (the second only after a tile)
        const long long t = take(p);
        s.tile[0] = t;
        s.tile[1] = t < p.tiles ? take(p) : t;
        if (t < p.tiles) issue(p, s, 0, t);
    }
    // the tables
    for (int v = i; v < 256; v += kBlockThreads) s.tr[v] = __ldg(p.tr + v);
    if (i <= p.n_terms) s.off[i] = __ldg(p.t_off + i);
    if (i == 0) s.table = p.table;
    for (int v = i; v < min(p.tb_len, kTermSmem); v += kBlockThreads)
        s.tb[v] = __ldg(p.t_bytes + v);
    __syncthreads();
    for (int v = i; v < 256; v += kBlockThreads) {
        uint32_t m = 0;
        for (int t = 0; t < p.n_terms; ++t)
            if (s.off[t + 1] > s.off[t]
                && (s.off[t] < kTermSmem ? s.tb[s.off[t]]
                                         : __ldg(p.t_bytes + s.off[t])) == v)
                m |= 1u << t;
        s.first[v] = m;
    }
    __syncthreads();
    if (i >= kThreads) {
        // the look-back warp: the stashed tiles in turn, until the
        // compute warps' end mark
        for (int n = 0;; ++n) {
            const Stash& sh = s.stash[n & 1];
            bar_wait(&s.full[n & 1], n >> 1 & 1);
            if (sh.T < 0) break;
            finish_tile<kRows>(p, s, sh);
            __syncwarp();
            if (i == kThreads) bar_arrive(&s.empty[n & 1]);
        }
        LT_STAMP(1);
        return;
    }
    // The compute warps.  Tile n is staged in stage n & 1 (s.tile[n & 1]);
    // while it is worked, tile n + 1's copy is in flight and the ticket of
    // tile n + 2 is taken (its value wanted only at the tile's end).
    if (s.tile[0] < p.tiles)
        ragged_store(s.stage[0], ragged_load(p, s.stage[0], s.tile[0]));
    long long ahead = -1;           // the first thread's newest ticket
    uint32_t parity = 0;            // bit k: stage k's next wait
    for (int n = 0;; ++n) {
        const int k = n & 1;
        // the stage's tile, its ragged ends and the next tile visible; the
        // other stage and the stash of tile n - 2 no longer read
        sync_compute();
        LT_SPAN_BEGIN(tile_t);
        const long long T = s.tile[k], Tn = s.tile[k ^ 1];
        Stash& sh = s.stash[k];
        if (T >= p.tiles) {
            if (i == 0) {
                bar_wait(&s.empty[k], (n >> 1 & 1) ^ 1);
                sh.T = -1;
            }
            bar_arrive(&s.full[k]);
            break;
        }
        Ragged g{-1, 0u};
        if (Tn < p.tiles) {
            LT_SPAN_BEGIN(issue_t);
            if (i == 0) {
                issue(p, s, k ^ 1, Tn);
                ahead = take(p);
            }
            g = ragged_load(p, s.stage[k ^ 1], Tn);
            LT_SPAN_END(13, issue_t);
        } else if (i == 0) {
            ahead = Tn;
        }
        {
            LT_SPAN_BEGIN(wait_t);
            bar_wait(&s.bar[k], parity >> k & 1u);
            LT_SPAN_END(2, wait_t);
        }
        parity ^= 1u << k;
        fold_tile(p, s, k, T, sh, &s.empty[k], (n >> 1 & 1) ^ 1);
        LT_TICK(6);
        LT_SPAN_BEGIN(end_t);
        ragged_store(s.stage[k ^ 1], g);
        if (i == 0) s.tile[k] = ahead;     // tile n + 2, in stage k
        bar_arrive(&s.full[k]);     // this thread's part of the stash
        LT_SPAN_END(14, end_t);
        LT_SPAN_END(8, tile_t);
    }
}

const void* kernel(int rows) {
    return rows ? reinterpret_cast<const void*>(terms_kernel<true>)
                : reinterpret_cast<const void*>(terms_kernel<false>);
}

}  // namespace line_terms

using namespace line_terms;

extern "C" {

// Threads a block, the blocks of the rows form (rows != 0) or the count
// form that the current device holds at once (the wrapper's grid) and the
// text bytes a tile.  Returns a cudaError_t.
int line_terms_geometry(int rows, int* threads, int* max_blocks, int* tile) {
    *threads = kBlockThreads;
    *tile = kTile;
    const void* fn = kernel(rows);
    const size_t bytes = sizeof(Smem);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    int dev, sms, per_sm;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
        return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fn, kBlockThreads, bytes)) != cudaSuccess)
        return (int)err;
    *max_blocks = sms * per_sm;
    return 0;
}

// One launch on `stream` of grid blocks (any number: the tiles go by
// ticket).  state: the scratch, int64 [2 + 2 * state_tiles], 16-byte
// aligned (its ticket counter and a pad, then a status of 16 bytes a
// tile), zeroed when it was allocated and never since: every launch on it
// gives an epoch above any earlier one's and below 2^30, and the count of
// tickets its earlier launches took (tiles + grid each).  R, the
// carried-out mask, the body's last newline (a stream position, or -1)
// and the tail line's verdict land in out[0..3].  Where rows is not null, the rows (int64 [capacity,
// 2]; those past capacity are not written).  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments the kernel does
// not take).  All pointers are device pointers: text u8 [N], plane u32
// [ceil(N / 32)], t_bytes u8 [tb_len], t_off int32 [n_terms + 1] into
// t_bytes, tr u8 [256], table u32 [max(1, 2^n_terms / 32)]; max_len is the
// longest term.
int line_terms_launch(const uint8_t* text, long long N, long long body,
                      const uint32_t* plane, int shift,
                      const uint8_t* t_bytes, long long tb_len,
                      const int* t_off, int n_terms, int max_len,
                      const uint8_t* tr, const uint32_t* table,
                      long long carry, long long base, long long begin,
                      long long cap_e, int last, long long* rows,
                      long long capacity, long long* state,
                      long long state_tiles, long long epoch,
                      long long ticket_base, long long* out, int grid,
                      void* stream) {
    const long long tiles = (body + kTile - 1) / kTile;
    if (N < 1 || body < 1 || body > N || shift < 0 || n_terms < 1
        || n_terms > kMaxTerms || carry < 0 || carry >> n_terms
        || capacity < 0 || grid < 1 || max_len < 1 || tb_len < 1
        || tiles > state_tiles || epoch < 1 || epoch >= 1 << 30
        || ticket_base < 0 || N >= 0xffffffffLL)
        return (int)cudaErrorInvalidValue;
    Params p;
    p.text = text;
    p.plane = plane;
    p.t_bytes = t_bytes;
    p.t_off = t_off;
    p.tr = tr;
    p.table = table;
    p.rows = rows;
    p.out = out;
    p.ticket = reinterpret_cast<unsigned long long*>(state);
    p.status = reinterpret_cast<uint32_t*>(state + 2);
    p.N = N;
    p.body = body;
    p.pw = (N + 31) / 32;
    p.base = base;
    p.begin = begin;
    p.cap_e = cap_e;
    p.capacity = rows ? capacity : 0;
    p.tiles = tiles;
    p.ticket_base = ticket_base;
    p.epoch = (uint32_t)epoch;
    p.shift = shift;
    p.n_terms = n_terms;
    p.halo = min(max_len - 1, kHalo);
    p.tb_len = (int)min(tb_len, (long long)kTermSmem);
    p.carry = (uint32_t)carry;
    p.last = last;
    const void* fn = kernel(rows != nullptr);
    const size_t bytes = sizeof(Smem);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&p};
    err = cudaLaunchKernel(fn, dim3(grid), dim3(kBlockThreads), args, bytes,
                           static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

const char* line_terms_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
