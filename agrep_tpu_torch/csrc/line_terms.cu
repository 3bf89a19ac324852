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
// The design.  A line's mask is a segmented OR over newline-delimited
// runs of positions, and the summary (the OR of the starts after the last
// newline, the last newline's position) of a run of text words combines
// associatively: combine(A, B) = B when B holds a newline, else (A.tail |
// B.tail, A.last).  One cooperative launch (at most as many blocks as the
// SMs hold at once, each warp a run of consecutive 32-byte text words,
// lane l word l of each 32-word step) with grid-wide barriers between:
//
//   * phase 1: each lane loads its word's newline mask (two 16-byte
//     loads where the text is 16-byte aligned) and its 32 candidate bits
//     (one funnel shift of two plane words) and verifies only the starts
//     after the word's last newline (all that the summary needs); a
//     shuffle reduction folds each step, lane 0 the warp's run, thread 0
//     the block's warps;
//   * phase 2: block 0 scans the blocks' summaries in order from the
//     carried-in mask and writes each block's exclusive prefix, the
//     carried-out mask, the last newline and whether the tail line fires
//     (a summary a block, not a warp: block 0 reads its share of them
//     out of L2 in series, and eight times as many cost more than the
//     rest of the count);
//   * phase 3: thread 0 of each block turns its block's prefix into its
//     warps', and each warp walks its run again from its prefix: a
//     shuffle scan of the lanes' summaries gives each lane the mask and
//     the last newline before its word, and the lane verifies the starts
//     before its word's last newline, ORs each into its line and tests
//     each line that ends in its word against the truth table: a fire
//     mask over its newlines.  A start compares past its first byte only
//     the terms that begin with that byte, folded (a table in shared
//     memory).  The count form sums the fires (atomicAdd a block) and
//     ends;
//   * rows form: each block's count, a barrier, block 0's exclusive scan
//     of them (and the tail line's row), a barrier, and phase 4 walks the
//     run a third time and writes each firing line's row at its offset
//     (a warp's from its block's, a lane's by a shuffle scan of the fire
//     masks' popcounts).
//
// The rows are allocated before the launch at a bound of the lines that
// can fire (a firing line holds a whole occurrence and its newline, the
// first and the tail line aside), so no count is read before the rows are
// written and there is never a second launch.
//
// Built by ops/_cuda.py as one object with a plain C interface:
// nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
// -fPIC.  The grid sync needs no -rdc with CUDA 12.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "plane_words.cuh"

namespace line_terms {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTerms = 16;

struct Params {
    const uint8_t* text;            // [N], the region
    const uint32_t* plane;          // [ceil(N / 32)]
    const uint8_t* t_bytes;         // the folded terms' bytes
    const int* t_off;               // [n_terms + 1]
    const uint8_t* tr;              // [256]
    const uint32_t* table;          // [max(1, 2^n_terms / 32)]
    long long* rows;                // [capacity, 2]; null for a count
    long long N, body;
    long long base, begin, cap_e;
    long long capacity;             // rows the output holds
    long long warp_words;           // text words of a warp's run
    int shift, n_terms;
    uint32_t carry;
    int last;
};

// A run's summary: the OR of the terms of its starts after its last
// newline (all its starts where it holds none) and the region position of
// its last newline (-1: none).
struct Sum {
    uint32_t tail;
    long long last;
};

__device__ __forceinline__ Sum identity() { return Sum{0u, -1}; }

__device__ __forceinline__ Sum combine(Sum a, Sum b) {
    return b.last >= 0 ? b : Sum{a.tail | b.tail, a.last};
}

__device__ __forceinline__ Sum shfl_up(Sum x, int d) {
    return Sum{__shfl_up_sync(0xffffffffu, x.tail, d),
               __shfl_up_sync(0xffffffffu, x.last, d)};
}

__device__ __forceinline__ Sum shfl_down(Sum x, int d) {
    return Sum{__shfl_down_sync(0xffffffffu, x.tail, d),
               __shfl_down_sync(0xffffffffu, x.last, d)};
}

__device__ __forceinline__ Sum shfl(Sum x, int l) {
    return Sum{__shfl_sync(0xffffffffu, x.tail, l),
               __shfl_sync(0xffffffffu, x.last, l)};
}

// The inclusive scan of x over the warp's lanes, in lane order.
__device__ __forceinline__ Sum warp_scan(Sum x, int lane) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const Sum y = shfl_up(x, d);
        if (lane >= d) x = combine(y, x);
    }
    return x;
}

// The block's tables in shared memory: the fold, the terms' offsets, and
// for each folded byte the terms whose first byte it is.
struct Shared {
    uint32_t first[256];
    uint8_t tr[256];
    int off[kMaxTerms + 1];
};

__device__ __forceinline__ void load_shared(const Params& p, Shared& s) {
    for (int i = threadIdx.x; i < 256; i += kThreads) s.tr[i] = __ldg(p.tr + i);
    if (threadIdx.x <= p.n_terms) s.off[threadIdx.x] = __ldg(p.t_off + threadIdx.x);
    __syncthreads();
    for (int v = threadIdx.x; v < 256; v += kThreads) {
        uint32_t m = 0;
        for (int t = 0; t < p.n_terms; ++t)
            if (s.off[t + 1] > s.off[t] && __ldg(p.t_bytes + s.off[t]) == v)
                m |= 1u << t;
        s.first[v] = m;
    }
    __syncthreads();
}

// A text word's newlines (bits of body positions) and candidate starts.
struct Word {
    uint32_t nl, cand;
};

__device__ __forceinline__ uint32_t nl_bits4(uint32_t x) {
    const uint32_t e = __vcmpeq4(x, 0x0a0a0a0au);            // 0xff a byte
    return (e >> 7 & 1u) | (e >> 14 & 2u) | (e >> 21 & 4u) | (e >> 28 & 8u);
}

__device__ __forceinline__ Word load_word(const Params& p, long long w) {
    const long long i0 = 32 * w;
    uint32_t nl = 0;
    if ((reinterpret_cast<uintptr_t>(p.text) & 15) == 0 && i0 + 32 <= p.N) {
        const uint4* q = reinterpret_cast<const uint4*>(p.text + i0);
        const uint4 a = __ldg(q), b = __ldg(q + 1);
        const uint32_t x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) nl |= nl_bits4(x[i]) << (4 * i);
    } else {
        for (int b = 0; b < 32 && i0 + b < p.N; ++b)
            nl |= (uint32_t)(__ldg(p.text + i0 + b) == 0x0a) << b;
    }
    // the candidates: plane bits i0 + shift .. i0 + shift + 31
    const long long a0 = i0 + p.shift;
    const long long pw = (p.N + 31) / 32, q = a0 >> 5;
    const int r = (int)(a0 & 31);
    const uint32_t lo = q < pw ? __ldg(p.plane + q) : 0u;
    const uint32_t hi = q + 1 < pw ? __ldg(p.plane + q + 1) : 0u;
    uint32_t cand = r ? __funnelshift_r(lo, hi, r) : lo;
    const long long left = p.body - i0;
    const uint32_t keep = left >= 32 ? 0xffffffffu : (1u << (int)left) - 1u;
    return Word{nl & keep, cand & keep};
}

// The terms present at start s, one bit a term: only the terms whose
// first byte is s's, folded, are compared past it.
__device__ __forceinline__ uint32_t terms_at(const Params& p,
                                             const Shared& sh, long long s) {
    uint32_t m = 0;
    for (uint32_t c = sh.first[sh.tr[__ldg(p.text + s)]]; c; c &= c - 1) {
        const int t = __ffs(c) - 1;
        const int o = sh.off[t], L = sh.off[t + 1] - o;
        if (s + L > p.N) continue;
        int k = 1;
        while (k < L && sh.tr[__ldg(p.text + s + k)] == __ldg(p.t_bytes + o + k))
            ++k;
        if (k == L) m |= 1u << t;
    }
    return m;
}

// The word's summary: only the starts after its last newline verified.
__device__ __forceinline__ Sum summary(const Params& p, const Shared& sh,
                                       long long w, Word wd) {
    Sum s = identity();
    uint32_t c = wd.cand;
    if (wd.nl) {
        const int hi = 31 - __clz(wd.nl);
        s.last = 32 * w + hi;
        c = hi == 31 ? 0u : c & (0xffffffffu << (hi + 1));
    }
    for (; c; c &= c - 1) s.tail |= terms_at(p, sh, 32 * w + __ffs(c) - 1);
    return s;
}

__device__ __forceinline__ bool fires(const Params& p, uint32_t m) {
    return m && (__ldg(p.table + (m >> 5)) >> (m & 31) & 1u);
}

// The word walked from the open line's mask acc: every start before its
// last newline verified and ORed into its line (a start after it ends no
// line here), each line that ends at a newline of the word tested;
// returns the word's newlines whose lines fire.
__device__ __forceinline__ uint32_t fire_mask(const Params& p,
                                              const Shared& sh, long long w,
                                              Word wd, uint32_t acc) {
    if (!wd.nl) return 0u;
    const int hi = 31 - __clz(wd.nl);
    const uint32_t before = hi == 31 ? 0xffffffffu : (2u << hi) - 1u;
    uint32_t f = 0;
    for (uint32_t ev = wd.nl | (wd.cand & before); ev; ev &= ev - 1) {
        const int b = __ffs(ev) - 1;
        if (wd.cand >> b & 1u) acc |= terms_at(p, sh, 32 * w + b);
        if (wd.nl >> b & 1u) {
            if (fires(p, acc)) f |= 1u << b;
            acc = 0;
        }
    }
    return f;
}

// The warp's run of text words [w0, w1) and its 32-word steps.
struct Run {
    long long w0, w1;
    int steps;
};

__device__ __forceinline__ Run warp_run(const Params& p) {
    const long long words = (p.body + 31) / 32;
    const long long gw = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    Run r;
    r.w0 = gw * p.warp_words;
    r.w1 = min(r.w0 + p.warp_words, words);
    r.steps = r.w0 < r.w1 ? (int)((r.w1 - r.w0 + 31) / 32) : 0;
    return r;
}

// Scratch (int64): [0, B) the blocks' last newlines, then their exclusive
// prefixes; [B, 2B) their tails, then the prefixes'; [2B, 3B) the blocks'
// fire counts, then their rows' offsets (rows form); [3B, 3B + 4): R, the
// carried-out mask, the last newline's stream position, whether the tail
// line fires.  B: the grid's blocks.
struct Scratch {
    long long *last, *tail, *count, *out;
};

__device__ __forceinline__ Scratch scratch_of(long long* s) {
    const long long B = gridDim.x;
    return Scratch{s, s + B, s + 2 * B, s + 3 * B};
}

// The block's warps' summaries (phase 1) and then their prefixes (phase
// 3), their fire counts and then their rows' offsets.
struct Warps {
    uint32_t tail[kWarps];
    long long last[kWarps];
    long long count[kWarps];
};

// Phase 2, block 0: the blocks' exclusive prefixes from the carried mask,
// in place; the carried-out mask, the last newline and the tail line's
// verdict into out[1..3], and the tail line into R.
__device__ void scan_summaries(const Params& p, const Scratch& sc) {
    __shared__ uint32_t s_tail[kWarps];
    __shared__ long long s_last[kWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long B = gridDim.x;
    const long long per = (B + kThreads - 1) / kThreads;
    const long long i0 = min(threadIdx.x * per, B), i1 = min(i0 + per, B);
    Sum x = identity();
    for (long long i = i0; i < i1; ++i)
        x = combine(x, Sum{(uint32_t)__ldcg(sc.tail + i), __ldcg(sc.last + i)});
    const Sum incl = warp_scan(x, lane);
    if (lane == 31) {
        s_tail[warp] = incl.tail;
        s_last[warp] = incl.last;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        Sum pre = Sum{p.carry, -1};
        for (int k = 0; k < kWarps; ++k) {
            const Sum t = Sum{s_tail[k], s_last[k]};
            s_tail[k] = pre.tail;
            s_last[k] = pre.last;
            pre = combine(pre, t);
        }
    }
    __syncthreads();
    const Sum up = shfl_up(incl, 1);
    Sum pre = combine(Sum{s_tail[warp], s_last[warp]},
                      lane ? up : identity());
    for (long long i = i0; i < i1; ++i) {
        const Sum e = Sum{(uint32_t)__ldcg(sc.tail + i), __ldcg(sc.last + i)};
        sc.tail[i] = pre.tail;
        sc.last[i] = pre.last;
        pre = combine(pre, e);
    }
    if (threadIdx.x == kThreads - 1) {
        // pre: the fold of every block from the carried mask
        const int tail_fires = p.last && fires(p, pre.tail);
        sc.out[1] = p.last ? 0 : pre.tail;
        sc.out[2] = pre.last >= 0 ? p.base + pre.last : -1;
        sc.out[3] = tail_fires;
        sc.out[0] = tail_fires;
    }
}

// Phases 3 and 4: the warp's run walked from its prefix; each step's
// lanes, words and fire masks to visit(w, word, fire mask, the last
// newline before the word), and the step's fires summed into the return.
template <typename Visit>
__device__ __forceinline__ long long walk_run(const Params& p,
                                              const Shared& sh, Run r,
                                              Sum pre, Visit visit) {
    const int lane = threadIdx.x & 31;
    long long n = 0;
    for (int st = 0; st < r.steps; ++st) {
        const long long w = r.w0 + 32LL * st + lane;
        const bool live = w < r.w1;
        const Word wd = live ? load_word(p, w) : Word{0u, 0u};
        const Sum s = live ? summary(p, sh, w, wd) : identity();
        const Sum incl = warp_scan(s, lane);
        const Sum up = shfl_up(incl, 1);
        const Sum before = combine(pre, lane ? up : identity());
        const uint32_t f = live ? fire_mask(p, sh, w, wd, before.tail) : 0u;
        n += visit(w, wd, f, before.last);
        pre = combine(pre, shfl(incl, 31));
    }
    return n;
}

__device__ __forceinline__ long long warp_sum(long long x) {
#pragma unroll
    for (int o = 16; o; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    return x;
}

// Phase 1: each warp's summary into ws, the block's into scratch.
__device__ __forceinline__ void summarize(const Params& p, const Shared& sh,
                                          const Scratch& sc, Warps& ws) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const Run r = warp_run(p);
    Sum run = identity();
    for (int st = 0; st < r.steps; ++st) {
        const long long w = r.w0 + 32LL * st + lane;
        Sum s = w < r.w1 ? summary(p, sh, w, load_word(p, w)) : identity();
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const Sum y = shfl_down(s, d);
            if (lane + d < 32) s = combine(s, y);
        }
        run = combine(run, shfl(s, 0));
    }
    if (lane == 0) {
        ws.tail[warp] = run.tail;
        ws.last[warp] = run.last;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        Sum b = identity();
        for (int k = 0; k < kWarps; ++k) b = combine(b, Sum{ws.tail[k], ws.last[k]});
        sc.tail[blockIdx.x] = b.tail;
        sc.last[blockIdx.x] = b.last;
    }
}

// After phase 2: each warp's prefix, from its block's and the summaries of
// the block's warps before it, into ws in place; returns the calling
// warp's.
__device__ __forceinline__ Sum warp_prefix(const Scratch& sc, Warps& ws) {
    if (threadIdx.x == 0) {
        Sum pre = Sum{(uint32_t)__ldcg(sc.tail + blockIdx.x),
                      __ldcg(sc.last + blockIdx.x)};
        for (int k = 0; k < kWarps; ++k) {
            const Sum t = Sum{ws.tail[k], ws.last[k]};
            ws.tail[k] = pre.tail;
            ws.last[k] = pre.last;
            pre = combine(pre, t);
        }
    }
    __syncthreads();
    const int warp = threadIdx.x >> 5;
    return Sum{ws.tail[warp], ws.last[warp]};
}

__global__ void __launch_bounds__(kThreads)
count_kernel(Params p, long long* __restrict__ scratch) {
    __shared__ Shared sh;
    __shared__ Warps ws;
    cg::grid_group grid = cg::this_grid();
    const Scratch sc = scratch_of(scratch);
    load_shared(p, sh);
    summarize(p, sh, sc, ws);
    grid.sync();
    if (blockIdx.x == 0) scan_summaries(p, sc);
    grid.sync();
    long long n = walk_run(p, sh, warp_run(p), warp_prefix(sc, ws),
                           [](long long, Word, uint32_t f, long long) {
                               return (long long)__popc(f);
                           });
    n = warp_sum(n);
    if ((threadIdx.x & 31) == 0) ws.count[threadIdx.x >> 5] = n;
    __syncthreads();
    if (threadIdx.x == 0) {
        long long t = 0;
        for (int k = 0; k < kWarps; ++k) t += ws.count[k];
        if (t) atomicAdd(reinterpret_cast<unsigned long long*>(sc.out),
                         (unsigned long long)t);
    }
}

__device__ __forceinline__ void put_row(const Params& p, long long i,
                                        long long b, long long e) {
    if (i < p.capacity) {
        p.rows[2 * i] = b;
        p.rows[2 * i + 1] = e;
    }
}

// Rows form, block 0 between phases 3 and 4: the blocks' fire counts
// turned into their rows' offsets, in place; the tail line's row; R into
// out[0].
__device__ void scan_counts(const Params& p, const Scratch& sc) {
    __shared__ long long s_part[kWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long B = gridDim.x;
    const long long per = (B + kThreads - 1) / kThreads;
    const long long i0 = min(threadIdx.x * per, B), i1 = min(i0 + per, B);
    long long x = 0;
    for (long long i = i0; i < i1; ++i) x += __ldcg(sc.count + i);
    long long incl = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const long long y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
    }
    if (lane == 31) s_part[warp] = incl;
    __syncthreads();
    if (threadIdx.x == 0) {
        long long o = 0;
        for (int k = 0; k < kWarps; ++k) {
            const long long t = s_part[k];
            s_part[k] = o;
            o += t;
        }
    }
    __syncthreads();
    long long pre = s_part[warp] + incl - x;
    for (long long i = i0; i < i1; ++i) {
        const long long c = __ldcg(sc.count + i);
        sc.count[i] = pre;
        pre += c;
    }
    if (threadIdx.x == kThreads - 1) {
        // pre: the rows of every block; out[2..3] this thread's own
        // stores of phase 2
        const long long tail = sc.out[3];
        if (tail)
            put_row(p, pre, sc.out[2] >= 0 ? sc.out[2] + 1 : p.begin,
                    p.cap_e);
        sc.out[0] = pre + tail;
    }
}

__global__ void __launch_bounds__(kThreads)
rows_kernel(Params p, long long* __restrict__ scratch) {
    __shared__ Shared sh;
    __shared__ Warps ws;
    cg::grid_group grid = cg::this_grid();
    const Scratch sc = scratch_of(scratch);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    load_shared(p, sh);
    summarize(p, sh, sc, ws);
    grid.sync();
    if (blockIdx.x == 0) scan_summaries(p, sc);
    grid.sync();
    const Run r = warp_run(p);
    const Sum pre = warp_prefix(sc, ws);
    long long n = walk_run(p, sh, r, pre,
                           [](long long, Word, uint32_t f, long long) {
                               return (long long)__popc(f);
                           });
    n = warp_sum(n);
    if (lane == 0) ws.count[warp] = n;
    __syncthreads();
    if (threadIdx.x == 0) {
        long long t = 0;
        for (int k = 0; k < kWarps; ++k) t += ws.count[k];
        sc.count[blockIdx.x] = t;
    }
    grid.sync();
    if (blockIdx.x == 0) scan_counts(p, sc);
    grid.sync();
    // phase 4: each firing line's row at its offset
    if (threadIdx.x == 0) {
        long long o = __ldcg(sc.count + blockIdx.x);
        for (int k = 0; k < kWarps; ++k) {
            const long long t = ws.count[k];
            ws.count[k] = o;
            o += t;
        }
    }
    __syncthreads();
    long long o = ws.count[warp];
    walk_run(p, sh, r, pre, [&](long long w, Word wd, uint32_t f,
                                long long last) {
        const int c = __popc(f);
        int x = c;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, x, d);
            if (lane >= d) x += y;
        }
        const int total = __shfl_sync(0xffffffffu, x, 31);
        long long i = o + x - c;
        for (uint32_t m = f; m; m &= m - 1) {
            const int b = __ffs(m) - 1;
            const uint32_t below = wd.nl & ((1u << b) - 1u);
            const long long prev = below ? 32 * w + 31 - __clz(below) : last;
            put_row(p, i++, prev >= 0 ? p.base + prev + 1 : p.begin,
                    p.base + 32 * w + b + 1);
        }
        o += total;
        return (long long)c;
    });
}

const void* kernel(int rows) {
    return rows ? reinterpret_cast<const void*>(rows_kernel)
                : reinterpret_cast<const void*>(count_kernel);
}

}  // namespace line_terms

using namespace line_terms;

extern "C" {

// Threads a block and the blocks of a launch of the rows form (rows != 0)
// or the count form that the current device holds at once (the most a
// cooperative launch takes).  Returns a cudaError_t.
int line_terms_geometry(int rows, int* threads, int* max_blocks) {
    *threads = kThreads;
    return plane_words::resident_blocks(kernel(rows), kThreads, 0,
                                        max_blocks);
}

// One cooperative launch on `stream` of grid blocks (at most
// line_terms_geometry's max_blocks).  scratch: int64 [3 * grid + 4];
// R, the carried-out mask, the body's last newline (a stream position, or
// -1) and the tail line's verdict land in its last four.  Where rows is
// not null, the rows (int64 [capacity, 2]; those past capacity are not
// written).  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).  All
// pointers are device pointers: text u8 [N], plane u32 [ceil(N / 32)],
// t_off int32 [n_terms + 1] into t_bytes, tr u8 [256], table u32
// [max(1, 2^n_terms / 32)].
int line_terms_launch(const uint8_t* text, long long N, long long body,
                      const uint32_t* plane, int shift,
                      const uint8_t* t_bytes, const int* t_off, int n_terms,
                      const uint8_t* tr, const uint32_t* table,
                      long long carry, long long base, long long begin,
                      long long cap_e, int last, long long* rows,
                      long long capacity, long long* scratch, int grid,
                      void* stream) {
    if (N < 1 || body < 1 || body > N || shift < 0 || n_terms < 1
        || n_terms > kMaxTerms || carry < 0 || carry >> n_terms
        || capacity < 0 || grid < 1)
        return (int)cudaErrorInvalidValue;
    Params p;
    p.text = text;
    p.plane = plane;
    p.t_bytes = t_bytes;
    p.t_off = t_off;
    p.tr = tr;
    p.table = table;
    p.rows = rows;
    p.N = N;
    p.body = body;
    p.base = base;
    p.begin = begin;
    p.cap_e = cap_e;
    p.capacity = rows ? capacity : 0;
    p.shift = shift;
    p.n_terms = n_terms;
    p.carry = (uint32_t)carry;
    p.last = last;
    // each warp an equal run of 32-word steps
    const long long steps = ((body + 31) / 32 + 31) / 32;
    const long long warps = (long long)grid * kWarps;
    p.warp_words = 32 * ((steps + warps - 1) / warps);
    void* args[] = {&p, &scratch};
    cudaError_t err = cudaLaunchCooperativeKernel(
        kernel(rows != nullptr), dim3(grid), dim3(kThreads), args, 0,
        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

const char* line_terms_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
