// Record verdicts of the bitap engine, cut from mask_scan's planes, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the host walk that cuts the mask machine's events into records
// (agrep_tpu/runtime/engine.py, BitapEngine.search_stream_chunked's loop
// `for p_m, w in zip(pos_b.tolist(), ev_b.tolist())` (:109) and
// search_stream's `for k in range(len(P))` (:396)): one Python step a
// event, a delimiter event at every line end, where only the few records
// that hold a hit print.  This kernel decides on the card, from the
// planes themselves, which records fire, and only their rows cross to the
// host.
//
// The function.  Input: mask_scan's planes and their values, keep_from
// (plane_words.cuh), as event_pairs takes them: its pairs are the events
// this function cuts, though it never writes one.  endpos and d_endpos,
// the machine's hit and delimiter bits; skip_pos, a position whose event
// is dropped whole before anything else, its hit and its end (the glitch
// byte, or -1); and_flag and invert; acc_in, the OR of the hit bits since
// the last record end of the stream's earlier events.  An event ORs word
// & endpos into its record's acc; an event with word & d_endpos set ends
// its record (an event can be both: its hit counts in the record it
// ends).  A record fires when
//     and_flag:  (acc & endpos) == endpos  ||  invert
//     otherwise: (acc != 0) ^ invert.
// Output: one row (ordinal, end, prev) for each record that fires, in
// stream order: the ordinal of its end among the call's record ends, the
// position of its end, and the position of the record end before it (-1
// where that lies before the call's positions); and a summary: the record
// ends, the last end's position (-1 without one), the OR of the hit bits
// after it (the next call's acc_in), the rows, and the events (the pairs
// event_pairs would give, the skipped one included).
//
// What bounds it on an H100: bytes.  It must read the body words of the
// planes whose value meets endpos | d_endpos and write 24 bytes a row
// that fires: at config 2's 32 MB chunk about 4.3 MB of plane words and
// ~230 rows, 1.3 us at 3.35 TB/s.  Cutting event_pairs' pairs instead
// would write and read 8.2 MB more there, behind a second launch and the
// host's read of K; so this reads the planes itself (once from device
// memory, again from L2), in one launch:
//
//   * A run of positions has a summary (struct Sum) under an associative
//     combine: its record ends, the records among them after the first
//     that fire, its last end, the hit bits up to its first end and those
//     after its last.  A lane folds a whole 32-position stream word into
//     a Sum with bit arithmetic: e, the OR of the bits of the planes whose
//     value meets d_endpos (kept-masked, skip_pos's bit cleared), gives
//     the ends (popc), the last (clz), the head (the hits at the bits of
//     e ^ (e - 1)) and the tail (the hits above the highest end); a short
//     loop over the ends after the first gives `fired`.  A hit of a bit
//     range is the OR of val & endpos over the planes whose bits meet it.
//   * The grid is persistent and cooperative (as event_pairs.cu's: every
//     block resident, a grid-wide barrier in place of a second launch and
//     the host's read), each warp a run of stream words, a lane R
//     consecutive words a step, their plane bits in registers
//     (plane_words.cuh).  Inside a warp's run a Sum fits 32 bits (struct
//     Local: positions from the run's first).  Phase 1: each lane folds
//     its R words, the warp its lanes' (shuffles, in lane order) a step;
//     the block combines its warps' and writes its Sum.  Grid sync.
//     Phase 2: each block combines the Sums of the blocks before it,
//     seeded with acc_in (its threads fold slices, then shuffles), warp 0
//     scans its warps', and each warp walks its steps again: a step's
//     exclusive scan by shuffles of its lanes' summaries (kept in shared
//     memory by phase 1) gives each lane its incoming acc, ordinal,
//     previous end and rows, and a lane whose words end a record that
//     fires (few: ~230 of a 32 MB chunk's 1 M words at config 2) reloads
//     them from L2 and writes those rows.  The last block writes the
//     summary.
//   * Rows capacity: the wrapper allocates the rows before the launch (see
//     ops/kernels.py rows_capacity: twice the stream's previous chunk's
//     rows, at least 1,024; on a first chunk one row a 1,024 bytes, at
//     least 1,024); the kernel writes no row at or past it, always
//     reports the true count, and the wrapper launches again with the
//     exact count only where it exceeds the capacity.
//
// Built by ops/_cuda.py as one object with a plain C interface:
// nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
// -fPIC.  The grid sync needs no -rdc with CUDA 12.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "plane_words.cuh"

namespace record_verdicts {

using namespace plane_words;
namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// Steps whose lane summaries phase 1 keeps in shared memory for phase 2
// (a lane whose words end no row that fires loads nothing there).
constexpr int kKeptSteps = 8;

struct Params {
    Planes pl;
    long long skip_pos;
    long long cap;                  // rows the output holds
    uint32_t endpos, d_endpos, acc_in;
    int and_flag, invert;
};

// The summary of a run of positions.
struct Sum {
    long long n;          // record ends
    long long fired;      // records that fire, among the ends after the first
    long long last;       // position of the last end; -1 without one
    uint32_t head;        // hit bits up to and including the first end
                          // (all of the run's without an end)
    uint32_t tail;        // hit bits after the last end (all without one)
};
static_assert(sizeof(Sum) == 32, "the wrapper allocates 32 bytes a Sum");

// A Sum inside one warp's run: last counts from the run's first position.
struct Local {
    int n, fired, last;
    uint32_t head, tail;
};
constexpr size_t kShared = sizeof(Local) * kKeptSteps * kThreads;

namespace {

__device__ __forceinline__ bool fires(const Params& p, uint32_t acc) {
    return p.and_flag ? ((acc & p.endpos) == p.endpos) || p.invert
                      : (acc != 0) != (p.invert != 0);
}

template <class S>
__device__ __forceinline__ S identity() {
    S s;
    s.n = 0;
    s.fired = 0;
    s.last = -1;
    s.head = 0;
    s.tail = 0;
    return s;
}

// The summary of run a followed by run b.
template <class S>
__device__ __forceinline__ S combine(const Params& p, const S& a,
                                     const S& b) {
    S r;
    r.n = a.n + b.n;
    // b's first end closes a record that began in a
    r.fired = a.fired + b.fired
              + ((a.n && b.n && fires(p, a.tail | b.head)) ? 1 : 0);
    r.last = b.n ? b.last : a.last;
    r.head = a.n ? a.head : (a.head | b.head);
    r.tail = b.n ? b.tail : (a.tail | b.tail);
    return r;
}

// A Local of a run whose first position is p0, as a Sum.
__device__ __forceinline__ Sum widen(const Local& l, long long p0) {
    Sum s;
    s.n = l.n;
    s.fired = l.fired;
    s.last = l.last < 0 ? -1 : p0 + l.last;
    s.head = l.head;
    s.tail = l.tail;
    return s;
}

// Rows before the end of a run whose summary is s, seeded with acc_in:
// its first record's verdict reads the seeded head.
__device__ __forceinline__ long long rows_of(const Params& p, const Sum& s) {
    return s.fired + ((s.n && fires(p, s.head)) ? 1 : 0);
}

// A shuffle of every field of a Sum or a Local (how: 0 from lane d, 1
// down by d, 2 up by d).
template <int kHow, class T>
__device__ __forceinline__ T shfl1(T v, int d) {
    if constexpr (kHow == 0) return __shfl_sync(0xffffffffu, v, d);
    if constexpr (kHow == 1) return __shfl_down_sync(0xffffffffu, v, d);
    return __shfl_up_sync(0xffffffffu, v, d);
}

template <int kHow, class S>
__device__ __forceinline__ S shfl(const S& s, int d) {
    S r;
    r.n = shfl1<kHow>(s.n, d);
    r.fired = shfl1<kHow>(s.fired, d);
    r.last = shfl1<kHow>(s.last, d);
    r.head = shfl1<kHow>(s.head, d);
    r.tail = shfl1<kHow>(s.tail, d);
    return r;
}

// The lanes' summaries combined in lane order, in lane 0.
template <class S>
__device__ __forceinline__ S warp_fold(const Params& p, S x) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const S y = shfl<1>(x, d);
        if (lane + d < 32) x = combine(p, x, y);
    }
    return x;
}

// The lanes' summaries combined in lane order up to each lane.
template <class S>
__device__ __forceinline__ S warp_scan(const Params& p, S x) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const S y = shfl<2>(x, d);
        if (lane >= d) x = combine(p, y, x);
    }
    return x;
}

// Bits 0 .. b (b in -1 .. 31).
__device__ __forceinline__ uint32_t upto(int b) {
    return b < 0 ? 0u : (2u << b) - 1u;
}

// A lane's R words of a step: each active plane's kept bits with
// skip_pos's cleared, the events (skip_pos's counted), each word's ends
// and whether it holds a hit.
template <int MAXP, int R>
struct Words {
    uint32_t bits[MAXP][R];
    uint32_t e[R];
    uint32_t hit;         // bit i: word i holds a hit
    int events;

    __device__ __forceinline__ void load(const Params& p, const Active& a,
                                         long long g) {
        load_words<MAXP, R>(p.pl, a, g, bits);
        events = 0;
        hit = 0;
        const long long off0 = p.skip_pos - 32 * g;
        const bool skips = off0 >= 0 && off0 < 32 * R;
#pragma unroll
        for (int i = 0; i < R; ++i) {
            const long long off = off0 - 32 * i;
            const uint32_t keep = (skips && off >= 0 && off < 32)
                                  ? ~(1u << (int)off) : 0xffffffffu;
            uint32_t any = 0, ends = 0, hits = 0;
#pragma unroll
            for (int q = 0; q < MAXP; ++q) {
                any |= bits[q][i];
                bits[q][i] &= keep;
                if (a.val[q] & p.d_endpos) ends |= bits[q][i];
                if (a.val[q] & p.endpos) hits |= bits[q][i];
            }
            events += __popc(any);
            e[i] = ends;
            hit |= (hits != 0) << i;
        }
    }

    // The hit bits of word i's positions in mask: val & endpos of every
    // plane whose bits meet it.
    __device__ __forceinline__ uint32_t hits(const Params& p,
                                             const Active& a, int i,
                                             uint32_t mask) const {
        uint32_t h = 0;
#pragma unroll
        for (int q = 0; q < MAXP; ++q)
            if (bits[q][i] & mask) h |= a.val[q];
        return h & p.endpos;
    }

    // The Local of the words, the first at position p0 of the run.
    __device__ __forceinline__ Local fold(const Params& p, const Active& a,
                                          int p0) const {
        Local s = identity<Local>();
        if (!hit) {
            // no hit in any word: every record that ends here holds none
#pragma unroll
            for (int i = 0; i < R; ++i) {
                s.n += __popc(e[i]);
                if (e[i]) s.last = p0 + 32 * i + 31 - __clz(e[i]);
            }
            s.fired = s.n ? (s.n - 1) * fires(p, 0u) : 0;
            return s;
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
            const uint32_t ev = e[i];
            Local w = identity<Local>();
            if (!(hit >> i & 1)) {
                // no hit: every record that ends here holds none
                if (ev) {
                    w.n = __popc(ev);
                    w.last = p0 + 32 * i + 31 - __clz(ev);
                    w.fired = (w.n - 1) * fires(p, 0u);
                }
            } else if (!ev) {
                w.head = w.tail = hits(p, a, i, 0xffffffffu);
            } else {
                const int hi = 31 - __clz(ev);
                w.n = __popc(ev);
                w.last = p0 + 32 * i + hi;
                w.head = hits(p, a, i, ev ^ (ev - 1));
                w.tail = hits(p, a, i, ~upto(hi));
                int prev = __ffs(ev) - 1;
                for (uint32_t m = ev & (ev - 1); m; m &= m - 1) {
                    const int b = __ffs(m) - 1;
                    w.fired += fires(p, hits(p, a, i,
                                             upto(b) & ~upto(prev)));
                    prev = b;
                }
            }
            s = combine(p, s, w);
        }
        return s;
    }
};

// scratch: gridDim.x Sums (4 int64 each), gridDim.x int64 event counts,
// then the summary int64 [5] = {record ends, last end or -1, acc after
// it, rows, events}.
template <int MAXP, int R>
__global__ void __launch_bounds__(kThreads)
records_kernel(Params p, long long* __restrict__ scratch,
               long long* __restrict__ rows) {
    extern __shared__ Local s_loc[];                // [kKeptSteps][kThreads]
    __shared__ Active a;
    __shared__ Local s_warp[kWarps];
    __shared__ Sum s_part[kWarps];
    __shared__ long long s_events[kWarps];
    __shared__ Sum s_pre[kWarps];
    load_active(p.pl, a);
    Sum* sums = reinterpret_cast<Sum*>(scratch);
    long long* events = scratch + 4 * (long long)gridDim.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long g0 = run_start(p.pl, kWarps, warp);
    const int steps = run_steps(p.pl, g0, 32 * R);
    Words<MAXP, R> w;

    // phase 1: this block's Sum and events
    Local run = identity<Local>();
    long long ev = 0;
    for (int s = 0; s < steps; ++s) {
        const int at = s * 32 * R + lane * R;          // words into the run
        w.load(p, a, g0 + at);
        ev += w.events;
        const Local x = w.fold(p, a, 32 * at);
        if (s < kKeptSteps) s_loc[s * kThreads + threadIdx.x] = x;
        run = combine(p, run, shfl<0>(warp_fold(p, x), 0));
    }
    ev = warp_sum(ev);
    if (lane == 0) {
        s_warp[warp] = run;
        s_events[warp] = ev;
    }
    __syncthreads();
    if (warp == 0) {
        Sum x = identity<Sum>();
        long long n = 0;
        if (lane < kWarps) {
            x = widen(s_warp[lane], 32 * run_start(p.pl, kWarps, lane));
            n = s_events[lane];
        }
        x = warp_fold(p, x);
        n = warp_sum(n);
        if (lane == 0) {
            sums[blockIdx.x] = x;
            events[blockIdx.x] = n;
        }
    }
    cg::this_grid().sync();

    // phase 2: the Sum of the blocks before this one, each thread a slice
    const int before = blockIdx.x;
    const int per = (before + kThreads - 1) / kThreads;
    const int b0 = min(before, (int)threadIdx.x * per);
    const int b1 = min(before, b0 + per);
    Sum agg = identity<Sum>();
    long long nev = 0;
    for (int b = b0; b < b1; ++b) {
        Sum x;
        const long long* q = scratch + 4 * (long long)b;
        x.n = __ldcg(q);
        x.fired = __ldcg(q + 1);
        x.last = __ldcg(q + 2);
        const unsigned long long ht = __ldcg(
            reinterpret_cast<const unsigned long long*>(q + 3));
        x.head = (uint32_t)ht;
        x.tail = (uint32_t)(ht >> 32);
        agg = combine(p, agg, x);
        nev += __ldcg(events + b);
    }
    agg = warp_fold(p, agg);
    nev = warp_sum(nev);
    if (lane == 0) {
        s_part[warp] = agg;
        s_events[warp] += nev;      // this warp's events and a slice's
    }
    __syncthreads();
    if (warp == 0) {
        Sum pre = identity<Sum>();
        pre.head = pre.tail = p.acc_in & p.endpos;
        pre = combine(p, pre, shfl<0>(warp_fold(
            p, lane < kWarps ? s_part[lane] : identity<Sum>()), 0));
        const Sum x = lane < kWarps
            ? widen(s_warp[lane], 32 * run_start(p.pl, kWarps, lane))
            : identity<Sum>();
        const Sum inc = warp_scan(p, x);
        const Sum ex = shfl<2>(inc, 1);
        if (lane < kWarps)
            s_pre[lane] = combine(p, pre, lane ? ex : identity<Sum>());
        const long long n = warp_sum(lane < kWarps ? s_events[lane] : 0);
        const Sum t = combine(p, pre, shfl<0>(inc, kWarps - 1));
        if (lane == 0 && blockIdx.x == gridDim.x - 1) {
            long long* summary = events + gridDim.x;
            summary[0] = t.n;
            summary[1] = t.last;
            summary[2] = t.tail;
            summary[3] = rows_of(p, t);
            summary[4] = n;
        }
    }
    __syncthreads();

    // each lane's words again, from the summary of the words before them
    Sum pre = s_pre[warp];
    const long long p0 = 32 * g0;
    for (int s = 0; s < steps; ++s) {
        const int at = s * 32 * R + lane * R;
        const long long g = g0 + at;
        const bool kept_sum = s < kKeptSteps;
        if (!kept_sum) w.load(p, a, g);
        const Local x = kept_sum ? s_loc[s * kThreads + threadIdx.x]
                                 : w.fold(p, a, 32 * at);
        const Local inc = warp_scan(p, x);
        const Local ex = shfl<2>(inc, 1);
        const Sum in = combine(p, pre, widen(lane ? ex : identity<Local>(),
                                             p0));
        pre = combine(p, pre, widen(shfl<0>(inc, 31), p0));
        long long ord = in.n, prev = in.last, out = rows_of(p, in);
        // no row ends in this lane's words: nothing to walk
        if (rows_of(p, combine(p, in, widen(x, p0))) == out) continue;
        if (kept_sum) w.load(p, a, g);
        uint32_t acc = in.tail;
#pragma unroll
        for (int i = 0; i < R; ++i) {
            int lo = -1;
            for (uint32_t m = w.e[i]; m; m &= m - 1) {
                const int b = __ffs(m) - 1;
                acc |= w.hits(p, a, i, upto(b) & ~upto(lo));
                const long long end = 32 * (g + i) + b;
                if (fires(p, acc)) {
                    if (out < p.cap) {
                        rows[3 * out] = ord;
                        rows[3 * out + 1] = end;
                        rows[3 * out + 2] = prev;
                    }
                    ++out;
                }
                ++ord;
                prev = end;
                acc = 0;
                lo = b;
            }
            acc |= w.hits(p, a, i, ~upto(lo));
        }
    }
}

// The instantiation of a launch over n_planes planes: its kernel and
// the words a lane takes a step.
struct Form {
    const void* kernel;
    int r;
};

Form form(int n_planes) {
    if (n_planes <= 2)
        return {reinterpret_cast<const void*>(records_kernel<2, 8>), 8};
    if (n_planes <= 4)
        return {reinterpret_cast<const void*>(records_kernel<4, 8>), 8};
    return {reinterpret_cast<const void*>(records_kernel<kMaxPlanes, 1>),
            1};
}

}  // namespace
}  // namespace record_verdicts

using namespace record_verdicts;

extern "C" {

// Threads a block, the blocks of a launch over n_planes planes that the
// current device holds at once (the most a cooperative launch takes),
// the stream words of a warp's step and the bytes of a block's Sum.
// Returns a cudaError_t.
int record_verdicts_geometry(int n_planes, int* threads, int* max_blocks,
                             int* step_words, int* sum_bytes) {
    if (n_planes < 1 || n_planes > kMaxPlanes)
        return (int)cudaErrorInvalidValue;
    const Form f = form(n_planes);
    *threads = kThreads;
    *step_words = 32 * f.r;
    *sum_bytes = (int)sizeof(Sum);
    return resident_blocks(f.kernel, kThreads, kShared, max_blocks);
}

// One cooperative launch on `stream`, with event_pairs_launch's planes,
// geometry and grid rules (step_words from record_verdicts_geometry):
// the rows [0, min(R, cap)) into rows int64 [cap, 3], and the summary
// (record ends, last end or -1, acc after it, R, events) into
// scratch[5 * grid .. 5 * grid + 5) (scratch int64 [5 * grid + 5]).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take).  All pointers are device
// pointers.
int record_verdicts_launch(const uint32_t* planes, int n_planes,
                           long long T, int n_words, const uint32_t* vals,
                           int W, int L, long long n, long long keep_from,
                           uint32_t endpos, uint32_t d_endpos,
                           long long skip_pos, int and_flag, int invert,
                           uint32_t acc_in, long long* rows, long long cap,
                           long long* scratch, int grid,
                           long long warp_words, void* stream) {
    Params p;
    if (n_planes < 1 || n_planes > kMaxPlanes)
        return (int)cudaErrorInvalidValue;
    const Form f = form(n_planes);
    if (!make_planes(planes, n_planes, T, n_words, vals, W, L, n, keep_from,
                     grid, warp_words, kWarps, 32 * f.r, &p.pl) || cap < 0)
        return (int)cudaErrorInvalidValue;
    p.skip_pos = skip_pos;
    p.cap = cap;
    p.endpos = endpos;
    p.d_endpos = d_endpos;
    p.acc_in = acc_in;
    p.and_flag = and_flag != 0;
    p.invert = invert != 0;
    void* args[] = {&p, &scratch, &rows};
    cudaError_t err = allow_shared(f.kernel, kShared);
    if (err != cudaSuccess) return (int)err;
    err = cudaLaunchCooperativeKernel(f.kernel, dim3(grid), dim3(kThreads),
                                      args, kShared,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

const char* record_verdicts_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
