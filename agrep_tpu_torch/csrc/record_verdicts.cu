// Record verdicts of the bitap engine's event pairs for NVIDIA Hopper
// (sm_90a).
//
// Replaces the host walk that cuts the mask machine's events into records
// (agrep_tpu/runtime/engine.py, BitapEngine.search_stream_chunked's loop
// `for p_m, w in zip(pos_b.tolist(), ev_b.tolist())` and search_stream's
// `for k in range(len(P))`): one Python step a pair, a delimiter pair at
// every line end, where only the few records that hold a hit print.  This
// kernel decides on the card which records fire, and only their rows
// cross to the host.
//
// The function.  Input: the (pos int64, word u32) pairs that event_pairs
// leaves on the card, ascending by position; endpos and d_endpos, the
// machine's hit and delimiter bits; skip_pos, a position whose pair is
// dropped before anything else (the glitch byte, or -1); and_flag and
// invert; acc_in, the OR of the hit bits since the last record end of the
// stream's earlier pairs.  A pair ORs word & endpos into its record's acc;
// a pair with word & d_endpos set ends its record (a pair can be both: its
// hit counts in the record it ends).  A record fires when
//     and_flag:  (acc & endpos) == endpos  ||  invert
//     otherwise: (acc != 0) ^ invert.
// Output: one row (ordinal, end, prev) for each record that fires, in
// stream order: the ordinal of its end among the call's record ends, the
// position of its end, and the position of the record end before it (-1
// where that lies before the call's pairs); and a summary: the record
// ends, the last end's position (-1 without one), the OR of the hit bits
// after it (the next call's acc_in) and the rows.
//
// What bounds it on an H100: bytes.  It reads 12 bytes a pair and writes
// 24 a row that fires, a few integer operations a pair: at config 2's
// 32 MB chunk (685,449 pairs, ~170 rows) about 8.2 MB, 2.5 us at
// 3.35 TB/s, so the launches' fixed cost and the host's read of the
// summary are its time.  The design is the simple one:
//
//   * A run of pairs has a summary (struct Sum) under an associative
//     combine: its record ends, the records among them after the first
//     that fire, its last end, the hit bits up to its first end and those
//     after its last.  A thread folds eight consecutive pairs; a block
//     combines its threads' summaries by a scan in shared memory.
//   * Pass 1 (summarize_kernel): each block writes the summary of its
//     kPairsPerBlock pairs.
//   * Pass 2 (combine_kernel, one block): the exclusive prefix of the
//     block summaries, seeded with acc_in; from it each block knows its
//     incoming acc, ordinal, previous end and rows before it, and the
//     call's summary follows.  The wrapper reads the summary (one
//     32-byte copy) to size the rows.
//   * Pass 3 (write_kernel): each block scans its threads' summaries
//     again from its prefix, and each thread walks its pairs and writes
//     the rows of its records that fire.
//
// Built by ops/_cuda.py as one object with a plain C interface:
// nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
// -fPIC.

#include <cstdint>
#include <cuda_runtime.h>

namespace record_verdicts {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kPairsPerBlock = kThreads * kPerThread;

struct Params {
    const long long* pos;           // [K]
    const uint32_t* word;           // [K]
    long long K;
    long long skip_pos;
    uint32_t endpos, d_endpos, acc_in;
    int and_flag, invert;
};

// The summary of a run of pairs.
struct Sum {
    long long n;          // record ends
    long long fired;      // records that fire, among the ends after the first
    long long last;       // position of the last end; -1 without one
    uint32_t head;        // hit bits up to and including the first end
                          // (all of the run's without an end)
    uint32_t tail;        // hit bits after the last end (all without one)
};
static_assert(sizeof(Sum) == 32, "the wrapper allocates 32 bytes a Sum");

namespace {

__device__ __forceinline__ Sum identity() {
    Sum s;
    s.n = 0;
    s.fired = 0;
    s.last = -1;
    s.head = 0;
    s.tail = 0;
    return s;
}

__device__ __forceinline__ bool fires(const Params& p, uint32_t acc) {
    return p.and_flag ? ((acc & p.endpos) == p.endpos) || p.invert
                      : (acc != 0) != (p.invert != 0);
}

// The summary of run a followed by run b.
__device__ __forceinline__ Sum combine(const Params& p, const Sum& a,
                                       const Sum& b) {
    Sum r;
    r.n = a.n + b.n;
    // b's first end closes a record that began in a
    r.fired = a.fired + b.fired
              + ((a.n && b.n && fires(p, a.tail | b.head)) ? 1 : 0);
    r.last = b.n ? b.last : a.last;
    r.head = a.n ? a.head : (a.head | b.head);
    r.tail = b.n ? b.tail : (a.tail | b.tail);
    return r;
}

// Rows before the end of a run whose summary is s, seeded with acc_in:
// its first record's verdict reads the seeded head.
__device__ __forceinline__ long long rows_of(const Params& p, const Sum& s) {
    return s.fired + ((s.n && fires(p, s.head)) ? 1 : 0);
}

// The summary of this thread's pairs [i0, min(i0 + kPerThread, K)).
__device__ Sum fold(const Params& p, long long i0) {
    Sum s = identity();
    const long long i1 = min(i0 + kPerThread, p.K);
    for (long long i = i0; i < i1; ++i) {
        const long long q = __ldg(p.pos + i);
        if (q == p.skip_pos) continue;
        const uint32_t w = __ldg(p.word + i);
        Sum x;
        x.fired = 0;
        x.head = w & p.endpos;
        if (w & p.d_endpos) {
            x.n = 1;
            x.last = q;
            x.tail = 0;
        } else {
            x.n = 0;
            x.last = -1;
            x.tail = x.head;
        }
        s = combine(p, s, x);
    }
    return s;
}

// Exclusive scan of the block's thread summaries, seeded: returns
// seed + the summaries of the threads before this one, and sets *total
// to seed + all of them (every thread).  buf holds 2 * kThreads Sums.
__device__ Sum block_scan(const Params& p, Sum x, const Sum& seed, Sum* buf,
                          Sum* total) {
    const int t = threadIdx.x;
    int in = 0;
    buf[t] = x;
    __syncthreads();
    for (int o = 1; o < kThreads; o <<= 1) {
        Sum v = buf[in * kThreads + t];
        if (t >= o) v = combine(p, buf[in * kThreads + t - o], v);
        buf[(1 - in) * kThreads + t] = v;
        in = 1 - in;
        __syncthreads();
    }
    const Sum before = t ? buf[in * kThreads + t - 1] : identity();
    *total = combine(p, seed, buf[in * kThreads + kThreads - 1]);
    const Sum r = combine(p, seed, before);
    __syncthreads();                    // buf is rewritten by the next scan
    return r;
}

__global__ void __launch_bounds__(kThreads)
summarize_kernel(Params p, Sum* __restrict__ sums) {
    __shared__ Sum buf[2 * kThreads];
    const long long i0 = (long long)blockIdx.x * kPairsPerBlock
                         + (long long)threadIdx.x * kPerThread;
    Sum total;
    block_scan(p, fold(p, i0), identity(), buf, &total);
    if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// One block: pre[b] = acc_in's seed + sums[0 .. b); summary = {record
// ends, last end, acc after it, rows}.
__global__ void __launch_bounds__(kThreads)
combine_kernel(Params p, const Sum* __restrict__ sums, Sum* __restrict__ pre,
               long long* __restrict__ summary, int grid) {
    __shared__ Sum buf[2 * kThreads];
    const int per = (grid + kThreads - 1) / kThreads;
    const int b0 = min(grid, (int)threadIdx.x * per);
    const int b1 = min(grid, b0 + per);
    Sum agg = identity();
    for (int b = b0; b < b1; ++b) agg = combine(p, agg, sums[b]);
    Sum seed = identity();
    seed.head = seed.tail = p.acc_in & p.endpos;
    Sum total;
    Sum run = block_scan(p, agg, seed, buf, &total);
    for (int b = b0; b < b1; ++b) {
        pre[b] = run;
        run = combine(p, run, sums[b]);
    }
    if (threadIdx.x == 0) {
        summary[0] = total.n;
        summary[1] = total.last;
        summary[2] = total.tail;
        summary[3] = rows_of(p, total);
    }
}

__global__ void __launch_bounds__(kThreads)
write_kernel(Params p, const Sum* __restrict__ pre,
             long long* __restrict__ rows) {
    __shared__ Sum buf[2 * kThreads];
    const long long i0 = (long long)blockIdx.x * kPairsPerBlock
                         + (long long)threadIdx.x * kPerThread;
    Sum total;
    const Sum s = block_scan(p, fold(p, i0), pre[blockIdx.x], buf, &total);
    long long ord = s.n, prev = s.last, out = rows_of(p, s);
    uint32_t acc = s.tail;
    const long long i1 = min(i0 + kPerThread, p.K);
    for (long long i = i0; i < i1; ++i) {
        const long long q = __ldg(p.pos + i);
        if (q == p.skip_pos) continue;
        const uint32_t w = __ldg(p.word + i);
        acc |= w & p.endpos;
        if (!(w & p.d_endpos)) continue;
        if (fires(p, acc)) {
            rows[3 * out] = ord;
            rows[3 * out + 1] = q;
            rows[3 * out + 2] = prev;
            ++out;
        }
        ++ord;
        prev = q;
        acc = 0;
    }
}

// The Params of a call, or false for arguments the kernels do not take.
bool make_params(const long long* pos, const uint32_t* word, long long K,
                 uint32_t endpos, uint32_t d_endpos, long long skip_pos,
                 int and_flag, int invert, uint32_t acc_in, int grid,
                 Params* p) {
    if (K < 1 || grid != (K + kPairsPerBlock - 1) / kPairsPerBlock)
        return false;
    p->pos = pos;
    p->word = word;
    p->K = K;
    p->skip_pos = skip_pos;
    p->endpos = endpos;
    p->d_endpos = d_endpos;
    p->acc_in = acc_in;
    p->and_flag = and_flag != 0;
    p->invert = invert != 0;
    return true;
}

}  // namespace
}  // namespace record_verdicts

using namespace record_verdicts;

extern "C" {

// Threads a block, pairs a block and bytes of a block summary.
int record_verdicts_geometry(int* threads, int* pairs_per_block,
                             int* sum_bytes) {
    *threads = kThreads;
    *pairs_per_block = kPairsPerBlock;
    *sum_bytes = (int)sizeof(Sum);
    return 0;
}

// Pass 1 on `stream`: the summary of each block's pairs into sums
// (sum_bytes each), with grid = ceil(K / pairs_per_block).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernels do not take).  All pointers are device pointers:
// pos int64 [K], word u32 [K].
int record_verdicts_summarize(const long long* pos, const uint32_t* word,
                              long long K, uint32_t endpos,
                              uint32_t d_endpos, long long skip_pos,
                              int and_flag, int invert, uint32_t acc_in,
                              void* sums, int grid, void* stream) {
    Params p;
    if (!make_params(pos, word, K, endpos, d_endpos, skip_pos, and_flag,
                     invert, acc_in, grid, &p))
        return (int)cudaErrorInvalidValue;
    summarize_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        p, static_cast<Sum*>(sums));
    return (int)cudaGetLastError();
}

// Pass 2 on `stream`, one block, the same arguments: each block's
// incoming prefix into pre (sum_bytes each), and summary int64 [4] =
// {record ends, last end or -1, acc after it, rows}.
int record_verdicts_combine(const long long* pos, const uint32_t* word,
                            long long K, uint32_t endpos, uint32_t d_endpos,
                            long long skip_pos, int and_flag, int invert,
                            uint32_t acc_in, const void* sums, void* pre,
                            long long* summary, int grid, void* stream) {
    Params p;
    if (!make_params(pos, word, K, endpos, d_endpos, skip_pos, and_flag,
                     invert, acc_in, grid, &p))
        return (int)cudaErrorInvalidValue;
    combine_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        p, static_cast<const Sum*>(sums), static_cast<Sum*>(pre), summary,
        grid);
    return (int)cudaGetLastError();
}

// Pass 3 on `stream`, the same arguments and grid as pass 1: the rows
// into rows int64 [R, 3], R = summary[3], from pass 2's prefixes.
int record_verdicts_write(const long long* pos, const uint32_t* word,
                          long long K, uint32_t endpos, uint32_t d_endpos,
                          long long skip_pos, int and_flag, int invert,
                          uint32_t acc_in, const void* pre, long long* rows,
                          int grid, void* stream) {
    Params p;
    if (!make_params(pos, word, K, endpos, d_endpos, skip_pos, and_flag,
                     invert, acc_in, grid, &p))
        return (int)cudaErrorInvalidValue;
    write_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        p, static_cast<const Sum*>(pre), rows);
    return (int)cudaGetLastError();
}

const char* record_verdicts_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
