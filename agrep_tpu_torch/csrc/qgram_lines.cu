// The q-gram route's matching lines, for NVIDIA Hopper (sm_90a).
//
// Replaces the host work of the multi-pattern route past the chain
// kernel's caps: agrep_tpu/runtime/mgrep.py::_first_match_occurrences
// (:967; the native qgram_first_per_line, :904 for a count) and the
// port's device branch of it, which read qgram_filter's candidate
// positions back (about 38 M per 100 MB, as int64), verified them on the
// host and built the stream's newline index there.  Here the candidate
// plane stays on the card: a count crosses as one number, a print as one
// row a matching line.
//
// The function.  Input: the text b, u8 [n]; qgram_filter's candidate
// plane, u32 [ceil(n / 32)] (bit r of word w: position 32 w + r); the
// q-gram tables of compile/multi.py: the member set of the gram hashes as
// a 32768-bit set (bit h & 31 of word h >> 5), hash_id (hash -> bucket),
// the bucket CSR b_off/b_tids (term ids ascending), the term CSR
// t_off/t_bytes, the fold tr u8 [256]; p (p_size), long_ and wordbound.
// At each set bit a >= p - 1 of the plane (a < n) the winner is
// agrep_host.cpp::qgram_first_win's: the gram hash
//     h = (b[a] & 31) << 5 | (b[a-1] & 31),  LONG: (h << 5 | (b[a-2] & 31))
// must be a member; then the first term of bucket hash_id[h], from the
// highest term id down, with s = a - (p - 1), s + L <= n,
// tr[b[s + k]] == tr[t[k]] for k < L and, under -w, neither b[s + L]
// (0 past the end) nor b[s - 1] (0 before the start) ASCII alphanumeric.
// Anchor a lies in line (newlines at positions <= a).  Output: the number
// of lines that hold an anchor with a winner (qgram_first_per_line's
// count_only total) and, for a print, one row (anchor, term id) a such
// line, its first anchor with a winner, in stream order (the pairs
// qgram_first_per_line returns: the route's terms hold no newline, so a
// match lies inside one line).
//
// Why CUDA and not Triton: the winner is a per-candidate walk of a
// variable-length bucket and a byte compare of variable-length terms,
// and the lines are a segmented fold by newline across the whole text;
// Triton's block-wide tensors have neither the data-dependent loops nor
// the warp shuffles that carry the fold.
//
// What bounds it on an H100: bytes.  It must read the text and the plane
// once (n + n / 8 bytes: 0.035 ms per 100 MB at 3.35 TB/s) and write 16
// bytes a row.  About 38 % of the positions pass the plane and about
// 0.15 % the exact member test, so the bucket walks are rare.  The design
// is the simple one, after record_verdicts.cu and line_rows.cu:
//
//   * A thread owns one 32-position plane word a round (kRounds rounds, a
//     block's words in round-major order, so a warp's loads are
//     coalesced).  It loads the word's 32 text bytes (text_word32: any
//     alignment) and the two bytes before them (the neighbouring lane's,
//     by shuffle), computes the exact member test of all 32 positions
//     from the member bit set in shared memory, ANDs it with the plane
//     word and the valid positions, and runs the bucket walk at each bit
//     left: a winner mask and a newline mask of the word.
//   * A word, and any run of words, folds into a summary: whether it
//     holds a newline; whether its head (the positions before its first
//     newline) holds a winner; whether its tail (from its last newline
//     on) does; and the number of whole lines inside it that do.  The
//     fold is associative, so warps fold by shuffles, blocks by their
//     warps' summaries in shared memory.
//   * Pass 1 (sums_kernel): each block's summary.
//   * Pass 2 (scan_kernel, one block): the exclusive prefix of the block
//     summaries, each thread folding a run of blocks; the prefix of the
//     whole text gives the count, which the wrapper reads: a count stops
//     here.  The count of lines whose first winner lies in a prefix is
//     its head + its whole lines + its tail.
//   * Pass 3 (rows_kernel, print form): each block that holds a row folds
//     its words again from its prefix; each thread then knows whether
//     its first line already has a winner and where its first row goes,
//     walks its newlines and winners in order and writes its rows.
//
// Built by ops/_cuda.py as one object with a plain C interface:
// nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
// -fPIC.

#include <cstdint>
#include <cuda_runtime.h>

#include "text_piece.cuh"

namespace qgram_lines {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;
constexpr int kWordsPerBlock = kThreads * kRounds;
constexpr int kScanThreads = 1024;
constexpr int kMemberWords = 1024;      // 32768 hashes

struct Params {
    const uint8_t* text;
    long long n;
    const uint32_t* plane;              // [ceil(n / 32)]
    long long n_words;
    const uint32_t* member;             // [kMemberWords]
    const int* hash_id;                 // [32768]
    const long long* b_off;             // [buckets + 1]
    const long long* b_tids;
    const uint8_t* t_bytes;
    const long long* t_off;             // [terms + 1]
    const uint8_t* tr;                  // [256]
    long long p;
    int long_, wordbound;
};

// A run's summary: bit 0 a newline in it, bit 1 a winner in its head
// (before its first newline; the whole run when it has none), bit 2 a
// winner in its tail (from its last newline on); mid, the whole lines in
// it that hold a winner.
constexpr int kNl = 1, kHead = 2, kTail = 4;

template <typename M>
struct Sum {
    int f;
    M mid;
};

// The summary of run x followed by run y.
template <typename M>
__device__ __forceinline__ Sum<M> combine(Sum<M> x, Sum<M> y) {
    if (!(x.f & kNl))
        return {(y.f & kNl) | ((x.f | y.f) & kHead) | (y.f & kTail),
                (y.f & kNl) ? y.mid : M(0)};
    if (!(y.f & kNl))
        return {kNl | (x.f & kHead) | ((x.f & kTail) || (y.f & kHead)
                                       ? kTail : 0), x.mid};
    return {kNl | (x.f & kHead) | (y.f & kTail),
            x.mid + y.mid + M((x.f & kTail) || (y.f & kHead))};
}

// Of a prefix of the text: the lines whose first winner lies in it, and
// whether the line still open at its end holds a winner.
__device__ __forceinline__ long long rows_of(Sum<long long> s) {
    return ((s.f >> 1) & 1) + s.mid + ((s.f & kNl) && (s.f & kTail));
}

__device__ __forceinline__ bool open_won(Sum<long long> s) {
    return (s.f & kNl) ? (s.f & kTail) != 0 : (s.f & kHead) != 0;
}

template <typename M>
__device__ __forceinline__ Sum<M> shfl_down(Sum<M> s, int o) {
    return {__shfl_down_sync(0xffffffffu, s.f, o),
            __shfl_down_sync(0xffffffffu, s.mid, o)};
}

template <typename M>
__device__ __forceinline__ Sum<M> shfl_up(Sum<M> s, int o) {
    return {__shfl_up_sync(0xffffffffu, s.f, o),
            __shfl_up_sync(0xffffffffu, s.mid, o)};
}

// The summary of one word from its newline and winner masks.
__device__ __forceinline__ Sum<int> word_sum(uint32_t nl, uint32_t win) {
    if (!nl) return {win ? kHead : 0, 0};
    const int first = __ffs(nl) - 1, last = 31 - __clz(nl);
    Sum<int> s = {kNl | ((win & ((1u << first) - 1u)) ? kHead : 0)
                  | ((win >> last) ? kTail : 0), 0};
    if (win) {
        int prev = first;
        for (uint32_t rest = nl & (nl - 1u); rest; rest &= rest - 1u) {
            const int q = __ffs(rest) - 1;
            s.mid += (win & ((1u << q) - 1u) & ~((1u << prev) - 1u)) != 0;
            prev = q;
        }
    }
    return s;
}

__device__ __forceinline__ bool is_alnum(uint32_t c) {
    return (c - '0' < 10u) || ((c | 0x20u) - 'a' < 26u);
}

// The winning term at anchor a (its gram hash a member), or -1.
__device__ int winner(const Params& P, const uint8_t* s_tr, long long a,
                      uint32_t h) {
    const long long s = a - (P.p - 1);
    const int bk = P.hash_id[h];
    const long long lo = P.b_off[bk];
    for (long long j = P.b_off[bk + 1] - 1; j >= lo; --j) {
        const long long tid = P.b_tids[j];
        const long long o = P.t_off[tid], L = P.t_off[tid + 1] - o;
        if (s + L > P.n) continue;
        long long k = 0;
        while (k < L && s_tr[__ldg(P.text + s + k)]
                            == s_tr[__ldg(P.t_bytes + o + k)])
            ++k;
        if (k < L) continue;
        if (P.wordbound) {
            const uint32_t after = s + L < P.n ? __ldg(P.text + s + L) : 0u;
            const uint32_t before = s > 0 ? __ldg(P.text + s - 1) : 0u;
            if (is_alnum(after) || is_alnum(before)) continue;
        }
        return (int)tid;
    }
    return -1;
}

__device__ __forceinline__ void load_tables(const Params& P,
                                            uint32_t* s_member,
                                            uint8_t* s_tr) {
    for (int i = threadIdx.x; i < kMemberWords; i += kThreads)
        s_member[i] = P.member[i];
    for (int i = threadIdx.x; i < 256; i += kThreads) s_tr[i] = P.tr[i];
    __syncthreads();
}

// Word w's newline mask and winner mask; the whole warp calls it (the
// bytes before the word come from the neighbouring lane).
__device__ __forceinline__ void word_masks(const Params& P,
                                           const uint32_t* s_member,
                                           const uint8_t* s_tr, long long w,
                                           uint32_t* nl_out,
                                           uint32_t* win_out) {
    const uintptr_t lo = reinterpret_cast<uintptr_t>(P.text);
    const uintptr_t hi = lo + (uintptr_t)P.n;
    const int lane = threadIdx.x & 31;
    uint32_t x[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    if (w < P.n_words) text_word32(lo, hi, (int)(lo & 15), w, x);
    // the two bytes before position 32 w: lane - 1's last two
    uint32_t prev = __shfl_up_sync(0xffffffffu, x[7], 1);
    if (lane == 0)
        prev = w > 0 && w < P.n_words
                   ? (uint32_t)__ldg(P.text + 32 * w - 1) << 24
                         | (uint32_t)__ldg(P.text + 32 * w - 2) << 16
                   : 0u;
    uint32_t b1 = (prev >> 24) & 31u, b2 = (prev >> 16) & 31u;
    uint32_t mem = 0, nl = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const uint32_t e = __vcmpeq4(x[i], 0x0a0a0a0au);     // 0xff a newline
        nl |= ((e >> 7 & 1u) | (e >> 14 & 2u) | (e >> 21 & 4u)
               | (e >> 28 & 8u)) << (4 * i);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const uint32_t b0 = (x[i] >> (8 * k)) & 31u;
            const uint32_t h = P.long_ ? (b0 << 10 | b1 << 5 | b2)
                                       : (b0 << 5 | b1);
            mem |= ((s_member[h >> 5] >> (h & 31)) & 1u) << (4 * i + k);
            b2 = b1;
            b1 = b0;
        }
    }
    uint32_t cand = 0;
    if (w < P.n_words) {
        cand = P.plane[w] & mem;
        // positions p - 1 .. n - 1 only
        const long long base = 32 * w;
        const long long below = P.p - 1 - base, left = P.n - base;
        if (below > 0) cand = below >= 32 ? 0u : cand & (~0u << below);
        if (left < 32) cand &= (1u << left) - 1u;
    }
    uint32_t win = 0;
    for (uint32_t m = cand; m; m &= m - 1u) {
        const int r = __ffs(m) - 1;
        const long long a = 32 * w + r;
        const uint32_t b0 = __ldg(P.text + a) & 31u;
        uint32_t h = b0 << 5 | (__ldg(P.text + a - 1) & 31u);
        if (P.long_) h = (h << 5 | (__ldg(P.text + a - 2) & 31u)) & 32767u;
        if (winner(P, s_tr, a, h) >= 0) win |= 1u << r;
    }
    *nl_out = nl;
    *win_out = win;
}

__device__ __forceinline__ long long round_word(int r) {
    return ((long long)blockIdx.x * kRounds + r) * kThreads + threadIdx.x;
}

__global__ void __launch_bounds__(kThreads)
sums_kernel(Params P, int* __restrict__ bf, int* __restrict__ bmid) {
    __shared__ uint32_t s_member[kMemberWords];
    __shared__ uint8_t s_tr[256];
    __shared__ Sum<int> s_warp[kRounds * kWarps];
    load_tables(P, s_member, s_tr);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int r = 0; r < kRounds; ++r) {
        uint32_t nl, win;
        word_masks(P, s_member, s_tr, round_word(r), &nl, &win);
        Sum<int> s = word_sum(nl, win);
        // lane l folds lanes l .. l + 2o - 1, in order
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const Sum<int> y = shfl_down(s, o);
            if (lane + o < 32) s = combine(s, y);
        }
        if (lane == 0) s_warp[r * kWarps + warp] = s;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        Sum<int> s = s_warp[0];
        for (int i = 1; i < kRounds * kWarps; ++i) s = combine(s, s_warp[i]);
        bf[blockIdx.x] = s.f;
        bmid[blockIdx.x] = s.mid;
    }
}

// Lane l's inclusive fold of lanes 0 .. l, and the warp's exclusive one.
template <typename M>
__device__ __forceinline__ Sum<M> warp_scan(Sum<M> s, Sum<M>* excl) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const Sum<M> y = shfl_up(s, o);
        if (lane >= o) s = combine(y, s);
    }
    const Sum<M> e = shfl_up(s, 1);
    *excl = lane ? e : Sum<M>{0, M(0)};
    return s;
}

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ bf, const int* __restrict__ bmid,
            long long nb, int* __restrict__ pf, long long* __restrict__ pmid,
            long long* __restrict__ total) {
    __shared__ Sum<long long> s_warp[kScanThreads / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long per = (nb + kScanThreads - 1) / kScanThreads;
    const long long b0 = threadIdx.x * per;
    const long long b1 = b0 + per < nb ? b0 + per : nb;
    Sum<long long> s = {0, 0};
    for (long long b = b0; b < b1; ++b)
        s = combine(s, Sum<long long>{bf[b], (long long)bmid[b]});
    Sum<long long> excl;
    const Sum<long long> incl = warp_scan(s, &excl);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    Sum<long long> pre = {0, 0};
    for (int i = 0; i < warp; ++i) pre = combine(pre, s_warp[i]);
    pre = combine(pre, excl);
    for (long long b = b0; b < b1; ++b) {
        pf[b] = pre.f;
        pmid[b] = pre.mid;
        pre = combine(pre, Sum<long long>{bf[b], (long long)bmid[b]});
    }
    if (threadIdx.x == kScanThreads - 1) {
        pf[nb] = pre.f;
        pmid[nb] = pre.mid;
        *total = rows_of(pre);
    }
}

__global__ void __launch_bounds__(kThreads)
rows_kernel(Params P, const int* __restrict__ pf,
            const long long* __restrict__ pmid, long long* __restrict__ rows) {
    __shared__ uint32_t s_member[kMemberWords];
    __shared__ uint8_t s_tr[256];
    __shared__ Sum<int> s_warp[kWarps];
    const long long b = blockIdx.x;
    Sum<long long> pre = {pf[b], pmid[b]};
    if (rows_of(Sum<long long>{pf[b + 1], pmid[b + 1]}) == rows_of(pre))
        return;                         // no row in this block
    load_tables(P, s_member, s_tr);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int r = 0; r < kRounds; ++r) {
        const long long w = round_word(r);
        uint32_t nl, win;
        word_masks(P, s_member, s_tr, w, &nl, &win);
        Sum<int> excl;
        const Sum<int> incl = warp_scan(word_sum(nl, win), &excl);
        if (lane == 31) s_warp[warp] = incl;
        __syncthreads();
        // this thread's prefix: the block's, earlier warps', earlier lanes'
        Sum<long long> mine = pre;
        for (int i = 0; i < warp; ++i)
            mine = combine(mine, Sum<long long>{s_warp[i].f, s_warp[i].mid});
        mine = combine(mine, Sum<long long>{excl.f, excl.mid});
        bool won = open_won(mine);
        long long o = rows_of(mine);
        for (uint32_t m = nl | win; m; m &= m - 1u) {
            const int q = __ffs(m) - 1;
            if ((nl >> q) & 1u) won = false;
            if (((win >> q) & 1u) && !won) {
                const long long a = 32 * w + q;
                uint32_t h = (__ldg(P.text + a) & 31u) << 5
                             | (__ldg(P.text + a - 1) & 31u);
                if (P.long_)
                    h = (h << 5 | (__ldg(P.text + a - 2) & 31u)) & 32767u;
                rows[2 * o] = a;
                rows[2 * o + 1] = winner(P, s_tr, a, h);
                ++o;
                won = true;
            }
        }
        for (int i = 0; i < kWarps; ++i)
            pre = combine(pre, Sum<long long>{s_warp[i].f, s_warp[i].mid});
        __syncthreads();                // s_warp is rewritten next round
    }
}

bool make_params(const uint8_t* text, long long n, const uint32_t* plane,
                 const uint32_t* member, const int* hash_id,
                 const long long* b_off, const long long* b_tids,
                 const uint8_t* t_bytes, const long long* t_off,
                 const uint8_t* tr, long long p, int long_, int wordbound,
                 Params* P) {
    if (n < 1 || p < 2 || (long_ && p < 3)) return false;
    P->text = text;
    P->n = n;
    P->plane = plane;
    P->n_words = (n + 31) / 32;
    P->member = member;
    P->hash_id = hash_id;
    P->b_off = b_off;
    P->b_tids = b_tids;
    P->t_bytes = t_bytes;
    P->t_off = t_off;
    P->tr = tr;
    P->p = p;
    P->long_ = long_;
    P->wordbound = wordbound;
    return true;
}

long long blocks_of(long long n) {
    return ((n + 31) / 32 + kWordsPerBlock - 1) / kWordsPerBlock;
}

}  // namespace qgram_lines

using namespace qgram_lines;

extern "C" {

// Threads a block of passes 1 and 3, plane words a block, threads of
// pass 2's one block.
int qgram_lines_geometry(int* threads, int* words_per_block,
                         int* scan_threads) {
    *threads = kThreads;
    *words_per_block = kWordsPerBlock;
    *scan_threads = kScanThreads;
    return 0;
}

// Pass 1 on `stream`: bf and bmid int32 [grid], each block's summary
// (flags, whole lines with a winner), grid = ceil(ceil(n / 32) /
// words_per_block).  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernels do not take).  All
// pointers are device pointers: text u8 [n] at any address, plane u32
// [ceil(n / 32)], member u32 [1024], hash_id int32 [32768], b_off, b_tids,
// t_off int64, t_bytes u8, tr u8 [256].
int qgram_lines_sums(const uint8_t* text, long long n, const uint32_t* plane,
                     const uint32_t* member, const int* hash_id,
                     const long long* b_off, const long long* b_tids,
                     const uint8_t* t_bytes, const long long* t_off,
                     const uint8_t* tr, long long p, int long_,
                     int wordbound, int* bf, int* bmid, int grid,
                     void* stream) {
    Params P;
    if (!make_params(text, n, plane, member, hash_id, b_off, b_tids, t_bytes,
                     t_off, tr, p, long_, wordbound, &P)
        || grid != blocks_of(n))
        return (int)cudaErrorInvalidValue;
    sums_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        P, bf, bmid);
    return (int)cudaGetLastError();
}

// Pass 2 on `stream`: pf int32 and pmid int64 [nb + 1], the exclusive
// prefix summary of the nb block summaries (the whole text's at nb), and
// total int64 [1], the count of lines with a winner.
int qgram_lines_scan(const int* bf, const int* bmid, long long nb, int* pf,
                     long long* pmid, long long* total, void* stream) {
    if (nb < 1) return (int)cudaErrorInvalidValue;
    scan_kernel<<<1, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        bf, bmid, nb, pf, pmid, total);
    return (int)cudaGetLastError();
}

// Pass 3 on `stream`, the arguments and grid of pass 1, with pass 2's
// prefixes: the rows, int64 [total, 2], (anchor, term id) in stream order.
int qgram_lines_rows(const uint8_t* text, long long n, const uint32_t* plane,
                     const uint32_t* member, const int* hash_id,
                     const long long* b_off, const long long* b_tids,
                     const uint8_t* t_bytes, const long long* t_off,
                     const uint8_t* tr, long long p, int long_,
                     int wordbound, const int* pf, const long long* pmid,
                     long long* rows, int grid, void* stream) {
    Params P;
    if (!make_params(text, n, plane, member, hash_id, b_off, b_tids, t_bytes,
                     t_off, tr, p, long_, wordbound, &P)
        || grid != blocks_of(n))
        return (int)cudaErrorInvalidValue;
    rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        P, pf, pmid, rows);
    return (int)cudaGetLastError();
}

const char* qgram_lines_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
