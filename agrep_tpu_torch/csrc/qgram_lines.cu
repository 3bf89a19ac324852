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
// What bounds it on an H100: bytes, in the function's least work.  It
// must read the text and the plane once (n + n / 8 bytes: 0.035 ms per
// 100 MB at 3.35 TB/s) and write 16 bytes a row.  About 38 % of the
// positions pass the plane and about 0.15 % the exact member test, so
// the bucket walks are rare (0.013 ms of the first design's 0.125 at
// 100 MB).  Staging the bucket and term tables in shared memory, and
// queueing a tile's candidates to walk them one a thread, each made the
// pass slower on an H100 (by 0.002-0.004 ms a call at 100 MB,
// tools/torch_kernel_ab.py): a thread walks the candidates it finds,
// from the tables in global memory.  This design tests every position
// against the member set (a shared-memory gather and about six int32
// instructions) and builds every word's newline mask: int32 issue, at
// half the fp32 rate on Hopper, binds it before the bytes do.  The
// design:
//
//   * A block of kThreads threads walks tiles of kTileWords plane words
//     (kTileWords * 32 text bytes), as many tiles as the card holds
//     blocks, so that each block loads the 4 KB member set and the fold
//     once.  A thread owns kWordsPerThread consecutive words of a tile: it
//     loads their text bytes and the two bytes before them (the previous
//     lane's, by shuffle), and builds each word's newline mask and its
//     exact member mask (one gather a position from the member set in
//     shared memory, the bit placed by a funnel shift: about six
//     instructions a position), ANDed with the plane's bits at the valid
//     positions: the candidates.  The thread walks each candidate's
//     bucket (winner) and keeps the bits that win: its words' winner
//     masks.
//   * A word, and any run of words, folds into a summary: whether it
//     holds a newline; whether its head (the positions before its first
//     newline) holds a winner; whether its tail (from its last newline
//     on) does; and the number of whole lines inside it that do.  The
//     fold is associative: a thread folds its words in order, a warp by
//     shuffles, a block by its warps' summaries in shared memory.
//   * Pass 1 (sums_kernel): each tile's summary; in the print form also
//     each word's newline and winner masks (u32 [ceil(n / 32)] each).
//   * Pass 2 (scan_kernel, one block): the exclusive prefix of the tile
//     summaries, each thread folding a run of tiles; the prefix of the
//     whole text gives the count, which the wrapper reads: a count stops
//     here.  The count of lines whose first winner lies in a prefix is
//     its head + its whole lines + its tail.
//   * Pass 3 (rows_kernel, print form, a block a tile): each tile that
//     holds a row folds its words' masks from its prefix; each thread
//     then knows whether its first line already has a winner and where its
//     first row goes, walks its newlines and winners in order and writes
//     its rows, with one bucket walk a row for the term id.
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
constexpr int kWordsPerThread = 2;
constexpr int kTileWords = kThreads * kWordsPerThread;
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

template <typename M>
__device__ __forceinline__ Sum<long long> wide(Sum<M> s) {
    return {s.f, (long long)s.mid};
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

// The gram hash at anchor a >= p - 1 >= 1 (LONG: a >= 2).
__device__ __forceinline__ uint32_t gram_hash(const Params& P, long long a) {
    uint32_t h = (__ldg(P.text + a) & 31u) << 5 | (__ldg(P.text + a - 1) & 31u);
    if (P.long_) h = (h << 5 | (__ldg(P.text + a - 2) & 31u)) & 32767u;
    return h;
}

// The winning term at anchor a (its gram hash h a member), or -1.
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
        while (k < L && s_tr[__ldg(P.text + s + k)] == s_tr[P.t_bytes[o + k]])
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

// Newline mask of four text bytes (bit k: byte k is '\n'), exactly: the
// bytes equal to 0x0a get 0x80, gathered by one multiply.
__device__ __forceinline__ uint32_t newline4(uint32_t x) {
    const uint32_t y = x ^ 0x0a0a0a0au;
    const uint32_t z = ~(((y & 0x7f7f7f7fu) + 0x7f7f7f7fu) | y) & 0x80808080u;
    return (z * 0x00204081u) >> 28;
}

// The text bytes of words w0 .. w0 + kWordsPerThread - 1 (32 each; 0
// outside the text), x[k][i] bytes 32 (w0 + k) + 4 i .. + 3.  Inside the
// text, the run's 16-byte pieces from the aligned address at or below it
// are loaded at once and shifted into place; at its edges, word by word
// (text_word32).
__device__ __forceinline__ void thread_words(uintptr_t lo, uintptr_t hi,
                                             long long w0, long long n_words,
                                             uint32_t x[kWordsPerThread][8]) {
    constexpr int kPieces = 2 * kWordsPerThread + 1;
    const int sh = (int)(lo & 15);
    const uintptr_t a = lo + 32 * (uintptr_t)w0 - sh;
    if (a >= lo && a + 16 * kPieces <= hi) {
        const uint4* q = reinterpret_cast<const uint4*>(a);
        uint32_t v[4 * kPieces];
#pragma unroll
        for (int j = 0; j < kPieces - 1; ++j) {
            const uint4 p = __ldg(q + j);
            v[4 * j] = p.x;
            v[4 * j + 1] = p.y;
            v[4 * j + 2] = p.z;
            v[4 * j + 3] = p.w;
        }
        if (sh == 0) {
#pragma unroll
            for (int k = 0; k < kWordsPerThread; ++k)
#pragma unroll
                for (int i = 0; i < 8; ++i) x[k][i] = v[8 * k + i];
            return;
        }
        const uint4 p = __ldg(q + kPieces - 1);
        v[4 * kPieces - 4] = p.x;
        v[4 * kPieces - 3] = p.y;
        v[4 * kPieces - 2] = p.z;
        v[4 * kPieces - 1] = p.w;
        // x = the words from byte sh of v: whole words by sh >> 2, then
        // bytes by a funnel shift
#pragma unroll
        for (int j = 0; j < 4 * kPieces - 2; ++j)
            v[j] = (sh & 8) ? v[j + 2] : v[j];
#pragma unroll
        for (int j = 0; j < 4 * kPieces - 3; ++j)
            v[j] = (sh & 4) ? v[j + 1] : v[j];
#pragma unroll
        for (int k = 0; k < kWordsPerThread; ++k)
#pragma unroll
            for (int i = 0; i < 8; ++i)
                x[k][i] = __funnelshift_r(v[8 * k + i], v[8 * k + i + 1],
                                          8 * (sh & 3));
        return;
    }
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
#pragma unroll
        for (int i = 0; i < 8; ++i) x[k][i] = 0u;
        if (w0 + k < n_words) text_word32(lo, hi, sh, w0 + k, x[k]);
    }
}

// Words w0 .. w0 + kWordsPerThread - 1 of the text (any alignment; the
// bytes outside it read as 0), their newline masks and their exact member
// masks at the plane's bits of the positions p - 1 .. n - 1 (the
// candidates).  The whole warp calls it: the two bytes before w0 come
// from the previous lane.
template <bool kLong>
__device__ __forceinline__ void thread_masks(const Params& P,
                                             const uint32_t* s_member,
                                             long long w0,
                                             uint32_t nl[kWordsPerThread],
                                             uint32_t cand[kWordsPerThread]) {
    const uintptr_t lo = reinterpret_cast<uintptr_t>(P.text);
    const uintptr_t hi = lo + (uintptr_t)P.n;
    const int lane = threadIdx.x & 31;
    uint32_t x[kWordsPerThread][8];
    thread_words(lo, hi, w0, P.n_words, x);
    // the two bytes before position 32 w0: lane - 1's last two
    uint32_t prev = __shfl_up_sync(0xffffffffu, x[kWordsPerThread - 1][7], 1);
    if (lane == 0)
        prev = w0 > 0 && w0 < P.n_words
                   ? (uint32_t)__ldg(P.text + 32 * w0 - 1) << 24
                         | (uint32_t)__ldg(P.text + 32 * w0 - 2) << 16
                   : 0u;
    // c1, c2: the low five bits of the two bytes before the position;
    // c1x4 = c1 << 2 (the member word's byte address is c0 << 7 | c1 << 2)
    uint32_t c1 = (prev >> 24) & 31u, c2 = (prev >> 16) & 31u;
    uint32_t c1x4 = c1 << 2;
    const char* s_bytes = reinterpret_cast<const char*>(s_member);
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
        uint32_t m = 0, mem = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            m |= newline4(x[k][i]) << (4 * i);
            const uint32_t f = x[k][i] & 0x1f1f1f1fu;
            const uint32_t g = f << 2;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                const uint32_t c0 = __byte_perm(f, 0, 0x4440 + b);
                const uint32_t c0x4 = __byte_perm(g, 0, 0x4440 + b);
                // the member word (h >> 5) and bit (h & 31)
                const uint32_t v = kLong
                    ? *reinterpret_cast<const uint32_t*>(
                          s_bytes + ((c0x4 << 5) + c1x4)) >> c2
                    : *reinterpret_cast<const uint32_t*>(s_bytes + c0x4)
                          >> c1;
                // the position's bit enters at the top; 32 steps later
                // position 4 i + b sits at bit 4 i + b
                mem = __funnelshift_r(mem, v, 1);
                c2 = c1;
                c1 = c0;
                c1x4 = c0x4;
            }
        }
        nl[k] = m;
        // the plane's bits at positions p - 1 .. n - 1
        uint32_t pw = 0;
        const long long w = w0 + k;
        if (w < P.n_words) {
            pw = P.plane[w];
            const long long base = 32 * w;
            const long long below = P.p - 1 - base, left = P.n - base;
            if (below > 0) pw = below >= 32 ? 0u : pw & (~0u << below);
            if (left < 32) pw &= (1u << left) - 1u;
        }
        cand[k] = mem & pw;
    }
}

// Pass 1: a block walks tiles blockIdx.x, + gridDim.x, ...
template <bool kLong>
__global__ void __launch_bounds__(kThreads, 6)
sums_kernel(Params P, long long n_tiles, int* __restrict__ bf,
            int* __restrict__ bmid, uint32_t* __restrict__ nlm,
            uint32_t* __restrict__ winm) {
    __shared__ uint32_t s_member[kMemberWords];
    __shared__ uint8_t s_tr[256];
    // the warps' summaries, two sets: a tile writes the set its
    // predecessor did not read, so one barrier a tile suffices
    __shared__ Sum<int> s_warp[2][kWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int i = threadIdx.x; i < kMemberWords; i += kThreads)
        s_member[i] = P.member[i];
    for (int i = threadIdx.x; i < 256; i += kThreads) s_tr[i] = P.tr[i];
    __syncthreads();
    int set = 0;
    for (long long tile = blockIdx.x; tile < n_tiles;
         tile += gridDim.x, set ^= 1) {
        const long long w0 = tile * kTileWords
                             + (long long)threadIdx.x * kWordsPerThread;
        uint32_t nl[kWordsPerThread], win[kWordsPerThread];
        thread_masks<kLong>(P, s_member, w0, nl, win);
        // walk: each candidate in the thread that found it; win keeps the
        // winners
#pragma unroll
        for (int k = 0; k < kWordsPerThread; ++k)
            for (uint32_t m = win[k]; m; m &= m - 1u) {
                const int q = __ffs(m) - 1;
                const long long a = 32 * (w0 + k) + q;
                if (winner(P, s_tr, a, gram_hash(P, a)) < 0)
                    win[k] &= ~(1u << q);
            }
        // fold: the thread's words in order, then the warp, then the block
        Sum<int> s = {0, 0};
#pragma unroll
        for (int k = 0; k < kWordsPerThread; ++k) {
            s = k ? combine(s, word_sum(nl[k], win[k]))
                  : word_sum(nl[k], win[k]);
            if (nlm != nullptr && w0 + k < P.n_words) {
                nlm[w0 + k] = nl[k];
                winm[w0 + k] = win[k];
            }
        }
        // lane l folds lanes l .. l + 2o - 1, in order
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const Sum<int> y = shfl_down(s, o);
            if (lane + o < 32) s = combine(s, y);
        }
        if (lane == 0) s_warp[set][warp] = s;
        __syncthreads();
        if (threadIdx.x == 0) {
            Sum<int> t = s_warp[set][0];
            for (int i = 1; i < kWarps; ++i) t = combine(t, s_warp[set][i]);
            bf[tile] = t.f;
            bmid[tile] = t.mid;
        }
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

// Pass 2, one block: each thread folds a run of consecutive tiles, the
// block scans the threads' folds, each thread writes its run's prefixes.
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

// Pass 3: block b folds tile b's masks from its prefix and writes its rows.
__global__ void __launch_bounds__(kThreads)
rows_kernel(Params P, const int* __restrict__ pf,
            const long long* __restrict__ pmid,
            const uint32_t* __restrict__ nlm,
            const uint32_t* __restrict__ winm, long long* __restrict__ rows) {
    __shared__ uint8_t s_tr[256];
    __shared__ Sum<int> s_warp[kWarps];
    const long long b = blockIdx.x;
    const Sum<long long> pre = {pf[b], pmid[b]};
    if (rows_of(Sum<long long>{pf[b + 1], pmid[b + 1]}) == rows_of(pre))
        return;                         // no row in this tile
    for (int i = threadIdx.x; i < 256; i += kThreads) s_tr[i] = P.tr[i];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long w0 = b * kTileWords + (long long)threadIdx.x
                                              * kWordsPerThread;
    uint32_t nl[kWordsPerThread], win[kWordsPerThread];
    Sum<int> s = {0, 0};
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
        const bool in = w0 + k < P.n_words;
        nl[k] = in ? nlm[w0 + k] : 0u;
        win[k] = in ? winm[w0 + k] : 0u;
        s = k ? combine(s, word_sum(nl[k], win[k])) : word_sum(nl[k], win[k]);
    }
    Sum<int> excl;
    const Sum<int> incl = warp_scan(s, &excl);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();                    // also: s_tr is loaded
    // this thread's prefix: the tile's, earlier warps', earlier lanes'
    Sum<long long> mine = pre;
    for (int i = 0; i < warp; ++i) mine = combine(mine, wide(s_warp[i]));
    mine = combine(mine, wide(excl));
    bool won = open_won(mine);
    long long o = rows_of(mine);
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k)
        for (uint32_t m = nl[k] | win[k]; m; m &= m - 1u) {
            const int q = __ffs(m) - 1;
            if ((nl[k] >> q) & 1u) won = false;
            if (((win[k] >> q) & 1u) && !won) {
                const long long a = 32 * (w0 + k) + q;
                rows[2 * o] = a;
                rows[2 * o + 1] = winner(P, s_tr, a, gram_hash(P, a));
                ++o;
                won = true;
            }
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

long long tiles_of(long long n) {
    return ((n + 31) / 32 + kTileWords - 1) / kTileWords;
}

template <bool kLong>
int launch_sums(const Params& P, long long n_tiles, int* bf, int* bmid,
                uint32_t* nlm, uint32_t* winm, cudaStream_t stream) {
    auto kernel = sums_kernel<kLong>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long slots = (long long)per_sm * sms;
    const int grid = (int)(n_tiles < slots ? n_tiles : slots);
    kernel<<<grid, kThreads, 0, stream>>>(P, n_tiles, bf, bmid, nlm, winm);
    return (int)cudaGetLastError();
}

}  // namespace qgram_lines

using namespace qgram_lines;

extern "C" {

// Plane words a tile of passes 1 and 3.
int qgram_lines_geometry(int* tile_words) {
    *tile_words = kTileWords;
    return 0;
}

// Pass 1 on `stream`: bf and bmid int32 [tiles], each tile's summary
// (flags, whole lines with a winner), tiles = ceil(ceil(n / 32) /
// tile_words); nlm and winm u32 [ceil(n / 32)], each word's newline and
// winner masks, or both null (a count).  The grid is as many blocks as the card holds at once, at most tiles.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernels do not take).  All pointers are device pointers:
// text u8 [n] at any address, plane u32 [ceil(n / 32)], member u32
// [1024], hash_id int32 [32768], b_off, b_tids, t_off int64, t_bytes u8,
// tr u8 [256].
int qgram_lines_sums(const uint8_t* text, long long n, const uint32_t* plane,
                     const uint32_t* member, const int* hash_id,
                     const long long* b_off, const long long* b_tids,
                     const uint8_t* t_bytes, const long long* t_off,
                     const uint8_t* tr, long long p, int long_,
                     int wordbound, int* bf, int* bmid, uint32_t* nlm,
                     uint32_t* winm, long long tiles, void* stream) {
    Params P;
    if (!make_params(text, n, plane, member, hash_id, b_off, b_tids, t_bytes,
                     t_off, tr, p, long_, wordbound, &P)
        || tiles != tiles_of(n) || (nlm == nullptr) != (winm == nullptr))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return long_ ? launch_sums<true>(P, tiles, bf, bmid, nlm, winm, s)
                 : launch_sums<false>(P, tiles, bf, bmid, nlm, winm, s);
}

// Pass 2 on `stream`: pf int32 and pmid int64 [nb + 1], the exclusive
// prefix summary of the nb tile summaries (the whole text's at nb), and
// total int64 [1], the count of lines with a winner.
int qgram_lines_scan(const int* bf, const int* bmid, long long nb, int* pf,
                     long long* pmid, long long* total, void* stream) {
    if (nb < 1) return (int)cudaErrorInvalidValue;
    scan_kernel<<<1, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        bf, bmid, nb, pf, pmid, total);
    return (int)cudaGetLastError();
}

// Pass 3 on `stream`, a block a tile, with pass 1's masks and pass 2's
// prefixes: the rows, int64 [total, 2], (anchor, term id) in stream order.
int qgram_lines_rows(const uint8_t* text, long long n, const uint32_t* plane,
                     const uint32_t* member, const int* hash_id,
                     const long long* b_off, const long long* b_tids,
                     const uint8_t* t_bytes, const long long* t_off,
                     const uint8_t* tr, long long p, int long_,
                     int wordbound, const int* pf, const long long* pmid,
                     const uint32_t* nlm, const uint32_t* winm,
                     long long* rows, long long tiles, void* stream) {
    Params P;
    if (!make_params(text, n, plane, member, hash_id, b_off, b_tids, t_bytes,
                     t_off, tr, p, long_, wordbound, &P)
        || tiles != tiles_of(n) || nlm == nullptr || winm == nullptr)
        return (int)cudaErrorInvalidValue;
    rows_kernel<<<(unsigned)tiles, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(P, pf, pmid, nlm, winm,
                                                       rows);
    return (int)cudaGetLastError();
}

const char* qgram_lines_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
