// Line index of a text chunk, in length order, for NVIDIA Hopper (sm_90a).
//
// Replaces the regex engine's host line index
// (agrep_tpu/runtime/regex_engine.py: `np.flatnonzero(seg == 0x0A)` of a
// chunk, :116 and :149, or of the whole stream, :339 and :349, then
// `np.argsort(line_len, kind="stable")`, :375), which reads every byte of
// the chunk twice on the host and sorts every line length before the lines
// go to the card.  Here the text already lies on the card, and the lines
// are cut and ordered there for renfa_lanes.
//
// The function.  Input: a u8 text of n bytes and a delimiter byte (the
// regex engine's newline, or the bitap engine's one-byte -d for
// bitap_lanes.cu); "newline" below is that byte.  Output, with K the
// text's newlines and nl[j] the position of the j-th (line j is
// [start_j, nl[j]), start_0 = 0 and start_j = nl[j-1] + 1 after):
//   * nl, int64 [K], in stream order; the last newline, nl[K-1], is where
//     the caller cuts the next chunk;
//   * the lines in length order: starts, lens and ords, int64 [K] each,
//     ords[q] the stream ordinal of the q-th line in that order.
// The order is a stable counting sort by len_key(len): the exact length
// below 128 bytes, sixteen steps an octave from 128 to 8,191 bytes (a
// step's lengths differ by at most 1/16), and every line of 8,192 bytes
// or more last, in stream order.  renfa_lanes walks a warp's 32 lines
// side by side, so neighbours of close lengths end together; 225 keys keep
// the sort one pass with a histogram a block, where exact lengths up to
// 8,192 would need 8,193 bins a block or two radix passes.
//
// What bounds it on an H100: bytes.  It must read the text once and write
// 32 bytes a line: at config 4's 32 MB chunk (684,929 lines) about 55 MB,
// 16 us at 3.35 TB/s.  The design reads the text once, its newline bits
// (n / 8 bytes) once more and nl once more.  Every pass works on one grid of blocks of
// kBytesPerBlock text bytes (512 blocks at 32 MB: all resident at once on
// 132 SMs), and nothing runs between the passes but the passes:
//
//   * Pass 1 (count_kernel): each block counts the newlines of its bytes,
//     read as aligned 16-byte pieces (text_piece.cuh: the bytes outside
//     the text read as 0), and the last one's position, and stores each
//     piece's 16 newline bits (an eighth of the text's bytes) for pass 3.
//     A warp owns kRounds * 32 consecutive pieces, a round's 32 side by
//     side, and a thread issues all its kRounds loads before it uses one.
//   * Pass 2 (offsets_kernel, one block): the exclusive prefix sum of the
//     block counts (each block's first line), the exclusive prefix max of
//     their last newlines (the newline before each block's bytes, which
//     ends the line before its first), K and the last newline, which the
//     wrapper reads: the outputs are sized by K.
//   * Pass 3 (write_kernel) reads pass 1's newline bits, not the text,
//     sums the warps' newlines and last newlines across the block once
//     (shared memory, one barrier), then scans each round's lanes with
//     warp shuffles alone, and each thread writes its piece's newlines'
//     positions from its offset and histograms their lines' keys in
//     shared memory.  The histograms go
//     out key-major, hist[key * grid + block].
//   * Pass 4 (keys_kernel, a block a key): the exclusive prefix of each
//     key's row over the blocks, and the key's total.
//   * Pass 5 (scatter_kernel): each block sorts its lines by key in shared
//     memory, kRoundLines at a time, stably (a warp ranks its lanes of
//     equal key with __match_any_sync over its own run of lines, the warps'
//     counts a key are scanned), so that each key's run of the round
//     leaves the block as one contiguous store into each output array, at
//     the key's next slot: the earlier keys' totals, the earlier blocks'
//     lines of the key and the block's earlier rounds.
//
// Built by ops/_cuda.py as one object with a plain C interface:
// nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
// -fPIC.

#include <cstdint>
#include <cuda_runtime.h>

#include "text_piece.cuh"

namespace line_index {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;
constexpr int kBytesPerBlock = kThreads * 16 * kRounds;
constexpr int kRoundLines = 2048;
constexpr int kLinesPerThread = kRoundLines / kThreads;
constexpr int kKeys = 225;
constexpr int kScanThreads = 1024;

struct Text {
    const uint8_t* text;
    long long n;
    uintptr_t lo, hi, base;         // [lo, hi) the text; base = lo & ~15
    long long pieces;               // 16-byte pieces from base to hi
    uint32_t delim4;                // the delimiter byte in each byte
};

namespace {

Text make_text(const uint8_t* text, long long n, int delim = 0x0a) {
    Text t;
    t.text = text;
    t.n = n;
    t.delim4 = 0x01010101u * (uint32_t)(delim & 0xff);
    t.lo = reinterpret_cast<uintptr_t>(text);
    t.hi = t.lo + (uintptr_t)n;
    t.base = t.lo & ~(uintptr_t)15;
    t.pieces = (long long)((t.hi - t.base + 15) / 16);
    return t;
}

long long text_grid(const Text& t) {
    return (t.pieces + kBytesPerBlock / 16 - 1) / (kBytesPerBlock / 16);
}

// Bit k set where byte k of x is a newline (d4: the newline byte in each
// byte): the bytes equal to it get 0x80, gathered by one multiply.
__device__ __forceinline__ uint32_t newline4(uint32_t x, uint32_t d4) {
    const uint32_t y = x ^ d4;
    const uint32_t z = ~(((y & 0x7f7f7f7fu) + 0x7f7f7f7fu) | y) & 0x80808080u;
    return (z * 0x00204081u) >> 28;
}

__device__ __forceinline__ uint32_t newline16(uint4 v, uint32_t d4) {
    return newline4(v.x, d4) | newline4(v.y, d4) << 4
           | newline4(v.z, d4) << 8 | newline4(v.w, d4) << 12;
}

// Bit b set where byte b of piece g is a newline of the text: text_piece
// reads the bytes outside the text as 0, so a piece at an edge keeps only
// its bits inside [lo, hi) (a 0 delimiter would match them).
__device__ __forceinline__ uint32_t newline_bits(const Text& t, long long g) {
    const uintptr_t a = t.base + 16 * (uintptr_t)g;
    uint32_t m = newline16(text_piece(a, t.lo, t.hi), t.delim4);
    if (a < t.lo) m &= 0xffffu << (t.lo - a);
    if (a + 16 > t.hi) m &= t.hi > a ? 0xffffu >> (a + 16 - t.hi) : 0u;
    return m;
}

// Text position of byte b of piece g.
__device__ __forceinline__ long long piece_pos(const Text& t, long long g,
                                               int b) {
    return (long long)(t.base + 16 * (uintptr_t)g + b - t.lo);
}

__device__ __forceinline__ long long max64(long long a, long long b) {
    return a > b ? a : b;
}

__device__ __forceinline__ int len_key(long long len) {
    if (len < 128) return (int)len;
    if (len >= 8192) return kKeys - 1;
    const int e = 63 - __clzll(len);                   // 7 .. 12
    return 128 + (e - 7) * 16 + (int)((len >> (e - 4)) & 15);
}

// The block's exclusive prefix sum of v (thread order) and its total;
// s_tmp holds kWarps values.  Every thread calls it; it syncs twice.
template <typename T>
__device__ __forceinline__ T block_excl_sum(T v, T* s_tmp, T* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    T x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const T y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) s_tmp[warp] = x;
    __syncthreads();
    T before = 0, all = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
        if (w < warp) before += s_tmp[w];
        all += s_tmp[w];
    }
    __syncthreads();                    // s_tmp may be rewritten next
    *total = all;
    return before + x - v;
}

// Piece r of this thread: a warp owns kRounds * 32 consecutive pieces of
// its block, round r's 32 side by side (one 512-byte load a warp), so
// that the warp's newlines come in stream order round by round.
__device__ __forceinline__ long long warp_piece(int r) {
    return ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRounds
               * 32 + r * 32 + (threadIdx.x & 31);
}

// The newline masks of this thread's pieces: inside the text, every load
// is issued before the first is used; at its edges, piece by piece.
__device__ __forceinline__ void piece_masks(const Text& t,
                                            uint32_t m[kRounds]) {
    const uintptr_t a = t.base + 16 * (uintptr_t)warp_piece(0);
    if (a >= t.lo && a + 16 * 32 * (kRounds - 1) + 16 <= t.hi) {
        const uint4* q = reinterpret_cast<const uint4*>(a);
        uint4 v[kRounds];
#pragma unroll
        for (int r = 0; r < kRounds; ++r) v[r] = __ldg(q + 32 * r);
#pragma unroll
        for (int r = 0; r < kRounds; ++r) m[r] = newline16(v[r], t.delim4);
        return;
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
        m[r] = warp_piece(r) < t.pieces ? newline_bits(t, warp_piece(r)) : 0u;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(Text t, long long* __restrict__ counts,
             long long* __restrict__ last, uint16_t* __restrict__ masks) {
    __shared__ int s_warp[kWarps];
    __shared__ long long s_last[kWarps];
    uint32_t m[kRounds];
    piece_masks(t, m);
#pragma unroll
    for (int r = 0; r < kRounds; ++r) masks[warp_piece(r)] = (uint16_t)m[r];
    int c = 0;
    long long mx = -1;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
        c += __popc(m[r]);
        if (m[r]) mx = max64(mx, piece_pos(t, warp_piece(r), 31 - __clz(m[r])));
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
        c += __shfl_down_sync(0xffffffffu, c, o);
        mx = max64(mx, __shfl_down_sync(0xffffffffu, mx, o));
    }
    if ((threadIdx.x & 31) == 0) {
        s_warp[threadIdx.x >> 5] = c;
        s_last[threadIdx.x >> 5] = mx;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        long long s = 0, l = -1;
        for (int w = 0; w < kWarps; ++w) {
            s += s_warp[w];
            l = max64(l, s_last[w]);
        }
        counts[blockIdx.x] = s;
        last[blockIdx.x] = l;
    }
}

__global__ void __launch_bounds__(kScanThreads)
offsets_kernel(const long long* __restrict__ counts,
               const long long* __restrict__ last, long long nb,
               long long* __restrict__ offs, long long* __restrict__ prev,
               long long* __restrict__ meta) {
    __shared__ long long s_sum[kScanThreads / 32];
    __shared__ long long s_max[kScanThreads / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long per = (nb + kScanThreads - 1) / kScanThreads;
    const long long b0 = threadIdx.x * per;
    const long long b1 = b0 + per < nb ? b0 + per : nb;
    long long s = 0, m = -1;
    for (long long b = b0; b < b1; ++b) {
        s += counts[b];
        m = max64(m, last[b]);
    }
    long long x = s, y = m;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const long long xs = __shfl_up_sync(0xffffffffu, x, o);
        const long long ym = __shfl_up_sync(0xffffffffu, y, o);
        if (lane >= o) {
            x += xs;
            y = max64(y, ym);
        }
    }
    if (lane == 31) {
        s_sum[warp] = x;
        s_max[warp] = y;
    }
    long long ey = __shfl_up_sync(0xffffffffu, y, 1);
    if (lane == 0) ey = -1;
    __syncthreads();
    long long sum = x - s, mx = ey;
    for (int w = 0; w < warp; ++w) {
        sum += s_sum[w];
        mx = max64(mx, s_max[w]);
    }
    for (long long b = b0; b < b1; ++b) {
        offs[b] = sum;
        prev[b] = mx;
        sum += counts[b];
        mx = max64(mx, last[b]);
    }
    if (threadIdx.x == kScanThreads - 1) {
        offs[nb] = sum;
        meta[0] = sum;
        meta[1] = mx;
    }
}

__global__ void __launch_bounds__(kThreads)
write_kernel(Text t, const uint16_t* __restrict__ masks,
             const long long* __restrict__ offs,
             const long long* __restrict__ prev, long long* __restrict__ nl,
             int* __restrict__ hist) {
    __shared__ int s_hist[kKeys];
    __shared__ int s_warp[kWarps];
    __shared__ long long s_wmax[kWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int k = threadIdx.x; k < kKeys; k += kThreads) s_hist[k] = 0;
    uint32_t m[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) m[r] = masks[warp_piece(r)];
    // the warp's newlines and last newline, then the earlier warps'
    int c = 0;
    long long mx = -1;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
        c += __popc(m[r]);
        if (m[r]) mx = max64(mx, piece_pos(t, warp_piece(r), 31 - __clz(m[r])));
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
        c += __shfl_xor_sync(0xffffffffu, c, o);
        mx = max64(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    if (lane == 0) {
        s_warp[warp] = c;
        s_wmax[warp] = mx;
    }
    __syncthreads();                    // also: s_hist is zeroed
    long long base = offs[blockIdx.x];
    long long p0 = prev[blockIdx.x];    // the newline before the round
    for (int w = 0; w < warp; ++w) {
        base += s_warp[w];
        p0 = max64(p0, s_wmax[w]);
    }
    // round by round: each lane's first slot and the newline before its
    // piece, from the warp's earlier lanes and rounds
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
        const int n = __popc(m[r]);
        const long long g = warp_piece(r);
        const long long mine = m[r] ? piece_pos(t, g, 31 - __clz(m[r])) : -1;
        int x = n;
        long long y = mine;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int xs = __shfl_up_sync(0xffffffffu, x, o);
            const long long ym = __shfl_up_sync(0xffffffffu, y, o);
            if (lane >= o) {
                x += xs;
                y = max64(y, ym);
            }
        }
        long long ey = __shfl_up_sync(0xffffffffu, y, 1);
        if (lane == 0) ey = -1;
        long long o = base + x - n;
        long long p = max64(p0, ey);
        for (uint32_t k = m[r]; k; k &= k - 1) {
            const long long pos = piece_pos(t, g, __ffs(k) - 1);
            nl[o++] = pos;
            atomicAdd(&s_hist[len_key(pos - p - 1)], 1);
            p = pos;
        }
        base += __shfl_sync(0xffffffffu, x, 31);
        p0 = max64(p0, __shfl_sync(0xffffffffu, y, 31));
    }
    __syncthreads();
    for (int k = threadIdx.x; k < kKeys; k += kThreads)
        hist[(long long)k * gridDim.x + blockIdx.x] = s_hist[k];
}

__global__ void __launch_bounds__(kThreads)
keys_kernel(const int* __restrict__ hist, long long nb,
            long long* __restrict__ slots, long long* __restrict__ ktot) {
    __shared__ long long s_tmp[kWarps];
    const long long row = (long long)blockIdx.x * nb;
    const long long per = (nb + kThreads - 1) / kThreads;
    const long long b0 = threadIdx.x * per;
    const long long b1 = b0 + per < nb ? b0 + per : nb;
    long long s = 0;
    for (long long b = b0; b < b1; ++b) s += hist[row + b];
    long long total;
    long long pre = block_excl_sum(s, s_tmp, &total);
    for (long long b = b0; b < b1; ++b) {
        slots[row + b] = pre;
        pre += hist[row + b];
    }
    if (threadIdx.x == 0) ktot[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const long long* __restrict__ nl,
               const long long* __restrict__ offs,
               const long long* __restrict__ slots,
               const long long* __restrict__ ktot,
               long long* __restrict__ starts, long long* __restrict__ lens,
               long long* __restrict__ ords) {
    __shared__ long long s_nl[kRoundLines + 1];  // nl[j0 - 1 ..]
    __shared__ long long s_next[kKeys];     // the block's next slot a key
    __shared__ int s_wc[kWarps][kKeys];     // a round's lines a warp a key
    __shared__ int s_base[kKeys];           // a key's first sorted place
    __shared__ int s_tot[kKeys];            // a round's lines a key
    __shared__ uint8_t s_key[kRoundLines];
    __shared__ uint16_t s_sorted[kRoundLines];   // round lines by key
    __shared__ long long s_tmp[kWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long b = blockIdx.x, nb = gridDim.x;
    const long long j_lo = offs[b], j_hi = offs[b + 1];
    if (j_lo == j_hi) return;
    {
        // the key's first slot: the earlier keys' lines, then the earlier
        // blocks' lines of the key
        const int k = threadIdx.x;
        const long long t = k < kKeys ? ktot[k] : 0;
        long long all;
        const long long kb = block_excl_sum(t, s_tmp, &all);
        if (k < kKeys) s_next[k] = kb + slots[(long long)k * nb + b];
    }
    const unsigned below = (1u << lane) - 1u;
    for (long long j0 = j_lo; j0 < j_hi; j0 += kRoundLines) {
        const int cnt = (int)(j_hi - j0 < kRoundLines ? j_hi - j0
                                                       : kRoundLines);
        for (int i = threadIdx.x; i <= cnt; i += kThreads)
            s_nl[i] = j0 + i - 1 >= 0 ? nl[j0 + i - 1] : -1;
        for (int k = threadIdx.x; k < kKeys; k += kThreads)
            for (int w = 0; w < kWarps; ++w) s_wc[w][k] = 0;
        __syncthreads();
        // a warp ranks its run of kLinesPerThread * 32 lines, 32 at a step
        int key[kLinesPerThread], rank[kLinesPerThread];
#pragma unroll
        for (int s = 0; s < kLinesPerThread; ++s) {
            const int li = (warp * kLinesPerThread + s) * 32 + lane;
            key[s] = li < cnt ? len_key(s_nl[li + 1] - s_nl[li] - 1) : -1;
            const unsigned peers = __match_any_sync(0xffffffffu, key[s]);
            rank[s] = 0;
            if (key[s] >= 0) {
                rank[s] = s_wc[warp][key[s]] + __popc(peers & below);
                s_key[li] = (uint8_t)key[s];
            }
            __syncwarp();
            if (key[s] >= 0 && (__ffs(peers) - 1) == lane)
                s_wc[warp][key[s]] += __popc(peers);
            __syncwarp();
        }
        __syncthreads();
        {
            // each key's warps in order, then the keys in order
            const int k = threadIdx.x;
            int run = 0;
            if (k < kKeys)
                for (int w = 0; w < kWarps; ++w) {
                    const int c = s_wc[w][k];
                    s_wc[w][k] = run;
                    run += c;
                }
            int all;
            const int kb = block_excl_sum(run, reinterpret_cast<int*>(s_tmp),
                                          &all);
            if (k < kKeys) {
                s_base[k] = kb;
                s_tot[k] = run;
            }
        }
        __syncthreads();
#pragma unroll
        for (int s = 0; s < kLinesPerThread; ++s)
            if (key[s] >= 0)
                s_sorted[s_base[key[s]] + s_wc[warp][key[s]] + rank[s]] =
                    (uint16_t)((warp * kLinesPerThread + s) * 32 + lane);
        __syncthreads();
        for (int q = threadIdx.x; q < cnt; q += kThreads) {
            const int li = s_sorted[q];
            const int k = s_key[li];
            const long long at = s_next[k] + (q - s_base[k]);
            const long long st = s_nl[li] + 1;
            starts[at] = st;
            lens[at] = s_nl[li + 1] - st;
            ords[at] = j0 + li;
        }
        __syncthreads();
        for (int k = threadIdx.x; k < kKeys; k += kThreads)
            s_next[k] += s_tot[k];
        __syncthreads();
    }
}

}  // namespace
}  // namespace line_index

using namespace line_index;

extern "C" {

// Threads a block, text bytes a block (every pass's grid), lines a round
// of the scatter and the sort's keys.
int line_index_geometry(int* threads, int* bytes_per_block,
                        int* round_lines, int* keys) {
    *threads = kThreads;
    *bytes_per_block = kBytesPerBlock;
    *round_lines = kRoundLines;
    *keys = kKeys;
    return 0;
}

// Blocks of every pass but 2 and 4 for a text of n bytes at `text`: its
// 16-byte pieces from the aligned address at or below text, a block's
// share at a time.
long long line_index_text_grid(const uint8_t* text, long long n) {
    if (n < 1) return 0;
    return text_grid(make_text(text, n));
}

// Pass 1 on `stream`: counts[b] and last[b] (int64 [grid] each) = the
// newlines (bytes equal to delim, 0-255) of block b's bytes and the last
// one's position (-1 without one), with grid = line_index_text_grid(text,
// n), and masks u16 [grid * bytes_per_block / 16], each 16-byte piece's
// newline bits (0 past the text) for pass 3.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments the kernel does
// not take).  All pointers are device pointers.
int line_index_count(const uint8_t* text, long long n, long long* counts,
                     long long* last, uint16_t* masks, int grid, int delim,
                     void* stream) {
    if (n < 1 || grid != line_index_text_grid(text, n) || delim < 0
        || delim > 255)
        return (int)cudaErrorInvalidValue;
    count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        make_text(text, n, delim), counts, last, masks);
    return (int)cudaGetLastError();
}

// Pass 2 on `stream`, one block: offs int64 [grid + 1], the exclusive
// prefix sum of pass 1's counts (offs[grid] = K); prev int64 [grid], the
// exclusive prefix max of its last newlines (-1 before the first); meta
// int64 [2] = (K, the last newline or -1).
int line_index_offsets(const long long* counts, const long long* last,
                       int grid, long long* offs, long long* prev,
                       long long* meta, void* stream) {
    if (grid < 1) return (int)cudaErrorInvalidValue;
    offsets_kernel<<<1, kScanThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        counts, last, grid, offs, prev, meta);
    return (int)cudaGetLastError();
}

// Pass 3 on `stream`, the text and grid of pass 1, with its masks and
// pass 2's offs and prev: the newlines' positions into nl int64 [K], in
// stream order, and hist int32 [keys * grid], key-major, the lines of each
// key whose newline lies in each block.
int line_index_write(const uint8_t* text, long long n,
                     const uint16_t* masks, const long long* offs,
                     const long long* prev, long long* nl, int* hist,
                     int grid, void* stream) {
    if (n < 1 || grid != line_index_text_grid(text, n))
        return (int)cudaErrorInvalidValue;
    write_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        make_text(text, n), masks, offs, prev, nl, hist);
    return (int)cudaGetLastError();
}

// Pass 4 on `stream`, a block a key: slots int64 [keys * grid], each key
// row's exclusive prefix sum of pass 3's hist, and ktot int64 [keys], the
// key's lines.
int line_index_keys(const int* hist, int grid, long long* slots,
                    long long* ktot, void* stream) {
    if (grid < 1) return (int)cudaErrorInvalidValue;
    keys_kernel<<<kKeys, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        hist, grid, slots, ktot);
    return (int)cudaGetLastError();
}

// Pass 5 on `stream`, the grid of pass 1, with the outputs of passes 2-4:
// the lines' starts, lengths and stream ordinals into starts, lens and
// ords (int64 [K] each), in length order.
int line_index_scatter(const long long* nl, const long long* offs,
                       const long long* slots, const long long* ktot,
                       long long* starts, long long* lens, long long* ords,
                       int grid, void* stream) {
    if (grid < 1) return (int)cudaErrorInvalidValue;
    scatter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        nl, offs, slots, ktot, starts, lens, ords);
    return (int)cudaGetLastError();
}

const char* line_index_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
