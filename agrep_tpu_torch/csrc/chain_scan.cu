// Exact multi-term match starts for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// agrep_tpu/ops/chain_kernel.py::_get_chain_kernel (the `run` it returns,
// pl.pallas_call at chain_kernel.py:233).  It computes the same function,
//     start[i] = OR_term AND_t (tr[text[i+t]] == tr[term[t]]),
// with bytes past the end of the text read as 0, packed 32 positions to a
// u32 word (bit r of word w: a term starts at byte 32*w + r).  None of the
// TPU layout carries over: the TPU kernel transposed the bytes into eight
// bit planes, built one equality plane per folded character class from a
// cube cover, and ANDed shifted planes along every term (lanes, tail halos
// and an unrolled body were Mosaic's workarounds).
//
// What bounds it on an H100: by the function's least work, the bytes: the
// text read once and the plane written once, 0.0352 ms per 100 MB at
// 3.35 TB/s.  A multi-string automaton needs about 3 int32 operations and
// 2 shared loads a byte (chip_smoke.py chain_ops), under that.  What each
// part of the design does about it:
//
//   * Class-pair buckets.  The program is a 256-entry byte -> class
//     table, the terms as strings of class ids sorted by their first two
//     classes, and device_program's prefix-sum table over the pair (class
//     of byte i, class of byte i + 1), NO_CLASS counting as class n_cls:
//     (n_cls + 1)^2 + 1 i16 entries, 64 KB as words at 127 classes.  Its
//     caps are those of these tables (i16 term offsets, 7-bit class ids)
//     and of the shared memory a block may take; chain_kernel.fits holds
//     them, and compile_chain and the Python launcher check it.  Bit 7
//     of a class id in shared memory flags a class that has a one-byte
//     term: such a position matches whatever follows.  Any other
//     position tests only the terms of its pair, from their third class
//     on, each with early exit at its first mismatch, and no more terms
//     once one matched.
//   * A candidate bitmap.  Each block sets one bit for every class
//     triple a term starts with (row c0, word c0 ^ c1, bit c2: 4 KB,
//     when the classes and NO_CLASS fit in 32), or, past 31 classes, for
//     every pair (four words a row); every triple or pair after a term's
//     last class, or after a class with a one-byte term, is set too.  A
//     position costs one probe; only those whose bit is set go on to the
//     bucket test: on config 5's text 8.1 % of positions pass a pair
//     filter and almost none the triples.  The XOR spreads a warp's
//     probes over the banks: 2.8 shared accesses a probe on that text,
//     4.5 without it (both counted by tools/torch_chain_scan_phases.py).
//   * A lane owns 32 consecutive positions, one output word.  It reads
//     their 34 class bytes as nine 4-byte words of a class buffer that
//     skips one word after every eight, so that the 32 lanes of a warp
//     read 32 different banks, probes the bitmap for each position, then
//     runs one loop over its own candidates: the warp waits for the lane
//     with the most once.  The lanes' words make one 128-byte store.
//     A first form, a position a thread and a ballot a word with the
//     test inline, waited on three dependent shared loads a position and
//     on a term loop that diverged in the 81 % of config 5's rounds of 32
//     positions that hold a pair candidate.  The same tool times the
//     kernel with its parts cut out; PERF.md has what it shows.
//   * A persistent grid.  About as many blocks as the SMs hold each load
//     the program into dynamic shared memory once, then walk every
//     gridDim.x-th tile of `tile` start positions.
//   * 16-byte staging, double-buffered.  Each tile's bytes and its
//     max(maxlen, 2) - 1 halo (halo()) are copied with cp.async, 16
//     bytes a thread, from the aligned address at or below the tile's
//     first byte into a raw buffer, while the block computes the previous
//     tile; the chunks that reach past either end of the text are loaded
//     byte by byte (bytes outside it as 0), so the text may start at any
//     address and have any length.  The block then translates the raw
//     bytes to class ids, four a thread at a time, into the class buffer.
//
// Built by ops/_cuda.py as one object with a plain C interface:
// nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
// -fPIC.

#include <cstdint>
#include <cuda_runtime.h>

namespace chain_scan {

constexpr int kThreads = 256;
constexpr int kNoClass = 255;         // class_of's id of a byte no term holds
constexpr int kSingle = 0x80;         // flag: the class has a one-byte term
constexpr int kMinTile = 1024;        // a warp's 32 words
constexpr int kMaxTile = 65536;

struct Layout {
    int raw;        // bytes of one raw buffer; two sit at offset 0
    int cls, rows, range, off, map, term, total;
};

// Whether the classes, NO_CLASS included, fit in 32 bits: then the
// candidate bitmap is over class triples, else over pairs.
__host__ __device__ inline bool narrow(int n_cls) { return n_cls < 32; }

// Words of the candidate bitmap for a first class: 32 rows of one word
// (second class, bit: third class) when narrow, else one row of four
// (bit: second class).
__host__ __device__ inline int row_words(int n_cls) {
    return narrow(n_cls) ? 32 : 4;
}

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// Bytes a tile reads past its last start position: a term's length - 1,
// at least 1 (the pair of the last position).
__host__ __device__ inline int halo(int maxlen) {
    return (maxlen > 2 ? maxlen : 2) - 1;
}

// Class words a tile needs: its span of positions, four a word, and one
// more, which the last lane of the last warp reads.
__host__ __device__ inline int class_words(int tile, int maxlen) {
    return (tile + halo(maxlen) + 3) / 4 + 1;
}

// A raw buffer holds a tile plus its halo, widened to whole 16-byte
// chunks (up to 15 bytes before the tile's first byte and 15 of
// round-up), and the translation reads one word past the class words:
// the halo and 32 bytes past the tile, 16-byte aligned.
__host__ __device__ inline int stage_slack(int maxlen) {
    return align16(halo(maxlen) + 32);
}

// chain_kernel.smem_bytes mirrors the total.
__host__ __device__ inline Layout layout(int n_cls, int n_pos, int n_terms,
                                         int maxlen, int tile) {
    const int pairs = (n_cls + 1) * (n_cls + 1);
    const int cw = class_words(tile, maxlen);
    Layout l;
    l.raw = tile + stage_slack(maxlen);
    l.cls = 2 * l.raw;
    l.rows = l.cls + align16(4 * (cw + cw / 8 + 1));
    l.range = l.rows + align16(4 * (n_cls + 1) * row_words(n_cls));
    l.off = l.range + 4 * pairs;
    l.map = l.off + align16(2 * (n_terms + 1));
    l.term = l.map + 4 * 256;
    l.total = l.term + align16(n_pos);
    return l;
}

namespace {

__device__ __forceinline__ void cp_async16(void* dst, uintptr_t src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    const size_t g = __cvta_generic_to_global(reinterpret_cast<void*>(src));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Issue the copy of bytes [g0, g0 + span) of the text into raw, from the
// 16-byte aligned address at or below text + g0: raw[i] holds the byte at
// that address + i, 0 outside [text, text + n).
__device__ __forceinline__ void stage(uint8_t* raw, const uint8_t* text,
                                      long long n, long long g0, int span) {
    const uintptr_t lo = reinterpret_cast<uintptr_t>(text);
    const uintptr_t hi = lo + (uintptr_t)n;
    const uintptr_t a0 = (lo + (uintptr_t)g0) & ~(uintptr_t)15;
    const int chunks = (int)((lo + (uintptr_t)g0 - a0 + span + 15) >> 4);
    for (int c = threadIdx.x; c < chunks; c += kThreads) {
        const uintptr_t src = a0 + 16 * (uintptr_t)c;
        uint8_t* dst = raw + 16 * c;
        if (src >= lo && src + 16 <= hi) {
            cp_async16(dst, src);
        } else if (src >= hi) {
            *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
        } else {
            for (int b = 0; b < 16; ++b) {
                const uintptr_t a = src + b;
                dst[b] = a >= lo && a < hi
                    ? __ldg(reinterpret_cast<const uint8_t*>(a)) : 0;
            }
        }
    }
}

// The class byte of position j in the class buffer (one word skipped
// after every eight).
__device__ __forceinline__ int class_at(const uint8_t* cls, int j) {
    return cls[j + ((j >> 5) << 2)];
}

// Whether a term starts at position j, whose bitmap bit is set.
__device__ __forceinline__ bool starts_here(
        const uint8_t* cls, int j, int stride, const uint32_t* s_range,
        const uint16_t* s_off, const uint8_t* s_term) {
    const int c0 = class_at(cls, j), c1 = class_at(cls, j + 1);
    if (c0 & kSingle) return true;
    const uint32_t r = s_range[c0 * stride + (c1 & ~kSingle)];
    for (int t = r & 0xffff; t < (int)(r >> 16); ++t) {
        const int o = s_off[t], e = s_off[t + 1];
        int k = 2;              // the pair matched positions 0 and 1
        while (o + k < e && class_at(cls, j + k) == s_term[o + k]) ++k;
        if (o + k == e) return true;
    }
    return false;
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
chain_scan_kernel(const uint8_t* __restrict__ text, long long n,
                  const uint8_t* __restrict__ class_of,
                  const uint8_t* __restrict__ single, int n_cls,
                  const uint8_t* __restrict__ term_cls, int n_pos,
                  const int16_t* __restrict__ term_off, int n_terms,
                  const int16_t* __restrict__ pair, int maxlen, int tile,
                  uint32_t* __restrict__ out) {
    extern __shared__ __align__(16) uint8_t smem[];
    const Layout l = layout(n_cls, n_pos, n_terms, maxlen, tile);
    uint32_t* s_cls = reinterpret_cast<uint32_t*>(smem + l.cls);
    uint32_t* s_rows = reinterpret_cast<uint32_t*>(smem + l.rows);
    uint32_t* s_range = reinterpret_cast<uint32_t*>(smem + l.range);
    uint16_t* s_off = reinterpret_cast<uint16_t*>(smem + l.off);
    uint32_t* s_map = reinterpret_cast<uint32_t*>(smem + l.map);
    uint8_t* s_term = smem + l.term;
    const int tid = threadIdx.x, lane = tid & 31;
    const int stride = n_cls + 1, pairs = stride * stride;
    const long long n_tiles = (n + tile - 1) / tile;
    const long long n_words = (n + 31) >> 5;
    const int span = tile + halo(maxlen);

    // the first tile's copy goes out before the program loads
    long long t = blockIdx.x;
    stage(smem, text, n, t * tile, span);
    cp_async_commit();
    // pair bucket q as one word: first term | end << 16
    for (int i = tid; i < pairs; i += kThreads)
        s_range[i] = (uint32_t)(uint16_t)pair[i]
            | (uint32_t)(uint16_t)pair[i + 1] << 16;
    for (int i = tid; i <= n_terms; i += kThreads)
        s_off[i] = (uint16_t)term_off[i];
    for (int i = tid; i < 256; i += kThreads) {
        const int c = class_of[i];
        s_map[i] = (uint32_t)(c == kNoClass
                              ? n_cls : c | (single[c] ? kSingle : 0));
    }
    for (int i = tid; i < n_pos; i += kThreads) {
        const int c = term_cls[i];
        s_term[i] = (uint8_t)(c | (single[c] ? kSingle : 0));
    }
    constexpr int kRow = kWide ? 4 : 32;
    for (int i = tid; i < stride * kRow; i += kThreads) s_rows[i] = 0;
    __syncthreads();
    // the candidate bitmap: the classes a term starts with (two or,
    // when narrow, three), every class after a term's last, every pair
    // after a class with a one-byte term
    const int n_multi = pair[pairs];    // terms of two or more classes
    for (int i = tid; i < n_multi; i += kThreads) {
        const int o = s_off[i], len = s_off[i + 1] - o;
        const int c0 = s_term[o] & ~kSingle, c1 = s_term[o + 1] & ~kSingle;
        if (kWide)
            atomicOr(&s_rows[4 * c0 + (c1 >> 5)], 1u << (c1 & 31));
        else
            atomicOr(&s_rows[32 * c0 + (c0 ^ c1)],
                     len > 2 ? 1u << (s_term[o + 2] & ~kSingle) : ~0u);
    }
    for (int i = tid; i < n_cls * kRow; i += kThreads)
        if (single[i / kRow]) s_rows[i] = ~0u;

    const int n_cw = class_words(tile, maxlen);
    for (int k = 0; t < n_tiles; ++k, t += gridDim.x) {
        const uint8_t* raw = smem + (k & 1) * l.raw;
        if (t + gridDim.x < n_tiles)
            stage(smem + ((k + 1) & 1) * l.raw, text, n,
                  (t + gridDim.x) * tile, span);
        cp_async_commit();
        cp_async_wait<1>();     // this tile's copies (this thread's)
        // everyone's, the program, and the previous tile's last reads of
        // the class buffer
        __syncthreads();
        const long long g0 = t * tile;
        const int shift =
            (int)((reinterpret_cast<uintptr_t>(text) + (uintptr_t)g0) & 15);
        const uint32_t* rw =
            reinterpret_cast<const uint32_t*>(raw) + (shift >> 2);
        for (int w = tid; w < n_cw; w += kThreads) {
            const uint32_t v = __funnelshift_r(rw[w], rw[w + 1],
                                               8 * (shift & 3));
            s_cls[w + (w >> 3)] = s_map[v & 255] | s_map[(v >> 8) & 255] << 8
                | s_map[(v >> 16) & 255] << 16 | s_map[v >> 24] << 24;
        }
        __syncthreads();
        const uint8_t* cls = reinterpret_cast<const uint8_t*>(s_cls);
        const int lim = (int)(n - g0 < tile ? n - g0 : tile);
        for (int grp = tid >> 5; grp < tile >> 10; grp += kThreads >> 5) {
            // this lane's positions: j0 .. j0 + 31, class words 8 r + m at
            // 9 r + m, r = 32 grp + lane
            const int j0 = (grp << 10) + (lane << 5);
            const int base = 9 * (j0 >> 5);
            uint32_t x[9];
#pragma unroll
            for (int m = 0; m < 8; ++m)
                x[m] = s_cls[base + m] & 0x7f7f7f7fu;
            x[8] = s_cls[base + 9] & 0x7f7f7f7fu;
            // bit p of cand: the bitmap bit of position j0 + p, shifted
            // in from the top
            uint32_t cand = 0;
            uint32_t c0 = x[0] & 0xff, c1 = (x[0] >> 8) & 0xff;
#pragma unroll
            for (int p = 0; p < 32; ++p) {
                if (kWide) {
                    cand = __funnelshift_r(
                        cand, s_rows[4 * c0 + (c1 >> 5)] >> (c1 & 31), 1);
                    c0 = c1;
                    c1 = __byte_perm(x[(p + 2) >> 2], 0,
                                     0x4440 + ((p + 2) & 3));
                } else {
                    const uint32_t c2 = __byte_perm(x[(p + 2) >> 2], 0,
                                                    0x4440 + ((p + 2) & 3));
                    cand = __funnelshift_r(
                        cand, s_rows[32 * c0 + (c0 ^ c1)] >> c2, 1);
                    c0 = c1;
                    c1 = c2;
                }
            }
            if (lim - j0 < 32)
                cand &= lim <= j0 ? 0u : (1u << (lim - j0)) - 1;
            uint32_t hits = 0;
            while (cand) {
                const int p = __ffs(cand) - 1;
                cand &= cand - 1;
                if (starts_here(cls, j0 + p, stride, s_range, s_off,
                                s_term))
                    hits |= 1u << p;
            }
            const long long w = (g0 >> 5) + (j0 >> 5);
            if (w < n_words) out[w] = hits;
        }
    }
    cp_async_wait<0>();
}

// The kernel instance for n_cls classes.
void* kernel_for(int n_cls) {
    return narrow(n_cls)
        ? reinterpret_cast<void*>(chain_scan_kernel<false>)
        : reinterpret_cast<void*>(chain_scan_kernel<true>);
}

// What the launch can encode at all: class ids below the kSingle flag,
// i16 term offsets, no term longer than the terms' positions, a tile of
// whole warps' words.  The caps inside these are chain_kernel.fits.
bool encodable(int n_cls, int n_pos, int n_terms, int maxlen, int tile) {
    return n_cls >= 1 && n_cls < kSingle && n_terms >= 1
        && n_terms <= n_pos && n_pos <= INT16_MAX && maxlen >= 1
        && maxlen <= n_pos && tile >= kMinTile && tile <= kMaxTile
        && tile % kMinTile == 0;
}

}  // namespace
}  // namespace chain_scan

using namespace chain_scan;

extern "C" {

// The dynamic shared bytes a block of the current device may take
// (cudaDevAttrMaxSharedMemoryPerBlockOptin).  Returns a cudaError_t.
int chain_scan_smem_optin(int* bytes) {
    int device = 0;
    const cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaDeviceGetAttribute(
        bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// Geometry of a launch: threads a block, dynamic shared bytes a block and
// how many such blocks one SM of the current device holds.  Returns a
// cudaError_t (cudaErrorInvalidValue for arguments the kernel does not
// take).
int chain_scan_geometry(int n_cls, int n_pos, int n_terms, int maxlen,
                        int tile, int* threads, int* smem_bytes,
                        int* blocks_per_sm) {
    if (!encodable(n_cls, n_pos, n_terms, maxlen, tile))
        return (int)cudaErrorInvalidValue;
    const int smem = layout(n_cls, n_pos, n_terms, maxlen, tile).total;
    const void* kernel = kernel_for(n_cls);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, kThreads, smem);
    *threads = kThreads;
    *smem_bytes = smem;
    return (int)err;
}

// Launches the chain scan on `stream` with `grid` blocks (at most one a
// tile); returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).  All
// pointers are device pointers; text may start at any address.
// class_of u8[256], single u8[n_cls] (1: a one-byte term has that class),
// term_cls u8[n_pos], term_off i16[n_terms + 1] (term t is
// term_cls[term_off[t] : term_off[t + 1]]), pair i16[(n_cls + 1)^2 + 1]
// (the terms whose first two classes are (a, b) are pair[q] .. pair[q +
// 1] - 1, q = a * (n_cls + 1) + b, NO_CLASS as n_cls; one-byte terms
// after all of them), out u32[ceil(n / 32)].
int chain_scan_launch(const uint8_t* text, long long n,
                      const uint8_t* class_of, const uint8_t* single,
                      int n_cls, const uint8_t* term_cls, int n_pos,
                      const int16_t* term_off, int n_terms,
                      const int16_t* pair, int maxlen, uint32_t* out,
                      int tile, int grid, void* stream) {
    if (n < 1 || !encodable(n_cls, n_pos, n_terms, maxlen, tile)
        || grid < 1)
        return (int)cudaErrorInvalidValue;
    if (grid > (n + tile - 1) / tile) grid = (int)((n + tile - 1) / tile);
    const int smem = layout(n_cls, n_pos, n_terms, maxlen, tile).total;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel_for(n_cls), cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (narrow(n_cls))
        chain_scan_kernel<false><<<grid, kThreads, smem, s>>>(
            text, n, class_of, single, n_cls, term_cls, n_pos, term_off,
            n_terms, pair, maxlen, tile, out);
    else
        chain_scan_kernel<true><<<grid, kThreads, smem, s>>>(
            text, n, class_of, single, n_cls, term_cls, n_pos, term_off,
            n_terms, pair, maxlen, tile, out);
    return (int)cudaGetLastError();
}

const char* chain_scan_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
