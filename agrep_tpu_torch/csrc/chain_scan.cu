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
// and an unrolled body were Mosaic's workarounds).  Here:
//
//   * The program is small (compile_chain caps it at 2400 term positions,
//     96 classes, terms of at most 128 bytes) and lives in shared memory:
//     a 256-entry byte -> class table (255: a byte no term holds), the
//     terms as strings of class ids, sorted by their first class, and
//     for each class the range of terms that start with it.
//   * A block owns kTile consecutive start positions.  It stages their
//     bytes plus a halo of maxlen - 1, translated to class ids, in shared
//     memory; bytes past N stage as the class of byte 0.
//   * One thread tests one position: only the terms whose first class is
//     the position's class, each with early exit at its first mismatch,
//     and no more terms once one matched.  __ballot_sync packs the 32
//     verdicts of a warp into the output word, which lane 0 writes.
//
// What bounds it on an H100: by the function's least work, the bytes: the
// text read once and the plane written once, ~0.035 ms per 100 MB at
// 3.35 TB/s.  A multi-string automaton needs about 3 int32 operations and
// 2 shared loads a byte (chip_smoke.py chain_ops), under that; the TPU
// kernel's bit-plane form needs about 80 operations a byte, one design's
// count and not a bound.  This design costs a position one shared load
// and its first class's terms, so it is cheap on text where few
// positions begin a term and dear where many do.  Known slack left for a
// later change: byte-wide global loads in the staging loop (16-byte loads
// would cut the load instructions 16-fold), the program re-read from L2
// by every block (a persistent grid would read it once per SM), and warps
// that diverge over buckets of different sizes.
//
// Built by ops/_cuda.py as one object with a plain C interface:
// nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
// -fPIC.

#include <cstdint>
#include <cuda_runtime.h>

namespace chain_scan {

constexpr int kThreads = 512;
constexpr int kTile = 16384;          // start positions a block owns
constexpr int kMaxLen = 128;          // compile_chain's longest term
constexpr int kMaxPositions = 2400;   // compile_chain's MAX_POSITIONS
constexpr int kClasses = 256;         // class ids are bytes; 255 = none

namespace {

__global__ void __launch_bounds__(kThreads)
chain_scan_kernel(const uint8_t* __restrict__ text, long long n,
                  const uint8_t* __restrict__ class_of,
                  const uint8_t* __restrict__ term_cls, int n_pos,
                  const int16_t* __restrict__ term_off, int n_terms,
                  const int16_t* __restrict__ bucket, int maxlen,
                  uint32_t* __restrict__ out, long long n_words) {
    __shared__ uint8_t s_cls[kTile + kMaxLen - 1];
    __shared__ uint8_t s_map[256];
    __shared__ uint8_t s_term[kMaxPositions];
    __shared__ uint16_t s_off[kMaxPositions + 1];
    __shared__ uint16_t s_bucket[kClasses + 1];
    const int tid = threadIdx.x;
    for (int i = tid; i < 256; i += kThreads) s_map[i] = class_of[i];
    for (int i = tid; i < n_pos; i += kThreads) s_term[i] = term_cls[i];
    for (int i = tid; i <= n_terms; i += kThreads)
        s_off[i] = (uint16_t)term_off[i];
    for (int i = tid; i <= kClasses; i += kThreads)
        s_bucket[i] = (uint16_t)bucket[i];
    __syncthreads();

    const long long base = (long long)blockIdx.x * kTile;
    const int span = kTile + maxlen - 1;
    for (int i = tid; i < span; i += kThreads) {
        const long long g = base + i;
        s_cls[i] = s_map[g < n ? __ldg(text + g) : 0];
    }
    __syncthreads();

    // kTile is a multiple of kThreads: every lane of a warp runs every
    // iteration, so the full-mask ballot is well formed
    for (int j = tid; j < kTile; j += kThreads) {
        bool hit = false;
        if (base + j < n) {
            const int c0 = s_cls[j];
            const int t_end = s_bucket[c0 + 1];
            for (int t = s_bucket[c0]; t < t_end && !hit; ++t) {
                const int o = s_off[t], e = s_off[t + 1];
                int k = 1;              // the bucket matched position 0
                while (o + k < e && s_cls[j + k] == s_term[o + k]) ++k;
                hit = o + k == e;
            }
        }
        const unsigned word = __ballot_sync(0xffffffffu, hit);
        if ((tid & 31) == 0) {
            const long long w = (base + j) >> 5;
            if (w < n_words) out[w] = word;
        }
    }
}

}  // namespace
}  // namespace chain_scan

using namespace chain_scan;

extern "C" {

// Launches the chain scan on `stream`; returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for arguments the kernel does not
// take).  All pointers are device pointers: class_of u8[256], term_cls
// u8[n_pos], term_off i16[n_terms + 1] (term t is term_cls[term_off[t] :
// term_off[t + 1]]), bucket i16[257] (the terms whose first class is c
// are bucket[c] .. bucket[c + 1] - 1), out u32[ceil(n / 32)].
int chain_scan_launch(const uint8_t* text, long long n,
                      const uint8_t* class_of, const uint8_t* term_cls,
                      int n_pos, const int16_t* term_off, int n_terms,
                      const int16_t* bucket, int maxlen, uint32_t* out,
                      void* stream) {
    if (n < 1 || n_terms < 1 || n_terms > n_pos || n_pos > kMaxPositions
        || maxlen < 1 || maxlen > kMaxLen
        || (n + kTile - 1) / kTile > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    const long long n_words = (n + 31) / 32;
    const long long blocks = (n + kTile - 1) / kTile;
    chain_scan_kernel<<<(unsigned)blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        text, n, class_of, term_cls, n_pos, term_off, n_terms, bucket,
        maxlen, out, n_words);
    return (int)cudaGetLastError();
}

const char* chain_scan_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
