// Native host-side runtime for agrep_tpu_torch.
//
// The GPU owns the dense scan; this library owns the byte-sequential
// host work that would be slow in Python:
//
//  * the reference-conformance control-flow emulations (Boyer-Moore
//    skip-loop walk for the -v early-return quirk, the partition
//    engine's candidate construction, the long-approximate filter +
//    banded verifier) -- see runtime/sgrep_sim.py for the
//    specification; these are the same algorithms at C speed,
//  * multi-string occurrence search for the mgrep engine,
//  * record-boundary search for arbitrary delimiters.
//
// Exposed as a plain C ABI consumed through ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------
// Record/delimiter scanning
// ---------------------------------------------------------------

#if defined(__x86_64__)
// Two-byte-anchored candidate scan: 32-wide compare of delim[0] at i
// and delim[1] at i+1 (the AND kills almost every false candidate for
// multi-byte delimiters), emit from the movemask bits.  The memchr /
// memmem restart loop pays ~40-160ns per HIT, which dominates on
// delimiter-dense record corpora ('\n' every ~70 bytes, '$$' every
// ~200); this runs at memory speed regardless of hit density.
__attribute__((target("avx2")))
static int64_t find_delims_avx2(const uint8_t* buf, int64_t n,
                                const uint8_t* delim, int64_t dl,
                                int64_t* out, int64_t cap) {
    int64_t cnt = 0;
    int64_t lim = n - dl;            // last candidate start, inclusive
    if (lim < 0) return 0;
    __m256i v0 = _mm256_set1_epi8((char)delim[0]);
    __m256i v1 = _mm256_set1_epi8((char)delim[dl >= 2 ? 1 : 0]);
    int64_t i = 0;
    for (; i + 33 <= n; i += 32) {
        __m256i a = _mm256_loadu_si256((const __m256i*)(buf + i));
        __m256i hit = _mm256_cmpeq_epi8(a, v0);
        if (dl >= 2) {
            __m256i b = _mm256_loadu_si256(
                (const __m256i*)(buf + i + 1));
            hit = _mm256_and_si256(hit, _mm256_cmpeq_epi8(b, v1));
        }
        uint32_t m = (uint32_t)_mm256_movemask_epi8(hit);
        while (m) {
            int64_t s = i + __builtin_ctz(m);
            m &= m - 1;
            if (s > lim) break;
            bool ok = true;
            for (int64_t k = 2; k < dl; k++)
                if (buf[s + k] != delim[k]) { ok = false; break; }
            if (!ok) continue;
            if (cnt < cap) out[cnt] = s + dl - 1;
            if (++cnt >= cap) return cnt;
        }
    }
    for (int64_t s = i; s <= lim; s++) {
        bool ok = true;
        for (int64_t k = 0; k < dl; k++)
            if (buf[s + k] != delim[k]) { ok = false; break; }
        if (!ok) continue;
        if (cnt < cap) out[cnt] = s + dl - 1;
        if (++cnt >= cap) return cnt;
    }
    return cnt;
}
#endif

// Find all occurrences of delim in buf; writes end positions (index of
// the delimiter's LAST byte).  Returns count (capped at cap).
int64_t find_delims(const uint8_t* buf, int64_t n, const uint8_t* delim,
                    int64_t dl, int64_t* out, int64_t cap) {
    int64_t cnt = 0;
#if defined(__x86_64__)
    if (__builtin_cpu_supports("avx2"))
        return find_delims_avx2(buf, n, delim, dl, out, cap);
#endif
    if (dl == 1) {
        const uint8_t* p = buf;
        const uint8_t* e = buf + n;
        while (p < e && cnt < cap) {
            const uint8_t* q =
                (const uint8_t*)memchr(p, delim[0], e - p);
            if (!q) break;
            out[cnt++] = q - buf;
            p = q + 1;
        }
        return cnt;
    }
    const uint8_t* p = buf;
    const uint8_t* e = buf + n;
    while (p + dl <= e && cnt < cap) {
        const uint8_t* q =
            (const uint8_t*)memmem(p, e - p, delim, dl);
        if (!q) break;
        out[cnt++] = (q - buf) + dl - 1;
        p = q + 1;
    }
    return cnt;
}

// Multi-string exact occurrence search (folded): start positions of
// term in buf under fold table tr.  Returns count (capped).
int64_t find_occurrences(const uint8_t* buf, int64_t n,
                         const uint8_t* term, int64_t tl,
                         const uint8_t* tr, int64_t* out, int64_t cap) {
    if (tl <= 0 || n < tl) return 0;
    int64_t cnt = 0;
    uint8_t t0 = tr[term[0]];
    for (int64_t i = 0; i + tl <= n && cnt < cap; i++) {
        if (tr[buf[i]] != t0) continue;
        int64_t k = 1;
        while (k < tl && tr[buf[i + k]] == tr[term[k]]) k++;
        if (k == tl) out[cnt++] = i;
    }
    return cnt;
}

// ---------------------------------------------------------------
// bm() skip-loop walk (sgrep.c:723-985) -- INVERSE tail decision
// ---------------------------------------------------------------

// Returns 1 if bm reaches its INVERSE tail print, 0 on early return.
int bm_inverse_survives(const uint8_t* buf, int64_t buflen,
                        int64_t start, int64_t end, const uint8_t* pat,
                        int64_t m, const int32_t* shift_tab,
                        int32_t shift_1, const uint8_t* tr,
                        const int64_t* resume, int64_t n_resume,
                        int32_t wordbound) {
    auto isaln = [](uint8_t c) {
        return (c >= '0' && c <= '9') || (c >= 'A' && c <= 'Z')
            || (c >= 'a' && c <= 'z');
    };
    int64_t text = start;
    int64_t sh = 0;
    int64_t textend = end;
    int64_t ridx = 0;
    int64_t guard = 0;
    int64_t guard_max = 10 * (buflen + m + 512);
    while (text < textend) {
        while (sh) {
            text += sh;
            // running off the virtual buffer: the reference strides
            // through heap bytes until a zero-shift candidate, which
            // mismatches on garbage -- the tail print survives
            if (text >= buflen) return 1;
            sh = shift_tab[buf[text]];
            if (++guard > guard_max) return 0;
        }
        int64_t j = 0;
        while (j < m && text - j >= 0 &&
               tr[buf[text - j]] == tr[pat[m - 1 - j]]) j++;
        if (j == m) {
            if (text > textend) return 0;   // sgrep.c:748
            if (wordbound) {
                // sgrep.c:749-753: rejected match steps by 1 (the
                // `shift=1; goto CONT` path), no record jump
                uint8_t a1 = (text + 1 < buflen) ? buf[text + 1] : 0;
                uint8_t b1 = (text - m >= 0) ? buf[text - m] : 0;
                if (isaln(a1) || isaln(b1)) {
                    sh = 1;
                    continue;
                }
            }
            // jump to this match's curtextend: the first resume entry
            // past text (record ends strictly increase with matches)
            while (ridx < n_resume && resume[ridx] <= text) ridx++;
            if (ridx < n_resume) {
                text = resume[ridx];
            } else {
                int64_t t = text + 1;
                while (t < textend && buf[t] != '\n') t++;
                text = t + 1;
            }
            sh = (text < buflen) ? shift_tab[buf[text]] : 1;
        } else {
            sh = shift_1;
        }
    }
    return 1;
}

// ---------------------------------------------------------------
// agrep() candidate construction (sgrep.c:1123-1154)
// ---------------------------------------------------------------

// Writes (lo, hi) pairs relative to `start`; returns pair count.
int64_t agrep_candidates(const uint8_t* buf, int64_t buflen,
                         int64_t start, int64_t end, const uint8_t* pat,
                         int64_t M, int64_t D, const int32_t* shift_tab,
                         int32_t d1, const uint8_t* member,
                         int64_t* out, int64_t cap) {
    int64_t m = M / (D + 1);
    int64_t r1 = (m < 3) ? m : 3;
    int64_t text = start;
    int64_t textend = end;
    int64_t sh = m - 1;
    int64_t cnt = 1;
    out[0] = 0; out[1] = 0;  // sentinel candidate (round 0)
    while (text < textend) {
        text += sh;
        if (text >= buflen) break;
        sh = shift_tab[buf[text]];
        while (sh) {
            text += sh;
            if (text >= buflen) { sh = 0; break; }
            sh = shift_tab[buf[text]];
            text += sh;
            if (text >= buflen) { sh = 0; break; }
            sh = shift_tab[buf[text]];
        }
        if (text >= buflen) break;
        int64_t h = buf[text];
        for (int64_t j = 1; j < r1; j++) h = (h << 2) + buf[text - j];
        if (member[h & 8191]) {
            int64_t i = text - start;
            if (i - M - D - 10 > out[2 * (cnt - 1) + 1]) {
                if (cnt >= cap) break;
                out[2 * cnt] = i - M - D - 2;
                out[2 * cnt + 1] = i + M + D;
                cnt++;
            } else {
                out[2 * (cnt - 1) + 1] = i + M + D;
            }
        }
        sh = d1;
    }
    return cnt;
}

// ---------------------------------------------------------------
// agrep() per-block count walk (sgrep.c:1166-1238): events inside a
// candidate round are consumed in scan order; each counted event
// jumps the scan index to the record end (or lastend), so events in
// the jumped-over span are never seen.
// ---------------------------------------------------------------

// Post-jump verification (sgrep.c:1201-1204): after a pulse the round
// machine resets every word to ~0 -- the UNSEEDED state -- and jumps to
// the record end.  A dense-scan event within m+D+2 bytes of the jump
// target may rely on skipped bytes / seeding the fresh machine lacks:
// replay the reference machine from the jump target and check the pulse.
static int fresh_pulse_ok(const uint8_t* buf, int64_t blen, int64_t tb,
                          int64_t frm, int64_t e,
                          const uint32_t* maskI, uint32_t endpos,
                          int64_t D) {
    uint32_t R1[9], R2[9];
    for (int64_t k = 0; k <= D; k++) R1[k] = R2[k] = 0xFFFFFFFFu;
    int half = 0;
    for (int64_t t = frm; t <= e; t++) {
        int64_t bi = tb + t;
        uint32_t c = (bi >= 0 && bi < blen) ? buf[bi] : 0;
        if (c == 0x0A)
            for (int64_t k = 0; k <= D; k++) R1[k] = R2[k] = 0xFFFFFFFFu;
        uint32_t r1 = maskI[c];
        uint32_t* A = half ? R2 : R1;
        uint32_t* B = half ? R1 : R2;
        A[0] = (B[0] >> 1) | r1;
        for (int64_t k = 1; k <= D; k++)
            A[k] = ((B[k] >> 1) | r1) & B[k - 1]
                   & ((A[k - 1] & B[k - 1]) >> 1);
        if (t == e) return (A[D] & endpos) == 0;
        half ^= 1;
    }
    return 0;
}

int64_t agrep_count_walk(const int64_t* events, const int64_t* rec_ends,
                         int64_t n_ev, const int64_t* cand,
                         int64_t n_cand, int64_t lo_g, int64_t m_pat,
                         int64_t D, const uint8_t* buf, int64_t blen,
                         int64_t tb, const uint32_t* maskI,
                         uint32_t endpos) {
    int64_t count = 0;
    int64_t lastend = 0;
    int64_t win = m_pat + D + 2;
    for (int64_t c = 0; c < n_cand; c++) {
        int64_t clo = cand[2 * c], chi = cand[2 * c + 1];
        if (clo < 0) clo = 0;
        // the machine is reset at round start; a match needs at least
        // m - D real characters of warmup
        int64_t warm = clo + (m_pat - D);
        // event cursor: first event >= lo_g + clo
        int64_t lo = 0, hi = n_ev;
        while (lo < hi) {
            int64_t mid = (lo + hi) >> 1;
            if (events[mid] < lo_g + clo) lo = mid + 1; else hi = mid;
        }
        int64_t k = lo;
        int64_t i = clo;
        int64_t fresh_from = -1;
        // the round body is 2x-unrolled with the bound checked once
        // per PAIR (sgrep.c:1175-1238): after a count-jump in the
        // first half the second half still consumes one byte -- even
        // past the round bound -- and can re-count an event there
        while (i < chi) {
            for (int half = 0; half < 2; half++) {
                while (k < n_ev && events[k] < lo_g + i) k++;
                int hit = (k < n_ev && events[k] == lo_g + i
                           && i + 1 >= warm);
                if (hit && fresh_from >= 0 && i - fresh_from < win
                        && !fresh_pulse_ok(buf, blen, tb, fresh_from,
                                           i, maskI, endpos, D)) {
                    hit = 0;
                    k++;            // event consumed, not counted
                }
                if (hit) {
                    count++;
                    int64_t idx = i + 1;
                    if (idx <= lastend) i = lastend;
                    else i = rec_ends[k] - lo_g;
                    lastend = i;
                    fresh_from = i;
                    k++;
                } else {
                    i++;
                }
            }
        }
    }
    return count;
}

// ---------------------------------------------------------------
// agrep() exact round machine (sgrep.c:1166-1238 + s_output
// jump:1275-1345).  For degenerate fragment lengths (m close to D)
// the event-list proxy above cannot model the per-round machine
// resets, so this runs the actual 32-bit shift-or recurrence over the
// candidate ranges of the virtual buffer.  Emits (idx, flag) per
// counted event; flag=1 when the event produced s_output (an output
// record), 0 when it was only counted (i <= lastend re-count).
// ---------------------------------------------------------------

static int64_t agrep_jump_target(const uint8_t* buf, int64_t buflen,
                                 int64_t tb, int64_t te, int64_t i,
                                 const uint8_t* delim, int64_t dlen,
                                 int outtail) {
    if (dlen <= 0) {
        // curtextend scan (sgrep.c:1306-1308): stop AT textend, then
        // step over a newline even when it sits exactly at textend
        int64_t j = tb + i;
        while (j < te && (j < buflen ? buf[j] : 0) != '\n') j++;
        if (j < buflen && buf[j] == '\n') j++;
        return j - tb;
    }
    // forward_delimiter (delim.c:50-71)
    int64_t b = tb + i, e = te;
    if (b + dlen > e) return e + 1 - tb;
    if (dlen == 1 && delim[0] == '\n') {
        b++;
        while (b < e && (b < buflen ? buf[b] : 0) != '\n') b++;
        if (outtail && b < buflen && buf[b] == '\n') b++;
        return b - tb;
    }
    int64_t cb = b;
    for (; cb + dlen <= e; cb++) {
        int64_t k = 0;
        while (k < dlen &&
               (cb + k < buflen ? buf[cb + k] : 0) == delim[k]) k++;
        if (k >= dlen) break;
    }
    if (cb + dlen <= e) return (outtail ? cb + dlen : cb) - tb;
    return e + 1 - tb;
}

// curtextbegin scan (sgrep.c:1296-1300 / backward_delimiter)
static int64_t agrep_span_begin(const uint8_t* buf, int64_t buflen,
                                int64_t tb, int64_t i,
                                const uint8_t* delim, int64_t dlen,
                                int outtail) {
    if (dlen <= 0) {
        int64_t j = tb + i;
        while (j > tb && (--j < buflen ? buf[j] : 0) != '\n') {}
        if (j < buflen && buf[j] == '\n') j++;
        return j - tb;
    }
    // backward_delimiter (delim.c:75-97); begin bound is textbegin
    int64_t e = tb + i, b = tb;
    if (e - dlen < b) return 0;
    if (dlen == 1 && delim[0] == '\n') {
        e--;
        while (e > b && (e < buflen ? buf[e] : 0) != '\n') e--;
        if (outtail && e < buflen && buf[e] == '\n') e++;
        return e - tb;
    }
    int64_t cb = e - dlen;
    for (; cb >= b; cb--) {
        int64_t k = 0;
        while (k < dlen &&
               (cb + k < buflen ? buf[cb + k] : 0) == delim[k]) k++;
        if (k >= dlen) break;
    }
    if (cb >= b) return (outtail ? cb + dlen : cb) - tb;
    return 0;
}

int64_t agrep_rounds(const uint8_t* buf, int64_t buflen, int64_t tb,
                     int64_t te, const int64_t* cand, int64_t n_cand,
                     const uint32_t* mask, uint32_t endpos, int64_t D,
                     const uint8_t* delim, int64_t dlen, int outtail,
                     int silent, int64_t* out_idx, uint8_t* out_flag,
                     int64_t* out_begin, int64_t* out_end,
                     int64_t cap) {
    int64_t n = te - tb;
    int64_t cnt = 0;
    int64_t lastend = 0;
    uint32_t R1[12], R2[12];
    if (D > 10) D = 10;
    for (int64_t r = 0; r < n_cand; r++) {
        int64_t i = cand[2 * r];
        int64_t hi = cand[2 * r + 1];
        if (hi > n) hi = n;
        if (i < 0) i = 0;
        R1[0] = R2[0] = ~0u;
        for (int64_t k = 1; k <= D; k++)
            R1[k] = R2[k] = (R1[k - 1] >> 1) & R1[k - 1];
        // the body is 2x-unrolled with the bound checked once per
        // PAIR; after a count-jump in the first half the second half
        // still consumes one byte, even past the bound
        while (i < hi) {
            for (int half = 0; half < 2; half++) {
                uint32_t c = (tb + i < buflen) ? buf[tb + i] : 0;
                i++;
                if (c == '\n')
                    for (int64_t k = 0; k <= D; k++)
                        R1[k] = R2[k] = ~0u;
                uint32_t r1 = mask[c];
                uint32_t* A = half ? R2 : R1;
                uint32_t* B = half ? R1 : R2;
                A[0] = (B[0] >> 1) | r1;
                for (int64_t k = 1; k <= D; k++)
                    A[k] = ((B[k] >> 1) | r1) & B[k - 1]
                           & ((A[k - 1] & B[k - 1]) >> 1);
                if ((A[D] & endpos) == 0) {
                    if (cnt < cap) {
                        out_idx[cnt] = i;
                        out_begin[cnt] = -1;
                        out_end[cnt] = -1;
                    }
                    int flag = 0;
                    if (i <= lastend) i = lastend;
                    else if (!silent) {
                        flag = 1;
                        int64_t sb = agrep_span_begin(
                            buf, buflen, tb, i, delim, dlen, outtail);
                        i = agrep_jump_target(buf, buflen, tb, te, i,
                                              delim, dlen, outtail);
                        if (cnt < cap) {
                            out_begin[cnt] = sb;
                            out_end[cnt] = i;
                        }
                    }
                    if (cnt < cap) out_flag[cnt] = (uint8_t)flag;
                    cnt++;
                    lastend = i;
                    for (int64_t k = 0; k <= D; k++)
                        R1[k] = R2[k] = ~0u;
                    if (cnt >= cap) return cnt;
                }
            }
        }
    }
    return cnt;
}

// ---------------------------------------------------------------
// verify() banded DP (sgrep.c:2118-2181), including gcc's resolution
// of the unsequenced A[last+1] = A[last++]+1 (destination address is
// materialized after the increment).
// ---------------------------------------------------------------

int64_t verify_dp(int64_t m, int64_t n, int64_t D, const uint8_t* pat_in,
                  const uint8_t* win, int64_t wlen) {
    int A[300], B[300];
    uint8_t pat[300];
    memset(pat, 0, sizeof(pat));
    memcpy(pat, pat_in, (size_t)m);
    int64_t last = D;
    for (int64_t i = 0; i < 300; i++) A[i] = B[i] = (int)i;
    int64_t t = 0;
    auto ch = [&](int64_t i) -> uint8_t {
        return (i >= 0 && i < wlen) ? win[i] : 0;
    };
    while (t < n) {
        for (int64_t k = 1; k <= last && k < 299; k++) {
            int cost = B[k - 1] + 1;
            if (pat[k - 1] != ch(t)) {
                if (B[k] + 1 < cost) cost = B[k] + 1;
                if (A[k - 1] + 1 < cost) cost = A[k - 1] + 1;
            } else cost = cost - 1;
            A[k] = cost;
        }
        if (pat[last] == ch(t)) { A[last + 1] = B[last]; last++; }
        t++;
        if (A[last] < D) { int tmp = A[last] + 1; last++; A[last + 1] = tmp; }
        while (A[last] > D) last--;
        if (last >= m) return t - 1;
        if (ch(t) == '\n') {
            last = D;
            for (int64_t c = 0; c <= m + 1; c++) A[c] = B[c] = (int)c;
        }
        for (int64_t k = 1; k <= last && k < 299; k++) {
            int cost = A[k - 1] + 1;
            if (pat[k - 1] != ch(t)) {
                if (A[k] + 1 < cost) cost = A[k] + 1;
                if (B[k - 1] + 1 < cost) cost = B[k - 1] + 1;
            } else cost = cost - 1;
            B[k] = cost;
        }
        if (pat[last] == ch(t)) { B[last + 1] = A[last]; last++; }
        t++;
        if (B[last] < D) { int tmp = B[last] + 1; last++; B[last + 1] = tmp; }
        while (B[last] > D) last--;
        if (last >= m) return t - 1;
        if (ch(t) == '\n') {
            last = D;
            for (int64_t c = 0; c <= m + 1; c++) A[c] = B[c] = (int)c;
        }
    }
    return 0;
}

// ---------------------------------------------------------------
// a_monkey filter walk (sgrep.c:1858-2067): match end positions.
// ---------------------------------------------------------------

// curtextend for a match at pos (sgrep_sim._record_end_buf,
// a_monkey:1891-1894): newline records end one past the '\n';
// delimiter records end where the delimiter STARTS (or textend+1).
static int64_t record_end_buf(const uint8_t* buf, int64_t buflen,
                              int64_t pos, int64_t textend,
                              const uint8_t* dpat, int64_t dl) {
    if (dl == 0) {  // newline records
        int64_t t = pos + 1;
        while (t < textend && buf[t] != '\n') t++;
        if (t < buflen && buf[t] == '\n') t++;
        return t;
    }
    int64_t t = pos + 1;
    while (t + dl <= textend) {
        if (memcmp(buf + t, dpat, (size_t)dl) == 0) return t;
        t++;
    }
    return textend + 1;
}

// Returns the TOTAL number of match ends found (may exceed cap; only
// the first cap are written -- callers retry with a larger buffer).
// dl == 0 means newline records; dl > 0 is the -d delimiter.
int64_t a_monkey_block(const uint8_t* buf, int64_t buflen, int64_t start,
                       int64_t end, const uint8_t* pat, int64_t m,
                       int64_t D, const uint8_t* member1,
                       const uint8_t* dpat, int64_t dl,
                       int64_t* out, int64_t cap) {
    int64_t m1 = m - 1 - D;
    int64_t text = start;
    int64_t oldtext = text;
    int64_t cnt = 0;
    int64_t guard = 0;
    int64_t guard_max = 4 * (end - start + 16);
    while (text < end) {
        text += m1;
        int64_t suffix_error = 0;
        while (suffix_error <= D) {
            if (text < 0) break;
            uint32_t h = (text < buflen) ? buf[text] : 0;
            text--;
            while (member1[h]) {
                if (text < 0) break;
                h = ((h << 8) + ((text < buflen) ? buf[text] : 0))
                    & 0xFFFF;
                text--;
            }
            suffix_error++;
        }
        if (++guard > guard_max) break;
        if (text <= oldtext) {
            int64_t wlen = 2 * m + D;
            if (oldtext + wlen > buflen) wlen = buflen - oldtext;
            int64_t pos = verify_dp(m, 2 * m + D, D, pat,
                                    buf + oldtext, wlen);
            if (pos > 0) {
                text = oldtext + pos;
                if (text > end) break;
                if (cnt < cap) out[cnt] = text;
                cnt++;
                text = record_end_buf(buf, buflen, text, end, dpat, dl);
            } else {
                text = oldtext + m;
            }
        }
        oldtext = text;
    }
    return cnt;
}

// monkey4 filter walk (sgrep.c:2345-2480): DNA 2-bit q-gram backward
// filter + verify DP.  char_map/member/hashmask are prebuilt by the
// Python caller (prep4 quirks live there).  Resumes one PAST the
// record end after a match (sgrep.c:2441).  Same contract as
// a_monkey_block.
int64_t monkey4_block(const uint8_t* buf, int64_t buflen, int64_t start,
                      int64_t end, const uint8_t* pat, int64_t m,
                      int64_t D, const int64_t* char_map,
                      const uint8_t* member, int64_t hashmask,
                      const uint8_t* dpat, int64_t dl,
                      int64_t* out, int64_t cap) {
    const int LOG_DNA = 3;
    int64_t m1 = m - 1 - D;
    int64_t text = start;
    int64_t oldtext = text;
    int64_t cnt = 0;
    int64_t guard = 0;
    int64_t guard_max = 4 * (end - start + 16);
    while (text < end) {
        text += m1;
        int64_t suffix_error = 0;
        while (suffix_error <= D) {
            if (text < 1) break;
            int64_t h = (text < buflen) ? char_map[buf[text]] : 0;
            text--;
            h = ((h << LOG_DNA)
                 + ((text < buflen) ? char_map[buf[text]] : 0))
                & hashmask;
            text--;
            while (member[h]) {
                if (text < 0) break;
                h = ((h << LOG_DNA)
                     + ((text < buflen) ? char_map[buf[text]] : 0))
                    & hashmask;
                text--;
            }
            suffix_error++;
        }
        if (++guard > guard_max) break;
        if (text <= oldtext) {
            int64_t wlen = 2 * m + D;
            if (oldtext + wlen > buflen) wlen = buflen - oldtext;
            int64_t pos = verify_dp(m, 2 * m + D, D, pat,
                                    buf + oldtext, wlen);
            if (pos > 0) {
                text = oldtext + pos;
                if (text > end) break;
                if (cnt < cap) out[cnt] = text;
                cnt++;
                text = record_end_buf(buf, buflen, text, end, dpat, dl)
                       + 1;
            } else {
                text = oldtext + m;
            }
        }
        oldtext = text;
    }
    return cnt;
}


// ---------------------------------------------------------------
// SIMD 2-gram candidate prefilter
// ---------------------------------------------------------------
//
// The scalar q-gram loops below pay ~5 cycles/byte computing the
// hash + member load at every position.  The prefilter computes, one
// 64KB window at a time, a candidate BITMAP over the same 2-gram
// projection the TPU kernel uses (ops/qgram_kernel.py): bit p of
// word w[c] == "some member hash has tail 2-gram (c, p)", so the
// per-position test is one 32-entry word select + one variable
// shift -- with AVX512 that is a single vpermi2d + vpsrlvd per 16
// positions.  Exact for the 10-bit (non-LONG) tables; for LONG
// 15-bit tables it is the sound tail projection and the scalar
// member[h] re-check on candidates restores exactness.
static void qgram2_bitmap_scalar(const uint8_t* buf, int64_t lo,
                                 int64_t hi, const uint32_t* w,
                                 uint64_t* bm) {
    int64_t len = hi - lo;
    memset(bm, 0, (size_t)(((len + 63) >> 6) * 8));
    for (int64_t i = 0; i < len; i++) {
        uint32_t bit = (w[buf[lo + i] & 31]
                        >> (buf[lo + i - 1] & 31)) & 1u;
        bm[i >> 6] |= (uint64_t)bit << (i & 63);
    }
}

#if defined(__x86_64__)
__attribute__((target("avx512f")))
static void qgram2_bitmap_avx512(const uint8_t* buf, int64_t lo,
                                 int64_t hi, const uint32_t* w,
                                 uint64_t* bm) {
    __m512i t0 = _mm512_loadu_si512((const void*)w);
    __m512i t1 = _mm512_loadu_si512((const void*)(w + 16));
    __m512i v31 = _mm512_set1_epi32(31);
    __m512i one = _mm512_set1_epi32(1);
    int64_t len = hi - lo;
    memset(bm, 0, (size_t)(((len + 63) >> 6) * 8));
    int64_t i = 0;
    for (; i + 16 <= len; i += 16) {
        __m128i cb = _mm_loadu_si128((const __m128i*)(buf + lo + i));
        __m128i pb = _mm_loadu_si128(
            (const __m128i*)(buf + lo + i - 1));
        __m512i c = _mm512_and_si512(_mm512_cvtepu8_epi32(cb), v31);
        __m512i pv = _mm512_and_si512(_mm512_cvtepu8_epi32(pb), v31);
        __m512i wv = _mm512_permutex2var_epi32(t0, c, t1);
        __m512i sh = _mm512_srlv_epi32(wv, pv);
        __mmask16 m = _mm512_test_epi32_mask(sh, one);
        bm[i >> 6] |= (uint64_t)(uint16_t)m << (i & 63);
    }
    for (; i < len; i++) {
        uint32_t bit = (w[buf[lo + i] & 31]
                        >> (buf[lo + i - 1] & 31)) & 1u;
        bm[i >> 6] |= (uint64_t)bit << (i & 63);
    }
}

__attribute__((target("avx2")))
static void qgram2_bitmap_avx2(const uint8_t* buf, int64_t lo,
                               int64_t hi, const uint32_t* w,
                               uint64_t* bm) {
    __m256i t[4];
    for (int k = 0; k < 4; k++)
        t[k] = _mm256_loadu_si256((const __m256i*)(w + 8 * k));
    __m256i v31 = _mm256_set1_epi32(31);
    int64_t len = hi - lo;
    memset(bm, 0, (size_t)(((len + 63) >> 6) * 8));
    int64_t i = 0;
    for (; i + 8 <= len; i += 8) {
        __m128i cb = _mm_loadl_epi64((const __m128i*)(buf + lo + i));
        __m128i pb = _mm_loadl_epi64(
            (const __m128i*)(buf + lo + i - 1));
        __m256i c = _mm256_and_si256(_mm256_cvtepu8_epi32(cb), v31);
        __m256i pv = _mm256_and_si256(_mm256_cvtepu8_epi32(pb), v31);
        __m256i r0 = _mm256_permutevar8x32_epi32(t[0], c);
        __m256i r1 = _mm256_permutevar8x32_epi32(t[1], c);
        __m256i r2 = _mm256_permutevar8x32_epi32(t[2], c);
        __m256i r3 = _mm256_permutevar8x32_epi32(t[3], c);
        __m256i b3 = _mm256_srai_epi32(_mm256_slli_epi32(c, 28), 31);
        __m256i b4 = _mm256_srai_epi32(_mm256_slli_epi32(c, 27), 31);
        __m256i r01 = _mm256_blendv_epi8(r0, r1, b3);
        __m256i r23 = _mm256_blendv_epi8(r2, r3, b3);
        __m256i wv = _mm256_blendv_epi8(r01, r23, b4);
        __m256i sh = _mm256_srlv_epi32(wv, pv);
        uint32_t m = (uint32_t)_mm256_movemask_ps(
            _mm256_castsi256_ps(_mm256_slli_epi32(sh, 31)));
        bm[i >> 6] |= (uint64_t)m << (i & 63);
    }
    for (; i < len; i++) {
        uint32_t bit = (w[buf[lo + i] & 31]
                        >> (buf[lo + i - 1] & 31)) & 1u;
        bm[i >> 6] |= (uint64_t)bit << (i & 63);
    }
}
#endif  // __x86_64__

typedef void (*qgram2_fn)(const uint8_t*, int64_t, int64_t,
                          const uint32_t*, uint64_t*);

static qgram2_fn qgram2_impl() {
    static qgram2_fn fn = nullptr;
    if (fn == nullptr) {
#if defined(__x86_64__)
        if (__builtin_cpu_supports("avx512f"))
            fn = qgram2_bitmap_avx512;
        else if (__builtin_cpu_supports("avx2"))
            fn = qgram2_bitmap_avx2;
        else
#endif
            fn = qgram2_bitmap_scalar;
    }
    return fn;
}

// Windowed candidate iterator over the prefilter bitmap.  Positions
// handed out satisfy the 2-gram projection test; callers re-check the
// exact member[h] (identical for non-LONG, narrowing for LONG).
// Precondition: scanning starts at position >= 1 (the previous byte
// is read), which p >= 2 (!shortf) guarantees.
struct QScan {
    const uint8_t* buf;
    int64_t n;
    uint32_t w[32];
    int64_t lo = 0, hi = 0;
    uint64_t bm[1024];                       // 64KB window
    qgram2_fn fn;
    QScan(const uint8_t* b, int64_t nn, const uint8_t* member,
          int32_t longf) : buf(b), n(nn) {
        fn = qgram2_impl();
        for (int c = 0; c < 32; c++) {
            uint32_t v = 0;
            for (int pp = 0; pp < 32; pp++) {
                int64_t base = ((int64_t)c << 5) | pp;
                bool any = false;
                if (longf) {
                    const uint8_t* row = member + (base << 5);
                    for (int q = 0; q < 32; q++) any |= row[q] != 0;
                } else {
                    any = member[base] != 0;
                }
                if (any) v |= 1u << pp;
            }
            w[c] = v;
        }
    }
    int64_t next(int64_t a) {
        if (a < 1) a = 1;
        while (a < n) {
            if (a >= hi || a < lo) {
                lo = a;
                hi = (lo + 65536 > n) ? n : lo + 65536;
                fn(buf, lo, hi, w, bm);
            }
            int64_t rel = a - lo;
            int64_t wi = rel >> 6;
            int64_t nw = (hi - lo + 63) >> 6;
            uint64_t word = bm[wi] & (~0ull << (rel & 63));
            while (word == 0 && ++wi < nw) word = bm[wi];
            if (word)
                return lo + (wi << 6)
                       + (int64_t)__builtin_ctzll(word);
            a = hi;
        }
        return n;
    }
};

// ---------------------------------------------------------------
// One-pass multi-pattern: first verified match per newline record
// ---------------------------------------------------------------
//
// The dense q-gram member filter + bucket verify of
// compile/multi.py::qgram_occurrences, restricted to flat-OR
// semantics: at most ONE winning (anchor, term) pair per line (the
// first anchor that verifies; ties at an anchor go to the highest
// pattern index, newmgrep.c f_prep1 bucket order), then jump to the
// line end.  This is the host-speed twin of the TPU q-gram kernel
// path; Python-side spec: runtime/mgrep.py::_first_match_occurrences.
//
// member: u8[32768] (u8[256] when shortf); hash_id: i32 per hash ->
// bucket index; buckets CSR: bucket_off[i64, nb+1] -> bucket_tids
// (ascending); terms CSR: term_off[i64, nterm+1] -> term_bytes.
// Returns the TOTAL number of (anchor, tid) pairs found; only the
// first cap are written (callers either re-walk with a larger buffer
// or, for count-only use, take the total as-is).
int64_t qgram_first_per_line(
    const uint8_t* buf, int64_t n, const uint8_t* member,
    const int32_t* hash_id, const int64_t* bucket_off,
    const int64_t* bucket_tids, const uint8_t* term_bytes,
    const int64_t* term_off, const uint8_t* tr, int64_t p,
    int32_t longf, int32_t shortf, int32_t wordbound,
    int64_t* out_anchor, int64_t* out_tid, int64_t cap) {
    int64_t cnt = 0;
    if (n < p) return 0;
    auto isaln = [](uint8_t c) {
        return (c >= '0' && c <= '9') || (c >= 'A' && c <= 'Z')
            || (c >= 'a' && c <= 'z');
    };
    const bool simd = !shortf;
    QScan qs(buf, n, member, longf);
    int64_t a = p - 1;
    if (simd) a = qs.next(a);
    while (a < n) {
        uint32_t h;
        if (shortf) {
            h = tr[buf[a]];
        } else {
            h = ((uint32_t)(buf[a] & 31) << 5) | (buf[a - 1] & 31);
            if (longf)
                h = ((h << 5) | (buf[a - 2] & 31)) & 32767u;
        }
        if (member[h]) {
            int32_t b = hash_id[h];
            int64_t won = -1;
            // highest pattern index first
            for (int64_t j = bucket_off[b + 1] - 1;
                 j >= bucket_off[b]; j--) {
                int64_t tid = bucket_tids[j];
                const uint8_t* t = term_bytes + term_off[tid];
                int64_t L = term_off[tid + 1] - term_off[tid];
                int64_t s = a - (p - 1);
                if (s + L > n) continue;
                int64_t k = 0;
                while (k < L && tr[buf[s + k]] == tr[t[k]]) k++;
                if (k < L) continue;
                if (wordbound) {
                    uint8_t after = (s + L < n) ? buf[s + L] : 0;
                    uint8_t before = (s > 0) ? buf[s - 1] : 0;
                    if (isaln(after) || isaln(before)) continue;
                }
                won = tid;
                break;
            }
            if (won >= 0) {
                if (cnt < cap) {
                    out_anchor[cnt] = a;
                    out_tid[cnt] = won;
                }
                cnt++;
                const void* nl = memchr(buf + a, '\n', (size_t)(n - a));
                if (nl == nullptr) break;
                a = (int64_t)((const uint8_t*)nl - buf) + p;
                if (simd) a = qs.next(a);
                continue;
            }
        }
        a++;
        if (simd) a = qs.next(a);
    }
    return cnt;
}

// First (= highest-tid) verified win per ANCHOR: the event stream of
// the -d anchor-driven replay (runtime/mgrep.py walk_region consumes
// one max-tid row per anchor).  wordbound optional.
//
// When dlen > 0, wins that can never be OBSERVED by the replay are
// skipped: after consuming an anchor the replay resumes its event
// search at nv >= min(next delimiter start, region end + 1) - dlen +
// 1, so anchors below that bound are invisible whichever way the
// block-trim quirks resolve.  We resume at that bound minus a safety
// margin (maxs + 4) -- keeping extra anchors is always safe, the
// python walk does its own searchsorted jumps.  marks = sorted region
// ends (buffer coords); binary-searched per win.
// Returns TOTAL wins; only the first cap are written.
int64_t qgram_first_per_anchor(
    const uint8_t* buf, int64_t n, const uint8_t* member,
    const int32_t* hash_id, const int64_t* bucket_off,
    const int64_t* bucket_tids, const uint8_t* term_bytes,
    const int64_t* term_off, const uint8_t* tr, int64_t p,
    int32_t longf, int32_t shortf, int32_t wordbound,
    const uint8_t* dpat, int64_t dlen, const int64_t* marks,
    int64_t n_marks, int64_t maxs,
    int64_t* out_anchor, int64_t* out_tid, int64_t cap) {
    int64_t cnt = 0;
    if (n < p) return 0;
    auto isaln = [](uint8_t c) {
        return (c >= '0' && c <= '9') || (c >= 'A' && c <= 'Z')
            || (c >= 'a' && c <= 'z');
    };
    const bool simd = !shortf;
    QScan qs(buf, n, member, longf);
    for (int64_t a = p - 1; a < n; a++) {
        if (simd) {
            a = qs.next(a);
            if (a >= n) break;
        }
        uint32_t h;
        if (shortf) {
            h = tr[buf[a]];
        } else {
            h = ((uint32_t)(buf[a] & 31) << 5) | (buf[a - 1] & 31);
            if (longf)
                h = ((h << 5) | (buf[a - 2] & 31)) & 32767u;
        }
        if (!member[h]) continue;
        int32_t b = hash_id[h];
        for (int64_t j = bucket_off[b + 1] - 1; j >= bucket_off[b];
             j--) {
            int64_t tid = bucket_tids[j];
            const uint8_t* t = term_bytes + term_off[tid];
            int64_t L = term_off[tid + 1] - term_off[tid];
            int64_t s = a - (p - 1);
            if (s + L > n) continue;
            int64_t k = 0;
            while (k < L && tr[buf[s + k]] == tr[t[k]]) k++;
            if (k < L) continue;
            if (wordbound) {
                uint8_t after = (s + L < n) ? buf[s + L] : 0;
                uint8_t before = (s > 0) ? buf[s - 1] : 0;
                if (isaln(after) || isaln(before)) continue;
            }
            if (cnt < cap) {
                out_anchor[cnt] = a;
                out_tid[cnt] = tid;
            }
            cnt++;
            if (dlen > 0) {
                // A delimiter just before/at this anchor means an
                // earlier consumed event's resume point (nv = that
                // delimiter + step) can still land in (a, a + maxs] --
                // and from there observe any event we'd prune.  Only
                // a delimiter-free tail makes the zone unobservable.
                int64_t lo0 = a - maxs - dlen - 2;
                if (lo0 < 0) lo0 = 0;
                int64_t span = a + dlen - lo0;
                if (span > n - lo0) span = n - lo0;
                if (span >= dlen
                    && memmem(buf + lo0, (size_t)span, dpat,
                              (size_t)dlen) != nullptr) {
                    break;   // no jump: recent delimiter context
                }
                // next delimiter start at or after a + 1
                int64_t ds = n + 1;
                if (a + 1 + dlen <= n) {
                    const void* q = memmem(buf + a + 1,
                                           (size_t)(n - a - 1),
                                           dpat, (size_t)dlen);
                    if (q) ds = (int64_t)((const uint8_t*)q - buf);
                }
                // first region end > a
                int64_t lo = 0, hi = n_marks;
                while (lo < hi) {
                    int64_t mid = (lo + hi) / 2;
                    if (marks[mid] > a) hi = mid;
                    else lo = mid + 1;
                }
                int64_t te1 = (lo < n_marks) ? marks[lo] + 1 : n;
                int64_t bound = (ds < te1 ? ds : te1)
                                - dlen - maxs - 4;
                if (bound > a + 1) a = bound - 1;  // loop a++
            }
            break;
        }
    }
    return cnt;
}

// Exact-pattern scan: memmem over the stream (what bm()'s skip loop
// buys the reference), emitting event word 1 at each match END --
// byte-identical to the D==0 sgrep machine when every pattern
// position is a single byte (the python caller checks the mask).
// Returns total matches (writes at most cap).
int64_t exact_scan_events(const uint8_t* buf, int64_t n,
                          const uint8_t* pat, int64_t m,
                          int64_t* out_pos, uint32_t* out_word,
                          int64_t cap) {
    int64_t cnt = 0;
    const uint8_t* p = buf;
    const uint8_t* e = buf + n;
    while (p + m <= e) {
        const uint8_t* q = (const uint8_t*)memmem(p, (size_t)(e - p),
                                                  pat, (size_t)m);
        if (!q) break;
        if (cnt < cap) {
            out_pos[cnt] = (q - buf) + m - 1;
            out_word[cnt] = 1u;
        }
        cnt++;
        p = q + 1;            // overlapping matches, like the machine
    }
    return cnt;
}

// Exact match under a byte fold table (the sgrep mask's case pairs):
// Boyer-Moore-Horspool on folded bytes, emitting event word 1 at each
// match END.  Equivalent to the D==0 sgrep machine when every
// position's byte set is {c} or the case pair {c, c^0x20} (python
// gates).  Returns total matches (writes at most cap).
#if defined(__x86_64__)
// next 32-byte block at/after i32 (32-aligned stepping from i) with
// any byte equal to a or b; fills *msk with the per-byte hit mask,
// returns the block base or -1 when no full block remains
__attribute__((target("avx2")))
static int64_t eq2_next32(const uint8_t* buf, int64_t n, int64_t i,
                          uint8_t a, uint8_t b, uint32_t* msk) {
    __m256i va = _mm256_set1_epi8((char)a);
    __m256i vb = _mm256_set1_epi8((char)b);
    for (; i + 32 <= n; i += 32) {
        __m256i v = _mm256_loadu_si256((const __m256i*)(buf + i));
        __m256i hit = _mm256_or_si256(_mm256_cmpeq_epi8(v, va),
                                      _mm256_cmpeq_epi8(v, vb));
        uint32_t m0 = (uint32_t)_mm256_movemask_epi8(hit);
        if (m0) {
            *msk = m0;
            return i;
        }
    }
    return -1;
}
#endif

int64_t folded_exact_scan(const uint8_t* buf, int64_t n,
                          const uint8_t* patf, int64_t m,
                          const uint8_t* fold, int64_t* out_pos,
                          uint32_t* out_word, int64_t cap) {
    if (m <= 0 || n < m) return 0;
    int64_t cnt = 0;
    // --- anchor selection: the raw-byte set matching each folded
    // position.  A 1-byte anchor rides glibc memchr (AVX-tuned); a
    // 2-byte anchor (case pair) rides the AVX2/AVX512 two-compare
    // loop below.  Anchor choice biases to the LAST eligible
    // position so the verify runs backward like bm() does.
    int64_t k1 = -1, k2 = -1;        // anchor, secondary check
    uint8_t v1a = 0, v1b = 0;
    int nv1 = 3;
    for (int64_t k = 0; k < m; k++) {
        uint8_t va = 0, vb = 0;
        int nv = 0;
        for (int c = 0; c < 256; c++) {
            if (fold[c] == patf[k]) {
                if (nv == 0) va = (uint8_t)c;
                else if (nv == 1) vb = (uint8_t)c;
                nv++;
                if (nv > 2) break;
            }
        }
        if (nv >= 1 && nv <= 2 && nv <= nv1) {
            k2 = k1;
            k1 = k;
            v1a = va;
            v1b = vb;
            nv1 = nv;
        }
    }
    auto verify_at = [&](int64_t i) {
        // i = anchor position of patf[k1]; full window check
        int64_t s = i - k1;
        if (s < 0 || s + m > n) return;
        if (k2 >= 0 && fold[buf[s + k2]] != patf[k2]) return;
        for (int64_t k = m - 1; k >= 0; k--)
            if (fold[buf[s + k]] != patf[k]) return;
        if (cnt < cap) {
            out_pos[cnt] = s + m - 1;
            out_word[cnt] = 1u;
        }
        cnt++;
    };
    if (nv1 == 1) {
        const uint8_t* p = buf + k1;
        const uint8_t* e = buf + n;
        while (p < e) {
            const uint8_t* q = (const uint8_t*)memchr(
                p, v1a, (size_t)(e - p));
            if (!q) break;
            verify_at(q - buf);
            p = q + 1;
        }
        return cnt;
    }
    if (nv1 == 2) {
#if defined(__x86_64__)
        if (__builtin_cpu_supports("avx2")) {
            int64_t i = 0;
            uint32_t msk;
            while ((i = eq2_next32(buf, n, i, v1a, v1b, &msk)) >= 0) {
                while (msk) {
                    int b = __builtin_ctz(msk);
                    msk &= msk - 1;
                    verify_at(i + b);
                }
                i += 32;
            }
            for (i = n & ~(int64_t)31; i < n; i++)
                if (buf[i] == v1a || buf[i] == v1b) verify_at(i);
            return cnt;
        }
#endif
        for (int64_t i = 0; i < n; i++)
            if (buf[i] == v1a || buf[i] == v1b) verify_at(i);
        return cnt;
    }
    // fallback: folded Boyer-Moore-Horspool (wide fold classes)
    int64_t shift[256];
    for (int i = 0; i < 256; i++) shift[i] = m;
    for (int64_t k = 0; k < m - 1; k++) {
        // every byte folding to patf[k] skips to align position k
        for (int c = 0; c < 256; c++)
            if (fold[c] == patf[k]) shift[c] = m - 1 - k;
    }
    int64_t i = m - 1;
    uint8_t last = patf[m - 1];
    while (i < n) {
        uint8_t c = fold[buf[i]];
        if (c == last) {
            int64_t k = m - 2;
            while (k >= 0 && fold[buf[i - (m - 1 - k)]] == patf[k])
                k--;
            if (k < 0) {
                if (cnt < cap) {
                    out_pos[cnt] = i;
                    out_word[cnt] = 1u;
                }
                cnt++;
            }
            i += 1;            // overlapping matches, like the machine
        } else {
            i += shift[buf[i]];
        }
    }
    return cnt;
}

// Sequential bit-parallel stream scan: the host twin of the windowed
// numpy backend (ops/scan.py _scan_windows_np) for the bitap and
// sgrep machines.  Valid when the machine's dependence window is
// bounded (callers gate out sticky/wildcard shapes), where carrying
// state sequentially equals the tile+halo restart.  Emits SPARSE
// events: (position, event word) pairs for nonzero words.  Returns
// the total pair count (writes at most cap).
//
// variant: 0 = bitap (asearch.c:100-115 transition, delimiter pulse
// reset through d_mask), 1 = sgrep (inverted shift-or,
// sgrep.c:1183-1186, newline state reset when D > 0).
// costs: ci/cs/cd >= 1 enables the asearch1 wiring (pass 0,0,0 for
// uniform).
}  // extern "C" (templates below; reopened after)

template <int DD, int VARIANT, bool JUMP>
static int64_t bitap_scan_tpl(const uint8_t* buf, int64_t n,
                              const uint32_t* mask, uint32_t init0,
                              uint32_t init1_ns, uint32_t noerr,
                              uint32_t d_endpos, uint32_t endpos,
                              uint32_t d_mask, int64_t ci, int64_t cs,
                              int64_t cd, int64_t* out_pos,
                              uint32_t* out_word, int64_t cap) {
    uint32_t st[DD + 1], nw[DD + 1], rs[DD + 1], ini[DD + 1];
    if (VARIANT == 0) {
        for (int k = 0; k <= DD; k++) ini[k] = init0;
    } else {
        uint32_t lvl = 0;
        ini[0] = 0;
        for (int k = 1; k <= DD; k++) {
            lvl = ((lvl >> 1) | lvl | 0x80000000u);
            ini[k] = lvl;
        }
    }
    for (int k = 0; k <= DD; k++) st[k] = ini[k];
    int64_t cnt = 0;
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = buf[i];
        uint32_t cm = mask[c];
        uint32_t ev;
        if (VARIANT == 0) {
            if (!JUMP) {
                nw[0] = ((st[0] >> 1) & cm) | (init1_ns & st[0]);
                for (int k = 1; k <= DD; k++) {
                    uint32_t r2 = st[k - 1]
                        | (((nw[k - 1] | st[k - 1]) >> 1) & noerr);
                    nw[k] = ((st[k] >> 1) & cm) | (init1_ns & st[k])
                            | r2;
                }
            } else {
                for (int k = 0; k <= DD; k++) {
                    uint32_t r = ((st[k] >> 1) & cm)
                                 | (init1_ns & st[k]);
                    if (k - ci >= 0) r |= st[k - ci];
                    uint32_t err = 0;
                    if (k - cd >= 0) err |= nw[k - cd];
                    if (k - cs >= 0) err |= st[k - cs];
                    r |= (err >> 1) & noerr;
                    nw[k] = r;
                }
            }
            ev = (nw[0] & d_endpos) | (nw[DD] & endpos);
            if (__builtin_expect((nw[0] & d_endpos) != 0, 0)) {
                // delimiter pulse: restart from init through d_mask
                if (!JUMP) {
                    rs[0] = ((init0 >> 1) & cm) | (init1_ns & init0);
                    for (int k = 1; k <= DD; k++) {
                        uint32_t r2 = init0
                            | (((rs[k - 1] | init0) >> 1) & noerr);
                        rs[k] = ((init0 >> 1) & cm)
                                | (init1_ns & init0) | r2;
                    }
                } else {
                    for (int k = 0; k <= DD; k++) {
                        uint32_t r = ((init0 >> 1) & cm)
                                     | (init1_ns & init0);
                        if (k - ci >= 0) r |= init0;
                        uint32_t err = 0;
                        if (k - cd >= 0) err |= rs[k - cd];
                        if (k - cs >= 0) err |= init0;
                        r |= (err >> 1) & noerr;
                        rs[k] = r;
                    }
                }
                rs[0] &= d_mask;
                for (int k = 0; k <= DD; k++) st[k] = rs[k];
            } else {
                for (int k = 0; k <= DD; k++) st[k] = nw[k];
            }
        } else {
            if (DD > 0 && c == '\n') {
                for (int k = 0; k <= DD; k++) st[k] = ini[k];
            }
            nw[0] = ((st[0] >> 1) | 0x80000000u) & cm;
            for (int k = 1; k <= DD; k++) {
                nw[k] = (((st[k] >> 1) | 0x80000000u) & cm)
                        | st[k - 1]
                        | (((nw[k - 1] | st[k - 1]) >> 1)
                           | 0x80000000u);
            }
            ev = (nw[DD] & endpos) ? 1u : 0u;
            for (int k = 0; k <= DD; k++) st[k] = nw[k];
        }
        if (__builtin_expect(ev != 0, 0)) {
            if (cnt < cap) {
                out_pos[cnt] = i;
                out_word[cnt] = ev;
            }
            cnt++;
        }
    }
    return cnt;
}

extern "C"
int64_t bitap_scan_events(const uint8_t* buf, int64_t n,
                          const uint32_t* mask, uint32_t init0,
                          uint32_t init1_ns, uint32_t noerr,
                          uint32_t d_endpos, uint32_t endpos,
                          uint32_t d_mask, int64_t D, int32_t variant,
                          int64_t ci, int64_t cs, int64_t cd,
                          int64_t* out_pos, uint32_t* out_word,
                          int64_t cap) {
    bool jump = (ci | cs | cd) != 0;
#define CASE(DV)                                                       \
    case DV:                                                           \
        if (variant == 0 && !jump)                                     \
            return bitap_scan_tpl<DV, 0, false>(                       \
                buf, n, mask, init0, init1_ns, noerr, d_endpos,        \
                endpos, d_mask, ci, cs, cd, out_pos, out_word, cap);   \
        if (variant == 0)                                              \
            return bitap_scan_tpl<DV, 0, true>(                        \
                buf, n, mask, init0, init1_ns, noerr, d_endpos,        \
                endpos, d_mask, ci, cs, cd, out_pos, out_word, cap);   \
        return bitap_scan_tpl<DV, 1, false>(                           \
            buf, n, mask, init0, init1_ns, noerr, d_endpos, endpos,    \
            d_mask, ci, cs, cd, out_pos, out_word, cap)
    switch (D) {
        CASE(0); CASE(1); CASE(2); CASE(3); CASE(4);
        CASE(5); CASE(6); CASE(7); CASE(8);
        default: return -1;
    }
#undef CASE
}

extern "C" {

// Sequential regex-NFA stream scan: the host twin of the renfa lane
// machine (ops/renfa.py scan_records), using the tabulated
// followpos transition (compute_next agrep.c:396-457; split half
// tables like re1 :492-498).  buf must START one past a newline;
// emits one verdict byte per '\n' encountered.  Returns the line
// count (writes at most cap).
// inject >= 0 processes one extra 0x00 byte just before buf[inject]
// (the re() 2x-unroll block-boundary glitch, see regex_engine.py).
int64_t renfa_scan_lines(const uint8_t* buf, int64_t n,
                         const uint32_t* mask, const uint32_t* lo_tab,
                         const uint32_t* hi_tab, int64_t h,
                         int64_t rel, uint32_t init1, uint32_t noerr,
                         int64_t D, int32_t tail, const uint32_t* cont,
                         int64_t inject, uint8_t* out, int64_t cap) {
    uint32_t st[16], nw[16];
    for (int64_t k = 0; k <= D; k++) st[k] = cont[k];
    uint64_t idx_mask = rel > 0 ? ((1ull << rel) - 1) : 0;
    uint64_t lo_mask = h > 0 ? ((1ull << h) - 1) : 0;
    auto nxt = [&](uint32_t s) -> uint32_t {
        uint64_t i = ((uint64_t)s >> 1) & idx_mask;
        if (h > 0) return lo_tab[i & lo_mask] | hi_tab[i >> h];
        return lo_tab[i];
    };
    int64_t line = 0;
    for (int64_t i = 0; i < n; i++) {
        uint8_t c;
        if (i == inject) {
            // synthesized stale-buffer byte: one ordinary transition
            // on 0x00, then fall through to the real byte
            uint32_t cm0 = mask[0];
            nw[0] = (nxt(st[0]) & cm0) | (init1 & st[0]);
            for (int64_t k = 1; k <= D; k++) {
                uint32_t r0 = st[k - 1] | nw[k - 1];
                nw[k] = (nxt(st[k]) & cm0)
                        | ((st[k - 1] | nxt(r0)) & noerr)
                        | (init1 & st[k]);
            }
            for (int64_t k = 0; k <= D; k++) st[k] = nw[k];
        }
        c = buf[i];
        uint32_t cm = mask[c];
        if (c == '\n') {
            uint32_t ad = (nxt(st[D]) & cm) | (init1 & st[D]);
            if (tail) ad = nxt(ad) | ad;
            if (line < cap) out[line] = (uint8_t)(ad & 1u);
            line++;
            for (int64_t k = 0; k <= D; k++) st[k] = cont[k];
            continue;
        }
        nw[0] = (nxt(st[0]) & cm) | (init1 & st[0]);
        for (int64_t k = 1; k <= D; k++) {
            uint32_t r0 = st[k - 1] | nw[k - 1];
            nw[k] = (nxt(st[k]) & cm)
                    | ((st[k - 1] | nxt(r0)) & noerr)
                    | (init1 & st[k]);
        }
        for (int64_t k = 0; k <= D; k++) st[k] = nw[k];
    }
    return line;
}

// Pack variable-length lines into a zero-padded lane matrix
// u8[R, L]: lens[r]+1 bytes (the line plus its trailing newline)
// copied from starts[r], remainder zeroed.  One pass, no O(R*L)
// temporaries (the numpy gather materializes several).
void pack_lines(const uint8_t* buf, int64_t n, const int64_t* starts,
                const int64_t* lens, int64_t R, int64_t L,
                uint8_t* out) {
    for (int64_t r = 0; r < R; r++) {
        int64_t s = starts[r];
        int64_t c = lens[r] + 1;
        if (c > L) c = L;
        if (s < 0) s = 0;
        if (s + c > n) c = n - s;
        if (c < 0) c = 0;
        memcpy(out + r * L, buf + s, (size_t)c);
        memset(out + r * L + c, 0, (size_t)(L - c));
    }
}

// Hash one anchor a (>= p - 1), check its membership, and verify its
// bucket's terms at start a - (p - 1); appends each verified
// (anchor, tid) row while cnt < cap and returns the new count.
static inline int64_t qgram_verify_anchor(
    const uint8_t* buf, int64_t n, int64_t a, const uint8_t* member,
    const int32_t* hash_id, const int64_t* bucket_off,
    const int64_t* bucket_tids, const uint8_t* term_bytes,
    const int64_t* term_off, const uint8_t* tr, int64_t p,
    int32_t longf, int32_t shortf, int64_t* out_anchor,
    int64_t* out_tid, int64_t cap, int64_t cnt) {
    uint32_t h;
    if (shortf) {
        h = tr[buf[a]];
    } else {
        h = ((uint32_t)(buf[a] & 31) << 5) | (buf[a - 1] & 31);
        if (longf)
            h = ((h << 5) | (buf[a - 2] & 31)) & 32767u;
    }
    if (!member[h]) return cnt;
    int32_t b = hash_id[h];
    for (int64_t j = bucket_off[b]; j < bucket_off[b + 1]; j++) {
        int64_t tid = bucket_tids[j];
        const uint8_t* t = term_bytes + term_off[tid];
        int64_t L = term_off[tid + 1] - term_off[tid];
        int64_t s = a - (p - 1);
        if (s + L > n) continue;
        int64_t k = 0;
        while (k < L && tr[buf[s + k]] == tr[t[k]]) k++;
        if (k < L) continue;
        if (cnt < cap) {
            out_anchor[cnt] = a;
            out_tid[cnt] = tid;
        }
        cnt++;
    }
    return cnt;
}

// All verified (anchor, tid) pairs -- the full occurrence table of
// compile/multi.py::qgram_occurrences at C speed (dense member filter
// + bucket verify, NO first-per-line pruning, NO wordbound: callers
// filter downstream exactly like the Python path).  Returns the TOTAL
// pair count; only the first cap are written.
int64_t qgram_occ_all(
    const uint8_t* buf, int64_t n, const uint8_t* member,
    const int32_t* hash_id, const int64_t* bucket_off,
    const int64_t* bucket_tids, const uint8_t* term_bytes,
    const int64_t* term_off, const uint8_t* tr, int64_t p,
    int32_t longf, int32_t shortf,
    int64_t* out_anchor, int64_t* out_tid, int64_t cap) {
    int64_t cnt = 0;
    if (n < p) return 0;
    const bool simd = !shortf;
    QScan qs(buf, n, member, longf);
    for (int64_t a = p - 1; a < n; a++) {
        if (simd) {
            a = qs.next(a);
            if (a >= n) break;
        }
        cnt = qgram_verify_anchor(buf, n, a, member, hash_id, bucket_off,
                                  bucket_tids, term_bytes, term_off, tr, p,
                                  longf, shortf, out_anchor, out_tid, cap,
                                  cnt);
    }
    return cnt;
}

// The verify half of qgram_occ_all over given ascending candidate
// anchors (the device q-gram filter's, a sound superset of the member
// anchors): the same rows, in the same order, as qgram_occ_all gives
// for those anchors.  Returns the TOTAL pair count; only the first cap
// are written.
int64_t qgram_occ_at(
    const uint8_t* buf, int64_t n, const int64_t* anchors,
    int64_t n_anchors, const uint8_t* member, const int32_t* hash_id,
    const int64_t* bucket_off, const int64_t* bucket_tids,
    const uint8_t* term_bytes, const int64_t* term_off,
    const uint8_t* tr, int64_t p, int32_t longf, int32_t shortf,
    int64_t* out_anchor, int64_t* out_tid, int64_t cap) {
    int64_t cnt = 0;
    for (int64_t i = 0; i < n_anchors; i++) {
        int64_t a = anchors[i];
        if (a < p - 1 || a >= n) continue;
        cnt = qgram_verify_anchor(buf, n, a, member, hash_id, bucket_off,
                                  bucket_tids, term_bytes, term_off, tr, p,
                                  longf, shortf, out_anchor, out_tid, cap,
                                  cnt);
    }
    return cnt;
}

}  // extern "C"

#include <algorithm>

// ---------------------------------------------------------------
// Flat-OR -d record-count walk
// ---------------------------------------------------------------
//
// C twin of runtime/mgrep.py walk_region restricted to pure count
// mode (flat OR, -c, no inversion/limits/booleans, p_size > 1): the
// anchor-driven replay of monkey1's DO_OUTPUT + record jump + DOW
// crossing flush (newmgrep.c:803-1043).  Consumes the one-row-per-
// anchor event stream wa[] (qgram_first_per_anchor output after the
// python-side trim filters); every consumed row is one DO_OUTPUT.
// Regions are independent, so callers thread contiguous region
// ranges [r_lo, r_hi) and sum the returns.
extern "C"
int64_t mgrep_or_count_walk(
    const uint8_t* stream, int64_t n, const uint8_t* dref, int64_t dl,
    const uint8_t* tr, const int32_t* shift1, int32_t longf,
    int64_t m1w, const int64_t* wa, int64_t nw, const int64_t* de,
    int64_t nd, const int64_t* bounds, int64_t nb, int64_t r_lo,
    int64_t r_hi, int64_t base, int64_t final_end, int32_t outtail) {
    // tr1 code at hash-context position i: positions below dl are the
    // memcpy'd delimiter (newmgrep.c:511), positions past n + dl are
    // the EOF-rescan's virtual appended delimiter
    auto hs = [&](int64_t i) -> uint32_t {
        int64_t j = i - dl;
        if (j < 0) return tr[dref[i]] & 31u;
        if (j < n) return tr[stream[j]] & 31u;
        int64_t k = j - n;
        return (k < dl) ? (tr[dref[k]] & 31u) : 0u;
    };
    auto sh_at = [&](int64_t t) -> int32_t {
        int64_t i = dl + t;
        uint32_t h = hs(i) << 5;
        if (i >= 1) h += hs(i - 1);
        if (longf) h = (h << 5) + ((i >= 2) ? hs(i - 2) : 0u);
        return shift1[h];
    };
    // skip-walk phase: first visited position >= X from exact t
    auto first_visit_ge = [&](int64_t t, int64_t X) -> int64_t {
        while (t < X) {
            int32_t s = sh_at(t);
            t += (s > 1) ? s : 1;
        }
        return t;
    };
    int64_t maxs_w = m1w - longf;
    if (maxs_w < 1) maxs_w = 1;
    int64_t cnt = 0;
    for (int64_t r = r_lo; r < r_hi; r++) {
        int64_t tb_region = (r == 0) ? base : bounds[r - 1];
        int64_t te = ((r < nb) ? bounds[r] + 1 : final_end) - 1;
        bool DOW = false;
        int64_t cure = 0;
        int64_t tb_jump = tb_region;
        int64_t nv = tb_region + m1w - 1;
        const int64_t* jp = std::lower_bound(wa, wa + nw, nv);
        while (true) {
            bool have = (jp < wa + nw) && (*jp <= te);
            int64_t a = have ? *jp : -1;
            if (DOW) {
                if (!have) { DOW = false; break; }
                bool flush_before = false;
                if (nv >= cure - 1) {
                    flush_before = (nv < a);
                } else if (a >= cure - 1) {
                    if (a >= cure - 1 + maxs_w) flush_before = true;
                    else flush_before =
                        (first_visit_ge(nv, cure - 1) < a);
                }
                if (flush_before) DOW = false;
            }
            if (!have) break;
            if (!DOW) {
                // record extraction bounded by the advancing
                // textbegin (monkey1:885-886); curb only matters for
                // printing, the count walk needs cure + tb_jump
                int64_t j2 = std::lower_bound(de, de + nd, a + dl)
                             - de;
                cure = te + 1;
                while (j2 < nd) {
                    int64_t dv = de[j2], ds = dv - dl + 1;
                    if (ds >= a + 1 && ds <= te - dl) {
                        cure = outtail ? ds + dl : ds;
                        break;
                    }
                    if (ds > te - dl) break;
                    j2++;
                }
                tb_jump = outtail ? cure - dl : cure;
                DOW = true;
            }
            cnt++;                           // DO_OUTPUT (count)
            int64_t post = tb_jump;
            nv = post + ((m1w - 1 > 0) ? (m1w - 1) : 1);
            if (post >= cure - 1) DOW = false;   // crossing flush
            jp = std::lower_bound(wa, wa + nw, nv);
        }
    }
    return cnt;
}
