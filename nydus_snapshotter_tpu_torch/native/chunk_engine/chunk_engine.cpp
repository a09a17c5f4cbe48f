// chunk_engine: sequential FastCDC gear chunker, bit-identical to the
// framework's Python/JAX chunking semantics (ops/cdc.py
// chunk_sequential_reference / resolve_cuts).
//
// This is the host arm of the hybrid conversion engine: content-defined
// boundaries are latency-bound and branchy — a poor fit for wide vector
// hardware at small batch — so the native path handles streams below the
// device crossover while the TPU two-phase kernel handles bulk batches.
// Called via ctypes (which drops the GIL), so Python threads chunk many
// layer streams in parallel.

#include <cstdint>
#include <cstdlib>
#include <cstring>

#include <atomic>
#include <thread>
#include <vector>

#include <dlfcn.h>

#include "blake3.h"
#include "sha256.h"

#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>
#define NTPU_X86 1
#endif

namespace {

// ---- Position-parallel gear candidate bitmaps (the TPU kernel's
// log-doubling identity on host SIMD) ----------------------------------
//
// h_i = sum_{k=0}^{31} G[x_{i-k}] << k is position-independent, so every
// byte's hash is computed in parallel: mix32 per byte, then 5 log-doubling
// shifted adds (m = 1,2,4,8,16) over a tile. Judged positions always sit
// >= min_size >= 1024 bytes past their chunk start, so the 32-byte window
// is chunk-interior and bitmap candidates are bit-identical to the
// sequential per-chunk hash (same argument as ops/gear.py docstring).
// G here is gear-v2 (mix32 arithmetic), computed inline — no table gather.

constexpr int64_t TILE = 2048;  // positions per tile; buffers stay in L1
constexpr uint32_t MIX_C0 = 0x9E3779B1u;
constexpr uint32_t MIX_C1 = 0x85EBCA6Bu;
constexpr uint32_t MIX_C2 = 0xC2B2AE35u;

inline uint32_t mix32(uint32_t x) {
  x = (x + 1u) * MIX_C0;
  x ^= x >> 16;
  x *= MIX_C1;
  x ^= x >> 13;
  x *= MIX_C2;
  x ^= x >> 16;
  return x;
}

// All three arms compute candidate bitmaps for the position range
// [lo, hi) only — lo must be TILE-aligned (whole bitmap words, and each
// tile re-derives its own 31-byte seam from the bytes before it), so
// disjoint ranges compose bit-identically with a whole-stream pass. The
// fused pass exploits this: positions inside [chunk_start,
// judge_from - 31) can never influence a judged hash and are simply never
// computed (~min_size/avg_size of all bytes skipped).
#ifdef NTPU_X86
// AVX2 register-resident arm (8 u32 lanes/step): same rolling-state
// formulation as the AVX-512 kernel — log-doubling levels never touch
// memory — with the element shifts built from the permute2x128+alignr
// carry idiom (AVX2's alignr is per-128-bit-lane). The s8-level early-out
// applies unchanged: bits 0..15 of the final hash equal bits 0..15 of
// s8, so one movemask decides whether the <<16 completion runs. This is
// the fused pass's fast path on AVX2-only hosts (e.g. AMD Milan TPU
// hosts).

// value at position i-1 / i-2 / i-4, carrying from the previous register
#define NTPU_G2_CARRY(cur, prev) _mm256_permute2x128_si256(prev, cur, 0x21)
#define NTPU_G2_SHIFT1(cur, prev) \
  _mm256_alignr_epi8(cur, NTPU_G2_CARRY(cur, prev), 12)
#define NTPU_G2_SHIFT2(cur, prev) \
  _mm256_alignr_epi8(cur, NTPU_G2_CARRY(cur, prev), 8)

#define NTPU_G2_STEP8(raw64)                                                 \
  __m256i g = _mm256_cvtepu8_epi32(raw64);                                   \
  g = _mm256_mullo_epi32(_mm256_add_epi32(g, one), c0);                      \
  g = _mm256_xor_si256(g, _mm256_srli_epi32(g, 16));                         \
  g = _mm256_mullo_epi32(g, c1);                                             \
  g = _mm256_xor_si256(g, _mm256_srli_epi32(g, 13));                         \
  g = _mm256_mullo_epi32(g, c2);                                             \
  g = _mm256_xor_si256(g, _mm256_srli_epi32(g, 16));                         \
  const __m256i s1 =                                                         \
      _mm256_add_epi32(g, _mm256_slli_epi32(NTPU_G2_SHIFT1(g, pg), 1));      \
  const __m256i s2 =                                                         \
      _mm256_add_epi32(s1, _mm256_slli_epi32(NTPU_G2_SHIFT2(s1, p1), 2));    \
  const __m256i s4 =                                                         \
      _mm256_add_epi32(s2, _mm256_slli_epi32(NTPU_G2_CARRY(s2, p2), 4));     \
  const __m256i s8v =                                                        \
      _mm256_add_epi32(s4, _mm256_slli_epi32(p4, 8));                        \
  const __m256i oldpp8 = pp8;                                                \
  (void)oldpp8;                                                              \
  pg = g;                                                                    \
  p1 = s1;                                                                   \
  p2 = s2;                                                                   \
  p4 = s4;                                                                   \
  pp8 = p8;                                                                  \
  p8 = s8v;

__attribute__((target("avx2")))
void gear_bitmaps_avx2(const uint8_t *data, int64_t lo, int64_t hi,
                       uint32_t mask_s, uint32_t mask_l, uint64_t *bm_s,
                       uint64_t *bm_l) {
  const __m256i c0 = _mm256_set1_epi32((int)MIX_C0);
  const __m256i c1 = _mm256_set1_epi32((int)MIX_C1);
  const __m256i c2 = _mm256_set1_epi32((int)MIX_C2);
  const __m256i one = _mm256_set1_epi32(1);
  const __m256i vms = _mm256_set1_epi32((int)mask_s);
  const __m256i vml = _mm256_set1_epi32((int)mask_l);
  const __m256i vzero = _mm256_setzero_si256();
  const __m256i vpre = _mm256_set1_epi32((int)(mask_s & mask_l & 0xFFFFu));

  __m256i pg = _mm256_setzero_si256(), p1 = pg, p2 = pg, p4 = pg, p8 = pg,
          pp8 = pg;

  // Warm the rolling state from the 32 bytes of history (zero state IS
  // the history at the stream head; callers keep lo 0 or >= 32).
  if (lo >= 32) {
    for (int w = 4; w >= 1; --w) {
      NTPU_G2_STEP8(_mm_loadl_epi64((const __m128i *)(data + lo - 8 * w)))
      (void)s8v;
    }
  }

  for (int64_t w = lo; w < hi; w += 64) {
    uint64_t ws = 0, wl = 0;
    const int64_t wend = (w + 64 <= hi) ? w + 64 : hi;
    int shift = 0;
    for (int64_t pos = w; pos < wend; pos += 8, shift += 8) {
      const int64_t rem = wend - pos;
      if (rem >= 8) {
        NTPU_G2_STEP8(_mm_loadl_epi64((const __m128i *)(data + pos)))
        if (_mm256_movemask_ps(_mm256_castsi256_ps(_mm256_cmpeq_epi32(
                _mm256_and_si256(s8v, vpre), vzero)))) {
          const __m256i s16 =
              _mm256_add_epi32(s8v, _mm256_slli_epi32(oldpp8, 16));
          const uint64_t ms =
              (uint32_t)_mm256_movemask_ps(_mm256_castsi256_ps(
                  _mm256_cmpeq_epi32(_mm256_and_si256(s16, vms), vzero)));
          const uint64_t ml =
              (uint32_t)_mm256_movemask_ps(_mm256_castsi256_ps(
                  _mm256_cmpeq_epi32(_mm256_and_si256(s16, vml), vzero)));
          ws |= ms << shift;
          wl |= ml << shift;
        }
      } else {
        uint8_t tail[8] = {0};
        std::memcpy(tail, data + pos, (size_t)rem);
        NTPU_G2_STEP8(_mm_loadl_epi64((const __m128i *)tail))
        const __m256i s16 =
            _mm256_add_epi32(s8v, _mm256_slli_epi32(oldpp8, 16));
        const uint64_t live = (1u << rem) - 1;
        const uint64_t ms = (uint32_t)_mm256_movemask_ps(_mm256_castsi256_ps(
            _mm256_cmpeq_epi32(_mm256_and_si256(s16, vms), vzero)));
        const uint64_t ml = (uint32_t)_mm256_movemask_ps(_mm256_castsi256_ps(
            _mm256_cmpeq_epi32(_mm256_and_si256(s16, vml), vzero)));
        ws |= (ms & live) << shift;
        wl |= (ml & live) << shift;
      }
    }
    bm_s[w >> 6] = ws;
    bm_l[w >> 6] = wl;
  }
}
#undef NTPU_G2_STEP8
#undef NTPU_G2_SHIFT2
#undef NTPU_G2_SHIFT1
#undef NTPU_G2_CARRY
// GCC-12 false positives: maskless AVX-512 intrinsics expand through
// _mm512_undefined_epi32 dummies that trip -Wmaybe-uninitialized.
#pragma GCC diagnostic push
#pragma GCC diagnostic ignored "-Wmaybe-uninitialized"
// Register-resident rolling formulation: the 5 log-doubling levels never
// touch memory. Each 16-position step keeps the previous step's vector at
// every level (pg, p1, p2, p4, p8) live in zmm registers; the
// position-m shift is a valignd against that rolling state. The buffered
// variant (see gear_bitmaps_avx2) bounces every level through L1
// (store->load per position per level), which caps it ~1.3 GiB/s; this
// one is pure ALU.
//
// Mirrors the mix32 + shifted-add identity of the Pallas kernel
// (ops/gear_pallas.py) — same math, lane-rotation instead of sublane
// slices.

#define NTPU_GEAR_MIX(x)                                                     \
  x = _mm512_mullo_epi32(_mm512_add_epi32(x, one), c0);                      \
  x = _mm512_xor_si512(x, _mm512_srli_epi32(x, 16));                         \
  x = _mm512_mullo_epi32(x, c1);                                             \
  x = _mm512_xor_si512(x, _mm512_srli_epi32(x, 13));                         \
  x = _mm512_mullo_epi32(x, c2);                                             \
  x = _mm512_xor_si512(x, _mm512_srli_epi32(x, 16));

// One 16-position step through level 4 (s8 = sum of the last 16 weighted
// mix values per position). The final level is intentionally NOT
// computed here: the <<16 completion term cannot touch bits 0..15 of the
// full hash, so a single testn against (mask_s & mask_l & 0xFFFF)
// decides — almost always negatively (~16/2^14 of vectors at default
// masks) — whether any lane can be a candidate under either mask; the
// caller runs the s16 completion + both final tests only on that rare
// hit. (Pushing the early-out down to s4 was tried and measured slower:
// the extra rolling register plus a 1/16-taken branch cost more than the
// saved level.)
#define NTPU_GEAR_STEP8(raw128)                                              \
  __m512i g = _mm512_cvtepu8_epi32(raw128);                                  \
  NTPU_GEAR_MIX(g)                                                           \
  const __m512i s1 = _mm512_add_epi32(                                       \
      g, _mm512_slli_epi32(_mm512_alignr_epi32(g, pg, 15), 1));              \
  const __m512i s2 = _mm512_add_epi32(                                       \
      s1, _mm512_slli_epi32(_mm512_alignr_epi32(s1, p1, 14), 2));            \
  const __m512i s4 = _mm512_add_epi32(                                       \
      s2, _mm512_slli_epi32(_mm512_alignr_epi32(s2, p2, 12), 4));            \
  const __m512i s8v = _mm512_add_epi32(                                      \
      s4, _mm512_slli_epi32(_mm512_alignr_epi32(s4, p4, 8), 8));             \
  const __m512i oldp8 = p8;                                                  \
  (void)oldp8;                                                               \
  pg = g;                                                                    \
  p1 = s1;                                                                   \
  p2 = s2;                                                                   \
  p4 = s4;                                                                   \
  p8 = s8v;

__attribute__((target("avx512f,avx512bw,avx512vl")))
void gear_bitmaps_avx512(const uint8_t *data, int64_t lo, int64_t hi,
                         uint32_t mask_s, uint32_t mask_l, uint64_t *bm_s,
                         uint64_t *bm_l) {
  const __m512i c0 = _mm512_set1_epi32((int)MIX_C0);
  const __m512i c1 = _mm512_set1_epi32((int)MIX_C1);
  const __m512i c2 = _mm512_set1_epi32((int)MIX_C2);
  const __m512i one = _mm512_set1_epi32(1);
  const __m512i vms = _mm512_set1_epi32((int)mask_s);
  const __m512i vml = _mm512_set1_epi32((int)mask_l);
  // Necessary-condition mask for the early-out (see NTPU_GEAR_STEP8). An
  // all-zero vpre makes testn return all-ones — i.e. the early-out simply
  // never fires and every vector takes the full path; still correct.
  const __m512i vpre = _mm512_set1_epi32((int)(mask_s & mask_l & 0xFFFFu));

  __m512i pg = _mm512_setzero_si512(), p1 = pg, p2 = pg, p4 = pg, p8 = pg;

  // Warm the rolling state from the 32 bytes of history so position lo's
  // hash is whole-stream-identical (a 32-bit gear hash retains exactly 32
  // bytes). At the stream head the zero state IS the history (h starts
  // at 0). Callers keep lo tile-aligned, so lo is 0 or >= 32.
  if (lo >= 32) {
    { NTPU_GEAR_STEP8(_mm_loadu_si128((const __m128i *)(data + lo - 32))) }
    { NTPU_GEAR_STEP8(_mm_loadu_si128((const __m128i *)(data + lo - 16))) }
  }

  for (int64_t w = lo; w < hi; w += 64) {
    uint64_t ws = 0, wl = 0;
    const int64_t wend = (w + 64 <= hi) ? w + 64 : hi;
    int shift = 0;
    for (int64_t pos = w; pos < wend; pos += 16, shift += 16) {
      const int64_t rem = wend - pos;
      if (rem >= 16) {
        NTPU_GEAR_STEP8(_mm_loadu_si128((const __m128i *)(data + pos)))
        if (_mm512_testn_epi32_mask(s8v, vpre)) {
          const __m512i s16 =
              _mm512_add_epi32(s8v, _mm512_slli_epi32(oldp8, 16));
          ws |= (uint64_t)_mm512_testn_epi32_mask(s16, vms) << shift;
          wl |= (uint64_t)_mm512_testn_epi32_mask(s16, vml) << shift;
        }
      } else {
        const __mmask16 live = (__mmask16)((1u << rem) - 1);
        NTPU_GEAR_STEP8(_mm_maskz_loadu_epi8(live, (const void *)(data + pos)))
        const __m512i s16 =
            _mm512_add_epi32(s8v, _mm512_slli_epi32(oldp8, 16));
        ws |= (uint64_t)(_mm512_testn_epi32_mask(s16, vms) & live) << shift;
        wl |= (uint64_t)(_mm512_testn_epi32_mask(s16, vml) & live) << shift;
      }
    }
    bm_s[w >> 6] = ws;
    bm_l[w >> 6] = wl;
  }
}
#undef NTPU_GEAR_STEP8
#undef NTPU_GEAR_MIX
#pragma GCC diagnostic pop
#endif  // NTPU_X86

void gear_bitmaps_scalar(const uint8_t *data, int64_t lo, int64_t hi,
                         uint32_t mask_s, uint32_t mask_l, uint64_t *bm_s,
                         uint64_t *bm_l) {
  const int64_t w0 = lo >> 6, w1 = (hi + 63) >> 6;
  std::memset(bm_s + w0, 0, (size_t)(w1 - w0) * 8);
  std::memset(bm_l + w0, 0, (size_t)(w1 - w0) * 8);
  uint32_t h = 0;
  // A 32-bit gear hash only retains 32 bytes of history: warming up from
  // lo-31 makes h at every position >= lo whole-stream-identical.
  int64_t i = lo - 31;
  if (i < 0) i = 0;
  for (; i < hi; ++i) {
    h = (h << 1) + mix32(data[i]);
    if (i < lo) continue;
    if ((h & mask_s) == 0) bm_s[i >> 6] |= 1ULL << (i & 63);
    if ((h & mask_l) == 0) bm_l[i >> 6] |= 1ULL << (i & 63);
  }
}

// Test hook: NTPU_GEAR_FORCE_ISA=avx2|scalar pins the dispatch so the
// narrower arms are differential-testable on wider hardware.
int gear_forced_isa() {
  static const int forced = [] {
    const char *e = std::getenv("NTPU_GEAR_FORCE_ISA");
    if (e == nullptr) return 0;
    if (std::strcmp(e, "avx2") == 0) return 2;
    if (std::strcmp(e, "scalar") == 0) return 1;
    return 0;
  }();
  return forced;
}

// Which arm the dispatch actually selects (respecting the force hook):
// 3 = avx512, 2 = avx2, 1 = scalar. Callers that pin an arm for
// differential testing must assert on this instead of trusting the env
// var (forcing avx2 on a non-AVX2 host falls back to scalar, which would
// otherwise let a "differential" trivially compare scalar to scalar).
int gear_active_isa_impl() {
  const int forced = gear_forced_isa();
  if (forced == 1) return 1;
#ifdef NTPU_X86
  if (forced != 2 && __builtin_cpu_supports("avx512f") &&
      __builtin_cpu_supports("avx512bw") &&
      __builtin_cpu_supports("avx512vl")) {
    return 3;
  }
  if (__builtin_cpu_supports("avx2")) return 2;
#endif
  return 1;
}

void gear_bitmaps_range(const uint8_t *data, int64_t lo, int64_t hi,
                        uint32_t mask_s, uint32_t mask_l, uint64_t *bm_s,
                        uint64_t *bm_l) {
  switch (gear_active_isa_impl()) {
#ifdef NTPU_X86
    case 3:
      gear_bitmaps_avx512(data, lo, hi, mask_s, mask_l, bm_s, bm_l);
      return;
    case 2:
      gear_bitmaps_avx2(data, lo, hi, mask_s, mask_l, bm_s, bm_l);
      return;
#endif
    default:
      gear_bitmaps_scalar(data, lo, hi, mask_s, mask_l, bm_s, bm_l);
  }
}

// ---- Table-based candidate bitmaps (the vectorized arm of
// ntpu_cdc_chunk) ------------------------------------------------------
//
// Same position-parallel bitmap layout as the gear-v2 kernels above, but
// for a CALLER-supplied 256-entry gear table (the ntpu_cdc_chunk ABI):
// there is no mix arithmetic to inline, so the AVX2 arm runs the
// sequential recurrence across 8 independent STRIPES — one per u32 lane —
// with all 8 table lookups served by a single vpgatherdd per step. A
// 32-bit gear hash retains exactly 32 bytes of history, so warming each
// lane from stripe_start-31 makes every hash whole-stream identical (the
// gear_bitmaps_scalar argument applied per stripe); stripe seams are
// invisible in the bitmaps and cut resolution never learns they existed.

void cdc_table_bitmaps_scalar(const uint8_t *data, int64_t lo, int64_t hi,
                              const uint32_t *table, uint32_t mask_s,
                              uint32_t mask_l, uint64_t *bm_s,
                              uint64_t *bm_l) {
  const int64_t w0 = lo >> 6, w1 = (hi + 63) >> 6;
  std::memset(bm_s + w0, 0, (size_t)(w1 - w0) * 8);
  std::memset(bm_l + w0, 0, (size_t)(w1 - w0) * 8);
  uint32_t h = 0;
  int64_t i = lo - 31;
  if (i < 0) i = 0;
  for (; i < hi; ++i) {
    h = (h << 1) + table[data[i]];
    if (i < lo) continue;
    if ((h & mask_s) == 0) bm_s[i >> 6] |= 1ULL << (i & 63);
    if ((h & mask_l) == 0) bm_l[i >> 6] |= 1ULL << (i & 63);
  }
}

#ifdef NTPU_X86
// Byte feed: one 32-bit load per lane covers the next 4 positions, so
// the 8 scalar loads amortize across 4 gather steps. Candidates
// accumulate as one movemask byte per step (bit l = stripe l) and the
// 64x8 step-major matrix transposes to per-stripe bitmap words via the
// slide-bit-l-to-MSB + movemask_epi8 column extract — no BMI2/pext
// dependency (pext is microcoded on pre-Zen3 AMD).
__attribute__((target("avx2")))
void cdc_table_bitmaps_avx2(const uint8_t *data, int64_t lo, int64_t hi,
                            const uint32_t *table, uint32_t mask_s,
                            uint32_t mask_l, uint64_t *bm_s, uint64_t *bm_l) {
  const int64_t len = hi - lo;
  // Per-lane stripe length, 64-aligned so every stripe starts on a
  // bitmap word boundary (lo arrives tile-aligned). Word loads at
  // offsets 0,4,..,slen-4 stay strictly in-stripe: no read ever crosses
  // hi, so no over-read guard is needed.
  const int64_t slen = (len / 8) & ~(int64_t)63;
  if (slen < 64) {
    cdc_table_bitmaps_scalar(data, lo, hi, table, mask_s, mask_l, bm_s, bm_l);
    return;
  }
  alignas(32) uint32_t hs[8];
  for (int l = 0; l < 8; ++l) {
    const int64_t s = lo + l * slen;
    uint32_t h = 0;
    int64_t i = s - 31;
    if (i < 0) i = 0;
    for (; i < s; ++i) h = (h << 1) + table[data[i]];
    hs[l] = h;
  }
  __m256i hv = _mm256_load_si256((const __m256i *)hs);
  const __m256i vms = _mm256_set1_epi32((int)mask_s);
  const __m256i vml = _mm256_set1_epi32((int)mask_l);
  const __m256i vzero = _mm256_setzero_si256();
  const __m256i bytemask = _mm256_set1_epi32(0xFF);

  alignas(32) uint8_t mb_s[64];
  alignas(32) uint8_t mb_l[64];
  for (int64_t t = 0; t < slen; t += 64) {
    for (int64_t u = 0; u < 64; u += 4) {
      alignas(32) uint32_t wsrc[8];
      for (int l = 0; l < 8; ++l) {
        std::memcpy(&wsrc[l], data + lo + l * slen + t + u, 4);
      }
      __m256i words = _mm256_load_si256((const __m256i *)wsrc);
      for (int b = 0; b < 4; ++b) {
        const __m256i idx = _mm256_and_si256(words, bytemask);
        words = _mm256_srli_epi32(words, 8);
        const __m256i g = _mm256_i32gather_epi32((const int *)table, idx, 4);
        hv = _mm256_add_epi32(_mm256_slli_epi32(hv, 1), g);
        mb_s[u + b] = (uint8_t)_mm256_movemask_ps(_mm256_castsi256_ps(
            _mm256_cmpeq_epi32(_mm256_and_si256(hv, vms), vzero)));
        mb_l[u + b] = (uint8_t)_mm256_movemask_ps(_mm256_castsi256_ps(
            _mm256_cmpeq_epi32(_mm256_and_si256(hv, vml), vzero)));
      }
    }
    const __m256i s_lo = _mm256_load_si256((const __m256i *)mb_s);
    const __m256i s_hi = _mm256_load_si256((const __m256i *)(mb_s + 32));
    const __m256i l_lo = _mm256_load_si256((const __m256i *)mb_l);
    const __m256i l_hi = _mm256_load_si256((const __m256i *)(mb_l + 32));
    for (int l = 0; l < 8; ++l) {
      // bit l of every mask byte -> MSB, then movemask reads the column;
      // stripe starts are 64-aligned, so the 64 steps are exactly one
      // bitmap word per stripe and a direct store suffices
      const __m128i sh = _mm_cvtsi32_si128(7 - l);
      const int64_t word = (lo + l * slen + t) >> 6;
      uint64_t ws = (uint32_t)_mm256_movemask_epi8(_mm256_sll_epi16(s_lo, sh));
      ws |= (uint64_t)(uint32_t)_mm256_movemask_epi8(
                _mm256_sll_epi16(s_hi, sh))
            << 32;
      bm_s[word] = ws;
      uint64_t wl = (uint32_t)_mm256_movemask_epi8(_mm256_sll_epi16(l_lo, sh));
      wl |= (uint64_t)(uint32_t)_mm256_movemask_epi8(
                _mm256_sll_epi16(l_hi, sh))
            << 32;
      bm_l[word] = wl;
    }
  }
  if (lo + 8 * slen < hi)
    cdc_table_bitmaps_scalar(data, lo + 8 * slen, hi, table, mask_s, mask_l,
                             bm_s, bm_l);
}
#endif  // NTPU_X86

// Test hook: NTPU_CDC_FORCE_ISA=scalar pins the table-based dispatch so
// the striped AVX2 arm is differential-testable against the portable arm
// on the same host (mirrors NTPU_GEAR_FORCE_ISA for the fused kernels).
int cdc_forced_isa() {
  static const int forced = [] {
    const char *e = std::getenv("NTPU_CDC_FORCE_ISA");
    if (e == nullptr) return 0;
    if (std::strcmp(e, "avx2") == 0) return 2;
    if (std::strcmp(e, "scalar") == 0) return 1;
    return 0;
  }();
  return forced;
}

// Which table-scan arm the dispatch selects (2 = avx2 striped,
// 1 = scalar). Tests assert on this, not the env var: forcing avx2 on a
// non-AVX2 host falls back to scalar and a naive differential would
// compare scalar to scalar.
int cdc_active_isa_impl() {
  if (cdc_forced_isa() == 1) return 1;
#ifdef NTPU_X86
  if (__builtin_cpu_supports("avx2")) return 2;
#endif
  return 1;
}

void cdc_table_bitmaps_range(const uint8_t *data, int64_t lo, int64_t hi,
                             const uint32_t *table, uint32_t mask_s,
                             uint32_t mask_l, uint64_t *bm_s,
                             uint64_t *bm_l) {
  switch (cdc_active_isa_impl()) {
#ifdef NTPU_X86
    case 2:
      cdc_table_bitmaps_avx2(data, lo, hi, table, mask_s, mask_l, bm_s, bm_l);
      return;
#endif
    default:
      cdc_table_bitmaps_scalar(data, lo, hi, table, mask_s, mask_l, bm_s,
                               bm_l);
  }
}

// First set bit in [lo, hi) of an LSB-first word bitmap, or -1.
inline int64_t find_first_set(const uint64_t *bm, int64_t lo, int64_t hi) {
  if (lo >= hi) return -1;
  int64_t w = lo >> 6;
  const int64_t wend = (hi + 63) >> 6;
  uint64_t word = bm[w] & (~0ULL << (lo & 63));
  for (;;) {
    if (word) {
      const int64_t bit = (w << 6) + __builtin_ctzll(word);
      return bit < hi ? bit : -1;
    }
    if (++w >= wend) return -1;
    word = bm[w];
  }
}

// ---- LZ4 block codec (dlopen'd system liblz4; absent -> caller falls
// back to its Python codec path) --------------------------------------

typedef int (*lz4_fast_fn)(const char *, char *, int, int, int);

lz4_fast_fn load_lz4(void) {
  static lz4_fast_fn fn = [] {
    void *h = dlopen("liblz4.so.1", RTLD_NOW);
    if (h == nullptr) h = dlopen("liblz4.so", RTLD_NOW);
    if (h == nullptr) return (lz4_fast_fn) nullptr;
    return (lz4_fast_fn)dlsym(h, "LZ4_compress_fast");
  }();
  return fn;
}

// LZ4_compressBound, computable without the library.
inline int64_t lz4_bound(int64_t n) { return n + n / 255 + 16; }

constexpr int64_t LZ4_MAX_INPUT = 0x7E000000;

// ---- zstd codec (dlopen'd system libzstd; absent -> caller falls back
// to its Python codec path). The level arrives through the pack ABI's
// codec-param slot (Python single source: constants.ZSTD_LEVEL);
// ZSTD_compress at a given level is byte-identical to the Python lane's
// system-libzstd binding at the same level, so the fused/serial/parallel
// and Python arms keep the byte-identity invariant across compressors. ----

typedef size_t (*zstd_compress_fn)(void *, size_t, const void *, size_t, int);
typedef size_t (*zstd_bound_fn)(size_t);
typedef unsigned (*zstd_iserr_fn)(size_t);
typedef void *(*zstd_createcctx_fn)(void);
typedef size_t (*zstd_freecctx_fn)(void *);
typedef size_t (*zstd_compresscctx_fn)(void *, void *, size_t, const void *,
                                       size_t, int);

struct ZstdApi {
  zstd_compress_fn compress;
  zstd_bound_fn bound;
  zstd_iserr_fn iserr;
  zstd_createcctx_fn create_cctx;
  zstd_freecctx_fn free_cctx;
  zstd_compresscctx_fn compress_cctx;
};

// RAII per-worker compression context: ZSTD_compressCCtx produces the
// same bytes as one-shot ZSTD_compress at the same level, without paying
// context alloc/init per chunk in the fused hot loop.
struct ZstdCtx {
  const ZstdApi *api;
  void *ctx;
  explicit ZstdCtx(const ZstdApi *a)
      : api(a), ctx(a != nullptr ? a->create_cctx() : nullptr) {}
  ~ZstdCtx() {
    if (ctx != nullptr) api->free_cctx(ctx);
  }
  ZstdCtx(const ZstdCtx &) = delete;
  ZstdCtx &operator=(const ZstdCtx &) = delete;
};


const ZstdApi *load_zstd(void) {
  static const ZstdApi *api = []() -> const ZstdApi * {
    void *h = dlopen("libzstd.so.1", RTLD_NOW);
    if (h == nullptr) h = dlopen("libzstd.so", RTLD_NOW);
    if (h == nullptr) return nullptr;
    static ZstdApi a;
    a.compress = (zstd_compress_fn)dlsym(h, "ZSTD_compress");
    a.bound = (zstd_bound_fn)dlsym(h, "ZSTD_compressBound");
    a.iserr = (zstd_iserr_fn)dlsym(h, "ZSTD_isError");
    a.create_cctx = (zstd_createcctx_fn)dlsym(h, "ZSTD_createCCtx");
    a.free_cctx = (zstd_freecctx_fn)dlsym(h, "ZSTD_freeCCtx");
    a.compress_cctx = (zstd_compresscctx_fn)dlsym(h, "ZSTD_compressCCtx");
    if (a.compress == nullptr || a.bound == nullptr || a.iserr == nullptr ||
        a.create_cctx == nullptr || a.free_cctx == nullptr ||
        a.compress_cctx == nullptr)
      return nullptr;
    return &a;
  }();
  return api;
}

}  // namespace

extern "C" {

// Which gear arm the dispatch selects on this host + env (3 = avx512,
// 2 = avx2, 1 = scalar) — lets the ISA differential tests assert the arm
// they pinned actually runs.
int64_t ntpu_gear_active_isa(void) { return gear_active_isa_impl(); }

// Returns the number of cut offsets written to cuts_out (exclusive chunk
// ends, final == n). cuts_cap is the capacity of cuts_out; on overflow the
// function returns -1. table is the caller's 256-entry gear table.
int64_t ntpu_cdc_chunk(const uint8_t *data, int64_t n,
                       const uint32_t *table,
                       uint32_t mask_small, uint32_t mask_large,
                       int64_t min_size, int64_t normal_size,
                       int64_t max_size,
                       int64_t *cuts_out, int64_t cuts_cap) {
  int64_t n_cuts = 0;
  int64_t start = 0;
  while (n - start > min_size) {
    uint32_t h = 0;
    int64_t end = -1;
    const int64_t scan_end = (start + max_size < n) ? start + max_size : n;
    // a length of exactly normal_size is judged with the LARGE mask
    // (cdc.py resolve_cuts: small range is [min-1, normal-1))
    const int64_t normal_end =
        (start + normal_size - 1 < scan_end) ? start + normal_size - 1 : scan_end;
    // Judgement starts at judge_from; a 32-bit gear hash only retains the
    // last 32 bytes (one bit of history per shift), so hashing can begin
    // 32 bytes before it — the bytes in [start, judge_from-31) can never
    // influence a judged value. Skipping them is bit-exact and saves
    // min_size-32 table ops per chunk.
    const int64_t judge_from = start + min_size - 1;
    int64_t i = judge_from - 31;
    if (i < start) i = start;
    for (; i < judge_from && i < scan_end; ++i) {
      h = (h << 1) + table[data[i]];
    }
    // small-mask region: [min_size, normal_size)
    for (; i < normal_end; ++i) {
      h = (h << 1) + table[data[i]];
      if ((h & mask_small) == 0) {
        end = i + 1;
        break;
      }
    }
    if (end < 0) {
      // large-mask region: [normal_size, max_size)
      for (; i < scan_end; ++i) {
        h = (h << 1) + table[data[i]];
        if ((h & mask_large) == 0) {
          end = i + 1;
          break;
        }
      }
    }
    if (end < 0) {
      end = (scan_end == start + max_size) ? start + max_size : n;
    }
    if (n_cuts >= cuts_cap) return -1;
    cuts_out[n_cuts++] = end;
    start = end;
  }
  if (n > start) {
    if (n_cuts >= cuts_cap) return -1;
    cuts_out[n_cuts++] = n;
  }
  return n_cuts;
}

// Which table-scan arm ntpu_cdc_chunk_vec dispatches to on this host +
// env (2 = avx2 striped, 1 = scalar) — lets the differential battery
// assert the arm it pinned actually runs.
int64_t ntpu_cdc_active_isa(void) { return cdc_active_isa_impl(); }

// Vectorized arm of ntpu_cdc_chunk: SAME ABI, SAME cuts. Candidate
// bitmaps come from the striped table kernel (AVX2 gather lanes with a
// portable-scalar fallback, runtime-dispatched); cuts are then resolved
// with the exact region/judgement discipline of ntpu_cdc_chunk /
// ops/cdc.resolve_cuts, so the output is cut-identical to the
// sequential scanner and to chunk_sequential_reference by construction —
// the bitmaps are position-exact whole-stream candidates (judged
// positions sit >= min_size >= 32 past their chunk start, so per-chunk
// hash state equals whole-stream state at every judged position), and
// the resolution loop is shared. Differential-proven in
// tests/test_chunk_engine.py, gear-table-resonance corpora included.
// Bitmap tiles are computed lazily exactly as in ntpu_chunk_digest: the
// resolution scan advances strictly forward, so skipped gaps
// ([cut, cut + min_size - 32) of every chunk) are never hashed at all.
int64_t ntpu_cdc_chunk_vec(const uint8_t *data, int64_t n,
                           const uint32_t *table,
                           uint32_t mask_small, uint32_t mask_large,
                           int64_t min_size, int64_t normal_size,
                           int64_t max_size,
                           int64_t *cuts_out, int64_t cuts_cap) {
  if (n <= 0) return 0;
  const int64_t words = (n + 63) >> 6;
  uint64_t *bm = (uint64_t *)std::malloc((size_t)words * 16);
  if (bm == nullptr) return -1;
  uint64_t *bm_s = bm, *bm_l = bm + words;

  // 8 stripes x 1024 positions per lazy tile: big enough that the 31-byte
  // per-stripe warm-up is ~3% overhead, small enough to stay cache-warm.
  constexpr int64_t VTILE = 8192;
  int64_t hashed_until = 0;
  const auto ensure_tile = [&](int64_t pos) {
    const int64_t t0 = pos & ~(VTILE - 1);
    if (t0 < hashed_until) return;
    const int64_t t1 = (t0 + VTILE < n) ? t0 + VTILE : n;
    cdc_table_bitmaps_range(data, t0, t1, table, mask_small, mask_large,
                            bm_s, bm_l);
    hashed_until = t0 + VTILE;
  };
  const auto scan = [&](const uint64_t *bmx, int64_t lo, int64_t hi) {
    int64_t pos = lo;
    while (pos < hi) {
      ensure_tile(pos);
      int64_t te = (pos & ~(VTILE - 1)) + VTILE;
      if (te > hi) te = hi;
      const int64_t i = find_first_set(bmx, pos, te);
      if (i >= 0) return i;
      pos = te;
    }
    return (int64_t)-1;
  };

  int64_t n_cuts = 0;
  int64_t start = 0;
  while (n - start > min_size) {
    const int64_t scan_end = (start + max_size < n) ? start + max_size : n;
    const int64_t normal_end =
        (start + normal_size - 1 < scan_end) ? start + normal_size - 1
                                             : scan_end;
    const int64_t judge_from = start + min_size - 1;
    int64_t end = -1;
    int64_t i = scan(bm_s, judge_from, normal_end);
    if (i >= 0) end = i + 1;
    if (end < 0) {
      i = scan(bm_l, normal_end, scan_end);
      if (i >= 0) end = i + 1;
    }
    if (end < 0) end = (scan_end == start + max_size) ? scan_end : n;
    if (n_cuts >= cuts_cap) {
      std::free(bm);
      return -1;
    }
    cuts_out[n_cuts++] = end;
    start = end;
  }
  if (n > start) {
    if (n_cuts >= cuts_cap) {
      std::free(bm);
      return -1;
    }
    cuts_out[n_cuts++] = n;
  }
  std::free(bm);
  return n_cuts;
}

// Open-addressing chunk-dict table build: sequential first-wins insertion
// (the host arm of parallel/sharded_dict.py's table builder — single-pass
// sequential insertion beats any vectorized lockstep scheme on the
// memory-bound path, and ctypes drops the GIL for the call).
//
// digests: u32[n][8] raw SHA-256 keys. keys: u32[n_shards*cap][8] and
// values: i32[n_shards*cap] must arrive zeroed (0 = empty slot). Shard =
// word0 % n_shards, slot base = word1 & (cap-1), linear probing. A probe
// hitting an equal key is a duplicate: dropped, first insertion wins.
// Returns 0 on success, -1 when a probe chain exceeded max_probe (caller
// grows cap and retries).
int64_t ntpu_dict_build(const uint32_t *digests, int64_t n,
                        int64_t n_shards, int64_t cap, int64_t max_probe,
                        uint32_t *keys, int32_t *values) {
  for (int64_t idx = 0; idx < n; ++idx) {
    const uint32_t *d = digests + idx * 8;
    const uint64_t shard = d[0] % (uint64_t)n_shards;
    const uint64_t base = d[1] & (uint64_t)(cap - 1);
    bool placed = false;
    for (int64_t j = 0; j < max_probe; ++j) {
      const uint64_t lin = shard * (uint64_t)cap + ((base + j) & (uint64_t)(cap - 1));
      if (values[lin] == 0) {
        std::memcpy(keys + lin * 8, d, 32);
        values[lin] = (int32_t)(idx + 1);
        placed = true;
        break;
      }
      if (std::memcmp(keys + lin * 8, d, 32) == 0) {
        placed = true;  // duplicate digest: first insertion wins
        break;
      }
    }
    if (!placed) return -1;
  }
  return 0;
}

// Incremental insert into an already-built table (same layout as
// ntpu_dict_build): place k entries carrying EXPLICIT stored values
// (+1 form — the caller numbers them as first-occurrence positions of
// the concatenated insertion sequence, so previously issued indices
// never move). Cost is proportional to k, not the table — the
// insert-proportional arm that replaces the full rebuild on growth.
// An equal key already in the table is skipped (idempotent re-insert).
// Values are release-stored AFTER the 32-byte key write so a concurrent
// lock-free probe never pairs a live value with a torn key (it treats
// value==0 as empty and linearizes before the insert).
// Returns the deepest chain reached (>= 0) on success, or -1 when any
// entry overflowed max_probe (caller falls back to a value-preserving
// rebuild; entries placed before the overflow are in the table, which
// the rebuild's occupancy scan collects).
int64_t ntpu_dict_insert(const uint32_t *digests, const int32_t *vals,
                         int64_t k, int64_t n_shards, int64_t cap,
                         int64_t max_probe, uint32_t *keys, int32_t *values) {
  int64_t depth = 0;
  for (int64_t idx = 0; idx < k; ++idx) {
    const uint32_t *d = digests + idx * 8;
    const uint64_t shard = d[0] % (uint64_t)n_shards;
    const uint64_t base = d[1] & (uint64_t)(cap - 1);
    bool placed = false;
    for (int64_t j = 0; j < max_probe; ++j) {
      const uint64_t lin = shard * (uint64_t)cap + ((base + j) & (uint64_t)(cap - 1));
      if (values[lin] == 0) {
        std::memcpy(keys + lin * 8, d, 32);
#if defined(__GNUC__) || defined(__clang__)
        __atomic_store_n(&values[lin], vals[idx], __ATOMIC_RELEASE);
#else
        values[lin] = vals[idx];
#endif
        if (j + 1 > depth) depth = j + 1;
        placed = true;
        break;
      }
      if (std::memcmp(keys + lin * 8, d, 32) == 0) {
        placed = true;  // already present: first insertion wins
        break;
      }
    }
    if (!placed) return -1;
  }
  return depth;
}

// Fused probe-or-insert over one batch (the insert_u32 hot path): for
// each digest in order, walk its chain once — a key match answers with
// the stored index (batch-internal duplicates resolve to the entry just
// placed, so values are first-occurrence positions of the concatenated
// sequence with NO host-side pre-dedup or separate lookup pass); an
// empty slot inserts value base+idx+1 and answers base+idx. out_idx[k]
// receives every answer. Returns (depth << 32) | n_new on success
// (depth = deepest chain reached, n_new = fresh slots consumed), or -1
// when any chain overflowed max_probe (entries before the overflow are
// placed with their final values — the caller's fallback path sees them
// as ordinary hits, so the partial work is semantically idempotent).
int64_t ntpu_dict_upsert(const uint32_t *digests, int64_t n, int64_t base,
                         int64_t n_shards, int64_t cap, int64_t max_probe,
                         uint32_t *keys, int32_t *values, int64_t *out_idx) {
  int64_t depth = 0;
  int64_t n_new = 0;
  for (int64_t idx = 0; idx < n; ++idx) {
    const uint32_t *d = digests + idx * 8;
    const uint64_t shard = d[0] % (uint64_t)n_shards;
    const uint64_t slot0 = d[1] & (uint64_t)(cap - 1);
    bool placed = false;
    for (int64_t j = 0; j < max_probe; ++j) {
      const uint64_t lin = shard * (uint64_t)cap + ((slot0 + j) & (uint64_t)(cap - 1));
      if (values[lin] == 0) {
        std::memcpy(keys + lin * 8, d, 32);
#if defined(__GNUC__) || defined(__clang__)
        __atomic_store_n(&values[lin], (int32_t)(base + idx + 1), __ATOMIC_RELEASE);
#else
        values[lin] = (int32_t)(base + idx + 1);
#endif
        out_idx[idx] = base + idx;
        if (j + 1 > depth) depth = j + 1;
        ++n_new;
        placed = true;
        break;
      }
      if (std::memcmp(keys + lin * 8, d, 32) == 0) {
        out_idx[idx] = (int64_t)values[lin] - 1;
        placed = true;
        break;
      }
    }
    if (!placed) return -1;
  }
  return (depth << 32) | n_new;
}

// Probe a batch of digests against a built table (same layout as
// ntpu_dict_build). Writes the stored value-1 (= dict chunk index) per
// query, or -1 on miss. This is the single-node latency arm of the dedup
// probe: XLA TPU gathers execute element-serially (~1 µs/element measured
// on v5e), so host probing wins until the dict is sharded across chips
// (parallel/sharded_dict.py's all_to_all path).
// The probe side of the lock-free protocol: values are ACQUIRE-loaded so
// a nonzero value happens-after the inserter's 32-byte key memcpy (which
// the inserter sequences before its RELEASE store). A plain load would
// let the compiler/TSan-visible ordering pair a live value with a torn
// key; acquire is free on x86 (plain mov) and what the release store has
// always assumed. Verified under ThreadSanitizer by the concurrent
// upsert-vs-probe battery in tests/test_native_sanitizers.py.
static inline int32_t ntpu_value_acquire(const int32_t *p) {
#if defined(__GNUC__) || defined(__clang__)
  return __atomic_load_n(p, __ATOMIC_ACQUIRE);
#else
  return *p;
#endif
}

void ntpu_dict_probe(const uint32_t *queries, int64_t m,
                     const uint32_t *keys, const int32_t *values,
                     int64_t n_shards, int64_t cap, int64_t max_probe,
                     int64_t *out) {
  for (int64_t i = 0; i < m; ++i) {
    const uint32_t *q = queries + i * 8;
    const uint64_t shard = q[0] % (uint64_t)n_shards;
    const uint64_t base = q[1] & (uint64_t)(cap - 1);
    int64_t ans = -1;
    for (int64_t j = 0; j < max_probe; ++j) {
      const uint64_t lin = shard * (uint64_t)cap + ((base + j) & (uint64_t)(cap - 1));
      const int32_t v = ntpu_value_acquire(values + lin);
      if (v == 0) break;  // empty slot terminates the chain
      if (std::memcmp(keys + lin * 8, q, 32) == 0) {
        ans = (int64_t)v - 1;
        break;
      }
    }
    out[i] = ans;
  }
}

// Position-parallel gear hash of every byte position (the same
// h_i = sum G[x_{i-k}] << k decomposition the TPU kernel uses) — useful
// for differential testing the device bitmaps from C++.
void ntpu_gear_hashes(const uint8_t *data, int64_t n,
                      const uint32_t *table, uint32_t *out) {
  uint32_t h = 0;
  for (int64_t i = 0; i < n; ++i) {
    h = (h << 1) + table[data[i]];
    out[i] = h;
  }
}

// SHA-256 of m extents of data; extents are (offset, size) i64 pairs,
// digests_out gets 32 bytes per extent. The batch scheduler keeps three
// SHA-NI chains busy regardless of per-extent length imbalance.
void ntpu_sha256_many(const uint8_t *data, const int64_t *extents, int64_t m,
                      uint8_t *digests_out) {
  ntpu_sha::sha256_extents(data, extents, m, digests_out);
}

// BLAKE3 of m extents of data (same shape contract as ntpu_sha256_many).
// The chunk digester for real-image dedup parity: the reference
// toolchain's default chunk digests are blake3, so `--chunk-dict
// bootstrap=<real image>` content hits need blake3 chunk digests at pack
// time (reference tool/builder.go:122-123; RafsSuperFlags HASH_BLAKE3).
void ntpu_blake3_many(const uint8_t *data, const int64_t *extents, int64_t m,
                      uint8_t *digests_out) {
  ntpu_b3::blake3_extents(data, extents, m, digests_out);
}

// Which blake3 leaf arm runs on this host + env (3 = avx512, 2 = avx2,
// 1 = scalar) — lets the ISA differential tests assert the pinned arm.
int64_t ntpu_b3_active_isa(void) { return ntpu_b3::b3_active_isa(); }

// Fused single-pass chunk + digest: SIMD candidate bitmaps -> cut
// resolution -> per-chunk SHA-256 while the bytes are cache-warm. This is
// the host latency arm's fast path, replacing the separate
// boundaries/digest sweeps (the reference does all of this inside one
// `nydus-image create` process, pkg/converter/tool/builder.go:148-178).
// Hashing is gear-v2 arithmetic (mix32); callers that pass a custom gear
// table must use ntpu_cdc_chunk instead. digests_out may be null for a
// boundaries-only pass. algo selects the chunk digest: 0 = SHA-256
// (SHA-NI batch), 1 = BLAKE3 (AVX2 8-way leaves) — the real toolchain's
// default digester, so blake3 packs ride the same fused hot loop.
// Returns the number of cuts (= digests) written, or -1 on cuts_cap
// overflow / allocation failure.
int64_t ntpu_chunk_digest(const uint8_t *data, int64_t n,
                          uint32_t mask_small, uint32_t mask_large,
                          int64_t min_size, int64_t normal_size,
                          int64_t max_size, int64_t *cuts_out,
                          int64_t cuts_cap, uint8_t *digests_out,
                          int64_t algo) {
  if (n <= 0) return 0;  // malloc(0) may return NULL; empty input is 0 cuts
  const int64_t words = (n + 63) >> 6;
  uint64_t *bm = (uint64_t *)std::malloc((size_t)words * 16);
  if (bm == nullptr) return -1;
  uint64_t *bm_s = bm, *bm_l = bm + words;

  // Lazy tile hashing: bitmap tiles are computed only when the resolution
  // scan first touches them. Scans advance strictly forward (each chunk's
  // judge window starts min_size-1 past the previous cut), so a single
  // watermark suffices and the skipped gaps — [cut, cut + min_size - 32)
  // of every chunk, ~min/avg of all bytes — are never hashed at all.
  int64_t hashed_until = 0;
  const auto ensure_tile = [&](int64_t pos) {
    const int64_t t0 = pos & ~(TILE - 1);
    if (t0 < hashed_until) return;
    const int64_t t1 = (t0 + TILE < n) ? t0 + TILE : n;
    gear_bitmaps_range(data, t0, t1, mask_small, mask_large, bm_s, bm_l);
    hashed_until = t0 + TILE;
  };
  // First candidate position in [lo, hi) of bitmap bmx, or -1.
  const auto scan = [&](const uint64_t *bmx, int64_t lo, int64_t hi) {
    int64_t pos = lo;
    while (pos < hi) {
      ensure_tile(pos);
      int64_t te = (pos & ~(TILE - 1)) + TILE;
      if (te > hi) te = hi;
      const int64_t i = find_first_set(bmx, pos, te);
      if (i >= 0) return i;
      pos = te;
    }
    return (int64_t)-1;
  };

  // Same region/judgement semantics as ntpu_cdc_chunk (differential-
  // tested equal in tests/test_native_engine.py).
  int64_t n_cuts = 0;
  int64_t start = 0;
  while (n - start > min_size) {
    const int64_t scan_end = (start + max_size < n) ? start + max_size : n;
    const int64_t normal_end =
        (start + normal_size - 1 < scan_end) ? start + normal_size - 1
                                             : scan_end;
    const int64_t judge_from = start + min_size - 1;
    int64_t end = -1;
    int64_t i = scan(bm_s, judge_from, normal_end);
    if (i >= 0) end = i + 1;
    if (end < 0) {
      i = scan(bm_l, normal_end, scan_end);
      if (i >= 0) end = i + 1;
    }
    if (end < 0) end = (scan_end == start + max_size) ? scan_end : n;
    if (n_cuts >= cuts_cap) {
      std::free(bm);
      return -1;
    }
    cuts_out[n_cuts++] = end;
    start = end;
  }
  if (n > start) {
    if (n_cuts >= cuts_cap) {
      std::free(bm);
      return -1;
    }
    cuts_out[n_cuts++] = n;
  }
  std::free(bm);

  if (digests_out != nullptr && n_cuts > 0) {
    int64_t *ext = (int64_t *)std::malloc((size_t)n_cuts * 16);
    if (ext == nullptr) return -1;
    int64_t s = 0;
    for (int64_t j = 0; j < n_cuts; ++j) {
      ext[2 * j] = s;
      ext[2 * j + 1] = cuts_out[j] - s;
      s = cuts_out[j];
    }
    if (algo == 1)
      ntpu_b3::blake3_extents(data, ext, n_cuts, digests_out);
    else
      ntpu_sha::sha256_extents(data, ext, n_cuts, digests_out);
    std::free(ext);
  }
  return n_cuts;
}

// Batched fused chunk+digest over MANY file extents in one call: the
// in-memory pack path walks thousands of small files per layer (the
// node_modules shape), and a ctypes round trip per file costs ~15% of
// the engine stage. One call amortizes the FFI + GIL churn for the
// whole layer (the per-file bitmap scratch is cheap by comparison).
//
// extents: m (off, size) i64 pairs into data. Per file, cut offsets
// (file-relative, exclusive ends) append to cuts_out and 32-B digests to
// digests_out; file_ncuts[i] receives that file's cut count. Returns the
// total number of cuts, -1 on cap overflow/OOM.
int64_t ntpu_chunk_digest_multi(const uint8_t *data, const int64_t *extents,
                                int64_t m, uint32_t mask_small,
                                uint32_t mask_large, int64_t min_size,
                                int64_t normal_size, int64_t max_size,
                                int64_t *file_ncuts, int64_t *cuts_out,
                                int64_t cuts_cap, uint8_t *digests_out,
                                int64_t algo) {
  int64_t total = 0;
  for (int64_t i = 0; i < m; ++i) {
    const int64_t off = extents[2 * i];
    const int64_t size = extents[2 * i + 1];
    const int64_t n = ntpu_chunk_digest(
        data + off, size, mask_small, mask_large, min_size, normal_size,
        max_size, cuts_out + total, cuts_cap - total,
        digests_out != nullptr ? digests_out + 32 * total : nullptr, algo);
    if (n < 0) return -1;
    file_ncuts[i] = n;
    total += n;
  }
  return total;
}

// Fused blob-section assembly: the per-chunk compress -> append -> hash
// loop of the data section in one native pass (the reference keeps this
// whole loop inside one `nydus-image create` process,
// pkg/converter/tool/builder.go:148-178; re-entering Python per chunk was
// ~80% of full-path wall time).
//
// extents: m (src, off, size) i64 triples — src 0 reads from src0 (the
// caller's tar buffer, zero-copy), src 1 from src1 (loose bytes the
// caller staged). compressor: 0 = store raw, 1 = LZ4 block (accel >= 1;
// 1 == LZ4_compress_default output). Chunks land back-to-back in out
// (no alignment padding — the caller gates on that layout);
// comp_extents gets (coff, csize) per chunk; blob_digest32 (nullable)
// gets SHA-256 of the assembled section. n_threads > 1 compresses
// chunks in parallel into a bound-spaced scratch then compacts —
// output bytes are identical to the serial pass.
//
// Returns the section size, -1 on overflow/allocation/compress failure,
// -2 when the compressor's system library (liblz4/libzstd) is absent.
int64_t ntpu_pack_section(const uint8_t *src0, const uint8_t *src1,
                          const int64_t *extents, int64_t m,
                          int64_t compressor, int64_t accel,
                          int64_t n_threads, uint8_t *out, int64_t out_cap,
                          int64_t *comp_extents, uint8_t *blob_digest32) {
  lz4_fast_fn lz4 = nullptr;
  const ZstdApi *zstd = nullptr;
  if (compressor == 1) {
    lz4 = load_lz4();
    if (lz4 == nullptr) return -2;
  } else if (compressor == 2) {
    zstd = load_zstd();
    if (zstd == nullptr) return -2;
  }
  // lz4-only clamp: for zstd the slot carries the LEVEL verbatim (libzstd
  // defines level 0 = default and negative fast levels; rewriting them
  // here would silently diverge from the Python lane's same-level call).
  if (compressor != 2 && accel < 1) accel = 1;
  // Worst-case output per chunk for bound-spaced parallel slots and
  // serial overflow checks.
  auto bound = [&](int64_t n) -> int64_t {
    if (compressor == 1) return lz4_bound(n);
    if (compressor == 2) return (int64_t)zstd->bound((size_t)n);
    return n;
  };
  // Compress one chunk into dst (dst has >= bound(size) room); returns
  // csize or -1 on codec failure. zctx is the worker's reusable zstd
  // compression context (null for other codecs).
  auto compress_one = [&](void *zctx, const uint8_t *src, int64_t size,
                          uint8_t *dst, int64_t dst_cap) -> int64_t {
    if (compressor == 1) {
      const int64_t cap =
          dst_cap > LZ4_MAX_INPUT ? LZ4_MAX_INPUT : dst_cap;
      const int64_t csize = lz4((const char *)src, (char *)dst, (int)size,
                                (int)cap, (int)accel);
      return csize <= 0 ? -1 : csize;
    }
    if (compressor == 2) {
      // accel doubles as the codec-param slot: for zstd it IS the level,
      // threaded from Python's single source (constants.ZSTD_LEVEL) so
      // the cross-lane byte identity cannot drift on a level bump.
      if (zctx == nullptr) return -1;
      const size_t w = zstd->compress_cctx(zctx, dst, (size_t)dst_cap, src,
                                           (size_t)size, (int)accel);
      return zstd->iserr(w) ? -1 : (int64_t)w;
    }
    std::memcpy(dst, src, (size_t)size);
    return size;
  };
  int64_t coff = 0;
  if (m > 0 && n_threads <= 1) {
    ZstdCtx zc(compressor == 2 ? zstd : nullptr);
    for (int64_t j = 0; j < m; ++j) {
      const uint8_t *base = extents[3 * j] == 0 ? src0 : src1;
      const int64_t off = extents[3 * j + 1];
      const int64_t size = extents[3 * j + 2];
      if (compressor == 1 && size > LZ4_MAX_INPUT) return -1;
      if (coff + bound(size) > out_cap) return -1;
      const int64_t csize =
          compress_one(zc.ctx, base + off, size, out + coff, out_cap - coff);
      if (csize < 0) return -1;
      comp_extents[2 * j] = coff;
      comp_extents[2 * j + 1] = csize;
      coff += csize;
    }
  } else if (m > 0) {
    // Parallel arm: workers compress straight into out at bound-spaced
    // offsets (the caller allocates out to exactly this sum of bounds),
    // then a serial pass compacts left in place — coff <= pre[j] always
    // (every predecessor's csize <= its bound), so memmove suffices and
    // no scratch allocation or second buffer is needed.
    std::vector<int64_t> pre((size_t)m);
    int64_t acc = 0;
    for (int64_t j = 0; j < m; ++j) {
      const int64_t size = extents[3 * j + 2];
      if (compressor == 1 && size > LZ4_MAX_INPUT) return -1;
      pre[(size_t)j] = acc;
      acc += bound(size);
    }
    if (acc > out_cap) return -1;
    std::atomic<int64_t> next{0};
    std::atomic<bool> failed{false};
    auto worker = [&]() {
      constexpr int64_t GRAB = 32;  // chunks per work grab
      ZstdCtx zc(compressor == 2 ? zstd : nullptr);  // one ctx per worker
      for (;;) {
        int64_t j = next.fetch_add(GRAB);
        if (j >= m || failed.load(std::memory_order_relaxed)) return;
        const int64_t jend = j + GRAB < m ? j + GRAB : m;
        for (; j < jend; ++j) {
          const uint8_t *base = extents[3 * j] == 0 ? src0 : src1;
          const int64_t off = extents[3 * j + 1];
          const int64_t size = extents[3 * j + 2];
          const int64_t csize = compress_one(
              zc.ctx, base + off, size, out + pre[(size_t)j], bound(size));
          if (csize < 0) {
            failed.store(true, std::memory_order_relaxed);
            return;
          }
          comp_extents[2 * j + 1] = csize;
        }
      }
    };
    std::vector<std::thread> pool;
    const int64_t nt = n_threads < m ? n_threads : m;
    for (int64_t t = 1; t < nt; ++t) pool.emplace_back(worker);
    worker();
    for (auto &th : pool) th.join();
    if (failed.load()) return -1;
    for (int64_t j = 0; j < m; ++j) {
      const int64_t csize = comp_extents[2 * j + 1];
      if (coff != pre[(size_t)j])
        std::memmove(out + coff, out + pre[(size_t)j], (size_t)csize);
      comp_extents[2 * j] = coff;
      coff += csize;
    }
  }
  if (blob_digest32 != nullptr) {
    const int64_t ext[2] = {0, coff};
    ntpu_sha::sha256_extents(out, ext, 1, blob_digest32);
  }
  return coff;
}

// Batched per-chunk zstd encode behind the adaptive codec's encode seam
// (converter/codec.py): m independent chunks -> m independent zstd
// frames at `level` in ONE GIL-released call. extents: m (off, size)
// i64 pairs into data. Frames land back-to-back in out; comp_extents
// gets (coff, csize) per chunk. Workers compress into bound-spaced
// slots with one reusable ZSTD_CCtx each (the codec engine's
// per-worker-context pin pushed down into C), then a serial pass
// compacts left in place — bytes are identical to per-chunk
// ZSTD_compressCCtx calls at the same level (== utils/zstd
// compress_with_ctx, the cross-lane byte-identity anchor).
// digests_out (nullable) additionally banks a 32-byte digest of each
// UNCOMPRESSED chunk (algo 0 = SHA-256, 1 = BLAKE3): the future device
// codec returns payloads + digests from one dispatch, so the batch ABI
// carries both today. Returns the packed payload size; -1 on
// overflow/codec failure; -2 when the system libzstd is absent.
int64_t ntpu_encode_batch(const uint8_t *data, const int64_t *extents,
                          int64_t m, int64_t level, int64_t n_threads,
                          uint8_t *out, int64_t out_cap,
                          int64_t *comp_extents, uint8_t *digests_out,
                          int64_t algo) {
  const ZstdApi *zstd = load_zstd();
  if (zstd == nullptr) return -2;
  if (m <= 0) return 0;
  std::vector<int64_t> pre((size_t)m);
  int64_t acc = 0;
  for (int64_t j = 0; j < m; ++j) {
    pre[(size_t)j] = acc;
    acc += (int64_t)zstd->bound((size_t)extents[2 * j + 1]);
  }
  if (acc > out_cap) return -1;
  auto encode_some = [&](void *ctx, int64_t j0, int64_t j1) -> bool {
    for (int64_t j = j0; j < j1; ++j) {
      const int64_t size = extents[2 * j + 1];
      const size_t w = zstd->compress_cctx(
          ctx, out + pre[(size_t)j], (size_t)zstd->bound((size_t)size),
          data + extents[2 * j], (size_t)size, (int)level);
      if (zstd->iserr(w)) return false;
      comp_extents[2 * j + 1] = (int64_t)w;
    }
    return true;
  };
  if (n_threads <= 1 || m == 1) {
    // Serial arm: frames go straight to the running cursor — already
    // compacted (no memmove pass, and only the compressed prefix of out
    // is ever touched, not the full sum-of-bounds span). The CCtx is
    // pinned thread_local across calls: a pipeline compress worker
    // draining batch after batch pays context alloc + workspace faults
    // once, matching the per-chunk lane's pinned-ctx discipline.
    // dstCapacity never changes the emitted bytes (only success/failure),
    // so this stays byte-identical to the bound-spaced parallel arm.
    static thread_local ZstdCtx zc(zstd);
    if (zc.ctx == nullptr) return -1;
    int64_t coff = 0;
    for (int64_t j = 0; j < m; ++j) {
      const int64_t size = extents[2 * j + 1];
      const size_t w = zstd->compress_cctx(
          zc.ctx, out + coff, (size_t)(out_cap - coff), data + extents[2 * j],
          (size_t)size, (int)level);
      if (zstd->iserr(w)) return -1;
      comp_extents[2 * j] = coff;
      comp_extents[2 * j + 1] = (int64_t)w;
      coff += (int64_t)w;
    }
    if (digests_out != nullptr) {
      if (algo == 1)
        ntpu_b3::blake3_extents(data, extents, m, digests_out);
      else
        ntpu_sha::sha256_extents(data, extents, m, digests_out);
    }
    return coff;
  }
  {
    std::atomic<int64_t> next{0};
    std::atomic<bool> failed{false};
    auto worker = [&]() {
      constexpr int64_t GRAB = 8;  // chunks per work grab
      ZstdCtx zc(zstd);
      if (zc.ctx == nullptr) {
        failed.store(true, std::memory_order_relaxed);
        return;
      }
      for (;;) {
        const int64_t j = next.fetch_add(GRAB);
        if (j >= m || failed.load(std::memory_order_relaxed)) return;
        const int64_t jend = j + GRAB < m ? j + GRAB : m;
        if (!encode_some(zc.ctx, j, jend)) {
          failed.store(true, std::memory_order_relaxed);
          return;
        }
      }
    };
    std::vector<std::thread> pool;
    const int64_t nt = n_threads < m ? n_threads : m;
    for (int64_t t = 1; t < nt; ++t) pool.emplace_back(worker);
    worker();
    for (auto &th : pool) th.join();
    if (failed.load()) return -1;
  }
  int64_t coff = 0;
  for (int64_t j = 0; j < m; ++j) {
    const int64_t csize = comp_extents[2 * j + 1];
    if (coff != pre[(size_t)j])
      std::memmove(out + coff, out + pre[(size_t)j], (size_t)csize);
    comp_extents[2 * j] = coff;
    coff += csize;
  }
  if (digests_out != nullptr) {
    if (algo == 1)
      ntpu_b3::blake3_extents(data, extents, m, digests_out);
    else
      ntpu_sha::sha256_extents(data, extents, m, digests_out);
  }
  return coff;
}

// Whole-layer fused pack: chunk + digest + first-wins dedup + compress +
// blob assembly + blob SHA-256 in ONE native pass over the planned file
// extents (no chunk-dict arm — dictionary packs keep the Python dedup
// lane). This is the full in-process equivalent of the reference's
// `nydus-image create` hot loop (pkg/converter/tool/builder.go:148-178).
//
// Inputs: data/n = the tar buffer; extents = m (off, size) pairs in tar
// order; CDC params; compressor (0 raw, 1 lz4, 2 zstd) + codec param
// (lz4 acceleration / zstd level) + n_threads for
// the assembly phase.
// Outputs: per-file chunk counts; per-chunk-ref digest32 / size /
// unique-index (first occurrence wins, indices dense in first-seen
// order); per-unique (coff, csize) extents; the assembled blob and its
// SHA-256. n_uniq_out / blob_size_out receive the table sizes.
// Returns total chunk refs; -1 overflow/OOM; -2 system codec absent.
int64_t ntpu_pack_files(const uint8_t *data, int64_t n,
                        const int64_t *extents, int64_t m,
                        uint32_t mask_small, uint32_t mask_large,
                        int64_t min_size, int64_t normal_size,
                        int64_t max_size, int64_t compressor, int64_t accel,
                        int64_t n_threads, int64_t *file_nchunks,
                        uint8_t *digests_out, int64_t *chunk_sizes,
                        int64_t *chunk_uniq, int64_t refs_cap,
                        int64_t *comp_extents, uint8_t *out_blob,
                        int64_t out_cap, uint8_t *blob_digest32,
                        int64_t *n_uniq_out, int64_t *blob_size_out,
                        int64_t algo) {
  (void)n;
  // Phase 1: fused chunk+digest per file (same kernel as the multi call).
  int64_t total = 0;
  std::vector<int64_t> cuts((size_t)refs_cap);
  for (int64_t i = 0; i < m; ++i) {
    const int64_t off = extents[2 * i];
    const int64_t size = extents[2 * i + 1];
    const int64_t c = ntpu_chunk_digest(
        data + off, size, mask_small, mask_large, min_size, normal_size,
        max_size, cuts.data() + total, refs_cap - total,
        digests_out + 32 * total, algo);
    if (c < 0) return -1;
    file_nchunks[i] = c;
    total += c;
  }

  // Phase 2: sequential first-wins dedup over the refs in tar order.
  // Open addressing keyed on the digest's first 8 bytes, full 32-byte
  // confirm; values are dense unique indices in first-seen order.
  int64_t tab_cap = 64;
  while (tab_cap < 2 * total) tab_cap <<= 1;
  std::vector<int64_t> slots((size_t)tab_cap, -1);
  std::vector<int64_t> uniq_off((size_t)(total > 0 ? total : 1));
  std::vector<int64_t> uniq_size((size_t)(total > 0 ? total : 1));
  std::vector<int64_t> uniq_first_ref((size_t)(total > 0 ? total : 1));
  int64_t n_uniq = 0;
  {
    int64_t ref = 0;
    for (int64_t i = 0; i < m; ++i) {
      const int64_t base = extents[2 * i];
      int64_t s = 0;
      for (int64_t k = 0; k < file_nchunks[i]; ++k, ++ref) {
        const int64_t end = cuts[(size_t)ref];
        const int64_t sz = end - s;
        chunk_sizes[ref] = sz;
        const uint8_t *dig = digests_out + 32 * ref;
        uint64_t h;
        std::memcpy(&h, dig, 8);
        int64_t slot = (int64_t)(h & (uint64_t)(tab_cap - 1));
        int64_t idx = -1;
        for (;;) {
          const int64_t v = slots[(size_t)slot];
          if (v < 0) {
            slots[(size_t)slot] = n_uniq;
            uniq_off[(size_t)n_uniq] = base + s;
            uniq_size[(size_t)n_uniq] = sz;
            uniq_first_ref[(size_t)n_uniq] = ref;
            idx = n_uniq++;
            break;
          }
          if (std::memcmp(
                  digests_out + 32 * uniq_first_ref[(size_t)v], dig, 32) == 0) {
            idx = v;
            break;
          }
          slot = (slot + 1) & (tab_cap - 1);
        }
        chunk_uniq[ref] = idx;
        s = end;
      }
    }
  }

  // Phase 3: compress + assemble the unique chunks (the pack_section
  // core), then hash the section.
  std::vector<int64_t> triples((size_t)n_uniq * 3);
  for (int64_t u = 0; u < n_uniq; ++u) {
    triples[(size_t)(3 * u)] = 0;
    triples[(size_t)(3 * u + 1)] = uniq_off[(size_t)u];
    triples[(size_t)(3 * u + 2)] = uniq_size[(size_t)u];
  }
  const int64_t blob = ntpu_pack_section(
      data, nullptr, triples.data(), n_uniq, compressor, accel, n_threads,
      out_blob, out_cap, comp_extents, blob_digest32);
  if (blob < 0) return blob;
  *n_uniq_out = n_uniq;
  *blob_size_out = blob;
  return total;
}

}  // extern "C"
