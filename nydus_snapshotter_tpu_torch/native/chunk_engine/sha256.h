// SHA-256 (FIPS 180-4) for the native chunk engine: scalar compression
// plus an x86 SHA-NI fast path, runtime-dispatched. Written for the fused
// chunk+digest sweep (chunk_engine.cpp ntpu_chunk_digest): per-chunk
// digests computed while the chunk bytes are cache-hot, no Python
// round-trip per chunk. Differential-tested byte-exact against hashlib
// over random lengths (tests/test_native_engine.py).
#pragma once

#include <cstdint>
#include <cstring>

// The SHA-NI arm dispatches at runtime via __builtin_cpu_supports("sha"),
// a feature name GCC only learned in 11 (clang has it throughout). On
// older GCC the whole SHA-NI arm gates off at compile time and the scalar
// compress below carries the load — same bytes, no runtime dispatch.
#if (defined(__x86_64__) || defined(_M_X64)) && \
    (defined(__clang__) || !defined(__GNUC__) || __GNUC__ >= 11)
#include <immintrin.h>
#define NTPU_X86 1
#endif

namespace ntpu_sha {

static const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

static inline uint32_t rotr(uint32_t x, int s) {
  return (x >> s) | (x << (32 - s));
}

// Scalar one-block compression (the portable arm).
inline void compress_scalar(uint32_t state[8], const uint8_t *block,
                            size_t nblocks) {
  while (nblocks--) {
    uint32_t w[64];
    for (int i = 0; i < 16; ++i) {
      w[i] = (uint32_t)block[4 * i] << 24 | (uint32_t)block[4 * i + 1] << 16 |
             (uint32_t)block[4 * i + 2] << 8 | (uint32_t)block[4 * i + 3];
    }
    for (int i = 16; i < 64; ++i) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
    uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
    for (int i = 0; i < 64; ++i) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = h + S1 + ch + K[i] + w[i];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + maj;
      h = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    state[0] += a; state[1] += b; state[2] += c; state[3] += d;
    state[4] += e; state[5] += f; state[6] += g; state[7] += h;
    block += 64;
  }
}

#ifdef NTPU_X86
// SHA-NI: states held in the ABEF/CDGH packing the sha256rnds2
// instruction expects; 4 message words per vector, schedule advanced with
// sha256msg1/msg2 + alignr.

// state (a..h) -> (ABEF, CDGH)
__attribute__((target("sha,sse4.1,ssse3")))
inline void shani_pack(const uint32_t state[8], __m128i &st0, __m128i &st1) {
  __m128i tmp = _mm_loadu_si128((const __m128i *)&state[0]);   // d c b a
  st1 = _mm_loadu_si128((const __m128i *)&state[4]);           // h g f e
  tmp = _mm_shuffle_epi32(tmp, 0xB1);                          // c d a b
  st1 = _mm_shuffle_epi32(st1, 0x1B);                          // e f g h
  st0 = _mm_alignr_epi8(tmp, st1, 8);                          // a b e f
  st1 = _mm_blend_epi16(st1, tmp, 0xF0);                       // c d g h
}

__attribute__((target("sha,sse4.1,ssse3")))
inline void shani_unpack(__m128i st0, __m128i st1, uint32_t state[8]) {
  __m128i tmp = _mm_shuffle_epi32(st0, 0x1B);                  // f e b a
  st1 = _mm_shuffle_epi32(st1, 0xB1);                          // d c h g
  st0 = _mm_blend_epi16(tmp, st1, 0xF0);                       // d c b a
  st1 = _mm_alignr_epi8(st1, tmp, 8);                          // h g f e
  _mm_storeu_si128((__m128i *)&state[0], st0);
  _mm_storeu_si128((__m128i *)&state[4], st1);
}

// One 64-byte block through the 64 rounds.
__attribute__((target("sha,sse4.1,ssse3")))
inline void shani_block(__m128i &st0, __m128i &st1, const uint8_t *block) {
  const __m128i BSWAP =
      _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
  {
    const __m128i abef_save = st0;
    const __m128i cdgh_save = st1;
    __m128i msg, msg0, msg1, msg2, msg3;

    // Rounds 0-3
    msg0 = _mm_shuffle_epi8(
        _mm_loadu_si128((const __m128i *)(block + 0)), BSWAP);
    msg = _mm_add_epi32(msg0, _mm_loadu_si128((const __m128i *)&K[0]));
    st1 = _mm_sha256rnds2_epu32(st1, st0, msg);
    msg = _mm_shuffle_epi32(msg, 0x0E);
    st0 = _mm_sha256rnds2_epu32(st0, st1, msg);

    // Rounds 4-7
    msg1 = _mm_shuffle_epi8(
        _mm_loadu_si128((const __m128i *)(block + 16)), BSWAP);
    msg = _mm_add_epi32(msg1, _mm_loadu_si128((const __m128i *)&K[4]));
    st1 = _mm_sha256rnds2_epu32(st1, st0, msg);
    msg = _mm_shuffle_epi32(msg, 0x0E);
    st0 = _mm_sha256rnds2_epu32(st0, st1, msg);
    msg0 = _mm_sha256msg1_epu32(msg0, msg1);

    // Rounds 8-11
    msg2 = _mm_shuffle_epi8(
        _mm_loadu_si128((const __m128i *)(block + 32)), BSWAP);
    msg = _mm_add_epi32(msg2, _mm_loadu_si128((const __m128i *)&K[8]));
    st1 = _mm_sha256rnds2_epu32(st1, st0, msg);
    msg = _mm_shuffle_epi32(msg, 0x0E);
    st0 = _mm_sha256rnds2_epu32(st0, st1, msg);
    msg1 = _mm_sha256msg1_epu32(msg1, msg2);

    // Rounds 12-15
    msg3 = _mm_shuffle_epi8(
        _mm_loadu_si128((const __m128i *)(block + 48)), BSWAP);
    msg = _mm_add_epi32(msg3, _mm_loadu_si128((const __m128i *)&K[12]));
    st1 = _mm_sha256rnds2_epu32(st1, st0, msg);
    msg0 = _mm_add_epi32(msg0, _mm_alignr_epi8(msg3, msg2, 4));
    msg0 = _mm_sha256msg2_epu32(msg0, msg3);
    msg = _mm_shuffle_epi32(msg, 0x0E);
    st0 = _mm_sha256rnds2_epu32(st0, st1, msg);
    msg2 = _mm_sha256msg1_epu32(msg2, msg3);

    // Rounds 16-47: two full turns of the 4-group schedule wheel
    for (int r = 16; r < 48; r += 16) {
      msg = _mm_add_epi32(msg0, _mm_loadu_si128((const __m128i *)&K[r]));
      st1 = _mm_sha256rnds2_epu32(st1, st0, msg);
      msg1 = _mm_add_epi32(msg1, _mm_alignr_epi8(msg0, msg3, 4));
      msg1 = _mm_sha256msg2_epu32(msg1, msg0);
      msg = _mm_shuffle_epi32(msg, 0x0E);
      st0 = _mm_sha256rnds2_epu32(st0, st1, msg);
      msg3 = _mm_sha256msg1_epu32(msg3, msg0);

      msg = _mm_add_epi32(msg1, _mm_loadu_si128((const __m128i *)&K[r + 4]));
      st1 = _mm_sha256rnds2_epu32(st1, st0, msg);
      msg2 = _mm_add_epi32(msg2, _mm_alignr_epi8(msg1, msg0, 4));
      msg2 = _mm_sha256msg2_epu32(msg2, msg1);
      msg = _mm_shuffle_epi32(msg, 0x0E);
      st0 = _mm_sha256rnds2_epu32(st0, st1, msg);
      msg0 = _mm_sha256msg1_epu32(msg0, msg1);

      msg = _mm_add_epi32(msg2, _mm_loadu_si128((const __m128i *)&K[r + 8]));
      st1 = _mm_sha256rnds2_epu32(st1, st0, msg);
      msg3 = _mm_add_epi32(msg3, _mm_alignr_epi8(msg2, msg1, 4));
      msg3 = _mm_sha256msg2_epu32(msg3, msg2);
      msg = _mm_shuffle_epi32(msg, 0x0E);
      st0 = _mm_sha256rnds2_epu32(st0, st1, msg);
      msg1 = _mm_sha256msg1_epu32(msg1, msg2);

      msg = _mm_add_epi32(msg3, _mm_loadu_si128((const __m128i *)&K[r + 12]));
      st1 = _mm_sha256rnds2_epu32(st1, st0, msg);
      msg0 = _mm_add_epi32(msg0, _mm_alignr_epi8(msg3, msg2, 4));
      msg0 = _mm_sha256msg2_epu32(msg0, msg3);
      msg = _mm_shuffle_epi32(msg, 0x0E);
      st0 = _mm_sha256rnds2_epu32(st0, st1, msg);
      msg2 = _mm_sha256msg1_epu32(msg2, msg3);
    }

    // Rounds 48-51 (msg3 still needs its msg1 step: w[60..63] depends on it)
    msg = _mm_add_epi32(msg0, _mm_loadu_si128((const __m128i *)&K[48]));
    st1 = _mm_sha256rnds2_epu32(st1, st0, msg);
    msg1 = _mm_add_epi32(msg1, _mm_alignr_epi8(msg0, msg3, 4));
    msg1 = _mm_sha256msg2_epu32(msg1, msg0);
    msg = _mm_shuffle_epi32(msg, 0x0E);
    st0 = _mm_sha256rnds2_epu32(st0, st1, msg);
    msg3 = _mm_sha256msg1_epu32(msg3, msg0);

    // Rounds 52-55
    msg = _mm_add_epi32(msg1, _mm_loadu_si128((const __m128i *)&K[52]));
    st1 = _mm_sha256rnds2_epu32(st1, st0, msg);
    msg2 = _mm_add_epi32(msg2, _mm_alignr_epi8(msg1, msg0, 4));
    msg2 = _mm_sha256msg2_epu32(msg2, msg1);
    msg = _mm_shuffle_epi32(msg, 0x0E);
    st0 = _mm_sha256rnds2_epu32(st0, st1, msg);

    // Rounds 56-59
    msg = _mm_add_epi32(msg2, _mm_loadu_si128((const __m128i *)&K[56]));
    st1 = _mm_sha256rnds2_epu32(st1, st0, msg);
    msg3 = _mm_add_epi32(msg3, _mm_alignr_epi8(msg2, msg1, 4));
    msg3 = _mm_sha256msg2_epu32(msg3, msg2);
    msg = _mm_shuffle_epi32(msg, 0x0E);
    st0 = _mm_sha256rnds2_epu32(st0, st1, msg);

    // Rounds 60-63
    msg = _mm_add_epi32(msg3, _mm_loadu_si128((const __m128i *)&K[60]));
    st1 = _mm_sha256rnds2_epu32(st1, st0, msg);
    msg = _mm_shuffle_epi32(msg, 0x0E);
    st0 = _mm_sha256rnds2_epu32(st0, st1, msg);

    st0 = _mm_add_epi32(st0, abef_save);
    st1 = _mm_add_epi32(st1, cdgh_save);
  }
}

__attribute__((target("sha,sse4.1,ssse3")))
inline void compress_shani(uint32_t state[8], const uint8_t *block,
                           size_t nblocks) {
  __m128i st0, st1;
  shani_pack(state, st0, st1);
  while (nblocks--) {
    shani_block(st0, st1, block);
    block += 64;
  }
  shani_unpack(st0, st1, state);
}

// Two independent block streams advanced in lockstep, instruction-
// interleaved at 4-round granularity. Each stream's rounds form a serial
// sha256rnds2 dependency chain (~6-cycle latency, 2-cycle throughput);
// alternating the two chains' round groups in the instruction stream
// keeps both inside the scheduler window so the core overlaps them —
// measured ~1.9x single-thread digest throughput over sequential blocks.
// Used for pairs of chunks, which are independent messages.
//
// The macros are the proven single-stream round groups from shani_block
// with every register name suffixed; S is the chain tag (A/B).

#define NTPU_SHA_LOAD(S, block, off, mreg)                                   \
  mreg##S = _mm_shuffle_epi8(                                                \
      _mm_loadu_si128((const __m128i *)((block) + (off))), BSWAP);

#define NTPU_SHA_RNDS(S, kidx, mreg)                                         \
  msg##S = _mm_add_epi32(mreg##S,                                            \
                         _mm_loadu_si128((const __m128i *)&K[kidx]));        \
  st1##S = _mm_sha256rnds2_epu32(st1##S, st0##S, msg##S);                    \
  msg##S = _mm_shuffle_epi32(msg##S, 0x0E);                                  \
  st0##S = _mm_sha256rnds2_epu32(st0##S, st1##S, msg##S);

#define NTPU_SHA_SCHED(S, mnext, mcur, mprev2, mprev)                        \
  mnext##S = _mm_add_epi32(mnext##S,                                         \
                           _mm_alignr_epi8(mcur##S, mprev2##S, 4));          \
  mnext##S = _mm_sha256msg2_epu32(mnext##S, mcur##S);                        \
  mprev##S = _mm_sha256msg1_epu32(mprev##S, mcur##S);

__attribute__((target("sha,sse4.1,ssse3")))
inline void compress_shani_x2(uint32_t sa[8], const uint8_t *ba,
                              uint32_t sb[8], const uint8_t *bb,
                              size_t nblocks) {
  const __m128i BSWAP =
      _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
  __m128i st0A, st1A, st0B, st1B;
  shani_pack(sa, st0A, st1A);
  shani_pack(sb, st0B, st1B);
  while (nblocks--) {
    const __m128i saveA0 = st0A, saveA1 = st1A;
    const __m128i saveB0 = st0B, saveB1 = st1B;
    __m128i msgA, msg0A, msg1A, msg2A, msg3A;
    __m128i msgB, msg0B, msg1B, msg2B, msg3B;

    // Rounds 0-3
    NTPU_SHA_LOAD(A, ba, 0, msg0) NTPU_SHA_LOAD(B, bb, 0, msg0)
    NTPU_SHA_RNDS(A, 0, msg0) NTPU_SHA_RNDS(B, 0, msg0)
    // Rounds 4-7
    NTPU_SHA_LOAD(A, ba, 16, msg1) NTPU_SHA_LOAD(B, bb, 16, msg1)
    NTPU_SHA_RNDS(A, 4, msg1) NTPU_SHA_RNDS(B, 4, msg1)
    msg0A = _mm_sha256msg1_epu32(msg0A, msg1A);
    msg0B = _mm_sha256msg1_epu32(msg0B, msg1B);
    // Rounds 8-11
    NTPU_SHA_LOAD(A, ba, 32, msg2) NTPU_SHA_LOAD(B, bb, 32, msg2)
    NTPU_SHA_RNDS(A, 8, msg2) NTPU_SHA_RNDS(B, 8, msg2)
    msg1A = _mm_sha256msg1_epu32(msg1A, msg2A);
    msg1B = _mm_sha256msg1_epu32(msg1B, msg2B);
    // Rounds 12-15
    NTPU_SHA_LOAD(A, ba, 48, msg3) NTPU_SHA_LOAD(B, bb, 48, msg3)
    NTPU_SHA_RNDS(A, 12, msg3) NTPU_SHA_RNDS(B, 12, msg3)
    NTPU_SHA_SCHED(A, msg0, msg3, msg2, msg2)
    NTPU_SHA_SCHED(B, msg0, msg3, msg2, msg2)
    // Rounds 16-47: two full turns of the 4-group schedule wheel
    for (int r = 16; r < 48; r += 16) {
      NTPU_SHA_RNDS(A, r, msg0) NTPU_SHA_RNDS(B, r, msg0)
      NTPU_SHA_SCHED(A, msg1, msg0, msg3, msg3)
      NTPU_SHA_SCHED(B, msg1, msg0, msg3, msg3)
      NTPU_SHA_RNDS(A, r + 4, msg1) NTPU_SHA_RNDS(B, r + 4, msg1)
      NTPU_SHA_SCHED(A, msg2, msg1, msg0, msg0)
      NTPU_SHA_SCHED(B, msg2, msg1, msg0, msg0)
      NTPU_SHA_RNDS(A, r + 8, msg2) NTPU_SHA_RNDS(B, r + 8, msg2)
      NTPU_SHA_SCHED(A, msg3, msg2, msg1, msg1)
      NTPU_SHA_SCHED(B, msg3, msg2, msg1, msg1)
      NTPU_SHA_RNDS(A, r + 12, msg3) NTPU_SHA_RNDS(B, r + 12, msg3)
      NTPU_SHA_SCHED(A, msg0, msg3, msg2, msg2)
      NTPU_SHA_SCHED(B, msg0, msg3, msg2, msg2)
    }
    // Rounds 48-51 (msg3's msg1 step still needed for w[60..63])
    NTPU_SHA_RNDS(A, 48, msg0) NTPU_SHA_RNDS(B, 48, msg0)
    NTPU_SHA_SCHED(A, msg1, msg0, msg3, msg3)
    NTPU_SHA_SCHED(B, msg1, msg0, msg3, msg3)
    // Rounds 52-55
    NTPU_SHA_RNDS(A, 52, msg1) NTPU_SHA_RNDS(B, 52, msg1)
    msg2A = _mm_add_epi32(msg2A, _mm_alignr_epi8(msg1A, msg0A, 4));
    msg2A = _mm_sha256msg2_epu32(msg2A, msg1A);
    msg2B = _mm_add_epi32(msg2B, _mm_alignr_epi8(msg1B, msg0B, 4));
    msg2B = _mm_sha256msg2_epu32(msg2B, msg1B);
    // Rounds 56-59
    NTPU_SHA_RNDS(A, 56, msg2) NTPU_SHA_RNDS(B, 56, msg2)
    msg3A = _mm_add_epi32(msg3A, _mm_alignr_epi8(msg2A, msg1A, 4));
    msg3A = _mm_sha256msg2_epu32(msg3A, msg2A);
    msg3B = _mm_add_epi32(msg3B, _mm_alignr_epi8(msg2B, msg1B, 4));
    msg3B = _mm_sha256msg2_epu32(msg3B, msg2B);
    // Rounds 60-63
    NTPU_SHA_RNDS(A, 60, msg3) NTPU_SHA_RNDS(B, 60, msg3)

    st0A = _mm_add_epi32(st0A, saveA0);
    st1A = _mm_add_epi32(st1A, saveA1);
    st0B = _mm_add_epi32(st0B, saveB0);
    st1B = _mm_add_epi32(st1B, saveB1);
    ba += 64;
    bb += 64;
  }
  shani_unpack(st0A, st1A, sa);
  shani_unpack(st0B, st1B, sb);
}

// Three chains. sha256rnds2's ~6-cycle latency against ~2-cycle
// throughput leaves room beyond x2 (measured: x2 ~1.56x one chain); the
// third chain costs register spills (3 chains x 7 live xmm exceeds the
// 16 legacy registers SHA-NI encodings can address) but the spilled
// schedule vectors sit off the critical sha256rnds2 path.
__attribute__((target("sha,sse4.1,ssse3")))
inline void compress_shani_x3(uint32_t sa[8], const uint8_t *ba,
                              uint32_t sb[8], const uint8_t *bb,
                              uint32_t sc[8], const uint8_t *bc,
                              size_t nblocks) {
  const __m128i BSWAP =
      _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
  __m128i st0A, st1A, st0B, st1B, st0C, st1C;
  shani_pack(sa, st0A, st1A);
  shani_pack(sb, st0B, st1B);
  shani_pack(sc, st0C, st1C);
  while (nblocks--) {
    const __m128i saveA0 = st0A, saveA1 = st1A;
    const __m128i saveB0 = st0B, saveB1 = st1B;
    const __m128i saveC0 = st0C, saveC1 = st1C;
    __m128i msgA, msg0A, msg1A, msg2A, msg3A;
    __m128i msgB, msg0B, msg1B, msg2B, msg3B;
    __m128i msgC, msg0C, msg1C, msg2C, msg3C;

    NTPU_SHA_LOAD(A, ba, 0, msg0)
    NTPU_SHA_LOAD(B, bb, 0, msg0)
    NTPU_SHA_LOAD(C, bc, 0, msg0)
    NTPU_SHA_RNDS(A, 0, msg0) NTPU_SHA_RNDS(B, 0, msg0)
    NTPU_SHA_RNDS(C, 0, msg0)
    NTPU_SHA_LOAD(A, ba, 16, msg1)
    NTPU_SHA_LOAD(B, bb, 16, msg1)
    NTPU_SHA_LOAD(C, bc, 16, msg1)
    NTPU_SHA_RNDS(A, 4, msg1) NTPU_SHA_RNDS(B, 4, msg1)
    NTPU_SHA_RNDS(C, 4, msg1)
    msg0A = _mm_sha256msg1_epu32(msg0A, msg1A);
    msg0B = _mm_sha256msg1_epu32(msg0B, msg1B);
    msg0C = _mm_sha256msg1_epu32(msg0C, msg1C);
    NTPU_SHA_LOAD(A, ba, 32, msg2)
    NTPU_SHA_LOAD(B, bb, 32, msg2)
    NTPU_SHA_LOAD(C, bc, 32, msg2)
    NTPU_SHA_RNDS(A, 8, msg2) NTPU_SHA_RNDS(B, 8, msg2)
    NTPU_SHA_RNDS(C, 8, msg2)
    msg1A = _mm_sha256msg1_epu32(msg1A, msg2A);
    msg1B = _mm_sha256msg1_epu32(msg1B, msg2B);
    msg1C = _mm_sha256msg1_epu32(msg1C, msg2C);
    NTPU_SHA_LOAD(A, ba, 48, msg3)
    NTPU_SHA_LOAD(B, bb, 48, msg3)
    NTPU_SHA_LOAD(C, bc, 48, msg3)
    NTPU_SHA_RNDS(A, 12, msg3) NTPU_SHA_RNDS(B, 12, msg3)
    NTPU_SHA_RNDS(C, 12, msg3)
    NTPU_SHA_SCHED(A, msg0, msg3, msg2, msg2)
    NTPU_SHA_SCHED(B, msg0, msg3, msg2, msg2)
    NTPU_SHA_SCHED(C, msg0, msg3, msg2, msg2)
    for (int r = 16; r < 48; r += 16) {
      NTPU_SHA_RNDS(A, r, msg0) NTPU_SHA_RNDS(B, r, msg0)
      NTPU_SHA_RNDS(C, r, msg0)
      NTPU_SHA_SCHED(A, msg1, msg0, msg3, msg3)
      NTPU_SHA_SCHED(B, msg1, msg0, msg3, msg3)
      NTPU_SHA_SCHED(C, msg1, msg0, msg3, msg3)
      NTPU_SHA_RNDS(A, r + 4, msg1) NTPU_SHA_RNDS(B, r + 4, msg1)
      NTPU_SHA_RNDS(C, r + 4, msg1)
      NTPU_SHA_SCHED(A, msg2, msg1, msg0, msg0)
      NTPU_SHA_SCHED(B, msg2, msg1, msg0, msg0)
      NTPU_SHA_SCHED(C, msg2, msg1, msg0, msg0)
      NTPU_SHA_RNDS(A, r + 8, msg2) NTPU_SHA_RNDS(B, r + 8, msg2)
      NTPU_SHA_RNDS(C, r + 8, msg2)
      NTPU_SHA_SCHED(A, msg3, msg2, msg1, msg1)
      NTPU_SHA_SCHED(B, msg3, msg2, msg1, msg1)
      NTPU_SHA_SCHED(C, msg3, msg2, msg1, msg1)
      NTPU_SHA_RNDS(A, r + 12, msg3) NTPU_SHA_RNDS(B, r + 12, msg3)
      NTPU_SHA_RNDS(C, r + 12, msg3)
      NTPU_SHA_SCHED(A, msg0, msg3, msg2, msg2)
      NTPU_SHA_SCHED(B, msg0, msg3, msg2, msg2)
      NTPU_SHA_SCHED(C, msg0, msg3, msg2, msg2)
    }
    NTPU_SHA_RNDS(A, 48, msg0) NTPU_SHA_RNDS(B, 48, msg0)
    NTPU_SHA_RNDS(C, 48, msg0)
    NTPU_SHA_SCHED(A, msg1, msg0, msg3, msg3)
    NTPU_SHA_SCHED(B, msg1, msg0, msg3, msg3)
    NTPU_SHA_SCHED(C, msg1, msg0, msg3, msg3)
    NTPU_SHA_RNDS(A, 52, msg1) NTPU_SHA_RNDS(B, 52, msg1)
    NTPU_SHA_RNDS(C, 52, msg1)
    msg2A = _mm_add_epi32(msg2A, _mm_alignr_epi8(msg1A, msg0A, 4));
    msg2A = _mm_sha256msg2_epu32(msg2A, msg1A);
    msg2B = _mm_add_epi32(msg2B, _mm_alignr_epi8(msg1B, msg0B, 4));
    msg2B = _mm_sha256msg2_epu32(msg2B, msg1B);
    msg2C = _mm_add_epi32(msg2C, _mm_alignr_epi8(msg1C, msg0C, 4));
    msg2C = _mm_sha256msg2_epu32(msg2C, msg1C);
    NTPU_SHA_RNDS(A, 56, msg2) NTPU_SHA_RNDS(B, 56, msg2)
    NTPU_SHA_RNDS(C, 56, msg2)
    msg3A = _mm_add_epi32(msg3A, _mm_alignr_epi8(msg2A, msg1A, 4));
    msg3A = _mm_sha256msg2_epu32(msg3A, msg2A);
    msg3B = _mm_add_epi32(msg3B, _mm_alignr_epi8(msg2B, msg1B, 4));
    msg3B = _mm_sha256msg2_epu32(msg3B, msg2B);
    msg3C = _mm_add_epi32(msg3C, _mm_alignr_epi8(msg2C, msg1C, 4));
    msg3C = _mm_sha256msg2_epu32(msg3C, msg2C);
    NTPU_SHA_RNDS(A, 60, msg3) NTPU_SHA_RNDS(B, 60, msg3)
    NTPU_SHA_RNDS(C, 60, msg3)

    st0A = _mm_add_epi32(st0A, saveA0);
    st1A = _mm_add_epi32(st1A, saveA1);
    st0B = _mm_add_epi32(st0B, saveB0);
    st1B = _mm_add_epi32(st1B, saveB1);
    st0C = _mm_add_epi32(st0C, saveC0);
    st1C = _mm_add_epi32(st1C, saveC1);
    ba += 64;
    bb += 64;
    bc += 64;
  }
  shani_unpack(st0A, st1A, sa);
  shani_unpack(st0B, st1B, sb);
  shani_unpack(st0C, st1C, sc);
}

#undef NTPU_SHA_LOAD
#undef NTPU_SHA_RNDS
#undef NTPU_SHA_SCHED
#endif  // NTPU_X86

inline bool have_shani() {
#ifdef NTPU_X86
  static const bool ok = __builtin_cpu_supports("sha") &&
                         __builtin_cpu_supports("sse4.1") &&
                         __builtin_cpu_supports("ssse3");
  return ok;
#else
  return false;
#endif
}

inline void compress(uint32_t state[8], const uint8_t *block, size_t nblocks) {
#ifdef NTPU_X86
  if (have_shani()) {
    compress_shani(state, block, nblocks);
    return;
  }
#endif
  compress_scalar(state, block, nblocks);
}

constexpr uint32_t INIT[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                              0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};

// Final block(s) — remainder + 0x80 pad + 64-bit big-endian bit length —
// then big-endian digest emit. `state` has absorbed the n/64 full blocks.
inline void finish(uint32_t state[8], const uint8_t *data, uint64_t n,
                   uint8_t out[32]) {
  uint8_t tail[128];
  const uint64_t rem = n % 64;
  std::memcpy(tail, data + (n - rem), rem);
  std::memset(tail + rem, 0, sizeof(tail) - rem);
  tail[rem] = 0x80;
  const uint64_t tail_blocks = (rem + 9 <= 64) ? 1 : 2;
  const uint64_t bits = n * 8;
  for (int i = 0; i < 8; ++i) {
    tail[tail_blocks * 64 - 1 - i] = (uint8_t)(bits >> (8 * i));
  }
  compress(state, tail, tail_blocks);
  for (int i = 0; i < 8; ++i) {
    out[4 * i] = (uint8_t)(state[i] >> 24);
    out[4 * i + 1] = (uint8_t)(state[i] >> 16);
    out[4 * i + 2] = (uint8_t)(state[i] >> 8);
    out[4 * i + 3] = (uint8_t)state[i];
  }
}

// One-shot digest of data[0..n) into out[32].
inline void sha256(const uint8_t *data, uint64_t n, uint8_t out[32]) {
  uint32_t state[8];
  std::memcpy(state, INIT, sizeof(state));
  compress(state, data, n / 64);
  finish(state, data, n, out);
}

// Digest two independent messages, overlapping their compression chains
// on SHA-NI hardware (chunks are independent, so digesting them pairwise
// hides the per-round dependency latency).
inline void sha256_pair(const uint8_t *da, uint64_t na, uint8_t outa[32],
                        const uint8_t *db, uint64_t nb, uint8_t outb[32]) {
#ifdef NTPU_X86
  if (have_shani()) {
    uint32_t sa[8], sb[8];
    std::memcpy(sa, INIT, sizeof(sa));
    std::memcpy(sb, INIT, sizeof(sb));
    const uint64_t fa = na / 64, fb = nb / 64;
    const uint64_t common = fa < fb ? fa : fb;
    compress_shani_x2(sa, da, sb, db, common);
    compress_shani(sa, da + common * 64, fa - common);
    compress_shani(sb, db + common * 64, fb - common);
    finish(sa, da, na, outa);
    finish(sb, db, nb, outb);
    return;
  }
#endif
  sha256(da, na, outa);
  sha256(db, nb, outb);
}

// ---- Batch multi-slot scheduler ----------------------------------------
//
// sha256_pair interleaves only min(blocks_a, blocks_b); with CDC chunk
// lengths (random in [min, max]) the longer chunk's tail always runs
// single-chain, costing ~25% of the interleave win across a batch. Here
// each slot reloads with the next message the moment its current one
// finishes, so three SHA-NI chains (compress_shani_x3; x2/x1 only to
// drain the final messages) stay busy until the whole extent list drains
// and the interleaved rate applies to essentially every digested byte.
//
// A message is two segments: the body (n/64 full blocks, read in place)
// and the tail (1-2 padded blocks built in a stack buffer). The scheduler
// advances all active slots by min(rem) blocks per round.

struct ShaSlot {
  uint32_t state[8];
  const uint8_t *p;      // current segment cursor
  uint64_t rem;          // 64-byte blocks left in the current segment
  uint8_t tail[128];
  uint64_t tail_blocks;
  bool in_tail;
  uint8_t *out;
};

inline void slot_load(ShaSlot &s, const uint8_t *msg, uint64_t n,
                      uint8_t *out) {
  std::memcpy(s.state, INIT, sizeof(INIT));
  s.out = out;
  const uint64_t rem_bytes = n % 64;
  std::memset(s.tail, 0, sizeof(s.tail));
  if (rem_bytes) std::memcpy(s.tail, msg + (n - rem_bytes), rem_bytes);
  s.tail[rem_bytes] = 0x80;
  s.tail_blocks = (rem_bytes + 9 <= 64) ? 1 : 2;
  const uint64_t bits = n * 8;
  for (int i = 0; i < 8; ++i) {
    s.tail[s.tail_blocks * 64 - 1 - i] = (uint8_t)(bits >> (8 * i));
  }
  const uint64_t full = n / 64;
  if (full) {
    s.p = msg;
    s.rem = full;
    s.in_tail = false;
  } else {
    s.p = s.tail;
    s.rem = s.tail_blocks;
    s.in_tail = true;
  }
}

inline void slot_emit(const ShaSlot &s) {
  for (int i = 0; i < 8; ++i) {
    s.out[4 * i] = (uint8_t)(s.state[i] >> 24);
    s.out[4 * i + 1] = (uint8_t)(s.state[i] >> 16);
    s.out[4 * i + 2] = (uint8_t)(s.state[i] >> 8);
    s.out[4 * i + 3] = (uint8_t)s.state[i];
  }
}

// Advance past an exhausted segment. True when the message completed
// (digest emitted) — the slot then needs a fresh message.
inline bool slot_step(ShaSlot &s) {
  if (!s.in_tail) {
    s.p = s.tail;
    s.rem = s.tail_blocks;
    s.in_tail = true;
    return false;
  }
  slot_emit(s);
  return true;
}

// Refill a drained slot with its next segment or next message. False when
// the extent list is exhausted and the slot's last message has emitted.
inline bool slot_refill(ShaSlot &s, const uint8_t *data,
                        const int64_t *extents, int64_t m, uint8_t *out,
                        int64_t &next) {
  while (s.rem == 0) {
    if (!slot_step(s)) continue;
    if (next >= m) return false;
    slot_load(s, data + extents[2 * next], (uint64_t)extents[2 * next + 1],
              out + 32 * next);
    ++next;
  }
  return true;
}

// Retire drained slots that could not refill (extent list exhausted),
// compacting the active-pointer array; returns the new active count.
inline int slots_retire(ShaSlot **act, int n_act, const uint8_t *data,
                        const int64_t *extents, int64_t m, uint8_t *out,
                        int64_t &next) {
  for (int i = 0; i < n_act;) {
    if (act[i]->rem == 0 &&
        !slot_refill(*act[i], data, extents, m, out, next)) {
      ShaSlot *t = act[i];
      act[i] = act[n_act - 1];
      act[n_act - 1] = t;
      --n_act;
    } else {
      ++i;
    }
  }
  return n_act;
}

#ifdef NTPU_X86
__attribute__((target("sha,sse4.1,ssse3")))
inline void sha256_extents_shani(const uint8_t *data, const int64_t *extents,
                                 int64_t m, uint8_t *out) {
  // Slots self-reference their tail buffers, so membership is tracked by
  // pointer swap, never by copying a ShaSlot.
  ShaSlot store[3];
  ShaSlot *act[3] = {&store[0], &store[1], &store[2]};
  int64_t next = 0;
  int n_act = 0;
  while (n_act < 3 && next < m) {
    slot_load(*act[n_act], data + extents[2 * next],
              (uint64_t)extents[2 * next + 1], out + 32 * next);
    ++n_act;
    ++next;
  }

  while (n_act == 3) {
    ShaSlot &a = *act[0], &b = *act[1], &c = *act[2];
    uint64_t k = a.rem < b.rem ? a.rem : b.rem;
    if (c.rem < k) k = c.rem;
    if (k) {
      compress_shani_x3(a.state, a.p, b.state, b.p, c.state, c.p, k);
      a.p += k * 64;
      a.rem -= k;
      b.p += k * 64;
      b.rem -= k;
      c.p += k * 64;
      c.rem -= k;
    }
    n_act = slots_retire(act, n_act, data, extents, m, out, next);
  }

  while (n_act == 2) {
    ShaSlot &a = *act[0], &b = *act[1];
    const uint64_t k = a.rem < b.rem ? a.rem : b.rem;
    if (k) {
      compress_shani_x2(a.state, a.p, b.state, b.p, k);
      a.p += k * 64;
      a.rem -= k;
      b.p += k * 64;
      b.rem -= k;
    }
    n_act = slots_retire(act, n_act, data, extents, m, out, next);
  }

  if (n_act == 1) {
    ShaSlot &r = *act[0];
    for (;;) {
      compress_shani(r.state, r.p, (size_t)r.rem);
      r.rem = 0;
      if (!slot_refill(r, data, extents, m, out, next)) break;
    }
  }
}
#endif  // NTPU_X86

// Digest m messages given as (offset, size) i64 pairs into data; 32 bytes
// of output per message. Keeps three SHA-NI chains saturated across the
// whole batch; falls back to sequential digesting without SHA-NI.
inline void sha256_extents(const uint8_t *data, const int64_t *extents,
                           int64_t m, uint8_t *out) {
#ifdef NTPU_X86
  if (have_shani() && m >= 2) {
    sha256_extents_shani(data, extents, m, out);
    return;
  }
#endif
  for (int64_t i = 0; i < m; ++i) {
    sha256(data + extents[2 * i], (uint64_t)extents[2 * i + 1], out + 32 * i);
  }
}

}  // namespace ntpu_sha
