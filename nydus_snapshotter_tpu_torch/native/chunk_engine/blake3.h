// BLAKE3 (unkeyed hash mode, 32-byte output) for chunk content digests.
//
// The reference toolchain's default chunk digester is blake3 (RafsSuperFlags
// HASH_BLAKE3; both committed fixtures under
// /root/reference/pkg/filesystem/testdata carry it), so packing layers whose
// chunks can dedup against REAL nydus images — ChunkDict.from_path on a real
// bootstrap, reference tool/builder.go:122-123 `--chunk-dict bootstrap=…` —
// needs blake3 digests at chunk-content scale, not just the metadata-sized
// inputs utils/blake3.py covers. This is an independent implementation of
// the public BLAKE3 spec (chunks of 1024 bytes, largest-power-of-two left
// subtrees, CHUNK_START/CHUNK_END/PARENT/ROOT domain flags); the pure-Python
// oracle in utils/blake3.py — itself validated against the committed real
// fixtures' digests — is the differential test anchor
// (tests/test_blake3_digester.py).
//
// Leaves are hashed 16-way on AVX-512 or 8-way on AVX2 (one u32 lane
// per leaf — the same decomposition the TPU device kernel uses,
// ops/blake3_jax.py), with a scalar compress for tails, small inputs,
// and plain hosts. Measured: AVX-512 ~2.7 GiB/s/core (1.7x the SHA-NI
// arm), AVX2 ~1.7 (parity) — blake3-digester packs are never slower
// than sha256 ones. NTPU_B3_FORCE_ISA=scalar|avx2|avx512 pins an arm
// for differential tests (same contract as the gear engine's
// NTPU_GEAR_FORCE_ISA); ntpu_b3_active_isa() reports the running arm.
#pragma once

#include <array>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#if (defined(__x86_64__) || defined(_M_X64)) && defined(__GNUC__)
// gcc/clang only: the 8-way kernel uses __attribute__((target)) and
// __builtin_cpu_supports
#include <immintrin.h>
#define NTPU_B3_X86 1
#endif

namespace ntpu_b3 {

static const uint32_t IV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};

enum Flags : uint32_t {
  CHUNK_START = 1u << 0,
  CHUNK_END = 1u << 1,
  PARENT = 1u << 2,
  ROOT = 1u << 3,
};

static const int PERM[16] = {2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8};

static inline uint32_t rotr32(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

static inline void g(uint32_t *s, int a, int b, int c, int d, uint32_t mx,
                     uint32_t my) {
  s[a] = s[a] + s[b] + mx;
  s[d] = rotr32(s[d] ^ s[a], 16);
  s[c] = s[c] + s[d];
  s[b] = rotr32(s[b] ^ s[c], 12);
  s[a] = s[a] + s[b] + my;
  s[d] = rotr32(s[d] ^ s[a], 8);
  s[c] = s[c] + s[d];
  s[b] = rotr32(s[b] ^ s[c], 7);
}

static inline void round_fn(uint32_t st[16], const uint32_t m[16]) {
  g(st, 0, 4, 8, 12, m[0], m[1]);
  g(st, 1, 5, 9, 13, m[2], m[3]);
  g(st, 2, 6, 10, 14, m[4], m[5]);
  g(st, 3, 7, 11, 15, m[6], m[7]);
  g(st, 0, 5, 10, 15, m[8], m[9]);
  g(st, 1, 6, 11, 12, m[10], m[11]);
  g(st, 2, 7, 8, 13, m[12], m[13]);
  g(st, 3, 4, 9, 14, m[14], m[15]);
}

// One compression; out8 receives the chaining value (v[0..8] ^ v[8..16]).
static inline void compress(const uint32_t cv[8], const uint32_t block[16],
                            uint64_t counter, uint32_t block_len,
                            uint32_t flags, uint32_t out8[8]) {
  uint32_t st[16];
  std::memcpy(st, cv, 32);
  st[8] = IV[0];
  st[9] = IV[1];
  st[10] = IV[2];
  st[11] = IV[3];
  st[12] = (uint32_t)counter;
  st[13] = (uint32_t)(counter >> 32);
  st[14] = block_len;
  st[15] = flags;
  uint32_t m[16];
  std::memcpy(m, block, 64);
  for (int r = 0;; r++) {
    round_fn(st, m);
    if (r == 6) break;
    uint32_t p[16];
    for (int i = 0; i < 16; i++) p[i] = m[PERM[i]];
    std::memcpy(m, p, 64);
  }
  for (int i = 0; i < 8; i++) out8[i] = st[i] ^ st[i + 8];
}

static inline void load_block(const uint8_t *p, uint32_t len,
                              uint32_t block[16]) {
  uint8_t buf[64];
  if (len < 64) {
    std::memset(buf, 0, 64);
    std::memcpy(buf, p, len);
    p = buf;
  }
  for (int i = 0; i < 16; i++) {
    block[i] = (uint32_t)p[4 * i] | ((uint32_t)p[4 * i + 1] << 8) |
               ((uint32_t)p[4 * i + 2] << 16) | ((uint32_t)p[4 * i + 3] << 24);
  }
}

// Chaining value of one chunk (<= 1024 bytes). root_flag is OR'd into the
// LAST block's flags only (ROOT when this chunk is the whole message).
static inline void chunk_cv(const uint8_t *p, uint64_t len, uint64_t counter,
                            uint32_t root_flag, uint32_t out8[8]) {
  uint32_t cv[8];
  std::memcpy(cv, IV, 32);
  uint64_t pos = 0;
  int blk = 0;
  // n blocks: ceil(len/64), at least 1 (empty chunk = one zero block).
  uint64_t nblk = len == 0 ? 1 : (len + 63) / 64;
  for (; (uint64_t)blk < nblk; blk++) {
    uint32_t blen = (uint32_t)((len - pos) < 64 ? (len - pos) : 64);
    uint32_t flags = 0;
    if (blk == 0) flags |= CHUNK_START;
    if ((uint64_t)(blk + 1) == nblk) flags |= CHUNK_END | root_flag;
    uint32_t block[16];
    load_block(p + pos, blen, block);
    compress(cv, block, counter, blen, flags, cv);
    pos += blen;
  }
  std::memcpy(out8, cv, 32);
}

static inline void parent_cv(const uint32_t l[8], const uint32_t r[8],
                             uint32_t root_flag, uint32_t out8[8]) {
  uint32_t block[16];
  std::memcpy(block, l, 32);
  std::memcpy(block + 8, r, 32);
  compress(IV, block, 0, 64, PARENT | root_flag, out8);
}

static inline uint64_t prev_pow2(uint64_t x) {
  // largest power of two <= x (x >= 1)
  while (x & (x - 1)) x &= x - 1;
  return x;
}

// CV of the subtree covering len bytes starting at chunk index chunk0.
static inline void subtree_cv(const uint8_t *p, uint64_t len, uint64_t chunk0,
                              uint32_t root_flag, uint32_t out8[8]) {
  if (len <= 1024) {
    chunk_cv(p, len, chunk0, root_flag, out8);
    return;
  }
  uint64_t nchunks = (len + 1023) / 1024;
  // Left subtree: largest power-of-two chunk count that leaves at least
  // one byte on the right (spec's tree shape rule).
  uint64_t left_chunks = prev_pow2(nchunks - 1);
  uint64_t left_len = left_chunks * 1024;
  uint32_t l[8], r[8];
  subtree_cv(p, left_len, chunk0, 0, l);
  subtree_cv(p + left_len, len - left_len, chunk0 + left_chunks, 0, r);
  parent_cv(l, r, root_flag, out8);
}

// Composed permutation schedules as flat arrays (usable from the AVX2
// target function, where std::vector/loop-built tables are awkward).
static inline const int *PERM_SCHED(int r) {
  static int sched[7][16];
  static bool init = [] {
    for (int i = 0; i < 16; i++) sched[0][i] = i;
    for (int rr = 1; rr < 7; rr++)
      for (int i = 0; i < 16; i++) sched[rr][i] = sched[rr - 1][PERM[i]];
    return true;
  }();
  (void)init;
  return sched[r];
}

static inline bool avx2_ok() {
#ifdef NTPU_B3_X86
  static const bool ok = __builtin_cpu_supports("avx2");
  return ok;
#else
  return false;
#endif
}

static inline bool avx512_ok() {
#ifdef NTPU_B3_X86
  static const bool ok = __builtin_cpu_supports("avx512f");
  return ok;
#else
  return false;
#endif
}

// Arm selection with a test pin (3 = avx512, 2 = avx2, 1 = scalar) —
// the gear engine's NTPU_GEAR_FORCE_ISA contract, for blake3: without
// a pin the widest supported arm runs; a pin never selects an arm the
// host cannot execute (it degrades toward scalar).
static inline int b3_active_isa() {
  static const int v = [] {
    int forced = 0;
    const char *e = std::getenv("NTPU_B3_FORCE_ISA");
    if (e != nullptr) {
      if (std::strcmp(e, "scalar") == 0) forced = 1;
      else if (std::strcmp(e, "avx2") == 0) forced = 2;
      else if (std::strcmp(e, "avx512") == 0) forced = 3;
    }
    const int widest = avx512_ok() ? 3 : (avx2_ok() ? 2 : 1);
    if (forced == 0) return widest;
    return forced < widest ? forced : widest;
  }();
  return v;
}

#ifdef NTPU_B3_X86
// 8-way leaf hashing: one u32 lane per leaf. BLAKE3's leaves are fully
// independent (only the counter differs), so eight complete 1024-byte
// leaves run through the compression function simultaneously — the same
// lane decomposition the device kernel (ops/blake3_jax.py) uses on the
// TPU VPU, here on AVX2. Message words are gathered across the eight
// leaves (stride 1024 B); rounds are the scalar G network on __m256i.
__attribute__((target("avx2"))) static inline void leaves8_avx2(
    const uint8_t *p, uint64_t leaf0, uint32_t out_cvs[8][8]) {
  __m256i v0 = _mm256_set1_epi32((int)IV[0]);
  __m256i v1 = _mm256_set1_epi32((int)IV[1]);
  __m256i v2 = _mm256_set1_epi32((int)IV[2]);
  __m256i v3 = _mm256_set1_epi32((int)IV[3]);
  __m256i v4 = _mm256_set1_epi32((int)IV[4]);
  __m256i v5 = _mm256_set1_epi32((int)IV[5]);
  __m256i v6 = _mm256_set1_epi32((int)IV[6]);
  __m256i v7 = _mm256_set1_epi32((int)IV[7]);
  __m256i cv[8] = {v0, v1, v2, v3, v4, v5, v6, v7};
  const __m256i counter = _mm256_add_epi32(
      _mm256_set1_epi32((int)(uint32_t)leaf0),
      _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7));
  const __m256i zero = _mm256_setzero_si256();
  const __m256i b64 = _mm256_set1_epi32(64);
  // leaf stride in i32 units for the cross-leaf gathers
  const __m256i vidx = _mm256_setr_epi32(0, 256, 512, 768, 1024, 1280, 1536, 1792);

#define NTPU_B3_ROTR(x, r) \
  _mm256_or_si256(_mm256_srli_epi32(x, r), _mm256_slli_epi32(x, 32 - (r)))
#define NTPU_B3_G(a, b, c, d, mx, my)              \
  a = _mm256_add_epi32(_mm256_add_epi32(a, b), mx); \
  d = NTPU_B3_ROTR(_mm256_xor_si256(d, a), 16);     \
  c = _mm256_add_epi32(c, d);                       \
  b = NTPU_B3_ROTR(_mm256_xor_si256(b, c), 12);     \
  a = _mm256_add_epi32(_mm256_add_epi32(a, b), my); \
  d = NTPU_B3_ROTR(_mm256_xor_si256(d, a), 8);      \
  c = _mm256_add_epi32(c, d);                       \
  b = NTPU_B3_ROTR(_mm256_xor_si256(b, c), 7);

  for (int blk = 0; blk < 16; blk++) {
    const uint32_t flags =
        (blk == 0 ? (uint32_t)CHUNK_START : 0u) |
        (blk == 15 ? (uint32_t)CHUNK_END : 0u);
    __m256i m[16];
    const int *base = (const int *)(p + blk * 64);
    for (int w = 0; w < 16; w++)
      m[w] = _mm256_i32gather_epi32(base + w, vidx, 4);
    __m256i s[16];
    for (int i = 0; i < 8; i++) s[i] = cv[i];
    s[8] = _mm256_set1_epi32((int)IV[0]);
    s[9] = _mm256_set1_epi32((int)IV[1]);
    s[10] = _mm256_set1_epi32((int)IV[2]);
    s[11] = _mm256_set1_epi32((int)IV[3]);
    s[12] = counter;
    s[13] = zero;
    s[14] = b64;
    s[15] = _mm256_set1_epi32((int)flags);
    for (int r = 0; r < 7; r++) {
      const int *sc = PERM_SCHED(r);
      NTPU_B3_G(s[0], s[4], s[8], s[12], m[sc[0]], m[sc[1]])
      NTPU_B3_G(s[1], s[5], s[9], s[13], m[sc[2]], m[sc[3]])
      NTPU_B3_G(s[2], s[6], s[10], s[14], m[sc[4]], m[sc[5]])
      NTPU_B3_G(s[3], s[7], s[11], s[15], m[sc[6]], m[sc[7]])
      NTPU_B3_G(s[0], s[5], s[10], s[15], m[sc[8]], m[sc[9]])
      NTPU_B3_G(s[1], s[6], s[11], s[12], m[sc[10]], m[sc[11]])
      NTPU_B3_G(s[2], s[7], s[8], s[13], m[sc[12]], m[sc[13]])
      NTPU_B3_G(s[3], s[4], s[9], s[14], m[sc[14]], m[sc[15]])
    }
    for (int i = 0; i < 8; i++) cv[i] = _mm256_xor_si256(s[i], s[i + 8]);
  }
#undef NTPU_B3_G
#undef NTPU_B3_ROTR
  // transpose: out_cvs[lane][word]
  alignas(32) uint32_t tmp[8][8];
  for (int w = 0; w < 8; w++)
    _mm256_store_si256((__m256i *)tmp[w], cv[w]);
  for (int lane = 0; lane < 8; lane++)
    for (int w = 0; w < 8; w++) out_cvs[lane][w] = tmp[w][lane];
}
// gcc 12's avx512fintrin.h builds every AVX-512F op on
// _mm512_undefined_epi32(), which -Wuninitialized flags spuriously (the
// gear AVX-512 arm in chunk_engine.cpp carries the same suppression).
#pragma GCC diagnostic push
#pragma GCC diagnostic ignored "-Wuninitialized"
#pragma GCC diagnostic ignored "-Wmaybe-uninitialized"
// 16-way leaf hashing on AVX-512: same lane decomposition as the 8-way
// arm, twice the width. Rotates are written as shift/or — gcc pattern-
// matches them to vprord, and the _mm512_ror_epi32 intrinsic's
// undefined-source idiom trips -Wuninitialized inside gcc's own header.
__attribute__((target("avx512f"))) static inline void leaves16_avx512(
    const uint8_t *p, uint64_t leaf0, uint32_t out_cvs[16][8]) {
  __m512i cv[8];
  for (int i = 0; i < 8; i++) cv[i] = _mm512_set1_epi32((int)IV[i]);
  const __m512i counter = _mm512_add_epi32(
      _mm512_set1_epi32((int)(uint32_t)leaf0),
      _mm512_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15));
  const __m512i zero = _mm512_setzero_si512();
  const __m512i b64 = _mm512_set1_epi32(64);
  // leaf stride in i32 units (1024 B = 256 ints) across 16 leaves
  const __m512i vidx = _mm512_setr_epi32(
      0, 256, 512, 768, 1024, 1280, 1536, 1792,
      2048, 2304, 2560, 2816, 3072, 3328, 3584, 3840);

#define NTPU_B3_ROTR512(x, r)                         \
  _mm512_or_si512(_mm512_srli_epi32(x, r),            \
                  _mm512_slli_epi32(x, 32 - (r)))
#define NTPU_B3_G512(a, b, c, d, mx, my)              \
  a = _mm512_add_epi32(_mm512_add_epi32(a, b), mx);   \
  d = NTPU_B3_ROTR512(_mm512_xor_si512(d, a), 16);    \
  c = _mm512_add_epi32(c, d);                         \
  b = NTPU_B3_ROTR512(_mm512_xor_si512(b, c), 12);    \
  a = _mm512_add_epi32(_mm512_add_epi32(a, b), my);   \
  d = NTPU_B3_ROTR512(_mm512_xor_si512(d, a), 8);     \
  c = _mm512_add_epi32(c, d);                         \
  b = NTPU_B3_ROTR512(_mm512_xor_si512(b, c), 7);

  for (int blk = 0; blk < 16; blk++) {
    const uint32_t flags =
        (blk == 0 ? (uint32_t)CHUNK_START : 0u) |
        (blk == 15 ? (uint32_t)CHUNK_END : 0u);
    __m512i m[16];
    const int *base = (const int *)(p + blk * 64);
    for (int w = 0; w < 16; w++)
      // masked form with an explicit zero source: the plain gather's
      // undefined-source idiom trips -Wuninitialized inside gcc's own
      // avx512fintrin.h
      m[w] = _mm512_mask_i32gather_epi32(zero, (__mmask16)0xFFFF, vidx,
                                         base + w, 4);
    __m512i s[16];
    for (int i = 0; i < 8; i++) s[i] = cv[i];
    for (int i = 0; i < 4; i++) s[8 + i] = _mm512_set1_epi32((int)IV[i]);
    s[12] = counter;
    s[13] = zero;
    s[14] = b64;
    s[15] = _mm512_set1_epi32((int)flags);
    for (int r = 0; r < 7; r++) {
      const int *sc = PERM_SCHED(r);
      NTPU_B3_G512(s[0], s[4], s[8], s[12], m[sc[0]], m[sc[1]])
      NTPU_B3_G512(s[1], s[5], s[9], s[13], m[sc[2]], m[sc[3]])
      NTPU_B3_G512(s[2], s[6], s[10], s[14], m[sc[4]], m[sc[5]])
      NTPU_B3_G512(s[3], s[7], s[11], s[15], m[sc[6]], m[sc[7]])
      NTPU_B3_G512(s[0], s[5], s[10], s[15], m[sc[8]], m[sc[9]])
      NTPU_B3_G512(s[1], s[6], s[11], s[12], m[sc[10]], m[sc[11]])
      NTPU_B3_G512(s[2], s[7], s[8], s[13], m[sc[12]], m[sc[13]])
      NTPU_B3_G512(s[3], s[4], s[9], s[14], m[sc[14]], m[sc[15]])
    }
    for (int i = 0; i < 8; i++)
      cv[i] = _mm512_xor_si512(s[i], s[i + 8]);
  }
#undef NTPU_B3_G512
#undef NTPU_B3_ROTR512
  alignas(64) uint32_t tmp[8][16];
  for (int w = 0; w < 8; w++)
    _mm512_store_si512((__m512i *)tmp[w], cv[w]);
  for (int lane = 0; lane < 16; lane++)
    for (int w = 0; w < 8; w++) out_cvs[lane][w] = tmp[w][lane];
}
#pragma GCC diagnostic pop
#endif  // NTPU_B3_X86

// 32-byte BLAKE3 hash of data[0:len].
static inline void blake3_hash(const uint8_t *data, uint64_t len,
                               uint8_t out[32]) {
  uint32_t root[8];
  const uint64_t nchunks = len == 0 ? 1 : (len + 1023) / 1024;
  // >= 2^32 chunks (4 TiB): the SIMD lane counters are 32-bit — take
  // the scalar path, which carries the full 64-bit counter.
  const int isa = b3_active_isa();
  if (nchunks <= 8 || nchunks >= (1ull << 32) || isa == 1) {
    subtree_cv(data, len, 0, ROOT, root);
  } else {
    // Leaf pass: AVX2 8-way over complete leaves, scalar tail; then a
    // pair-adjacent/odd-promotes reduction — the same shape as the
    // spec's largest-power-of-two-left-subtree rule (see the proof note
    // in ops/blake3_jax.py, whose device kernel uses the identical
    // decomposition).
    std::vector<std::array<uint32_t, 8>> cvs((size_t)nchunks);
    const uint64_t full = len / 1024;  // complete leaves
    uint64_t i = 0;
#ifdef NTPU_B3_X86
    if (isa >= 3)
      for (; i + 16 <= full; i += 16)
        leaves16_avx512(
            data + i * 1024, i,
            reinterpret_cast<uint32_t(*)[8]>(cvs[(size_t)i].data()));
    if (isa >= 2)
      for (; i + 8 <= full; i += 8)
        leaves8_avx2(data + i * 1024, i,
                     reinterpret_cast<uint32_t(*)[8]>(cvs[(size_t)i].data()));
#endif
    for (; i < nchunks; i++) {
      const uint64_t off = i * 1024;
      chunk_cv(data + off, len - off < 1024 ? len - off : 1024, i, 0,
               cvs[(size_t)i].data());
    }
    uint64_t n = nchunks;
    while (n > 1) {
      const uint64_t half = n / 2;
      for (uint64_t j = 0; j < half; j++)
        parent_cv(cvs[(size_t)(2 * j)].data(), cvs[(size_t)(2 * j + 1)].data(),
                  n == 2 ? (uint32_t)ROOT : 0u, cvs[(size_t)j].data());
      if (n & 1) {
        cvs[(size_t)half] = cvs[(size_t)(n - 1)];
        n = half + 1;
      } else {
        n = half;
      }
    }
    std::memcpy(root, cvs[0].data(), 32);
  }
  for (int i = 0; i < 8; i++) {
    out[4 * i] = (uint8_t)root[i];
    out[4 * i + 1] = (uint8_t)(root[i] >> 8);
    out[4 * i + 2] = (uint8_t)(root[i] >> 16);
    out[4 * i + 3] = (uint8_t)(root[i] >> 24);
  }
}

// Batch form mirroring ntpu_sha::sha256_extents: m (offset, size) extents
// against one base pointer, 32 bytes out per extent.
static inline void blake3_extents(const uint8_t *data, const int64_t *extents,
                                  int64_t m, uint8_t *out) {
  for (int64_t i = 0; i < m; i++) {
    blake3_hash(data + extents[2 * i], (uint64_t)extents[2 * i + 1],
                out + 32 * i);
  }
}

}  // namespace ntpu_b3
