// K2 — SHA-256 of many chunks read straight from the layer buffer.
//
// Replaces: nydus_snapshotter_tpu/ops/sha256_pallas.py `_kernel` (launched
// by `_sha256_groups`, wrapped by `sha256_batch_pallas`) together with the
// gather and padding in front of it (ops/fused_convert.py
// `_gather_pack_sha`). Same function as
//     sha256_batch_pallas(_gather_pack_sha(buf, offs, sizes, cap),
//                         (sizes + 8) // 64 + 1)
// : chunk m is buf[offs[m], offs[m] + sizes[m]); out[m] is its SHA-256 state
// as eight big-endian-word u32s.
//
// Bound on this card: integer operations, and the longest chunk. One
// 64-byte block costs 64 rounds of ~14 ops plus 48 schedule steps of ~10
// ops (~1.4k ops for 64 bytes read), far above the byte time. A chunk's
// blocks chain through the state, so one chunk is one serial thread: the
// longest chunk's blocks x 64 rounds x the round's dependent depth is a
// floor no amount of parallelism lowers.
//
// Design: one thread per chunk, every chunk of a pass in ONE launch.
// - Longest first: thread i digests row perm[i], perm orders the rows by
//   size descending. CTAs start roughly in blockIdx order, so the longest
//   chains start first, and a warp holds chunks of similar length instead
//   of waiting on one long lane. 128 threads per CTA: one warp per
//   scheduler of an SM, and the first 132 CTAs spread the longest rows
//   over every SM.
// - Branch-free full blocks: blocks j < size / 64 are all message bytes.
//   They are read with five aligned 16-byte loads (four when the chunk
//   start is 16-aligned), shifted to the chunk start by two select stages
//   (whole words) and one `__byte_perm` per word (the byte offset and the
//   big-endian swap together). No per-word condition.
// - Loads off the critical path: block j+1's loads are issued before
//   block j's 64 rounds and land in registers while the rounds run.
// - Only the last one or two blocks take the padding path: 0x80 at byte
//   `size`, the 64-bit bit length in words 14-15 of block (size + 8) / 64.
// The 64 rounds are unrolled so the 16-word schedule window stays in
// registers; round constants come from constant memory (every lane reads
// the same one).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__constant__ uint32_t kK[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
}

// Big-endian word of the 4 bytes at buf + a (any alignment; buf 4-aligned).
// The second aligned word is read only when the 4 bytes straddle it, and
// then it holds at least one of them, so no read leaves the allocation.
__device__ __forceinline__ uint32_t load_be(const uint8_t* __restrict__ buf,
                                            int64_t a) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(buf + (a & ~int64_t{3}));
  const uint32_t s = static_cast<uint32_t>(a & 3);
  const uint32_t lo = w[0];
  const uint32_t hi = s ? w[1] : 0u;
  return __byte_perm(lo, hi, (s << 12) | ((s + 1) << 8) | ((s + 2) << 4) | (s + 3));
}

// The five aligned 16-byte pieces that cover one full block at p (16-aligned
// base of the block). The fifth holds block bytes only when the block start
// is not 16-aligned, and is read only then: every piece read holds a byte
// of the block, so no read leaves a 16-aligned, 16-padded allocation.
struct Raw {
  uint4 v[5];
};

__device__ __forceinline__ void load_raw(Raw& r, const uint4* __restrict__ p, bool tail) {
#pragma unroll
  for (int k = 0; k < 4; ++k) r.v[k] = __ldg(p + k);
  r.v[4] = tail ? __ldg(p + 4) : make_uint4(0u, 0u, 0u, 0u);
}

// Message words of a full block from its raw pieces: start at byte
// 4 * q + b of the 80 raw bytes (q = whole-word shift, sel = the big-endian
// `__byte_perm` selector of byte shift b).
__device__ __forceinline__ void block_words(uint32_t w[16], const Raw& r, uint32_t q,
                                            uint32_t sel) {
  uint32_t x[20];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    x[4 * k] = r.v[k].x;
    x[4 * k + 1] = r.v[k].y;
    x[4 * k + 2] = r.v[k].z;
    x[4 * k + 3] = r.v[k].w;
  }
#pragma unroll
  for (int k = 0; k < 19; ++k) x[k] = (q & 1u) ? x[k + 1] : x[k];
#pragma unroll
  for (int k = 0; k < 17; ++k) x[k] = (q & 2u) ? x[k + 2] : x[k];
#pragma unroll
  for (int k = 0; k < 16; ++k) w[k] = __byte_perm(x[k], x[k + 1], sel);
}

__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int r = 0; r < 64; ++r) {
    uint32_t wr;
    if (r < 16) {
      wr = w[r];
    } else {
      const uint32_t w15 = w[(r - 15) & 15], w2 = w[(r - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wr = w[r & 15] + s0 + w[(r - 7) & 15] + s1;
      w[r & 15] = wr;
    }
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + kK[r] + wr;
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + S0 + maj;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

__global__ void __launch_bounds__(kThreads)
sha256_chunks_kernel(const uint8_t* __restrict__ buf, const int32_t* __restrict__ offs,
                     const int32_t* __restrict__ sizes, const int32_t* __restrict__ perm,
                     uint32_t* __restrict__ out, int64_t m) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const int64_t row = perm[i];
  const int64_t off = offs[row];
  const int64_t size = sizes[row];
  const int64_t nfull = size >> 6;
  const int64_t nb = (size + 8) / 64 + 1;

  uint32_t st[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};

  // Full blocks: aligned 16-byte pieces, one block ahead.
  const uint4* base = reinterpret_cast<const uint4*>(buf + (off & ~int64_t{15}));
  const uint32_t s16 = static_cast<uint32_t>(off & 15);
  const uint32_t q = s16 >> 2, b = s16 & 3;
  const uint32_t sel = (b << 12) | ((b + 1) << 8) | ((b + 2) << 4) | (b + 3);
  const bool unaligned = s16 != 0;
  Raw next;
  if (nfull > 0) load_raw(next, base, unaligned);
  for (int64_t j = 0; j < nfull; ++j) {
    const Raw cur = next;
    if (j + 1 < nfull) load_raw(next, base + 4 * (j + 1), unaligned);
    uint32_t w[16];
    block_words(w, cur, q, sel);
    compress(st, w);
  }

  // The one or two blocks that hold the message end and the padding.
  for (int64_t j = nfull; j < nb; ++j) {
    uint32_t w[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int64_t p = j * 64 + 4 * k;  // byte index within the message
      if (p + 4 <= size) {
        w[k] = load_be(buf, off + p);
      } else {
        uint32_t v = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int64_t pc = p + c;
          const uint32_t byte = pc < size ? buf[off + pc] : (pc == size ? 0x80u : 0u);
          v = (v << 8) | byte;
        }
        w[k] = v;
      }
    }
    if (j == nb - 1) {
      w[14] = static_cast<uint32_t>(size >> 29);
      w[15] = static_cast<uint32_t>(size << 3);
    }
    compress(st, w);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) out[row * 8 + k] = st[k];
}

}  // namespace

// buf: u8[N] (16-byte aligned, N % 16 == 0); offs, sizes, perm: i32[m]
// (perm a permutation of 0..m-1); out: u32[m, 8].
extern "C" int ntpu_sha256_chunks(const void* buf, const void* offs, const void* sizes,
                                  const void* perm, void* out, int64_t m, void* stream) {
  const unsigned blocks = static_cast<unsigned>((m + kThreads - 1) / kThreads);
  sha256_chunks_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), static_cast<const int32_t*>(offs),
      static_cast<const int32_t*>(sizes), static_cast<const int32_t*>(perm),
      static_cast<uint32_t*>(out), m);
  return static_cast<int>(cudaGetLastError());
}
