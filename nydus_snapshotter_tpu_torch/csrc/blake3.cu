// K4 — BLAKE3 of many chunks read straight from the layer buffer.
//
// Replaces: nydus_snapshotter_tpu/ops/blake3_jax.py `_blake3_batch_jit`
// (XLA, not Pallas: `_compress`, `_leaf_cv`, the tree of `_blake3_one`)
// together with the gather in front of it (ops/fused_convert.py
// `_gather_pack_b3`). Same function as
//     _blake3_batch_jit(_gather_pack_b3(buf, offs, sizes, cap), sizes)
// : chunk m is buf[offs[m], offs[m] + sizes[m]); out[m] is its BLAKE3
// digest as eight little-endian u32 words.
//
// Bound on this card: integer operations. A 64-byte compression is 7
// rounds x 8 G mixes of 12 operations (2 three-input adds, 2 adds, 4 xors,
// 4 rotates) plus 8 output xors, ~11 operations a byte with the parent
// compressions, far above the byte time. Unlike SHA-256 a chunk is not one
// serial chain: its 1024-byte leaves compress independently, and only a
// leaf's 16 blocks plus log2(leaves) parent levels are in sequence.
//
// Design, two launches per call:
// (a) `blake3_leaves`: one thread per leaf over a flat leaf index (every
//     leaf of every chunk), the chunk found by binary search over the
//     leaf ends that the wrapper prefix-sums on the card. 16 compressions
//     in registers; full blocks are read as aligned 16-byte pieces shifted
//     to the chunk start by two select stages and one `__byte_perm` a word
//     (as K2 does, little-endian here); the one partial block is read a
//     word at a time and zeroed past the chunk. Counter = leaf index (high
//     word 0). A single-leaf chunk finishes here (CHUNK_START | CHUNK_END |
//     ROOT on its last block) and writes its digest; a leaf of a longer
//     chunk writes its chaining value to the scratch cv[L, 8].
// (b) `blake3_parents`: one block per chunk (single-leaf chunks return at
//     once), the tree level by level, "pair adjacent, odd lane promotes",
//     ROOT on the last merge. Levels wider than the shared array ping-pong
//     between the scratch and a second scratch in device memory (only a
//     chunk of more than kSharedCvs leaves has them: above 512 KiB); the
//     rest run in shared memory, one pair a thread.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLeafThreads = 128;
constexpr int kParentThreads = 256;
constexpr int kSharedCvs = 2 * kParentThreads;

constexpr uint32_t kChunkStart = 1u << 0;
constexpr uint32_t kChunkEnd = 1u << 1;
constexpr uint32_t kParent = 1u << 2;
constexpr uint32_t kRoot = 1u << 3;

__device__ __forceinline__ uint32_t iv(int i) {
  switch (i) {
    case 0: return 0x6A09E667u;
    case 1: return 0xBB67AE85u;
    case 2: return 0x3C6EF372u;
    case 3: return 0xA54FF53Au;
    case 4: return 0x510E527Fu;
    case 5: return 0x9B05688Cu;
    case 6: return 0x1F83D9ABu;
    default: return 0x5BE0CD19u;
  }
}

__device__ __forceinline__ uint32_t rotr(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
}

#define B3_G(a, b, c, d, x, y)  \
  a = a + b + (x);              \
  d = rotr(d ^ a, 16);          \
  c = c + d;                    \
  b = rotr(b ^ c, 12);          \
  a = a + b + (y);              \
  d = rotr(d ^ a, 8);           \
  c = c + d;                    \
  b = rotr(b ^ c, 7);

// cv <- first 8 words of compress(cv, m, counter, blen, flags). m is
// permuted in place (the message schedule), so the caller's copy is spent.
__device__ __forceinline__ void compress(uint32_t cv[8], uint32_t m[16], uint32_t counter,
                                         uint32_t blen, uint32_t flags) {
  uint32_t v0 = cv[0], v1 = cv[1], v2 = cv[2], v3 = cv[3];
  uint32_t v4 = cv[4], v5 = cv[5], v6 = cv[6], v7 = cv[7];
  uint32_t v8 = iv(0), v9 = iv(1), v10 = iv(2), v11 = iv(3);
  uint32_t v12 = counter, v13 = 0u, v14 = blen, v15 = flags;
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    B3_G(v0, v4, v8, v12, m[0], m[1]);
    B3_G(v1, v5, v9, v13, m[2], m[3]);
    B3_G(v2, v6, v10, v14, m[4], m[5]);
    B3_G(v3, v7, v11, v15, m[6], m[7]);
    B3_G(v0, v5, v10, v15, m[8], m[9]);
    B3_G(v1, v6, v11, v12, m[10], m[11]);
    B3_G(v2, v7, v8, v13, m[12], m[13]);
    B3_G(v3, v4, v9, v14, m[14], m[15]);
    if (r < 6) {  // m <- m[PERM], PERM = 2 6 3 10 7 0 4 13 1 11 12 5 9 14 15 8
      const uint32_t t0 = m[2], t1 = m[6], t2 = m[3], t3 = m[10], t4 = m[7], t5 = m[0];
      const uint32_t t6 = m[4], t7 = m[13], t8 = m[1], t9 = m[11], t10 = m[12];
      const uint32_t t11 = m[5], t12 = m[9], t13 = m[14], t14 = m[15], t15 = m[8];
      m[0] = t0; m[1] = t1; m[2] = t2; m[3] = t3; m[4] = t4; m[5] = t5; m[6] = t6;
      m[7] = t7; m[8] = t8; m[9] = t9; m[10] = t10; m[11] = t11; m[12] = t12;
      m[13] = t13; m[14] = t14; m[15] = t15;
    }
  }
  cv[0] = v0 ^ v8; cv[1] = v1 ^ v9; cv[2] = v2 ^ v10; cv[3] = v3 ^ v11;
  cv[4] = v4 ^ v12; cv[5] = v5 ^ v13; cv[6] = v6 ^ v14; cv[7] = v7 ^ v15;
}

// Little-endian word of the 4 bytes at buf + a (any alignment; buf
// 4-aligned). The second aligned word is read only when the 4 bytes
// straddle it, and then it holds one of them.
__device__ __forceinline__ uint32_t load_le(const uint8_t* __restrict__ buf, int64_t a) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(buf + (a & ~int64_t{3}));
  const uint32_t s = static_cast<uint32_t>(a & 3);
  const uint32_t lo = w[0];
  const uint32_t hi = s ? w[1] : 0u;
  return __byte_perm(lo, hi, s | ((s + 1) << 4) | ((s + 2) << 8) | ((s + 3) << 12));
}

// The 16 words of a full block at byte a: the aligned 16-byte pieces that
// cover [a, a + 64), the fifth read only when a is not 16-aligned (it then
// holds block bytes), so no read leaves a 16-aligned, 16-padded buffer.
__device__ __forceinline__ void full_block(uint32_t w[16], const uint8_t* __restrict__ buf,
                                           int64_t a) {
  const uint4* p = reinterpret_cast<const uint4*>(buf + (a & ~int64_t{15}));
  const uint32_t s16 = static_cast<uint32_t>(a & 15);
  const uint32_t q = s16 >> 2, b = s16 & 3;
  uint32_t x[20];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint4 v = __ldg(p + k);
    x[4 * k] = v.x; x[4 * k + 1] = v.y; x[4 * k + 2] = v.z; x[4 * k + 3] = v.w;
  }
  const uint4 v = s16 ? __ldg(p + 4) : make_uint4(0u, 0u, 0u, 0u);
  x[16] = v.x; x[17] = v.y; x[18] = v.z; x[19] = v.w;
#pragma unroll
  for (int k = 0; k < 19; ++k) x[k] = (q & 1u) ? x[k + 1] : x[k];
#pragma unroll
  for (int k = 0; k < 17; ++k) x[k] = (q & 2u) ? x[k + 2] : x[k];
  const uint32_t sel = b | ((b + 1) << 4) | ((b + 2) << 8) | ((b + 3) << 12);
#pragma unroll
  for (int k = 0; k < 16; ++k) w[k] = __byte_perm(x[k], x[k + 1], sel);
}

// Leaves of a chunk of `size` bytes (the empty chunk is one leaf).
__device__ __forceinline__ int64_t leaves_of(int64_t size) {
  return size > 1024 ? (size + 1023) >> 10 : 1;
}

__global__ void __launch_bounds__(kLeafThreads)
blake3_leaves(const uint8_t* __restrict__ buf, const int32_t* __restrict__ offs,
              const int32_t* __restrict__ sizes, const int64_t* __restrict__ leaf_end,
              int64_t m, int64_t total, uint32_t* __restrict__ cvs, uint32_t* __restrict__ out) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kLeafThreads + threadIdx.x;
  if (g >= total) return;
  // The chunk of leaf g: the first row whose leaf end exceeds g.
  int64_t lo = 0, hi = m - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(leaf_end + mid) > g) hi = mid; else lo = mid + 1;
  }
  const int64_t row = lo;
  const int64_t size = sizes[row];
  const int64_t nl = leaves_of(size);
  const int64_t li = g - (leaf_end[row] - nl);
  const int64_t start = static_cast<int64_t>(offs[row]) + (li << 10);
  const int64_t rest = size - (li << 10);
  const int leaf_len = static_cast<int>(rest < 1024 ? rest : 1024);
  const int nfull = leaf_len >> 6;
  const int nblk = leaf_len > 0 ? (leaf_len + 63) >> 6 : 1;
  const uint32_t root = nl == 1 ? kRoot : 0u;

  uint32_t cv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) cv[k] = iv(k);
  for (int j = 0; j < nblk; ++j) {
    uint32_t w[16];
    uint32_t blen = 64;
    if (j < nfull) {
      full_block(w, buf, start + 64 * j);
    } else {  // the last block, partial (or the empty chunk's zero block)
      blen = static_cast<uint32_t>(leaf_len - 64 * j);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int p = 64 * j + 4 * k;  // byte index within the leaf
        if (p + 4 <= leaf_len) {
          w[k] = load_le(buf, start + p);
        } else {
          uint32_t v = 0;
          for (int c = 0; c < 4 && p + c < leaf_len; ++c)
            v |= static_cast<uint32_t>(buf[start + p + c]) << (8 * c);
          w[k] = v;
        }
      }
    }
    uint32_t flags = j == 0 ? kChunkStart : 0u;
    if (j == nblk - 1) flags |= kChunkEnd | root;
    compress(cv, w, static_cast<uint32_t>(li), blen, flags);
  }
  uint32_t* dst = nl == 1 ? out + row * 8 : cvs + g * 8;
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(cv[0], cv[1], cv[2], cv[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(cv[4], cv[5], cv[6], cv[7]);
}

// cv_out <- the parent chaining value of the adjacent pair at `pair`
// (16 words: left then right).
__device__ __forceinline__ void parent_cv(uint32_t cv_out[8], const uint32_t* pair,
                                          uint32_t flags) {
  uint32_t m[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) m[k] = pair[k];
#pragma unroll
  for (int k = 0; k < 8; ++k) cv_out[k] = iv(k);
  compress(cv_out, m, 0u, 64u, flags);
}

__global__ void __launch_bounds__(kParentThreads)
blake3_parents(const int32_t* __restrict__ sizes, const int64_t* __restrict__ leaf_end,
               uint32_t* cv_a, uint32_t* cv_b, uint32_t* __restrict__ out) {
  const int64_t row = blockIdx.x;
  const int64_t n = leaves_of(sizes[row]);
  if (n == 1) return;  // finished by the leaf kernel
  const int64_t base = (leaf_end[row] - n) * 8;
  const uint32_t* src = cv_a + base;
  int64_t width = n;
  bool in_a = true;
  // Levels wider than the shared array: device memory, ping-pong.
  while (width > kSharedCvs) {
    const int64_t half = (width + 1) >> 1;
    uint32_t* dst = (in_a ? cv_b : cv_a) + base;
    for (int64_t t = threadIdx.x; t < half; t += kParentThreads) {
      uint32_t r[8];
      if (2 * t + 1 < width) {
        parent_cv(r, src + 16 * t, kParent);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) r[k] = src[16 * t + k];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) dst[8 * t + k] = r[k];
    }
    __syncthreads();
    src = dst;
    width = half;
    in_a = !in_a;
  }
  __shared__ uint32_t s[kSharedCvs * 8];
  for (int t = threadIdx.x; t < width * 8; t += kParentThreads) s[t] = src[t];
  __syncthreads();
  while (width > 1) {
    const int half = static_cast<int>((width + 1) >> 1);
    const int t = threadIdx.x;  // half <= kParentThreads: one pair a thread
    uint32_t r[8];
    if (t < half) {
      if (2 * t + 1 < width) {
        parent_cv(r, s + 16 * t, kParent | (width == 2 ? kRoot : 0u));
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) r[k] = s[16 * t + k];
      }
    }
    __syncthreads();
    if (t < half) {
#pragma unroll
      for (int k = 0; k < 8; ++k) s[8 * t + k] = r[k];
    }
    __syncthreads();
    width = half;
  }
  if (threadIdx.x < 8) out[row * 8 + threadIdx.x] = s[threadIdx.x];
}

}  // namespace

// buf: u8[N] (16-byte aligned, N % 16 == 0); offs, sizes: i32[m];
// leaf_end: i64[m], the inclusive prefix sum of each chunk's leaves, whose
// last entry is `total`; cvs: u32[total, 8] scratch; out: u32[m, 8].
extern "C" int ntpu_blake3_leaves(const void* buf, const void* offs, const void* sizes,
                                  const void* leaf_end, int64_t m, int64_t total, void* cvs,
                                  void* out, void* stream) {
  const unsigned blocks = static_cast<unsigned>((total + kLeafThreads - 1) / kLeafThreads);
  blake3_leaves<<<blocks, kLeafThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), static_cast<const int32_t*>(offs),
      static_cast<const int32_t*>(sizes), static_cast<const int64_t*>(leaf_end), m, total,
      static_cast<uint32_t*>(cvs), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The widest tree level a parent block keeps in shared memory. The caller
// sizes cv_b by it, so the threshold lives here alone.
extern "C" int ntpu_blake3_shared_cvs() { return kSharedCvs; }

// sizes, leaf_end, out: as above; cv_a: the leaf kernel's cvs; cv_b: a second
// u32[total, 8] scratch, read and written only for chunks of more than
// ntpu_blake3_shared_cvs() leaves (may be a 1-row dummy when there are none).
extern "C" int ntpu_blake3_parents(const void* sizes, const void* leaf_end, int64_t m,
                                   void* cv_a, void* cv_b, void* out, void* stream) {
  blake3_parents<<<static_cast<unsigned>(m), kParentThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sizes), static_cast<const int64_t*>(leaf_end),
      static_cast<uint32_t*>(cv_a), static_cast<uint32_t*>(cv_b), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
