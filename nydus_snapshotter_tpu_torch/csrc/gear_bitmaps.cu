// K1 — gear-hash FastCDC candidate bitmaps.
//
// Replaces: nydus_snapshotter_tpu/ops/gear_pallas.py `_kernel` (launched by
// `_bitmaps_lanes`, wrapped by `gear_bitmaps`). Same function: for every
// position i of each row the 32-bit gear hash
//     h_i = sum_{k<32} mix32(x_{i-k}) << k   (mod 2^32)
// is tested against two masks, and each test is packed into u32 words,
// bit j of word w = position 32w + j, in stream order.
//
// Input rows are u8[B, n + 31]: each row carries the 31 bytes that precede
// it in the stream (zero BYTES before the stream start — they hash as
// mix32(0), which is not 0, exactly as the reference builds its zero tail
// row). Output position p of a row is the hash ending at row byte p + 31.
//
// Bound on this card: bytes and operations at about parity. The 32-term
// sum is the rolling recurrence h_i = (h_{i-1} << 1) + mix32(x_i), exact
// mod 2^32 because the term of x_{i-32} is shifted out, so the function
// needs ~6 integer ops per position (the gear value, a shift-add, two mask
// tests) against 1 byte read and 2 bits written.
//
// Design: the recurrence, each thread owning a run of kRun = 64 positions
// (two output words per bitmap).
// - Staging: a CTA's tile of kTile positions needs the tile's bytes plus
//   the 31 before each run. The CTA reads them with coalesced aligned
//   16-byte loads, mixes each byte once (mix32: ~9 ops per byte, computed
//   inline; a 256-entry table in shared memory was no faster, its lookups
//   conflict on banks) and stores the gear values in shared memory. Only
//   the tile's first and last pieces check each byte against the tile.
// - Each thread starts 31 bytes before its first position with h = 0 and
//   steps h = (h << 1) + g: after the 31 warm-up steps h is the windowed
//   sum exactly, so (kRun + 31) / kRun ~ 1.5 steps per position instead
//   of a 32-term sum. Within a row the warm-up reads the run's preceding
//   bytes of the same row, so runs and tiles hash exactly as one stream.
// - Bank conflicts: runs start kRun values apart, a multiple of the 32
//   banks. The gear values are stored with one word of skew per kRun
//   (index v -> v + v / kRun), so thread t reads bank (t + k) mod 32 at
//   step k: conflict-free.
// - Each thread stores its two words per bitmap with one 8-byte store
//   (scalar stores where a row's word count leaves the pair unaligned or
//   the row ends inside the run: n is only a multiple of 32).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRun = 64;                    // positions per thread
constexpr int kWords = kRun / 32;           // output words per bitmap per thread
constexpr int kTile = kThreads * kRun;      // positions per CTA
constexpr int kTail = 31;
constexpr int kVals = kTile + kTail;        // gear values a tile needs
constexpr int kSkewed = kVals + kVals / kRun + 1;
static_assert(kWords == 2, "the vector store below writes one uint2 per bitmap");

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x + 1u) * 0x9E3779B1u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ int skew(int v) {
  return v + static_cast<int>(static_cast<unsigned>(v) / kRun);
}

__global__ void __launch_bounds__(kThreads)
gear_bitmaps_kernel(const uint8_t* __restrict__ x, int64_t total, uint32_t* __restrict__ out_s,
                    uint32_t* __restrict__ out_l, int64_t n, uint32_t mask_s,
                    uint32_t mask_l) {
  __shared__ uint32_t g[kSkewed];
  const int64_t row = blockIdx.y;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int t = threadIdx.x;

  // g[skew(v)] = mix32(row byte p0 + v), v in [0, nv): the tile's bytes and
  // the 31 after its last position. Loaded as aligned 16-byte pieces of the
  // whole tensor; a piece that straddles the tensor's ends is read bytewise.
  const int64_t nv = (n - p0 < kTile ? n - p0 : kTile) + kTail;
  const int64_t g0 = row * (n + kTail) + p0;  // tensor byte of value 0
  const uintptr_t a_first = reinterpret_cast<uintptr_t>(x + g0) & ~uintptr_t{15};
  const int64_t lead = static_cast<int64_t>(reinterpret_cast<uintptr_t>(x + g0) - a_first);
  const int64_t pieces = (lead + nv + 15) / 16;
  const uintptr_t x_lo = reinterpret_cast<uintptr_t>(x);
  const uintptr_t x_hi = x_lo + static_cast<uintptr_t>(total);
  for (int64_t c = t; c < pieces; c += kThreads) {
    const uintptr_t a = a_first + 16 * static_cast<uintptr_t>(c);
    uint32_t word[4];
    if (a >= x_lo && a + 16 <= x_hi) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(a));
      word[0] = v.x; word[1] = v.y; word[2] = v.z; word[3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t wv = 0;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const uintptr_t ab = a + 4 * k + bb;
          const uint32_t byte = (ab >= x_lo && ab < x_hi)
                                    ? *reinterpret_cast<const uint8_t*>(ab) : 0u;
          wv |= byte << (8 * bb);
        }
        word[k] = wv;
      }
    }
    const int64_t v0 = 16 * c - lead;  // value index of the piece's byte 0
    if (v0 >= 0 && v0 + 16 <= nv) {     // every piece but the tile's first and last
      const int base = static_cast<int>(v0);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const uint32_t byte = __byte_perm(word[k >> 2], 0u, 0x4440u | (k & 3));
        g[skew(base + k)] = mix32(byte);
      }
      continue;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int64_t v = v0 + k;
      if (v >= 0 && v < nv) {
        const uint32_t byte = __byte_perm(word[k >> 2], 0u, 0x4440u | (k & 3));
        g[skew(static_cast<int>(v))] = mix32(byte);
      }
    }
  }
  __syncthreads();

  const int64_t first = p0 + static_cast<int64_t>(t) * kRun;  // first position of the run
  if (first >= n) return;
  const uint32_t* gr = g + t * (kRun + 1);  // skew(t * kRun): the run's value 0
  uint32_t h = 0;
#pragma unroll
  for (int k = 0; k < kTail; ++k) h = (h << 1) + gr[skew(k)];
  uint32_t ws[kWords], wl[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    uint32_t bs = 0, bl = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      h = (h << 1) + gr[skew(kTail + 32 * w + j)];
      bs |= static_cast<uint32_t>((h & mask_s) == 0u) << j;
      bl |= static_cast<uint32_t>((h & mask_l) == 0u) << j;
    }
    ws[w] = bs;
    wl[w] = bl;
  }

  const int64_t nw = n / 32;
  const int64_t w0 = first / 32;
  const int64_t o = row * nw + w0;
  if (w0 + kWords <= nw && (o % kWords) == 0) {
    *reinterpret_cast<uint2*>(out_s + o) = make_uint2(ws[0], ws[1]);
    *reinterpret_cast<uint2*>(out_l + o) = make_uint2(wl[0], wl[1]);
  } else {
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      if (w0 + w < nw) {
        out_s[o + w] = ws[w];
        out_l[o + w] = wl[w];
      }
    }
  }
}

}  // namespace

// x: u8[rows, n + 31]; out_s, out_l: u32[rows, n / 32] (8-byte aligned);
// n % 32 == 0.
extern "C" int ntpu_gear_bitmaps(const void* x, void* out_s, void* out_l,
                                 int64_t rows, int64_t n, uint32_t mask_s,
                                 uint32_t mask_l, void* stream) {
  const dim3 grid(static_cast<unsigned>((n + kTile - 1) / kTile),
                  static_cast<unsigned>(rows));
  gear_bitmaps_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), rows * (n + kTail), static_cast<uint32_t*>(out_s),
      static_cast<uint32_t*>(out_l), n, mask_s, mask_l);
  return static_cast<int>(cudaGetLastError());
}
