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
// sum is the rolling recurrence h_i = (h_{i-1} << 1) + mix32(x_i), so the
// function needs ~6 integer ops per position (a 256-entry table lookup, a
// shift-add, two mask tests) against 1 byte read and 2 bits written. This
// kernel does not reach that bound: it recomputes the window sum at every
// position (32 shared-memory loads and 32 shift-adds), ~10x the ops the
// recurrence needs, in exchange for positions that are independent.
//
// Design: one thread per position. A block stages its 256-position tile
// plus the 31 preceding bytes in shared memory, already mixed (each byte is
// mixed once, not 32 times). Each warp's 32 lanes take 32 consecutive
// positions, so `__ballot_sync` of a mask test IS the output word in stream
// order — the lane-major transpose the TPU layout needed is gone.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTail = 31;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x + 1u) * 0x9E3779B1u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__global__ void __launch_bounds__(kThreads)
gear_bitmaps_kernel(const uint8_t* __restrict__ x, uint32_t* __restrict__ out_s,
                    uint32_t* __restrict__ out_l, int64_t n, uint32_t mask_s,
                    uint32_t mask_l) {
  __shared__ uint32_t g[kThreads + kTail];
  const int64_t row_len = n + kTail;
  const int64_t row = blockIdx.y;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const uint8_t* xr = x + row * row_len;
  const int t = threadIdx.x;

  // g[j] = mix32(byte at row offset p0 + j), j in [0, 256 + 31)
  for (int j = t; j < kThreads + kTail; j += kThreads) {
    const int64_t q = p0 + j;
    g[j] = q < row_len ? mix32(xr[q]) : 0u;
  }
  __syncthreads();

  const int64_t p = p0 + t;
  // n % 32 == 0, so a warp is either wholly inside the row or wholly past it.
  if (p >= n) return;
  uint32_t h = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) h += g[t + kTail - k] << k;

  const uint32_t bs = __ballot_sync(0xffffffffu, (h & mask_s) == 0u);
  const uint32_t bl = __ballot_sync(0xffffffffu, (h & mask_l) == 0u);
  if ((t & 31) == 0) {
    const int64_t w = row * (n / 32) + p / 32;
    out_s[w] = bs;
    out_l[w] = bl;
  }
}

}  // namespace

// x: u8[rows, n + 31]; out_s, out_l: u32[rows, n / 32]; n % 32 == 0.
extern "C" int ntpu_gear_bitmaps(const void* x, void* out_s, void* out_l,
                                 int64_t rows, int64_t n, uint32_t mask_s,
                                 uint32_t mask_l, void* stream) {
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(rows));
  gear_bitmaps_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint32_t*>(out_s),
      static_cast<uint32_t*>(out_l), n, mask_s, mask_l);
  return static_cast<int>(cudaGetLastError());
}
