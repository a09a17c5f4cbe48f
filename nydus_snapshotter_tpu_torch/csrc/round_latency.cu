// Cycles of one SHA-256 round's critical path on this card: a probe for
// the serial term of K2's bound (csrc/sha256.cu), not a kernel of the
// convert path.
//
// Within a round, e' = S1(e) + Ch(e, f, g) + (d + h + K[r] + W[r]), and
// the last sum is known rounds ahead, so it is taken off the chain. The new
// e then depends on e through three dependent instructions: a rotate of S1
// (SHF), the 3-input xor of the rotates (LOP3; Ch is a LOP3 beside it) and
// one 3-input add (IADD3 of S1, Ch and the sum). The new a has the same
// depth through S0 and Maj. One thread runs `steps` rounds of exactly that
// chain — one rotate, one xor, Ch beside them, one IADD3 — with operands
// from the arguments so the compiler cannot fold them, and reads the SM
// cycle counter around the loop. One warp on the card issues 4
// instructions per round against 3 dependent latencies, so the count is
// the sum of the SHF, LOP3 and IADD3 latencies. (The other two rotates of
// S1 are left out: they would add their issue slots, not latency.)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void round_chain_kernel(const uint32_t* __restrict__ arg, uint32_t* __restrict__ out,
                                   long long* __restrict__ cycles, int steps) {
  const uint32_t r = arg[0] & 31u, y = arg[1], f = arg[2], g = arg[3], p = arg[4];
  uint32_t e = arg[5];
  const long long t0 = clock64();
#pragma unroll 64
  for (int i = 0; i < steps; ++i) {
    const uint32_t s1 = __funnelshift_r(e, e, r) ^ y ^ f;
    const uint32_t ch = (e & f) ^ (~e & g);
    e = s1 + ch + p;
  }
  const long long t1 = clock64();
  out[0] = e;
  cycles[0] = t1 - t0;
}

}  // namespace

// arg: u32[6] operands (rotate amount, y, f, g, the off-chain sum, e);
// out: u32[1] (keeps the chain live); cycles: i64[1].
extern "C" int ntpu_round_latency(const void* arg, void* out, void* cycles, int steps,
                                  void* stream) {
  round_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(arg), static_cast<uint32_t*>(out),
      static_cast<long long*>(cycles), steps);
  return static_cast<int>(cudaGetLastError());
}
