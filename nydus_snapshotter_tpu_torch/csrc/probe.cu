// K3 — open-addressing chunk-dict probe over the wrap-free padded table.
//
// Replaces: nydus_snapshotter_tpu/ops/probe_pallas.py `_kernel` (launched by
// `probe_padded`, wrapped by `probe`). Same function: the table is
// `pad_tables`' layout, keys u32[C + W, 8] and values i32[C + W] (the head
// replicated after the end), so the chain of query q — rows
// wstart[q] + off[q] + r for r < depth — never wraps. The answer is the
// value of the first chain row whose key equals the query AND whose value
// is not 0 (values are dict index + 1); a miss answers 0. A row with value
// 0 never matches, so an empty slot's all-zero key cannot hit a zero query.
//
// Bound on this card: bytes. Each chain row examined reads 32 key bytes
// and (on a key match) 4 value bytes, at random table positions, against
// a handful of compares.
//
// Design: a group of 8 threads per query, one digest word each, so every
// 32-byte row read is one coalesced sector. `__ballot_sync` over the
// group's 8 lanes gives the row's equality; the group stops at its first
// match. Occupancy (many groups in flight per SM) hides the row latency
// that the TPU kernel hid with explicit DMA windows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 32 queries per block

__global__ void __launch_bounds__(kThreads)
probe_kernel(const uint32_t* __restrict__ keys, const int32_t* __restrict__ vals,
             const uint32_t* __restrict__ q, const int32_t* __restrict__ wstart,
             const int32_t* __restrict__ off, int32_t* __restrict__ out,
             int64_t nq, int depth) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t qi = tid >> 3;
  if (qi >= nq) return;  // whole groups of 8 leave together
  const int word = threadIdx.x & 7;
  const unsigned gmask = 0xFFu << (threadIdx.x & 24);
  const uint32_t qw = q[qi * 8 + word];
  const int64_t row0 = static_cast<int64_t>(wstart[qi]) + off[qi];
  int32_t res = 0;
  for (int r = 0; r < depth; ++r) {
    const int64_t row = row0 + r;
    const unsigned eq = __ballot_sync(gmask, keys[row * 8 + word] == qw) & gmask;
    if (eq == gmask) {  // uniform across the group
      const int32_t v = vals[row];
      if (v != 0) {
        res = v;
        break;
      }
    }
  }
  if (word == 0) out[qi] = res;
}

}  // namespace

// keys: u32[rows, 8]; vals: i32[rows]; q: u32[nq, 8]; wstart, off, out: i32[nq].
extern "C" int ntpu_probe(const void* keys, const void* vals, const void* q,
                          const void* wstart, const void* off, void* out, int64_t nq,
                          int depth, void* stream) {
  const unsigned blocks = static_cast<unsigned>((nq * 8 + kThreads - 1) / kThreads);
  probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const int32_t*>(vals),
      static_cast<const uint32_t*>(q), static_cast<const int32_t*>(wstart),
      static_cast<const int32_t*>(off), static_cast<int32_t*>(out), nq, depth);
  return static_cast<int>(cudaGetLastError());
}
