// K3 — open-addressing chunk-dict probe over the wrap-free padded table.
//
// Replaces: nydus_snapshotter_tpu/ops/probe_pallas.py `_kernel` (launched by
// `probe_padded`, line 151). Same function: the table is `pad_tables`'
// layout, keys u32[C + W, 8] and values i32[C + W] (the head replicated
// after the end), so the chain of query q — rows wstart[q] + off[q] + r for
// r < depth — never wraps. The answer is the value of the first chain row
// whose key equals the query AND whose value is not 0 (values are dict
// index + 1); a miss answers 0. A row with value 0 never matches, so an
// empty slot's all-zero key cannot hit a zero query. There is no early stop
// at an empty slot (the reference has none): a miss walks its whole chain.
//
// Bound on this card: bytes. Each chain row examined reads 32 key bytes
// (4 more for a hit's value) at a random table position, against a handful
// of compares; at registry scale (2^26 slots, 2M queries) that is ~1.9 GB.
//
// Design: the chain rows of a query are contiguous and their addresses are
// known before any compare, so every load of a step is issued before the
// first compare, the counterpart of the TPU kernel's whole-window DMAs.
// - A query is a warp. Two lanes share a 32-byte row, each reading one
//   16-byte half with a 128-bit read-only load, so one load instruction
//   reads 16 contiguous rows (512 B).
// - The first step reads chain rows [0, 16): at registry scale 99.95% of
//   hits sit there. A chain that did not answer goes on in steps of 4
//   loads a lane (64 rows), for any depth. Lanes past row0 + depth are
//   masked off.
// - A row matches when both halves equal the query's (one __shfl_xor_sync
//   pairs them). Only a key-equal row's value is loaded, in one trip for
//   all such rows of the step; the first with value != 0 in chain order
//   (__ffs of a ballot, load by load) answers.
// - Latency: up to 64 warps (32 registers) on an SM, each with 512 B to
//   2 KB in flight: above the ~20 KB per SM that 3.35 TB/s x ~0.8 us of
//   latency over 132 SMs asks for, so at registry scale the kernel is
//   bound by bytes. A short batch (the main path's 38 592 queries) is
//   bound by its dependent trips: the query, the first step, then the
//   value or the next step.
// Alternatives measured on an H100 and rejected (PERF.md): 16 or 8 lanes
// per query (40 and 44 registers) were within 3% of the warp on both
// workloads; loading every row's value with its key saved a hit one trip
// but moved 0.28 GB more at registry scale and was ~9% slower there;
// persistent groups that kept the next query's first step in flight took
// 57 registers, halved the resident warps and lost on both workloads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerLoad = 16;          // rows one load instruction of a warp reads
constexpr int kFirstRows = 16;            // chain rows of the first step
constexpr int kStepLoads = 4;             // loads a lane in each later step
constexpr int kStepRows = kStepLoads * kRowsPerLoad;  // chain rows of a later step
constexpr unsigned kAll = 0xFFFFFFFFu;

struct Query {
  const uint4* keys;  // the key table as 16-byte half-rows
  const int32_t* vals;
  int64_t row0;       // the query's first chain row
  int depth;
  uint4 half;         // this lane's half of the query digest
  int sub;            // this lane's row within one load of the warp
  int side;           // which half of the row this lane reads
};

// Chain rows [r0, r0 + kLoads * kRowsPerLoad) -> the value of the first
// (in chain order) whose key equals the query and whose value is not 0,
// else 0. Every key load is issued before the first compare.
template <int kLoads>
__device__ __forceinline__ int32_t step(const Query& g, int r0) {
  uint4 k[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int r = r0 + j * kRowsPerLoad + g.sub;
    k[j] = r < g.depth ? __ldg(g.keys + (g.row0 + r) * 2 + g.side) : make_uint4(0, 0, 0, 0);
  }
  bool eq[kLoads];
  unsigned any = 0;
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int r = r0 + j * kRowsPerLoad + g.sub;
    const bool e = r < g.depth && k[j].x == g.half.x && k[j].y == g.half.y &&
                   k[j].z == g.half.z && k[j].w == g.half.w;
    eq[j] = __shfl_xor_sync(kAll, e, 1) && e;  // both halves of the row
    any |= __ballot_sync(kAll, eq[j]);
  }
  if (!any) return 0;  // no key-equal row: the common case for a miss
  int32_t v[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int64_t row = g.row0 + r0 + j * kRowsPerLoad + g.sub;
    v[j] = eq[j] && g.side == 0 ? __ldg(g.vals + row) : 0;
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const unsigned hit = __ballot_sync(kAll, eq[j] && g.side == 0 && v[j] != 0);
    if (hit) return __shfl_sync(kAll, v[j], __ffs(hit) - 1);
  }
  return 0;  // every key-equal row held value 0
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(const uint4* __restrict__ keys, const int32_t* __restrict__ vals,
             const uint4* __restrict__ q, const int32_t* __restrict__ wstart,
             const int32_t* __restrict__ off, int32_t* __restrict__ out, int64_t nq, int depth) {
  const int64_t qi = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  if (qi >= nq) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  Query g;
  g.keys = keys;
  g.vals = vals;
  g.row0 = static_cast<int64_t>(__ldg(wstart + qi)) + __ldg(off + qi);
  g.depth = depth;
  g.side = lane & 1;
  g.half = __ldg(q + qi * 2 + g.side);
  g.sub = lane >> 1;
  int32_t res = step<kFirstRows / kRowsPerLoad>(g, 0);
  for (int r0 = kFirstRows; res == 0 && r0 < depth; r0 += kStepRows)
    res = step<kStepLoads>(g, r0);
  if (lane == 0) out[qi] = res;
}

}  // namespace

// keys: u32[rows, 8]; vals: i32[rows]; q: u32[nq, 8] (all 16-byte aligned);
// wstart, off, out: i32[nq]; depth >= 1.
extern "C" int ntpu_probe(const void* keys, const void* vals, const void* q,
                          const void* wstart, const void* off, void* out, int64_t nq,
                          int depth, void* stream) {
  const int64_t blocks = (nq * 32 + kThreads - 1) / kThreads;
  probe_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(keys), static_cast<const int32_t*>(vals),
      static_cast<const uint4*>(q), static_cast<const int32_t*>(wstart),
      static_cast<const int32_t*>(off), static_cast<int32_t*>(out), nq, depth);
  return static_cast<int>(cudaGetLastError());
}
