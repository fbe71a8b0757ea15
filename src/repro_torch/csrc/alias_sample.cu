// Alias-table draws for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   src/repro/kernels/alias_sample.py::alias_sample_sorted  (kernel 7)
//   src/repro/kernels/alias_sample.py::alias_sample         (kernel 8)
// Both compute, per draw b: out[b] = slot[b] if coin[b] < prob[row, slot]
// else alias[row, slot], with row = rows[b], and 0 for rows outside
// [0, V) (the sorted layout's padding sentinels, which the TPU kernels
// leave at their zero-initialised output).
//
// What bounds it on the card.  Bytes: rows, slot and coin in, the draw
// out, and one prob and at most one alias entry gathered per draw, 24
// bytes a draw at most; no arithmetic to speak of.  The gathers are the
// cost: 4-byte reads scattered over the (V, K) tables, each of which moves
// a whole 32-byte sector, so the floor the card can reach is the streams
// plus 32 bytes a distinct (row, sector) gathered.
//
// Kernel 7 (alias_sample_sorted_kernel), for the token-sorted stream:
// one thread per draw, adjacent threads on adjacent draws, so the streams
// are read and the draws written as whole lines a warp (evict-first, as
// kernel 8's); slot and coin are read only for a real row, so the
// sentinel tail reads its rows alone, and the alias entry only when the
// coin rejects the slot.  The TPU kernel staged (tile_v, K) table tiles in
// VMEM through its scalar-prefetched vstart/vcount window; here a thread
// reads its own entries and nothing is staged.  In a sorted stream a
// warp's draws share one or two rows, whose sectors many draws read, so
// the long runs' gathers hit L1 and L2; the short runs' gathers, 32-byte
// sectors missed to device memory at random, bound the kernel.  Staging
// the long runs' rows in shared memory was tried and ran slower on an
// NVIDIA H100 (PERF.md, "Designs tried" for kernel 7).
//
// Kernel 8 (alias_sample_batch_kernel), for an unsorted stream, where
// every gather is a sector of its own: a thread takes kDraws adjacent
// draws, loads their rows, slots and coins as 16-byte vectors marked
// evict-first (so the streams do not push table sectors out of L2), then
// issues all of its prob gathers before it compares any, then the alias
// gathers of the rejected draws together, and writes the draws as one
// evict-first vector.  Three round trips to memory a thread, as kernel 7
// makes, but each carries kDraws gathers, so a quarter of the threads keep
// the same gathers in flight.  Sentinels write 0 and gather nothing; a
// ragged tail, or streams not on 16-byte boundaries, take scalar loads.
// On an NVIDIA H100 80GB HBM3 (700 W; PERF.md) the scattered reads, not
// their sectors, bound it: one PyTorch gather of the prob entries alone
// (1.58 M reads of a 512 MB table in this order) runs at ~5e10 reads a
// second, kernel 8 at ~4e10 (2.45 M prob and alias reads), whether a
// thread takes 1, 4 or 8 draws.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void alias_sample_sorted_kernel(const float* __restrict__ prob,
                                           const int* __restrict__ alias,
                                           const int* __restrict__ rows,
                                           const int* __restrict__ slot,
                                           const float* __restrict__ coin,
                                           long b, int v, int k,
                                           int* __restrict__ out) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= b) return;
  const int r = __ldcs(rows + i);
  if (r < 0 || r >= v) {
    __stcs(out + i, 0);
    return;
  }
  const int s = __ldcs(slot + i);
  const long at = (long)r * k + s;
  __stcs(out + i, __ldcs(coin + i) < __ldg(prob + at) ? s : __ldg(alias + at));
}

constexpr int kDraws = 4;          // a multiple of 4: whole int4 vectors

template <bool kVec>
__global__ void alias_sample_batch_kernel(const float* __restrict__ prob,
                                          const int* __restrict__ alias,
                                          const int* __restrict__ rows,
                                          const int* __restrict__ slot,
                                          const float* __restrict__ coin,
                                          long b, int v, int k,
                                          int* __restrict__ out) {
  const long i0 = ((long)blockIdx.x * kThreads + threadIdx.x) * kDraws;
  if (i0 >= b) return;
  const bool whole = kVec && i0 + kDraws <= b;
  int r[kDraws], s[kDraws], o[kDraws];
  float u[kDraws], p[kDraws];
  if (whole) {
#pragma unroll
    for (int q = 0; q < kDraws; q += 4) {
      const int4 rv = __ldcs(reinterpret_cast<const int4*>(rows + i0 + q));
      const int4 sv = __ldcs(reinterpret_cast<const int4*>(slot + i0 + q));
      const float4 uv =
          __ldcs(reinterpret_cast<const float4*>(coin + i0 + q));
      r[q] = rv.x, r[q + 1] = rv.y, r[q + 2] = rv.z, r[q + 3] = rv.w;
      s[q] = sv.x, s[q + 1] = sv.y, s[q + 2] = sv.z, s[q + 3] = sv.w;
      u[q] = uv.x, u[q + 1] = uv.y, u[q + 2] = uv.z, u[q + 3] = uv.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kDraws; ++e) {
      const bool in = i0 + e < b;
      r[e] = in ? __ldcs(rows + i0 + e) : -1;
      s[e] = in ? __ldcs(slot + i0 + e) : 0;
      u[e] = in ? __ldcs(coin + i0 + e) : 0.f;
    }
  }
  long at[kDraws];
  bool real[kDraws];
#pragma unroll
  for (int e = 0; e < kDraws; ++e) {
    real[e] = r[e] >= 0 && r[e] < v;
    at[e] = real[e] ? (long)r[e] * k + s[e] : 0;
    p[e] = real[e] ? __ldg(prob + at[e]) : 0.f;
  }
  int al[kDraws];
#pragma unroll
  for (int e = 0; e < kDraws; ++e)
    al[e] = real[e] && !(u[e] < p[e]) ? __ldg(alias + at[e]) : 0;
#pragma unroll
  for (int e = 0; e < kDraws; ++e)
    o[e] = !real[e] ? 0 : u[e] < p[e] ? s[e] : al[e];
  if (whole) {
#pragma unroll
    for (int q = 0; q < kDraws; q += 4)
      __stcs(reinterpret_cast<int4*>(out + i0 + q),
             make_int4(o[q], o[q + 1], o[q + 2], o[q + 3]));
  } else {
#pragma unroll
    for (int e = 0; e < kDraws; ++e)
      if (i0 + e < b) __stcs(out + i0 + e, o[e]);
  }
}

bool aligned16(const void* a, const void* b, const void* c, const void* d) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) &
          15) == 0;
}

}  // namespace

extern "C" int alias_sample(const float* prob, const int* alias,
                            const int* rows, const int* slot,
                            const float* coin, long b, int v, int k,
                            int* out, void* stream) {
  if (b > 0) {
    const long threads = (b + kDraws - 1) / kDraws;
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    if (aligned16(rows, slot, coin, out))
      alias_sample_batch_kernel<true><<<blocks, kThreads, 0,
                                        (cudaStream_t)stream>>>(
          prob, alias, rows, slot, coin, b, v, k, out);
    else
      alias_sample_batch_kernel<false><<<blocks, kThreads, 0,
                                         (cudaStream_t)stream>>>(
          prob, alias, rows, slot, coin, b, v, k, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int alias_sample_sorted(const float* prob, const int* alias,
                                   const int* rows, const int* slot,
                                   const float* coin, long b, int v, int k,
                                   int* out, void* stream) {
  if (b > 0)
    alias_sample_sorted_kernel<<<(unsigned)((b + kThreads - 1) / kThreads),
                                 kThreads, 0, (cudaStream_t)stream>>>(
        prob, alias, rows, slot, coin, b, v, k, out);
  return (int)cudaGetLastError();
}
