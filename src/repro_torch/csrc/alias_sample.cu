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
// cost: 4-byte reads scattered over the (V, K) tables.
//
// What the design does about it.  One thread per draw, adjacent threads
// on adjacent draws, so the stream reads and the write are coalesced; the
// alias entry is read only when the coin rejects the slot.  The TPU
// kernels staged (tile_v, K) table tiles in VMEM, the sorted one skipping
// tiles with no resident draws through the scalar-prefetched
// vstart/vcount window; here a thread reads its own entries and nothing
// is staged, so both variants are this one kernel.  In a sorted stream
// neighbouring draws share a row, so their gathers fall in the same few
// cache lines; an unsorted stream pays a sector per gather.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void alias_sample_kernel(const float* __restrict__ prob,
                                    const int* __restrict__ alias,
                                    const int* __restrict__ rows,
                                    const int* __restrict__ slot,
                                    const float* __restrict__ coin, long b,
                                    int v, int k, int* __restrict__ out) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= b) return;
  const int r = rows[i];
  if (r < 0 || r >= v) {
    out[i] = 0;
    return;
  }
  const int s = slot[i];
  const long at = (long)r * k + s;
  out[i] = coin[i] < prob[at] ? s : alias[at];
}

int launch_draws(const float* prob, const int* alias, const int* rows,
                 const int* slot, const float* coin, long b, int v, int k,
                 int* out, void* stream) {
  if (b > 0)
    alias_sample_kernel<<<(unsigned)((b + kThreads - 1) / kThreads),
                          kThreads, 0, (cudaStream_t)stream>>>(
        prob, alias, rows, slot, coin, b, v, k, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Two entries so that the wrappers count their launches apart.
extern "C" int alias_sample(const float* prob, const int* alias,
                            const int* rows, const int* slot,
                            const float* coin, long b, int v, int k,
                            int* out, void* stream) {
  return launch_draws(prob, alias, rows, slot, coin, b, v, k, out, stream);
}

extern "C" int alias_sample_sorted(const float* prob, const int* alias,
                                   const int* rows, const int* slot,
                                   const float* coin, long b, int v, int k,
                                   int* out, void* stream) {
  return launch_draws(prob, alias, rows, slot, coin, b, v, k, out, stream);
}
