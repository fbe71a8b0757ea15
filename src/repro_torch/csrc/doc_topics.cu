// Per-document lists of the non-zero topics of n_dk (sm_90a).
//
// Built once per launch of a sweep kernel (csrc/mhw_fused.cu, kernel 1;
// csrc/pdp_fused.cu, kernel 4) from the (D, K) n_dk that the launch reads,
// which is fixed within a chunk.  No TPU kernel computes it: the TPU sweeps
// read dense n_dk rows.  Its plain PyTorch version is
// src/repro_torch/kernels/ref.py::doc_topic_lists_ref; the layout is
// described in csrc/sweep_common.cuh.  Per document d, with W = ceil(K/32)
// + 1 words:
//   words[d, j] = {bits, pre}: bit i of `bits` is n_dk[d, 32j + i] != 0,
//     `pre` the number of such topics below 32j (word W-1: bits 0 and pre
//     the document's count of non-zero topics, k_d);
//   counts[d, q] = the q-th non-zero count in increasing topic order,
//     as a u16 when it is an integer in [0, 65535), else 0xffff (read
//     n_dk itself); entries from k_d on are not written.
//
// What bounds it on the card: bytes.  It reads n_dk once (D*K*4 B) and
// writes D*W*8 B of words and 2 B for each non-zero count.  At a client's
// 32768 x 1024 that is ~154 MB, ~46 us at 3.35 TB/s.
//
// What the design does about it: a read of n_dk at the byte rate needs
// ~20 KB in flight on every SM, so a warp, one document at a time, loads
// a whole batch of up to kBatch * 128 topics (4 KB at K = 1024) before its
// first ballot: lane l reads topics 128c + 4l .. +3 of pass c as one
// 16-byte load (rows that are not 16-byte aligned, K % 4 != 0, take four
// scalar loads in the same order).  Per pass, four ballots (one per
// element of the lanes' quadruples) give the pass's 128 bits:
//   * a lane's count slots: the non-zero topics below the pass (a running
//     total), plus those of the lower lanes (popcounts of the ballots under
//     the lane mask), plus its own lower elements; so each list is in
//     increasing topic order with no sort and no atomic.  The counts go to
//     a stage of the batch's slots in shared memory, and after the batch
//     the warp copies the stage out with adjacent lanes on adjacent slots:
//     2-byte stores scattered over a pass's four ballots took a quarter
//     of the kernel's time at K = 1024 on an H100 (PERF.md);
//   * word 4c + g of the batch interleaves byte g of the four ballots; lane
//     4c + g keeps it with its prefix, and after the batch lanes 0..31
//     store their words as one coalesced int2 store (the pad word rides
//     along in a lane of its own where the batch has one free).
// The capacity is K a document: the launch is given no document length and
// reads no size back to the host.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kPass = 128;           // topics a warp reads in one pass
constexpr int kBatch = 8;            // passes loaded before the first ballot
constexpr int kBatchTopics = kBatch * kPass;   // = 32 words, a lane each

// Bits 0..7 of x spread to bits 0, 4, ..., 28.
__device__ __forceinline__ unsigned spread4(unsigned x) {
  x &= 0xffu;
  x = (x | (x << 12)) & 0x000f000fu;
  x = (x | (x << 6)) & 0x03030303u;
  x = (x | (x << 3)) & 0x11111111u;
  return x;
}

template <bool kVec>
__device__ __forceinline__ float4 load_quad(const float* row, int t, int k) {
  if (kVec)
    return t < k ? __ldcs(reinterpret_cast<const float4*>(row + t))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 x;
  x.x = t < k ? __ldcs(row + t) : 0.f;
  x.y = t + 1 < k ? __ldcs(row + t + 1) : 0.f;
  x.z = t + 2 < k ? __ldcs(row + t + 2) : 0.f;
  x.w = t + 3 < k ? __ldcs(row + t + 3) : 0.f;
  return x;
}

__device__ __forceinline__ void put(uint16_t* stage, int& slot, float x) {
  if (x != 0.f) stage[slot++] = sweep::encode_count(x);
}

template <bool kVec>
__global__ void doc_topics_kernel(const float* __restrict__ n_dk, int d_total,
                                  int k, int2* __restrict__ words,
                                  uint16_t* __restrict__ counts) {
  __shared__ uint16_t stages[kWarpsPerBlock][kBatchTopics];
  const int lane = threadIdx.x & 31;
  const long d = (long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (d >= d_total) return;
  uint16_t* stage = stages[threadIdx.x >> 5];
  const int n_words = sweep::doc_words(k);
  const float* row = n_dk + d * k;
  int2* wrow = words + d * n_words;
  uint16_t* crow = counts + d * k;
  const unsigned below = (1u << lane) - 1u;
  const int g8 = 8 * (lane & 3);                 // the lane's word's byte
  const unsigned g_below = (1u << g8) - 1u;
  int pre = 0;
  for (int base = 0; base < k; base += kBatchTopics) {
    const int pre0 = pre;
    float4 x[kBatch];
#pragma unroll
    for (int c = 0; c < kBatch; ++c)
      x[c] = load_quad<kVec>(row, base + kPass * c + 4 * lane, k);
    unsigned wbits = 0;
    int wpre = 0;
#pragma unroll
    for (int c = 0; c < kBatch; ++c) {
      const unsigned b0 = __ballot_sync(sweep::kFull, x[c].x != 0.f);
      const unsigned b1 = __ballot_sync(sweep::kFull, x[c].y != 0.f);
      const unsigned b2 = __ballot_sync(sweep::kFull, x[c].z != 0.f);
      const unsigned b3 = __ballot_sync(sweep::kFull, x[c].w != 0.f);
      int slot = pre - pre0 + __popc(b0 & below) + __popc(b1 & below) +
                 __popc(b2 & below) + __popc(b3 & below);
      put(stage, slot, x[c].x);
      put(stage, slot, x[c].y);
      put(stage, slot, x[c].z);
      put(stage, slot, x[c].w);
      if ((lane >> 2) == c) {
        wbits = spread4(b0 >> g8) | spread4(b1 >> g8) << 1 |
                spread4(b2 >> g8) << 2 | spread4(b3 >> g8) << 3;
        wpre = pre + __popc(b0 & g_below) + __popc(b1 & g_below) +
               __popc(b2 & g_below) + __popc(b3 & g_below);
      }
      pre += __popc(b0) + __popc(b1) + __popc(b2) + __popc(b3);
    }
    __syncwarp();
    for (int i = lane; i < pre - pre0; i += 32) crow[pre0 + i] = stage[i];
    __syncwarp();
    const int batch_words = min(32, (k - base + 31) / 32);
    if (lane < batch_words)
      wrow[base / 32 + lane] = make_int2((int)wbits, wpre);
    else if (lane == batch_words)     // the last batch, with a lane free
      wrow[n_words - 1] = make_int2(0, pre);
  }
  // The pad word {0, k_d}, where no batch had a lane free for it.
  if (lane == 0 && (n_words - 1) % 32 == 0)
    wrow[n_words - 1] = make_int2(0, pre);
}

}  // namespace

extern "C" int doc_topic_lists(const float* n_dk, int d_total, int k,
                               int2* words, uint16_t* counts, void* stream) {
  if (d_total > 0) {
    const int blocks = (d_total + kWarpsPerBlock - 1) / kWarpsPerBlock;
    // 16-byte loads only where every row starts on a 16-byte boundary.
    if (k % 4 == 0 && (reinterpret_cast<uintptr_t>(n_dk) & 15) == 0)
      doc_topics_kernel<true><<<blocks, kWarpsPerBlock * 32, 0,
                                (cudaStream_t)stream>>>(n_dk, d_total, k,
                                                        words, counts);
    else
      doc_topics_kernel<false><<<blocks, kWarpsPerBlock * 32, 0,
                                 (cudaStream_t)stream>>>(n_dk, d_total, k,
                                                         words, counts);
  }
  return (int)cudaGetLastError();
}
