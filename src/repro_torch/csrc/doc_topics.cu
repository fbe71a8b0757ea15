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
// writes D*W*8 B of words and 2 B for each non-zero count.
//
// Design: one warp per document; lane i reads topic 32j + i (coalesced),
// a ballot gives the word's bits, and each lane with a non-zero count
// writes it at pre + the number of set bits below it, so the list is in
// increasing topic order without a sort or an atomic.  The capacity is K a
// document: the launch is given no document length and reads no size back
// to the host.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void doc_topics_kernel(const float* __restrict__ n_dk, int d_total,
                                  int k, int2* __restrict__ words,
                                  uint16_t* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const long d = (long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (d >= d_total) return;
  const int n_words = sweep::doc_words(k);
  const float* row = n_dk + d * k;
  int2* wrow = words + d * n_words;
  uint16_t* crow = counts + d * k;
  int pre = 0;
  for (int j = 0; j < n_words - 1; ++j) {
    const int t = 32 * j + lane;
    const float x = t < k ? row[t] : 0.f;
    const bool nz = x != 0.f;
    const unsigned bits = __ballot_sync(sweep::kFull, nz);
    if (nz)
      crow[pre + __popc(bits & ((1u << lane) - 1u))] = sweep::encode_count(x);
    if (lane == 0) wrow[j] = make_int2((int)bits, pre);
    pre += __popc(bits);
  }
  if (lane == 0) wrow[n_words - 1] = make_int2(0, pre);
}

}  // namespace

extern "C" int doc_topic_lists(const float* n_dk, int d_total, int k,
                               int2* words, uint16_t* counts, void* stream) {
  if (d_total > 0) {
    const int blocks = (d_total + kWarpsPerBlock - 1) / kWarpsPerBlock;
    doc_topics_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                        (cudaStream_t)stream>>>(n_dk, d_total, k, words,
                                                counts);
  }
  return (int)cudaGetLastError();
}
