// Fused MHW sweep over one token-sorted chunk, LDA/HDP (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/mhw_fused.py:153 mhw_sweep_fused (_mhw_fused_kernel)
// whose math is src/repro/core/mhw.py::sorted_chain / mix_chain; the plain
// PyTorch version is src/repro_torch/core/mhw.py::sorted_chain.  Per token
// b (row r = rows[b] < V; padding rows keep z0):
//   own_k = [k == z0]; ndk_k = n_dk[docs[b], k] - own_k;
//   lm_k = (n_wk[r,k] - own_k + beta) / (n_k[k] - own_k + beta_bar);
//   w_k = ndk_k * lm_k; cdf = cumsum(w); then mh_steps of
//   alias draw (slot, coin), inverse-CDF draw #(cdf <= u*cdf[K-1]),
//   mixture pick, and the eq. 7 accept against the stale row.
//
// What bounds it on the card.  The function needs the language-model row
// once per distinct word (it differs between a word's tokens only at the
// token's own topic) and, per token, only the weights at the document's
// non-zero topics: k_d of K, about a fifth at the main path's shapes
// (K = 1024, documents of 256 tokens).  Its bytes are the word rows, the
// document rows and the point reads of the tables; those bound it.  The
// dense design before this one (one warp a token) recomputed the K-wide
// row for every token (K divisions) and read each token's full n_dk row
// (4 KB; ~8.6 GB a 2M-token chunk), so that per-token K-wide work, not the
// bound, set its time.
//
// What the design does about it (see csrc/sweep_common.cuh).
//   * A block of four warps owns a tile of 128 consecutive positions and
//     splits it into runs of one word.  For each run the block computes
//     lm_t with no own topic for all t into shared memory, once, and flags
//     the topics where lm_t is not finite (a zero count times it would not
//     be zero).  Each token then reads lm_t there and recomputes only its
//     own topic, by the same function with own = 1.  For t != own the
//     cached value is bit-equal to the per-token one (x - 0.f is x).
//   * n_dk is not read as rows: csrc/doc_topics.cu builds, once per
//     launch, each document's bitmap of non-zero topics and their counts
//     (~0.6 KB a document at the main path's k_d, in L2).  A token visits
//     the document's non-zero topics, the flagged ones and its own; every
//     other weight is exactly 0.
//   * The cdf keeps the dense design's 32 lane blocks (lane l owns topics
//     [l*C, (l+1)*C), C = ceil(K/32)), each summed left to right, block
//     offsets from a warp scan: skipping exact zeros changes no sum, so
//     every cdf value and draw is the dense design's, which differed from
//     the plain version's left-to-right cumsum on ~1e-5 of chains (a
//     target within rounding of a step).  Each MH step counts
//     cdf <= target over the visited topics and the runs of zero-weight
//     topics behind them.
//   * A step's candidate does not depend on the chain's state, only its
//     accept does: lane i forms step i's candidate and evaluates log p and
//     log q there (lane 16 at the initial state) in one pass, so the point
//     reads of n_dk, prior and stale of all steps are in flight together;
//     the accepts then run in order (sweep::mh_chain).  Built with
//     --fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace {

using sweep::kFull;
constexpr int kMaxWarps = 4;
using sweep::kEps;
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float lm_of(float nw, float nk, float own,
                                       float beta, float beta_bar) {
  return (nw - own + beta) / (nk - own + beta_bar);
}

size_t smem_bytes(int k, int warps) {
  const size_t t = 32 * warps, cap = (size_t)warps * sweep::kCap;
  return sizeof(float) * (k + sweep::doc_words(k) + 2 * t + 1 + warps + cap)
         + sizeof(uint16_t) * cap;
}

__global__ void mhw_sweep_kernel(
    const float* __restrict__ prob, const int* __restrict__ alias,
    const float* __restrict__ mass, const float* __restrict__ stale,
    const float* __restrict__ n_wk, const float* __restrict__ n_k,
    const float* __restrict__ prior, const int* __restrict__ rows,
    const int* __restrict__ docs, const int* __restrict__ z0,
    const float* __restrict__ n_dk, const int2* __restrict__ dwords,
    const uint16_t* __restrict__ dcounts, const int* __restrict__ slot,
    const float* __restrict__ coin, const float* __restrict__ u_mix,
    const float* __restrict__ u_sparse, const float* __restrict__ u_acc,
    int* __restrict__ out, int v, int k, long b_total, int steps,
    float beta, float beta_bar) {
  extern __shared__ float smem[];
  const int tpb = blockDim.x, warps = tpb >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_words = sweep::doc_words(k);
  const int cb = (k + 31) / 32;
  float* slm = smem;
  unsigned* sflag = reinterpret_cast<unsigned*>(slm + k);
  int* srow = reinterpret_cast<int*>(sflag + n_words);
  int* seg = srow + tpb;
  int* warp_n = seg + tpb + 1;
  float* ent_c = reinterpret_cast<float*>(warp_n + warps);
  uint16_t* ent_p = reinterpret_cast<uint16_t*>(ent_c + warps * sweep::kCap);

  const long base = (long)blockIdx.x * tpb;
  const int nt = (int)min((long)tpb, b_total - base);
  if (threadIdx.x == 0) sflag[n_words - 1] = 0u;
  const int nseg = sweep::tile_segments(rows, base, nt, srow, seg, warp_n);
  float* warp_c = ent_c + warp * sweep::kCap;
  uint16_t* warp_p = ent_p + warp * sweep::kCap;

  for (int sg = 0; sg < nseg; ++sg) {
    const int s0 = seg[sg], s1 = seg[sg + 1];
    const int r = srow[s0];
    if (r < 0 || r >= v) {              // padding keeps its state
      for (int q = s0 + threadIdx.x; q < s1; q += tpb)
        out[base + q] = z0[base + q];
      continue;
    }
    const long rk = (long)r * k;
    const float* nw = n_wk + rk;
    // The word's LM row with no own topic, and its non-finite entries.
    for (int j = warp; j < n_words - 1; j += warps) {
      const int t = 32 * j + lane;
      float x = 0.f;
      if (t < k) {
        x = lm_of(nw[t], n_k[t], 0.f, beta, beta_bar);
        slm[t] = x;
      }
      const unsigned bad = __ballot_sync(kFull, t < k && !isfinite(x));
      if (lane == 0) sflag[j] = bad;
    }
    __syncthreads();

    for (int q = s0 + warp; q < s1; q += warps) {
      const long b = base + q;
      const int z_init = z0[b];
      const long dd = docs[b];
      const float* nd = n_dk + dd * k;
      const int2* drow = dwords + dd * n_words;
      const uint16_t* crow = dcounts + dd * k;
      const float lm_own = lm_of(nw[z_init], n_k[z_init], 1.f, beta,
                                 beta_bar);
      auto lm = [&](int t) { return t == z_init ? lm_own : slm[t]; };
      auto ndk = [&](int t) { return nd[t] - (t == z_init ? 1.f : 0.f); };
      auto log_p = [&](int t) {
        return logf(ndk(t) + prior[t] + kEps) + logf(lm(t) + kEps);
      };
      auto log_q = [&](int t) {
        return logf(ndk(t) * lm(t) + stale[rk + t] + kEps);
      };

      auto cdf = sweep::lane_cdf(
          [&](int t, int n) {
            unsigned bits = sweep::topic_bits(drow, t, n)
                            | sweep::topic_bits(sflag, t, n);
            const unsigned o = (unsigned)(z_init - t);
            if (o < (unsigned)n) bits |= 1u << o;
            return bits;
          },
          [&](int t) {
            const float own = t == z_init ? 1.f : 0.f;
            return (sweep::doc_count(drow, crow, nd, t) - own) * lm(t);
          },
          warp_c, warp_p, sweep::kCap);
      const float sparse_mass = cdf.build(lane, cb, k);
      const float dense_mass = mass[r];

      const int z = sweep::mh_chain(
          lane, z_init, steps, b, b_total, slot, coin, u_mix, u_sparse, u_acc,
          sparse_mass, dense_mass, k, cdf,
          [&](int sl, float cn) {
            return cn < prob[rk + sl] ? sl : alias[rk + sl];
          },
          [&](int t, float& lp, float& lq) {
            lp = log_p(t);
            lq = log_q(t);
          });
      if (lane == 0) out[b] = z;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int mhw_sweep_fused(
    const float* prob, const int* alias, const float* mass,
    const float* stale, const float* n_wk, const float* n_k,
    const float* prior, const int* rows, const int* docs, const int* z0,
    const float* n_dk, const int2* dwords, const uint16_t* dcounts,
    const int* slot, const float* coin, const float* u_mix,
    const float* u_sparse, const float* u_acc, int* out, int v, int k,
    long b_total, int steps, float beta, float beta_bar, void* stream) {
  int warps = kMaxWarps;
  while (warps > 1 && smem_bytes(k, warps) > kMaxSmem) warps >>= 1;
  const size_t smem = smem_bytes(k, warps);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mhw_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (b_total > 0) {
    const long tile = 32L * warps;
    mhw_sweep_kernel<<<(unsigned)((b_total + tile - 1) / tile), 32 * warps,
                       smem, (cudaStream_t)stream>>>(
        prob, alias, mass, stale, n_wk, n_k, prior, rows, docs, z0, n_dk,
        dwords, dcounts, slot, coin, u_mix, u_sparse, u_acc, out, v, k,
        b_total, steps, beta, beta_bar);
  }
  return (int)cudaGetLastError();
}
