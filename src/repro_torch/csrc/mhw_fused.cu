// Fused MHW sweep over one token-sorted chunk, LDA/HDP (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/mhw_fused.py::mhw_sweep_fused (_mhw_fused_kernel)
// whose math is src/repro/core/mhw.py::sorted_chain / mix_chain; the plain
// PyTorch version is src/repro_torch/core/mhw.py::sorted_chain.  Per token
// b (row r = rows[b] < V; padding rows keep z0):
//   own_k = [k == z0]; ndk_k = n_dk[docs[b], k] - own_k;
//   lm_k = (n_wk[r,k] - own_k + beta) / (n_k[k] - own_k + beta_bar);
//   w_k = ndk_k * lm_k; cdf = cumsum(w); then mh_steps of
//   alias draw (slot, coin), inverse-CDF draw #(cdf <= u*cdf[K-1]),
//   mixture pick, and the eq. 7 accept against the stale row.
//
// What bounds it on the card.  Bytes: each token reads its document's
// n_dk row (K floats) and its word's n_wk row, plus point gathers of
// prob/alias/stale/n_wk/n_dk at the slot and candidate topics.  At the
// main path's shapes (K = 1024, ~2M tokens a chunk) the n_dk rows alone
// are ~8 GB a chunk, so the kernel is bound by memory traffic; n_wk rows
// repeat across neighbouring tokens (the stream is sorted by word), so
// they mostly come from L2.
//
// What the design does about it.
//   * One warp per token; neighbouring warps hold neighbouring tokens of
//     the sorted stream, i.e. the same word, so they share n_wk/prob/alias/
//     stale rows in L2.
//   * n_dk is read in place through `docs`: the (B, K) gathered matrix the
//     TPU path materialises (~8.6 GB a chunk at the main path's size) is
//     never written.
//   * The K-lane pass is coalesced (k = lane + 32 t) into shared memory,
//     stored so that lane l owns the contiguous block [l*C, (l+1)*C) with
//     C = ceil(K/32) (stride C+1, no bank conflicts).  Each lane sums its
//     block sequentially, a warp scan gives each block's offset, and each
//     lane rewrites its block as the running cumulative sum from that
//     offset.  Within a block the sum is the sequential cumsum; only the
//     32 block offsets are summed in another order than a sequential
//     cumsum, so a draw whose target lies within rounding of a cdf step
//     can differ from the plain version.  The tests state that rate.
//   * Each MH step counts cdf <= target per lane and reduces over the
//     warp; the point values at a candidate are recomputed with the same
//     float operations as the K-lane pass.  Built with --fmad=false, so
//     no product is fused into an add the plain version rounds apart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr float kEps = 1e-30f;

struct Token {
  const float* nd;   // document row of n_dk
  const float* nw;   // word row of n_wk
  const float* nk;
  const float* prior;
  const float* stale;
  int z0;
  float beta, beta_bar;

  __device__ __forceinline__ float ndk(int t) const {
    return nd[t] - (t == z0 ? 1.f : 0.f);
  }
  __device__ __forceinline__ float lm(int t) const {
    const float own = t == z0 ? 1.f : 0.f;
    return (nw[t] - own + beta) / (nk[t] - own + beta_bar);
  }
  __device__ __forceinline__ float log_p(int t) const {
    return logf(ndk(t) + prior[t] + kEps) + logf(lm(t) + kEps);
  }
  __device__ __forceinline__ float log_q(int t) const {
    return logf(ndk(t) * lm(t) + stale[t] + kEps);
  }
};

__global__ void mhw_sweep_kernel(
    const float* __restrict__ prob, const int* __restrict__ alias,
    const float* __restrict__ mass, const float* __restrict__ stale,
    const float* __restrict__ n_wk, const float* __restrict__ n_k,
    const float* __restrict__ prior, const int* __restrict__ rows,
    const int* __restrict__ docs, const int* __restrict__ z0,
    const float* __restrict__ n_dk, const int* __restrict__ slot,
    const float* __restrict__ coin, const float* __restrict__ u_mix,
    const float* __restrict__ u_sparse, const float* __restrict__ u_acc,
    int* __restrict__ out, int v, int k, long b_total, int steps,
    float beta, float beta_bar) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long b = (long)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= b_total) return;
  const int r = rows[b];
  const int z_init = z0[b];
  if (r < 0 || r >= v) {              // padding keeps its state
    if (lane == 0) out[b] = z_init;
    return;
  }
  const int c = (k + 31) / 32;
  float* cdf = smem + warp * 32 * (c + 1);
  const long rk = (long)r * k;
  Token tok{n_dk + (long)docs[b] * k, n_wk + rk, n_k, prior, stale + rk,
            z_init, beta, beta_bar};

  // K-lane pass: sparse weights, coalesced, into per-lane blocks.
  for (int t = lane; t < k; t += 32)
    cdf[(t / c) * (c + 1) + t % c] = tok.ndk(t) * tok.lm(t);
  __syncwarp();

  float* blk = cdf + lane * (c + 1);
  const int n = max(0, min(c, k - lane * c));
  float tot = 0.f;
  for (int j = 0; j < n; ++j) tot += blk[j];
  float incl = tot;
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  float run = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) run = 0.f;
  for (int j = 0; j < n; ++j) {
    run += blk[j];
    blk[j] = run;
  }
  const float sparse_mass = __shfl_sync(kFull, run, (k - 1) / c);
  const float dense_mass = mass[r];
  __syncwarp();

  int z = z_init;
  float lp_z = tok.log_p(z), lq_z = tok.log_q(z);
  for (int s = 0; s < steps; ++s) {
    const long o = (long)s * b_total + b;
    const int sl = slot[o];
    const int dense_draw = coin[o] < prob[rk + sl] ? sl : alias[rk + sl];
    const float target = u_sparse[o] * sparse_mass;
    int cnt = 0;
    for (int j = 0; j < n; ++j) cnt += blk[j] <= target;
    cnt = __reduce_add_sync(kFull, cnt);
    const int sparse_draw = min(max(cnt, 0), k - 1);
    const bool pick_sparse =
        u_mix[o] * (sparse_mass + dense_mass) < sparse_mass;
    const int cand = pick_sparse ? sparse_draw : dense_draw;
    const float lp_c = tok.log_p(cand), lq_c = tok.log_q(cand);
    if (logf(u_acc[o] + kEps) < lp_c - lp_z + lq_z - lq_c) {
      z = cand;
      lp_z = lp_c;
      lq_z = lq_c;
    }
  }
  if (lane == 0) out[b] = z;
}

}  // namespace

extern "C" int mhw_sweep_fused(
    const float* prob, const int* alias, const float* mass,
    const float* stale, const float* n_wk, const float* n_k,
    const float* prior, const int* rows, const int* docs, const int* z0,
    const float* n_dk, const int* slot, const float* coin,
    const float* u_mix, const float* u_sparse, const float* u_acc, int* out,
    int v, int k, long b_total, int steps, float beta, float beta_bar,
    void* stream) {
  const size_t smem =
      sizeof(float) * (size_t)kWarpsPerBlock * 32 * ((k + 31) / 32 + 1);
  cudaError_t err = cudaFuncSetAttribute(
      mhw_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (b_total > 0) {
    const long blocks = (b_total + kWarpsPerBlock - 1) / kWarpsPerBlock;
    mhw_sweep_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, smem,
                       (cudaStream_t)stream>>>(
        prob, alias, mass, stale, n_wk, n_k, prior, rows, docs, z0, n_dk,
        slot, coin, u_mix, u_sparse, u_acc, out, v, k, b_total, steps, beta,
        beta_bar);
  }
  return (int)cudaGetLastError();
}
