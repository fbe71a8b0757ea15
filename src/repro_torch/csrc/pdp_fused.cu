// Fused MHW sweep over one token-sorted chunk, PDP (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/mhw_fused.py::pdp_sweep_fused (_pdp_fused_kernel)
// whose math is src/repro/core/pdp.py::sorted_chain_pdp; the plain PyTorch
// version is src/repro_torch/core/pdp.py::sorted_chain_pdp.  The chain runs
// over E = 2K joint outcomes e = t + K*r (topic t, table-open indicator r).
// Per token b (row w = rows[b] < V; padding rows keep e0), with
// own_t = [t == e0 % K] and own_r = own_t * [e0 >= K]:
//   m = m_wk[w,t] - own_t; s = s_wk[w,t] - own_r;
//   s = m > 0 ? max(s, 1) : 0; s = min(s, m)              (CRP repair)
//   log_f(t, 0), log_f(t, 1) from paper eqs. 5-6 with the aggregates
//   m_k[t] - own_t, s_k[t] - own_r and log-Stirling ratios;
//   ndk_t = n_dk[docs[b], t] - own_t; sparse weight ndk_t * exp(log_f(e));
//   cdf over the 2K weights; then mh_steps of alias draw (slot in [0, 2K),
//   coin), inverse-CDF draw, mixture pick and the eq. 7 accept with
//   log p(e) = log(ndk_t + prior[e] + 1e-30) + log_f(e) and
//   log q(e) = log(sparse_w(e) + stale[w, e] + 1e-30).
//
// What bounds it on the card.  Bytes: each token reads its document's n_dk
// row and its word's m_wk and s_wk rows (rows repeat across neighbouring
// tokens of the sorted stream and come from L2), plus point reads of
// prob/alias/stale.  Operations: the log factors of a (word, topic) cell
// differ between tokens only at the token's own topic, so the function
// needs them once per distinct word, and per token only the 2K weights,
// their cdf and the chain; at the main path's shapes that work is below
// the bytes' bound.  This kernel evaluates the factors per token (seven
// logf, two expf, four Stirling-table reads and some twenty float
// operations per topic; precise logf and expf are tens of instructions
// each), so its arithmetic, not the bound, sets its time.
//
// What the design does about it (a first, simple kernel).
//   * One warp per token, four warps a block, as in mhw_fused.cu:
//     neighbouring warps hold the same word, so the m_wk/s_wk rows and the
//     prob/alias/stale entries of that word come from L2.  n_dk is read in
//     place through `docs`; the (B, K) gathered rows the TPU path stages
//     are never written.
//   * The K-lane pass (t = lane + 32 j) writes both weights of topic t, at
//     e = t and e = t + K, into the blocked cdf layout of mhw_fused.cu
//     (lane l owns [l*C, (l+1)*C), C = ceil(2K/32), stride C+1).  Within a
//     block the cdf is the sequential sum; only the 32 block offsets come
//     from a warp scan, the one place where the kernel rounds otherwise
//     than the plain version's left-to-right cumsum.
//   * The log factors at the current state and the candidates are
//     recomputed by the same function as in the pass, so they are
//     bit-equal to the pass's values: no second 2K-wide buffer in shared
//     memory.
//   * The Stirling table ((n_max+1)^2 floats, about 1 MB at n_max = 512)
//     does not fit in shared memory; it is read through the read-only path
//     and stays in L2.  Most (word, topic) cells have m = s = 0, so the
//     lookups mostly hit the same few lines.
//   * Every float operation is the plain version's, in its order (built
//     with --fmad=false, precise logf/expf, NaN-propagating max/min as in
//     torch.clamp_min/torch.minimum); the clamps are taken in float and then
//     truncated to int, as torch.clamp(...).to(int64) does, so the -1e30
//     entries and the clamp at counts above n_max flow through unchanged.
//   * Offsets into the (V, 2K) and (V, K) tables are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr float kEps = 1e-30f;

// torch.maximum / torch.clamp_min / torch.minimum return NaN when either
// operand is NaN; fmaxf and fminf would drop it.
__device__ __forceinline__ float max_nan(float x, float y) {
  return (x != x || y != y) ? x + y : fmaxf(x, y);
}
__device__ __forceinline__ float min_nan(float x, float y) {
  return (x != x || y != y) ? x + y : fminf(x, y);
}

// clamp to [0, hi] in float, then truncate to int.
__device__ __forceinline__ int clip_int(float x, int hi) {
  return (int)fminf(fmaxf(x, 0.f), (float)hi);
}

struct PdpToken {
  const float* mw;     // word row of m_wk
  const float* sw;     // word row of s_wk
  const float* nd;     // document row of n_dk
  const float* mk;
  const float* sk;
  const float* prior;  // (2K,)
  const float* stale;  // word row of stale, 2K wide
  const float* stirl;  // log-Stirling table, read through __ldg
  int sdim;            // the Stirling table is sdim x sdim
  int k;
  int z0;
  float r0;            // 1 if the token's state opened a table, else 0
  float b, a, gamma, gamma_bar;

  __device__ __forceinline__ float own(int t) const {
    return t == z0 ? 1.f : 0.f;
  }
  __device__ __forceinline__ float ndk(int t) const { return nd[t] - own(t); }

  __device__ __forceinline__ float stirl_at(int n, int m) const {
    return __ldg(stirl + (long)n * sdim + m);
  }

  // log_f(t, r=0) and log_f(t, r=1), pdp.log_factors on corrected rows.
  __device__ void log_f(int t, float& f0, float& f1) const {
    const float ot = own(t);
    const float orr = ot * r0;
    const float m = mw[t] - ot;
    float s = sw[t] - orr;
    s = m > 0.f ? max_nan(s, 1.f) : 0.f;
    s = min_nan(s, m);
    const float mk_t = mk[t] - ot;
    const float sk_t = sk[t] - orr;
    const float log_denom = logf(b + mk_t);
    const float occ = max_nan(m + 1.f - s, 0.f);
    const float log_m1 = logf(m + 1.f);
    const int hi = sdim - 2;
    const int n_c = clip_int(m, hi);
    const int s_same = clip_int(s, hi + 1);
    const int s_incr = clip_int(s, hi);
    const float ratio_same =
        stirl_at(n_c + 1, s_same) - stirl_at(n_c, s_same);
    const float ratio_incr =
        stirl_at(n_c + 1, s_incr + 1) - stirl_at(n_c, s_incr);
    f0 = logf(occ + kEps) - log_m1 + ratio_same - log_denom;
    f1 = logf(b + a * sk_t) - log_denom + logf(s + 1.f) - log_m1 +
         logf(gamma + s) - logf(gamma_bar + sk_t) + ratio_incr;
  }

  // log p(e) and log q(e) at one outcome, from the same values as the pass.
  __device__ void point(int e, float& lp, float& lq) const {
    const int t = e < k ? e : e - k;
    float f0, f1;
    log_f(t, f0, f1);
    const float lf = e < k ? f0 : f1;
    const float d = ndk(t);
    lp = logf(d + prior[e] + kEps) + lf;
    lq = logf(d * expf(lf) + stale[e] + kEps);
  }
};

__global__ void pdp_sweep_kernel(
    const float* __restrict__ prob, const int* __restrict__ alias,
    const float* __restrict__ mass, const float* __restrict__ stale,
    const float* __restrict__ m_wk, const float* __restrict__ s_wk,
    const float* __restrict__ m_k, const float* __restrict__ s_k,
    const float* __restrict__ stirl, const float* __restrict__ prior,
    const int* __restrict__ rows, const int* __restrict__ docs,
    const int* __restrict__ e0, const float* __restrict__ n_dk,
    const int* __restrict__ slot, const float* __restrict__ coin,
    const float* __restrict__ u_mix, const float* __restrict__ u_sparse,
    const float* __restrict__ u_acc, int* __restrict__ out, int v, int k,
    long b_total, int steps, int sdim, float b, float a, float gamma,
    float gamma_bar) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long bi = (long)blockIdx.x * kWarpsPerBlock + warp;
  if (bi >= b_total) return;
  const int w = rows[bi];
  const int e_init = e0[bi];
  if (w < 0 || w >= v) {              // padding keeps its state
    if (lane == 0) out[bi] = e_init;
    return;
  }
  const int n_out = 2 * k;
  const int c = (n_out + 31) / 32;
  float* cdf = smem + warp * 32 * (c + 1);
  const long wk = (long)w * k;
  const long we = (long)w * n_out;
  const PdpToken tok{m_wk + wk, s_wk + wk, n_dk + (long)docs[bi] * k,
                     m_k, s_k, prior, stale + we, stirl, sdim, k,
                     e_init % k, e_init >= k ? 1.f : 0.f,
                     b, a, gamma, gamma_bar};

  // K-lane pass: both sparse weights of each topic, into per-lane blocks.
  for (int t = lane; t < k; t += 32) {
    float f0, f1;
    tok.log_f(t, f0, f1);
    const float d = tok.ndk(t);
    cdf[(t / c) * (c + 1) + t % c] = d * expf(f0);
    const int e1 = t + k;
    cdf[(e1 / c) * (c + 1) + e1 % c] = d * expf(f1);
  }
  __syncwarp();

  float* blk = cdf + lane * (c + 1);
  const int n = max(0, min(c, n_out - lane * c));
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
  const float sparse_mass = __shfl_sync(kFull, run, (n_out - 1) / c);
  const float dense_mass = mass[w];
  __syncwarp();

  int e = e_init;
  float lp_z, lq_z;
  tok.point(e, lp_z, lq_z);
  for (int s = 0; s < steps; ++s) {
    const long o = (long)s * b_total + bi;
    const int sl = slot[o];
    const int dense_draw = coin[o] < prob[we + sl] ? sl : alias[we + sl];
    const float target = u_sparse[o] * sparse_mass;
    int cnt = 0;
    for (int j = 0; j < n; ++j) cnt += blk[j] <= target;
    cnt = __reduce_add_sync(kFull, cnt);
    const int sparse_draw = min(max(cnt, 0), n_out - 1);
    const bool pick_sparse =
        u_mix[o] * (sparse_mass + dense_mass) < sparse_mass;
    const int cand = pick_sparse ? sparse_draw : dense_draw;
    float lp_c, lq_c;
    tok.point(cand, lp_c, lq_c);
    if (logf(u_acc[o] + kEps) < lp_c - lp_z + lq_z - lq_c) {
      e = cand;
      lp_z = lp_c;
      lq_z = lq_c;
    }
  }
  if (lane == 0) out[bi] = e;
}

}  // namespace

extern "C" int pdp_sweep_fused(
    const float* prob, const int* alias, const float* mass,
    const float* stale, const float* m_wk, const float* s_wk,
    const float* m_k, const float* s_k, const float* stirl,
    const float* prior, const int* rows, const int* docs, const int* e0,
    const float* n_dk, const int* slot, const float* coin,
    const float* u_mix, const float* u_sparse, const float* u_acc, int* out,
    int v, int k, long b_total, int steps, int sdim, float b, float a,
    float gamma, float gamma_bar, void* stream) {
  const size_t smem =
      sizeof(float) * (size_t)kWarpsPerBlock * 32 * ((2 * k + 31) / 32 + 1);
  cudaError_t err = cudaFuncSetAttribute(
      pdp_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (b_total > 0) {
    const long blocks = (b_total + kWarpsPerBlock - 1) / kWarpsPerBlock;
    pdp_sweep_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, smem,
                       (cudaStream_t)stream>>>(
        prob, alias, mass, stale, m_wk, s_wk, m_k, s_k, stirl, prior, rows,
        docs, e0, n_dk, slot, coin, u_mix, u_sparse, u_acc, out, v, k,
        b_total, steps, sdim, b, a, gamma, gamma_bar);
  }
  return (int)cudaGetLastError();
}
