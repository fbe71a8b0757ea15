// Fused MHW sweep over one token-sorted chunk, PDP (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/mhw_fused.py:322 pdp_sweep_fused (_pdp_fused_kernel)
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
// What bounds it on the card.  The log factors of a (word, topic) cell
// differ between a word's tokens only at the token's own topic, so the
// function evaluates them once per distinct word; a cell whose m_wk is 0
// depends on the topic alone.  Per token it needs the weights at the
// document's non-zero topics (k_d of K, both outcomes) and the chain.  At
// the main path's shapes that work is below the bytes' bound: the word
// rows, the document rows and the point reads bound it.  The dense design
// before this one (one warp a token) evaluated all 2K factors for every
// token (seven logf, two expf, four Stirling reads and ~20 float
// operations a topic), ~37x its bound.
//
// What the design does about it (see csrc/sweep_common.cuh).
//   * A first launch evaluates, for each topic, the factors of a cell with
//     m_wk = 0 (then s is 0 whatever s_wk says, and the result is a
//     function of m_k[t], s_k[t] alone): 4K floats, read through L2.
//   * A block of eight warps (fewer where K leaves too little shared
//     memory; PERF.md compares four) owns a tile of 256 consecutive
//     positions and splits it into runs of one word.  For each run the
//     block builds into shared memory f0_t, f1_t and exp(f0_t), exp(f1_t)
//     for all t with no own topic: from the topic table where
//     m_wk[w,t] == 0, by log_f elsewhere (bit-equal either way), and flags
//     every topic whose exp(f) is not finite: a zero count times inf is
//     the plain version's NaN, which the cdf must keep (Stirling clamps
//     reach the table's -1e30 entries and make f0 = +1e30).  Each token
//     recomputes only its own topic, by the same log_f with own = 1.
//   * n_dk is not read as rows: csrc/doc_topics.cu's per-document bitmap
//     and counts give the non-zero topics.  A token visits, in each half
//     r = 0, 1, the document's topics, the half's flagged topics and its
//     own topic; every other weight is exactly 0.
//   * The cdf keeps the dense design's 32 lane blocks over the 2K outcomes
//     (C = ceil(2K/32)), each summed left to right, offsets from a warp
//     scan: every cdf value and draw is the dense design's (which differed
//     from the plain left-to-right cumsum on ~3e-5 of chains).  Each MH
//     step counts cdf <= target over the visited outcomes and the
//     zero-weight runs behind them.
//   * The MH steps run as in csrc/mhw_fused.cu: each step's candidate and
//     its log p, log q in a lane of its own, then the accepts in order.
//   * Every float operation is the plain version's, in its order (built
//     with --fmad=false, precise logf/expf, NaN-propagating max/min as in
//     torch.clamp_min/torch.minimum); the clamps are taken in float and then
//     truncated to int, as torch.clamp(...).to(int64) does.  The Stirling
//     table is read through the read-only path and stays in L2.  Offsets
//     into the (V, 2K) and (V, K) tables are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace {

using sweep::kFull;
constexpr int kMaxWarps = 8;
using sweep::kEps;
constexpr size_t kMaxSmem = 232448;

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

struct Pdp {
  const float* stirl;  // log-Stirling table, read through __ldg
  int sdim;            // the Stirling table is sdim x sdim
  float b, a, gamma, gamma_bar;

  __device__ __forceinline__ float stirl_at(int n, int m) const {
    return __ldg(stirl + (long)n * sdim + m);
  }

  // log_f(t, r=0) and log_f(t, r=1) of one cell, pdp.log_factors on the
  // corrected rows: mw, sw the word's counts, mk, sk the topic's, ot and
  // orr the own-token removal (0 or 1).
  __device__ void log_f(float mw, float sw, float mk, float sk, float ot,
                        float orr, float& f0, float& f1) const {
    const float m = mw - ot;
    float s = sw - orr;
    s = m > 0.f ? max_nan(s, 1.f) : 0.f;
    s = min_nan(s, m);
    const float mk_t = mk - ot;
    const float sk_t = sk - orr;
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
};

size_t smem_bytes(int k, int warps) {
  const size_t t = 32 * warps, cap = (size_t)warps * sweep::kCap;
  return sizeof(float) * (4 * (size_t)k + 2 * sweep::doc_words(k) + 2 * t
                            + 1 + warps + cap)
         + sizeof(uint16_t) * cap;
}

// Factors of an empty cell (m_wk = s_wk = 0) of each topic: tz = [f0 | f1 |
// exp(f0) | exp(f1)], each K wide.
__global__ void pdp_topic_kernel(const float* __restrict__ m_k,
                                 const float* __restrict__ s_k, Pdp pdp,
                                 int k, float* __restrict__ tz) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= k) return;
  float f0, f1;
  pdp.log_f(0.f, 0.f, m_k[t], s_k[t], 0.f, 0.f, f0, f1);
  tz[t] = f0;
  tz[k + t] = f1;
  tz[2 * k + t] = expf(f0);
  tz[3 * k + t] = expf(f1);
}

__global__ void pdp_sweep_kernel(
    const float* __restrict__ prob, const int* __restrict__ alias,
    const float* __restrict__ mass, const float* __restrict__ stale,
    const float* __restrict__ m_wk, const float* __restrict__ s_wk,
    const float* __restrict__ m_k, const float* __restrict__ s_k, Pdp pdp,
    const float* __restrict__ tz, const float* __restrict__ prior,
    const int* __restrict__ rows, const int* __restrict__ docs,
    const int* __restrict__ e0, const float* __restrict__ n_dk,
    const int2* __restrict__ dwords, const uint16_t* __restrict__ dcounts,
    const int* __restrict__ slot, const float* __restrict__ coin,
    const float* __restrict__ u_mix, const float* __restrict__ u_sparse,
    const float* __restrict__ u_acc, int* __restrict__ out, int v, int k,
    long b_total, int steps) {
  extern __shared__ float smem[];
  const int tpb = blockDim.x, warps = tpb >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_words = sweep::doc_words(k);
  const int n_out = 2 * k;
  const int cb = (n_out + 31) / 32;
  float* sf = smem;                     // [f0 | f1], 2K
  float* sx = smem + 2 * k;             // [exp(f0) | exp(f1)], 2K
  unsigned* flag0 = reinterpret_cast<unsigned*>(smem + 4 * k);
  unsigned* flag1 = flag0 + n_words;
  int* srow = reinterpret_cast<int*>(flag1 + n_words);
  int* seg = srow + tpb;
  int* warp_n = seg + tpb + 1;
  float* ent_c = reinterpret_cast<float*>(warp_n + warps);
  uint16_t* ent_p = reinterpret_cast<uint16_t*>(ent_c + warps * sweep::kCap);

  const long base = (long)blockIdx.x * tpb;
  const int nt = (int)min((long)tpb, b_total - base);
  if (threadIdx.x == 0) flag0[n_words - 1] = flag1[n_words - 1] = 0u;
  const int nseg = sweep::tile_segments(rows, base, nt, srow, seg, warp_n);
  float* warp_c = ent_c + warp * sweep::kCap;
  uint16_t* warp_p = ent_p + warp * sweep::kCap;

  for (int sg = 0; sg < nseg; ++sg) {
    const int s0 = seg[sg], s1 = seg[sg + 1];
    const int w = srow[s0];
    if (w < 0 || w >= v) {              // padding keeps its state
      for (int q = s0 + threadIdx.x; q < s1; q += tpb)
        out[base + q] = e0[base + q];
      continue;
    }
    const long wk = (long)w * k;
    const long we = (long)w * n_out;
    const float* mw = m_wk + wk;
    const float* sw = s_wk + wk;
    // The word's factors with no own topic, and the non-finite exp(f).
    for (int j = warp; j < n_words - 1; j += warps) {
      const int t = 32 * j + lane;
      float x0 = 0.f, x1 = 0.f;
      if (t < k) {
        const float mwt = mw[t];
        float f0, f1;
        if (mwt == 0.f) {
          f0 = tz[t];
          f1 = tz[k + t];
          x0 = tz[2 * k + t];
          x1 = tz[3 * k + t];
        } else {
          pdp.log_f(mwt, sw[t], m_k[t], s_k[t], 0.f, 0.f, f0, f1);
          x0 = expf(f0);
          x1 = expf(f1);
        }
        sf[t] = f0;
        sf[k + t] = f1;
        sx[t] = x0;
        sx[k + t] = x1;
      }
      const unsigned bad0 = __ballot_sync(kFull, t < k && !isfinite(x0));
      const unsigned bad1 = __ballot_sync(kFull, t < k && !isfinite(x1));
      if (lane == 0) {
        flag0[j] = bad0;
        flag1[j] = bad1;
      }
    }
    __syncthreads();

    for (int q = s0 + warp; q < s1; q += warps) {
      const long bi = base + q;
      const int e_init = e0[bi];
      const int zt = e_init % k;
      const long dd = docs[bi];
      const float* nd = n_dk + dd * k;
      const int2* drow = dwords + dd * n_words;
      const uint16_t* crow = dcounts + dd * k;
      // The own topic's factors with the token removed.
      float fo[2], xo[2];
      pdp.log_f(mw[zt], sw[zt], m_k[zt], s_k[zt], 1.f,
                1.f * (e_init >= k ? 1.f : 0.f), fo[0], fo[1]);
      xo[0] = expf(fo[0]);
      xo[1] = expf(fo[1]);
      auto lf = [&](int e) {
        const int r = e >= k, t = e - r * k;
        return t == zt ? fo[r] : sf[e];
      };
      auto xf = [&](int e) {
        const int r = e >= k, t = e - r * k;
        return t == zt ? xo[r] : sx[e];
      };
      auto ndk = [&](int t) { return nd[t] - (t == zt ? 1.f : 0.f); };
      auto point = [&](int e, float& lp, float& lq) {
        const float d = ndk(e < k ? e : e - k);
        lp = logf(d + prior[e] + kEps) + lf(e);
        lq = logf(d * xf(e) + stale[we + e] + kEps);
      };
      auto half_bits = [&](int t, int n, const unsigned* fl) {
        return sweep::topic_bits(drow, t, n) | sweep::topic_bits(fl, t, n);
      };

      auto cdf = sweep::lane_cdf(
          [&](int e, int n) {
            unsigned bits;
            if (e >= k) {
              bits = half_bits(e - k, n, flag1);
            } else if (e + n <= k) {
              bits = half_bits(e, n, flag0);
            } else {
              const int n1 = k - e;
              bits = half_bits(e, n1, flag0)
                     | (half_bits(0, n - n1, flag1) << n1);
            }
            unsigned o = (unsigned)(zt - e);
            if (o < (unsigned)n) bits |= 1u << o;
            o = (unsigned)(zt + k - e);
            if (o < (unsigned)n) bits |= 1u << o;
            return bits;
          },
          [&](int e) {
            const int t = e < k ? e : e - k;
            const float own = t == zt ? 1.f : 0.f;
            return (sweep::doc_count(drow, crow, nd, t) - own) * xf(e);
          },
          warp_c, warp_p, sweep::kCap);
      const float sparse_mass = cdf.build(lane, cb, n_out);
      const float dense_mass = mass[w];

      const int e = sweep::mh_chain(
          lane, e_init, steps, bi, b_total, slot, coin, u_mix, u_sparse,
          u_acc, sparse_mass, dense_mass, n_out, cdf,
          [&](int sl, float cn) {
            return cn < prob[we + sl] ? sl : alias[we + sl];
          },
          point);
      if (lane == 0) out[bi] = e;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int pdp_sweep_fused(
    const float* prob, const int* alias, const float* mass,
    const float* stale, const float* m_wk, const float* s_wk,
    const float* m_k, const float* s_k, const float* stirl,
    const float* prior, const int* rows, const int* docs, const int* e0,
    const float* n_dk, const int2* dwords, const uint16_t* dcounts,
    float* topic_scratch, const int* slot, const float* coin,
    const float* u_mix, const float* u_sparse, const float* u_acc, int* out,
    int v, int k, long b_total, int steps, int sdim, float b, float a,
    float gamma, float gamma_bar, void* stream) {
  int warps = kMaxWarps;
  while (warps > 1 && smem_bytes(k, warps) > kMaxSmem) warps >>= 1;
  const size_t smem = smem_bytes(k, warps);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pdp_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Pdp pdp{stirl, sdim, b, a, gamma, gamma_bar};
  if (b_total > 0) {
    pdp_topic_kernel<<<(k + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        m_k, s_k, pdp, k, topic_scratch);
    const long tile = 32L * warps;
    pdp_sweep_kernel<<<(unsigned)((b_total + tile - 1) / tile), 32 * warps,
                       smem, (cudaStream_t)stream>>>(
        prob, alias, mass, stale, m_wk, s_wk, m_k, s_k, pdp, topic_scratch,
        prior, rows, docs, e0, n_dk, dwords, dcounts, slot, coin, u_mix,
        u_sparse, u_acc, out, v, k, b_total, steps);
  }
  return (int)cudaGetLastError();
}
