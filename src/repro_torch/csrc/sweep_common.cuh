// Shared pieces of the sorted-layout sweep kernels (csrc/mhw_fused.cu,
// kernel 1; csrc/pdp_fused.cu, kernel 4) and of the document-list build
// (csrc/doc_topics.cu) that feeds them.
//
// Document lists.  For each document d, W = ceil(K/32) + 1 words
// {bits, pre}: bit i of word j says n_dk[d, 32j + i] != 0 and `pre` counts
// the non-zero topics below 32j; the last word has no bits and holds k_d.
// The q-th non-zero count in topic order is counts[d, q], a u16 when it is
// an integer in [0, 65535), else 0xffff, which sends the reader to n_dk.
//
// Tiles and segments.  A block of NW warps owns a tile of 32*NW
// consecutive positions of the sorted stream and splits it into segments
// of one word (equal consecutive rows); the block builds the word's
// factors once into shared memory and its warps then take the segment's
// tokens in turn.
//
// Lane blocks.  A token's E outcomes are cut into 32 blocks of
// C = ceil(E/32), lane l owning [l*C, (l+1)*C), as in the dense design
// (one warp a token, all E outcomes).  A lane visits only the outcomes of
// its block whose weight can be non-zero (given by a bit mask), sums their
// weights left to right, a warp scan of the 32 block totals gives each
// block's offset, and the warp keeps the running sums (the cdf) and the
// positions of the visited outcomes.  An outcome that is not visited has
// weight exactly 0 (it adds nothing), so its cdf equals that of the
// visited outcome before it, or the block's offset; the count
// #(cdf <= target) over all E outcomes is then the sum, over visited
// outcomes, of the run of positions up to the next one.  Every sum is the
// one the dense design forms.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sweep {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-30f;
constexpr uint16_t kNoCount = 0xffff;
// Visited outcomes a warp keeps for one token (the main path's tokens
// visit at most ~2(k_d + 1) <= 490); a token that visits more walks them
// again at each draw.
constexpr int kCap = 512;

__host__ __device__ inline int doc_words(int k) { return (k + 31) / 32 + 1; }

__device__ __forceinline__ uint16_t encode_count(float x) {
  return (x >= 0.f && x < 65535.f && x == truncf(x)) ? (uint16_t)x
                                                      : kNoCount;
}

__device__ __forceinline__ unsigned word_of(const int2* row, int j) {
  return (unsigned)row[j].x;
}
__device__ __forceinline__ unsigned word_of(const unsigned* row, int j) {
  return row[j];
}

// Bits of topics [t, t+n), n in [1, 32], t + n <= K, from a bitmap of
// doc_words(K) words (the last one a zero pad).
template <class Row>
__device__ __forceinline__ unsigned topic_bits(const Row* row, int t, int n) {
  const int j = t >> 5;
  const unsigned x = __funnelshift_r(word_of(row, j), word_of(row, j + 1),
                                     t & 31);
  return n == 32 ? x : x & ((1u << n) - 1u);
}

// n_dk[d, t] from the document's list where it is non-zero, else 0.
__device__ __forceinline__ float doc_count(const int2* drow,
                                           const uint16_t* crow,
                                           const float* nd, int t) {
  const int2 wd = drow[t >> 5];
  const unsigned bit = 1u << (t & 31);
  if (!((unsigned)wd.x & bit)) return 0.f;
  const uint16_t c = crow[wd.y + __popc((unsigned)wd.x & (bit - 1u))];
  return c == kNoCount ? nd[t] : (float)c;
}

// Splits the block's tile of the sorted stream into segments of equal
// rows.  Called by every thread of the block; srow gets the tile's rows,
// seg the first position of each segment and, after the last, the tile's
// length.  Returns the number of segments.
__device__ inline int tile_segments(const int* __restrict__ rows, long base,
                                    int nt, int* srow, int* seg, int* warp_n) {
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5;
  if (i < nt) srow[i] = rows[base + i];
  __syncthreads();
  const bool head = i < nt && (i == 0 || srow[i - 1] != srow[i]);
  const unsigned bal = __ballot_sync(kFull, head);
  if (lane == 0) warp_n[warp] = __popc(bal);
  __syncthreads();
  int before = 0, total = 0;
  for (int q = 0; q < (int)(blockDim.x >> 5); ++q) {
    if (q < warp) before += warp_n[q];
    total += warp_n[q];
  }
  if (head) seg[before + __popc(bal & ((1u << lane) - 1u))] = i;
  if (i == 0) seg[total] = nt;
  __syncthreads();
  return total;
}

// One lane's block of a token's cdf, see the note at the top.  The visited
// outcomes of the whole warp are kept in a compact per-warp array of `cap`
// entries (lane l's from the count of the lanes before it); a token that
// visits more than `cap` keeps nothing and walks its outcomes again at each
// draw, with the same sums.
template <class Bits, class Weight>
struct LaneCdf {
  Bits bits_of;       // (e, nb) -> mask of the outcomes to visit in [e, e+nb)
  Weight weight_of;   // e -> the outcome's weight
  float* c;           // the warp's running sums at the visited outcomes
  uint16_t* p;        // and their positions within their lane's block
  int cap;
  int lo = 0, n = 0, m = 0, first = 0;
  float off = 0.f;    // the block's offset: the cdf before its first outcome
  bool stored = false;

  template <class F>
  __device__ __forceinline__ void walk(F visit) const {
    for (int q = 0; q < n; q += 32) {
      unsigned mask = bits_of(lo + q, min(32, n - q));
      while (mask) {
        const int j = __ffs(mask) - 1;
        mask &= mask - 1u;
        visit(q + j, lo + q + j);
      }
    }
  }

  // Forms the cdf of the lane's block of C = cb outcomes; returns the total
  // (the cdf at outcome E-1), the same in every lane.
  __device__ __forceinline__ float build(int lane, int cb, int e_total) {
    lo = lane * cb;
    n = max(0, min(cb, e_total - lo));
    m = 0;
    for (int q = 0; q < n; q += 32)
      m += __popc(bits_of(lo + q, min(32, n - q)));
    int before = m;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, before, o);
      if (lane >= o) before += y;
    }
    stored = __shfl_sync(kFull, before, 31) <= cap;
    first = before - m;
    float tot = 0.f;
    int j = first;
    walk([&](int pos, int e) {
      const float w = weight_of(e);
      if (stored) {
        c[j] = w;
        p[j] = (uint16_t)pos;
      }
      ++j;
      tot += w;
    });
    float incl = tot;
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    float run = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) run = 0.f;
    off = run;
    if (stored) {
      for (j = first; j < first + m; ++j) {
        run += c[j];
        c[j] = run;
      }
    } else {
      walk([&](int, int e) { run += weight_of(e); });
    }
    return __shfl_sync(kFull, run, (e_total - 1) / cb);
  }

  // #(cdf <= target) over all E outcomes, clamped to [0, E-1]: the
  // positions from a visited outcome up to the next one share its cdf,
  // those before the first the block's offset.
  __device__ __forceinline__ int draw(float target, int e_total) const {
    int cnt = 0, from = 0;
    float prev = off;
    auto visit = [&](int pos, float cdf) {
      if (prev <= target) cnt += pos - from;
      prev = cdf;
      from = pos;
    };
    if (stored) {
      for (int j = first; j < first + m; ++j) visit(p[j], c[j]);
    } else {
      float run = off;
      walk([&](int pos, int e) {
        run += weight_of(e);
        visit(pos, run);
      });
    }
    if (prev <= target) cnt += n - from;
    cnt = __reduce_add_sync(kFull, cnt);
    return min(max(cnt, 0), e_total - 1);
  }
};

// The MH steps of one token, from e_init.  A step's candidate does not
// depend on the chain's state, only its accept does; so lane i loads step
// i's uniforms and forms its dense draw, the warp counts each step's sparse
// draw in turn, lane i evaluates log p and log q at step i's candidate
// (lane 16 at e_init) in one pass, and the accepts then run in order on
// the values shuffled from those lanes: the float operations of the plain
// chain, 16 steps at a time.  `dense_of(slot, coin)` is the alias draw,
// `point(e, lp, lq)` log p and log q at outcome e.
template <class LaneCdfT, class Dense, class Point>
__device__ __forceinline__ int mh_chain(
    int lane, int e_init, int steps, long b, long b_total,
    const int* __restrict__ slot, const float* __restrict__ coin,
    const float* __restrict__ u_mix, const float* __restrict__ u_sparse,
    const float* __restrict__ u_acc, float sparse_mass, float dense_mass,
    int e_total, const LaneCdfT& cdf, Dense dense_of, Point point) {
  constexpr int kGroup = 16;
  int e = e_init;
  float lp_z = 0.f, lq_z = 0.f;
  for (int g = 0; g < steps; g += kGroup) {
    const int ng = min(kGroup, steps - g);
    int mine = e_init, dense = 0;
    float target = 0.f, log_u = 0.f;
    bool pick_sparse = false;
    if (lane < ng) {
      const long o = (long)(g + lane) * b_total + b;
      dense = dense_of(slot[o], coin[o]);
      target = u_sparse[o] * sparse_mass;
      pick_sparse = u_mix[o] * (sparse_mass + dense_mass) < sparse_mass;
      log_u = logf(u_acc[o] + kEps);
    }
    for (int i = 0; i < ng; ++i) {
      const int drawn = cdf.draw(__shfl_sync(kFull, target, i), e_total);
      if (lane == i) mine = pick_sparse ? drawn : dense;
    }
    float lp, lq;
    point(mine, lp, lq);
    if (g == 0) {
      lp_z = __shfl_sync(kFull, lp, kGroup);
      lq_z = __shfl_sync(kFull, lq, kGroup);
    }
    for (int i = 0; i < ng; ++i) {
      const int cand = __shfl_sync(kFull, mine, i);
      const float lp_c = __shfl_sync(kFull, lp, i);
      const float lq_c = __shfl_sync(kFull, lq, i);
      if (__shfl_sync(kFull, log_u, i) < lp_c - lp_z + lq_z - lq_c) {
        e = cand;
        lp_z = lp_c;
        lq_z = lq_c;
      }
    }
  }
  return e;
}

template <class Bits, class Weight>
__device__ __forceinline__ LaneCdf<Bits, Weight> lane_cdf(
    Bits bits_of, Weight weight_of, float* c, uint16_t* p, int cap) {
  return LaneCdf<Bits, Weight>{bits_of, weight_of, c, p, cap};
}

}  // namespace sweep
