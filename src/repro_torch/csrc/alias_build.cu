// Row-wise Walker/Vose alias-table builds for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   src/repro/kernels/alias_build.py::alias_build               (kernel 2)
//   src/repro/kernels/alias_build.py::alias_build_gather_fused  (kernel 3)
//   src/repro/kernels/alias_build.py::alias_build_rows          (kernel 5)
//   src/repro/kernels/alias_build.py::alias_build_fused         (kernel 6)
// and computes what the reference's jnp loop src/repro/core/alias.py::build
// computes: per row, mass = sum(p); scaled = p/mass*K (uniform 1/K*K when
// mass is 0); then Vose's two-stack pairing with a stable larges-first
// partition, K steps at most, prob=1/alias=self for slots never assigned.
//
// What bounds it on the card.  The pairing is sequential within a row: K
// dependent steps, each a compare and a subtract.  Bytes are small (read p
// once, write prob/alias once: 12 bytes per entry), so the bound that
// matters is the latency of the per-row chain, and the only cure is to run
// many rows at once with a short chain.
//
// What the design does about it.
//   * One warp owns 32 rows.  Each lane sums its own row left to right
//     (the order of the plain version, so masses agree bit for bit); the
//     count of small entries and the prob=1/alias=self initialisation run
//     with all 32 lanes on one row at a time, coalesced.
//   * Then every lane runs the pairing of its own row.  The two stacks are
//     not materialised: in Vose's loop the original smalls are popped in
//     ascending index order and the original larges in descending order,
//     and a large that turns small is popped at once as the next small.
//     So the loop keeps the current small (i, s_i) and the current large
//     (j, s_j) in registers and finds the next original small/large with
//     two monotone scans of the row, recomputing scaled = p/mass*K from
//     the input.  No shared memory and no scratch; 32 rows in flight per
//     warp and every row of the matrix in flight at once.
//   * The result is exactly that of the stack loop: each step assigns one
//     slot, and the float operations (p/mass, *K, s_j - (1 - s_i)) are the
//     reference's, compiled with --fmad=false.
// Kernel 3 first writes prior*((n_wk+beta)/(n_k+beta_bar)) of each
// gathered row into its `dense` output (the division grouped first, as
// lda.dense_probs does, so partial and full rebuilds agree bit for bit),
// then runs the same row build on it.
// Kernel 5 is the build of a compacted block of gathered changed rows (the
// generic incremental rebuild, PDP's).  The TPU kernel pads the block to
// its row tile and trims the result; here a warp takes any 32 rows, so the
// entry launches the full build's kernel on the R rows as they are.  Its
// own entry point lets the wrapper count its launches apart from full
// builds; a profile tells the two apart by grid size only.
// Kernel 6 is the full LDA build from the raw statistics: the row source
// the pairing reads forms (alpha*(n_wk+beta))/(n_k+beta_bar) from n_wk and
// n_k wherever the build reads an entry, so the dense term never goes to
// device memory.  The grouping is the TPU kernel's, the product first; it
// is not lda.dense_probs's alpha*((n_wk+beta)/(n_k+beta_bar)), so these
// tables differ from kernel 2's on the unfused term in the last place.
// The TPU kernel divides by the row mass with no zero-mass fallback: with
// beta > 0 every entry is positive and no row has zero mass, so the shared
// fallback of scaled_of is never taken there, and where it would be (beta
// = 0 and an empty word) it gives the plain version's uniform row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float scaled_of(float x, float mass, int k) {
  const float pn = mass > 0.f ? x / mass : (float)(1.0 / (double)k);
  return pn * (float)k;
}

// Row sources: src(r, c) is entry c of input row r.
// A dense (R, K) matrix.  `p` carries no __restrict__: kernel 3 wrote it
// earlier in the same launch, so it must not go through the read-only
// cache.
struct DenseRows {
  const float* p;
  int k;
  __device__ float operator()(long r, int c) const {
    return p[r * (long)k + c];
  }
};

// The LDA dense term of kernel 6, formed from the statistics on each read.
struct FusedLdaRows {
  const float* __restrict__ n_wk;
  const float* __restrict__ n_k;
  int k;
  float alpha, beta, beta_bar;
  __device__ float operator()(long r, int c) const {
    return (alpha * (n_wk[r * (long)k + c] + beta)) / (n_k[c] + beta_bar);
  }
};

// Vose pairing of row r of src, whose scaled values are
// scaled_of(src(r, c)).  prob/alias point at the row and must already
// hold 1 / self.
template <class Rows>
__device__ void pair_row(const Rows& src, long r, float mass,
                         int n_small, int k, float* __restrict__ prob,
                         int* __restrict__ alias) {
  int n_large = k - n_small;
  if (n_small == 0 || n_large == 0) return;
  int ps = -1, pl = k;
  float si, sj;
  do { si = scaled_of(src(r, ++ps), mass, k); } while (!(si < 1.f));
  do { sj = scaled_of(src(r, --pl), mass, k); } while (sj < 1.f);
  int i = ps, j = pl;
  while (true) {
    prob[i] = si;
    alias[i] = j;
    sj = sj - (1.f - si);
    if (sj < 1.f) {           // j turns small and is the next small
      i = j;
      si = sj;
      if (--n_large == 0) break;
      do { sj = scaled_of(src(r, --pl), mass, k); } while (sj < 1.f);
      j = pl;
    } else {                  // j stays the top large; next original small
      if (--n_small == 0) break;
      do { si = scaled_of(src(r, ++ps), mass, k); } while (!(si < 1.f));
      i = ps;
    }
  }
}

// Build rows [row0, row0 + n) of src into prob/alias/mass (ld = k);
// called by a whole warp, n <= 32.
template <class Rows>
__device__ void build_rows_warp(const Rows& src, long row0,
                                int n, int k, float* __restrict__ prob,
                                int* __restrict__ alias,
                                float* __restrict__ mass_out) {
  const int lane = threadIdx.x & 31;
  // Each lane sums its own row left to right, as the plain version does,
  // so the masses (and with them the tables) agree bit for bit.
  float my_mass = 0.f;
  if (lane < n)
    for (int c = 0; c < k; ++c) my_mass += src(row0 + lane, c);
  int my_small = 0;
  for (int q = 0; q < n; ++q) {
    const long base = (row0 + q) * (long)k;
    const float m = __shfl_sync(kFull, my_mass, q);
    int small = 0;
    for (int c = lane; c < k; c += 32) {
      small += scaled_of(src(row0 + q, c), m, k) < 1.f;
      prob[base + c] = 1.f;
      alias[base + c] = c;
    }
    small = __reduce_add_sync(kFull, small);
    if (lane == q) my_small = small;
  }
  __syncwarp();
  if (lane < n) {
    const long base = (row0 + lane) * (long)k;
    pair_row(src, row0 + lane, my_mass, my_small, k, prob + base,
             alias + base);
    mass_out[row0 + lane] = my_mass;
  }
}

__global__ void alias_build_kernel(const float* __restrict__ p, int r, int k,
                                   float* __restrict__ prob,
                                   int* __restrict__ alias,
                                   float* __restrict__ mass) {
  const long warp = (long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const long row0 = warp * 32;
  if (row0 >= r) return;
  const int n = (int)min(32L, (long)r - row0);
  build_rows_warp(DenseRows{p, k}, row0, n, k, prob, alias, mass);
}

__global__ void alias_build_fused_kernel(
    const float* __restrict__ n_wk, const float* __restrict__ n_k, int v,
    int k, float alpha, float beta, float beta_bar, float* __restrict__ prob,
    int* __restrict__ alias, float* __restrict__ mass) {
  const long warp = (long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const long row0 = warp * 32;
  if (row0 >= v) return;
  const int n = (int)min(32L, (long)v - row0);
  build_rows_warp(FusedLdaRows{n_wk, n_k, k, alpha, beta, beta_bar}, row0,
                  n, k, prob, alias, mass);
}

__global__ void alias_build_gather_kernel(
    const float* __restrict__ n_wk, const float* __restrict__ n_k,
    const float* __restrict__ prior, const int* __restrict__ rows, int r,
    int k, float beta, float beta_bar, float* __restrict__ prob,
    int* __restrict__ alias, float* __restrict__ mass,
    float* __restrict__ dense) {
  const int lane = threadIdx.x & 31;
  const long warp = (long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const long row0 = warp * 32;
  if (row0 >= r) return;
  const int n = (int)min(32L, (long)r - row0);
  for (int q = 0; q < n; ++q) {
    const float* src = n_wk + (long)rows[row0 + q] * k;
    float* dst = dense + (row0 + q) * (long)k;
    for (int c = lane; c < k; c += 32)
      dst[c] = prior[c] * ((src[c] + beta) / (n_k[c] + beta_bar));
  }
  __syncwarp();
  build_rows_warp(DenseRows{dense, k}, row0, n, k, prob, alias, mass);
}

int blocks_for(long rows) {
  const long warps = (rows + 31) / 32;
  return (int)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" int alias_build(const float* p, int r, int k, float* prob,
                           int* alias, float* mass, void* stream) {
  if (r > 0)
    alias_build_kernel<<<blocks_for(r), kWarpsPerBlock * 32, 0,
                         (cudaStream_t)stream>>>(p, r, k, prob, alias, mass);
  return (int)cudaGetLastError();
}

extern "C" int alias_build_rows(const float* p, int r, int k, float* prob,
                                int* alias, float* mass, void* stream) {
  return alias_build(p, r, k, prob, alias, mass, stream);
}

extern "C" int alias_build_gather_fused(const float* n_wk, const float* n_k,
                                        const float* prior, const int* rows,
                                        int r, int k, float beta,
                                        float beta_bar, float* prob,
                                        int* alias, float* mass,
                                        float* dense, void* stream) {
  if (r > 0)
    alias_build_gather_kernel<<<blocks_for(r), kWarpsPerBlock * 32, 0,
                                (cudaStream_t)stream>>>(
        n_wk, n_k, prior, rows, r, k, beta, beta_bar, prob, alias, mass,
        dense);
  return (int)cudaGetLastError();
}

extern "C" int alias_build_fused(const float* n_wk, const float* n_k, int v,
                                 int k, float alpha, float beta,
                                 float beta_bar, float* prob, int* alias,
                                 float* mass, void* stream) {
  if (v > 0)
    alias_build_fused_kernel<<<blocks_for(v), kWarpsPerBlock * 32, 0,
                               (cudaStream_t)stream>>>(
        n_wk, n_k, v, k, alpha, beta, beta_bar, prob, alias, mass);
  return (int)cudaGetLastError();
}
