// Row-wise Walker/Vose alias-table builds for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   src/repro/kernels/alias_build.py:186 alias_build               (kernel 2)
//   src/repro/kernels/alias_build.py:273 alias_build_fused         (kernel 6)
//   src/repro/kernels/alias_build.py:379 alias_build_gather_fused  (kernel 3)
//   src/repro/kernels/alias_build.py:336 alias_build_rows          (kernel 5)
// and computes what the reference's jnp loop src/repro/core/alias.py::build
// computes: per row, mass = sum(p); scaled = p/mass*K (uniform 1/K*K when
// mass is 0); then Vose's two-stack pairing with a stable larges-first
// partition, K steps at most, prob=1/alias=self for slots never assigned.
// The two stacks are never materialised: in Vose's loop the original
// smalls are popped in ascending index order and the original larges in
// descending order, and a large that turns small is popped at once as the
// next small.  So a chain keeps the current small (i, s_i) and large
// (j, s_j) in registers and only has to find the next original small or
// large.  Every float operation (the left-to-right mass, p/mass, *K,
// s_j - (1 - s_i)) is the plain version's, compiled with --fmad=false, so
// the tables are bit-equal to core/alias.py::build.
//
// Every build runs on rows staged once in shared memory (the staged
// route); rows wider than it takes run per lane (below).
//   What bounds them.  The function moves 12 bytes an entry (p in, prob
//   and alias out; kernel 3 also writes its dense row), 0.48 ms at
//   131072x1024 on an H100; but each row's pairing is a chain of up to K
//   dependent steps, so the time is the chain's latency times the rows an
//   SM holds in flight at once, and shared memory bounds that number (a
//   row needs ~6 bytes an entry).  An incremental build of a few thousand
//   rows is one wave or less: its floor is one chain's latency.
//   What the design does.  A warp owns a few rows at a time (the plan
//   below sizes rows per warp and warps per block from K and the card's
//   shared memory: about sixteen warps a block, as many rows each as fit,
//   since on the H100 the warps hide each other's chain latency better
//   than more rows a warp do; every warp walks its own rows, the grid is
//   one wave of blocks; rows that fill less than one wave are spread over
//   every SM, a row a warp where the SMs hold that many warps) and, for
//   each group of rows:
//   * stages the rows with coalesced 16-byte cp.async copies: kernels 2
//     and 5 the dense rows, kernel 6 its n_wk rows, kernel 3 the n_wk rows
//     its row indices name (a gather: any order).  Kernel 6 then forms
//     (alpha*(n_wk+beta))/(n_k+beta_bar) in place, kernel 3
//     prior*((n_wk+beta)/(n_k+beta_bar)) (the division grouped first, as
//     lda.dense_probs does, so partial and full rebuilds agree bit for bit)
//     and stores it to its `dense` output before the row is scaled; the
//     per-topic arrays (n_k+beta_bar, and kernel 3's prior) are read from
//     shared memory, filled once a block;
//   * sums each row's mass left to right in one lane, the rows of the
//     group on different lanes at once (the plain order; no tree);
//   * forms scaled in place with the whole warp, a bit an entry for
//     scaled < 1 (NaN counts as large) with __ballot_sync, n_small with
//     __popc, and a 16-bit alias array (self at smalls, links at larges);
//   * runs each row's chain in one lane on the staged row (chain_row): the
//     original smalls are consumed in ascending order, so the lane scans
//     them from the mask four entries at a time, the rows of a warp in
//     step, and a small consumed by a large that stays large keeps its
//     scaled value as prob, in place: a group in which the large does not
//     turn small costs four subtractions and a store of its aliases.  The
//     alias of a large that turns small is the next large below it, so
//     the scale pass writes that link into each large slot's alias, and a
//     group with a turn goes entry by entry, each turned large storing its
//     residual as prob and handing on to its link.  The larges at and
//     below the one current at the end were never consumed, and a small
//     slot whose alias is still itself was never assigned: both get
//     prob = 1, alias = self;
//   * writes prob and alias with coalesced 16-byte streaming stores: the
//     outputs are written once, no init pass, no scattered stores.
//   Width: a row takes (K4 + 4)*6 bytes plus its mask words (K4 = K
//   rounded up to 4), and a block (K4 + 4)*4 bytes more for each of its
//   per-topic arrays (none for kernels 2 and 5, one for kernel 6, two for
//   kernel 3); alias indices are 16-bit, so K <= 32768.  On an H100 (227
//   KB a block) that is K <= 32768 for kernels 2 and 5, K <= 22,952 for
//   kernel 6 and K <= 16,452 for kernel 3 (alias_build_staged_max_width
//   reports each kernel's limit for the card at hand); at K = 1024 an SM
//   holds 36 rows (18 warps of 2), at 2048 18 (18 warps of 1).  Kernel 3's
//   4096 rows at K = 1024 are less than a wave: 256 blocks of 16 warps, a
//   row each, two blocks an SM.  A lone row's chain still takes ~75 us
//   there (most groups of a frequent word's row turn a large), so a wave's
//   latency, not the byte bound, is the floor of an incremental build.
//   Kernel 5 is kernel 2 on a compacted block of gathered changed rows
//   (the generic incremental rebuild, PDP's).  The TPU kernel pads the
//   block to its row tile and trims the result; here any number of rows
//   is taken as it is.  Its own entry point lets the wrapper count its
//   launches apart from full builds.
//
// Per-lane builds, rows wider than the staged route: one warp owns 32
// rows.  Each lane sums its own row left to right; the count of small
// entries and the prob=1/alias=self initialisation run with all 32 lanes
// on one row at a time, coalesced; then every lane runs the pairing of its
// own row on device memory, finding the next original small/large with two
// monotone scans of the row that recompute scaled = p/mass*K from the
// input.  Kernel 3 first writes each gathered row's dense term to `dense`,
// then runs the same row build on it.
//
// Kernel 6's grouping is the TPU kernel's, the product first; it is not
// lda.dense_probs's alpha*((n_wk+beta)/(n_k+beta_bar)), so its tables
// differ from kernel 2's on the unfused term in the last place.  The TPU
// kernel divides by the row mass with no zero-mass fallback: with beta > 0
// every entry is positive and no row has zero mass, so the shared fallback
// of scaled_of is never taken there, and where it would be (beta = 0 and
// an empty word) it gives the plain version's uniform row.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float scaled_of(float x, float mass, int k) {
  const float pn = mass > 0.f ? x / mass : (float)(1.0 / (double)k);
  return pn * (float)k;
}

// ------------------------------------------------------ per-lane route
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

// -------------------------------------------------------- staged route
constexpr int kMaxStagedWidth = 32768;   // alias indices held in 16 bits
constexpr int kTargetWarps = 16;         // warps a block, rows allowing
constexpr int kMaxWarps = 24;

// Floats of a staged row: K rounded up to 4, plus 4, so rows start on
// 16 bytes and consecutive rows start 4 banks apart.
__host__ __device__ __forceinline__ int row_stride(int k) {
  return ((k + 3) & ~3) + 4;
}
// Mask words of a row: ceil(K/32), rounded up to 4 words.
__host__ __device__ __forceinline__ int mask_stride(int k) {
  return ((k + 31) / 32 + 3) & ~3;
}

struct Plan {
  int rows_per_warp;   // 0: the row does not fit; use the per-lane route
  int warps;
  int warp_bytes;      // shared memory of one warp's rows
  int block_bytes;     // the block's own part: its per-topic arrays
  int smem;            // dynamic shared memory a block
};

// Scaled/prob (4 bytes), alias (2) and the mask of a staged row, rounded
// up to 16 bytes so that every warp's part starts on 16 bytes.
long row_bytes(int k) {
  return ((long)row_stride(k) * 6 + (long)mask_stride(k) * 4 + 15) & ~15L;
}

// The full plan of a kernel whose block keeps `arrays` per-topic arrays
// of row_stride(k) floats (0: kernels 2 and 5, 1: kernel 6, 2: kernel 3).
Plan make_plan(int k, int arrays, int smem_max) {
  Plan p{0, 0, 0, 0, 0};
  const long bytes = row_bytes(k);
  p.block_bytes = arrays * row_stride(k) * 4;
  if (k < 1 || k > kMaxStagedWidth) return p;
  const long fit = ((long)smem_max - p.block_bytes) / bytes;
  if (fit < 1) return p;
  p.rows_per_warp = (int)std::min(32L, std::max(1L, fit / kTargetWarps));
  p.warps = (int)std::min((long)kMaxWarps, fit / p.rows_per_warp);
  p.warp_bytes = (int)(bytes * p.rows_per_warp);
  p.smem = p.block_bytes + p.warps * p.warp_bytes;
  return p;
}

int device_smem_max() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage sources.  A warp copies input row r (k entries) into shared s
// with stage(); once the copies have landed, finish() turns the copy of
// row r into the row's dense term in place.
__device__ __forceinline__ void copy_row(const float* __restrict__ src,
                                         float* s, int k, int lane,
                                         bool vec) {
  if (vec) {
    for (int c = lane * 4; c < k; c += 128) cp_async16(s + c, src + c);
  } else {
    for (int c = lane; c < k; c += 32) s[c] = src[c];
  }
}

// kernel 2: the dense rows as they are.
template <bool kVec>
struct StageDense {
  const float* __restrict__ p;
  __device__ void block_setup(float*, int) const {}
  __device__ void stage(long r, float* s, int k, int lane) const {
    copy_row(p + r * (long)k, s, k, lane, kVec);
  }
  __device__ void finish(long, float*, int, int) const {}
};

// kernel 6: (alpha*(n_wk+beta))/(n_k+beta_bar), the denominators formed
// once a block into shared memory.
template <bool kVec>
struct StageFusedLda {
  const float* __restrict__ n_wk;
  const float* __restrict__ n_k;
  float alpha, beta, beta_bar;
  const float* den;   // set by block_setup
  __device__ void block_setup(float* d, int k) {
    for (int c = threadIdx.x; c < k; c += blockDim.x) d[c] = n_k[c] + beta_bar;
    den = d;
  }
  __device__ void stage(long r, float* s, int k, int lane) const {
    copy_row(n_wk + r * (long)k, s, k, lane, kVec);
  }
  __device__ void finish(long, float* s, int k, int lane) const {
    // Rows and denominators start on 16 bytes in shared memory, so the
    // four-wide pass is safe for any K; entries past K are never read.
    for (int c = lane * 4; c < k; c += 128) {
      const float4 x = *reinterpret_cast<const float4*>(s + c);
      const float4 d = *reinterpret_cast<const float4*>(den + c);
      float4 y;
      y.x = (alpha * (x.x + beta)) / d.x;
      y.y = (alpha * (x.y + beta)) / d.y;
      y.z = (alpha * (x.z + beta)) / d.z;
      y.w = (alpha * (x.w + beta)) / d.w;
      *reinterpret_cast<float4*>(s + c) = y;
    }
  }
};

// kernel 3: prior*((n_wk+beta)/(n_k+beta_bar)) of n_wk row rows[r], the
// prior and the denominators formed once a block into shared memory; the
// term is also stored to row r of `dense`.
template <bool kVec>
struct StageGather {
  const float* __restrict__ n_wk;
  const float* __restrict__ n_k;
  const float* __restrict__ prior;
  const int* __restrict__ rows;
  float beta, beta_bar;
  float* __restrict__ dense;
  const float* pri;   // set by block_setup
  const float* den;
  __device__ void block_setup(float* d, int k) {
    float* e = d + row_stride(k);
    for (int c = threadIdx.x; c < k; c += blockDim.x) {
      d[c] = prior[c];
      e[c] = n_k[c] + beta_bar;
    }
    pri = d;
    den = e;
  }
  __device__ void stage(long r, float* s, int k, int lane) const {
    copy_row(n_wk + (long)rows[r] * k, s, k, lane, kVec);
  }
  __device__ void finish(long r, float* s, int k, int lane) const {
    float* out = dense + r * (long)k;
    if (kVec) {
      for (int c = lane * 4; c < k; c += 128) {
        const float4 x = *reinterpret_cast<const float4*>(s + c);
        const float4 p = *reinterpret_cast<const float4*>(pri + c);
        const float4 d = *reinterpret_cast<const float4*>(den + c);
        float4 y;
        y.x = p.x * ((x.x + beta) / d.x);
        y.y = p.y * ((x.y + beta) / d.y);
        y.z = p.z * ((x.z + beta) / d.z);
        y.w = p.w * ((x.w + beta) / d.w);
        *reinterpret_cast<float4*>(s + c) = y;
        __stcs(reinterpret_cast<float4*>(out + c), y);
      }
    } else {
      for (int c = lane; c < k; c += 32) {
        const float y = pri[c] * ((s[c] + beta) / den[c]);
        s[c] = y;
        __stcs(out + c, y);
      }
    }
  }
};

// A staged row: scaled values s; a 16-bit alias array a, holding self at
// every small slot and, at every large slot, the next large below it (the
// large that takes it if it turns small: its alias), or kNoLarge; and the
// small mask m, where m[w] holds bit b for entry 32w + b (set: scaled
// < 1; set also for the tail entries past K).
constexpr unsigned short kNoLarge = 0xffff;

// Vose pairing of one staged row in one lane: the loop of pair_row, read
// the other way round.  The original smalls are consumed in ascending
// index order, and a small consumed by a large that stays large keeps its
// scaled value as prob, already in place, so the common step is only the
// large's residual r = r - (1 - s_i).  The lane scans its row four
// entries at a time, in step with the other rows of the warp, and takes a
// group with selects when at most one large turns small in it and the
// next large takes the turned one and stays large: the turned large's
// prob is its residual and its alias is already in a; the next large and
// the one after it are preloaded by following the links.  Any other group
// (two turns, a turn the next large does not absorb, the last large
// turning) is taken entry by entry.  The float operations and their order
// are the stack loop's.  Returns the large current at the end: the larges
// above it were consumed, it and those below it were not.  j is the first
// (highest) large.
__device__ int chain_row(float* s, unsigned short* a, const unsigned* m,
                         int k, int n_small, int j) {
  int n_large = k - n_small;
  if (n_small == 0 || n_large == 0) return k;
  const unsigned tail = (k & 31) ? (1u << (k & 31)) - 1u : kFull;
  float r = s[j];
  unsigned bits = 0;
#pragma unroll 4
  for (int c = 0; c < k; c += 4) {
    if ((c & 31) == 0) {
      bits = m[c >> 5];
      if (c + 32 >= k) bits &= tail;   // the tail past K is no small
    }
    const unsigned g = (bits >> (c & 31)) & 15u;
    const float4 x4 = *reinterpret_cast<const float4*>(s + c);
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
    // The group at once while the large stays large.
    float t = r;
    bool turns = false;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool small = (g >> e) & 1u;
      const float u = t - (1.f - x[e]);
      turns |= small && u < 1.f;
      t = small ? u : t;
    }
    if (!turns) {
      r = t;
      const unsigned short jj = (unsigned short)j;
      if (g == 15u) {
        *reinterpret_cast<ushort4*>(a + c) = make_ushort4(jj, jj, jj, jj);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if ((g >> e) & 1u) a[c + e] = jj;
      }
      continue;
    }
    // A large turns small in this group: entry by entry, each turned
    // large taken by the next one (its link) while they turn.
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!((g >> e) & 1u)) continue;
      a[c + e] = (unsigned short)j;
      r = r - (1.f - x[e]);
      while (r < 1.f) {
        if (n_large == 1) return j;
        --n_large;
        s[j] = r;
        const float si = r;
        j = a[j];
        r = s[j] - (1.f - si);
      }
    }
  }
  return j;
}

// Slot c of a finished row: a small is assigned iff its alias is not
// itself; a large iff it lies above the chain's last large (it was
// consumed, its alias is the link and its prob the residual).  A slot
// never assigned gets prob = 1 and alias = self.
__device__ __forceinline__ void finish_slot(int c, bool small, float p,
                                            int al, int j_end, float& prob,
                                            int& alias) {
  const bool assigned = small ? al != c : c > j_end;
  prob = assigned ? p : 1.f;
  alias = assigned ? al : c;
}

template <bool kVec>
__device__ void write_row(const float* s, const unsigned short* a,
                          const unsigned* m, int k, int j_end,
                          float* __restrict__ prob, int* __restrict__ alias,
                          int lane) {
  if (kVec) {
    for (int c = lane * 4; c < k; c += 128) {
      const float4 p = *reinterpret_cast<const float4*>(s + c);
      const ushort4 q = *reinterpret_cast<const ushort4*>(a + c);
      const unsigned g = m[c >> 5] >> (c & 31);
      float4 out;
      int4 al;
      finish_slot(c, g & 1u, p.x, q.x, j_end, out.x, al.x);
      finish_slot(c + 1, (g >> 1) & 1u, p.y, q.y, j_end, out.y, al.y);
      finish_slot(c + 2, (g >> 2) & 1u, p.z, q.z, j_end, out.z, al.z);
      finish_slot(c + 3, (g >> 3) & 1u, p.w, q.w, j_end, out.w, al.w);
      __stcs(reinterpret_cast<float4*>(prob + c), out);
      __stcs(reinterpret_cast<int4*>(alias + c), al);
    }
  } else {
    for (int c = lane; c < k; c += 32) {
      float out;
      int al;
      finish_slot(c, (m[c >> 5] >> (c & 31)) & 1u, s[c], a[c], j_end,
                  out, al);
      __stcs(prob + c, out);
      __stcs(alias + c, al);
    }
  }
}

// Bit i of an 8-bit value moved to bit 4i.
__device__ __forceinline__ unsigned spread4(unsigned x) {
  x &= 0xffu;
  x = (x | (x << 12)) & 0x000f000fu;
  x = (x | (x << 6)) & 0x03030303u;
  return (x | (x << 3)) & 0x11111111u;
}

// One staged row, by the whole warp: scaled = scaled_of(p) in place; the
// small mask (bit b of m[w]: entry 32w + b has scaled < 1, NaN large;
// set for the tail past K); in a, self at each small slot and at each
// large slot the next large below it (kNoLarge at the lowest).  Lane l
// takes entries 4l..4l+3 of each block of 128, so its four divisions are
// independent; the mass test is the row's, outside the loop.  Returns the
// number of smalls and the highest large (kNoLarge if none).
__device__ void scale_row(float* s, unsigned short* a, unsigned* m, int k,
                          float mass, int lane, int& n_small, int& first) {
  const bool safe = mass > 0.f;
  const float uniform = (float)(1.0 / (double)k) * (float)k;
  const float kf = (float)k;
  const int words = (k + 31) / 32;
  const unsigned lower = (1u << lane) - 1u;
  int below = kNoLarge, smalls = 0;
  for (int b = 0; b < k; b += 128) {
    const int c = b + 4 * lane;
    float v[4] = {uniform, uniform, uniform, uniform};
    if (c < k) {
      const float4 x = *reinterpret_cast<const float4*>(s + c);
      if (safe) {
        v[0] = (x.x / mass) * kf;
        v[1] = (x.y / mass) * kf;
        v[2] = (x.z / mass) * kf;
        v[3] = (x.w / mass) * kf;
      }
      *reinterpret_cast<float4*>(s + c) = make_float4(v[0], v[1], v[2], v[3]);
    }
    unsigned large[4];
    bool is_large[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      is_large[e] = c + e < k && !(v[e] < 1.f);
      large[e] = __ballot_sync(kFull, is_large[e]);
      smalls += 32 - __popc(large[e]);
    }
    // Mask words of this block: entry 4l + e is bit e of lane l's nibble.
    if (lane < 4 && (b >> 5) + lane < words) {
      unsigned word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        word |= spread4(~large[e] >> (8 * lane)) << e;
      m[(b >> 5) + lane] = word;
    }
    // The next large below each entry: in this lane, in the lanes below,
    // or in the blocks before.
    int link = below, top = -1;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned under = large[e] & lower;
      if (under) link = max(link == kNoLarge ? -1 : link,
                            b + 4 * (31 - __clz(under)) + e);
      if (large[e]) top = max(top, b + 4 * (31 - __clz(large[e])) + e);
    }
    if (c < k) {
      unsigned short out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        out[e] = (unsigned short)(is_large[e] ? link : c + e);
        if (is_large[e]) link = c + e;
      }
      if (c + 3 < k) {
        *reinterpret_cast<ushort4*>(a + c) =
            make_ushort4(out[0], out[1], out[2], out[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < k) a[c + e] = out[e];
      }
    }
    if (top >= 0) below = top;
  }
  n_small = smalls - (((k + 127) & ~127) - k);
  first = below;
}

template <class Stage, bool kVec>
__global__ void __launch_bounds__(kMaxWarps * 32)
    alias_build_staged_kernel(Stage src, int r, int k, Plan plan,
                              float* __restrict__ prob,
                              int* __restrict__ alias,
                              float* __restrict__ mass_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  src.block_setup(reinterpret_cast<float*>(smem), k);
  __syncthreads();
  const int rpw = plan.rows_per_warp;
  const int stride = row_stride(k), mstride = mask_stride(k);
  unsigned char* mine = smem + plan.block_bytes + warp * plan.warp_bytes;
  float* rows_s = reinterpret_cast<float*>(mine);
  unsigned short* rows_a =
      reinterpret_cast<unsigned short*>(rows_s + rpw * stride);
  unsigned* rows_m = reinterpret_cast<unsigned*>(rows_a + rpw * stride);

  const long groups = ((long)r + rpw - 1) / rpw;
  for (long g = (long)blockIdx.x * plan.warps + warp; g < groups;
       g += (long)gridDim.x * plan.warps) {
    const long row0 = g * rpw;
    const int n = (int)min((long)rpw, (long)r - row0);
    for (int q = 0; q < n; ++q)
      src.stage(row0 + q, rows_s + q * stride, k, lane);
    if (kVec) cp_async_wait_all();
    __syncwarp();
    for (int q = 0; q < n; ++q)
      src.finish(row0 + q, rows_s + q * stride, k, lane);
    __syncwarp();

    // The mass of row `lane`, left to right in one lane.
    float my_mass = 0.f;
    if (lane < n) {
      const float* s = rows_s + lane * stride;
      if (kVec) {
#pragma unroll 8
        for (int c = 0; c < k; c += 4) {
          const float4 x = *reinterpret_cast<const float4*>(s + c);
          my_mass += x.x;
          my_mass += x.y;
          my_mass += x.z;
          my_mass += x.w;
        }
      } else {
        for (int c = 0; c < k; ++c) my_mass += s[c];
      }
    }

    // Scaled values in place, the small mask, and in a: self at a small
    // slot, the next large below at a large slot (the link).
    int my_small = 0, my_first = kNoLarge;
    for (int q = 0; q < n; ++q) {
      int small, first;
      scale_row(rows_s + q * stride, rows_a + q * stride,
                rows_m + q * mstride, k, __shfl_sync(kFull, my_mass, q),
                lane, small, first);
      if (lane == q) {
        my_small = small;
        my_first = first;
      }
    }
    __syncwarp();

    int my_end = k;
    if (lane < n)
      my_end = chain_row(rows_s + lane * stride, rows_a + lane * stride,
                         rows_m + lane * mstride, k, my_small, my_first);
    __syncwarp();

    for (int q = 0; q < n; ++q) {
      const long base = (row0 + q) * (long)k;
      write_row<kVec>(rows_s + q * stride, rows_a + q * stride,
                      rows_m + q * mstride, k, __shfl_sync(kFull, my_end, q),
                      prob + base, alias + base, lane);
    }
    if (lane < n) mass_out[row0 + lane] = my_mass;
    __syncwarp();
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

long ceil_div(long a, long b) { return (a + b - 1) / b; }

// Launch the staged kernel.  With one wave of rows or more (every SM
// holding as many blocks of the full plan as fit), as many blocks as the
// SMs hold at once, each warp walking its groups of rows.  Below one wave
// the rows are spread over every SM instead, a row a warp: the fewest
// blocks an SM, up to as many as the SMs hold, that are resident at once
// and give every row a warp of its own.
template <class Stage, bool kVec>
int launch_staged(Stage src, int r, int k, const Plan& full, float* prob,
                  int* alias, float* mass, cudaStream_t stream) {
  auto kernel = alias_build_staged_kernel<Stage, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, full.smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto resident = [&](const Plan& p) {
    int n = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &n, kernel, p.warps * 32, p.smem) == cudaSuccess ? n : 0;
  };
  auto launch = [&](const Plan& p, long grid) {
    kernel<<<(int)std::max(1L, grid), p.warps * 32, p.smem, stream>>>(
        src, r, k, p, prob, alias, mass);
    return (int)cudaGetLastError();
  };
  const long full_rows = (long)full.warps * full.rows_per_warp;
  const long wave = (long)sms * std::max(1, resident(full));   // blocks
  if (r < wave * full_rows) {
    Plan p = full;          // within the full plan's shared memory
    p.rows_per_warp = 1;
    p.warp_bytes = (int)row_bytes(k);
    auto size = [&](long warps) {
      p.warps = (int)warps;
      p.smem = p.block_bytes + p.warps * p.warp_bytes;
    };
    size(1);
    const int most = resident(p);        // one-warp blocks an SM holds
    for (int b = 1; b <= most; ++b) {
      const long w = ceil_div(r, (long)sms * b);
      if (w > std::min((long)kMaxWarps, full_rows)) continue;
      size(w);
      if (resident(p) >= b) return launch(p, ceil_div(r, w));
    }
  }
  return launch(full, std::min(ceil_div(ceil_div(r, full.rows_per_warp),
                                        full.warps), wave));
}

// Kernels 2 and 5: the rows of p as they are.
int build_dense(const float* p, int r, int k, float* prob, int* alias,
                float* mass, cudaStream_t st) {
  if (r <= 0) return (int)cudaGetLastError();
  const Plan plan = make_plan(k, 0, device_smem_max());
  if (plan.rows_per_warp == 0) {
    alias_build_kernel<<<blocks_for(r), kWarpsPerBlock * 32, 0, st>>>(
        p, r, k, prob, alias, mass);
    return (int)cudaGetLastError();
  }
  if (k % 4 == 0 && aligned16(p) && aligned16(prob) && aligned16(alias))
    return launch_staged<StageDense<true>, true>(StageDense<true>{p}, r, k,
                                                 plan, prob, alias, mass, st);
  return launch_staged<StageDense<false>, false>(StageDense<false>{p}, r, k,
                                                 plan, prob, alias, mass, st);
}

}  // namespace

// The widest K that the staged route takes on the current card for a
// kernel whose block keeps `arrays` per-topic arrays (0: kernels 2 and 5,
// 1: kernel 6, 2: kernel 3); wider rows run per lane.
extern "C" int alias_build_staged_max_width(int arrays) {
  const int smem = device_smem_max();
  int lo = 0, hi = kMaxStagedWidth;
  while (lo < hi) {                       // the fit is monotone in K
    const int mid = (lo + hi + 1) / 2;
    if (make_plan(mid, arrays, smem).rows_per_warp > 0) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

extern "C" int alias_build(const float* p, int r, int k, float* prob,
                           int* alias, float* mass, void* stream) {
  return build_dense(p, r, k, prob, alias, mass, (cudaStream_t)stream);
}

extern "C" int alias_build_rows(const float* p, int r, int k, float* prob,
                                int* alias, float* mass, void* stream) {
  return build_dense(p, r, k, prob, alias, mass, (cudaStream_t)stream);
}

extern "C" int alias_build_gather_fused(const float* n_wk, const float* n_k,
                                        const float* prior, const int* rows,
                                        int r, int k, float beta,
                                        float beta_bar, float* prob,
                                        int* alias, float* mass,
                                        float* dense, void* stream) {
  if (r <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  const Plan plan = make_plan(k, 2, device_smem_max());
  if (plan.rows_per_warp == 0) {
    alias_build_gather_kernel<<<blocks_for(r), kWarpsPerBlock * 32, 0, st>>>(
        n_wk, n_k, prior, rows, r, k, beta, beta_bar, prob, alias, mass,
        dense);
    return (int)cudaGetLastError();
  }
  if (k % 4 == 0 && aligned16(n_wk) && aligned16(prob) && aligned16(alias) &&
      aligned16(dense))
    return launch_staged<StageGather<true>, true>(
        StageGather<true>{n_wk, n_k, prior, rows, beta, beta_bar, dense,
                          nullptr, nullptr},
        r, k, plan, prob, alias, mass, st);
  return launch_staged<StageGather<false>, false>(
      StageGather<false>{n_wk, n_k, prior, rows, beta, beta_bar, dense,
                         nullptr, nullptr},
      r, k, plan, prob, alias, mass, st);
}

extern "C" int alias_build_fused(const float* n_wk, const float* n_k, int v,
                                 int k, float alpha, float beta,
                                 float beta_bar, float* prob, int* alias,
                                 float* mass, void* stream) {
  if (v <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  const Plan plan = make_plan(k, 1, device_smem_max());
  if (plan.rows_per_warp == 0) {
    alias_build_fused_kernel<<<blocks_for(v), kWarpsPerBlock * 32, 0, st>>>(
        n_wk, n_k, v, k, alpha, beta, beta_bar, prob, alias, mass);
    return (int)cudaGetLastError();
  }
  if (k % 4 == 0 && aligned16(n_wk) && aligned16(prob) && aligned16(alias))
    return launch_staged<StageFusedLda<true>, true>(
        StageFusedLda<true>{n_wk, n_k, alpha, beta, beta_bar, nullptr}, v, k,
        plan, prob, alias, mass, st);
  return launch_staged<StageFusedLda<false>, false>(
      StageFusedLda<false>{n_wk, n_k, alpha, beta, beta_bar, nullptr}, v, k,
      plan, prob, alias, mass, st);
}
