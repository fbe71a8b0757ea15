// Metropolis-Hastings accept step (paper eq. 7) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mh_accept.py::mh_accept
// (kernel 9): per element, out = cand if log(u + 1e-30) <
// ((lp_c - lp_z) + lq_z) - lq_c else z, the reference's operation order,
// compiled with --fmad=false.
//
// What bounds it on the card.  Bytes: seven 4-byte inputs and one output,
// 32 bytes an element; one logf and three subtractions.  What the design
// does about it: one thread per element, coalesced, nothing staged; the
// TPU kernel's point was to fuse the five elementwise passes into one,
// and one pass is what this is.  logf is CUDA's full-precision logf
// (within 1 ulp), the function PyTorch's log calls on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void mh_accept_kernel(const int* __restrict__ z,
                                 const int* __restrict__ cand,
                                 const float* __restrict__ lp_z,
                                 const float* __restrict__ lp_c,
                                 const float* __restrict__ lq_z,
                                 const float* __restrict__ lq_c,
                                 const float* __restrict__ u, long b,
                                 int* __restrict__ out) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= b) return;
  const float log_ratio = ((lp_c[i] - lp_z[i]) + lq_z[i]) - lq_c[i];
  out[i] = logf(u[i] + 1e-30f) < log_ratio ? cand[i] : z[i];
}

}  // namespace

extern "C" int mh_accept(const int* z, const int* cand, const float* lp_z,
                         const float* lp_c, const float* lq_z,
                         const float* lq_c, const float* u, long b, int* out,
                         void* stream) {
  if (b > 0)
    mh_accept_kernel<<<(unsigned)((b + kThreads - 1) / kThreads), kThreads,
                       0, (cudaStream_t)stream>>>(z, cand, lp_z, lp_c, lq_z,
                                                  lq_c, u, b, out);
  return (int)cudaGetLastError();
}
