// The cast kernels' template (K4 cast_seg, K4v cast_seg_value, K5
// cast_sweep), shared by cast_seg.cu (the instantiations without the
// CONVEX routes) and cast_cvx.cu (the CVX instantiations and the route
// probe): two sources, so that nvcc builds them in parallel.  The design
// and bounds are described in cast_seg.cu.
#pragma once

#include <cuda_runtime.h>

#include "collision.cuh"

using namespace coll;

enum { MODE_JAC = 0, MODE_VALUE = 1, MODE_SWEEP = 2 };
constexpr int THREADS = 128;
constexpr int ND_JAC = 7;  // n_dof of the Jacobian variant (7-DoF arms)

template <typename T, int ND, int MODE, bool CVX>
__global__ void __launch_bounds__(THREADS)
cast_kernel(const int* __restrict__ I, const T* __restrict__ F,
            const T* __restrict__ x, long x_stride, int nc, int first,
            int n_gaps, const T* __restrict__ ss, int n_sub, T* D, T* Ja,
            T* Jb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slots = reinterpret_cast<T*>(smem_raw);
  const int P = I[3], sz = slot_size(I);
  const int n_slots = MODE == MODE_SWEEP ? n_sub + 1 : n_sub;
  T* dsub = slots + n_slots * sz;
  T* dtan = dsub + n_sub * P;
  const int lane = blockIdx.x / n_gaps, g = blockIdx.x % n_gaps;
  const T* qa = x + lane * x_stride + (first + g) * nc;
  const T* qb = qa + nc;

  for (int s = threadIdx.x; s < n_slots; s += blockDim.x)
    slot_fill(I, F, qa, qb, ss, s, n_sub, slots + s * sz);
  __syncthreads();
  for (int it = threadIdx.x; it < n_sub * P; it += blockDim.x)
    discrete_item<T, ND, MODE == MODE_JAC, CVX>(I, F, slots, it / P, it % P,
                                                 dsub, dtan);
  __syncthreads();
  const long gap = (long)lane * n_gaps + g;
  if (MODE == MODE_SWEEP) {
    for (int p = threadIdx.x; p < P; p += blockDim.x)
      sweep_item<T, CVX>(I, F, slots, n_sub, p, dsub, D + gap * P);
  } else {
    const int n_seg = n_sub - 1;
    const long rows = (long)n_seg * P;
    for (int it = threadIdx.x; it < n_seg * P; it += blockDim.x)
      segment_item<T, ND, MODE == MODE_JAC, CVX>(
          I, F, slots, ss, it / P, it % P, dsub, dtan, D + gap * rows,
          MODE == MODE_JAC ? Ja + gap * rows * nc : nullptr,
          MODE == MODE_JAC ? Jb + gap * rows * nc : nullptr, nc);
  }
}

template <typename T, int ND, int MODE, bool CVX>
static int launch(const int* I, const T* F, const T* x, long x_stride, int nc,
                  int first, int n_gaps, const T* ss, int n_sub, T* D, T* Ja,
                  T* Jb, int lanes, int smem_bytes, cudaStream_t stream) {
  auto kern = cast_kernel<T, ND, MODE, CVX>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<lanes * n_gaps, THREADS, smem_bytes, stream>>>(
      I, F, x, x_stride, nc, first, n_gaps, ss, n_sub, D, Ja, Jb);
  return (int)cudaGetLastError();
}

#define CAST_ENTRY(NAME, T, ND, MODE, CVX, CHECK)                             \
  extern "C" int NAME(const int* I, const T* F, const T* x, long x_stride,   \
                      int nc, int first, int n_gaps, const T* ss, int n_sub, \
                      T* D, T* Ja, T* Jb, int lanes, int nd, int smem_bytes, \
                      void* stream) {                                         \
    if (CHECK) return -1;                                                     \
    return launch<T, ND, MODE, CVX>(I, F, x, x_stride, nc, first, n_gaps, ss,\
                                    n_sub, D, Ja, Jb, lanes, smem_bytes,     \
                                    (cudaStream_t)stream);                    \
  }

