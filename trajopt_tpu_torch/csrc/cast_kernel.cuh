// The cast kernels' launchers (K4 cast_seg, K4v cast_seg_value, K5
// cast_sweep), shared by cast_seg.cu (the instantiations without the
// CONVEX routes) and cast_cvx.cu (the CVX instantiations and the route
// probe): two sources, so that nvcc builds them in parallel.  The block's
// body is cast_block.cuh's; the design and bounds are described in
// cast_seg.cu.
#pragma once

#include <cuda_runtime.h>

#include "cast_block.cuh"

using namespace coll;

// the blocks the card takes: 64 or 128 threads, in teams of 4, 8, 16 or
// 32 lanes of a warp
static bool card_block(int threads, int team) {
  return (threads == 64 || threads == CAST_THREADS) &&
         (team == 4 || team == 8 || team == 16 || team == 32);
}

// The CTAs per SM each instantiation's registers are sized for (its second
// launch bound).  float32 without the CONVEX routes: K4 and K5 take the
// registers they need and K4v those of seven 128-thread CTAs (73), so none
// spills to local memory; float32 CVX: ptxas's own choice (72 / 64
// registers), measured faster than more registers there; float64: as many
// as needed (the measurements: PERF.md section 6).
template <typename T, int MODE, bool CVX>
constexpr int cast_min_blocks() {
  return sizeof(T) == 8 ? 1
         : CVX          ? (MODE == MODE_JAC ? 7 : 8)
                        : (MODE == MODE_VALUE ? 7 : 1);
}

// one CTA (blockDim.x threads, in teams of `team` lanes) per (lane, gap)
template <typename T, int ND, int MODE, bool CVX>
__global__ void __launch_bounds__(CAST_THREADS,
                                  cast_min_blocks<T, MODE, CVX>())
cast_kernel(const int* __restrict__ I, const T* __restrict__ F,
            const T* __restrict__ x, long x_stride, int nc, int first,
            int n_gaps, const T* __restrict__ ss, int n_sub, T* D, T* Ja,
            T* Jb, int team, long long* clk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cast_gap<T, ND, MODE, CVX>(I, F, x, x_stride, nc, first, n_gaps, ss, n_sub,
                             D, Ja, Jb, blockIdx.x / n_gaps,
                             blockIdx.x % n_gaps, smem_raw, blockDim.x, team,
                             clk == nullptr ? clk : clk + 4 * blockIdx.x);
}

template <typename T, int ND, int MODE, bool CVX>
static int launch(const int* I, const T* F, const T* x, long x_stride, int nc,
                  int first, int n_gaps, const T* ss, int n_sub, T* D, T* Ja,
                  T* Jb, int lanes, int L, int nd, int NG, int P,
                  int threads, int team, long long* clk,
                  cudaStream_t stream) {
  auto kern = cast_kernel<T, ND, MODE, CVX>;
  const long smem = cast_smem_bytes<T, ND, MODE>(L, nd, NG, P, n_sub,
                                                 threads / team);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<lanes * n_gaps, threads, smem, stream>>>(
      I, F, x, x_stride, nc, first, n_gaps, ss, n_sub, D, Ja, Jb, team, clk);
  return (int)cudaGetLastError();
}

// the C entry points (-1: an instantiation or block the card does not
// take); clk (optional): the phase timer, 4 clock64 stamps per CTA (start,
// after phase A, after B, after C)
#define CAST_ENTRY(NAME, T, ND, MODE, CVX, CHECK)                             \
  extern "C" int NAME(const int* I, const T* F, const T* x, long x_stride,   \
                      int nc, int first, int n_gaps, const T* ss, int n_sub, \
                      T* D, T* Ja, T* Jb, int lanes, int L, int nd, int NG,  \
                      int P, int threads, int team, long long* clk,          \
                      void* stream) {                                         \
    if ((CHECK) || !card_block(threads, team)) return -1;                     \
    return launch<T, ND, MODE, CVX>(I, F, x, x_stride, nc, first, n_gaps, ss,\
                                    n_sub, D, Ja, Jb, lanes, L, nd, NG, P,   \
                                    threads, team, clk,                       \
                                    (cudaStream_t)stream);                    \
  }

// the registers and local memory of an instantiation (cudaFuncGetAttributes):
// out = [numRegs, localSizeBytes, maxThreadsPerBlock, sharedSizeBytes]
template <typename T, int ND, int MODE, bool CVX>
static int attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e =
      cudaFuncGetAttributes(&a, cast_kernel<T, ND, MODE, CVX>);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = (int)a.sharedSizeBytes;
  return 0;
}

// K4's launch: the Jacobian's tangent columns are a template parameter,
// instantiated at ND_JAC (the 7-DoF arms) exactly and at the ceiling
// ND_MAX, which takes every other n_dof from 1 to ND_MAX (counted at run
// time).  The ceiling's instantiations build apart (-DCAST_CEIL: the
// libraries cast_seg_ceil / cast_cvx_ceil), so that nvcc builds them in
// parallel with the others; each library returns -1 for an n_dof it does
// not take
#ifdef CAST_CEIL
constexpr bool CEIL = true;
#else
constexpr bool CEIL = false;
#endif
template <typename T, bool CVX>
static int launch_jac(const int* I, const T* F, const T* x, long x_stride,
                      int nc, int first, int n_gaps, const T* ss, int n_sub,
                      T* D, T* Ja, T* Jb, int lanes, int L, int nd, int NG,
                      int P, int threads, int team, long long* clk,
                      cudaStream_t stream) {
  if constexpr (!CEIL) {
    if (nd == ND_JAC)
      return launch<T, ND_JAC, MODE_JAC, CVX>(I, F, x, x_stride, nc, first,
                                              n_gaps, ss, n_sub, D, Ja, Jb,
                                              lanes, L, nd, NG, P, threads,
                                              team, clk, stream);
  } else {
    if (nd != ND_JAC && nd >= 1 && nd <= ND_MAX)
      return launch<T, ND_MAX, MODE_JAC, CVX>(I, F, x, x_stride, nc, first,
                                              n_gaps, ss, n_sub, D, Ja, Jb,
                                              lanes, L, nd, NG, P, threads,
                                              team, clk, stream);
  }
  return -1;
}

#define CAST_JAC_ENTRY(NAME, T, CVX)                                          \
  extern "C" int NAME(const int* I, const T* F, const T* x, long x_stride,   \
                      int nc, int first, int n_gaps, const T* ss, int n_sub, \
                      T* D, T* Ja, T* Jb, int lanes, int L, int nd, int NG,  \
                      int P, int threads, int team, long long* clk,          \
                      void* stream) {                                         \
    if (!card_block(threads, team)) return -1;                                \
    return launch_jac<T, CVX>(I, F, x, x_stride, nc, first, n_gaps, ss,      \
                              n_sub, D, Ja, Jb, lanes, L, nd, NG, P, threads,\
                              team, clk, (cudaStream_t)stream);               \
  }

// which: 0..5 = cast_seg f32, f64, cast_seg_value f32, f64, cast_sweep f32,
// f64 of this source's instantiations (-DCAST_CEIL: 0, 1 = cast_seg f32,
// f64 at the n_dof ceiling ND_MAX)
template <bool CVX>
static int attrs_of(int which, int* out) {
  if constexpr (CEIL) {
    switch (which) {
      case 0: return attrs<float, ND_MAX, MODE_JAC, CVX>(out);
      case 1: return attrs<double, ND_MAX, MODE_JAC, CVX>(out);
      default: return -1;
    }
  } else {
    switch (which) {
      case 0: return attrs<float, ND_JAC, MODE_JAC, CVX>(out);
      case 1: return attrs<double, ND_JAC, MODE_JAC, CVX>(out);
      case 2: return attrs<float, 1, MODE_VALUE, CVX>(out);
      case 3: return attrs<double, 1, MODE_VALUE, CVX>(out);
      case 4: return attrs<float, 1, MODE_SWEEP, CVX>(out);
      case 5: return attrs<double, 1, MODE_SWEEP, CVX>(out);
      default: return -1;
    }
  }
}

#define ATTRS_ENTRY(NAME, CVX) \
  extern "C" int NAME(int which, int* out) { return attrs_of<CVX>(which, out); }
