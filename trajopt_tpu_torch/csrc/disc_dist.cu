// K7 disc_dist and K7v disc_dist_value: the discrete collision terms'
// distances per (lane, step), fused.
//
// Replaces (JAX package, hand-shaped XLA routines):
//   K7  terms/collision.py:117-128  DiscreteDistancePre.value_jac — each
//       pair's signed distance at one step and its Jacobian wrt that
//       step's dofs (jacfwd over collision/world.py:171-175
//       pair_distances, through kinematics/chain.py's FK)
//   K7v terms/collision.py:114-115  DiscreteDistancePre.value
// The block's body is cast_block.cuh's disc_step, over the device
// functions of collision.cuh that K4 runs in its phases A and B (the chain,
// the joint frames and world records, the closed-form pair distances with
// one dual tangent column per thread); cast_host.cpp runs it on a CPU.
//
// Design: one CTA per (lane, step) (128 on the spherebot's single step,
// 3,840 on arm7 at T = 30), of DISC_THREADS threads: one thread runs the
// chain (a few hundred flops per link, in link order), a thread per dof
// and per geometry the joint frames and world records into shared memory,
// then a thread per (pair, tangent column) the closed form at that slot.
// n_dof is read from the world's tables, so one instantiation takes the
// spherebot (2), the 7-DoF arms and the 9-DoF rail.  Built with
// -fmad=false, as the plain version computes every multiply and add apart.
//
// Bound: per (lane, step) ~2 x 10^3 flops of FK and ~10^2-10^3 per pair
// and column (capsule-box: 12 projections) on ~10^2 bytes of input, so the
// bound is operations (chip_smoke's disc_work), far above the bytes of x,
// D and J.  What the design does about it: no thread carries more than one
// tangent column, the pairs' columns fill the block; the chain, serial by
// nature, runs once per step.
// Not instantiated: a world with CONVEX geometry (a CONVEX side takes a
// team route, cast_block.cuh's, which K7 does not run; the wrapper raises).

#include <cuda_runtime.h>

#include "cast_block.cuh"

using namespace coll;

template <typename T, bool JAC>
__global__ void __launch_bounds__(CAST_THREADS)
disc_kernel(const int* __restrict__ I, const T* __restrict__ F,
            const T* __restrict__ x, long x_stride, int nc, int first,
            int span, T* D, T* J) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  disc_step<T, JAC>(I, F, x, x_stride, nc, first, span, D, J,
                    blockIdx.x / span, blockIdx.x % span, smem_raw,
                    blockDim.x);
}

// the C entry points (-1: a block the kernel does not take); the block's
// threads a multiple of 32 up to CAST_THREADS
#define DISC_ENTRY(NAME, T, JAC)                                              \
  extern "C" int NAME(const int* I, const T* F, const T* x, long x_stride,   \
                      int nc, int first, int span, T* D, T* J, int lanes,    \
                      int L, int nd, int NG, int P, int threads,             \
                      void* stream) {                                         \
    (void)P;                                                                  \
    if (threads < 32 || threads > CAST_THREADS || threads % 32) return -1;    \
    const long smem = (long)slot_size_of(L, nd, NG) * (long)sizeof(T);       \
    disc_kernel<T, JAC><<<lanes * span, threads, smem,                       \
                          (cudaStream_t)stream>>>(I, F, x, x_stride, nc,     \
                                                  first, span, D, J);        \
    return (int)cudaGetLastError();                                           \
  }

DISC_ENTRY(disc_dist_f32, float, true)
DISC_ENTRY(disc_dist_f64, double, true)
DISC_ENTRY(disc_dist_value_f32, float, false)
DISC_ENTRY(disc_dist_value_f64, double, false)

// the registers and local memory of an instantiation (which: 0..3 =
// disc_dist f32, f64, disc_dist_value f32, f64): out = [numRegs,
// localSizeBytes, maxThreadsPerBlock, sharedSizeBytes]
template <typename T, bool JAC>
static int attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, disc_kernel<T, JAC>);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = (int)a.sharedSizeBytes;
  return 0;
}

extern "C" int disc_dist_attrs(int which, int* out) {
  switch (which) {
    case 0: return attrs<float, true>(out);
    case 1: return attrs<double, true>(out);
    case 2: return attrs<float, false>(out);
    case 3: return attrs<double, false>(out);
    default: return -1;
  }
}
