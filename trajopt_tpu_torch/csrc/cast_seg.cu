// K4 cast_seg, K4v cast_seg_value, K5 cast_sweep: the swept collision
// distances of the cast terms and of the trajectory gate, fused per
// (lane, step gap).
//
// Replaces (JAX package, hand-shaped XLA routines):
//   K4  terms/collision.py:165-181  CastDistancePre.value_jac — swept
//       distance per (gap, segment, pair) and its Jacobian wrt both gap
//       endpoints (jacfwd over collision/world.py:196-221 + 265-382)
//   K4v terms/collision.py:159-163  CastDistancePre.value
//   K5  terms/collision.py:548-564  trajectory_in_collision over
//       collision/world.py:223-239 cast_pair_distances (n_sub substates)
//
// Design: one block per (lane, gap).  Phase A: one thread per slot
// (substate, or the exact end pose for K5) runs FK and the joint frames
// and writes the canonical world geometry to shared memory.  Phase B: one
// thread per (slot, pair) evaluates the discrete pair distance — with K4
// as a dual number carrying n_dof tangent columns seeded from the point
// Jacobians z_d x (v - o_d).  Phase C: one thread per (segment, pair)
// takes the substate min, applies the pair's static sweep route (exact
// sphere sweep with 2 n_dof columns; or the two-pose hull feature
// distance, whose Jacobian is the witness-linear form) and writes D and
// the Jacobian rows, split onto qa and qb by the substate fractions.
//
// Bound: the work is ~10^4-10^5 flops per (lane, gap) on a few hundred
// bytes of input, so the bound is operations (the float32 / float64 CUDA
// core rates), far above the bytes of x, D, Ja and Jb.  This first version
// keeps the dual numbers in registers and local memory; the pair threads
// of one block diverge by route.

#include <cuda_runtime.h>

#include "collision.cuh"

using namespace coll;

enum { MODE_JAC = 0, MODE_VALUE = 1, MODE_SWEEP = 2 };
constexpr int THREADS = 128;
constexpr int ND_JAC = 7;  // n_dof of the Jacobian variant (7-DoF arms)

template <typename T, int ND, int MODE>
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
    discrete_item<T, ND, MODE == MODE_JAC>(I, F, slots, it / P, it % P, dsub,
                                            dtan);
  __syncthreads();
  const long gap = (long)lane * n_gaps + g;
  if (MODE == MODE_SWEEP) {
    for (int p = threadIdx.x; p < P; p += blockDim.x)
      sweep_item(I, F, slots, n_sub, p, dsub, D + gap * P);
  } else {
    const int n_seg = n_sub - 1;
    const long rows = (long)n_seg * P;
    for (int it = threadIdx.x; it < n_seg * P; it += blockDim.x)
      segment_item<T, ND, MODE == MODE_JAC>(
          I, F, slots, ss, it / P, it % P, dsub, dtan, D + gap * rows,
          MODE == MODE_JAC ? Ja + gap * rows * nc : nullptr,
          MODE == MODE_JAC ? Jb + gap * rows * nc : nullptr, nc);
  }
}

template <typename T, int ND, int MODE>
static int launch(const int* I, const T* F, const T* x, long x_stride, int nc,
                  int first, int n_gaps, const T* ss, int n_sub, T* D, T* Ja,
                  T* Jb, int lanes, int smem_bytes, cudaStream_t stream) {
  auto kern = cast_kernel<T, ND, MODE>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<lanes * n_gaps, THREADS, smem_bytes, stream>>>(
      I, F, x, x_stride, nc, first, n_gaps, ss, n_sub, D, Ja, Jb);
  return (int)cudaGetLastError();
}

#define CAST_ENTRY(NAME, T, ND, MODE, CHECK)                                  \
  extern "C" int NAME(const int* I, const T* F, const T* x, long x_stride,   \
                      int nc, int first, int n_gaps, const T* ss, int n_sub, \
                      T* D, T* Ja, T* Jb, int lanes, int nd, int smem_bytes, \
                      void* stream) {                                         \
    if (CHECK) return -1;                                                     \
    return launch<T, ND, MODE>(I, F, x, x_stride, nc, first, n_gaps, ss,     \
                               n_sub, D, Ja, Jb, lanes, smem_bytes,          \
                               (cudaStream_t)stream);                         \
  }

CAST_ENTRY(cast_seg_f32, float, ND_JAC, MODE_JAC, nd != ND_JAC)
CAST_ENTRY(cast_seg_f64, double, ND_JAC, MODE_JAC, nd != ND_JAC)
CAST_ENTRY(cast_seg_value_f32, float, 1, MODE_VALUE, false)
CAST_ENTRY(cast_seg_value_f64, double, 1, MODE_VALUE, false)
CAST_ENTRY(cast_sweep_f32, float, 1, MODE_SWEEP, false)
CAST_ENTRY(cast_sweep_f64, double, 1, MODE_SWEEP, false)
