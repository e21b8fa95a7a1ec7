// K9 cart_pose and K9v cart_pose_value: the pose error rows of one
// cart_pose term at its step, for every lane, with (K9) or without (K9v)
// their Jacobian with respect to that step's joints.
//
// Replaces (JAX package, hand-shaped XLA routines):
//   K9   terms/cartesian.py:99-106  cart_pose_term's jac_fn: jax.jacfwd of
//        the step's pose error over its n_dof joints (FK of the source and
//        target links, the offsets, lie.transform_error with rot_log, the
//        band, the coefficients), scattered into the (6, n_x) rows
//   K9v  terms/cartesian.py:95-97   cart_pose_term's fn (the same error)
// The body is pose.cuh's cart_pose_item; pose_host.cpp runs it on a CPU.
//
// Design: a thread per (lane, tangent column) (K9; lanes x n_dof threads)
// or per lane (K9v), 128 to a CTA.  A thread walks the source's (and a
// moving target's) chain path with one dual tangent column, so it gives
// jacfwd's column bit for bit as a wider dual number would; the column-0
// thread also writes the value.  J's other columns are the caller's zeros.
// Built with -fmad=false, as the plain version computes every multiply
// and add apart.
//
// Bound: per lane ~10^3 flops of FK and pose error (K9: n_dof dual
// columns, ~3x each) on ~10^2 bytes of input: operations (chip_smoke's
// pose_work), far above the bytes of x, E and J.  It replaces the few
// hundred eager launches of FK, jacfwd and rot_log per term evaluation
// with one launch.

#include <cuda_runtime.h>

#include "pose.cuh"

using namespace pose;

constexpr int POSE_THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(POSE_THREADS)
cart_pose_kernel(const int* __restrict__ I, const T* __restrict__ F,
                 const T* __restrict__ x, long x_stride, int x_off,
                 PoseArgs<T> a, T* E, T* J, long ldj, int j_off, int lanes,
                 int ncol) {
  const long g = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long)lanes * ncol) return;
  const int lane = (int)(g / ncol), col = J ? (int)(g % ncol) : -1;
  PoseArgs<T> al = a;
  const long o9 = lane * 9L, o3 = lane * 3L, o6 = lane * 6L;
  al.tR += o9;
  al.tp += o3;
  if (al.soR) al.soR += o9, al.sop += o3;
  if (al.lo) al.lo += o6, al.hi += o6;
  if (al.coeffs) al.coeffs += o6;
  cart_pose_item(I, F, x, x_stride, x_off, al, E, J, ldj, j_off, lane, col);
}

// the C entry points: J null runs K9v (values only); the per-lane
// parameters are (lanes, 9), (lanes, 3) and (lanes, 6) rows
#define POSE_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const int* I, const T* F, const T* x, long x_stride,   \
                      int x_off, int nd, int src, int tgt, const T* tR,      \
                      const T* tp, const T* soR, const T* sop, const T* lo,  \
                      const T* hi, const T* coeffs, T* E, T* J, long ldj,    \
                      int j_off, int lanes, void* stream) {                   \
    const int ncol = J ? nd : 1;                                              \
    const long n = (long)lanes * ncol;                                        \
    if (n == 0) return 0;                                                     \
    PoseArgs<T> a{src, tgt, tR, tp, soR, sop, lo, hi, coeffs};                \
    cart_pose_kernel<T><<<(unsigned)((n + POSE_THREADS - 1) / POSE_THREADS), \
                          POSE_THREADS, 0, (cudaStream_t)stream>>>(          \
        I, F, x, x_stride, x_off, a, E, J, ldj, j_off, lanes, ncol);         \
    return (int)cudaGetLastError();                                           \
  }

POSE_ENTRY(cart_pose_f32, float)
POSE_ENTRY(cart_pose_f64, double)

// the registers and local memory of an instantiation (0: float32, 1:
// float64): out = [numRegs, localSizeBytes, maxThreadsPerBlock,
// sharedSizeBytes]
template <typename T>
static int attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, cart_pose_kernel<T>);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = (int)a.sharedSizeBytes;
  return 0;
}

extern "C" int cart_pose_attrs(int which, int* out) {
  return which == 0 ? attrs<float>(out) : which == 1 ? attrs<double>(out) : -1;
}
