// K8 solve_ik: damped-least-squares (Levenberg-Marquardt) IK of one link
// pose per lane, each lane's whole loop in one launch.
//
// Replaces (JAX package, hand-shaped XLA routine):
//   kinematics/ik.py:34-83  solve_ik under vmap: a lax.while_loop per lane
//       of the pose error, its jax.jacfwd (:66), jnp.linalg.solve of the
//       n_e x n_e system J J' + lam^2 I (:68), the clamp, the error at the
//       new q, the accept test and lam's update
// The body is pose.cuh's ik_lane; pose_host.cpp runs it on a CPU.
//
// Design: a warp per lane, four to a CTA, the lane's state in shared
// memory.  Each iteration spreads the Jacobian's n_dof tangent columns
// over the warp's threads (a dual number per column through FK and the
// pose error); thread 0 then forms A = J J' + lam^2 I, solves it by
// Gaussian elimination with partial pivoting (as LAPACK's getrf, the
// first largest pivot), clamps q + J' y, evaluates the error there and
// updates lam; the warp's loop ends where the lane's does, so every lane
// keeps its own iteration count, as the while_loop under vmap.  Built with
// -fmad=false.
//
// Bound: operations (chip_smoke's ik_work, at the iterations run): per
// iteration n_dof dual FK columns, the n_e x n_e system and one value FK,
// ~10^4 flops per lane on ~10^2 bytes.

#include <cuda_runtime.h>

#include "pose.cuh"

using namespace pose;

constexpr int IK_WARPS = 4;

template <typename T>
__global__ void __launch_bounds__(32 * IK_WARPS)
solve_ik_kernel(const int* __restrict__ I, const T* __restrict__ F,
                PoseArgs<T> a, const T* __restrict__ q0,
                const T* __restrict__ lb, const T* __restrict__ ub,
                int max_iters, T tol, T damping, int ne, int nd, T* q,
                T* err, int* conv, int* iters, int lanes) {
  __shared__ IkMem<T> mem[IK_WARPS];
  const int w = threadIdx.x / 32;
  const int lane = blockIdx.x * IK_WARPS + w;
  if (lane >= lanes) return;  // the whole warp
  PoseArgs<T> al = a;
  al.tR += lane * 9;
  al.tp += lane * 3;
  ik_lane(I, F, al, q0 + lane * nd, lb, ub, max_iters, tol, damping, ne,
          q + lane * nd, err + lane, conv + lane, iters + lane, mem + w,
          threadIdx.x % 32, 32);
}

#define IK_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const int* I, const T* F, int link, const T* tR,       \
                      const T* tp, const T* q0, const T* lb, const T* ub,    \
                      int max_iters, double tol, double damping, int ne,     \
                      int nd, T* q, T* err, int* conv, int* iters,           \
                      int lanes, void* stream) {                              \
    if (nd > ND_MAX) return -1;                                               \
    if (lanes == 0) return 0;                                                 \
    PoseArgs<T> a{link, -1, tR, tp, nullptr, nullptr, nullptr, nullptr,      \
                  nullptr};                                                   \
    solve_ik_kernel<T><<<(lanes + IK_WARPS - 1) / IK_WARPS, 32 * IK_WARPS,  \
                         0, (cudaStream_t)stream>>>(                          \
        I, F, a, q0, lb, ub, max_iters, (T)tol, (T)damping, ne, nd, q, err,  \
        conv, iters, lanes);                                                  \
    return (int)cudaGetLastError();                                           \
  }

IK_ENTRY(solve_ik_f32, float)
IK_ENTRY(solve_ik_f64, double)

template <typename T>
static int attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, solve_ik_kernel<T>);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = (int)a.sharedSizeBytes;
  return 0;
}

// 0: float32, 1: float64; out as cart_pose_attrs
extern "C" int solve_ik_attrs(int which, int* out) {
  return which == 0 ? attrs<float>(out) : which == 1 ? attrs<double>(out) : -1;
}
