// K8 solve_ik: damped-least-squares (Levenberg-Marquardt) IK of one link
// pose per lane, each lane's whole loop in one launch.
//
// Replaces (JAX package, hand-shaped XLA routine):
//   kinematics/ik.py:34-83  solve_ik under vmap: a lax.while_loop per lane
//       of the pose error, its jax.jacfwd (:66), jnp.linalg.solve of the
//       n_e x n_e system J J' + lam^2 I (:68), the clamp, the error at the
//       new q, the accept test and lam's update
// The body is pose.cuh's ik_team; pose_host.cpp runs it on a CPU.
//
// Design: a warp per lane, IK_WARPS (4) warps to a CTA (one warp to a
// CTA, 128 lanes on 128 of the H100's 132 SMs, measured no faster: each
// warp has an SM sub-partition of its own either way, and 128 CTAs cost
// more to launch and stage than 32).  The CTA first stages the link's
// chain path (joint types, dofs, 33 reals a link) in shared memory with
// asynchronous coalesced copies; the walk then makes no global load.
// Each iteration runs ONE dual evaluation, at the trial point: the
// Jacobian's n_dof tangent columns spread over the warp (a dual number per
// column through FK and the pose error), whose column 0 also gives the
// error there; an accepted step keeps that J and e for the next
// iteration, a rejected one keeps the old, so no evaluation repeats one
// the loop already made.  The joints' sines and cosines are formed first,
// a joint per lane (pose.cuh path_sincos), and each column is walked by a
// row team of 3 lanes (n_dof up to 10; of 1 above), each lane one row of
// every rotation and position along the chain (pose.cuh Rows).  The
// damped system is solved by the whole warp (pose.cuh ik_team: A's
// columns on their members from a shared copy of J, the pivot row, the
// row factors and the triangle broadcast by shuffles, every division over
// a reciprocal formed off the chain: qmath.cuh's qdiv_f, qdiv bit for bit
// or qdiv itself), each value by the plain loop's operations in its
// order, so every output is the same as the loop that evaluates e and J
// anew at each q.  The warp's loop ends
// where the lane's does, so every lane keeps its own iteration count, as
// the while_loop under vmap.  Built with -fmad=false.
// -DIK_TIMED=1 builds the phase timer (pose.cuh IkClock; library
// solve_ik_timer, entry solve_ik_timed_f32).
//
// Bound: operations (chip_smoke's ik_work, at the iterations run): per
// iteration n_dof dual FK columns, the n_e x n_e system and the error's
// norm, ~10^4 flops per lane on ~10^2 bytes.  The lanes run in parallel,
// but a lane's iterations are a chain: its latency floor is the slowest
// lane's iterations times one dual evaluation.

#include <cuda_runtime.h>

#include "pose.cuh"

using namespace pose;

constexpr int IK_WARPS = 4;
constexpr size_t MAX_SMEM = 232448;  // the H100's per-block limit

template <typename T, int NE, int RT>
__global__ void __launch_bounds__(32 * IK_WARPS) solve_ik_kernel(IkArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rs = reinterpret_cast<T*>(smem_raw);
  const long team = ik_team_reals(a.plen);
  int* is = reinterpret_cast<int*>(rs + (long)LINK_R * a.plen +
                                   IK_WARPS * team);
  const Path<T> pa = stage_path(a.I, a.F, a.link, rs, is, is + 2 * a.plen,
                                threadIdx.x, blockDim.x);
  __syncthreads();
  const int w = threadIdx.x / 32, lane = blockIdx.x * IK_WARPS + w;
  if (lane >= a.lanes) return;  // the whole warp
  ik_team<T, NE, 32, RT>(a, pa, lane,
                     rs + (long)LINK_R * a.plen + w * team,
                     threadIdx.x % 32);
}

template <typename T, int NE, int RT>
static int launch_rt(const IkArgs<T>& a, cudaStream_t s) {
  const long bytes = ik_smem_bytes<T>(a.plen, IK_WARPS);
  if (bytes > (long)MAX_SMEM) return -1;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        solve_ik_kernel<T, NE, RT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  solve_ik_kernel<T, NE, RT><<<(a.lanes + IK_WARPS - 1) / IK_WARPS,
                               32 * IK_WARPS, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

// row teams of 3 up to 10 dofs, of 1 above
template <typename T, int NE>
static int launch(const IkArgs<T>& a, cudaStream_t s) {
  return a.nd <= ik_nd_max<32, 3>() ? launch_rt<T, NE, 3>(a, s)
                                    : launch_rt<T, NE, 1>(a, s);
}

// the C entry points (-1: n_dof outside 1..ND_MAX, n_e not 3 or 6, or a
// path the shared memory cannot hold); the timed build's take clk
// (lanes, IK_PHASES) last
#if IK_TIMED
#define IK_CLK_ARG , long long* clk
#define IK_CLK clk
#else
#define IK_CLK_ARG
#define IK_CLK nullptr
#endif
#define IK_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const int* I, const T* F, int link, int plen,          \
                      const T* tR, const T* tp, const T* q0, const T* lb,    \
                      const T* ub, int max_iters, double tol, double damping, \
                      int ne, int nd, T* q, T* err, int* conv, int* iters,    \
                      int lanes, void* stream IK_CLK_ARG) {                   \
    if (nd < 1 || nd > ND_MAX || (ne != 3 && ne != 6) || plen < 1)            \
      return -1;                                                              \
    if (lanes == 0) return 0;                                                 \
    const IkArgs<T> a{I,    F,    link, plen, tR,    tp,  q0,                 \
                      lb,   ub,   max_iters, (T)tol, (T)damping, nd, lanes,   \
                      q,    err,  conv, iters, IK_CLK};                       \
    cudaStream_t s = (cudaStream_t)stream;                                    \
    return ne == 3 ? launch<T, 3>(a, s) : launch<T, 6>(a, s);                 \
  }

#if IK_TIMED
IK_ENTRY(solve_ik_timed_f32, float)
#else
IK_ENTRY(solve_ik_f32, float)
IK_ENTRY(solve_ik_f64, double)
#endif

template <typename T, int NE, int RT>
static int attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, solve_ik_kernel<T, NE, RT>);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = (int)a.sharedSizeBytes;
  return 0;
}

// the attributes of instantiation which / 2: 0 the full pose (n_e 6) at
// row teams of 3 (n_dof up to 10), 1 the full pose at row teams of 1
// (n_dof 11-12), 2 and 3 pos_only (n_e 3) likewise; which % 2 0: float32,
// 1: float64 (-1: no such instantiation); out as cart_pose_attrs
template <typename T>
static int attrs_of(int k, int* out) {
  switch (k) {
    case 0: return attrs<T, 6, 3>(out);
    case 1: return attrs<T, 6, 1>(out);
    case 2: return attrs<T, 3, 3>(out);
    case 3: return attrs<T, 3, 1>(out);
    default: return -1;
  }
}

extern "C" int solve_ik_attrs(int which, int* out) {
  if (which < 0) return -1;
  return which % 2 == 0 ? attrs_of<float>(which / 2, out)
                        : attrs_of<double>(which / 2, out);
}
