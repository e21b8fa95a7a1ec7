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
// The body is pose.cuh's cart_stage / cart_item; pose_host.cpp runs it on
// a CPU.
//
// Design: a work item per (lane, tangent column) (K9; lanes x n_dof items)
// or per lane (K9v), CART_ITEMS (32) to a CTA, so that 128 lanes spread
// over 4 (K9v) or 28 (K9 at n_dof 7) SMs; an item is a row team of 3
// lanes (and a fourth that repeats row 2), each of which computes one row
// of every rotation and position along the chain, the poses then
// gathered by shuffles (pose.cuh Rows).  Each CTA first stages the
// source's chain path (and a moving target's) in shared memory, by
// asynchronous coalesced copies that are all in flight at once, and forms
// its lanes' joints' sines and cosines there (pose.cuh cart_stage); a
// walk then makes no dependent global load (an item reads its lane's
// joints and parameters from global memory, each once or from L1).
// Staging the joints and parameters too was measured no faster.  An item
// walks the path with one dual tangent
// column, so it gives jacfwd's column bit for bit as a wider dual number
// would; the column-0 item also writes the value.  J's other columns
// are the caller's zeros.  Built with -fmad=false, as the plain version
// computes every multiply and add apart.
//
// Bound: per lane ~10^3 flops of FK and pose error (K9: n_dof dual
// columns, ~3x each) on ~10^2 bytes of input: operations (chip_smoke's
// pose_work), far above the bytes of x, E and J.  It replaces the few
// hundred eager launches of FK, jacfwd and rot_log per term evaluation
// with one launch.

#include <cuda_runtime.h>

#include "pose.cuh"

using namespace pose;

constexpr size_t MAX_SMEM = 232448;  // the H100's per-block limit

constexpr int CTA = CART_ITEMS * CART_TEAM;

template <typename T>
__global__ void __launch_bounds__(CTA) cart_pose_kernel(CartArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rs = reinterpret_cast<T*>(smem_raw);
  int* is = reinterpret_cast<int*>(rs + cart_reals(a));
  const CartBlock<T> b = cart_stage(a, blockIdx.x, rs, is, threadIdx.x, CTA);
  __syncthreads();
  const long g = (long)blockIdx.x * CART_ITEMS + threadIdx.x / CART_TEAM;
  const int m = threadIdx.x % CART_TEAM, base = threadIdx.x % 32 - m;
  const Rows<3> tm{m < 3 ? m : 2, base, 0xfu << base};
  if (g < (long)a.lanes * (a.J ? a.nd : 1)) cart_item(a, b, g, tm);
}

// the C entry points: J null runs K9v (values only); the per-lane
// parameters are (lanes, 9), (lanes, 3) and (lanes, 6) rows; plen the
// links on the source's path and a moving target's (-1: tables the shared
// memory cannot hold)
#define POSE_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const int* I, const T* F, const T* x, long x_stride,   \
                      int x_off, int nd, int src, int tgt, int plen,         \
                      const T* tR, const T* tp, const T* soR, const T* sop,  \
                      const T* lo, const T* hi, const T* coeffs, T* E, T* J, \
                      long ldj, int j_off, int lanes, void* stream) {         \
    const long n = (long)lanes * (J ? nd : 1);                                \
    if (n == 0) return 0;                                                     \
    const CartArgs<T> a{I,  F,  x,  x_stride, x_off, nd,     src,  tgt,      \
                        plen, tR, tp, soR,    sop,   lo,     hi,   coeffs,   \
                        E,  J,  ldj, j_off,   lanes};                         \
    const long bytes = cart_smem_bytes(a);                                    \
    if (bytes > (long)MAX_SMEM) return -1;                                    \
    if (bytes > 48 * 1024) {                                                  \
      const cudaError_t e = cudaFuncSetAttribute(                             \
          cart_pose_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,   \
          (int)bytes);                                                        \
      if (e != cudaSuccess) return (int)e;                                    \
    }                                                                         \
    cart_pose_kernel<T><<<(unsigned)((n + CART_ITEMS - 1) / CART_ITEMS),     \
                          CTA, bytes, (cudaStream_t)stream>>>(a);            \
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
