// The CVX instantiations of K4 cast_seg, K4v cast_seg_value and K5
// cast_sweep (for a world with CONVEX geometry: the two CONVEX routes of
// collision.cuh as device functions), and the route probe convex_route.
// The kernels are those of cast_seg.cu (cast_kernel.cuh); what they
// replace and what bounds them is described there.
//
// Replaces (JAX package, hand-shaped XLA routines), inside K4 / K4v / K5:
//   collision/geometry.py:490-507 + 796-814  d_convex_auto's generic
//     feature enumeration (a pair with a CONVEX side at each substate,
//     and the two-pose route when both sets have at most 12 vertices)
//   collision/geometry.py:172-307  d_convex_convex + _fw_weights, the
//     Frank-Wolfe max separation (the two-pose route beyond 12 vertices)
// Bound: operations, as K4's: an (8, 8) generic enumeration is 1,680
// candidates (~2 x 10^5 flops) in one thread; the Frank-Wolfe route
// ~2 x 10^4 flops at (8, 16).

#include "cast_kernel.cuh"

CAST_ENTRY(cast_seg_cvx_f32, float, ND_JAC, MODE_JAC, true, nd != ND_JAC)
CAST_ENTRY(cast_seg_cvx_f64, double, ND_JAC, MODE_JAC, true, nd != ND_JAC)
CAST_ENTRY(cast_seg_value_cvx_f32, float, 1, MODE_VALUE, true, false)
CAST_ENTRY(cast_seg_value_cvx_f64, double, 1, MODE_VALUE, true, false)
CAST_ENTRY(cast_sweep_cvx_f32, float, 1, MODE_SWEEP, true, false)
CAST_ENTRY(cast_sweep_cvx_f64, double, 1, MODE_SWEEP, true, false)


// the route probe: route 0 the generic feature enumeration, 1 Frank-Wolfe;
// V1 (rows, n1, 3), V2 (rows, n2, 3); D = value - (r1 + r2)
template <typename T>
__global__ void convex_route_kernel(const int* __restrict__ I,
                                    const T* __restrict__ F,
                                    const T* __restrict__ V1, int n1,
                                    const T* __restrict__ V2, int n2,
                                    const T* __restrict__ r1,
                                    const T* __restrict__ r2, int rows,
                                    int route, T* D) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  D[row] = convex_route_row(I, F, route == 1, V1 + (long)row * n1 * 3, n1,
                            V2 + (long)row * n2 * 3, n2) -
           (r1[row] + r2[row]);
}

#define ROUTE_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const int* I, const T* F, const T* V1, int n1,          \
                      const T* V2, int n2, const T* r1, const T* r2,          \
                      int rows, int route, T* D, void* stream) {             \
    if (n1 > CVX_MAXV || n2 > CVX_MAXV ||                                     \
        (route == 0 && (n1 > GENERIC_MAX || n2 > GENERIC_MAX)))               \
      return -1;                                                              \
    convex_route_kernel<T><<<(rows + THREADS - 1) / THREADS, THREADS, 0,     \
                             (cudaStream_t)stream>>>(I, F, V1, n1, V2, n2,   \
                                                     r1, r2, rows, route, D); \
    return (int)cudaGetLastError();                                           \
  }

ROUTE_ENTRY(convex_route_f32, float)
ROUTE_ENTRY(convex_route_f64, double)
