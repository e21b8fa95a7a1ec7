// The CVX instantiations of K4 cast_seg, K4v cast_seg_value and K5
// cast_sweep (for a world with CONVEX geometry: the two CONVEX routes of
// collision.cuh as team routines of cast_block.cuh), and the route probe
// convex_route.  The kernels are those of cast_seg.cu (cast_kernel.cuh);
// what they replace and what bounds them is described there.
//
// Replaces (JAX package, hand-shaped XLA routines), inside K4 / K4v / K5:
//   collision/geometry.py:490-507 + 796-814  d_convex_auto's generic
//     feature enumeration (a pair with a CONVEX side at each substate,
//     and the two-pose route when both sets have at most 12 vertices)
//   collision/geometry.py:172-307  d_convex_convex + _fw_weights, the
//     Frank-Wolfe max separation (the two-pose route beyond 12 vertices)
// Bound: operations, as K4's: an (8, 8) generic enumeration is 1,680
// candidates (~2 x 10^5 flops), now a share per lane of its team; the
// Frank-Wolfe route ~2 x 10^4 flops at (8, 16), its support scans strided
// over the team (the weights' sums keep the serial order in every lane).

#include "cast_kernel.cuh"

// -DCAST_CEIL: K4 CVX at the n_dof ceiling alone (the library
// cast_cvx_ceil)
CAST_JAC_ENTRY(cast_seg_cvx_f32, float, true)
CAST_JAC_ENTRY(cast_seg_cvx_f64, double, true)
ATTRS_ENTRY(cast_cvx_attrs, true)
#ifndef CAST_CEIL
CAST_ENTRY(cast_seg_value_cvx_f32, float, 1, MODE_VALUE, true, false)
CAST_ENTRY(cast_seg_value_cvx_f64, double, 1, MODE_VALUE, true, false)
CAST_ENTRY(cast_sweep_cvx_f32, float, 1, MODE_SWEEP, true, false)
CAST_ENTRY(cast_sweep_cvx_f64, double, 1, MODE_SWEEP, true, false)

// the route probe: route 0 the generic feature enumeration, 1 Frank-Wolfe;
// V1 (rows, n1, 3), V2 (rows, n2, 3); D = value - (r1 + r2); K (optional)
// the witness index; one team per row, threads / team rows per CTA
template <typename T>
__global__ void __launch_bounds__(CAST_THREADS)
convex_route_kernel(const int* __restrict__ I, const T* __restrict__ F,
                    const T* __restrict__ V1, int n1,
                    const T* __restrict__ V2, int n2,
                    const T* __restrict__ r1, const T* __restrict__ r2,
                    int rows, int route, T* D, int* K, int team) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  route_block(I, F, route == 1, V1, n1, V2, n2, r1, r2, rows, D, K,
              (int)blockIdx.x, (int)gridDim.x, smem_raw, (int)blockDim.x,
              team);
}

#define ROUTE_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const int* I, const T* F, const T* V1, int n1,          \
                      const T* V2, int n2, const T* r1, const T* r2,          \
                      int rows, int route, T* D, int* K, int threads,        \
                      int team, void* stream) {                               \
    if (n1 > CVX_MAXV || n2 > CVX_MAXV || !card_block(threads, team) ||       \
        (route == 0 && (n1 > GENERIC_MAX || n2 > GENERIC_MAX)))               \
      return -1;                                                              \
    const int per = threads / team;                                           \
    const long smem = per * (long)sizeof(TeamMem<T>);                         \
    if (smem > 48 * 1024) {                                                   \
      cudaError_t e = cudaFuncSetAttribute(                                   \
          convex_route_kernel<T>,                                             \
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);            \
      if (e != cudaSuccess) return (int)e;                                    \
    }                                                                         \
    convex_route_kernel<T><<<(rows + per - 1) / per, threads, smem,          \
                             (cudaStream_t)stream>>>(I, F, V1, n1, V2, n2,   \
                                                     r1, r2, rows, route, D, \
                                                     K, team);                \
    return (int)cudaGetLastError();                                           \
  }

ROUTE_ENTRY(convex_route_f32, float)
ROUTE_ENTRY(convex_route_f64, double)
#endif
