// Host build of the cast kernels' device code (collision.cuh), for
// checking its arithmetic on a CPU against the plain PyTorch version.
//
// The same entry points as cast_seg.cu (same arguments, same output
// layouts), run serially: for each (lane, gap) the three phases of the
// CUDA block (fill the slots; the discrete distance per (slot, pair); the
// routes per (segment, pair), or per pair for cast_sweep) run one after
// another.  Compiled with a C++ compiler by _native.host_library; it is
// not on any path that solves a problem.

#include <vector>

#include "collision.cuh"

using namespace coll;

enum { MODE_JAC = 0, MODE_VALUE = 1, MODE_SWEEP = 2 };
constexpr int ND_JAC = 7;

template <typename T, int ND, int MODE, bool CVX>
static int run(const int* I, const T* F, const T* x, long x_stride, int nc,
               int first, int n_gaps, const T* ss, int n_sub, T* D, T* Ja,
               T* Jb, int lanes) {
  const int P = I[3], sz = slot_size(I);
  const int n_slots = MODE == MODE_SWEEP ? n_sub + 1 : n_sub;
  std::vector<T> mem(n_slots * sz + n_sub * P * (1 + (MODE == MODE_JAC ? ND : 0)));
  T* slots = mem.data();
  T* dsub = slots + n_slots * sz;
  T* dtan = dsub + n_sub * P;
  for (int lane = 0; lane < lanes; ++lane)
    for (int g = 0; g < n_gaps; ++g) {
      const T* qa = x + lane * x_stride + (first + g) * nc;
      const T* qb = qa + nc;
      for (int s = 0; s < n_slots; ++s)
        slot_fill(I, F, qa, qb, ss, s, n_sub, slots + s * sz);
      for (int it = 0; it < n_sub * P; ++it)
        discrete_item<T, ND, MODE == MODE_JAC, CVX>(I, F, slots, it / P,
                                                     it % P, dsub, dtan);
      const long gap = (long)lane * n_gaps + g;
      if (MODE == MODE_SWEEP) {
        for (int p = 0; p < P; ++p)
          sweep_item<T, CVX>(I, F, slots, n_sub, p, dsub, D + gap * P);
      } else {
        const long rows = (long)(n_sub - 1) * P;
        for (int it = 0; it < rows; ++it)
          segment_item<T, ND, MODE == MODE_JAC, CVX>(
              I, F, slots, ss, it / P, it % P, dsub, dtan, D + gap * rows,
              MODE == MODE_JAC ? Ja + gap * rows * nc : nullptr,
              MODE == MODE_JAC ? Jb + gap * rows * nc : nullptr, nc);
      }
    }
  return 0;
}

#define HOST_ENTRY(NAME, T, ND, MODE, CVX, CHECK)                            \
  extern "C" int NAME(const int* I, const T* F, const T* x, long x_stride,   \
                      int nc, int first, int n_gaps, const T* ss, int n_sub, \
                      T* D, T* Ja, T* Jb, int lanes, int nd, int, void*) {   \
    if (CHECK) return -1;                                                     \
    return run<T, ND, MODE, CVX>(I, F, x, x_stride, nc, first, n_gaps, ss,   \
                                 n_sub, D, Ja, Jb, lanes);                    \
  }

HOST_ENTRY(cast_seg_f32, float, ND_JAC, MODE_JAC, false, nd != ND_JAC)
HOST_ENTRY(cast_seg_f64, double, ND_JAC, MODE_JAC, false, nd != ND_JAC)
HOST_ENTRY(cast_seg_value_f32, float, 1, MODE_VALUE, false, false)
HOST_ENTRY(cast_seg_value_f64, double, 1, MODE_VALUE, false, false)
HOST_ENTRY(cast_sweep_f32, float, 1, MODE_SWEEP, false, false)
HOST_ENTRY(cast_sweep_f64, double, 1, MODE_SWEEP, false, false)
HOST_ENTRY(cast_seg_cvx_f32, float, ND_JAC, MODE_JAC, true, nd != ND_JAC)
HOST_ENTRY(cast_seg_cvx_f64, double, ND_JAC, MODE_JAC, true, nd != ND_JAC)
HOST_ENTRY(cast_seg_value_cvx_f32, float, 1, MODE_VALUE, true, false)
HOST_ENTRY(cast_seg_value_cvx_f64, double, 1, MODE_VALUE, true, false)
HOST_ENTRY(cast_sweep_cvx_f32, float, 1, MODE_SWEEP, true, false)
HOST_ENTRY(cast_sweep_cvx_f64, double, 1, MODE_SWEEP, true, false)

// the route probe of cast_seg.cu, row by row
#define ROUTE_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const int* I, const T* F, const T* V1, int n1,          \
                      const T* V2, int n2, const T* r1, const T* r2,          \
                      int rows, int route, T* D, void*) {                    \
    if (n1 > CVX_MAXV || n2 > CVX_MAXV ||                                     \
        (route == 0 && (n1 > GENERIC_MAX || n2 > GENERIC_MAX)))               \
      return -1;                                                              \
    for (int row = 0; row < rows; ++row)                                      \
      D[row] = convex_route_row(I, F, route == 1, V1 + (long)row * n1 * 3,   \
                                n1, V2 + (long)row * n2 * 3, n2) -           \
               (r1[row] + r2[row]);                                           \
    return 0;                                                                 \
  }

ROUTE_ENTRY(convex_route_f32, float)
ROUTE_ENTRY(convex_route_f64, double)
