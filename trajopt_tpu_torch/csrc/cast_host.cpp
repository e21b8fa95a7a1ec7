// Host build of the cast kernels and of K7 / K7v (cast_block.cuh and
// disc_block.cuh over collision.cuh), for checking them on a CPU against the plain PyTorch
// version.
//
// The same entry points as cast_seg.cu / cast_cvx.cu / disc_dist.cu (same
// arguments, same output layouts), and the same block body: each (lane,
// gap) runs cast_gap (each block of (lane, step) slots disc_block) with
// the block played by one thread, stage by stage.  `threads`
// and `team` set the layout: team 1 is one thread that is the whole block
// and its only team; a team of t > 1 (t dividing threads, at most
// CAST_TEAM) runs `threads` threads in teams of t, each thread's share in
// turn, as the card divides the work.  The outputs are bitwise equal at
// every layout.  Compiled with a C++
// compiler by _native.host_library; it is not on any path that solves a
// problem.

#include <vector>

#include "disc_block.cuh"

using namespace coll;

static bool host_block(int threads, int team, int& nthr) {
  nthr = team == 1 ? 1 : threads;
  return team >= 1 && team <= CAST_TEAM && threads >= 1 &&
         threads <= CAST_THREADS && threads % team == 0;
}

template <typename T, int ND, int MODE, bool CVX>
static int run(const int* I, const T* F, const T* x, long x_stride, int nc,
               int first, int n_gaps, const T* ss, int n_sub, T* D, T* Ja,
               T* Jb, int lanes, int L, int nd, int NG, int P, int threads,
               int team) {
  int nthr;
  if (!host_block(threads, team, nthr)) return -1;
  std::vector<unsigned char> smem(
      cast_smem_bytes<T, ND, MODE>(L, nd, NG, P, n_sub, nthr / team));
  for (int lane = 0; lane < lanes; ++lane)
    for (int g = 0; g < n_gaps; ++g)
      cast_gap<T, ND, MODE, CVX>(I, F, x, x_stride, nc, first, n_gaps, ss,
                                 n_sub, D, Ja, Jb, lane, g, smem.data(), nthr,
                                 team);
  return 0;
}

#define HOST_ENTRY(NAME, T, ND, MODE, CVX, CHECK)                            \
  extern "C" int NAME(const int* I, const T* F, const T* x, long x_stride,   \
                      int nc, int first, int n_gaps, const T* ss, int n_sub, \
                      T* D, T* Ja, T* Jb, int lanes, int L, int nd, int NG,  \
                      int P, int threads, int team, long long*, void*) {     \
    if (CHECK) return -1;                                                     \
    return run<T, ND, MODE, CVX>(I, F, x, x_stride, nc, first, n_gaps, ss,   \
                                 n_sub, D, Ja, Jb, lanes, L, nd, NG, P,      \
                                 threads, team);                              \
  }

// K4: n_dof ND_JAC exactly, every other n_dof up to the ceiling ND_MAX,
// as the card's
template <typename T, bool CVX>
static int run_jac(const int* I, const T* F, const T* x, long x_stride,
                   int nc, int first, int n_gaps, const T* ss, int n_sub,
                   T* D, T* Ja, T* Jb, int lanes, int L, int nd, int NG,
                   int P, int threads, int team) {
  if (nd == ND_JAC)
    return run<T, ND_JAC, MODE_JAC, CVX>(I, F, x, x_stride, nc, first, n_gaps,
                                         ss, n_sub, D, Ja, Jb, lanes, L, nd,
                                         NG, P, threads, team);
  if (nd >= 1 && nd <= ND_MAX)
    return run<T, ND_MAX, MODE_JAC, CVX>(I, F, x, x_stride, nc, first, n_gaps,
                                         ss, n_sub, D, Ja, Jb, lanes, L, nd,
                                         NG, P, threads, team);
  return -1;
}

#define HOST_JAC_ENTRY(NAME, T, CVX)                                          \
  extern "C" int NAME(const int* I, const T* F, const T* x, long x_stride,   \
                      int nc, int first, int n_gaps, const T* ss, int n_sub, \
                      T* D, T* Ja, T* Jb, int lanes, int L, int nd, int NG,  \
                      int P, int threads, int team, long long*, void*) {     \
    return run_jac<T, CVX>(I, F, x, x_stride, nc, first, n_gaps, ss, n_sub,  \
                           D, Ja, Jb, lanes, L, nd, NG, P, threads, team);   \
  }

HOST_JAC_ENTRY(cast_seg_f32, float, false)
HOST_JAC_ENTRY(cast_seg_f64, double, false)
HOST_ENTRY(cast_seg_value_f32, float, 1, MODE_VALUE, false, false)
HOST_ENTRY(cast_seg_value_f64, double, 1, MODE_VALUE, false, false)
HOST_ENTRY(cast_sweep_f32, float, 1, MODE_SWEEP, false, false)
HOST_ENTRY(cast_sweep_f64, double, 1, MODE_SWEEP, false, false)
HOST_JAC_ENTRY(cast_seg_cvx_f32, float, true)
HOST_JAC_ENTRY(cast_seg_cvx_f64, double, true)
HOST_ENTRY(cast_seg_value_cvx_f32, float, 1, MODE_VALUE, true, false)
HOST_ENTRY(cast_seg_value_cvx_f64, double, 1, MODE_VALUE, true, false)
HOST_ENTRY(cast_sweep_cvx_f32, float, 1, MODE_SWEEP, true, false)
HOST_ENTRY(cast_sweep_cvx_f64, double, 1, MODE_SWEEP, true, false)

// the route probe of cast_cvx.cu, one block playing every team
#define ROUTE_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const int* I, const T* F, const T* V1, int n1,          \
                      const T* V2, int n2, const T* r1, const T* r2,          \
                      int rows, int route, T* D, int* K, int threads,        \
                      int team, void*) {                                      \
    int nthr;                                                                 \
    if (n1 > CVX_MAXV || n2 > CVX_MAXV || !host_block(threads, team, nthr) || \
        (route == 0 && (n1 > GENERIC_MAX || n2 > GENERIC_MAX)))               \
      return -1;                                                              \
    std::vector<TeamMem<T>> teams(nthr / team);                               \
    route_block(I, F, route == 1, V1, n1, V2, n2, r1, r2, rows, D, K, 0, 1,  \
                reinterpret_cast<unsigned char*>(teams.data()), nthr, team); \
    return 0;                                                                 \
  }

ROUTE_ENTRY(convex_route_f32, float)
ROUTE_ENTRY(convex_route_f64, double)

// K7 disc_dist / K7v disc_dist_value of disc_dist.cu: each block of
// `slots` (lane, step) slots runs disc_block with one thread playing the
// block's `threads` threads in turn (any slots >= 1, threads 1 to
// DISC_MAX_THREADS, within the card's shared memory)
#define DISC_ENTRY(NAME, T, JAC)                                              \
  extern "C" int NAME(const int* I, const T* F, int n_ints, int n_reals,     \
                      const T* x, long x_stride, int nc, int first, int span,\
                      T* D, T* J, int lanes, int L, int nd, int NG,          \
                      int slots, int stage, int threads, void*) {             \
    if (threads < 1 || threads > DISC_MAX_THREADS || slots < 1) return -1;   \
    const long smem =                                                         \
        disc_smem_bytes<T>(n_ints, n_reals, slots, stage, L, nd, NG);         \
    if (smem > DISC_MAX_SMEM) return -1;                                      \
    std::vector<double> buf((smem + 7) / 8);                                  \
    const long n_slots = (long)lanes * span;                                  \
    auto body = stage ? disc_block<T, JAC, true> : disc_block<T, JAC, false>; \
    for (long b = 0; b * slots < n_slots; ++b)                                \
      body(I, F, n_ints, n_reals, x, x_stride, nc, first, span, n_slots, D, \
           J, b, slots, reinterpret_cast<unsigned char*>(buf.data()),         \
           threads);                                                          \
    return 0;                                                                 \
  }

DISC_ENTRY(disc_dist_f32, float, true)
DISC_ENTRY(disc_dist_f64, double, true)
DISC_ENTRY(disc_dist_value_f32, float, false)
DISC_ENTRY(disc_dist_value_f64, double, false)

// disc_dist.cu's: the block of at most `slots` slots that fits the card
extern "C" int disc_dist_layout(int esz, int n_ints, int n_reals, int L,
                                int nd, int NG, int slots, int* out) {
  return (int)disc_layout_of(esz, n_ints, n_reals, L, nd, NG, slots, out);
}
