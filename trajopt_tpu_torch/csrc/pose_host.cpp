// Host build of K9 cart_pose / K9v and K8 solve_ik (pose.cuh), for
// checking their arithmetic on a CPU against the plain PyTorch versions.
//
// The same entry points as cart_pose.cu and solve_ik.cu (same arguments,
// same outputs), run serially: K9's (lane, column) items one after
// another, and each K8 lane's loop by one thread that plays the warp (its
// barrier empty).  Compiled with a C++ compiler by _native.host_library;
// it is not on any path that solves a problem.

#include "pose.cuh"

using namespace pose;

#define POSE_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const int* I, const T* F, const T* x, long x_stride,   \
                      int x_off, int nd, int src, int tgt, const T* tR,      \
                      const T* tp, const T* soR, const T* sop, const T* lo,  \
                      const T* hi, const T* coeffs, T* E, T* J, long ldj,    \
                      int j_off, int lanes, void*) {                          \
    const int ncol = J ? nd : 1;                                              \
    for (int lane = 0; lane < lanes; ++lane) {                                \
      PoseArgs<T> a{src, tgt, tR + 9 * lane, tp + 3 * lane,                   \
                    soR ? soR + 9 * lane : nullptr,                           \
                    sop ? sop + 3 * lane : nullptr,                           \
                    lo ? lo + 6 * lane : nullptr, hi ? hi + 6 * lane : nullptr, \
                    coeffs ? coeffs + 6 * lane : nullptr};                    \
      for (int c = 0; c < ncol; ++c)                                          \
        cart_pose_item(I, F, x, x_stride, x_off, a, E, J, ldj, j_off, lane,  \
                       J ? c : -1);                                           \
    }                                                                         \
    return 0;                                                                 \
  }

POSE_ENTRY(cart_pose_f32, float)
POSE_ENTRY(cart_pose_f64, double)

#define IK_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const int* I, const T* F, int link, const T* tR,       \
                      const T* tp, const T* q0, const T* lb, const T* ub,    \
                      int max_iters, double tol, double damping, int ne,     \
                      int nd, T* q, T* err, int* conv, int* iters,           \
                      int lanes, void*) {                                     \
    if (nd > ND_MAX) return -1;                                               \
    IkMem<T> mem;                                                             \
    for (int lane = 0; lane < lanes; ++lane) {                                \
      PoseArgs<T> a{link, -1, tR + 9 * lane, tp + 3 * lane, nullptr,          \
                    nullptr, nullptr, nullptr, nullptr};                      \
      ik_lane(I, F, a, q0 + lane * nd, lb, ub, max_iters, (T)tol,            \
              (T)damping, ne, q + lane * nd, err + lane, conv + lane,         \
              iters + lane, &mem, 0, 1);                                      \
    }                                                                         \
    return 0;                                                                 \
  }

IK_ENTRY(solve_ik_f32, float)
IK_ENTRY(solve_ik_f64, double)
