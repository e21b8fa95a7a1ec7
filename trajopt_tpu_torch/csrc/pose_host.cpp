// Host build of K9 cart_pose / K9v and K8 solve_ik (pose.cuh), for
// checking their arithmetic on a CPU against the plain PyTorch versions.
//
// The same entry points as cart_pose.cu and solve_ik.cu (same arguments,
// same outputs), run serially: each K9 CTA's staging by one thread, then
// its (lane, column) items one after another, each walked by a row team
// of one thread that holds every row; each K8 lane's path staged, then its
// loop by a team of one thread that holds every column and row (its
// broadcasts and barriers empty).  Compiled with a C++ compiler by
// _native.host_library; it is not on any path that solves a problem.

#include <vector>

#include "pose.cuh"

using namespace pose;

#define POSE_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const int* I, const T* F, const T* x, long x_stride,   \
                      int x_off, int nd, int src, int tgt, int plen,         \
                      const T* tR, const T* tp, const T* soR, const T* sop,  \
                      const T* lo, const T* hi, const T* coeffs, T* E, T* J, \
                      long ldj, int j_off, int lanes, void*) {                \
    const long n = (long)lanes * (J ? nd : 1);                                \
    const CartArgs<T> a{I,  F,  x,  x_stride, x_off, nd,     src,  tgt,      \
                        plen, tR, tp, soR,    sop,   lo,     hi,   coeffs,   \
                        E,  J,  ldj, j_off,   lanes};                         \
    std::vector<T> rs(cart_reals(a));                                         \
    std::vector<int> is(3 * (size_t)plen);                                    \
    for (int blk = 0; (long)blk * CART_ITEMS < n; ++blk) {                    \
      const CartBlock<T> b = cart_stage(a, blk, rs.data(), is.data(), 0, 1);  \
      for (long g = (long)blk * CART_ITEMS;                                   \
           g < n && g < (long)(blk + 1) * CART_ITEMS; ++g)                    \
        cart_item(a, b, g, Rows<1>{0, 0, 1u});                                \
    }                                                                         \
    return 0;                                                                 \
  }

POSE_ENTRY(cart_pose_f32, float)
POSE_ENTRY(cart_pose_f64, double)

#define IK_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const int* I, const T* F, int link, int plen,          \
                      const T* tR, const T* tp, const T* q0, const T* lb,    \
                      const T* ub, int max_iters, double tol, double damping, \
                      int ne, int nd, T* q, T* err, int* conv, int* iters,    \
                      int lanes, void*) {                                     \
    if (nd < 1 || nd > ND_MAX || (ne != 3 && ne != 6) || plen < 1)            \
      return -1;                                                              \
    const IkArgs<T> a{I,    F,    link, plen, tR,    tp,  q0,                 \
                      lb,   ub,   max_iters, (T)tol, (T)damping, nd, lanes,   \
                      q,    err,  conv, iters, nullptr};                      \
    std::vector<T> rs(LINK_R * (size_t)plen + ik_team_reals(plen));           \
    std::vector<int> is(3 * (size_t)plen);                                    \
    for (int lane = 0; lane < lanes; ++lane) {                                \
      const Path<T> pa = stage_path(I, F, link, rs.data(), is.data(),         \
                                    is.data() + 2 * plen, 0, 1);              \
      T* ws = rs.data() + LINK_R * (size_t)plen;                              \
      if (ne == 3)                                                            \
        ik_team<T, 3, 1, 1>(a, pa, lane, ws, 0);                              \
      else                                                                    \
        ik_team<T, 6, 1, 1>(a, pa, lane, ws, 0);                              \
    }                                                                         \
    return 0;                                                                 \
  }

IK_ENTRY(solve_ik_f32, float)
IK_ENTRY(solve_ik_f64, double)
