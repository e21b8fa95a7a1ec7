// Device code of the pose kernels (K9 cart_pose in cart_pose.cu, K8
// solve_ik in solve_ik.cu): forward kinematics of one link along its
// chain path, the pose error of the cartesian terms (the offsets, the
// transform error with its SO(3) log map, the tolerance band and the row
// coefficients), and one lane's damped-least-squares IK loop.
//
// Replaces the JAX package's hand-shaped XLA routines:
//   kinematics/chain.py:70-208    Chain.fk (of the links a pose needs)
//   ops/lie.py:60-112             rot_log, transform_error
//   terms/cartesian.py:30-114     _link_pose_with_offset, _apply_tolerances,
//                                 cart_pose_term's _err_q and its jacfwd
//   kinematics/ik.py:34-83        solve_ik (LM / damped least squares)
//
// Every function is scalar-generic: S is T (a value) or Dual<T, 1> (the
// value and one tangent column, collision.cuh), so one thread carries one
// column of jax.jacfwd with jacfwd's tangent rules: max / min and clip
// split a tie's tangent 0.5 / 0.5, sqrt's tangent is 0.5 / sqrt, a
// branch (the pivot, the hemisphere, the Taylor switch, the band) takes
// the tangent of the side its value takes.  Every function is also
// host-compilable (HD), so pose_host.cpp checks the arithmetic on a CPU.
//
// Chain tables (Chain.kernel_tables):
//   ints:  [0] L, [1] n_dof; link l at 2 + 4 l: parent, jtype, dof,
//          offset of its path; a path: its length, then the links from
//          the root to l;
//   reals: link l (33): off_R 9, off_p 3, axis 3, K 9, K^2 9 (the unit
//          axis' skew matrix and its square: R_axis(q) = I + sin q K +
//          (1 - cos q) K^2).
#pragma once

#include "collision.cuh"

namespace pose {

using coll::Dual;
using coll::Sc;
using coll::vof;
using coll::qdiv;
using coll::ssqrt;
using coll::smaxc;
using coll::sclip;

using coll::JT_PRISMATIC;
using coll::JT_REVOLUTE;
using coll::LINK_R;
constexpr int ND_MAX = 9;  // K8's shared state holds at most this many dofs

#ifdef __CUDA_ARCH__
#define POSE_SYNC() __syncwarp()
#else
#define POSE_SYNC() ((void)0)
#endif

// a joint value lifted into S: column col's tangent is 1 at dof col
template <typename S> struct Var;
template <> struct Var<float> {
  static HD float of(const float* q, int d, int) { return q[d]; }
};
template <> struct Var<double> {
  static HD double of(const double* q, int d, int) { return q[d]; }
};
template <typename T> struct Var<Dual<T, 1>> {
  static HD Dual<T, 1> of(const T* q, int d, int col) {
    Dual<T, 1> r;
    r.v = q[d];
    r.d[0] = d == col ? T(1) : T(0);
    return r;
  }
};

// sin and cos of a joint value (collision.cuh's, the float path within an
// ulp of sinf / cosf); tangents cos q dq and -(sin q dq), as jax.jvp's
template <typename T> HD void ssincos(T q, T& s, T& c) {
  coll::joint_sincos(q, s, c);
}
template <typename T, int N>
HD void ssincos(const Dual<T, N>& q, Dual<T, N>& s, Dual<T, N>& c) {
  T sv, cv;
  coll::joint_sincos(q.v, sv, cv);
  s.v = sv;
  c.v = cv;
  for (int i = 0; i < N; ++i) {
    s.d[i] = q.d[i] * cv;
    c.d[i] = -(q.d[i] * sv);
  }
}

// atan2(y, x); tangents dy x / (y^2 + x^2) - dx y / (y^2 + x^2), as
// jax.jvp's
HD float satan2(float y, float x) { return atan2f(y, x); }
HD double satan2(double y, double x) { return atan2(y, x); }
template <typename T, int N>
HD Dual<T, N> satan2(const Dual<T, N>& y, const Dual<T, N>& x) {
  Dual<T, N> r;
  r.v = satan2(y.v, x.v);
  const T den = y.v * y.v + x.v * x.v;
  const T gy = qdiv(x.v, den), gx = qdiv(-y.v, den);
  for (int i = 0; i < N; ++i) r.d[i] = y.d[i] * gy + x.d[i] * gx;
  return r;
}

// 3x3 row-major products; B a constant (C = A B) or lifted
template <typename S, typename B>
HD void mm3(const S* A, const B* Bm, S* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * Bm[j] + A[3 * i + 1] * Bm[3 + j] +
                     A[3 * i + 2] * Bm[6 + j];
}
template <typename S, typename B>
HD void mv3(const S* A, const B* v, S* out) {
  for (int i = 0; i < 3; ++i)
    out[i] = A[3 * i] * v[0] + A[3 * i + 1] * v[1] + A[3 * i + 2] * v[2];
}

// World pose (R, p) of link `link` at q, walking its chain path from the
// root (the operations of Chain.fk, link by link); a Dual S carries the
// tangent of dof col
template <typename S, typename T>
HD void link_pose(const int* I, const T* F, const T* q, int col, int link,
                  S* R, S* p) {
  const int* path = I + I[2 + 4 * link + 3];
  const int n = path[0];
  for (int k = 0; k < n; ++k) {
    const int l = path[1 + k];
    const int* li = I + 2 + 4 * l;
    const T* lf = F + LINK_R * l;
    const int jt = li[1], dof = li[2];
    S Rj[9], pj[3];
    if (k == 0) {
      for (int i = 0; i < 9; ++i) Rj[i] = Sc<S>::from(lf[i]);
      for (int i = 0; i < 3; ++i) pj[i] = Sc<S>::from(lf[9 + i]);
    } else {
      mm3(R, lf, Rj);
      mv3(R, lf + 9, pj);
      for (int i = 0; i < 3; ++i) pj[i] = pj[i] + p[i];
    }
    if (jt == JT_REVOLUTE && dof >= 0) {
      S sn, cq;
      ssincos(Var<S>::of(q, dof, col), sn, cq);
      const S cs = T(1) - cq;
      S Ra[9];
      for (int i = 0; i < 9; ++i)
        Ra[i] = (T((i % 4) == 0 ? 1 : 0) + sn * lf[15 + i]) + cs * lf[24 + i];
      mm3(Rj, Ra, R);
      for (int i = 0; i < 3; ++i) p[i] = pj[i];
    } else if (jt == JT_PRISMATIC && dof >= 0) {
      const S qd = Var<S>::of(q, dof, col);
      S step[3], off[3];
      for (int i = 0; i < 3; ++i) step[i] = lf[12 + i] * qd;
      mv3(Rj, step, off);
      for (int i = 0; i < 9; ++i) R[i] = Rj[i];
      for (int i = 0; i < 3; ++i) p[i] = pj[i] + off[i];
    } else {
      for (int i = 0; i < 9; ++i) R[i] = Rj[i];
      for (int i = 0; i < 3; ++i) p[i] = pj[i];
    }
  }
}

// (R off_R, R off_p + p): a link's pose with a fixed offset
template <typename S, typename T>
HD void with_offset(const S* R, const S* p, const T* oR, const T* op, S* Ro,
                    S* po) {
  mm3(R, oR, Ro);
  mv3(R, op, po);
  for (int i = 0; i < 3; ++i) po[i] = po[i] + p[i];
}

// Matrix log of a rotation (row-major m): the quaternion route of
// lie.rot_log, computing only the candidate its pivot selects
template <typename S>
HD void rot_log(const S* m, S* out) {
  using T = typename Sc<S>::T;
  const T eps = T(1e-12);
  const S tr = (m[0] + m[4]) + m[8];
  const T p1 = (vof(m[0]) - vof(m[4])) - vof(m[8]);
  const T p2 = (-vof(m[0]) + vof(m[4])) - vof(m[8]);
  const T p3 = (-vof(m[0]) - vof(m[4])) + vof(m[8]);
  int idx = 0;  // argmax of the pivots: the first index on ties
  T best = vof(tr);
  if (p1 > best) idx = 1, best = p1;
  if (p2 > best) idx = 2, best = p2;
  if (p3 > best) idx = 3;
  const S two = Sc<S>::from(T(2));
  S c[4];
  if (idx == 0) {
    const S r = qdiv(ssqrt(smaxc(T(1) + tr, eps)), two);
    const S f = T(4) * r;
    c[0] = r;
    c[1] = qdiv(m[7] - m[5], f);
    c[2] = qdiv(m[2] - m[6], f);
    c[3] = qdiv(m[3] - m[1], f);
  } else if (idx == 1) {
    const S r = qdiv(ssqrt(smaxc(((T(1) + m[0]) - m[4]) - m[8], eps)), two);
    const S f = T(4) * r;
    c[0] = qdiv(m[7] - m[5], f);
    c[1] = r;
    c[2] = qdiv(m[1] + m[3], f);
    c[3] = qdiv(m[2] + m[6], f);
  } else if (idx == 2) {
    const S r = qdiv(ssqrt(smaxc(((T(1) - m[0]) + m[4]) - m[8], eps)), two);
    const S f = T(4) * r;
    c[0] = qdiv(m[2] - m[6], f);
    c[1] = qdiv(m[1] + m[3], f);
    c[2] = r;
    c[3] = qdiv(m[5] + m[7], f);
  } else {
    const S r = qdiv(ssqrt(smaxc(((T(1) - m[0]) - m[4]) + m[8], eps)), two);
    const S f = T(4) * r;
    c[0] = qdiv(m[3] - m[1], f);
    c[1] = qdiv(m[2] + m[6], f);
    c[2] = qdiv(m[5] + m[7], f);
    c[3] = r;
  }
  const S nrm = ssqrt(((c[0] * c[0] + c[1] * c[1]) + c[2] * c[2]) + c[3] * c[3]);
  for (int i = 0; i < 4; ++i) c[i] = qdiv(c[i], nrm);
  if (vof(c[0]) < T(0))  // the hemisphere w >= 0: angle in [0, pi]
    for (int i = 0; i < 4; ++i) c[i] = -c[i];
  const S w = sclip(c[0], T(-1), T(1));
  const S vn = ssqrt((c[1] * c[1] + c[2] * c[2]) + c[3] * c[3]);
  const S angle = T(2) * satan2(vn, w);
  // angle / sin(angle / 2), with the Taylor value near zero
  const S scale = vof(vn) > T(1e-8) ? qdiv(angle, smaxc(vn, eps))
                                    : qdiv(two, smaxc(w, T(0.5)));
  for (int i = 0; i < 3; ++i) out[i] = c[1 + i] * scale;
}

// [translation; angle-axis] of target^-1 * source in the target frame
template <typename S>
HD void transform_error(const S* Rt, const S* pt, const S* Rs, const S* ps,
                        S* e) {
  S d[3], dR[9];
  for (int j = 0; j < 3; ++j) d[j] = ps[j] - pt[j];
  for (int i = 0; i < 3; ++i)
    e[i] = (Rt[i] * d[0] + Rt[3 + i] * d[1]) + Rt[6 + i] * d[2];
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k)
      dR[3 * i + k] = (Rt[i] * Rs[k] + Rt[3 + i] * Rs[3 + k]) +
                      Rt[6 + i] * Rs[6 + k];
  rot_log(dR, e + 3);
}

// One cart_pose term's parameters for one lane (row-major 3x3s); soR,
// lo, coeffs may be null (no source offset: the link's pose; no band; no
// coefficients)
template <typename T>
struct PoseArgs {
  int src, tgt;  // link indices; tgt < 0: a world target
  const T *tR, *tp, *soR, *sop, *lo, *hi, *coeffs;
};

// The pose error rows of one lane at q (cart_pose_term's _err_q):
// source = FK(src) * source offset, target = the world pose (tR, tp) or
// FK(tgt) * (tR, tp); the transform error, the band (inside [lo, hi]: 0,
// outside: the distance to the bound passed), times the coefficients
template <typename S, typename T>
HD void pose_error(const int* I, const T* F, const T* q, int col,
                   const PoseArgs<T>& a, S* e) {
  S R[9], p[3], Rs[9], ps[3], Rt[9], pt[3];
  link_pose(I, F, q, col, a.src, R, p);
  if (a.soR != nullptr) {
    with_offset(R, p, a.soR, a.sop, Rs, ps);
  } else {
    for (int i = 0; i < 9; ++i) Rs[i] = R[i];
    for (int i = 0; i < 3; ++i) ps[i] = p[i];
  }
  if (a.tgt >= 0) {
    link_pose(I, F, q, col, a.tgt, R, p);
    with_offset(R, p, a.tR, a.tp, Rt, pt);
  } else {
    for (int i = 0; i < 9; ++i) Rt[i] = Sc<S>::from(a.tR[i]);
    for (int i = 0; i < 3; ++i) pt[i] = Sc<S>::from(a.tp[i]);
  }
  transform_error(Rt, pt, Rs, ps, e);
  if (a.lo != nullptr)
    for (int i = 0; i < 6; ++i) {
      const T v = vof(e[i]);
      e[i] = v > a.hi[i] ? e[i] - a.hi[i]
                         : (v < a.lo[i] ? e[i] - a.lo[i] : Sc<S>::from(T(0)));
    }
  if (a.coeffs != nullptr)
    for (int i = 0; i < 6; ++i) e[i] = e[i] * a.coeffs[i];
}

// K9's work item: lane `lane`, tangent column col (col < 0: the value
// only).  E (lanes, 6); J (lanes, 6, ldj), this step's columns at
// j_off .. j_off + n_dof.  Column 0 also writes the value.
template <typename T>
HD void cart_pose_item(const int* I, const T* F, const T* x, long x_stride,
                       int x_off, const PoseArgs<T>& a, T* E, T* J, long ldj,
                       int j_off, int lane, int col) {
  const T* q = x + lane * x_stride + x_off;
  if (col < 0) {
    T e[6];
    pose_error(I, F, q, 0, a, e);
    for (int i = 0; i < 6; ++i) E[lane * 6 + i] = e[i];
    return;
  }
  Dual<T, 1> e[6];
  pose_error(I, F, q, col, a, e);
  T* Jl = J + lane * 6 * ldj + j_off + col;
  for (int i = 0; i < 6; ++i) Jl[i * ldj] = e[i].d[0];
  if (col == 0)
    for (int i = 0; i < 6; ++i) E[lane * 6 + i] = e[i].v;
}

// K8: one lane's damped-least-squares loop, in the shared state of its
// warp (the host: one thread).  The Jacobian's columns are spread over
// the warp's threads (a Dual per column); thread 0 runs the rest:
// A = J J' + lam^2 I, its solve by Gaussian elimination with partial
// pivoting (the first largest pivot, as LAPACK's getrf), dq = J' y, the
// clamp to the chain's bounds, the error at q + dq, the accept test and
// lam's update.  The loop ends per lane (its warp) as the JAX while_loop
// does under vmap.
template <typename T>
struct IkMem {
  T q[ND_MAX], qn[ND_MAX], J[6 * ND_MAX], M[6 * 7], y[6], lam, err;
  int it, go;
};

template <typename T>
HD T mag(T v) {
  return v < T(0) ? -v : v;
}

template <typename T>
HD T nanmin(T a, T b) {  // jnp.minimum: a NaN wins
  return b != b ? b : (a != a ? a : (b < a ? b : a));
}

template <typename T>
HD T err_norm(const int* I, const T* F, const T* q, const PoseArgs<T>& a,
              int ne) {
  T e[6];
  pose_error(I, F, q, 0, a, e);
  T s = T(0);
  for (int i = 0; i < 6; ++i)  // a constant trip: e stays in registers
    if (i < ne) s = s + e[i] * e[i];
  return coll::qsqrt(s);
}

template <typename T>
HD void ik_lane(const int* I, const T* F, const PoseArgs<T>& a, const T* q0,
                const T* lb, const T* ub, int max_iters, T tol, T damping,
                int ne, T* q_out, T* err_out, int* conv_out, int* it_out,
                IkMem<T>* m, int tid, int nthr) {
  const int nd = I[1];
  if (tid == 0) {
    for (int d = 0; d < nd; ++d)
      m->q[d] = coll::sminc(coll::smaxc(q0[d], lb[d]), ub[d]);
    m->err = err_norm(I, F, m->q, a, ne);
    m->lam = damping;
    m->it = 0;
    m->go = (0 < max_iters) && (m->err > tol);
  }
  POSE_SYNC();
  while (m->go) {
    for (int c = tid; c < nd; c += nthr) {
      Dual<T, 1> e[6];
      pose_error(I, F, m->q, c, a, e);
      for (int i = 0; i < 6; ++i)
        if (i < ne) m->J[i * ND_MAX + c] = e[i].d[0];
    }
    POSE_SYNC();
    if (tid == 0) {
      T e[6];
      pose_error(I, F, m->q, 0, a, e);
      const T l2 = m->lam * m->lam;
      const int w = ne + 1;
      for (int i = 0; i < 6; ++i)
        if (i < ne) m->M[i * w + ne] = -e[i];
      for (int i = 0; i < ne; ++i)
        for (int j = 0; j < ne; ++j) {
          T s = T(0);
          for (int k = 0; k < nd; ++k)
            s = s + m->J[i * ND_MAX + k] * m->J[j * ND_MAX + k];
          m->M[i * w + j] = i == j ? s + l2 : s;
        }
      for (int k = 0; k < ne; ++k) {
        int pr = k;
        for (int r = k + 1; r < ne; ++r)
          if (mag(m->M[r * w + k]) > mag(m->M[pr * w + k])) pr = r;
        if (pr != k)
          for (int j = 0; j < w; ++j) {
            const T t = m->M[k * w + j];
            m->M[k * w + j] = m->M[pr * w + j];
            m->M[pr * w + j] = t;
          }
        for (int r = k + 1; r < ne; ++r) {
          const T f = qdiv(m->M[r * w + k], m->M[k * w + k]);
          for (int j = k + 1; j < w; ++j)
            m->M[r * w + j] = m->M[r * w + j] - f * m->M[k * w + j];
        }
      }
      for (int k = ne - 1; k >= 0; --k) {
        T s = m->M[k * w + ne];
        for (int j = k + 1; j < ne; ++j) s = s - m->M[k * w + j] * m->y[j];
        m->y[k] = qdiv(s, m->M[k * w + k]);
      }
      for (int d = 0; d < nd; ++d) {
        T s = T(0);
        for (int i = 0; i < ne; ++i) s = s + m->J[i * ND_MAX + d] * m->y[i];
        m->qn[d] = coll::sminc(coll::smaxc(m->q[d] + s, lb[d]), ub[d]);
      }
      const T en = err_norm(I, F, m->qn, a, ne);
      const bool improved = en < m->err;
      if (improved)
        for (int d = 0; d < nd; ++d) m->q[d] = m->qn[d];
      m->lam = improved ? coll::smaxc(m->lam * T(0.5), T(1e-5))
                        : m->lam * T(2);
      m->it = m->it + 1;
      m->err = nanmin(m->err, en);
      m->go = (m->it < max_iters) && (m->err > tol);
    }
    POSE_SYNC();
  }
  if (tid == 0) {
    for (int d = 0; d < nd; ++d) q_out[d] = m->q[d];
    *err_out = m->err;
    *conv_out = m->err <= tol;
    *it_out = m->it;
  }
}

}  // namespace pose
