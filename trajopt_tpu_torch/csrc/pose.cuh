// Device code of the pose kernels (K9 cart_pose in cart_pose.cu, K8
// solve_ik in solve_ik.cu): forward kinematics of one link along its
// chain path, the pose error of the cartesian terms (the offsets, the
// transform error with its SO(3) log map, the tolerance band and the row
// coefficients), and one lane's damped-least-squares IK loop run by a team.
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
// the tangent of the side its value takes.  A Dual's value is computed by
// the value's own operations, so a column's value is the value bit for
// bit.  Every function is also host-compilable (HD), so pose_host.cpp
// checks the arithmetic on a CPU.
//
// Chain tables (Chain.kernel_tables):
//   ints:  [0] L, [1] n_dof; link l at 2 + 4 l: parent, jtype, dof,
//          offset of its path; a path: its length, then the links from
//          the root to l;
//   reals: link l (33): off_R 9, off_p 3, axis 3, K 9, K^2 9 (the unit
//          axis' skew matrix and its square: R_axis(q) = I + sin q K +
//          (1 - cos q) K^2).
// The kernels first stage the path of each link they walk (Path: its
// links' joint types, dofs and 33 reals, in the walk's order) in shared
// memory, by asynchronous copies that a CTA issues together; the walk
// then makes no dependent global load.
// The sines and cosines of a path's joints are computed before the walk,
// one joint per thread (path_sincos), and a walk is shared by a row team
// (Rows: a lane per row of every rotation), so that neither the sines
// nor the three rows lie on one thread's chain.  Each value keeps the
// operations of the plain product in their order: the outputs are those
// of one thread walking alone, bit for bit.
#pragma once

#ifdef __CUDACC__
#include <cuda_pipeline.h>
#endif

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
// K8 takes n_dof 1..ND_MAX (as K4's Jacobian: _native.CAST_ND_MAX)
constexpr int ND_MAX = 12;

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

// sin and cos of a joint value q lifted into S, from sv, cv, the sin and
// cos of its value (coll::joint_sincos: the float path within an ulp of
// sinf / cosf); tangents cos q dq and -(sin q dq), as jax.jvp's
template <typename T> HD void ssincos(T, T sv, T cv, T& s, T& c) {
  s = sv;
  c = cv;
}
template <typename T, int N>
HD void ssincos(const Dual<T, N>& q, T sv, T cv, Dual<T, N>& s,
                Dual<T, N>& c) {
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

// A link's chain path staged for the walk: its n links from the root,
// each with its joint type and dof (jd: 2 ints a link) and its LINK_R
// reals (F); k0 the row of its first link among the staged rows (the
// rows of a sine and cosine table: path_sincos)
template <typename T>
struct Path {
  const T* F;
  const int* jd;
  int n, k0;
};

// Staging into shared memory.  copy_in(dst, src): *dst = *src; on the
// card an asynchronous copy (cp.async), so that a loop of copies issues
// every one before any lands; copies_commit closes this thread's copies
// issued since the last commit into a group, copies_wait waits until
// this thread's groups have landed, and cta_sync is the CTA's
// barrier after which every thread sees the copies.  On the host each
// copy is made at once and the rest is empty.
template <typename T>
HD void copy_in(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  __pipeline_memcpy_async(dst, src, sizeof(T));
#else
  *dst = *src;
#endif
}
HD void copies_commit() {
#ifdef __CUDA_ARCH__
  __pipeline_commit();
#endif
}
HD void copies_wait() {
#ifdef __CUDA_ARCH__
  __pipeline_wait_prior(0);
#endif
}
HD void cta_sync() {
#ifdef __CUDA_ARCH__
  __syncthreads();
#endif
}

// a path in the chain tables: its offset in I and its number of links
struct PathRef {
  int off, n;
};
HD PathRef path_ref(const int* I, int link) {
  const int off = I[2 + 4 * link + 3];
  return PathRef{off, I[off]};
}

// the staging's first step: the path's link indices into links, by member
// tid of a team of nthr
HD void stage_links(const int* I, PathRef r, int* links, int tid, int nthr) {
  for (int i = tid; i < r.n; i += nthr) copy_in(links + i, I + r.off + 1 + i);
}

// its second step, once the links have landed and the team has
// synchronised: each link's reals into Fs (consecutive members,
// consecutive reals) and its joint type and dof into jd
template <typename T>
HD Path<T> stage_rows(const int* I, const T* F, const int* links, int n,
                      int k0, T* Fs, int* jd, int tid, int nthr) {
  for (int i = tid; i < n * LINK_R; i += nthr) {
    const int k = i / LINK_R;
    copy_in(Fs + i, F + LINK_R * links[k] + (i - k * LINK_R));
  }
  for (int i = tid; i < 2 * n; i += nthr)
    copy_in(jd + i, I + 2 + 4 * links[i / 2] + 1 + (i & 1));
  return Path<T>{Fs, jd, n, k0};
}

// link's path staged into (Fs, jd; links: n ints of scratch) by the whole
// CTA (member tid of nthr, every member calls it); the caller then
// synchronises the CTA
template <typename T>
HD Path<T> stage_path(const int* I, const T* F, int link, T* Fs, int* jd,
                      int* links, int tid, int nthr) {
  const PathRef r = path_ref(I, link);
  stage_links(I, r, links, tid, nthr);
  copies_commit();
  copies_wait();
  cta_sync();
  const Path<T> pa = stage_rows(I, F, links, r.n, 0, Fs, jd, tid, nthr);
  copies_commit();
  copies_wait();
  return pa;
}

// A row team: RT members (1 or 3) that walk one chain path together.
// Member rsub holds rows rsub, rsub + RT, ... (NR = 3 / RT of them) of
// every 3x3 rotation and 3-vector of the walk; each element is computed
// by the operations of the full 3x3 product, only on the member that
// holds its row.  On the card a team of 3 is lanes base .. base + 2 of a
// warp (mask: the lanes that run the team's shuffles together, all of
// them on the same branch); row(v, r) gives every member the value v of
// row r's member.  A team of 1 holds every row.
template <int RT>
struct Rows {
  int rsub, base;
  unsigned mask;
  template <typename T>
  HD T row(T v, int r) const {
#ifdef __CUDA_ARCH__
    if (RT > 1) return __shfl_sync(mask, v, base + r);
#endif
    (void)r;
    return v;
  }
  template <typename T>
  HD Dual<T, 1> row(const Dual<T, 1>& v, int r) const {
    Dual<T, 1> o;
    o.v = row(v.v, r);
    o.d[0] = row(v.d[0], r);
    return o;
  }
};

// The sines and cosines of the path's joints at q into sc (2 reals a
// link from row pa.k0: sin, cos; the other links' entries untouched), by
// member tid of a team of nthr: the joints' in parallel, none of them on
// the walk's chain
template <typename T>
HD void path_sincos(const Path<T>& pa, const T* q, T* sc, int tid,
                    int nthr) {
  for (int k = tid; k < pa.n; k += nthr) {
    const int dof = pa.jd[2 * k + 1];
    if (pa.jd[2 * k] == JT_REVOLUTE && dof >= 0)
      coll::joint_sincos(q[dof], sc[2 * (pa.k0 + k)],
                         sc[2 * (pa.k0 + k) + 1]);
  }
}

// World pose rows (R, p) of the path's last link at q, walking the path
// from the root (the operations of Chain.fk, link by link), the member's
// rows r = rsub + RT m, its joints' sines and cosines from sc
// (path_sincos); a Dual S carries the tangent of dof col
template <int RT, typename S, typename T>
HD void link_pose(const Path<T>& pa, const T* q, const T* sc, int col,
                  int rsub, S (&R)[3 / RT][3], S (&p)[3 / RT]) {
  constexpr int NR = 3 / RT;
  for (int k = 0; k < pa.n; ++k) {
    const T* lf = pa.F + LINK_R * k;
    const int jt = pa.jd[2 * k], dof = pa.jd[2 * k + 1];
    S Rj[NR][3], pj[NR];
#pragma unroll
    for (int m = 0; m < NR; ++m) {
      const int r = rsub + RT * m;
      if (k == 0) {
#pragma unroll
        for (int j = 0; j < 3; ++j) Rj[m][j] = Sc<S>::from(lf[3 * r + j]);
        pj[m] = Sc<S>::from(lf[9 + r]);
      } else {  // (R off_R, R off_p + p), row r
#pragma unroll
        for (int j = 0; j < 3; ++j)
          Rj[m][j] = R[m][0] * lf[j] + R[m][1] * lf[3 + j] +
                     R[m][2] * lf[6 + j];
        pj[m] = (R[m][0] * lf[9] + R[m][1] * lf[10] + R[m][2] * lf[11]) +
                p[m];
      }
    }
    if (jt == JT_REVOLUTE && dof >= 0) {
      S sn, cq;
      const T* sck = sc + 2 * (pa.k0 + k);
      ssincos(Var<S>::of(q, dof, col), sck[0], sck[1], sn, cq);
      const S cs = T(1) - cq;
      S Ra[9];
#pragma unroll
      for (int i = 0; i < 9; ++i)
        Ra[i] = (T((i % 4) == 0 ? 1 : 0) + sn * lf[15 + i]) + cs * lf[24 + i];
#pragma unroll
      for (int m = 0; m < NR; ++m) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
          R[m][j] = Rj[m][0] * Ra[j] + Rj[m][1] * Ra[3 + j] +
                    Rj[m][2] * Ra[6 + j];
        p[m] = pj[m];
      }
    } else if (jt == JT_PRISMATIC && dof >= 0) {
      const S qd = Var<S>::of(q, dof, col);
      S step[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) step[i] = lf[12 + i] * qd;
#pragma unroll
      for (int m = 0; m < NR; ++m) {
#pragma unroll
        for (int j = 0; j < 3; ++j) R[m][j] = Rj[m][j];
        p[m] = pj[m] + (Rj[m][0] * step[0] + Rj[m][1] * step[1] +
                        Rj[m][2] * step[2]);
      }
    } else {
#pragma unroll
      for (int m = 0; m < NR; ++m) {
#pragma unroll
        for (int j = 0; j < 3; ++j) R[m][j] = Rj[m][j];
        p[m] = pj[m];
      }
    }
  }
}

// (R off_R, R off_p + p): a link's pose with a fixed offset, the member's
// rows
template <int NR, typename S, typename T>
HD void with_offset(const S (&R)[NR][3], const S (&p)[NR], const T* oR,
                    const T* op, S (&Ro)[NR][3], S (&po)[NR]) {
#pragma unroll
  for (int m = 0; m < NR; ++m) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Ro[m][j] = R[m][0] * oR[j] + R[m][1] * oR[3 + j] + R[m][2] * oR[6 + j];
    po[m] = (R[m][0] * op[0] + R[m][1] * op[1] + R[m][2] * op[2]) + p[m];
  }
}

// the whole pose (row-major Rf, pf) on every member of the team
template <int RT, typename S>
HD void gather(const Rows<RT>& tm, const S (&R)[3 / RT][3],
               const S (&p)[3 / RT], S* Rf, S* pf) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Rf[3 * r + j] = RT == 1 ? R[r % (3 / RT)][j] : tm.row(R[0][j], r);
    pf[r] = RT == 1 ? p[r % (3 / RT)] : tm.row(p[0], r);
  }
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
// outside: the distance to the bound passed), times the coefficients.
// ps / pt: the staged paths of the source and of a moving target, sc
// their joints' sines and cosines at q.  The row team tm walks the chains
// (each member its rows), then every member has the poses and computes
// the rest.
template <int RT, typename S, typename T>
HD void pose_error(const Rows<RT>& tm, const Path<T>& ps, const Path<T>& pt,
                   const T* q, const T* sc, int col, const PoseArgs<T>& a,
                   S* e) {
  constexpr int NR = 3 / RT;
  S R[NR][3], p[NR], Ro[NR][3], po[NR];
  S Rs[9], psrc[3], Rt[9], ptgt[3];
  link_pose<RT>(ps, q, sc, col, tm.rsub, R, p);
  if (a.soR != nullptr) {
    with_offset(R, p, a.soR, a.sop, Ro, po);
    gather(tm, Ro, po, Rs, psrc);
  } else {
    gather(tm, R, p, Rs, psrc);
  }
  if (a.tgt >= 0) {
    link_pose<RT>(pt, q, sc, col, tm.rsub, R, p);
    with_offset(R, p, a.tR, a.tp, Ro, po);
    gather(tm, Ro, po, Rt, ptgt);
  } else {
    for (int i = 0; i < 9; ++i) Rt[i] = Sc<S>::from(a.tR[i]);
    for (int i = 0; i < 3; ++i) ptgt[i] = Sc<S>::from(a.tp[i]);
  }
  transform_error(Rt, ptgt, Rs, psrc, e);
  if (a.lo != nullptr)
    for (int i = 0; i < 6; ++i) {
      const T v = vof(e[i]);
      e[i] = v > a.hi[i] ? e[i] - a.hi[i]
                         : (v < a.lo[i] ? e[i] - a.lo[i] : Sc<S>::from(T(0)));
    }
  if (a.coeffs != nullptr)
    for (int i = 0; i < 6; ++i) e[i] = e[i] * a.coeffs[i];
}

// K9's work item: lane `lane` at its joints q (sc: its paths' sines and
// cosines there), tangent column col (col < 0: the value only), walked by
// the row team tm, whose member of row 0 writes.  E (lanes, 6); J (lanes,
// 6, ldj), this step's columns at j_off .. j_off + n_dof.  Column 0 also
// writes the value.
template <int RT, typename T>
HD void cart_pose_item(const Rows<RT>& tm, const Path<T>& ps,
                       const Path<T>& pt, const T* q, const T* sc,
                       const PoseArgs<T>& a, T* E, T* J, long ldj, int j_off,
                       int lane, int col) {
  if (col < 0) {
    T e[6];
    pose_error(tm, ps, pt, q, sc, 0, a, e);
    if (tm.rsub == 0)
      for (int i = 0; i < 6; ++i) E[lane * 6 + i] = e[i];
    return;
  }
  Dual<T, 1> e[6];
  pose_error(tm, ps, pt, q, sc, col, a, e);
  if (tm.rsub != 0) return;
  T* Jl = J + lane * 6 * ldj + j_off + col;
  for (int i = 0; i < 6; ++i) Jl[i * ldj] = e[i].d[0];
  if (col == 0)
    for (int i = 0; i < 6; ++i) E[lane * 6 + i] = e[i].v;
}

// ------------------------------------------------------------ K9 / K9v

// K9 (J set) or K9v (J null): the chain tables; the step's joints x
// (lanes rows of stride x_stride, from column x_off); the source and
// target links (tgt < 0: a world target) and plen, the links on the
// source's path and on a moving target's (the staged tables' size); the
// per-lane parameters, (lanes, 9), (lanes, 3) and (lanes, 6) rows (soR /
// sop, lo / hi, coeffs may be null); E (lanes, 6); J (lanes, 6, ldj),
// the step's columns at j_off.
template <typename T>
struct CartArgs {
  const int* I;
  const T* F;
  const T* x;
  long x_stride;
  int x_off, nd, src, tgt, plen;
  const T *tR, *tp, *soR, *sop, *lo, *hi, *coeffs;
  T *E, *J;
  long ldj;
  int j_off, lanes;
};

// a work item per (lane, tangent column) (K9) or per lane (K9v),
// CART_ITEMS to a CTA (a CTA's items touch at most CART_ITEMS lanes); on
// the card an item is a row team of 3 lanes and a fourth that repeats row
// 2 (CART_TEAM lanes, so no team straddles a warp).  A CTA's shared
// reals: the staged paths (plen links), then its lanes' sine and cosine
// tables (CART_ITEMS x 2 plen); its ints: the paths' jd (2 plen), their
// links (plen).  The lanes' joints and parameters are read from global
// memory, each by the items that use it.
constexpr int CART_ITEMS = 32, CART_TEAM = 4;

template <typename T>
HD long cart_reals(const CartArgs<T>& a) {
  return (long)LINK_R * a.plen + (long)CART_ITEMS * 2 * a.plen;
}
template <typename T>
HD long cart_smem_bytes(const CartArgs<T>& a) {
  return cart_reals(a) * (long)sizeof(T) + 3L * a.plen * (long)sizeof(int);
}

// a CTA's staged view: the paths and its lanes' sine and cosine tables
// (SC), from lane l0
template <typename T>
struct CartBlock {
  Path<T> src, tgt;
  const T* SC;
  int l0;
};

// lane l's joints in x
template <typename T>
HD const T* cart_joints(const CartArgs<T>& a, int l) {
  return a.x + l * a.x_stride + a.x_off;
}

// CTA blk's staging into rs (reals) and is (ints), by member tid of nthr
// (every member calls it): the paths' links, then the links' rows, then
// every (lane, joint)'s sine and cosine; the caller then synchronises the
// CTA
template <typename T>
HD CartBlock<T> cart_stage(const CartArgs<T>& a, int blk, T* rs, int* is,
                           int tid, int nthr) {
  const int ncol = a.J ? a.nd : 1;
  const long n = (long)a.lanes * ncol, g0 = (long)blk * CART_ITEMS;
  const long g1 = g0 + CART_ITEMS < n ? g0 + CART_ITEMS : n;
  const int l0 = (int)(g0 / ncol), nl = (int)((g1 - 1) / ncol) + 1 - l0;
  const PathRef rsrc = path_ref(a.I, a.src);
  const PathRef rtgt = a.tgt >= 0 ? path_ref(a.I, a.tgt) : PathRef{0, 0};
  int* links = is + 2 * a.plen;
  stage_links(a.I, rsrc, links, tid, nthr);
  stage_links(a.I, rtgt, links + rsrc.n, tid, nthr);
  copies_commit();
  copies_wait();
  cta_sync();
  CartBlock<T> b;
  b.src = stage_rows(a.I, a.F, links, rsrc.n, 0, rs, is, tid, nthr);
  b.tgt = rtgt.n > 0 ? stage_rows(a.I, a.F, links + rsrc.n, rtgt.n, rsrc.n,
                                  rs + LINK_R * rsrc.n, is + 2 * rsrc.n, tid,
                                  nthr)
                     : Path<T>{nullptr, nullptr, 0, rsrc.n};
  copies_commit();
  copies_wait();
  cta_sync();
  T* SC = rs + (long)LINK_R * a.plen;
  const int rows = rsrc.n + rtgt.n, w = 2 * a.plen;
  for (int i = tid; i < nl * rows; i += nthr) {
    const int l = i / rows, k = i - l * rows;
    const Path<T>& pa = k < rsrc.n ? b.src : b.tgt;
    const int dof = pa.jd[2 * (k - pa.k0) + 1];
    if (pa.jd[2 * (k - pa.k0)] == JT_REVOLUTE && dof >= 0)
      coll::joint_sincos(cart_joints(a, l0 + l)[dof], SC[l * w + 2 * k],
                         SC[l * w + 2 * k + 1]);
  }
  b.SC = SC;
  b.l0 = l0;
  return b;
}

// item g (lane g / ncol, column g % ncol) over the staged view, by the
// row team tm
template <int RT, typename T>
HD void cart_item(const CartArgs<T>& a, const CartBlock<T>& b, long g,
                  const Rows<RT>& tm) {
  const int ncol = a.J ? a.nd : 1;
  const int lane = (int)(g / ncol), col = a.J ? (int)(g % ncol) : -1;
  const PoseArgs<T> al{a.src,
                       a.tgt,
                       a.tR + 9 * lane,
                       a.tp + 3 * lane,
                       a.soR ? a.soR + 9 * lane : nullptr,
                       a.soR ? a.sop + 3 * lane : nullptr,
                       a.lo ? a.lo + 6 * lane : nullptr,
                       a.lo ? a.hi + 6 * lane : nullptr,
                       a.coeffs ? a.coeffs + 6 * lane : nullptr};
  cart_pose_item(tm, b.src, b.tgt, cart_joints(a, lane),
                 b.SC + (lane - b.l0) * 2 * a.plen, al, a.E, a.J, a.ldj,
                 a.j_off, lane, col);
}

// ------------------------------------------------------------------- K8

// K8: the chain tables; the link and plen, the links on its path; the
// per-lane targets tR (lanes, 9), tp (lanes, 3) and seeds q0 (lanes,
// n_dof); the chain's bounds; the loop's settings; the outputs q (lanes,
// n_dof), err, conv, iters (lanes); clk (lanes, IK_PHASES) or null: the
// timed build's cycles per phase
template <typename T>
struct IkArgs {
  const int* I;
  const T* F;
  int link, plen;
  const T *tR, *tp, *q0, *lb, *ub;
  int max_iters;
  T tol, damping;
  int nd, lanes;
  T* q;
  T* err;
  int* conv;
  int* iters;
  long long* clk;
};

// a team's shared reals: the trial point qn (ND_MAX), tR 9, tp 3, the
// Jacobian's columns (ND_MAX x 6: J(i, c) at 6 c + i), then the path's
// sines and cosines at qn (2 plen)
HD long ik_team_reals(int plen) { return 7 * ND_MAX + 12 + 2L * plen; }
// a CTA of `teams` teams: the staged path's reals, then the teams'; its
// ints: the path's jd and links (3 plen)
template <typename T>
HD long ik_smem_bytes(int plen, int teams) {
  return ((long)LINK_R * plen + (long)teams * ik_team_reals(plen)) *
             (long)sizeof(T) +
         3L * plen * (long)sizeof(int);
}

// the timed build's phases (clock64 cycles summed over a lane's loop on
// its team's member 0): the clamp of q0 and the first dual evaluation,
// then per iteration the dual evaluation at the trial point, the system
// [J J' + lam^2 I | -e], its elimination and back-substitution, the step
// and clamp, the accept test
constexpr int IK_PHASES = 6;
#ifndef IK_TIMED
#define IK_TIMED 0
#endif
struct IkClock {
#if defined(__CUDA_ARCH__) && IK_TIMED
  long long last, acc[IK_PHASES];
  __device__ IkClock() : last(clock64()) {
    for (int i = 0; i < IK_PHASES; ++i) acc[i] = 0;
  }
  __device__ void tick(int ph) {
    const long long t = clock64();
    acc[ph] += t - last;
    last = t;
  }
  __device__ void write(long long* out) const {
    for (int i = 0; i < IK_PHASES; ++i) out[i] = acc[i];
  }
#else
  HD void tick(int) {}
  HD void write(long long*) const {}
#endif
};

// v of team member src, to every member (a warp shuffle on the card; the
// host's team is one thread)
template <int NT, typename V>
HD V bcast(V v, int src) {
#ifdef __CUDA_ARCH__
  if (NT > 1) return __shfl_sync(0xffffffffu, v, src);
#endif
  (void)src;
  return v;
}

template <typename T>
HD T mag(T v) {
  return v < T(0) ? -v : v;
}

template <typename T>
HD T nanmin(T a, T b) {  // jnp.minimum: a NaN wins
  return b != b ? b : (a != a ? a : (b < a ? b : a));
}

// the error's norm, its squares summed in row order
template <typename T, int NE>
HD T norm_of(const T (&e)[NE]) {
  T s = T(0);
#pragma unroll
  for (int i = 0; i < NE; ++i) s = s + e[i] * e[i];
  return coll::qsqrt(s);
}

// A team of NT members holds the Jacobian's columns, each column on a row
// team of RT members (RT 3: up to NT / 3 columns, the card's warp takes
// n_dof up to 10 so; RT 1: up to ND_MAX); member tid is row tid % RT of
// column tid / RT + v NT / RT, slot v of ik_slots
template <int NT, int RT>
constexpr int ik_nd_max() {
  return RT == 1 ? ND_MAX : NT / RT;
}
template <int NT, int RT>
constexpr int ik_slots() {
  return (ik_nd_max<NT, RT>() + NT / RT - 1) / (NT / RT);
}

// The team's dual evaluation at the point qn (shared): the joints' sines
// and cosines into sc, then the pose error's Jacobian columns of member
// tid's slots into J, and column 0's values, the pose error at qn, to
// every member in e
template <typename T, int NE, int NT, int RT>
HD void ik_eval(const Path<T>& pa, const PoseArgs<T>& pr, const T* qn,
                T* sc, int nd, int tid, T (&J)[ik_slots<NT, RT>()][NE],
                T (&e)[NE]) {
  constexpr int VC = ik_slots<NT, RT>(), NTC = NT / RT;
  const int base = tid / RT * RT;
  const Rows<RT> tm{tid - base, base, ((1u << RT) - 1u) << (base & 31)};
  path_sincos(pa, qn, sc, tid, NT);
  POSE_SYNC();
  T e0[NE];
#pragma unroll
  for (int i = 0; i < NE; ++i) e0[i] = T(0);
#pragma unroll
  for (int v = 0; v < VC; ++v) {
    const int c = tid / RT + v * NTC;
    if (c < nd) {
      Dual<T, 1> ec[6];
      pose_error(tm, pa, Path<T>{nullptr, nullptr, 0, 0}, qn, sc, c, pr,
                 ec);
#pragma unroll
      for (int i = 0; i < NE; ++i) J[v][i] = ec[i].d[0];
      if (c == 0)
#pragma unroll
        for (int i = 0; i < NE; ++i) e0[i] = ec[i].v;
    }
  }
#pragma unroll
  for (int i = 0; i < NE; ++i) e[i] = bcast<NT>(e0[i], 0);
}

// the Jacobian's columns held by the members (row 0 of each column's
// team) into their shared copy Js (J(i, c) at 6 c + i)
template <int NT, int RT, typename T, int NE>
HD void share_columns(const T (&J)[ik_slots<NT, RT>()][NE], T* Js, int nd,
                      int tid) {
#pragma unroll
  for (int v = 0; v < ik_slots<NT, RT>(); ++v) {
    const int c = tid / RT + v * (NT / RT);
    if (c < nd && tid % RT == 0)
#pragma unroll
      for (int i = 0; i < NE; ++i) Js[6 * c + i] = J[v][i];
  }
}

// K8: lane `lane`'s damped-least-squares loop (kinematics/ik.py's body),
// run by a team of NT members (member tid; the card: a warp, NT = 32;
// the host: one thread, NT = 1) over the staged path pa, with the team's
// shared reals ws.  A row team of RT members (ik_slots) walks each dual
// column of the Jacobian, the column's rows of every rotation on their
// members, and then holds the column in registers, with q_c and its
// bounds; the system [A | -e], A = J J' + lam^2 I (NE x NE + 1), lives
// by its columns j = tid + v NT.  Per iteration:
// - A(i, j) = sum_k J(i, k) J(j, k) in k order, from J's columns copied
//   to shared memory when they change (share_columns: a member reads
//   them with independent loads, where broadcasting column after column
//   waited on each shuffle);
// - Gaussian elimination with partial pivoting (the first largest
//   |pivot|, as LAPACK's getrf): the pivot column's owner scans it and
//   broadcasts the row, every member swaps its columns' entries, the
//   owner forms the row factors over the pivot's one reciprocal and
//   broadcasts them, each member updates its columns; the back-
//   substitution on every member (the triangle broadcast, the pivots'
//   reciprocals formed before its chain);
// - dq_c = sum_i J(i, c) y(i) and the clamp on column c's team;
// - the one dual evaluation at the trial point qn = clamp(q + dq), whose
//   column 0 gives err_new: accepted (err_new < err), q, J and e become
//   the trial point's; rejected, they stay and the next iteration
//   re-solves with the doubled lam.
// Every value is computed by the operations of the plain loop in its
// order, so the outputs are those of the loop that evaluates e and J at q
// anew.  The loop ends where the lane's does, as the while_loop under
// vmap.
template <typename T, int NE, int NT, int RT>
HD void ik_team(const IkArgs<T>& a, const Path<T>& pa, int lane, T* ws,
                int tid) {
  constexpr int VC = ik_slots<NT, RT>(), NTC = NT / RT;
  constexpr int VM = (NE + 1 + NT - 1) / NT;
  const int nd = a.nd, rsub = tid % RT;
  IkClock clk;
  T *qn = ws, *Js = ws + ND_MAX + 12, *sc = Js + 6 * ND_MAX;
  for (int i = tid; i < 12; i += NT)
    ws[ND_MAX + i] = i < 9 ? a.tR[9L * lane + i] : a.tp[3L * lane + i - 9];
  const PoseArgs<T> pr{a.link,  -1,      ws + ND_MAX, ws + ND_MAX + 9,
                       nullptr, nullptr, nullptr,     nullptr,
                       nullptr};
  T q[VC], lo[VC], hi[VC];
#pragma unroll
  for (int v = 0; v < VC; ++v) {
    const int c = tid / RT + v * NTC;
    q[v] = lo[v] = hi[v] = T(0);
    if (c < nd) {
      lo[v] = a.lb[c];
      hi[v] = a.ub[c];
      q[v] = coll::sminc(coll::smaxc(a.q0[(long)lane * nd + c], lo[v]),
                         hi[v]);
      if (rsub == 0) qn[c] = q[v];
    }
  }
  POSE_SYNC();
  T J[VC][NE], e[NE];
  ik_eval<T, NE, NT, RT>(pa, pr, qn, sc, nd, tid, J, e);
  share_columns<NT, RT>(J, Js, nd, tid);
  T err = norm_of(e), lam = a.damping;
  int it = 0;
  bool go = (0 < a.max_iters) && (err > a.tol);
  clk.tick(0);
  while (go) {
    // the system: member tid's columns of [A | -e], from the shared copy
    // of J's columns
    T M[VM][NE];
    POSE_SYNC();
    {
      const T l2 = lam * lam;
      T s[VM][NE];
#pragma unroll
      for (int v = 0; v < VM; ++v) {
        const int j = tid + v * NT;
#pragma unroll
        for (int i = 0; i < NE; ++i) s[v][i] = T(0);
        if (j < NE)
          for (int k = 0; k < nd; ++k) {
            const T cj = Js[6 * k + j];
#pragma unroll
            for (int i = 0; i < NE; ++i)
              s[v][i] = s[v][i] + Js[6 * k + i] * cj;
          }
      }
#pragma unroll
      for (int v = 0; v < VM; ++v) {
        const int j = tid + v * NT;
#pragma unroll
        for (int i = 0; i < NE; ++i)
          M[v][i] = j < NE ? (i == j ? s[v][i] + l2 : s[v][i]) : -e[i];
      }
    }
    clk.tick(2);
    // elimination with partial pivoting; column k lives on member k % NT
#pragma unroll
    for (int k = 0; k < NE; ++k) {
      int p = k;
      {
        T best = mag(M[k / NT][k]);
#pragma unroll
        for (int r = k + 1; r < NE; ++r) {
          const T m = mag(M[k / NT][r]);
          if (m > best) p = r, best = m;
        }
      }
      p = bcast<NT>(p, k % NT);
#pragma unroll
      for (int v = 0; v < VM; ++v) {  // rows k and p
        const T tk = M[v][k];
        T tp = tk;
#pragma unroll
        for (int r = k + 1; r < NE; ++r)
          if (r == p) tp = M[v][r];
#pragma unroll
        for (int r = k + 1; r < NE; ++r)
          if (r == p) M[v][r] = tk;
        M[v][k] = tp;
      }
      // the row factors over one divisor: its reciprocal once, each
      // quotient qdiv's bit for bit (qm::qdiv_f; qdiv itself where that
      // does not hold)
      T f[NE];
      {
        const T piv = M[k / NT][k], rf = qm::qrcp(piv);
        bool ok = true;
#pragma unroll
        for (int r = k + 1; r < NE; ++r)
          f[r] = qm::qdiv_f(M[k / NT][r], piv, rf, ok);
        if (!ok)
#pragma unroll
          for (int r = k + 1; r < NE; ++r) f[r] = qdiv(M[k / NT][r], piv);
#pragma unroll
        for (int r = k + 1; r < NE; ++r) f[r] = bcast<NT>(f[r], k % NT);
      }
#pragma unroll
      for (int v = 0; v < VM; ++v) {
        const int j = tid + v * NT;
        if (j > k && j <= NE)
#pragma unroll
          for (int r = k + 1; r < NE; ++r) M[v][r] = M[v][r] - f[r] * M[v][k];
      }
    }
    // back-substitution, on every member
    T y[NE];
    {
      T u[NE][NE], b[NE];
#pragma unroll
      for (int k = 0; k < NE; ++k) {
        b[k] = bcast<NT>(M[NE / NT][k], NE % NT);
#pragma unroll
        for (int j = k; j < NE; ++j) u[k][j] = bcast<NT>(M[j / NT][k], j % NT);
      }
      // the pivots' reciprocals first, off the chain; each quotient
      // qdiv's bit for bit, else the whole substitution by qdiv
      T rk[NE];
#pragma unroll
      for (int k = 0; k < NE; ++k) rk[k] = qm::qrcp(u[k][k]);
      bool ok = true;
#pragma unroll
      for (int k = NE - 1; k >= 0; --k) {
        T s = b[k];
#pragma unroll
        for (int j = k + 1; j < NE; ++j) s = s - u[k][j] * y[j];
        y[k] = qm::qdiv_f(s, u[k][k], rk[k], ok);
      }
      if (!ok)
#pragma unroll
        for (int k = NE - 1; k >= 0; --k) {
          T s = b[k];
#pragma unroll
          for (int j = k + 1; j < NE; ++j) s = s - u[k][j] * y[j];
          y[k] = qdiv(s, u[k][k]);
        }
    }
    clk.tick(3);
    // the step dq = J' y, clamped: the trial point
    T qt[VC];
    POSE_SYNC();  // the last evaluation's reads of qn and sc are done
#pragma unroll
    for (int v = 0; v < VC; ++v) {
      const int c = tid / RT + v * NTC;
      qt[v] = q[v];
      if (c < nd) {
        T s = T(0);
#pragma unroll
        for (int i = 0; i < NE; ++i) s = s + J[v][i] * y[i];
        qt[v] = coll::sminc(coll::smaxc(q[v] + s, lo[v]), hi[v]);
        if (rsub == 0) qn[c] = qt[v];
      }
    }
    POSE_SYNC();
    clk.tick(4);
    T Jn[VC][NE], en[NE];
    ik_eval<T, NE, NT, RT>(pa, pr, qn, sc, nd, tid, Jn, en);
    clk.tick(1);
    const T err_new = norm_of(en);
    const bool improved = err_new < err;
    if (improved) {
#pragma unroll
      for (int v = 0; v < VC; ++v) {
        q[v] = qt[v];
#pragma unroll
        for (int i = 0; i < NE; ++i) J[v][i] = Jn[v][i];
      }
#pragma unroll
      for (int i = 0; i < NE; ++i) e[i] = en[i];
      share_columns<NT, RT>(J, Js, nd, tid);
    }
    lam = improved ? coll::smaxc(lam * T(0.5), T(1e-5)) : lam * T(2);
    it = it + 1;
    err = nanmin(err, err_new);
    go = (it < a.max_iters) && (err > a.tol);
    clk.tick(5);
  }
#pragma unroll
  for (int v = 0; v < VC; ++v) {
    const int c = tid / RT + v * NTC;
    if (c < nd && rsub == 0) a.q[(long)lane * nd + c] = q[v];
  }
  if (tid == 0) {
    a.err[lane] = err;
    a.conv[lane] = err <= a.tol;
    a.iters[lane] = it;
    if (a.clk) clk.write(a.clk + (long)lane * IK_PHASES);
  }
}

}  // namespace pose
