// How a cast kernel's block divides its work (K4 cast_seg, K4v
// cast_seg_value, K5 cast_sweep, and the route probe convex_route) over
// the device functions of collision.cuh.  The same body runs on the card
// (cast_kernel.cuh: one CTA per (lane, gap)) and in the host build
// (cast_host.cpp), where one thread plays the block's threads one after
// another, stage by stage.
//
// The block has nthr threads in teams of tsz: on the card 64 or 128
// threads in teams of tsz lanes of a warp (4, 8, 16 or 32), the layout
// chosen per kernel; on the host the same layouts, or one thread that is
// the whole block and its only team (tsz = 1).
// Phases, each over the whole block (CB_SYNC between):
//  A  one thread per slot runs the chain (q, then the link poses), then
//     one thread per (slot, dof) joint frame and per (slot, geometry)
//     world record;
//  B  the discrete pair distance per (slot, pair): a closed form per
//     (slot, pair, tangent column) thread — K4's thread carries one dof's
//     column as a Dual<T, 1> and recomputes the value — or, for a pair
//     with a CONVEX side, one team per (slot, pair) enumerating the
//     generic features;
//  C  the route per (segment, pair) (K5: per pair over the whole gap): the
//     exact sweep (a moving sphere's capsule, a translating box's zonotope
//     SAT) per (segment, pair, dof) thread (a Dual<T, 2>: the dof at both
//     slots), the substate min per (segment, pair, column)
//     thread, and one team per (segment, pair) for a hull or CONVEX route,
//     whose members then finish one Jacobian column each.
// The pairs of each kind of work sit in contiguous ranges of the world's
// work lists (CollisionWorld.kernel_tables): the per-thread items grouped
// by kind pair, so that neighbouring threads run one route, and taken
// from the block's last thread down; the team routes heaviest first.
//
// A team's work runs in stages (CB_STAGE: a warp barrier after each on the
// card, one member after another on the host); what outlives a stage lives
// in the team's TeamMem in shared memory.  A scan is strided over the
// members: each member keeps the first extreme of its share (member 0 the
// scan's start, index 0, whatever its value, as the serial loop does), and
// the shares are combined on (value, index).  That is the serial loop's
// first extreme for any team size (a NaN past index 0 never wins), so the
// host build gives bitwise the same D, Ja and Jb at team size 1 and at the
// card's layout, and every value is computed by the same operations in the
// same order as a single thread would.
#pragma once

#include "collision.cuh"

namespace coll {

enum { MODE_JAC = 0, MODE_VALUE = 1, MODE_SWEEP = 2 };
// the n_dof of K4's Jacobian instantiations: ND_JAC (the 7-DoF arms)
// exactly, and ND_MAX a ceiling for every other n_dof from 1 to ND_MAX,
// whose tangent columns are counted at run time (tan_cols); ND_MAX sizes
// a team's tangent columns
constexpr int ND_JAC = 7, ND_MAX = 12;
// the tangent columns of an instantiation at ND: ND itself, or the
// world's n_dof under the ceiling
template <int ND> HD int tan_cols(const int* I) {
  return ND == ND_MAX ? I[1] : ND;
}
constexpr int CAST_THREADS = 128; // the largest block
constexpr int CAST_TEAM = 32;     // the largest team: one warp
// a team route: the small-hull enumeration, the generic one, Frank-Wolfe
enum { TR_HULL = 0, TR_GENERIC = 1, TR_FW = 2 };

#ifdef __CUDA_ARCH__
// the lanes of this thread's team (tsz lanes of its warp, tsz | 32)
__device__ __forceinline__ unsigned team_mask(int tsz) {
  return tsz == 32 ? 0xffffffffu
                   : ((1u << tsz) - 1u) << ((threadIdx.x & 31) & ~(tsz - 1));
}
// each thread runs its own share once; a team stage ends at a barrier of
// the team's lanes
#define CB_THREAD(t) \
  for (int t = threadIdx.x, t##_k = 0; t##_k < 1; ++t##_k)
#define CB_TEAM(tm) \
  for (int tm = threadIdx.x / tsz, tm##_k = 0; tm##_k < 1; ++tm##_k)
#define CB_STAGE(m)                                                   \
  for (int m = threadIdx.x % tsz, m##_k = 0; m##_k < 1;              \
       ++m##_k, __syncwarp(team_mask(tsz)))
#define CB_SYNC() __syncthreads()
// the phase timer: thread 0 stamps the SM's clock at mark i of the CTA
#define CB_MARK(clk, i) \
  if ((clk) != nullptr && threadIdx.x == 0) (clk)[i] = clock64()
#else
// one thread plays every thread of the block, member of the team
#define CB_THREAD(t) for (int t = 0; t < nthr; ++t)
#define CB_TEAM(tm) for (int tm = 0; tm < nthr / tsz; ++tm)
#define CB_STAGE(m) for (int m = 0; m < tsz; ++m)
#define CB_SYNC() ((void)0)
#define CB_MARK(clk, i) ((void)(clk))
#endif

// A team's shared state: the two vertex sets and their poses, the witness
// (W1, W2, n), the depth cover's extremes per direction, the Frank-Wolfe
// weights and directions, the route's value and tangent columns [slot a |
// slot b], and four scans' results (value, index); the host build keeps
// the members' shares of each scan instead
template <typename T>
struct TeamMem {
  V3<T> V1[CVX_MAXV], V2[CVX_MAXV];
  T W1[CVX_MAXV], W2[CVX_MAXV], l1[CVX_MAXV], l2[CVX_MAXV];
  T cm1[N_DIRS], cm2[N_DIRS];
  T th[2 * ND_MAX];
  V3<T> n, p, u, bu;
  T val, best, sall;
#ifdef __CUDACC__
  T rv[4];
  int rk[4];
#else
  T pv[4][CAST_TEAM];
  int pk[4][CAST_TEAM];
#endif
  int p1[CVX_MAXV], p2[CVX_MAXV];
  int flag, k, widx;
};

// a wins over b in a first-minimum (MAX: first-maximum) scan: a share of
// index -1 is none; a NaN share is index 0's (no other member keeps one),
// which the serial loop's start keeps; else (value, index) in order.  A
// strict total order, so the shares combine to the serial loop's first
// extreme in any grouping.
template <bool MAX, typename T>
HD bool wins(T av, int ak, T bv, int bk) {
  if (ak < 0) return false;
  if (bk < 0) return true;
  if (av != av) return true;
  if (bv != bv) return false;
  return (MAX ? av > bv : av < bv) || (av == bv && ak < bk);
}

// Inside a stage, every member m: scan f(k) over k = m, m + tsz, ... of
// [0, n) into result `slot` of the team (member 0 starts at index 0
// whatever its value, the others at their first non-NaN value).  On the
// card the members' shares meet by a butterfly of warp shuffles and
// member 0 stores the extreme; on the host each share is stored.  Read
// the result with team_result in a later stage.
template <bool MAX, typename T, typename Fn>
HD void team_scan(TeamMem<T>* tm, int slot, int m, int tsz, int n,
                  const Fn& f) {
  T bv = T(0);
  int bk = -1;
  auto take = [&](T v, int k) {
    if (k == 0 || (bk < 0 ? v == v : (MAX ? v > bv : v < bv))) {
      bv = v;
      bk = k;
    }
  };
  for (int k = m; k < n; k += tsz) take(f(k), k);
#ifdef __CUDA_ARCH__
  const unsigned mask = team_mask(tsz);
  for (int off = tsz / 2; off > 0; off /= 2) {
    const T ov = __shfl_xor_sync(mask, bv, off, tsz);
    const int ok = __shfl_xor_sync(mask, bk, off, tsz);
    if (wins<MAX>(ov, ok, bv, bk)) {
      bv = ov;
      bk = ok;
    }
  }
  if (m == 0) {
    tm->rv[slot] = bv;
    tm->rk[slot] = bk;
  }
#else
  tm->pv[slot][m] = bv;
  tm->pk[slot][m] = bk;
#endif
}

// the extreme of scan `slot` (its index; v its value)
template <bool MAX, typename T>
HD int team_result(const TeamMem<T>* tm, int slot, int tsz, T& v) {
#ifdef __CUDA_ARCH__
  (void)tsz;
  v = tm->rv[slot];
  return tm->rk[slot];
#else
  T bv = tm->pv[slot][0];
  int bk = tm->pk[slot][0];
  for (int j = 1; j < tsz; ++j)
    if (wins<MAX>(tm->pv[slot][j], tm->pk[slot][j], bv, bk)) {
      bv = tm->pv[slot][j];
      bk = tm->pk[slot][j];
    }
  v = bv;
  return bk;
#endif
}

// The frozen witness (W1, W2, n) of conv(V1) vs conv(V2) over the
// topologies t1, t2, by the team: the candidate argmin strided over the
// members; member 0 forms the witness, its support scans along the gap
// direction strided, and member 0 the separation test; when the sets
// penetrate, the 26-direction cover strided (each direction's extremes
// kept), then each member shares the weights of its own vertices.
// widx: the winning candidate.
template <typename T>
HD void team_feature_witness(TeamMem<T>* tm, int n1, int n2, const Topo& t1,
                             const Topo& t2, const T* dirs, int tsz) {
  const int nc = feature_cands(n1, n2, t1, t2);
  CB_STAGE(m) {
    team_scan<false>(tm, 0, m, tsz, nc, [&](int c) {
      return feature_cand(tm->V1, n1, tm->V2, t1, t2, c);
    });
  }
  CB_STAGE(m) {
    if (m == 0) {
      T best;
      const int c = team_result<false>(tm, 0, tsz, best);
      tm->widx = c;
      tm->val = feature_weights(tm->V1, n1, tm->V2, n2, t1, t2, c, tm->W1,
                                tm->W2, tm->n);
    }
  }
  CB_STAGE(m) {
    const V3<T> nn = tm->n;
    team_scan<true>(tm, 1, m, tsz, n1,
                    [&](int i) { return dot(tm->V1[i], nn); });
    team_scan<false>(tm, 2, m, tsz, n2,
                     [&](int i) { return dot(tm->V2[i], nn); });
  }
  CB_STAGE(m) {
    if (m == 0) {
      T mx1, mn2;
      team_result<true>(tm, 1, tsz, mx1);
      team_result<false>(tm, 2, tsz, mn2);
      tm->flag = separated(tm->val, mx1, mn2);
    }
  }
  if (tm->flag) return;  // separated: the gap direction is the witness's
  CB_STAGE(m) {
    team_scan<false>(tm, 0, m, tsz, N_DIRS, [&](int k) {
      cover_extremes(tm->V1, n1, tm->V2, n2, dirs, k, tm->cm1[k], tm->cm2[k]);
      return tm->cm1[k] - tm->cm2[k];
    });
  }
  CB_STAGE(m) {
    // the first minimum's direction: its support vertices share W1 / W2
    T h;
    const int kd = team_result<false>(tm, 0, tsz, h);
    const V3<T> u = mk3<T>(dirs[3 * kd], dirs[3 * kd + 1], dirs[3 * kd + 2]);
    const T m1 = tm->cm1[kd], m2 = tm->cm2[kd];
    const T c1 = support_count(tm->V1, n1, u, m1, true);
    const T c2 = support_count(tm->V2, n2, u, m2, false);
    for (int i = m; i < n1; i += tsz)
      tm->W1[i] = qdiv(in_support(tm->V1, i, u, m1, true) ? T(1) : T(0), c1);
    for (int i = m; i < n2; i += tsz)
      tm->W2[i] = qdiv(in_support(tm->V2, i, u, m2, false) ? T(1) : T(0), c2);
    if (m == 0) tm->n = u;
  }
}

// d_convex_convex's frozen witness (W1, W2, u* in n) by the team: from
// vertex 0, FW_ITERS Frank-Wolfe steps, each two support scans strided
// over the members (the weights' sums run in vertex order in every
// member); the max separation over the 26 cover directions, +n and -n
// (n the closest-point direction) strided; six projected-ascent polish
// steps from the winner, their support scans strided (a step is kept only
// when strictly better); the final winner over those 28 and the polished
// direction is u*, whose support vertices share W1 / W2 (the scans
// strided, each member weighting its own vertices).
// Every argmax / argmin takes the first index, as the reference's.
// widx: the final direction (28 = polished).
template <typename T>
HD void team_fw_witness(TeamMem<T>* tm, int n1, int n2, const T* dirs,
                        int tsz) {
  const V3<T>* V1 = tm->V1;
  const V3<T>* V2 = tm->V2;
  CB_STAGE(m) {
    for (int i = m; i < n1; i += tsz) tm->l1[i] = i == 0 ? T(1) : T(0);
    for (int i = m; i < n2; i += tsz) tm->l2[i] = i == 0 ? T(1) : T(0);
  }
  for (int it = 0; it < FW_ITERS; ++it) {
    CB_STAGE(m) {
      const V3<T> p = fw_point(V1, tm->l1, n1, V2, tm->l2, n2);
      if (m == 0) tm->p = p;
      const V3<T> np = mk3<T>(-p.x, -p.y, -p.z);
      team_scan<true>(tm, 0, m, tsz, n1, [&](int i) { return dot(V1[i], np); });
      team_scan<true>(tm, 1, m, tsz, n2, [&](int i) { return dot(V2[i], p); });
    }
    CB_STAGE(m) {
      T v;
      const int i1 = team_result<true>(tm, 0, tsz, v);
      const int i2 = team_result<true>(tm, 1, tsz, v);
      const V3<T> p = tm->p;
      const V3<T> dv = (V1[i1] - V2[i2]) - p;
      const T gamma =
          sclip(qdiv(-dot(p, dv), smax(dot(dv, dv), eps<T>())), T(0), T(1));
      for (int i = m; i < n1; i += tsz)
        tm->l1[i] = (T(1) - gamma) * tm->l1[i] + (i == i1 ? gamma : T(0));
      for (int i = m; i < n2; i += tsz)
        tm->l2[i] = (T(1) - gamma) * tm->l2[i] + (i == i2 ? gamma : T(0));
    }
  }
  CB_STAGE(m) {
    const V3<T> p = fw_point(V1, tm->l1, n1, V2, tm->l2, n2);
    const T pn = safe_norm(p);
    V3<T> n = mk3<T>(dirs[0], dirs[1], dirs[2]);
    if (pn > T(1e-9)) {
      const T mm = smax(pn, eps<T>());
      n = mk3<T>(qdiv(p.x, mm), qdiv(p.y, mm), qdiv(p.z, mm));
    }
    if (m == 0) tm->p = n;  // from here on: the Frank-Wolfe direction
    team_scan<true>(tm, 0, m, tsz, N_DIRS + 2, [&](int k) {
      return separation(V1, n1, V2, n2, sep_dir(dirs, n, k));
    });
  }
  CB_STAGE(m) {
    if (m == 0) {
      T best;
      const int k0 = team_result<true>(tm, 0, tsz, best);
      tm->k = k0;
      tm->sall = tm->best = best;
      tm->u = tm->bu = sep_dir(dirs, tm->p, k0);
    }
  }
  for (int st = 0; st < 6; ++st) {
    CB_STAGE(m) {
      const V3<T> u = tm->u;
      team_scan<true>(tm, 0, m, tsz, n1, [&](int i) { return dot(V1[i], u); });
      team_scan<false>(tm, 1, m, tsz, n2, [&](int i) { return dot(V2[i], u); });
    }
    CB_STAGE(m) {
      // every member takes the step (the same arithmetic), then scans
      // the new direction's support
      T v;
      const int ia = team_result<true>(tm, 0, tsz, v);
      const int ib = team_result<false>(tm, 1, tsz, v);
      V3<T> u = tm->u;
      const V3<T> g = V2[ib] - V1[ia];
      const T gm = smax(safe_norm(g), eps<T>());
      const T t = polish_step<T>(st);
      u = mk3<T>(u.x + qdiv(t * g.x, gm), u.y + qdiv(t * g.y, gm),
                 u.z + qdiv(t * g.z, gm));
      const T um = smax(safe_norm(u), eps<T>());
      u = mk3<T>(qdiv(u.x, um), qdiv(u.y, um), qdiv(u.z, um));
      if (m == 0) tm->n = u;
      team_scan<true>(tm, 2, m, tsz, n1, [&](int i) { return dot(V1[i], u); });
      team_scan<false>(tm, 3, m, tsz, n2, [&](int i) { return dot(V2[i], u); });
    }
    CB_STAGE(m) {
      if (m == 0) {
        T m1, m2;
        team_result<true>(tm, 2, tsz, m1);
        team_result<false>(tm, 3, tsz, m2);
        const T s = m2 - m1;
        tm->u = tm->n;
        if (s > tm->best) {
          tm->bu = tm->n;
          tm->best = s;
        }
      }
    }
  }
  CB_STAGE(m) {
    if (m == 0) {
      // the 28 directions again (their best is sall), then the polished one
      const int ks = tm->best > tm->sall ? N_DIRS + 2 : tm->k;
      tm->widx = ks;
      tm->n = ks == N_DIRS + 2 ? tm->bu : sep_dir(dirs, tm->p, ks);
    }
  }
  CB_STAGE(m) {
    const V3<T> us = tm->n;
    team_scan<true>(tm, 0, m, tsz, n1, [&](int i) { return dot(V1[i], us); });
    team_scan<false>(tm, 1, m, tsz, n2, [&](int i) { return dot(V2[i], us); });
  }
  CB_STAGE(m) {
    // the support vertices of u* share W1 / W2, each member its own
    const V3<T> us = tm->n;
    T m1, m2;
    team_result<true>(tm, 0, tsz, m1);
    team_result<false>(tm, 1, tsz, m2);
    const T c1 = support_count(V1, n1, us, m1, true);
    const T c2 = support_count(V2, n2, us, m2, false);
    for (int i = m; i < n1; i += tsz)
      tm->W1[i] = qdiv(in_support(V1, i, us, m1, true) ? T(1) : T(0), c1);
    for (int i = m; i < n2; i += tsz)
      tm->W2[i] = qdiv(in_support(V2, i, us, m2, false) ? T(1) : T(0), c2);
  }
}

// The witness of one team route between the support sets of gi (na
// vertices) and gj (nb) over slots a and b (kind: TR_HULL over the small
// hull topologies, TR_GENERIC over the generic ones, TR_FW Frank-Wolfe):
// tm->val its distance, and with JAC tm->th its witness-linear tangent,
// column d of slot a in th[d], of slot b in th[ND + d], one dof per member
template <typename T, int ND, bool JAC, bool CVX>
HD void team_route(const int* I, const T* F, const Slot<T>& sa,
                   const Slot<T>& sb, int gi, int gj, int na, int nb,
                   int kind, TeamMem<T>* tm, int tsz) {
  CB_STAGE(m) {
    for (int i = m; i < na + nb; i += tsz) {
      if (i < na)
        tm->V1[i] = hull_vert<T, CVX>(I, F, sa, sb, gi, i, tm->p1[i]);
      else
        tm->V2[i - na] =
            hull_vert<T, CVX>(I, F, sa, sb, gj, i - na, tm->p2[i - na]);
    }
  }
  const T* dirs = dirs_of(I, F);
  bool fw = false;
  if constexpr (CVX) {
    fw = kind == TR_FW;
    if (fw)
      team_fw_witness(tm, na, nb, dirs, tsz);
  }
  if (!fw) {
    const bool small = kind == TR_HULL;
    team_feature_witness(tm, na, nb,
                         small ? topo_of(I, na) : generic_topo_of(I, na),
                         small ? topo_of(I, nb) : generic_topo_of(I, nb),
                         dirs, tsz);
  }
  const T rr = geom_reals(I, F, gi)[12] + geom_reals(I, F, gj)[12];
  CB_STAGE(m) {
    if (m == 0)
      tm->val = witness_value(tm->V1, tm->W1, na, tm->V2, tm->W2, nb, tm->n,
                              fw) - rr;
    if constexpr (JAC) {
      for (int d = m; d < tan_cols<ND>(I); d += tsz) {
        T ta = T(0), tb = T(0);
        witness_tangent_dof(I, sa, sb, gi, na, tm->V1, tm->p1, tm->W1, tm->n,
                            T(-1), d, ta, tb);
        witness_tangent_dof(I, sa, sb, gj, nb, tm->V2, tm->p2, tm->W2, tm->n,
                            T(1), d, ta, tb);
        tm->th[d] = ta;
        tm->th[ND + d] = tb;
      }
    }
  }
}

// ------------------------------------------------------------ the phases

// Phase B (and K7's phase C, disc_block.cuh), one closed-form (slot, pair,
// column) thread: the discrete distance of pair pr at slot sl to *dv
// (written by column 0) and, with JAC, its tangent column d to *dt
template <typename T, bool JAC>
HD void discrete_col(const int* I, const T* F, const Slot<T>& sl,
                     const int* pr, int d, T* dv, T* dt) {
  if constexpr (JAC) {
    const Dual<T, 1> v = pair_discrete<Dual<T, 1>>(I, F, sl, pr[0], pr[1], d);
    if (d == 0) *dv = v.v;
    *dt = v.d[0];
  } else {
    *dv = pair_discrete<T>(I, F, sl, pr[0], pr[1], 0);
  }
}

// the row's Jacobian column c from the tangents t0 (slot k) and t1 (slot
// k + 1), split onto the gap's two steps by the substate fractions
template <typename T>
HD void jac_put(const T* ss, int k, int row, int c, T t0, T t1, T* Ja, T* Jb,
                int nc) {
  Ja[row * nc + c] = (T(1) - ss[k]) * t0 + (T(1) - ss[k + 1]) * t1;
  Jb[row * nc + c] = ss[k] * t0 + ss[k + 1] * t1;
}

// Phase C of K4 / K4v, one (segment k, pair p, column c) thread of an
// exact-sweep (sphere or box) or min-only route: D (n_seg, P) of the gap
// and, with JAC, column c of the row's Ja, Jb (zero past n_dof)
template <typename T, int ND, bool JAC>
HD void segment_col(const int* I, const T* F, const T* slots, const T* ss,
                    int k, int p, int c, bool sweep, const T* dsub,
                    const T* dtan, T* D, T* Ja, T* Jb, int nc) {
  const int P = I[3], sz = slot_size(I), row = k * P + p;
  const int nt = tan_cols<ND>(I);
  const int* pr = pair_rec(I, p);
  const Slot<T> sa{I, slots + k * sz}, sb{I, slots + (k + 1) * sz};
  const T a = dsub[k * P + p], b = dsub[(k + 1) * P + p];
  if constexpr (!JAC) {
    D[row] = sweep ? exact_sweep<T>(I, F, sa, sb, pr, 0) : (a < b ? a : b);
  } else {
    if (c >= I[1]) {  // the columns past n_dof (an inv-dt column)
      Ja[row * nc + c] = T(0);
      Jb[row * nc + c] = T(0);
      return;
    }
    T val, t0, t1;
    if (sweep) {
      const Dual<T, 2> v = exact_sweep<Dual<T, 2>>(I, F, sa, sb, pr, c);
      val = v.v;
      t0 = v.d[0];
      t1 = v.d[1];
    } else {
      // min of the two substates' discrete distances (ties split 0.5 / 0.5)
      val = a < b ? a : b;
      const T wa = a < b ? T(1) : (b < a ? T(0) : T(0.5));
      const T wb = b < a ? T(1) : (a < b ? T(0) : T(0.5));
      t0 = wa * dtan[(k * P + p) * nt + c];
      t1 = wb * dtan[((k + 1) * P + p) * nt + c];
    }
    if (c == 0) D[row] = val;
    jac_put(ss, k, row, c, t0, t1, Ja, Jb, nc);
  }
}

// Phase C of K4 / K4v after a team route (dh, its tangent th): column c
// of the row (segment k, pair p) from the substate min and the route
template <typename T, int ND, bool JAC>
HD void segment_finish(const int* I, const T* ss, int k, int p, int c, T dh,
                       const T* th, const T* dsub, const T* dtan, T* D, T* Ja,
                       T* Jb, int nc) {
  const int P = I[3], row = k * P + p, nt = tan_cols<ND>(I);
  const T a = dsub[k * P + p], b = dsub[(k + 1) * P + p];
  const T val = a < b ? a : b;
  if (c == 0) D[row] = dh < val ? dh : val;
  if constexpr (JAC) {
    if (c >= I[1]) {
      Ja[row * nc + c] = T(0);
      Jb[row * nc + c] = T(0);
      return;
    }
    const T wa = a < b ? T(1) : (b < a ? T(0) : T(0.5));
    const T wb = b < a ? T(1) : (a < b ? T(0) : T(0.5));
    T t0 = wa * dtan[(k * P + p) * nt + c];
    T t1 = wb * dtan[((k + 1) * P + p) * nt + c];
    if (dh < val) {
      t0 = th[c];
      t1 = th[ND + c];
    } else if (dh == val) {
      t0 = T(0.5) * t0 + T(0.5) * th[c];
      t1 = T(0.5) * t1 + T(0.5) * th[ND + c];
    }
    jac_put(ss, k, row, c, t0, t1, Ja, Jb, nc);
  }
}

// the kind of a phase-C team route of pair record pr
template <bool CVX>
HD int route_kind(const int* pr) {
  if (!CVX || pr[2] == ROUTE_HULL) return TR_HULL;
  return pr[5] > GENERIC_MAX || pr[6] > GENERIC_MAX ? TR_FW : TR_GENERIC;
}

// shared memory of a block: the slots, the substate distances (and their
// tangent columns), then nteams TeamMem records (16-byte aligned)
template <typename T>
HD long cast_team_offset(int n_slots, int sz, int n_sub, int P, int ntan) {
  const long elems = (long)n_slots * sz + (long)n_sub * P * (1 + ntan);
  return (elems * (long)sizeof(T) + 15) / 16 * 16;
}
template <typename T, int ND, int MODE>
HD long cast_smem_bytes(int L, int nd, int NG, int P, int n_sub, int nteams) {
  const int n_slots = MODE == MODE_SWEEP ? n_sub + 1 : n_sub;
  return cast_team_offset<T>(n_slots, slot_size_of(L, nd, NG), n_sub, P,
                             MODE != MODE_JAC ? 0 : ND == ND_MAX ? nd : ND) +
         nteams * (long)sizeof(TeamMem<T>);
}

// One (lane, gap) of K4 (MODE_JAC), K4v (MODE_VALUE) or K5 (MODE_SWEEP):
// x (lanes, x_stride) holds steps of nc columns, the gaps are steps
// [first, first + n_gaps]; D (lanes, n_gaps, n_seg, P) or, for K5,
// (lanes, n_gaps, P); Ja, Jb (lanes, n_gaps, n_seg P, nc)
template <typename T, int ND, int MODE, bool CVX>
HD void cast_gap(const int* I, const T* F, const T* x, long x_stride, int nc,
                 int first, int n_gaps, const T* ss, int n_sub, T* D, T* Ja,
                 T* Jb, int lane, int gap, unsigned char* smem, int nthr,
                 int tsz, long long* clk = nullptr) {
  constexpr bool JAC = MODE == MODE_JAC;
  const int nd = I[1], NG = I[2], P = I[3], sz = slot_size(I);
  const int n_slots = MODE == MODE_SWEEP ? n_sub + 1 : n_sub;
  const int n_seg = n_sub - 1, nteams = nthr / tsz;
  const int nt = JAC ? tan_cols<ND>(I) : 0;  // dtan's tangent columns
  const T* qa = x + lane * x_stride + (first + gap) * nc;
  const T* qb = qa + nc;
  const long g = (long)lane * n_gaps + gap;
  const long rows = MODE == MODE_SWEEP ? P : (long)n_seg * P;
  D += g * rows;
  if (JAC) {
    Ja += g * rows * nc;
    Jb += g * rows * nc;
  }
  T* slots = reinterpret_cast<T*>(smem);
  T* dsub = slots + n_slots * sz;
  T* dtan = dsub + n_sub * P;
  TeamMem<T>* teams = reinterpret_cast<TeamMem<T>*>(
      smem + cast_team_offset<T>(n_slots, sz, n_sub, P, nt));
  const int* W = I + I[14];
  const int nBc = W[0], nBt = W[1], nCs = W[2], nCn = W[3], nCt = W[4];
  const int* Lb = W + 5;           // B: closed form | CONVEX side
  const int* Lc = Lb + nBc + nBt;  // C: exact sweep | min only | team route

  // A: the chain per slot, then the joint frames and world records
  CB_MARK(clk, 0);
  CB_THREAD(t) {
    for (int s = t; s < n_slots; s += nthr)
      slot_chain(I, F, qa, qb, ss, s, n_sub, slots + s * sz);
  }
  CB_SYNC();
  CB_THREAD(t) {
    for (int it = t; it < n_slots * (nd + NG); it += nthr) {
      T* sl = slots + (it / (nd + NG)) * sz;
      const int r = it % (nd + NG);
      if (r < nd)
        slot_frame(I, F, sl, r);
      else
        slot_geom(I, F, sl, r - nd);
    }
  }
  CB_SYNC();
  CB_MARK(clk, 1);

  // B: the discrete distances per (slot, pair); the pairs of an exact
  // sweep skip it (their sweep replaces the value outright).  A pair with
  // a CONVEX side takes d_convex_auto, the generic enumeration, by a team;
  // the closed forms take a thread per (slot, pair, column), from the
  // block's last thread down (the teams' first threads are busiest)
  if constexpr (CVX) {
    CB_TEAM(tm) {
      for (int it = tm; it < nBt * n_sub; it += nteams) {
        const int s = it % n_sub, p = Lb[nBc + it / n_sub];
        const int* pr = pair_rec(I, p);
        const Slot<T> sl{I, slots + s * sz};
        TeamMem<T>* me = teams + tm;
        team_route<T, ND, JAC, CVX>(I, F, sl, sl, pr[0], pr[1],
                                    support_n(I, pr[0]), I[12], TR_GENERIC,
                                    me, tsz);
        CB_STAGE(m) {
          if (m == 0) dsub[s * P + p] = me->val;
          if constexpr (JAC)
            for (int c = m; c < nt; c += tsz)
              dtan[(s * P + p) * nt + c] = me->th[c];
        }
      }
    }
  }
  const int NCB = JAC ? nt : 1;
  CB_THREAD(t) {
    for (int it = nthr - 1 - t; it < nBc * n_sub * NCB; it += nthr) {
      const int c = it % NCB, r = it / NCB, s = r % n_sub, p = Lb[r / n_sub];
      discrete_col<T, JAC>(I, F, Slot<T>{I, slots + s * sz}, pair_rec(I, p),
                           c, dsub + s * P + p, dtan + (s * P + p) * nt + c);
    }
  }
  CB_SYNC();
  CB_MARK(clk, 2);

  // C: the routes
  // (the teams' routes, heaviest first; then the per-thread items from the
  // block's last thread down, so that they fill the teams with one route
  // fewer)
  if constexpr (MODE != MODE_SWEEP) {
    const int ncc = JAC ? nc : 1;
    CB_TEAM(tm) {
      for (int it = tm; it < nCt * n_seg; it += nteams) {
        const int k = it % n_seg, p = Lc[nCs + nCn + it / n_seg];
        const int* pr = pair_rec(I, p);
        TeamMem<T>* me = teams + tm;
        team_route<T, ND, JAC, CVX>(
            I, F, Slot<T>{I, slots + k * sz}, Slot<T>{I, slots + (k + 1) * sz},
            pr[0], pr[1], pr[5], pr[6], route_kind<CVX>(pr), me, tsz);
        CB_STAGE(m) {
          for (int c = m; c < ncc; c += tsz)
            segment_finish<T, ND, JAC>(I, ss, k, p, c, me->val, me->th, dsub,
                                       dtan, D, Ja, Jb, nc);
        }
      }
    }
    CB_THREAD(t) {
      for (int it = nthr - 1 - t; it < (nCs + nCn) * n_seg * ncc;
           it += nthr) {
        const int c = it % ncc, r = it / ncc, k = r % n_seg, j = r / n_seg;
        segment_col<T, ND, JAC>(I, F, slots, ss, k, Lc[j], c, j < nCs, dsub,
                                dtan, D, Ja, Jb, nc);
      }
    }
  } else {
    // K5: the min over the n_sub substates, then the sweep overrides
    // between the end poses (slots 0 and n_sub)
    const Slot<T> sa{I, slots}, sb{I, slots + n_sub * sz};
    CB_TEAM(tm) {
      for (int j = tm; j < nCt; j += nteams) {
        const int p = Lc[nCs + nCn + j];
        const int* pr = pair_rec(I, p);
        TeamMem<T>* me = teams + tm;
        team_route<T, 1, false, CVX>(I, F, sa, sb, pr[0], pr[1], pr[5], pr[6],
                                     route_kind<CVX>(pr), me, tsz);
        CB_STAGE(m) {
          if (m == 0) {
            T val = dsub[p];
            for (int s = 1; s < n_sub; ++s) val = smin(val, dsub[s * P + p]);
            D[p] = me->val < val ? me->val : val;
          }
        }
      }
    }
    CB_THREAD(t) {
      for (int j = nthr - 1 - t; j < nCs + nCn; j += nthr) {
        const int p = Lc[j];
        const int* pr = pair_rec(I, p);
        if (j < nCs) {
          D[p] = exact_sweep<T>(I, F, sa, sb, pr, 0);
        } else {
          T val = dsub[p];
          for (int s = 1; s < n_sub; ++s) val = smin(val, dsub[s * P + p]);
          D[p] = val;
        }
      }
    }
  }
  if (clk != nullptr) {
    CB_SYNC();
    CB_MARK(clk, 3);
  }
}

// The route probe: rows of vertex sets V1 (rows, n1, 3), V2 (rows, n2, 3),
// one team per row (rows block nteams + tm, strided by nblocks nteams):
// D = the route's value - (r1 + r2) and, when K is given, the witness
// index (the generic route's winning candidate, Frank-Wolfe's final
// direction)
template <typename T>
HD void route_block(const int* I, const T* F, bool fw, const T* V1, int n1,
                    const T* V2, int n2, const T* r1, const T* r2, int rows,
                    T* D, int* K, int block, int nblocks,
                    unsigned char* smem, int nthr, int tsz) {
  TeamMem<T>* teams = reinterpret_cast<TeamMem<T>*>(smem);
  const int nteams = nthr / tsz;
  const T* dirs = dirs_of(I, F);
  CB_TEAM(tm) {
    for (int row = block * nteams + tm; row < rows; row += nblocks * nteams) {
      TeamMem<T>* me = teams + tm;
      CB_STAGE(m) {
        for (int i = m; i < n1 + n2; i += tsz) {
          const T* v = i < n1 ? V1 + ((long)row * n1 + i) * 3
                              : V2 + ((long)row * n2 + i - n1) * 3;
          (i < n1 ? me->V1[i] : me->V2[i - n1]) = mk3<T>(v[0], v[1], v[2]);
        }
      }
      if (fw)
        team_fw_witness(me, n1, n2, dirs, tsz);
      else
        team_feature_witness(me, n1, n2, generic_topo_of(I, n1),
                             generic_topo_of(I, n2), dirs, tsz);
      CB_STAGE(m) {
        if (m == 0) {
          D[row] = witness_value(me->V1, me->W1, n1, me->V2, me->W2, n2,
                                 me->n, fw) - (r1[row] + r2[row]);
          if (K != nullptr) K[row] = me->widx;
        }
      }
    }
  }
}

}  // namespace coll
