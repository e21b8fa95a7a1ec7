// K11 ipm_dense's per-lane body: the interior-point QP solver's whole
// Mehrotra predictor-corrector loop for ONE lane whose rows are dense
// (m, n) matrices, from the initial interior point to termination.
//
// Replaces trajopt_tpu/ops/ipm_qp.py:92 solve_ipm_qp's dense-row branch
// (:108 `banded = data.A_h is None`, the dense rows :156-187, K formed
// dense, symmetrized, regularized and factored :344-371, the loop
// :373-520); its plain PyTorch counterpart is ops/ipm_qp.py's _loop_plain
// on a _Setup with dense rows.  The loop is K6's, ipm::Loop of ipm.cuh (in
// the plain loop's order: the barrier diagonals; K's assembly and factor,
// the residuals and mu beside it; the predictor and corrector Newton
// solves, each with one refinement step; the step lengths and sigma; the
// NaN-guarded update; best-iterate tracking by the exact composite
// objective; the unscaled termination test).  This file supplies what
// differs: the dense rows' and P's products, the assembly of the
// symmetrized K, its two factor routes and the solves.  The set-up
// (pinned-coordinate elimination, row scaling, the cost scale c, f(0))
// and the teardown run in PyTorch in the wrapper.
//
// The factor takes one of two routes, as the plain loop does (nb > 0: the
// kkt_block b is set, n % b == 0 and n >= 2b):
// - block route: only the block-tridiagonal band of the symmetrized K is
//   formed (D's lower triangles, O), and factored and solved by K2's and
//   K3's device functions (banded::btd_factor_warp, btd_solve_warp, their
//   exact fallback btd_factor_inplace) on the first warp, at the run-time
//   b through Blocks (every b of the library's range LO..HI);
// - dense route (nb == 0): the whole lower triangle of K + reg I, a
//   right-looking Cholesky by the whole team (column j scaled by its
//   pivot, then the trailing triangle updated; two barriers a column),
//   then the residuals on the members past the first warp, and the Newton
//   solves as two triangular solves on the first warp (L y = r by rows,
//   each row's dot product summed across the warp; L' x = y by columns),
//   in place of the reference's explicit inverse L^-T L^-1.
//   A pivot that is not positive (or NaN) marks the factor broken and
//   every solve then returns NaN, as torch.linalg.cholesky_ex's info != 0
//   does in the plain loop, so the NaN guard keeps the incumbent.
//
// Rows: Jh v and Ja v by rows (a member per row, the row in column order),
// Jh' w and Ja' w by columns (a member per column, the rows in order);
// P v by rows of P from P' (PT, a member per column of PT: coalesced).
// Every sum runs in a fixed order, no atomics; min, max and clamp
// propagate NaN as torch does (ipm.cuh's helpers); divisions and roots are
// qm::qdiv / qm::qsqrt.  Team, barriers and reductions as K6's (ipm.cuh).
//
// Memory per lane: the reduction buffer and the flags in shared memory;
// four regions in shared memory where the launcher's plan holds them
// (Args::smem_base, smem_rows, smem_k, smem_scr, in that priority), else
// in the lane's slice of the device scratch (Args::dscr; the scaled rows
// are read where they lie): base (the block route's D, O and pivots'
// reciprocals, and the n-vectors), rows (the scaled Jh, Ja), K (the dense
// route's n x n matrix) and the scratch m-vectors (12 per row kind).
#pragma once

#include "ipm.cuh"

#ifdef __CUDACC__
#define K11_NOINLINE __host__ __device__ __noinline__
#else
#define K11_NOINLINE inline
#endif

namespace ipm_dense {

using ipm::nmax;
using ipm::team_reduce;
using qm::qdiv;

constexpr int N_VEC = 19;      // n-vectors of the base region
using ipm::N_SCR_VEC;  // m-vectors per row kind in the scratch
constexpr int N_SC = 4;        // flags and scalars in shared memory (ipm::Loop's
                               // two, the dense factor's broke flag)

// The launch arguments (ctypes mirror: ops.ipm_qp._K11Args).  Per-lane
// arrays are lane-major and contiguous.
struct Args {
  int lanes, n, b, nb, mh, ma, max_iter;
  // where each region lives: 1 shared memory, 0 the device scratch (the
  // card's launcher plans them and writes its choice back; the host build
  // takes them as given)
  int smem_base, smem_rows, smem_k, smem_scr;
  double eps_abs, eps_rel;
  // P' scaled (PT) and raw (PrT), (n, n) each; q scaled and raw; the
  // IPM's bounds (pinned coordinates at -1, 1) and the raw ones; cf
  // (lanes, 2): c, f(0)
  const void *PT, *PrT, *q, *qr, *lb, *ub, *lbr, *ubr, *cf;
  // per row kind: rows (m, n) scaled J and raw R, scaled e and w, raw e
  // and w
  const void *Jh, *Rh, *eh, *wh, *ehr, *whr;
  const void *Ja, *Ra, *ea, *wa, *ear, *war;
  // outputs: the final iterate, the incumbent, per-lane scalars; the
  // device scratch (scratch_size elements per lane)
  void *dx, *z5, *z6, *dxb, *h, *z1, *p, *nn, *y, *rp, *rd, *fb, *dscr;
  int *it, *status;
};

// elements of each region
BHD long band_size(int b, int nb) {
  return nb > 0 ? (long)nb * b * b + (long)(nb - 1) * b * b + (long)nb * b
                : 0;
}
BHD long base_size(int n, int b, int nb) {
  return band_size(b, nb) + (long)N_VEC * n;
}
BHD long k_size(int n, int nb) { return nb > 0 ? 0 : (long)n * n; }
BHD long scr_size(int mh, int ma) { return (long)N_SCR_VEC * (mh + ma); }
// the device scratch per lane: base, then K, then the scratch m-vectors
// (ops.ipm_qp.k11_scratch_size mirrors it)
BHD long scratch_size(int n, int b, int nb, int mh, int ma) {
  return base_size(n, b, nb) + k_size(n, nb) + scr_size(mh, ma);
}

// A lane's shared memory, in elements of T: the reduction buffer, the
// flags, then the regions the plan puts there (base, rows, K, scratch)
struct Layout {
  long o_sc, o_base, o_rows, o_k, o_scr, total;
};

BHD Layout smem_layout(int n, int b, int nb, int mh, int ma, bool base,
                       bool rows, bool kin, bool scr) {
  Layout L;
  L.o_sc = (long)ipm::N_RED * 32;
  L.o_base = L.o_sc + N_SC;
  L.o_rows = L.o_base + (base ? base_size(n, b, nb) : 0);
  L.o_k = L.o_rows + (rows ? (long)(mh + ma) * n : 0);
  L.o_scr = L.o_k + (kin ? k_size(n, nb) : 0);
  L.total = L.o_scr + (scr ? scr_size(mh, ma) : 0);
  return L;
}

// the sum of v over the first WT members (a warp on the card: a xor
// butterfly, so every member gets the same bits)
template <int WT, typename T>
BHD T warp_sum(T v) {
#ifdef __CUDA_ARCH__
  if (WT > 1) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  }
#endif
  return v;
}

// ---- the block route: K2 / K3's device functions at the run-time b ----

template <typename T, int BS, int WT>
K11_NOINLINE bool factor_b(T* D, T* O, T* rc, int nb, T tiny, int tid) {
  return banded::btd_factor_warp<T, BS, WT>(D, O, rc, nb, tiny, tid);
}

// the exact fallback: K2's btd_factor_inplace, then the pivots'
// reciprocals
template <typename T, int BS, int WT>
K11_NOINLINE void factor_exact_b(T* D, T* O, T* rc, int nb, T tiny,
                                 int tid) {
  banded::btd_factor_inplace<T, BS, WT>(D, O, nb, tiny, tid);
  WSYNC();
  for (int k = tid; k < nb * BS; k += WT)
    rc[k] = qm::qrcp(D[(long)(k / BS) * BS * BS + (k % BS) * (BS + 1)]);
}

template <typename T, int BS, int WT>
K11_NOINLINE void solve_b(const T* D, const T* O, const T* rc, const T* r,
                          T* x, int nb, int tid) {
  banded::btd_solve_warp<T, BS, WT>(D, O, rc, r, x, nb, tid);
}

// The block route's factor and solves at run-time block size b, for every
// b in LO..HI (the launcher refuses another)
template <typename T, int WT, int LO, int HI>
struct Blocks {
  static BHD bool factor(int b, T* D, T* O, T* rc, int nb, T tiny, int tid) {
    if constexpr (LO > HI) {
      return false;
    } else {
      if (b == LO) return factor_b<T, LO, WT>(D, O, rc, nb, tiny, tid);
      return Blocks<T, WT, LO + 1, HI>::factor(b, D, O, rc, nb, tiny, tid);
    }
  }
  static BHD void factor_exact(int b, T* D, T* O, T* rc, int nb, T tiny,
                               int tid) {
    if constexpr (LO <= HI) {
      if (b == LO) return factor_exact_b<T, LO, WT>(D, O, rc, nb, tiny, tid);
      Blocks<T, WT, LO + 1, HI>::factor_exact(b, D, O, rc, nb, tiny, tid);
    }
  }
  static BHD void solve(int b, const T* D, const T* O, const T* rc,
                        const T* r, T* x, int nb, int tid) {
    if constexpr (LO <= HI) {
      if (b == LO) return solve_b<T, LO, WT>(D, O, rc, r, x, nb, tid);
      Blocks<T, WT, LO + 1, HI>::solve(b, D, O, rc, r, x, nb, tid);
    }
  }
};

// K11's lane: the loop is K6's (ipm::Loop); the rows are dense (m, n)
// matrices (ipm::Rows with S the scaled rows and R the raw ones, no
// window tables), P is read from P' (n, n), and K is assembled and
// factored by the block route (nb > 0) or the dense route.
template <typename T, int WT, typename Blk>
struct Lane : ipm::Loop<T, WT, false, Lane<T, WT, Blk>> {
  using B = ipm::Loop<T, WT, false, Lane<T, WT, Blk>>;
  using B::A;
  using B::chol_tiny;
  using B::da;
  using B::dbox;
  using B::dhd;
  using B::H;
  using B::n;
  using B::nthr;
  using B::red;
  using B::sc;
  using B::sync;
  using B::tid;
  int b, nb;
  // shared memory (or the device scratch): the band's blocks and pivots'
  // reciprocals (block route), the dense K (dense route), its pivots and
  // the column being scaled
  T *D, *O, *rc, *K, *ld, *col;
  // device memory: P' scaled and raw
  const T *PT, *PrT;

  // row i of M (m, n) times v
  BHD T rdot(const T* M, int i, const T* v) const {
    return ipm::rowdot(M + (long)i * n, v, n);
  }
  // column k of R.S' (u * w) (u may be null), the rows in order
  BHD T rcol(const ipm::Rows<T>& R, const T* w, const T* u, int k) const {
    T s = T(0);
    const T* Jk = R.S + k;
    if (u) {
      for (int i = 0; i < R.m; ++i) s += Jk[(long)i * n] * (u[i] * w[i]);
    } else {
      for (int i = 0; i < R.m; ++i) s += Jk[(long)i * n] * w[i];
    }
    return s;
  }
  // row k of P v from P' (column k of Mt), the columns in order
  BHD T pcol(const T* Mt, const T* v, int k) const {
    T s = T(0);
    for (int j = 0; j < n; ++j) s += Mt[(long)j * n + k] * v[j];
    return s;
  }
  BHD T hdot(int i, const T* v) const { return rdot(H.S, i, v); }
  BHD T adot(int i, const T* v) const { return rdot(A.S, i, v); }
  BHD T hraw(int i, const T* v) const { return rdot(H.R, i, v); }
  BHD T araw(int i, const T* v) const { return rdot(A.R, i, v); }
  BHD T hcol(const T* w, const T* u, int k) const { return rcol(H, w, u, k); }
  BHD T acol(const T* w, const T* u, int k) const { return rcol(A, w, u, k); }
  BHD T pmv(const T* v, int k) const { return pcol(PT, v, k); }
  BHD T rpmv(const T* v, int k) const { return pcol(PrT, v, k); }

  // Entry (r, c) of the symmetrized K: 0.5 (P + P') + Dbox, then
  // Jh' Dh Jh's and Ja' Da Ja's sums over the rows in order
  BHD T ksym(int r, int cc) const {
    T v = T(0.5) * (PT[(long)cc * n + r] + PT[(long)r * n + cc]);
    if (r == cc) v = v + dbox[r];
    T s = T(0);
    for (int i = 0; i < H.m; ++i) {
      const T* Ji = H.S + (long)i * n;
      s += (Ji[r] * dhd()[i]) * Ji[cc];
    }
    v = v + s;
    s = T(0);
    for (int i = 0; i < A.m; ++i) {
      const T* Ji = A.S + (long)i * n;
      s += (Ji[r] * da()[i]) * Ji[cc];
    }
    return v + s;
  }

  // K + reg I: the block route's band (D's lower triangles, O) or the
  // dense route's lower triangle, entry by entry over the team
  IHD void assemble() {
    T dm[1] = {T(-INFINITY)};
    if (nb > 0) {
      const long bb = (long)b * b, nD = nb * bb, nO = (nb - 1) * bb;
      for (long e = tid; e < nD + nO; e += nthr) {
        const bool isD = e < nD;
        const long ee = isD ? e : e - nD;
        const int t = (int)(ee / bb), i = (int)(ee % bb) / b,
                  j = (int)(ee % bb) % b;
        if (isD && j > i) continue;
        const int r = (isD ? t : t + 1) * b + i, cc = t * b + j;
        const T v = ksym(r, cc);
        (isD ? D : O)[ee] = v;
        if (isD && i == j) dm[0] = nmax(dm[0], v);
      }
    } else {
      for (long e = tid; e < (long)n * n; e += nthr) {
        const int r = (int)(e / n), cc = (int)(e % n);
        if (cc > r) continue;
        const T v = ksym(r, cc);
        K[e] = v;
        if (r == cc) dm[0] = nmax(dm[0], v);
      }
    }
    team_reduce<T, 0, 1>(red, nullptr, dm, tid, nthr);
    const T reg = sizeof(T) == 8 ? T(1e-12) * dm[0] + T(1e-11)
                                 : T(1e-7) * dm[0] + T(1e-8);
    if (nb > 0) {
      for (int k = tid; k < nb * b; k += nthr) {
        T* Dk = D + (long)(k / b) * b * b + (k % b) * (b + 1);
        *Dk = *Dk + reg;
      }
    } else {
      for (int k = tid; k < n; k += nthr) {
        T* Kk = K + (long)k * n + k;
        *Kk = *Kk + reg;
      }
    }
    sync();
  }

  // the block route: K2's steps on the first warp at the run-time b
  BHD bool team_factor() const { return nb == 0; }
  BHD bool factor_warp() {
    return Blk::factor(b, D, O, rc, nb, chol_tiny(), tid);
  }
  BHD void factor_exact() {
    Blk::factor_exact(b, D, O, rc, nb, chol_tiny(), tid);
  }

  // The dense route's Cholesky of K in place (lower triangle; the
  // pivots in ld), right-looking by the whole team: every member forms
  // pivot j from K[j, j] (read after the last barrier), column j is
  // scaled by it, then the trailing triangle takes its rank-one update, a
  // row per group of up to 32 members.  A pivot that is not positive (or
  // NaN) stops it and sets sc[2].
  IHD void factor_team() {
    const int lw = nthr < 32 ? nthr : 32;
    const int lane = tid % lw, grp = tid / lw, ngrp = nthr / lw;
    bool broke = false;
    for (int j = 0; j < n; ++j) {
      const T d = K[(long)j * n + j];
      if (!(d > T(0))) {
        broke = true;
        break;
      }
      const T ljj = qm::qsqrt(d);
      if (tid == 0) ld[j] = ljj;
      for (int i = j + 1 + tid; i < n; i += nthr) {
        const T v = qdiv(K[(long)i * n + j], ljj);
        K[(long)i * n + j] = v;
        col[i] = v;
      }
      sync();
      for (int i = j + 1 + grp; i < n; i += ngrp) {
        const T li = col[i];
        T* Ki = K + (long)i * n;
        for (int k = j + 1 + lane; k <= i; k += lw) Ki[k] = Ki[k] - li * col[k];
      }
      sync();
    }
    if (tid == 0) sc[2] = broke ? T(1) : T(0);
    sync();
  }

  // K x = r on the first WT members (the others wait at the barrier); x
  // may not be r.  The dense route: L y = r by rows (row i's dot product
  // with y summed over the warp, y_i stored by the member that reads it
  // back), then L' x = y by columns (x_j formed by its owner and
  // broadcast, the owners of the rows above it update theirs); NaN where
  // the factor broke.
  BHD void solve(const T* r, T* x) const {
    if (tid < WT) {
      if (nb > 0) {
        Blk::solve(b, D, O, rc, r, x, nb, tid);
      } else if (sc[2] != T(0)) {
        for (int k = tid; k < n; k += WT) x[k] = T(NAN);
      } else {
        for (int i = 0; i < n; ++i) {
          const T* Li = K + (long)i * n;
          T s = T(0);
          for (int k = tid; k < i; k += WT) s += Li[k] * x[k];
          s = warp_sum<WT>(s);
          if (tid == i % WT) x[i] = qdiv(r[i] - s, ld[i]);
        }
        for (int j = n - 1; j >= 0; --j) {
          T v = T(0);
          if (tid == j % WT) {
            v = qdiv(x[j], ld[j]);
            x[j] = v;
          }
          const T xj = banded::team_bcast<WT>(v, j % WT);
          const T* Lj = K + (long)j * n;
          for (int i = tid; i < j; i += WT) x[i] = x[i] - Lj[i] * xj;
        }
      }
    }
    sync();
  }
};

// One row kind of lane `lane`: its slices of the arguments, its scaled
// rows at S (shared or device memory) and its scratch at scr (12 m).
template <typename T>
BHD ipm::Rows<T> lane_rows(int m, int n, long lane, const T* S,
                           const void* R, const void* e, const void* w,
                           const void* er, const void* wr, T* scr) {
  ipm::Rows<T> K;
  const long ml = lane * m;
  K.m = m;
  K.S = S;
  K.R = (const T*)R + ml * n;
  K.e = (const T*)e + ml;
  K.w = (const T*)w + ml;
  K.er = (const T*)er + ml;
  K.wr = (const T*)wr + ml;
  K.rowG = nullptr;
  K.cov = nullptr;
  K.v0 = scr;
  K.v1 = scr + 1L * m;
  K.v2 = scr + 2L * m;
  K.v3 = scr + 3L * m;
  K.v4 = scr + 4L * m;
  K.v5 = scr + 5L * m;
  K.d0[0] = scr + 6L * m;
  K.d1[0] = scr + 7L * m;
  K.d2[0] = scr + 8L * m;
  K.d0[1] = scr + 9L * m;
  K.d1[1] = scr + 10L * m;
  K.d2[1] = scr + 11L * m;
  return K;
}

// Lane `lane`'s view of the arguments, with its shared memory `sm` (laid
// out by smem_layout as Args' flags ask) and the team (tid of nthr); then
// its whole loop.  Blk: the block route's factor and solves.
template <typename T, int WT, typename Blk>
IHD void ipm_dense_lane(const Args& a, int lane, T* sm, int tid, int nthr) {
  Lane<T, WT, Blk> L;
  const int n = a.n, b = a.b, nb = a.nb, mh = a.mh, ma = a.ma;
  const long nl = (long)lane * n;
  const Layout lay = smem_layout(n, b, nb, mh, ma, a.smem_base != 0,
                                 a.smem_rows != 0, a.smem_k != 0,
                                 a.smem_scr != 0);
  T* ds = (T*)a.dscr + (long)lane * scratch_size(n, b, nb, mh, ma);
  T* base = a.smem_base ? sm + lay.o_base : ds;
  T* kreg = a.smem_k ? sm + lay.o_k : ds + base_size(n, b, nb);
  T* scr = a.smem_scr ? sm + lay.o_scr
                      : ds + base_size(n, b, nb) + k_size(n, nb);
  L.tid = tid;
  L.nthr = nthr;
  L.n = n;
  L.b = b;
  L.nb = nb;
  L.max_iter = a.max_iter;
  L.eps_abs = T(a.eps_abs);
  L.eps_rel = T(a.eps_rel);
  L.c = ((const T*)a.cf)[2 * lane];
  L.fzero = ((const T*)a.cf)[2 * lane + 1];
  L.red = sm;
  L.sc = sm + lay.o_sc;
  L.D = base;
  L.O = base + (nb > 0 ? (long)nb * b * b : 0);
  L.rc = L.O + (nb > 0 ? (long)(nb - 1) * b * b : 0);
  L.K = kreg;
  T* v = base + band_size(b, nb);
  L.dx = v;
  L.z5 = v + 1L * n;
  L.z6 = v + 2L * n;
  L.lb = v + 3L * n;
  L.ub = v + 4L * n;
  L.q = v + 5L * n;
  L.dbox = v + 6L * n;
  L.rdx = v + 7L * n;
  L.rhs = v + 8L * n;
  L.ddxa = v + 9L * n;
  L.dz5a = v + 10L * n;
  L.dz6a = v + 11L * n;
  L.ddx = v + 12L * n;
  L.dz5 = v + 13L * n;
  L.dz6 = v + 14L * n;
  L.tmp = v + 15L * n;
  L.tmp2 = v + 16L * n;
  L.col = v + 17L * n;
  L.ld = v + 18L * n;
  const long nn2 = (long)n * n;
  L.PT = (const T*)a.PT + (long)lane * nn2;
  L.PrT = (const T*)a.PrT + (long)lane * nn2;
  L.gq = (const T*)a.q + nl;
  L.qr = (const T*)a.qr + nl;
  L.glb = (const T*)a.lb + nl;
  L.gub = (const T*)a.ub + nl;
  L.lbr = (const T*)a.lbr + nl;
  L.ubr = (const T*)a.ubr + nl;
  L.odx = (T*)a.dx + nl;
  L.oz5 = (T*)a.z5 + nl;
  L.oz6 = (T*)a.z6 + nl;
  L.dxb = (T*)a.dxb + nl;
  // the scaled rows: staged into shared memory by the team (made visible
  // by the barrier after the initial point's n-vectors), or read where
  // they lie
  const T* Jh = (const T*)a.Jh + (long)lane * mh * n;
  const T* Ja = (const T*)a.Ja + (long)lane * ma * n;
  if (a.smem_rows) {
    T* sh = sm + lay.o_rows;
    T* sa = sh + (long)mh * n;
    for (long k = tid; k < (long)mh * n; k += nthr) sh[k] = Jh[k];
    for (long k = tid; k < (long)ma * n; k += nthr) sa[k] = Ja[k];
    Jh = sh;
    Ja = sa;
  }
  L.H = lane_rows<T>(mh, n, lane, Jh, a.Rh, a.eh, a.wh, a.ehr, a.whr, scr);
  L.A = lane_rows<T>(ma, n, lane, Ja, a.Ra, a.ea, a.wa, a.ear, a.war,
                     scr + (long)N_SCR_VEC * mh);
  L.h = (T*)a.h + (long)lane * mh;
  L.z1 = (T*)a.z1 + (long)lane * mh;
  L.p = (T*)a.p + (long)lane * ma;
  L.nn = (T*)a.nn + (long)lane * ma;
  L.y = (T*)a.y + (long)lane * ma;
  L.clk = nullptr;
  L.t_last = 0;
  L.run(a.it + lane, a.status + lane, (T*)a.rp + lane, (T*)a.rd + lane,
        (T*)a.fb + lane);
}

}  // namespace ipm_dense
