// K6 ipm_banded's per-lane body: the banded interior-point QP solver's
// whole Mehrotra predictor-corrector loop for ONE lane, from the initial
// interior point to termination.
//
// Replaces trajopt_tpu/ops/ipm_qp.py:92 solve_ipm_qp's banded loop (body
// :373-511, cond :513-514, while_loop :516-520, make_kkt_solve :321-371);
// its plain PyTorch counterpart is ops/ipm_qp.py's _loop_plain.  Per
// iteration, in the plain loop's order: the barrier diagonals; the block
// assembly of K = P + Jh' Dh Jh + Ja' Da Ja + Dbox (K1's
// banded::bb_quad_entry per row group) and the relative regularization;
// the block Cholesky (K2's steps, in place); the residuals and mu; the
// predictor and corrector Newton solves (K3's steps), each with one
// refinement step against the exact condensed matrix; the step lengths and
// sigma; the NaN-guarded update; best-iterate tracking by the exact
// composite objective; the unscaled termination test.  A lane leaves its
// loop when its status is set or it reaches max_iter, so a stopped lane
// never changes again.  The set-up (pinned-coordinate elimination, column
// and row scaling, the cost scale c, P's blocks, f(0)) and the teardown run
// in PyTorch in the wrapper (ops/ipm_qp.py).
//
// Team: every phase is a strided loop over a thread team (`tid` of
// `nthr`): rows i = tid, tid + nthr, ... of each row kind, columns
// likewise, so a row or column always has the same owner and no two
// members write one entry.  TEAM_SYNC separates phases that read what
// another member wrote.  The factor and the solves run on the first WT
// members (one warp on the card, banded.cuh's warp-synchronous b-steps).
// On the card the team is the CTA (ipm_banded.cu); in the host build
// (ipm_host.cpp) it is one thread and TEAM_SYNC is empty.
//
// Sums: every sum runs in a fixed order (a row's window in column order,
// Jh' w by column over the row groups in row order, reductions in a fixed
// tree), no atomics; min, max and clamp propagate NaN as torch does.
//
// Memory per lane: D, O (factored in place) and the n-vectors in shared
// memory (smem_elems); the rows (scaled for the Newton system, raw for
// the composite objective) and the m-vectors in device memory (the
// scratch holds 12 vectors per row kind).
#pragma once

#include "banded.cuh"

#ifdef __CUDACC__
#define IHD __host__ __device__
#else
#define IHD inline
#endif

#ifdef __CUDA_ARCH__
#define TEAM_SYNC() __syncthreads()
#else
#define TEAM_SYNC() ((void)0)
#endif

namespace ipm {

enum { QP_UNSOLVED = 0, QP_SOLVED = 1, QP_SOLVED_INACCURATE = 2,
       QP_MAX_ITER = 3 };
constexpr int N_SMEM_VEC = 17;  // n-vectors in shared memory
constexpr int N_SCR_VEC = 12;   // m-vectors per row kind in the scratch
constexpr int N_RED = 14;       // values of the widest team reduction

// The launch arguments (ctypes mirror: ops.ipm_qp._K6Args).  Per-lane
// arrays are lane-major and contiguous; the int tables are shared.
struct Args {
  int lanes, n, b, nb, mh, ma, ngr_h, ngr_a, max_iter, pad;
  double eps_abs, eps_rel;
  // P blocks: scaled and masked (PD, PO) and raw (RD, RO); q scaled and
  // raw; the IPM's bounds (pinned coordinates at -1, 1) and the raw ones;
  // cf (lanes, 2): c, f(0)
  const void *PD, *PO, *RD, *RO, *q, *qr, *lb, *ub, *lbr, *ubr, *cf;
  // per row kind: rows (m, 2b) scaled S and raw R, scaled e and w, raw
  // e and w; rowG (m) window start block of each row; gtab (ngr, 4) per
  // row group: first row, n_g, r, offset of its window starts in G
  const void *Sh, *Rh, *eh, *wh, *ehr, *whr;
  const void *Sa, *Ra, *ea, *wa, *ear, *war;
  const int *rowGh, *gtabh, *Gh, *rowGa, *gtaba, *Ga;
  // outputs: the final iterate, the incumbent, per-lane scalars; scratch
  void *dx, *z5, *z6, *dxb, *h, *z1, *p, *nn, *y, *rp, *rd, *fb, *scr;
  int *it, *status;
};

BHD long smem_elems(int n, int b, int nb) {
  return (long)(2 * nb - 1) * b * b + (long)N_SMEM_VEC * n + N_RED * 32;
}

template <typename T>
BHD T nmax(T a, T b) { return (a > b || a != a) ? a : b; }
template <typename T>
BHD T clamp_lo(T x, T lo) { return x < lo ? lo : x; }  // NaN stays NaN
template <typename T>
BHD T clamp_hi(T x, T hi) { return x > hi ? hi : x; }
template <typename T>
BHD T aabs(T x) { return x < T(0) ? -x : x; }
template <typename T>
BHD bool finite(T x) { return x - x == T(0); }

// Reduce KS sums and KM maxima over the team; every member gets the
// results.  Warp shuffles in a fixed tree, then the warps in order.
template <typename T, int KS, int KM>
BHD void team_reduce(T* red, T* sums, T* maxs, int tid, int nthr) {
#ifdef __CUDA_ARCH__
  const int lane = tid & 31, warp = tid >> 5, nw = nthr >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < KS; ++k)
      sums[k] += __shfl_down_sync(0xffffffffu, sums[k], o);
#pragma unroll
    for (int k = 0; k < KM; ++k)
      maxs[k] = nmax(maxs[k], __shfl_down_sync(0xffffffffu, maxs[k], o));
  }
  if (lane == 0) {
    for (int k = 0; k < KS; ++k) red[k * 32 + warp] = sums[k];
    for (int k = 0; k < KM; ++k) red[(KS + k) * 32 + warp] = maxs[k];
  }
  __syncthreads();
  for (int k = 0; k < KS; ++k) {
    T a = red[k * 32];
    for (int w = 1; w < nw; ++w) a += red[k * 32 + w];
    sums[k] = a;
  }
  for (int k = 0; k < KM; ++k) {
    T a = red[(KS + k) * 32];
    for (int w = 1; w < nw; ++w) a = nmax(a, red[(KS + k) * 32 + w]);
    maxs[k] = a;
  }
  __syncthreads();
#else
  (void)red, (void)sums, (void)maxs, (void)tid, (void)nthr;
#endif
}

template <typename T>
BHD T rowdot(const T* row, const T* v, int w) {
  T s = T(0);
  for (int k = 0; k < w; ++k) s += row[k] * v[k];
  return s;
}

// One row kind (hinge or abs) of one lane.
template <typename T>
struct Rows {
  int m, ngr;
  const T *S, *R, *e, *w, *er, *wr;
  const int *rowG, *gtab, *G;
  T *s[N_SCR_VEC];  // scratch m-vectors
};

// Column (t, i) of A' (u * w) (u may be null): each row group's window
// groups that cover block t, their r rows summed first, in row order.
template <typename T>
BHD T rmv_col(const Rows<T>& K, const T* w, const T* u, int b, int t, int i) {
  T acc = T(0);
  const int ww = 2 * b;
  for (int gr = 0; gr < K.ngr; ++gr) {
    const int* g4 = K.gtab + 4 * gr;
    const int* G = K.G + g4[3];
    for (int g = 0; g < g4[1]; ++g) {
      const int Gg = G[g];
      const int half = Gg == t ? 0 : (Gg + 1 == t ? 1 : -1);
      if (half < 0) continue;
      const int r0 = g4[0] + g * g4[2];
      const T* B = K.S + (long)r0 * ww + half * b + i;
      T s = T(0);
      for (int k = 0; k < g4[2]; ++k)
        s += B[(long)k * ww] * (u ? u[r0 + k] * w[r0 + k] : w[r0 + k]);
      acc += s;
    }
  }
  return acc;
}

// Row (t, i) of the block-tridiagonal P (PD, PO) times v
template <typename T, int BS>
BHD T pmv(const T* PD, const T* PO, const T* v, int nb, int t, int i) {
  constexpr int BB = BS * BS;
  T acc = T(0);
  const T* Dt = PD + (long)t * BB + i * BS;
  for (int j = 0; j < BS; ++j) acc += Dt[j] * v[t * BS + j];
  if (t > 0) {
    const T* Ot = PO + (long)(t - 1) * BB + i * BS;
    for (int j = 0; j < BS; ++j) acc += Ot[j] * v[(t - 1) * BS + j];
  }
  if (t < nb - 1) {
    const T* Ot = PO + (long)t * BB;
    for (int j = 0; j < BS; ++j) acc += Ot[j * BS + i] * v[(t + 1) * BS + j];
  }
  return acc;
}

template <typename T, int BS, int WT>
struct Lane {
  int tid, nthr, n, nb, max_iter;
  T eps_abs, eps_rel, c, fzero;
  // shared memory
  T *D, *O, *red;
  T *dx, *z5, *z6, *lb, *ub, *q, *dbox, *rdx, *rhs, *ddxa, *dz5a, *dz6a,
      *ddx, *dz5, *dz6, *tmp, *tmp2;
  // device memory
  const T *PD, *PO, *RD, *RO, *qr, *lbr, *ubr, *glb, *gub, *gq;
  T *odx, *oz5, *oz6, *dxb;
  Rows<T> H, A;
  T *h, *z1, *p, *nn, *y;

  // scratch names (hinge)
  BHD T* s1() const { return H.s[0]; }
  BHD T* z2() const { return H.s[1]; }
  BHD T* den() const { return H.s[2]; }
  BHD T* dhd() const { return H.s[3]; }
  BHD T* bh() const { return H.s[4]; }
  BHD T* jvh() const { return H.s[5]; }
  // (abs)
  BHD T* z3() const { return A.s[0]; }
  BHD T* z4() const { return A.s[1]; }
  BHD T* da() const { return A.s[2]; }
  BHD T* ba() const { return A.s[3]; }
  BHD T* re() const { return A.s[4]; }
  BHD T* jva() const { return A.s[5]; }

  static BHD T tiny() { return sizeof(T) == 8 ? T(1e-30) : T(1e-25); }
  static BHD T dcap() { return sizeof(T) == 8 ? T(1e14) : T(1e10); }
  static BHD T chol_tiny() { return sizeof(T) == 8 ? T(1e-30) : T(1e-18); }

  BHD T hdot(int i, const T* v) const {
    return rowdot(H.S + (long)i * 2 * BS, v + H.rowG[i] * BS, 2 * BS);
  }
  BHD T adot(int i, const T* v) const {
    return rowdot(A.S + (long)i * 2 * BS, v + A.rowG[i] * BS, 2 * BS);
  }

  // the step-length candidate of (v, dv), folded into the running -min
  static BHD void step_cand(T& negmin, T v, T dv) {
    if (dv < T(0)) negmin = nmax(negmin, -((T(-0.99) * v) / dv));
  }

  BHD void sync() const { TEAM_SYNC(); }

  BHD void solve(const T* r, T* x) const {
    if (tid < WT) banded::btd_solve_lane<T, BS, WT>(D, O, r, x, nb, tid);
    sync();
  }

  // the complementarity right-hand sides of the predictor (corr false)
  // and of the corrector (Mehrotra's second-order terms from the
  // predictor's step, stored in H.s[6..8], A.s[6..8], ddxa, dz5a, dz6a)
  BHD T rc1(int i, bool corr, T smu) const {
    return corr ? (smu - z1[i] * s1()[i]) - H.s[6][i] * H.s[8][i]
                : -z1[i] * s1()[i];
  }
  BHD T rc2(int i, bool corr, T smu) const {
    return corr ? (smu - z2()[i] * h[i]) - (-H.s[6][i]) * H.s[7][i]
                : -z2()[i] * h[i];
  }
  BHD T rc3(int i, bool corr, T smu) const {
    return corr ? (smu - z3()[i] * p[i]) - (-A.s[6][i]) * A.s[7][i]
                : -z3()[i] * p[i];
  }
  BHD T rc4(int i, bool corr, T smu) const {
    return corr ? (smu - z4()[i] * nn[i]) - A.s[6][i] * A.s[8][i]
                : -z4()[i] * nn[i];
  }
  BHD T rc5(int k, bool corr, T smu) const {
    return corr ? (smu - z5[k] * (dx[k] - lb[k])) - dz5a[k] * ddxa[k]
                : -z5[k] * (dx[k] - lb[k]);
  }
  BHD T rc6(int k, bool corr, T smu) const {
    return corr ? (smu - z6[k] * (ub[k] - dx[k])) - dz6a[k] * (-ddxa[k])
                : -z6[k] * (ub[k] - dx[k]);
  }

  // K = P + Jh' Dh Jh + Ja' Da Ja + Dbox + reg I into (D, O), then its
  // block Cholesky in place
  IHD void assemble_factor() {
    constexpr int BB = BS * BS;
    const int nD = nb * BB, nO = (nb - 1) * BB;
    T dm[1] = {T(-INFINITY)};
    for (int e = tid; e < nD + nO; e += nthr) {
      const bool isD = e < nD;
      const int ee = isD ? e : e - nD;
      const int t = ee / BB, i = (ee % BB) / BS, j = ee % BS;
      T acc = isD ? PD[ee] + (i == j ? dbox[t * BS + i] : T(0)) : PO[ee];
      for (int gr = 0; gr < H.ngr; ++gr) {
        const int* g4 = H.gtab + 4 * gr;
        acc = banded::bb_quad_entry<T>(H.S + (long)g4[0] * 2 * BS,
                                       H.G + g4[3], dhd() + g4[0], g4[1],
                                       g4[2], BS, isD, t, i, j, acc);
      }
      for (int gr = 0; gr < A.ngr; ++gr) {
        const int* g4 = A.gtab + 4 * gr;
        acc = banded::bb_quad_entry<T>(A.S + (long)g4[0] * 2 * BS,
                                       A.G + g4[3], da() + g4[0], g4[1],
                                       g4[2], BS, isD, t, i, j, acc);
      }
      (isD ? D : O)[ee] = acc;
      if (isD && i == j) dm[0] = nmax(dm[0], acc);
    }
    team_reduce<T, 0, 1>(red, nullptr, dm, tid, nthr);
    const T reg = sizeof(T) == 8 ? T(1e-12) * dm[0] + T(1e-11)
                                 : T(1e-7) * dm[0] + T(1e-8);
    for (int e = tid; e < nD; e += nthr)
      if ((e % BB) / BS == e % BS) D[e] = D[e] + reg;
    sync();
    if (tid < WT)
      banded::btd_factor_inplace<T, BS, WT>(D, O, nb, chol_tiny(), tid);
    sync();
  }

  // One Newton solve of the condensed system for the predictor (corr
  // false) or the corrector; the step goes to (ddx, dz5, dz6) and the
  // row kinds' slots 6..8 (predictor) or 9..11 (corrector).  Returns the
  // step length.
  IHD T newton(bool corr, T smu, T* sdx, T* sz5, T* sz6) {
    const int o = corr ? 9 : 6;
    T* dz1 = H.s[o];
    T* dh = H.s[o + 1];
    T* ds1 = H.s[o + 2];
    T* dy = A.s[o];
    T* dp = A.s[o + 1];
    T* dnn = A.s[o + 2];
    for (int i = tid; i < H.m; i += nthr)
      bh()[i] = (rc1(i, corr, smu) * z2()[i] - z1[i] * rc2(i, corr, smu)) /
                den()[i];
    for (int i = tid; i < A.m; i += nthr)
      ba()[i] = (-re()[i] + rc3(i, corr, smu) / z3()[i]) -
                rc4(i, corr, smu) / z4()[i];
    sync();
    for (int k = tid; k < n; k += nthr) {
      const int t = k / BS, i = k % BS;
      rhs[k] = ((-rdx[k] - rmv_col(H, bh(), (const T*)nullptr, BS, t, i)) +
                rmv_col(A, ba(), da(), BS, t, i) +
                rc5(k, corr, smu) / (dx[k] - lb[k])) -
               rc6(k, corr, smu) / (ub[k] - dx[k]);
    }
    sync();
    solve(rhs, sdx);
    // one refinement step against the exact condensed matrix
    for (int i = tid; i < H.m; i += nthr) jvh()[i] = hdot(i, sdx);
    for (int i = tid; i < A.m; i += nthr) jva()[i] = adot(i, sdx);
    sync();
    for (int k = tid; k < n; k += nthr) {
      const int t = k / BS, i = k % BS;
      const T kmv = ((pmv<T, BS>(PD, PO, sdx, nb, t, i) +
                      rmv_col(H, jvh(), dhd(), BS, t, i)) +
                     rmv_col(A, jva(), da(), BS, t, i)) +
                    dbox[k] * sdx[k];
      tmp[k] = rhs[k] - kmv;
    }
    sync();
    solve(tmp, tmp2);
    for (int k = tid; k < n; k += nthr) sdx[k] = sdx[k] + tmp2[k];
    sync();
    // the slack and dual steps, and the step length
    T am[1] = {T(-1)};  // -min(1, candidates)
    for (int i = tid; i < H.m; i += nthr) {
      const T jv = hdot(i, sdx);
      dz1[i] = dhd()[i] * jv + bh()[i];
      dh[i] = (rc2(i, corr, smu) + h[i] * dz1[i]) / z2()[i];
      ds1[i] = dh[i] - jv;
      step_cand(am[0], s1()[i], ds1[i]);
      step_cand(am[0], h[i], dh[i]);
      step_cand(am[0], z1[i], dz1[i]);
      step_cand(am[0], z2()[i], -dz1[i]);
    }
    for (int i = tid; i < A.m; i += nthr) {
      const T jv = adot(i, sdx);
      dy[i] = da()[i] * (jv - ba()[i]);
      dp[i] = (rc3(i, corr, smu) + p[i] * dy[i]) / z3()[i];
      dnn[i] = (rc4(i, corr, smu) - nn[i] * dy[i]) / z4()[i];
      step_cand(am[0], p[i], dp[i]);
      step_cand(am[0], nn[i], dnn[i]);
      step_cand(am[0], z3()[i], -dy[i]);
      step_cand(am[0], z4()[i], dy[i]);
    }
    for (int k = tid; k < n; k += nthr) {
      sz5[k] = (rc5(k, corr, smu) - z5[k] * sdx[k]) / (dx[k] - lb[k]);
      sz6[k] = (rc6(k, corr, smu) + z6[k] * sdx[k]) / (ub[k] - dx[k]);
      step_cand(am[0], dx[k] - lb[k], sdx[k]);
      step_cand(am[0], ub[k] - dx[k], -sdx[k]);
      step_cand(am[0], z5[k], sz5[k]);
      step_cand(am[0], z6[k], sz6[k]);
    }
    team_reduce<T, 0, 1>(red, nullptr, am, tid, nthr);
    return -am[0];
  }

  static BHD T mu_of(const T* s, T n_pairs) {
    return ((((s[0] + s[1]) + (s[2] + s[3])) + s[4]) + s[5]) / n_pairs;
  }

  // the whole loop; returns the final (it, status, rp, rd, f_best)
  IHD void run(int* it_out, int* st_out, T* rp_out, T* rd_out, T* fb_out) {
    const T n_pairs = T(2 * H.m + 2 * A.m + 2 * n);
    const T inf = T(INFINITY);
    // ---- initial interior point ----
    for (int k = tid; k < n; k += nthr) {
      lb[k] = glb[k];
      ub[k] = gub[k];
      q[k] = gq[k];
      const T lo = lb[k] + T(0.01) * (ub[k] - lb[k]);
      const T hi = ub[k] - T(0.01) * (ub[k] - lb[k]);
      dx[k] = clamp_hi(clamp_lo(T(0), lo), hi);
      z5[k] = T(1);
      z6[k] = T(1);
      dxb[k] = T(0);
    }
    sync();
    for (int i = tid; i < H.m; i += nthr) {
      h[i] = clamp_lo(hdot(i, dx) + H.e[i], T(0)) + T(1);
      z1[i] = T(0.5) * H.w[i];
    }
    for (int i = tid; i < A.m; i += nthr) {
      const T r0 = adot(i, dx) + A.e[i];
      p[i] = clamp_lo(r0, T(0)) + T(1);
      nn[i] = p[i] - r0;
      y[i] = T(0);
    }
    sync();
    int it = 0, status = QP_UNSOLVED;
    T rp = inf, rd = inf, fbest = fzero;
    while (status == QP_UNSOLVED && it < max_iter) {
      // ---- barrier diagonals ----
      for (int i = tid; i < H.m; i += nthr) {
        s1()[i] = h[i] - (hdot(i, dx) + H.e[i]);
        z2()[i] = H.w[i] - z1[i];
        den()[i] = clamp_lo(h[i] * z1[i] + s1()[i] * z2()[i], tiny());
        dhd()[i] = clamp_hi(z1[i] * z2()[i] / den()[i], dcap());
      }
      for (int i = tid; i < A.m; i += nthr) {
        z3()[i] = A.w[i] - y[i];
        z4()[i] = A.w[i] + y[i];
        da()[i] = clamp_hi(
            T(1) / clamp_lo(p[i] / z3()[i] + nn[i] / z4()[i], tiny()),
            dcap());
      }
      for (int k = tid; k < n; k += nthr)
        dbox[k] = clamp_hi(z5[k] / (dx[k] - lb[k]) + z6[k] / (ub[k] - dx[k]),
                           dcap());
      sync();
      assemble_factor();
      // ---- residuals and mu ----
      T su[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      for (int i = tid; i < H.m; i += nthr) {
        su[0] += z1[i] * s1()[i];
        su[1] += z2()[i] * h[i];
      }
      for (int i = tid; i < A.m; i += nthr) {
        re()[i] = ((adot(i, dx) - p[i]) + nn[i]) + A.e[i];
        su[2] += z3()[i] * p[i];
        su[3] += z4()[i] * nn[i];
      }
      for (int k = tid; k < n; k += nthr) {
        const int t = k / BS, i = k % BS;
        rdx[k] = ((((pmv<T, BS>(PD, PO, dx, nb, t, i) + q[k]) +
                    rmv_col(H, z1, (const T*)nullptr, BS, t, i)) +
                   rmv_col(A, y, (const T*)nullptr, BS, t, i)) -
                  z5[k]) +
                 z6[k];
        su[4] += z5[k] * (dx[k] - lb[k]);
        su[5] += z6[k] * (ub[k] - dx[k]);
      }
      team_reduce<T, 6, 0>(red, su, nullptr, tid, nthr);
      const T mu = mu_of(su, n_pairs);

      // ---- predictor ----
      const T a_aff = newton(false, T(0), ddxa, dz5a, dz6a);
      for (int k = 0; k < 6; ++k) su[k] = T(0);
      for (int i = tid; i < H.m; i += nthr) {
        const T z1a = z1[i] + a_aff * H.s[6][i];
        su[0] += z1a * (s1()[i] + a_aff * H.s[8][i]);
        su[1] += (H.w[i] - z1a) * (h[i] + a_aff * H.s[7][i]);
      }
      for (int i = tid; i < A.m; i += nthr) {
        const T ya = y[i] + a_aff * A.s[6][i];
        su[2] += (A.w[i] - ya) * (p[i] + a_aff * A.s[7][i]);
        su[3] += (A.w[i] + ya) * (nn[i] + a_aff * A.s[8][i]);
      }
      for (int k = tid; k < n; k += nthr) {
        const T dxa = dx[k] + a_aff * ddxa[k];
        su[4] += (z5[k] + a_aff * dz5a[k]) * (dxa - lb[k]);
        su[5] += (z6[k] + a_aff * dz6a[k]) * (ub[k] - dxa);
      }
      team_reduce<T, 6, 0>(red, su, nullptr, tid, nthr);
      const T mu_aff = mu_of(su, n_pairs);
      const T ratio = mu_aff / clamp_lo(mu, tiny());
      const T sigma = clamp_hi(clamp_lo(ratio * ratio * ratio, T(1e-8)), T(1));

      // ---- corrector ----
      const T a = newton(true, sigma * mu, ddx, dz5, dz6);
      T* dz1 = H.s[9];
      T* dh = H.s[10];
      T* dy = A.s[9];
      T* dp = A.s[10];
      T* dnn = A.s[11];

      // ---- NaN guard: a broken Newton step keeps the incumbent ----
      T bad[1] = {T(0)};
      for (int k = tid; k < n; k += nthr)
        if (!finite(dx[k] + a * ddx[k]) || !finite(z5[k] + a * dz5[k]) ||
            !finite(z6[k] + a * dz6[k]))
          bad[0] = T(1);
      for (int i = tid; i < H.m; i += nthr)
        if (!finite(h[i] + a * dh[i]) || !finite(z1[i] + a * dz1[i]))
          bad[0] = T(1);
      for (int i = tid; i < A.m; i += nthr)
        if (!finite(p[i] + a * dp[i]) || !finite(nn[i] + a * dnn[i]) ||
            !finite(y[i] + a * dy[i]))
          bad[0] = T(1);
      team_reduce<T, 0, 1>(red, nullptr, bad, tid, nthr);
      const bool fin = bad[0] == T(0);
      if (fin) {
        for (int k = tid; k < n; k += nthr) {
          dx[k] = dx[k] + a * ddx[k];
          z5[k] = z5[k] + a * dz5[k];
          z6[k] = z6[k] + a * dz6[k];
        }
        for (int i = tid; i < H.m; i += nthr) {
          h[i] = h[i] + a * dh[i];
          z1[i] = z1[i] + a * dz1[i];
        }
        for (int i = tid; i < A.m; i += nthr) {
          p[i] = p[i] + a * dp[i];
          nn[i] = nn[i] + a * dnn[i];
          y[i] = y[i] + a * dy[i];
        }
      }
      // the composite objective's point: clip(dx, raw bounds)
      for (int k = tid; k < n; k += nthr)
        tmp[k] = clamp_hi(clamp_lo(dx[k], lbr[k]), ubr[k]);
      sync();

      // ---- composite objective, residuals, mu, scales: one pass ----
      // sums: mu's six dots, d'P d, q'd, the hinge and abs terms;
      // maxima: |re|, p_scale, |rdx|, d_scale
      T sm[10] = {T(0), T(0), T(0), T(0), T(0),
                  T(0), T(0), T(0), T(0), T(0)};
      T mx[4] = {T(0), T(0), T(0), T(0)};
      for (int i = tid; i < H.m; i += nthr) {
        const T s1n = h[i] - (hdot(i, dx) + H.e[i]);
        sm[0] += z1[i] * s1n;
        sm[1] += (H.w[i] - z1[i]) * h[i];
        const T g = H.er[i] + rowdot(H.R + (long)i * 2 * BS,
                                     tmp + H.rowG[i] * BS, 2 * BS);
        sm[8] += H.wr[i] * clamp_lo(g, T(0));
      }
      for (int i = tid; i < A.m; i += nthr) {
        const T jv = adot(i, dx);
        const T r = ((jv - p[i]) + nn[i]) + A.e[i];
        mx[0] = nmax(mx[0], aabs(r));
        mx[1] = nmax(mx[1], nmax(aabs(jv), aabs(A.e[i])));
        sm[2] += (A.w[i] - y[i]) * p[i];
        sm[3] += (A.w[i] + y[i]) * nn[i];
        const T g = A.er[i] + rowdot(A.R + (long)i * 2 * BS,
                                     tmp + A.rowG[i] * BS, 2 * BS);
        sm[9] += A.wr[i] * aabs(g);
      }
      for (int k = tid; k < n; k += nthr) {
        const int t = k / BS, i = k % BS;
        const T pdx = pmv<T, BS>(PD, PO, dx, nb, t, i);
        const T jh = rmv_col(H, z1, (const T*)nullptr, BS, t, i);
        const T ja = rmv_col(A, y, (const T*)nullptr, BS, t, i);
        const T r = ((((pdx + q[k]) + jh) + ja) - z5[k]) + z6[k];
        mx[2] = nmax(mx[2], aabs(r));
        mx[3] = nmax(nmax(mx[3], nmax(aabs(pdx), aabs(q[k]))),
                     nmax(aabs(jh), aabs(ja)));
        sm[4] += z5[k] * (dx[k] - lb[k]);
        sm[5] += z6[k] * (ub[k] - dx[k]);
        sm[6] += tmp[k] * pmv<T, BS>(RD, RO, tmp, nb, t, i);
        sm[7] += qr[k] * tmp[k];
      }
      team_reduce<T, 10, 4>(red, sm, mx, tid, nthr);
      const T f1 = ((T(0.5) * sm[6] + sm[7]) + sm[8]) + sm[9];

      // ---- best iterate ----
      if (fin && f1 < fbest) {
        fbest = f1;
        for (int k = tid; k < n; k += nthr) dxb[k] = dx[k];
      }
      // ---- termination (unscaled; OSQP-style abs + rel criterion) ----
      const T mu1 = mu_of(sm, n_pairs);
      const T rp_u = mx[0];
      const T rd_u = mx[2] / c;
      const T gap_u = (n_pairs * mu1) / c;
      const T d_scale = mx[3] / c;
      const T f_scale = nmax(aabs(f1), aabs(fzero)) + T(1);
      const T eps_p = eps_abs + eps_rel * mx[1];
      const T eps_d = eps_abs + eps_rel * d_scale;
      const T eps_g = eps_abs * f_scale;
      rp = rp_u / eps_p;
      rd = nmax(rd_u / eps_d, gap_u / eps_g);
      const bool conv = fin && rp <= T(1) && rd <= T(1);
      const int broke = fbest < fzero ? QP_SOLVED_INACCURATE : QP_MAX_ITER;
      status = conv ? QP_SOLVED : (fin ? status : broke);
      it += 1;
      sync();
    }
    for (int k = tid; k < n; k += nthr) {
      odx[k] = dx[k];
      oz5[k] = z5[k];
      oz6[k] = z6[k];
    }
    if (tid == 0) {
      *it_out = it;
      *st_out = status;
      *rp_out = rp;
      *rd_out = rd;
      *fb_out = fbest;
    }
  }
};

// Lane `lane`'s view of the arguments, with its shared memory `sm`
// (smem_elems entries) and the team (tid of nthr); then its whole loop.
template <typename T, int BS, int WT>
IHD void ipm_lane(const Args& a, int lane, T* sm, int tid, int nthr) {
  Lane<T, BS, WT> L;
  const int n = a.n, nb = a.nb, BB = BS * BS;
  const long nl = (long)lane * n;
  L.tid = tid;
  L.nthr = nthr;
  L.n = n;
  L.nb = nb;
  L.max_iter = a.max_iter;
  L.eps_abs = T(a.eps_abs);
  L.eps_rel = T(a.eps_rel);
  L.c = ((const T*)a.cf)[2 * lane];
  L.fzero = ((const T*)a.cf)[2 * lane + 1];
  L.D = sm;
  L.O = L.D + (long)nb * BB;
  T* v = L.O + (long)(nb - 1) * BB;
  T** vecs[N_SMEM_VEC] = {&L.dx,   &L.z5,   &L.z6,   &L.lb,  &L.ub,  &L.q,
                          &L.dbox, &L.rdx,  &L.rhs,  &L.ddxa, &L.dz5a,
                          &L.dz6a, &L.ddx,  &L.dz5,  &L.dz6, &L.tmp,
                          &L.tmp2};
  for (int k = 0; k < N_SMEM_VEC; ++k) *vecs[k] = v + (long)k * n;
  L.red = v + (long)N_SMEM_VEC * n;
  L.PD = (const T*)a.PD + (long)lane * nb * BB;
  L.PO = (const T*)a.PO + (long)lane * (nb - 1) * BB;
  L.RD = (const T*)a.RD + (long)lane * nb * BB;
  L.RO = (const T*)a.RO + (long)lane * (nb - 1) * BB;
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
  T* scr = (T*)a.scr + (long)lane * N_SCR_VEC * (a.mh + a.ma);
  const void* src[2][6] = {{a.Sh, a.Rh, a.eh, a.wh, a.ehr, a.whr},
                           {a.Sa, a.Ra, a.ea, a.wa, a.ear, a.war}};
  const int* tabs[2][3] = {{a.rowGh, a.gtabh, a.Gh}, {a.rowGa, a.gtaba, a.Ga}};
  for (int kind = 0; kind < 2; ++kind) {
    Rows<T>& K = kind ? L.A : L.H;
    const int m = kind ? a.ma : a.mh;
    const long ml = (long)lane * m, mw = ml * 2 * BS;
    K.m = m;
    K.ngr = kind ? a.ngr_a : a.ngr_h;
    K.S = (const T*)src[kind][0] + mw;
    K.R = (const T*)src[kind][1] + mw;
    K.e = (const T*)src[kind][2] + ml;
    K.w = (const T*)src[kind][3] + ml;
    K.er = (const T*)src[kind][4] + ml;
    K.wr = (const T*)src[kind][5] + ml;
    K.rowG = tabs[kind][0];
    K.gtab = tabs[kind][1];
    K.G = tabs[kind][2];
    for (int k = 0; k < N_SCR_VEC; ++k) K.s[k] = scr + (long)k * m;
    scr += (long)N_SCR_VEC * m;
  }
  L.h = (T*)a.h + (long)lane * a.mh;
  L.z1 = (T*)a.z1 + (long)lane * a.mh;
  L.p = (T*)a.p + (long)lane * a.ma;
  L.nn = (T*)a.nn + (long)lane * a.ma;
  L.y = (T*)a.y + (long)lane * a.ma;
  L.run(a.it + lane, a.status + lane, (T*)a.rp + lane, (T*)a.rd + lane,
        (T*)a.fb + lane);
}

}  // namespace ipm
