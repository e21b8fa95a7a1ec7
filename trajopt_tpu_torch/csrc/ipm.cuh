// K6 ipm_banded's per-lane body: the banded interior-point QP solver's
// whole Mehrotra predictor-corrector loop for ONE lane, from the initial
// interior point to termination.  The loop (Loop) is shared with K11
// ipm_dense (ipm_dense.cuh), which supplies its own rows, P and factor;
// K6's are Lane's.
//
// Replaces trajopt_tpu/ops/ipm_qp.py:92 solve_ipm_qp's banded loop (body
// :373-511, cond :513-514, while_loop :516-520, make_kkt_solve :321-371);
// its plain PyTorch counterpart is ops/ipm_qp.py's _loop_plain.  Per
// iteration, in the plain loop's order: the barrier diagonals; the block
// assembly of K = P + Jh' Dh Jh + Ja' Da Ja + Dbox (K1's sums, over each
// block's cover list) and the relative regularization; the block Cholesky
// (K2's steps in banded.cuh's block-inverse form, banded::btd_factor_warp,
// each pivot block's Cholesky factor inverted beside it) and, beside it,
// the residuals, mu and the predictor's right-hand side, then the
// couplings W_t, V_t (btd_couple_team); the predictor and corrector Newton
// solves (K3's steps as recurrences over those inverses, btd_solve_team),
// each with one refinement step against the exact condensed matrix; the
// step lengths and sigma; the NaN-guarded update; best-iterate tracking
// by the exact composite objective; the unscaled termination test.  A
// lane leaves its loop when its status is
// set or it reaches max_iter, so a stopped lane never changes again.  The
// set-up (pinned-coordinate elimination, column and row scaling, the cost
// scale c, P's blocks, f(0)) and the teardown run in PyTorch in the
// wrapper (ops/ipm_qp.py).
//
// Team: every phase is a strided loop over a thread team (`tid` of
// `nthr`): rows i = tid, tid + nthr, ... of each row kind, columns
// likewise, so a row or column always has the same owner and no two
// members write one entry.  TEAM_SYNC separates phases that read what
// another member wrote.  The factor and the solves run on the first WT
// members (one warp on the card), the residuals beside the factor on the
// others (side_sync their barrier); the couplings and the solves' passes
// on the whole team, the solves' sweeps on the first WT members.  On the
// card the team is the CTA (ipm_launch.cuh); in the host build
// (ipm_host.cpp) it is one thread and TEAM_SYNC is empty.
//
// Sums: every sum runs in a fixed order (a row's window in column order,
// Jh' w by column over the windows that cover its block in row-group then
// window order, reductions in a fixed tree), no atomics; min, max and
// clamp propagate NaN as torch does.  Divisions and square roots are
// qm::qdiv / qm::qsqrt (correctly rounded, as the operators).
//
// Cover lists (ops.ipm_qp.band_plan): for each column block t, the windows
// that cover it, as (first row, rows, half) in row-group then window order
// (half 0: the window starts at t; half 1: at t - 1).  Block t's column
// sums and D[t] visit only those windows, and O[t] their half-0 entries.
//
// Memory per lane: D (lower triangle; the factor's block inverses), O (M,
// then W), V, the solves' scratch n-vector and the n-vectors in shared
// memory; the lane's scaled rows and its scratch m-vectors (12 per row
// kind) in shared memory where the launcher's budget
// holds them (Args::smem_rows, smem_scr; smem_layout), else in device
// memory; the raw rows, the per-row inputs and the m-vector state in
// device memory.
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

using qm::qdiv;

enum { QP_UNSOLVED = 0, QP_SOLVED = 1, QP_SOLVED_INACCURATE = 2,
       QP_MAX_ITER = 3 };
constexpr int N_SMEM_VEC = 17;  // n-vectors in shared memory
constexpr int N_SCR_VEC = 12;   // m-vectors per row kind in the scratch
constexpr int N_RED = 14;       // values of the widest team reduction

// The launch arguments (ctypes mirror: ops.ipm_qp._K6Args).  Per-lane
// arrays are lane-major and contiguous; the int tables are shared.
struct Args {
  int lanes, n, b, nb, mh, ma, max_iter;
  // where the scaled rows and the scratch live: 1 shared memory, 0 device
  // memory (the card's launcher sets both from its budget and writes its
  // choice back; the host build takes them as given)
  int smem_rows, smem_scr;
  double eps_abs, eps_rel;
  // P blocks: scaled and masked (PD, PO) and raw (RD, RO); q scaled and
  // raw; the IPM's bounds (pinned coordinates at -1, 1) and the raw ones;
  // cf (lanes, 2): c, f(0)
  const void *PD, *PO, *RD, *RO, *q, *qr, *lb, *ub, *lbr, *ubr, *cf;
  // per row kind: rows (m, 2b) scaled S and raw R, scaled e and w, raw
  // e and w; rowG (m) window start block of each row; cov the cover lists:
  // offsets (nb + 1), then (first row, rows, half) per entry
  const void *Sh, *Rh, *eh, *wh, *ehr, *whr;
  const void *Sa, *Ra, *ea, *wa, *ear, *war;
  const int *rowGh, *covh, *rowGa, *cova;
  // outputs: the final iterate, the incumbent, per-lane scalars; scratch
  void *dx, *z5, *z6, *dxb, *h, *z1, *p, *nn, *y, *rp, *rd, *fb, *scr;
  int *it, *status;
  // the phase timer (card only; null: off): N_PHASES + 1 per lane, each
  // phase's clock64 cycles on thread 0 summed over the lane's iterations,
  // then the count of factors that took their fallback
  long long* clk;
};

// the timer's phases, in the loop's order
enum { PH_DIAG, PH_ASSEMBLY, PH_FACTOR, PH_RESID, PH_PRED_PASS,
       PH_PRED_SOLVE, PH_CORR_PASS, PH_CORR_SOLVE, PH_UPDATE, PH_OBJECTIVE,
       N_PHASES };

// A lane's shared memory, in elements of T: D, O, V, the solves' scratch
// n-vector w, the n-vectors, the reduction buffer, two scalars (the
// factor's fallback flag, mu); then, as planned, the scaled rows (hinge,
// abs) and the scratch.  (ops.ipm_qp.k6_smem_plan mirrors it.)
struct Layout {
  long o_O, o_V, o_w, o_v, o_red, o_sc, o_Sh, o_Sa, o_scr, total;
};

BHD Layout smem_layout(int n, int b, int nb, int mh, int ma, bool rows,
                       bool scr) {
  Layout L;
  L.o_O = (long)nb * b * b;
  L.o_V = L.o_O + (long)(nb - 1) * b * b;
  L.o_w = L.o_V + (long)(nb - 1) * b * b;
  L.o_v = L.o_w + (long)nb * b;
  L.o_red = L.o_v + (long)N_SMEM_VEC * n;
  L.o_sc = L.o_red + N_RED * 32;
  L.o_Sh = L.o_sc + 2;
  L.o_Sa = L.o_Sh + (rows ? (long)mh * 2 * b : 0);
  L.o_scr = L.o_Sa + (rows ? (long)ma * 2 * b : 0);
  L.total = L.o_scr + (scr ? (long)N_SCR_VEC * (mh + ma) : 0);
  return L;
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
#pragma unroll
    for (int k = 0; k < KS; ++k) red[k * 32 + warp] = sums[k];
#pragma unroll
    for (int k = 0; k < KM; ++k) red[(KS + k) * 32 + warp] = maxs[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    T a = red[k * 32];
    for (int w = 1; w < nw; ++w) a += red[k * 32 + w];
    sums[k] = a;
  }
#pragma unroll
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

// One row kind (hinge or abs) of one lane: its rows, inputs, tables and
// scratch, each scratch vector by name (the predictor's steps at [0], the
// corrector's at [1]).
template <typename T>
struct Rows {
  int m;
  const T *S, *R, *e, *w, *er, *wr;
  const int *rowG, *cov;
  // hinge: s1, z2, den, dhd, bh, jvh; abs: z3, z4, da, ba, re, jva
  T *v0, *v1, *v2, *v3, *v4, *v5;
  // hinge: dz1, dh, ds1; abs: dy, dp, dnn
  T *d0[2], *d1[2], *d2[2];
};

// Column (t, i) of A' (u * w) (u may be null): the windows that cover
// block t, their r rows summed first, in row order.
template <typename T>
BHD T rmv_col(const Rows<T>& K, const T* w, const T* u, int b, int nb, int t,
              int i) {
  T acc = T(0);
  const int ww = 2 * b;
  const int* ent = K.cov + nb + 1;
  for (int e = K.cov[t]; e < K.cov[t + 1]; ++e) {
    const int r0 = ent[3 * e], r = ent[3 * e + 1], half = ent[3 * e + 2];
    const T* B = K.S + (long)r0 * ww + half * b + i;
    const T* wk = w + r0;
    T s = T(0);
    if (u) {
      const T* uk = u + r0;
#pragma unroll 4
      for (int k = 0; k < r; ++k) s += B[(long)k * ww] * (uk[k] * wk[k]);
    } else {
#pragma unroll 4
      for (int k = 0; k < r; ++k) s += B[(long)k * ww] * wk[k];
    }
    acc += s;
  }
  return acc;
}

// Row i of block t of D (isD) or O of A' diag(d) A, added to acc[j]: the
// windows that cover block t (O: those that start at t), each window's r
// rows summed first, in row order (K1's bb_quad_entry over every group,
// for the b entries of the row at once: each row of a window is read once
// for them).  A row of D is formed whole; the caller keeps its lower part.
template <typename T, int BS>
BHD void quad_row(const Rows<T>& K, const T* d, int nb, bool isD, int t,
                  int i, T (&acc)[BS]) {
  constexpr int w = 2 * BS;
  const int* ent = K.cov + nb + 1;
  for (int e = K.cov[t]; e < K.cov[t + 1]; ++e) {
    const int r0 = ent[3 * e], r = ent[3 * e + 1], half = ent[3 * e + 2];
    if (!isD && half != 0) continue;
    const int wi = (isD ? half * BS : BS) + i, w0 = isD ? half * BS : 0;
    const T* Bg = K.S + (long)r0 * w;
    const T* dg = d + r0;
    T s[BS];
#pragma unroll
    for (int j = 0; j < BS; ++j) s[j] = T(0);
#pragma unroll 2
    for (int k = 0; k < r; ++k) {
      const T* row = Bg + k * w;
      const T a = row[wi] * dg[k];
#pragma unroll
      for (int j = 0; j < BS; ++j) s[j] += a * row[w0 + j];
    }
#pragma unroll
    for (int j = 0; j < BS; ++j) acc[j] += s[j];
  }
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

// K2 / K3's block-inverse form on the team (banded.cuh): after the factor
// (Li the blocks' inverses in D, M in O), the couplings V_t, then W_t in
// place of M_t; every member returns after the last barrier
template <typename T, int BS>
IHD void btd_couple_team(const T* Li, T* O, T* V, int nb, int tid, int nthr) {
  banded::btd_couple_v<T, BS>(Li, O, V, nb, tid, nthr);
  TEAM_SYNC();
  banded::btd_couple_w<T, BS>(Li, O, nb, tid, nthr);
  TEAM_SYNC();
}

// K x = r from the factor and its couplings (W in O): the team's passes
// c = Linv r and d = Linv^T y into the scratch n-vector w, the first WT
// members' sweeps y_t = c_t - W_t y_{t-1} and x_t = d_t - V_t x_{t+1};
// x may not be r; every member returns after the last barrier
template <typename T, int BS, int WT>
IHD void btd_solve_team(const T* Li, const T* W, const T* V, T* w,
                        const T* r, T* x, int nb, int tid, int nthr) {
  banded::btd_apply_inv<T, BS, false>(Li, r, w, nb, tid, nthr);
  TEAM_SYNC();
  if (tid < WT) banded::btd_sweep<T, BS, WT, true>(W, w, x, nb, tid);
  TEAM_SYNC();
  banded::btd_apply_inv<T, BS, true>(Li, x, w, nb, tid, nthr);
  TEAM_SYNC();
  if (tid < WT) banded::btd_sweep<T, BS, WT, false>(V, w, x, nb, tid);
  TEAM_SYNC();
}

// The loop of one lane, shared by K6 (banded rows: Lane below) and K11
// ipm_dense (dense rows: ipm_dense.cuh).  LaneT, the derived lane (CRTP),
// supplies the rows' and P's products: hdot / adot (a row of Jh / Ja times
// v), hraw / araw (a raw row times v), hcol / acol (column k of A'(u * w),
// u may be null), pmv / rpmv (row k of P v, scaled / raw); the condensed
// matrix and its factor: assemble() (K + reg I), team_factor() (true
// where the whole team factors it: factor_team(); else the first WT
// members: factor_warp(false), false where a fast path did not hold, then
// factor_warp(true) with the exact operators; then the whole team:
// couple()); and solve(r, x) (K x = r by every member, each returning
// after the last barrier).
template <typename T, int WT, bool TIMED, typename LaneT>
struct Loop {
  int tid, nthr, n, max_iter;
  T eps_abs, eps_rel, c, fzero;
  // shared memory
  T* red;
  T* sc;  // [0] the factor's fast paths did not hold, [1] mu
  T *dx, *z5, *z6, *lb, *ub, *q, *dbox, *rdx, *rhs, *ddxa, *dz5a, *dz6a,
      *ddx, *dz5, *dz6, *tmp, *tmp2;
  // device memory
  const T *qr, *lbr, *ubr, *glb, *gub, *gq;
  T *odx, *oz5, *oz6, *dxb;
  Rows<T> H, A;
  T *h, *z1, *p, *nn, *y;
  long long* clk;  // this lane's timer sums and fallbacks (TIMED)
  long long t_last;

  static BHD T tiny() { return sizeof(T) == 8 ? T(1e-30) : T(1e-25); }
  static BHD T dcap() { return sizeof(T) == 8 ? T(1e14) : T(1e10); }
  static BHD T chol_tiny() { return sizeof(T) == 8 ? T(1e-30) : T(1e-18); }

  BHD LaneT& self() { return *static_cast<LaneT*>(this); }

  // the step-length candidate of (v, dv), folded into the running -min
  static BHD void step_cand(T& negmin, T v, T dv) {
    if (dv < T(0)) negmin = nmax(negmin, -qdiv(T(-0.99) * v, dv));
  }

  BHD void sync() const { TEAM_SYNC(); }

  // the timer: thread 0 adds the cycles since the last stamp to phase ph
  BHD void stamp(int ph) {
#ifdef __CUDA_ARCH__
    if (TIMED && tid == 0) {
      const long long t = clock64();
      clk[ph] += t - t_last;
      t_last = t;
    }
#else
    (void)ph;
#endif
  }

  // the timer's count of factors that took their fallback
  BHD void count_fallback() {
    if (TIMED && tid == 0) clk[N_PHASES] += 1;
  }

  // hinge scratch
  BHD T* s1() const { return H.v0; }
  BHD T* z2() const { return H.v1; }
  BHD T* den() const { return H.v2; }
  BHD T* dhd() const { return H.v3; }
  BHD T* bh() const { return H.v4; }
  BHD T* jvh() const { return H.v5; }
  // abs scratch
  BHD T* z3() const { return A.v0; }
  BHD T* z4() const { return A.v1; }
  BHD T* da() const { return A.v2; }
  BHD T* ba() const { return A.v3; }
  BHD T* re() const { return A.v4; }
  BHD T* jva() const { return A.v5; }

  // the complementarity right-hand sides of the predictor (CORR false)
  // and of the corrector (Mehrotra's second-order terms from the
  // predictor's step: [0] of the step vectors, ddxa, dz5a, dz6a)
  template <bool CORR>
  BHD T rc1(int i, T smu) const {
    return CORR ? (smu - z1[i] * s1()[i]) - H.d0[0][i] * H.d2[0][i]
                : -z1[i] * s1()[i];
  }
  template <bool CORR>
  BHD T rc2(int i, T smu) const {
    return CORR ? (smu - z2()[i] * h[i]) - (-H.d0[0][i]) * H.d1[0][i]
                : -z2()[i] * h[i];
  }
  template <bool CORR>
  BHD T rc3(int i, T smu) const {
    return CORR ? (smu - z3()[i] * p[i]) - (-A.d0[0][i]) * A.d1[0][i]
                : -z3()[i] * p[i];
  }
  template <bool CORR>
  BHD T rc4(int i, T smu) const {
    return CORR ? (smu - z4()[i] * nn[i]) - A.d0[0][i] * A.d2[0][i]
                : -z4()[i] * nn[i];
  }
  template <bool CORR>
  BHD T rc5(int k, T smu) const {
    return CORR ? (smu - z5[k] * (dx[k] - lb[k])) - dz5a[k] * ddxa[k]
                : -z5[k] * (dx[k] - lb[k]);
  }
  template <bool CORR>
  BHD T rc6(int k, T smu) const {
    return CORR ? (smu - z6[k] * (ub[k] - dx[k])) - dz6a[k] * (-ddxa[k])
                : -z6[k] * (ub[k] - dx[k]);
  }

  // the barrier of the members past the first warp (the side of
  // factor_beside; the host's one thread: none)
  BHD void side_sync() const {
#ifdef __CUDA_ARCH__
    asm volatile("bar.sync 1, %0;" ::"r"(nthr - WT) : "memory");
#endif
  }

  // The residuals rdx, re and mu's six sums, on the side: the members past
  // the first warp, which play the first warp's share too (warp 1 sums
  // its rows and warp 0's), so each member's sums and the reduction tree
  // are team_reduce's over the whole team; every side member gets mu.
  IHD T residuals_side() {
    LaneT& L = self();
    const bool two = nthr > 1 && (tid >> 5) == 1;
    T su[2][6] = {};
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      if (g == 1 && !two) continue;
      const int v = g == 0 ? tid : tid - 32;
      for (int i = v; i < H.m; i += nthr) {
        su[g][0] += z1[i] * s1()[i];
        su[g][1] += z2()[i] * h[i];
      }
      for (int i = v; i < A.m; i += nthr) {
        re()[i] = ((L.adot(i, dx) - p[i]) + nn[i]) + A.e[i];
        su[g][2] += z3()[i] * p[i];
        su[g][3] += z4()[i] * nn[i];
      }
      for (int k = v; k < n; k += nthr) {
        rdx[k] = ((((L.pmv(dx, k) + q[k]) + L.hcol(z1, (const T*)nullptr, k)) +
                   L.acol(y, (const T*)nullptr, k)) -
                  z5[k]) +
                 z6[k];
        su[g][4] += z5[k] * (dx[k] - lb[k]);
        su[g][5] += z6[k] * (ub[k] - dx[k]);
      }
    }
#ifdef __CUDA_ARCH__
    const int lane = tid & 31, warp = tid >> 5, nw = nthr >> 5;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      if (g == 1 && !two) continue;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int k = 0; k < 6; ++k)
          su[g][k] += __shfl_down_sync(0xffffffffu, su[g][k], o);
      if (lane == 0)
#pragma unroll
        for (int k = 0; k < 6; ++k) red[k * 32 + (g == 0 ? warp : 0)] = su[g][k];
    }
    side_sync();
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      T a = red[k * 32];
      for (int w = 1; w < nw; ++w) a += red[k * 32 + w];
      su[0][k] = a;
    }
#endif
    return mu_of(su[0], n_pairs());
  }

  // the assembly, then its factor: on the first warp (K6, and K11's block
  // route: K2's steps, their fast paths) and beside it, on the other
  // members, the residuals, mu and the predictor's right-hand side (they
  // read neither the factor nor K); where a fast path did not hold, the
  // assembly again and the exact factor; then the couplings on the whole
  // team.  Where the whole team factors (K11's dense route), the
  // residuals follow it on the same members.
  // Returns mu.
  IHD T factor_beside() {
    LaneT& L = self();
    L.assemble();
    stamp(PH_ASSEMBLY);
    const bool team = L.team_factor();
    if (team) {
      L.factor_team();
    } else if (tid < WT) {
      const bool ok = L.factor_warp(false);
      if (tid == 0) sc[0] = ok ? T(0) : T(1);
    }
    if (tid >= WT || nthr == 1) {
      const T mu = residuals_side();
      if (tid == (nthr > 1 ? WT : 0)) sc[1] = mu;
      newton_rhs<false, true>(T(0));
    }
    sync();
    if (!team && sc[0] != T(0)) {
      count_fallback();
      L.assemble();
      if (tid < WT) L.factor_warp(true);
      sync();
    }
    if (!team) L.couple();
    stamp(PH_FACTOR);
    return sc[1];
  }

  // The right-hand side of the condensed system for the predictor (CORR
  // false) or the corrector, into rhs: by the whole team, or (SIDE) by
  // the members past the first warp
  template <bool CORR, bool SIDE>
  IHD void newton_rhs(T smu) {
    LaneT& L = self();
    const int first = SIDE && nthr > 1 ? tid - WT : tid;
    const int step = SIDE && nthr > 1 ? nthr - WT : nthr;
    for (int i = first; i < H.m; i += step)
      bh()[i] = qdiv(rc1<CORR>(i, smu) * z2()[i] - z1[i] * rc2<CORR>(i, smu),
                     den()[i]);
    for (int i = first; i < A.m; i += step)
      ba()[i] = (-re()[i] + qdiv(rc3<CORR>(i, smu), z3()[i])) -
                qdiv(rc4<CORR>(i, smu), z4()[i]);
    if (SIDE)
      side_sync();
    else
      sync();
    for (int k = first; k < n; k += step) {
      rhs[k] = ((-rdx[k] - L.hcol(bh(), (const T*)nullptr, k)) +
                L.acol(ba(), da(), k) +
                qdiv(rc5<CORR>(k, smu), dx[k] - lb[k])) -
               qdiv(rc6<CORR>(k, smu), ub[k] - dx[k]);
    }
  }

  // One Newton solve of the condensed system for the predictor (CORR
  // false; its right-hand side formed beside the factor) or the corrector;
  // the step goes to (sdx, sz5, sz6) and the row kinds' step vectors
  // [CORR].  Returns the step length.
  template <bool CORR>
  IHD T newton(T smu, T* sdx, T* sz5, T* sz6) {
    LaneT& L = self();
    constexpr int ph_pass = CORR ? PH_CORR_PASS : PH_PRED_PASS;
    constexpr int ph_solve = CORR ? PH_CORR_SOLVE : PH_PRED_SOLVE;
    T* dz1 = H.d0[CORR];
    T* dh = H.d1[CORR];
    T* ds1 = H.d2[CORR];
    T* dy = A.d0[CORR];
    T* dp = A.d1[CORR];
    T* dnn = A.d2[CORR];
    if (CORR) {
      newton_rhs<true, false>(smu);
      sync();
      stamp(ph_pass);
    }
    L.solve(rhs, sdx);
    stamp(ph_solve);
    // one refinement step against the exact condensed matrix
    for (int i = tid; i < H.m; i += nthr) jvh()[i] = L.hdot(i, sdx);
    for (int i = tid; i < A.m; i += nthr) jva()[i] = L.adot(i, sdx);
    sync();
    for (int k = tid; k < n; k += nthr) {
      const T kmv = ((L.pmv(sdx, k) + L.hcol(jvh(), dhd(), k)) +
                     L.acol(jva(), da(), k)) +
                    dbox[k] * sdx[k];
      tmp[k] = rhs[k] - kmv;
    }
    sync();
    stamp(ph_pass);
    L.solve(tmp, tmp2);
    stamp(ph_solve);
    for (int k = tid; k < n; k += nthr) sdx[k] = sdx[k] + tmp2[k];
    sync();
    // the slack and dual steps, and the step length
    T am[1] = {T(-1)};  // -min(1, candidates)
    for (int i = tid; i < H.m; i += nthr) {
      const T jv = L.hdot(i, sdx);
      dz1[i] = dhd()[i] * jv + bh()[i];
      dh[i] = qdiv(rc2<CORR>(i, smu) + h[i] * dz1[i], z2()[i]);
      ds1[i] = dh[i] - jv;
      step_cand(am[0], s1()[i], ds1[i]);
      step_cand(am[0], h[i], dh[i]);
      step_cand(am[0], z1[i], dz1[i]);
      step_cand(am[0], z2()[i], -dz1[i]);
    }
    for (int i = tid; i < A.m; i += nthr) {
      const T jv = L.adot(i, sdx);
      dy[i] = da()[i] * (jv - ba()[i]);
      dp[i] = qdiv(rc3<CORR>(i, smu) + p[i] * dy[i], z3()[i]);
      dnn[i] = qdiv(rc4<CORR>(i, smu) - nn[i] * dy[i], z4()[i]);
      step_cand(am[0], p[i], dp[i]);
      step_cand(am[0], nn[i], dnn[i]);
      step_cand(am[0], z3()[i], -dy[i]);
      step_cand(am[0], z4()[i], dy[i]);
    }
    for (int k = tid; k < n; k += nthr) {
      sz5[k] = qdiv(rc5<CORR>(k, smu) - z5[k] * sdx[k], dx[k] - lb[k]);
      sz6[k] = qdiv(rc6<CORR>(k, smu) + z6[k] * sdx[k], ub[k] - dx[k]);
      step_cand(am[0], dx[k] - lb[k], sdx[k]);
      step_cand(am[0], ub[k] - dx[k], -sdx[k]);
      step_cand(am[0], z5[k], sz5[k]);
      step_cand(am[0], z6[k], sz6[k]);
    }
    team_reduce<T, 0, 1>(red, nullptr, am, tid, nthr);
    stamp(ph_pass);
    return -am[0];
  }

  BHD T n_pairs() const { return T(2 * H.m + 2 * A.m + 2 * n); }

  static BHD T mu_of(const T* s, T n_pairs) {
    return qdiv(((((s[0] + s[1]) + (s[2] + s[3])) + s[4]) + s[5]), n_pairs);
  }

  // the whole loop; returns the final (it, status, rp, rd, f_best)
  IHD void run(int* it_out, int* st_out, T* rp_out, T* rd_out, T* fb_out) {
    LaneT& L = self();
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
      h[i] = clamp_lo(L.hdot(i, dx) + H.e[i], T(0)) + T(1);
      z1[i] = T(0.5) * H.w[i];
    }
    for (int i = tid; i < A.m; i += nthr) {
      const T r0 = L.adot(i, dx) + A.e[i];
      p[i] = clamp_lo(r0, T(0)) + T(1);
      nn[i] = p[i] - r0;
      y[i] = T(0);
    }
    sync();
    int it = 0, status = QP_UNSOLVED;
    T rp = inf, rd = inf, fbest = fzero;
#ifdef __CUDA_ARCH__
    if (TIMED) t_last = clock64();
#endif
    while (status == QP_UNSOLVED && it < max_iter) {
      // ---- barrier diagonals ----
      for (int i = tid; i < H.m; i += nthr) {
        s1()[i] = h[i] - (L.hdot(i, dx) + H.e[i]);
        z2()[i] = H.w[i] - z1[i];
        den()[i] = clamp_lo(h[i] * z1[i] + s1()[i] * z2()[i], tiny());
        dhd()[i] = clamp_hi(qdiv(z1[i] * z2()[i], den()[i]), dcap());
      }
      for (int i = tid; i < A.m; i += nthr) {
        z3()[i] = A.w[i] - y[i];
        z4()[i] = A.w[i] + y[i];
        da()[i] = clamp_hi(
            qdiv(T(1), clamp_lo(qdiv(p[i], z3()[i]) + qdiv(nn[i], z4()[i]),
                                tiny())),
            dcap());
      }
      for (int k = tid; k < n; k += nthr)
        dbox[k] = clamp_hi(
            qdiv(z5[k], dx[k] - lb[k]) + qdiv(z6[k], ub[k] - dx[k]), dcap());
      sync();
      stamp(PH_DIAG);
      // ---- the factor, and beside it the residuals and mu ----
      const T mu = factor_beside();
      stamp(PH_RESID);

      // ---- predictor ----
      const T a_aff = newton<false>(T(0), ddxa, dz5a, dz6a);
      T su[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      for (int i = tid; i < H.m; i += nthr) {
        const T z1a = z1[i] + a_aff * H.d0[0][i];
        su[0] += z1a * (s1()[i] + a_aff * H.d2[0][i]);
        su[1] += (H.w[i] - z1a) * (h[i] + a_aff * H.d1[0][i]);
      }
      for (int i = tid; i < A.m; i += nthr) {
        const T ya = y[i] + a_aff * A.d0[0][i];
        su[2] += (A.w[i] - ya) * (p[i] + a_aff * A.d1[0][i]);
        su[3] += (A.w[i] + ya) * (nn[i] + a_aff * A.d2[0][i]);
      }
      for (int k = tid; k < n; k += nthr) {
        const T dxa = dx[k] + a_aff * ddxa[k];
        su[4] += (z5[k] + a_aff * dz5a[k]) * (dxa - lb[k]);
        su[5] += (z6[k] + a_aff * dz6a[k]) * (ub[k] - dxa);
      }
      team_reduce<T, 6, 0>(red, su, nullptr, tid, nthr);
      stamp(PH_PRED_PASS);
      const T mu_aff = mu_of(su, n_pairs());
      const T ratio = qdiv(mu_aff, clamp_lo(mu, tiny()));
      const T sigma = clamp_hi(clamp_lo(ratio * ratio * ratio, T(1e-8)), T(1));

      // ---- corrector ----
      const T a = newton<true>(sigma * mu, ddx, dz5, dz6);
      T* dz1 = H.d0[1];
      T* dh = H.d1[1];
      T* dy = A.d0[1];
      T* dp = A.d1[1];
      T* dnn = A.d2[1];

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
      stamp(PH_UPDATE);

      // ---- composite objective, residuals, mu, scales: one pass ----
      // sums: mu's six dots, d'P d, q'd, the hinge and abs terms;
      // maxima: |re|, p_scale, |rdx|, d_scale
      T sm[10] = {T(0), T(0), T(0), T(0), T(0),
                  T(0), T(0), T(0), T(0), T(0)};
      T mx[4] = {T(0), T(0), T(0), T(0)};
      for (int i = tid; i < H.m; i += nthr) {
        const T s1n = h[i] - (L.hdot(i, dx) + H.e[i]);
        sm[0] += z1[i] * s1n;
        sm[1] += (H.w[i] - z1[i]) * h[i];
        const T g = H.er[i] + L.hraw(i, tmp);
        sm[8] += H.wr[i] * clamp_lo(g, T(0));
      }
      for (int i = tid; i < A.m; i += nthr) {
        const T jv = L.adot(i, dx);
        const T r = ((jv - p[i]) + nn[i]) + A.e[i];
        mx[0] = nmax(mx[0], aabs(r));
        mx[1] = nmax(mx[1], nmax(aabs(jv), aabs(A.e[i])));
        sm[2] += (A.w[i] - y[i]) * p[i];
        sm[3] += (A.w[i] + y[i]) * nn[i];
        const T g = A.er[i] + L.araw(i, tmp);
        sm[9] += A.wr[i] * aabs(g);
      }
      for (int k = tid; k < n; k += nthr) {
        const T pdx = L.pmv(dx, k);
        const T jh = L.hcol(z1, (const T*)nullptr, k);
        const T ja = L.acol(y, (const T*)nullptr, k);
        const T r = ((((pdx + q[k]) + jh) + ja) - z5[k]) + z6[k];
        mx[2] = nmax(mx[2], aabs(r));
        mx[3] = nmax(nmax(mx[3], nmax(aabs(pdx), aabs(q[k]))),
                     nmax(aabs(jh), aabs(ja)));
        sm[4] += z5[k] * (dx[k] - lb[k]);
        sm[5] += z6[k] * (ub[k] - dx[k]);
        sm[6] += tmp[k] * L.rpmv(tmp, k);
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
      const T mu1 = mu_of(sm, n_pairs());
      const T rp_u = mx[0];
      const T rd_u = qdiv(mx[2], c);
      const T gap_u = qdiv(n_pairs() * mu1, c);
      const T d_scale = qdiv(mx[3], c);
      const T f_scale = nmax(aabs(f1), aabs(fzero)) + T(1);
      const T eps_p = eps_abs + eps_rel * mx[1];
      const T eps_d = eps_abs + eps_rel * d_scale;
      const T eps_g = eps_abs * f_scale;
      rp = qdiv(rp_u, eps_p);
      rd = nmax(qdiv(rd_u, eps_d), qdiv(gap_u, eps_g));
      const bool conv = fin && rp <= T(1) && rd <= T(1);
      const int broke = fbest < fzero ? QP_SOLVED_INACCURATE : QP_MAX_ITER;
      status = conv ? QP_SOLVED : (fin ? status : broke);
      it += 1;
      sync();
      stamp(PH_OBJECTIVE);
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

// K6's lane: banded rows (windows over two column blocks of b, their
// cover lists) and a block-tridiagonal P, K's band assembled over the
// cover lists and factored by K2's steps on the first warp.
template <typename T, int BS, int WT, bool TIMED>
struct Lane : Loop<T, WT, TIMED, Lane<T, BS, WT, TIMED>> {
  using B = Loop<T, WT, TIMED, Lane<T, BS, WT, TIMED>>;
  using B::A;
  using B::chol_tiny;
  using B::da;
  using B::dbox;
  using B::dhd;
  using B::H;
  using B::nthr;
  using B::red;
  using B::sync;
  using B::tid;
  int nb;
  // shared memory: the factor's block inverses, M (then W), V; the solves'
  // scratch n-vector
  T *D, *O, *V, *w;
  // device memory
  const T *PD, *PO, *RD, *RO;

  BHD T hdot(int i, const T* v) const {
    return rowdot(H.S + (long)i * 2 * BS, v + H.rowG[i] * BS, 2 * BS);
  }
  BHD T adot(int i, const T* v) const {
    return rowdot(A.S + (long)i * 2 * BS, v + A.rowG[i] * BS, 2 * BS);
  }
  BHD T hraw(int i, const T* v) const {
    return rowdot(H.R + (long)i * 2 * BS, v + H.rowG[i] * BS, 2 * BS);
  }
  BHD T araw(int i, const T* v) const {
    return rowdot(A.R + (long)i * 2 * BS, v + A.rowG[i] * BS, 2 * BS);
  }
  BHD T hcol(const T* w, const T* u, int k) const {
    return rmv_col(H, w, u, BS, nb, k / BS, k % BS);
  }
  BHD T acol(const T* w, const T* u, int k) const {
    return rmv_col(A, w, u, BS, nb, k / BS, k % BS);
  }
  BHD T pmv(const T* v, int k) const {
    return ipm::pmv<T, BS>(PD, PO, v, nb, k / BS, k % BS);
  }
  BHD T rpmv(const T* v, int k) const {
    return ipm::pmv<T, BS>(RD, RO, v, nb, k / BS, k % BS);
  }

  IHD void solve(const T* r, T* x) const {
    btd_solve_team<T, BS, WT>(D, O, V, w, r, x, nb, tid, nthr);
  }

  // K = P + Jh' Dh Jh + Ja' Da Ja + Dbox + reg I into (D's lower triangle,
  // O), a block row per member in turn
  IHD void assemble() {
    constexpr int BB = BS * BS;
    const int nDr = nb * BS, nOr = (nb - 1) * BS;
    T dm[1] = {T(-INFINITY)};
    for (int e = tid; e < nDr + nOr; e += nthr) {
      const bool isD = e < nDr;
      const int ee = isD ? e : e - nDr;
      const int t = ee / BS, i = ee % BS;
      const long at = (long)t * BB + i * BS;
      T acc[BS];
#pragma unroll
      for (int j = 0; j < BS; ++j)
        acc[j] = isD ? PD[at + j] + (i == j ? dbox[t * BS + i] : T(0))
                     : PO[at + j];
      quad_row(H, dhd(), nb, isD, t, i, acc);
      quad_row(A, da(), nb, isD, t, i, acc);
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        if (!isD || j <= i) (isD ? D : O)[at + j] = acc[j];
        if (isD && j == i) dm[0] = nmax(dm[0], acc[j]);
      }
    }
    team_reduce<T, 0, 1>(red, nullptr, dm, tid, nthr);
    const T reg = sizeof(T) == 8 ? T(1e-12) * dm[0] + T(1e-11)
                                 : T(1e-7) * dm[0] + T(1e-8);
    for (int k = tid; k < nb * BS; k += nthr) {
      T* Dk = D + (long)(k / BS) * BB + (k % BS) * (BS + 1);
      *Dk = *Dk + reg;
    }
    sync();
  }

  // the factor on the first warp: btd_factor_warp's fast paths, or the
  // same with the exact operators; the couplings on the whole team
  static BHD bool team_factor() { return false; }
  BHD void factor_team() {}
  BHD bool factor_warp(bool exact) {
    return exact ? banded::btd_factor_warp<T, BS, WT, true>(D, O, nb,
                                                            chol_tiny(), tid)
                 : banded::btd_factor_warp<T, BS, WT, false>(D, O, nb,
                                                             chol_tiny(), tid);
  }
  IHD void couple() { btd_couple_team<T, BS>(D, O, V, nb, tid, nthr); }
};

// One row kind of lane `lane`: its slices of the arguments, its scaled
// rows at S (shared or device memory) and its scratch at scr (12 m).
template <typename T>
BHD Rows<T> lane_rows(int m, long lane, int b, const T* S, const void* R,
                      const void* e, const void* w, const void* er,
                      const void* wr, const int* rowG, const int* cov,
                      T* scr) {
  Rows<T> K;
  const long ml = lane * m;
  K.m = m;
  K.S = S;
  K.R = (const T*)R + ml * 2 * b;
  K.e = (const T*)e + ml;
  K.w = (const T*)w + ml;
  K.er = (const T*)er + ml;
  K.wr = (const T*)wr + ml;
  K.rowG = rowG;
  K.cov = cov;
  K.v0 = scr;
  K.v1 = scr + m;
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
// out by smem_layout) and the team (tid of nthr); then its whole loop.
template <typename T, int BS, int WT, bool TIMED>
IHD void ipm_lane(const Args& a, int lane, T* sm, int tid, int nthr) {
  Lane<T, BS, WT, TIMED> L;
  const int n = a.n, nb = a.nb, mh = a.mh, ma = a.ma, BB = BS * BS;
  const long nl = (long)lane * n;
  const Layout lay = smem_layout(n, BS, nb, mh, ma, a.smem_rows != 0,
                                 a.smem_scr != 0);
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
  L.O = sm + lay.o_O;
  L.V = sm + lay.o_V;
  L.w = sm + lay.o_w;
  T* v = sm + lay.o_v;
  L.dx = v;
  L.z5 = v + n;
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
  L.red = sm + lay.o_red;
  L.sc = sm + lay.o_sc;
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
  // the scaled rows: staged into shared memory by the team (made visible
  // by the barrier after the initial point's n-vectors), or read where
  // they lie
  const T* Sh = (const T*)a.Sh + (long)lane * mh * 2 * BS;
  const T* Sa = (const T*)a.Sa + (long)lane * ma * 2 * BS;
  if (a.smem_rows) {
    T* sh = sm + lay.o_Sh;
    T* sa = sm + lay.o_Sa;
    for (long k = tid; k < (long)mh * 2 * BS; k += nthr) sh[k] = Sh[k];
    for (long k = tid; k < (long)ma * 2 * BS; k += nthr) sa[k] = Sa[k];
    Sh = sh;
    Sa = sa;
  }
  T* scr = a.smem_scr ? sm + lay.o_scr
                      : (T*)a.scr + (long)lane * N_SCR_VEC * (mh + ma);
  L.H = lane_rows<T>(mh, lane, BS, Sh, a.Rh, a.eh, a.wh, a.ehr, a.whr,
                     a.rowGh, a.covh, scr);
  L.A = lane_rows<T>(ma, lane, BS, Sa, a.Ra, a.ea, a.wa, a.ear, a.war,
                     a.rowGa, a.cova, scr + (long)N_SCR_VEC * mh);
  L.h = (T*)a.h + (long)lane * mh;
  L.z1 = (T*)a.z1 + (long)lane * mh;
  L.p = (T*)a.p + (long)lane * ma;
  L.nn = (T*)a.nn + (long)lane * ma;
  L.y = (T*)a.y + (long)lane * ma;
  L.clk = TIMED ? a.clk + (long)lane * (N_PHASES + 1) : nullptr;
  L.t_last = 0;
  L.run(a.it + lane, a.status + lane, (T*)a.rp + lane, (T*)a.rd + lane,
        (T*)a.fb + lane);
}

}  // namespace ipm
