// Per-lane bodies of K1 bb_quad, K2 btd_factor and K3 btd_solve, shared by
// their own kernels (bb_quad.cu, btd_factor.cu, btd_solve.cu) and by K6
// ipm_banded (ipm.cuh), which runs them inside its per-lane IPM loop.
//
// Every function is __host__ __device__ (HD) and written for a TEAM of
// threads: member `tid` of `NT` takes rows tid, tid + NT, ... of a block.
// On the card the team is one warp (NT = 32, b <= BLOCK_MAX < 32, so a
// member owns one row) and WSYNC is __syncwarp(); in the host build
// (ipm_host.cpp)
// the team is one thread (NT = 1) that plays every row, and WSYNC is empty.
// The arithmetic, and the order of every sum, is the same in both.
//
// The block-tridiagonal layout of ops.btridiag: D (T, b, b) diagonal
// blocks, O (T-1, b, b) sub-diagonal blocks O[t] = K[t+1, t]; the factor
// is LD (T, b, b) lower with zeros above the diagonal, LM (T-1, b, b).
// Row groups are those of ops.banded_rows: B (n_g, r, 2b) windows over
// column blocks G[g] and G[g] + 1.
//
// K6 runs its factor and solves through the warp versions at the end of
// this file (btd_factor_warp, btd_solve_warp): the same arithmetic as K2's
// and K3's, with the rows in registers.
#pragma once

#include <math.h>

#include <type_traits>

#include "qmath.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define BHD __host__ __device__ __forceinline__
#else
#define BHD inline
#endif

#ifdef __CUDA_ARCH__
#define WSYNC() __syncwarp()
#else
#define WSYNC() ((void)0)
#endif

namespace banded {

// the largest block size K2, K3 and K6 are instantiated for (every b from 1
// up to it; a member of the card's warp owns one row of a block)
constexpr int BLOCK_MAX = 21;

// f(std::integral_constant<int, B>()) for the B in [LO, HI] that equals
// the run-time b (the launchers' dispatch to a template instantiation);
// -1 when b lies outside [LO, HI]
template <int LO, int HI, typename F>
inline int with_block(int b, const F& f) {
  if constexpr (LO > HI) {
    (void)b;
    (void)f;
    return -1;
  } else {
    if (b == LO) return f(std::integral_constant<int, LO>());
    return with_block<LO + 1, HI>(b, f);
  }
}

template <typename T>
BHD T bsqrt(T v);
template <>
BHD float bsqrt<float>(float v) { return sqrtf(v); }
template <>
BHD double bsqrt<double>(double v) { return sqrt(v); }

// v of team member `src`, to every member (a warp shuffle on the card)
template <int NT, typename T>
BHD T team_bcast(T v, int src) {
#ifdef __CUDA_ARCH__
  if (NT > 1) return __shfl_sync(0xffffffffu, v, src);
#endif
  (void)src;
  return v;
}

// ------------------------------------------------------------------ K1

// Entry (t, i, j) of the D (isD) or O blocks of A' diag(d) A, added to
// acc, for ONE row group: every window group g whose window covers it
// contributes the sum over its r rows (taken first, in row order).  A
// group with window start G touches D[G] (window block 0), D[G+1]
// (window block 1) and O[G].  K1 runs it once per (entry, group); K6 once
// per (entry, group) over the hinge groups, then the abs groups.
template <typename T>
BHD T bb_quad_entry(const T* B, const int* G, const T* d, int ng, int r,
                    int b, bool isD, int t, int i, int j, T acc) {
  const int w = 2 * b;
  for (int g = 0; g < ng; ++g) {
    const int Gg = G[g];
    int wi, wj;
    if (isD) {
      if (Gg == t) {
        wi = i;
        wj = j;
      } else if (Gg + 1 == t) {
        wi = b + i;
        wj = b + j;
      } else {
        continue;
      }
    } else {
      if (Gg != t) continue;
      wi = b + i;  // O[t] = K[block t+1, block t] = W[b:, :b]
      wj = j;
    }
    const T* Bg = B + (long)g * r * w;
    const T* dg = d + (long)g * r;
    T s = T(0);
    for (int k = 0; k < r; ++k) s += Bg[k * w + wi] * dg[k] * Bg[k * w + wj];
    acc += s;
  }
  return acc;
}

// ------------------------------------------------------------------ K2

// Lower Cholesky of the BS x BS block A into L (L may be A: the upper
// triangle of A is never read), each pivot floored at tiny.
template <typename T, int BS, int NT>
BHD void chol_block(const T* A, T* L, T tiny, int tid) {
  for (int j = 0; j < BS; ++j) {
    if (tid == j % NT) {
      T s = A[j * BS + j];
      for (int k = 0; k < j; ++k) s -= L[j * BS + k] * L[j * BS + k];
      L[j * BS + j] = bsqrt<T>(s > tiny ? s : tiny);
    }
    WSYNC();
    for (int i = tid; i < BS; i += NT) {
      if (i > j) {
        const T inv = T(1) / L[j * BS + j];
        T r = A[i * BS + j];
        for (int k = 0; k < j; ++k) r -= L[i * BS + k] * L[j * BS + k];
        L[i * BS + j] = r * inv;
      }
      if (i < j) L[i * BS + j] = T(0);  // upper triangle
    }
    WSYNC();
  }
}

// M <- M Lp^{-T} in place (row i solves Lp y = M[i, :] forward)
template <typename T, int BS, int NT>
BHD void offdiag_solve(const T* Lp, T* M, int tid) {
  for (int i = tid; i < BS; i += NT) {
    for (int j = 0; j < BS; ++j) {
      T s = M[i * BS + j];
      for (int k = 0; k < j; ++k) s -= Lp[j * BS + k] * M[i * BS + k];
      M[i * BS + j] = s / Lp[j * BS + j];
    }
  }
}

// A <- Dt - M M^T (the sum is taken first, as in the JAX routine); A may
// be Dt (each member reads and writes its own rows)
template <typename T, int BS, int NT>
BHD void schur_update(const T* Dt, const T* M, T* A, int tid) {
  for (int i = tid; i < BS; i += NT) {
    for (int j = 0; j < BS; ++j) {
      T acc = T(0);
      for (int k = 0; k < BS; ++k) acc += M[i * BS + k] * M[j * BS + k];
      A[i * BS + j] = Dt[i * BS + j] - acc;
    }
  }
}

// The whole block Cholesky of one lane IN PLACE: D -> LD, O -> LM.
template <typename T, int BS, int NT>
BHD void btd_factor_inplace(T* D, T* O, int nT, T tiny, int tid) {
  constexpr int BB = BS * BS;
  chol_block<T, BS, NT>(D, D, tiny, tid);
  for (int t = 1; t < nT; ++t) {
    T* M = O + (long)(t - 1) * BB;
    T* Dt = D + (long)t * BB;
    offdiag_solve<T, BS, NT>(D + (long)(t - 1) * BB, M, tid);
    WSYNC();
    schur_update<T, BS, NT>(Dt, M, Dt, tid);
    WSYNC();
    chol_block<T, BS, NT>(Dt, Dt, tiny, tid);
  }
}

// ------------------------------------------------------------------ K3

// One forward block step of L y = r:  y_t = L_t^{-1} (r_t - M_t y_{t-1})
// (M null at t = 0).  The triangular solve is column-oriented, the solved
// entry broadcast to the team, so no barrier sits inside the b-step
// chain.  y may be vprev (the team syncs before writing it).
template <typename T, int BS, int NT>
BHD void fwd_step(const T* L, const T* M, const T* rt, const T* vprev, T* y,
                  int tid) {
  constexpr int V = (BS + NT - 1) / NT;
  T s[V], yv[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int i = tid + k * NT;
    s[k] = T(0);
    yv[k] = T(0);
    if (i < BS) {
      s[k] = rt[i];
      if (M) {
        T acc = T(0);
        for (int c = 0; c < BS; ++c) acc += M[i * BS + c] * vprev[c];
        s[k] = s[k] - acc;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < BS; ++j) {
    const T v = (tid == j % NT) ? s[j / NT] / L[j * BS + j] : T(0);
    const T xj = team_bcast<NT>(v, j % NT);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = tid + k * NT;
      if (i == j) yv[k] = xj;
      if (i > j && i < BS) s[k] -= L[i * BS + j] * xj;
    }
  }
  WSYNC();
#pragma unroll
  for (int k = 0; k < V; ++k)
    if (tid + k * NT < BS) y[tid + k * NT] = yv[k];
  WSYNC();
}

// One backward block step of L^T x = y:  x_t = L_t^{-T} (y_t - M_{t+1}^T
// x_{t+1}) (M null at t = T-1); the terms subtracted in reverse order.
// x may be yt or vnext (the team syncs before writing it).
template <typename T, int BS, int NT>
BHD void bwd_step(const T* L, const T* M, const T* yt, const T* vnext, T* x,
                  int tid) {
  constexpr int V = (BS + NT - 1) / NT;
  T s[V], xv[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int i = tid + k * NT;
    s[k] = T(0);
    xv[k] = T(0);
    if (i < BS) {
      s[k] = yt[i];
      if (M) {
        T acc = T(0);
        for (int c = 0; c < BS; ++c) acc += M[c * BS + i] * vnext[c];
        s[k] = s[k] - acc;
      }
    }
  }
#pragma unroll
  for (int j = BS - 1; j >= 0; --j) {
    const T v = (tid == j % NT) ? s[j / NT] / L[j * BS + j] : T(0);
    const T xj = team_bcast<NT>(v, j % NT);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = tid + k * NT;
      if (i == j) xv[k] = xj;
      if (i < j) s[k] -= L[j * BS + i] * xj;
    }
  }
  WSYNC();
#pragma unroll
  for (int k = 0; k < V; ++k)
    if (tid + k * NT < BS) x[tid + k * NT] = xv[k];
  WSYNC();
}

// K x = r for one lane from the factor (LD, LM); x (T, b) may not be r.
template <typename T, int BS, int NT>
BHD void btd_solve_lane(const T* LD, const T* LM, const T* r, T* x, int nT,
                        int tid) {
  constexpr int BB = BS * BS;
  for (int t = 0; t < nT; ++t)
    fwd_step<T, BS, NT>(LD + (long)t * BB,
                        t > 0 ? LM + (long)(t - 1) * BB : nullptr,
                        r + t * BS, t > 0 ? x + (t - 1) * BS : x, x + t * BS,
                        tid);
  for (int t = nT - 1; t >= 0; --t)
    bwd_step<T, BS, NT>(LD + (long)t * BB,
                        t < nT - 1 ? LM + (long)t * BB : nullptr, x + t * BS,
                        t < nT - 1 ? x + (t + 1) * BS : x, x + t * BS, tid);
}

// ------------------------------------------------- K2, K3: K6's warp form
//
// The block Cholesky and the block solves as K6 runs them on one warp:
// the same arithmetic as btd_factor_inplace and btd_solve_lane, every sum
// in the same order, but with the rows in registers and no branch in the
// chains.  Row r of a block is held by member r % NT in slot r / NT (V =
// ceil(BS / NT) slots: one on the card, where NT = 32 > b, BS on the host,
// where NT = 1); a value of another member's row comes by team_bcast (a
// warp shuffle).  A float division by a pivot L[j, j] takes its reciprocal
// refined once (qm::qrcp, kept in rc beside the factor), and every float
// division and root takes qmath's fast path with a flag (qdiv_f,
// qsqrt_f): a triangular b-step whose flag is cleared (an operand out of
// the fast path's range, as the tiny values of pinned coordinates) is done
// again with qdiv, and a factor whose Cholesky steps' flag is cleared
// returns false, and the caller does it again, whole, with
// btd_factor_inplace, so the results are those of the operators bit for
// bit.
// Only D's lower triangle is read or written.

// every member's flag, and-ed over the team
template <int NT>
BHD bool team_all(bool ok) {
#ifdef __CUDA_ARCH__
  if (NT > 1) return __all_sync(0xffffffffu, ok);
#endif
  return ok;
}

// The triangular solve of one b-step in registers: L x = s (LOWER, the
// terms subtracted in column order) or L^T x = s (the terms subtracted
// from the last column down); s is consumed.  EXACT: qdiv, else the
// flagged fast path (returns false where it did not hold).
template <typename T, int BS, bool LOWER, bool EXACT>
BHD bool tri_pass(T (&s)[BS], const T* L, const T* rcp, T (&x)[BS]) {
  bool ok = true;
#pragma unroll
  for (int jj = 0; jj < BS; ++jj) {
    const int j = LOWER ? jj : BS - 1 - jj;
    const T xj = EXACT ? qm::qdiv(s[j], L[j * BS + j])
                       : qm::qdiv_f(s[j], L[j * BS + j], rcp[j], ok);
    x[j] = xj;
    if (LOWER) {
#pragma unroll
      for (int i = j + 1; i < BS; ++i) s[i] -= L[i * BS + j] * xj;
    } else {
#pragma unroll
      for (int i = 0; i < j; ++i) s[i] -= L[j * BS + i] * xj;
    }
  }
  return ok;
}

// the b-step's triangular solve: the fast path, and where it did not
// hold (an operand out of its range), the same step again with qdiv
template <typename T, int BS, bool LOWER>
BHD void tri_solve(const T (&s)[BS], const T* L, const T* rcp, T (&x)[BS]) {
  T w[BS];
#pragma unroll
  for (int i = 0; i < BS; ++i) w[i] = s[i];
  if (tri_pass<T, BS, LOWER, false>(w, L, rcp, x)) return;
#pragma unroll
  for (int i = 0; i < BS; ++i) w[i] = s[i];
  tri_pass<T, BS, LOWER, true>(w, L, rcp, x);
}

// The Cholesky of the lower triangle of A (my rows), column by column, in
// place
template <typename T, int BS, int NT>
BHD void chol_rows(T (&A)[(BS + NT - 1) / NT][BS], T tiny, int tid,
                   bool& ok) {
  constexpr int V = (BS + NT - 1) / NT;
#pragma unroll
  for (int j = 0; j < BS; ++j) {
    T s = A[j / NT][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= A[j / NT][k] * A[j / NT][k];
    s = s > tiny ? s : tiny;
    bool okj = true;
    const T d = qm::qsqrt_f(s, okj);
    ok = ok & (okj | (tid != j % NT));
    const T ljj = team_bcast<NT>(d, j % NT);
    T ljk[BS > 1 ? BS - 1 : 1];
#pragma unroll
    for (int k = 0; k < j; ++k) ljk[k] = team_bcast<NT>(A[j / NT][k], j % NT);
    const T inv = qm::qdiv_f(T(1), ljj, qm::qrcp(ljj), ok);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int i = tid + v * NT;
      T r = A[v][j];
#pragma unroll
      for (int k = 0; k < j; ++k) r -= A[v][k] * ljk[k];
      if (i > j) A[v][j] = r * inv;
      if (i == j) A[v][j] = ljj;
    }
  }
}

// One block step of the factor: M <- M Lp^{-T} (M = O[t-1] in place; Lp,
// rcp the previous block's factor), A <- Dt - M M^T, Dt <- chol(A) in
// place, rct its pivots' reciprocals.  FIRST (t = 0): Dt <- chol(Dt)
// alone.  A member past the block's last row works on that row too and
// stores nothing, so no branch splits the warp.
template <typename T, int BS, int NT, bool FIRST>
BHD void factor_step(const T* Lp, const T* rcp, T* M, T* Dt, T* rct, T tiny,
                     int tid, bool& ok) {
  constexpr int V = (BS + NT - 1) / NT;
  T A[V][BS];
  if (!FIRST) {
    T m[V][BS];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int i = tid + v * NT, ic = i < BS ? i : BS - 1;
      T row[BS];
#pragma unroll
      for (int j = 0; j < BS; ++j) row[j] = M[ic * BS + j];
      tri_solve<T, BS, true>(row, Lp, rcp, m[v]);
    }
    WSYNC();
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int i = tid + v * NT;
      if (i < BS) {
#pragma unroll
        for (int j = 0; j < BS; ++j) M[i * BS + j] = m[v][j];
      }
    }
    WSYNC();
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int i = tid + v * NT, ic = i < BS ? i : BS - 1;
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < BS; ++k) acc += m[v][k] * M[j * BS + k];
        A[v][j] = j <= ic ? Dt[ic * BS + j] - acc : T(0);
      }
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int i = tid + v * NT, ic = i < BS ? i : BS - 1;
#pragma unroll
      for (int j = 0; j < BS; ++j) A[v][j] = j <= ic ? Dt[ic * BS + j] : T(0);
    }
  }
  chol_rows<T, BS, NT>(A, tiny, tid, ok);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = tid + v * NT;
    if (i < BS) {
#pragma unroll
      for (int j = 0; j < BS; ++j)
        if (j <= i) Dt[i * BS + j] = A[v][j];
    }
  }
#pragma unroll
  for (int j = 0; j < BS; ++j)
    if (tid == j % NT) rct[j] = qm::qrcp(A[j / NT][j]);
  WSYNC();
}

// The whole factor of one lane in place: D -> LD (lower), O -> LM, rc
// (nT, BS) the pivots' reciprocals.  Returns false (on every member) where
// a fast path did not hold: the caller then assembles D and O again and
// factors them with btd_factor_inplace.
template <typename T, int BS, int NT>
BHD bool btd_factor_warp(T* D, T* O, T* rc, int nT, T tiny, int tid) {
  constexpr int BB = BS * BS;
  bool ok = true;
  factor_step<T, BS, NT, true>(nullptr, nullptr, nullptr, D, rc, tiny, tid,
                               ok);
  for (int t = 1; t < nT; ++t)
    factor_step<T, BS, NT, false>(D + (long)(t - 1) * BB, rc + (t - 1) * BS,
                                  O + (long)(t - 1) * BB, D + (long)t * BB,
                                  rc + t * BS, tiny, tid, ok);
  return team_all<NT>(ok);
}

// One b-step's right-hand side gathered to every member: s = v - M u
// (TRANS: v - M^T u; without M, hasM false, at the chain's first step),
// row i formed by its owner (a member past the last row repeats that row)
template <typename T, int BS, int NT, bool TRANS>
BHD void gather_rhs(const T* v, const T* M, bool hasM, const T (&u)[BS],
                    T (&s)[BS], int tid) {
  constexpr int V = (BS + NT - 1) / NT;
  T part[V];
#pragma unroll
  for (int w = 0; w < V; ++w) {
    const int i = tid + w * NT, ic = i < BS ? i : BS - 1;
    T si = v[ic];
    if (hasM) {
      T acc = T(0);
#pragma unroll
      for (int c = 0; c < BS; ++c)
        acc += (TRANS ? M[c * BS + ic] : M[ic * BS + c]) * u[c];
      si = si - acc;
    }
    part[w] = si;
  }
#pragma unroll
  for (int j = 0; j < BS; ++j) s[j] = team_bcast<NT>(part[j / NT], j % NT);
}

// K x = r for one lane from the factor (LD, LM, rc); x (T, b) may not be
// r.  Each b-step's right-hand side is formed row by row, gathered to
// every member, and the triangular solve runs in every member's
// registers.  The owner of row i stores it and is the only member that
// reads it back, so the forward solve's y lies in x with no barrier.
template <typename T, int BS, int NT>
BHD void btd_solve_warp(const T* LD, const T* LM, const T* rc, const T* r,
                        T* x, int nT, int tid) {
  constexpr int BB = BS * BS;
  T xv[BS], s[BS];
  // forward: y_t = L_t^{-1} (r_t - M_t y_{t-1})
  for (int t = 0; t < nT; ++t) {
    gather_rhs<T, BS, NT, false>(r + t * BS, LM + (long)(t - 1) * BB, t > 0,
                                 xv, s, tid);
    tri_solve<T, BS, true>(s, LD + (long)t * BB, rc + t * BS, xv);
#pragma unroll
    for (int j = 0; j < BS; ++j)
      if (tid == j % NT) x[t * BS + j] = xv[j];
  }
  // backward: x_t = L_t^{-T} (y_t - M_{t+1}^T x_{t+1})
  for (int t = nT - 1; t >= 0; --t) {
    gather_rhs<T, BS, NT, true>(x + t * BS, LM + (long)t * BB, t < nT - 1,
                                xv, s, tid);
    tri_solve<T, BS, false>(s, LD + (long)t * BB, rc + t * BS, xv);
#pragma unroll
    for (int j = 0; j < BS; ++j)
      if (tid == j % NT) x[t * BS + j] = xv[j];
  }
}

}  // namespace banded
