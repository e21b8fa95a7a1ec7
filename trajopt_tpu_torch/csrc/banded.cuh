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
// K6 and K11's block route run the block-inverse form at the end of this
// file (btd_factor_warp, btd_couple_v / _w, btd_apply_inv, btd_sweep): the
// same K x = r as K2's and K3's steps, with the solves as recurrences over
// the pivot blocks' inverses formed in the factor.
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

// ---------------------------- K2, K3: K6's and K11's block-inverse form
//
// K6 and K11's block route factor K and solve K x = r through the inverses
// of the pivot blocks' Cholesky factors, Linv_t = L_t^{-1}, so that a solve
// is two recurrences of b x b products with no division:
// - the factor (btd_factor_warp; one warp, over t in order): M_t = O_{t-1}
//   Linv_{t-1}^T (a product in place of the reference's triangular solve),
//   S_t = D_t - M_t M_t^T (the sum taken first), L_t = chol(S_t) with each
//   pivot floored at tiny, and Linv_t formed beside L_t: row j of Linv as
//   soon as L's column j is known.  D_t <- Linv_t (lower), O_{t-1} <- M_t;
//   L itself is not kept.
// - the couplings (btd_couple_v, btd_couple_w; the whole team, every t at
//   once): V_t = Linv_t^T M_{t+1}^T into V, then W_t = Linv_t M_t in place
//   of M_t.
// - the solve (btd_apply_inv, btd_sweep): c = Linv r (the team, every row
//   at once), y_t = c_t - W_t y_{t-1} (one warp: a b x b product a step),
//   d = Linv^T y (the team), x_t = d_t - V_t x_{t+1} (one warp).
// Row r of a block is held by team member r % NT in slot r / NT (V =
// ceil(BS / NT) slots: one on the card, where NT = 32 > b, BS on the host,
// where NT = 1); a value of another member's row comes by team_bcast (a
// warp shuffle).  The only divisions are the pivots' reciprocals 1 / L_jj
// and the only roots the pivots: EXACT takes qm::qdiv / qm::qsqrt, else
// qmath's flagged fast paths (qdiv_f, qsqrt_f), and a factor whose flag is
// cleared returns false and the caller does it again, whole, with EXACT:
// the same arithmetic with the exact operators, so the two agree bit for
// bit.  The sums: the
// passes' and the couplings' in index order, a sweep step's dot product as
// a balanced tree (log2 b dependent adds).  No
// tensor cores: at b <= 21 the off-chain products are ~20k multiply-adds
// a factor, far from any limit, and a float32 mma would round through
// TF32.  Only D's lower triangle is read or written.

// every member's flag, and-ed over the team
template <int NT>
BHD bool team_all(bool ok) {
#ifdef __CUDA_ARCH__
  if (NT > 1) return __all_sync(0xffffffffu, ok);
#endif
  return ok;
}

// p[LO] + ... + p[LO + N - 1] as a balanced tree (the halves summed apart)
template <int LO, int N, typename T, int BS>
BHD T tree_sum(const T (&p)[BS]) {
  if constexpr (N == 1) {
    return p[LO];
  } else {
    return tree_sum<LO, N / 2>(p) + tree_sum<LO + N / 2, N - N / 2>(p);
  }
}

// The Cholesky of the lower triangle of A (my rows) in place, column by
// column, and beside it the rows of its inverse into Li: Li[j][j] =
// 1 / L[j][j], Li[j][m] = -(sum over p = m .. j-1 of L[j][p] Li[p][m]) *
// Li[j][j] (m < j), the sum gathered in row j's slot as each row p is
// formed.  A member past the block's last row works on that row too.
template <typename T, int BS, int NT, bool EXACT>
BHD void chol_inv_rows(T (&A)[(BS + NT - 1) / NT][BS],
                       T (&Li)[(BS + NT - 1) / NT][BS], T tiny, int tid,
                       bool& ok) {
  constexpr int V = (BS + NT - 1) / NT;
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int m = 0; m < BS; ++m) Li[v][m] = T(0);
#pragma unroll
  for (int j = 0; j < BS; ++j) {
    T s = A[j / NT][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= A[j / NT][k] * A[j / NT][k];
    s = s > tiny ? s : tiny;
    bool okj = true;
    const T d = EXACT ? qm::qsqrt(s) : qm::qsqrt_f(s, okj);
    ok = ok & (okj | (tid != j % NT));
    const T ljj = team_bcast<NT>(d, j % NT);
    T ljk[BS > 1 ? BS - 1 : 1];
#pragma unroll
    for (int k = 0; k < j; ++k) ljk[k] = team_bcast<NT>(A[j / NT][k], j % NT);
    const T inv = EXACT ? qm::qdiv(T(1), ljj)
                        : qm::qdiv_f(T(1), ljj, qm::qrcp(ljj), ok);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int i = tid + v * NT;
      T r = A[v][j];
#pragma unroll
      for (int k = 0; k < j; ++k) r -= A[v][k] * ljk[k];
      if (i > j) A[v][j] = r * inv;
      if (i == j) {
        A[v][j] = ljj;
#pragma unroll
        for (int m = 0; m < j; ++m) Li[v][m] = -Li[v][m] * inv;
        Li[v][j] = inv;
      }
    }
    T lj[BS];
#pragma unroll
    for (int m = 0; m <= j; ++m) lj[m] = team_bcast<NT>(Li[j / NT][m], j % NT);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int i = tid + v * NT;
      if (i > j) {
#pragma unroll
        for (int m = 0; m <= j; ++m) Li[v][m] += A[v][j] * lj[m];
      }
    }
  }
}

// One block step of the factor: M <- M Lp^T (M = O[t-1] in place, Lp the
// previous block's inverse), A <- Dt - M M^T, Dt <- the inverse of
// chol(A).  FIRST (t = 0): Dt <- the inverse of chol(Dt) alone.  A member
// past the block's last row works on that row too and stores nothing, so
// no branch splits the warp.
template <typename T, int BS, int NT, bool FIRST, bool EXACT>
BHD void factor_step(const T* Lp, T* M, T* Dt, T tiny, int tid, bool& ok) {
  constexpr int V = (BS + NT - 1) / NT;
  T A[V][BS];
  if (!FIRST) {
    T m[V][BS];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int i = tid + v * NT, ic = i < BS ? i : BS - 1;
      T o[BS];
#pragma unroll
      for (int k = 0; k < BS; ++k) o[k] = M[ic * BS + k];
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k <= j; ++k) acc += o[k] * Lp[j * BS + k];
        m[v][j] = acc;
      }
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
  T Li[V][BS];
  chol_inv_rows<T, BS, NT, EXACT>(A, Li, tiny, tid, ok);
  WSYNC();
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = tid + v * NT;
    if (i < BS) {
#pragma unroll
      for (int j = 0; j < BS; ++j)
        if (j <= i) Dt[i * BS + j] = Li[v][j];
    }
  }
  WSYNC();
}

// The whole factor of one lane in place: D -> the blocks' inverses Linv
// (lower), O -> M.  Returns false (on every member) where a fast path did
// not hold (never with EXACT): the caller then assembles D and O again and
// factors them with EXACT.
template <typename T, int BS, int NT, bool EXACT>
BHD bool btd_factor_warp(T* D, T* O, int nT, T tiny, int tid) {
  constexpr int BB = BS * BS;
  bool ok = true;
  factor_step<T, BS, NT, true, EXACT>(nullptr, nullptr, D, tiny, tid, ok);
  for (int t = 1; t < nT; ++t)
    factor_step<T, BS, NT, false, EXACT>(D + (long)(t - 1) * BB,
                                         O + (long)(t - 1) * BB,
                                         D + (long)t * BB, tiny, tid, ok);
  return team_all<NT>(ok);
}

// V_t = Linv_t^T M_{t+1}^T (t < nT - 1; M_{t+1} lies at O[t]), an entry a
// member in turn: V_t[i][j] = sum over k >= i of Linv_t[k][i] M_{t+1}[j][k]
template <typename T, int BS>
BHD void btd_couple_v(const T* Li, const T* M, T* V, int nT, int tid,
                      int nthr) {
  constexpr int BB = BS * BS;
  for (long e = tid; e < (long)(nT - 1) * BB; e += nthr) {
    const long t = e / BB;
    const int i = (int)(e / BS) % BS, j = (int)(e % BS);
    const T* L = Li + t * BB;
    const T* Mn = M + t * BB + j * BS;
    T acc = T(0);
    for (int k = i; k < BS; ++k) acc += L[k * BS + i] * Mn[k];
    V[e] = acc;
  }
}

// W_t = Linv_t M_t in place of M_t (t >= 1, at O[t-1]), a column a member
// in turn: W_t[i][j] = sum over k <= i of Linv_t[i][k] M_t[k][j]
template <typename T, int BS>
BHD void btd_couple_w(const T* Li, T* M, int nT, int tid, int nthr) {
  constexpr int BB = BS * BS;
  for (long e = tid; e < (long)(nT - 1) * BS; e += nthr) {
    const long t = e / BS + 1;
    const int j = (int)(e % BS);
    const T* L = Li + t * BB;
    T* Mt = M + (t - 1) * BB;
    T w[BS];
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      T acc = T(0);
#pragma unroll
      for (int k = 0; k <= i; ++k) acc += L[i * BS + k] * Mt[k * BS + j];
      w[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < BS; ++i) Mt[i * BS + j] = w[i];
  }
}

// w = Linv r (TRANS: Linv^T r), block by block, an entry a member in turn;
// w may not be r
template <typename T, int BS, bool TRANS>
BHD void btd_apply_inv(const T* Li, const T* r, T* w, int nT, int tid,
                       int nthr) {
  constexpr int BB = BS * BS;
  for (int e = tid; e < nT * BS; e += nthr) {
    const int t = e / BS, i = e % BS;
    const T* L = Li + (long)t * BB;
    const T* rt = r + t * BS;
    T acc = T(0);
    if (TRANS) {
      for (int k = i; k < BS; ++k) acc += L[k * BS + i] * rt[k];
    } else {
      for (int k = 0; k <= i; ++k) acc += L[i * BS + k] * rt[k];
    }
    w[e] = acc;
  }
}

// a sweep step's operands for my rows: row i of the coupling block and
// entry i of c (step s of btd_sweep)
template <typename T, int BS, int NT, bool FWD>
BHD void sweep_load(const T* C, const T* c, int nT, int s, int tid,
                    T (&cr)[(BS + NT - 1) / NT][BS],
                    T (&cv)[(BS + NT - 1) / NT]) {
  constexpr int V = (BS + NT - 1) / NT, BB = BS * BS;
  const int t = FWD ? s : nT - 1 - s;
  const T* Cb = C + (long)(FWD ? t - 1 : t) * BB;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = tid + v * NT, ic = i < BS ? i : BS - 1;
#pragma unroll
    for (int k = 0; k < BS; ++k) cr[v][k] = Cb[ic * BS + k];
    cv[v] = c[t * BS + ic];
  }
}

// One sweep over the blocks on the team: FWD x_0 = c_0, x_t = c_t - W_t
// x_{t-1} (W_t at C[t-1]); else x_{T-1} = c_{T-1}, x_t = c_t - V_t x_{t+1}
// (V_t at C[t]).  Member i keeps x's row i of the last step in registers
// and stores it; the step's product gathers that step by shuffles, and
// the next step's operands are loaded ahead of it.  x may not be c.
template <typename T, int BS, int NT, bool FWD>
BHD void btd_sweep(const T* C, const T* c, T* x, int nT, int tid) {
  constexpr int V = (BS + NT - 1) / NT;
  const int t0 = FWD ? 0 : nT - 1;
  T xv[V], cr[V][BS], cv[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = tid + v * NT, ic = i < BS ? i : BS - 1;
    xv[v] = c[t0 * BS + ic];
    if (i < BS) x[t0 * BS + i] = xv[v];
  }
  if (nT > 1) sweep_load<T, BS, NT, FWD>(C, c, nT, 1, tid, cr, cv);
  for (int s = 1; s < nT; ++s) {
    T crn[V][BS], cvn[V];
    sweep_load<T, BS, NT, FWD>(C, c, nT, s + 1 < nT ? s + 1 : s, tid, crn,
                               cvn);
    T u[BS];
#pragma unroll
    for (int k = 0; k < BS; ++k) u[k] = team_bcast<NT>(xv[k / NT], k % NT);
    const int t = FWD ? s : nT - 1 - s;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int i = tid + v * NT;
      T p[BS];
#pragma unroll
      for (int k = 0; k < BS; ++k) p[k] = cr[v][k] * u[k];
      xv[v] = cv[v] - tree_sum<0, BS>(p);
      if (i < BS) x[t * BS + i] = xv[v];
#pragma unroll
      for (int k = 0; k < BS; ++k) cr[v][k] = crn[v][k];
      cv[v] = cvn[v];
    }
  }
}

}  // namespace banded
