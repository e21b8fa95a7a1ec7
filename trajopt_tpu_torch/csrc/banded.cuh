// Per-lane bodies of K1 bb_quad, K2 btd_factor and K3 btd_solve, shared by
// their own kernels (bb_quad.cu, btd_factor.cu, btd_solve.cu) and by K6
// ipm_banded (ipm.cuh), which runs them inside its per-lane IPM loop.
//
// Every function is __host__ __device__ (HD) and written for a TEAM of
// threads: member `tid` of `NT` takes rows tid, tid + NT, ... of a block.
// On the card the team is one warp (NT = 32, b <= 21 < 32, so a member
// owns one row) and WSYNC is __syncwarp(); in the host build (ipm_host.cpp)
// the team is one thread (NT = 1) that plays every row, and WSYNC is empty.
// The arithmetic, and the order of every sum, is the same in both.
//
// The block-tridiagonal layout of ops.btridiag: D (T, b, b) diagonal
// blocks, O (T-1, b, b) sub-diagonal blocks O[t] = K[t+1, t]; the factor
// is LD (T, b, b) lower with zeros above the diagonal, LM (T-1, b, b).
// Row groups are those of ops.banded_rows: B (n_g, r, 2b) windows over
// column blocks G[g] and G[g] + 1.
#pragma once

#include <math.h>

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

}  // namespace banded
