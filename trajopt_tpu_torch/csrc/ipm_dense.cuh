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
// Lists: the rows are fixed for the whole loop (only the diagonals and
// vectors change) and almost all zeros (a cartesian velocity row touches
// 14 of 210 columns, a timed velocity row 3 of 240).  So before its loop
// the lane lists, once, the nonzeros of each scaled row kind by rows (in
// column order) and by columns (in row order), of P by rows, and of the
// raw rows and raw P by rows (pinned columns make their zeros differ),
// and every sum of the loop runs over a list in the order
// the dense sum takes, leaving out the terms whose matrix entry is zero.
// Such a term is +0 or -0 where its other factor is finite, and adding a
// zero to a sum that started at +0 changes neither its value nor its sign
// (the sum is never -0 under round-to-nearest), so every output is the
// dense order's.  Where a factor is not finite (0 * inf and 0 * NaN are
// NaN), the sum takes the dense order: a row pass when its vector has a
// non-finite entry, a column pass when a product u_i w_i has, the assembly
// of a row kind when a d_i, or a row's entry times d_i, has (finite_all,
// row_finite).  The lists are built from the dense rows in device memory
// (build_lists): by rows a warp per RA rows (a ballot and a count per 32
// columns), by columns from those, a member per column (the rows in
// order); offsets by a warp's scan.  A QP of fewer columns than the
// wrapper's threshold (Args::lists 0) builds none and keeps the dense
// order: an instantiation of its own (LISTS), where the lists would only
// add latency.
//
// The factor takes one of two routes, as the plain loop does (nb > 0: the
// kkt_block b is set, n % b == 0 and n >= 2b):
// - block route: only the block-tridiagonal band of the symmetrized K is
//   formed (D's lower triangles, O), and factored and solved by K2's and
//   K3's device functions in banded.cuh's block-inverse form (the factor
//   banded::btd_factor_warp on the first warp, its fast paths or the exact
//   operators; the couplings and the solves' passes on the whole team,
//   their sweeps on the first warp: ipm::btd_couple_team, btd_solve_team),
//   at the run-time b through Blocks (every b of the library's range
//   LO..HI);
// - dense route (nb == 0): the lower triangle of K + reg I, packed by rows
//   (n (n + 1) / 2 entries), a blocked Cholesky by the whole team
//   (factor_team: a panel of PANEL columns a column at a time, one barrier
//   a column; then the trailing triangle's updates by the panel in
//   register tiles; each entry takes the right-looking factor's rank-one
//   updates one by one in column order, then its scaling), then the
//   residuals on the members past the first warp, and the Newton solves
//   as two triangular solves on the first warp (L y = r by rows, each
//   row's dot product summed across the warp; L' x = y by columns), in
//   place of the reference's explicit inverse L^-T L^-1.  A pivot that is
//   not positive (or NaN) marks the factor broken and every solve then
//   returns NaN, as torch.linalg.cholesky_ex's info != 0 does in the
//   plain loop, so the NaN guard keeps the incumbent.
//
// Every sum runs in a fixed order, no atomics; min, max and clamp
// propagate NaN as torch does (ipm.cuh's helpers); divisions and roots are
// qm::qdiv / qm::qsqrt.  Team, barriers and reductions as K6's (ipm.cuh).
//
// Memory per lane: the reduction buffer and the flags in shared memory;
// five regions in shared memory where the launcher's plan holds them
// (Args::smem_k, smem_lists, smem_base, smem_scr, smem_raw, in that
// priority), else in the lane's slice of the device scratch (Args::dscr):
// K (the dense route's packed triangle), the lists of the scaled rows and
// of P, base (the block route's D, O, V and the solves' scratch n-vector,
// and the n-vectors), the scratch m-vectors (12 per row kind) and the raw
// lists; the lists' table (8 descriptors) beside the flags.  The dense rows and
// P stay in device memory, read by the lists' build and by the dense
// order.
#pragma once

#include "ipm.cuh"

#ifdef __CUDACC__
#define K11_NOINLINE __host__ __device__ __noinline__
#else
#define K11_NOINLINE inline
#endif

namespace ipm_dense {

using ipm::finite;
using ipm::nmax;
using ipm::team_reduce;
using qm::qdiv;

constexpr int N_VEC = 18;      // n-vectors of the base region
using ipm::N_SCR_VEC;          // m-vectors per row kind in the scratch
constexpr int N_SC = 4;        // flags and scalars in shared memory (ipm::Loop's
                               // two, the dense factor's broke flag)
constexpr int PANEL = 8;       // the dense factor's panel of columns
constexpr int TILE = 4;        // its trailing updates: TILE x TILE a member

// The launch arguments (ctypes mirror: ops.ipm_qp._K11Args).  Per-lane
// arrays are lane-major and contiguous.
struct Args {
  int lanes, n, b, nb, mh, ma, max_iter;
  // where each region lives: 1 shared memory, 0 the device scratch (the
  // card's launcher plans them and writes its choice back; the host build
  // takes them as given)
  int smem_k, smem_lists, smem_base, smem_scr, smem_raw;
  // 1: the sums run over the lists; 0: in the dense order (a QP of a few
  // columns, where the lists would only add latency; the outputs alike)
  int lists;
  // the lists' capacities, the most entries of any lane: the scaled Jh
  // and Ja, the raw Rh and Ra, P and the raw P (the wrapper counts the
  // nonzeros)
  int nz_h, nz_a, nz_rh, nz_ra, nz_p, nz_pr;
  double eps_abs, eps_rel;
  // P scaled and raw, (n, n) each, row-major; q scaled and raw; the
  // IPM's bounds (pinned coordinates at -1, 1) and the raw ones; cf
  // (lanes, 2): c, f(0)
  const void *P, *Pr, *q, *qr, *lb, *ub, *lbr, *ubr, *cf;
  // per row kind: rows (m, n) scaled J and raw R, scaled e and w, raw e
  // and w
  const void *Jh, *Rh, *eh, *wh, *ehr, *whr;
  const void *Ja, *Ra, *ea, *wa, *ear, *war;
  // outputs: the final iterate, the incumbent, per-lane scalars; the
  // device scratch (scratch_size elements per lane)
  void *dx, *z5, *z6, *dxb, *h, *z1, *p, *nn, *y, *rp, *rd, *fb, *dscr;
  int *it, *status;
  // the phase timer (the timed library only; null: off): CLK_SLOTS per
  // lane, ipm::Loop's phases (clock64 cycles on thread 0 summed over the
  // lane's iterations), the factors that took their fallback, the cycles
  // of the lane's set-up before its loop, and of the dense route's factor
  // the panels' columns and the trailing updates
  long long* clk;
};

constexpr int CLK_SLOTS = ipm::N_PHASES + 4;

// elements of T that k ints take
template <typename T>
BHD long ints(long k) {
  return (k * (long)sizeof(int) + (long)sizeof(T) - 1) / (long)sizeof(T);
}
// a list of cap entries over `rows` rows (or columns): the values, then
// the indices and the rows' offsets
template <typename T>
BHD long list_size(int rows, long cap) {
  return cap + ints<T>(cap + rows + 1);
}

// A matrix's nonzeros by rows (or by columns): row r's at ptr[r] ..
// ptr[r + 1] - 1, their values and column (row) indices in column (row)
// order
template <typename T>
struct List {
  T* val;
  int *idx, *ptr;
};

// K11's lists, by their index in the lane's table (in shared memory, so
// that the loop keeps one pointer to it in registers): by rows the scaled
// Jh and Ja, P, the raw Rh and Ra, the raw P; by columns the scaled Jh
// and Ja
enum { LH, LA, LP, LRH, LRA, LPR, LHC, LAC, N_LISTS };

// elements of T that the table takes
template <typename T>
BHD long tab_size() {
  return ((long)N_LISTS * sizeof(List<T>) + sizeof(T) - 1) / sizeof(T);
}

// elements of each region; the block route's band: D, O and V, and the
// solves' scratch n-vector
BHD long band_size(int b, int nb) {
  return nb > 0
             ? (long)nb * b * b + 2L * (nb - 1) * b * b + (long)nb * b
             : 0;
}
BHD long base_size(int n, int b, int nb) {
  return band_size(b, nb) + (long)N_VEC * n;
}
// the dense route's packed K
BHD long k_size(int n, int nb) { return nb > 0 ? 0 : (long)n * (n + 1) / 2; }
BHD long scr_size(int mh, int ma) { return (long)N_SCR_VEC * (mh + ma); }
// the scaled lists: Jh by rows and by columns, Ja likewise, P by rows
template <typename T>
BHD long lists_size(const Args& a) {
  return list_size<T>(a.mh, a.nz_h) + list_size<T>(a.n, a.nz_h) +
         list_size<T>(a.ma, a.nz_a) + list_size<T>(a.n, a.nz_a) +
         list_size<T>(a.n, a.nz_p);
}
// the raw lists: Rh, Ra and the raw P by rows
template <typename T>
BHD long raw_size(const Args& a) {
  return list_size<T>(a.mh, a.nz_rh) + list_size<T>(a.ma, a.nz_ra) +
         list_size<T>(a.n, a.nz_pr);
}
// the device scratch per lane: K, the lists, base, the scratch m-vectors,
// the raw lists (ops.ipm_qp.k11_scratch_size mirrors it)
template <typename T>
BHD long scratch_size(const Args& a) {
  return k_size(a.n, a.nb) + lists_size<T>(a) + base_size(a.n, a.b, a.nb) +
         scr_size(a.mh, a.ma) + raw_size<T>(a);
}

// A lane's shared memory, in elements of T: the reduction buffer, the
// flags, the lists' table, then the regions the plan puts there (K,
// lists, base, scratch, raw lists)
struct Layout {
  long o_sc, o_tab, o_k, o_lists, o_base, o_scr, o_raw, total;
};

template <typename T>
BHD Layout smem_layout(const Args& a, bool kin, bool lists, bool base,
                       bool scr, bool raw) {
  Layout L;
  L.o_sc = (long)ipm::N_RED * 32;
  L.o_tab = L.o_sc + N_SC;
  L.o_k = L.o_tab + tab_size<T>();
  L.o_lists = L.o_k + (kin ? k_size(a.n, a.nb) : 0);
  L.o_base = L.o_lists + (lists ? lists_size<T>(a) : 0);
  L.o_scr = L.o_base + (base ? base_size(a.n, a.b, a.nb) : 0);
  L.o_raw = L.o_scr + (scr ? scr_size(a.mh, a.ma) : 0);
  L.total = L.o_raw + (raw ? raw_size<T>(a) : 0);
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

// ---- the lists ----

// a list of cap entries over `rows` rows at p (list_size elements);
// returns its end
template <typename T>
BHD T* carve(T* p, int rows, long cap, List<T>& l) {
  l.val = p;
  l.idx = reinterpret_cast<int*>(p + cap);
  l.ptr = l.idx + cap;
  return p + list_size<T>(rows, cap);
}

// ptr[1..rows] hold the rows' counts: make ptr their offsets, by one
// warp (lane: its member) on the card, serially on the host
BHD void offsets(int* ptr, int rows, int lane) {
#ifdef __CUDA_ARCH__
  int carry = 0;
  for (int r0 = 0; r0 < rows; r0 += 32) {
    const int r = r0 + lane;
    int v = r < rows ? ptr[r + 1] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (r < rows) ptr[r + 1] = carry + v;
    carry += __shfl_sync(0xffffffffu, v, 31);
  }
  if (lane == 0) ptr[0] = 0;
#else
  (void)lane;
  ptr[0] = 0;
  for (int r = 0; r < rows; ++r) ptr[r + 1] += ptr[r];
#endif
}

// the lists by rows are read from device memory a warp per RA rows, UNR
// loads a member and row in flight
constexpr int UNR = 8, RA = 4;

// The list by rows of the m x n row-major M: row r's entries that are not
// zero (ALL: every entry) in column order.  COUNT: ptr[r + 1] = their
// count; else (after offsets) their values and columns.  On the card each
// warp takes a contiguous share of the rows, RA at a time, 32 columns a
// load, and compacts each load by a ballot; on the host the one member
// reads them all.
template <typename T, bool ALL, bool COUNT>
IHD void list_rows(const T* M, int m, int n, List<T> l, int tid,
                   int nthr) {
#ifdef __CUDA_ARCH__
  const int lane = tid & 31, w = tid >> 5, nw = nthr >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int r0 = (int)((long)m * w / nw), r1 = (int)((long)m * (w + 1) / nw);
  for (int r = r0; r < r1; r += RA) {
    int at[RA];
#pragma unroll
    for (int h = 0; h < RA; ++h)
      at[h] = COUNT || r + h >= r1 ? 0 : l.ptr[r + h];
    for (int k0 = 0; k0 < n; k0 += 32 * UNR) {
      T v[RA][UNR];
#pragma unroll
      for (int h = 0; h < RA; ++h)
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          const int k = k0 + 32 * u + lane;
          v[h][u] = r + h < r1 && k < n ? M[(long)(r + h) * n + k] : T(0);
        }
#pragma unroll
      for (int h = 0; h < RA; ++h) {
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          const int k = k0 + 32 * u + lane;
          const bool keep = r + h < r1 && k < n && (ALL || v[h][u] != T(0));
          const unsigned bal = __ballot_sync(0xffffffffu, keep);
          if (!COUNT && keep) {
            const int e = at[h] + __popc(bal & below);
            l.val[e] = v[h][u];
            l.idx[e] = k;
          }
          at[h] += __popc(bal);
        }
      }
    }
    if (COUNT && lane == 0) {
#pragma unroll
      for (int h = 0; h < RA; ++h)
        if (r + h < r1) l.ptr[r + h + 1] = at[h];
    }
  }
#else
  (void)tid, (void)nthr;
  for (int r = 0; r < m; ++r) {
    int at = COUNT ? 0 : l.ptr[r];
    for (int k = 0; k < n; ++k) {
      const T v = M[(long)r * n + k];
      if (ALL || v != T(0)) {
        if (!COUNT) {
          l.val[at] = v;
          l.idx[at] = k;
        }
        ++at;
      }
    }
    if (COUNT) l.ptr[r + 1] = at;
  }
#endif
}

// The list by columns (n of them) of the matrix listed by rows in rl (m
// rows): column k's entries in row order, a member per column reading rl
// in order (the members read its entries together).  COUNT: cl.ptr[k + 1]
// = their count; else (after offsets) their values and rows.
template <typename T, bool COUNT>
IHD void list_cols(List<T> rl, int m, List<T> cl, int n, int tid,
                   int nthr) {
  const int nz = rl.ptr[m];
  for (int k = tid; k < n; k += nthr) {
    if (COUNT) {
      int c = 0;
      for (int e = 0; e < nz; ++e) c += rl.idx[e] == k;
      cl.ptr[k + 1] = c;
    } else {
      int at = cl.ptr[k], r = 0, rend = rl.ptr[1];
      for (int e = 0; e < nz; ++e) {
        while (e == rend) rend = rl.ptr[++r + 1];
        if (rl.idx[e] == k) {
          cl.val[at] = rl.val[e];
          cl.idx[at] = r;
          ++at;
        }
      }
    }
  }
}

// row r of the list times v, in its order
template <typename T>
BHD T list_dot(const List<T>& l, int r, const T* v) {
  T s = T(0);
  for (int e = l.ptr[r]; e < l.ptr[r + 1]; ++e) s += l.val[e] * v[l.idx[e]];
  return s;
}

// row r of the list times (u * w) (u may be null), in its order
template <typename T>
BHD T list_wdot(const List<T>& l, int r, const T* w, const T* u) {
  T s = T(0);
  if (u) {
    for (int e = l.ptr[r]; e < l.ptr[r + 1]; ++e) {
      const int i = l.idx[e];
      s += l.val[e] * (u[i] * w[i]);
    }
  } else {
    for (int e = l.ptr[r]; e < l.ptr[r + 1]; ++e)
      s += l.val[e] * w[l.idx[e]];
  }
  return s;
}

// the entry (r, c) of the listed matrix: its value, +0 where the list has
// none (a search of row r)
template <typename T>
BHD T list_at(const List<T>& l, int r, int c) {
  int lo = l.ptr[r], hi = l.ptr[r + 1];
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int k = l.idx[mid];
    if (k == c) return l.val[mid];
    if (k < c)
      lo = mid + 1;
    else
      hi = mid;
  }
  return T(0);
}

// whether u_i w_i (u null: w_i) is finite for every i < len; on the card
// the members of a warp that call it together share the scan of a long
// vector, and each scans a short one (up to 64 entries) alone
template <typename T>
BHD bool finite_all(const T* w, const T* u, int len) {
#ifdef __CUDA_ARCH__
  if (len > 64) {
    const unsigned mask = __activemask();
    const int rank = __popc(mask & ((1u << (threadIdx.x & 31)) - 1u));
    const int cnt = __popc(mask);
    bool bad = false;
    for (int i = rank; i < len; i += cnt)
      bad |= !finite(u ? u[i] * w[i] : w[i]);
    return !__any_sync(mask, bad);
  }
#endif
  bool bad = false;
  for (int i = 0; i < len; ++i) bad |= !finite(u ? u[i] * w[i] : w[i]);
  return !bad;
}

// (r, c) of entry e of a packed lower triangle by rows
BHD void unpack(long e, int& r, int& c) {
  int i = (int)((sqrtf(8.0f * (float)e + 1.0f) - 1.0f) * 0.5f);
  while (i > 0 && (long)i * (i + 1) / 2 > e) --i;
  while ((long)(i + 1) * (i + 2) / 2 <= e) ++i;
  r = i;
  c = (int)(e - (long)i * (i + 1) / 2);
}

// the index of (i, k), k <= i, in the packed lower triangle
BHD long pk(int i, int k) { return (long)i * (i + 1) / 2 + k; }

// ---- the block route: K2 / K3's device functions at the run-time b ----

// the factor on the first warp: its fast paths, or (EXACT, the fallback)
// the same with the exact operators
template <typename T, int BS, int WT, bool EXACT>
K11_NOINLINE bool factor_b(T* D, T* O, int nb, T tiny, int tid) {
  return banded::btd_factor_warp<T, BS, WT, EXACT>(D, O, nb, tiny, tid);
}

// the couplings on the whole team
template <typename T, int BS>
K11_NOINLINE void couple_b(const T* D, T* O, T* V, int nb, int tid,
                           int nthr) {
  ipm::btd_couple_team<T, BS>(D, O, V, nb, tid, nthr);
}

// K x = r on the whole team
template <typename T, int BS, int WT>
K11_NOINLINE void solve_b(const T* D, const T* O, const T* V, T* w,
                          const T* r, T* x, int nb, int tid, int nthr) {
  ipm::btd_solve_team<T, BS, WT>(D, O, V, w, r, x, nb, tid, nthr);
}

// The block route's factor, couplings and solves at run-time block size
// b, for every b in LO..HI (the launcher refuses another)
template <typename T, int WT, int LO, int HI>
struct Blocks {
  static BHD bool factor(int b, T* D, T* O, int nb, T tiny, int tid,
                         bool exact) {
    if constexpr (LO > HI) {
      return false;
    } else {
      if (b == LO)
        return exact ? factor_b<T, LO, WT, true>(D, O, nb, tiny, tid)
                     : factor_b<T, LO, WT, false>(D, O, nb, tiny, tid);
      return Blocks<T, WT, LO + 1, HI>::factor(b, D, O, nb, tiny, tid, exact);
    }
  }
  static BHD void couple(int b, const T* D, T* O, T* V, int nb, int tid,
                         int nthr) {
    if constexpr (LO <= HI) {
      if (b == LO) return couple_b<T, LO>(D, O, V, nb, tid, nthr);
      Blocks<T, WT, LO + 1, HI>::couple(b, D, O, V, nb, tid, nthr);
    }
  }
  static BHD void solve(int b, const T* D, const T* O, const T* V, T* w,
                        const T* r, T* x, int nb, int tid, int nthr) {
    if constexpr (LO <= HI) {
      if (b == LO) return solve_b<T, LO, WT>(D, O, V, w, r, x, nb, tid, nthr);
      Blocks<T, WT, LO + 1, HI>::solve(b, D, O, V, w, r, x, nb, tid, nthr);
    }
  }
};

// K11's lane: the loop is K6's (ipm::Loop); the rows are dense (m, n)
// matrices (ipm::Rows with S the scaled rows and R the raw ones in device
// memory, no window tables) read through their lists, P likewise, and K is
// assembled and factored by the block route (nb > 0) or the dense route.
template <typename T, int WT, typename Blk, bool TIMED, bool LISTS>
struct Lane : ipm::Loop<T, WT, TIMED, Lane<T, WT, Blk, TIMED, LISTS>> {
  using B = ipm::Loop<T, WT, TIMED, Lane<T, WT, Blk, TIMED, LISTS>>;
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
  // shared memory (or the device scratch): the band's blocks (block route:
  // the factor's block inverses, M then W, V) and the solves' scratch
  // n-vector, the dense route's packed K and its pivots
  T *D, *O, *V, *w, *K, *ld;
  // device memory: P scaled and raw
  const T *P, *Pr;
  // the lists' table (LH ..): in shared memory on the card (LISTS: the
  // sums run over it; else in the dense order)
  const List<T>* ls;
  static constexpr bool lists = LISTS;

  // the dense order: row i of M (m, n) times v (also row k of P v); column
  // k of R.S' (u * w) (u may be null), the rows in order
  BHD T rdot(const T* M, int i, const T* v) const {
    return ipm::rowdot(M + (long)i * n, v, n);
  }
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
  // the passes over the lists, or the dense order where a vector (or a
  // product u_i w_i) is not finite
  BHD T row(const List<T>& l, const T* M, int i, const T* v) const {
    return lists && finite_all<T>(v, nullptr, n) ? list_dot(l, i, v)
                                                 : rdot(M, i, v);
  }
  BHD T col(const List<T>& l, const ipm::Rows<T>& R, const T* w,
            const T* u, int k) const {
    return lists && finite_all(w, u, R.m) ? list_wdot(l, k, w, u)
                                          : rcol(R, w, u, k);
  }
  BHD T hdot(int i, const T* v) const { return row(ls[LH], H.S, i, v); }
  BHD T adot(int i, const T* v) const { return row(ls[LA], A.S, i, v); }
  BHD T hraw(int i, const T* v) const { return row(ls[LRH], H.R, i, v); }
  BHD T araw(int i, const T* v) const { return row(ls[LRA], A.R, i, v); }
  BHD T hcol(const T* w, const T* u, int k) const {
    return col(ls[LHC], H, w, u, k);
  }
  BHD T acol(const T* w, const T* u, int k) const {
    return col(ls[LAC], A, w, u, k);
  }
  BHD T pmv(const T* v, int k) const { return row(ls[LP], P, k, v); }
  BHD T rpmv(const T* v, int k) const { return row(ls[LPR], Pr, k, v); }

  // whether row i's d_i and every listed entry times d_i are finite
  static BHD bool row_finite(const List<T>& l, const T* d, int i) {
    if (!finite(d[i])) return false;
    for (int e = l.ptr[i]; e < l.ptr[i + 1]; ++e)
      if (!finite(l.val[e] * d[i])) return false;
    return true;
  }
  // (J' diag(d) J)_(r, cc) over the rows that touch both columns, in row
  // order (a merge of the two columns' lists c)
  static BHD T merge(const List<T>& c, const T* d, int r, int cc) {
    int a = c.ptr[r], bb = c.ptr[cc];
    const int ea = c.ptr[r + 1], eb = c.ptr[cc + 1];
    T s = T(0);
    // no common row where the two row ranges do not meet
    if (a == ea || bb == eb || c.idx[ea - 1] < c.idx[bb] ||
        c.idx[eb - 1] < c.idx[a])
      return s;
    while (a < ea && bb < eb) {
      const int ia = c.idx[a], ib = c.idx[bb];
      if (ia == ib) {
        s += (c.val[a] * d[ia]) * c.val[bb];
        ++a;
        ++bb;
      } else if (ia < ib) {
        ++a;
      } else {
        ++bb;
      }
    }
    return s;
  }
  // the same over every row, in the dense order
  BHD T dsum(const ipm::Rows<T>& R, const T* d, int r, int cc) const {
    T s = T(0);
    for (int i = 0; i < R.m; ++i) {
      const T* Ji = R.S + (long)i * n;
      s += (Ji[r] * d[i]) * Ji[cc];
    }
    return s;
  }

  // Entry (r, c) of the symmetrized K: 0.5 (P + P') + Dbox, then Jh' Dh
  // Jh's and Ja' Da Ja's sums over the rows in order (dh, dA: the kind's
  // sum in the dense order).  P's entries come from its lists, +0 where
  // they hold none: a -0 there would give another zero's sign to the P
  // part, which the sum (never -0) then added makes +0 alike.
  BHD T ksym(int r, int cc, bool dh, bool dA) const {
    T v = lists ? T(0.5) * (list_at(ls[LP], r, cc) + list_at(ls[LP], cc, r))
                : T(0.5) * (P[(long)r * n + cc] + P[(long)cc * n + r]);
    if (r == cc) v = v + dbox[r];
    v = v + (dh ? dsum(H, dhd(), r, cc) : merge(ls[LHC], dhd(), r, cc));
    return v + (dA ? dsum(A, da(), r, cc) : merge(ls[LAC], da(), r, cc));
  }

  // K + reg I: the block route's band (D's lower triangles, O) or the
  // dense route's packed lower triangle, entry by entry over the team; a
  // row kind's sums take the dense order this iteration where row_finite
  // fails on one of its rows
  IHD void assemble() {
    T fl[2] = {T(1), T(1)};
    if (lists) {
      fl[0] = fl[1] = T(0);
      for (int i = tid; i < H.m; i += nthr)
        if (!row_finite(ls[LH], dhd(), i)) fl[0] = T(1);
      for (int i = tid; i < A.m; i += nthr)
        if (!row_finite(ls[LA], da(), i)) fl[1] = T(1);
      team_reduce<T, 0, 2>(red, nullptr, fl, tid, nthr);
    }
    const bool dh = fl[0] != T(0), dA = fl[1] != T(0);
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
        const T v = ksym(r, cc, dh, dA);
        (isD ? D : O)[ee] = v;
        if (isD && i == j) dm[0] = nmax(dm[0], v);
      }
    } else {
      int r, cc;
      unpack(tid, r, cc);
      for (long e = tid; e < (long)n * (n + 1) / 2; e += nthr) {
        const T v = ksym(r, cc, dh, dA);
        K[e] = v;
        if (r == cc) dm[0] = nmax(dm[0], v);
        for (cc += nthr; cc > r; ++r) cc -= r + 1;
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
        T* Kk = K + pk(k, k);
        *Kk = *Kk + reg;
      }
    }
    sync();
  }

  // the block route: K2's steps on the first warp at the run-time b, then
  // the couplings on the whole team
  BHD bool team_factor() const { return nb == 0; }
  BHD bool factor_warp(bool exact) {
    return Blk::factor(b, D, O, nb, chol_tiny(), tid, exact);
  }
  BHD void couple() { Blk::couple(b, D, O, V, nb, tid, nthr); }

  // the first row at or after s that this member owns (row i: member i %
  // nthr)
  BHD int row0(int s) const { return s + ((tid - s % nthr) + nthr) % nthr; }

  // The trailing triangle's updates by the panel's columns j0 .. je - 1:
  // TILE x TILE entries a member, held in registers while each takes
  // K[i][c] - l_ij * l_cj for j in order
  IHD void trailing(int j0, int je) {
    const int nt = (n - je + TILE - 1) / TILE;
    const long ntiles = (long)nt * (nt + 1) / 2;
    for (long t = tid; t < ntiles; t += nthr) {
      int ti, tc;
      unpack(t, ti, tc);
      const int i0 = je + ti * TILE, c0 = je + tc * TILE;
      T acc[TILE][TILE];
#pragma unroll
      for (int a = 0; a < TILE; ++a)
#pragma unroll
        for (int c = 0; c < TILE; ++c)
          acc[a][c] = (i0 + a < n && c0 + c <= i0 + a)
                          ? K[pk(i0 + a, c0 + c)]
                          : T(0);
      for (int j = j0; j < je; ++j) {
        T li[TILE], lc[TILE];
#pragma unroll
        for (int a = 0; a < TILE; ++a) {
          li[a] = i0 + a < n ? K[pk(i0 + a, j)] : T(0);
          lc[a] = c0 + a < n ? K[pk(c0 + a, j)] : T(0);
        }
#pragma unroll
        for (int a = 0; a < TILE; ++a)
#pragma unroll
          for (int c = 0; c < TILE; ++c)
            acc[a][c] = acc[a][c] - li[a] * lc[c];
      }
#pragma unroll
      for (int a = 0; a < TILE; ++a)
#pragma unroll
        for (int c = 0; c < TILE; ++c)
          if (i0 + a < n && c0 + c <= i0 + a)
            K[pk(i0 + a, c0 + c)] = acc[a][c];
    }
  }

  // The dense route's Cholesky of the packed K in place (the pivots in
  // ld), blocked: for each panel of PANEL columns, a column k at a time,
  // the owner of row k forms its pivot from K[k][k] after the panel's
  // earlier columns' updates, and after one barrier every row below takes
  // those updates of its entry in column order and scales it by the
  // pivot; then the trailing triangle takes the panel's updates
  // (trailing).  Each entry meets the right-looking factor's sequence:
  // K[i][c] - l_ij l_cj for j = 0, 1, ... in order, then its scaling.  A
  // pivot that is not positive (or NaN) stops it (every member reads
  // ld[k]) and sets sc[2].  The timed build adds the panels' and the
  // trailing updates' cycles to their slots.
  IHD void factor_team() {
    bool broke = false;
#ifdef __CUDA_ARCH__
    long long t0 = TIMED && tid == 0 ? clock64() : 0;
#endif
    for (int j0 = 0; j0 < n && !broke; j0 += PANEL) {
      const int je = j0 + PANEL < n ? j0 + PANEL : n;
      for (int k = j0; k < je; ++k) {
        const T* Lk = K + pk(k, 0);
        if (tid == k % nthr) {
          T d = Lk[k];
          for (int j = j0; j < k; ++j) d = d - Lk[j] * Lk[j];
          ld[k] = d > T(0) ? qm::qsqrt(d) : T(0);
        }
        sync();
        const T lkk = ld[k];
        if (!(lkk > T(0))) {
          broke = true;
          break;
        }
        for (int i = row0(k + 1); i < n; i += nthr) {
          T* Li = K + pk(i, 0);
          T t = Li[k];
          for (int j = j0; j < k; ++j) t = t - Li[j] * Lk[j];
          Li[k] = qdiv(t, lkk);
        }
      }
      if (broke) break;
      sync();
#ifdef __CUDA_ARCH__
      if (TIMED && tid == 0) {
        const long long t1 = clock64();
        this->clk[ipm::N_PHASES + 2] += t1 - t0;
        t0 = t1;
      }
#endif
      trailing(j0, je);
      sync();
#ifdef __CUDA_ARCH__
      if (TIMED && tid == 0) {
        const long long t1 = clock64();
        this->clk[ipm::N_PHASES + 3] += t1 - t0;
        t0 = t1;
      }
#endif
    }
    if (tid == 0) sc[2] = broke ? T(1) : T(0);
    sync();
  }

  // K x = r, every member returning after the last barrier; x may not be
  // r.  The block route on the whole team (btd_solve_team).  The dense
  // route on the first WT members (the others wait at the barrier): L y =
  // r by rows (row i's dot product with y summed over the warp, y_i stored
  // by the member that reads it back), then L' x = y by columns (x_j
  // formed by its owner and broadcast, the owners of the rows above it
  // update theirs); NaN where the factor broke.
  BHD void solve(const T* r, T* x) const {
    if (nb > 0) {
      Blk::solve(b, D, O, V, w, r, x, nb, tid, nthr);
      return;
    }
    if (tid < WT) {
      if (sc[2] != T(0)) {
        for (int k = tid; k < n; k += WT) x[k] = T(NAN);
      } else {
        for (int i = 0; i < n; ++i) {
          const T* Li = K + pk(i, 0);
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
          const T* Lj = K + pk(j, 0);
          for (int i = tid; i < j; i += WT) x[i] = x[i] - Lj[i] * xj;
        }
      }
    }
    sync();
  }
};

// Lane `lane`'s lists of nonzeros (in the regions lists and raw) and
// their table tab, before its loop (so that the loop's state is not yet
// live): the counts of the lists by rows, their offsets (a warp per
// list), their entries; then the lists by columns from them likewise.
template <typename T, int WT, bool ALL>
IHD void build_lists(const Args& a, int lane, T* lists, T* raw, List<T>* tab,
                     int tid, int nthr) {
  const int n = a.n, mh = a.mh, ma = a.ma;
  const long nn2 = (long)n * n;
  List<T> lt[N_LISTS];
  T* at = carve(lists, mh, a.nz_h, lt[LH]);
  at = carve(at, n, a.nz_h, lt[LHC]);
  at = carve(at, ma, a.nz_a, lt[LA]);
  at = carve(at, n, a.nz_a, lt[LAC]);
  carve(at, n, a.nz_p, lt[LP]);
  at = carve(raw, mh, a.nz_rh, lt[LRH]);
  at = carve(at, ma, a.nz_ra, lt[LRA]);
  carve(at, n, a.nz_pr, lt[LPR]);
  if (tid == 0) {
#pragma unroll
    for (int q = 0; q < N_LISTS; ++q) tab[q] = lt[q];
  }
  const T* src[6] = {(const T*)a.Jh + (long)lane * mh * n,
                     (const T*)a.Ja + (long)lane * ma * n,
                     (const T*)a.P + (long)lane * nn2,
                     (const T*)a.Rh + (long)lane * mh * n,
                     (const T*)a.Ra + (long)lane * ma * n,
                     (const T*)a.Pr + (long)lane * nn2};
  const int rows[6] = {mh, ma, n, mh, ma, n};
#pragma unroll
  for (int q = 0; q < 6; ++q)
    list_rows<T, ALL, true>(src[q], rows[q], n, lt[q], tid, nthr);
  TEAM_SYNC();
#pragma unroll
  for (int q = 0; q < 6; ++q)
    if (WT == 1 || tid / 32 == q) offsets(lt[q].ptr, rows[q], tid % 32);
  TEAM_SYNC();
#pragma unroll
  for (int q = 0; q < 6; ++q)
    list_rows<T, ALL, false>(src[q], rows[q], n, lt[q], tid, nthr);
  TEAM_SYNC();
  list_cols<T, true>(lt[LH], mh, lt[LHC], n, tid, nthr);
  list_cols<T, true>(lt[LA], ma, lt[LAC], n, tid, nthr);
  TEAM_SYNC();
  if (WT == 1 || tid < 32) offsets(lt[LHC].ptr, n, tid % 32);
  if (WT == 1 || (tid >= 32 && tid < 64)) offsets(lt[LAC].ptr, n, tid % 32);
  TEAM_SYNC();
  list_cols<T, false>(lt[LH], mh, lt[LHC], n, tid, nthr);
  list_cols<T, false>(lt[LA], ma, lt[LAC], n, tid, nthr);
  TEAM_SYNC();
}

// One row kind of lane `lane`: its slices of the arguments, its scaled
// rows at S and its scratch at scr (12 m).
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
// out by smem_layout as Args' flags ask) and the team (tid of nthr): its
// lists, then its whole loop.  Blk: the block route's factor and solves;
// TIMED: the phase timer (Args::clk); LISTS: the sums over the lists
// (Args::lists; else the dense order, no lists built); ALL: lists that
// hold every entry,
// zeros too (the host build's check that leaving the zeros out changes
// nothing).
template <typename T, int WT, typename Blk, bool TIMED, bool LISTS,
          bool ALL = false>
IHD void ipm_dense_lane(const Args& a, int lane, T* sm, int tid, int nthr) {
  Lane<T, WT, Blk, TIMED, LISTS> L;
#ifdef __CUDA_ARCH__
  const long long t_setup = TIMED ? clock64() : 0;
#endif
  const int n = a.n, b = a.b, nb = a.nb, mh = a.mh, ma = a.ma;
  const long nl = (long)lane * n;
  const Layout lay = smem_layout<T>(a, a.smem_k != 0, a.smem_lists != 0,
                                    a.smem_base != 0, a.smem_scr != 0,
                                    a.smem_raw != 0);
  // the device scratch, in scratch_size's order
  T* ds = (T*)a.dscr + (long)lane * scratch_size<T>(a);
  T* ds_lists = ds + k_size(n, nb);
  T* ds_base = ds_lists + lists_size<T>(a);
  T* ds_scr = ds_base + base_size(n, b, nb);
  T* ds_raw = ds_scr + scr_size(mh, ma);
  T* kreg = a.smem_k ? sm + lay.o_k : ds;
  T* lists = a.smem_lists ? sm + lay.o_lists : ds_lists;
  T* base = a.smem_base ? sm + lay.o_base : ds_base;
  T* scr = a.smem_scr ? sm + lay.o_scr : ds_scr;
  T* raw = a.smem_raw ? sm + lay.o_raw : ds_raw;
  if (LISTS)
    build_lists<T, WT, ALL>(a, lane, lists, raw,
                            reinterpret_cast<List<T>*>(sm + lay.o_tab), tid,
                            nthr);
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
  L.V = L.O + (nb > 0 ? (long)(nb - 1) * b * b : 0);
  L.w = L.V + (nb > 0 ? (long)(nb - 1) * b * b : 0);
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
  L.ld = v + 17L * n;
  const long nn2 = (long)n * n;
  L.P = (const T*)a.P + (long)lane * nn2;
  L.Pr = (const T*)a.Pr + (long)lane * nn2;
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
  const T* Jh = (const T*)a.Jh + (long)lane * mh * n;
  const T* Ja = (const T*)a.Ja + (long)lane * ma * n;
  L.H = lane_rows<T>(mh, n, lane, Jh, a.Rh, a.eh, a.wh, a.ehr, a.whr, scr);
  L.A = lane_rows<T>(ma, n, lane, Ja, a.Ra, a.ea, a.wa, a.ear, a.war,
                     scr + (long)N_SCR_VEC * mh);
  L.h = (T*)a.h + (long)lane * mh;
  L.z1 = (T*)a.z1 + (long)lane * mh;
  L.p = (T*)a.p + (long)lane * ma;
  L.nn = (T*)a.nn + (long)lane * ma;
  L.y = (T*)a.y + (long)lane * ma;
  L.ls = reinterpret_cast<const List<T>*>(sm + lay.o_tab);
  L.clk = TIMED ? a.clk + (long)lane * CLK_SLOTS : nullptr;
  L.t_last = 0;
#ifdef __CUDA_ARCH__
  if (TIMED && tid == 0) L.clk[ipm::N_PHASES + 1] += clock64() - t_setup;
#endif
  L.run(a.it + lane, a.status + lane, (T*)a.rp + lane, (T*)a.rd + lane,
        (T*)a.fb + lane);
}

}  // namespace ipm_dense
