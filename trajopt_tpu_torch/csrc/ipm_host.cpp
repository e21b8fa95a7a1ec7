// Host build of K6 ipm_banded's device code (ipm.cuh, banded.cuh) and of
// K11 ipm_dense's (ipm_dense.cuh), for checking their arithmetic on a CPU
// against the plain PyTorch loop and the JAX reference without a card.
//
// The same entry points as ipm_banded.cu's and ipm_dense.cu's float32 and
// float64 builds (same arguments, same outputs), at every block size they
// cover, run serially: each lane's whole IPM loop by a team of one thread,
// with an empty barrier, one lane after another.  The shared memory is a
// host array laid out as the Args' smem flags ask (every path of the
// card's plan runs here).  Also K2 / K3's block-inverse form alone
// (btd_inverse_*: the factor, its couplings and solves as K6 and K11's
// block route run them) and K6's shared-memory layout (ipm_banded_layout),
// for the CPU tests.  Compiled with a C++ compiler by
// _native.host_library; it is not on any path that solves a problem.

#include <algorithm>
#include <vector>

#include "ipm.cuh"
#include "ipm_dense.cuh"

template <typename T, int BS>
static int run(const ipm::Args* a) {
  std::vector<T> smem(ipm::smem_layout(a->n, BS, a->nb, a->mh, a->ma,
                                       a->smem_rows != 0, a->smem_scr != 0)
                           .total);
  for (int lane = 0; lane < a->lanes; ++lane)
    ipm::ipm_lane<T, BS, 1, false>(*a, lane, smem.data(), 0, 1);
  return 0;
}

// every block size the card takes (1..BLOCK_MAX; -1 for another)
template <typename T>
static int dispatch(const ipm::Args* a) {
  return banded::with_block<1, banded::BLOCK_MAX>(
      a->b, [&](auto bs) { return run<T, decltype(bs)::value>(a); });
}

extern "C" int ipm_banded_f32(ipm::Args* a, void*) {
  return dispatch<float>(a);
}

extern "C" int ipm_banded_f64(ipm::Args* a, void*) {
  return dispatch<double>(a);
}

// K11: the dense route, and the block route at every b the card takes
// (1..BLOCK_MAX; -1 for another); ALL: lists that hold every entry, zeros
// too (the host's check that leaving the zeros out changes no output; the
// card's libraries have no such entry)
template <typename T, bool ALL>
static int run_dense(const ipm_dense::Args* a) {
  if (a->nb > 0 && (a->b < 1 || a->b > banded::BLOCK_MAX)) return -1;
  std::vector<T> smem(ipm_dense::smem_layout<T>(
                          *a, a->smem_k != 0, a->smem_lists != 0,
                          a->smem_base != 0, a->smem_scr != 0,
                          a->smem_raw != 0)
                          .total);
  using Blk = ipm_dense::Blocks<T, 1, 1, banded::BLOCK_MAX>;
  for (int lane = 0; lane < a->lanes; ++lane) {
    if (a->lists)
      ipm_dense::ipm_dense_lane<T, 1, Blk, false, true, ALL>(
          *a, lane, smem.data(), 0, 1);
    else
      ipm_dense::ipm_dense_lane<T, 1, Blk, false, false, ALL>(
          *a, lane, smem.data(), 0, 1);
  }
  return 0;
}

extern "C" int ipm_dense_f32(ipm_dense::Args* a, void*) {
  return run_dense<float, false>(a);
}

extern "C" int ipm_dense_f64(ipm_dense::Args* a, void*) {
  return run_dense<double, false>(a);
}

extern "C" int ipm_dense_all_f32(ipm_dense::Args* a, void*) {
  return run_dense<float, true>(a);
}

extern "C" int ipm_dense_all_f64(ipm_dense::Args* a, void*) {
  return run_dense<double, true>(a);
}

// the elements of each region per lane (K, lists, base, scratch, raw
// lists: ipm_dense.cuh's sizes, in the plan's order) into out[5], for the
// wrapper's mirror (ops.ipm_qp.k11_region_sizes) to be held against
template <typename T>
static int dense_sizes(const ipm_dense::Args* a, long* out) {
  out[0] = ipm_dense::k_size(a->n, a->nb);
  out[1] = ipm_dense::lists_size<T>(*a);
  out[2] = ipm_dense::base_size(a->n, a->b, a->nb);
  out[3] = ipm_dense::scr_size(a->mh, a->ma);
  out[4] = ipm_dense::raw_size<T>(*a);
  return 0;
}

extern "C" int ipm_dense_sizes_f32(ipm_dense::Args* a, long* out) {
  return dense_sizes<float>(a, out);
}

extern "C" int ipm_dense_sizes_f64(ipm_dense::Args* a, long* out) {
  return dense_sizes<double>(a, out);
}

// K2 / K3's block-inverse form alone (banded.cuh), as K6 and K11's block
// route run it, by a team of one thread: for each lane, D (nT, b, b) and
// O (nT - 1, b, b) of a block-tridiagonal K factored once (the fast
// paths; where they did not hold, the same with the exact operators, and
// fell[lane] = 1), the couplings formed, then K x = r for each of the
// nrhs right-hand sides R (nrhs, nT, b) into X; the factor's pivots
// floored at tiny.  -1 for a b outside 1..BLOCK_MAX.
template <typename T>
static int btd_inverse(const T* D, const T* O, const T* R, T* X, int* fell,
                       int lanes, int nT, int b, int nrhs, T tiny) {
  return banded::with_block<1, banded::BLOCK_MAX>(b, [&](auto bs) {
    constexpr int BS = decltype(bs)::value, BB = BS * BS;
    const long nD = (long)nT * BB, nO = (long)(nT - 1) * BB, n = nT * BS;
    std::vector<T> d(nD), o(nO), v(nO), w(n);
    for (int lane = 0; lane < lanes; ++lane) {
      const T* Dl = D + lane * nD;
      const T* Ol = O + lane * nO;
      bool ok = false;
      for (int exact = 0; exact < 2 && !ok; ++exact) {
        std::copy(Dl, Dl + nD, d.begin());
        std::copy(Ol, Ol + nO, o.begin());
        ok = exact ? banded::btd_factor_warp<T, BS, 1, true>(
                         d.data(), o.data(), nT, tiny, 0)
                   : banded::btd_factor_warp<T, BS, 1, false>(
                         d.data(), o.data(), nT, tiny, 0);
        fell[lane] = exact;
      }
      ipm::btd_couple_team<T, BS>(d.data(), o.data(), v.data(), nT, 0, 1);
      for (int k = 0; k < nrhs; ++k) {
        const long off = ((long)lane * nrhs + k) * n;
        ipm::btd_solve_team<T, BS, 1>(d.data(), o.data(), v.data(), w.data(),
                                      R + off, X + off, nT, 0, 1);
      }
    }
    return 0;
  });
}

extern "C" int btd_inverse_f32(const float* D, const float* O, const float* R,
                               float* X, int* fell, int lanes, int nT, int b,
                               int nrhs, float tiny) {
  return btd_inverse<float>(D, O, R, X, fell, lanes, nT, b, nrhs, tiny);
}

extern "C" int btd_inverse_f64(const double* D, const double* O,
                               const double* R, double* X, int* fell,
                               int lanes, int nT, int b, int nrhs,
                               double tiny) {
  return btd_inverse<double>(D, O, R, X, fell, lanes, nT, b, nrhs, tiny);
}

// K6's shared-memory layout (ipm::smem_layout) into out[10]: the offsets
// of O, V, w, the n-vectors, the reduction buffer, the scalars, the rows
// (hinge, abs) and the scratch, then the total, in elements; for the
// wrapper's mirror (ops.ipm_qp.k6_smem_plan) to be held against
extern "C" int ipm_banded_layout(int n, int b, int nb, int mh, int ma,
                                 int rows, int scr, long* out) {
  const ipm::Layout L = ipm::smem_layout(n, b, nb, mh, ma, rows != 0,
                                         scr != 0);
  const long v[10] = {L.o_O,  L.o_V,  L.o_w,  L.o_v,   L.o_red,
                      L.o_sc, L.o_Sh, L.o_Sa, L.o_scr, L.total};
  std::copy(v, v + 10, out);
  return 0;
}
