// Host build of K6 ipm_banded's device code (ipm.cuh, banded.cuh) and of
// K11 ipm_dense's (ipm_dense.cuh), for checking their arithmetic on a CPU
// against the plain PyTorch loop and the JAX reference without a card.
//
// The same entry points as ipm_banded.cu's and ipm_dense.cu's float32 and
// float64 builds (same arguments, same outputs), at every block size they
// cover, run serially: each lane's whole IPM loop by a team of one thread,
// with an empty barrier, one lane after another.  The shared memory is a
// host array laid out as the Args' smem flags ask (every path of the
// card's plan runs here).  Compiled with a C++ compiler by
// _native.host_library; it is not on any path that solves a problem.

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
// (1..BLOCK_MAX; -1 for another)
template <typename T>
static int run_dense(const ipm_dense::Args* a) {
  if (a->nb > 0 && (a->b < 1 || a->b > banded::BLOCK_MAX)) return -1;
  std::vector<T> smem(ipm_dense::smem_layout(
                          a->n, a->b, a->nb, a->mh, a->ma, a->smem_base != 0,
                          a->smem_rows != 0, a->smem_k != 0,
                          a->smem_scr != 0)
                          .total);
  for (int lane = 0; lane < a->lanes; ++lane)
    ipm_dense::ipm_dense_lane<
        T, 1, ipm_dense::Blocks<T, 1, 1, banded::BLOCK_MAX>>(
        *a, lane, smem.data(), 0, 1);
  return 0;
}

extern "C" int ipm_dense_f32(ipm_dense::Args* a, void*) {
  return run_dense<float>(a);
}

extern "C" int ipm_dense_f64(ipm_dense::Args* a, void*) {
  return run_dense<double>(a);
}
