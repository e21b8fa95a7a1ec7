// Host build of K6 ipm_banded's device code (ipm.cuh, banded.cuh), for
// checking its arithmetic on a CPU against the plain PyTorch loop and the
// JAX reference without a card.
//
// The same entry points as ipm_banded.cu's float32 and float64 builds
// (same arguments, same outputs), at every block size they cover, run
// serially: each lane's whole IPM loop by a team of one thread, with an
// empty barrier, one lane after another.  The
// shared memory is a host array laid out as Args::smem_rows / smem_scr
// ask (both paths of the card's plan run here).  Compiled with a C++
// compiler by _native.host_library; it is not on any path that solves a
// problem.

#include <vector>

#include "ipm.cuh"

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
