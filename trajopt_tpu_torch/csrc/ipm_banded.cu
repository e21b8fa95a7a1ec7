// K6 ipm_banded: the banded interior-point QP solver's whole Mehrotra loop,
// one CTA per lane, from the initial interior point to termination.
//
// Replaces trajopt_tpu/ops/ipm_qp.py:92 solve_ipm_qp's banded loop (body
// :373-511, cond :513-514, while_loop :516-520, make_kkt_solve :321-371),
// which the plain PyTorch port runs as ~1,200 small launches per batched
// IPM iteration and one host sync after each.  Here one launch runs every
// lane's loop; a lane leaves it when its own status is set or it reaches
// max_iter.  The per-lane body, with K1-K3's math as device functions, is
// ipm.cuh; this file is its launcher with a plain C interface (ctypes).
//
// Design: 256 threads per CTA (8 warps).  Row passes (the banded matvecs,
// the slack and dual updates) and column passes (A' w by column, P v, the
// box terms) are strided over all 256; the block Cholesky and the four
// block-bidiagonal solves per iteration run on warp 0 with banded.cuh's
// warp-synchronous b-steps while the other warps wait at the barrier.
// D, O and the n-vectors sit in dynamic shared memory (at b=7, T=30 in
// float64 55,272 bytes), the rows and m-vectors in device memory (at the
// flagship's 1,624 hinge rows and 128 lanes, ~12 MB of scaled plus raw
// rows in float32, held in the 50 MB L2).  Built with -fmad=false, as the
// plain version computes every multiply and add apart.
//
// Bound on the H100 (chip_smoke's k6_work): the bytes the function must
// move, each input read once (~0.26 MB per lane at the flagship's shape in
// float32), take less time than its least arithmetic (~1.1e6 flops per IPM
// iteration and lane, mostly the rows' passes and their share of the
// symmetric assembly), so operations bound it.  The kernel's own limit is
// neither: it re-reads the rows from L2 ~10 times per iteration, and per
// iteration the factor and four solves are sequential over T block steps
// of b dependent pivots each, on one warp.

#include <cuda_runtime.h>

#include "ipm.cuh"

constexpr int THREADS = 256;
constexpr size_t MAX_SMEM = 232448;  // the H100's per-block limit

template <typename T, int BS>
__global__ void __launch_bounds__(THREADS) ipm_banded_kernel(ipm::Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ipm::ipm_lane<T, BS, 32>(a, blockIdx.x, reinterpret_cast<T*>(smem_raw),
                           threadIdx.x, THREADS);
}

template <typename T, int BS>
static int launch_bs(const ipm::Args& a, cudaStream_t s) {
  const size_t bytes = ipm::smem_elems(a.n, BS, a.nb) * sizeof(T);
  if (bytes > MAX_SMEM) return -1;
  cudaError_t e = cudaFuncSetAttribute(
      ipm_banded_kernel<T, BS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  ipm_banded_kernel<T, BS><<<a.lanes, THREADS, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const ipm::Args* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (a->b) {
    case 7:
      return launch_bs<T, 7>(*a, s);
    case 14:
      return launch_bs<T, 14>(*a, s);
    case 21:
      return launch_bs<T, 21>(*a, s);
    default:
      return -1;
  }
}

extern "C" int ipm_banded_f32(const ipm::Args* a, void* stream) {
  return launch<float>(a, stream);
}

extern "C" int ipm_banded_f64(const ipm::Args* a, void* stream) {
  return launch<double>(a, stream);
}
