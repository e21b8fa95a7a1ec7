// K11 ipm_dense: the dense-row interior-point QP solver's whole Mehrotra
// loop, one CTA per lane, from the initial interior point to termination.
//
// Replaces trajopt_tpu/ops/ipm_qp.py:92 solve_ipm_qp's dense-row branch
// (:108, :156-187, :344-371, the loop :373-520), which the plain PyTorch
// port runs as ~860 small launches per batched IPM iteration and one host
// sync after each.  Here one launch runs every lane's loop; a lane leaves
// it when its own status is set or it reaches max_iter.  The per-lane body
// is ipm_dense.cuh (its block route through K2 / K3's device functions of
// banded.cuh); this file is its launcher, with a plain C interface
// (ctypes), built once per dtype and range of block sizes
// (_native.K11_GROUPS; every library also runs the dense route).
//
// Design: 256 threads per CTA (8 warps), one CTA per SM.  Row passes (Jh v,
// Ja v, the slack and dual updates) take a thread per row, column passes
// (Jh' w, Ja' w, P v from P', the box terms) a thread per column; the
// assembly forms each entry of K's band (block route) or lower triangle
// (dense route) over the rows in order.  The loop is K6's (ipm::Loop):
// the block Cholesky runs on warp 0 (banded.cuh's warp forms at the
// run-time b: a non-inlined instantiation per b of the library's range)
// while the other warps form the residuals and the predictor's
// right-hand side, and the four block solves per iteration on warp 0
// while the others wait; the dense Cholesky runs on the whole CTA, its
// triangular solves on warp 0.  The shared-memory plan
// (ipm_dense::smem_layout) keeps the n-vectors and the band, the scaled
// rows, the dense K and the scratch m-vectors in shared memory where they
// fit, in that order, and the rest in the device scratch; no size is
// refused.  Built with -fmad=false, as the plain version computes every
// multiply and add apart.
//
// Bound on the H100 (chip_smoke's k11_work): the least arithmetic of the
// iterations the lanes take (the rows' passes and the assembly's share of
// J' D J), against each input read once; operations bound it.

#include <cuda_runtime.h>

#include "ipm_dense.cuh"

// One library per (dtype, block-size range): -DK11_F64 (0 float32, 1
// float64) and the range K11_LO..K11_HI of the block route, given by
// _native.K11_GROUPS.
#if !defined(K11_F64) || !defined(K11_LO) || !defined(K11_HI)
#error "build with -DK11_F64=0|1 -DK11_LO=<b> -DK11_HI=<b>"
#endif
using K11T = std::conditional_t<K11_F64, double, float>;
static_assert(1 <= K11_LO && K11_LO <= K11_HI && K11_HI <= banded::BLOCK_MAX,
              "K11's block sizes lie in 1..BLOCK_MAX");

constexpr int THREADS = 256;
constexpr size_t MAX_SMEM = 232448;  // the H100's per-block limit

__global__ void __launch_bounds__(THREADS, 1)
    ipm_dense_kernel(ipm_dense::Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ipm_dense::ipm_dense_lane<K11T, 32,
                            ipm_dense::Blocks<K11T, 32, K11_LO, K11_HI>>(
      a, blockIdx.x, reinterpret_cast<K11T*>(smem_raw), threadIdx.x,
      THREADS);
}

// the shared-memory plan: the regions (base, rows, K, scratch) in shared
// memory by priority, the first combination that fits (the last, none of
// them, always does); written back into *a; the bytes
static long plan_smem(ipm_dense::Args* a) {
  for (int mask = 15;; --mask) {
    const bool base = mask & 8, rows = mask & 4, kin = mask & 2,
               scr = mask & 1;
    const long bytes = ipm_dense::smem_layout(a->n, a->b, a->nb, a->mh,
                                              a->ma, base, rows, kin, scr)
                           .total *
                       (long)sizeof(K11T);
    if (bytes <= (long)MAX_SMEM || mask == 0) {
      a->smem_base = base;
      a->smem_rows = rows;
      a->smem_k = kin;
      a->smem_scr = scr;
      return bytes;
    }
  }
}

// -1: a block route at a block size outside K11_LO..K11_HI
extern "C" int ipm_dense_run(ipm_dense::Args* a, void* stream) {
  if (a->nb > 0 && (a->b < K11_LO || a->b > K11_HI)) return -1;
  const long bytes = plan_smem(a);
  cudaError_t e = cudaFuncSetAttribute(
      ipm_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  ipm_dense_kernel<<<a->lanes, THREADS, bytes, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// the kernel's registers and local memory (cudaFuncGetAttributes): out =
// [numRegs, localSizeBytes, maxThreadsPerBlock, sharedSizeBytes]
extern "C" int ipm_dense_attrs(int* out) {
  cudaFuncAttributes f;
  const cudaError_t e = cudaFuncGetAttributes(&f, ipm_dense_kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = f.numRegs;
  out[1] = (int)f.localSizeBytes;
  out[2] = f.maxThreadsPerBlock;
  out[3] = (int)f.sharedSizeBytes;
  return 0;
}
