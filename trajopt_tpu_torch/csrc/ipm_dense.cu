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
// Design: 256 threads per CTA (8 warps), one CTA per SM.  Before its
// loop each lane lists the nonzeros of its rows and of P (ipm_dense.cuh:
// by rows a warp per four rows with ballots, by columns from those),
// and every pass of the loop runs over the lists: row passes (Jh v, Ja v,
// the slack and dual updates) a thread per row, column passes (Jh' w, Ja'
// w, P v, the box terms) a thread per column; the assembly forms each
// entry of K's band (block route) or packed lower triangle (dense route)
// from P's lists and a merge of its two columns' row lists.  The loop is
// K6's (ipm::Loop): the block Cholesky runs on warp 0 (banded.cuh's
// block-inverse form at the run-time b: a non-inlined instantiation per b
// of the library's range) while the other warps form the residuals and
// the predictor's right-hand side, then the whole CTA forms its
// couplings; each of the four block solves per iteration is two passes of
// the CTA and two division-free sweeps on warp 0; the dense Cholesky runs
// on the whole CTA by panels of eight columns (one barrier a column, the
// trailing updates in 4 x 4 register tiles), its triangular solves on
// warp 0.  A QP of at
// most 32 columns keeps the dense order (no lists; its own library,
// -DK11_LISTS=0, at b 1-9 and the dense route).
// The shared-memory plan (ipm_dense::smem_layout) keeps the packed K, the
// lists, the n-vectors and the band, the scratch m-vectors and the raw
// lists in shared memory where they fit, in that order, and the rest in
// the device scratch; no size is refused.  Built with -fmad=false, as the
// plain version computes every multiply and add apart.
//
// Bound on the H100 (chip_smoke's k11_work): the least arithmetic of the
// iterations the lanes take over these inputs' nonzeros (the rows' and
// P's passes, the assembly's share of J' D J, the factor and solves),
// against each input read once: the dense inputs' bytes bound the block
// route, the dense route's n^3 / 3 factor operations bind it.  The
// kernel's own limits are latency: K2's factor chain and K3's sweeps on
// one warp (block route; no tensor cores: the products are small and a
// float32 mma would round through TF32), the factor's column steps and the solves' row chains on one
// warp (dense route), at 255 registers a thread.

#include <cuda_runtime.h>

#include "ipm_dense.cuh"

// One library per (dtype, block-size range): -DK11_F64 (0 float32, 1
// float64) and the range K11_LO..K11_HI of the block route, given by
// _native.K11_GROUPS; -DK11_TIMED=1 builds the phase timer's library
// (ipm_dense::Args::clk; float32, b 1-9 and the dense route: the one
// scripts/ipm_ab.py --k11 --phases reads, apart from the solver's).
#if !defined(K11_F64) || !defined(K11_LO) || !defined(K11_HI)
#error "build with -DK11_F64=0|1 -DK11_LO=<b> -DK11_HI=<b>"
#endif
#ifndef K11_TIMED
#define K11_TIMED 0
#endif
// -DK11_LISTS=0: the kernel that keeps the dense order (Args::lists 0; a
// library of its own, so that each nvcc builds one kernel)
#ifndef K11_LISTS
#define K11_LISTS 1
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
                            ipm_dense::Blocks<K11T, 32, K11_LO, K11_HI>,
                            K11_TIMED != 0, K11_LISTS != 0>(
      a, blockIdx.x, reinterpret_cast<K11T*>(smem_raw), threadIdx.x,
      THREADS);
}

// the shared-memory plan: the regions (K, lists, base, scratch, raw
// lists) in shared memory by priority, the first combination that fits
// (the last, none of them, always does); written back into *a; the bytes
static long plan_smem(ipm_dense::Args* a) {
  for (int mask = 31;; --mask) {
    const bool kin = mask & 16, lists = mask & 8, base = mask & 4,
               scr = mask & 2, raw = mask & 1;
    const long bytes =
        ipm_dense::smem_layout<K11T>(*a, kin, lists, base, scr, raw).total *
        (long)sizeof(K11T);
    if (bytes <= (long)MAX_SMEM || mask == 0) {
      a->smem_k = kin;
      a->smem_lists = lists;
      a->smem_base = base;
      a->smem_scr = scr;
      a->smem_raw = raw;
      return bytes;
    }
  }
}

// -1: a block route at a block size outside K11_LO..K11_HI; -2: a timer
// given to the untimed library or none to the timed one; -3: Args::lists
// other than the library's
extern "C" int ipm_dense_run(ipm_dense::Args* a, void* stream) {
  if (a->nb > 0 && (a->b < K11_LO || a->b > K11_HI)) return -1;
  if ((K11_TIMED != 0) != (a->clk != nullptr)) return -2;
  if ((K11_LISTS != 0) != (a->lists != 0)) return -3;
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
