// K6 ipm_banded's launcher, shared by its two sources (ipm_banded.cu: the
// solver's kernels, ipm_timer.cu: float32 with the phase timer).
// ipm_banded.cu is built into several libraries, each one dtype and a
// range of block sizes (_native.K6_GROUPS), so that nvcc builds them in
// parallel.  The kernel, its design and its bound are described in
// ipm_banded.cu.
#pragma once

#include <cuda_runtime.h>

#include "ipm.cuh"

constexpr int THREADS = 256;
constexpr size_t MAX_SMEM = 232448;  // the H100's per-block limit

template <typename T, int BS, bool TIMED>
__global__ void __launch_bounds__(THREADS, 1) ipm_banded_kernel(ipm::Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ipm::ipm_lane<T, BS, 32, TIMED>(a, blockIdx.x,
                                  reinterpret_cast<T*>(smem_raw),
                                  threadIdx.x, THREADS);
}

// the shared-memory plan: the rows and the scratch in shared memory where
// both fit, else the one that fits (the rows first), else neither;
// written back into *a; the bytes (-1 when even the base does not fit)
template <typename T, int BS>
static long plan_smem(ipm::Args* a) {
  const int pref[4][2] = {{1, 1}, {1, 0}, {0, 1}, {0, 0}};
  for (const auto& p : pref) {
    const long bytes = ipm::smem_layout(a->n, BS, a->nb, a->mh, a->ma,
                                        p[0], p[1]).total * (long)sizeof(T);
    if (bytes <= (long)MAX_SMEM) {
      a->smem_rows = p[0];
      a->smem_scr = p[1];
      return bytes;
    }
  }
  return -1;
}

template <typename T, int BS, bool TIMED>
static int launch_bs(ipm::Args* a, cudaStream_t s) {
  const long bytes = plan_smem<T, BS>(a);
  if (bytes < 0) return -1;
  cudaError_t e = cudaFuncSetAttribute(
      ipm_banded_kernel<T, BS, TIMED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  ipm_banded_kernel<T, BS, TIMED><<<a->lanes, THREADS, bytes, s>>>(*a);
  return (int)cudaGetLastError();
}

// the C entry point of one (dtype, timer) instantiation set, the block
// sizes LO..HI (-1: a block size it is not instantiated for, or shared
// memory the card lacks)
template <typename T, bool TIMED, int LO, int HI>
static int launch(ipm::Args* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (TIMED != (a->clk != nullptr)) return -2;
  return banded::with_block<LO, HI>(a->b, [&](auto bs) {
    return launch_bs<T, decltype(bs)::value, TIMED>(a, s);
  });
}

// the registers and local memory of the instantiation at block size b
// (cudaFuncGetAttributes; -1: b outside LO..HI): out = [numRegs,
// localSizeBytes, maxThreadsPerBlock, sharedSizeBytes]
template <typename T, int LO, int HI>
static int attrs(int b, int* out) {
  return banded::with_block<LO, HI>(b, [&](auto bs) {
    cudaFuncAttributes f;
    const cudaError_t e = cudaFuncGetAttributes(
        &f, ipm_banded_kernel<T, decltype(bs)::value, false>);
    if (e != cudaSuccess) return (int)e;
    out[0] = f.numRegs;
    out[1] = (int)f.localSizeBytes;
    out[2] = f.maxThreadsPerBlock;
    out[3] = (int)f.sharedSizeBytes;
    return 0;
  });
}
