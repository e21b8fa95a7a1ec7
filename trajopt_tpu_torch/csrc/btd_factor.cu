// K2 btd_factor: block Cholesky of a block-tridiagonal SPD matrix.
//
// Replaces trajopt_tpu/ops/btridiag.py:171-185 and 208-231 (_chol_s and
// btd_factor_scalar; the same math as btd_factor, :88-111):
//
//   L_0 = chol(D_0)
//   M_t = O_{t-1} L_{t-1}^{-T}                 (t = 1..T-1)
//   L_t = chol(D_t - M_t M_t^T)
//
// with each diagonal pivot floored at `tiny` (1e-18 float32, 1e-30
// float64) so a marginally indefinite block yields finite values that the
// IPM's NaN and descent guards catch.
//
// Layout: D (lanes, T, b, b), O (lanes, T-1, b, b) sub-diagonal blocks
// (O[t] = K[t+1, t]); outputs LD (lanes, T, b, b) lower factors with zeros
// above the diagonal, LM (lanes, T-1, b, b).  All contiguous.
//
// Design: one thread block of one warp per lane; the chain over T is a
// loop inside the block.  Thread i owns row i of the current b x b blocks
// (b <= BLOCK_MAX < 32), which sit in shared memory.  The column loop of each
// Cholesky is warp-synchronous; every sum runs in the JAX routine's order.
// The block steps are banded.cuh's (chol_block, offdiag_solve,
// schur_update), which K6 ipm_banded runs in place.
//
// Bound on the H100: it reads D and O once and writes LD and LM once
// (at b=7, T=30, 128 lanes, float32: ~3 MB, about 1 us at 3.35 TB/s) and
// does ~T (b^3/3 + 2 b^3) flops per lane (~7 MFLOP in all, far below
// 67 TFLOP/s).  The real limit is the dependency chain: T sequential
// block steps, each a chain of b dependent pivots.

#include "banded.cuh"

template <typename T, int BS>
__global__ void __launch_bounds__(32)
btd_factor_kernel(const T* __restrict__ D, const T* __restrict__ O,
                  T* __restrict__ LD, T* __restrict__ LM, int nT, T tiny) {
  using namespace banded;
  constexpr int BB = BS * BS;
  __shared__ T A[BB];   // block being factored
  __shared__ T Lp[BB];  // factor of the previous (then current) block
  __shared__ T M[BB];   // off-diagonal factor
  const int lane = blockIdx.x;
  const int i = threadIdx.x;
  const T* Dl = D + (long)lane * nT * BB;
  const T* Ol = O + (long)lane * (nT - 1) * BB;
  T* LDl = LD + (long)lane * nT * BB;
  T* LMl = LM + (long)lane * (nT - 1) * BB;

  for (int e = i; e < BB; e += 32) A[e] = Dl[e];
  __syncwarp();
  chol_block<T, BS, 32>(A, Lp, tiny, i);
  for (int e = i; e < BB; e += 32) LDl[e] = Lp[e];

  for (int t = 1; t < nT; ++t) {
    for (int e = i; e < BB; e += 32) M[e] = Ol[(long)(t - 1) * BB + e];
    __syncwarp();
    offdiag_solve<T, BS, 32>(Lp, M, i);
    __syncwarp();
    schur_update<T, BS, 32>(Dl + (long)t * BB, M, A, i);
    for (int e = i; e < BB; e += 32) LMl[(long)(t - 1) * BB + e] = M[e];
    __syncwarp();
    chol_block<T, BS, 32>(A, Lp, tiny, i);
    for (int e = i; e < BB; e += 32) LDl[(long)t * BB + e] = Lp[e];
    __syncwarp();
  }
}

// -1: a block size outside 1..BLOCK_MAX
template <typename T>
static int launch(const void* D, const void* O, void* LD, void* LM, int lanes,
                  int nT, int b, double tiny, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int r = banded::with_block<1, banded::BLOCK_MAX>(b, [&](auto bs) {
    btd_factor_kernel<T, decltype(bs)::value><<<lanes, 32, 0, s>>>(
        (const T*)D, (const T*)O, (T*)LD, (T*)LM, nT, (T)tiny);
    return 0;
  });
  return r < 0 ? r : (int)cudaGetLastError();
}

extern "C" int btd_factor_f32(const void* D, const void* O, void* LD, void* LM,
                              int lanes, int nT, int b, double tiny,
                              void* stream) {
  return launch<float>(D, O, LD, LM, lanes, nT, b, tiny, stream);
}

extern "C" int btd_factor_f64(const void* D, const void* O, void* LD, void* LM,
                              int lanes, int nT, int b, double tiny,
                              void* stream) {
  return launch<double>(D, O, LD, LM, lanes, nT, b, tiny, stream);
}
