// K3 btd_solve: solve K x = r with the block-bidiagonal factor of K3's
// partner K2 (btd_factor.cu): forward substitution L y = r, then backward
// substitution L^T x = y, block by block.
//
// Replaces trajopt_tpu/ops/btridiag.py:188-205 and 234-250
// (_solve_lower_vec_s, _solve_upper_vec_s, btd_solve_scalar):
//
//   y_0 = L_0^{-1} r_0,      y_t = L_t^{-1} (r_t - M_t y_{t-1})
//   x_{T-1} = L_{T-1}^{-T} y_{T-1},   x_t = L_t^{-T} (y_t - M_{t+1}^T x_{t+1})
//
// (M_t is LM[t-1] in the (lanes, T-1, b, b) layout.)
//
// Layout: LD (lanes, T, b, b), LM (lanes, T-1, b, b), r and x (lanes, T, b),
// all contiguous.
//
// Design: one warp per lane, the chain over T a loop inside it.  Thread i
// owns entry i of the current block vector; the triangular solves are
// column-oriented, the solved entry broadcast with a warp shuffle, so no
// shared-memory barrier sits inside a b-step chain (banded.cuh's fwd_step
// and bwd_step, which K6 ipm_banded also runs).  The coupling
// matvecs sum in the JAX routine's order; the backward substitution
// subtracts its terms in the reverse order.
//
// Bound on the H100: it reads LD, LM and r once and writes x once (at b=7,
// T=30, 128 lanes, float32: ~3 MB, about 1 us at 3.35 TB/s) for ~4 T b^2
// flops per lane.  The real limit is the chain of 2 T b dependent steps.

#include "banded.cuh"

template <typename T, int BS>
__global__ void __launch_bounds__(32)
btd_solve_kernel(const T* __restrict__ LD, const T* __restrict__ LM,
                 const T* __restrict__ r, T* __restrict__ x, int nT) {
  constexpr int BB = BS * BS;
  __shared__ T Ls[BB];
  __shared__ T Ms[BB];
  __shared__ T vprev[32];
  const int lane = blockIdx.x;
  const int i = threadIdx.x;
  const T* LDl = LD + (long)lane * nT * BB;
  const T* LMl = LM + (long)lane * (nT - 1) * BB;
  const T* rl = r + (long)lane * nT * BS;
  T* xl = x + (long)lane * nT * BS;

  // ---- forward: L y = r ----
  for (int t = 0; t < nT; ++t) {
    for (int e = i; e < BB; e += 32) Ls[e] = LDl[(long)t * BB + e];
    if (t > 0)
      for (int e = i; e < BB; e += 32) Ms[e] = LMl[(long)(t - 1) * BB + e];
    __syncwarp();
    banded::fwd_step<T, BS, 32>(Ls, t > 0 ? Ms : nullptr, rl + t * BS, vprev,
                                vprev, i);
    if (i < BS) xl[t * BS + i] = vprev[i];
  }

  // ---- backward: L^T x = y ----
  for (int t = nT - 1; t >= 0; --t) {
    for (int e = i; e < BB; e += 32) Ls[e] = LDl[(long)t * BB + e];
    if (t < nT - 1)
      for (int e = i; e < BB; e += 32) Ms[e] = LMl[(long)t * BB + e];
    __syncwarp();
    // y_t was written by this thread in the forward pass
    banded::bwd_step<T, BS, 32>(Ls, t < nT - 1 ? Ms : nullptr, xl + t * BS,
                                vprev, vprev, i);
    if (i < BS) xl[t * BS + i] = vprev[i];
  }
}

// -1: a block size outside 1..BLOCK_MAX
template <typename T>
static int launch(const void* LD, const void* LM, const void* r, void* x,
                  int lanes, int nT, int b, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int code = banded::with_block<1, banded::BLOCK_MAX>(b, [&](auto bs) {
    btd_solve_kernel<T, decltype(bs)::value><<<lanes, 32, 0, s>>>(
        (const T*)LD, (const T*)LM, (const T*)r, (T*)x, nT);
    return 0;
  });
  return code < 0 ? code : (int)cudaGetLastError();
}

extern "C" int btd_solve_f32(const void* LD, const void* LM, const void* r,
                             void* x, int lanes, int nT, int b, void* stream) {
  return launch<float>(LD, LM, r, x, lanes, nT, b, stream);
}

extern "C" int btd_solve_f64(const void* LD, const void* LM, const void* r,
                             void* x, int lanes, int nT, int b, void* stream) {
  return launch<double>(LD, LM, r, x, lanes, nT, b, stream);
}
