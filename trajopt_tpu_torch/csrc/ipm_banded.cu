// K6 ipm_banded: the banded interior-point QP solver's whole Mehrotra loop,
// one CTA per lane, from the initial interior point to termination.
//
// Replaces trajopt_tpu/ops/ipm_qp.py:92 solve_ipm_qp's banded loop (body
// :373-511, cond :513-514, while_loop :516-520, make_kkt_solve :321-371),
// which the plain PyTorch port runs as ~1,200 small launches per batched
// IPM iteration and one host sync after each.  Here one launch runs every
// lane's loop; a lane leaves it when its own status is set or it reaches
// max_iter.  The per-lane body, with K1-K3's math as device functions, is
// ipm.cuh; ipm_launch.cuh its launcher, with a plain C interface
// (ctypes): this file's entry points, built once per dtype and range of
// block sizes (every b from 1 to 21), and ipm_timer.cu's float32 with the
// phase timer.
//
// Design: 256 threads per CTA (8 warps), one CTA per SM (the launch
// bounds give each thread up to 255 registers, so the lane's view stays in
// registers: no local memory in float32 up to b 16).  Row passes (the banded
// matvecs, the slack and dual updates) and column passes (A' w by column
// over each block's cover list, P v, the box terms) are strided over all
// 256; the assembly forms D's lower triangle and O entry by entry over the
// cover lists.  The block Cholesky runs on warp 0 in banded.cuh's
// block-inverse form (the block's rows in registers, values of other rows
// by shuffle; each pivot block's Cholesky factor inverted beside its
// columns, M_t a product with the previous inverse, so no triangular
// solve sits in the chain) while the other warps form the residuals; then
// the whole CTA forms the couplings W_t = L_t^{-1} M_t and V_t = L_t^{-T}
// M_{t+1}^T.  Each of the four block solves per iteration is two passes of
// the whole CTA (c = L^{-1} r, d = L^{-T} y) and two sweeps on warp 0 (y_t
// = c_t - W_t y_{t-1}, x_t = d_t - V_t x_{t+1}: a b x b product a step,
// with no division).  D (the inverses), O (W), V, the solves' scratch and
// the n-vectors sit in dynamic shared memory; so do the lane's scaled rows and its scratch m-vectors where
// they fit (at the flagship's shape in float32, 1,624 + 67 rows: 94.7 KB
// of rows, 81.2 KB of scratch, 210.0 KB in all), else device memory
// (float64; b 14 and 21 keep the rows there).  Built with -fmad=false, as
// the plain version computes every multiply and add apart.
//
// Bound on the H100 (chip_smoke's k6_work): the bytes the function must
// move, each input read once (~0.26 MB per lane at the flagship's shape in
// float32), take less time than its least arithmetic (~1.1e6 flops per IPM
// iteration and lane, mostly the rows' passes and their share of the
// symmetric assembly), so operations bound it.  The kernel's own limit is
// neither: per iteration the factor is sequential over T block steps of b
// dependent pivots each, and the solves' sweeps over T steps of one b x b
// product each, on one warp, and the passes read the rows ~10 times from
// shared memory.  No tensor cores: the factor's and couplings' products
// are ~20k multiply-adds per factor at b <= 21, far from any limit, and a
// float32 mma would round through TF32, which the QP math keeps out.
//
// The phase timer (Args::clk) runs in a second instantiation of the
// float32 kernels (ipm_timer.cu), so the kernel the solver launches
// carries none of it.

#include "ipm_launch.cuh"

// One library per (dtype, block-size range): -DK6_F64 (0 float32, 1
// float64) and the range K6_LO..K6_HI, given by _native.K6_GROUPS.  K6
// runs at every block size from 1 to banded::BLOCK_MAX.
#if !defined(K6_F64) || !defined(K6_LO) || !defined(K6_HI)
#error "build with -DK6_F64=0|1 -DK6_LO=<b> -DK6_HI=<b>"
#endif
using K6T = std::conditional_t<K6_F64, double, float>;
static_assert(1 <= K6_LO && K6_LO <= K6_HI && K6_HI <= banded::BLOCK_MAX,
              "K6's block sizes lie in 1..BLOCK_MAX");

extern "C" int ipm_banded_run(ipm::Args* a, void* stream) {
  return launch<K6T, false, K6_LO, K6_HI>(a, stream);
}

extern "C" int ipm_banded_attrs(int b, int* out) {
  return attrs<K6T, K6_LO, K6_HI>(b, out);
}
