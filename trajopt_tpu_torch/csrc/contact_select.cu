// K10 contact_select and K10v contact_select_value: the collision terms'
// worst-contact selection (the reference's max_num_cnt), for the cast and
// the discrete terms, on the distances (and Jacobians) that K4 / K4v and
// K7 / K7v wrote.
//
// Replaces (JAX package, hand-shaped XLA routines):
//   terms/collision.py:70-89    _topk_rows (jax.lax.top_k per step)
//   terms/collision.py:252-290  the discrete terms' row-level selection
//                               (sfn, _sel_jac_steps, sjac_banded)
//   terms/collision.py:441-491  the cast terms' pair-level selection (the
//                               key a pair's worst segment, top_k, the
//                               gathers of its segments' values and rows)
// K10v (no Jacobian pointers) gives the selected value rows for fn and
// evaluate; K10 also writes the selected banded window rows, in the form
// jac_banded returns, so no gather runs after it.  The body is
// contact_select.cuh; contact_select_host.cpp runs it on a CPU.
//
// Design: a warp per (lane, group), CS_WARPS warps to a CTA.  At the
// paths' shapes every CTA is resident in one wave (7a: 28 warps an SM),
// so a launch takes its floor (one group's chain) plus what the SMs issue
// for their warps; the design cuts both (contact_select.cuh's register
// route, for P up to 64, S up to 8 and S K up to 64):
// - lane t loads pairs t and t + 32: every load of D, m and c issued
//   before the first use, the keys and S errors kept in registers;
// - each of the K rounds is two warp reductions (__reduce_max_sync over
//   an order-preserving 32-bit image of the lanes' best keys, then
//   __reduce_min_sync of the index among the lanes at the maximum; float64
//   a third, over the image's low word), the winner retired by its lane;
//   lane r % 32 keeps row r = s K + k (its (s, k) found before the
//   rounds, by compares) and notes round k's winner;
// - after the rounds each lane shuffles its rows' errors and coefficients
//   from the winners' lanes, one shuffle per segment for all rounds (a
//   lane reads its own source), and forms their values, scales and
//   Jacobian rows; the shuffles run unrolled over S_MAX segments (or one
//   at S 1), with no branch between them: a loop that stops at S makes
//   each shuffle wait for the last (scripts/select_ab.py measured it
//   slower);
// - the values are stored by the lanes that keep them; each lane then
//   loads its NB row entries' Jacobian values (row offset and scale
//   shuffled from the keeping lane, the entry's row and column stepped by
//   counters, no division in the loop) before it stores any of them; the
//   stores run along the 2 nc columns.
// Larger sizes take the shared-memory route: the keys and retired flags
// in shared memory, K rounds of a butterfly of __shfl_xor_sync on (key
// descending, index ascending), the outputs re-read from D.  Built with
// -fmad=false, as the plain version computes every multiply apart.
//
// Bound: bytes.  The function reads D once (4-8 bytes per (segment,
// pair)), the K selected pairs' Jacobian rows and the margins and
// coefficients, and writes the selected values and rows; it does a few
// compares per (segment, pair) and one multiply per output, far below the
// card's rate.

#include <cuda_runtime.h>

#include "contact_select.cuh"

using namespace csel;

constexpr int CS_WARPS = 4;
constexpr long CS_MAX_SMEM = 48 * 1024;  // static launch limit, no opt-in

constexpr unsigned FULL = 0xffffffffu;

// the round's winner: the least index among the lanes whose candidate
// image (hi, lo) is the warp's largest
template <typename T>
__device__ __forceinline__ int warp_argmax(unsigned hi, unsigned lo,
                                           int bi) {
  const unsigned hmax = __reduce_max_sync(FULL, hi);
  bool top = hi == hmax;
  if constexpr (sizeof(T) == 8) {
    const unsigned lmax = __reduce_max_sync(FULL, top ? lo : 0u);
    top = top && lo == lmax;
  }
  return (int)__reduce_min_sync(FULL, top ? (unsigned)bi : 0xffffffffu);
}

// the register route for one (lane, group): lane t of the warp, SM the
// segments a lane holds (1 for S 1, else S_MAX)
template <typename T, int NP, int SM>
__device__ __forceinline__ void select_regs(const Args<T>& a, int lane,
                                            int g, int t) {
  const long grp = (long)lane * a.G + g;
  Lane<T, NP, 32, SM> L;
  L.load(a.D + grp * a.S * a.P, a.margins + (long)lane * a.P,
         a.coeffs + (long)lane * a.P, a.S, a.P, t);
  L.plan(a.S, a.K, t);
  for (int k = 0; k < a.K; ++k) {
    unsigned hi, lo;
    int bi;
    L.best(a.P, t, hi, lo, bi);
    const int w = warp_argmax<T>(hi, lo, bi);
    L.retire(w, t);
    L.note(k, w);
  }
  // each kept row's error and coefficient shuffled from its pair's lane:
  // NP shuffles per segment, all issued without a branch between them
  L.gather(a.S * a.K, a.P, -(T)a.buffer, [&](int src, int jb, int s) {
    T x = __shfl_sync(FULL, s < SM ? L.e[0][s] : L.c[0], src);
#pragma unroll
    for (int j = 1; j < NP; ++j) {
      const T y = __shfl_sync(FULL, s < SM ? L.e[j][s] : L.c[j], src);
      if (jb == j) x = y;
    }
    return x;
  });
  L.write_values(a.vals + grp * a.S * a.K, a.S * a.K, t);
  if (a.rows)
    L.write_rows(a, lane, g, t, [&](int b, int src, int& off, T& sc) {
      off = __shfl_sync(FULL, L.roff[b], src);
      sc = __shfl_sync(FULL, L.rsc[b], src);
    });
}

template <typename T, int NP>
__global__ void __launch_bounds__(32 * CS_WARPS)
contact_select_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, tid = threadIdx.x % 32;
  const long item = (long)blockIdx.x * CS_WARPS + warp;
  if (item >= (long)a.lanes * a.G) return;  // warp-uniform: no CTA barrier
  const int lane = (int)(item / a.G), g = (int)(item % a.G);
  if (reg_route(a.P, a.S, a.K, 32)) {
    if (a.S == 1)
      select_regs<T, NP, 1>(a, lane, g, tid);
    else
      select_regs<T, NP, S_MAX>(a, lane, g, tid);
    return;
  }
  T* keys = reinterpret_cast<T*>(smem_raw) + (long)warp * a.P;
  int* ret = reinterpret_cast<int*>(reinterpret_cast<T*>(smem_raw) +
                                    (long)CS_WARPS * a.P) +
             (long)warp * a.P;
  int* win = reinterpret_cast<int*>(reinterpret_cast<T*>(smem_raw) +
                                    (long)CS_WARPS * a.P) +
             (long)CS_WARPS * a.P + (long)warp * a.K;
  group_keys(a, lane, g, keys, ret, tid, 32);
  __syncwarp();
  for (int k = 0; k < a.K; ++k) {
    T bk;
    int bi;
    local_best(a, keys, ret, tid, 32, bk, bi);
    for (int off = 16; off > 0; off >>= 1) {
      const T ok = __shfl_xor_sync(FULL, bk, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      if (before(ok, oi, bk, bi)) {
        bk = ok;
        bi = oi;
      }
    }
    if (tid == 0) {
      win[k] = bi;
      ret[bi] = 1;
    }
    __syncwarp();
  }
  write_group(a, lane, g, win, tid, 32);
}

template <typename T>
static int launch(const void* D, const void* Ja, const void* Jb,
                  const void* m, const void* c, void* vals, void* rows,
                  int lanes, int G, int S, int P, int K, int nc,
                  int right_group, double buffer, void* stream) {
  if (K < 1 || K > P || S < 1 || (Ja && nc < 1)) return -1;
  const bool regs = reg_route(P, S, K, 32);
  const long smem = regs ? 0 : CS_WARPS * team_smem_bytes<T>(P, K);
  if (smem > CS_MAX_SMEM) return -1;
  const long items = (long)lanes * G;
  if (items == 0) return 0;
  Args<T> a{(const T*)D, (const T*)Ja, (const T*)Jb, (const T*)m,
            (const T*)c, (T*)vals, Ja ? (T*)rows : nullptr, lanes, G, S, P,
            K, nc, right_group, buffer};
  const unsigned grid = (unsigned)((items + CS_WARPS - 1) / CS_WARPS);
  if (regs && P <= 32)
    contact_select_kernel<T, 1>
        <<<grid, 32 * CS_WARPS, 0, (cudaStream_t)stream>>>(a);
  else
    contact_select_kernel<T, 2>
        <<<grid, 32 * CS_WARPS, (size_t)smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// the C entry points: Ja null runs K10v (values only); Jb null is the
// discrete form (rows placed by right_group)
#define CS_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const void* D, const void* Ja, const void* Jb,         \
                      const void* m, const void* c, void* vals, void* rows,  \
                      int lanes, int G, int S, int P, int K, int nc,         \
                      int right_group, double buffer, void* stream) {        \
    return launch<T>(D, Ja, Jb, m, c, vals, rows, lanes, G, S, P, K, nc,     \
                     right_group, buffer, stream);                            \
  }

CS_ENTRY(contact_select_f32, float)
CS_ENTRY(contact_select_f64, double)

// the registers and local memory of an instantiation (0: float32, 1:
// float64, pairs up to 32 a lane; 2, 3: the same up to 64, which also
// runs the shared-memory route): out = [numRegs, localSizeBytes,
// maxThreadsPerBlock, sharedSizeBytes]
template <typename T, int NP>
static int attrs(int* out) {
  cudaFuncAttributes f;
  const cudaError_t e =
      cudaFuncGetAttributes(&f, contact_select_kernel<T, NP>);
  if (e != cudaSuccess) return (int)e;
  out[0] = f.numRegs;
  out[1] = (int)f.localSizeBytes;
  out[2] = f.maxThreadsPerBlock;
  out[3] = (int)f.sharedSizeBytes;
  return 0;
}

extern "C" int contact_select_attrs(int which, int* out) {
  switch (which) {
    case 0: return attrs<float, 1>(out);
    case 1: return attrs<double, 1>(out);
    case 2: return attrs<float, 2>(out);
    case 3: return attrs<double, 2>(out);
    default: return -1;
  }
}
