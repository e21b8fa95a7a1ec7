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
// Design: a warp per (lane, group), CS_WARPS warps to a CTA.  Each thread
// computes the keys of pairs tid, tid + 32, ... into shared memory; then
// K rounds of a warp arg-max (each thread's best unretired pair, then a
// butterfly of __shfl_xor_sync on (key descending, index ascending)), the
// winner retired; then the warp writes the K pairs' values and rows, a
// thread per entry.  Built with -fmad=false, as the plain version
// computes every multiply apart.
//
// Bound: bytes.  The function reads D once (4-8 bytes per (segment,
// pair)), the K selected pairs' Jacobian rows and the margins and
// coefficients, and writes the selected values and rows; it does a few
// compares per (segment, pair) and one multiply per output, far below the
// card's rate.  A simple kernel: one pass over D per group, the rows
// copied coalesced along their 2 nc columns.

#include <cuda_runtime.h>

#include "contact_select.cuh"

using namespace csel;

constexpr int CS_WARPS = 4;
constexpr long CS_MAX_SMEM = 48 * 1024;  // static launch limit, no opt-in

template <typename T>
__global__ void __launch_bounds__(32 * CS_WARPS)
contact_select_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, tid = threadIdx.x % 32;
  const long item = (long)blockIdx.x * CS_WARPS + warp;
  if (item >= (long)a.lanes * a.G) return;  // warp-uniform: no CTA barrier
  const int lane = (int)(item / a.G), g = (int)(item % a.G);
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
      const T ok = __shfl_xor_sync(0xffffffffu, bk, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
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
  const long smem = CS_WARPS * team_smem_bytes<T>(P, K);
  if (smem > CS_MAX_SMEM) return -1;
  const long items = (long)lanes * G;
  if (items == 0) return 0;
  Args<T> a{(const T*)D, (const T*)Ja, (const T*)Jb, (const T*)m,
            (const T*)c, (T*)vals, Ja ? (T*)rows : nullptr, lanes, G, S, P,
            K, nc, right_group, buffer};
  contact_select_kernel<T>
      <<<(unsigned)((items + CS_WARPS - 1) / CS_WARPS), 32 * CS_WARPS,
         (size_t)smem, (cudaStream_t)stream>>>(a);
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
// float64): out = [numRegs, localSizeBytes, maxThreadsPerBlock,
// sharedSizeBytes]
template <typename T>
static int attrs(int* out) {
  cudaFuncAttributes f;
  const cudaError_t e = cudaFuncGetAttributes(&f, contact_select_kernel<T>);
  if (e != cudaSuccess) return (int)e;
  out[0] = f.numRegs;
  out[1] = (int)f.localSizeBytes;
  out[2] = f.maxThreadsPerBlock;
  out[3] = (int)f.sharedSizeBytes;
  return 0;
}

extern "C" int contact_select_attrs(int which, int* out) {
  return which == 0 ? attrs<float>(out) : which == 1 ? attrs<double>(out) : -1;
}
