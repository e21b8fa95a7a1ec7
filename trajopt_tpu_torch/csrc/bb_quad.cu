// K1 bb_quad: block-tridiagonal blocks of A^T diag(d) A from banded rows.
//
// Replaces trajopt_tpu/ops/banded_rows.py:89-103 (bb_quad: per-group einsum
// "grw,gr,grv->gwv" plus scatter-adds into the (nb, b, b) diagonal and
// (nb-1, b, b) sub-diagonal block grids).
//
// Layout (one row group of the ops.banded_rows format, all lanes):
//   B  (lanes, ng, r, 2b)  window values, row-major, contiguous
//   G  (ng,)  int32        window start block of each group (shared by lanes)
//   d  (lanes, >= ng*r)    row weights; lane l starts at d + l*d_stride
//   D  (lanes, nb, b, b)   diagonal blocks, accumulated IN PLACE
//   O  (lanes, nb-1, b, b) sub-diagonal blocks O[t] = K[t+1, t], in place
//
// Design: one thread block per lane.  Each thread OWNS output entries of
// D and O and loops over the groups in row order, adding each group's
// sum over its r rows (banded::bb_quad_entry in banded.cuh, which K6
// ipm_banded also runs) — no atomics, and the order of every sum is fixed,
// so results repeat bitwise from run to run.  A group with window start
// G touches D[G] (window block 0), D[G+1] (window block 1) and O[G]; the
// last trajectory step's rows sit in window nb-2 (step_window), so two
// groups can land on one block and are summed in row order.
//
// Bound on the H100: it reads B and d once and reads and writes D and O
// once; the useful work is 3 b^2 entries x r rows x 3 flops per group.
// At the flagship's shapes (b=7, upright ng=30 r=2, 128 lanes, float32)
// that is ~3.2 MB (mostly D and O) and ~1 MFLOP: about 1 us at 3.35 TB/s,
// so the bound is bytes; a kernel this small runs near launch latency.

#include "banded.cuh"

template <typename T>
__global__ void bb_quad_kernel(const T* __restrict__ Bw,
                               const int* __restrict__ G,
                               const T* __restrict__ d, long d_stride,
                               T* __restrict__ D, T* __restrict__ O,
                               int ng, int r, int b, int nb) {
  const int lane = blockIdx.x;
  const T* Bl = Bw + (long)lane * ng * r * 2 * b;
  const T* dl = d + (long)lane * d_stride;
  const int bb = b * b;
  const int nD = nb * bb;
  const int nO = (nb - 1) * bb;
  T* Dl = D + (long)lane * nD;
  T* Ol = O + (long)lane * nO;
  for (int e = threadIdx.x; e < nD + nO; e += blockDim.x) {
    const bool isD = e < nD;
    const int ee = isD ? e : e - nD;
    T* out = isD ? Dl + ee : Ol + ee;
    *out = banded::bb_quad_entry<T>(Bl, G, dl, ng, r, b, isD, ee / bb,
                                    (ee % bb) / b, ee % b, *out);
  }
}

template <typename T>
static int launch(const void* Bw, const void* G, const void* d, long d_stride,
                  void* D, void* O, int lanes, int ng, int r, int b, int nb,
                  void* stream) {
  const int entries = (2 * nb - 1) * b * b;
  int threads = entries < 256 ? ((entries + 31) / 32) * 32 : 256;
  bb_quad_kernel<T><<<lanes, threads, 0, (cudaStream_t)stream>>>(
      (const T*)Bw, (const int*)G, (const T*)d, d_stride, (T*)D, (T*)O, ng, r,
      b, nb);
  return (int)cudaGetLastError();
}

extern "C" int bb_quad_f32(const void* Bw, const void* G, const void* d,
                           long d_stride, void* D, void* O, int lanes, int ng,
                           int r, int b, int nb, void* stream) {
  return launch<float>(Bw, G, d, d_stride, D, O, lanes, ng, r, b, nb, stream);
}

extern "C" int bb_quad_f64(const void* Bw, const void* G, const void* d,
                           long d_stride, void* D, void* O, int lanes, int ng,
                           int r, int b, int nb, void* stream) {
  return launch<double>(Bw, G, d, d_stride, D, O, lanes, ng, r, b, nb, stream);
}
