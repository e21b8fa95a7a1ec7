// K7 disc_dist and K7v disc_dist_value: the discrete collision terms'
// distances per (lane, step), fused.
//
// Replaces (JAX package, hand-shaped XLA routines):
//   K7  terms/collision.py:117-128  DiscreteDistancePre.value_jac — each
//       pair's signed distance at one step and its Jacobian wrt that
//       step's dofs (jacfwd over collision/world.py:171-175
//       pair_distances, through kinematics/chain.py's FK)
//   K7v terms/collision.py:114-115  DiscreteDistancePre.value
// The block's body is disc_block.cuh's disc_block, over the device
// functions of collision.cuh that K4 runs in its phases A and B (the chain,
// the joint frames and world records, the closed-form pair distances with
// one dual tangent column per thread); cast_host.cpp runs it on a CPU.
//
// Design: a CTA holds S (lane, step) slots (the grid ceil(lanes span /
// S), the last CTA a partial set), of `threads` threads; S and the
// threads are the launcher's arguments (terms.collision.DISC_BLOCKS, per
// instantiation, chosen by measurement: PERF.md section 6).  The world's
// tables are staged into shared memory once per CTA (where they are small
// and fit beside the S slots; else they are read from global memory, an
// instantiation of its own, and S is lowered to the slots that fit:
// disc_dist_layout); a thread per slot
// runs the chain (S chains at once, where one CTA ran one), a thread per
// (slot, dof | geometry) the frames and world records, then the (pair,
// slot, column) items fill the whole CTA, the column fastest, the pairs in
// the work list's order from its heaviest kind pair down (a warp on one
// closed form; the last round the lightest).  n_dof is read from the
// world's tables, so one instantiation takes the spherebot (2), the 7-DoF
// arms and the 9-DoF rail.  Built with -fmad=false, as the plain version computes every
// multiply and add apart; each slot's arithmetic is the one-slot order,
// so every layout gives the same bits.
//
// Bound: per (lane, step) ~2 x 10^3 flops of FK and ~10^2-10^3 per pair
// and column (capsule-box: 12 projections) on ~10^2 bytes of input, so the
// bound is operations (chip_smoke's disc_work), far above the bytes of x,
// D and J.  What the design does about it: no thread carries more than one
// tangent column, the (slot, pair, column) items fill the CTA, the chains
// run side by side, and no CTA reads the tables from global memory twice.
// Not instantiated: a world with CONVEX geometry (a CONVEX side takes a
// team route, cast_block.cuh's, which K7 does not run; the wrapper raises).

#include <cuda_runtime.h>

#include "disc_block.cuh"

using namespace coll;

#define DISC_KERNEL_ARGS                                                      \
  const int *__restrict__ I, const T *__restrict__ F, int n_ints,           \
      int n_reals, const T *__restrict__ x, long x_stride, int nc,          \
      int first, int span, long n_slots, T *D, T *J, int S
#define DISC_KERNEL_BODY(STAGE)                                               \
  extern __shared__ __align__(16) unsigned char smem_raw[];                   \
  disc_block<T, JAC, STAGE>(I, F, n_ints, n_reals, x, x_stride, nc, first,    \
                            span, n_slots, D, J, blockIdx.x, S, smem_raw,     \
                            blockDim.x)

// the tables staged
template <typename T, bool JAC>
__global__ void __launch_bounds__(DISC_MAX_THREADS)
disc_kernel(DISC_KERNEL_ARGS) {
  DISC_KERNEL_BODY(true);
}

// the tables read from global memory
template <typename T, bool JAC>
__global__ void __launch_bounds__(DISC_MAX_THREADS)
disc_kernel_global(DISC_KERNEL_ARGS) {
  DISC_KERNEL_BODY(false);
}

// K7v's with the tables in global memory: with no minimum of blocks an SM
// ptxas spills 4 bytes of its float32 build at 40 registers; one block
// clears it (64 registers), but costs K7's a third (arm7 with 450 table
// spheres: PERF.md section 6), which keeps the kernel above
template <typename T, bool JAC>
__global__ void __launch_bounds__(DISC_MAX_THREADS, 1)
disc_value_kernel_global(DISC_KERNEL_ARGS) {
  DISC_KERNEL_BODY(false);
}

template <typename T, bool JAC, bool STAGE>
static auto disc_kernel_of() {
  if constexpr (STAGE)
    return disc_kernel<T, JAC>;
  else if constexpr (JAC)
    return disc_kernel_global<T, JAC>;
  else
    return disc_value_kernel_global<T, JAC>;
}

template <typename T, bool JAC, bool STAGE>
static int disc_launch(const int* I, const T* F, int n_ints, int n_reals,
                       const T* x, long x_stride, int nc, int first,
                       int span, T* D, T* J, long n_slots, int S,
                       int threads, long smem, cudaStream_t stream) {
  auto kern = disc_kernel_of<T, JAC, STAGE>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<(n_slots + S - 1) / S, threads, smem, stream>>>(
      I, F, n_ints, n_reals, x, x_stride, nc, first, span, n_slots, D, J, S);
  return (int)cudaGetLastError();
}

// the C entry points (-1: a block the kernel does not take): `slots` (lane,
// step) slots a CTA, the tables staged where `stage` (disc_dist_layout
// gives both), `threads` a multiple of 32 up to DISC_MAX_THREADS
#define DISC_ENTRY(NAME, T, JAC)                                              \
  extern "C" int NAME(const int* I, const T* F, int n_ints, int n_reals,     \
                      const T* x, long x_stride, int nc, int first, int span,\
                      T* D, T* J, int lanes, int L, int nd, int NG,          \
                      int slots, int stage, int threads, void* stream) {      \
    if (threads < 32 || threads > DISC_MAX_THREADS || threads % 32 ||        \
        slots < 1)                                                            \
      return -1;                                                              \
    const long smem =                                                         \
        disc_smem_bytes<T>(n_ints, n_reals, slots, stage, L, nd, NG);         \
    if (smem > DISC_MAX_SMEM) return -1;                                      \
    const long n_slots = (long)lanes * span;                                  \
    return (stage ? disc_launch<T, JAC, true> : disc_launch<T, JAC, false>)(  \
        I, F, n_ints, n_reals, x, x_stride, nc, first, span, D, J, n_slots,  \
        slots, threads, smem, (cudaStream_t)stream);                          \
  }

DISC_ENTRY(disc_dist_f32, float, true)
DISC_ENTRY(disc_dist_f64, double, true)
DISC_ENTRY(disc_dist_value_f32, float, false)
DISC_ENTRY(disc_dist_value_f64, double, false)

// the block of at most `slots` slots that fits (disc_block.cuh
// disc_layout) for elements of `esz` bytes: out = [slots, stage]; returns
// its shared-memory bytes, or -1
extern "C" int disc_dist_layout(int esz, int n_ints, int n_reals, int L,
                                int nd, int NG, int slots, int* out) {
  return (int)disc_layout_of(esz, n_ints, n_reals, L, nd, NG, slots, out);
}

// the registers and local memory of an instantiation (which: 0..3 =
// disc_dist f32, f64, disc_dist_value f32, f64 with the tables staged,
// 4..7 the same reading them from global memory): out = [numRegs,
// localSizeBytes, maxThreadsPerBlock, sharedSizeBytes]
template <typename T, bool JAC, bool STAGE>
static int attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e =
      cudaFuncGetAttributes(&a, disc_kernel_of<T, JAC, STAGE>());
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = (int)a.sharedSizeBytes;
  return 0;
}

extern "C" int disc_dist_attrs(int which, int* out) {
  switch (which) {
    case 0: return attrs<float, true, true>(out);
    case 1: return attrs<double, true, true>(out);
    case 2: return attrs<float, false, true>(out);
    case 3: return attrs<double, false, true>(out);
    case 4: return attrs<float, true, false>(out);
    case 5: return attrs<double, true, false>(out);
    case 6: return attrs<float, false, false>(out);
    case 7: return attrs<double, false, false>(out);
    default: return -1;
  }
}
