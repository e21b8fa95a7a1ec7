// K4 cast_seg, K4v cast_seg_value, K5 cast_sweep: the swept collision
// distances of the cast terms and of the trajectory gate, fused per
// (lane, step gap).
//
// Replaces (JAX package, hand-shaped XLA routines):
//   K4  terms/collision.py:165-181  CastDistancePre.value_jac — swept
//       distance per (gap, segment, pair) and its Jacobian wrt both gap
//       endpoints (jacfwd over collision/world.py:196-221 + 265-382)
//   K4v terms/collision.py:159-163  CastDistancePre.value
//   K5  terms/collision.py:548-564  trajectory_in_collision over
//       collision/world.py:223-239 cast_pair_distances (n_sub substates)
// The kernel template is in cast_kernel.cuh; this source holds the
// instantiations without the CONVEX routes, cast_cvx.cu those with them
// (a world with CONVEX geometry) and the route probe.
//
// Design: one block per (lane, gap).  Phase A: one thread per slot
// (substate, or the exact end pose for K5) runs FK and the joint frames
// and writes the canonical world geometry to shared memory.  Phase B: one
// thread per (slot, pair) evaluates the discrete pair distance — with K4
// as a dual number carrying n_dof tangent columns seeded from the point
// Jacobians z_d x (v - o_d).  Phase C: one thread per (segment, pair)
// takes the substate min, applies the pair's static sweep route (exact
// sphere sweep with 2 n_dof columns; or the two-pose hull feature
// distance, whose Jacobian is the witness-linear form) and writes D and
// the Jacobian rows, split onto qa and qb by the substate fractions.
//
// Bound: the work is ~10^4-10^5 flops per (lane, gap) on a few hundred
// bytes of input (~10^6 with an (8, 8) generic enumeration), so the bound
// is operations (the float32 / float64 CUDA core rates), far above the
// bytes of x, D, Ja and Jb.  This first version keeps the dual numbers in
// registers and local memory; the pair threads of one block diverge by
// route, and a CONVEX pair's enumeration runs serially in one thread.

#include "cast_kernel.cuh"

CAST_ENTRY(cast_seg_f32, float, ND_JAC, MODE_JAC, false, nd != ND_JAC)
CAST_ENTRY(cast_seg_f64, double, ND_JAC, MODE_JAC, false, nd != ND_JAC)
CAST_ENTRY(cast_seg_value_f32, float, 1, MODE_VALUE, false, false)
CAST_ENTRY(cast_seg_value_f64, double, 1, MODE_VALUE, false, false)
CAST_ENTRY(cast_sweep_f32, float, 1, MODE_SWEEP, false, false)
CAST_ENTRY(cast_sweep_f64, double, 1, MODE_SWEEP, false, false)
