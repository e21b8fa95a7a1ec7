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
// The launchers are in cast_kernel.cuh and the block's body in
// cast_block.cuh; this source holds the instantiations without the CONVEX
// routes, cast_cvx.cu those with them (a world with CONVEX geometry) and
// the route probe.
//
// Design: one CTA per (lane, gap) (3,712 on the flagship, 1,408 on the
// pick-and-place transfer), of 64 or 128 threads in teams of 8 or 16 lanes
// of a warp, the layout chosen per kernel (terms/collision.py
// CAST_BLOCKS, from the measurements in PERF.md).  Phase A: a thread per
// slot (substate, or the exact end pose for K5) runs the chain, then a
// thread per (slot, dof) and (slot, geometry) the joint frames and the
// canonical world geometry, into shared memory.  Phase B: the discrete
// pair distance per (slot, pair), a thread per tangent column: with K4 a
// Dual<T, 1> seeded with one dof's point Jacobian z_d x (v - o_d), each
// column's thread recomputing the value; a pair with a CONVEX side takes
// a team.  Phase C: per (segment, pair) the exact sphere sweep (a thread
// per dof, a Dual<T, 2> for the dof at both slots) or the substate min (a
// thread per column), and a team per hull or CONVEX route: its candidates,
// the witness's support scans, the 26-direction depth cover and
// Frank-Wolfe's support scans strided over the lanes with an in-order
// (value, index) argmin by warp shuffles, the witness by lane 0, the
// weights and the witness-linear Jacobian a vertex or a dof per lane.  The
// work lists group the pairs by route and put the heaviest team items
// first.  cast_block.cuh holds the body; cast_host.cpp runs it on a CPU.
//
// Bound: the work is ~10^4-10^5 flops per (lane, gap) on a few hundred
// bytes of input (~10^6 with an (8, 8) generic enumeration), so the bound
// is operations (the float32 / float64 CUDA core rates), far above the
// bytes of x, D, Ja and Jb.  What the design does about it: no tangent
// array lives in one thread (few registers), a feature enumeration's
// chain is its lane's share of candidates, not all of them, and float
// division and square root take no slow-path subroutine (collision.cuh
// qdiv / qsqrt: the same correctly rounded results).

#include "cast_kernel.cuh"

// -DCAST_CEIL: K4 at the n_dof ceiling alone (the library cast_seg_ceil)
CAST_JAC_ENTRY(cast_seg_f32, float, false)
CAST_JAC_ENTRY(cast_seg_f64, double, false)
#ifndef CAST_CEIL
CAST_ENTRY(cast_seg_value_f32, float, 1, MODE_VALUE, false, false)
CAST_ENTRY(cast_seg_value_f64, double, 1, MODE_VALUE, false, false)
CAST_ENTRY(cast_sweep_f32, float, 1, MODE_SWEEP, false, false)
CAST_ENTRY(cast_sweep_f64, double, 1, MODE_SWEEP, false, false)
#endif
ATTRS_ENTRY(cast_seg_attrs, false)
