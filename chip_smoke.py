#!/usr/bin/env python3
"""Smoke run of the PyTorch port (trajopt_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Every line printed is one JSON object.  Phases, in order:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, and the build of every kernel of ``trajopt_tpu_torch/csrc``
   (one nvcc per library, all at once; K6's source once per dtype and
   range of block sizes; each library's build seconds); the registers and
   local memory of every K4 (n_dof 7 and the ceiling 12), K4v, K5, K7 and
   K7v instantiation and of K6's (float32 and float64 at every b from 1 to
   21) (``cudaFuncGetAttributes``),
   which the kernel summary repeats; the float32 K4 (n_dof 7), K4v
   without the CONVEX routes, K7 and K7v, and the float32 K6 at every b up to
   ``K6_F32_NO_LOCAL_MAX_B``, must use no local memory; then the registers and local memory of K10 / K10v (float32 and
   float64), of K6 at b 8 and (their ptxas lines) of K1-K3 at b 8;
2. each kernel held against its plain PyTorch version on the same inputs
   (tolerances below), in float32 and float64, then its time, its plain
   version's time, one PyTorch library call's time where one computes the
   same function, and its bound on the card:
   K1 bb_quad, K2 btd_factor, K3 btd_solve at the banded IPM's shapes
   (block sizes 7, 14, 21; K1 also at the collision row group, 29 gaps x
   28 rows; and all three at b 8, 128 x 30 x 8, the 1/dt grid, and at b
   2, 3 and 9); K4 cast_seg, K4v cast_seg_value (n_sub 2 and 3) and K5
   cast_sweep (n_sub 16) at the flagship's 128 lanes x 29 gaps x 28 pairs,
   on its initial trajectories plus seeded noise.  Their values are
   compared on every row (in float32 a row over the tolerance must be one
   whose plain value moves by more than it under a few ulps of change of
   x); their Jacobians on the rows whose witness decision is not tied
   (``CollisionWorld.cast_ties``), the tied rows counted;
2c. the CONVEX routes (the generic feature enumeration ``convex_feature``
   and the Frank-Wolfe max separation ``convex_fw``), each alone through
   the route probe ``convex_route`` on the vertex sets of the
   pick-and-place transfer world at 128 lanes x 11 gaps (n_sub 2) against
   its plain version, and timed;
2d. K6 ipm_banded against the plain IPM loop (``kernels=False``) on QPs
   captured from real solves: the full flagship's first QP and its second
   (the last with hinge rows active at the solution on many lanes), and
   the pick-and-place transfer's first, 128 lanes
   each, and the flagship's first regrouped to superblocks of two and
   three steps (K6 at b 14 and 21), in float32 and float64 (the float32
   capture cast up), each with the launcher's shared-memory plan for it
   (``ipm_qp.k6_smem_plan``: the factor's block inverses, M then W, V and
   the solves' scratch beside the n-vectors).  Per lane:
   status, iteration count and dx.  float64: equal statuses, and dx within
   K6_DX_TOL of the lane's largest |dx| on every lane whose iteration count
   is equal; a lane whose runs end apart must be a termination-threshold
   case (the run that stopped first did so with its ratio max(rp, rd)
   within K6_RATIO_BAND of 1).  float32: each lane's composite objective
   within K6_F32_GAP_TOL of the IPM's gap tolerance from the plain loop's,
   its status usable alike, and dx within K6_F32_DX_TOL of the lane's
   largest |dx| on every lane whose runs end alike (K6 constants below);
   then K6's time per call, the plain loop's, and K6's bound; and K6 at
   b 9 on the 9-DoF rail's first QP (128 lanes), and K6 at b 8 on phase
   7b's first QP (128 lanes), with the same checks, and their times (on
   7b's first QP the float32 dx is reported, not held:
   ``K6_F32_DX_REPORTED``); K6 at b 2 on phase 8b's first QP and at b 3
   on ``time_parameterized``'s form (128 lanes), with the same checks, and
   their times; at b 4, 6, 10, 12 and 20 on 8b's first QP regrouped
   (``K6_BOX_REGROUP``); and at every other block size the box slice
   instantiated (``K6_NEW_BLOCKS``) on the IPM fixture (``ipm_fixture``,
   128 lanes x 10 steps) in float64, with the same checks;
2h. (run after 2d) K11 ipm_dense against the plain IPM loop on the first
   QPs of the dense-row paths, captured from their solves on the card (128
   lanes each; each QP's shapes, route and block-route band printed):
   6a's and 6b's (K11's block route at b 7), 7c(i)'s (b 8), 7c(ii)'s and
   simple_collision's (its dense route), in float32 and float64 with phase 2d's rules; then
   on each, in float32, K11's time (the bare launch on the device clock,
   ``device_ms``, and the wrapper's CUDA events), the plain loop's, its
   bound (``k11_work``, over the nonzeros), the nonzeros per row kind and
   of P (``k11_nonzero_counts``), the lists' bytes and where its
   shared-memory plan put each region, and each K11 library's registers
   and local memory (at most ``K11_LOCAL_BYTES``);
2e. the kernels of the reference's solve benchmarks against their plain
   versions, float32 and float64, with phase 2's value and Jacobian rules
   (a float32 Jacobian row over its tolerance must be one whose plain
   Jacobian moves by more than it under a few ulps of x): K7 disc_dist
   and K7v disc_dist_value on the spherebot (128 lanes, one step) and on
   arm7's table world (128 lanes x 30 steps x 28 pairs, the flagship's
   initial trajectories plus seeded noise); K4 and K4v at n_sub 8 on the
   planning scene (128 x 5 gaps) and K4 at n_dof 9 on the rail (128 x 14
   gaps), then their times and bounds; K7 / K7v on boxbot (128 x 30, the
   box-box SAT distance) and K4, K4v and K5 at n_dof 2 on boxbot at phase
   8b's shapes (128 x 29 gaps x 47 segments, n_sub 48: the translating
   box's SAT sweep), the box-box rows' Jacobians held off the SAT max's
   near ties (``geometry.box_box_ties`` / ``swept_box_box_ties``,
   counted); K7 / K7v also on arm7 with 450 seeded table spheres (128 x 4
   steps x 3178 pairs), a world whose tables and slot records outgrow a
   block's shared memory (the plan's slots lowered; float64's tables read
   from global memory, asserted); then their times and bounds: K7 / K7v's
   the bare launch on
   the device clock (``device_ms`` of ``disc_bare_launch``) beside the
   wrapper's CUDA events (``wrapper_ms``) and, at arm7, one (lane, step),
   the launch floor (``one_slot_ms``);
3. the collision-free slice: ``make_glass_upright_free(batch=128, T=30,
   float32)`` through ``solve_batch_compact(bench_params(),
   phase_qp_solves=8)`` with every launch counter and the count of batched
   QP solves set to 0 just before and read just after; K6 must have
   launched once per batched QP solve and K1-K3 never (their math runs
   inside K6), no lane may be non-finite, and at least 120 of 128 lanes
   must be CONVERGED with max violation < 1e-4;
3b. the full flagship: ``make_glass_upright(batch=128, T=30, float32)``
   through the same solve (one cold run, three warm runs, counters reset
   before the first warm run), then the K5 gate (n_sub 16) on every lane;
   K6 once per batched QP solve, K1-K3 never, K4, K4v and K5 launched, no
   lane non-finite, and at least 120 of 128 lanes CONVERGED with max
   violation < 1e-4 and min swept distance >= 0 (the bench's gate);
3c. pick-and-place (BASELINE config 4): ``solve_pick_and_place(batch=128,
   T=12, float32)`` (one cold run, three warm runs, counters reset before
   the first warm run and read after it and both phases' gates), then one
   run phase by phase for each phase's wall and launches; each phase must
   gate at least 120 of 128 lanes (CONVERGED, max violation < 1e-4, the
   K5 gate at n_sub 16 >= 0 in the phase's own world), the transfer's
   step 0 must equal the approach's last step exactly, and the transfer
   must run K4, K4v, K5 and both CONVEX routes, each phase K6 once per
   batched QP solve and K1-K3 never; then K4, K4v and K5 on the
   transfer world (its straight-line init through the wall, that init
   plus seeded noise, and the solved trajectories) against their plain
   versions as in phase 2, the CONVEX pairs reported apart;
4. 16 lanes in float64 through the kernel path and through the plain path
   on the card, for the free slice (4) and the full flagship (4b), and 8
   lanes of each pick-and-place phase (4c): equal statuses and QP-solve
   counts, x within 1e-8 (free slice) and 3e-5 (flagship and the
   pick-and-place approach: a tied witness decision on a lane's path is
   resolved by rounding, which differs between the kernel and torch; the
   plain path from x0 moved by one ulp is printed beside it, and no lane
   may move further than that), and 1e-4 for the transfer
   (``TRANSFER_DX_TOL``);
5. ``run_benchmarks(batch=128, repeats=3)`` on the card (the reference's
   four solve benchmarks: simple_collision, planning, glass_upright,
   redundant_rail), each entry with every launch counter and the count of
   batched QP solves set to 0 just before and read just after: each
   entry's dict and launches; simple_collision must launch K7 and K7v,
   K11 once per batched QP solve (its one-step QP takes the dense rows:
   K11's dense route) and no K6, K1-K3 or torch Cholesky
   (``dense_path_ok``), planning K4 and K4v and
   K6 once per batched QP solve, the rail K6 at b 9 and K4 at n_dof 9; no
   lane non-finite; the K5 gate at n_sub 16 on the planning and rail
   lanes; converged and gated counts at or above ``BENCH_LIMITS`` (the
   JAX package's own counts on the CPU less 5);
5b. 8 lanes each of simple_collision, planning and the rail in float64
   through ``solve_batch``'s kernel path and plain path: equal statuses
   and QP counts, x within 3e-5 and the plain path's own one-ulp move;
   the rail from x0 plus seeded noise (its straight-line start sits on
   exact ties that each path resolves by its own rounding: the two paths'
   first QP solves from it are reported);
2f. (run after 5b) the pose kernels against their plain versions, float32
   and float64, 128 lanes: K9 cart_pose and K9v cart_pose_value at step
   20 of the flagship's initial trajectories plus seeded noise (a world
   target, a moving target link, a tolerance band), values on every row,
   Jacobians on the rows off the log map's and the band's switches
   (``cart_pose_ties``, counted); K8 solve_ik on phase 6c's queries
   (plain and ``pos_only``) against the plain loop
   (``solve_ik_plain_ties``): equal iteration counts and convergence
   except on lanes with a near-tie decision (counted), and on the lanes
   with equal counts q and the error norms within ``IK_Q_TOL`` /
   ``IK_ERR_CONV_TOL`` where both converged and ``IK_Q_STUCK_TOL`` /
   ``IK_ERR_TOL`` where both ran to the iteration limit (``ik_compare``);
   K8 at every n_dof from 1 to 12 (``serial_urdf`` chains, 16 lanes)
   against the plain loop by the same rule, float64, and at 12 also
   float32 and ``pos_only``; then their times (the bare launch on the
   device clock, ``device_ms``, and the whole wrapper), their plain
   versions' and their bounds, and their registers and local memory;
6a. cartesian waypoints (BASELINE config 2): arm7, 128 lanes x T=30,
   float32, ``cartesian_inputs`` (seed 0) built by
   ``port_cartesian_problem("waypoints")`` (cart_pose EQ at three waypoint
   steps, cart_vel INEQ, joint_vel cost, step 0 fixed) through
   ``solve_batch(SQPParams())``: one cold run, one warm run with the
   counters reset before it (6b: three); the dense-row QP must launch K11
   once per batched QP solve (its block route at b 7) and never K6, K1-K3
   or torch's dense Cholesky and triangular solves (``LINALG_CALLS``,
   counted by ``count_linalg``), the terms K9 and K9v; no lane
   non-finite; converged and
   gated (CONVERGED, max violation < 1e-4) at or above ``CART_LIMITS``
   (the JAX package's CPU counts less 5);
6b. the IK goal: the same starts, ik_term EQ at the last step (the goal's
   pose), joint_vel cost, from start -> goal + 0.2: as 6a, and K8 at least
   once per batched QP solve; the K8 launches of one more run (untimed,
   after the warm runs' counts are read) replayed on the device clock
   (``ik_launch_times``: each launch's ms and largest iteration count,
   their sum and its share of the warm runs' mean wall);
6c. ``solve_ik`` alone on ``ik_inputs`` (128 lanes, float32), plain and
   ``pos_only``: converged at or above ``CART_LIMITS``, iterations, error
   norms, K8's time;
6d. 8 lanes each of 6a and 6b in float64, kernel path against plain path:
   equal statuses and QP counts, x within 3e-5 and the plain path's own
   one-ulp move; the kernel path with K11 once per batched QP solve, as
   6a;
2g. (run after 6d) K10 contact_select and K10v against the plain
   selection (``contact_select_plain``), float32 and float64: the cast
   form on K4's outputs for phase 7a's x0 plus seeded noise (128 lanes x
   29 gaps x 7 segments x 28 pairs, K = 3) and the discrete form on K7's
   on arm7's table world (128 x 30 x 28); the selected values and rows
   bitwise equal on every (lane, group) off a near tie (two of the K + 1
   largest keys within ``SELECT_TIE_ULPS``; counted), K10's values
   K10v's (inputs: ``select_inputs``); then ``SELECT_SIZES`` on seeded
   inputs (``select_case``: exact ties, NaN distances, signed-zero keys,
   inactive pairs), both routes of ``select_route`` (P 33, 64, 65, 300; S
   47; K = P), float32 and float64, every output's bits equal to the
   plain selection's; then their times (the bare launch on the device
   clock, ``device_ms``; one (lane, group) for the launch floor), the
   plain version's, torch.topk's for the selection alone
   (``library_ms``), the bound (``select_work``) and the four
   instantiations' registers and local bytes (``kernel_attributes``);
7a. the ``arm_around_table.json`` form (``json_docs("table")``: one
   document per lane, ``port_json_problem``: ``load_problem`` with its
   defaults, n_sub 8, cull on; 28 pairs), 128 x T=30, float32, through
   ``solve_batch`` with the documents' own ``SQPParams``: one cold run,
   three warm runs, the counters reset before them; K6 once per batched
   QP solve at b 7, K4 once per batched QP solve (the cost and the
   constraint share one pipeline), K4v, K10 and K10v launched, K1-K3
   never, no lane non-finite; converged and gated (CONVERGED, max
   violation < 1e-4, K5 at n_sub 16 >= 0 on the full table world) at or
   above ``JSON_LIMITS``;
7b. the ``arm_around_table_time.json`` form (dt in [0.05, 0.5], the
   goal timed): as 7a, with K6 at b 8 on every batched QP solve, the
   collision pipeline at nc 8, and the 1/dt column inside its bounds;
7c. the timed velocity on the dense rows (no collision): (i) a timed
   joint_vel INEQ (|velocity| <= 1 rad/s) and the goal: K11 at b 8; (ii)
   plus a total_time cost: K11's dense route; each K11 once per batched
   QP solve, never K6, K1-K3 or torch's Cholesky; one cold and one warm
   run each; velocity and total time
   checked as ``tests/test_json_io.py`` does; counts at or above
   ``JSON_LIMITS``;
7d. the CLI: ``python3 -m trajopt_tpu_torch solve`` as a subprocess,
   with no ``--device``, on ``numerical_ik1.json``'s form (K9) and on 7a's
   document of lane 0: exit 0, OPT_CONVERGED, and the ``--out``
   trajectory within ``CLI_X_TOL`` of the in-process ``solve`` of the same
   document on the card;
7e. 8 lanes each of 7a and 7b in float64, kernel path against plain
   path: equal statuses; equal QP counts except on lanes where a path's
   count flips under one ulp of x0 (counted); x within ``JSON_DX_TOL`` on
   the lanes with equal counts;
7f. 7a's documents with both collision terms at evaluator_type 0, the
   reference's per-step discrete evaluator (``json_docs("table_discrete")``:
   dist_pen, coeffs and max_num_cnt 3 as 7a's), 128 x T=30, float32,
   ``load_problem``'s defaults, ``solve_batch``: one cold run, three warm
   runs, the counters reset before them; K6 once per batched QP solve at
   b 7, K7 once per batched QP solve (the cost and the constraint share one
   pipeline: 30 steps x 28 pairs), K7v, K10 and K10v (their discrete form,
   K = 3) launched, no cast kernel, K1-K3 never, no lane non-finite;
   converged and gated (CONVERGED, max violation < 1e-4) at or above
   ``JSON_LIMITS``; the K5 swept distance at n_sub 16 reported, not gated
   (a per-step term promises no swept-free path, in the reference either),
   with the warm wall, the mean QP solves and K7 / K7v / K10 / K10v's
   launches per batched QP solve;
8a. boxbot's ``box_cast_test.json`` form (``box_docs("box_cast")``: T=3,
   one document per lane, starts and goals moved by U(-0.2, 0.2) per
   joint, ``port_box_problem``: ``load_problem`` with n_sub
   ``box_n_sub``, 48 or the batch's largest longest_valid_segment_length
   count), 128 lanes, float32, the documents' own ``SQPParams``: one cold
   run, three warm runs with the counters reset before them; K6 at b 2
   once per batched QP solve, K4 at n_dof 2 once per batched QP solve, K4v
   launched, K1-K3 never; then the K5 gate (n_sub 16); converged and gated
   (CONVERGED, max violation < 1e-4, the gate >= 0) at or above
   ``BOX_LIMITS`` (the JAX package's CPU counts less 5);
8b. the same at T=30 (fixed steps 0 and 29, a joint_interpolated init:
   n_x 60, 1,363 swept hinge rows per lane at n_sub 48);
8c. each spherebot document of the JSON tests and the CLI test's
   (``spherebot_docs``) in 128 float32 copies: the status counts exactly
   the JAX package's (``SPHERE_DOC_COUNTS``; K6 at b 2 and 3, K7, K11's
   dense route on the one-step and total_time documents: every batched QP
   solve one K6 or one K11 launch, K1-K3 and torch's Cholesky never); and
   8 float64 copies, kernel path against plain path:
   equal statuses and QP counts, x within ``SPHERE_DX_TOL``;
8d. the CLI with no ``--device``: ``solve --model spherebot`` on the CLI
   test's document and ``solve --model boxbot --n-sub 48`` on 8a's
   document of lane 0: exit 0, OPT_CONVERGED, the ``--out`` trajectory
   within ``CLI_X_TOL`` of the in-process ``solve``;
8e. 8 lanes each of 8a and 8b in float64, kernel path against plain
   path: equal statuses and QP counts, x within 3e-5 and the plain path's
   own one-ulp move;
9. the kernel summary line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Any failure raises and the script exits non-zero.  It exits non-zero with
no result when CUDA is not available.
"""

import ctypes
import dataclasses
import json
import subprocess
import sys
import time

# kernel vs plain tolerance, relative to the plain result's largest entry:
# float32 carries ~7 digits and the kernels sum in another order than the
# plain versions (one FMA per step, the chains T*b long); float64 ~16
REL_TOL = {"float32": 1e-4, "float64": 1e-10}
# collision kernels: values relative to the largest |D| and Jacobians
# relative to the largest |J|; Jacobians on the rows without a tied
# decision (in float32 a decision within (rel, witness change, band in
# metres) of its runner-up or threshold, in float64 within rounding)
COLL_TOL = {"float32": (1e-4, 1e-3), "float64": (1e-10, 1e-8)}
TIE_RULE = {"float32": (1e-3, 1e-4, 1e-5), "float64": (1e-9, 1e-9, 0.0)}
# float32 values on every row: a hull route whose separation test is
# decided by rounding (a gap of ~1e-4 m against hulls ~1 m across: the
# test's own rounding error, extent * eps / gap, exceeds its margin)
# takes the other branch, and its value moves by the gap plus the depth
# cover's depth.  Every row over the value tolerance must be one whose
# plain value itself moves by more than that tolerance when the gap's two
# steps move by up to ULP_MOVE ulps (ULP_DRAWS seeded draws); at most
# D_OVER_SHARE of the rows may be such, and none beyond D_ALL_TOL
D_ALL_TOL, D_OVER_SHARE, ULP_MOVE, ULP_DRAWS = 1e-2, 1e-3, 16, 64
# the swept sphere against a box is d_capsule_box, whose tangent runs
# through 12 unconverged projections: in float32 its rows are held to
# this looser Jacobian tolerance (reported apart)
CAPBOX_JTOL = {"float32": 1e-2, "float64": 1e-8}
# float64 flagship, kernel path vs plain path: statuses and QP counts
# equal, x within this.  A lane whose path meets a tied witness decision
# takes another valid Jacobian there.  The phase also runs the plain path
# from x0 moved by one ulp, and no lane of the kernel path may move
# further than the farthest lane that move gives
FLAGSHIP_DX_TOL = 3e-5
# float64 pick-and-place transfer, kernel path vs plain path: the CONVEX
# routes' tied rows are not measure-zero there (the payload's faces are
# parallel to the wall's and to each other's poses), and on them the two
# roundings take Frank-Wolfe polish paths of different values (the plain
# version alone moves as far under a few ulps of x); over a long solve a
# lane's x then moves further than one ulp of x0 moves it.  The transfer
# is held to the SQP's own step floor, SQPParams.min_trust_box_size
# (measurements: PERF.md section 6)
TRANSFER_DX_TOL = 1e-4
# the kernels the flagship's path launches (K6 once per batched QP solve);
# pick-and-place's transfer also runs the two CONVEX routes inside K4, K4v
# and K5.  K1-K3 are held against their plain versions in phase 2 and run
# on no path: their math is K6's and K11's (csrc/banded.cuh)
PATH_KERNELS = ("ipm_banded", "cast_seg", "cast_seg_value", "cast_sweep")
QP_KERNELS = ("bb_quad", "btd_factor", "btd_solve")
# run_benchmarks at batch 128, float32: the JAX package's own counts on the
# CPU (scripts/jax_reference_counts.py, seed 0) less 5, as the transfer's
# gate limit is its JAX count less 5 (converged; gated: CONVERGED, max
# violation < 1e-4 and, with a collision world over gaps, the n_sub=16
# swept check >= 0)
BENCH_LIMITS = {"simple_collision": {"converged": 123, "gated": 123},
                "planning": {"converged": 123, "gated": 121},
                "redundant_rail": {"converged": 45, "gated": 45}}
# K6 vs the plain loop, float64: dx relative to the lane's largest |dx| on
# lanes with equal iteration counts (the same Newton sequence in another
# sum order: ~1e-15 per step, amplified by the late barrier stages'
# conditioning); a lane whose runs stop at different iterations must have
# stopped first with max(rp, rd) within K6_RATIO_BAND of 1 (an iterate
# moved by rounding moves the ratio by ~|K| |delta dx| / eps ~ 1e-8)
K6_DX_TOL = 1e-9
K6_RATIO_BAND = {"float64": 1e-6, "float32": 1e-2}
# float32: on every lane the composite objective at K6's dx within
# K6_F32_GAP_TOL of the IPM's own gap tolerance eps_g = eps_abs (max(|f|,
# |f(0)|) + 1) from the plain loop's, and the SQP's verdict on the status
# alike (usable: 1 or 2); on the lanes whose runs end alike (equal status
# and iteration count) dx within K6_F32_DX_TOL of the lane's largest |dx|.
# In float32 the Newton steps of two sum orders drift apart over the late
# barrier stages (D up to 1e10), so a run may end at another iteration, on
# the threshold or on the NaN guard (a non-finite step; the incumbent is
# returned): those lanes' dx, iterations and statuses are reported, not
# held.  The limits sit ~4x and ~10x above the largest readings on the
# H100 (dx 5.4e-3, objective 5.1e-3 eps_g, the flagship's second QP), well
# under what a wrong float32 constant or instantiation gives (dx off by
# the step's own size, objective off by many eps_g)
K6_F32_DX_TOL = 2e-2
# the float32 QPs whose dx is reported, not held: phase 7b's first QP
# (b 8) leaves its minimizer far from unique at float32's resolution: half
# of its 1,218 hinge rows violated at dx = 0, every lane ends at status 2
# (inaccurate) on both sides, max(rp, rd) up to ~1e6 at the stop; on the
# H100 K6 and the plain loop end with objectives 0.025 eps_g apart and dx
# 0.108 of the lane's largest apart on lanes ending alike.  There the
# objective and usability are held as on every QP, and float64 holds dx to
# K6_DX_TOL.  Phase 2h's K11 on 6a's first QP likewise: in float32 every
# lane ends at status 2 on both K11 and the plain loop (stopped by the NaN
# guard after ~13 iterations), their dx a few percent of the lane's
# largest apart (PERF.md section 6)
K6_F32_DX_REPORTED = ("json_table_time_qp1", "cartesian_waypoints_qp1")
K6_F32_GAP_TOL = 0.05
# K6 in float32 keeps its lane view in registers and shared memory up to
# this block size (cudaFuncGetAttributes: no local memory)
K6_F32_NO_LOCAL_MAX_B = 16
# K11's local memory per library (cudaFuncGetAttributes), at most the
# bytes it took before its block route's factor and solves took the
# block-inverse form (on an H100 80GB HBM3 at 700 W)
K11_LOCAL_BYTES = {"f32_b1_9": 336, "f32_b10_14": 672, "f32_b15_18": 1024,
                   "f32_b19_21": 1280, "f64_b1_9": 624, "f64_b10_14": 800,
                   "f64_b15_18": 880, "f64_b19_21": 944, "f32_dense": 96,
                   "f64_dense": 256}
# H100 SXM peaks (NVIDIA data sheet): HBM 3.35 TB/s; non-tensor-core
# float32 67 TFLOP/s, float64 34 TFLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


# flops of the collision kernels' pieces, counted from csrc/collision.cuh
# (value arithmetic; a dual number with N tangent columns costs ~1 + 1.5 N
# times as much): FK per link, joint frame per dof, canonical form per
# geometry; discrete distance per kind pair; one candidate of the hull
# enumeration (edge-edge, vertex-triangle); the witness / separation test
# and the 26-direction depth cover per vertex
FK_LINK, FK_DOF, FK_GEOM = 150, 18, 72
# (2, 2): d_box_box's 15 axes (~59 flops an axis, the nine crosses ~77);
# SWEPT_BOXBOX: d_swept_box_box's 21 (~76 an axis, with the generators)
DISCRETE = {(0, 0): 12, (0, 1): 40, (0, 2): 45, (1, 1): 70, (1, 2): 385,
            (2, 2): 1060}
SWEPT_BOXBOX = 1620
CAND_EE, CAND_PT, WITNESS_V, COVER_V = 85, 130, 20, 156
_TOPO = {1: (1, 0), 2: (1, 0), 4: (6, 4), 8: (12, 12)}
# the Frank-Wolfe route, per vertex of both sets: a support value (dot and
# compare) 6, a weighted vertex sum 6; per step (gamma, the weights) 30
SUPPORT_V, FW_STEP, FW_ITERS = 6, 30, 24
GENERIC_MAX = 12  # geometry.GENERIC_FEATURE_MAX_VERTS


def feature_flops(n1, n2, generic):
    """flops of one feature enumeration (candidates and witness) at sizes
    (n1, n2): the small-hull topologies, or all pairs and triples."""
    def topo(n):
        if not generic or n <= 2:
            return _TOPO[n]
        return n * (n - 1) // 2, n * (n - 1) * (n - 2) // 6
    (e1, t1), (e2, t2) = topo(n1), topo(n2)
    return e1 * e2 * CAND_EE + (n1 * t2 + n2 * t1) * CAND_PT \
        + WITNESS_V * (n1 + n2)


def fw_flops(n1, n2):
    """flops of one Frank-Wolfe max separation (csrc/collision.cuh
    fw_witness): the FW steps, the 28 directions, six polish steps, the
    sharing and the value."""
    n = n1 + n2
    return (FW_ITERS * (2 * SUPPORT_V * n + FW_STEP) + 28 * SUPPORT_V * n
            + 6 * (2 * SUPPORT_V * n + FW_STEP) + 3 * SUPPORT_V * n)


def convex_flops(n1, n2):
    """flops of d_convex_auto at sizes (n1, n2) (the depth cover of the
    generic route counted apart)."""
    if max(n1, n2) <= GENERIC_MAX:
        return feature_flops(n1, n2, True)
    return fw_flops(n1, n2)


def cast_work(world, D, lanes, n_gaps, n_sub, es, nd):
    """(bytes, flops) of K4 ("jac"), K4v ("value") and K5 ("sweep") on
    these inputs: each input read once, each output written once; the
    feature enumerations' depth cover is counted on the rows this data
    penetrates (D within 1e-6 of -(r1 + r2), the separation test's
    threshold), a CONVEX pair's substates at the rows of its swept value
    (D bounds them from below)."""
    L, NG, P = world.chain.n_links, len(world.geoms), world.n_pairs
    dual = lambda n: 1 + 1.5 * n
    fk = L * FK_LINK + nd * FK_DOF + NG * FK_GEOM
    routes = world.pair_routes()
    nv = world.n_convex_verts
    support = {0: 1, 1: 2, 2: 8, 3: nv}
    Dl = D.reshape(lanes, n_gaps, -1, P)
    pen = 0
    per = {"jac": 0.0, "value": 0.0, "sweep": 0.0}
    for k, ((i, j), (route, hull)) in enumerate(zip(world.pairs, routes)):
        gi, gj = world.geoms[i], world.geoms[j]
        n_pen = int((Dl[..., k] <= -(gi.radius + gj.radius) + 1e-6).sum())
        if gj.kind == 3:  # a CONVEX side: d_convex_auto, witness-linear
            n1 = support[gi.kind]
            c = convex_flops(n1, nv)
            if max(n1, nv) <= GENERIC_MAX:
                pen += n_pen * n_sub * COVER_V * (n1 + nv)
            per["jac"] += n_sub * (c + 16 * nd * (n1 + nv))
            per["value"] += n_sub * c
            per["sweep"] += n_sub * c
            if route == "convex":
                na, nb = hull
                h = convex_flops(na, nb)
                if max(na, nb) <= GENERIC_MAX:
                    pen += n_pen * COVER_V * (na + nb)
                seg = n_sub - 1
                per["jac"] += seg * (h + 16 * nd * (na + nb))
                per["value"] += seg * h
                per["sweep"] += h
            continue
        disc = DISCRETE[(gi.kind, gj.kind)]
        if route == "boxbox":  # the translating box's exact sweep
            per["jac"] += SWEPT_BOXBOX * dual(2 * nd)
            per["value"] += SWEPT_BOXBOX
            per["sweep"] += SWEPT_BOXBOX
            continue
        if route == "sphere":
            other = gj if gi.kind == 0 else gi
            sw = DISCRETE[(1, other.kind)] if other.kind != 0 else DISCRETE[(0, 1)]
            per["jac"] += sw * dual(2 * nd)
            per["value"] += sw
            per["sweep"] += sw
            continue
        per["jac"] += n_sub * (disc * dual(nd) + 4 * nd * 11)
        per["value"] += n_sub * disc
        per["sweep"] += n_sub * disc
        if route == "hull":
            na, nb = hull
            h = feature_flops(na, nb, False)
            pen += n_pen * COVER_V * (na + nb)
            seg = n_sub - 1
            per["jac"] += seg * (h + 16 * nd * (na + nb))
            per["value"] += seg * h
            per["sweep"] += h
    blocks = lanes * n_gaps
    tables = sum(t.numel() * t.element_size()
                 for t in world.kernel_tables(D.dtype, D.device))
    x_bytes = lanes * (n_gaps + 1) * nd * es
    n_seg = n_sub - 1
    d_bytes = lanes * n_gaps * n_seg * P * es
    out = {
        "jac": (x_bytes + tables + d_bytes * (1 + 2 * nd),
                blocks * (n_sub * fk + per["jac"]) + pen),
        "value": (x_bytes + tables + d_bytes,
                  blocks * (n_sub * fk + per["value"]) + pen),
        "sweep": (x_bytes + tables + lanes * n_gaps * P * es,
                  blocks * ((n_sub + 1) * fk + per["sweep"]) + pen),
    }
    return out


def k6_work(qp, b, iters, es):
    """(bytes, flops) that one K6 ipm_banded launch's function needs on
    these inputs: each input read once (P's scaled and raw blocks, six
    n-vectors, the scaled and raw rows, four per-row vectors, the row
    tables) and each output written once; against the least arithmetic of
    the iterations this run's lanes took (``iters``).  Per row and
    iteration: ten passes over its 2b window (~52 b: the matvecs of the
    barrier diagonals, the residuals, two Newton solves with their
    refinement, the termination test, the composite objective) and its
    share of the assembly, 2 flops per unique entry of the symmetric
    2b x 2b outer product with d a_i formed once (4 b^2 + 4 b).  Per block
    and iteration: the Cholesky step b^3 / 3, the sub-diagonal solve
    L_k+1,k = O L_k^-T b^3, the symmetric Schur update b^3, and 54 b^2
    (four block solves, five P products).  ~100 flops per column; plus the
    initial point."""
    lanes, n = qp.q.shape
    mh, ma = qp.e_h.shape[1], qp.e_a.shape[1]
    m, nb = mh + ma, n // b
    per_it = m * (52 * b + 4 * b * b + 4 * b) \
        + nb * (b ** 3 / 3 + 2 * b ** 3 + 54 * b * b) + 100 * n
    flops = float(iters.double().sum()) * per_it + lanes * (m * 4 * b + 10 * n)
    ins = 2 * (2 * nb - 1) * b * b + 6 * n + 2 + 2 * m * 2 * b + 4 * m
    outs = 4 * n + 2 * mh + 3 * ma + 3
    nbytes = lanes * (es * (ins + outs) + 4 * 2) + 4 * (m + 8)
    return nbytes, flops



def k11_nonzero_counts(qp, su):
    """Per lane (numpy int64 arrays): the nonzeros K11's lists hold, of the
    scaled Jh and Ja ("h", "a"), the raw rows ("rh", "ra"), P scaled and
    raw ("p", "pr"); and "pairs", the pairs (r >= c) of a scaled row's
    nonzeros that fall in the part of K the assembly fills (the block
    route's band at su.bsz, else the lower triangle), summed over the
    rows of both kinds."""
    import torch

    def nz(M):
        return (M != 0).flatten(1).sum(1).cpu().numpy()
    out = {"h": nz(su.Jh), "a": nz(su.Ja), "rh": nz(qp.A_h),
           "ra": nz(qp.A_a), "p": nz(su.P), "pr": nz(qp.P)}
    pairs = torch.zeros(qp.q.shape[0], dtype=torch.int64,
                        device=qp.q.device)
    for J in (su.Jh, su.Ja):
        Z = (J != 0).to(torch.int64)
        if su.nb:  # per block of b columns: D's triangles and O
            c = Z.reshape(Z.shape[0], Z.shape[1], su.nb, su.bsz).sum(-1)
            pairs += (c * (c + 1) // 2).sum((1, 2)) \
                + (c[..., 1:] * c[..., :-1]).sum((1, 2))
        else:
            c = Z.sum(-1)
            pairs += (c * (c + 1) // 2).sum(1)
    out["pairs"] = pairs.cpu().numpy()
    return out


def k11_work(qp, su, iters, es):
    """(bytes, flops) that one K11 ipm_dense launch's function needs on
    these inputs: each input read once (P' scaled and raw, six n-vectors,
    the scaled and raw dense rows, four per-row vectors) and each output
    written once; against the least arithmetic of the iterations each lane
    took (``iters``) over that lane's nonzeros (``k11_nonzero_counts``: a
    sum over zeros is no work).  Per iteration: twelve passes over the
    scaled rows' nonzeros and one over the raw rows' (2 flops a nonzero:
    the matvecs of the barrier diagonals, the residuals, two Newton solves
    with their right-hand sides and refinement, the composite objective),
    four products with P's nonzeros and one with the raw P's, the
    assembly's share of J' D J: 2 flops per pair of a row's nonzeros in
    the part of K it fills, with d a_i formed once (one per nonzero); the
    factor (block route nb (b^3 / 3 + 2 b^3), dense route n^3 / 3), four
    solves (block 4 n b each, dense 2 n^2), ~100 flops per column and 30
    per row; plus the initial point."""
    lanes, n = qp.q.shape
    mh, ma = qp.e_h.shape[1], qp.e_a.shape[1]
    m, nb, b = mh + ma, su.nb, su.bsz
    c = k11_nonzero_counts(qp, su)
    nzj = c["h"] + c["a"]
    if nb:
        fac, sol = nb * (b ** 3 / 3 + 2 * b ** 3), 4 * 4 * n * b
    else:
        fac, sol = n ** 3 / 3, 4 * 2 * n * n
    per_it = 24 * nzj + 2 * (c["rh"] + c["ra"]) + 8 * c["p"] \
        + 2 * c["pr"] + 2 * c["pairs"] + nzj + fac + sol + 100 * n + 30 * m
    it = iters.double().cpu().numpy()
    flops = float((it * per_it).sum()) + float((2 * nzj + 10 * n).sum())
    ins = 2 * n * n + 6 * n + 2 + 2 * m * n + 4 * m
    outs = 4 * n + 2 * mh + 3 * ma + 3
    nbytes = lanes * (es * (ins + outs) + 4 * 2)
    return nbytes, flops

# The cartesian slice (phases 2f and 6a-6d): the pose kernels K9
# cart_pose / K9v cart_pose_value and K8 solve_ik against their plain
# versions.  Values within REL_TOL of the largest |E|; Jacobians within
# COLL_TOL's Jacobian tolerance of the largest |J| on the rows whose
# decisions (the log map's pivot, hemisphere, clip and Taylor switch, the
# band's edges) are not within POSE_TIE_ULPS ulps of a unit scale
# (cart_pose_ties), the others counted: two roundings may take either
# side there (the value is continuous, its tangent is not).
POSE_TIE_ULPS = 64
# K8 (ik_compare): equal iteration counts and convergence except on lanes
# where an accept (err_new < err) or stop (err > tol) decision had sides
# within IK_TIE_ULPS ulps of the larger side or of 1 (a pose's scale,
# metres and radians: the pose error's rounding is absolute, ~an ulp of
# the poses it subtracts), counted by solve_ik_plain_ties.  On the lanes
# whose counts are equal:
# - both converged: q within IK_Q_TOL (in float32 the 7-DoF arm's
#   converged q is unique only up to its null-space direction, a 6-D
#   pose, along which the damped steps' rounding drifts) and the error
#   norms, both at most tol, within IK_ERR_CONV_TOL of each other (in
#   float32 they sit at the pose error's rounding floor, a few ulps of 1);
# - both ran to the iteration limit without converging (stuck: lam
#   doubling and halving on near-equal errors, q often at a joint bound):
#   q within IK_Q_STUCK_TOL and the error norms within IK_ERR_TOL of the
#   plain one's, relative.
# Each limit is set from this phase's readings on an H100 (the worst lane
# of the plain and pos_only runs; PERF.md section 6), float32 / float64:
#   q converged     1.57e-3 / 2.46e-12
#   err converged   2.77e-7 / 6.71e-16
#   q stuck         3.85e-2 / 1.05e-8
#   err stuck, rel  1.12e-2 / 1.08e-10
IK_TIE_ULPS = 4
IK_Q_TOL = {"float32": 1e-2, "float64": 1e-10}
IK_ERR_CONV_TOL = {"float32": 6e-7, "float64": 1e-13}
IK_Q_STUCK_TOL = {"float32": 2e-1, "float64": 1e-6}
IK_ERR_TOL = {"float32": 5e-2, "float64": 1e-8}
# phases 6a-6c at 128 lanes, float32: the JAX package's own counts on the
# CPU (scripts/jax_reference_counts.py --cartesian, seed 0) less 5
# (JAX: 128 / 128, 128 / 128, 119, 128)
CART_LIMITS = {"cartesian_waypoints": {"converged": 123, "gated": 123},
               "ik_goal": {"converged": 123, "gated": 123},
               "solve_ik": {"converged": 114},
               "solve_ik_pos_only": {"converged": 123}}


def rot_log_margins(R):
    """How far each decision of ``lie.rot_log(R)`` is from switching, each
    (...,): the gap between its two largest pivots (the candidate), |w|
    (the hemisphere), 1 - |w| (the clip to [-1, 1], whose tangent splits at
    a tie) and |vn - 1e-8| (the Taylor switch)."""
    import torch

    from trajopt_tpu_torch.ops.lie import _quaternion

    m00, m11, m22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    pivots = torch.stack([m00 + m11 + m22, m00 - m11 - m22,
                          -m00 + m11 - m22, -m00 - m11 + m22], -1)
    top = torch.topk(pivots, 2, dim=-1).values
    q = _quaternion(R)
    w = q[..., 0].abs()
    vn = torch.linalg.norm(q[..., 1:], dim=-1)
    return top[..., 0] - top[..., 1], w, 1.0 - w, (vn - 1e-8).abs()


def cart_pose_ties(chain, x, p, n_steps, step, src, tgt=None, n_cols=None):
    """(B, 6) bool: the rows of ``cart_pose_rows`` whose Jacobian sits at
    a decision within POSE_TIE_ULPS ulps (of a unit scale) of switching, in
    x's dtype: the log map's decisions (``rot_log_margins``) flag the three
    rotation rows; each band edge its own row."""
    import torch

    from trajopt_tpu_torch.ops.lie import transform_error
    from trajopt_tpu_torch.terms.cartesian import _poses
    from trajopt_tpu_torch.utils.lanes import lane_broadcast

    nc = n_cols or chain.n_dof
    B = x.shape[0]
    q = x.reshape(B, n_steps, nc)[:, step, :chain.n_dof]
    Rt, pt, Rs, ps = _poses(chain, q, p, src, tgt)
    k = POSE_TIE_ULPS * torch.finfo(x.dtype).eps
    dR = torch.einsum("...ji,...jk->...ik", Rt, Rs)
    rot = torch.stack(rot_log_margins(dR), -1).le(k).any(-1)
    ties = torch.zeros((B, 6), dtype=torch.bool, device=x.device)
    ties[:, 3:] = rot[:, None]
    if "lower_tols" in p and "upper_tols" in p:
        err = transform_error(Rt, pt, Rs, ps)
        for key in ("lower_tols", "upper_tols"):
            edge = lane_broadcast(p[key].to(x.dtype), (6,))
            ties |= (err - edge).abs() <= k * torch.clamp(edge.abs(), min=1.0)
    return ties


def solve_ik_plain_ties(chain, link, target_R, target_p, q0, pos_only,
                        max_iters=60, tol=1e-6, damping=1e-3):
    """``kinematics.ik.solve_ik_plain``'s loop, step for step (its start,
    step and accept), noting per lane whether any of its decisions
    (``err_new < err``, ``err > tol``) had sides within IK_TIE_ULPS ulps
    (of the larger side or of 1): (IKResult, ties (B,) bool)."""
    import torch

    from trajopt_tpu_torch.kinematics import ik
    from trajopt_tpu_torch.utils.lanes import lane_select

    q, err, lam, step = ik._plain_start(chain, link, target_R, target_p,
                                        damping, pos_only, q0)
    eps = torch.finfo(err.dtype).eps
    tol_t = torch.full((), tol, dtype=err.dtype, device=err.device)

    def near(a, b):
        scale = torch.clamp(torch.maximum(a.abs(), b.abs()), min=1.0)
        return (a - b).abs() <= IK_TIE_ULPS * eps * scale

    it = torch.zeros(err.shape, dtype=torch.int32, device=err.device)
    act = (it < max_iters) & (err > tol)
    tie = near(err, tol_t)
    while bool(act.any()):
        q_new, err_new = step(q, lam)
        new = ik._plain_accept(q, lam, it, err, q_new, err_new)
        tie = tie | (act & (near(err_new, err) | near(new[3], tol_t)))
        q, lam, it, err = [lane_select(act, a, b)
                           for a, b in zip(new, (q, lam, it, err))]
        act = (it < max_iters) & (err > tol)
    return ik.IKResult(q=q, err_norm=err, converged=err <= tol,
                       iters=it), tie


def ik_compare(kr, pr, tie, name):
    """K8's result ``kr`` against the plain loop's ``pr`` (with its near-tie
    lanes ``tie``) by the rule above: a record with "ok"."""
    same_it = kr.iters == pr.iters
    same = same_it & (kr.converged == pr.converged)
    conv = same_it & kr.converged & pr.converged
    stuck = same_it & ~kr.converged & ~pr.converged
    dq = (kr.q - pr.q).abs().amax(-1)
    de = (kr.err_norm - pr.err_norm).abs()
    de_rel = de / pr.err_norm.abs()

    def worst(v, lanes):
        return float(v[lanes].max()) if lanes.any() else 0.0

    rec = {"lanes": int(kr.iters.numel()),
           "converged": int(kr.converged.sum()),
           "converged_plain": int(pr.converged.sum()),
           "lanes_apart": int((~same).sum()),
           "lanes_near_tie": int(tie.sum()),
           "apart_and_not_tied": int((~same & ~tie).sum()),
           "lanes_converged_equal": int(conv.sum()),
           "lanes_stuck_equal": int(stuck.sum()),
           "q_abs_err_converged_equal": worst(dq, conv),
           "err_norm_abs_err_converged_equal": worst(de, conv),
           "q_abs_err_stuck_equal": worst(dq, stuck),
           "err_norm_rel_err_stuck_equal": worst(de_rel, stuck),
           "q_tol": IK_Q_TOL[name], "err_conv_tol": IK_ERR_CONV_TOL[name],
           "q_stuck_tol": IK_Q_STUCK_TOL[name], "err_tol": IK_ERR_TOL[name]}
    rec["ok"] = rec["apart_and_not_tied"] == 0 \
        and rec["q_abs_err_converged_equal"] <= IK_Q_TOL[name] \
        and rec["err_norm_abs_err_converged_equal"] \
        <= IK_ERR_CONV_TOL[name] \
        and rec["q_abs_err_stuck_equal"] <= IK_Q_STUCK_TOL[name] \
        and rec["err_norm_rel_err_stuck_equal"] <= IK_ERR_TOL[name]
    return rec


def cartesian_inputs(lanes, n_steps=30, seed=0):
    """The inputs of the cartesian scenes (phases 6a, 6b, 6d), numpy
    only (the port's float64 FK on the CPU for the poses): per lane the
    start and goal of ``make_glass_upright`` (Q_START / Q_GOAL + U(-0.15,
    0.15) on the yaw joints), the waypoint steps (T // 3, 2 T // 3, T - 1),
    their configurations (the straight joint path there + U(-0.1, 0.1) per
    joint; the goal itself at T - 1) and the tool's poses at them; the
    initial trajectories (6a: the straight path start -> goal, 6b: start ->
    goal + 0.2); and cart_vel's max displacement, 1.5 x the largest tool
    step of 6a's initial trajectories over all lanes (a rule fixed before
    the first chip run; its value at 128 x 30 in PERF.md section 4)."""
    import numpy as np
    import torch

    from trajopt_tpu_torch.benchmarks import Q_GOAL, Q_START
    from trajopt_tpu_torch.models import arm7
    from trajopt_tpu_torch.problem.trajectory import interpolated_init

    _, chain = arm7()
    tool = chain.link_index("tool")
    T, D = n_steps, chain.n_dof
    steps = (T // 3, 2 * T // 3, T - 1)
    rng = np.random.default_rng(seed)
    yaw = np.array([1.0, 0, 0, 0, 0, 0, 1.0])
    start = np.empty((lanes, D))
    goal = np.empty((lanes, D))
    wq = np.empty((lanes, 3, D))
    for i in range(lanes):
        start[i] = Q_START + rng.uniform(-0.15, 0.15, D) * yaw
        goal[i] = Q_GOAL + rng.uniform(-0.15, 0.15, D) * yaw
        line = interpolated_init(start[i], goal[i], T)
        wq[i, 0] = line[steps[0]] + rng.uniform(-0.1, 0.1, D)
        wq[i, 1] = line[steps[1]] + rng.uniform(-0.1, 0.1, D)
        wq[i, 2] = goal[i]
    init_a = np.stack([interpolated_init(s, g, T) for s, g in zip(start, goal)])
    init_b = np.stack([interpolated_init(s, g + 0.2, T)
                       for s, g in zip(start, goal)])

    def fk(q):
        R, p = chain.fk(torch.as_tensor(q, dtype=torch.float64))
        return R[..., tool, :, :].numpy(), p[..., tool, :].numpy()

    wR, wp = fk(wq)
    _, tp = fk(init_a)
    vel = 1.5 * float(np.abs(np.diff(tp, axis=1)).max())
    return {"steps": steps, "start": start, "goal": goal, "waypoint_q": wq,
            "waypoint_R": wR, "waypoint_p": wp, "init_waypoints": init_a,
            "init_ik_goal": init_b, "max_displacement": vel}


def ik_inputs(lanes, seed=0):
    """Phase 6c's IK queries, numpy only: q in the middle half of arm7's
    joint box, the tool's float64 pose there (the target) and the seed
    q + 0.3 (1, -1, 1, -1, 1, -1, 1) (``tests/test_ik.py``)."""
    import numpy as np
    import torch

    from trajopt_tpu_torch.models import arm7

    _, chain = arm7()
    tool = chain.link_index("tool")
    rng = np.random.default_rng(seed)
    q = chain.lb + (chain.ub - chain.lb) * (
        0.25 + 0.5 * rng.uniform(0.0, 1.0, (lanes, chain.n_dof)))
    R, p = chain.fk(torch.as_tensor(q, dtype=torch.float64))
    seed_q = q + 0.3 * np.array([1, -1, 1, -1, 1, -1, 1.0])
    return {"q": q, "target_R": R[:, tool].numpy(),
            "target_p": p[:, tool].numpy(), "q0": seed_q, "link": tool}


def serial_urdf(n):
    """A serial arm of n revolute joints as a URDF string (axes z, y, x
    in turn, every fourth origin turned), then a fixed ``tool`` link:
    K8's chains of every n_dof (phase 2f)."""
    axes = ("0 0 1", "0 1 0", "1 0 0")
    links = ['<link name="base"/>'] + [f'<link name="s{i}"/>'
                                       for i in range(1, n + 1)]
    joints = []
    for i in range(1, n + 1):
        parent = "base" if i == 1 else f"s{i - 1}"
        rpy = "0.1 0 0.2" if i % 4 == 0 else "0 0 0"
        joints.append(
            f'<joint name="q{i}" type="revolute">'
            f'<origin xyz="0.01 0 {0.08 + 0.01 * (i % 3)}" rpy="{rpy}"/>'
            f'<parent link="{parent}"/><child link="s{i}"/>'
            f'<axis xyz="{axes[i % 3]}"/>'
            '<limit lower="-2.6" upper="2.6" velocity="2"/></joint>')
    links.append('<link name="tool"/>')
    joints.append('<joint name="tool_fix" type="fixed">'
                  '<origin xyz="0 0 0.1"/>'
                  f'<parent link="s{n}"/><child link="tool"/></joint>')
    return '<robot name="serial">' + "".join(links + joints) + "</robot>"


def serial_ik_queries(chain, lanes, seed):
    """IK queries on a chain as ``ik_inputs`` makes them (numpy draws):
    q in the middle half of the joint box, the tool's float64 pose there,
    the seed q + 0.3 (1, -1, 1, ...); (link, R, p, q0) float64 CPU
    tensors."""
    import numpy as np
    import torch

    tool = chain.link_index("tool")
    rng = np.random.default_rng(seed)
    q = chain.lb + (chain.ub - chain.lb) * (
        0.25 + 0.5 * rng.uniform(0.0, 1.0, (lanes, chain.n_dof)))
    R, p = chain.fk(torch.as_tensor(q, dtype=torch.float64))
    sign = np.where(np.arange(chain.n_dof) % 2 == 0, 1.0, -1.0)
    return tool, R[:, tool], p[:, tool], torch.as_tensor(q + 0.3 * sign)


def port_cartesian_problem(kind, inp, dtype, device):
    """(spec, batched data, chain) of a cartesian scene through the port's
    public term API.  ``kind`` "waypoints" (BASELINE config 2, phase 6a):
    joint_vel cost (coeffs 1), cart_pose EQ on the tool at the three
    waypoint steps, cart_vel INEQ on the tool over every gap, step 0
    fixed; "ik_goal" (phase 6b): joint_vel cost, ik_term EQ on the tool at
    the last step (target: the goal's pose), step 0 fixed."""
    import numpy as np
    import torch

    from trajopt_tpu_torch.kinematics.ik import ik_term
    from trajopt_tpu_torch.models import arm7
    from trajopt_tpu_torch.problem.trajectory import (TrajProblemBuilder,
                                                      stack_data)
    from trajopt_tpu_torch.terms.cartesian import (cart_pose_term,
                                                   cart_vel_term,
                                                   default_cart_pose_params)
    from trajopt_tpu_torch.terms.joint import joint_vel_term

    _, chain = arm7()
    T, D = inp["init_waypoints"].shape[1], chain.n_dof
    npdt = np.float64 if dtype == torch.float64 else np.float32
    b = TrajProblemBuilder(chain, T, device=device)
    b.add_cost(joint_vel_term("jvel", T, D),
               {"targets": np.zeros(D, npdt), "coeffs": np.ones(D, npdt)})

    def cnt(i):
        if kind == "waypoints":
            out = [{k: np.asarray(v, npdt) for k, v in default_cart_pose_params(
                inp["waypoint_R"][i, w], inp["waypoint_p"][i, w]).items()}
                for w in range(3)]
            return out + [{"max_displacement": np.asarray(
                inp["max_displacement"], npdt)}]
        return [{"target_R": np.asarray(inp["waypoint_R"][i, 2], npdt),
                 "target_p": np.asarray(inp["waypoint_p"][i, 2], npdt),
                 "coeffs": np.ones(D, npdt)}]

    if kind == "waypoints":
        for w, s in enumerate(inp["steps"]):
            b.add_constraint(cart_pose_term(f"pose{w}", chain, T, s, "tool"),
                             cnt(0)[w])
        b.add_constraint(cart_vel_term("cart_vel", chain, T, "tool",
                                       is_constraint=True), cnt(0)[3])
        init = inp["init_waypoints"]
    else:
        b.add_constraint(ik_term("ik_goal", chain, T, T - 1, "tool"),
                         cnt(0)[0])
        init = inp["init_ik_goal"]
    b.fix_timestep(0)
    datas = []
    for i in range(init.shape[0]):
        spec, data = b.build(np.asarray(init[i], npdt))
        data = data._replace(cnt_params=tuple(
            {k: torch.as_tensor(v, device=b.device) for k, v in c.items()}
            for c in cnt(i)))
        datas.append(data)
    return spec, stack_data(datas), chain


JSON_KINDS = ("table", "table_time", "timed_vel", "timed_vel_total",
              "table_discrete")


def json_docs(kind, lanes, n_steps=30, seed=0):
    """Phase 7's reference-format problem documents, one per lane (JSON
    objects; numpy only), on arm7 from ``make_glass_upright``'s starts and
    goals (the same draws, seed 0):

    - "table" (7a, ``arm_around_table.json``'s form): step 0 fixed;
      costs joint_vel (coeffs 1) and a cast collision (evaluator_type 3,
      dist_pen 0.025, coeffs 20, max_num_cnt 3); constraints the goal
      joint_pos at the last step and a cast collision (dist_pen 0.01,
      max_num_cnt 3); init joint_interpolated start -> goal;
    - "table_time" (7b, ``arm_around_table_time.json``'s form): "table"
      with dt_lower_lim 0.05, dt_upper_lim 0.5, the goal's use_time
      "tRuE" and joint_vel's "false" (the 1/dt grid, n_cols 8);
    - "table_discrete" (7f): "table" with both collision terms at
      evaluator_type 0, the reference's per-step discrete evaluator
      (dist_pen, coeffs and max_num_cnt as "table");
    - "timed_vel" (7c(i)): a timed joint_vel INEQ (|velocity| <= 1 rad/s:
      use_time true, upper_tols 1, lower_tols -1) and the goal, no
      collision; dt in [0.01, 1], init dt 0.05 (the straight path then
      moves up to ~1.5 rad/s: the solve has to stretch time);
    - "timed_vel_total" (7c(ii)): "timed_vel" plus a total_time cost
      (coeff 1, limit 1.25 x the lane's least time at 1 rad/s, its largest
      |goal - start| joint distance)."""
    import numpy as np

    from trajopt_tpu_torch.benchmarks import Q_GOAL, Q_START

    if kind not in JSON_KINDS:
        raise ValueError(f"json_docs: unknown kind {kind!r}")
    T, D = n_steps, 7
    rng = np.random.default_rng(seed)
    yaw = np.array([1.0, 0, 0, 0, 0, 0, 1.0])
    docs = []
    for _ in range(lanes):
        start = Q_START + rng.uniform(-0.15, 0.15, D) * yaw
        goal = Q_GOAL + rng.uniform(-0.15, 0.15, D) * yaw
        # make_glass_upright's bump and end-offset draws, so that the next
        # lane's start and goal are its own
        rng.uniform(-0.12, 0.12, D)
        rng.uniform(-0.05, 0.05, D)
        basic = {"n_steps": T, "manip": "arm", "fixed_timesteps": [0]}
        goal_t = {"type": "joint_pos", "name": "goal",
                  "params": {"coeffs": 1, "targets": goal.tolist(),
                             "first_step": T - 1, "last_step": T - 1}}
        init = {"type": "joint_interpolated", "data": start.tolist(),
                "endpoint": goal.tolist()}
        if kind in ("table", "table_time", "table_discrete"):
            ev = 0 if kind == "table_discrete" else 3
            vel = {"type": "joint_vel", "name": "jvel",
                   "params": {"coeffs": 1, "targets": 0}}
            costs = [vel, {"type": "collision", "name": "coll",
                           "params": {"evaluator_type": ev, "dist_pen": 0.025,
                                      "coeffs": 20, "max_num_cnt": 3}}]
            cnts = [goal_t, {"type": "collision", "name": "coll_cnt",
                             "params": {"evaluator_type": ev, "dist_pen": 0.01,
                                        "max_num_cnt": 3}}]
            if kind == "table_time":
                basic.update(dt_lower_lim=0.05, dt_upper_lim=0.5)
                vel["use_time"] = "false"
                goal_t["use_time"] = "tRuE"
        else:
            basic.update(dt_lower_lim=0.01, dt_upper_lim=1.0)
            init["dt"] = 0.05
            costs = []
            if kind == "timed_vel_total":
                least = float(np.abs(goal - start).max())
                costs = [{"type": "total_time", "name": "total_time",
                          "params": {"coeff": 1, "limit": 1.25 * least}}]
            cnts = [{"type": "joint_vel", "name": "tvel", "use_time": True,
                     "params": {"coeffs": 1, "targets": 0, "upper_tols": 1,
                                "lower_tols": -1}}, goal_t]
        docs.append({"basic_info": basic, "costs": costs,
                     "constraints": cnts, "init_info": init})
    return docs


def port_json_problem(docs, dtype, device, model="arm7", **load_kw):
    """Phase 7's batch through the port's loader: each lane's document
    loaded by ``load_problem(doc, chain, world, **load_kw)`` (arm7 and its
    table world, the loader's defaults; ``model`` another model of the
    zoo and its world), lane 0's spec and parameters taken after checking
    that every lane's spec has the same term names, kinds, ``n_rows`` and
    ``n_x`` (raises if not), the data stacked (``stack_data``) and cast to
    ``dtype``.  Returns (spec, data, params, chain, world)."""
    import torch

    from trajopt_tpu_torch import models
    from trajopt_tpu_torch.collision.world import build_collision_world
    from trajopt_tpu_torch.problem.json_io import load_problem
    from trajopt_tpu_torch.problem.trajectory import stack_data
    from trajopt_tpu_torch.utils.lanes import tree_map

    mdl, chain = getattr(models, model)()
    world = build_collision_world(mdl, chain)

    def signature(spec):
        return (spec.n_x, [(t.name, int(t.kind), t.n_rows)
                           for t in spec.cost_terms + spec.cnt_terms])

    spec = params = None
    datas, loaded = [], {}
    for i, doc in enumerate(docs):
        key = json.dumps(doc, sort_keys=True)  # equal documents load once
        if key not in loaded:
            loaded[key] = load_problem(doc, chain, world, device=device,
                                       **load_kw)
        s, d, p = loaded[key]
        if spec is None:
            spec, params = s, p
        elif signature(s) != signature(spec):
            raise ValueError(f"lane {i}'s document gives another problem "
                             f"class: {signature(s)} != {signature(spec)}")
        datas.append(d)
    data = tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    stack_data(datas))
    return spec, data, params, chain, world


BOX_KINDS = ("box_cast", "box_cast_t30")
# box_cast_test.json's longest_valid_segment_length and the JAX package's
# own n_sub for it (tests/test_json_io.py: load_problem(..., n_sub=48))
BOX_LVS, BOX_N_SUB = 0.05, 48


def box_docs(kind, lanes, seed=0):
    """Phase 8's problem documents on boxbot (a unit box on an x-y gantry
    against a unit box at the origin), one per lane (numpy only): the
    upstream ``box_cast_test.json``'s form (tests/test_json_io.py:47-70) -
    a joint_vel cost (coeffs 1), a cast collision cost (evaluator_type 4,
    dist_pen 0.02, coeffs 10, longest_valid_segment_length 0.05) and the
    goal joint_pos constraint at the last step, both ends fixed - from a
    start (-1.9, 0) + U(-0.2, 0.2) and a goal (1.9, 3.8) + U(-0.2, 0.2)
    per joint and lane (seed ``seed``):

    - "box_cast" (8a): T=3, init given_traj [start, the mean of start and
      goal (the document's (0, 1.9)), goal];
    - "box_cast_t30" (8b): T=30, fixed steps [0, 29], init
      joint_interpolated start -> goal."""
    import numpy as np

    if kind not in BOX_KINDS:
        raise ValueError(f"box_docs: unknown kind {kind!r}")
    T = 3 if kind == "box_cast" else 30
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(lanes):
        start = np.array([-1.9, 0.0]) + rng.uniform(-0.2, 0.2, 2)
        goal = np.array([1.9, 3.8]) + rng.uniform(-0.2, 0.2, 2)
        init = ({"type": "given_traj", "data": [
            start.tolist(), (0.5 * (start + goal)).tolist(), goal.tolist()]}
            if T == 3 else {"type": "joint_interpolated",
                            "data": start.tolist(), "endpoint": goal.tolist()})
        docs.append({
            "basic_info": {"n_steps": T, "manip": "manipulator",
                           "fixed_timesteps": [0, T - 1]},
            "costs": [
                {"type": "joint_vel", "name": "jvel0",
                 "params": {"coeffs": [1], "targets": [0, 0]}},
                {"type": "collision", "name": "coll",
                 "params": {"coeffs": 10, "dist_pen": 0.02,
                            "evaluator_type": 4,
                            "longest_valid_segment_length": BOX_LVS}}],
            "constraints": [
                {"type": "joint_pos", "name": "joint",
                 "params": {"coeffs": [1, 1], "targets": goal.tolist(),
                            "first_step": T - 1, "last_step": T - 1}}],
            "init_info": init})
    return docs


# the reference CLI test's document (tests/test_cli.py:16-37)
CLI_DOC = {
    "basic_info": {"n_steps": 3, "manip": "manipulator",
                   "fixed_timesteps": [0]},
    "costs": [{"type": "joint_vel",
               "params": {"coeffs": [1], "targets": [0, 0]}}],
    "constraints": [
        {"type": "joint_pos", "name": "goal",
         "params": {"coeffs": [1, 1], "targets": [1.0, 0.5],
                    "first_step": 2, "last_step": 2}}],
    "init_info": {"type": "stationary", "data": [0, 0]},
}


def spherebot_docs():
    """The spherebot documents of tests/test_json_io.py (by name, as
    tests/port/test_torch_json_io.py names them) and the CLI test's
    (``cli``): (document, with a collision world, whether the tests load
    it with their tight QP settings)."""
    return {
        "simple_collision": ({
            "basic_info": {"n_steps": 1, "manip": "manipulator"},
            "costs": [
                {"type": "collision", "params": {
                    "coeffs": 1, "dist_pen": 0.3, "evaluator_type": 1}},
                {"type": "joint_pos", "name": "joint0",
                 "params": {"coeffs": [1, 1], "targets": [0.0, 0.0]}}],
            "constraints": [
                {"type": "collision", "params": {
                    "coeffs": 1, "dist_pen": 0.2, "evaluator_type": 1}}],
            "init_info": {"type": "given_traj", "data": [[-0.75, 0.75]]},
        }, True, True),
        "opt_info": ({
            "basic_info": {"n_steps": 2, "manip": "m"},
            "opt_info": {"max_iter": 7, "trust_box_size": 0.5,
                         "initial_merit_error_coeff": 33.0,
                         "cnt_tolerance": 1e-5},
            "costs": [{"type": "joint_vel", "params": {"coeffs": 1}}],
            "init_info": {"type": "stationary"},
        }, False, False),
        "time_parameterized": ({
            "basic_info": {"n_steps": 5, "manip": "m",
                           "fixed_timesteps": [0],
                           "dt_lower_lim": 0.05, "dt_upper_lim": 0.5},
            "costs": [{"type": "joint_vel", "use_time": "false",
                       "params": {"coeffs": [1], "targets": [0, 0]}}],
            "constraints": [
                {"type": "joint_pos", "name": "goal", "use_time": "tRuE",
                 "params": {"coeffs": [1, 1], "targets": [1.0, -0.5],
                            "first_step": 4, "last_step": 4}}],
            "init_info": {"type": "joint_interpolated", "dt": 0.1,
                          "data": [0.0, 0.0], "endpoint": [1.0, -0.5]},
        }, False, True),
        "timed_vel_total_time": ({
            "basic_info": {"n_steps": 4, "manip": "m", "use_time": True,
                           "dt_lower_lim": 0.01, "dt_upper_lim": 10.0},
            "costs": [{"type": "total_time",
                       "params": {"coeff": 1.0, "limit": 3.5}}],
            "constraints": [
                {"type": "joint_vel", "use_time": True,
                 "params": {"coeffs": [1, 1], "targets": [0.0, 0.0],
                            "upper_tols": [1.0, 1.0],
                            "lower_tols": [-1.0, -1.0]}},
                {"type": "joint_pos", "name": "goal",
                 "params": {"coeffs": [1, 1], "targets": [3.0, 0.0],
                            "first_step": 3, "last_step": 3}}],
            "init_info": {"type": "joint_interpolated", "dt": 1.0,
                          "data": [0.0, 0.0], "endpoint": [3.0, 0.0]},
        }, False, True),
        "cli": (CLI_DOC, False, False),
    }


def time_parameterized_docs(lanes, seed=0):
    """``time_parameterized``'s form at ``lanes`` lanes (phase 2d's b-3
    QP): its goal target and init endpoint moved by U(-0.2, 0.2) per joint
    and lane."""
    import copy

    import numpy as np

    base = spherebot_docs()["time_parameterized"][0]
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(lanes):
        goal = (np.array([1.0, -0.5]) + rng.uniform(-0.2, 0.2, 2)).tolist()
        d = copy.deepcopy(base)
        d["constraints"][0]["params"]["targets"] = goal
        d["init_info"]["endpoint"] = goal
        docs.append(d)
    return docs


def box_n_sub(docs):
    """The substate count every lane of a batch of phase-8 documents is
    loaded with: ``load_problem``'s n_sub is a floor under the count each
    document's longest_valid_segment_length draws from its own init
    (ceil(largest step / lvs) + 1, at most 64), so one batch takes the
    largest over its lanes (at least BOX_N_SUB): a finer sampling of the
    same sweep for the lanes that draw fewer."""
    import numpy as np

    out = BOX_N_SUB
    for d in docs:
        init = d["init_info"]
        if init["type"] == "given_traj":
            q = np.asarray(init["data"], np.float64)
        else:
            a, b = (np.asarray(init[k], np.float64) for k in ("data",
                                                                "endpoint"))
            T = d["basic_info"]["n_steps"]
            q = a + np.linspace(0.0, 1.0, T)[:, None] * (b - a)
        step = float(np.linalg.norm(np.diff(q, axis=0), axis=1).max())
        out = max(out, min(int(np.ceil(step / BOX_LVS)) + 1, 64))
    return out


def port_box_problem(docs, dtype, device):
    """Phase 8's batch through the port's loader: ``port_json_problem`` on
    boxbot and its world, every lane at n_sub ``box_n_sub(docs)``."""
    return port_json_problem(docs, dtype, device, "boxbot",
                             n_sub=box_n_sub(docs))


# the block sizes K6 (and K2 / K3) gained in the box slice: every b from 1
# to 21 but those of the earlier slices (7, 8, 9, 14, 21).  Phase 2d holds
# K6 at b 2 and 3 on real QPs (8b's first, time_parameterized's form), at
# b 4, 6, 10, 12 and 20 on 8b's first QP regrouped to superblocks of 2, 3,
# 5, 6 and 10 steps (float32 and float64), and at every one of them on the
# IPM fixture (``ipm_fixture``) in float64 only: float32 does not resolve
# the fixture's random rows (on the H100 at b 4, 24 of 128 lanes end at
# status 2 and five runs stop on the NaN guard, the objectives 0.087 eps_g
# apart), as it does not 7b's first QP; the fixture takes the sizes the
# regrouped QP does not
K6_NEW_BLOCKS = tuple(b for b in range(1, 22) if b not in (7, 8, 9, 14, 21))
K6_BOX_REGROUP = (2, 3, 5, 6, 10)


def ipm_fixture(lanes, b, nb, seed, device):
    """A flagship-shaped banded QP at block size b (the IPM tests'
    fixture, tests/port/test_torch_ipm.py ``_problem``; numpy draws, float64
    tensors): a joint-velocity quadratic over nb steps, hinge rows on the
    gap windows, abs rows on per-step windows and a goal block, a trust
    box and a pinned first step."""
    import numpy as np
    import torch

    from trajopt_tpu_torch.ops.banded_rows import step_window
    from trajopt_tpu_torch.ops.prox_qp import ProxQPData

    rng = np.random.default_rng(seed)
    n = b * nb
    S = np.zeros(((nb - 1) * b, n))
    for t in range(nb - 1):
        for d in range(b):
            S[t * b + d, t * b + d] = -1.0
            S[t * b + d, (t + 1) * b + d] = 1.0
    P = np.stack([2.0 * S.T @ np.diag(rng.uniform(1, 5, S.shape[0])) @ S
                  for _ in range(lanes)])
    q = rng.normal(size=(lanes, n))
    Bh = (rng.normal(size=(lanes, nb - 1, 3, 2 * b)),)
    Gh = (np.arange(nb - 1, dtype=np.int32),)
    Bstep, Gstep = step_window(torch.as_tensor(
        rng.normal(size=(lanes, nb, 2, b))), np.arange(nb), nb)
    Ba = (Bstep.numpy(), rng.normal(size=(lanes, 1, b, 2 * b)))
    Ga = (Gstep.numpy(), np.asarray([nb - 2], np.int32))
    mh, ma = (nb - 1) * 3, nb * 2 + b
    lb = -rng.uniform(0.05, 0.3, (lanes, n))
    ub = rng.uniform(0.05, 0.3, (lanes, n))
    pin = rng.uniform(-0.02, 0.02, (lanes, b))
    lb[:, :b] = pin
    ub[:, :b] = pin
    arrays = dict(P=P, q=q, e_h=rng.normal(size=(lanes, mh)),
                  w_h=rng.uniform(1, 20, (lanes, mh)),
                  e_a=rng.normal(size=(lanes, ma)),
                  w_a=rng.uniform(1, 20, (lanes, ma)), lb=lb, ub=ub)

    def t(v):
        return torch.as_tensor(np.asarray(v), device=device)
    return ProxQPData(**{k: t(v) for k, v in arrays.items()}, A_h=None,
                      A_a=None, Bh=tuple(t(B) for B in Bh),
                      Gh=tuple(t(G) for G in Gh), Ba=tuple(t(B) for B in Ba),
                      Ga=tuple(t(G) for G in Ga))


def pose_value_flops(path_kinds, n_offsets, band):
    """Value arithmetic of one lane's pose error, counted from
    csrc/pose.cuh: per link of the chain paths after the root, the parent
    compose (63: 3x3 product 45, point 15, add 3) and its joint (revolute
    ~112: sin / cos ~30, R_axis 37, product 45; prismatic 21); per offset
    63; the transform error with its log map ~143; the band 12 and the
    coefficients 6."""
    link = {"rev": 63 + 112, "pri": 63 + 21, "fixed": 63}
    return (sum(link[k] for k in path_kinds) + 63 * n_offsets + 143
            + (12 if band else 0) + 6)


def pose_path_kinds(chain, link):
    """The joint kinds along a link's chain path after the root."""
    kinds, l = [], link
    while chain.parent[l] >= 0:
        jt = int(chain.jtype[l]) if chain.dof_of_link[l] >= 0 else 0
        kinds.append({1: "rev", 2: "pri"}.get(jt, "fixed"))
        l = int(chain.parent[l])
    return kinds


def pose_work(chain, lanes, src, tgt, band, jac, es):
    """(bytes, flops) of one K9 (jac) or K9v launch: the step's joints,
    the per-lane parameters and the chain tables read once, E (and J's
    n_dof columns) written once; the value's arithmetic, and with the
    Jacobian n_dof dual columns at ~1.5 times the value's each."""
    nd = chain.n_dof
    kinds = pose_path_kinds(chain, src) + (
        pose_path_kinds(chain, tgt) if tgt is not None else [])
    val = pose_value_flops(kinds, 2 if tgt is not None else 1, band)
    flops = lanes * val * ((1 + 1.5 * nd) if jac else 1)
    ins = nd + 9 + 3 + 9 + 3 + 6 + (12 if band else 0)
    outs = 6 + (6 * nd if jac else 0)
    nbytes = lanes * es * (ins + outs) + 33 * es * chain.n_links
    return nbytes, flops


def ik_work(chain, link, iters, ne, es):
    """(bytes, flops) of one K8 launch at the iterations its lanes ran
    (``iters`` (lanes,)): per iteration the error and its Jacobian at the
    trial point (the value, its norm and n_dof dual columns: the next
    iteration's J and e when the step is accepted), A = J J' + lam^2 I
    (2 ne^2 n_dof), its elimination (2/3 ne^3 + 2 ne^2), dq and the clamp
    (2 ne n_dof + 2 n_dof); per lane the first error and Jacobian.  No
    second value evaluation per iteration: the loop does not need one."""
    nd = chain.n_dof
    val = pose_value_flops(pose_path_kinds(chain, link), 0, False) + 2 * ne
    evaluation = val * (1 + 1.5 * nd)
    per_it = evaluation + 2 * ne * ne * nd \
        + (2 / 3) * ne ** 3 + 2 * ne * ne + 2 * ne * nd + 2 * nd
    lanes = iters.numel()
    flops = float(iters.double().sum()) * per_it + lanes * evaluation
    nbytes = lanes * (es * (9 + 3 + 2 * nd + 1) + 8) + es * (
        33 * chain.n_links + 2 * nd)
    return nbytes, flops


def recording_solve_ik(calls):
    """kinematics.ik.solve_ik that also records each call's chain, link
    and arguments into ``calls`` (a 6b run's K8 launches)."""
    from trajopt_tpu_torch.kinematics import ik

    solve = ik.solve_ik

    def rec(chain, link, target_R, target_p, max_iters=60, tol=1e-6,
            damping=1e-3, pos_only=False, q0=None, kernels=True):
        calls.append((chain, link, target_R.clone(), target_p.clone(),
                      max_iters, tol, damping, pos_only, q0.clone()))
        return solve(chain, link, target_R, target_p, max_iters, tol,
                     damping, pos_only, q0, kernels)
    return rec


def ik_launch_times(calls, wall_s):
    """The recorded K8 launches of one run, each replayed alone (its
    arguments built once) on the device clock (``device_ms``): per launch
    its ms and largest iteration count, the largest-iteration launch's,
    their sum and its share of ``wall_s``, the mean wall of the runs
    timed without the recording."""
    import torch

    from trajopt_tpu_torch import _native
    from trajopt_tpu_torch.kinematics.ik import _ik_args

    lib, out = _native.library("solve_ik"), []
    for chain, link, *args in calls:
        fn, a, res, _keep = _ik_args(lib, chain, link, *args)
        _native.check("solve_ik", fn(*a))
        torch.cuda.synchronize()
        ms, _ = device_ms(lambda: _native.check("solve_ik", fn(*a)), reps=10)
        out.append({"ms": ms, "iters_max": int(res.iters.max()),
                    "iters_mean": float(res.iters.double().mean())})
    total = sum(r["ms"] for r in out)
    top = max(out, key=lambda r: r["iters_max"]) if out else None
    return {"launches": len(out), "per_launch": out,
            "largest_iteration_launch": top, "device_ms_sum": total,
            "share_of_wall": total * 1e-3 / wall_s}


# K8's instantiations, in solve_ik_attrs' order: n_e 6 / 3 (pos_only) at
# row teams of 3 (n_dof up to 10) or of 1 (n_dof 11-12)
IK_INSTANCES = ("ne6_rt3", "ne6_rt1", "ne3_rt3", "ne3_rt1")


def pose_attributes():
    """numRegs / localSizeBytes of K9 (cart_pose.cu, one kernel for K9
    and K9v), float32 and float64, and of each of K8's instantiations
    (solve_ik.cu, ``IK_INSTANCES``; one taken from a checkout without it
    is left out), with the largest of them (``worst``)."""
    import ctypes

    from trajopt_tpu_torch import _native

    def read(fn, sym, which):
        a = (ctypes.c_int * 4)()
        rc = fn(which, a)
        return rc, {"registers": a[0], "local_bytes": a[1],
                    "max_threads": a[2], "static_smem": a[3]}

    out = {}
    cart = _native.library("cart_pose").cart_pose_attrs
    ik = _native.library("solve_ik").solve_ik_attrs
    for which, d in ((0, "f32"), (1, "f64")):
        rc, out[f"cart_pose_{d}"] = read(cart, "cart_pose_attrs", which)
        _native.check("cart_pose_attrs", rc)
        inst = {}
        for k, name in enumerate(IK_INSTANCES):
            rc, r = read(ik, "solve_ik_attrs", 2 * k + which)
            if rc == -1 and k > 0:  # a checkout with one instantiation
                continue
            _native.check("solve_ik_attrs", rc)
            inst[name] = r
        inst["worst"] = {k: max(r[k] for r in inst.values())
                         for k in ("registers", "local_bytes")}
        out[f"solve_ik_{d}"] = inst
    return out


def device_ms(fn, reps=50):
    """Per-launch device time of ``fn`` (one bare kernel launch, its
    arguments built beforehand): the launches are queued behind a
    sleeping kernel, so the card runs them back to back and the events
    between them hold no host time.  Returns (ms, queue), ``queue`` the
    host's time to queue them against the sleep's device time; the
    reading holds only if the queueing ended before the sleep did
    (checked)."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(50_000_000)  # ~25 ms at the H100's 1.98 GHz
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    ev[2].record()
    torch.cuda.synchronize()
    queue = {"host_queue_ms": host_ms,
             "sleep_ms": ev[0].elapsed_time(ev[1])}
    assert host_ms < queue["sleep_ms"], queue
    return ev[1].elapsed_time(ev[2]) / reps, queue


def disc_bare_launch(kind, world, x, n_steps, nc, first, span, block=None):
    """A zero-argument bare launch of K7 ``disc_dist`` / K7v
    ``disc_dist_value`` on x (a CUDA tensor; arguments as
    ``terms.collision.disc_launch``, ``block`` (slots, threads, stage) as
    ``_disc_plan`` takes it, None for the default), and its outputs (D, J;
    J None for K7v): the wrapper's plan and outputs built once, each call
    the wrapper's ``_disc_call`` into them, not counted."""
    import torch

    from trajopt_tpu_torch import _native
    from trajopt_tpu_torch.terms.collision import _disc_call, _disc_plan

    plan = _disc_plan(_native.library("disc_dist"), kind, world, x, n_steps,
                      nc, first, span, block)
    D, J = _disc_call(plan, x)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def launch():
        _disc_call(plan, x, stream, out=(D, J))
    return launch, D, J


def pose_inputs(lanes, dev, T=30):
    """Phase 2f's K9 / K9v inputs, float64: the free flagship's chain and
    x (its x0 plus seeded noise, 128 x T), and per configuration the
    cart_pose params and target link: "world" (the tool's pose at step 25
    as a world target, a source offset, row coefficients),
    "moving_target" (an offset on link l3) and "band" (the world target
    with a tolerance band).  The term sits at step 20."""
    import numpy as np
    import torch

    from trajopt_tpu_torch.benchmarks import make_glass_upright_free
    from trajopt_tpu_torch.ops.lie import rpy_to_matrix

    _, data64, chain = make_glass_upright_free(lanes, T, torch.float64,
                                               device=dev)
    nd = chain.n_dof
    tool, l3 = chain.link_index("tool"), chain.link_index("l3")
    x64 = data64.x0 + torch.as_tensor(np.random.default_rng(12).normal(
        0.0, 0.05, tuple(data64.x0.shape)), device=dev)
    Rw, pw = chain.fk(x64.reshape(lanes, T, nd)[:, 25])
    rpy = torch.tensor([[0.05, -0.05, 0.1], [0.1, 0.2, 0.3]],
                       dtype=torch.float64)
    offR = rpy_to_matrix(rpy).to(dev)

    def lanes_of(t):
        return t.expand((lanes,) + tuple(t.shape)).contiguous()

    def vec(v):
        return lanes_of(torch.tensor(v, device=dev, dtype=torch.float64))

    common = {"source_off_R": lanes_of(offR[0]),
              "source_off_p": vec([0.0, 0.0, 0.1]),
              "coeffs": vec([1, 1, 1, 0.5, 0.5, 0.5])}
    world = dict(common, target_R=Rw[:, tool], target_p=pw[:, tool])
    moving = dict(common, target_R=lanes_of(offR[1]),
                  target_p=vec([0.1, 0.0, 0.2]))
    tol = [0.05] * 3 + [0.1] * 3
    band = dict(world, lower_tols=vec([-t for t in tol]),
                upper_tols=vec(tol))
    return chain, x64, {"world": (world, None),
                        "moving_target": (moving, l3), "band": (band, None)}


def cartesian_phases(dev, smi, time_ms, reset_counts, qp_calls, lanes=128):
    """Phases 2f and 6a-6d (module docstring).  Returns (summary entries
    of K9, K9v and K8, launches by path of every kernel on 6a and 6b)."""
    import numpy as np
    import torch

    from trajopt_tpu_torch import _native
    from trajopt_tpu_torch.kinematics import ik as ik_mod
    from trajopt_tpu_torch.kinematics.chain import build_chain
    from trajopt_tpu_torch.kinematics.ik import _ik_args, solve_ik
    from trajopt_tpu_torch.kinematics.urdf import parse_urdf
    from trajopt_tpu_torch.solver.sqp import solve_batch
    from trajopt_tpu_torch.solver.types import CONVERGED, SQPParams
    from trajopt_tpu_torch.terms.cartesian import _pose_args, cart_pose_rows

    def sync():
        torch.cuda.synchronize()

    T, step = 30, 20
    attrs = pose_attributes()
    emit({"phase": "pose_attributes", "attributes": attrs, "card": smi})

    # ---------------- phase 2f: K9 / K9v against the plain version
    chain, x64, configs = pose_inputs(lanes, dev, T)
    nd = chain.n_dof
    tool = chain.link_index("tool")
    world = configs["world"][0]
    k9_recs, k9_err = [], {"cart_pose": [], "cart_pose_value": []}
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[-1]
        x = x64.to(dt)
        for label, (p64, tgt) in configs.items():
            p = {k: v.to(dt) for k, v in p64.items()}
            Ev = cart_pose_rows(chain, x, p, T, step, tool, tgt)
            Ek, Jk = cart_pose_rows(chain, x, p, T, step, tool, tgt,
                                    jac=True)
            Ep, Jp = cart_pose_rows(chain, x, p, T, step, tool, tgt,
                                    jac=True, kernels=False)
            sync()
            ties = cart_pose_ties(chain, x, p, T, step, tool, tgt)
            escale = float(Ep.abs().max())
            jscale = float(Jp.abs().max())
            untied = ~ties[..., None].expand_as(Jk)
            dv = float((Ev - Ep).abs().max())
            de = float((Ek - Ep).abs().max())
            dj = float((Jk - Jp)[untied].abs().max()) if untied.any() else 0.0
            rec = {"phase": "pose_kernels", "config": label, "dtype": name,
                   "rows": int(Ep.numel()),
                   "E_value_abs_err": dv, "E_abs_err": de,
                   "E_rel_err": max(dv, de) / escale,
                   "J_rel_err_untied_rows": dj / jscale,
                   "J_rel_err_all_rows": float((Jk - Jp).abs().max()) / jscale,
                   "tie_rows": int(ties.sum()),
                   "value_bitwise_equal_K9_K9v": bool(torch.equal(Ev, Ek)),
                   "rows_in_band": int((Ep == 0).sum()) if label == "band"
                   else None}
            rec["ok"] = rec["E_rel_err"] <= REL_TOL[name] \
                and rec["J_rel_err_untied_rows"] <= COLL_TOL[name][1]
            emit(rec)
            k9_recs.append(rec)
            k9_err["cart_pose"].append(max(de, dj))
            k9_err["cart_pose_value"].append(dv)
            assert rec["ok"], rec
    # K8 against the plain loop on phase 6c's queries
    ik = ik_inputs(lanes)
    link = ik["link"]
    tR64, tp64, q064 = (torch.as_tensor(ik[k], device=dev)
                        for k in ("target_R", "target_p", "q0"))
    k8_recs = []
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[-1]
        for po in (False, True):
            tR, tp, q0 = tR64.to(dt), tp64.to(dt), q064.to(dt)
            kr = solve_ik(chain, link, tR, tp, q0=q0, pos_only=po)
            pr, tie = solve_ik_plain_ties(chain, link, tR, tp, q0, po)
            sync()
            rec = {"phase": "ik_kernel", "dtype": name, "pos_only": po,
                   **ik_compare(kr, pr, tie, name),
                   "iters_mean": float(kr.iters.double().mean())}
            emit(rec)
            k8_recs.append(rec)
            assert rec["ok"], rec
    # K8 at every n_dof 1..CAST_ND_MAX (serial chains, 16 lanes) against
    # the plain loop by the same rule: float64 and the full pose at each,
    # and at the ceiling float32 and pos_only too
    cases = [(n, torch.float64, False)
             for n in range(1, _native.CAST_ND_MAX + 1)] + [
        (_native.CAST_ND_MAX, dt, po) for dt, po in (
            (torch.float64, True), (torch.float32, False),
            (torch.float32, True))]
    chains = {}
    for n, dt, po in cases:
        name = str(dt).split(".")[-1]
        if n not in chains:
            chains[n] = build_chain(parse_urdf(serial_urdf(n)),
                                    [f"q{i}" for i in range(1, n + 1)])
        sch = chains[n]
        slink, sR, sp, sq0 = (t if isinstance(t, int) else t.to(dev, dt)
                              for t in serial_ik_queries(sch, 16, seed=n))
        kr = solve_ik(sch, slink, sR, sp, q0=sq0, pos_only=po)
        pr, tie = solve_ik_plain_ties(sch, slink, sR, sp, sq0, po)
        sync()
        rec = {"phase": "ik_kernel_ndof", "n_dof": n, "dtype": name,
               "pos_only": po, **ik_compare(kr, pr, tie, name),
               "iters_max": int(kr.iters.max()),
               "finite": bool(torch.isfinite(kr.q).all())}
        rec["ok"] = rec["ok"] and rec["finite"]
        emit(rec)
        k8_recs.append(rec)
        assert rec["ok"], rec

    # times (float32): K9 / K9v on the world target, K8 on 6c's queries.
    # ms: the bare launch on the card (its arguments built once, the
    # launches queued behind a sleeping kernel, device_ms); wrapper_ms: the
    # whole entry point, argument building included, one call after another
    x = x64.float()
    pw32 = {k: v.float() for k, v in world.items()}
    timing = {}

    def bound(nb, fl):
        b_bytes, b_ops = nb / PEAK_BYTES, fl / PEAK_FLOPS["float32"]
        return {"bound_ms": 1e3 * max(b_bytes, b_ops),
                "bound_by": "bytes" if b_bytes > b_ops else "operations",
                "work": {"bytes": nb, "flops": fl}}

    for key, jac in (("cart_pose", True), ("cart_pose_value", False)):
        fn, args, *_keep = _pose_args(_native.library("cart_pose"), chain, x,
                                      pw32, step, nd, tool, None, jac)
        ms, enq = device_ms(lambda: _native.check("cart_pose", fn(*args)))
        wrapper = time_ms(lambda: cart_pose_rows(chain, x, pw32, T, step,
                                                 tool, None, jac=jac))
        plain = time_ms(lambda: cart_pose_rows(chain, x, pw32, T, step, tool,
                                               None, jac=jac, kernels=False),
                        reps=5)
        timing[key] = {"ms": ms, "wrapper_ms": wrapper, "plain_ms": plain,
                       "queue": enq,
                       **bound(*pose_work(chain, lanes, tool, None, False,
                                          jac, 4))}
    tR, tp, q0 = tR64.float(), tp64.float(), q064.float()
    ik_runs = {}
    for po in (False, True):
        key = "solve_ik_pos_only" if po else "solve_ik"
        r = solve_ik(chain, link, tR, tp, q0=q0, pos_only=po)
        fn, args, *_keep = _ik_args(_native.library("solve_ik"), chain, link,
                                    tR, tp, 60, 1e-6, 1e-3, po, q0)
        ms, enq = device_ms(lambda: _native.check("solve_ik", fn(*args)),
                            reps=20)
        wrapper = time_ms(lambda: solve_ik(chain, link, tR, tp, q0=q0,
                                           pos_only=po), reps=20)
        plain = time_ms(lambda: solve_ik(chain, link, tR, tp, q0=q0,
                                         pos_only=po, kernels=False), reps=2)
        ik_runs[key] = r
        timing[key] = {"ms": ms, "wrapper_ms": wrapper, "plain_ms": plain,
                       "queue": enq,
                       **bound(*ik_work(chain, link, r.iters, 3 if po else 6,
                                        4))}
    emit({"phase": "pose_timing", "timing": timing, "card": smi})

    # ---------------- phase 6c: solve_ik alone, 128 lanes, float32
    for key, r in ik_runs.items():
        rec = {"phase": "solve_ik", "variant": key, "lanes": lanes,
               "dtype": "float32", "converged": int(r.converged.sum()),
               "iters_mean": float(r.iters.double().mean()),
               "iters_max": int(r.iters.max()),
               "err_norm_max": float(r.err_norm.max()),
               "err_norm_median": float(r.err_norm.median()),
               "finite": bool(torch.isfinite(r.q).all()),
               "ms": timing[key]["ms"], "limits": CART_LIMITS[key],
               "card": smi}
        emit(rec)
        assert rec["finite"] and rec["converged"] >= \
            CART_LIMITS[key]["converged"], rec

    # ---------------- phases 6a and 6b: the SQP, 128 lanes x T=30, float32
    params = SQPParams()
    inp = cartesian_inputs(lanes, T)
    by_path = {}
    # (6a, ~5 s a run, runs one warm run to keep the script's wall within
    # its budget; 6b three)
    for kind, key, warm in (("waypoints", "cartesian_waypoints", 1),
                            ("ik_goal", "ik_goal", 3)):
        spec, data, _ = port_cartesian_problem(kind, inp, torch.float32, dev)
        t0 = time.perf_counter()
        res = solve_batch(spec, data, params, device=dev)
        sync()
        cold = time.perf_counter() - t0
        reset_counts()
        walls = []
        for _ in range(warm):
            t0 = time.perf_counter()
            res = solve_batch(spec, data, params, device=dev)
            sync()
            walls.append(time.perf_counter() - t0)
        launches = dict(_native.LAUNCHES)
        nqp = qp_calls[0]
        by_path[key] = launches
        dense_ok = dense_path_ok(launches, nqp, b=7)
        st = res.status.cpu().numpy()
        v = res.cnt_viols.max(dim=1).values.cpu().numpy()
        conv = st == CONVERGED
        rec = {"phase": key, "batch": lanes, "n_steps": T,
               "dtype": "float32", "cold_wall_s": cold, "warm_walls_s": walls,
               "warm_wall_s": float(np.mean(walls)), "runs": warm,
               "converged": int(conv.sum()),
               "gated": int((conv & (v < 1e-4)).sum()),
               "mean_qp_solves": float(res.n_qp_solves.double().mean()),
               "max_viol": float(v.max()),
               "finite": bool(torch.isfinite(res.x).all()),
               "status_counts": np.bincount(st, minlength=5).tolist(),
               "batched_qp_solves": nqp, "launches": launches,
               "launches_per_batched_qp_solve": {
                   k: n / nqp for k, n in launches.items() if n},
               "linalg_calls": dict(LINALG_CALLS),
               "limits": CART_LIMITS[key], "card": smi}
        if kind == "waypoints":
            rec["max_displacement"] = inp["max_displacement"]
        else:  # K8's launches, recorded in one more run (untimed, after
            # the counts were read) and replayed on the device clock
            ik_calls = []
            ik_mod.solve_ik = recording_solve_ik(ik_calls)
            try:
                solve_batch(spec, data, params, device=dev)
                sync()
            finally:
                ik_mod.solve_ik = solve_ik
            rec["k8"] = ik_launch_times(ik_calls, rec["warm_wall_s"])
            timing["solve_ik"]["launches_6b"] = rec["k8"]
        emit(rec)
        assert rec["finite"], rec
        assert rec["converged"] >= CART_LIMITS[key]["converged"] \
            and rec["gated"] >= CART_LIMITS[key]["gated"], rec
        # the dense-row QP: K11 once per batched QP solve (its block
        # route, b 7); K6, K1-K3 and torch's Cholesky never
        assert dense_ok, rec
        if kind == "waypoints":
            assert launches["cart_pose"] > 0 \
                and launches["cart_pose_value"] > 0, rec
        else:
            assert launches["solve_ik"] >= nqp, rec

    # ---------------- phase 6d: float64 kernel path against plain path
    inp8 = cartesian_inputs(8, T)
    for kind in ("waypoints", "ik_goal"):
        spec, data, _ = port_cartesian_problem(kind, inp8, torch.float64, dev)
        reset_counts()
        rk = solve_batch(spec, data, params, device=dev, kernels=True)
        sync()
        # the kernel path: K11 once per batched QP solve, as 6a / 6b
        k_launches, k_nqp = dict(_native.LAUNCHES), qp_calls[0]
        k_ok = dense_path_ok(k_launches, k_nqp, b=7)
        rp = solve_batch(spec, data, params, device=dev, kernels=False)
        u = torch.as_tensor(np.random.default_rng(14).integers(
            -1, 2, tuple(data.x0.shape)), device=dev).to(torch.float64)
        ru = solve_batch(spec, data._replace(
            x0=data.x0 * (1 + u * torch.finfo(torch.float64).eps)), params,
            device=dev, kernels=False)
        dx = (rk.x - rp.x).abs().amax(-1)
        du = (ru.x - rp.x).abs().amax(-1)
        rec = {"phase": f"f64_{kind}_kernel_vs_plain", "lanes": 8,
               "status": rk.status.tolist(),
               "status_plain": rp.status.tolist(),
               "n_qp": rk.n_qp_solves.tolist(),
               "n_qp_plain": rp.n_qp_solves.tolist(),
               "same_status": bool((rk.status == rp.status).all()),
               "same_n_qp": bool((rk.n_qp_solves == rp.n_qp_solves).all()),
               "max_abs_dx": float(dx.max()), "dx_per_lane": dx.tolist(),
               "plain_x0_ulp_dx_per_lane": du.tolist(),
               "tol": FLAGSHIP_DX_TOL, "kernel_path_batched_qp_solves": k_nqp,
               "kernel_path_launches": {k: n for k, n in k_launches.items()
                                        if n}}
        rec["ok"] = rec["same_status"] and rec["same_n_qp"] \
            and rec["max_abs_dx"] < FLAGSHIP_DX_TOL \
            and rec["max_abs_dx"] <= max(float(du.max()), 1e-10) and k_ok
        emit(rec)
        assert rec["ok"], rec

    # the summary's entries
    k9a, k8a = by_path["cartesian_waypoints"], by_path["ik_goal"]
    entries = {}
    for key, src, rep, label in (
            ("cart_pose", "cart_pose.cu", "trajopt_tpu/terms/cartesian.py:100",
             "K9"),
            ("cart_pose_value", "cart_pose.cu",
             "trajopt_tpu/terms/cartesian.py:96", "K9v"),
            ("solve_ik", "solve_ik.cu", "trajopt_tpu/kinematics/ik.py:34",
             "K8")):
        t = timing[key]
        if key == "solve_ik":
            err = max(r["q_abs_err_converged_equal"] for r in k8_recs
                      if r["dtype"] == "float32")
            extra = {"max_abs_err_of": "q, float32, lanes converged with "
                     "equal iteration counts (phase 2f)",
                     "q_abs_err_stuck_equal": {
                         f"{r['dtype']}_{'pos' if r['pos_only'] else 'full'}":
                         r["q_abs_err_stuck_equal"] for r in k8_recs},
                     "lanes_apart": {f"{r['dtype']}_{'pos' if r['pos_only'] else 'full'}":
                                     r["lanes_apart"] for r in k8_recs},
                     "pos_only": timing["solve_ik_pos_only"],
                     "launches_are": "phase 6b's three warm runs (ik_term's "
                     "fn, every convexify and evaluate)",
                     "on_6b": {k: t["launches_6b"][k] for k in (
                         "launches", "largest_iteration_launch",
                         "device_ms_sum", "share_of_wall")},
                     "library_ms_null_because": "no one PyTorch call runs "
                     "the damped-least-squares loop",
                     "attributes": {d: attrs[f"solve_ik_{d}"]
                                    for d in ("f32", "f64")}}
            launches = k8a[key]
        else:
            err = max(k9_err[key])
            extra = {"max_abs_err_of": "E (and J on the untied rows), "
                     "float32 and float64, phase 2f",
                     "J_tie_rows_excluded": max(r["tie_rows"]
                                                for r in k9_recs),
                     "launches_are": "phase 6a's warm run",
                     "library_ms_null_because": "no one PyTorch call computes "
                     "FK and the pose error",
                     "attributes": {d: attrs[f"cart_pose_{d}"]
                                    for d in ("f32", "f64")}}
            launches = k9a[key]
        entries[key] = {
            "name": key, "route": "cuda",
            "source": f"trajopt_tpu_torch/csrc/{src}", "replaces": rep,
            "kernel": label, "launches": launches, "ok": True,
            "max_abs_err": err, **extra, "sources": [
                f"trajopt_tpu_torch/csrc/{f}" for f in (src, "pose.cuh",
                                                        "collision.cuh")],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None}
    return entries, by_path


# phase 7's limits: the JAX package's own float32 counts on the CPU less 5
# (scripts/jax_reference_counts.py --names json_table json_table_time
# json_timed_vel json_timed_vel_total json_table_discrete: 128 converged
# and gated each)
JSON_LIMITS = {"json_table": {"converged": 123, "gated": 123},
               "json_table_time": {"converged": 123, "gated": 123},
               "json_timed_vel": {"converged": 123, "gated": 123},
               "json_timed_vel_total": {"converged": 123, "gated": 123},
               # 7f (--names json_table_discrete: 128 converged and gated,
               # mean QP solves 4.0, every lane swept-free, the least swept
               # distance 0.0239)
               "json_table_discrete": {"converged": 123, "gated": 123}}
# a near tie of the selection: two adjacent keys among a group's K + 1
# largest within this many ulps of the larger
SELECT_TIE_ULPS = 4
# phase 7e, float64 kernel path against plain path on 8 lanes of 7a / 7b:
# the worst-contact selection and the SQP's convergence test decide by
# values equal to within rounding, so a lane's QP count may part where
# the decision flips under one ulp of x0 (for either path: counted and
# reported, x not compared there); on the other lanes x within
# JSON_DX_TOL.  Readings on the H100 (7a): on lanes with equal QP counts
# dx up to 1.39e-4, the plain path's own move under one ulp of x0 up to
# 1.27e-4, one lane of 8 parting (4 QP solves against 5, dx 3.6e-3)
JSON_DX_TOL = 1e-3
# the CLI's --out trajectory against the in-process solve of the same
# document on the same card (float32; one code path, so bitwise equal is
# expected; the tolerance bounds a reordered reduction)
CLI_X_TOL = 1e-5


def select_work(D, K, nc, es, jac, n_jac):
    """(bytes, operations) the worst-contact selection must move and do
    on D (B, G, S, P): D once, the margins and coefficients, the K kept
    pairs' Jacobian rows (nc columns from each of the ``n_jac`` inputs: 2
    cast, 1 discrete), the values and the banded rows (2 nc) written once;
    per (segment, pair) a subtract and a compare, per output a multiply."""
    B, G, S, P = D.shape
    out_rows = B * G * S * K
    nb = es * (D.numel() + 2 * B * P + out_rows)
    if jac:
        nb += es * out_rows * nc * (n_jac + 2)
    ops = 2 * D.numel() + out_rows * (1 + (2 * nc if jac else 0))
    return nb, ops


# phase 2g's selection settings (max_num_cnt 3, a 0.5 window buffer)
SELECT_K, SELECT_BUFFER = 3, 0.5
# phase 2g's added sizes, (form, S, P, K, nc) on select_case's seeded
# inputs: the register route's edges (P 33 and 64: a lane's second pair;
# K = P with S K up to 64) and the shared-memory route (P 65 and 300 above
# the register cap of 64, S 47 above its 8, K = P with S K above 64)
SELECT_SIZES = (("cast", 7, 33, 3, 7), ("cast", 7, 64, 3, 8),
                ("cast", 1, 32, 32, 7), ("cast", 1, 64, 64, 2),
                ("cast", 7, 65, 3, 7), ("cast", 7, 300, 3, 13),
                ("cast", 47, 28, 3, 7), ("cast", 7, 28, 28, 7),
                ("discrete", 1, 33, 3, 7), ("discrete", 1, 5, 5, 13),
                ("discrete", 1, 65, 65, 8))


def select_inputs(prob, lanes, dt, kernels=True):
    """Phase 2g's inputs at dtype ``dt``, {form: (D, margins, coeffs, Ja,
    Jb, right_group)}: the cast form on the cost term's distance pipeline
    (K4 at the problem's n_sub, lane 0's pruned world) for x0 plus seeded
    noise, with the term's margins and coefficients per pair; the discrete
    form on K7's on the full world (margins 0.025, coefficients 20).
    ``prob``: a phase-7 problem (``port_json_problem``); ``kernels=False``:
    the plain distance pipelines."""
    import numpy as np
    import torch

    from trajopt_tpu_torch.terms.collision import DiscreteDistancePre

    spec, data, world = prob[0], prob[1], prob[4]
    ci = next(i for i, t in enumerate(spec.cost_terms)
              if t.pre_fn is not None)
    cpre = spec.cost_terms[ci].pre_fn
    P = cpre.P
    m64, c64 = (data.cost_params[ci][k].double().reshape(lanes, -1).expand(
        lanes, P).contiguous() for k in ("margins", "coeffs"))
    x = (data.x0.double() + torch.as_tensor(np.random.default_rng(15).normal(
        0.0, 0.05, tuple(data.x0.shape)), device=data.x0.device)).to(dt)
    Dc, (Ja, Jb) = cpre.value_jac(x, kernels=kernels)
    dpre = DiscreteDistancePre(world, spec.n_steps, n_cols=spec.n_cols)
    Dd, Js = dpre.value_jac(x, kernels=kernels)
    full = lambda v: m64.new_full((lanes, Dd.shape[-1]), v).to(dt)  # noqa
    return {"cast": (Dc.contiguous(), m64.to(dt), c64.to(dt),
                     Ja.contiguous(), Jb.contiguous(), -1),
            "discrete": (Dd[:, :, None, :].contiguous(), full(0.025),
                         full(20.0), Js.contiguous(), None,
                         spec.n_steps - 1)}


def select_case(rng, S, P, nc, cast, lanes=2, groups=4,
                buffer=SELECT_BUFFER):
    """Seeded selection inputs (numpy float64: D (lanes, groups, S, P),
    margins, coeffs (lanes, P), Ja and, cast, Jb (lanes, groups, S P,
    nc)): group 0 as drawn with keys of -0 (pair P // 4) and +0 (P // 2),
    group 1 with exact ties between pairs (2 and 34: two pairs of one
    lane on the card), group 2 with NaN distances (one segment of pair 0,
    every segment of pairs P // 2 and P - 1), group 3 with every pair
    inactive (err < -buffer)."""
    import numpy as np

    D = rng.uniform(-0.2, 0.6, (lanes, groups, S, P))
    m = rng.uniform(0.0, 0.3, (lanes, P))
    c = rng.uniform(1.0, 20.0, (lanes, P))
    if P > 1:
        z0, z1 = P // 4, P // 2
        m[:, z0], m[:, z1] = -0.0, 0.0
        D[:, 0, :, z0] = 0.0
        D[:, 0, :, z1] = 0.0
        for p, q in ((0, P - 1), (1, P // 3), (2, min(P - 1, 34)),
                     (P - 2, min(P - 1, 33))):
            if p != q and p >= 0:
                D[:, 1, :, q] = D[:, 1, :, p]
                m[:, q] = m[:, p]
                c[:, q] = c[:, p]
    D[:, 2, S // 2, 0] = np.nan
    D[:, 2, :, P // 2] = np.nan
    D[:, 2, :, P - 1] = np.nan
    D[:, 3] = m[:, None, :] + buffer + rng.uniform(0.01, 1.0,
                                                   (lanes, S, P))
    Ja = rng.normal(size=(lanes, groups, S * P, nc))
    Jb = rng.normal(size=(lanes, groups, S * P, nc)) if cast else None
    return D, m, c, Ja, Jb


def same_bits(a, b):
    """Elements of a and b whose bits differ (the shapes must agree)."""
    import torch

    assert a.shape == b.shape, (a.shape, b.shape)
    it = torch.int32 if a.dtype == torch.float32 else torch.int64
    return int((a.contiguous().view(it) != b.contiguous().view(it)).sum())


def select_sizes_check(dev, lanes=8):
    """Phase 2g's added sizes (SELECT_SIZES): K10 and K10v on the card
    against the plain selection on the same inputs, float32 and float64,
    every output's bits equal.  Returns one record per size and dtype."""
    import numpy as np
    import torch

    from trajopt_tpu_torch.terms.collision import (contact_select,
                                                   contact_select_plain,
                                                   select_route)

    recs = []
    for i, (form, S, P, K, nc) in enumerate(SELECT_SIZES):
        cast = form == "cast"
        arrs = select_case(np.random.default_rng(160 + i), S, P, nc, cast,
                           lanes=lanes)
        for dt in (torch.float32, torch.float64):
            D, m, c, Ja, Jb = (None if a is None else torch.as_tensor(
                a, dtype=dt, device=dev).contiguous() for a in arrs)
            right = -1 if cast else D.shape[1] - 1
            kv = contact_select(D, m, c, SELECT_BUFFER, K)
            kr = contact_select(D, m, c, SELECT_BUFFER, K, Ja, Jb, right)
            pv, pr = contact_select_plain(D, m, c, SELECT_BUFFER, K, Ja, Jb,
                                          right)
            torch.cuda.synchronize()
            rec = {"phase": "contact_select_size", "form": form,
                   "dtype": str(dt).split(".")[-1], "lanes": lanes,
                   "groups": D.shape[1], "S": S, "P": P, "K": K, "nc": nc,
                   "route": select_route(P, S, K),
                   "differ_K10v": same_bits(kv, pv),
                   "differ_K10_values": same_bits(kr[0], pv),
                   "differ_K10_rows": same_bits(kr[1], pr),
                   "negative_zero_rows": int(torch.signbit(pr).logical_and(
                       pr == 0).sum()),
                   "active_rows": int((pv != -1).sum())}
            rec["max_abs_err"] = float(max(
                (kv - pv).abs().nan_to_num().max(),
                (kr[1] - pr).abs().nan_to_num().max()))
            rec["ok"] = rec["differ_K10v"] == rec["differ_K10_values"] \
                == rec["differ_K10_rows"] == 0
            recs.append(rec)
    return recs


def select_ties(D, m, K):
    """(B, G) groups whose K + 1 largest keys (a pair's largest m - D
    over segments) hold two adjacent keys within SELECT_TIE_ULPS ulps:
    their choice is a rounding decision."""
    import torch

    key = torch.amax(m[:, None, None, :] - D, dim=2)
    top = torch.sort(key, dim=-1, descending=True).values[..., :K + 1]
    ulp = torch.finfo(D.dtype).eps * top[..., :-1].abs().clamp(
        min=torch.finfo(D.dtype).tiny)
    return ((top[..., :-1] - top[..., 1:]).abs()
            <= SELECT_TIE_ULPS * ulp).any(-1)


def discrete_json_phase(dev, smi, reset_counts, qp_calls, prob, lanes=128,
                        warm=3):
    """Phase 7f (module docstring): ``prob``, 7f's ``port_json_problem``
    at ``lanes``, through ``solve_batch`` (one cold run, ``warm`` warm runs
    with the counters reset before them).  Returns its record, whose
    ``launches`` are the warm runs'."""
    import numpy as np
    import torch

    from trajopt_tpu_torch import _native
    from trajopt_tpu_torch.solver.sqp import solve_batch
    from trajopt_tpu_torch.solver.types import CONVERGED
    from trajopt_tpu_torch.terms.collision import (DiscreteDistancePre,
                                                   trajectory_in_collision)

    key = "json_table_discrete"
    spec, data, params, chain, world = prob
    t0 = time.perf_counter()
    res = solve_batch(spec, data, params, device=dev)
    torch.cuda.synchronize(dev)
    cold = time.perf_counter() - t0
    reset_counts()
    walls = []
    for _ in range(warm):
        t0 = time.perf_counter()
        res = solve_batch(spec, data, params, device=dev)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
    launches = dict(_native.LAUNCHES)
    nqp = qp_calls[0]
    st = res.status.cpu().numpy()
    v = res.cnt_viols.max(dim=1).values.cpu().numpy()
    conv = st == CONVERGED
    gated = conv & (v < 1e-4)
    X = res.x.reshape(lanes, spec.n_steps, spec.n_cols)
    # the K5 swept distance at n_sub 16 on the full table world: reported,
    # not gated (a per-step term promises no swept-free path, in the
    # reference either)
    g = trajectory_in_collision(
        world, X[..., :chain.n_dof].contiguous()).cpu().numpy()
    pre = next(t.pre_fn for t in spec.cost_terms + spec.cnt_terms
               if isinstance(t.pre_fn, DiscreteDistancePre))
    rec = {"phase": key, "batch": lanes, "n_steps": spec.n_steps,
           "n_cols": spec.n_cols, "n_x": spec.n_x, "dtype": "float32",
           "terms": [(t.name, t.kind.name, t.n_rows)
                     for t in spec.cost_terms + spec.cnt_terms],
           "collision_pairs": pre.P, "collision_nc": pre.nc,
           "cold_wall_s": cold, "warm_walls_s": walls,
           "warm_wall_s": float(np.mean(walls)), "runs": warm,
           "converged": int(conv.sum()), "gated": int(gated.sum()),
           "mean_qp_solves": float(res.n_qp_solves.double().mean()),
           "max_qp_solves": int(res.n_qp_solves.max()),
           "max_viol": float(v.max()),
           "finite": bool(torch.isfinite(res.x).all()),
           "status_counts": np.bincount(st, minlength=7).tolist(),
           "min_swept_distance": float(g.min()),
           "swept_free_lanes": int((g >= 0.0).sum()),
           "batched_qp_solves": nqp, "launches": launches,
           "launches_per_batched_qp_solve": {
               k: n / nqp for k, n in launches.items() if n} if nqp else {},
           "limits": JSON_LIMITS[key], "card": smi}
    emit(rec)
    assert rec["finite"], rec
    # K6 once per batched QP solve at b 7; K7 once per convexify (the cost
    # and the constraint share one pipeline); K7v, K10 and K10v launched;
    # no cast kernel, K1-K3 never
    assert nqp > 0 and launches["ipm_banded"] == nqp \
        and launches["ipm_banded_b8"] == 0 \
        and launches["disc_dist"] == nqp \
        and launches["disc_dist_value"] > 0 \
        and launches["contact_select"] > 0 \
        and launches["contact_select_value"] > 0 \
        and launches["cast_seg"] == launches["cast_seg_value"] == 0 \
        and all(launches[k] == 0 for k in QP_KERNELS), rec
    assert pre.nc == spec.n_cols == 7 and pre.span == spec.n_steps, rec
    assert rec["converged"] >= JSON_LIMITS[key]["converged"] \
        and rec["gated"] >= JSON_LIMITS[key]["gated"], rec
    return rec


def json_phases(dev, smi, time_ms, reset_counts, qp_calls, json_probs,
                lanes=128):
    """Phases 2g, 7a-7e and 7f (module docstring); ``json_probs``: each
    phase-7 kind's ``port_json_problem`` at ``lanes``.  Returns (summary
    entries of K10 and K10v, launches by path of every kernel on 7a-7c and
    7f)."""
    import json as _json
    import os
    import tempfile

    import numpy as np
    import torch

    from trajopt_tpu_torch import _native
    from trajopt_tpu_torch.collision.world import build_collision_world
    from trajopt_tpu_torch.models import arm7
    from trajopt_tpu_torch.problem.json_io import load_problem
    from trajopt_tpu_torch.solver.sqp import solve, solve_batch
    from trajopt_tpu_torch.solver.types import CONVERGED
    from trajopt_tpu_torch.terms.collision import (contact_select,
                                                   contact_select_plain,
                                                   kernel_attributes,
                                                   select_route,
                                                   trajectory_in_collision)
    from trajopt_tpu_torch.utils.lanes import tree_map

    def sync():
        torch.cuda.synchronize()

    def equal_groups(a, b):
        """(B, G) groups on which a and b (B, G, ...) are bitwise equal
        (NaN at the same places counts as equal)."""
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        return same.reshape(a.shape[0], a.shape[1], -1).all(-1)

    # ---------------- phase 2g: K10 / K10v against the plain selection
    K, buf = SELECT_K, SELECT_BUFFER
    sel_recs, inputs = [], {}
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[-1]
        forms = select_inputs(json_probs["table"], lanes, dt)
        for form, (D, mm, cc, A, Bj, right) in forms.items():
            kv = contact_select(D, mm, cc, buf, K)
            kr = contact_select(D, mm, cc, buf, K, A, Bj, right)
            pv, pr = contact_select_plain(D, mm, cc, buf, K, A, Bj, right)
            sync()
            B_, G_ = D.shape[:2]
            ties = select_ties(D, mm, K)
            ok_v = equal_groups(kv.reshape(B_, G_, -1), pv.reshape(B_, G_, -1))
            ok_r = equal_groups(kr[1], pr) & equal_groups(
                kr[0].reshape(B_, G_, -1), pv.reshape(B_, G_, -1))
            rec = {"phase": "contact_select", "form": form, "dtype": name,
                   "shape": list(D.shape), "K": K, "buffer": buf,
                   "route": select_route(D.shape[3], D.shape[2], K),
                   "groups": B_ * G_, "near_tie_groups": int(ties.sum()),
                   "groups_apart_K10v": int((~ok_v).sum()),
                   "groups_apart_K10": int((~ok_r).sum()),
                   "groups_apart_off_ties": int(((~ok_v | ~ok_r)
                                                 & ~ties).sum()),
                   "values_bitwise_equal_K10_K10v": bool(torch.equal(
                       kr[0], kv)),
                   "active_rows": int((pv != -1).sum()),
                   "max_abs_err": float(max(
                       (kv - pv).abs().nan_to_num().max(),
                       (kr[1] - pr).abs().nan_to_num().max()))}
            rec["ok"] = rec["groups_apart_off_ties"] == 0 \
                and rec["values_bitwise_equal_K10_K10v"]
            emit(rec)
            sel_recs.append(rec)
            assert rec["ok"], rec
            if name == "float32":
                inputs[form] = (D, mm, cc, A, Bj, right)
    # every route and size class: seeded inputs with exact ties, NaN
    # distances, signed-zero keys and inactive pairs, each output's bits
    # equal to the plain selection's on the card
    size_recs = select_sizes_check(dev)
    for rec in size_recs:
        emit(rec)
        assert rec["ok"], rec
    # times (float32): the bare wrapper launch on the device clock, the
    # plain version's, torch.topk's for the selection alone (the keys
    # given), and the bound
    sel_timing = {}
    for form, (D, mm, cc, A, Bj, right) in inputs.items():
        key = torch.amax(mm[:, None, None, :] - D, dim=2)
        for kname, jac in (("contact_select", True),
                           ("contact_select_value", False)):
            args = (A, Bj, right) if jac else ()
            ms, enq = device_ms(lambda: contact_select(D, mm, cc, buf, K,
                                                       *args))
            plain = time_ms(lambda: contact_select_plain(D, mm, cc, buf, K,
                                                         *args), reps=10)
            lib = time_ms(lambda: torch.topk(key, K, dim=-1))
            nb, ops = select_work(D, K, A.shape[-1], 4, jac,
                                  1 if Bj is None else 2)
            t_b, t_o = nb / PEAK_BYTES * 1e3, ops / PEAK_FLOPS["float32"] * 1e3
            sel_timing[f"{kname}_{form}"] = {
                "ms": ms, "plain_ms": plain, "library_ms": lib,
                "library_call": "torch.topk(key, 3) on the precomputed keys: "
                "the selection part only (no keys, no gathers)",
                "queue": enq, "bound_ms": max(t_b, t_o),
                "bound_by": "bytes" if t_b >= t_o else "operations",
                "work": {"bytes": nb, "operations": ops},
                "shape": list(D.shape) + [A.shape[-1]]}
    # the launch floor: one (lane, group) of the cast form
    D, mm, cc, A, Bj, right = inputs["cast"]
    one = (D[:1, :1].contiguous(), mm[:1].contiguous(), cc[:1].contiguous())
    for kname, args in (("contact_select", (A[:1, :1].contiguous(),
                                            Bj[:1, :1].contiguous(), -1)),
                        ("contact_select_value", ())):
        ms, enq = device_ms(lambda: contact_select(*one, buf, K, *args))
        sel_timing[f"{kname}_one_group"] = {
            "ms": ms, "queue": enq, "shape": list(one[0].shape)}
    attrs = {k: v for k, v in kernel_attributes().items()
             if k.startswith("contact_select")}
    emit({"phase": "contact_select_timing", "timing": sel_timing,
          "attributes": attrs, "card": smi})
    # every instantiation keeps its lanes' pairs, errors and rows in
    # registers and shared memory
    assert all(v["local_bytes"] == 0 for v in attrs.values()), attrs

    # ---------------- phases 7a-7c: the documents through the SQP
    by_path = {}
    for kind, warm in (("table", 3), ("table_time", 3), ("timed_vel", 1),
                       ("timed_vel_total", 1)):
        key = f"json_{kind}"
        spec, data, params, chain, world = json_probs[kind]
        t0 = time.perf_counter()
        res = solve_batch(spec, data, params, device=dev)
        sync()
        cold = time.perf_counter() - t0
        reset_counts()
        walls = []
        for _ in range(warm):
            t0 = time.perf_counter()
            res = solve_batch(spec, data, params, device=dev)
            sync()
            walls.append(time.perf_counter() - t0)
        launches = dict(_native.LAUNCHES)
        nqp = qp_calls[0]
        by_path[key] = launches
        st = res.status.cpu().numpy()
        v = res.cnt_viols.max(dim=1).values.cpu().numpy()
        conv = st == CONVERGED
        gated = conv & (v < 1e-4)
        X = res.x.reshape(lanes, spec.n_steps, spec.n_cols)
        rec = {"phase": key, "batch": lanes, "n_steps": spec.n_steps,
               "n_cols": spec.n_cols, "n_x": spec.n_x, "dtype": "float32",
               "terms": [(t.name, t.kind.name, t.n_rows)
                         for t in spec.cost_terms + spec.cnt_terms],
               "cold_wall_s": cold, "warm_walls_s": walls,
               "warm_wall_s": float(np.mean(walls)), "runs": warm,
               "converged": int(conv.sum()),
               "mean_qp_solves": float(res.n_qp_solves.double().mean()),
               "max_qp_solves": int(res.n_qp_solves.max()),
               "max_viol": float(v.max()),
               "finite": bool(torch.isfinite(res.x).all()),
               "status_counts": np.bincount(st, minlength=7).tolist(),
               "batched_qp_solves": nqp, "launches": launches,
               "launches_per_batched_qp_solve": {
                   k: n / nqp for k, n in launches.items() if n},
               "limits": JSON_LIMITS[key], "card": smi}
        assert rec["finite"], rec
        assert nqp > 0 and launches["bb_quad"] == 0, rec
        if kind.startswith("table"):
            g = trajectory_in_collision(
                world, X[..., :chain.n_dof].contiguous()).cpu().numpy()
            gated = gated & (g >= 0.0)
            rec["min_swept_distance"] = float(g.min())
            cpre_k = next(t.pre_fn for t in spec.cost_terms
                          if t.pre_fn is not None)
            rec["collision_pairs"] = cpre_k.P
            rec["n_sub"] = cpre_k.n_seg + 1
            rec["collision_nc"] = cpre_k.nc
            # K6 once per batched QP solve, at the grid's block size; one
            # K4 per convexify (cost and constraint share one pipeline);
            # K4v, K10 and K10v launched; K1-K3 never
            b8 = kind == "table_time"
            assert launches["ipm_banded"] == nqp \
                and launches["ipm_banded_b8"] == (nqp if b8 else 0) \
                and launches["cast_seg"] == nqp \
                and launches["cast_seg_value"] > 0 \
                and launches["contact_select"] > 0 \
                and launches["contact_select_value"] > 0 \
                and launches["btd_factor"] == 0 \
                and launches["btd_solve"] == 0, rec
            assert cpre_k.nc == spec.n_cols == (8 if b8 else 7), rec
            if b8:
                inv = X[..., 7]
                rec["inv_dt_range"] = [float(inv.min()), float(inv.max())]
                assert float(inv.min()) >= 2.0 - 1e-5 \
                    and float(inv.max()) <= 20.0 + 1e-5, rec
        else:
            # the timed velocity and the total time, as tests/test_json_io.py
            # checks them: |velocity| <= 1 rad/s, the total time at least the
            # lane's least and (with the total_time cost) at most its limit
            docs = json_docs(kind, lanes, spec.n_steps)
            start = torch.as_tensor([d["init_info"]["data"] for d in docs],
                                    device=dev)
            goal = torch.as_tensor([d["init_info"]["endpoint"] for d in docs],
                                   device=dev)
            least = (goal - start).abs().amax(-1)
            Q, inv = X[..., :7].double(), X[..., 7].double()
            vel = ((Q[:, 1:] - Q[:, :-1]) * inv[:, 1:, None]).abs().amax(
                (1, 2))
            total = (1.0 / inv[:, 1:]).sum(-1)
            ok_t = (vel <= 1.0 + 1e-3) & (total >= least - 1e-2)
            if kind == "timed_vel_total":
                ok_t = ok_t & (total <= 1.25 * least + 1e-2)
            ok_t = ok_t.cpu().numpy()
            rec.update(max_velocity=float(vel.max()),
                       total_time_range=[float(total.min()),
                                         float(total.max())],
                       lanes_time_and_velocity_ok=int(ok_t.sum()),
                       converged_lanes_time_and_velocity_ok=int(
                           (ok_t & conv).sum()))
            gated = gated & ok_t
            # K11 once per batched QP solve: (i) its block route at
            # kkt_block 8, (ii) no band (total_time couples every step):
            # its dense route; K6, K1-K3 and torch's Cholesky never
            rec["linalg_calls"] = dict(LINALG_CALLS)
            assert dense_path_ok(launches, nqp,
                                 b=8 if kind == "timed_vel" else None), rec
        rec["gated"] = int(gated.sum())
        emit(rec)
        assert rec["converged"] >= JSON_LIMITS[key]["converged"] \
            and rec["gated"] >= JSON_LIMITS[key]["gated"], rec

    # ---------------- phase 7d: the CLI on the card, no --device
    model, chain = arm7()
    world = build_collision_world(model, chain)
    tool = chain.link_index("tool")
    R, p = chain.fk(torch.tensor([0.4, 0.6, -0.2, 0.9, 0.3, -0.5, 0.2],
                                 dtype=torch.float64))
    Rt = R[tool].numpy()
    w = np.sqrt(max(1 + Rt[0, 0] + Rt[1, 1] + Rt[2, 2], 0)) / 2
    quat = [w, (Rt[2, 1] - Rt[1, 2]) / (4 * w), (Rt[0, 2] - Rt[2, 0]) / (4 * w),
            (Rt[1, 0] - Rt[0, 1]) / (4 * w)]
    ik_doc = {"basic_info": {"n_steps": 1, "manip": "arm"},
              "constraints": [{"type": "cart_pose", "params": {
                  "pos_coeffs": [1, 1, 1], "rot_coeffs": [1, 1, 1],
                  "source_frame": "tool", "target_frame": "base",
                  "target_frame_offset_xyz": p[tool].tolist(),
                  "target_frame_offset_wxyz": quat}}],
              "costs": [{"type": "joint_pos",
                         "params": {"coeffs": 1e-4, "targets": 0.0}}],
              "init_info": {"type": "given_traj", "data": [[0.1] * 7]}}
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    cli_recs = []
    try:
        for label, doc in (("numerical_ik1", ik_doc),
                           ("table_lane0", json_docs("table", 1)[0])):
            path, out = (os.path.join(tmp, f"{label}{e}")
                         for e in (".json", "_out.json"))
            with open(path, "w") as f:
                _json.dump(doc, f)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "trajopt_tpu_torch", "solve", path,
                 "--model", "arm7", "--out", out], cwd=root,
                capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            got = _json.load(open(out)) if proc.returncode == 0 else None
            spec, data, params = load_problem(doc, chain, world, device=dev)
            data = tree_map(lambda t: t.to(torch.float32)
                            if t.is_floating_point() else t, data)
            reset_counts()
            r = solve(spec, data, params, device=dev)
            sync()
            launches = {k: n for k, n in _native.LAUNCHES.items() if n}
            rec = {"phase": "cli", "document": label, "rc": proc.returncode,
                   "converged_in_stdout": "OPT_CONVERGED" in proc.stdout,
                   "subprocess_wall_s": wall,
                   "status": None if got is None else got["status"],
                   "in_process_status": int(r.status),
                   "in_process_launches": launches,
                   "stderr_tail": proc.stderr[-800:]}
            if got is not None:
                dx = np.abs(np.asarray(got["trajectory"]).reshape(-1)
                            - r.x.double().cpu().numpy()).max()
                rec.update(x_abs_diff=float(dx), tol=CLI_X_TOL,
                           n_qp_solves=got["n_qp_solves"],
                           in_process_n_qp_solves=int(r.n_qp_solves))
            rec["ok"] = proc.returncode == 0 and rec["converged_in_stdout"] \
                and got is not None and rec["x_abs_diff"] <= CLI_X_TOL \
                and int(r.status) == CONVERGED
            if label == "numerical_ik1":
                rec["ok"] = rec["ok"] and launches.get("cart_pose", 0) > 0
            emit(rec)
            cli_recs.append(rec)
            assert rec["ok"], rec
    finally:
        for f in os.listdir(tmp):
            os.remove(os.path.join(tmp, f))
        os.rmdir(tmp)

    # ---------------- phase 7e: float64 kernel path against plain path
    for kind in ("table", "table_time"):
        spec64, data64, par64 = port_json_problem(json_docs(kind, 8),
                                                  torch.float64, dev)[:3]
        u = torch.as_tensor(np.random.default_rng(16).integers(
            -1, 2, tuple(data64.x0.shape)), device=dev).to(torch.float64)
        d_ulp = data64._replace(
            x0=data64.x0 * (1 + u * torch.finfo(torch.float64).eps))
        rk, rp, rku, rpu = (solve_batch(spec64, d, par64, device=dev,
                                        kernels=k)
                            for d, k in ((data64, True), (data64, False),
                                         (d_ulp, True), (d_ulp, False)))
        same_n = rk.n_qp_solves == rp.n_qp_solves
        flips = ~same_n & ((rku.n_qp_solves == rp.n_qp_solves)
                           | (rpu.n_qp_solves == rk.n_qp_solves))
        dx = (rk.x - rp.x).abs().amax(-1)
        rec = {"phase": f"f64_json_{kind}_kernel_vs_plain", "lanes": 8,
               "status": rk.status.tolist(),
               "status_plain": rp.status.tolist(),
               "n_qp": rk.n_qp_solves.tolist(),
               "n_qp_plain": rp.n_qp_solves.tolist(),
               "n_qp_x0_ulp": rku.n_qp_solves.tolist(),
               "n_qp_plain_x0_ulp": rpu.n_qp_solves.tolist(),
               "same_status": bool((rk.status == rp.status).all()),
               "lanes_apart": int((~same_n).sum()),
               "lanes_apart_decided_under_one_ulp": int(flips.sum()),
               "dx_per_lane": dx.tolist(),
               "max_abs_dx_equal_counts": max0(dx[same_n]),
               "plain_x0_ulp_dx_per_lane": (rpu.x - rp.x).abs().amax(
                   -1).tolist(),
               "tol": JSON_DX_TOL}
        rec["ok"] = rec["same_status"] and bool((same_n | flips).all()) \
            and rec["max_abs_dx_equal_counts"] <= JSON_DX_TOL
        emit(rec)
        assert rec["ok"], rec

    # ---------------- phase 7f: 7a's documents with discrete collision
    rec7f = discrete_json_phase(dev, smi, reset_counts, qp_calls,
                                json_probs["table_discrete"], lanes)
    by_path["json_table_discrete"] = rec7f["launches"]

    # the summary's entries
    ta = by_path["json_table"]
    entries = {}
    for kname, rep, label in (
            ("contact_select", "trajopt_tpu/terms/collision.py:457", "K10"),
            ("contact_select_value", "trajopt_tpu/terms/collision.py:444",
             "K10v")):
        t = sel_timing[f"{kname}_cast"]
        entries[kname] = {
            "name": kname, "route": "cuda",
            "source": "trajopt_tpu_torch/csrc/contact_select.cu",
            "replaces": rep, "kernel": label,
            "also_replaces": ["trajopt_tpu/terms/collision.py:70",
                              "trajopt_tpu/terms/collision.py:252"],
            "launches": ta[kname], "ok": True,
            "max_abs_err": max(r["max_abs_err"] for r in sel_recs
                               + size_recs),
            "max_abs_err_of": "values and rows against the plain selection, "
            "float32 and float64, both forms, 7a's inputs and "
            "SELECT_SIZES (phase 2g)",
            "sizes_bitwise_equal": len(size_recs),
            "near_tie_groups": {f"{r['form']}_{r['dtype']}":
                                r["near_tie_groups"] for r in sel_recs},
            "groups_apart": {f"{r['form']}_{r['dtype']}":
                             r["groups_apart_K10"] for r in sel_recs},
            "launches_are": "phase 7a's three warm runs",
            "discrete": sel_timing[f"{kname}_discrete"],
            "sources": [f"trajopt_tpu_torch/csrc/{f}" for f in (
                "contact_select.cu", "contact_select.cuh")],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_call": t["library_call"], "shape": t["shape"]}
    return entries, by_path


# phases 8a / 8b: the JAX package's own float32 counts on the CPU less 5
# (scripts/jax_reference_counts.py --names box_cast box_cast_t30: 128
# converged and gated each; mean QP solves 3.59375 and 3.6640625)
BOX_LIMITS = {"box_cast": {"converged": 123, "gated": 123},
              "box_cast_t30": {"converged": 123, "gated": 123}}
# phase 8c: each spherebot document's status counts over 128 float32 copies
# in the JAX package on the CPU (scripts/jax_reference_counts.py --names
# spherebot_docs: all 128 CONVERGED), which the card must give exactly
SPHERE_DOC_COUNTS = {k: {1: 128} for k in (
    "simple_collision", "opt_info", "time_parameterized",
    "timed_vel_total_time", "cli")}
# phase 8c, float64 on 8 copies: kernel path against plain path
SPHERE_DX_TOL = 1e-8


def box_phases(dev, smi, time_ms, reset_counts, qp_calls, box_probs,
               lanes=128):
    """Phases 8a-8e (module docstring); ``box_probs``: each phase-8 kind's
    ``port_box_problem`` at ``lanes`` in float32.  Returns the launches by
    path of every kernel on 8a-8c."""
    import json as _json
    import os
    import tempfile

    import numpy as np
    import torch

    from trajopt_tpu_torch import _native
    from trajopt_tpu_torch.collision.world import build_collision_world
    from trajopt_tpu_torch.models import boxbot, spherebot
    from trajopt_tpu_torch.problem.json_io import load_problem
    from trajopt_tpu_torch.solver.sqp import solve, solve_batch
    from trajopt_tpu_torch.solver.types import CONVERGED
    from trajopt_tpu_torch.terms.collision import trajectory_in_collision
    from trajopt_tpu_torch.utils.lanes import tree_map

    def sync():
        torch.cuda.synchronize()

    by_path = {}
    # ---------------- phases 8a / 8b: boxbot's documents through the SQP
    for kind, warm in (("box_cast", 3), ("box_cast_t30", 3)):
        spec, data, params, chain, world = box_probs[kind]
        t0 = time.perf_counter()
        res = solve_batch(spec, data, params, device=dev)
        sync()
        cold = time.perf_counter() - t0
        reset_counts()
        walls = []
        for _ in range(warm):
            t0 = time.perf_counter()
            res = solve_batch(spec, data, params, device=dev)
            sync()
            walls.append(time.perf_counter() - t0)
        launches = dict(_native.LAUNCHES)
        nqp = qp_calls[0]
        X = res.x.reshape(lanes, spec.n_steps, spec.n_cols)
        g = trajectory_in_collision(world, X.contiguous())
        sync()
        gate_k5 = _native.LAUNCHES["cast_sweep"] - launches["cast_sweep"]
        by_path[kind] = dict(_native.LAUNCHES)  # the gate's K5 too
        st = res.status.cpu().numpy()
        v = res.cnt_viols.max(dim=1).values.cpu().numpy()
        g = g.cpu().numpy()
        conv = st == CONVERGED
        gated = conv & (v < 1e-4) & (g >= 0.0)
        pre = next(t.pre_fn for t in spec.cost_terms if t.pre_fn is not None)
        rec = {"phase": kind, "batch": lanes, "n_steps": spec.n_steps,
               "n_x": spec.n_x, "dtype": "float32",
               "terms": [(t.name, t.kind.name, t.n_rows)
                         for t in spec.cost_terms + spec.cnt_terms],
               "n_sub": pre.n_seg + 1, "kkt_block": params.qp.kkt_block,
               "cold_wall_s": cold, "warm_walls_s": walls,
               "warm_wall_s": float(np.mean(walls)), "runs": warm,
               "converged": int(conv.sum()), "gated": int(gated.sum()),
               "gated_solves_per_s": int(gated.sum()) / float(np.mean(walls)),
               "mean_qp_solves": float(res.n_qp_solves.double().mean()),
               "max_qp_solves": int(res.n_qp_solves.max()),
               "max_viol": float(v.max()),
               "min_swept_distance": float(g.min()),
               "finite": bool(torch.isfinite(res.x).all()),
               "status_counts": np.bincount(st, minlength=7).tolist(),
               "batched_qp_solves": nqp, "launches": launches,
               "launches_per_batched_qp_solve": {
                   k: n / nqp for k, n in launches.items() if n},
               "gate_cast_sweep_launches": gate_k5,
               "limits": BOX_LIMITS[kind], "card": smi}
        emit(rec)
        # K6 at b 2 once per batched QP solve (no plain IPM loop); one K4
        # at n_dof 2 per convexify; K4v launched; the gate's K5; K1-K3 never
        assert rec["finite"] and nqp > 0, rec
        assert launches["ipm_banded"] == nqp \
            and launches["ipm_banded_b2"] == nqp \
            and launches["cast_seg"] == nqp \
            and launches["cast_seg_nd2"] == nqp \
            and launches["cast_seg_value"] > 0 \
            and launches["cast_boxbox"] > 0 and gate_k5 == 1 \
            and all(launches[k] == 0 for k in QP_KERNELS), rec
        assert rec["converged"] >= BOX_LIMITS[kind]["converged"] \
            and rec["gated"] >= BOX_LIMITS[kind]["gated"], rec

    # ---------------- phase 8c: the spherebot documents on the card
    on_k11 = []
    for key, (doc, _, _) in spherebot_docs().items():
        spec, data, params = port_json_problem([doc] * lanes, torch.float32,
                                               dev, "spherebot")[:3]
        reset_counts()
        res = solve_batch(spec, data, params, device=dev)
        sync()
        launches = dict(_native.LAUNCHES)
        nqp = qp_calls[0]
        by_path[f"spherebot_{key}"] = launches
        # every batched QP solve one launch: K11 on the dense-row QPs (one
        # step, a total_time cost), K6 on the banded ones; K1-K3 and
        # torch's Cholesky never
        dense = launches["ipm_dense"] > 0
        one_each = (dense_path_ok(launches, nqp) if dense else
                    launches["ipm_banded"] == nqp > 0
                    and all(launches[k] == 0 for k in QP_KERNELS)
                    and not any(LINALG_CALLS.values()))
        if dense:
            on_k11.append(key)
        st = res.status.cpu().numpy()
        counts = {int(k): int(n) for k, n in
                  zip(*np.unique(st, return_counts=True))}
        spec64, data64, par64 = port_json_problem(
            [doc] * 8, torch.float64, dev, "spherebot")[:3]
        rk = solve_batch(spec64, data64, par64, device=dev)
        rp = solve_batch(spec64, data64, par64, device=dev, kernels=False)
        dx = float((rk.x - rp.x).abs().max())
        rec = {"phase": "spherebot_document", "document": key,
               "batch": lanes, "kkt_block": params.qp.kkt_block,
               "n_x": spec.n_x, "status_counts": counts,
               "jax_status_counts": SPHERE_DOC_COUNTS.get(key),
               "mean_qp_solves": float(res.n_qp_solves.double().mean()),
               "batched_qp_solves": nqp,
               "launches": {k: n for k, n in launches.items() if n},
               "f64_same_status": bool((rk.status == rp.status).all()),
               "f64_same_n_qp": bool((rk.n_qp_solves
                                      == rp.n_qp_solves).all()),
               "f64_max_abs_dx": dx, "f64_tol": SPHERE_DX_TOL,
               "qp_kernel": "ipm_dense" if dense else "ipm_banded",
               "card": smi}
        rec["ok"] = counts == SPHERE_DOC_COUNTS.get(key) \
            and rec["f64_same_status"] and rec["f64_same_n_qp"] \
            and dx <= SPHERE_DX_TOL and one_each
        emit(rec)
        assert rec["ok"], rec
    assert on_k11, "no spherebot document took K11's dense-row QP"

    # ---------------- phase 8d: the CLI on the card, no --device
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    box_doc = box_docs("box_cast", 1)[0]
    try:
        for label, model, doc, n_sub in (
                ("cli_test", "spherebot", CLI_DOC, None),
                ("box_cast_lane0", "boxbot", box_doc, BOX_N_SUB)):
            path, out = (os.path.join(tmp, f"{label}{e}")
                         for e in (".json", "_out.json"))
            with open(path, "w") as f:
                _json.dump(doc, f)
            cmd = [sys.executable, "-m", "trajopt_tpu_torch", "solve", path,
                   "--model", model, "--out", out]
            if n_sub is not None:
                cmd += ["--n-sub", str(n_sub)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=root, capture_output=True,
                                  text=True, timeout=600)
            wall = time.perf_counter() - t0
            got = _json.load(open(out)) if proc.returncode == 0 else None
            mdl, chain = (spherebot if model == "spherebot" else boxbot)()
            world = build_collision_world(mdl, chain)
            spec, data, params = load_problem(
                doc, chain, world, device=dev,
                **({} if n_sub is None else {"n_sub": n_sub}))
            data = tree_map(lambda t: t.to(torch.float32)
                            if t.is_floating_point() else t, data)
            reset_counts()
            r = solve(spec, data, params, device=dev)
            sync()
            launches = {k: n for k, n in _native.LAUNCHES.items() if n}
            rec = {"phase": "cli", "document": label, "model": model,
                   "rc": proc.returncode,
                   "converged_in_stdout": "OPT_CONVERGED" in proc.stdout,
                   "subprocess_wall_s": wall,
                   "status": None if got is None else got["status"],
                   "in_process_status": int(r.status),
                   "in_process_launches": launches,
                   "stderr_tail": proc.stderr[-800:]}
            if got is not None:
                dx = np.abs(np.asarray(got["trajectory"]).reshape(-1)
                            - r.x.double().cpu().numpy()).max()
                rec.update(x_abs_diff=float(dx), tol=CLI_X_TOL,
                           n_qp_solves=got["n_qp_solves"],
                           in_process_n_qp_solves=int(r.n_qp_solves))
            rec["ok"] = proc.returncode == 0 and rec["converged_in_stdout"] \
                and got is not None and rec["x_abs_diff"] <= CLI_X_TOL \
                and int(r.status) == CONVERGED \
                and launches.get("ipm_banded", 0) > 0
            if model == "boxbot":
                rec["ok"] = rec["ok"] and launches.get("cast_seg_nd2", 0) > 0
            emit(rec)
            assert rec["ok"], rec
    finally:
        for f in os.listdir(tmp):
            os.remove(os.path.join(tmp, f))
        os.rmdir(tmp)

    # ---------------- phase 8e: float64 kernel path against plain path
    for kind in BOX_KINDS:
        spec64, data64, par64 = port_box_problem(box_docs(kind, 8),
                                                 torch.float64, dev)[:3]
        u = torch.as_tensor(np.random.default_rng(17).integers(
            -1, 2, tuple(data64.x0.shape)), device=dev).to(torch.float64)
        d_ulp = data64._replace(
            x0=data64.x0 * (1 + u * torch.finfo(torch.float64).eps))
        rk, rp, rpu = (solve_batch(spec64, d, par64, device=dev, kernels=k)
                       for d, k in ((data64, True), (data64, False),
                                    (d_ulp, False)))
        dx = (rk.x - rp.x).abs().amax(-1)
        du = (rpu.x - rp.x).abs().amax(-1)
        rec = {"phase": f"f64_{kind}_kernel_vs_plain", "lanes": 8,
               "status": rk.status.tolist(),
               "status_plain": rp.status.tolist(),
               "n_qp": rk.n_qp_solves.tolist(),
               "n_qp_plain": rp.n_qp_solves.tolist(),
               "same_status": bool((rk.status == rp.status).all()),
               "same_n_qp": bool((rk.n_qp_solves == rp.n_qp_solves).all()),
               "max_abs_dx": float(dx.max()), "dx_per_lane": dx.tolist(),
               "plain_x0_ulp_dx_per_lane": du.tolist(),
               "lanes_beyond_ulp_move": int((dx > du).sum()),
               "tol": FLAGSHIP_DX_TOL}
        rec["ok"] = rec["same_status"] and rec["same_n_qp"] \
            and rec["max_abs_dx"] < FLAGSHIP_DX_TOL \
            and rec["max_abs_dx"] <= max(float(du.max()), 1e-10)
        emit(rec)
        assert rec["ok"], rec
    return by_path


# calls of torch's dense Cholesky factors and triangular solves, by name,
# once count_linalg() has wrapped them (reset with the launch counters):
# a dense-row path whose QPs K11 carries makes none
LINALG_CALLS = {}


def count_linalg():
    """Wrap ``torch.linalg.cholesky``, ``cholesky_ex``,
    ``solve_triangular`` and ``torch.cholesky_solve`` so that every call
    adds one to ``LINALG_CALLS[name]``."""
    import torch

    for mod, name in ((torch.linalg, "cholesky"),
                      (torch.linalg, "cholesky_ex"),
                      (torch.linalg, "solve_triangular"),
                      (torch, "cholesky_solve")):
        fn = getattr(mod, name)
        if name in LINALG_CALLS:
            continue

        def counted(*a, _fn=fn, _name=name, **k):
            LINALG_CALLS[_name] += 1
            return _fn(*a, **k)
        LINALG_CALLS[name] = 0
        setattr(mod, name, counted)


def dense_path_ok(launches, n_qp, b=None):
    """A dense-row path: K11 once per batched QP solve (on its block route
    at block size b, or with b None its dense route), K6 and standalone
    K1-K3 never, and no call in ``LINALG_CALLS`` since the last reset."""
    route = launches[f"ipm_dense_b{b}" if b else "ipm_dense_chol"]
    return n_qp > 0 and launches["ipm_dense"] == n_qp == route \
        and launches["ipm_banded"] == 0 \
        and all(launches[k] == 0 for k in QP_KERNELS) \
        and not any(LINALG_CALLS.values())


def count_qp_calls(sqp_mod, native):
    """Count the SQP's batched QP solves (``sqp_mod.solve_ipm_qp`` wrapped):
    (calls, reset), calls[0] the count since reset(), which also sets every
    kernel's launch counter and every ``LINALG_CALLS`` count to 0."""
    calls = [0]
    solve_qp = sqp_mod.solve_ipm_qp

    def counted_qp(*a, **k):
        calls[0] += 1
        return solve_qp(*a, **k)
    sqp_mod.solve_ipm_qp = counted_qp

    def reset():
        native.reset_launches()
        for k in LINALG_CALLS:
            LINALG_CALLS[k] = 0
        calls[0] = 0
    return calls, reset


def ptxas_functions(log):
    """{mangled kernel name: {"registers", "stack_bytes", "spill_stores",
    "spill_loads"}} from an nvcc build log with ``-Xptxas -v``."""
    import re

    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = m.group(1)
            out[cur] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur:
            out[cur].update(stack_bytes=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur:
            out[cur]["registers"] = int(m.group(1))
    return out


def max0(t):
    """The largest entry of t, 0 when t is empty (no such rows)."""
    return float(t.max()) if t.numel() else 0.0


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; every line but the last also carries the seconds
    since the script started (``t_s``)."""
    if "device" not in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: CUDA is not available\n")
        sys.exit(2)

    import numpy as np

    from trajopt_tpu_torch import _native
    from trajopt_tpu_torch.benchmarks import (bench_params, chain_transfer,
                                              make_glass_upright,
                                              make_glass_upright_free,
                                              make_pick_and_place,
                                              make_planning,
                                              make_redundant_rail,
                                              make_simple_collision,
                                              run_benchmarks,
                                              solve_pick_and_place)
    from trajopt_tpu_torch import models
    from trajopt_tpu_torch.collision import geometry as geom
    from trajopt_tpu_torch.collision.world import build_collision_world
    from trajopt_tpu_torch.kinematics.urdf import UrdfGeom
    from trajopt_tpu_torch.ops import banded_rows as br
    from trajopt_tpu_torch.ops import btridiag as bt
    from trajopt_tpu_torch.ops import ipm_qp
    from trajopt_tpu_torch.solver import sqp as sqp_mod
    from trajopt_tpu_torch.solver.sqp import solve_batch, solve_batch_compact
    from trajopt_tpu_torch.solver.types import CONVERGED
    from trajopt_tpu_torch.terms.collision import _disc_plan as disc_plan
    from trajopt_tpu_torch.terms.collision import (DISC_BLOCKS,
                                                   CastDistancePre,
                                                   DiscreteDistancePre,
                                                   cast_sweep_distances,
                                                   convex_route,
                                                   kernel_attributes,
                                                   trajectory_in_collision)

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    build_s = _native.build_all()
    ptxas = {}
    for name in _native.SOURCES:
        log = (_native.BUILD_DIR / f"{name}.log")
        if log.exists():
            ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln]
    emit({"phase": "setup", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "build_s_by_library": dict(_native.BUILD_SECONDS), "ptxas": ptxas})
    # registers and local memory of every K4 / K4v / K5 instantiation
    # (cudaFuncGetAttributes)
    cast_attrs = kernel_attributes()
    emit({"phase": "cast_attributes", "attributes": cast_attrs, "card": smi})
    # and of K6's instantiations; the float32 ones up to
    # K6_F32_NO_LOCAL_MAX_B keep their lane view in registers and shared
    # memory
    ipm_attrs = ipm_qp.kernel_attributes()
    emit({"phase": "ipm_attributes", "attributes": ipm_attrs, "card": smi})
    assert all(ipm_attrs[f"f32_b{b}"]["local_bytes"] == 0
               for b in range(1, K6_F32_NO_LOCAL_MAX_B + 1)), ipm_attrs
    # the instantiations this slice added: K10 / K10v (one kernel, float32
    # and float64), K6 at b 8 (above) and K1-K3 at b 8 (their ptxas lines;
    # K1 takes b at run time, one instantiation per dtype)
    b8_attrs = {"contact_select": {d: cast_attrs[f"contact_select_{d}"]
                                   for d in ("f32", "f64")},
                "ipm_banded_b8": {d: ipm_attrs[f"{d}_b8"]
                                  for d in ("f32", "f64")}}
    for src, pat in (("bb_quad", "bb_quad_kernel"),
                     ("btd_factor", "btd_factor_kernelI{}Li8E"),
                     ("btd_solve", "btd_solve_kernelI{}Li8E")):
        fns = ptxas_functions((_native.BUILD_DIR / f"{src}.log").read_text()
                              if (_native.BUILD_DIR / f"{src}.log").exists()
                              else "")
        b8_attrs[src + ("" if src == "bb_quad" else "_b8")] = {
            d: next((v for k, v in fns.items()
                     if pat.format(c) in k), "no ptxas line (built earlier)")
            for d, c in (("f32", "f"), ("f64", "d"))}
    emit({"phase": "b8_and_select_attributes", "attributes": b8_attrs,
          "card": smi})
    # the float32 K4 (n_dof 7) and K4v without the CONVEX routes keep every
    # value in registers and shared memory (the launch bounds in
    # cast_kernel.cuh), and so do the float32 K7 and K7v, their tables
    # staged or not
    assert all(cast_attrs[k]["local_bytes"] == 0
               for k in ("cast_seg_f32", "cast_seg_value_f32",
                         "disc_dist_f32", "disc_dist_value_f32",
                         "disc_dist_global_f32",
                         "disc_dist_value_global_f32")), cast_attrs

    def sync():
        torch.cuda.synchronize()

    def time_ms(fn, reps=50):
        fn()
        sync()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        sync()
        return t0.elapsed_time(t1) / reps

    def rel_err(got, ref):
        scale = float(ref.abs().max().clamp(min=1e-30))
        return float((got - ref).abs().max()), float((got - ref).abs().max()) / scale

    # ------------------------------------------------------------------
    # phase 2: kernels vs plain versions
    # ------------------------------------------------------------------
    lanes, n_x, D = 128, 210, 7
    rng = np.random.default_rng(0)

    def spd(b, dtype):
        """Block-tridiagonal SPD systems like the IPM's: J' diag(d) J + I
        over gap windows, at n_x = 210 split into blocks of b."""
        T = n_x // b
        W = torch.as_tensor(rng.normal(size=(lanes, T - 1, 2 * b, 2 * b))
                            / np.sqrt(2 * b), device=dev)
        d = torch.as_tensor(rng.uniform(0.5, 2.0, (lanes, (T - 1) * 2 * b)),
                            device=dev)
        Dm = 2.0 * torch.eye(b, dtype=torch.float64, device=dev).repeat(
            lanes, T, 1, 1)
        Om = torch.zeros((lanes, T - 1, b, b), dtype=torch.float64, device=dev)
        br.bb_quad_group_plain(W, torch.arange(T - 1, dtype=torch.int32,
                                               device=dev), d, Dm, Om)
        r = torch.as_tensor(rng.normal(size=(lanes, T, b)), device=dev)
        return Dm.to(dtype), Om.to(dtype), r.to(dtype)

    def k1_inputs(b, dtype, ng, r):
        nb = n_x // b
        Bw = torch.as_tensor(rng.normal(size=(lanes, ng, r, 2 * b)),
                             device=dev).to(dtype)
        G = torch.as_tensor(np.minimum(np.arange(ng), nb - 2).astype(np.int32)
                            if ng > 1 else np.asarray([nb - 2], np.int32),
                            device=dev)
        d = torch.as_tensor(rng.uniform(0.1, 2.0, (lanes, ng * r)),
                            device=dev).to(dtype)
        D0 = torch.as_tensor(rng.normal(size=(lanes, nb, b, b)), device=dev).to(dtype)
        O0 = torch.as_tensor(rng.normal(size=(lanes, nb - 1, b, b)), device=dev).to(dtype)
        return Bw, G, d, D0, O0

    checks = {"bb_quad": [], "btd_factor": [], "btd_solve": []}
    slice_err = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        for b in (7, 14, 21):
            T = n_x // b
            # K1: the upright group (per-step windows, last step doubled up
            # in window nb-2) and the goal group (one window, r = 7)
            # (b = 7 also: the collision row group, 29 gap windows x 28)
            for ng, r in ((T, 2), (1, D)) + (((T - 1, 28),) if b == 7 else ()):
                Bw, G, d, D0, O0 = k1_inputs(b, dtype, ng, r)
                Dk, Ok = D0.clone(), O0.clone()
                Dp, Op = D0.clone(), O0.clone()
                br.bb_quad_group_cuda(Bw, G, d, Dk, Ok)
                br.bb_quad_group_plain(Bw, G, d, Dp, Op)
                sync()
                ea, er = max(rel_err(Dk, Dp), rel_err(Ok, Op), key=lambda e: e[1])
                ok = er < REL_TOL[dname]
                checks["bb_quad"].append(er)
                emit({"check": "bb_quad", "dtype": dname, "b": b, "n_g": ng,
                      "r": r, "max_abs_err": ea, "max_rel_err": er,
                      "tol": REL_TOL[dname], "ok": ok})
                assert ok, "bb_quad disagrees with its plain version"
                if b == 7 and dname == "float32" and ng == T - 1:
                    slice_err["bb_quad"] = ea
            Dm, Om, rr = spd(b, dtype)
            LDk, LMk = bt.btd_factor_cuda(Dm, Om)
            LDp, LMp = bt.btd_factor_plain(Dm, Om)
            xk = bt.btd_solve_cuda(LDp, LMp, rr)
            xp = bt.btd_solve_plain(LDp, LMp, rr)
            sync()
            for name, (ea, er) in (
                    ("btd_factor", max(rel_err(LDk, LDp), rel_err(LMk, LMp),
                                       key=lambda e: e[1])),
                    ("btd_solve", rel_err(xk, xp))):
                ok = er < REL_TOL[dname]
                checks[name].append(er)
                emit({"check": name, "dtype": dname, "b": b, "T": T,
                      "max_abs_err": ea, "max_rel_err": er,
                      "tol": REL_TOL[dname], "ok": ok})
                assert ok, f"{name} disagrees with its plain version"
                if b == 7 and dname == "float32":
                    slice_err[name] = ea

    # ---- times at the main path's shapes (float32, b = 7, T = 30) ----
    f32, b, T = torch.float32, 7, 30
    es = 4
    Bw, G, d, D0, O0 = k1_inputs(b, f32, T, 2)
    Dm, Om, rr = spd(b, f32)
    LDp, LMp = bt.btd_factor_plain(Dm, Om)
    K = torch.zeros((lanes, n_x, n_x), dtype=f32, device=dev)
    for t in range(T):
        K[:, t * b:(t + 1) * b, t * b:(t + 1) * b] = Dm[:, t]
    for t in range(T - 1):
        K[:, (t + 1) * b:(t + 2) * b, t * b:(t + 1) * b] = Om[:, t]
        K[:, t * b:(t + 1) * b, (t + 1) * b:(t + 2) * b] = Om[:, t].transpose(1, 2)
    Lk = torch.linalg.cholesky(K)
    rflat = rr.reshape(lanes, n_x, 1)
    bb = b * b
    timing = {
        "bb_quad": dict(
            ms=time_ms(lambda: br.bb_quad_group_cuda(Bw, G, d, D0, O0)),
            plain_ms=time_ms(lambda: br.bb_quad_group_plain(Bw, G, d, D0, O0)),
            # one batched einsum forms every window's B' diag(d) B (the
            # scatter-add into D and O aside)
            library_ms=time_ms(lambda: torch.einsum(
                "zgri,zgr,zgrj->zgij", Bw, d.reshape(lanes, T, 2), Bw)),
            library_call="torch.einsum zgri,zgr,zgrj->zgij (the window "
            "products, without the scatter into D, O)",
            bytes=es * (Bw.numel() + d.numel() + 2 * (D0.numel() + O0.numel()))
            + 4 * G.numel(),
            flops=lanes * T * 9 * bb * 2,
            shape="B (128, 30, 2, 14) upright group into D (128, 30, 7, 7)"),
        "btd_factor": dict(
            ms=time_ms(lambda: bt.btd_factor_cuda(Dm, Om)),
            plain_ms=time_ms(lambda: bt.btd_factor_plain(Dm, Om), reps=5),
            library_ms=time_ms(lambda: torch.linalg.cholesky(K)),
            bytes=es * 2 * (Dm.numel() + Om.numel()),
            flops=lanes * (T * bb * b // 3 + (T - 1) * 3 * bb * b),
            shape="D (128, 30, 7, 7), O (128, 29, 7, 7)"),
        "btd_solve": dict(
            ms=time_ms(lambda: bt.btd_solve_cuda(LDp, LMp, rr)),
            plain_ms=time_ms(lambda: bt.btd_solve_plain(LDp, LMp, rr), reps=5),
            library_ms=time_ms(lambda: torch.cholesky_solve(rflat, Lk)),
            bytes=es * (LDp.numel() + LMp.numel() + 2 * rr.numel()),
            flops=lanes * 2 * (T * bb + (T - 1) * 2 * bb),
            shape="LD (128, 30, 7, 7), LM (128, 29, 7, 7), r (128, 30, 7)"),
    }
    for name, tm in timing.items():
        t_bytes = tm["bytes"] / PEAK_BYTES * 1e3
        t_ops = tm["flops"] / PEAK_FLOPS["float32"] * 1e3
        tm["bound_ms"] = max(t_bytes, t_ops)
        tm["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        emit({"time": name, **tm, "card": smi})

    # ---- K1-K3 at b 8 (the 1/dt grid of a 7-DoF arm), and K2 / K3 at b 2
    # and 3 (spherebot and boxbot, and spherebot's 1/dt grid) and 9 (the
    # rail): 128 x 30 x b, the rules above, then their times ----
    def k123_at(b, seed):
        """K1-K3 at block size b against their plain versions, float64 and
        float32, then their float32 times (local names kept apart from
        the phase's)."""
        b8 = {"checks": {k: {} for k in checks}, "timing": {}}
        T8, nb8 = 30, 30
        rng8 = np.random.default_rng(seed)
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).split(".")[-1]
            W = torch.as_tensor(rng8.normal(size=(lanes, T8 - 1, 2 * b, 2 * b))
                                / np.sqrt(2 * b), device=dev)
            dW = torch.as_tensor(rng8.uniform(0.5, 2.0, (lanes, (T8 - 1) * 2 * b)),
                                 device=dev)
            Dm = 2.0 * torch.eye(b, dtype=torch.float64, device=dev).repeat(
                lanes, T8, 1, 1)
            Om = torch.zeros((lanes, T8 - 1, b, b), dtype=torch.float64,
                             device=dev)
            br.bb_quad_group_plain(W, torch.arange(T8 - 1, dtype=torch.int32,
                                                   device=dev), dW, Dm, Om)
            rr = torch.as_tensor(rng8.normal(size=(lanes, T8, b)),
                                 device=dev).to(dtype)
            Dm, Om = Dm.to(dtype), Om.to(dtype)
            errs8 = {}
            for ng, r in ((T8, 2), (1, b), (T8 - 1, 21)):
                Bw = torch.as_tensor(rng8.normal(size=(lanes, ng, r, 2 * b)),
                                     device=dev).to(dtype)
                G = torch.as_tensor(np.minimum(np.arange(ng), nb8 - 2).astype(
                    np.int32) if ng > 1 else np.asarray([nb8 - 2], np.int32),
                    device=dev)
                d = torch.as_tensor(rng8.uniform(0.1, 2.0, (lanes, ng * r)),
                                    device=dev).to(dtype)
                D0 = torch.as_tensor(rng8.normal(size=(lanes, nb8, b, b)),
                                     device=dev).to(dtype)
                O0 = torch.as_tensor(rng8.normal(size=(lanes, nb8 - 1, b, b)),
                                     device=dev).to(dtype)
                Dk, Ok, Dp, Op = D0.clone(), O0.clone(), D0.clone(), O0.clone()
                br.bb_quad_group_cuda(Bw, G, d, Dk, Ok)
                br.bb_quad_group_plain(Bw, G, d, Dp, Op)
                sync()
                errs8.setdefault("bb_quad", []).append(
                    max(rel_err(Dk, Dp), rel_err(Ok, Op), key=lambda e: e[1]))
                if (ng, r, dtype) == (T8, 2, torch.float32):
                    k1_args = (Bw, G, d, D0, O0)
            LDk, LMk = bt.btd_factor_cuda(Dm, Om)
            LDp, LMp = bt.btd_factor_plain(Dm, Om)
            xk = bt.btd_solve_cuda(LDp, LMp, rr)
            xp = bt.btd_solve_plain(LDp, LMp, rr)
            sync()
            errs8["btd_factor"] = [max(rel_err(LDk, LDp), rel_err(LMk, LMp),
                                       key=lambda e: e[1])]
            errs8["btd_solve"] = [rel_err(xk, xp)]
            for name, es_ in errs8.items():
                ea, er = max(e[0] for e in es_), max(e[1] for e in es_)
                ok = er < REL_TOL[dname]
                b8["checks"][name][dname] = {"max_abs_err": ea,
                                             "max_rel_err": er}
                emit({"check": name, "dtype": dname, "b": b, "T": T8,
                      "max_abs_err": ea, "max_rel_err": er,
                      "tol": REL_TOL[dname], "ok": ok})
                assert ok, f"{name} at b {b} disagrees with its plain version"
        # times (float32, the last system above)
        K8 = torch.zeros((lanes, T8 * b, T8 * b), dtype=f32, device=dev)
        for t in range(T8):
            K8[:, t * b:(t + 1) * b, t * b:(t + 1) * b] = Dm[:, t]
        for t in range(T8 - 1):
            K8[:, (t + 1) * b:(t + 2) * b, t * b:(t + 1) * b] = Om[:, t]
            K8[:, t * b:(t + 1) * b, (t + 1) * b:(t + 2) * b] = \
                Om[:, t].transpose(1, 2)
        L8 = torch.linalg.cholesky(K8)
        Bw, G, d, D0, O0 = k1_args
        bb = b * b
        b8["timing"] = {
            "bb_quad": dict(
                ms=time_ms(lambda: br.bb_quad_group_cuda(Bw, G, d, D0, O0)),
                plain_ms=time_ms(lambda: br.bb_quad_group_plain(Bw, G, d, D0,
                                                                O0)),
                library_ms=time_ms(lambda: torch.einsum(
                    "zgri,zgr,zgrj->zgij", Bw, d.reshape(lanes, T8, 2), Bw)),
                bytes=4 * (Bw.numel() + d.numel() + 2 * (D0.numel()
                                                        + O0.numel()))
                + 4 * G.numel(), flops=lanes * T8 * 9 * bb * 2,
                shape=f"B (128, 30, 2, {2 * b}) into D (128, 30, {b}, {b})"),
            "btd_factor": dict(
                ms=time_ms(lambda: bt.btd_factor_cuda(Dm, Om)),
                plain_ms=time_ms(lambda: bt.btd_factor_plain(Dm, Om), reps=5),
                library_ms=time_ms(lambda: torch.linalg.cholesky(K8)),
                bytes=4 * 2 * (Dm.numel() + Om.numel()),
                flops=lanes * (T8 * bb * b // 3 + (T8 - 1) * 3 * bb * b),
                shape=f"D (128, 30, {b}, {b}), O (128, 29, {b}, {b})"),
            "btd_solve": dict(
                ms=time_ms(lambda: bt.btd_solve_cuda(LDp, LMp, rr)),
                plain_ms=time_ms(lambda: bt.btd_solve_plain(LDp, LMp, rr),
                                 reps=5),
                library_ms=time_ms(lambda: torch.cholesky_solve(
                    rr.reshape(lanes, T8 * b, 1), L8)),
                bytes=4 * (LDp.numel() + LMp.numel() + 2 * rr.numel()),
                flops=lanes * 2 * (T8 * bb + (T8 - 1) * 2 * bb),
                shape=f"LD (128, 30, {b}, {b}), LM (128, 29, {b}, {b}), r "
                f"(128, 30, {b})")}
        for name, tm in b8["timing"].items():
            t_bytes = tm["bytes"] / PEAK_BYTES * 1e3
            t_ops = tm["flops"] / PEAK_FLOPS["float32"] * 1e3
            tm["bound_ms"] = max(t_bytes, t_ops)
            tm["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            emit({"time": f"{name}_b{b}", **tm, "card": smi})
        return b8

    b8 = k123_at(8, 8)
    k123_new = {b: k123_at(b, 100 + b) for b in (2, 3, 9)}

    # ---- K4 / K4v / K5 against their plain versions, then their times ----
    world_cache = {}

    def flagship_x(dtype, noise_seed):
        """The flagship's initial trajectories plus seeded numpy noise."""
        if dtype not in world_cache:
            world_cache[dtype] = make_glass_upright(lanes, 30, dtype=dtype,
                                                    device=dev)
        _, dat, _, wld = world_cache[dtype]
        noise = np.random.default_rng(noise_seed).normal(
            0.0, 0.02, tuple(dat.x0.shape))
        return (dat.x0 + torch.as_tensor(noise, device=dev).to(dtype)
                ).contiguous(), wld

    def ulp_spread(xg, value_fn):
        """xg (n, 2, nd): the two steps of the gaps of n rows.  The spread
        (max - min) of each row's plain value over its gap moved by up to
        ULP_MOVE ulps per entry (ULP_DRAWS seeded draws, the unmoved gap
        first); value_fn maps (n, draws, 2, nd) to (n, draws)."""
        u = torch.as_tensor(np.random.default_rng(3).integers(
            -ULP_MOVE, ULP_MOVE + 1, (xg.shape[0], ULP_DRAWS) + xg.shape[1:]),
            device=dev).to(xg.dtype)
        u[:, 0] = 0
        v = value_fn(xg[:, None] * (1 + u * torch.finfo(xg.dtype).eps))
        return v.amax(1) - v.amin(1)

    def value_rows(name, dname, err, rows_x, value_fn, dscale, tol_d,
                   tied=None):
        """The value check on every row: ``err`` is the kernel's error
        relative to the largest |D|; rows over tol_d are probed by
        ulp_spread (float32).  ``tied`` (float64): the rows whose witness
        a tied decision picks (``cast_ties``); a Frank-Wolfe route's value
        is a lower bound that another polish path moves, so those rows are
        held to D_ALL_TOL and the others to tol_d."""
        over = err > tol_d
        n_over = int(over.sum())
        rec = {"D_rel_err_all_rows": float(err.max()),
               "D_abs_err_all_rows": float(err.max()) * dscale,
               "D_rows_over_tol": n_over, "rows": err.numel()}
        ok = float(err.max()) < tol_d
        if tied is not None and dname == "float64":
            rec.update(D_rel_err_untied_rows=max0(err[~tied]),
                       D_tied_rows_over_tol=int((over & tied).sum()),
                       tie_rows=int(tied.sum()))
            ok = rec["D_rel_err_untied_rows"] < tol_d \
                and float(err.max()) < D_ALL_TOL
            if n_over:
                idx = torch.nonzero(over)
                rec["worst_row"] = idx[int(err[over].argmax())].tolist()
                # how far the plain value of an untied row over tol_d
                # moves under a few ulps of x (a tie the rules missed)
                bad = torch.nonzero(over & ~tied)
                if len(bad):
                    spread = ulp_spread(rows_x(bad),
                                        lambda xp: value_fn(bad, xp))
                    rec.update(D_untied_rows_over_tol_plain_spread_min=float(
                        (spread / dscale).min()))
        if dname == "float32":
            ok = float(err.max()) < D_ALL_TOL and \
                n_over <= D_OVER_SHARE * err.numel()
            if n_over:
                idx = torch.nonzero(over)
                spread = ulp_spread(rows_x(idx), lambda xp: value_fn(idx, xp))
                moved = spread > tol_d * dscale
                rec.update(D_rows_over_tol_plain_moves=int(moved.sum()),
                           plain_ulp_spread_min=float(spread.min()),
                           worst_row=idx[int(err[over].argmax())].tolist())
                ok = ok and bool(moved.all())
            rec["tol"] = [tol_d, D_ALL_TOL, D_OVER_SHARE]
        else:
            rec["tol"] = tol_d
        emit({"check": name, "dtype": dname, **rec, "ok": ok})
        assert ok, f"{name} values disagree with the plain version"
        return rec

    coll_err = {"cast_seg": [], "cast_seg_value": [], "cast_sweep": []}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        tol_d, tol_j = COLL_TOL[dname]
        x, world = flagship_x(dtype, 1)
        X = x.reshape(lanes, 30, D)
        P = world.n_pairs

        def gap_x(idx):
            return torch.stack([X[idx[:, 0], idx[:, 1]],
                                X[idx[:, 0], idx[:, 1] + 1]], 1)

        for n_sub in (2, 3):
            pre = CastDistancePre(world, 30, n_sub=n_sub)
            pre1 = CastDistancePre(world, 2, n_sub=n_sub)
            Dk, (Jak, Jbk) = pre.value_jac(x)
            Dv = pre.value(x)
            sync()
            Dp, (Jap, Jbp) = pre.value_jac(x, kernels=False)

            def seg_values(idx, xp):
                n, draws = xp.shape[:2]
                Dx = pre1.value(xp.reshape(n * draws, 2 * D),
                                kernels=False).reshape(n, draws, -1, P)
                return Dx[torch.arange(n, device=dev)[:, None],
                          torch.arange(draws, device=dev)[None],
                          idx[:, 2:3], idx[:, 3:4]]

            dscale = float(Dp.abs().max())
            recs = {}
            for name, Dout in (("cast_seg", Dk), ("cast_seg_value", Dv)):
                recs[name] = value_rows(
                    name, dname, (Dout - Dp).abs() / dscale, gap_x,
                    seg_values, dscale, tol_d)
                recs[name]["n_sub"] = n_sub
            # Jacobians: rows without a tied decision
            tie = world.cast_ties(X[:, :-1], X[:, 1:], n_sub, *TIE_RULE[dname])
            keep = ~tie.reshape(lanes, 29, -1)
            jscale = max(float(Jap.abs().max()), float(Jbp.abs().max()))
            rowj = torch.maximum((Jak - Jap).abs().amax(-1),
                                 (Jbk - Jbp).abs().amax(-1)) / jscale
            capbox = torch.as_tensor(
                [r == "sphere" and 2 in (world.geoms[i].kind,
                                         world.geoms[j].kind)
                 for (i, j), (r, _) in zip(world.pairs,
                                           world.pair_routes())],
                device=dev).repeat(n_sub - 1)
            ej = float((rowj * (keep & ~capbox)).max())
            ej_capbox = float((rowj * (keep & capbox)).max())
            ej_all = float(rowj.max())
            ok = ej < tol_j and ej_capbox < CAPBOX_JTOL[dname]
            if dtype == torch.float64:  # float64: every row, ties included
                ok = ok and ej_all < tol_j
            recs["cast_seg"].update(
                J_rel_err_untied_rows=ej, J_rel_err_all_rows=ej_all,
                J_tie_rows_excluded=int(tie.sum()))
            emit({"check": "cast_seg_jacobian", "dtype": dname,
                  "n_sub": n_sub, "J_rel_err_untied_rows": ej,
                  "J_rel_err_all_rows": ej_all,
                  "J_rel_err_sphere_box_untied_rows": ej_capbox,
                  "sphere_box_rows": int((capbox.expand_as(keep)).sum()),
                  # rows beyond tol_j: tied ones (excluded above) and
                  # sphere-box rows (held to CAPBOX_JTOL)
                  "J_rows_over_tol": int((rowj > tol_j).sum()),
                  "rows": keep.numel(), "tie_rows_excluded": int(tie.sum()),
                  "tol": [tol_j, CAPBOX_JTOL[dname]], "ok": ok})
            assert ok, "cast_seg's Jacobian disagrees with the plain version"
            for name in recs:
                coll_err[name].append(dict(recs[name], dtype=dname))
        Ds = cast_sweep_distances(world, X, 16)
        sync()
        Dsp = cast_sweep_distances(world, X, 16, kernels=False)

        def sweep_values(idx, xp):
            d = world.cast_pair_distances(xp[:, :, 0], xp[:, :, 1], 16)
            return torch.gather(d, 2, idx[:, 2:3, None].expand(
                -1, d.shape[1], 1))[..., 0]

        rec = value_rows("cast_sweep", dname,
                         (Ds - Dsp).abs() / float(Dsp.abs().max()), gap_x,
                         sweep_values, float(Dsp.abs().max()), tol_d)
        coll_err["cast_sweep"].append(dict(rec, dtype=dname, n_sub=16))

    xf, world = flagship_x(f32, 2)
    Xf = xf.reshape(lanes, 30, D)
    pre2 = CastDistancePre(world, 30, n_sub=2)
    D2 = pre2.value(xf, kernels=False)
    work = cast_work(world, D2, lanes, 29, 2, es, D)
    work16 = cast_work(world, cast_sweep_distances(world, Xf, 16, False),
                       lanes, 29, 16, es, D)
    for name, fn, plain, w in (
            ("cast_seg", lambda: pre2.value_jac(xf),
             lambda: pre2.value_jac(xf, kernels=False), work["jac"]),
            ("cast_seg_value", lambda: pre2.value(xf),
             lambda: pre2.value(xf, kernels=False), work["value"]),
            ("cast_sweep", lambda: cast_sweep_distances(world, Xf, 16),
             lambda: cast_sweep_distances(world, Xf, 16, False),
             work16["sweep"])):
        timing[name] = dict(ms=time_ms(fn), plain_ms=time_ms(plain, reps=3),
                            library_ms=None, bytes=w[0], flops=w[1],
                            shape="x (128, 210) -> D (128, 29, 28)"
                            + (", Ja/Jb (128, 29, 28, 7)"
                               if name == "cast_seg" else ""))
        t_bytes = w[0] / PEAK_BYTES * 1e3
        t_ops = w[1] / PEAK_FLOPS["float32"] * 1e3
        timing[name]["bound_ms"] = max(t_bytes, t_ops)
        timing[name]["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        emit({"time": name, **timing[name], "card": smi})

    # ---- 2c: the CONVEX routes alone, on the transfer world's sets ----
    pnp_T = 12
    _, _, pscene = make_pick_and_place(lanes, pnp_T, f32, device=dev)
    world_att = pscene["world_att"]
    # the transfer's straight-line init from each lane's grasp
    XB0 = chain_transfer(pscene, pscene["grasps"])[1].x0.reshape(
        lanes, pnp_T, D)
    route_err = {"convex_feature": [], "convex_fw": []}
    route_time = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        tol_d = COLL_TOL[dname][0]
        Xd = XB0.to(dtype)
        for (n1, n2), (V1, r1, V2, r2) in world_att.convex_route_sets(
                Xd[:, :-1], Xd[:, 1:], 2).items():
            fw = max(n1, n2) > geom.GENERIC_FEATURE_MAX_VERTS
            name = "convex_fw" if fw else "convex_feature"
            plain = geom.d_convex_convex if fw else geom.make_feature_distance(
                n1, n2, geom.generic_topology)
            ties = geom.convex_convex_ties if fw else geom.feature_ties(
                n1, n2, topology=geom.generic_topology)
            dk = convex_route(world_att, V1, r1, V2, r2, fw)
            sync()
            dp = plain(V1, r1, V2, r2)
            dscale = float(dp.abs().max())
            err = (dk - dp).abs() / dscale
            tie = ties(V1, V2, *TIE_RULE[dname])
            over = (err > tol_d) & ~tie
            rec = {"check": f"{name}_route", "dtype": dname, "n1": n1,
                   "n2": n2, "rows": err.numel(), "tie_rows": int(tie.sum()),
                   "D_rel_err_untied_rows": max0(err[~tie]),
                   "D_rel_err_all_rows": float(err.max()),
                   "D_abs_err_all_rows": float(err.max()) * dscale,
                   "D_untied_rows_over_tol": int(over.sum())}
            ok = float(err.max()) < D_ALL_TOL
            if dname == "float32":
                ok = ok and int(over.sum()) <= D_OVER_SHARE * err.numel()
                if int(over.sum()):
                    # such a row's plain value must move by more than the
                    # tolerance under a few ulps of change of its vertices
                    idx = torch.nonzero(over)[:, 0]
                    spread = ulp_spread(
                        torch.cat([V1[idx], V2[idx]], 1),
                        lambda vp: plain(vp[:, :, :n1], r1[idx, None],
                                         vp[:, :, n1:], r2[idx, None]))
                    moved = spread > tol_d * dscale
                    rec["D_untied_rows_over_tol_plain_moves"] = int(moved.sum())
                    ok = ok and bool(moved.all())
            else:
                ok = ok and rec["D_rel_err_untied_rows"] < tol_d
            rec.update(tol=[tol_d, D_ALL_TOL], ok=ok)
            emit(rec)
            assert ok, f"{name} disagrees with its plain version"
            route_err[name].append(rec)
            if dname != "float32":
                continue
            # time and bound at the main path's shapes (one K4 launch's
            # sets at n_sub 2); the generic route's depth cover counted on
            # the rows that penetrate
            n_pen = int((dp <= -(r1 + r2) + 1e-6).sum()) if not fw else 0
            t = route_time.setdefault(name, {"ms": 0.0, "plain_ms": 0.0,
                                             "bytes": 0, "flops": 0,
                                             "shapes": []})
            t["ms"] += time_ms(lambda: convex_route(world_att, V1, r1, V2,
                                                    r2, fw))
            t["plain_ms"] += time_ms(lambda: plain(V1, r1, V2, r2), reps=3)
            t["bytes"] += es * (V1.numel() + V2.numel() + 3 * V1.shape[0])
            t["flops"] += V1.shape[0] * convex_flops(n1, n2) \
                + n_pen * COVER_V * (n1 + n2)
            t["shapes"].append([V1.shape[0], n1, n2])
    for name, t in route_time.items():
        t_bytes = t["bytes"] / PEAK_BYTES * 1e3
        t_ops = t["flops"] / PEAK_FLOPS["float32"] * 1e3
        t.update(bound_ms=max(t_bytes, t_ops), library_ms=None,
                 bound_by="bytes" if t_bytes >= t_ops else "operations")
        timing[name] = t
        emit({"time": name, **t, "card": smi})

    # ---- 2d: K6 ipm_banded against the plain loop, on QPs of real solves
    params = bench_params()

    def capture(fn, keep):
        """Run fn() recording the SQP's batched QP solves number ``keep``:
        {index: (QP data, settings)}."""
        got, seen = {}, [0]
        orig = sqp_mod.solve_ipm_qp

        def rec(qd, st, **kw):
            if seen[0] in keep:
                got[seen[0]] = (qd, st)
            seen[0] += 1
            return orig(qd, st, **kw)
        sqp_mod.solve_ipm_qp = rec
        try:
            fn()
        finally:
            sqp_mod.solve_ipm_qp = orig
        return got

    spec_f, data_f, _, world_f = make_glass_upright(batch=lanes, n_steps=30,
                                                    dtype=torch.float32,
                                                    device=dev)
    got = capture(lambda: solve_batch_compact(
        spec_f, data_f, params, phase_qp_solves=8, device=dev), {0, 1})
    qps = {"flagship_qp1": got[0], "flagship_qp2": got[1]}
    specA2, dataA2, sc2 = make_pick_and_place(lanes, pnp_T, torch.float32,
                                              device=dev)
    rA2 = solve_batch_compact(specA2, dataA2, params, phase_qp_solves=8,
                              device=dev)
    specB2, dataB2 = chain_transfer(
        sc2, rA2.x.reshape(lanes, pnp_T, D)[:, -1].cpu().numpy())
    qps["transfer_qp1"] = capture(lambda: solve_batch_compact(
        specB2, dataB2, params, phase_qp_solves=8, device=dev), {0})[0]
    # the 9-DoF rail's first QP: K6 at b 9
    spec_r, data_r, _, world_r = make_redundant_rail(lanes, dtype=f32,
                                                     device=dev)
    qps["rail_qp1"] = capture(lambda: solve_batch(
        spec_r, data_r, dataclasses.replace(params, max_total_qp_solves=1),
        device=dev), {0})[0]
    # phase 7's problems (one document per lane through load_problem), and
    # 7b's first QP: K6 at b 8, the 1/dt grid
    json_probs = {kind: port_json_problem(json_docs(kind, lanes), f32, dev)
                  for kind in JSON_KINDS}
    spec_t, data_t, par_t = json_probs["table_time"][:3]
    qps["json_table_time_qp1"] = capture(lambda: solve_batch(
        spec_t, data_t, dataclasses.replace(par_t, max_total_qp_solves=1),
        device=dev), {0})[0]
    # phase 8's problems, 8b's first QP (K6 at b 2: boxbot, 60 columns, the
    # 1,363 swept hinge rows) and time_parameterized's form at 128 lanes
    # (b 3: spherebot's 1/dt grid)
    box_probs = {kind: port_box_problem(box_docs(kind, lanes), f32, dev)
                 for kind in BOX_KINDS}
    spec_bx, data_bx, par_bx = box_probs["box_cast_t30"][:3]
    qps["box_cast_t30_qp1"] = capture(lambda: solve_batch(
        spec_bx, data_bx, dataclasses.replace(par_bx, max_total_qp_solves=1),
        device=dev), {0})[0]
    spec_tp, data_tp, par_tp = port_json_problem(
        time_parameterized_docs(lanes), f32, dev, "spherebot")[:3]
    qps["time_parameterized_qp1"] = capture(lambda: solve_batch(
        spec_tp, data_tp, dataclasses.replace(par_tp, max_total_qp_solves=1),
        device=dev), {0})[0]
    # every other new block size on the IPM fixture (float64), with the
    # SQP's QP settings
    for b_new in K6_NEW_BLOCKS:
        if b_new not in (2, 3) + tuple(2 * c for c in K6_BOX_REGROUP):
            qps[f"fixture_b{b_new}"] = (
                ipm_fixture(lanes, b_new, 10, 200 + b_new, dev),
                dataclasses.replace(params.qp, kkt_block=b_new))

    def regrouped(qd, qset, c):
        """The QP with its windows regrouped to superblocks of c steps (K6
        at block size c b)."""
        b = qset.kkt_block
        nsb = qd.q.shape[1] // (b * c)

        def rg(Bs, Gs):
            out = [br.regroup(B, G, b, c, nsb) for B, G in zip(Bs, Gs)]
            return tuple(B for B, _ in out), tuple(G for _, G in out)
        Bh, Gh = rg(qd.Bh, qd.Gh)
        Ba, Ga = rg(qd.Ba, qd.Ga)
        return (qd._replace(Bh=Bh, Gh=Gh, Ba=Ba, Ga=Ga),
                dataclasses.replace(qset, kkt_block=b * c))
    for c in (2, 3):
        qps[f"flagship_qp1_b{7 * c}"] = regrouped(*qps["flagship_qp1"], c)
    for c in K6_BOX_REGROUP:
        qps[f"box_cast_t30_qp1_b{2 * c}"] = regrouped(
            *qps["box_cast_t30_qp1"], c)

    def qp_as(qd, dtype):
        dense = {k: getattr(qd, k).to(dtype) for k in ("A_h", "A_a")
                 if getattr(qd, k) is not None}
        return qd._replace(
            **{k: getattr(qd, k).to(dtype)
               for k in ("P", "q", "e_h", "w_h", "e_a", "w_a", "lb", "ub")},
            Bh=tuple(B.to(dtype) for B in qd.Bh),
            Ba=tuple(B.to(dtype) for B in qd.Ba), **dense)

    def ipm_vs_plain(check, qname, qd0, qset, dtype, **extra):
        """The kernel (K6 on banded rows, K11 on dense rows) against the
        plain loop on one captured QP in ``dtype``, per lane, with phase
        2d's rules; the record (with ``extra``), its "ok" set."""
        dname = str(dtype).split(".")[-1]
        b_k = qset.kkt_block
        qd = qp_as(qd0, dtype)
        rk = ipm_qp.solve_ipm_qp(qd, qset, device=dev, kernels=True)
        rpl = ipm_qp.solve_ipm_qp(qd, qset, device=dev, kernels=False)
        sync()
        same_it = rk.iters == rpl.iters
        same_st = rk.status == rpl.status
        dx_abs = (rk.x - rpl.x).abs().amax(-1)
        dx_rel = dx_abs / rpl.x.abs().amax(-1).clamp(min=1e-30)
        # runs that end apart: the run that stopped first converged
        # with its ratio at the threshold (iterations apart), or, at
        # equal iterations, one converged just under 1 and the other
        # ended just over it
        band = K6_RATIO_BAND[dname]
        rk_r = torch.maximum(rk.prim_res, rk.dual_res)
        rp_r = torch.maximum(rpl.prim_res, rpl.dual_res)
        k_first = rk.iters < rpl.iters
        first_r = torch.where(k_first, rk_r, rp_r)
        first_st = torch.where(k_first, rk.status, rpl.status)
        under = (first_st == 1) & (first_r >= 1 - band) & (first_r <= 1)
        conv_r = torch.where(rk.status == 1, rk_r, rp_r)
        other_r = torch.where(rk.status == 1, rp_r, rk_r)
        tie_eq = ((rk.status == 1) | (rpl.status == 1)) \
            & (conv_r >= 1 - band) & (other_r > 1) \
            & (other_r <= 1 + band)
        apart = ~(same_it & same_st)
        threshold = torch.where(same_it, tie_eq, under)
        # or one run stopped early on the NaN guard (a non-finite
        # Newton step; the incumbent is returned)
        first_it = torch.minimum(rk.iters, rpl.iters)
        guard = ~same_it & (first_it < qset.max_ipm_iter) \
            & (first_st != 1)
        usable_k = (rk.status == 1) | (rk.status == 2)
        usable_p = (rpl.status == 1) | (rpl.status == 2)
        # the composite objective at each answer, and the IPM's own gap
        # tolerance there
        fk = ipm_qp.composite_objective(qd, rk.x, b_k)
        fp = ipm_qp.composite_objective(qd, rpl.x, b_k)
        f0 = ipm_qp.composite_objective(qd, torch.zeros_like(qd.q), b_k)
        eps_g = qset.eps_abs * (torch.maximum(fp.abs(), f0.abs()) + 1)
        f_gap = ((fk - fp).abs() / eps_g)
        eq = same_it & same_st
        ah = (qd.A_h @ rpl.x[..., None])[..., 0] if qd.A_h is not None \
            else br.bb_mv(qd.Bh, qd.Gh, rpl.x, b_k)
        active = (qd.e_h + ah > 0).sum(-1)
        violated0 = (qd.e_h > 0).sum(-1)
        rec = {"check": check, "qp": qname, "dtype": dname,
               "lanes": lanes, "b": b_k, "n": qd.q.shape[1],
               "m_h": qd.e_h.shape[1], "m_a": qd.e_a.shape[1],
               "active_hinge_rows_per_lane_mean":
               float(active.double().mean()),
               "lanes_with_active_hinge_rows": int((active > 0).sum()),
               "hinge_rows_violated_at_dx0_per_lane_mean":
               float(violated0.double().mean()),
               "status_plain": torch.bincount(rpl.status,
                                              minlength=4).tolist(),
               "iters_plain_mean": float(rpl.iters.double().mean()),
               "iters_plain_max": int(rpl.iters.max()),
               "lanes_same_status": int(same_st.sum()),
               "lanes_same_iters": int(same_it.sum()),
               "dx_rel_err_equal_lanes": max0(dx_rel[eq]),
               "dx_abs_err_equal_lanes": max0(dx_abs[eq]),
               "dx_rel_err_all_lanes": float(dx_rel.max()),
               "lanes_apart": int(apart.sum()),
               "apart_lanes": torch.nonzero(apart)[:, 0].tolist(),
               "apart_ratio_kernel": rk_r[apart].tolist(),
               "apart_ratio_plain": rp_r[apart].tolist(),
               "apart_iters": [rk.iters[apart].tolist(),
                               rpl.iters[apart].tolist()],
               "apart_threshold_cases": int((apart & threshold).sum()),
               "apart_nan_guard_cases": int((apart & guard).sum()),
               "lanes_same_usable": int((usable_k == usable_p).sum()),
               "objective_gap_over_eps_g_max": float(f_gap.max()),
               "ratio_band": band, **extra}
        if dname == "float64":
            ok = bool(same_st.all()) and rec["dx_rel_err_equal_lanes"] \
                <= K6_DX_TOL and bool((threshold | ~apart).all())
            rec["tol"] = K6_DX_TOL
        else:
            dx_held = qname not in K6_F32_DX_REPORTED
            if not dx_held:
                # both float32 answers against the float64 plain loop's
                r64 = ipm_qp.solve_ipm_qp(qp_as(qd0, torch.float64), qset,
                                          device=dev, kernels=False)
                scale = r64.x.abs().amax(-1).clamp(min=1e-30)
                rec["dx_rel_to_f64_plain"] = {
                    "kernel": float(((rk.x.double() - r64.x).abs().amax(
                        -1) / scale).max()),
                    "plain": float(((rpl.x.double() - r64.x).abs().amax(
                        -1) / scale).max())}
            ok = bool((f_gap <= K6_F32_GAP_TOL).all()) \
                and bool((usable_k == usable_p).all()) \
                and (rec["dx_rel_err_equal_lanes"] <= K6_F32_DX_TOL
                     or not dx_held)
            rec["tol"] = {"objective_over_eps_g": K6_F32_GAP_TOL,
                          "dx_rel_equal_lanes": K6_F32_DX_TOL
                          if dx_held else "reported",
                          "usable_alike": True}
        rec["ok"] = ok
        emit(rec)
        return rec

    k6_recs = []
    for qname, (qd0, qset) in qps.items():
        for dtype in (torch.float64,) if qname.startswith("fixture_") \
                else (torch.float32, torch.float64):
            # the launcher's shared-memory plan for the QP (the factor's
            # block inverses D, M then W in O, V, the solves' scratch w)
            n_q, b_q = qd0.q.shape[1], qset.kkt_block
            smem_plan = ipm_qp.k6_smem_plan(
                n_q, b_q, n_q // b_q, qd0.e_h.shape[1], qd0.e_a.shape[1],
                torch.finfo(dtype).bits // 8)
            rec = ipm_vs_plain("ipm_banded", qname, qd0, qset, dtype,
                               smem_plan=smem_plan)
            k6_recs.append(rec)
            assert rec["ok"], "K6 ipm_banded disagrees with the plain " \
                f"loop ({qname}, {rec['dtype']})"
    # K6's time at the main path's shape (float32, the flagship's first QP)
    qd, qset = qps["flagship_qp1"]
    su = ipm_qp._setup(qd, qset)
    plan = ipm_qp.band_plan(qd, qset.kkt_block)
    it_k = ipm_qp.ipm_banded_cuda(su, plan).it
    k6_bytes, k6_flops = k6_work(qd, qset.kkt_block, it_k, es)
    t_bytes = k6_bytes / PEAK_BYTES * 1e3
    t_ops = k6_flops / PEAK_FLOPS["float32"] * 1e3
    timing["ipm_banded"] = dict(
        ms=time_ms(lambda: ipm_qp.ipm_banded_cuda(su, plan), reps=10),
        plain_ms=time_ms(lambda: ipm_qp._loop_plain(su), reps=1),
        call_ms=time_ms(lambda: ipm_qp.solve_ipm_qp(qd, qset, device=dev),
                        reps=10),
        library_ms=None, bytes=k6_bytes, flops=k6_flops,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        iters_mean=float(it_k.double().mean()), iters_max=int(it_k.max()),
        shape=f"one batched QP: 128 lanes, n {qd.q.shape[1]}, b "
        f"{qset.kkt_block}, m_h {qd.e_h.shape[1]}, m_a {qd.e_a.shape[1]}")
    emit({"time": "ipm_banded", **timing["ipm_banded"], "card": smi})
    # and at b 9 (the rail's first QP), b 8 (7b's first QP), b 2 (8b's
    # first QP) and b 3 (time_parameterized's form)
    for qname, b_t in (("rail_qp1", 9), ("json_table_time_qp1", 8),
                       ("box_cast_t30_qp1", 2), ("time_parameterized_qp1", 3)):
        qd, qset = qps[qname]
        assert qset.kkt_block == b_t, qset
        su = ipm_qp._setup(qd, qset)
        plan = ipm_qp.band_plan(qd, qset.kkt_block)
        it_k = ipm_qp.ipm_banded_cuda(su, plan).it
        k6_bytes, k6_flops = k6_work(qd, qset.kkt_block, it_k, es)
        t_bytes = k6_bytes / PEAK_BYTES * 1e3
        t_ops = k6_flops / PEAK_FLOPS["float32"] * 1e3
        timing[f"ipm_banded_b{b_t}"] = dict(
            ms=time_ms(lambda: ipm_qp.ipm_banded_cuda(su, plan), reps=10),
            plain_ms=time_ms(lambda: ipm_qp._loop_plain(su), reps=1),
            library_ms=None, bytes=k6_bytes, flops=k6_flops,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            iters_mean=float(it_k.double().mean()), iters_max=int(it_k.max()),
            qp=qname, shape=f"one batched QP: 128 lanes, n {qd.q.shape[1]}, "
            f"b {b_t}, m_h {qd.e_h.shape[1]}, m_a {qd.e_a.shape[1]}")
        emit({"time": f"ipm_banded_b{b_t}", **timing[f"ipm_banded_b{b_t}"],
              "card": smi})

    # ---- 2h: K11 ipm_dense against the plain loop, on the first QPs of
    # the dense-row paths: 6a and 6b (its block route at b 7), 7c(i) (b 8),
    # 7c(ii) and simple_collision (its dense route)
    from trajopt_tpu_torch.solver.types import SQPParams

    def first_qp(spec, data, par):
        return capture(lambda: solve_batch(spec, data, dataclasses.replace(
            par, max_total_qp_solves=1), device=dev), {0})[0]
    cart_inp = cartesian_inputs(lanes, 30)
    dense_qps = {}
    for kind in ("waypoints", "ik_goal"):
        dense_qps[f"cartesian_{kind}_qp1"] = first_qp(*port_cartesian_problem(
            kind, cart_inp, f32, dev)[:2], SQPParams())
    for kind in ("timed_vel", "timed_vel_total"):
        dense_qps[f"json_{kind}_qp1"] = first_qp(*json_probs[kind][:3])
    dense_qps["simple_collision_qp1"] = first_qp(
        *make_simple_collision(lanes, f32, device=dev)[:2], params)
    k11_recs = []
    for qname, (qd0, qset) in dense_qps.items():
        su = ipm_qp._setup(qd0, qset)
        route = f"block, b {su.bsz}" if su.nb else "dense"
        # the block route's band in the base region: D (the factor's block
        # inverses), O (M, then W), V, the solves' scratch w (bytes per
        # lane, float32 / float64); the plan is printed with the times
        bb_, nb_ = su.bsz * su.bsz, su.nb
        band = {k: {d: v * es_ for d, es_ in (("float32", 4),
                                              ("float64", 8))}
                for k, v in (("D", nb_ * bb_), ("O", (nb_ - 1) * bb_),
                             ("V", (nb_ - 1) * bb_), ("w", nb_ * su.bsz))
                } if nb_ else None
        emit({"phase": "dense_qp", "qp": qname, "lanes": lanes,
              "n": qd0.q.shape[1], "kkt_block": qset.kkt_block,
              "route": route, "m_h": qd0.e_h.shape[1],
              "m_a": qd0.e_a.shape[1], "max_ipm_iter": qset.max_ipm_iter,
              "band_bytes_per_lane": band})
        for dtype in (torch.float32, torch.float64):
            rec = ipm_vs_plain("ipm_dense", qname, qd0, qset, dtype,
                               route=route)
            k11_recs.append(rec)
            assert rec["ok"], "K11 ipm_dense disagrees with the plain " \
                f"loop ({qname}, {rec['dtype']})"
    # K11's times on each captured QP (float32): the bare launch on the
    # device clock, the wrapper's CUDA events, the plain loop, the bound;
    # the lists' nonzeros and sizes and where the plan put each region
    k11_attrs = ipm_qp.dense_kernel_attributes()
    for qname, (qd, qset) in dense_qps.items():
        su = ipm_qp._setup(qd, qset)
        args, keep = ipm_qp._k11_args(su)
        run = _native.library(_native.k11_library(
            False, args.b, bool(args.lists))).ipm_dense_run
        stream = torch.cuda.current_stream(dev).cuda_stream
        it_k = ipm_qp.ipm_dense_cuda(su).it
        k11_bytes, k11_flops = k11_work(qd, su, it_k, es)
        t_bytes = k11_bytes / PEAK_BYTES * 1e3
        t_ops = k11_flops / PEAK_FLOPS["float32"] * 1e3
        dev_ms, queue = device_ms(lambda: run(ctypes.byref(args), stream),
                                  reps=5)
        nzc = k11_nonzero_counts(qd, su)
        caps = tuple(getattr(args, f"nz_{k}") for k in (
            "h", "a", "rh", "ra", "p", "pr"))
        region_bytes = {k: v * es for k, v in ipm_qp.k11_region_sizes(
            su.n, su.bsz if su.nb else 0, su.nb, su.mh, su.ma, caps,
            es).items()}
        timing[f"ipm_dense_{qname}"] = dict(
            ms=dev_ms, queue=queue,
            wrapper_ms=time_ms(lambda: ipm_qp.ipm_dense_cuda(su), reps=5),
            plain_ms=time_ms(lambda: ipm_qp._loop_plain(su), reps=1),
            library_ms=None, bytes=k11_bytes, flops=k11_flops,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            iters_mean=float(it_k.double().mean()), iters_max=int(it_k.max()),
            route=f"block, b {su.bsz}" if su.nb else "dense",
            nonzeros_per_lane={k: {"mean": float(v.mean()),
                                   "max": int(v.max())}
                               for k, v in nzc.items()},
            rows_per_lane={"h": su.mh, "a": su.ma}, list_capacities=caps,
            region_bytes_per_lane=region_bytes,
            regions={k: "shared" if getattr(args, f"smem_{k}") else
                     "device scratch" for k in ipm_qp.K11_REGIONS},
            sums="over the lists" if args.lists else "dense order "
            f"(n < {ipm_qp.K11_LISTS_MIN_N})",
            shape=f"one batched QP: {lanes} lanes, n {qd.q.shape[1]}, "
            f"m_h {qd.e_h.shape[1]}, m_a {qd.e_a.shape[1]}")
        del keep
        emit({"time": f"ipm_dense_{qname}", **timing[f"ipm_dense_{qname}"],
              "card": smi})
    emit({"phase": "ipm_dense_attributes", "attributes": k11_attrs,
          "local_bytes_limit": K11_LOCAL_BYTES, "card": smi})
    assert all(k11_attrs[k]["local_bytes"] <= v
               for k, v in K11_LOCAL_BYTES.items()), k11_attrs

    # ---- 2e: K7 / K7v, K4 / K4v at n_sub 8 and K4 at n_dof 9 against
    # their plain versions, then their times ----
    def jac_rows(name, dname, rowj, capbox, jac_fn, rows_x, tol_j, ties):
        """The Jacobian check: rowj (rows) each row's largest error relative
        to the largest |J|; rows tied by ``ties`` excluded and counted;
        sphere-box rows (``capbox``) held to CAPBOX_JTOL; float64: every
        row to tol_j too; float32: a row over its tolerance must be one
        whose plain Jacobian moves by more than it under ULP_MOVE ulps of x
        (``jac_fn`` maps (n, draws, *x) to (n, draws, cols)), at most
        D_OVER_SHARE of the rows."""
        keep = ~ties
        lim = torch.where(capbox, torch.full_like(rowj, CAPBOX_JTOL[dname]),
                          torch.full_like(rowj, tol_j))
        over = keep & (rowj > lim)
        rec = {"check": name, "dtype": dname,
               "J_rel_err_untied_rows": max0((rowj * ~capbox)[keep]),
               "J_rel_err_sphere_box_untied_rows": max0((rowj * capbox)[keep]),
               "J_rel_err_all_rows": float(rowj.max()),
               "rows": rowj.numel(), "tie_rows_excluded": int(ties.sum()),
               "J_untied_rows_over_tol": int(over.sum()),
               "tol": [tol_j, CAPBOX_JTOL[dname]]}
        ok = not bool(over.any())
        if dname == "float64":
            ok = ok and rec["J_rel_err_all_rows"] < tol_j
        elif bool(over.any()):
            idx = torch.nonzero(over)
            spread = ulp_spread(rows_x(idx),
                                lambda xp: jac_fn(idx, xp)).amax(-1)
            moved = spread > lim[over] * jac_scale[0]
            rec.update(J_rows_over_tol_plain_moves=int(moved.sum()),
                       worst_row=idx[int(rowj[over].argmax())].tolist())
            ok = bool(moved.all()) and int(over.sum()) \
                <= D_OVER_SHARE * rowj.numel()
        rec["ok"] = ok
        emit(rec)
        assert ok, f"{name} disagrees with the plain version"
        return rec

    jac_scale = [1.0]  # the largest |J| of the plain version, per check

    def disc_work(world, lanes_, span, es_, nc):
        """(bytes, flops) of K7 ("jac") and K7v ("value") on these inputs:
        x read once, D (and J) written once; per (lane, step) the chain,
        the joint frames and world records, and per pair its closed form
        (with n_dof tangent columns for K7), counted as cast_work counts
        K4's phase A and B."""
        L, NG, P = world.chain.n_links, len(world.geoms), world.n_pairs
        nd = world.chain.n_dof
        fk = L * FK_LINK + nd * FK_DOF + NG * FK_GEOM
        jac = val = 0.0
        for i, j in world.pairs:
            disc = DISCRETE[(world.geoms[i].kind, world.geoms[j].kind)]
            jac += disc * (1 + 1.5 * nd) + 4 * nd * 11
            val += disc
        blocks = lanes_ * span
        tables = sum(t.numel() * t.element_size()
                     for t in world.kernel_tables(torch.float32, dev))
        x_b = lanes_ * span * nc * es_
        d_b = lanes_ * span * P * es_
        return {"jac": (x_b + tables + d_b * (1 + nc), blocks * (fk + jac)),
                "value": (x_b + tables + d_b, blocks * (fk + val))}

    def bound(w):
        t_bytes = w[0] / PEAK_BYTES * 1e3
        t_ops = w[1] / PEAK_FLOPS["float32"] * 1e3
        return dict(bytes=w[0], flops=w[1], bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations")

    _, data_sb, _, world_sb = make_simple_collision(lanes, torch.float64,
                                                    device=dev)
    x_sb64 = (data_sb.x0 + torch.as_tensor(np.random.default_rng(8).normal(
        0.0, 0.1, tuple(data_sb.x0.shape)), device=dev)).contiguous()
    # a world larger than a block's shared memory holds beside its slots:
    # arm7 with 450 seeded spheres of 3 cm on its table (3178 pairs), where
    # K7's plan lowers the slots and float64 leaves the tables in global
    # memory (the positions of test_torch_disc_slots.py's)
    sp_rng = np.random.default_rng(450)
    world_sp = build_collision_world(*models.arm7(), attachments=[
        ("table", UrdfGeom("sphere", np.array([0.03]), sp_rng.uniform(
            [-0.6, -0.6, 0.1], [0.6, 0.6, 1.0]), np.zeros(3)))
        for _ in range(450)])
    disc_err = {"disc_dist": [], "disc_dist_value": []}
    disc_time = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        tol_d, tol_j = COLL_TOL[dname]
        x_arm, world_arm = flagship_x(dtype, 7)
        x_box = (box_probs["box_cast_t30"][1].x0.to(dtype) + torch.as_tensor(
            np.random.default_rng(13).normal(0.0, 0.05, (lanes, 60)),
            device=dev).to(dtype)).contiguous()
        for label, world, x, TT in (
                ("spherebot", world_sb, x_sb64.to(dtype).contiguous(), 1),
                ("arm7", world_arm, x_arm, 30),
                ("boxbot", box_probs["box_cast_t30"][4], x_box, 30),
                ("spheres450", world_sp, x_arm.reshape(lanes, 30, 7)[:, :4]
                 .reshape(lanes, 28).contiguous(), 4)):
            nd, P = world.chain.n_dof, world.n_pairs
            blocks = {name: disc_plan(_native.library("disc_dist"), name,
                                      world, x, TT, nd, 0, TT)
                      for name in ("disc_dist", "disc_dist_value")}
            if label == "spheres450" and dtype == torch.float64:
                assert not any(b.stage for b in blocks.values()), blocks
            X = x.reshape(lanes, TT, nd)
            pre = DiscreteDistancePre(world, TT)
            Dk, Jk = pre.value_jac(x)
            Dv = pre.value(x)
            sync()
            Dp, Jp = pre.value_jac(x, kernels=False)

            def step_x(idx):
                return X[idx[:, 0], idx[:, 1]][:, None]

            def disc_values(idx, xp):
                n, draws = xp.shape[:2]
                d = world.pair_distances(xp[:, :, 0])
                return torch.gather(d, 2, idx[:, 2:3, None].expand(
                    -1, draws, 1))[..., 0]

            def disc_jac(idx, xp):
                n, draws = xp.shape[:2]
                J = torch.func.vmap(torch.func.jacfwd(world.pair_distances))(
                    xp[:, :, 0].reshape(-1, nd)).reshape(n, draws, P, nd)
                return torch.gather(J, 2, idx[:, 2:3, None, None].expand(
                    -1, draws, 1, nd))[:, :, 0]

            dscale = float(Dp.abs().max())
            for name, Dout in (("disc_dist", Dk), ("disc_dist_value", Dv)):
                rec = value_rows(f"{name}_{label}", dname,
                                 (Dout - Dp).abs() / dscale, step_x,
                                 disc_values, dscale, tol_d)
                disc_err[name].append(dict(
                    rec, dtype=dname, world=label, slots=blocks[name].slots,
                    tables_staged=bool(blocks[name].stage)))
            jac_scale[0] = float(Jp.abs().max())
            rowj = (Jk - Jp).abs().amax(-1) / jac_scale[0]
            # capsule-box rows: d_capsule_box's 12 projections, as phase 2's
            # sphere sweeps against a box
            capbox = torch.as_tensor(
                [(world.geoms[i].kind, world.geoms[j].kind) == (1, 2)
                 for i, j in world.pairs], device=dev).expand_as(rowj)
            # box-box rows off the SAT max's near ties (counted)
            rec = jac_rows(f"disc_dist_jacobian_{label}", dname, rowj,
                           capbox, disc_jac, step_x, tol_j,
                           world.pair_ties(X, TIE_RULE[dname][0]))
            disc_err["disc_dist"][-1].update(
                {k: v for k, v in rec.items() if k.startswith("J_")},
                tie_rows_excluded=rec["tie_rows_excluded"])
            if dtype == torch.float32:
                # ms: the bare launch on the device clock (device_ms);
                # wrapper_ms: the entry point's CUDA events over 50 calls
                # one after another (its host time where that is longer);
                # at arm7 also one (lane, step), the launch floor
                w = disc_work(world, lanes, TT, es, nd)
                for name, fn, plain, wk in (
                        ("disc_dist", lambda: pre.value_jac(x),
                         lambda: pre.value_jac(x, kernels=False), w["jac"]),
                        ("disc_dist_value", lambda: pre.value(x),
                         lambda: pre.value(x, kernels=False), w["value"])):
                    disc_time[name, label] = dict(
                        ms=device_ms(disc_bare_launch(
                            name, world, x, TT, nd, 0, TT)[0])[0],
                        wrapper_ms=time_ms(fn),
                        plain_ms=time_ms(plain, reps=3),
                        library_ms=None, **bound(wk),
                        shape=f"x ({lanes}, {TT * nd}) -> D ({lanes}, {TT}, "
                        f"{P})" + (f", J ({lanes}, {TT}, {P}, {nd})"
                                   if name == "disc_dist" else ""))
                    if label == "arm7":
                        disc_time[name, label]["one_slot_ms"] = device_ms(
                            disc_bare_launch(name, world,
                                             x[:1, :nd].contiguous(), 1, nd,
                                             0, 1)[0])[0]
                    emit({"time": f"{name}_{label}",
                          **disc_time[name, label], "card": smi})
    for name in ("disc_dist", "disc_dist_value"):
        # the main path's shape: arm7's table world at 128 x 30 (7f's);
        # simple_collision's spherebot beside it
        timing[name] = dict(disc_time[name, "arm7"],
                            spherebot=disc_time[name, "spherebot"])

    # K4 / K4v at n_sub 8 (planning) and K4 at n_dof 9 (the rail)
    def cast_check(label, world, X, n_sub, dname, kinds):
        """K4 (and K4v) against the plain versions on trajectories X
        (lanes, T, nd): values on every row, Jacobians on the untied rows
        (the sphere-box ones to CAPBOX_JTOL), as phase 2."""
        tol_d, tol_j = COLL_TOL[dname]
        TT, nd = X.shape[1], X.shape[2]
        P = world.n_pairs
        x = X.reshape(lanes, -1).contiguous()
        pre = CastDistancePre(world, TT, n_sub=n_sub)
        pre1 = CastDistancePre(world, 2, n_sub=n_sub)
        Dk, (Jak, Jbk) = pre.value_jac(x)
        Dv = pre.value(x)
        sync()
        Dp, (Jap, Jbp) = pre.value_jac(x, kernels=False)

        def gap_x(idx):
            return torch.stack([X[idx[:, 0], idx[:, 1]],
                                X[idx[:, 0], idx[:, 1] + 1]], 1)

        def seg_values(idx, xp):
            n, draws = xp.shape[:2]
            Dx = pre1.value(xp.reshape(n * draws, 2 * nd),
                            kernels=False).reshape(n, draws, -1, P)
            return Dx[torch.arange(n, device=dev)[:, None],
                      torch.arange(draws, device=dev)[None],
                      idx[:, 2:3], idx[:, 3:4]]

        def seg_jac(idx, xp):
            n, draws = xp.shape[:2]
            _, (Ja_, Jb_) = pre1.value_jac(xp.reshape(n * draws, 2 * nd),
                                           kernels=False)
            row = (idx[:, 2] * P + idx[:, 3])[:, None].expand(-1, draws)
            Ja_ = Ja_.reshape(n, draws, -1, nd)
            Jb_ = Jb_.reshape(n, draws, -1, nd)
            pick = row[..., None, None].expand(-1, -1, 1, nd)
            return torch.cat([torch.gather(Ja_, 2, pick)[:, :, 0],
                              torch.gather(Jb_, 2, pick)[:, :, 0]], -1)

        dscale = float(Dp.abs().max())
        recs = {}
        for name, Dout in (("cast_seg", Dk), ("cast_seg_value", Dv)):
            if name in kinds:
                recs[name] = value_rows(f"{name}_{label}", dname,
                                        (Dout - Dp).abs() / dscale, gap_x,
                                        seg_values, dscale, tol_d)
        tie = world.cast_ties(X[:, :-1], X[:, 1:], n_sub, *TIE_RULE[dname]
                              ).reshape(lanes, TT - 1, n_sub - 1, P)
        jac_scale[0] = max(float(Jap.abs().max()), float(Jbp.abs().max()))
        rowj = (torch.maximum((Jak - Jap).abs().amax(-1),
                              (Jbk - Jbp).abs().amax(-1)) / jac_scale[0]
                ).reshape(lanes, TT - 1, n_sub - 1, P)
        capbox = torch.as_tensor(
            [r == "sphere" and 2 in (world.geoms[i].kind,
                                     world.geoms[j].kind)
             for (i, j), (r, _) in zip(world.pairs, world.pair_routes())],
            device=dev).expand_as(rowj)
        rec = jac_rows(f"cast_seg_jacobian_{label}", dname, rowj, capbox,
                       seg_jac, gap_x, tol_j, tie)
        recs["cast_seg"].update({k: v for k, v in rec.items()
                                 if k.startswith("J_")},
                                J_tie_rows_excluded=rec["tie_rows_excluded"])
        return recs, pre, x, Dp

    new_err = {}
    _, data_pl, _, world_pl = make_planning(lanes, dtype=f32, device=dev)
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        for label, world, data_, n_sub, kinds in (
                ("planning_nsub8", world_pl, data_pl, 8,
                 ("cast_seg", "cast_seg_value")),
                ("rail_nd9", world_r, data_r, 2, ("cast_seg",))):
            x0 = data_.x0.to(dtype)
            noise = torch.as_tensor(np.random.default_rng(9).normal(
                0.0, 0.02, tuple(x0.shape)), device=dev).to(dtype)
            nd = world.chain.n_dof
            X = (x0 + noise).reshape(lanes, -1, nd)
            recs, pre, x, Dp = cast_check(label, world, X, n_sub, dname,
                                          kinds)
            for name, r in recs.items():
                new_err.setdefault((name, label), []).append(
                    dict(r, dtype=dname))
            if dtype != torch.float32:
                continue
            w = cast_work(world, Dp, lanes, X.shape[1] - 1, n_sub, es, nd)
            for name in kinds:
                fn = (lambda: pre.value_jac(x)) if name == "cast_seg" \
                    else (lambda: pre.value(x))
                plain = (lambda: pre.value_jac(x, kernels=False)) \
                    if name == "cast_seg" \
                    else (lambda: pre.value(x, kernels=False))
                t = dict(ms=time_ms(fn), plain_ms=time_ms(plain, reps=3),
                         library_ms=None,
                         **bound(w["jac" if name == "cast_seg" else "value"]),
                         shape=f"x ({lanes}, {x.shape[1]}) -> D ({lanes}, "
                         f"{X.shape[1] - 1}, {n_sub - 1}, {world.n_pairs})"
                         f" at n_sub {n_sub}, n_dof {nd}")
                timing[f"{name}_{label}"] = t
                emit({"time": f"{name}_{label}", **t, "card": smi})

    # K4 / K4v / K5 at n_dof 2 on boxbot at 8b's shapes (x (128, 60) -> D
    # (128, 29, 47, 1), Ja / Jb (128, 29, 47, 2), n_sub 48): the box-box
    # SAT sweep of phase C; the Jacobian's rows held off the SAT max's near
    # ties (geometry.swept_box_box_ties, TIE_RULE's rel), which are counted
    world_bx = box_probs["box_cast_t30"][4]
    n_sub_bx = box_n_sub(box_docs("box_cast_t30", lanes))
    box_err = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        x0 = data_bx.x0.to(dtype)
        noise = torch.as_tensor(np.random.default_rng(12).normal(
            0.0, 0.05, tuple(x0.shape)), device=dev).to(dtype)
        X = (x0 + noise).reshape(lanes, -1, 2)
        recs, pre, x, Dp = cast_check("boxbot_nd2", world_bx, X, n_sub_bx,
                                      dname, ("cast_seg", "cast_seg_value"))
        for name, r in recs.items():
            box_err.setdefault(name, []).append(dict(r, dtype=dname))
        Ds = cast_sweep_distances(world_bx, X, 16)
        sync()
        Dsp = cast_sweep_distances(world_bx, X, 16, kernels=False)
        rec = value_rows("cast_sweep_boxbot", dname,
                         (Ds - Dsp).abs() / float(Dsp.abs().max()),
                         lambda idx: torch.stack(
                             [X[idx[:, 0], idx[:, 1]],
                              X[idx[:, 0], idx[:, 1] + 1]], 1),
                         lambda idx, xp: torch.gather(
                             world_bx.cast_pair_distances(
                                 xp[:, :, 0], xp[:, :, 1], 16), 2,
                             idx[:, 2:3, None].expand(-1, xp.shape[1], 1)
                         )[..., 0],
                         float(Dsp.abs().max()), COLL_TOL[dname][0])
        box_err.setdefault("cast_sweep", []).append(dict(rec, dtype=dname))
        if dtype != torch.float32:
            continue
        w = cast_work(world_bx, Dp, lanes, X.shape[1] - 1, n_sub_bx, es, 2)
        w16 = cast_work(world_bx, Dsp, lanes, X.shape[1] - 1, 16, es, 2)
        for name, fn, plain, wk in (
                ("cast_seg", lambda: pre.value_jac(x),
                 lambda: pre.value_jac(x, kernels=False), w["jac"]),
                ("cast_seg_value", lambda: pre.value(x),
                 lambda: pre.value(x, kernels=False), w["value"]),
                ("cast_sweep", lambda: cast_sweep_distances(world_bx, X, 16),
                 lambda: cast_sweep_distances(world_bx, X, 16, False),
                 w16["sweep"])):
            t = dict(ms=time_ms(fn), plain_ms=time_ms(plain, reps=3),
                     library_ms=None, **bound(wk),
                     shape=f"x ({lanes}, {x.shape[1]}) -> D ({lanes}, "
                     f"{X.shape[1] - 1}, "
                     + (f"{n_sub_bx - 1}, 1) at n_sub {n_sub_bx}"
                        if name != "cast_sweep" else "1) at n_sub 16")
                     + ", n_dof 2, boxbot")
            timing[f"{name}_boxbot_nd2"] = t
            emit({"time": f"{name}_boxbot_nd2", **t, "card": smi})

    # the SQP's batched QP solves (its calls of solve_ipm_qp), counted from
    # here on beside the launch counters
    qp_calls, reset_counts = count_qp_calls(sqp_mod, _native)
    count_linalg()

    def path_ok(launches, n_qp):
        """K6 once per batched QP solve; K1-K3 never."""
        return launches["ipm_banded"] == n_qp > 0 \
            and all(launches[k] == 0 for k in QP_KERNELS)

    # ------------------------------------------------------------------
    # phase 3: the collision-free slice, float32, 128 lanes, T = 30
    # ------------------------------------------------------------------
    spec, data, _ = make_glass_upright_free(batch=lanes, n_steps=30,
                                            dtype=torch.float32, device=dev)

    def run():
        res = solve_batch_compact(spec, data, params, phase_qp_solves=8,
                                  device=dev)
        sync()
        return res

    t0 = time.perf_counter()
    run()  # first call: allocator and library warm-up
    cold_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    res = run()
    wall_s = time.perf_counter() - t0
    launches_s = dict(_native.LAUNCHES)
    qp_s = qp_calls[0]
    walls = [wall_s]
    for _ in range(2):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    status = res.status.cpu().numpy()
    viol = res.cnt_viols.max(dim=1).values.cpu().numpy()
    finite = bool(torch.isfinite(res.x).all())
    good = (status == CONVERGED) & (viol < 1e-4)
    n_ok = int(good.sum())
    mean_wall = sum(walls) / len(walls)
    emit({"phase": "slice", "batch": lanes, "n_steps": 30, "dtype": "float32",
          "converged": n_ok, "finite": finite,
          "mean_qp_solves": float(res.n_qp_solves.float().mean()),
          "max_viol": float(viol.max()), "cold_s": cold_s,
          "wall_s": mean_wall, "walls_s": walls,
          "solves_per_s": n_ok / mean_wall, "launches": launches_s,
          "batched_qp_solves": qp_s, "card": smi})
    assert path_ok(launches_s, qp_s), (launches_s, qp_s)
    assert finite, "non-finite lanes"
    assert n_ok >= 120, f"only {n_ok}/128 lanes converged"

    # ------------------------------------------------------------------
    # phase 3b: the full flagship, float32, 128 lanes, T = 30, and its gate
    # ------------------------------------------------------------------
    def run_full():
        res = solve_batch_compact(spec_f, data_f, params, phase_qp_solves=8,
                                  device=dev)
        sync()
        return res

    t0 = time.perf_counter()
    run_full()
    cold_f = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    res_f = run_full()
    walls_f = [time.perf_counter() - t0]
    t0 = time.perf_counter()
    gate = trajectory_in_collision(world_f, res_f.x.reshape(lanes, 30, D))
    sync()
    gate_s = time.perf_counter() - t0
    launches_f = dict(_native.LAUNCHES)
    qp_f = qp_calls[0]
    for _ in range(2):
        t0 = time.perf_counter()
        run_full()
        walls_f.append(time.perf_counter() - t0)
    status = res_f.status.cpu().numpy()
    viol = res_f.cnt_viols.max(dim=1).values.cpu().numpy()
    gate_np = gate.cpu().numpy()
    finite = bool(torch.isfinite(res_f.x).all())
    good = (status == CONVERGED) & (viol < 1e-4) & (gate_np >= 0.0)
    n_ok = int(good.sum())
    mean_wall = sum(walls_f) / len(walls_f)
    emit({"phase": "flagship", "batch": lanes, "n_steps": 30,
          "dtype": "float32", "n_sub": 2, "gate_n_sub": 16,
          "converged": int((status == CONVERGED).sum()), "gated_ok": n_ok,
          "finite": finite,
          "mean_qp_solves": float(res_f.n_qp_solves.float().mean()),
          "max_viol": float(viol.max()), "min_swept_distance":
          float(gate_np.min()), "cold_s": cold_f, "wall_s": mean_wall,
          "walls_s": walls_f, "gate_s": gate_s,
          "solves_per_s": n_ok / mean_wall, "launches": launches_f,
          "batched_qp_solves": qp_f, "card": smi})
    assert all(launches_f[k] > 0 for k in PATH_KERNELS), launches_f
    assert path_ok(launches_f, qp_f), (launches_f, qp_f)
    assert finite, "non-finite lanes"
    assert n_ok >= 120, f"only {n_ok}/128 lanes pass the gate"

    # ------------------------------------------------------------------
    # phase 3c: pick-and-place, float32, 128 lanes, T = 12, both phases
    # ------------------------------------------------------------------
    def run_pnp():
        out = solve_pick_and_place(lanes, pnp_T, torch.float32, params=params,
                                   device=dev)
        sync()
        return out

    def gates(resA, resB, scene):
        XA = resA.x.reshape(lanes, pnp_T, D)
        XB = resB.x.reshape(lanes, pnp_T, D)
        return (trajectory_in_collision(scene["world_free"], XA),
                trajectory_in_collision(scene["world_att"], XB))

    t0 = time.perf_counter()
    run_pnp()
    cold_p = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    resA, resB, scene = run_pnp()
    walls_p = [time.perf_counter() - t0]
    gA, gB = gates(resA, resB, scene)
    sync()
    launches_p = dict(_native.LAUNCHES)
    qp_p = qp_calls[0]
    for _ in range(2):
        t0 = time.perf_counter()
        run_pnp()
        walls_p.append(time.perf_counter() - t0)
    # once more phase by phase: each phase's wall and launches (gate
    # included)
    phase_wall, phase_launches, phase_qp = {}, {}, {}
    reset_counts()
    t0 = time.perf_counter()
    specA, dataA, sc = make_pick_and_place(lanes, pnp_T, torch.float32,
                                           device=dev)
    rA = solve_batch_compact(specA, dataA, params, phase_qp_solves=8,
                             device=dev)
    trajectory_in_collision(sc["world_free"], rA.x.reshape(lanes, pnp_T, D))
    sync()
    phase_wall["approach"] = time.perf_counter() - t0
    phase_launches["approach"] = dict(_native.LAUNCHES)
    phase_qp["approach"] = qp_calls[0]
    reset_counts()
    t0 = time.perf_counter()
    specB, dataB = chain_transfer(
        sc, rA.x.reshape(lanes, pnp_T, D)[:, -1].cpu().numpy())
    rB = solve_batch_compact(specB, dataB, params, phase_qp_solves=8,
                             device=dev)
    trajectory_in_collision(sc["world_att"], rB.x.reshape(lanes, pnp_T, D))
    sync()
    phase_wall["transfer"] = time.perf_counter() - t0
    phase_launches["transfer"] = dict(_native.LAUNCHES)
    phase_qp["transfer"] = qp_calls[0]
    XA = resA.x.reshape(lanes, pnp_T, D)
    XB = resB.x.reshape(lanes, pnp_T, D)
    chained = bool((XB[:, 0] == XA[:, -1]).all())
    # the JAX package's counts on the CPU at this size (seed 0)
    reference = {"approach": {"gated": 128, "mean_qp_solves": 6.0},
                 "transfer": {"gated": 125, "mean_qp_solves": 15.52}}
    pnp_rec = {"phase": "pick_and_place", "batch": lanes, "n_steps": pnp_T,
               "dtype": "float32", "n_sub": 2, "gate_n_sub": 16,
               "cold_s": cold_p, "walls_s": walls_p,
               "wall_s": sum(walls_p) / len(walls_p),
               "transfer_step0_is_approach_last": chained,
               "launches": launches_p, "batched_qp_solves": qp_p,
               "card": smi}
    n_gated = {}
    for ph, r, g in (("approach", resA, gA), ("transfer", resB, gB)):
        st = r.status.cpu().numpy()
        v = r.cnt_viols.max(dim=1).values.cpu().numpy()
        gg = g.cpu().numpy()
        n_gated[ph] = int(((st == CONVERGED) & (v < 1e-4) & (gg >= 0)).sum())
        pnp_rec[ph] = {
            "converged": int((st == CONVERGED).sum()), "gated": n_gated[ph],
            "finite": bool(torch.isfinite(r.x).all()),
            "mean_qp_solves": float(r.n_qp_solves.float().mean()),
            "max_viol": float(v.max()), "min_swept_distance": float(gg.min()),
            "wall_s_phase_by_phase": phase_wall[ph],
            "launches_phase_by_phase": phase_launches[ph],
            "batched_qp_solves_phase_by_phase": phase_qp[ph],
            "jax_reference_cpu": reference[ph]}
    pnp_rec["gated_solves_per_s"] = sum(n_gated.values()) / 2 \
        / pnp_rec["wall_s"]
    emit(pnp_rec)
    tl = phase_launches["transfer"]
    assert chained, "the transfer's step 0 is not the approach's last step"
    assert all(pnp_rec[ph]["finite"] for ph in n_gated), "non-finite lanes"
    assert all(n >= 120 for n in n_gated.values()), n_gated
    assert all(tl[k] > 0 for k in PATH_KERNELS) and tl["convex_feature"] > 0 \
        and tl["convex_fw"] > 0, tl
    assert phase_launches["approach"]["convex_feature"] == 0
    assert path_ok(launches_p, qp_p), (launches_p, qp_p)
    assert all(path_ok(phase_launches[ph], phase_qp[ph])
               for ph in phase_qp), (phase_launches, phase_qp)

    # ---- K4 / K4v / K5 on the transfer world against their plain versions
    # (the straight-line init through the wall, plus seeded noise, and the
    # solved trajectories); the CONVEX pairs apart ----
    cvx_pair = torch.as_tensor([world_att.geoms[j].kind == 3
                                for _, j in world_att.pairs], device=dev)
    noise = torch.as_tensor(np.random.default_rng(5).normal(
        0.0, 0.02, tuple(XB0.shape)), device=dev)
    inputs = {"init": XB0, "init_noise": XB0 + noise.to(XB0.dtype),
              "solved": XB.detach()}
    P_att, gaps_p = world_att.n_pairs, pnp_T - 1
    pre_t = CastDistancePre(world_att, pnp_T, n_sub=2)
    pre_t1 = CastDistancePre(world_att, 2, n_sub=2)
    transfer_err = {"cast_seg": [], "cast_seg_value": [], "cast_sweep": []}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        tol_d, tol_j = COLL_TOL[dname]
        for label, Xin in inputs.items():
            X = Xin.to(dtype).contiguous()
            x = X.reshape(lanes, -1)

            def gap_x(idx):
                return torch.stack([X[idx[:, 0], idx[:, 1]],
                                    X[idx[:, 0], idx[:, 1] + 1]], 1)

            def seg_values(idx, xp):
                n, draws = xp.shape[:2]
                Dx = pre_t1.value(xp.reshape(n * draws, 2 * D),
                                  kernels=False).reshape(n, draws, -1, P_att)
                return Dx[torch.arange(n, device=dev)[:, None],
                          torch.arange(draws, device=dev)[None],
                          idx[:, 2:3], idx[:, 3:4]]

            Dk, (Jak, Jbk) = pre_t.value_jac(x)
            Dv = pre_t.value(x)
            sync()
            Dp, (Jap, Jbp) = pre_t.value_jac(x, kernels=False)
            dscale = float(Dp.abs().max())
            tie = world_att.cast_ties(X[:, :-1], X[:, 1:], 2,
                                      *TIE_RULE[dname]).reshape(lanes,
                                                                gaps_p, -1)
            recs = {}
            for name, Dout in (("cast_seg", Dk), ("cast_seg_value", Dv)):
                err = (Dout - Dp).abs() / dscale
                recs[name] = value_rows(f"{name}_transfer_{label}", dname,
                                        err, gap_x, seg_values, dscale, tol_d,
                                        tie.reshape(err.shape))
                recs[name]["D_rel_err_convex_pairs"] = float(
                    err[..., cvx_pair].max())
            keep = ~tie
            jscale = max(float(Jap.abs().max()), float(Jbp.abs().max()))
            rowj = torch.maximum((Jak - Jap).abs().amax(-1),
                                 (Jbk - Jbp).abs().amax(-1)) / jscale
            capbox = torch.as_tensor(
                [r == "sphere" and 2 in (world_att.geoms[i].kind,
                                         world_att.geoms[j].kind)
                 for (i, j), (r, _) in zip(world_att.pairs,
                                           world_att.pair_routes())],
                device=dev)
            ej = float((rowj * (keep & ~capbox)).max())
            ej_cvx = float((rowj * (keep & cvx_pair)).max())
            ej_capbox = float((rowj * (keep & capbox)).max())
            ok = ej < tol_j and ej_capbox < CAPBOX_JTOL[dname]
            recs["cast_seg"].update(
                J_rel_err_untied_rows=ej, J_rel_err_all_rows=float(rowj.max()),
                J_rel_err_untied_convex_pairs=ej_cvx,
                J_tie_rows_excluded=int(tie.sum()),
                J_tie_rows_convex_pairs=int(tie[..., cvx_pair].sum()))
            emit({"check": f"cast_seg_jacobian_transfer_{label}",
                  "dtype": dname, "J_rel_err_untied_rows": ej,
                  "J_rel_err_untied_convex_pairs": ej_cvx,
                  "J_rel_err_all_rows": float(rowj.max()),
                  "J_rel_err_sphere_box_untied_rows": ej_capbox,
                  "J_rows_over_tol": int((rowj > tol_j).sum()),
                  "rows": keep.numel(), "tie_rows_excluded": int(tie.sum()),
                  "tie_rows_convex_pairs": int(tie[..., cvx_pair].sum()),
                  "convex_pair_rows": int(cvx_pair.sum()) * lanes * gaps_p,
                  "tol": [tol_j, CAPBOX_JTOL[dname]], "ok": ok})
            assert ok, "cast_seg's Jacobian disagrees on the transfer world"
            for name in recs:
                transfer_err[name].append(dict(recs[name], dtype=dname,
                                               input=label))
            Ds = cast_sweep_distances(world_att, X, 16)
            sync()
            Dsp = cast_sweep_distances(world_att, X, 16, kernels=False)

            def sweep_values(idx, xp):
                d = world_att.cast_pair_distances(xp[:, :, 0], xp[:, :, 1],
                                                  16)
                return torch.gather(d, 2, idx[:, 2:3, None].expand(
                    -1, d.shape[1], 1))[..., 0]

            err = (Ds - Dsp).abs() / float(Dsp.abs().max())
            # the gap's hull decisions are those of n_sub 2's one segment
            rec = value_rows(f"cast_sweep_transfer_{label}", dname, err,
                             gap_x, sweep_values, float(Dsp.abs().max()),
                             tol_d, tie)
            rec["D_rel_err_convex_pairs"] = float(err[..., cvx_pair].max())
            transfer_err["cast_sweep"].append(dict(rec, dtype=dname,
                                                   input=label))
    # the CVX instantiations' times on the transfer world (float32, the
    # noisy init)
    xt = inputs["init_noise"].reshape(lanes, -1).contiguous()
    Xt = inputs["init_noise"]
    work_t = cast_work(world_att, pre_t.value(xt, kernels=False), lanes,
                       gaps_p, 2, es, D)
    work_t16 = cast_work(world_att, cast_sweep_distances(world_att, Xt, 16,
                                                         False),
                         lanes, gaps_p, 16, es, D)
    timing_t = {}
    for name, fn, plain, w in (
            ("cast_seg", lambda: pre_t.value_jac(xt),
             lambda: pre_t.value_jac(xt, kernels=False), work_t["jac"]),
            ("cast_seg_value", lambda: pre_t.value(xt),
             lambda: pre_t.value(xt, kernels=False), work_t["value"]),
            ("cast_sweep", lambda: cast_sweep_distances(world_att, Xt, 16),
             lambda: cast_sweep_distances(world_att, Xt, 16, False),
             work_t16["sweep"])):
        t_bytes = w[0] / PEAK_BYTES * 1e3
        t_ops = w[1] / PEAK_FLOPS["float32"] * 1e3
        timing_t[name] = dict(
            ms=time_ms(fn, reps=20), plain_ms=time_ms(plain, reps=3),
            bytes=w[0], flops=w[1], bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            shape="x (128, 84) -> D (128, 11, 34)"
            + (", Ja/Jb (128, 11, 34, 7)" if name == "cast_seg" else ""))
        emit({"time": f"{name}_transfer", **timing_t[name], "card": smi})

    # ------------------------------------------------------------------
    # phase 4: kernel path == plain path, float64, 16 lanes, on the card
    # ------------------------------------------------------------------
    spec64, data64, _ = make_glass_upright_free(batch=16, n_steps=30,
                                                dtype=torch.float64,
                                                device=dev)
    rk = solve_batch_compact(spec64, data64, params, phase_qp_solves=8,
                             device=dev, kernels=True)
    t0 = time.perf_counter()
    rp = solve_batch_compact(spec64, data64, params, phase_qp_solves=8,
                             device=dev, kernels=False)
    sync()
    plain_s = time.perf_counter() - t0
    same_status = bool((rk.status == rp.status).all())
    same_nqp = bool((rk.n_qp_solves == rp.n_qp_solves).all())
    dx = float((rk.x - rp.x).abs().max())
    emit({"phase": "f64_kernel_vs_plain", "lanes": 16,
          "status": rk.status.tolist(), "n_qp": rk.n_qp_solves.tolist(),
          "same_status": same_status, "same_n_qp": same_nqp,
          "max_abs_dx": dx, "tol": 1e-8, "plain_path_s": plain_s})
    assert same_status and same_nqp and dx < 1e-8, "kernel path != plain path"

    # phase 4b: the full flagship, the same comparison
    spec64f, data64f, _, _ = make_glass_upright(batch=16, n_steps=30,
                                                dtype=torch.float64,
                                                device=dev)
    rk = solve_batch_compact(spec64f, data64f, params, phase_qp_solves=8,
                             device=dev, kernels=True)
    t0 = time.perf_counter()
    rp = solve_batch_compact(spec64f, data64f, params, phase_qp_solves=8,
                             device=dev, kernels=False)
    sync()
    plain_s = time.perf_counter() - t0
    same_status = bool((rk.status == rp.status).all())
    same_nqp = bool((rk.n_qp_solves == rp.n_qp_solves).all())
    dx_lane = (rk.x - rp.x).abs().amax(-1)
    dx = float(dx_lane.max())
    # a tied witness decision (an exact tie, e.g. both poses of a pure-yaw
    # gap at the same height over the table) is resolved by rounding, and
    # the kernel's rounding is not torch's: a lane whose path meets such a
    # row takes another valid Jacobian there and its x moves.  The plain
    # path from x0 moved by one ulp shows how far rounding alone moves
    # each lane.
    u = torch.as_tensor(np.random.default_rng(4).integers(
        -1, 2, tuple(data64f.x0.shape)), device=dev).to(torch.float64)
    ru = solve_batch_compact(
        spec64f, data64f._replace(
            x0=data64f.x0 * (1 + u * torch.finfo(torch.float64).eps)),
        params, phase_qp_solves=8, device=dev, kernels=False)
    du_lane = (ru.x - rp.x).abs().amax(-1)
    emit({"phase": "f64_flagship_kernel_vs_plain", "lanes": 16,
          "status": rk.status.tolist(), "n_qp": rk.n_qp_solves.tolist(),
          "same_status": same_status, "same_n_qp": same_nqp,
          "max_abs_dx": dx, "dx_per_lane": dx_lane.tolist(),
          "lanes_within_1e-12": int((dx_lane < 1e-12).sum()),
          "plain_x0_ulp_dx_per_lane": du_lane.tolist(),
          "plain_x0_ulp_same_status": bool((ru.status == rp.status).all()),
          "lanes_moved_by_both": int(((dx_lane > 1e-12)
                                      & (du_lane > 1e-12)).sum()),
          "tol": FLAGSHIP_DX_TOL, "plain_path_s": plain_s})
    # and no lane moves further than rounding alone moves the plain path
    assert same_status and same_nqp and dx < FLAGSHIP_DX_TOL \
        and dx <= float(du_lane.max()), "flagship kernel path != plain path"

    # phase 4c: pick-and-place, 8 lanes of each phase, the same comparison;
    # the transfer of both paths starts from the plain path's approach
    def kernel_vs_plain(spec64, data64, label, dx_tol, ulp_bound):
        rk = solve_batch_compact(spec64, data64, params, phase_qp_solves=8,
                                 device=dev, kernels=True)
        t0 = time.perf_counter()
        rp = solve_batch_compact(spec64, data64, params, phase_qp_solves=8,
                                 device=dev, kernels=False)
        sync()
        plain_s = time.perf_counter() - t0
        u = torch.as_tensor(np.random.default_rng(6).integers(
            -1, 2, tuple(data64.x0.shape)), device=dev).to(torch.float64)
        ru = solve_batch_compact(
            spec64, data64._replace(
                x0=data64.x0 * (1 + u * torch.finfo(torch.float64).eps)),
            params, phase_qp_solves=8, device=dev, kernels=False)
        dx_lane = (rk.x - rp.x).abs().amax(-1)
        du_lane = (ru.x - rp.x).abs().amax(-1)
        rec = {"phase": f"f64_pick_and_place_{label}_kernel_vs_plain",
               "lanes": rk.x.shape[0], "status": rk.status.tolist(),
               "n_qp": rk.n_qp_solves.tolist(),
               "same_status": bool((rk.status == rp.status).all()),
               "same_n_qp": bool((rk.n_qp_solves == rp.n_qp_solves).all()),
               "max_abs_dx": float(dx_lane.max()),
               "dx_per_lane": dx_lane.tolist(),
               "plain_x0_ulp_dx_per_lane": du_lane.tolist(),
               "plain_x0_ulp_same_status": bool((ru.status == rp.status).all()),
               "lanes_beyond_ulp_move": int((dx_lane > du_lane).sum()),
               "tol": dx_tol, "plain_path_s": plain_s}
        emit(rec)
        # ulp_bound: no lane further than rounding alone moves the plain
        # path (or than 1e-10 where that move is smaller)
        assert rec["same_status"] and rec["same_n_qp"] \
            and rec["max_abs_dx"] < dx_tol and (not ulp_bound or (
                rec["max_abs_dx"] <= max(float(du_lane.max()), 1e-10))), \
            f"pick-and-place {label}: kernel path != plain path"
        return rp

    specA8, dataA8, sc8 = make_pick_and_place(8, pnp_T, torch.float64,
                                              device=dev)
    rpA = kernel_vs_plain(specA8, dataA8, "approach", FLAGSHIP_DX_TOL, True)
    kernel_vs_plain(*chain_transfer(
        sc8, rpA.x.reshape(8, pnp_T, D)[:, -1].cpu().numpy()), "transfer",
        TRANSFER_DX_TOL, False)

    # ------------------------------------------------------------------
    # phase 5: the reference's four solve benchmarks, run_benchmarks(
    # batch=128, repeats=3) on the card, entry by entry
    # ------------------------------------------------------------------
    bench_recs, bench_launches, bench_qp = [], {}, {}
    for name in ("simple_collision", "planning", "glass_upright",
                 "redundant_rail"):
        got = {}
        reset_counts()
        t0 = time.perf_counter()
        rec = run_benchmarks([name], batch=lanes, repeats=3, device=dev,
                             results=got)[0]
        sync()
        entry_s = time.perf_counter() - t0
        bl = dict(_native.LAUNCHES)
        bench_launches[name], bench_qp[name] = bl, qp_calls[0]
        linalg_calls = dict(LINALG_CALLS)
        res, world = got[name]
        st = res.status.cpu().numpy()
        v = res.cnt_viols.max(dim=1).values.cpu().numpy()
        gated = (st == CONVERGED) & (v < 1e-4)
        out = {"phase": "run_benchmarks", "entry": rec,
               "entry_s_cold_and_warm": entry_s, "runs": 4,
               "launches": bl, "batched_qp_solves": qp_calls[0],
               "linalg_calls": linalg_calls,
               "finite": bool(torch.isfinite(res.x).all()),
               "max_viol": float(v.max()),
               "status_counts": np.bincount(st, minlength=5).tolist(),
               "card": smi}
        if name != "simple_collision":  # the K5 gate (n_sub 16)
            T_ = res.x.shape[1] // world.chain.n_dof
            g = trajectory_in_collision(
                world, res.x.reshape(lanes, T_, world.chain.n_dof)
            ).cpu().numpy()
            gated = gated & (g >= 0.0)
            out["min_swept_distance"] = float(g.min())
        out["gated"] = int(gated.sum())
        lim = BENCH_LIMITS.get(name)
        if lim:
            out["limits"] = lim
        emit(out)
        bench_recs.append(out)
        assert out["finite"], f"{name}: non-finite lanes"
        if lim:
            assert rec["converged"] >= lim["converged"] \
                and out["gated"] >= lim["gated"], (name, rec, out["gated"])
        if name == "simple_collision":
            # one step: the dense-row QP (K11's dense route, no K6), the
            # discrete kernels
            assert bl["disc_dist"] > 0 and bl["disc_dist_value"] > 0 \
                and dense_path_ok(bl, qp_calls[0]), (bl, linalg_calls)
        else:
            assert path_ok(bl, qp_calls[0]), (name, bl, qp_calls[0])
            assert bl["cast_seg"] > 0 and bl["cast_seg_value"] > 0, bl
        if name == "redundant_rail":
            assert bl["ipm_banded_b9"] == bl["ipm_banded"] \
                and bl["cast_seg_nd9"] == bl["cast_seg"], bl
    launches_b = {k: sum(bench_launches[n][k] for n in bench_launches)
                  for k in _native.LAUNCHES}

    # phase 5b: the float64 kernel path against the plain path, 8 lanes
    # of each new scene, through solve_batch (run_benchmarks' solver)
    def batch_vs_plain(label, spec64, data64):
        """Equal statuses and QP counts, x within FLAGSHIP_DX_TOL and the
        plain path's own move from x0 moved by one ulp."""
        rk = solve_batch(spec64, data64, params, device=dev, kernels=True)
        t0 = time.perf_counter()
        rp = solve_batch(spec64, data64, params, device=dev, kernels=False)
        sync()
        plain_s = time.perf_counter() - t0
        u = torch.as_tensor(np.random.default_rng(10).integers(
            -1, 2, tuple(data64.x0.shape)), device=dev).to(torch.float64)
        ru = solve_batch(spec64, data64._replace(
            x0=data64.x0 * (1 + u * torch.finfo(torch.float64).eps)),
            params, device=dev, kernels=False)
        dx_lane = (rk.x - rp.x).abs().amax(-1)
        du_lane = (ru.x - rp.x).abs().amax(-1)
        rec = {"phase": f"f64_{label}_kernel_vs_plain",
               "lanes": rk.x.shape[0], "status": rk.status.tolist(),
               "n_qp": rk.n_qp_solves.tolist(),
               "status_plain": rp.status.tolist(),
               "n_qp_plain": rp.n_qp_solves.tolist(),
               "same_status": bool((rk.status == rp.status).all()),
               "same_n_qp": bool((rk.n_qp_solves == rp.n_qp_solves).all()),
               "max_abs_dx": float(dx_lane.max()),
               "dx_per_lane": dx_lane.tolist(),
               "plain_x0_ulp_dx_per_lane": du_lane.tolist(),
               "plain_x0_ulp_status": ru.status.tolist(),
               "plain_x0_ulp_n_qp": ru.n_qp_solves.tolist(),
               "plain_x0_ulp_same_status": bool(
                   (ru.status == rp.status).all()),
               "tol": FLAGSHIP_DX_TOL, "plain_path_s": plain_s}
        ok = rec["same_status"] and rec["same_n_qp"] \
            and rec["max_abs_dx"] < FLAGSHIP_DX_TOL \
            and rec["max_abs_dx"] <= max(float(du_lane.max()), 1e-10)
        rec["ok"] = ok
        emit(rec)
        assert ok, f"{label}: kernel path != plain path"
        return rec

    batch_vs_plain("simple_collision",
                   *make_simple_collision(8, torch.float64, device=dev)[:2])
    batch_vs_plain("planning", *make_planning(8, dtype=torch.float64,
                                              device=dev)[:2])
    # The rail's straight-line start moves only the carriage and the first
    # and last joints: about half of its cast rows hold an exact tie there
    # (two substates at one distance, a hull at the substates' minimum),
    # which each path resolves by its own rounding.  From it the two paths
    # part at the first QP solve (its dx reported here; the whole solve
    # from it is left out to keep the script's wall within its budget).
    # From x0 plus seeded noise no decision is tied, and the kernel path is
    # held to the plain path as above (PERF.md section 6).
    spec9, data9 = make_redundant_rail(8, dtype=torch.float64, device=dev)[:2]
    first = [solve_batch(spec9, data9, dataclasses.replace(
        params, max_total_qp_solves=1), device=dev, kernels=k)
        for k in (True, False)]
    emit({"phase": "f64_redundant_rail_straight_start_first_qp",
          "dx_per_lane": (first[0].x - first[1].x).abs().amax(-1).tolist()})
    noise9 = torch.as_tensor(np.random.default_rng(11).normal(
        0.0, 0.02, tuple(data9.x0.shape)), device=dev)
    batch_vs_plain("redundant_rail", spec9,
                   data9._replace(x0=data9.x0 + noise9))

    # ------------------------------------------------------------------
    # phases 2f and 6a-6d: the cartesian slice (K9 / K9v, K8; the
    # dense-row QP's K11)
    # ------------------------------------------------------------------
    cart_entries, cart_paths = cartesian_phases(dev, smi, time_ms,
                                                reset_counts, qp_calls)

    # ------------------------------------------------------------------
    # phases 2g and 7a-7e: the JSON documents and the CLI (K10 / K10v, K6
    # at b 8, K11 at b 8 and on its dense route)
    # ------------------------------------------------------------------
    json_entries, json_paths = json_phases(
        dev, smi, time_ms, reset_counts, qp_calls, json_probs)

    # ------------------------------------------------------------------
    # phases 8a-8e: boxbot's documents (the box-box SAT sweep in K4 / K4v /
    # K5, K6 at b 2), the spherebot documents (K6 at b 2, 3), the CLI
    # ------------------------------------------------------------------
    box_paths = box_phases(dev, smi, time_ms, reset_counts, qp_calls,
                           box_probs)

    # ------------------------------------------------------------------
    # summary (launches: the full flagship's run, phase 3b, for K1-K6; the
    # pick-and-place run, phase 3c, for the CONVEX routes; every path's
    # counts in launches_by_path; K1-K3 run on no path, their math inside
    # K6)
    # ------------------------------------------------------------------
    replaces = {
        "ipm_banded": "trajopt_tpu/ops/ipm_qp.py:92",
        "ipm_dense": "trajopt_tpu/ops/ipm_qp.py:108",
        "bb_quad": "trajopt_tpu/ops/banded_rows.py:89",
        "btd_factor": "trajopt_tpu/ops/btridiag.py:208",
        "btd_solve": "trajopt_tpu/ops/btridiag.py:234",
        "cast_seg": "trajopt_tpu/terms/collision.py:165",
        "cast_seg_value": "trajopt_tpu/terms/collision.py:159",
        "cast_sweep": "trajopt_tpu/terms/collision.py:548",
        "convex_feature": "trajopt_tpu/collision/geometry.py:796",
        "convex_fw": "trajopt_tpu/collision/geometry.py:211",
        "disc_dist": "trajopt_tpu/terms/collision.py:117",
        "disc_dist_value": "trajopt_tpu/terms/collision.py:114",
    }
    source = {k: f"trajopt_tpu_torch/csrc/{k}.cu" for k in replaces}
    source["disc_dist_value"] = source["disc_dist"]
    # K6: ipm_banded.cu (built once per dtype and range of block sizes)
    # over ipm_launch.cuh, its body ipm.cuh over banded.cuh (the warp factor
    # and solves) and qmath.cuh
    # the cast kernels: instantiated in cast_seg.cu (cast_cvx.cu with the
    # CONVEX routes), launched by cast_kernel.cuh, their block's body in
    # cast_block.cuh (the team routines of the CONVEX routes too) over
    # collision.cuh
    cast_sources = [f"trajopt_tpu_torch/csrc/{f}" for f in (
        "cast_seg.cu", "cast_cvx.cu", "cast_kernel.cuh", "cast_block.cuh",
        "collision.cuh")]
    for k in ("cast_seg", "cast_seg_value", "cast_sweep"):
        source[k] = "trajopt_tpu_torch/csrc/cast_seg.cu"
    for k in ("convex_feature", "convex_fw"):
        source[k] = "trajopt_tpu_torch/csrc/cast_block.cuh"
    launches = {k: launches_f[k] for k in PATH_KERNELS + QP_KERNELS}
    launches.update(ipm_dense=cart_paths["cartesian_waypoints"]["ipm_dense"],
                    convex_feature=launches_p["convex_feature"],
                    convex_fw=launches_p["convex_fw"],
                    # K7 / K7v: phase 7f's three warm runs
                    disc_dist=json_paths["json_table_discrete"]["disc_dist"],
                    disc_dist_value=json_paths["json_table_discrete"][
                        "disc_dist_value"])
    # errors: K1-K3 the largest relative error of every check and the
    # absolute one at the main path's shape; K4, K4v, K5 the values' error
    # on every row (D_*), K4 also the Jacobian's on the untied rows and on
    # all rows (J_*), each the worst over float32 and float64
    errs = {k: {"max_rel_err": max(checks[k]), "max_abs_err": slice_err[k]}
            for k in checks}
    # K6: dx against the plain loop on the captured QPs, on the lanes whose
    # runs end alike (float32 at the main path's QP for max_abs_err)
    k6_main = [r for r in k6_recs if r["qp"] == "flagship_qp1"
               and r["dtype"] == "float32"][0]
    errs["ipm_banded"] = {
        "max_abs_err": k6_main["dx_abs_err_equal_lanes"],
        "max_abs_err_of": "dx, float32, the flagship's first QP, lanes "
        "whose runs end alike",
        "dx_max_rel_err_equal_lanes": {
            d: max(r["dx_rel_err_equal_lanes"] for r in k6_recs
                   if r["dtype"] == d) for d in ("float32", "float64")},
        "lanes_apart": {f"{r['qp']}_{r['dtype']}": r["lanes_apart"]
                        for r in k6_recs},
        "objective_gap_over_eps_g_max": max(
            r["objective_gap_over_eps_g_max"] for r in k6_recs),
        "launches_are": "one per batched QP solve",
        "batched_qp_solves_by_path": {"free_slice": qp_s, "flagship": qp_f,
                                      "pick_and_place": qp_p},
        "call_ms": timing["ipm_banded"]["call_ms"],
        "attributes": ipm_attrs,
        "library_ms_null_because": "no one PyTorch call solves this QP",
        "sources": [f"trajopt_tpu_torch/csrc/{f}" for f in (
            "ipm_banded.cu", "ipm_launch.cuh", "ipm.cuh", "banded.cuh",
            "qmath.cuh")]}
    # K11: dx against the plain loop on the captured dense-row QPs, on the
    # lanes whose runs end alike (float32 at 6a's first QP for
    # max_abs_err); its time at 6a's first QP, the others by QP
    k11_main = [r for r in k11_recs if r["qp"] == "cartesian_waypoints_qp1"
                and r["dtype"] == "float32"][0]
    timing["ipm_dense"] = timing["ipm_dense_cartesian_waypoints_qp1"]
    errs["ipm_dense"] = {
        "max_abs_err": k11_main["dx_abs_err_equal_lanes"],
        "max_abs_err_of": "dx, float32, 6a's first QP, lanes whose runs "
        "end alike",
        "dx_max_rel_err_equal_lanes": {
            d: max(r["dx_rel_err_equal_lanes"] for r in k11_recs
                   if r["dtype"] == d) for d in ("float32", "float64")},
        "lanes_apart": {f"{r['qp']}_{r['dtype']}": r["lanes_apart"]
                        for r in k11_recs},
        "objective_gap_over_eps_g_max": max(
            r["objective_gap_over_eps_g_max"] for r in k11_recs),
        "ms_is": "the bare launch on the device clock (device_ms)",
        "launches_are": "one per batched QP solve: 6a's warm run",
        "by_qp": {q[len("ipm_dense_"):]: t for q, t in timing.items()
                  if q.startswith("ipm_dense_")},
        "attributes": k11_attrs,
        "library_ms_null_because": "no one PyTorch call solves this QP",
        "sources": [f"trajopt_tpu_torch/csrc/{f}" for f in (
            "ipm_dense.cu", "ipm_dense.cuh", "ipm.cuh", "banded.cuh",
            "qmath.cuh")]}
    for k, v in coll_err.items():
        errs[k] = {"max_abs_err": max(e["D_abs_err_all_rows"] for e in v),
                   "max_abs_err_of": "D, all rows",
                   "D_max_rel_err_all_rows": max(e["D_rel_err_all_rows"]
                                                 for e in v),
                   "D_rows_over_tol": max(e["D_rows_over_tol"] for e in v)}
        if k == "cast_seg":
            errs[k].update({f: max(e[f] for e in v) for f in (
                "J_rel_err_untied_rows", "J_rel_err_all_rows",
                "J_tie_rows_excluded")})
        # the transfer world (CVX instantiation): every input and dtype
        tv = transfer_err[k]
        errs[k]["transfer"] = {
            "D_max_rel_err_all_rows": max(e["D_rel_err_all_rows"]
                                          for e in tv),
            "D_max_rel_err_convex_pairs": max(e["D_rel_err_convex_pairs"]
                                              for e in tv),
            "D_rows_over_tol": max(e["D_rows_over_tol"] for e in tv),
            **timing_t[k]}
        if k == "cast_seg":
            errs[k]["transfer"].update({f: max(e[f] for e in tv) for f in (
                "J_rel_err_untied_rows", "J_rel_err_untied_convex_pairs",
                "J_tie_rows_excluded", "J_tie_rows_convex_pairs")})
    # the routes: the probe's value error against the plain route, on the
    # untied rows and on every row, worst over float32 and float64
    for k, v in route_err.items():
        errs[k] = {"max_abs_err": max(e["D_abs_err_all_rows"] for e in v),
                   "max_abs_err_of": "route value, all rows",
                   "D_max_rel_err_untied_rows": max(
                       e["D_rel_err_untied_rows"] for e in v),
                   "D_max_rel_err_all_rows": max(e["D_rel_err_all_rows"]
                                                 for e in v),
                   "tie_rows": max(e["tie_rows"] for e in v),
                   "launches_are": "K4 / K4v / K5 launches that ran it",
                   "shapes_rows_n1_n2": timing[k]["shapes"]}
    for k in ("cast_seg", "cast_seg_value", "cast_sweep"):
        errs[k].update(sources=cast_sources, attributes={
            f"{k}{sfx}{d}": cast_attrs[f"{k}{sfx}{d}"]
            for sfx in ("_", "_cvx_") for d in ("f32", "f64")})
    for k in ("convex_feature", "convex_fw"):
        errs[k]["sources"] = cast_sources
    # K7 / K7v: the values' error on every row and K7's Jacobian's, worst
    # over float32 and float64, every world; the times at arm7's table
    # world (7f's shape), the spherebot's with simple_collision's launches
    for k, v in disc_err.items():
        errs[k] = {"max_abs_err": max(e["D_abs_err_all_rows"] for e in v),
                   "max_abs_err_of": "D, all rows",
                   "D_max_rel_err_all_rows": max(e["D_rel_err_all_rows"]
                                                 for e in v),
                   "D_rows_over_tol": max(e["D_rows_over_tol"] for e in v),
                   "worlds": ["spherebot (128 x 1 step)",
                              "arm7 table (128 x 30 steps x 28 pairs)",
                              "boxbot (128 x 30 steps, 1 pair)",
                              "arm7 + 450 table spheres (128 x 4 steps x "
                              "3178 pairs; float64's tables in global "
                              "memory)"],
                   "ms_is": "the bare launch on the device clock "
                   "(device_ms); wrapper_ms the entry point's CUDA events",
                   "wrapper_ms": timing[k]["wrapper_ms"],
                   "one_slot_ms": timing[k]["one_slot_ms"],
                   "shape": timing[k]["shape"],
                   "spherebot": dict(
                       timing[k]["spherebot"],
                       launches=bench_launches["simple_collision"][k],
                       launches_are="simple_collision's run_benchmarks "
                       "entry (one cold and three warm runs)"),
                   "launches_are": "phase 7f's three warm runs (the "
                   "spherebot's simple_collision beside them)",
                   "blocks": {f"{kk}_{str(d)[6:]}": list(b) for (kk, d), b
                              in DISC_BLOCKS.items() if kk == k},
                   "library_ms_null_because": "no one PyTorch call computes "
                   "FK and the pair distances",
                   "sources": [f"trajopt_tpu_torch/csrc/{f}" for f in (
                       "disc_dist.cu", "disc_block.cuh", "cast_block.cuh",
                       "collision.cuh")],
                   "attributes": {f"{k}{g}_{d}": cast_attrs[f"{k}{g}_{d}"]
                                  for g in ("", "_global")
                                  for d in ("f32", "f64")}}
        if k == "disc_dist":
            errs[k].update({f: max(e[f] for e in v) for f in (
                "J_rel_err_untied_rows", "J_rel_err_all_rows")})
    # the instantiations this slice added: K4 at n_dof 9 (the rail) and
    # K4 / K4v at n_sub 8 (planning), K6 at b 9 (the rail)
    for k in ("cast_seg", "cast_seg_value"):
        inst = {}
        for label, what in (("planning_nsub8", "n_sub 8"),
                            ("rail_nd9", "n_dof 9")):
            if (k, label) not in new_err:
                continue
            v = new_err[(k, label)]
            inst[label] = dict(
                timing[f"{k}_{label}"], instantiation=what,
                D_max_rel_err_all_rows=max(e["D_rel_err_all_rows"]
                                           for e in v),
                D_rows_over_tol=max(e["D_rows_over_tol"] for e in v),
                launches=bench_launches[
                    "planning" if label == "planning_nsub8"
                    else "redundant_rail"][
                    "cast_seg_nd9" if label == "rail_nd9" else k])
            if k == "cast_seg":
                inst[label].update({f: max(e[f] for e in v) for f in (
                    "J_rel_err_untied_rows", "J_tie_rows_excluded")})
        if k == "cast_seg":
            inst["rail_nd9"]["attributes"] = {
                f"cast_seg_ceil_{d}": cast_attrs[f"cast_seg_ceil_{d}"]
                for d in ("f32", "f64")}
        errs[k]["instantiations"] = inst
    # the box slice: K4 / K4v / K5 at n_dof 2 on boxbot (the box-box SAT
    # sweep; K4 at the n_dof ceiling), launched on 8b's three warm runs
    # (K5: its gate)
    for k in ("cast_seg", "cast_seg_value", "cast_sweep"):
        v = box_err[k]
        b_inst = dict(
            timing[f"{k}_boxbot_nd2"], instantiation="n_dof 2, boxbot",
            D_max_rel_err_all_rows=max(e["D_rel_err_all_rows"] for e in v),
            D_rows_over_tol=max(e["D_rows_over_tol"] for e in v),
            launches=box_paths["box_cast_t30"][
                "cast_seg_nd2" if k == "cast_seg" else k],
            launches_are="phase 8b's three warm runs and its gate")
        if k == "cast_seg":
            b_inst.update({f: max(e[f] for e in v) for f in (
                "J_rel_err_untied_rows", "J_tie_rows_excluded")},
                attributes={f"cast_seg_ceil_{d}": cast_attrs[
                    f"cast_seg_ceil_{d}"] for d in ("f32", "f64")})
        errs[k].setdefault("instantiations", {})["boxbot_nd2"] = b_inst
    for k in ("disc_dist", "disc_dist_value"):
        errs[k]["boxbot_world"] = dict(
            disc_time[k, "boxbot"],
            launches_are="none on a path: phase 2e's check (box_cast has "
            "no discrete term)")
    k6_b9 = [r for r in k6_recs if r["qp"] == "rail_qp1"]
    errs["ipm_banded"]["instantiations"] = {"b9": dict(
        timing["ipm_banded_b9"], launches=bench_launches["redundant_rail"][
            "ipm_banded_b9"],
        dx_max_rel_err_equal_lanes={r["dtype"]: r["dx_rel_err_equal_lanes"]
                                    for r in k6_b9},
        lanes_apart={r["dtype"]: r["lanes_apart"] for r in k6_b9},
        attributes={d: ipm_attrs[f"{d}_b9"] for d in ("f32", "f64")})}
    errs["ipm_banded"]["instantiations"]["b8"] = dict(
        timing["ipm_banded_b8"],
        launches=json_paths["json_table_time"]["ipm_banded_b8"],
        dx_max_rel_err_equal_lanes={
            r["dtype"]: r["dx_rel_err_equal_lanes"] for r in k6_recs
            if r["qp"] == "json_table_time_qp1"},
        lanes_apart={r["dtype"]: r["lanes_apart"] for r in k6_recs
                     if r["qp"] == "json_table_time_qp1"},
        attributes=b8_attrs["ipm_banded_b8"],
        launches_are="phase 7b's three warm runs")
    # K6 at b 2 (8b's first QP) and b 3 (time_parameterized's form), and on
    # the IPM fixture at every other block size the box slice instantiated
    for b_t, qname, path, pkey in (
            (2, "box_cast_t30_qp1", "box_cast_t30", "8b's three warm runs"),
            (3, "time_parameterized_qp1", "spherebot_time_parameterized",
             "8c's time_parameterized run")):
        recs_b = [r for r in k6_recs if r["qp"] == qname]
        errs["ipm_banded"]["instantiations"][f"b{b_t}"] = dict(
            timing[f"ipm_banded_b{b_t}"],
            launches=box_paths[path][f"ipm_banded_b{b_t}"],
            launches_are=pkey,
            dx_max_rel_err_equal_lanes={r["dtype"]: r["dx_rel_err_equal_lanes"]
                                        for r in recs_b},
            lanes_apart={r["dtype"]: r["lanes_apart"] for r in recs_b},
            attributes={d: ipm_attrs[f"{d}_b{b_t}"] for d in ("f32", "f64")})
    errs["ipm_banded"]["instantiations"]["new_blocks"] = {
        f"{r['qp']}_{r['dtype']}": {
            "b": r["b"], "dx_rel_err_equal_lanes": r["dx_rel_err_equal_lanes"],
            "lanes_apart": r["lanes_apart"],
            "objective_gap_over_eps_g_max": r["objective_gap_over_eps_g_max"]}
        for r in k6_recs if r["qp"].startswith(("fixture_b",
                                                "box_cast_t30_qp1_b"))}
    # K1-K3 at b 8: on no path as kernels of their own (K11 runs K2 /
    # K3's block steps as device functions on 7c(i)'s dense rows)
    for k in ("bb_quad", "btd_factor", "btd_solve"):
        errs[k]["instantiations"] = {"b8": dict(
            b8["timing"][k], checks=b8["checks"][k],
            launches=json_paths["json_timed_vel"].get(f"{k}_b8", 0),
            launches_are="phase 7c(i)'s warm run (none: K11 runs them as "
            "device functions)" if k != "bb_quad"
            else "none: K1 runs inside K6 on every path",
            attributes=b8_attrs[k if k == "bb_quad" else f"{k}_b8"])}
    # K2 / K3 at b 2, 3 and 9: on no path as kernels of their own (the
    # dense-row paths there are T=1 or time-coupled: K11's dense route)
    for b_t, kb in k123_new.items():
        for k in ("btd_factor", "btd_solve"):
            errs[k]["instantiations"][f"b{b_t}"] = dict(
                kb["timing"][k], checks=kb["checks"][k],
                launches=sum(v.get(f"{k}_b{b_t}", 0)
                             for v in box_paths.values()),
                launches_are="phases 8a-8c (none: no banded dense-row QP "
                "there)")
    errs["ipm_banded"]["batched_qp_solves_by_path"]["benchmarks"] = sum(
        bench_qp.values())
    def by_path(name):
        return {"benchmarks": launches_b[name],
                "free_slice": launches_s[name],
                "flagship": launches_f[name],
                "pick_and_place": launches_p[name],
                "cartesian_waypoints": cart_paths["cartesian_waypoints"][name],
                "ik_goal": cart_paths["ik_goal"][name],
                **{k: v[name] for k, v in json_paths.items()},
                **{k: v[name] for k, v in box_paths.items()}}

    emit({"phase": "total", "seconds": time.perf_counter() - _T0,
          "build_s": build_s, "limit_s": 1200})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source[name],
         "replaces": replaces[name], "launches": launches[name],
         "launches_by_path": by_path(name),
         "ok": True, **errs[name],
         "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound_ms"],
         "bound_by": timing[name]["bound_by"],
         "library_ms": timing[name]["library_ms"]}
        for name in replaces] + [
        dict(entry, launches_by_path=by_path(name))
        for name, entry in {**cart_entries, **json_entries}.items()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
