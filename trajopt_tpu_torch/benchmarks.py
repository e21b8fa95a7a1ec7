"""Flagship benchmark problems (``trajopt_tpu/benchmarks.py``).

``make_glass_upright`` is the glass-upright flagship: a 7-DoF capsule arm
over a table box, joint_vel smoothing, one shared swept-collision
pipeline feeding a hinge cost (margin 0.025, coeff 20) and an INEQ
constraint (margin 0.005, coeff 1), an upright equality constraint at
every step, a joint goal constraint and a fixed start, over a 30-step
horizon.  ``make_glass_upright_free`` is the same scene without its two
cast-collision terms.  The random draws run in the reference's order, so
every lane's start, goal and initial trajectory equal the reference's
lanes for the same seed.

``solve_pick_and_place`` is BASELINE config 4: two chained problems over
the ``arm7_wall`` scene — the approach to the grasp without a payload, then
the transfer over the divider wall with a convex payload attached to the
tool, seeded by the approach's solved last step (``make_pick_and_place``,
``chain_transfer``).

``run_benchmarks`` runs the reference's four solve benchmarks
(``_BENCHES``; the upstream's ``BM_TRAJOPT_*_SOLVE``): ``simple_collision``
(a 2-DoF spherebot, one step, discrete collision, the dense-row QP),
``planning`` (arm7 around the table, T=6, swept collision at n_sub=8),
``glass_upright`` (the flagship) and ``redundant_rail`` (BASELINE config 5:
arm9_rail, 9 DoF, two of them prismatic, T=15).  On the CPU:
``run_benchmarks(device="cpu")``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .collision.decompose import fit_hull
from .collision.world import build_collision_world
from .models import arm7, arm7_wall, arm9_rail, spherebot
from .ops.qp import QPSettings
from .problem.trajectory import TrajProblemBuilder, interpolated_init, stack_data
from .solver.types import SQPParams
from .terms.cartesian import upright_term
from .terms.collision import (CastDistancePre, cast_collision_term,
                              discrete_collision_term)
from .terms.joint import joint_pos_term, joint_vel_term
from .utils.lanes import tree_map

Q_START = np.array([-1.1, 1.6, 0.0, -0.8, 0.0, -0.8, 0.0])
Q_GOAL = np.array([1.1, 1.6, 0.0, -0.8, 0.0, -0.8, 0.0])


def bench_params(dtype=torch.float32) -> SQPParams:
    """Throughput-tuned parameters (reference tolerance contract) with the
    interior-point inner solver."""
    return SQPParams(
        max_total_qp_solves=30,
        qp=QPSettings(eps_abs=1e-4, eps_rel=1e-6, max_iter=1000,
                      check_interval=25, adaptive_rho_interval=100,
                      solver="ipm", max_ipm_iter=16),
    )


def make_glass_upright_free(batch: int, n_steps: int = 30,
                            dtype=torch.float32, seed: int = 0,
                            device="cuda"):
    """The flagship without collision terms; returns (spec, batched
    ProblemData on ``device``, chain)."""
    spec, data, chain, _ = _glass_upright(batch, n_steps, dtype, seed,
                                          device, collision=False)
    return spec, data, chain


def make_glass_upright(batch: int, n_steps: int = 30, dtype=torch.float32,
                       n_sub: int = 2, seed: int = 0, device="cuda"):
    """The full flagship; returns (spec, batched ProblemData on
    ``device``, chain, world).  ``n_sub=2``: one exact hull-of-two-poses
    cast per step gap."""
    return _glass_upright(batch, n_steps, dtype, seed, device,
                          collision=True, n_sub=n_sub)


def _glass_upright(batch, n_steps, dtype, seed, device, collision,
                   n_sub=2):
    npdt = np.float64 if dtype == torch.float64 else np.float32
    model, chain = arm7()
    T, D = n_steps, chain.n_dof

    b = TrajProblemBuilder(chain, T, device=device)
    b.add_cost(joint_vel_term("jvel", T, D),
               {"targets": np.zeros(D, npdt), "coeffs": np.full(D, 5.0, npdt)})
    world = None
    if collision:
        # one shared swept-distance pipeline feeds both collision terms
        world = build_collision_world(model, chain)
        cpre = CastDistancePre(world, T, n_sub=n_sub)
        b.add_cost(cast_collision_term("coll", world, T, n_sub=n_sub,
                                       pre=cpre),
                   {"margins": np.asarray(0.025, npdt),
                    "coeffs": np.asarray(20.0, npdt)})
        b.add_constraint(
            cast_collision_term("coll_cnt", world, T, n_sub=n_sub,
                                is_constraint=True, pre=cpre),
            {"margins": np.asarray(0.005, npdt),
             "coeffs": np.asarray(1.0, npdt)})
    b.add_constraint(
        joint_pos_term("goal", T, D, first_step=T - 1, last_step=T - 1,
                       is_constraint=True),
        {"targets": np.asarray(Q_GOAL, npdt), "coeffs": np.ones(D, npdt)})
    b.add_constraint(
        upright_term("upright", chain, T, "tool"),
        {"coeffs": np.ones(2, npdt)})
    b.fix_timestep(0)

    rng = np.random.default_rng(seed)
    yaw_mask = np.array([1.0, 0, 0, 0, 0, 0, 1.0])  # joints 0/6 spin about z
    datas = []
    for _ in range(batch):
        # start/goal perturbed on the yaw joints only; a mid-trajectory
        # bump breaks uprightness and the free last step starts offset from
        # the goal target, so every constraint is active at the start
        start = Q_START + rng.uniform(-0.15, 0.15, D) * yaw_mask
        goal = Q_GOAL + rng.uniform(-0.15, 0.15, D) * yaw_mask
        init = np.asarray(interpolated_init(np.asarray(start, npdt),
                                            np.asarray(goal, npdt), T))
        bump = rng.uniform(-0.12, 0.12, D) * np.array([0, 1, 1, 1, 1, 1, 0])
        phase = np.sin(np.pi * np.arange(T) / (T - 1))[:, None]
        init = init + (phase * bump[None, :]).astype(init.dtype)
        init[0] = start  # step 0 is pinned by fix_timestep(0)
        init[T - 1] = goal + rng.uniform(-0.05, 0.05, D)
        spec, data = b.build(init)
        cnt = data.cnt_params[:-2] + (
            {"targets": torch.as_tensor(np.asarray(goal, npdt),
                                        device=b.device),
             "coeffs": torch.ones(D, dtype=dtype, device=b.device)},
            {"coeffs": torch.ones(2, dtype=dtype, device=b.device)},
        )
        data = data._replace(cnt_params=cnt)
        datas.append(data)
    batch_data = tree_map(
        lambda t: t.to(dtype) if t.is_floating_point() else t,
        stack_data(datas))
    return spec, batch_data, chain, world


# ---------------------------------------------------------------------------
# BASELINE config 4: pick-and-place (``trajopt_tpu/benchmarks.py:219-345``)
# ---------------------------------------------------------------------------

# home on the pick side; grasp / place beside the divider wall
Q_PNP_HOME = np.array([-1.1, 1.6, 0.0, -0.8, 0.0, -0.8, 0.0])
Q_PNP_GRASP = np.array([-0.736, 2.03, -0.133, -0.948, -0.045, -1.244, 0.0])
Q_PNP_PLACE = np.array([0.736, 2.03, 0.133, -0.948, 0.045, -1.244, 0.0])

# the grasped payload: a 0.1 x 0.1 x 0.18 box hull above the tool flange
PNP_PAYLOAD_VERTS = np.array(
    [[sx * 0.05, sy * 0.05, z]
     for sx in (-1, 1) for sy in (-1, 1) for z in (0.02, 0.20)])


def _pnp_scene():
    """(model, chain, world_free, world_att): the wall scene without and
    with the payload hull attached to the tool (the l6 / tool and base / l2
    pairs disabled, as the reference does)."""
    model, chain = arm7_wall()
    world_free = build_collision_world(model, chain)
    world_att = build_collision_world(
        model, chain, attachments=[("tool", fit_hull(PNP_PAYLOAD_VERTS))],
        extra_disabled={tuple(sorted(("l6", "tool"))),
                        tuple(sorted(("base", "l2")))})
    return model, chain, world_free, world_att


def _pnp_builder(world, chain, T, npdt, n_sub, goal, device):
    D = chain.n_dof
    b = TrajProblemBuilder(chain, T, device=device)
    b.add_cost(joint_vel_term("jvel", T, D),
               {"targets": np.zeros(D, npdt), "coeffs": np.full(D, 5.0, npdt)})
    cpre = CastDistancePre(world, T, n_sub=n_sub)
    b.add_cost(cast_collision_term("coll", world, T, n_sub=n_sub, pre=cpre),
               {"margins": np.asarray(0.025, npdt),
                "coeffs": np.asarray(20.0, npdt)})
    b.add_constraint(
        cast_collision_term("coll_cnt", world, T, n_sub=n_sub,
                            is_constraint=True, pre=cpre),
        {"margins": np.asarray(0.005, npdt), "coeffs": np.asarray(1.0, npdt)})
    b.add_constraint(
        joint_pos_term("goal", T, D, first_step=T - 1, last_step=T - 1,
                       is_constraint=True),
        {"targets": np.asarray(goal, npdt), "coeffs": np.ones(D, npdt)})
    b.fix_timestep(0)
    return b


def _pnp_batch(b, inits, goals, dtype, npdt):
    """Build one lane per (init, goal) and stack them in ``dtype``."""
    D = len(goals[0])
    datas = []
    for init, goal in zip(inits, goals):
        spec, data = b.build(init)
        datas.append(data._replace(cnt_params=(
            data.cnt_params[0],
            {"targets": torch.as_tensor(np.asarray(goal, npdt),
                                        device=b.device),
             "coeffs": torch.ones(D, dtype=dtype, device=b.device)})))
    return spec, tree_map(
        lambda t: t.to(dtype) if t.is_floating_point() else t,
        stack_data(datas))


def make_pick_and_place(batch: int, n_steps: int = 12, dtype=torch.float32,
                        n_sub: int = 2, seed: int = 0, device="cuda"):
    """The approach phase's batch, (spec, data on ``device``, scene); the
    scene dict carries what ``chain_transfer`` needs.  Each lane's grasp and
    place are yaw-perturbed (joints 0 and 6), drawn in the reference's
    order."""
    device = resolve_device(device)
    npdt = np.float64 if dtype == torch.float64 else np.float32
    _, chain, world_free, world_att = _pnp_scene()
    T, D = n_steps, chain.n_dof
    rng = np.random.default_rng(seed)
    yaw = np.array([1, 0, 0, 0, 0, 0, 1])
    grasps, places, inits = [], [], []
    for _ in range(batch):
        grasp = Q_PNP_GRASP + rng.uniform(-0.05, 0.05, D) * yaw
        places.append(Q_PNP_PLACE + rng.uniform(-0.05, 0.05, D) * yaw)
        grasps.append(grasp)
        inits.append(interpolated_init(np.asarray(Q_PNP_HOME, npdt),
                                       np.asarray(grasp, npdt), T))
    bA = _pnp_builder(world_free, chain, T, npdt, n_sub, Q_PNP_GRASP, device)
    specA, dataA = _pnp_batch(bA, inits, grasps, dtype, npdt)
    scene = {"chain": chain, "world_free": world_free, "world_att": world_att,
             "T": T, "D": D, "dtype": dtype, "n_sub": n_sub,
             "device": device, "grasps": np.asarray(grasps),
             "places": np.asarray(places)}
    return specA, dataA, scene


def chain_transfer(scene, qa_end: np.ndarray):
    """The transfer phase's batch (spec, data), seeded by the approach's
    solved last steps ``qa_end`` (batch, D) (numpy): step 0 is fixed
    there, the straight line to each lane's place is the initial
    trajectory."""
    dtype = scene["dtype"]
    npdt = np.float64 if dtype == torch.float64 else np.float32
    T = scene["T"]
    bB = _pnp_builder(scene["world_att"], scene["chain"], T, npdt,
                      scene["n_sub"], Q_PNP_PLACE, scene["device"])
    inits = [interpolated_init(np.asarray(q, npdt),
                               np.asarray(place, npdt), T)
             for q, place in zip(qa_end, scene["places"])]
    return _pnp_batch(bB, inits, list(scene["places"]), dtype, npdt)


def solve_pick_and_place(batch: int, n_steps: int = 12, dtype=torch.float32,
                         n_sub: int = 2, seed: int = 0, params=None,
                         phase_qp_solves: int = 8, device="cuda"):
    """The chained pick-and-place solve: (approach result, transfer
    result, scene).  The approach's solved last steps are read back to the
    host to seed the transfer."""
    from .solver.sqp import solve_batch_compact

    params = params or bench_params()
    specA, dataA, scene = make_pick_and_place(batch, n_steps, dtype, n_sub,
                                              seed, device)
    resA = solve_batch_compact(specA, dataA, params,
                               phase_qp_solves=phase_qp_solves,
                               device=scene["device"])
    qa_end = resA.x.reshape(batch, n_steps, -1)[:, -1].cpu().numpy()
    specB, dataB = chain_transfer(scene, qa_end)
    resB = solve_batch_compact(specB, dataB, params,
                               phase_qp_solves=phase_qp_solves,
                               device=scene["device"])
    return resA, resB, scene


def _stack(datas, dtype):
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    stack_data(datas))


def _goal(goal, D, dtype, npdt, device):
    return {"targets": torch.as_tensor(np.asarray(goal, npdt), device=device),
            "coeffs": torch.ones(D, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# The reference's solve benchmarks (``trajopt_tpu/benchmarks.py:147-207``)
# ---------------------------------------------------------------------------


def make_simple_collision(batch: int, dtype=torch.float64, seed: int = 0,
                          device="cuda"):
    """2-DoF spherebot vs a sphere obstacle, one step (simple_collision_test
    semantics; BM_TRAJOPT_SIMPLE_COLLISION_SOLVE): a discrete-collision
    hinge cost (margin 0.3) and INEQ constraint (margin 0.2) and a joint
    position cost; each lane starts near (-0.75, 0.75).  Returns (spec,
    batched data on ``device``, chain, world)."""
    npdt = np.float64 if dtype == torch.float64 else np.float32
    model, chain = spherebot()
    world = build_collision_world(model, chain)
    b = TrajProblemBuilder(chain, 1, device=device)
    b.add_cost(discrete_collision_term("coll_cost", world, 1),
               {"margins": np.asarray(0.3, npdt),
                "coeffs": np.asarray(1.0, npdt)})
    b.add_cost(joint_pos_term("jpos", 1, 2),
               {"targets": np.zeros(2, npdt), "coeffs": np.ones(2, npdt)})
    b.add_constraint(discrete_collision_term("coll_cnt", world, 1,
                                             is_constraint=True),
                     {"margins": np.asarray(0.2, npdt),
                      "coeffs": np.asarray(1.0, npdt)})
    rng = np.random.default_rng(seed)
    datas = []
    for _ in range(batch):
        q0 = np.array([-0.75, 0.75]) + rng.uniform(-0.05, 0.05, 2)
        spec, data = b.build(np.asarray(q0, npdt)[None, :])
        datas.append(data)
    return spec, _stack(datas, dtype), chain, world


def make_planning(batch: int, n_steps: int = 6, dtype=torch.float32,
                  n_sub: int = 8, seed: int = 0, device="cuda"):
    """arm7 moving around the table: joint_vel cost, one swept-collision
    cost at ``n_sub`` substates (its own CastDistancePre) and a joint goal
    constraint, step 0 fixed (arm_around_table semantics;
    BM_TRAJOPT_PLANNING_SOLVE).  Each lane's goal is Q_GOAL perturbed by
    up to 0.1 per joint.  Returns (spec, data, chain, world)."""
    npdt = np.float64 if dtype == torch.float64 else np.float32
    model, chain = arm7()
    world = build_collision_world(model, chain)
    T, D = n_steps, chain.n_dof
    b = TrajProblemBuilder(chain, T, device=device)
    b.add_cost(joint_vel_term("jvel", T, D),
               {"targets": np.zeros(D, npdt), "coeffs": np.ones(D, npdt)})
    b.add_cost(cast_collision_term("coll", world, T, n_sub=n_sub),
               {"margins": np.asarray(0.025, npdt),
                "coeffs": np.asarray(20.0, npdt)})
    b.add_constraint(
        joint_pos_term("goal", T, D, first_step=T - 1, last_step=T - 1,
                       is_constraint=True),
        {"targets": np.asarray(Q_GOAL, npdt), "coeffs": np.ones(D, npdt)})
    b.fix_timestep(0)
    rng = np.random.default_rng(seed)
    datas = []
    for _ in range(batch):
        goal = Q_GOAL + rng.uniform(-0.1, 0.1, D)
        init = interpolated_init(np.asarray(Q_START, npdt),
                                 np.asarray(goal, npdt), T)
        spec, data = b.build(init)
        datas.append(data._replace(
            cnt_params=(_goal(goal, D, dtype, npdt, b.device),)))
    return spec, _stack(datas, dtype), chain, world


# ---------------------------------------------------------------------------
# BASELINE config 5: swept collision with redundant external axes — 9 DoF
# (a 2-axis prismatic gantry under the 7-DoF arm), the arm carried past a
# table the straight-line motion sweeps through
# (``trajopt_tpu/benchmarks.py:354-401``)
# ---------------------------------------------------------------------------

Q9_START = np.array([-0.85, 0.0, -1.1, 1.6, 0.0, -0.8, 0.0, -0.8, 0.0])
Q9_GOAL = np.array([0.85, 0.0, 1.1, 1.6, 0.0, -0.8, 0.0, -0.8, 0.0])


def make_redundant_rail(batch: int, n_steps: int = 15, dtype=torch.float32,
                        n_sub: int = 2, seed: int = 0, device="cuda"):
    """The 9-DoF rail: joint_vel cost, one shared swept-collision pipeline
    feeding a hinge cost (margin 0.025, coeff 20) and an INEQ constraint
    (margin 0.005), a joint goal constraint, step 0 fixed; each lane's
    start and goal perturbed on the rail-y and yaw joints.  Returns (spec,
    data, chain, world)."""
    npdt = np.float64 if dtype == torch.float64 else np.float32
    model, chain = arm9_rail()
    world = build_collision_world(model, chain)
    T, D = n_steps, chain.n_dof
    b = TrajProblemBuilder(chain, T, device=device)
    b.add_cost(joint_vel_term("jvel", T, D),
               {"targets": np.zeros(D, npdt), "coeffs": np.full(D, 5.0, npdt)})
    cpre = CastDistancePre(world, T, n_sub=n_sub)
    b.add_cost(cast_collision_term("coll", world, T, n_sub=n_sub, pre=cpre),
               {"margins": np.asarray(0.025, npdt),
                "coeffs": np.asarray(20.0, npdt)})
    b.add_constraint(
        cast_collision_term("coll_cnt", world, T, n_sub=n_sub,
                            is_constraint=True, pre=cpre),
        {"margins": np.asarray(0.005, npdt), "coeffs": np.asarray(1.0, npdt)})
    b.add_constraint(
        joint_pos_term("goal", T, D, first_step=T - 1, last_step=T - 1,
                       is_constraint=True),
        {"targets": np.asarray(Q9_GOAL, npdt), "coeffs": np.ones(D, npdt)})
    b.fix_timestep(0)
    rng = np.random.default_rng(seed)
    mask = np.array([0, 1, 1, 0, 0, 0, 0, 0, 1.0])  # rail-y + yaw joints
    datas = []
    for _ in range(batch):
        start = Q9_START + rng.uniform(-0.1, 0.1, D) * mask
        goal = Q9_GOAL + rng.uniform(-0.1, 0.1, D) * mask
        init = interpolated_init(np.asarray(start, npdt),
                                 np.asarray(goal, npdt), T)
        spec, data = b.build(init)
        datas.append(data._replace(cnt_params=(
            data.cnt_params[0], _goal(goal, D, dtype, npdt, b.device))))
    return spec, _stack(datas, dtype), chain, world


_BENCHES = {
    "simple_collision": lambda batch, device: make_simple_collision(
        batch, dtype=torch.float32, device=device),
    "planning": lambda batch, device: make_planning(batch, device=device),
    "glass_upright": lambda batch, device: make_glass_upright(
        batch, device=device),
    "redundant_rail": lambda batch, device: make_redundant_rail(
        batch, device=device),
}


def run_benchmarks(names=None, batch: int = 32, repeats: int = 3,
                   device="cuda", results: Optional[dict] = None):
    """Run the named benchmark families: one cold solve of the batch, then
    ``repeats`` warm ones, each through ``solve_batch`` and ending in a
    device synchronization.  Returns a list of JSON-able dicts {name,
    batch, wall_s, solves_per_sec, us_per_solve, converged,
    mean_qp_solves} (the reference's keys and rounding).  ``results``, when
    given, receives {name: (SQPResult of the last warm run, world)}."""
    import time

    from .solver.sqp import solve_batch
    from .solver.types import CONVERGED

    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = []
    for name in (names or list(_BENCHES)):
        spec, data, _, world = _BENCHES[name](batch, dev)
        params = bench_params()
        res = solve_batch(spec, data, params, device=dev)
        sync()  # cold
        t0 = time.perf_counter()
        for _ in range(repeats):
            res = solve_batch(spec, data, params, device=dev)
            sync()
        dt = (time.perf_counter() - t0) / repeats
        ok = int((res.status == CONVERGED).sum())
        out.append({
            "name": name, "batch": batch, "wall_s": round(dt, 4),
            "solves_per_sec": round(ok / dt, 2),
            "us_per_solve": round(1e6 * dt / max(ok, 1), 1),
            "converged": ok,
            "mean_qp_solves": round(float(
                res.n_qp_solves.double().mean()), 2),
        })
        if results is not None:
            results[name] = (res, world)
    return out
