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
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .collision.decompose import fit_hull
from .collision.world import build_collision_world
from .models import arm7, arm7_wall
from .ops.qp import QPSettings
from .problem.trajectory import TrajProblemBuilder, interpolated_init, stack_data
from .solver.types import SQPParams
from .terms.cartesian import upright_term
from .terms.collision import CastDistancePre, cast_collision_term
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
