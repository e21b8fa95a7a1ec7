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
"""

from __future__ import annotations

import numpy as np
import torch

from .collision.world import build_collision_world
from .models import arm7
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
