"""PyTorch port vs JAX reference, end to end, float64 on the CPU:

- the glass-upright flagship without its collision terms
  (``benchmarks.make_glass_upright_free``) through ``solve_batch_compact``
  on the banded interior-point path at T=6, batch 4; the reference scene is
  built here from the JAX package's own terms with the same random draws;
- the full flagship (``make_glass_upright``, both cast-collision terms)
  at T=6, batch 2, through the port's ``solve_batch`` against the
  reference's ``_solve`` under one ``jit(vmap(...))`` (one compile);
- pick-and-place (``solve_pick_and_place``: the approach, then the
  transfer with the convex payload over the wall) at T=7, batch 2, against
  the reference's ``make_pick_and_place`` / ``chain_transfer`` scenes
  through ``_solve`` under one ``jit(vmap(...))`` per phase.

Per-lane status, QP-solve count and SQP iterations must be equal and x
agree to 1e-6 (the same float64 iterate sequence; sum orders differ inside
the QP).  The pick-and-place transfer is more sensitive than that: the
reference's own x moves by up to ~5e-6 when its x0 moves by one ulp, so
its x is held within twice the largest such move (3 seeded draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.benchmarks import Q_GOAL, Q_START
from trajopt_tpu.benchmarks import chain_transfer as j_chain_transfer
from trajopt_tpu.benchmarks import make_pick_and_place as j_make_pnp
from trajopt_tpu.benchmarks import make_glass_upright as j_make_full
from trajopt_tpu.benchmarks import bench_params as j_bench_params
from trajopt_tpu.models import arm7 as j_arm7
from trajopt_tpu.problem.trajectory import TrajProblemBuilder, interpolated_init
from trajopt_tpu.problem.trajectory import stack_data as j_stack
from trajopt_tpu.solver.sqp import _solve as j_solve_lane
from trajopt_tpu.solver.sqp import solve_batch_compact as j_solve
from trajopt_tpu.terms.cartesian import upright_term
from trajopt_tpu.terms.joint import joint_pos_term, joint_vel_term
from trajopt_tpu_torch.benchmarks import (bench_params, make_glass_upright,
                                          make_glass_upright_free,
                                          solve_pick_and_place)
from trajopt_tpu_torch.convert import problem_data_from_numpy
from trajopt_tpu_torch.solver.sqp import solve_batch, solve_batch_compact
from trajopt_tpu_torch.solver.types import CONVERGED
from trajopt_tpu_torch.terms.collision import trajectory_in_collision

T, BATCH = 6, 4
X_TOL = 1e-6


def _reference_scene(batch, n_steps, seed=0):
    """make_glass_upright (benchmarks.py:62-144) minus its two cast-
    collision terms, from the JAX package's own pieces."""
    _, chain = j_arm7()
    D = chain.n_dof
    dt = np.float64
    b = TrajProblemBuilder(chain, n_steps)
    b.add_cost(joint_vel_term("jvel", n_steps, D),
               {"targets": np.zeros(D, dt), "coeffs": np.full(D, 5.0, dt)})
    b.add_constraint(
        joint_pos_term("goal", n_steps, D, first_step=n_steps - 1,
                       last_step=n_steps - 1, is_constraint=True),
        {"targets": np.asarray(Q_GOAL, dt), "coeffs": np.ones(D, dt)})
    b.add_constraint(upright_term("upright", chain, n_steps, "tool"),
                     {"coeffs": np.ones(2, dt)})
    b.fix_timestep(0)
    rng = np.random.default_rng(seed)
    yaw_mask = np.array([1.0, 0, 0, 0, 0, 0, 1.0])
    datas = []
    for _ in range(batch):
        start = Q_START + rng.uniform(-0.15, 0.15, D) * yaw_mask
        goal = Q_GOAL + rng.uniform(-0.15, 0.15, D) * yaw_mask
        init = np.asarray(interpolated_init(start, goal, n_steps))
        bump = rng.uniform(-0.12, 0.12, D) * np.array([0, 1, 1, 1, 1, 1, 0])
        phase = np.sin(np.pi * np.arange(n_steps) / (n_steps - 1))[:, None]
        init = init + phase * bump[None, :]
        init[0] = start
        init[n_steps - 1] = goal + rng.uniform(-0.05, 0.05, D)
        spec, data = b.build(jnp.asarray(init))
        data = data._replace(cnt_params=(
            {"targets": np.asarray(goal, dt), "coeffs": np.ones(D, dt)},
            {"coeffs": np.ones(2, dt)}))
        datas.append(data)
    return spec, j_stack(datas)


@pytest.fixture(scope="module")
def scenes():
    jspec, jdata = _reference_scene(BATCH, T)
    tspec, tdata, _ = make_glass_upright_free(BATCH, n_steps=T,
                                              dtype=torch.float64,
                                              device="cpu")
    return jspec, jdata, tspec, tdata


def test_scene_data_equal(scenes):
    _, jdata, _, tdata = scenes
    ref = problem_data_from_numpy(jax.tree.map(np.asarray, jdata), "cpu",
                                  torch.float64)
    for a, b in zip(jax.tree.leaves(tuple(tdata)[:5], is_leaf=torch.is_tensor),
                    jax.tree.leaves(tuple(ref)[:5], is_leaf=torch.is_tensor)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("phase", [8, 1])
def test_slice_matches_reference(scenes, phase):
    """phase 8 mostly finishes in one phase; phase 1 resumes every lane
    mid-solve (ProblemData.resume) in a second phase."""
    jspec, jdata, tspec, tdata = scenes
    jres = j_solve(jspec, jdata, j_bench_params(), phase_qp_solves=phase)
    tres = solve_batch_compact(tspec, tdata, bench_params(),
                               phase_qp_solves=phase, device="cpu")
    np.testing.assert_array_equal(tres.status.numpy(), np.asarray(jres.status))
    np.testing.assert_array_equal(tres.n_qp_solves.numpy(),
                                  np.asarray(jres.n_qp_solves))
    np.testing.assert_array_equal(tres.sqp_it.numpy(), np.asarray(jres.sqp_it))
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x),
                               rtol=0, atol=X_TOL)
    np.testing.assert_allclose(tres.cnt_viols.numpy(),
                               np.asarray(jres.cnt_viols), rtol=0, atol=X_TOL)
    assert (tres.status == CONVERGED).all()
    assert float(tres.cnt_viols.max()) < 1e-4


def test_full_flagship_matches_reference():
    """The full flagship with its hinge cost and INEQ constraint over one
    shared cast pipeline: the lanes start in collision (gate < 0) and end
    CONVERGED and collision-free, lane for lane as the reference."""
    jspec, jdata, _, _ = j_make_full(2, n_steps=T, dtype=jnp.float64)
    tspec, tdata, _, world = make_glass_upright(2, n_steps=T,
                                                dtype=torch.float64,
                                                device="cpu")
    ref = problem_data_from_numpy(jax.tree.map(np.asarray, jdata), "cpu",
                                  torch.float64)
    for a, b in zip(jax.tree.leaves(tuple(tdata)[:3], is_leaf=torch.is_tensor),
                    jax.tree.leaves(tuple(ref)[:3], is_leaf=torch.is_tensor)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    jres = jax.jit(jax.vmap(lambda d: j_solve_lane(jspec, j_bench_params(),
                                                   d)))(jdata)
    tres = solve_batch(tspec, tdata, bench_params(), device="cpu")
    np.testing.assert_array_equal(tres.status.numpy(), np.asarray(jres.status))
    np.testing.assert_array_equal(tres.n_qp_solves.numpy(),
                                  np.asarray(jres.n_qp_solves))
    np.testing.assert_array_equal(tres.sqp_it.numpy(), np.asarray(jres.sqp_it))
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x),
                               rtol=0, atol=X_TOL)
    assert (tres.status == CONVERGED).all()
    gate0 = trajectory_in_collision(world, tdata.x0.reshape(2, T, 7))
    gate = trajectory_in_collision(world, tres.x.reshape(2, T, 7))
    assert (gate0 < 0).all() and (gate >= 0).all()


def test_pick_and_place_matches_reference():
    """Both chained phases lane for lane as the reference: equal statuses,
    QP counts and SQP iterations, x as the module docstring says; the
    transfer's step 0 is exactly the approach's last step, both phases
    end collision-free in their own worlds, and the straight-line transfer
    init passes through the wall (the solver had to plan over it)."""
    TP, B = 7, 2
    tA, tB, scene = solve_pick_and_place(B, n_steps=TP, dtype=torch.float64,
                                         device="cpu")
    params = j_bench_params()
    sA, dA, jscene = j_make_pnp(B, n_steps=TP, dtype=jnp.float64)
    jA = jax.jit(jax.vmap(lambda d: j_solve_lane(sA, params, d)))(dA)
    sB, dB = j_chain_transfer(jscene, np.asarray(jA.x).reshape(B, TP, -1)[:, -1])
    solve_b = jax.jit(jax.vmap(lambda d: j_solve_lane(sB, params, d)))
    jB = solve_b(dB)
    for t, j in ((tA, jA), (tB, jB)):
        np.testing.assert_array_equal(t.status.numpy(), np.asarray(j.status))
        np.testing.assert_array_equal(t.n_qp_solves.numpy(),
                                      np.asarray(j.n_qp_solves))
        np.testing.assert_array_equal(t.sqp_it.numpy(), np.asarray(j.sqp_it))
        assert (t.status == CONVERGED).all()
    np.testing.assert_allclose(tA.x.numpy(), np.asarray(jA.x), rtol=0,
                               atol=X_TOL)
    # the reference's own move under one ulp of change of the transfer's x0
    eps = np.finfo(np.float64).eps
    ulp = max(
        float(np.abs(np.asarray(solve_b(dB._replace(x0=dB.x0 * (
            1 + eps * np.random.default_rng(k).integers(-1, 2, dB.x0.shape)
        ))).x) - np.asarray(jB.x)).max()) for k in range(3))
    dx = float(np.abs(tB.x.numpy() - np.asarray(jB.x)).max())
    print(f"pick-and-place transfer: |dx| {dx:.3e}, the reference's own "
          f"one-ulp move {ulp:.3e}")
    assert dx <= max(X_TOL, 2.0 * ulp), (dx, ulp)
    XA, XB = tA.x.reshape(B, TP, 7), tB.x.reshape(B, TP, 7)
    assert torch.equal(XB[:, 0], XA[:, -1])
    assert (trajectory_in_collision(scene["world_free"], XA) >= 0).all()
    assert (trajectory_in_collision(scene["world_att"], XB) >= 0).all()
    a = torch.linspace(0.0, 1.0, TP, dtype=torch.float64)[:, None]
    straight = (1 - a) * XA[:, -1:] + a * torch.as_tensor(
        scene["places"])[:, None]
    assert (trajectory_in_collision(scene["world_att"], straight) < 0).all()
