"""PyTorch port vs JAX reference: the 9-DoF rail (BASELINE config 5,
``benchmarks.make_redundant_rail``: arm9_rail, two prismatic gantry joints
under the 7-DoF arm, T=12, at most 60 QP solves, as
``tests/test_baseline_scenes.py::test_redundant_rail_9dof``), batch 2,
float64 on the CPU, through the reference's ``_solve`` under one
``jit(vmap(...))`` and the port's ``solve_batch`` (K6's plain loop at
b = 9, the cast pipeline's plain version at n_dof 9).

The rail's straight-line start moves only the carriage and the first
and last joints: about half of its cast rows hold a tied decision there
(``cast_ties``: 314 of 638 at x0, 247 of them rows whose two substates
lie at the same distance — arm links whose relative pose the gap does not
change, links gliding level over the table), and a tie is resolved by
rounding, which the two implementations do apart.  The reference itself
is not stable under that: moving its x0 by one ulp (RAIL_ULP_DRAWS seeded
draws) changes a lane's outcome (status and QP count) outright.  So, per
lane: where the reference's outcome is the same from x0 and every draw
(decided to the ulp), the port's must equal it with x within RAIL_X_TOL
of the reference's (chip_smoke's float64 flagship tolerance); where it is
not, the port's lane must end finite and not FAILED, and its outcome and
|dx| to the reference's runs are printed.  A lane the port reports
CONVERGED must be collision-free (swept check >= 0) with the carriage
across the span, and one lane at least must converge.  From x0 plus
seeded noise (0.02 per entry; step 0 stays pinned by its bounds) no
decision is tied, and the port must end lane for lane as the reference:
equal statuses and QP counts, x within RAIL_NOISY_X_TOL.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu import benchmarks as JB
from trajopt_tpu.solver.sqp import _solve as j_solve_lane
from trajopt_tpu_torch import benchmarks as TB
from trajopt_tpu_torch.solver.sqp import solve_batch
from trajopt_tpu_torch.solver.types import CONVERGED, FAILED
from trajopt_tpu_torch.terms.collision import trajectory_in_collision

T9, B = 12, 2
RAIL_X_TOL = 3e-5
RAIL_ULP_DRAWS = 3
RAIL_NOISY_X_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU solves are many small ops, where torch's intra-op
    threads only add overhead (the rail at T=12: 21.4 s of wall and 107 s
    of CPU with 8 threads, 13.9 s and 13.9 s with one), and the test run
    shares the machine's cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_redundant_rail_9dof():
    jspec, jdata, _, _ = JB.make_redundant_rail(B, n_steps=T9,
                                                dtype=jnp.float64)
    tspec, tdata, chain, world = TB.make_redundant_rail(
        B, n_steps=T9, dtype=torch.float64, device="cpu")
    assert chain.n_dof == 9 and tspec.n_x == T9 * 9
    np.testing.assert_array_equal(tdata.x0.numpy(), np.asarray(jdata.x0))
    solve_j = jax.jit(jax.vmap(lambda d: j_solve_lane(
        jspec, dataclasses.replace(JB.bench_params(), max_total_qp_solves=60),
        d)))
    eps = np.finfo(np.float64).eps
    runs = [solve_j(jdata)] + [solve_j(jdata._replace(x0=jdata.x0 * (
        1 + eps * np.random.default_rng(k).integers(-1, 2, jdata.x0.shape))))
        for k in range(RAIL_ULP_DRAWS)]
    tres = solve_batch(tspec, tdata, dataclasses.replace(
        TB.bench_params(), max_total_qp_solves=60), device="cpu")
    for lane in range(B):
        outcome = (int(tres.status[lane]), int(tres.n_qp_solves[lane]))
        ref = [(int(r.status[lane]), int(r.n_qp_solves[lane])) for r in runs]
        dxs = [float(np.abs(tres.x[lane].numpy()
                            - np.asarray(r.x[lane])).max()) for r in runs]
        decided = len(set(ref)) == 1
        print(f"lane {lane}: port {outcome}; reference from x0 and "
              f"{RAIL_ULP_DRAWS} one-ulp draws {ref}; |dx| {dxs}; "
              f"{'decided' if decided else 'not decided'} to the ulp")
        if decided:
            assert outcome == ref[0] and dxs[0] <= RAIL_X_TOL, (lane, dxs)
        assert outcome[0] != FAILED and bool(
            torch.isfinite(tres.x[lane]).all()), (lane, outcome)
    # off the straight line (seeded noise on every step; step 0 stays
    # pinned by its bounds) no decision is tied: lane for lane as the
    # reference
    noise = np.random.default_rng(11).normal(0.0, 0.02, jdata.x0.shape)
    jn = solve_j(jdata._replace(x0=jdata.x0 + noise))
    tn = solve_batch(tspec, tdata._replace(x0=tdata.x0 + torch.as_tensor(
        noise)), dataclasses.replace(TB.bench_params(),
                                     max_total_qp_solves=60), device="cpu")
    np.testing.assert_array_equal(tn.status.numpy(), np.asarray(jn.status))
    np.testing.assert_array_equal(tn.n_qp_solves.numpy(),
                                  np.asarray(jn.n_qp_solves))
    print(f"noisy start: statuses {tn.status.tolist()}, QP solves "
          f"{tn.n_qp_solves.tolist()}, |dx| "
          f"{float(np.abs(tn.x.numpy() - np.asarray(jn.x)).max()):.3e}")
    np.testing.assert_allclose(tn.x.numpy(), np.asarray(jn.x), rtol=0,
                               atol=RAIL_NOISY_X_TOL)
    X = tres.x.reshape(B, T9, 9)
    conv = tres.status == CONVERGED
    assert conv.any()
    swept = trajectory_in_collision(world, X)
    assert (swept[conv] >= 0).all()
    # the rail dofs are used: the carriage travels the span
    assert (X[conv, 0, 0] < -0.7).all() and (X[conv, -1, 0] > 0.7).all()
