"""PyTorch port vs JAX reference: the reference's solve benchmarks
(``benchmarks.run_benchmarks`` and its scenes), float64 on the CPU.

- the three scene builders added with them (``make_simple_collision``,
  ``make_planning``, ``make_redundant_rail``) give the reference's data:
  x0, bounds and every parameter, bit for bit, and the same step band
  (``_bandable``);
- simple_collision (a 2-DoF spherebot, one step, discrete collision: the
  dense-row QP with the dense Cholesky), batch 4: statuses and QP counts
  equal, x within 1e-8;
- planning (arm7, T=6, one swept-collision cost at n_sub=8), batch 2:
  statuses and QP counts equal, x within 1e-6;
- the 9-DoF rail's solve is ``test_torch_rail.py``'s.

The three files are one set, split for the test run's time: each holds
reference compiles of minutes, and each file runs on a worker of its own.
- ``run_benchmarks`` itself is ``test_torch_benchmarks.py``'s.

Each solve goes through the reference's ``_solve`` under one
``jit(vmap(...))`` and the port's ``solve_batch`` (the same float64 iterate
sequence; sum orders differ inside the QP).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu import benchmarks as JB
from trajopt_tpu.solver.sqp import _bandable as j_bandable
from trajopt_tpu.solver.sqp import _solve as j_solve_lane
from trajopt_tpu_torch import benchmarks as TB
from trajopt_tpu_torch.convert import problem_data_from_numpy
from trajopt_tpu_torch.solver.sqp import _bandable as t_bandable
from trajopt_tpu_torch.solver.sqp import solve_batch
from trajopt_tpu_torch.solver.types import CONVERGED

SIMPLE_TOL, X_TOL = 1e-8, 1e-6


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


def _leaves(d):
    return jax.tree.leaves(tuple(d)[:5], is_leaf=torch.is_tensor)


def _assert_data_equal(tdata, jdata):
    ref = problem_data_from_numpy(jax.tree.map(np.asarray, jdata), "cpu",
                                  torch.float64)
    got, want = _leaves(tdata), _leaves(ref)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _solve_both(jspec, jdata, tspec, tdata, params_j, params_t):
    jres = jax.jit(jax.vmap(lambda d: j_solve_lane(jspec, params_j, d)))(
        jdata)
    tres = solve_batch(tspec, tdata, params_t, device="cpu")
    np.testing.assert_array_equal(tres.status.numpy(), np.asarray(jres.status))
    np.testing.assert_array_equal(tres.n_qp_solves.numpy(),
                                  np.asarray(jres.n_qp_solves))
    return jres, tres


@pytest.mark.parametrize("name", ["simple_collision", "planning",
                                  "redundant_rail"])
def test_scene_data_equal(name):
    jmake = getattr(JB, f"make_{name}")
    tmake = getattr(TB, f"make_{name}")
    jspec, jdata, jchain, jworld = jmake(3, dtype=jnp.float64)
    tspec, tdata, tchain, tworld = tmake(3, dtype=torch.float64, device="cpu")
    _assert_data_equal(tdata, jdata)
    # the step band: none for the one-step spherebot (the dense rows)
    assert t_bandable(tspec) == j_bandable(jspec) == (name != "simple_collision")
    assert tchain.n_dof == jchain.n_dof
    assert tworld.pair_names() == tuple(
        (jworld.geoms[i].name, jworld.geoms[j].name) for i, j in jworld.pairs)


def test_simple_collision_dense_path():
    """One step: no step band, so the QP takes the dense rows and the
    dense Cholesky; the lanes start inside the obstacle's margin."""
    jspec, jdata, _, _ = JB.make_simple_collision(4, dtype=jnp.float64)
    tspec, tdata, _, world = TB.make_simple_collision(4, dtype=torch.float64,
                                                      device="cpu")
    jres, tres = _solve_both(jspec, jdata, tspec, tdata, JB.bench_params(),
                             TB.bench_params())
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=SIMPLE_TOL)
    assert (tres.status == CONVERGED).all()
    d0 = world.pair_distances(tdata.x0)
    d1 = world.pair_distances(tres.x)
    assert (d0 < 0.2).all() and (d1 >= 0.2 - 1e-4).all()


def test_planning_n_sub_8():
    jspec, jdata, _, _ = JB.make_planning(2, dtype=jnp.float64)
    tspec, tdata, _, _ = TB.make_planning(2, dtype=torch.float64,
                                          device="cpu")
    jres, tres = _solve_both(jspec, jdata, tspec, tdata, JB.bench_params(),
                             TB.bench_params())
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=X_TOL)
    assert (tres.status == CONVERGED).all()
