"""K11 ``ipm_dense`` (the dense-row interior-point loop as one launch) in
its host build, float64 on the CPU, against the plain PyTorch loop and the
JAX reference.

The fixture is ``test_torch_ipm``'s: random flagship-shaped subproblems
(a joint-velocity quadratic, hinge rows on step-gap windows, abs rows on
per-step windows plus a goal block, a trust box, a pinned first step),
their rows made dense (lanes, m, n) matrices with ``bb_to_dense``.  K11's
device code (``csrc/ipm_dense.cuh``) runs here through its host build
(``solve_ipm_qp_host``, csrc/ipm_host.cpp): against the plain loop it must
give equal statuses and iteration counts and dx within 1e-10 of the
largest |dx| (``HOST_TOL``), and against JAX's ``solve_ipm_qp`` lane by
lane equal statuses and iteration counts and dx within 1e-8 (u within
1e-8 of its largest entry).  Both
routes: the block route (kkt_block 7 and 9: the band of the dense K
through K2 / K3's device functions) and the dense route (kkt_block = n:
the dense Cholesky), each with the regions in the shared-memory array and
in the device scratch bitwise alike; a non-positive-definite K on the
dense route (a lane with a negative definite P), which must take the NaN
guard as ``cholesky_ex``'s info does in the plain loop; lanes that stop at
different iterations; and chip_smoke phase 6a's cartesian waypoints at
T=8 through the SQP with the IPM run by K11's host build.  A dispatch
test holds that dense rows on a CUDA tensor reach K11's wrapper, and that
the wrapper raises rather than falls back to the plain loop when it
cannot build or launch.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.ops.ipm_qp import solve_ipm_qp as j_solve
from trajopt_tpu.ops.prox_qp import ProxQPData as JData
from trajopt_tpu.ops.qp import QPSettings as JSettings
from trajopt_tpu_torch import _native
from trajopt_tpu_torch.ops import ipm_qp
from trajopt_tpu_torch.ops.banded_rows import bb_to_dense
from trajopt_tpu_torch.ops.ipm_qp import (_finish, _setup, ipm_dense_host,
                                          k11_scratch_size, solve_ipm_qp_host)
from trajopt_tpu_torch.ops.ipm_qp import solve_ipm_qp as t_solve
from trajopt_tpu_torch.ops.qp import QPSettings as TSettings

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)
sys.path.insert(0, os.path.dirname(os.path.dirname(_HERE)))
import chip_smoke as CS  # noqa: E402
from test_torch_ipm import (B_SZ, HOST_TOL, TOL, _assert_same_run,  # noqa: E402
                            _problem, _settings, _tdata)

# route -> (steps, step width b, kkt_block): the block route at the
# fixture's b 7 and at b 9, the dense route with kkt_block = n (n < 2 b)
ROUTES = {"block_b7": (5, B_SZ, B_SZ), "block_b9": (5, 9, 9),
          "dense": (3, B_SZ, 3 * B_SZ)}


def _dense_fixture(route, tight, lanes=4, seed=None, **over):
    """(arrays, dense QP data, settings) of the fixture on ``route``."""
    nb, b, kkt = ROUTES[route]
    # the seeds of test_torch_ipm's K6 host-build fixture with hinge rows
    rng = np.random.default_rng(8 + 2 * tight if seed is None else seed)
    arrays, Bh, Gh, Ba, Ga = _problem(rng, lanes, True, nb=nb, b=b)
    banded = _tdata(arrays, Bh, Gh, Ba, Ga)
    n = b * nb
    dense = banded._replace(A_h=bb_to_dense(banded.Bh, banded.Gh, n, b),
                            A_a=bb_to_dense(banded.Ba, banded.Ga, n, b),
                            Bh=(), Gh=(), Ba=(), Ga=())
    return arrays, dense, _settings(tight, kkt, **over)


def _against_jax(arrays, dense, kw, sol):
    for z in range(dense.q.shape[0]):
        jd = JData(**{k: jnp.asarray(v[z]) for k, v in arrays.items()},
                   A_h=jnp.asarray(dense.A_h[z].numpy()),
                   A_a=jnp.asarray(dense.A_a[z].numpy()))
        ref = j_solve(jd, JSettings(**kw))
        assert int(sol.status[z]) == int(ref.status), z
        assert int(sol.iters[z]) == int(ref.iters), z
        np.testing.assert_allclose(sol.x[z].numpy(), np.asarray(ref.x),
                                   rtol=0, atol=TOL)
        # u within TOL of its largest entry, as test_torch_ipm's K6 case at
        # b 8, 9: a pinned step's abs rows have no free column, scale by
        # the 1e-8 floor, and their slacks reach ~1e8, where one ulp is
        # 1.5e-8 (the NaN-guard lane here: 2.98e-8 on an entry of 1.2e8)
        u_ref = np.asarray(ref.u)
        np.testing.assert_allclose(sol.u[z].numpy(), u_ref, rtol=0,
                                   atol=TOL * max(1.0, np.abs(u_ref).max()))


@pytest.mark.parametrize("tight", [False, True])
@pytest.mark.parametrize("route", list(ROUTES))
def test_k11_host_matches_plain_and_reference(route, tight):
    """K11's host build on both routes against the plain loop (HOST_TOL)
    and JAX (TOL), with its regions in the shared-memory array and in the
    device scratch bitwise alike."""
    arrays, dense, kw = _dense_fixture(route, tight)
    st = TSettings(**kw)
    su = _setup(dense, st)
    assert (su.nb > 0) == route.startswith("block")
    sol = solve_ipm_qp_host(dense, st)
    _assert_same_run(sol, t_solve(dense, st, device="cpu"), HOST_TOL)
    for smem in ((0, 0, 0, 0, 0), (1, 0, 0, 1, 1), (0, 1, 1, 0, 0)):
        other = _finish(su, ipm_dense_host(su, smem))
        assert torch.equal(other.x, sol.x) and torch.equal(other.u, sol.u)
    _against_jax(arrays, dense, kw, sol)


def test_k11_host_nan_guard_on_a_non_pd_k():
    """Lane 1's P is negative definite: on the dense route its K has no
    Cholesky, the reference's gives NaN, the Newton step is non-finite and
    the NaN guard keeps the incumbent (dx = 0) and stops the lane at its
    first iteration; the other lanes solve.  K11 as the plain loop and
    JAX."""
    arrays, dense, kw = _dense_fixture("dense", False, seed=5)
    n = dense.q.shape[1]
    arrays["P"][1] = -50.0 * np.eye(n)
    dense = dense._replace(P=torch.as_tensor(arrays["P"]))
    st = TSettings(**kw)
    sol = solve_ipm_qp_host(dense, st)
    ref = t_solve(dense, st, device="cpu")
    _assert_same_run(sol, ref, HOST_TOL)
    assert int(sol.iters[1]) == 1 and int(sol.status[1]) in (2, 3)
    # the incumbent dx = 0, clipped to the box (the pinned first step)
    assert torch.equal(sol.x[1], torch.clamp(torch.zeros(n), dense.lb[1],
                                             dense.ub[1]))
    assert (sol.status[[0, 2, 3]] == 1).all()
    _against_jax(arrays, dense, kw, sol)


@pytest.mark.parametrize("route,cap", [("block_b7", 12), ("dense", 11)])
def test_k11_host_lanes_stop_apart(route, cap):
    """Lanes that converge early stop while the others run on to the cap
    (the tight fixture, whose lanes converge after 11, 11, 13, 31
    iterations on the block route and 10, 10, 11, 11 on the dense route):
    equal statuses, iteration counts and dx as the plain loop."""
    _, dense, kw = _dense_fixture(route, True, max_ipm_iter=cap)
    st = TSettings(**kw)
    sol = solve_ipm_qp_host(dense, st)
    _assert_same_run(sol, t_solve(dense, st, device="cpu"), HOST_TOL)
    it = sol.iters.numpy()
    assert (it < cap).any() and (it == cap).any(), it
    assert (sol.status.numpy()[it < cap] == 1).all()


def test_k11_host_through_the_sqp(monkeypatch):
    """chip_smoke phase 6a's cartesian waypoints (cart_pose EQ at three
    waypoints, cart_vel INEQ, joint_vel cost) at T=8, two lanes, through
    ``solve_batch`` with the IPM run by K11's host build (the dense rows'
    block route at kkt_block 7): statuses, QP counts and x as the plain
    path's."""
    from trajopt_tpu_torch.solver import sqp
    from trajopt_tpu_torch.solver.types import CONVERGED, SQPParams

    inp = CS.cartesian_inputs(2, n_steps=8)
    spec, data, _ = CS.port_cartesian_problem("waypoints", inp,
                                              torch.float64, "cpu")
    ref = sqp.solve_batch(spec, data, SQPParams(), device="cpu")
    seen = []

    def host(d, s, device, kernels, plan):
        assert d.A_h is not None and plan is None
        seen.append(s.kkt_block)
        return solve_ipm_qp_host(d, s, plan)
    monkeypatch.setattr(sqp, "solve_ipm_qp", host)
    got = sqp.solve_batch(spec, data, SQPParams(), device="cpu")
    assert seen and set(seen) == {7}
    np.testing.assert_array_equal(got.status.numpy(), ref.status.numpy())
    np.testing.assert_array_equal(got.n_qp_solves.numpy(),
                                  ref.n_qp_solves.numpy())
    np.testing.assert_allclose(got.x.numpy(), ref.x.numpy(), rtol=0,
                               atol=1e-9)
    assert (got.status == CONVERGED).all()


def test_dense_rows_on_cuda_reach_k11_and_never_fall_back(monkeypatch):
    """With every tensor reporting CUDA (``Tensor.is_cuda`` patched), dense
    rows through ``solve_ipm_qp(kernels=True)`` reach ``ipm_dense_cuda``
    and never the plain loop; the wrapper itself, with no card and no
    nvcc, raises at its build and counts no launch.  ``kernels=False``
    keeps the plain loop.  The scratch size mirrors the kernel's."""
    _, dense, kw = _dense_fixture("block_b7", False)
    st = TSettings(**kw)
    ref = t_solve(dense, st, device="cpu")
    host = ipm_dense_host(_setup(dense, st))
    calls = []

    def k11(su):
        calls.append(su.nb)
        return host

    def no_plain(su):
        raise AssertionError("the plain loop ran")
    plain = ipm_qp._loop_plain
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(ipm_qp, "_loop_plain", no_plain)
    with monkeypatch.context() as m:
        m.setattr(ipm_qp, "ipm_dense_cuda", k11)
        _assert_same_run(t_solve(dense, st, device="cpu"), ref, HOST_TOL)
    assert calls == [5]
    # the wrapper itself: its library cannot be built here
    monkeypatch.setattr(_native, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(_native, "_lib_path",
                        lambda *a, **k: _native.BUILD_DIR / "absent.so")
    before = dict(_native.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        t_solve(dense, st, device="cpu")
    assert _native.LAUNCHES == before
    monkeypatch.setattr(ipm_qp, "_loop_plain", plain)
    _assert_same_run(t_solve(dense, st, device="cpu", kernels=False), ref,
                     0.0)
    # the device scratch: K (dense route, packed), the lists (empty here:
    # each its offsets, rows + 1 ints, two to a float64), band (D, O, V and
    # the solves' scratch n-vector), n-vectors, m-vectors, the raw lists
    # (Rh, Ra, P)
    def offsets(*rows):
        return sum(-(-(r + 1) // 2) for r in rows)
    assert k11_scratch_size(35, 7, 5, 10, 4) == offsets(10, 35, 4, 35, 35) \
        + 5 * 49 + 4 * 49 + 4 * 49 + 35 + 18 * 35 + 12 * 14 \
        + offsets(10, 4, 35)
    assert k11_scratch_size(21, 0, 0, 10, 4) == 21 * 22 // 2 \
        + offsets(10, 21, 4, 21, 21) + 18 * 21 + 12 * 14 + offsets(10, 4, 21)
    assert _native.k11_library(True, 0) == _native.k11_library(True, 1)
    assert [_native.k11_library(False, b) for b in (9, 10, 21)] == [
        "ipm_dense_f32_b1_9", "ipm_dense_f32_b10_14", "ipm_dense_f32_b19_21"]
    with pytest.raises(ValueError, match="1..21"):
        _native.k11_library(False, 22)
    # the dense order (a QP under K11_LISTS_MIN_N columns): a library of
    # its own per dtype, b up to K11_DENSE_HI and the dense route
    assert [_native.k11_library(f64, b, False) for f64, b in (
        (False, 0), (True, 9))] == ["ipm_dense_f32_dense",
                                    "ipm_dense_f64_dense"]
    with pytest.raises(ValueError, match="dense order"):
        _native.k11_library(False, 10, False)
