"""PyTorch port vs JAX reference: the cartesian terms and IK, float64 on
the CPU (and the pose kernels' host builds in float32 too).

- ``ops.lie``: ``quat_wxyz_to_matrix``, ``rot_log`` (random rotations,
  rotations within 1e-9 of the identity, rotations near pi, each of the
  four pivot branches) and ``transform_error`` within 1e-12;
- ``cart_pose_term``'s ``fn`` / ``jac_fn`` (world target, moving target
  link, the tolerance band, eq / abs / squared, ``n_cols`` = n_dof + 1):
  values within 1e-10, Jacobians within 1e-8;
- ``cart_line_term`` and ``cart_vel_term`` through the autodiff
  linearization (``Term.jac``) against the reference's ``Term.jac``;
- ``solve_ik``'s plain version on 16 lanes, plain and ``pos_only``:
  ``converged`` and ``iters`` equal, q within 1e-8;
- the host builds of K9 cart_pose / K9v and K8 solve_ik against their
  plain versions, float64 and float32, with chip_smoke phase 2f's
  tolerances and tie rules (imported from ``chip_smoke.py``);
- ``ik_term`` in ``solve_batch`` (batch 2, T=4, as ``tests/test_ik.py``)
  and chip_smoke phase 6a's scene cut to T=8, batch 2 (the same numpy
  inputs, ``chip_smoke.cartesian_inputs``, built into each package's terms):
  statuses and QP counts equal, x within 1e-6.
"""

import inspect
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.kinematics import ik as JIK
from trajopt_tpu.models import arm7 as j_arm7
from trajopt_tpu.ops import lie as JL
from trajopt_tpu.ops.qp import QPSettings as JQPSettings
from trajopt_tpu.problem.trajectory import TrajProblemBuilder as JBuilder
from trajopt_tpu.problem.trajectory import stack_data as j_stack
from trajopt_tpu.problem.trajectory import stationary_init
from trajopt_tpu.solver.sqp import _solve as j_solve_lane
from trajopt_tpu.solver.types import SQPParams as JSQPParams
from trajopt_tpu.terms import cartesian as JC
from trajopt_tpu.terms.joint import joint_vel_term as j_joint_vel
from trajopt_tpu_torch.kinematics import ik as TIK
from trajopt_tpu_torch.models import arm7
from trajopt_tpu_torch.ops import lie as TL
from trajopt_tpu_torch.ops.qp import QPSettings
from trajopt_tpu_torch.problem.trajectory import TrajProblemBuilder, stack_data
from trajopt_tpu_torch.solver.sqp import solve_batch
from trajopt_tpu_torch.solver.types import CONVERGED, SQPParams
from trajopt_tpu_torch.terms import cartesian as TC
from trajopt_tpu_torch.terms.joint import joint_vel_term

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "scripts"))
import chip_smoke as CS  # noqa: E402
from jax_reference_counts import jax_cartesian_problem  # noqa: E402

LIE_TOL, VAL_TOL, JAC_TOL, Q_TOL, X_TOL = 1e-12, 1e-10, 1e-8, 1e-8, 1e-6
_, JCH = j_arm7()
_, TCH = arm7()
ND = TCH.n_dof
TOOL = TCH.link_index("tool")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU solves are many small ops, where torch's intra-op
    threads only add overhead, and the test run shares the machine's
    cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rotations():
    """Rotation matrices (float64): random, within 1e-9 of the identity,
    near pi, and at each pivot branch of the log map."""
    rng = np.random.default_rng(0)
    Rs = [np.asarray(JL.quat_wxyz_to_matrix(jnp.asarray(q)))
          for q in rng.normal(size=(24, 4))]
    for ang in (1e-9, 3e-10, 1e-12, 0.0):
        ax = rng.normal(size=3)
        Rs.append(np.asarray(JL.axis_angle_matrix(jnp.asarray(ax),
                                                  jnp.asarray(ang))))
    for d in (0.0, 1e-7, 1e-4, 2e-3):
        for ax in (np.eye(3)[0], np.eye(3)[1], np.eye(3)[2],
                   rng.normal(size=3)):
            Rs.append(np.asarray(JL.axis_angle_matrix(
                jnp.asarray(ax), jnp.asarray(np.pi - d))))
    return np.stack(Rs)


def test_lie_matches_reference():
    R = _rotations()
    piv = np.stack([np.trace(R, axis1=1, axis2=2),
                    R[:, 0, 0] - R[:, 1, 1] - R[:, 2, 2],
                    -R[:, 0, 0] + R[:, 1, 1] - R[:, 2, 2],
                    -R[:, 0, 0] - R[:, 1, 1] + R[:, 2, 2]], -1)
    assert set(np.argmax(piv, -1)) == {0, 1, 2, 3}  # every branch
    got = TL.rot_log(torch.as_tensor(R)).numpy()
    ref = np.asarray(JL.rot_log(jnp.asarray(R)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=LIE_TOL)
    rng = np.random.default_rng(1)
    q = rng.normal(size=(16, 4))
    np.testing.assert_allclose(
        TL.quat_wxyz_to_matrix(torch.as_tensor(q)).numpy(),
        np.asarray(JL.quat_wxyz_to_matrix(jnp.asarray(q))), rtol=0,
        atol=LIE_TOL)
    n = R.shape[0]
    Rt, pt, ps = R[::-1].copy(), rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    np.testing.assert_allclose(
        TL.transform_error(*map(torch.as_tensor, (Rt, pt, R, ps))).numpy(),
        np.asarray(JL.transform_error(*map(jnp.asarray, (Rt, pt, R, ps)))),
        rtol=0, atol=LIE_TOL)


def _pose_params(B, band, seed=2):
    rng = np.random.default_rng(seed)
    tols = {}
    if band:
        tols = {"lower_tols": [-0.05] * 3 + [-0.1] * 3,
                "upper_tols": [0.05] * 3 + [0.1] * 3}
    ps = []
    for _ in range(B):
        tR = np.asarray(JL.rpy_to_matrix(jnp.asarray(rng.uniform(-1, 1, 3))))
        sR = np.asarray(JL.rpy_to_matrix(jnp.asarray(rng.uniform(-.2, .2, 3))))
        p = JC.default_cart_pose_params(
            target_R=tR, target_p=rng.normal(size=3) * 0.3,
            pos_coeffs=[1.0, 2.0, 0.5], rot_coeffs=0.7, source_off_R=sR,
            source_off_p=rng.normal(size=3) * 0.05, **tols)
        ps.append({k: np.asarray(v) for k, v in p.items()})
    return {k: np.stack([p[k] for p in ps]) for k in ps[0]}


def _lane(p, i):
    return {k: jnp.asarray(v[i]) for k, v in p.items()}


def _tp(p, dtype=torch.float64):
    return {k: torch.as_tensor(v, dtype=dtype) for k, v in p.items()}


POSE_CASES = {  # target link, band, constraint, cost kind, n_cols
    "world": (None, False, True, "eq", None),
    "target_link": ("l3", False, True, "eq", None),
    "band": (None, True, True, "eq", None),
    "abs": ("l3", True, False, "abs", None),
    "squared": (None, False, False, "squared", None),
    "n_cols": ("l2", True, True, "eq", ND + 1),
}


@pytest.mark.parametrize("case", list(POSE_CASES))
def test_cart_pose_term_matches_reference(case):
    tgt, band, cnt, kind, nc = POSE_CASES[case]
    T, B, step = 4, 3, 2
    w = nc or ND
    x = np.random.default_rng(3).uniform(-1.2, 1.2, (B, T * w))
    p = _pose_params(B, band)
    jt = JC.cart_pose_term("c", JCH, T, step, "tool", target_link=tgt,
                           is_constraint=cnt, kind=kind, n_cols=nc)
    tt = TC.cart_pose_term("c", TCH, T, step, "tool", target_link=tgt,
                           is_constraint=cnt, kind=kind, n_cols=nc)
    assert tt.kind == jt.kind and tt.step_coupling == jt.step_coupling
    ref_e = np.stack([np.asarray(jt.err(jnp.asarray(x[i]), _lane(p, i)))
                      for i in range(B)])
    ref_j = np.stack([np.asarray(jt.jac(jnp.asarray(x[i]), _lane(p, i)))
                      for i in range(B)])
    xt = torch.as_tensor(x)
    np.testing.assert_allclose(tt.err(xt, _tp(p)).numpy(), ref_e, rtol=0,
                               atol=VAL_TOL)
    np.testing.assert_allclose(tt.jac(xt, _tp(p)).numpy(), ref_j, rtol=0,
                               atol=JAC_TOL)
    if band:  # the band zeroes some rows and passes others
        assert (ref_e == 0).any() and (ref_e != 0).any()


def test_default_cart_pose_params():
    for k, v in JC.default_cart_pose_params(lower_tols=-0.1,
                                            upper_tols=0.2).items():
        np.testing.assert_array_equal(
            TC.default_cart_pose_params(lower_tols=-0.1,
                                        upper_tols=0.2)[k], np.asarray(v))
    with pytest.raises(ValueError, match="inverted"):
        TC.default_cart_pose_params(lower_tols=0.1, upper_tols=-0.1)


def test_line_and_vel_terms_autodiff():
    """cart_line_term and cart_vel_term (no jac_fn): values and the
    autodiff linearization (jacfwd under vmap) against the reference's."""
    T, B = 5, 3
    rng = np.random.default_rng(4)
    x = rng.uniform(-1.0, 1.0, (B, T * ND))
    line = {"line_a": rng.normal(size=(B, 3)) * 0.3,
            "line_b": rng.normal(size=(B, 3)) * 0.3,
            "target_R": np.stack([np.asarray(JL.rpy_to_matrix(
                jnp.asarray(r))) for r in rng.uniform(-1, 1, (B, 3))]),
            "coeffs": np.tile([1.0, 1.0, 2.0, 0.5, 0.5, 0.5], (B, 1))}
    vel = {"max_displacement": np.array([0.05, 0.1, 0.2])}
    for jt, tt, p in (
            (JC.cart_line_term("l", JCH, T, 3, "tool"),
             TC.cart_line_term("l", TCH, T, 3, "tool"), line),
            (JC.cart_line_term("l", JCH, T, 1, "l4", is_constraint=False),
             TC.cart_line_term("l", TCH, T, 1, "l4", is_constraint=False),
             line),
            (JC.cart_vel_term("v", JCH, T, "tool", first_step=1),
             TC.cart_vel_term("v", TCH, T, "tool", first_step=1), vel),
            (JC.cart_vel_term("v", JCH, T, "tool", is_constraint=False),
             TC.cart_vel_term("v", TCH, T, "tool", is_constraint=False),
             vel)):
        assert tt.jac_fn is None and tt.step_coupling == jt.step_coupling
        ref_e = np.stack([np.asarray(jt.err(jnp.asarray(x[i]), _lane(p, i)))
                          for i in range(B)])
        ref_j = np.stack([np.asarray(jt.jac(jnp.asarray(x[i]), _lane(p, i)))
                          for i in range(B)])
        xt = torch.as_tensor(x)
        np.testing.assert_allclose(tt.err(xt, _tp(p)).numpy(), ref_e,
                                   rtol=0, atol=VAL_TOL)
        np.testing.assert_allclose(tt.jac(xt, _tp(p)).numpy(), ref_j,
                                   rtol=0, atol=JAC_TOL)


def _ik_queries(lanes):
    inp = CS.ik_inputs(lanes, seed=5)
    return inp, [torch.as_tensor(inp[k]) for k in
                 ("target_R", "target_p", "q0")]


@pytest.mark.parametrize("pos_only", [False, True], ids=["full", "pos_only"])
def test_solve_ik_plain_matches_reference(pos_only):
    inp, (tR, tp, q0) = _ik_queries(16)
    got = TIK.solve_ik(TCH, TOOL, tR, tp, q0=q0, pos_only=pos_only)
    ref = jax.jit(jax.vmap(lambda R, p, q: JIK.solve_ik(
        JCH, TOOL, R, p, q0=q, pos_only=pos_only)))(
        *[jnp.asarray(inp[k]) for k in ("target_R", "target_p", "q0")])
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(ref.converged))
    assert int(got.converged.sum()) >= 12  # one lane stops at max_iters
    np.testing.assert_allclose(got.q.numpy(), np.asarray(ref.q), rtol=0,
                               atol=Q_TOL)
    np.testing.assert_allclose(got.err_norm.numpy(), np.asarray(ref.err_norm),
                               rtol=0, atol=Q_TOL)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_pose_kernels_host_build(dtype):
    """K9 / K9v and K8 built for the host against their plain versions,
    with phase 2f's tolerances: values on every row, Jacobians on the rows
    off the log map's and the band's switches; K8 by phase 2f's
    ``ik_compare`` (iteration counts and convergence equal off near-tie
    lanes; q and the error norms within its tolerances on the lanes both
    converged and on those both stopped unconverged at the limit)."""
    name = "float64" if dtype == torch.float64 else "float32"
    T, B, step = 6, 16, 4
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.uniform(-1.5, 1.5, (B, T * ND)), dtype=dtype)
    for tgt, band in ((None, False), (TCH.link_index("l3"), False),
                      (None, True)):
        p = _tp(_pose_params(B, band, seed=7), dtype)
        E, J = TC.cart_pose_host(TCH, x, p, T, step, TOOL, tgt, jac=True)
        Ev = TC.cart_pose_host(TCH, x, p, T, step, TOOL, tgt)
        Ep, Jp = TC.cart_pose_rows(TCH, x, p, T, step, TOOL, tgt, jac=True)
        ties = CS.cart_pose_ties(TCH, x, p, T, step, TOOL, tgt)
        assert torch.equal(E, Ev)  # the Jacobian's value is K9v's, bit for bit
        scale = float(Ep.abs().max())
        assert float((E - Ep).abs().max()) <= CS.REL_TOL[name] * scale
        ok = ~ties[..., None].expand_as(J)
        jscale = float(Jp.abs().max())
        assert float((J - Jp)[ok].abs().max()) \
            <= CS.COLL_TOL[name][1] * jscale
        if dtype == torch.float64:
            assert not bool(ties.any())
    inp, (tR, tp, q0) = _ik_queries(B)
    for po in (False, True):
        kh = TIK.solve_ik_host(TCH, TOOL, tR.to(dtype), tp.to(dtype),
                               q0=q0.to(dtype), pos_only=po)
        kp, tie = CS.solve_ik_plain_ties(TCH, TOOL, tR.to(dtype),
                                         tp.to(dtype), q0.to(dtype), po)
        # the tie tracker runs the plain loop itself, step for step
        plain = TIK.solve_ik_plain(TCH, TOOL, tR.to(dtype), tp.to(dtype),
                                   q0=q0.to(dtype), pos_only=po)
        assert all(torch.equal(a, b) for a, b in zip(kp, plain))
        rec = CS.ik_compare(kh, kp, tie, name)
        assert rec["ok"], rec
        if dtype == torch.float64:
            assert rec["lanes_apart"] == 0


def test_problem_data_from_numpy_defaults_to_the_card():
    """``convert.problem_data_from_numpy`` runs on the card unless asked
    for the CPU, as every entry point of the port."""
    from trajopt_tpu_torch.convert import problem_data_from_numpy

    sig = inspect.signature(problem_data_from_numpy)
    assert sig.parameters["device"].default == "cuda"
    inp = CS.cartesian_inputs(1, n_steps=4)
    _, jdata, _ = jax_cartesian_problem("waypoints", inp, np.float64)
    got = problem_data_from_numpy(jax.tree.map(np.asarray, jdata), "cpu")
    assert got.x0.device.type == "cpu"
    np.testing.assert_array_equal(got.x0.numpy(), np.asarray(jdata.x0))


def _jax_batch(spec, data, params):
    return jax.jit(jax.vmap(lambda d: j_solve_lane(spec, params, d)))(data)


def _same_solve(jres, tres):
    np.testing.assert_array_equal(tres.status.numpy(), np.asarray(jres.status))
    np.testing.assert_array_equal(tres.n_qp_solves.numpy(),
                                  np.asarray(jres.n_qp_solves))
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=X_TOL)


def test_ik_term_in_solve_batch():
    """``tests/test_ik.py``'s IK goal at T=4, two lanes: ik_term EQ at the
    last step, joint_vel cost, a stationary start off the goal; its
    jac_fn equals the reference's autodiff Jacobian."""
    T = 4
    goals = np.array([[0.3, 0.5, -0.1, 0.8, 0.2, -0.4, 0.1],
                      [-0.2, 0.6, 0.2, 0.7, -0.3, 0.3, -0.2]])
    R, p = TCH.fk(torch.as_tensor(goals))
    qp = dict(eps_abs=1e-6, eps_rel=1e-8, max_iter=4000)
    jb = JBuilder(JCH, T)
    jb.add_cost(j_joint_vel("vel", T, ND),
                {"targets": jnp.zeros(ND), "coeffs": jnp.ones(ND)})
    jt_ik = JIK.ik_term("ik_goal", JCH, T, T - 1, "tool")
    jb.add_constraint(jt_ik, {"target_R": R[0, TOOL].numpy(),
                              "target_p": p[0, TOOL].numpy(),
                              "coeffs": np.ones(ND)})
    tb = TrajProblemBuilder(TCH, T, device="cpu")
    tb.add_cost(joint_vel_term("vel", T, ND),
                {"targets": np.zeros(ND), "coeffs": np.ones(ND)})
    tt_ik = TIK.ik_term("ik_goal", TCH, T, T - 1, "tool")
    tb.add_constraint(tt_ik, {"target_R": R[0, TOOL].numpy(),
                              "target_p": p[0, TOOL].numpy(),
                              "coeffs": np.ones(ND)})
    jd, td = [], []
    for i in range(2):
        cnt = {"target_R": R[i, TOOL].numpy(), "target_p": p[i, TOOL].numpy(),
               "coeffs": np.ones(ND)}
        init = stationary_init(goals[i] + 0.2, T)
        js, d = jb.build(init)
        jd.append(d._replace(cnt_params=(
            {k: jnp.asarray(v) for k, v in cnt.items()},)))
        ts, d = tb.build(init)
        td.append(d._replace(cnt_params=(
            {k: torch.as_tensor(v) for k, v in cnt.items()},)))
    jdata, tdata = j_stack(jd), stack_data(td)
    x0 = tdata.x0 + 0.05
    ref_j = np.stack([np.asarray(jt_ik.jac(jnp.asarray(x0[i].numpy()), {
        k: v[i] for k, v in jdata.cnt_params[0].items()})) for i in range(2)])
    np.testing.assert_array_equal(
        tt_ik.jac(x0, tdata.cnt_params[0]).numpy(), ref_j)
    jres = _jax_batch(js, jdata, JSQPParams(qp=JQPSettings(**qp)))
    tres = solve_batch(ts, tdata, SQPParams(qp=QPSettings(**qp)),
                       device="cpu")
    _same_solve(jres, tres)
    assert (tres.status == CONVERGED).all()


def test_cartesian_waypoints_t8():
    """chip_smoke phase 6a's scene (BASELINE config 2) cut to T=8 and two
    lanes, from the same numpy inputs: cart_pose EQ at three waypoints,
    cart_vel INEQ, joint_vel cost, ``SQPParams()``."""
    inp = CS.cartesian_inputs(2, n_steps=8)
    js, jdata, _ = jax_cartesian_problem("waypoints", inp, np.float64)
    ts, tdata, _ = CS.port_cartesian_problem("waypoints", inp, torch.float64,
                                             "cpu")
    jres = _jax_batch(js, jdata, JSQPParams())
    tres = solve_batch(ts, tdata, SQPParams(), device="cpu")
    _same_solve(jres, tres)
    assert (tres.status == CONVERGED).all()
