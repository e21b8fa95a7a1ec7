"""PyTorch port vs JAX reference: URDF/chain, FK and Jacobians, joint and
upright terms (float64 on the CPU).

Tolerance 1e-12 absolute: both sides evaluate the same formulas in
float64; only the order of a few sums differs (batched 3x3 matmuls vs the
reference's unrolled scalar compose, analytic omega x z vs jacfwd).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu import models as jmodels
from trajopt_tpu.terms import cartesian as jcart
from trajopt_tpu.terms import joint as jjoint
from trajopt_tpu_torch import models as tmodels
from trajopt_tpu_torch.convert import chain_from_numpy
from trajopt_tpu_torch.terms import cartesian as tcart
from trajopt_tpu_torch.terms import joint as tjoint

TOL = 1e-12
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("name", ["SPHEREBOT_URDF", "BOXBOT_URDF", "ARM7_URDF",
                                  "ARM7_WALL_URDF", "ARM9_RAIL_URDF"])
def test_urdf_strings_and_chain_arrays_equal(name):
    assert getattr(tmodels, name) == getattr(jmodels, name)
    factory = {"SPHEREBOT_URDF": "spherebot", "BOXBOT_URDF": "boxbot",
               "ARM7_URDF": "arm7", "ARM7_WALL_URDF": "arm7_wall",
               "ARM9_RAIL_URDF": "arm9_rail"}[name]
    _, jc = getattr(jmodels, factory)()
    _, tc = getattr(tmodels, factory)()
    ref = chain_from_numpy(jc)
    assert tc.link_names == ref.link_names
    assert tc.joint_names == ref.joint_names
    for f in ("parent", "jtype", "dof_of_link", "link_of_dof", "ancestor"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(ref, f))
    for f in ("off_R", "off_p", "axis", "lb", "ub", "vel"):
        np.testing.assert_allclose(getattr(tc, f), getattr(ref, f),
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("factory", ["arm7", "arm9_rail", "spherebot"])
def test_fk_and_jacobians_match(factory):
    _, jc = getattr(jmodels, factory)()
    _, tc = getattr(tmodels, factory)()
    rng = np.random.default_rng(3)
    Q = rng.uniform(-1.5, 1.5, (3, 4, jc.n_dof))
    R_j, p_j = jax.vmap(jc.fk)(jnp.asarray(Q.reshape(-1, jc.n_dof)))
    R_t, p_t = tc.fk(_t(Q))
    np.testing.assert_allclose(R_t.reshape(-1, tc.n_links, 3, 3).numpy(),
                               np.asarray(R_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(p_t.reshape(-1, tc.n_links, 3).numpy(),
                               np.asarray(p_j), rtol=0, atol=TOL)
    link = tc.n_links - 1
    pt = rng.normal(size=(3, 4, 3))
    Qf, ptf = jnp.asarray(Q.reshape(-1, jc.n_dof)), jnp.asarray(pt.reshape(-1, 3))
    J_j = jax.vmap(lambda q: jc.jacobian(q, link))(Qf)
    Jp_j = jax.vmap(lambda q, x: jc.jacobian_point(q, link, x))(Qf, ptf)
    J_t = tc.jacobian(_t(Q), link)
    Jp_t = tc.jacobian_point(_t(Q), link, _t(pt))
    np.testing.assert_allclose(J_t.reshape(J_j.shape).numpy(), np.asarray(J_j),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(Jp_t.reshape(Jp_j.shape).numpy(),
                               np.asarray(Jp_j), rtol=0, atol=TOL)


def _lanes_ref(fn, X, params):
    """Run a JAX term function per lane; params is a per-lane list."""
    return [fn(jnp.asarray(X[i]), params[i]) for i in range(len(X))]


def _compare_term(jt, tt, X, jparams, tparams):
    B = X.shape[0]
    x_t = _t(X)
    e_j = np.stack([np.asarray(e) for e in _lanes_ref(jt.err, X, jparams)])
    np.testing.assert_allclose(tt.err(x_t, tparams).numpy(), e_j,
                               rtol=0, atol=TOL)
    J_j = np.stack([np.asarray(j) for j in _lanes_ref(jt.jac, X, jparams)])
    np.testing.assert_allclose(tt.jac(x_t, tparams).numpy(), J_j,
                               rtol=0, atol=TOL)
    out_j = _lanes_ref(jt.jac_banded, X, jparams)
    out_t = tt.jac_banded(x_t, tparams)
    groups_j = [o if isinstance(o, list) else [o] for o in out_j]
    groups_t = out_t if isinstance(out_t, list) else [out_t]
    assert len(groups_t) == len(groups_j[0])
    for k, (Bt, Gt) in enumerate(groups_t):
        Bj = np.stack([np.asarray(groups_j[i][k][0]) for i in range(B)])
        np.testing.assert_allclose(Bt.numpy(), Bj, rtol=0, atol=TOL)
        np.testing.assert_array_equal(Gt.numpy(), np.asarray(groups_j[0][k][1]))
    if jt.is_cost:
        w_j = np.stack([np.asarray(jt.weights(p)) for p in jparams])
        np.testing.assert_allclose(tt.weights(tparams, x_t).numpy(),
                                   np.broadcast_to(w_j, (B, jt.n_rows)),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(
            tt.value(x_t, tparams).numpy(),
            [float(v) for v in _lanes_ref(jt.value, X, jparams)],
            rtol=0, atol=TOL)
    else:
        v_j = np.stack([np.asarray(v) for v in
                        _lanes_ref(jt.violations, X, jparams)])
        np.testing.assert_allclose(tt.violations(x_t, tparams).numpy(), v_j,
                                   rtol=0, atol=TOL)


def _stack_params(plist):
    return {k: _t(np.stack([np.asarray(p[k]) for p in plist])) for k in plist[0]}


@pytest.mark.parametrize("case", [
    dict(order=1),                                        # joint_vel cost
    dict(order=0, first_step=5, last_step=5, is_constraint=True),  # goal
    dict(order=1, toleranced=True),                       # hinge cost
    dict(order=2, toleranced=True, is_constraint=True),   # acc ineq
    dict(order=3, is_constraint=True),                    # jerk eq
])
def test_joint_terms_match(case):
    T, D, B = 6, 7, 3
    case = dict(case)
    order = case.pop("order")
    jt = jjoint.joint_motion_term("t", order, T, D, **case)
    tt = tjoint.joint_motion_term("t", order, T, D, **case)
    rng = np.random.default_rng(order + 10)
    X = rng.normal(size=(B, T * D))
    span = (case.get("last_step", T - 1) - order - case.get("first_step", 0) + 1)
    plist = []
    for _ in range(B):
        p = {"targets": rng.normal(size=D), "coeffs": rng.uniform(0.5, 2, D)}
        if case.get("toleranced"):
            p["upper_tols"] = rng.uniform(0, 0.2, (span, D))
            p["lower_tols"] = -rng.uniform(0, 0.2, D)
        plist.append(p)
    _compare_term(jt, tt, X, plist, _stack_params(plist))


@pytest.mark.parametrize("steps", [(0, None), (2, 4)])
def test_upright_term_matches(steps):
    T, B = 6, 3
    _, jc = jmodels.arm7()
    _, tc = tmodels.arm7()
    first, last = steps
    jt = jcart.upright_term("u", jc, T, "tool", first_step=first,
                            last_step=last)
    tt = tcart.upright_term("u", tc, T, "tool", first_step=first,
                            last_step=last)
    rng = np.random.default_rng(5)
    X = rng.uniform(-1.5, 1.5, (B, T * jc.n_dof))
    plist = [{"coeffs": rng.uniform(0.5, 2.0, 2)} for _ in range(B)]
    _compare_term(jt, tt, X, plist, _stack_params(plist))


def test_import_loads_neither_jax_nor_reference():
    code = ("import sys, trajopt_tpu_torch, trajopt_tpu_torch.benchmarks, "
            "trajopt_tpu_torch.solver.sqp, trajopt_tpu_torch.convert, "
            "trajopt_tpu_torch.collision.world, "
            "trajopt_tpu_torch.collision.geometry, "
            "trajopt_tpu_torch.collision.decompose, "
            "trajopt_tpu_torch.terms.collision, "
            "trajopt_tpu_torch.__main__, "
            "trajopt_tpu_torch.problem.json_io\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'trajopt_tpu' or m.startswith('trajopt_tpu.')]\n"
            "assert not bad, bad\n"
            "import torch\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not torch.backends.cudnn.allow_tf32\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_default_to_cuda():
    """Without CUDA, every entry point called without device= raises."""
    from trajopt_tpu_torch.benchmarks import (make_glass_upright,
                                              make_glass_upright_free,
                                              make_pick_and_place,
                                              solve_pick_and_place)
    from trajopt_tpu_torch.problem.trajectory import TrajProblemBuilder
    from trajopt_tpu_torch.solver.sqp import solve_batch_compact
    from trajopt_tpu_torch.ops.ipm_qp import solve_ipm_qp

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    _, tc = tmodels.arm7()
    with pytest.raises(RuntimeError, match="CUDA"):
        TrajProblemBuilder(tc, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_glass_upright_free(2, n_steps=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_glass_upright(2, n_steps=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_pick_and_place(2, n_steps=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_pick_and_place(2, n_steps=4)
    spec, data, _ = make_glass_upright_free(2, n_steps=4, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_batch_compact(spec, data)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_ipm_qp(None)
