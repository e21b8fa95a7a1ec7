"""K8 solve_ik as a warp's team routine and K9 / K9v over staged chain
tables, built for the host, against the plain versions (and JAX).

- K8's host build (``csrc/pose_host.cpp``: ``pose.cuh``'s ``ik_team`` by a
  team of one thread) on serial chains of 10 and 12 revolute joints (the
  URDF strings of ``chip_smoke.serial_urdf``, which phase 2f gives K8 on
  the card) against the plain loop by chip_smoke phase 2f's
  ``ik_compare`` rule (iteration counts and convergence equal
  off near-tie lanes; q and the error norms within its tolerances);
- the same on 16 of arm7's lanes, float32 and float64, the full pose and
  ``pos_only``;
- the plain loop against JAX's ``solve_ik`` on the 12-joint chain,
  float64: iteration counts and convergence equal, q within 1e-8;
- K9 / K9v's host build (each CTA's chain paths staged and its lanes'
  sines formed, then its items) against ``cart_pose_rows(kernels=False)``: arm7's world
  target, moving target and band, and a moving target on the 12-joint
  chain whose lanes' columns straddle the CTAs; values on every row
  within ``REL_TOL`` of the largest, Jacobians off the log map's and
  band's switches within ``COLL_TOL``'s, K9's value K9v's bit for bit;
- K8's host build with every shared-reciprocal division's fallback taken
  (``QM_TEST_FALLBACK``) bit for bit as without;
- above 12 dofs K8 raises, naming its limit.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.kinematics import ik as JIK
from trajopt_tpu.kinematics.chain import build_chain as j_build_chain
from trajopt_tpu.kinematics.urdf import parse_urdf as j_parse_urdf
from trajopt_tpu_torch import _native
from trajopt_tpu_torch.kinematics import ik as TIK
from trajopt_tpu_torch.kinematics.chain import build_chain
from trajopt_tpu_torch.kinematics.urdf import parse_urdf
from trajopt_tpu_torch.models import arm7
from trajopt_tpu_torch.ops.lie import rpy_to_matrix
from trajopt_tpu_torch.terms import cartesian as TC

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, _ROOT)
import chip_smoke as CS  # noqa: E402

Q_TOL = 1e-8
_, ARM = arm7()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain loop is many small ops, where torch's intra-op threads
    only add overhead, and the test run shares the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def serial_chains(n):
    """The port's and JAX's chains of chip_smoke's serial arm of n
    revolute joints (``serial_urdf``, the URDF string phase 2f gives K8)."""
    doc = CS.serial_urdf(n)
    names = [f"q{i}" for i in range(1, n + 1)]
    return (build_chain(parse_urdf(doc), names),
            j_build_chain(j_parse_urdf(doc), names))


def host_against_plain(chain, link, tR, tp, q0, dtype):
    """K8's host build against the plain loop, both variants, by phase
    2f's rule; float64 runs end alike on every lane."""
    name = "float64" if dtype == torch.float64 else "float32"
    for po in (False, True):
        args = (chain, link, tR.to(dtype), tp.to(dtype))
        kh = TIK.solve_ik_host(*args, q0=q0.to(dtype), pos_only=po)
        kp, tie = CS.solve_ik_plain_ties(*args, q0.to(dtype), po)
        rec = CS.ik_compare(kh, kp, tie, name)
        assert rec["ok"], rec
        if dtype == torch.float64:
            assert rec["lanes_apart"] == 0, rec
        assert int(kh.converged.sum()) > 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("n", [10, 12])
def test_k8_host_on_long_chains(n, dtype):
    chain, _ = serial_chains(n)
    assert chain.n_dof == n and chain.path_len(chain.link_index("tool")) \
        == n + 2
    link, tR, tp, q0 = CS.serial_ik_queries(chain, 12, seed=n)
    host_against_plain(chain, link, tR, tp, q0, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_k8_host_on_arm7_lanes(dtype):
    inp = CS.ik_inputs(16, seed=9)
    tR, tp, q0 = (torch.as_tensor(inp[k]) for k in
                  ("target_R", "target_p", "q0"))
    host_against_plain(ARM, inp["link"], tR, tp, q0, dtype)


@pytest.mark.parametrize("pos_only", [False, True], ids=["full", "pos_only"])
def test_plain_matches_reference_on_12_joints(pos_only):
    chain, jchain = serial_chains(12)
    link, tR, tp, q0 = CS.serial_ik_queries(chain, 8, seed=3)
    got = TIK.solve_ik(chain, link, tR, tp, q0=q0, pos_only=pos_only,
                       kernels=False)
    ref = jax.jit(jax.vmap(lambda R, p, q: JIK.solve_ik(
        jchain, link, R, p, q0=q, pos_only=pos_only)))(
        *[jnp.asarray(t.numpy()) for t in (tR, tp, q0)])
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(ref.converged))
    assert bool(got.converged.any())
    np.testing.assert_allclose(got.q.numpy(), np.asarray(ref.q), rtol=0,
                               atol=Q_TOL)
    np.testing.assert_allclose(got.err_norm.numpy(),
                               np.asarray(ref.err_norm), rtol=0, atol=Q_TOL)


def _pose_params(lanes, band, seed):
    rng = np.random.default_rng(seed)
    R = rpy_to_matrix(torch.as_tensor(rng.uniform(-0.5, 0.5, (lanes, 2, 3))))
    tol = torch.as_tensor(rng.uniform(0.01, 0.1, (lanes, 6)))
    p = {"target_R": R[:, 0], "target_p": torch.as_tensor(
        rng.uniform(-0.3, 0.3, (lanes, 3))) + torch.tensor([0.3, 0.0, 0.5]),
        "source_off_R": R[:, 1],
        "source_off_p": torch.as_tensor(rng.uniform(-0.1, 0.1, (lanes, 3))),
        "coeffs": torch.as_tensor(rng.uniform(0.5, 2.0, (lanes, 6)))}
    if band:
        p.update(lower_tols=-tol, upper_tols=tol)
    return p


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_k9_host_on_staged_tables(dtype):
    name = "float64" if dtype == torch.float64 else "float32"
    chain12, _ = serial_chains(12)
    T, step, rng = 5, 3, np.random.default_rng(4)
    cases = [(ARM, 16, None, False), (ARM, 16, ARM.link_index("l3"), False),
             (ARM, 16, None, True),
             (chain12, 40, chain12.link_index("s5"), False)]
    for i, (chain, lanes, tgt, band) in enumerate(cases):
        x = torch.as_tensor(rng.uniform(-1.2, 1.2, (lanes, T * chain.n_dof)),
                            dtype=dtype)
        p = {k: v.to(dtype) for k, v in
             _pose_params(lanes, band, seed=i).items()}
        src = chain.link_index("tool")
        E, J = TC.cart_pose_host(chain, x, p, T, step, src, tgt, jac=True)
        Ev = TC.cart_pose_host(chain, x, p, T, step, src, tgt)
        Ep, Jp = TC.cart_pose_rows(chain, x, p, T, step, src, tgt, jac=True,
                                   kernels=False)
        assert torch.equal(E, Ev)
        assert float((E - Ep).abs().max()) \
            <= CS.REL_TOL[name] * float(Ep.abs().max())
        ties = CS.cart_pose_ties(chain, x, p, T, step, src, tgt)
        ok = ~ties[..., None].expand_as(J)
        assert float((J - Jp)[ok].abs().max()) \
            <= CS.COLL_TOL[name][1] * float(Jp.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_k8_host_fallback_divisions_bitwise(dtype):
    """The host build with QM_TEST_FALLBACK, where every division over a
    shared reciprocal takes its qdiv fallback (the elimination's row
    factors, the back-substitution), gives K8's outputs bit for bit."""
    fallback = _native.host_library("pose_host", ("QM_TEST_FALLBACK",))
    chain12, _ = serial_chains(12)
    inp = CS.ik_inputs(8, seed=4)
    arm = (ARM, inp["link"], *(torch.as_tensor(inp[k]) for k in
                               ("target_R", "target_p", "q0")))
    for chain, link, tR, tp, q0 in (arm, (chain12,
                                          *CS.serial_ik_queries(chain12, 8,
                                                                seed=2))):
        for po in (False, True):
            args = (chain, link, tR.to(dtype), tp.to(dtype))
            ref = TIK.solve_ik_host(*args, q0=q0.to(dtype), pos_only=po)
            got = TIK._ik_call(fallback, *args, 60, 1e-6, 1e-3, po,
                               q0.to(dtype))
            assert all(torch.equal(a, b) for a, b in zip(got, ref))
            assert int(ref.iters.sum()) > 0


def test_k8_refuses_chains_above_its_limit():
    chain, _ = serial_chains(_native.CAST_ND_MAX + 1)
    link, tR, tp, q0 = CS.serial_ik_queries(chain, 2, seed=1)
    with pytest.raises(ValueError, match=f"1 to {_native.CAST_ND_MAX}"):
        TIK.solve_ik_host(chain, link, tR, tp, q0=q0)
    # the plain loop takes any chain
    assert TIK.solve_ik(chain, link, tR, tp, q0=q0).q.shape == (2, 13)
