"""K2 / K3's block-inverse form against JAX and the plain versions, on the
CPU.

K6 ``ipm_banded`` and K11 ``ipm_dense``'s block route factor and solve the
block-tridiagonal K through the inverses of the pivot blocks' Cholesky
factors (``csrc/banded.cuh``): the factor forms L_t^{-1} beside L_t, the
couplings W_t = L_t^{-1} M_t and V_t = L_t^{-T} M_{t+1}^T, and each solve
is two recurrences of b x b products with no division.  Its host build
(``ops.btridiag.btd_inverse_host``, ``csrc/ipm_host.cpp``) runs the same
device functions by a team of one thread.  Here it is held, on random
SPD block-tridiagonal K made with numpy from a seed (one factor, several
right-hand sides), against JAX's ``btd_factor_scalar`` /
``btd_solve_scalar`` (the IPM's factor and solve) and the port's
``btd_factor_plain`` / ``btd_solve_plain``: float64 at a condition number
of at most 1e4 within 1e-10 of max |x| (condition x eps ~2e-12, with
room), float32 at most 1e3 within 5e-3 (~6e-5, with room).  A block
pinned at 1e10 on its diagonal (a pinned coordinate's capped barrier) is
held alike; a block whose pivot meets the Cholesky floor gives finite
values wherever the plain version does, and the same values on the
coordinates the floor does not touch.  The build whose fast paths all
report that they did not hold runs the exact fallback, bit for bit the
fast path's.  K6's shared-memory layout (its block inverses, couplings
and scratch) is held against the wrapper's mirror.

The float32 open check on 7b's first QP: JAX's own float32 IPM on it, the
port's plain loop and K6's host build (the block-inverse form) end at the
same statuses.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.ops.btridiag import btd_factor_scalar, btd_solve_scalar
from trajopt_tpu.ops.ipm_qp import solve_ipm_qp as j_solve
from trajopt_tpu.ops.prox_qp import ProxQPData as JData
from trajopt_tpu.ops.qp import QPSettings as JSettings
from trajopt_tpu_torch import _native
from trajopt_tpu_torch.ops.btridiag import (btd_factor_plain,
                                            btd_inverse_host,
                                            btd_solve_plain)
from trajopt_tpu_torch.ops.ipm_qp import (k6_smem_layout, k6_smem_plan,
                                          solve_ipm_qp_host)
from trajopt_tpu_torch.ops.ipm_qp import solve_ipm_qp as t_solve

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
import chip_smoke as CS  # noqa: E402

LANES, NRHS = 2, 3
BLOCKS = (1, 2, 7, 8, 9, 21)
STEPS = (1, 2, 5, 30)
# condition numbers of the systems and the tolerances, relative to max |x|
COND = {torch.float64: 1e4, torch.float32: 1e3}
TOL = {torch.float64: 1e-10, torch.float32: 5e-3}
PIN = 1e10  # a pinned coordinate's capped barrier (ipm.cuh dcap, float32)


def _system(seed, b, T, cond):
    """LANES random SPD block-tridiagonal K (float64, dense) of condition
    number cond / 2 (at most cond): B B' + delta I with B lower block
    bidiagonal; its blocks D (lanes, T, b, b), O (lanes, T-1, b, b)."""
    rng = np.random.default_rng(seed)
    n = T * b
    Ks = []
    for _ in range(LANES):
        B = np.zeros((n, n))
        for t in range(T):
            B[t * b:(t + 1) * b, t * b:(t + 1) * b] = rng.normal(size=(b, b))
            if t:
                B[t * b:(t + 1) * b, (t - 1) * b:t * b] = \
                    0.5 * rng.normal(size=(b, b))
        K = B @ B.T
        lam = np.linalg.eigvalsh(K)
        c = cond / 2
        K += max(0.0, (lam[-1] - c * lam[0]) / (c - 1)) * np.eye(n)
        Ks.append(K)
    K = np.stack(Ks)
    assert np.linalg.cond(K).max() <= cond
    return K, *_blocks(K, T, b)


def _blocks(K, T, b):
    D = np.stack([K[:, t * b:(t + 1) * b, t * b:(t + 1) * b]
                  for t in range(T)], 1)
    O = np.stack([K[:, (t + 1) * b:(t + 2) * b, t * b:(t + 1) * b]
                  for t in range(T - 1)], 1) if T > 1 \
        else np.zeros((K.shape[0], 0, b, b))
    return D, O


def _jax_solve(D, O, R, dtype):
    """JAX's btd_factor_scalar / btd_solve_scalar on every lane and
    right-hand side at once (their scalar arithmetic on batch-shaped
    values: the lanes and right-hand sides as trailing axes)."""
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    Dj = jnp.asarray(np.moveaxis(D, 0, -1)[..., None], jd)
    Oj = jnp.asarray(np.moveaxis(O, 0, -1)[..., None], jd)
    Rj = jnp.asarray(np.moveaxis(R, (0, 1), (-2, -1)), jd)
    x = btd_solve_scalar(btd_factor_scalar(Dj, Oj), Rj)
    return np.moveaxis(np.asarray(x, np.float64), (-2, -1), (0, 1))


def _plain(D, O, R, dtype):
    LD, LM = btd_factor_plain(torch.as_tensor(D, dtype=dtype),
                              torch.as_tensor(O, dtype=dtype))
    return torch.stack([btd_solve_plain(LD, LM, torch.as_tensor(
        R[:, k], dtype=dtype)) for k in range(R.shape[1])], 1).double().numpy()


def _inverse_form(D, O, R, dtype, fallback=False):
    X, fell = btd_inverse_host(torch.as_tensor(D, dtype=dtype),
                               torch.as_tensor(O, dtype=dtype),
                               torch.as_tensor(R, dtype=dtype), fallback)
    return X, fell


def _assert_close(got, ref, tol, what):
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max() / scale
    assert err <= tol, f"{what}: {err:.3e} of max |x| (tolerance {tol})"


@pytest.fixture(scope="module", autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("T", STEPS)
@pytest.mark.parametrize("b", BLOCKS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_inverse_form_matches_reference_and_plain(dtype, b, T):
    """One factor, NRHS right-hand sides: x against JAX's scalar factor
    and solve and against the plain versions, in the same dtype."""
    K, D, O = _system(100 * b + T, b, T, COND[dtype])
    R = np.random.default_rng(b + 7 * T).normal(size=(LANES, NRHS, T, b))
    X, fell = _inverse_form(D, O, R, dtype)
    assert not fell.any()
    X = X.double().numpy()
    _assert_close(X, _jax_solve(D, O, R, dtype), TOL[dtype], "vs JAX")
    _assert_close(X, _plain(D, O, R, dtype), TOL[dtype], "vs plain")
    if dtype == torch.float64:  # and the exact solution
        xe = np.linalg.solve(K[:, None], R.reshape(LANES, NRHS, -1, 1))
        _assert_close(X, xe.reshape(X.shape), TOL[dtype], "vs numpy")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_pinned_block_and_the_floor(dtype):
    """b 7, T 5: block 2 pinned (1e10 added to its diagonal) is held
    within the tolerance of max |x| against JAX and the plain versions;
    coordinate 0 of block 0 decoupled with a zero diagonal meets the
    Cholesky floor: every value finite where the plain version's is, and
    the other coordinates within the tolerance."""
    b, T = 7, 5
    _, D, O = _system(5, b, T, COND[dtype])
    R = np.random.default_rng(11).normal(size=(LANES, NRHS, T, b))
    Dp = D.copy()
    Dp[:, 2] += PIN * np.eye(b)
    X = _inverse_form(Dp, O, R, dtype)[0].double().numpy()
    _assert_close(X, _jax_solve(Dp, O, R, dtype), TOL[dtype], "pinned, JAX")
    _assert_close(X, _plain(Dp, O, R, dtype), TOL[dtype], "pinned, plain")
    Df, Of = D.copy(), O.copy()
    Df[:, 0, 0, :] = Df[:, 0, :, 0] = 0.0
    Of[:, 0, :, 0] = 0.0
    X = _inverse_form(Df, Of, R, dtype)[0].double().numpy()
    P = _plain(Df, Of, R, dtype)
    assert (np.isfinite(X) | ~np.isfinite(P)).all()
    assert np.isfinite(X[:, :, 0, 0]).all()
    rest = np.ones(X.shape, bool)
    rest[:, :, 0, 0] = False
    _assert_close(X[rest], P[rest], TOL[dtype], "floored, plain")
    _assert_close(X[rest], _jax_solve(Df, Of, R, dtype)[rest], TOL[dtype],
                  "floored, JAX")


@pytest.mark.parametrize("b", [1, 7, 21])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_fallback_is_the_fast_path_bit_for_bit(dtype, b):
    """The build whose fast paths all report that they did not hold takes
    the exact fallback on every lane, with the same bits."""
    T = 5
    _, D, O = _system(3 + b, b, T, COND[dtype])
    R = np.random.default_rng(b).normal(size=(LANES, NRHS, T, b))
    X, fell = _inverse_form(D, O, R, dtype)
    Xf, fellf = _inverse_form(D, O, R, dtype, fallback=True)
    assert not fell.any() and fellf.all()
    assert torch.equal(X, Xf)


def test_k6_layout_mirror():
    """ops.ipm_qp.k6_smem_layout against ipm::smem_layout (the host
    build's ipm_banded_layout), and the plan's choice at the flagship's
    sizes: float32 keeps the rows and the scratch in shared memory,
    float64 the scratch only."""
    import ctypes
    lib = _native.host_library("ipm_host")
    for n, b, mh, ma in ((210, 7, 1624, 67), (240, 8, 1218, 7),
                         (63, 21, 40, 9), (5, 1, 0, 2)):
        nb = n // b
        for rows in (0, 1):
            for scr in (0, 1):
                out = (ctypes.c_long * 10)()
                assert lib.ipm_banded_layout(n, b, nb, mh, ma, rows, scr,
                                             out) == 0
                parts = list(k6_smem_layout(n, b, nb, mh, ma, bool(rows),
                                            bool(scr)).values())
                offs = np.cumsum(parts)
                # the offsets of O, V, w, the n-vectors, the reduction; the rows, the
                # scratch and the total
                assert list(out)[:5] == list(offs[:5])
                assert list(out)[6:] == list(offs[5:])
    f32 = k6_smem_plan(210, 7, 30, 1624, 67, 4)
    assert (f32["rows"], f32["scratch"]) == ("shared", "shared")
    assert f32["bytes_by_part"]["V"] == 29 * 49 * 4
    f64 = k6_smem_plan(210, 7, 30, 1624, 67, 8)
    assert (f64["rows"], f64["scratch"]) == ("device", "shared")


def test_float32_table_time_qp_ends_as_the_reference(monkeypatch):
    """7b's first QP (``json_table_time``: the 1/dt grid, b 8, T=30,
    captured in float32 from the port's SQP at 4 lanes): JAX's own float32
    solve_ipm_qp lane by lane ends every lane at status 2, as the port's
    plain loop and K6's host build do (float32 does not resolve this QP
    in the reference either)."""
    from trajopt_tpu_torch.solver import sqp

    lanes = 4
    spec, data, par = CS.port_json_problem(
        CS.json_docs("table_time", lanes), torch.float32, "cpu")[:3]
    got = []

    class _Captured(Exception):
        pass

    def first_qp(qd, st, **kw):
        got.append((qd, st))
        raise _Captured
    monkeypatch.setattr(sqp, "solve_ipm_qp", first_qp)
    with pytest.raises(_Captured):
        sqp.solve_batch(spec, data, par, device="cpu")
    qd, st = got[0]
    assert st.kkt_block == 8 and qd.q.shape == (lanes, 240)
    assert qd.q.dtype == torch.float32
    jst = JSettings(**{f: getattr(st, f) for f in (
        "eps_abs", "eps_rel", "max_ipm_iter", "kkt_block", "solver")})
    ref_st = []
    for z in range(lanes):
        jd = JData(**{k: jnp.asarray(getattr(qd, k)[z].numpy()) for k in (
            "P", "q", "e_h", "w_h", "e_a", "w_a", "lb", "ub")},
            A_h=None, A_a=None,
            Bh=tuple(jnp.asarray(B[z].numpy()) for B in qd.Bh),
            Gh=tuple(jnp.asarray(np.asarray(G, np.int32)) for G in qd.Gh),
            Ba=tuple(jnp.asarray(B[z].numpy()) for B in qd.Ba),
            Ga=tuple(jnp.asarray(np.asarray(G, np.int32)) for G in qd.Ga))
        assert jd.q.dtype == jnp.float32
        ref_st.append(int(j_solve(jd, jst).status))
    plain = t_solve(qd, st, device="cpu").status.numpy()
    host = solve_ipm_qp_host(qd, st).status.numpy()
    assert ref_st == [2] * lanes, ref_st
    np.testing.assert_array_equal(plain, ref_st)
    np.testing.assert_array_equal(host, ref_st)
