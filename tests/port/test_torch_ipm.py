"""PyTorch port vs JAX reference: the interior-point QP solver
(ops.ipm_qp, banded and dense-row paths), float64 on the CPU.

Random flagship-shaped subproblems — a joint-velocity quadratic, hinge rows
on step-gap windows, abs rows on per-step windows plus a goal block, a
trust box and a pinned first step — solved lane by lane by the reference
and as one batch by the port.  Status and iteration count must be equal
and dx agree to 1e-8 (both run the same float64 Newton sequence; only sum
orders differ).

K6 ``ipm_banded``'s device code runs here through its host build
(``solve_ipm_qp_host``, csrc/ipm_host.cpp): against the plain loop it must
give equal statuses and iteration counts and dx within 1e-10 of the
largest |dx| (the same float64 Newton sequence, other sum orders), and
against JAX the reference tolerance above; at block size 7, 9 (the 9-DoF
rail's step width), 14 and 21 (the fixture's rows regrouped to 2- and
3-step superblocks; against JAX with the hinge rows), on row groups whose
windows cover a block from both halves in permuted order, with the rows
and scratch in device memory as well as in the shared-memory array, and
end to end through the SQP.

K6 runs at every block size from 1 to 21 (one instantiation each, in
libraries of a few sizes, ``_native.K6_GROUPS``) and raises above; K4's
Jacobian at every n_dof from 1 to 12 (7 exactly, the others under a
ceiling) and raises above: the dispatch is held as a pure function.  The
host build at b 2 and 3 runs the first QPs of chip_smoke phase 8b's form
(boxbot, T=30, 1,363 swept hinge rows) and of ``time_parameterized``'s
form (spherebot's 1/dt grid), captured on the CPU, against the plain loop
with phase 2d's float64 rules.

The dense-row path (``A_h`` / ``A_a`` set) is held against JAX on both of
its factorizations: the dense Cholesky (n < 2 kkt_block) and the block
Cholesky of the dense K (kkt_block set), on the fixture's rows made dense
with ``bb_to_dense``: equal statuses and iteration counts, dx within 1e-8.
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
from trajopt_tpu_torch.ops.banded_rows import bb_to_dense, regroup, step_window
from trajopt_tpu_torch.ops.ipm_qp import (_finish, _setup, band_plan,
                                          check_p_band, cover_lists,
                                          ipm_banded_host, solve_ipm_qp_host)
from trajopt_tpu_torch.ops.ipm_qp import solve_ipm_qp as t_solve
from trajopt_tpu_torch import _native
from trajopt_tpu_torch.ops.prox_qp import ProxQPData as TData
from trajopt_tpu_torch.ops.qp import QPSettings as TSettings
from trajopt_tpu_torch.terms.collision import jac_instantiation

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
import chip_smoke as CS  # noqa: E402

TOL = 1e-8
HOST_TOL = 1e-10  # K6 host build vs the plain loop, relative to max |dx|
B_SZ, NB = 7, 5


def _problem(rng, lanes, with_hinge=True, nb=NB, b=B_SZ):
    n = b * nb
    S = np.zeros(((nb - 1) * b, n))  # joint-velocity stencil
    for t in range(nb - 1):
        for d in range(b):
            S[t * b + d, t * b + d] = -1.0
            S[t * b + d, (t + 1) * b + d] = 1.0
    P = np.stack([2.0 * S.T @ np.diag(rng.uniform(1, 5, S.shape[0])) @ S
                  for _ in range(lanes)])
    q = rng.normal(size=(lanes, n))
    Bh = (rng.normal(size=(lanes, nb - 1, 3, 2 * b)),) if with_hinge else ()
    Gh = (np.arange(nb - 1, dtype=np.int32),) if with_hinge else ()
    Bstep, Gstep = step_window(torch.as_tensor(rng.normal(size=(lanes, nb, 2, b))),
                               np.arange(nb), nb)
    Ba = (Bstep.numpy(), rng.normal(size=(lanes, 1, b, 2 * b)))
    Ga = (Gstep.numpy(), np.asarray([nb - 2], np.int32))
    mh = sum(B.shape[1] * B.shape[2] for B in Bh)
    ma = sum(B.shape[1] * B.shape[2] for B in Ba)
    lb = -rng.uniform(0.05, 0.3, (lanes, n))
    ub = rng.uniform(0.05, 0.3, (lanes, n))
    pin = rng.uniform(-0.02, 0.02, (lanes, b))
    lb[:, :b] = pin  # pinned first step (fixed timestep)
    ub[:, :b] = pin
    arrays = dict(P=P, q=q, e_h=rng.normal(size=(lanes, mh)),
                  w_h=rng.uniform(1, 20, (lanes, mh)),
                  e_a=rng.normal(size=(lanes, ma)),
                  w_a=rng.uniform(1, 20, (lanes, ma)), lb=lb, ub=ub)
    return arrays, Bh, Gh, Ba, Ga


def _settings(tight, b=B_SZ, **over):
    kw = dict(eps_abs=1e-8, eps_rel=1e-10, max_ipm_iter=40) if tight \
        else dict(eps_abs=1e-4, eps_rel=1e-6, max_ipm_iter=16)
    kw.update(solver="ipm", kkt_block=b, **over)
    return kw


def _tdata(arrays, Bh, Gh, Ba, Ga):
    return TData(**{k: torch.as_tensor(v) for k, v in arrays.items()},
                 A_h=None, A_a=None,
                 Bh=tuple(torch.as_tensor(B) for B in Bh),
                 Gh=tuple(torch.as_tensor(np.array(G)) for G in Gh),
                 Ba=tuple(torch.as_tensor(B) for B in Ba),
                 Ga=tuple(torch.as_tensor(np.array(G)) for G in Ga))


def _regrouped(rng, lanes, with_hinge, c=2):
    """The fixture on 6 steps with its rows regrouped to superblocks of c
    steps (block size 7 c)."""
    arrays, Bh, Gh, Ba, Ga = _problem(rng, lanes, with_hinge, nb=6)

    def rg(Bs, Gs):
        out = [regroup(torch.as_tensor(B), G, B_SZ, c, 6 // c)
               for B, G in zip(Bs, Gs)]
        return (tuple(B.numpy() for B, _ in out),
                tuple(G.numpy() for _, G in out))
    return (arrays, *rg(Bh, Gh), *rg(Ba, Ga))


def _assert_same_run(got, ref, tol):
    """Equal statuses and iteration counts; x within tol of max |x|."""
    np.testing.assert_array_equal(got.status.numpy(), ref.status.numpy())
    np.testing.assert_array_equal(got.iters.numpy(), ref.iters.numpy())
    scale = float(ref.x.abs().max())
    np.testing.assert_allclose(got.x.numpy(), ref.x.numpy(), rtol=0,
                               atol=tol * scale)


@pytest.mark.parametrize("with_hinge", [True, False])
@pytest.mark.parametrize("tight", [False, True])
def test_ipm_matches_reference(with_hinge, tight):
    lanes = 4
    rng = np.random.default_rng(7 + 2 * tight + with_hinge)
    arrays, Bh, Gh, Ba, Ga = _problem(rng, lanes, with_hinge)
    kw = dict(eps_abs=1e-8, eps_rel=1e-10, max_ipm_iter=40) if tight \
        else dict(eps_abs=1e-4, eps_rel=1e-6, max_ipm_iter=16)
    kw.update(solver="ipm", kkt_block=B_SZ)

    tdata = TData(**{k: torch.as_tensor(v) for k, v in arrays.items()},
                  A_h=None, A_a=None,
                  Bh=tuple(torch.as_tensor(B) for B in Bh),
                  Gh=tuple(torch.as_tensor(G) for G in Gh),
                  Ba=tuple(torch.as_tensor(B) for B in Ba),
                  Ga=tuple(torch.as_tensor(np.array(G)) for G in Ga))
    sol = t_solve(tdata, TSettings(**kw), device="cpu")
    for z in range(lanes):
        jd = JData(**{k: jnp.asarray(v[z]) for k, v in arrays.items()},
                   A_h=None, A_a=None,
                   Bh=tuple(jnp.asarray(B[z]) for B in Bh),
                   Gh=tuple(jnp.asarray(G) for G in Gh),
                   Ba=tuple(jnp.asarray(B[z]) for B in Ba),
                   Ga=tuple(jnp.asarray(G) for G in Ga))
        ref = j_solve(jd, JSettings(**kw))
        assert int(sol.status[z]) == int(ref.status), z
        assert int(sol.iters[z]) == int(ref.iters), z
        np.testing.assert_allclose(sol.x[z].numpy(), np.asarray(ref.x),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(sol.u[z].numpy(), np.asarray(ref.u),
                                   rtol=0, atol=TOL)
        # the pinned step comes back exact
        np.testing.assert_array_equal(sol.x[z, :B_SZ].numpy(),
                                      arrays["lb"][z, :B_SZ])
    assert (sol.status >= 1).all()


@pytest.mark.parametrize("b", [B_SZ, 2 * B_SZ, 3 * B_SZ, 9, 8])
@pytest.mark.parametrize("with_hinge", [True, False])
@pytest.mark.parametrize("tight", [False, True])
def test_k6_host_matches_plain_and_reference(with_hinge, tight, b):
    """K6's device code (host build) against the plain loop and JAX (b 9:
    the fixture at the rail's step width; b 8: at the 1/dt grid's)."""
    lanes = 4
    rng = np.random.default_rng(7 + 2 * tight + with_hinge)
    arrays, Bh, Gh, Ba, Ga = (
        _problem(rng, lanes, with_hinge) if b == B_SZ
        else _problem(rng, lanes, with_hinge, b=b) if b in (8, 9)
        else _regrouped(rng, lanes, with_hinge, b // B_SZ))
    kw = _settings(tight, b)
    tdata = _tdata(arrays, Bh, Gh, Ba, Ga)
    sol = solve_ipm_qp_host(tdata, TSettings(**kw))
    _assert_same_run(sol, t_solve(tdata, TSettings(**kw), device="cpu"),
                     HOST_TOL)
    if b != B_SZ and not with_hinge:
        return  # JAX compiles b=8, 9, 14, 21 for ~25 s: the hinge fixtures hold it
    for z in range(lanes):
        jd = JData(**{k: jnp.asarray(v[z]) for k, v in arrays.items()},
                   A_h=None, A_a=None,
                   Bh=tuple(jnp.asarray(B[z]) for B in Bh),
                   Gh=tuple(jnp.asarray(G) for G in Gh),
                   Ba=tuple(jnp.asarray(B[z]) for B in Ba),
                   Ga=tuple(jnp.asarray(G) for G in Ga))
        ref = j_solve(jd, JSettings(**kw))
        assert int(sol.status[z]) == int(ref.status), z
        assert int(sol.iters[z]) == int(ref.iters), z
        np.testing.assert_allclose(sol.x[z].numpy(), np.asarray(ref.x),
                                   rtol=0, atol=TOL)
        # b 9: u within TOL of its largest entry.  The pinned step's abs
        # rows have no free column, scale by the 1e-8 floor, and their
        # slacks reach ~1e8, where one ulp is 1.5e-8 (measured: 2.98e-8 on
        # an entry of 1.3e8, the tight fixture without hinge rows)
        u_tol = TOL * max(1.0, float(np.abs(np.asarray(ref.u)).max())) \
            if b in (8, 9) else TOL
        np.testing.assert_allclose(sol.u[z].numpy(), np.asarray(ref.u),
                                   rtol=0, atol=u_tol)


def test_k6_host_lanes_stop_apart():
    """Lanes that converge early stop while the others run to the cap:
    with max_ipm_iter 12, two lanes of the tight fixture converge (11
    iterations) and two stop at the cap unsolved."""
    rng = np.random.default_rng(9)
    tdata = _tdata(*_problem(rng, 4, True))
    st = TSettings(**_settings(True, max_ipm_iter=12))
    sol = solve_ipm_qp_host(tdata, st)
    ref = t_solve(tdata, st, device="cpu")
    _assert_same_run(sol, ref, HOST_TOL)
    it = sol.iters.numpy()
    assert (it < 12).any() and (it == 12).any(), it
    assert (sol.status.numpy()[it < 12] == 1).all()


def test_k6_host_through_the_sqp(monkeypatch):
    """The free flagship slice end to end with the IPM run by K6's host
    build: equal statuses and QP counts, x within 1e-9."""
    from trajopt_tpu_torch.benchmarks import (bench_params,
                                              make_glass_upright_free)
    from trajopt_tpu_torch.solver import sqp

    spec, data, _ = make_glass_upright_free(3, n_steps=6,
                                            dtype=torch.float64, device="cpu")
    params = bench_params()
    ref = sqp.solve_batch_compact(spec, data, params, device="cpu")
    monkeypatch.setattr(
        sqp, "solve_ipm_qp",
        lambda d, s, device, kernels, plan: solve_ipm_qp_host(d, s, plan))
    got = sqp.solve_batch_compact(spec, data, params, device="cpu")
    np.testing.assert_array_equal(got.status.numpy(), ref.status.numpy())
    np.testing.assert_array_equal(got.n_qp_solves.numpy(),
                                  ref.n_qp_solves.numpy())
    np.testing.assert_allclose(got.x.numpy(), ref.x.numpy(), rtol=0,
                               atol=1e-9)


def test_k6_host_cover_lists_both_halves():
    """Row groups whose windows come in permuted order and overlap, so
    that a block's cover list holds windows of several groups from both
    halves, not in block order: the cover lists keep row-group then window
    order, and K6's host build matches the plain loop on them, with its
    rows and scratch in the shared-memory array and in device memory alike,
    and through the factor's and solves' fallback (bitwise)."""
    lanes, b, nb = 3, B_SZ, NB
    rng = np.random.default_rng(21)
    arrays, _, _, Ba, Ga = _problem(rng, lanes, False)
    Gh = (np.array([2, 0, 3, 1], np.int32), np.array([1, 1, 2], np.int32))
    Bh = (rng.normal(size=(lanes, 4, 3, 2 * b)),
          rng.normal(size=(lanes, 3, 2, 2 * b)))
    mh = 4 * 3 + 3 * 2
    arrays.update(e_h=rng.normal(size=(lanes, mh)),
                  w_h=rng.uniform(1, 20, (lanes, mh)))
    cover = cover_lists(((4, 3), (3, 2)), Gh, nb)
    # block 2: group 0's window 0 (start 2) and window 3 (start 1), then
    # group 1's window 1 (start 1) ... in row-group then window order
    assert cover[2] == [(0, 3, 0), (9, 3, 1), (12, 2, 1), (14, 2, 1),
                        (16, 2, 0)]
    assert {h for _, _, h in cover[2]} == {0, 1}
    tdata = _tdata(arrays, Bh, Gh, Ba, Ga)
    for tight in (False, True):
        st = TSettings(**_settings(tight))
        sol = solve_ipm_qp_host(tdata, st)
        _assert_same_run(sol, t_solve(tdata, st, device="cpu"), HOST_TOL)
        su = _setup(tdata, st)
        plan = band_plan(tdata, b)
        dev_mem = _finish(su, ipm_banded_host(su, plan, smem=(0, 0)))
        _assert_same_run(dev_mem, sol, 0.0)
        exact = _finish(su, ipm_banded_host(su, plan, fallback=True))
        _assert_same_run(exact, sol, 0.0)


def test_p_band_check():
    """K6 forms P v from P's block-tridiagonal blocks: a P with an entry
    two blocks off the diagonal is refused."""
    rng = np.random.default_rng(3)
    arrays = _problem(rng, 2, True)[0]
    P = torch.as_tensor(arrays["P"])
    check_p_band(P, B_SZ)
    P[1, 0, 2 * B_SZ] = P[1, 2 * B_SZ, 0] = 0.5
    with pytest.raises(ValueError, match="block tridiagonal"):
        check_p_band(P, B_SZ)
    check_p_band(P, 3 * B_SZ)  # a coarser block holds it


def test_k6_plan_checks_the_band_and_fits_its_qps():
    """K6's entry point checks P's band itself when given no plan; a plan
    built once serves every QP of the same structure (the SQP's use) and
    refuses one of another structure."""
    rng = np.random.default_rng(5)
    arrays, Bh, Gh, Ba, Ga = _problem(rng, 2, True)
    st = TSettings(**_settings(False))
    plan = band_plan(_tdata(arrays, Bh, Gh, Ba, Ga), B_SZ)
    arrays2 = dict(arrays, q=rng.normal(size=arrays["q"].shape))
    tdata2 = _tdata(arrays2, Bh, Gh, Ba, Ga)
    _assert_same_run(solve_ipm_qp_host(tdata2, st, plan),
                     solve_ipm_qp_host(tdata2, st), 0.0)
    off = dict(arrays, P=arrays["P"].copy())
    off["P"][0, 0, 2 * B_SZ] = off["P"][0, 2 * B_SZ, 0] = 0.5
    with pytest.raises(ValueError, match="block tridiagonal"):
        solve_ipm_qp_host(_tdata(off, Bh, Gh, Ba, Ga), st)
    with pytest.raises(ValueError, match="plan was built"):
        solve_ipm_qp_host(_tdata(*_problem(rng, 2, False)), st, plan)


# the float32 open check: lanes whose iteration counts may differ from
# JAX's (in float32 two sum orders drift apart in the late barrier stages
# and the NaN guard or the cap ends a run at another iteration; on these 6
# lanes the plain loop's counts equal JAX's and K6's host build ends one
# lane at the cap, 16, where JAX stops at 13, both at status 2)
F32_ITERS_APART = 1


def test_float32_flagship_qp_ends_as_the_reference(monkeypatch):
    """The reference's own float32 IPM on the full flagship's first batched
    QP (T=30, captured in float32 from the port's SQP): JAX solve_ipm_qp
    lane by lane, the port's plain loop and K6's host build give the same
    status counts, the same iteration counts on all but F32_ITERS_APART
    lanes, and no lane usable (status 1 or 2)
    on one side and not on the other.  Float32 ends at status 2 (the NaN
    guard or the iteration cap with the incumbent) on both sides alike."""
    from trajopt_tpu_torch.benchmarks import bench_params, make_glass_upright
    from trajopt_tpu_torch.solver import sqp

    lanes = 6
    spec, data, _, _ = make_glass_upright(lanes, n_steps=30,
                                          dtype=torch.float32, device="cpu")
    got = []

    class _Captured(Exception):
        pass

    def first_qp(qd, st, **kw):
        got.append((qd, st))
        raise _Captured
    monkeypatch.setattr(sqp, "solve_ipm_qp", first_qp)
    with pytest.raises(_Captured):
        sqp.solve_batch_compact(spec, data, bench_params(), device="cpu")
    qd, st = got[0]
    assert qd.q.dtype == torch.float32 and qd.q.shape == (lanes, 210)
    plain = t_solve(qd, st, device="cpu")
    host = solve_ipm_qp_host(qd, st)
    jst = JSettings(**{f: getattr(st, f) for f in (
        "eps_abs", "eps_rel", "max_ipm_iter", "kkt_block", "solver")})
    ref_st, ref_it = [], []
    for z in range(lanes):
        jd = JData(**{k: jnp.asarray(getattr(qd, k)[z].numpy()) for k in (
            "P", "q", "e_h", "w_h", "e_a", "w_a", "lb", "ub")},
            A_h=None, A_a=None,
            Bh=tuple(jnp.asarray(B[z].numpy()) for B in qd.Bh),
            Gh=tuple(jnp.asarray(np.asarray(G, np.int32)) for G in qd.Gh),
            Ba=tuple(jnp.asarray(B[z].numpy()) for B in qd.Ba),
            Ga=tuple(jnp.asarray(np.asarray(G, np.int32)) for G in qd.Ga))
        assert jd.q.dtype == jnp.float32
        ref = j_solve(jd, jst)
        ref_st.append(int(ref.status))
        ref_it.append(int(ref.iters))
    ref_st, ref_it = np.asarray(ref_st), np.asarray(ref_it)
    for sol in (plain, host):
        s, it = sol.status.numpy(), sol.iters.numpy()
        np.testing.assert_array_equal(np.bincount(s, minlength=4),
                                      np.bincount(ref_st, minlength=4))
        apart = it != ref_it
        assert apart.sum() <= F32_ITERS_APART, (it, ref_it)
        np.testing.assert_array_equal(np.isin(s, (1, 2)),
                                      np.isin(ref_st, (1, 2)))


@pytest.mark.parametrize("kkt", ["cholesky", "btd"])
def test_dense_rows_match_reference(kkt):
    """The dense-row path: the fixture's hinge and abs rows as dense
    (lanes, m, n) matrices (``bb_to_dense``).  ``cholesky``: three steps
    with kkt_block = n (n < 2 kkt_block: the dense Cholesky and explicit
    inverse); ``btd``: five steps at kkt_block 7 (K formed dense, factored
    block-tridiagonally).  Against JAX lane by lane, and the same QP with
    banded rows through the port."""
    lanes = 4
    nb = 3 if kkt == "cholesky" else NB
    rng = np.random.default_rng(31 + nb)
    arrays, Bh, Gh, Ba, Ga = _problem(rng, lanes, True, nb=nb)
    n = B_SZ * nb
    kw = _settings(False, n if kkt == "cholesky" else B_SZ)
    banded = _tdata(arrays, Bh, Gh, Ba, Ga)
    A_h = bb_to_dense(banded.Bh, banded.Gh, n, B_SZ)
    A_a = bb_to_dense(banded.Ba, banded.Ga, n, B_SZ)
    dense = banded._replace(A_h=A_h, A_a=A_a, Bh=(), Gh=(), Ba=(), Ga=())
    sol = t_solve(dense, TSettings(**kw), device="cpu")
    for z in range(lanes):
        jd = JData(**{k: jnp.asarray(v[z]) for k, v in arrays.items()},
                   A_h=jnp.asarray(A_h[z].numpy()),
                   A_a=jnp.asarray(A_a[z].numpy()))
        ref = j_solve(jd, JSettings(**kw))
        assert int(sol.status[z]) == int(ref.status), z
        assert int(sol.iters[z]) == int(ref.iters), z
        np.testing.assert_allclose(sol.x[z].numpy(), np.asarray(ref.x),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(sol.u[z].numpy(), np.asarray(ref.u),
                                   rtol=0, atol=TOL)
    assert (sol.status >= 1).all()
    if kkt == "btd":  # the same QP with banded rows: the same run
        _assert_same_run(t_solve(banded, TSettings(**kw), device="cpu"), sol,
                         TOL)


def test_card_dispatch_covers_every_size():
    """Which instantiation the card runs: K6 one per block size 1-21, in
    the library of its range (float32 and float64 apart), K4 the 7-DoF one
    at n_dof 7 and the ceiling's at every other n_dof up to 12; b 22 and
    n_dof 13 raise, naming the limit."""
    names = {}
    for f64 in (False, True):
        for b in range(1, 22):
            lib = _native.k6_library(f64, b)
            lo, hi = (int(v) for v in lib.rsplit("_b", 1)[1].split("_"))
            assert lo <= b <= hi and lib.startswith(
                "ipm_banded_f64" if f64 else "ipm_banded_f32")
            assert _native._VARIANTS[lib] == ("ipm_banded", [
                f"-DK6_F64={int(f64)}", f"-DK6_LO={lo}", f"-DK6_HI={hi}"])
            names.setdefault(lib, []).append(b)
    assert sorted(b for bs in names.values() for b in bs) \
        == sorted(list(range(1, 22)) * 2)
    with pytest.raises(ValueError, match="1..21"):
        _native.k6_library(False, 22)
    assert [jac_instantiation(n) for n in range(1, 13)] \
        == [12] * 6 + [7] + [12] * 5
    with pytest.raises(NotImplementedError, match="n_dof 1 to 12"):
        jac_instantiation(13)
    # K6's entry point refuses b 22 before it reaches a library
    rng = np.random.default_rng(2)
    tdata = _tdata(*_problem(rng, 1, True, nb=3, b=22))
    with pytest.raises(ValueError, match="1..21"):
        solve_ipm_qp_host(tdata, TSettings(**_settings(False, 22)))


def _first_qp(monkeypatch, spec, data, params):
    """The SQP's first batched QP of (spec, data) on the CPU (float64)."""
    from trajopt_tpu_torch.solver import sqp

    got = []

    class _Captured(Exception):
        pass

    def first_qp(qd, st, **kw):
        got.append((qd, st))
        raise _Captured
    monkeypatch.setattr(sqp, "solve_ipm_qp", first_qp)
    with pytest.raises(_Captured):
        sqp.solve_batch(spec, data, params, device="cpu")
    return got[0]


@pytest.mark.parametrize("form", ["box_cast_t30", "time_parameterized"])
def test_k6_host_on_captured_qps(monkeypatch, form):
    """K6's host build at b 2 (chip_smoke 8b's first QP: boxbot, 4 lanes,
    T=30, the swept hinge rows) and b 3 (``time_parameterized``'s form at
    8 lanes) against the plain loop, with phase 2d's float64 rules: equal
    statuses, dx within K6_DX_TOL of the lane's largest on lanes with equal
    iteration counts (here: all)."""
    if form == "box_cast_t30":
        prob = CS.port_box_problem(CS.box_docs(form, 4), torch.float64, "cpu")
    else:
        prob = CS.port_json_problem(CS.time_parameterized_docs(8),
                                    torch.float64, "cpu", "spherebot")
    qd, st = _first_qp(monkeypatch, *prob[:3])
    b = 2 if form == "box_cast_t30" else 3
    assert st.kkt_block == b and qd.q.shape[1] == (60 if b == 2 else 15)
    if b == 2:
        assert qd.e_h.shape[1] == 1363
    host = solve_ipm_qp_host(qd, st)
    plain = t_solve(qd, st, device="cpu")
    np.testing.assert_array_equal(host.status.numpy(), plain.status.numpy())
    np.testing.assert_array_equal(host.iters.numpy(), plain.iters.numpy())
    dx = (host.x - plain.x).abs().amax(-1) \
        / plain.x.abs().amax(-1).clamp(min=1e-30)
    assert float(dx.max()) <= CS.K6_DX_TOL, dx
