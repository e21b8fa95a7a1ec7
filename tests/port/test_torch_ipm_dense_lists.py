"""K11 ``ipm_dense``'s lists of nonzeros, in its host build (float64 and
float32 on the CPU), on dense rows with the zeros the problems' terms
leave.

K11 lists, once per launch, the nonzeros of the scaled and raw rows (by
rows and by columns) and of P, and runs every sum of its loop over them,
leaving out the terms whose matrix entry is zero; where a vector or a
diagonal meets a zero with a non-finite value it takes the dense order
(0 * inf is NaN).  The fixture here has the structures the dense-row paths
meet: rows touching one step block or two (a pose row, a velocity row),
one row over every step's last column (7c(ii)'s total_time row, on the
dense route), all-zero rows, rows whose only nonzeros lie in the pinned
first step (their scaled row is zero, their raw row is not), and a P with
zero blocks (no velocity cost over one gap).  Against the plain loop its
statuses and iteration counts are equal and dx within ``HOST_TOL`` of the
largest |dx|, against JAX's ``solve_ipm_qp`` as ``test_torch_ipm_dense``;
the host entry whose lists hold every entry, zeros too, gives every
output bit for bit; so do the dense order (``lists=False``, which a QP
under ``K11_LISTS_MIN_N`` columns takes) and every shared-memory plan;
lanes with a non-finite barrier diagonal or a NaN Newton direction decide
as the plain loop does.  The lists are forced on here (the dense route's
fixture has 21 columns).  ``chip_smoke.k11_nonzero_counts``, which K11's bound counts
from, is held against a numpy count.
"""

import ctypes
import itertools
import os
import sys

import numpy as np
import pytest
import torch

from trajopt_tpu_torch import _native
from trajopt_tpu_torch.ops.ipm_qp import (K11_REGIONS, _finish, _k11_args,
                                          _loop_plain, _setup, ipm_dense_host,
                                          k11_nonzeros, k11_region_sizes)
from trajopt_tpu_torch.ops.ipm_qp import solve_ipm_qp as t_solve
from trajopt_tpu_torch.ops.prox_qp import ProxQPData as TData
from trajopt_tpu_torch.ops.qp import QPSettings as TSettings

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)
sys.path.insert(0, os.path.dirname(os.path.dirname(_HERE)))
import chip_smoke as CS  # noqa: E402
from test_torch_ipm import HOST_TOL, _assert_same_run, _settings  # noqa: E402
from test_torch_ipm_dense import _against_jax  # noqa: E402

# route -> (steps, step width b, kkt_block), as test_torch_ipm_dense's
ROUTES = {"block_b7": (5, 7, 7), "dense": (3, 7, 21)}


def _structured(route, lanes=4, seed=0):
    """(arrays, dense QP data, settings) on ``route`` with the zeros of
    the dense-row paths' terms (see the module docstring)."""
    nb, b, kkt = ROUTES[route]
    n = nb * b
    rng = np.random.default_rng(seed)
    # a joint-velocity cost with no weight over gap 1: P's blocks coupling
    # steps 1 and 2 are zero
    S = np.zeros(((nb - 1) * b, n))
    for t in range(nb - 1):
        for d in range(b):
            S[t * b + d, t * b + d] = -1.0
            S[t * b + d, (t + 1) * b + d] = 1.0
    wv = rng.uniform(1, 5, (lanes, S.shape[0]))
    wv[:, b:2 * b] = 0.0
    P = np.stack([2.0 * S.T @ np.diag(w) @ S for w in wv]) \
        + np.eye(n)[None] * 0.1
    Ah, Aa = [], []
    for t in range(nb - 1):  # velocity rows: two steps, one joint each
        for d in (0, 3):
            r = np.zeros((lanes, n))
            r[:, t * b + d] = -rng.uniform(0.5, 2, lanes)
            r[:, (t + 1) * b + d] = rng.uniform(0.5, 2, lanes)
            Ah.append(r)
    for t in range(1, nb):  # pose rows: one step's columns
        r = np.zeros((lanes, n))
        r[:, t * b:(t + 1) * b] = rng.normal(size=(lanes, b))
        Ah.append(r)
    if route == "dense":  # total time: every step's last column
        r = np.zeros((lanes, n))
        r[:, b - 1::b] = 1.0
        Ah.append(r)
    Ah.append(np.zeros((lanes, n)))  # an all-zero row
    r = np.zeros((lanes, n))  # nonzeros in the pinned step only
    r[:, :b] = rng.normal(size=(lanes, b))
    Ah.append(r)
    r = np.zeros((lanes, n))  # the goal: the last step
    r[:, (nb - 1) * b:] = np.eye(b)[0] + rng.normal(size=(lanes, b)) * 0.1
    Aa.append(r)
    Aa.append(np.zeros((lanes, n)))
    r = np.zeros((lanes, n))
    r[:, 2:4] = rng.normal(size=(lanes, 2))
    Aa.append(r)
    A_h, A_a = np.stack(Ah, 1), np.stack(Aa, 1)
    mh, ma = A_h.shape[1], A_a.shape[1]
    e_h = rng.normal(size=(lanes, mh)) * 0.3
    e_h[:, -2] = -0.5  # the all-zero hinge row: inactive
    e_a = rng.normal(size=(lanes, ma)) * 0.3
    lb = -rng.uniform(0.05, 0.3, (lanes, n))
    ub = rng.uniform(0.05, 0.3, (lanes, n))
    pin = rng.uniform(-0.02, 0.02, (lanes, b))
    lb[:, :b] = pin
    ub[:, :b] = pin
    arrays = dict(P=P, q=rng.normal(size=(lanes, n)), e_h=e_h,
                  w_h=rng.uniform(1, 20, (lanes, mh)), e_a=e_a,
                  w_a=rng.uniform(1, 20, (lanes, ma)), lb=lb, ub=ub)
    data = TData(**{k: torch.as_tensor(v) for k, v in arrays.items()},
                 A_h=torch.as_tensor(A_h), A_a=torch.as_tensor(A_a),
                 Bh=(), Gh=(), Ba=(), Ga=())
    return arrays, data, _settings(False, kkt)


def _equal(a, b):
    """Two runs' final states equal in every output (NaN where NaN)."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        same = (x == y) | (torch.isnan(x) & torch.isnan(y)) \
            if x.is_floating_point() else x == y
        assert bool(same.all()), f


@pytest.mark.parametrize("route", list(ROUTES))
def test_k11_lists_match_plain_and_reference(route):
    """The structured fixture on both routes: the host build against the
    plain loop (HOST_TOL) and JAX (1e-8); its lists hold fewer entries
    than the rows, and the lists of every entry give every output bit for
    bit, in float64 and float32."""
    arrays, dense, kw = _structured(route)
    st = TSettings(**kw)
    su = _setup(dense, st)
    assert (su.nb > 0) == (route == "block_b7")
    nz = k11_nonzeros(su)
    assert nz[0] < su.mh * su.n // 3 and nz[2] > nz[0], nz  # pinned rows
    sol = _finish(su, ipm_dense_host(su, lists=True))
    _assert_same_run(sol, t_solve(dense, st, device="cpu"), HOST_TOL)
    _against_jax(arrays, dense, kw, sol)
    for dt in (torch.float64, torch.float32):
        sd = _setup(dense._replace(**{k: getattr(dense, k).to(dt) for k in (
            "P", "q", "e_h", "w_h", "e_a", "w_a", "lb", "ub", "A_h",
            "A_a")}), st)
        got = ipm_dense_host(sd, lists=True)
        _equal(got, ipm_dense_host(sd, every_index=True, lists=True))
        _equal(got, ipm_dense_host(sd, lists=False))


@pytest.mark.parametrize("route", list(ROUTES))
def test_k11_lists_every_plan_alike(route):
    """Every shared-memory plan (each region, the lists and the packed K
    among them, in the shared array or in the device scratch), with the
    sums over the lists or in the dense order, gives every output bit for
    bit."""
    _, dense, kw = _structured(route, seed=1)
    su = _setup(dense, TSettings(**kw))
    ref = ipm_dense_host(su, lists=True)
    for smem in itertools.product((0, 1), repeat=len(K11_REGIONS)):
        for lists in (True, False):
            _equal(ipm_dense_host(su, smem, lists=lists), ref)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("case", ["nan_diagonal", "nan_direction"])
def test_k11_lists_non_finite_lanes(route, case):
    """Lane 1 meets a non-finite value at a listed zero: an infinite hinge
    weight (its barrier diagonal is NaN from the first iteration) or a
    negative definite P (a broken factor, a NaN Newton direction).  It
    decides as the plain loop does (statuses, iterations, x), and as the
    lists of every entry do, bit for bit; the other lanes solve."""
    arrays, dense, kw = _structured(route, seed=2)
    if case == "nan_diagonal":
        arrays["w_h"][1, 0] = np.inf
    else:
        arrays["P"][1] = -50.0 * np.eye(dense.q.shape[1])
    dense = dense._replace(**{k: torch.as_tensor(arrays[k])
                              for k in ("w_h", "P")})
    st = TSettings(**kw)
    su = _setup(dense, st)
    got = ipm_dense_host(su, lists=True)
    _equal(got, ipm_dense_host(su, every_index=True, lists=True))
    ref = _loop_plain(su)
    np.testing.assert_array_equal(got.status.numpy(), ref.status.numpy())
    np.testing.assert_array_equal(got.it.numpy(), ref.it.numpy())
    _assert_same_run(_finish(su, got), _finish(su, ref), HOST_TOL)
    assert int(got.it[1]) == 1
    assert (got.status[[0, 2, 3]] != 3).all()


@pytest.mark.parametrize("route", list(ROUTES))
def test_k11_nonzero_counts_match_numpy(route):
    """chip_smoke.k11_nonzero_counts (K11's bound's counts) against a
    numpy count per lane: the nonzeros of every list, and the pairs of a
    row's nonzeros in the part of K the assembly fills (the block route's
    band of b x b blocks, else the lower triangle)."""
    _, dense, kw = _structured(route, seed=3)
    su = _setup(dense, TSettings(**kw))
    got = CS.k11_nonzero_counts(dense, su)
    mats = {"h": su.Jh, "a": su.Ja, "rh": dense.A_h, "ra": dense.A_a,
            "p": su.P, "pr": dense.P}
    for k, M in mats.items():
        np.testing.assert_array_equal(
            got[k], np.count_nonzero(M.numpy(), axis=(1, 2)))
    assert tuple(int(got[k].max()) for k in (
        "h", "a", "rh", "ra", "p", "pr")) == k11_nonzeros(su)
    want = []
    for z in range(su.lanes):
        c = 0
        for J in (su.Jh[z].numpy(), su.Ja[z].numpy()):
            for row in J:
                cols = np.flatnonzero(row)
                for r in cols:
                    for cc in cols:
                        near = not su.nb or abs(r // su.bsz
                                                - cc // su.bsz) <= 1
                        c += int(cc <= r and near)
        want.append(c)
    np.testing.assert_array_equal(got["pairs"], want)


@pytest.mark.parametrize("route", list(ROUTES))
def test_k11_region_sizes_mirror_the_kernel(route):
    """ops.ipm_qp.k11_region_sizes, which sizes the device scratch, gives
    each region's elements as csrc/ipm_dense.cuh lays them out, in float32
    and float64, with the lists' capacities of these inputs and of every
    entry."""
    _, dense, kw = _structured(route, seed=4)
    for dt in (torch.float64, torch.float32):
        su = _setup(dense._replace(**{k: getattr(dense, k).to(dt) for k in (
            "P", "q", "e_h", "w_h", "e_a", "w_a", "lb", "ub", "A_h",
            "A_a")}), TSettings(**kw))
        for every in (False, True):
            args, _ = _k11_args(su, every_index=every, lists=True)
            out = (ctypes.c_long * 5)()
            fn = getattr(_native.host_library("ipm_host"), "ipm_dense_sizes_"
                         + ("f64" if dt == torch.float64 else "f32"))
            assert fn(ctypes.byref(args), out) == 0
            nz = tuple(getattr(args, f"nz_{k}") for k in (
                "h", "a", "rh", "ra", "p", "pr"))
            want = k11_region_sizes(su.n, args.b, su.nb, su.mh, su.ma, nz,
                                    su.q.element_size())
            assert list(out) == [want[k] for k in K11_REGIONS]
