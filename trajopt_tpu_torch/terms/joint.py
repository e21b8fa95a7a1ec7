"""Joint-motion terms: position / velocity / acceleration / jerk
(``trajopt_tpu/terms/joint.py:37-230``).

- finite-difference stencils over the (n_steps, n_dof) trajectory grid:
    vel  =  x[t+1] - x[t]                      t in [first, last-1]
    acc  =  x[t] - 2 x[t+1] + x[t+2]           t in [first, last-2]
    jerk = -x[t] + 3 x[t+1] - 3 x[t+2] + x[t+3]  (trajectory_costs.cpp:775)
- equality targets -> SQUARED cost or EQ constraint rows;
- toleranced targets (upper/lower) -> HINGE cost or INEQ rows, two per
  element:  (v - targ - upper_tol)  and  (targ + lower_tol - v).

Rows are laid out step-major then dof; weights broadcast per-dof coeffs.
Every function takes ``x`` (B, n_x) and per-lane params (B, ...).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .base import (
    Term,
    eq_constraint,
    hinge_cost,
    ineq_constraint,
    squared_cost,
)
from ..utils.lanes import lane_broadcast


def _stencil(order: int):
    if order == 0:
        return (1.0,)
    if order == 1:
        return (-1.0, 1.0)
    if order == 2:
        return (1.0, -2.0, 1.0)
    if order == 3:
        return (-1.0, 3.0, -3.0, 1.0)
    raise ValueError(order)


class _Const:
    """A host (numpy) constant handed out as a tensor in the caller's
    dtype and device, copied there once per (dtype, device)."""

    def __init__(self, a: np.ndarray):
        self.a = a
        self._t: dict = {}

    def __call__(self, like: torch.Tensor, dtype=None) -> torch.Tensor:
        dtype = like.dtype if dtype is None else dtype
        key = (dtype, str(like.device))
        t = self._t.get(key)
        if t is None:
            t = torch.as_tensor(self.a, dtype=dtype, device=like.device)
            self._t[key] = t
        return t


def _diff_rows(x, n_steps, n_dof, first, last, order, n_cols=None):
    """(B, n_rows) stencil values over [first, last-order], step-major.

    ``n_cols`` > n_dof when the variable grid carries extra columns (the
    1/dt column of use_time problems); the stencil only touches the joint
    columns.
    """
    B = x.shape[0]
    X = x.reshape(B, n_steps, n_cols or n_dof)[:, :, :n_dof]
    coefs = _stencil(order)
    span = last - order - first + 1
    out = torch.zeros((B, span, n_dof), dtype=x.dtype, device=x.device)
    for k, c in enumerate(coefs):
        out = out + c * X[:, first + k:first + k + span]
    return out.reshape(B, -1)


def _eq_err_fn(n_steps, n_dof, first, last, order, n_cols=None):
    def fn(x, p):
        vals = _diff_rows(x, n_steps, n_dof, first, last, order, n_cols)
        span = last - order - first + 1
        targ = lane_broadcast(p["targets"].to(x.dtype), (span, n_dof))
        return vals - targ.reshape(x.shape[0], -1)
    return fn


def _tol_err_fn(n_steps, n_dof, first, last, order, n_cols=None):
    """Two-sided tolerance rows: [v - t - upper; t + lower - v]."""
    def fn(x, p):
        vals = _diff_rows(x, n_steps, n_dof, first, last, order, n_cols)
        span = last - order - first + 1
        B = x.shape[0]

        def bc(v):
            return lane_broadcast(v.to(x.dtype), (span, n_dof)).reshape(B, -1)
        targ, up, lo = bc(p["targets"]), bc(p["upper_tols"]), bc(p["lower_tols"])
        hi_rows = vals - targ - up
        lo_rows = targ + lo - vals
        return torch.cat([hi_rows, lo_rows], dim=-1)
    return fn


def _weight_fn(span, n_dof, doubled=False):
    def wf(p):
        c = p["coeffs"]
        w = lane_broadcast(c, (span, n_dof)).reshape(c.shape[0], -1)
        return torch.cat([w, w], dim=-1) if doubled else w
    return wf


def _stencil_jac(n_steps, n_dof, first, last, order, n_cols=None):
    """Analytic Jacobian of the stencil rows — a CONSTANT (n_rows, n_x)
    matrix (the reference pre-builds these quadratic forms once,
    trajectory_costs.cpp:28-55)."""
    nc = n_cols or n_dof
    span = last - order - first + 1
    J = np.zeros((span, n_dof, n_steps, nc))
    for k, c in enumerate(_stencil(order)):
        for s in range(span):
            for d in range(n_dof):
                J[s, d, first + k + s, d] += c
    return J.reshape(span * n_dof, n_steps * nc)


def _stencil_banded(n_steps, n_dof, first, last, order, n_cols=None):
    """Static banded window blocks (ops.banded_rows format):
    (B0 (span, n_dof, w*nc), G (span,)) with w = max(order + 1, 2) fine
    blocks per window.  Orders 2-3 produce wider-than-2 windows;
    ops.banded_rows.regroup folds them into 2-superblock windows at the
    coarser KKT block size c * nc."""
    nc = n_cols or n_dof
    span = last - order - first + 1
    coefs = _stencil(order)
    w = max(order + 1, 2)
    B0 = np.zeros((span, n_dof, w * nc))
    if order == 0:
        steps = first + np.arange(span)
        G = np.minimum(steps, n_steps - 2)
        off = steps - G
        for s in range(span):
            for d in range(n_dof):
                B0[s, d, off[s] * nc + d] = coefs[0]
    else:
        G = first + np.arange(span)
        for s in range(span):
            for d in range(n_dof):
                for k, cf in enumerate(coefs):
                    B0[s, d, k * nc + d] = cf
    return B0, np.asarray(G, np.int32)


def joint_motion_term(
    name: str,
    order: int,
    n_steps: int,
    n_dof: int,
    first_step: int = 0,
    last_step: Optional[int] = None,
    is_constraint: bool = False,
    toleranced: bool = False,
    n_cols: Optional[int] = None,
) -> Term:
    """Build a joint pos(0)/vel(1)/acc(2)/jerk(3) term.

    params: {"targets", "coeffs"} (+ "upper_tols"/"lower_tols" when
    toleranced), each (B, ...) with a per-lane shape broadcastable to
    (span, n_dof).
    """
    last = (n_steps - 1) if last_step is None else last_step
    span = last - order - first_step + 1
    assert span >= 1, f"{name}: trajectory too short for order {order}"
    n = span * n_dof
    S_np = _stencil_jac(n_steps, n_dof, first_step, last, order, n_cols)
    S = _Const(S_np)
    S2 = _Const(np.concatenate([S_np, -S_np]))
    if n_steps >= 2:
        B0_np, G_np = _stencil_banded(
            n_steps, n_dof, first_step, last, order, n_cols)
        B0, G = _Const(B0_np), _Const(G_np)
    else:
        B0 = None

    def _wvec(p, x):
        return lane_broadcast(p["coeffs"].to(x.dtype), (span, n_dof))

    def _G(x):
        return G(x, torch.int32)

    if not toleranced:
        fn = _eq_err_fn(n_steps, n_dof, first_step, last, order, n_cols)
        if is_constraint:
            # constraint rows are coeff-scaled (reference folds coeffs in)
            def cfn(x, p, base=fn):
                return base(x, p) * _wvec(p, x).reshape(x.shape[0], -1)

            def cjac(x, p):
                w = _wvec(p, x).reshape(x.shape[0], -1)
                return w[:, :, None] * S(x)
            jb = None
            if B0 is not None:
                def jb(x, p):
                    return B0(x) * _wvec(p, x)[..., None], _G(x)
            return eq_constraint(name, n, cfn, jac_fn=cjac,
                                 step_coupling=order, jac_banded_fn=jb)
        jb = None
        if B0 is not None:
            def jb(x, p):
                return B0(x).expand((x.shape[0],) + B0_np.shape), _G(x)
        return squared_cost(
            name, n, fn, weight_fn=_weight_fn(span, n_dof),
            jac_fn=lambda x, p: S(x).expand((x.shape[0],) + S_np.shape),
            step_coupling=order, jac_banded_fn=jb)

    fn = _tol_err_fn(n_steps, n_dof, first_step, last, order, n_cols)
    # tolerance rows are [v - t - up; t + lo - v] => jac = [S; -S]
    if is_constraint:
        def cfn(x, p, base=fn):
            w = _wvec(p, x).reshape(x.shape[0], -1)
            return base(x, p) * torch.cat([w, w], dim=-1)

        def cjac2(x, p):
            w = _wvec(p, x).reshape(x.shape[0], -1)
            return torch.cat([w, w], dim=-1)[:, :, None] * S2(x)
        jb = None
        if B0 is not None:
            def jb(x, p):
                Bw = B0(x) * _wvec(p, x)[..., None]
                return [(Bw, _G(x)), (-Bw, _G(x))]
        return ineq_constraint(name, 2 * n, cfn, jac_fn=cjac2,
                               step_coupling=order, jac_banded_fn=jb)
    jb = None
    if B0 is not None:
        def jb(x, p):
            Bw = B0(x).expand((x.shape[0],) + B0_np.shape)
            return [(Bw, _G(x)), (-Bw, _G(x))]
    return hinge_cost(
        name, 2 * n, fn, weight_fn=_weight_fn(span, n_dof, doubled=True),
        jac_fn=lambda x, p: S2(x).expand((x.shape[0], 2 * n, S_np.shape[1])),
        step_coupling=order, jac_banded_fn=jb)


def joint_pos_term(name, n_steps, n_dof, **kw) -> Term:
    return joint_motion_term(name, 0, n_steps, n_dof, **kw)


def joint_vel_term(name, n_steps, n_dof, **kw) -> Term:
    return joint_motion_term(name, 1, n_steps, n_dof, **kw)


def joint_acc_term(name, n_steps, n_dof, **kw) -> Term:
    return joint_motion_term(name, 2, n_steps, n_dof, **kw)


def joint_jerk_term(name, n_steps, n_dof, **kw) -> Term:
    return joint_motion_term(name, 3, n_steps, n_dof, **kw)
