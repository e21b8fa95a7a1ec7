"""Time-parameterized terms: the 1/dt column, the time-scaled velocity and
the total time (``trajopt_tpu/terms/time.py``).

With ``use_time`` the variable grid grows a per-step column holding
**1/dt** (the reference's dt variables, problem_description.cpp:553-592).
The velocity between steps t-1 and t is ``(x_t - x_{t-1}) * inv_dt_t``
(JointVelErrCalculator, kinematic_terms.cpp:427-442); the total time is
``sum_t 1 / inv_dt_t`` against a limit (TimeCostCalculator,
kinematic_terms.cpp:572-584).

Layout: x (B, n_steps * (n_dof + 1)), the last column of each step is
inv_dt.  Neither term has a ``jac_fn``: ``Term.jac`` differentiates them
(``torch.func.jacfwd`` under ``vmap`` over lanes), as the JAX package
does, and neither has banded windows (the SQP takes the dense rows).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.lanes import lane_broadcast
from .base import Term, eq_constraint, hinge_cost, ineq_constraint, squared_cost


def _cols(x, n_steps, n_dof):
    X = x.reshape(x.shape[0], n_steps, n_dof + 1)
    return X[..., :n_dof], X[..., n_dof]


def _param(p, key, like, shape):
    return lane_broadcast(p[key].to(like.dtype), shape)


def timed_joint_vel_term(
    name: str,
    n_steps: int,
    n_dof: int,
    first_step: int = 0,
    last_step: Optional[int] = None,
    is_constraint: bool = False,
    toleranced: bool = False,
) -> Term:
    """vel_t = (x_{t+1} - x_t) * inv_dt_{t+1}; params as joint_vel's
    ({"targets", "coeffs"} (+ "upper_tols" / "lower_tols"), each (B, ...)
    broadcastable to (span, n_dof))."""
    last = (n_steps - 1) if last_step is None else last_step
    span = last - first_step
    assert span >= 1

    def rows(x, p):
        Q, inv_dt = _cols(x, n_steps, n_dof)
        dq = Q[:, first_step + 1:last + 1] - Q[:, first_step:last]
        vel = dq * inv_dt[:, first_step + 1:last + 1, None]  # (B, span, n_dof)
        return vel, _param(p, "targets", x, (span, n_dof))

    def wf(p, doubled=False):
        w = lane_broadcast(p["coeffs"], (span, n_dof)).reshape(
            p["coeffs"].shape[0], -1)
        return torch.cat([w, w], dim=-1) if doubled else w

    n = span * n_dof
    if not toleranced:
        def fn(x, p):
            vel, targ = rows(x, p)
            return (vel - targ).reshape(x.shape[0], -1)
        if is_constraint:
            def cfn(x, p):
                return fn(x, p) * wf(p).to(x.dtype)
            return eq_constraint(name, n, cfn, step_coupling=1)
        return squared_cost(name, n, fn, weight_fn=wf, step_coupling=1)

    def fn(x, p):
        vel, targ = rows(x, p)
        up = _param(p, "upper_tols", x, (span, n_dof))
        lo = _param(p, "lower_tols", x, (span, n_dof))
        B = x.shape[0]
        return torch.cat([(vel - targ - up).reshape(B, -1),
                          (targ + lo - vel).reshape(B, -1)], dim=-1)

    if is_constraint:
        def cfn(x, p):
            return fn(x, p) * wf(p, doubled=True).to(x.dtype)
        return ineq_constraint(name, 2 * n, cfn, step_coupling=1)
    return hinge_cost(name, 2 * n, fn,
                      weight_fn=lambda p: wf(p, doubled=True),
                      step_coupling=1)


def total_time_term(
    name: str,
    n_steps: int,
    n_dof: int,
    is_constraint: bool = False,
    as_equality: bool = False,
) -> Term:
    """sum_t dt_t (= sum 1/inv_dt over steps 1..T-1) minus params["limit"]
    (B,).  Cost: a hinge (penalize exceeding the limit) weighted by
    params["coeff"] (B,); constraint: INEQ (or EQ with ``as_equality``)
    scaled by it, as TotalTimeTermInfo (problem_description.cpp:
    1851-1892).  A missing "coeff" is 1."""

    def coeff(p, like):
        if "coeff" not in p:
            return torch.ones((like.shape[0], 1), dtype=like.dtype,
                              device=like.device)
        return p["coeff"].to(like.dtype).reshape(-1, 1)

    def fn(x, p):
        _, inv_dt = _cols(x, n_steps, n_dof)
        total = torch.sum(1.0 / inv_dt[:, 1:], dim=-1)
        return (total - p["limit"].to(x.dtype).reshape(-1))[:, None]

    if is_constraint:
        def cfn(x, p):
            return fn(x, p) * coeff(p, x)
        make = eq_constraint if as_equality else ineq_constraint
        return make(name, 1, cfn)
    return hinge_cost(name, 1, fn,
                      weight_fn=lambda p: coeff(p, p["limit"]))
