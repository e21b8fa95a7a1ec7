"""Cartesian terms (``trajopt_tpu/terms/cartesian.py:189-245``).

Only ``upright_term`` is ported so far; the pose, line and velocity terms
(which need ``lie.rot_log``) come in a later slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..kinematics.chain import Chain
from ..ops.banded_rows import step_window
from ..utils.lanes import lane_broadcast
from .base import eq_constraint, squared_cost


def upright_term(
    name: str,
    chain: Chain,
    n_steps: int,
    link: str,
    first_step: int = 0,
    last_step: Optional[int] = None,
    is_constraint: bool = True,
):
    """Keep a link's local +z axis parallel to world +z (the classic
    "glass upright" task): rows are the world x/y components of the link
    z-axis at each step, scaled by params["coeffs"] (B, 2).

    The Jacobian is analytic: a revolute dof d that moves the link turns
    its z-axis at rate ``omega_d x z`` (omega_d the dof's world axis), so
    row block t is ``(omega_d x z_t)[:2] * coeffs`` over the dofs — the
    same numbers the JAX package gets from ``jacfwd`` through FK.
    """
    n_dof = chain.n_dof
    li = chain.link_index(link)
    last = (n_steps - 1) if last_step is None else last_step
    span = last - first_step + 1
    steps = first_step + np.arange(span)

    def _coeffs(x, p):
        return lane_broadcast(p["coeffs"].to(x.dtype), (2,))

    def fn(x, p):
        X = x.reshape(x.shape[0], n_steps, n_dof)[:, first_step:last + 1]
        R, _ = chain.fk(X)  # (B, span, L, 3, 3)
        zaxes = R[..., li, :2, 2]  # (B, span, 2)
        return (zaxes * _coeffs(x, p)[:, None, :]).reshape(x.shape[0], -1)

    def _jac_steps(x, p):
        """(B, span, 2, n_dof) per-step Jacobian blocks."""
        X = x.reshape(x.shape[0], n_steps, n_dof)[:, first_step:last + 1]
        z, _, R, _ = chain.joint_frames(X)  # z (B, span, D, 3)
        c = chain._tensors(x.dtype, x.device)
        zl = R[..., li, :, 2]  # (B, span, 3)
        dz = torch.linalg.cross(z, zl[..., None, :].expand_as(z))
        dz = dz * (c["ancestor"][li] * c["rev"])[:, None]  # (B, span, D, 3)
        return dz[..., :2].transpose(-1, -2) * _coeffs(x, p)[:, None, :, None]

    def jac_fn(x, p):
        """Rows at step t depend only on q_t: scatter the per-step blocks."""
        Js = _jac_steps(x, p)
        B = x.shape[0]
        J = torch.zeros((B, span, 2, n_steps, n_dof), dtype=x.dtype,
                        device=x.device)
        s = torch.arange(span, device=x.device)
        J[:, s, :, first_step + s, :] = Js.permute(1, 0, 2, 3)
        return J.reshape(B, 2 * span, n_steps * n_dof)

    def jac_banded_fn(x, p):
        return step_window(_jac_steps(x, p), steps, n_steps)

    n = 2 * span
    if is_constraint:
        # per-step groups: the reference hatches one pose term per timestep
        return eq_constraint(name, n, fn, jac_fn=jac_fn, viol_groups=span,
                             step_coupling=0, jac_banded_fn=jac_banded_fn)
    return squared_cost(name, n, fn, jac_fn=jac_fn, step_coupling=0,
                        jac_banded_fn=jac_banded_fn)
