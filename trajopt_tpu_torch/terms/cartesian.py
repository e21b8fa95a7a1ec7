"""Cartesian terms: pose targets, dynamic (link-to-link) poses, line,
velocity and upright (``trajopt_tpu/terms/cartesian.py``).

- ``cart_pose_term``: FK(source link) * source offset against a world
  target pose, or a moving target link * offset; error = [translation;
  angle-axis] of target^-1 * source (``lie.transform_error``), an optional
  tolerance band, rows scaled by ``coeffs``.  On a CUDA tensor ``fn`` is
  one launch of K9v and ``jac_fn`` one of K9 (``csrc/cart_pose.cu``: FK,
  the pose error and, per thread, one dual tangent column); on a CPU
  tensor, or with ``kernels=False`` from the SQP (the term's
  ``KernelChoice``), the plain versions: the torch ops of the JAX
  package's ``_err_q`` and ``torch.func.jacfwd`` of it over the step's
  joints.  :func:`cart_pose_host` runs the kernels' device code built for
  the host on CPU tensors, a check of the kernels on a CPU.
- ``cart_line_term`` (a link on a segment with an orientation target) and
  ``cart_vel_term`` (a two-sided bound on the link's displacement between
  consecutive steps): plain torch, linearized by autodiff (``Term.jac``),
  as in the JAX package.
- ``upright_term``: a link's z-axis kept vertical, with an analytic
  Jacobian.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import _native
from ..kinematics.chain import Chain
from ..ops.banded_rows import step_window
from ..ops.lie import transform_error
from ..utils.lanes import lane_broadcast, tree_map
from .base import (KernelChoice, abs_cost, eq_constraint, hinge_cost,
                   ineq_constraint, kernels_of, squared_cost)


def _link_pose_with_offset(chain: Chain, q, link: int, off_R, off_p):
    R, p = chain.fk(q)
    Rl, pl = R[..., link, :, :], p[..., link, :]
    return Rl @ off_R, (Rl @ off_p[..., None])[..., 0] + pl


def _apply_tolerances(err, lo, hi):
    """Tolerance band on a pose error (the reference's applyTolerances):
    per index, an error inside [lo, hi] is zero; outside, the distance to
    the bound it passed."""
    return torch.where(err > hi, err - hi,
                       torch.where(err < lo, err - lo, torch.zeros_like(err)))


def _poses(chain: Chain, q, p, src: int, tgt: Optional[int]):
    """The target and source poses (Rt, pt, Rs, ps) of a cart_pose term."""
    dt = q.dtype
    Rs, ps = _link_pose_with_offset(chain, q, src, p["source_off_R"].to(dt),
                                    p["source_off_p"].to(dt))
    if tgt is None:
        Rt, pt = p["target_R"].to(dt), p["target_p"].to(dt)
    else:
        Rt, pt = _link_pose_with_offset(chain, q, tgt, p["target_R"].to(dt),
                                        p["target_p"].to(dt))
    return Rt, pt, Rs, ps


def _pose_err(chain: Chain, q, p, src: int, tgt: Optional[int]):
    """(B, 6) pose error rows at q (B, n_dof): ``_err_q`` of the JAX
    package, batched over lanes."""
    dt = q.dtype
    err = transform_error(*_poses(chain, q, p, src, tgt))
    if "lower_tols" in p and "upper_tols" in p:
        err = _apply_tolerances(err, lane_broadcast(p["lower_tols"].to(dt), (6,)),
                                lane_broadcast(p["upper_tols"].to(dt), (6,)))
    return err * lane_broadcast(p["coeffs"].to(dt), (6,))


def _per_lane_jacfwd(f, q, p):
    """``torch.func.jacfwd`` of a lane-batched f(q (B, n), p) -> (B, m),
    lane by lane under ``torch.func.vmap``: (B, m, n)."""
    def one(qq, pp):
        return f(qq[None], tree_map(lambda a: a[None], pp))[0]
    return torch.func.vmap(torch.func.jacfwd(one))(q, p)


def _pose_args(lib, chain: Chain, x, p, step, nc, src, tgt, jac):
    """K9 (jac) or K9v from ``lib`` (the card's library or the host build)
    with its arguments, and the outputs it writes: (fn, args, E (B, 6),
    J (B, 6, n_x) or None; J zeros beside the step's columns)."""
    B, n_x = x.shape
    dt, dev = x.dtype, x.device
    nd = chain.n_dof
    I, F = chain.kernel_tables(dt, dev)

    def rows(key, shape):
        v = lane_broadcast(p[key].to(dt), shape)
        return v.reshape(B, -1).contiguous()

    band = "lower_tols" in p and "upper_tols" in p
    prm = [rows("target_R", (3, 3)), rows("target_p", (3,)),
           rows("source_off_R", (3, 3)), rows("source_off_p", (3,)),
           rows("lower_tols", (6,)) if band else None,
           rows("upper_tols", (6,)) if band else None,
           rows("coeffs", (6,))]
    xc = x.contiguous()
    E = torch.empty((B, 6), dtype=dt, device=dev)
    J = torch.zeros((B, 6, n_x), dtype=dt, device=dev) if jac else None
    fn = lib.cart_pose_f32 if dt == torch.float32 else lib.cart_pose_f64
    stream = torch.cuda.current_stream(dev).cuda_stream if x.is_cuda else None
    # the tensors stay referenced by the returned tuple while fn runs
    keep = (I, F, xc, prm)
    plen = chain.path_len(src) + (0 if tgt is None else chain.path_len(tgt))
    args = (I.data_ptr(), F.data_ptr(), xc.data_ptr(), xc.stride(0),
            step * nc, nd, src, -1 if tgt is None else tgt, plen,
            *[None if t is None else t.data_ptr() for t in prm],
            E.data_ptr(), None if J is None else J.data_ptr(), n_x,
            step * nc, B, stream)
    return fn, args, E, J, keep


def _pose_call(lib, chain: Chain, x, p, step, nc, src, tgt, jac):
    """Run K9 (jac) or K9v from ``lib``: E (B, 6) and J (B, 6, n_x)."""
    fn, args, E, J, _keep = _pose_args(lib, chain, x, p, step, nc, src, tgt,
                                       jac)
    _native.check("cart_pose", fn(*args))
    return E, J


def cart_pose_rows(chain: Chain, x: torch.Tensor, p, n_steps: int,
                   step: int, src: int, tgt: Optional[int] = None,
                   n_cols: Optional[int] = None, jac: bool = False,
                   kernels: bool = True):
    """A cart_pose term's error rows E (B, 6) at ``step`` of x (B, n_x)
    and, with ``jac``, its Jacobian (B, 6, n_x); ``src`` / ``tgt`` link
    indices (``tgt`` None: a world target).  Returns E, or (E, J).

    On a CUDA tensor K9 (``jac``) or K9v, counted; ``kernels=False`` (or a
    CPU tensor) the plain version."""
    nc = n_cols or chain.n_dof
    nd = chain.n_dof
    if x.is_cuda and kernels:
        E, J = _pose_call(_native.library("cart_pose"), chain, x, p, step,
                          nc, src, tgt, jac)
        _native.LAUNCHES["cart_pose" if jac else "cart_pose_value"] += 1
        return (E, J) if jac else E
    B = x.shape[0]
    q = x.reshape(B, n_steps, nc)[:, step, :nd]

    def f(qq, pp):
        return _pose_err(chain, qq, pp, src, tgt)
    E = f(q, p)
    if not jac:
        return E
    Jq = _per_lane_jacfwd(f, q, p)  # (B, 6, n_dof)
    J = torch.zeros((B, 6, n_steps, nc), dtype=x.dtype, device=x.device)
    J[:, :, step, :nd] = Jq
    return E, J.reshape(B, 6, n_steps * nc)


def cart_pose_host(chain: Chain, x: torch.Tensor, p, n_steps: int,
                   step: int, src: int, tgt: Optional[int] = None,
                   n_cols: Optional[int] = None, jac: bool = False):
    """:func:`cart_pose_rows` by K9 / K9v's device code built for the host
    (``csrc/pose_host.cpp``), on CPU tensors: a check of the kernels on a
    CPU."""
    if x.is_cuda:
        raise ValueError("cart_pose_host takes CPU tensors")
    E, J = _pose_call(_native.host_library("pose_host"), chain, x, p, step,
                      n_cols or chain.n_dof, src, tgt, jac)
    return (E, J) if jac else E


def cart_pose_term(
    name: str,
    chain: Chain,
    n_steps: int,
    step: int,
    source_link: str,
    target_link: Optional[str] = None,
    is_constraint: bool = True,
    kind: str = "eq",  # constraints: "eq"; costs: "abs" or "squared"
    n_cols: Optional[int] = None,
):
    """Pose term at one trajectory step.

    params (per lane, leading lane axis):
      target_R (3,3), target_p (3,)    — world target pose, or the offset in
                                         the target link's frame when
                                         ``target_link`` is given
      source_off_R (3,3), source_off_p (3,)
      coeffs (6,)                      — [pos_coeffs, rot_coeffs]
      lower_tols/upper_tols (6,)       — OPTIONAL tolerance band: error
                                         inside [lo, hi] is zero; present
                                         only when both keys are.

    The rows depend on one step's joints: ``jac_fn`` differentiates with
    respect to them (n_dof tangents) and scatters into (B, 6, n_x).
    """
    src = chain.link_index(source_link)
    tgt = chain.link_index(target_link) if target_link is not None else None

    def fn(x, p, aux=None):
        return cart_pose_rows(chain, x, p, n_steps, step, src, tgt, n_cols,
                              kernels=kernels_of(aux))

    def jac_fn(x, p, aux=None):
        return cart_pose_rows(chain, x, p, n_steps, step, src, tgt, n_cols,
                              jac=True, kernels=kernels_of(aux))[1]

    pre = KernelChoice()
    if is_constraint:
        return eq_constraint(name, 6, fn, jac_fn=jac_fn, step_coupling=0,
                             pre_fn=pre)
    if kind == "squared":
        return squared_cost(name, 6, fn, jac_fn=jac_fn, step_coupling=0,
                            pre_fn=pre)
    return abs_cost(name, 6, fn, jac_fn=jac_fn, step_coupling=0, pre_fn=pre)


def default_cart_pose_params(target_R=None, target_p=None, pos_coeffs=1.0,
                             rot_coeffs=1.0, source_off_R=None,
                             source_off_p=None, lower_tols=None,
                             upper_tols=None) -> dict:
    """One lane's cart_pose params as float64 numpy arrays (the builder
    makes tensors of them); raises on an inverted band."""
    eye = np.eye(3)
    zero = np.zeros(3)
    pos = np.broadcast_to(np.asarray(pos_coeffs, np.float64), (3,))
    rot = np.broadcast_to(np.asarray(rot_coeffs, np.float64), (3,))
    out = {
        "target_R": eye if target_R is None else np.asarray(target_R),
        "target_p": zero if target_p is None else np.asarray(target_p),
        "source_off_R": eye if source_off_R is None
        else np.asarray(source_off_R),
        "source_off_p": zero if source_off_p is None
        else np.asarray(source_off_p),
        "coeffs": np.concatenate([pos, rot]),
    }
    if lower_tols is not None or upper_tols is not None:
        lo = np.broadcast_to(np.asarray(
            0.0 if lower_tols is None else lower_tols, np.float64), (6,))
        hi = np.broadcast_to(np.asarray(
            0.0 if upper_tols is None else upper_tols, np.float64), (6,))
        if bool(np.any(lo > hi)):
            raise ValueError(
                "inverted cart_pose tolerance band: lower > upper "
                "(the reference's validateTolerances)")
        out["lower_tols"] = np.array(lo)
        out["upper_tols"] = np.array(hi)
    return out


def _clip01(t):
    """jnp.clip(t, 0, 1): a tie's tangent splits 0.5 / 0.5."""
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    return torch.minimum(torch.maximum(t, zero), zero + 1.0)


def cart_line_term(
    name: str,
    chain: Chain,
    n_steps: int,
    step: int,
    source_link: str,
    is_constraint: bool = True,
):
    """Constrain a link pose to a line segment (trajopt_ifopt's
    CartLineConstraint analog).

    params: line_a (3,), line_b (3,) segment endpoints; target_R (3,3)
    orientation target; coeffs (6,) [pos, rot] row scaling.  Position rows:
    p_source - closest point on the segment; rotation rows:
    log(target_R^-1 R_source).
    """
    n_dof = chain.n_dof
    src = chain.link_index(source_link)

    def fn(x, p):
        B, dt = x.shape[0], x.dtype
        q = x.reshape(B, n_steps, n_dof)[:, step]
        R, pos = chain.fk(q)
        ps = pos[:, src]
        a = p["line_a"].to(dt)
        b = p["line_b"].to(dt)
        d = b - a
        dd = torch.maximum(torch.sum(d * d, dim=-1),
                           torch.full((), 1e-12, dtype=dt, device=x.device))
        t = _clip01(torch.sum((ps - a) * d, dim=-1) / dd)
        closest = a + t[:, None] * d
        err = torch.cat([ps - closest, transform_error(
            p["target_R"].to(dt), closest, R[:, src], ps)[:, 3:]], dim=-1)
        return err * lane_broadcast(p["coeffs"].to(dt), (6,))

    if is_constraint:
        return eq_constraint(name, 6, fn, step_coupling=0)
    return abs_cost(name, 6, fn, step_coupling=0)


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


def cart_vel_term(
    name: str,
    chain: Chain,
    n_steps: int,
    source_link: str,
    first_step: int = 0,
    last_step: Optional[int] = None,
    is_constraint: bool = True,
    n_cols: Optional[int] = None,
):
    """Displacement limit between consecutive steps.

    params: {"max_displacement": ()} per lane.
    Rows per gap: [dp - limit (3); -dp - limit (3)] <= 0.
    """
    n_dof = chain.n_dof
    src = chain.link_index(source_link)
    last = (n_steps - 1) if last_step is None else last_step
    n_gaps = last - first_step
    assert n_gaps >= 1

    def fn(x, p):
        B = x.shape[0]
        X = x.reshape(B, n_steps, n_cols or n_dof)[:, first_step:last + 1,
                                                   :n_dof]
        lim = lane_broadcast(p["max_displacement"].to(x.dtype), (n_gaps, 3))
        ps = chain.fk(X)[1][:, :, src]  # (B, span, 3)
        dp = ps[:, 1:] - ps[:, :-1]  # (B, n_gaps, 3)
        return torch.cat([dp - lim, -dp - lim], dim=-1).reshape(B, -1)

    n = 6 * n_gaps
    if is_constraint:
        return ineq_constraint(name, n, fn, viol_groups=n_gaps,
                               step_coupling=1)
    return hinge_cost(name, n, fn, step_coupling=1)
