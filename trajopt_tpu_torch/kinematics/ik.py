"""Inverse kinematics: damped-least-squares solver + IK trajectory term
(``trajopt_tpu/kinematics/ik.py``).

The reference's ``InverseKinematicsConstraint`` constrains trajectory
variables to the output of an IK query (x - IK(target) = 0); here IK is a
damped-least-squares (Levenberg-Marquardt) iteration over the pose error's
Jacobian, with the lane axis leading: ``target_R`` (B, 3, 3),
``target_p`` (B, 3), ``q0`` (B, n_dof).

On a CUDA tensor :func:`solve_ik` is one launch of K8 (``csrc/solve_ik.cu``:
each lane's whole loop on one warp, n_dof 1 to ``_native.CAST_ND_MAX``); on
a CPU tensor, or with ``kernels=False``, the plain version, which mirrors
the JAX package's loop step for step (``torch.linalg.solve`` for
``jnp.linalg.solve``, the clamp, the accept test ``err_new < err``, lam
halved with a floor of 1e-5 or doubled) and, as its ``while_loop`` under
``vmap``, keeps each lane's own iteration count.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _native
from ..ops.lie import transform_error
from ..terms.base import KernelChoice, eq_constraint, kernels_of, squared_cost
from ..utils.lanes import lane_broadcast, lane_select
from .chain import Chain


class IKResult(NamedTuple):
    q: torch.Tensor  # (B, n_dof) solution configuration
    err_norm: torch.Tensor  # (B,) final pose-error norm
    converged: torch.Tensor  # (B,) bool
    iters: torch.Tensor  # (B,) int32


def _bounds(chain: Chain, dt, dev):
    return (torch.as_tensor(chain.lb, dtype=dt, device=dev),
            torch.as_tensor(chain.ub, dtype=dt, device=dev))


def _q_init(chain: Chain, target_p, q0):
    if q0 is None:
        return torch.zeros((target_p.shape[0], chain.n_dof),
                           dtype=target_p.dtype, device=target_p.device)
    return q0.to(target_p.dtype)


def _plain_start(chain: Chain, link: int, target_R, target_p,
                 damping: float, pos_only: bool, q0):
    """The plain loop's start (q, err, lam) and its damped step
    ``step(q, lam) -> (q_new, err_new)``: the new q, clamped to the
    chain's bounds, and the error norm there."""
    dt, dev = target_p.dtype, target_p.device
    lb, ub = _bounds(chain, dt, dev)
    ne = 3 if pos_only else 6
    eye = torch.eye(ne, dtype=dt, device=dev)

    def pose_err(q, tR, tp):
        R, p = chain.fk(q)
        return transform_error(tR, tp, R[..., link, :, :],
                               p[..., link, :])[..., :ne]

    def one(q, tR, tp):
        return pose_err(q[None], tR[None], tp[None])[0]

    jac = torch.func.vmap(torch.func.jacfwd(one))

    def clip(v):
        return torch.minimum(torch.maximum(v, lb), ub)

    def step(q, lam):
        e = pose_err(q, target_R, target_p)
        J = jac(q, target_R, target_p)  # (B, ne, n_dof)
        A = J @ J.transpose(1, 2) + (lam * lam)[:, None, None] * eye
        y = torch.linalg.solve_ex(A, -e[..., None])[0]
        q_new = clip(q + (J.transpose(1, 2) @ y)[..., 0])
        return q_new, torch.linalg.norm(pose_err(q_new, target_R, target_p),
                                        dim=-1)

    q = clip(_q_init(chain, target_p, q0))
    err = torch.linalg.norm(pose_err(q, target_R, target_p), dim=-1)
    lam = torch.full((target_p.shape[0],), damping, dtype=dt, device=dev)
    return q, err, lam, step


def _plain_accept(q, lam, it, err, q_new, err_new):
    """The accept test and the damping's update: the next (q, lam, it,
    err) of a lane that ran a step."""
    improved = err_new < err
    return (torch.where(improved[:, None], q_new, q),
            torch.where(improved, torch.clamp(lam * 0.5, min=1e-5),
                        lam * 2.0),
            it + 1, torch.minimum(err, err_new))


def solve_ik_plain(chain: Chain, link: int, target_R, target_p,
                   max_iters: int = 60, tol: float = 1e-6,
                   damping: float = 1e-3, pos_only: bool = False,
                   q0: Optional[torch.Tensor] = None) -> IKResult:
    """The plain PyTorch loop (arguments as :func:`solve_ik`)."""
    q, err, lam, step = _plain_start(chain, link, target_R, target_p,
                                     damping, pos_only, q0)
    it = torch.zeros(err.shape, dtype=torch.int32, device=err.device)

    def running(it, err):
        return (it < max_iters) & (err > tol)

    act = running(it, err)
    while bool(act.any()):
        new = _plain_accept(q, lam, it, err, *step(q, lam))
        q, lam, it, err = [lane_select(act, a, b)
                           for a, b in zip(new, (q, lam, it, err))]
        act = running(it, err)
    return IKResult(q=q, err_norm=err, converged=err <= tol, iters=it)


def _ik_args(lib, chain: Chain, link, target_R, target_p, max_iters, tol,
             damping, pos_only, q0, clk=None):
    """K8 from ``lib`` (the card's library or the host build) with its
    arguments, and the result it writes: (fn, args, IKResult, tensors the
    arguments point into).  ``clk`` (B, 6) int64: the timed build's
    (``solve_ik_timer``) cycles per phase."""
    dt, dev = target_p.dtype, target_p.device
    B, nd = target_p.shape[0], chain.n_dof
    if nd > _native.CAST_ND_MAX:
        raise ValueError(f"solve_ik: a chain of {nd} dofs; K8 takes 1 to "
                         f"{_native.CAST_ND_MAX}")
    I, F = chain.kernel_tables(dt, dev)
    lb, ub = _bounds(chain, dt, dev)
    tR = target_R.to(dt).reshape(B, 9).contiguous()
    tp = target_p.reshape(B, 3).contiguous()
    qi = _q_init(chain, target_p, q0).contiguous()
    q = torch.empty((B, nd), dtype=dt, device=dev)
    err = torch.empty((B,), dtype=dt, device=dev)
    conv = torch.empty((B,), dtype=torch.int32, device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream \
        if target_p.is_cuda else None
    args = (I.data_ptr(), F.data_ptr(), link, chain.path_len(link),
            tR.data_ptr(), tp.data_ptr(), qi.data_ptr(), lb.data_ptr(),
            ub.data_ptr(), max_iters, float(tol), float(damping),
            3 if pos_only else 6, nd, q.data_ptr(), err.data_ptr(),
            conv.data_ptr(), iters.data_ptr(), B, stream)
    if clk is not None:
        fn, args = lib.solve_ik_timed_f32, args + (clk.data_ptr(),)
    else:
        fn = lib.solve_ik_f32 if dt == torch.float32 else lib.solve_ik_f64
    res = IKResult(q=q, err_norm=err, converged=conv, iters=iters)
    return fn, args, res, (I, F, lb, ub, tR, tp, qi)


def _ik_call(lib, chain: Chain, link, target_R, target_p, max_iters, tol,
             damping, pos_only, q0):
    fn, args, res, _keep = _ik_args(lib, chain, link, target_R, target_p,
                                    max_iters, tol, damping, pos_only, q0)
    _native.check("solve_ik", fn(*args))
    return res._replace(converged=res.converged != 0)


def solve_ik(chain: Chain, link: int, target_R: torch.Tensor,
             target_p: torch.Tensor, max_iters: int = 60, tol: float = 1e-6,
             damping: float = 1e-3, pos_only: bool = False,
             q0: Optional[torch.Tensor] = None,
             kernels: bool = True) -> IKResult:
    """Damped-least-squares IK of link ``link`` to the pose (target_R
    (B, 3, 3), target_p (B, 3)) from q0 (B, n_dof) (zeros when None),
    clamped to the chain's bounds.

    The update is dq = J' (J J' + lam^2 I)^-1 (-e); lam halves (floor
    1e-5) when the error falls and doubles when it does not; a lane stops
    at ``max_iters`` or once its error is at most ``tol``.  K8 on a CUDA
    tensor, counted (``kernels=False`` takes the plain version there); the
    plain version on a CPU tensor."""
    if target_p.is_cuda and kernels:
        res = _ik_call(_native.library("solve_ik"), chain, link, target_R,
                       target_p, max_iters, tol, damping, pos_only, q0)
        _native.LAUNCHES["solve_ik"] += 1
        return res
    return solve_ik_plain(chain, link, target_R, target_p, max_iters, tol,
                          damping, pos_only, q0)


def solve_ik_host(chain: Chain, link: int, target_R, target_p,
                  max_iters: int = 60, tol: float = 1e-6,
                  damping: float = 1e-3, pos_only: bool = False,
                  q0: Optional[torch.Tensor] = None) -> IKResult:
    """K8's device code built for the host (``csrc/pose_host.cpp``, each
    lane's loop by a team of one thread that holds every column), on CPU
    tensors: a check of the kernel on a CPU."""
    if target_p.is_cuda:
        raise ValueError("solve_ik_host takes CPU tensors")
    return _ik_call(_native.host_library("pose_host"), chain, link, target_R,
                    target_p, max_iters, tol, damping, pos_only, q0)


def ik_term(
    name: str,
    chain: Chain,
    n_steps: int,
    step: int,
    link: str,
    is_constraint: bool = True,
    n_cols: Optional[int] = None,
):
    """Constrain step ``step`` to an IK solution of the target pose.

    params: {"target_R" (3,3), "target_p" (3,), "coeffs" (n_dof,)} per lane.
    Rows are coeffs * (q_step - IK(target, seed=q_step)) — the reference's
    InverseKinematicsConstraint semantics (error in joint space), with the
    current step as the IK seed so the constraint tracks the nearest IK
    branch.  The IK solution carries no tangent (the JAX package's
    ``stop_gradient``), so the Jacobian is ``coeffs`` on the step block's
    diagonal: ``jac_fn`` gives it without running IK.
    """
    n_dof = chain.n_dof
    nc = n_cols or n_dof
    li = chain.link_index(link)
    diag = np.arange(n_dof)

    def _coeffs(x, p):
        if "coeffs" not in p:
            return torch.ones((x.shape[0], n_dof), dtype=x.dtype,
                              device=x.device)
        return lane_broadcast(p["coeffs"].to(x.dtype), (n_dof,))

    def fn(x, p, aux=None):
        dt = x.dtype
        q = x.reshape(x.shape[0], n_steps, nc)[:, step, :n_dof]
        ik = solve_ik(chain, li, p["target_R"].to(dt), p["target_p"].to(dt),
                      q0=q.detach(), kernels=kernels_of(aux))
        return _coeffs(x, p) * (q - ik.q.detach())

    def jac_fn(x, p, aux=None):
        B = x.shape[0]
        J = torch.zeros((B, n_dof, n_steps, nc), dtype=x.dtype,
                        device=x.device)
        J[:, diag, step, diag] = _coeffs(x, p)
        return J.reshape(B, n_dof, n_steps * nc)

    pre = KernelChoice()
    if is_constraint:
        return eq_constraint(name, n_dof, fn, jac_fn=jac_fn, step_coupling=0,
                             pre_fn=pre)
    return squared_cost(name, n_dof, fn, jac_fn=jac_fn, step_coupling=0,
                        pre_fn=pre)
