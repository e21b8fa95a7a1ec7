"""SO(3)/SE(3) utilities — rotation construction, log map, pose error
(``trajopt_tpu/ops/lie.py``).

Elementwise torch ops on tensors with any leading dimensions.
``transform_error`` is the reference's ``calcTransformError``: the
translation and angle-axis rotation of target^-1 * source in the target
frame, the pose error of the cartesian terms and of IK.  ``rot_log`` keeps
the JAX package's quaternion route step for step (four candidates, the
first largest pivot, the w >= 0 hemisphere, ``arctan2``, the Taylor branch
at ``vn <= 1e-8``), and its guards are ``torch.maximum`` / ``minimum``
against constants, whose tangents split 0.5 / 0.5 at a tie as JAX's do:
``torch.func.jacfwd`` through it gives ``jax.jacfwd``'s numbers.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def rpy_to_matrix(rpy: torch.Tensor) -> torch.Tensor:
    """URDF fixed-axis roll-pitch-yaw to rotation matrix (Rz @ Ry @ Rx)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], -1)
    return torch.stack([row0, row1, row2], -2)


def quat_wxyz_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) to rotation matrix."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                        2 * (x * z + w * y)], -1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                        2 * (y * z - w * x)], -1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                        1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], -2)


def axis_angle_matrix(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation about a (normalized) axis."""
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True),
                              min=_EPS)
    K = skew(axis)
    s = torch.sin(angle)[..., None, None]
    c = torch.cos(angle)[..., None, None]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device).expand(K.shape)
    return eye + s * K + (1.0 - c) * (K @ K)


def skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _quaternion(R: torch.Tensor):
    """rot_log's quaternion of R, normalized (before the hemisphere
    flip)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    eps = _const(_EPS, R)

    def root(a):
        return torch.sqrt(torch.maximum(a, eps)) / 2.0

    # four candidate constructions; the numerically largest pivot is taken
    qw0 = root(1.0 + tr)
    w0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], -1)
    qx1 = root(1.0 + m00 - m11 - m22)
    w1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], -1)
    qy2 = root(1.0 - m00 + m11 - m22)
    w2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], -1)
    qz3 = root(1.0 - m00 - m11 + m22)
    w3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], -1)
    cands = torch.stack([w0, w1, w2, w3], -2)  # (..., 4, 4)
    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                          -m00 - m11 + m22], -1)
    idx = torch.argmax(pivots, dim=-1)  # the first index on ties
    q = torch.take_along_dim(
        cands, idx[..., None, None].expand(idx.shape + (1, 4)), -2)[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def rot_log(R: torch.Tensor) -> torch.Tensor:
    """Matrix log of a rotation: angle*axis vector, safe near 0 and pi
    (the quaternion route, not the trace formula, which is singular at
    pi)."""
    q = _quaternion(R)
    # canonical hemisphere (w >= 0) so the angle is in [0, pi]
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.minimum(torch.maximum(q[..., 0], _const(-1.0, R)),
                      _const(1.0, R))
    v = q[..., 1:]
    vn = torch.linalg.norm(v, dim=-1)
    angle = 2.0 * torch.atan2(vn, w)
    # angle / sin(angle / 2), with the Taylor value near zero
    scale = torch.where(vn > 1e-8, angle / torch.maximum(vn, _const(_EPS, R)),
                        2.0 / torch.maximum(w, _const(0.5, R)))
    return v * scale[..., None]


def transform_error(R_t: torch.Tensor, p_t: torch.Tensor, R_s: torch.Tensor,
                    p_s: torch.Tensor) -> torch.Tensor:
    """[translation; angle-axis] of target^-1 * source, in the target
    frame (tesseract's calcTransformError, as the reference's
    CartPoseErrCalculator uses it)."""
    dp = torch.einsum("...ji,...j->...i", R_t, p_s - p_t)
    dR = torch.einsum("...ji,...jk->...ik", R_t, R_s)
    return torch.cat([dp, rot_log(dR)], dim=-1)
