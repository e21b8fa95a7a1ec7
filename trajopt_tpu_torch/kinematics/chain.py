"""Batched forward kinematics + analytic geometric Jacobians.

Port of ``trajopt_tpu/kinematics/chain.py:70-221``.  A :class:`Chain` is
baked host-side (numpy) from a parsed URDF for one joint group; its methods
take ``q`` of shape ``(..., n_dof)`` with any leading dimensions (lanes,
steps) and compose per-link ``(..., 3, 3)`` rotations with batched
matmuls.  The JAX package unrolled each 3x3 compose into nine scalar
expressions to fill the TPU's vector lanes; on the GPU the leading
dimensions already give every elementwise op thousands of independent
entries, so the plain batched form is kept.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.lie import axis_angle_matrix, rpy_to_matrix
from .urdf import RobotModel

JT_FIXED, JT_REVOLUTE, JT_PRISMATIC = 0, 1, 2


def _np_rpy(rpy: np.ndarray) -> np.ndarray:
    return rpy_to_matrix(torch.as_tensor(rpy, dtype=torch.float64)).numpy()


@dataclasses.dataclass(frozen=True, eq=False)
class Chain:
    """Kinematic chain for one joint group (hash-by-identity)."""

    link_names: tuple
    joint_names: tuple  # actuated group joints, dof order
    parent: np.ndarray  # (L,) int, -1 for root
    off_R: np.ndarray  # (L, 3, 3) fixed offset rotation (incl. frozen joints)
    off_p: np.ndarray  # (L, 3)
    jtype: np.ndarray  # (L,) int: JT_*
    axis: np.ndarray  # (L, 3)
    dof_of_link: np.ndarray  # (L,) int, -1 if link's joint is not a group dof
    link_of_dof: np.ndarray  # (n_dof,) int link index whose joint is dof d
    ancestor: np.ndarray  # (L, n_dof) bool: dof d moves link l
    lb: np.ndarray  # (n_dof,)
    ub: np.ndarray  # (n_dof,)
    vel: np.ndarray  # (n_dof,)
    # per-(dtype, device) tensor copies of the constants, made at first use
    _consts: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_dof(self) -> int:
        return len(self.joint_names)

    @property
    def n_links(self) -> int:
        return len(self.link_names)

    def link_index(self, name: str) -> int:
        return self.link_names.index(name)

    def path_len(self, link: int) -> int:
        """The links on ``link``'s chain path, the root's and its own
        included (the pose kernels stage that many rows of the tables)."""
        n, a = 0, link
        while a >= 0:
            n, a = n + 1, int(self.parent[a])
        return n

    def _tensors(self, dtype, device):
        key = (dtype, str(device))
        c = self._consts.get(key)
        if c is None:
            def t(a):
                return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                       device=device)
            # Rodrigues factors of each revolute dof: R_axis = I + sin K +
            # (1 - cos) K^2 with the constant skew K of the unit axis
            K = np.zeros((self.n_links, 3, 3))
            for l in range(self.n_links):
                ax = self.axis[l] / max(np.linalg.norm(self.axis[l]), 1e-12)
                K[l] = [[0.0, -ax[2], ax[1]], [ax[2], 0.0, -ax[0]],
                        [-ax[1], ax[0], 0.0]]
            c = {
                "off_R": t(self.off_R), "off_p": t(self.off_p),
                "axis": t(self.axis), "K": t(K), "K2": t(K @ K),
                "eye": t(np.eye(3)),
                "ancestor": t(self.ancestor),
                "rev": t(self.jtype[self.link_of_dof] == JT_REVOLUTE),
            }
            self._consts[key] = c
        return c

    def kernel_tables(self, dtype, device):
        """(ints (int32), reals (dtype)) device tensors describing the
        chain for the pose kernels K8 / K9 (layout in ``csrc/pose.cuh``):
        per link its parent, joint type, dof and chain path from the root,
        and its 33 reals (off_R, off_p, axis, K, K^2)."""
        key = ("tables", dtype, str(device))
        t = self._consts.get(key)
        if t is None:
            L = self.n_links
            ints = [L, self.n_dof] + [0] * (4 * L)
            for l in range(L):
                path, a = [], l
                while a >= 0:
                    path.append(a)
                    a = int(self.parent[a])
                ints[2 + 4 * l:6 + 4 * l] = [int(self.parent[l]),
                                             int(self.jtype[l]),
                                             int(self.dof_of_link[l]),
                                             len(ints)]
                ints += [len(path)] + path[::-1]
            reals = []
            for l in range(L):
                ax = self.axis[l] / max(np.linalg.norm(self.axis[l]), 1e-12)
                K = np.array([[0.0, -ax[2], ax[1]], [ax[2], 0.0, -ax[0]],
                              [-ax[1], ax[0], 0.0]])
                reals += list(self.off_R[l].reshape(-1)) \
                    + list(self.off_p[l]) + list(self.axis[l]) \
                    + list(K.reshape(-1)) + list((K @ K).reshape(-1))
            t = (torch.as_tensor(ints, dtype=torch.int32, device=device),
                 torch.as_tensor(reals, dtype=torch.float64,
                                 device=device).to(dtype))
            self._consts[key] = t
        return t

    # ---------------- forward kinematics ----------------

    def fk(self, q: torch.Tensor):
        """World poses of every link: (R (..., L, 3, 3), p (..., L, 3))."""
        c = self._tensors(q.dtype, q.device)
        lead = q.shape[:-1]
        Rs: list = [None] * self.n_links
        ps: list = [None] * self.n_links
        for l in range(self.n_links):
            par = int(self.parent[l])
            offR, offp = c["off_R"][l], c["off_p"][l]
            if par < 0:
                Rj = offR.expand(lead + (3, 3))
                pj = offp.expand(lead + (3,))
            else:
                Rj = Rs[par] @ offR
                pj = Rs[par] @ offp + ps[par]
            jt = int(self.jtype[l])
            d = int(self.dof_of_link[l])
            if jt == JT_REVOLUTE and d >= 0:
                qd = q[..., d, None, None]
                Ra = c["eye"] + torch.sin(qd) * c["K"][l] \
                    + (1.0 - torch.cos(qd)) * c["K2"][l]
                Rs[l] = Rj @ Ra
                ps[l] = pj
            elif jt == JT_PRISMATIC and d >= 0:
                Rs[l] = Rj
                step = c["axis"][l] * q[..., d, None]  # (..., 3)
                ps[l] = pj + (Rj @ step[..., None])[..., 0]
            else:
                Rs[l] = Rj
                ps[l] = pj
        return torch.stack(Rs, -3), torch.stack(ps, -2)

    def joint_frames(self, q: torch.Tensor):
        """World joint axes and origins for each dof: (z (..., n_dof, 3),
        o (..., n_dof, 3), R, p)."""
        c = self._tensors(q.dtype, q.device)
        R, p = self.fk(q)
        lk = torch.as_tensor(self.link_of_dof, device=q.device)
        Rl = R[..., lk, :, :]  # (..., n_dof, 3, 3)
        ax = c["axis"][lk]  # (n_dof, 3)
        z = (Rl @ ax[..., None])[..., 0]
        o = p[..., lk, :]
        return z, o, R, p

    # ---------------- analytic geometric Jacobian ----------------

    def jacobian_point(self, q: torch.Tensor, link: int,
                       point_world: torch.Tensor):
        """(..., 3, n_dof) Jacobian of a world-space point rigidly attached
        to ``link``."""
        c = self._tensors(q.dtype, q.device)
        z, o, _, _ = self.joint_frames(q)
        mask = c["ancestor"][link]  # (n_dof,)
        rev = c["rev"]
        Jv_rev = torch.linalg.cross(z, point_world[..., None, :] - o)
        Jv = (rev[:, None] * Jv_rev + (1 - rev)[:, None] * z) * mask[:, None]
        return Jv.transpose(-1, -2)

    def jacobian(self, q: torch.Tensor, link: int,
                 point_world: Optional[torch.Tensor] = None):
        """(..., 6, n_dof) geometric Jacobian [linear; angular] at
        ``point_world`` (defaults to the link origin)."""
        c = self._tensors(q.dtype, q.device)
        z, o, R, p = self.joint_frames(q)
        pt = p[..., link, :] if point_world is None else point_world
        mask = c["ancestor"][link]
        rev = c["rev"]
        Jv_rev = torch.linalg.cross(z, pt[..., None, :] - o)
        Jv = (rev[:, None] * Jv_rev + (1 - rev)[:, None] * z) * mask[:, None]
        Jw = rev[:, None] * z * mask[:, None]
        return torch.cat([Jv.transpose(-1, -2), Jw.transpose(-1, -2)], dim=-2)


def build_chain(model: RobotModel, joints: Sequence[str] | str,
                q_defaults: Optional[dict] = None,
                base_link: Optional[str] = None) -> Chain:
    """Bake a Chain for a joint group.

    ``joints`` is a list of actuated joint names (dof order) or an SRDF group
    name.  Remaining actuated joints are frozen at ``q_defaults`` (default 0)
    and folded into fixed offsets.
    """
    if isinstance(joints, str):
        joints = model.groups[joints]
    joints = list(joints)
    q_defaults = q_defaults or {}

    order: list[str] = []
    children: dict[str, list] = {}
    joint_by_child = {}
    for j in model.joints:
        children.setdefault(j.parent, []).append(j)
        joint_by_child[j.child] = j
    all_children = set(joint_by_child)
    roots = [l for l in model.links if l not in all_children]
    if base_link is not None:
        roots = [base_link]

    # topological order via DFS from roots
    stack = list(reversed(roots))
    while stack:
        l = stack.pop()
        order.append(l)
        for j in sorted(children.get(l, []), key=lambda jj: jj.name):
            stack.append(j.child)

    link_idx = {l: i for i, l in enumerate(order)}
    L = len(order)
    parent = np.full(L, -1, np.int64)
    off_R = np.tile(np.eye(3), (L, 1, 1))
    off_p = np.zeros((L, 3))
    jtype = np.zeros(L, np.int64)
    axis = np.zeros((L, 3))
    axis[:, 0] = 1.0
    dof_of_link = np.full(L, -1, np.int64)

    dof_index = {name: d for d, name in enumerate(joints)}
    link_of_dof = np.zeros(len(joints), np.int64)
    lb = np.zeros(len(joints))
    ub = np.zeros(len(joints))
    vel = np.zeros(len(joints))

    for i, lname in enumerate(order):
        j = joint_by_child.get(lname)
        if j is None:
            continue
        parent[i] = link_idx[j.parent]
        R = _np_rpy(j.rpy)
        p = j.xyz.copy()
        if j.name in dof_index:
            d = dof_index[j.name]
            dof_of_link[i] = d
            link_of_dof[d] = i
            jtype[i] = JT_REVOLUTE if j.jtype in ("revolute", "continuous") else JT_PRISMATIC
            axis[i] = j.axis
            lb[d], ub[d], vel[d] = j.lower, j.upper, j.velocity
        elif j.jtype != "fixed":
            # frozen actuated joint: fold default q into the fixed offset
            q0 = float(q_defaults.get(j.name, 0.0))
            if j.jtype in ("revolute", "continuous"):
                R = R @ axis_angle_matrix(
                    torch.as_tensor(j.axis, dtype=torch.float64),
                    torch.tensor(q0, dtype=torch.float64)).numpy()
            else:
                p = p + R @ (j.axis * q0)
        off_R[i] = R
        off_p[i] = p

    ancestor = np.zeros((L, len(joints)), bool)
    for i in range(L):
        a = i
        while a >= 0:
            d = dof_of_link[a]
            if d >= 0:
                ancestor[i, d] = True
            a = parent[a]

    return Chain(
        link_names=tuple(order),
        joint_names=tuple(joints),
        parent=parent,
        off_R=off_R,
        off_p=off_p,
        jtype=jtype,
        axis=axis,
        dof_of_link=dof_of_link,
        link_of_dof=link_of_dof,
        ancestor=ancestor,
        lb=lb,
        ub=ub,
        vel=vel,
    )
