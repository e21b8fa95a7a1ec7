"""Static broad-phase pair culling by interval forward kinematics
(``trajopt_tpu/collision/broadphase.py``, numpy, copied and adapted to the
port's :class:`CollisionWorld`).

The reference relies on tesseract's contact managers to broad-phase-cull
geometry pairs before the narrow phase (trajopt/src/collision_terms.cpp:
203-323).  A sound static cull does the same at world-build time: a
candidate pair whose links can never come within ``margin + buffer`` of
each other over the whole joint box is dropped, since no configuration
the optimizer reaches (its iterates stay inside the joint limits) can make
it an active contact.

Soundness: propagate, host side, a ball enclosing every reachable world
position of each geometry over the joint box [lb, ub]:

  * the pose at the box midpoint q_mid gives the ball center;
  * each link carries (rho, theta): a bound on its position and rotation
    angle deviation from the midpoint pose over the whole box.  A child
    at fixed offset t of a parent with (rho, th) deviates by at most
    ``rho + chord(th) * ||t||`` with chord(th) = 2 sin(min(th, pi)/2); a
    revolute dof adds its half-range to theta, a prismatic dof its
    half-range (plus the rotated axis' deviation on the mid extension)
    to rho;
  * a geometry with local bounding ball (c, r) on link l then lies within
    ``rho_l + chord(theta_l) * ||c|| + r`` of its midpoint-pose center.

min distance(pair) >= ||cA - cB|| - radA - radB, so pairs with that bound
above the cull distance are provably inactive.  The pruned world is built
by the port's ``_make_world``, so it packs its own kernel tables.
"""

from __future__ import annotations

import numpy as np

from ..kinematics.chain import JT_PRISMATIC, JT_REVOLUTE, Chain
from .world import BOX, CAPSULE, SPHERE, CollisionWorld, _make_world


def _chord(theta: float) -> float:
    return 2.0 * np.sin(min(float(theta), np.pi) / 2.0)


def _rodrigues(axis: np.ndarray, angle: float) -> np.ndarray:
    a = np.asarray(axis, float)
    n = np.linalg.norm(a)
    if n < 1e-12:
        return np.eye(3)
    a = a / n
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def link_pose_balls(chain: Chain):
    """Midpoint-pose (R, p) per link plus sound deviation bounds (rho,
    theta) over the whole joint box."""
    L = chain.n_links
    qmid = 0.5 * (chain.lb + chain.ub)
    half = 0.5 * (chain.ub - chain.lb)
    R = [np.eye(3)] * L
    p = [np.zeros(3)] * L
    rho = np.zeros(L)
    th = np.zeros(L)
    for l in range(L):
        par = int(chain.parent[l])
        offR = np.asarray(chain.off_R[l], float)
        offp = np.asarray(chain.off_p[l], float)
        if par < 0:
            Rj, pj = offR, offp
            rho_p = th_p = 0.0
        else:
            Rj = R[par] @ offR
            pj = R[par] @ offp + p[par]
            rho_p, th_p = rho[par], th[par]
        rho_l = rho_p + _chord(th_p) * np.linalg.norm(offp)
        th_l = th_p
        jt = int(chain.jtype[l])
        d = int(chain.dof_of_link[l])
        ax = np.asarray(chain.axis[l], float)
        if jt == JT_REVOLUTE and d >= 0:
            R[l] = Rj @ _rodrigues(ax, float(qmid[d]))
            p[l] = pj
            th_l += float(half[d])
        elif jt == JT_PRISMATIC and d >= 0:
            R[l] = Rj
            p[l] = pj + Rj @ (ax * float(qmid[d]))
            an = np.linalg.norm(ax)
            rho_l += float(half[d]) * an + _chord(th_p) * abs(float(qmid[d])) * an
        else:
            R[l] = Rj
            p[l] = pj
        rho[l] = rho_l
        th[l] = th_l
    return R, p, rho, th


def geom_local_ball(spec) -> tuple[np.ndarray, float]:
    """Link-frame bounding ball (center, radius) of one GeomSpec."""
    c = np.asarray(spec.off_p, float)
    if spec.kind == SPHERE:
        return c, float(spec.radius)
    if spec.kind == CAPSULE:
        return c, float(spec.radius) + float(spec.half[2])
    if spec.kind == BOX:
        return c, float(np.linalg.norm(spec.half))
    # CONVEX: centroid of the vertex set + sweep radius
    V = np.asarray(spec.verts, float)
    m = V.mean(axis=0)
    r = float(np.max(np.linalg.norm(V - m[None, :], axis=1))) + float(spec.radius)
    return c + np.asarray(spec.off_R, float) @ m, r


def pair_distance_bounds(world: CollisionWorld) -> np.ndarray:
    """(n_pairs,) sound lower bounds on the pair distance over the joint box."""
    R, p, rho, th = link_pose_balls(world.chain)
    centers = np.zeros((len(world.geoms), 3))
    radii = np.zeros(len(world.geoms))
    for gi, g in enumerate(world.geoms):
        c_l, r_g = geom_local_ball(g)
        centers[gi] = R[g.link] @ c_l + p[g.link]
        radii[gi] = rho[g.link] + _chord(th[g.link]) * np.linalg.norm(c_l) + r_g
    out = np.zeros(world.n_pairs)
    for k, (i, j) in enumerate(world.pairs):
        out[k] = (np.linalg.norm(centers[i] - centers[j])
                  - radii[i] - radii[j])
    return out


def prune_pairs(world: CollisionWorld, cull_dist: float) -> CollisionWorld:
    """Drop candidate pairs that provably stay farther than ``cull_dist``
    apart over the whole joint box (set cull_dist >= the largest collision
    margin + safety buffer the problem will use)."""
    lbs = pair_distance_bounds(world)
    keep = [list(world.pairs)[k] for k in range(world.n_pairs)
            if lbs[k] <= cull_dist]
    return _make_world(world.chain, list(world.geoms), keep)
