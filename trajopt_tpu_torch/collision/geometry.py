"""Differentiable convex signed distances (sphere / capsule / box) and the
exact small-hull feature distance (``trajopt_tpu/collision/geometry.py``).

Every function takes tensors with any leading dimensions (pairs, substates,
lanes) and the geometry in the last axis, so a kind group evaluates as one
batch of elementwise ops; under ``torch.func.vmap`` the same code runs per
instance.  Forward-mode tangents follow the JAX package's exactly:

- ``jnp.clip`` is ``minimum(maximum(x, lo), hi)`` and a tie of ``maximum``
  / ``minimum`` splits the tangent 0.5 / 0.5 (``torch.maximum`` does too);
  a clamp strictly beyond its bound passes no tangent;
- ``jnp.abs`` has tangent +1 at 0 (``_abs``); ``torch.abs`` would give 0;
- ``jnp.max`` over an axis splits ties evenly (``torch.amax`` does too);
- ``stop_gradient`` becomes ``.detach()``.

Ported: the closed forms, ``box_vertices`` with ``_PEN_DIRS``,
``make_feature_distance`` over ``small_hull_topology`` and
``generic_topology``, the Frank-Wolfe max-separation ``d_convex_convex``
with ``_fw_weights``, ``d_convex_auto``, and the box-box SAT distances
``d_box_box`` / ``d_swept_box_box`` (with ``box_box_ties`` /
``swept_box_box_ties``, their near-tie rows for the float32 checks).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

_EPS = 1e-12


def _const(x: torch.Tensor, v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=x.dtype, device=x.device)


def _max(x, v):
    """``jnp.maximum(x, v)`` with its tie rule."""
    return torch.maximum(x, v if torch.is_tensor(v) else _const(x, v))


def _min(x, v):
    return torch.minimum(x, v if torch.is_tensor(v) else _const(x, v))


def _clip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``."""
    return _min(_max(x, lo), hi)


def _abs(x):
    """``jnp.abs`` (tangent +1 at 0)."""
    return torch.where(x >= 0, x, -x)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _safe_norm(v):
    """Norm over the last axis with a zero tangent at v = 0 (the double
    ``where`` of the reference keeps the value exact)."""
    d2 = _dot(v, v)
    pos = d2 > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, d2, 1.0)), 0.0)


def d_sphere_sphere(c1, r1, c2, r2):
    return _safe_norm(c1 - c2) - (r1 + r2)


def _closest_on_segment(a, b, p):
    d = b - a
    t = _dot(p - a, d) / _max(_dot(d, d), _EPS)
    return a + _clip(t, 0.0, 1.0)[..., None] * d


def _seg_param(a, b, p):
    d = b - a
    t = _dot(p - a, d) / _max(_dot(d, d), _EPS)
    return _clip(t, 0.0, 1.0)


def d_sphere_capsule(c, r, a, b, rc):
    p = _closest_on_segment(a, b, c)
    return _safe_norm(c - p) - (r + rc)


def _seg_seg_params(a1, b1, a2, b2):
    """Clamped (s, t) of the closest points on two segments (Ericson,
    parallel-safe)."""
    d1 = b1 - a1
    d2 = b2 - a2
    r = a1 - a2
    a = _dot(d1, d1)
    e = _dot(d2, d2)
    f = _dot(d2, r)
    c = _dot(d1, r)
    b = _dot(d1, d2)
    denom = a * e - b * b
    s = torch.where(denom > _EPS,
                    _clip((b * f - c * e) / _max(denom, _EPS), 0.0, 1.0), 0.0)
    t = (b * s + f) / _max(e, _EPS)
    t_cl = _clip(t, 0.0, 1.0)
    s = _clip((b * t_cl - c) / _max(a, _EPS), 0.0, 1.0)
    return s, t_cl


def _seg_seg_closest(a1, b1, a2, b2):
    s, t = _seg_seg_params(a1, b1, a2, b2)
    return a1 + s[..., None] * (b1 - a1), a2 + t[..., None] * (b2 - a2)


def d_capsule_capsule(a1, b1, r1, a2, b2, r2):
    p1, p2 = _seg_seg_closest(a1, b1, a2, b2)
    return _safe_norm(p1 - p2) - (r1 + r2)


def _to_local(p, bc, bR):
    """``bR.T @ (p - bc)`` over leading dimensions."""
    return torch.einsum("...ij,...i->...j", bR, p - bc)


def sdf_box_point(p, bc, bR, bh):
    """Exact signed distance of a point to an oriented box."""
    q = _abs(_to_local(p, bc, bR)) - bh
    outside = _safe_norm(_max(q, 0.0))
    inside = _min(torch.amax(q, dim=-1), 0.0)
    return outside + inside


def d_sphere_box(c, r, bc, bR, bh):
    return sdf_box_point(c, bc, bR, bh) - r


def d_capsule_box(a, b, r, bc, bR, bh, iters: int = 12):
    """Capsule vs box by ``iters`` alternating projections segment <-> box;
    the tangent is carried through every iteration, as ``jacfwd`` does."""
    la = _to_local(a, bc, bR)
    lb = _to_local(b, bc, bR)
    d = lb - la
    s = 0.5
    for _ in range(iters):
        s_ = s[..., None] if torch.is_tensor(s) else s
        p_box = _clip(la + s_ * (lb - la), -bh, bh)
        s = _clip(_dot(p_box - la, d) / _max(_dot(d, d), _EPS), 0.0, 1.0)
    q = _abs(la + s[..., None] * (lb - la)) - bh
    outside = _safe_norm(_max(q, 0.0))
    inside = _min(torch.amax(q, dim=-1), 0.0)
    return outside + inside - r


_BOX_SIGNS = np.asarray(list(itertools.product((-1.0, 1.0), repeat=3)))


def box_vertices(c, R, h):
    """(..., 8, 3) world corners of oriented boxes (c (..., 3), R (..., 3,
    3), h (..., 3)); vertex i has the signs of ``itertools.product``."""
    signs = _const(c, _BOX_SIGNS)
    return c[..., None, :] + (signs * h[..., None, :]) @ R.transpose(-1, -2)


def _make_dirs():
    ds = np.asarray([d for d in itertools.product((-1.0, 0.0, 1.0), repeat=3)
                     if any(d)])
    return ds / np.linalg.norm(ds, axis=1, keepdims=True)


# the 26 box-lattice directions of the penetration-depth cover
_PEN_DIRS = _make_dirs()


def small_hull_topology(n_verts: int):
    """(edges, tris) static index arrays of the cast's small vertex sets:
    1 point, 2 segment, 4 two-pose capsule (all pairs / triples), 8 box
    in ``box_vertices`` order (12 edges, 12 face triangles)."""
    if n_verts == 1:
        return np.zeros((1, 2), np.int32), np.zeros((0, 3), np.int32)
    if n_verts == 2:
        return np.array([[0, 1]], np.int32), np.zeros((0, 3), np.int32)
    if n_verts == 4:
        E = np.array(list(itertools.combinations(range(4), 2)), np.int32)
        T = np.array(list(itertools.combinations(range(4), 3)), np.int32)
        return E, T
    if n_verts == 8:
        E = np.array([(i, i ^ m) for i in range(8) for m in (1, 2, 4)
                      if i < (i ^ m)], np.int32)
        T = []
        for bit in (1, 2, 4):
            lo = [m for m in (1, 2, 4) if m != bit]
            for val in (0, bit):
                q00, q01 = val, val | lo[1]
                q11, q10 = val | lo[0] | lo[1], val | lo[0]
                T.append((q00, q01, q11))
                T.append((q00, q11, q10))
        return E, np.array(T, np.int32)
    raise ValueError(f"no static topology for {n_verts} vertices")


def generic_topology(n_verts: int):
    """(edges, tris) of a point cloud whose hull topology is unknown: all
    vertex pairs and all triples (``itertools.combinations`` order), a
    sound superset of the hull's features; 1 and 2 vertices as
    ``small_hull_topology``."""
    if n_verts <= 2:
        return small_hull_topology(n_verts)
    E = np.array(list(itertools.combinations(range(n_verts), 2)), np.int32)
    T = np.array(list(itertools.combinations(range(n_verts), 3)), np.int32)
    return E, T


def _bary_cascade(d1, d2, d3, d4, d5, d6):
    """The closest-point region cascade of a point to a triangle, carried
    as barycentric (v, w) (closest = a + v (b - a) + w (c - a))."""
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom_face = va + vb + vc
    face_ok = torch.abs(denom_face) > _EPS
    v = torch.where(face_ok, vb / torch.where(face_ok, denom_face, 1.0), 0.0)
    w = torch.where(face_ok, vc / torch.where(face_ok, denom_face, 1.0), 0.0)
    w_bc = _clip((d4 - d3) / _max((d4 - d3) + (d5 - d6), _EPS), 0.0, 1.0)
    m = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    v = torch.where(m, 1.0 - w_bc, v)
    w = torch.where(m, w_bc, w)
    w_ac = _clip(d2 / _max(d2 - d6, _EPS), 0.0, 1.0)
    m = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    v = torch.where(m, 0.0, v)
    w = torch.where(m, w_ac, w)
    v_ab = _clip(d1 / _max(d1 - d3, _EPS), 0.0, 1.0)
    m = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    v = torch.where(m, v_ab, v)
    w = torch.where(m, 0.0, w)
    m = (d6 >= 0) & (d5 <= d6)  # vertex c
    v = torch.where(m, 0.0, v)
    w = torch.where(m, 1.0, w)
    m = (d3 >= 0) & (d4 <= d3)  # vertex b
    v = torch.where(m, 1.0, v)
    w = torch.where(m, 0.0, w)
    m = (d1 <= 0) & (d2 <= 0)  # vertex a
    v = torch.where(m, 0.0, v)
    w = torch.where(m, 0.0, w)
    return v, w


def _point_tri_bary(p, a, b, c):
    """Barycentric (v, w) of the closest point on triangle abc to p."""
    ab = b - a
    ac = c - a
    ap, bp, cp = p - a, p - b, p - c
    return _bary_cascade(_dot(ab, ap), _dot(ac, ap), _dot(ab, bp),
                         _dot(ac, bp), _dot(ab, cp), _dot(ac, cp))


def _mm(a, b):
    """a @ b.T over leading dimensions: (..., m, 3) x (..., n, 3) -> (..., m, n)."""
    return a @ b.transpose(-1, -2)


def _seg_seg_d2_grid(A1, B1, A2, B2):
    """(..., e1, e2) squared distances between all edge pairs, in the
    reference's dot-product grid form (same clamped recurrence)."""
    d1 = B1 - A1
    d2 = B2 - A2
    aa = _dot(d1, d1)[..., :, None]
    ee = _dot(d2, d2)[..., None, :]
    b = _mm(d1, d2)
    c = _dot(d1, A1)[..., :, None] - _mm(d1, A2)
    f = _mm(A1, d2) - _dot(d2, A2)[..., None, :]
    denom = aa * ee - b * b
    s = torch.where(denom > _EPS,
                    _clip((b * f - c * ee) / _max(denom, _EPS), 0.0, 1.0), 0.0)
    t = (b * s + f) / _max(ee, _EPS)
    t_cl = _clip(t, 0.0, 1.0)
    s = _clip((b * t_cl - c) / _max(aa, _EPS), 0.0, 1.0)
    rr = (_dot(A1, A1)[..., :, None] + _dot(A2, A2)[..., None, :]
          - 2.0 * _mm(A1, A2))
    return (rr + s * s * aa + t_cl * t_cl * ee
            + 2.0 * s * c - 2.0 * t_cl * f - 2.0 * s * t_cl * b)


def _point_tri_d2_grid(P, TA, TB, TC):
    """(..., n_p, n_t) squared point-triangle distances in grid form."""
    ab = TB - TA
    ac = TC - TA
    Pab, Pac = _mm(P, ab), _mm(P, ac)
    d1 = Pab - _dot(ab, TA)[..., None, :]
    d2 = Pac - _dot(ac, TA)[..., None, :]
    d3 = Pab - _dot(ab, TB)[..., None, :]
    d4 = Pac - _dot(ac, TB)[..., None, :]
    d5 = Pab - _dot(ab, TC)[..., None, :]
    d6 = Pac - _dot(ac, TC)[..., None, :]
    v, w = _bary_cascade(d1, d2, d3, d4, d5, d6)
    pa2 = (_dot(P, P)[..., :, None] + _dot(TA, TA)[..., None, :]
           - 2.0 * _mm(P, TA))
    abab = _dot(ab, ab)[..., None, :]
    acac = _dot(ac, ac)[..., None, :]
    abac = _dot(ab, ac)[..., None, :]
    return (pa2 + v * v * abab + w * w * acac
            - 2.0 * v * d1 - 2.0 * w * d2 + 2.0 * v * w * abac)


def _onehot(idx, n, dtype):
    return (torch.arange(n, device=idx.device) == idx[..., None]).to(dtype)


def _pick_rows(table, idx):
    """``table[idx]`` for an integer (n, k) table and a batched index, as
    mask arithmetic (an out-of-range index is clamped, as JAX's gather)."""
    idx = torch.clamp(idx, max=table.shape[0] - 1)
    m = torch.arange(table.shape[0], device=idx.device) == idx[..., None]
    return torch.sum(torch.where(m[..., None], table, 0), dim=-2)


def _pick_vertex(V, i):
    """``V[..., i, :]`` for a batched index, exactly (one-hot sum)."""
    return torch.einsum("...n,...nk->...k", _onehot(i, V.shape[-2], V.dtype), V)


class _FeatureTables:
    """Static candidate tables of ``make_feature_distance(n1, n2,
    topology)``: flat candidate order [edge-edge | v1-tri2 | v2-tri1]."""

    def __init__(self, n1: int, n2: int, topology=None):
        topo = topology or small_hull_topology
        self.n1, self.n2 = n1, n2
        self.E1, self.T1 = topo(n1)
        self.E2, self.T2 = topo(n2)
        ct, ia, ib = [], [], []
        for i in range(len(self.E1)):
            for j in range(len(self.E2)):
                ct.append(0), ia.append(i), ib.append(j)
        for i in range(n1):
            for j in range(len(self.T2)):
                ct.append(1), ia.append(i), ib.append(j)
        for i in range(n2):
            for j in range(len(self.T1)):
                ct.append(2), ia.append(i), ib.append(j)
        self.cand = np.stack([ct, ia, ib], axis=1).astype(np.int64)

    def candidate_d2(self, V1, V2):
        """(..., n_cand) squared candidate distances (grid form)."""
        E1, T1, E2, T2 = self.E1, self.T1, self.E2, self.T2
        lead = V1.shape[:-2]
        ds = [_seg_seg_d2_grid(V1[..., E1[:, 0], :], V1[..., E1[:, 1], :],
                               V2[..., E2[:, 0], :], V2[..., E2[:, 1], :])
              .reshape(lead + (-1,))]
        if len(T2):
            ds.append(_point_tri_d2_grid(
                V1, V2[..., T2[:, 0], :], V2[..., T2[:, 1], :],
                V2[..., T2[:, 2], :]).reshape(lead + (-1,)))
        if len(T1):
            ds.append(_point_tri_d2_grid(
                V2, V1[..., T1[:, 0], :], V1[..., T1[:, 1], :],
                V1[..., T1[:, 2], :]).reshape(lead + (-1,)))
        return torch.cat(ds, dim=-1)


def _depth_cover(V1c, V2c):
    """(U (26, 3), h (..., 26)): the support-cover depths of the 26
    directions (the penetration depth is the min over them)."""
    U = torch.as_tensor(_PEN_DIRS, dtype=V1c.dtype, device=V1c.device)
    return U, torch.amax(V1c @ U.T, dim=-2) - torch.amin(V2c @ U.T, dim=-2)


def _witness(tb: _FeatureTables, V1c, V2c, k=None, kd=None, margins=False):
    """Frozen witness (W1f, W2f, nf) of the feature distance between
    conv(V1c) and conv(V2c), all from detached data.  ``k`` / ``kd`` force
    the candidate / depth-cover decision (default: the argmins).  With
    ``margins`` it also returns the distance of each threshold test to its
    threshold (..., 2 + n1 + n2): the separation test's two, then the
    support-vertex tie tests of the depth cover (where it decides)."""
    dt, dev = V1c.dtype, V1c.device
    n1, n2 = tb.n1, tb.n2
    if k is None:
        k = torch.argmin(tb.candidate_d2(V1c, V2c), dim=-1)
    cand = _pick_rows(torch.as_tensor(tb.cand, device=dev), k)
    ck, ak, bk = cand[..., 0], cand[..., 1], cand[..., 2]
    E1 = torch.as_tensor(tb.E1, dtype=torch.int64, device=dev)
    E2 = torch.as_tensor(tb.E2, dtype=torch.int64, device=dev)

    e1 = _pick_rows(E1, torch.where(ck == 0, ak, torch.where(ck == 2, bk, 0)))
    e2 = _pick_rows(E2, torch.where(ck == 0, bk, 0))
    s, t = _seg_seg_params(_pick_vertex(V1c, e1[..., 0]),
                           _pick_vertex(V1c, e1[..., 1]),
                           _pick_vertex(V2c, e2[..., 0]),
                           _pick_vertex(V2c, e2[..., 1]))
    W1 = _onehot(e1[..., 0], n1, dt) * (1.0 - s)[..., None] \
        + _onehot(e1[..., 1], n1, dt) * s[..., None]
    W2 = _onehot(e2[..., 0], n2, dt) * (1.0 - t)[..., None] \
        + _onehot(e2[..., 1], n2, dt) * t[..., None]
    for side, T_, n_self, n_oth in ((1, tb.T2, n1, n2), (2, tb.T1, n2, n1)):
        if not len(T_):
            continue
        Tt = torch.as_tensor(T_, dtype=torch.int64, device=dev)
        tri = _pick_rows(Tt, torch.where(ck == side, bk, 0))
        vi = torch.where(ck == side, ak, 0)
        Vs, Vo = (V1c, V2c) if side == 1 else (V2c, V1c)
        v, w = _point_tri_bary(_pick_vertex(Vs, vi),
                               _pick_vertex(Vo, tri[..., 0]),
                               _pick_vertex(Vo, tri[..., 1]),
                               _pick_vertex(Vo, tri[..., 2]))
        Ws = _onehot(vi, n_self, dt)
        Wo = (_onehot(tri[..., 0], n_oth, dt) * (1.0 - v - w)[..., None]
              + _onehot(tri[..., 1], n_oth, dt) * v[..., None]
              + _onehot(tri[..., 2], n_oth, dt) * w[..., None])
        hit = (ck == side)[..., None]
        if side == 1:
            W1, W2 = torch.where(hit, Ws, W1), torch.where(hit, Wo, W2)
        else:
            W2, W1 = torch.where(hit, Ws, W2), torch.where(hit, Wo, W1)

    p_c = torch.einsum("...n,...nk->...k", W1, V1c)
    q_c = torch.einsum("...n,...nk->...k", W2, V2c)
    gap_c = _safe_norm(q_c - p_c)
    n = (q_c - p_c) / _max(gap_c, _EPS)[..., None]
    # supporting-plane separation test of the closest pair
    proj1 = torch.einsum("...nk,...k->...n", V1c, n)
    proj2 = torch.einsum("...nk,...k->...n", V2c, n)
    margin = torch.amin(proj2, dim=-1) - torch.amax(proj1, dim=-1)
    sep = (gap_c > 1e-6) & (margin > -1e-6 * _max(gap_c, 1.0))

    # penetration: the 26-direction support-cover winner, near-tied
    # support vertices sharing the witness weight
    U, h = _depth_cover(V1c, V2c)
    S1 = V1c @ U.T
    S2 = V2c @ U.T
    if kd is None:
        kd = torch.argmin(h, dim=-1)
    ohd = _onehot(kd, U.shape[0], dt)
    s1 = torch.einsum("...nk,...k->...n", S1, ohd)
    s2 = torch.einsum("...nk,...k->...n", S2, ohd)
    m1 = torch.amax(s1, dim=-1, keepdim=True)
    m2 = torch.amin(s2, dim=-1, keepdim=True)
    a1 = (s1 >= m1 - 1e-6 * (1.0 + torch.abs(m1))).to(dt)
    a2 = (s2 <= m2 + 1e-6 * (1.0 + torch.abs(m2))).to(dt)
    ud = ohd @ U

    sep_ = sep[..., None]
    nf = torch.where(sep_, n, ud)
    W1f = torch.where(sep_, W1, a1 / torch.sum(a1, dim=-1, keepdim=True))
    W2f = torch.where(sep_, W2, a2 / torch.sum(a2, dim=-1, keepdim=True))
    if not margins:
        return W1f, W2f, nf
    cover = torch.cat([s1 - (m1 - 1e-6 * (1.0 + torch.abs(m1))),
                       (m2 + 1e-6 * (1.0 + torch.abs(m2))) - s2], dim=-1)
    cover = torch.where(sep_, float("inf"), torch.abs(cover))
    # the separation margin projects both sets on n = (q - p) / gap, whose
    # rounding error grows like extent / gap: scale its distance to the
    # threshold by 1 + extent^2 / gap
    ext2 = torch.amax(torch.cat([_dot(V1c, V1c), _dot(V2c, V2c)], -1), -1)
    test = torch.stack([
        torch.abs(gap_c - 1e-6),
        torch.abs(margin + 1e-6 * _max(gap_c, 1.0))
        / (1.0 + ext2 / _max(gap_c, 1e-30))], -1)
    return W1f, W2f, nf, torch.cat([test, cover], dim=-1)


def make_feature_distance(n1: int, n2: int, topology=None):
    """The exact feature-enumeration signed distance between conv(V1)+r1
    and conv(V2)+r2 for vertex-set sizes (n1, n2):
    ``fn(V1 (..., n1, 3), r1, V2 (..., n2, 3), r2)``.  ``topology`` maps a
    vertex count to (edges, tris): ``small_hull_topology`` (the default;
    sizes 1, 2, 4, 8) or ``generic_topology`` (any point cloud).

    Every discrete decision (candidate argmin, closest-feature parameters,
    separation test, depth-cover winner) runs on detached vertices; the
    value is the frozen-witness linear form
    ``W2 . (V2 @ n) - W1 . (V1 @ n) - (r1 + r2)``, whose tangent is that
    of the feature-enumeration distance (envelope theorem)."""
    tb = _FeatureTables(n1, n2, topology)

    def fn(V1, r1, V2, r2):
        W1f, W2f, nf = _witness(tb, V1.detach(), V2.detach())
        return (torch.einsum("...n,...n->...", W2f,
                             torch.einsum("...nk,...k->...n", V2, nf))
                - torch.einsum("...n,...n->...", W1f,
                               torch.einsum("...nk,...k->...n", V1, nf))
                - (r1 + r2))

    return fn


def feature_ties(n1: int, n2: int, depth: int = 8, topology=None):
    """``ties(V1, V2, rel, wtol, band)`` -> (...,) bool: rows of
    ``make_feature_distance(n1, n2, topology)`` whose witness decision is
    a tie.  An argmin (candidate, or depth-cover direction) is tied when
    one of its ``depth`` best entries lies within ``rel`` (relative) of the
    best plus a rounding floor (64 eps extent^2 for a squared distance, 64
    eps extent for a depth; extent: the largest vertex norm) AND gives
    another witness (W1, W2 or n differ by more than ``wtol``); a
    threshold test (the separation test, the support-vertex tie sets) is
    tied when its operand lies within ``band`` of the threshold.  Another
    implementation, or another rounding, may then pick another valid
    witness: the value moves by at most the decision's gap, the Jacobian
    by O(1).  With ``rules`` the dict of each rule's rows (argmin,
    cover_argmin, threshold) instead of their union."""
    tb = _FeatureTables(n1, n2, topology)

    def differ(a, b, wtol):
        return torch.stack([torch.amax(torch.abs(x - y), dim=-1)
                            for x, y in zip(a, b)]).amax(0) > wtol

    def ties(V1, V2, rel, wtol, band=0.0, rules=False):
        V1, V2 = V1.detach(), V2.detach()
        d2 = tb.candidate_d2(V1, V2)
        h = _depth_cover(V1, V2)[1]
        kv, ki = torch.topk(d2, min(depth, d2.shape[-1]), dim=-1,
                            largest=False)
        hv, hi = torch.topk(h, depth, dim=-1, largest=False)
        *best, tests = _witness(tb, V1, V2, ki[..., 0], hi[..., 0],
                                margins=True)
        r = {"threshold": torch.amin(tests, dim=-1) <= band}
        # the rounding floor: a d2 (depth) carries an absolute rounding
        # error of ~eps extent^2 (eps extent), however small it is
        ext = torch.amax(torch.cat([_safe_norm(V1), _safe_norm(V2)], -1), -1)
        floor = 64 * torch.finfo(V1.dtype).eps * ext
        for vals, idx, is_k in ((kv, ki, True), (hv, hi, False)):
            lim = rel * torch.clamp(torch.abs(vals[..., 0]), min=1e-30) \
                + (floor * ext if is_k else floor)
            out = torch.zeros_like(r["threshold"])
            for m in range(1, vals.shape[-1]):
                near = vals[..., m] - vals[..., 0] <= lim
                alt = _witness(tb, V1, V2, idx[..., m] if is_k else ki[..., 0],
                               hi[..., 0] if is_k else idx[..., m])
                out = out | (near & differ(best, alt, wtol))
            r["argmin" if is_k else "cover_argmin"] = out
        if rules:
            return r
        return r["threshold"] | r["argmin"] | r["cover_argmin"]

    return ties


def _dotn(V, u):
    """(..., n) support values V @ u of vertex sets (..., n, 3)."""
    return torch.einsum("...nk,...k->...n", V, u)


def _take_vertex(V, i):
    """``V[..., i, :]`` for a batched index (a gather: exact)."""
    return torch.gather(V, -2, i[..., None, None].expand(
        i.shape + (1, V.shape[-1])))[..., 0, :]


def _fw_weights(V1, V2, iters: int = 24):
    """Frank-Wolfe witness weights (l1 (..., n1), l2 (..., n2)) of the
    closest-point pair of conv(V1) and conv(V2), from vertex 0 of each.
    Runs on detached vertices: the weights carry no tangent (the
    reference's zero-tangent ``custom_jvp``), so ``jacfwd`` never traces
    the ``iters`` steps."""
    V1, V2 = V1.detach(), V2.detach()
    l1 = _onehot(torch.zeros(V1.shape[:-2], dtype=torch.int64,
                             device=V1.device), V1.shape[-2], V1.dtype)
    l2 = _onehot(torch.zeros(V2.shape[:-2], dtype=torch.int64,
                             device=V2.device), V2.shape[-2], V2.dtype)
    for _ in range(iters):
        p = (torch.einsum("...n,...nk->...k", l1, V1)
             - torch.einsum("...n,...nk->...k", l2, V2))
        i1 = torch.argmax(_dotn(V1, -p), dim=-1)
        i2 = torch.argmax(_dotn(V2, p), dim=-1)
        dvec = (_take_vertex(V1, i1) - _take_vertex(V2, i2)) - p
        gamma = _clip(-_dot(p, dvec) / _max(_dot(dvec, dvec), _EPS), 0.0,
                      1.0)[..., None]
        l1 = (1 - gamma) * l1 + gamma * _onehot(i1, V1.shape[-2], V1.dtype)
        l2 = (1 - gamma) * l2 + gamma * _onehot(i2, V2.shape[-2], V2.dtype)
    return l1, l2


# the direction polish's projected-ascent step sizes
_POLISH_STEPS = (0.5, 0.25, 0.12, 0.06, 0.03, 0.015)


def _near_runner_up(vals, items, lim, wtol, largest=True):
    """(...,) bool: the runner-up of an argmax (argmin) over ``vals``
    (..., k) lies within ``lim`` of the winner and its item (..., k, 3)
    differs from the winner's by more than ``wtol``."""
    if vals.shape[-1] < 2:
        return torch.zeros(vals.shape[:-1], dtype=torch.bool,
                           device=vals.device)
    v, i = torch.topk(vals, 2, dim=-1, largest=largest)
    far = torch.amax(torch.abs(_take_vertex(items, i[..., 0])
                               - _take_vertex(items, i[..., 1])), -1) > wtol
    return (torch.abs(v[..., 0] - v[..., 1]) <= lim) & far


def _fw_witness(V1c, V2c, iters: int = 24, tie=None):
    """Frozen witness (W1, W2, u*) of ``d_convex_convex`` from detached
    vertex sets.  With ``tie = (rel, wtol, band)`` it also returns, per
    tie rule of ``convex_convex_ties``, the (...,) rows whose witness that
    rule finds tied."""
    dt, dev = V1c.dtype, V1c.device
    l1, l2 = _fw_weights(V1c, V2c, iters)
    p = (torch.einsum("...n,...nk->...k", l1, V1c)
         - torch.einsum("...n,...nk->...k", l2, V2c))
    pn = _safe_norm(p)
    pen = torch.as_tensor(_PEN_DIRS, dtype=dt, device=dev)
    n = torch.where((pn > 1e-9)[..., None], p / _max(pn, _EPS)[..., None],
                    pen[0])
    U0 = torch.cat([pen.expand(p.shape[:-1] + pen.shape), n[..., None, :],
                    -n[..., None, :]], dim=-2)
    sep0 = (torch.amin(_mm(V2c, U0), dim=-2)
            - torch.amax(_mm(V1c, U0), dim=-2))
    k0 = torch.argmax(sep0, dim=-1)
    u = _take_vertex(U0, k0)
    best_u, best_sep = u, torch.amax(sep0, dim=-1)
    if tie is not None:
        rel, wtol, band = tie
        ext = torch.amax(torch.cat([_safe_norm(V1c), _safe_norm(V2c)], -1), -1)
        lim = rel * _max(ext, 1e-30)
        r = {"cover_argmax": _near_runner_up(sep0, U0, lim, wtol)}
        r["polish_pick"] = r["polish_better"] = torch.zeros_like(
            r["cover_argmax"])
        fw_dir = (k0 >= 26)
    for t in _POLISH_STEPS:
        s1u, s2u = _dotn(V1c, u), _dotn(V2c, u)
        if tie is not None:
            r["polish_pick"] = r["polish_pick"] \
                | _near_runner_up(s1u, V1c, lim, wtol) \
                | _near_runner_up(s2u, V2c, lim, wtol, largest=False)
        g = (_take_vertex(V2c, torch.argmin(s2u, dim=-1))
             - _take_vertex(V1c, torch.argmax(s1u, dim=-1)))
        u = u + t * g / _max(_safe_norm(g), _EPS)[..., None]
        u = u / _max(_safe_norm(u), _EPS)[..., None]
        s = torch.amin(_dotn(V2c, u), dim=-1) - torch.amax(_dotn(V1c, u),
                                                           dim=-1)
        if tie is not None:
            r["polish_better"] = r["polish_better"] \
                | (torch.abs(s - best_sep) <= band + lim)
        better = s > best_sep
        best_u = torch.where(better[..., None], u, best_u)
        best_sep = torch.where(better, s, best_sep)
    U = torch.cat([U0, best_u[..., None, :]], dim=-2)
    S1, S2 = _mm(V1c, U), _mm(V2c, U)
    sep = torch.amin(S2, dim=-2) - torch.amax(S1, dim=-2)
    ks = torch.argmax(sep, dim=-1)
    us = _take_vertex(U, ks)
    s1 = torch.gather(S1, -1, ks[..., None, None].expand(
        S1.shape[:-1] + (1,)))[..., 0]
    s2 = torch.gather(S2, -1, ks[..., None, None].expand(
        S2.shape[:-1] + (1,)))[..., 0]
    m1 = torch.amax(s1, dim=-1, keepdim=True)
    m2 = torch.amin(s2, dim=-1, keepdim=True)
    th1 = m1 - 1e-6 * (1.0 + torch.abs(m1))
    th2 = m2 + 1e-6 * (1.0 + torch.abs(m2))
    a1 = (s1 >= th1).to(dt)
    a2 = (s2 <= th2).to(dt)
    W1 = a1 / torch.sum(a1, dim=-1, keepdim=True)
    W2 = a2 / torch.sum(a2, dim=-1, keepdim=True)
    if tie is None:
        return W1, W2, us
    r["final_argmax"] = _near_runner_up(sep, U, lim, wtol)
    # the Frank-Wolfe direction decides where it seeds the polish or wins:
    # a tied support pick on the FW path then moves the witness
    fw_dir = fw_dir | (ks == 26) | (ks == 27)
    fw = torch.zeros_like(r["final_argmax"])
    l1 = _onehot(torch.zeros_like(k0), V1c.shape[-2], dt)
    l2 = _onehot(torch.zeros_like(k0), V2c.shape[-2], dt)
    for _ in range(iters):
        pp = (torch.einsum("...n,...nk->...k", l1, V1c)
              - torch.einsum("...n,...nk->...k", l2, V2c))
        v1, v2 = _dotn(V1c, -pp), _dotn(V2c, pp)
        lp = rel * _max(ext * _safe_norm(pp), 1e-30)
        fw = fw | _near_runner_up(v1, V1c, lp, wtol) \
            | _near_runner_up(v2, V2c, lp, wtol)
        i1, i2 = torch.argmax(v1, dim=-1), torch.argmax(v2, dim=-1)
        dvec = (_take_vertex(V1c, i1) - _take_vertex(V2c, i2)) - pp
        gamma = _clip(-_dot(pp, dvec) / _max(_dot(dvec, dvec), _EPS), 0.0,
                      1.0)[..., None]
        l1 = (1 - gamma) * l1 + gamma * _onehot(i1, V1c.shape[-2], dt)
        l2 = (1 - gamma) * l2 + gamma * _onehot(i2, V2c.shape[-2], dt)
    share = torch.cat([torch.abs(s1 - th1), torch.abs(s2 - th2)], -1)
    r["fw_pick"] = fw & fw_dir
    r["share"] = torch.amin(share, -1) <= band
    return W1, W2, us, r


def d_convex_convex(V1, r1, V2, r2, iters: int = 24):
    """Signed distance between conv(V1)+r1 and conv(V2)+r2 as the max
    separation over the 26 cover directions, the Frank-Wolfe closest-point
    direction +n and -n, and that winner polished by six projected-ascent
    steps (``_POLISH_STEPS``).  Every decision runs on detached vertices;
    the value is the witness-linear form ``(W2 @ V2) . u* - (W1 @ V1) . u*
    - (r1 + r2)``, near-tied support vertices (within 1e-6 (1 + |max|))
    sharing W1 / W2 equally."""
    W1, W2, us = _fw_witness(V1.detach(), V2.detach(), iters)
    return (_dot(torch.einsum("...n,...nk->...k", W2, V2), us)
            - _dot(torch.einsum("...n,...nk->...k", W1, V1), us)
            - (r1 + r2))


def convex_convex_ties(V1, V2, rel, wtol, band=0.0, iters: int = 24,
                       rules: bool = False):
    """(...,) bool: rows of ``d_convex_convex`` whose witness a tied
    decision picks — the runner-up of the cover argmax, of a polish
    support pick or of the final argmax over the 29 directions within
    ``rel`` x the sets' extent (max vertex norm) with another direction
    or vertex (differing by more than ``wtol``); a polish step's
    ``better`` within ``band`` + that; a support value within ``band`` of
    the 1e-6 (1 + |max|) sharing threshold; a tied support pick of the
    Frank-Wolfe steps where the FW direction seeds the polish or wins.
    Another rounding may there take another polish path: the value moves
    by the lower bound's slack, the Jacobian by O(1).  ``rules``: the dict
    of each rule's rows (cover_argmax, polish_pick, polish_better,
    final_argmax, fw_pick, share) instead of their union."""
    r = _fw_witness(V1.detach(), V2.detach(), iters, (rel, wtol, band))[3]
    if rules:
        return r
    out = torch.zeros_like(r["share"])
    for m in r.values():
        out = out | m
    return out


# above this vertex count the all-pairs / all-triples enumeration gives way
# to the Frank-Wolfe path
GENERIC_FEATURE_MAX_VERTS = 12


def d_convex_auto(V1, r1, V2, r2):
    """The generic feature enumeration for small point clouds (both sets at
    most ``GENERIC_FEATURE_MAX_VERTS``), ``d_convex_convex`` otherwise; the
    vertex counts are static, so the choice is made here."""
    n1, n2 = V1.shape[-2], V2.shape[-2]
    if max(n1, n2) <= GENERIC_FEATURE_MAX_VERTS:
        return make_feature_distance(n1, n2, generic_topology)(V1, r1, V2, r2)
    return d_convex_convex(V1, r1, V2, r2)


def convex_auto_ties(n1: int, n2: int):
    """``ties(V1, V2, rel, wtol, band)`` of ``d_convex_auto`` at sizes
    (n1, n2): ``feature_ties`` over the generic topology, or
    ``convex_convex_ties``."""
    if max(n1, n2) <= GENERIC_FEATURE_MAX_VERTS:
        return feature_ties(n1, n2, topology=generic_topology)
    return convex_convex_ties


# ---------------------------------------------------------------------------
# box-box: separating-axis (SAT) distances


def _cross(a, b):
    """``jnp.cross`` over the last axis (the leading axes broadcast)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _box_radius(u, R, h):
    """A box's support radius along the axes u (..., A, 3): (|h0 u.R0| +
    |h1 u.R1|) + |h2 u.R2| over R's columns (R (..., 3, 3), h (..., 3))."""
    cols = R.transpose(-1, -2)[..., None, :, :]
    hh = h[..., None, :]
    out = _abs(hh[..., 0] * _dot(u, cols[..., 0, :]))
    out = out + _abs(hh[..., 1] * _dot(u, cols[..., 1, :]))
    return out + _abs(hh[..., 2] * _dot(u, cols[..., 2, :]))


def _box_box_seps(c1, R1, h1, c2, R2, h2):
    """``d_box_box``'s 15 axes' separations (..., 15), validity and unit
    axes (..., 15, 3)."""
    d = c2 - c1
    cols1, cols2 = torch.broadcast_tensors(R1.transpose(-1, -2),
                                           R2.transpose(-1, -2))
    # R1 column i x R2 column j at 3 i + j
    cr = _cross(cols1[..., :, None, :], cols2[..., None, :, :]).flatten(-3, -2)
    n = _safe_norm(cr)
    crn = torch.where((n > 1e-8)[..., None], cr / _max(n, _EPS)[..., None],
                      torch.zeros_like(cr))
    axes = torch.cat([cols1, cols2, crn], dim=-2)
    valid = _dot(axes, axes) > 0.5
    sep = _abs(_dot(axes, d[..., None, :])) - (
        _box_radius(axes, R1, h1) + _box_radius(axes, R2, h2))
    return sep, valid, axes


def _swept_box_box_seps(c1a, c1b, R1, h1, c2, R2, h2):
    """``d_swept_box_box``'s 21 axes' separations (..., 21), validity and
    unit axes (..., 21, 3)."""
    mid = 0.5 * (c1a + c1b)
    m = 0.5 * (c1b - c1a)
    cols1 = R1.transpose(-1, -2)
    gens = torch.stack(torch.broadcast_tensors(
        *(cols1[..., i, :] * h1[..., i, None] for i in range(3)), m),
        dim=-2)  # (..., 4, 3): R1's columns times h1, then m
    cols2 = R2.transpose(-1, -2).expand(gens.shape[:-2] + (3, 3))
    d = c2 - mid
    ii, jj = zip(*[(i, j) for i in range(4) for j in range(i + 1, 4)])
    axes = torch.cat([
        cols2, _cross(gens[..., ii, :], gens[..., jj, :]),
        _cross(gens[..., :, None, :], cols2[..., None, :, :]).flatten(-3, -2)],
        dim=-2)  # (..., 21, 3)
    n = _safe_norm(axes)
    un = axes / _max(n, _EPS)[..., None]
    valid = n > 1e-8
    rz = _abs(_dot(un, gens[..., None, 0, :]))
    for g in range(1, 4):
        rz = rz + _abs(_dot(un, gens[..., None, g, :]))
    sep = _abs(_dot(un, d[..., None, :])) - (rz + _box_radius(un, R2, h2))
    return sep, valid, un


def _sat_max(sep, valid):
    """The max over the valid axes (``jnp.max``: its forward-mode tangent
    is the mean over tied maxima, as ``torch.amax``'s)."""
    return torch.amax(torch.where(valid, sep, torch.full_like(sep, -np.inf)),
                      dim=-1)


def _sat_ties(sep, valid, axes, rel):
    """A max over axes where a valid axis not parallel to the largest's
    (|u . u_max| < 1 - 1e-6) lies within ``rel`` (1 + |max|) of it: there
    another rounding may take another set of tied axes, and another
    tangent.  Parallel axes (the repeated face normals of axis-aligned
    boxes) tie exactly and share one tangent, so they are no tie."""
    sep, axes = sep.detach(), axes.detach()
    masked = torch.where(valid, sep, torch.full_like(sep, -np.inf))
    top, k = torch.max(masked, dim=-1)
    u0 = torch.gather(axes, -2, k[..., None, None].expand(
        k.shape + (1, 3)))
    near = masked >= (top - rel * (1.0 + torch.abs(top)))[..., None]
    other = torch.abs(_dot(axes, u0)) < 1.0 - 1e-6
    return (near & other).any(dim=-1)


def d_box_box(c1, R1, h1, c2, R2, h2):
    """Separating-axis signed distance between oriented boxes: the max
    over the 15 SAT axes (the two boxes' face normals, the nine edge
    crosses; a cross of parallel edges, norm <= 1e-8, is left out) of the
    per-axis separation; exact for face-contact separation and for
    penetration depth, a tight lower bound in edge-corner cases."""
    sep, valid, _ = _box_box_seps(c1, R1, h1, c2, R2, h2)
    return _sat_max(sep, valid)


def d_swept_box_box(c1a, c1b, R1, h1, c2, R2, h2):
    """Exact SAT distance between a *translating* box (pose R1 fixed,
    centre sweeping c1a -> c1b) and a static box: the swept volume is a
    zonotope with generators {R1 columns h1, motion / 2}; its face normals
    (the generators' pairwise crosses), the static box's face normals and
    the edge-cross axes, 21 in all (those of norm <= 1e-8 left out)."""
    sep, valid, _ = _swept_box_box_seps(c1a, c1b, R1, h1, c2, R2, h2)
    return _sat_max(sep, valid)


def box_box_ties(c1, R1, h1, c2, R2, h2, rel):
    """``d_box_box``'s rows with a near tie of its max (``_sat_ties``)."""
    return _sat_ties(*_box_box_seps(c1, R1, h1, c2, R2, h2), rel=rel)


def swept_box_box_ties(c1a, c1b, R1, h1, c2, R2, h2, rel):
    """``d_swept_box_box``'s rows with a near tie of its max."""
    return _sat_ties(*_swept_box_box_seps(c1a, c1b, R1, h1, c2, R2, h2),
                     rel=rel)
