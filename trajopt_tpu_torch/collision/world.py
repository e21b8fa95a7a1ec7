"""Collision world: robot link geometries, candidate pairs and batched
distance evaluation (``trajopt_tpu/collision/world.py``).

Candidate pairs are fixed when the world is built and grouped by
(kind, kind); each group evaluates as one batch of tensor ops.  Every
query takes configurations with any leading dimensions (lanes, gaps) and
returns distances with the same leading dimensions.

Swept ("cast") queries follow the reference: a moving sphere against
static geometry is swept exactly (a capsule), and so is a box on a chain
without revolute joints against a static box (``d_swept_box_box``, the
zonotope SAT; the chain is translation-only); every other pair with a
moving side takes the min of the substate distance and the distance to the
convex hull of its two poses — the exact small-hull feature distance, or
``geometry.d_convex_auto`` where a side is a CONVEX point cloud (the
generic feature enumeration up to 12 vertices, Frank-Wolfe max separation
beyond).

Ported kinds: SPHERE, CAPSULE, BOX, CONVEX (and attached geometry); box-box
pairs (``d_box_box``).  A pair whose sweep needs the two-pose hull of a
moving box (a box on a chain with a revolute joint, or a moving box against
anything but a static box) raises ``NotImplementedError`` when the world is
built.

``kernel_tables`` packs the world's static tables (chain, geometry
constants, pair order, sweep routes, hull topologies) for the CUDA
kernels of ``csrc/cast_seg.cu``; their layout is documented there and in
``csrc/collision.cuh``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kinematics.chain import Chain
from ..kinematics.urdf import RobotModel
from ..ops.lie import rpy_to_matrix
from . import geometry as G

SPHERE, CAPSULE, BOX, CONVEX = 0, 1, 2, 3
# sweep routes of a pair (kernel tables and tests): none, the exact sphere
# sweep, the small-hull feature distance, d_convex_auto over the two poses,
# the exact translating-box sweep
ROUTE_NONE, ROUTE_SPHERE, ROUTE_HULL, ROUTE_CONVEX, ROUTE_BOXBOX = range(5)
# vertex count of a geometry's support set (CONVEX: its vertex count)
_SUPPORT_N = {SPHERE: 1, CAPSULE: 2, BOX: 8}
# reals per link and per geometry in the kernel tables (csrc/collision.cuh)
LINK_REALS, GEOM_REALS = 33, 16


@dataclasses.dataclass(frozen=True, eq=False)
class GeomSpec:
    link: int
    kind: int
    off_R: np.ndarray  # (3,3)
    off_p: np.ndarray  # (3,)
    radius: float
    half: np.ndarray  # (3,) box half extents; capsule: half[2] = half-length
    name: str = ""
    # CONVEX: local-frame vertices (V, 3), padded to the world's largest V
    # by repeating vertex 0 (support-function neutral); radius: sweep radius
    verts: Optional[np.ndarray] = None


# pair kernels over canonical world-space forms:
#   sphere: (c, r); capsule: (a, b, r); box: (c, R, h)
_KERNELS = {
    (SPHERE, SPHERE): lambda A, B: G.d_sphere_sphere(A[0], A[1], B[0], B[1]),
    (SPHERE, CAPSULE): lambda A, B: G.d_sphere_capsule(
        A[0], A[1], B[0], B[1], B[2]),
    (SPHERE, BOX): lambda A, B: G.d_sphere_box(A[0], A[1], B[0], B[1], B[2]),
    (CAPSULE, CAPSULE): lambda A, B: G.d_capsule_capsule(
        A[0], A[1], A[2], B[0], B[1], B[2]),
    (CAPSULE, BOX): lambda A, B: G.d_capsule_box(
        A[0], A[1], A[2], B[0], B[1], B[2]),
    (BOX, BOX): lambda A, B: G.d_box_box(A[0], A[1], A[2], B[0], B[1], B[2]),
    # convex: (Vw, r); the other side becomes a (radius-inflated) vertex set
    (SPHERE, CONVEX): lambda A, B: G.d_convex_auto(
        A[0][..., None, :], A[1], B[0], B[1]),
    (CAPSULE, CONVEX): lambda A, B: G.d_convex_auto(
        torch.stack([A[0], A[1]], dim=-2), A[2], B[0], B[1]),
    (BOX, CONVEX): lambda A, B: G.d_convex_auto(
        G.box_vertices(A[0], A[1], A[2]), 0.0, B[0], B[1]),
    (CONVEX, CONVEX): lambda A, B: G.d_convex_auto(A[0], A[1], B[0], B[1]),
}

# the number of trailing (per-geometry) axes of each world-array entry;
# entries without a leading (..., k) position axis are constants
_POSED = {SPHERE: (2, None), CAPSULE: (2, 2, None), BOX: (2, 3, None),
          CONVEX: (3, None)}


def _take(wk, kind, sel):
    """Entries of geometries ``sel`` (numpy indices into the kind) from a
    world-kind dict; the geometry axis is the first of the trailing axes."""
    out = []
    for a, nd in zip(wk[kind], _POSED[kind]):
        if nd is None:
            out.append(a[sel])
        else:
            out.append(a.index_select(a.dim() - nd, torch.as_tensor(
                sel, device=a.device)))
    return tuple(out)


def _narrow_sub(wk, start, length):
    """Slice the substate axis (just before the geometry axis) of every
    posed entry of a world-kind dict."""
    out = {}
    for kind, arrs in wk.items():
        out[kind] = tuple(
            a if nd is None else a.narrow(a.dim() - nd - 1, start, length)
            for a, nd in zip(arrs, _POSED[kind]))
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class CollisionWorld:
    chain: Chain
    geoms: tuple  # tuple[GeomSpec]
    pairs: tuple  # tuple[(gi, gj)], grouped by (kind, kind), kind_i <= kind_j
    _kind_idx: dict  # kind -> np indices of geoms
    _groups: tuple  # ((ka, kb), idx_a (into kind arrays), idx_b, pair_pos)
    # sweep routes: {other_kind: (pos, sphere_idx, other_idx)},
    # {(ka, kb, mov_a, mov_b): (pos, idx_a, idx_b, na, nb)} and the
    # translating boxes' (pos, moving_box_idx, static_box_idx) or None
    _sphere_routes: dict
    _hull_routes: dict
    _boxbox_route: Optional[tuple]
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_pairs(self) -> int:
        return len(self.pairs)

    def pair_names(self):
        return tuple(
            (self.geoms[i].name, self.geoms[j].name) for i, j in self.pairs)

    def pair_link_names(self):
        """Per-pair (link_name_i, link_name_j): geometry names are
        "link/idx"; this strips the geometry index."""
        return tuple((a.split("/")[0], b.split("/")[0])
                     for a, b in self.pair_names())

    def pair_value_array(self, default, per_pair: Optional[dict] = None,
                         dtype=np.float64) -> np.ndarray:
        """(n_pairs,) array from a default and link-pair overrides:
        ``per_pair`` maps ("linkA", "linkB") (order-insensitive) or the
        string "linkA,linkB" to a value (the reference's
        ``CollisionCoeffData``, trajopt_common/collision_types.h:124-163).
        Unknown link pairs raise."""
        out = np.full(self.n_pairs, float(default), dtype)
        if not per_pair:
            return out
        names = self.pair_link_names()
        keyed = {tuple(sorted(k.split(",") if isinstance(k, str) else k)): v
                 for k, v in per_pair.items()}
        known = {tuple(sorted(nm)) for nm in names}
        unknown = set(keyed) - known
        if unknown:
            raise ValueError(
                f"per-pair collision override names unknown pairs "
                f"{sorted(unknown)}; known link pairs: {sorted(known)}")
        for k, (a, b) in enumerate(names):
            v = keyed.get(tuple(sorted((a, b))))
            if v is not None:
                out[k] = float(v)
        return out

    def pair_routes(self):
        """Per pair: ``("sphere", None)`` (exact sphere sweep, set),
        ``("boxbox", None)`` (exact translating-box sweep, set),
        ``("hull", (na, nb))`` (two-pose hull feature distance, min),
        ``("convex", (na, nb))`` (``d_convex_auto`` over the two-pose
        sets, min) or ``("none", None)``."""
        out = [("none", None)] * self.n_pairs
        for pos, _, _ in self._sphere_routes.values():
            for k in pos:
                out[k] = ("sphere", None)
        for k in () if self._boxbox_route is None else self._boxbox_route[0]:
            out[k] = ("boxbox", None)
        for key, (pos, _, _, na, nb) in self._hull_routes.items():
            for k in pos:
                out[k] = ("convex" if CONVEX in key[:2] else "hull", (na, nb))
        return tuple(out)

    def convex_sizes(self):
        """The (n1, n2) vertex-set sizes at which this world's cast calls
        ``d_convex_auto``: a pair with a CONVEX side at a substate (not
        a sphere sweep), and the two-pose sets of its CONVEX hull routes."""
        routes = self.pair_routes()
        sizes = set()
        for (ka, kb), ia, ib, pos in self._groups:
            if kb != CONVEX:
                continue
            for k, gi in zip(pos, self._kind_idx[ka][ia]):
                if routes[k][0] != "sphere":
                    sizes.add((len(self.geoms[gi].verts) if ka == CONVEX
                               else _SUPPORT_N[ka], self.n_convex_verts))
        sizes.update(h for r, h in routes if r == "convex")
        return sorted(sizes)

    def kernel_routes(self):
        """The CONVEX routes the cast kernels run on this world:
        ``convex_feature`` (the generic feature enumeration) and / or
        ``convex_fw`` (Frank-Wolfe max separation)."""
        out = set()
        for n1, n2 in self.convex_sizes():
            out.add("convex_feature" if max(n1, n2) <= G.GENERIC_FEATURE_MAX_VERTS
                    else "convex_fw")
        return sorted(out)

    @property
    def n_box_pairs(self) -> int:
        """The number of box-box pairs (the SAT distances)."""
        return sum(len(pos) for (ka, kb), _, _, pos in self._groups
                   if (ka, kb) == (BOX, BOX))

    @property
    def n_convex_verts(self) -> int:
        """The (padded) vertex count of the world's CONVEX geometry, or 0."""
        return max((len(g.verts) for g in self.geoms if g.kind == CONVEX),
                   default=0)

    # ---------------- world-space canonical geometry ----------------

    def _const(self, name, fn, dt, dev):
        key = (name, dt, str(dev))
        v = self._cache.get(key)
        if v is None:
            v = torch.as_tensor(np.asarray(fn(), np.float64), dtype=dt,
                                device=dev)
            self._cache[key] = v
        return v

    def _world_kind_arrays(self, R, p, dt):
        """Canonical world-space arrays per kind from link poses
        (..., L, 3, 3), (..., L, 3); radii and half extents are constants
        without the leading axes."""
        out = {}
        dev = R.device
        for kind, idx in self._kind_idx.items():
            if len(idx) == 0:
                continue
            gs = [self.geoms[i] for i in idx]
            links = torch.as_tensor([g.link for g in gs], device=dev)
            offp = self._const(("offp", kind),
                               lambda: np.stack([g.off_p for g in gs]), dt, dev)
            offR = self._const(("offR", kind),
                               lambda: np.stack([g.off_R for g in gs]), dt, dev)
            Rl = R.index_select(R.dim() - 3, links)
            pl = p.index_select(p.dim() - 2, links)
            c = torch.einsum("...kij,kj->...ki", Rl, offp) + pl
            r = self._const(("r", kind), lambda: [g.radius for g in gs], dt, dev)
            if kind == SPHERE:
                out[kind] = (c, r)
            elif kind == CAPSULE:
                Rw = torch.einsum("...kij,kjl->...kil", Rl, offR)
                hl = self._const(("hl", kind), lambda: [g.half[2] for g in gs],
                                 dt, dev)
                axis = Rw[..., :, 2] * hl[:, None]
                out[kind] = (c - axis, c + axis, r)
            elif kind == BOX:
                Rw = torch.einsum("...kij,kjl->...kil", Rl, offR)
                h = self._const(("h", kind),
                                lambda: np.stack([g.half for g in gs]), dt, dev)
                out[kind] = (c, Rw, h)
            else:  # CONVEX: world vertices (..., k, V, 3) and sweep radius
                Rw = torch.einsum("...kij,kjl->...kil", Rl, offR)
                Vl = self._const(("verts", kind),
                                 lambda: np.stack([g.verts for g in gs]), dt,
                                 dev)
                Vw = torch.einsum("...kij,kvj->...kvi", Rw, Vl) \
                    + c[..., None, :]
                out[kind] = (Vw, r)
        return out

    # ---------------- queries ----------------

    def pair_distances(self, q: torch.Tensor) -> torch.Tensor:
        """(..., n_pairs) signed distances at configurations q (..., n_dof)."""
        R, p = self.chain.fk(q)
        return self._pair_distances_from_poses(R, p, q.dtype)

    def _pair_distances_from_poses(self, R, p, dt) -> torch.Tensor:
        wk = self._world_kind_arrays(R, p, dt)
        return torch.cat([_KERNELS[key](_take(wk, key[0], ia),
                                        _take(wk, key[1], ib))
                          for key, ia, ib, _ in self._groups], dim=-1)

    @staticmethod
    def _fractions(n_sub, dt, dev):
        return torch.linspace(0.0, 1.0, n_sub, dtype=torch.float64,
                              device=dev).to(dt)

    def cast_pair_distances_sub(self, qa, qb, n_sub: int = 8):
        """(..., n_sub, n_pairs) discrete distances at the interpolated
        substates of qa -> qb."""
        ss = self._fractions(n_sub, qa.dtype, qa.device)
        qs = qa[..., None, :] + ss[:, None] * (qb - qa)[..., None, :]
        return self.pair_distances(qs)

    def cast_pair_distances_seg(self, qa, qb, n_sub: int = 8):
        """(..., n_sub - 1, n_pairs) swept distances over the consecutive
        substate segments of qa -> qb: FK and the discrete distances once
        per substate, the exact-sweep overrides per segment."""
        dt = qa.dtype
        ss = self._fractions(n_sub, dt, qa.device)
        qs = qa[..., None, :] + ss[:, None] * (qb - qa)[..., None, :]
        Rs, ps = self.chain.fk(qs)
        wks = self._world_kind_arrays(Rs, ps, dt)
        sub_d = self._pair_distances_from_poses(Rs, ps, dt)
        d_min = torch.minimum(sub_d[..., :-1, :], sub_d[..., 1:, :])
        wa = _narrow_sub(wks, 0, n_sub - 1)
        wb = _narrow_sub(wks, 1, n_sub - 1)
        return self._exact_sweep_overrides(wa, wb, d_min)

    def cast_pair_distances(self, qa, qb, n_sub: int = 8):
        """(..., n_pairs) swept distances over qa -> qb: the min over
        ``n_sub`` substates, then the exact-sweep overrides between the
        two endpoint poses."""
        dt = qa.dtype
        Ra, pa = self.chain.fk(qa)
        Rb, pb = self.chain.fk(qb)
        d_min = torch.amin(self.cast_pair_distances_sub(qa, qb, n_sub), dim=-2)
        wa = self._world_kind_arrays(Ra, pa, dt)
        wb = self._world_kind_arrays(Rb, pb, dt)
        return self._exact_sweep_overrides(wa, wb, d_min)

    def _vert_sets(self, wk, kind, sel, wk_b=None):
        """Support vertex sets (..., k, V, 3) and radii (k,) of geometries
        ``sel``; with ``wk_b`` the two-pose set conv(A(qa) u A(qb))."""
        def one(w):
            A = _take(w, kind, sel)
            if kind == SPHERE:
                return A[0][..., None, :], A[1]
            if kind == CAPSULE:
                return torch.stack([A[0], A[1]], dim=-2), A[2]
            if kind == CONVEX:
                return A[0], A[1]
            return G.box_vertices(A[0], A[1], A[2]), torch.zeros_like(
                A[2][..., 0])

        Va, r = one(wk)
        if wk_b is None:
            return Va, r
        Vb, _ = one(wk_b)
        return torch.cat([Va, Vb], dim=-2), r

    def _boxbox_sweep(self, wa, wb):
        """``d_swept_box_box``'s arguments for the translating boxes, from
        the world-kind arrays at the motion's ends (the static box's pose
        and the moving box's R at ``wa``)."""
        _, ai, bi = self._boxbox_route
        c1a, R1, h1 = _take(wa, BOX, ai)
        c2, R2, h2 = _take(wa, BOX, bi)
        return c1a, _take(wb, BOX, ai)[0], R1, h1, c2, R2, h2

    def _exact_sweep_overrides(self, wa, wb, d_min):
        """Replace the substate-min distance of every pair with a moving
        side: a moving sphere against static geometry by its exact swept
        capsule, a translating box against a static box by its exact swept
        zonotope (both set); every other such pair by the min with the exact
        feature distance to the convex hull of its two poses."""
        P = self.n_pairs
        cols = [d_min]
        src = np.arange(P)
        off = P
        for okind, (pos, si, oi) in self._sphere_routes.items():
            ca = _take(wa, SPHERE, si)[0]
            cb, r = _take(wb, SPHERE, si)[0], _take(wa, SPHERE, si)[1]
            other = _take(wa, okind, oi)
            if okind == SPHERE:
                d = G.d_sphere_capsule(other[0], other[1], ca, cb, r)
            elif okind == CAPSULE:
                d = G.d_capsule_capsule(ca, cb, r, *other)
            elif okind == CONVEX:
                d = G.d_convex_convex(torch.stack([ca, cb], dim=-2), r,
                                      other[0], other[1])
            else:
                d = G.d_capsule_box(ca, cb, r, *other)
            cols.append(d)
            src[pos] = off + np.arange(len(pos))
            off += len(pos)
        if self._boxbox_route is not None:
            pos = self._boxbox_route[0]
            cols.append(G.d_swept_box_box(*self._boxbox_sweep(wa, wb)))
            src[pos] = off + np.arange(len(pos))
            off += len(pos)
        for (ka, kb, mov_a, mov_b), (pos, ai, bi, na, nb) in \
                self._hull_routes.items():
            VA, rA = self._vert_sets(wa, ka, ai, wb if mov_a else None)
            VB, rB = self._vert_sets(wa, kb, bi, wb if mov_b else None)
            if CONVEX in (ka, kb):  # no static topology: d_convex_auto
                d = G.d_convex_auto(VA, rA, VB, rB)
            else:
                d = G.make_feature_distance(na, nb)(VA, rA, VB, rB)
            pos_t = torch.as_tensor(pos, device=d_min.device)
            cols.append(torch.minimum(d_min.index_select(-1, pos_t), d))
            src[pos] = off + np.arange(len(pos))
            off += len(pos)
        return torch.cat(cols, dim=-1).index_select(
            -1, torch.as_tensor(src, device=d_min.device))

    def cast_ties(self, qa, qb, n_sub: int = 8, rel: float = 1e-9,
                  wtol: float = 1e-9, band: float = 0.0):
        """(..., n_sub - 1, n_pairs) bool: the rows of
        ``cast_pair_distances_seg`` with a tied discrete decision — the
        witness of a hull route (``geometry.feature_ties``, or
        ``geometry.convex_auto_ties`` for ``d_convex_auto``) or of a CONVEX
        pair's generic feature distance at either substate, the
        ``d_convex_convex`` sweep of a sphere against a CONVEX geometry
        (``geometry.convex_convex_ties``), the SAT max of a translating
        box's sweep (``geometry.swept_box_box_ties``), or a min whose two
        sides (two substates; substate and hull) lie within ``band``.
        There another implementation, or another rounding, may return the
        same distance with another valid Jacobian."""
        dt = qa.dtype
        ss = self._fractions(n_sub, dt, qa.device)
        qs = qa[..., None, :] + ss[:, None] * (qb - qa)[..., None, :]
        Rs, ps = self.chain.fk(qs)
        wks = self._world_kind_arrays(Rs, ps, dt)
        sub_d = self._pair_distances_from_poses(Rs, ps, dt)
        d_min = torch.minimum(sub_d[..., :-1, :], sub_d[..., 1:, :])
        out = torch.abs(sub_d[..., :-1, :] - sub_d[..., 1:, :]) <= band
        for (ka, kb), ia, ib, pos in self._groups:
            if kb != CONVEX:
                continue
            V1, _ = self._vert_sets(wks, ka, ia)
            V2, _ = self._vert_sets(wks, kb, ib)
            t = G.convex_auto_ties(V1.shape[-2], V2.shape[-2])(
                V1, V2, rel, wtol, band)
            out[..., torch.as_tensor(pos)] |= t[..., :-1, :] | t[..., 1:, :]
        wa = _narrow_sub(wks, 0, n_sub - 1)
        wb = _narrow_sub(wks, 1, n_sub - 1)
        for okind, (pos, si, oi) in self._sphere_routes.items():
            pos_t = torch.as_tensor(pos)
            out[..., pos_t] = False
            if okind == CONVEX:
                V1 = torch.stack([_take(wa, SPHERE, si)[0],
                                  _take(wb, SPHERE, si)[0]], dim=-2)
                out[..., pos_t] = G.convex_convex_ties(
                    V1, _take(wa, CONVEX, oi)[0], rel, wtol, band)
        if self._boxbox_route is not None:
            out[..., torch.as_tensor(self._boxbox_route[0])] = \
                G.swept_box_box_ties(*self._boxbox_sweep(wa, wb), rel)
        for (ka, kb, mov_a, mov_b), (pos, ai, bi, na, nb) in \
                self._hull_routes.items():
            VA, rA = self._vert_sets(wa, ka, ai, wb if mov_a else None)
            VB, rB = self._vert_sets(wa, kb, bi, wb if mov_b else None)
            pos_t = torch.as_tensor(pos)
            if CONVEX in (ka, kb):
                dh = G.d_convex_auto(VA, rA, VB, rB)
                ties = G.convex_auto_ties(na, nb)
            else:
                dh = G.make_feature_distance(na, nb)(VA, rA, VB, rB)
                ties = G.feature_ties(na, nb)
            out[..., pos_t] |= ties(VA, VB, rel, wtol, band) \
                | (torch.abs(d_min[..., pos_t] - dh) <= band)
        return out

    def pair_ties(self, q, rel: float = 1e-9):
        """(..., n_pairs) bool: the rows of ``pair_distances(q)`` with a
        tied discrete decision: a box-box pair whose SAT max has a near tie
        (``geometry.box_box_ties``); there another rounding may give
        another valid Jacobian.  The other closed forms have none."""
        wk = self._world_kind_arrays(*self.chain.fk(q), q.dtype)
        out = torch.zeros(q.shape[:-1] + (self.n_pairs,), dtype=torch.bool,
                          device=q.device)
        for (ka, kb), ia, ib, pos in self._groups:
            if (ka, kb) == (BOX, BOX):
                out[..., torch.as_tensor(pos)] = G.box_box_ties(
                    *_take(wk, BOX, ia), *_take(wk, BOX, ib), rel)
        return out

    def convex_route_sets(self, qa, qb, n_sub: int = 2):
        """{(n1, n2): (V1 (rows, n1, 3), r1 (rows,), V2, r2)}: the vertex
        sets at which ``cast_pair_distances_seg(qa, qb, n_sub)`` calls
        ``d_convex_auto`` — each substate of a pair with a CONVEX side,
        each segment's two-pose sets of a CONVEX hull route — as rows (the
        inputs of the route probe ``terms.collision.convex_route``)."""
        dt = qa.dtype
        ss = self._fractions(n_sub, dt, qa.device)
        qs = qa[..., None, :] + ss[:, None] * (qb - qa)[..., None, :]
        wks = self._world_kind_arrays(*self.chain.fk(qs), dt)
        wa = _narrow_sub(wks, 0, n_sub - 1)
        wb = _narrow_sub(wks, 1, n_sub - 1)
        sets = [(self._vert_sets(wks, ka, ia), self._vert_sets(wks, kb, ib))
                for (ka, kb), ia, ib, _ in self._groups if kb == CONVEX]
        sets += [(self._vert_sets(wa, ka, ai, wb if ma else None),
                  self._vert_sets(wa, kb, bi, wb if mb else None))
                 for (ka, kb, ma, mb), (_, ai, bi, _, _) in
                 self._hull_routes.items() if CONVEX in (ka, kb)]
        out = {}
        for (V1, r1), (V2, r2) in sets:
            rows = [V1.reshape(-1, *V1.shape[-2:]),
                    r1.expand(V1.shape[:-2]).reshape(-1),
                    V2.reshape(-1, *V2.shape[-2:]),
                    r2.expand(V2.shape[:-2]).reshape(-1)]
            key = (V1.shape[-2], V2.shape[-2])
            if key in out:
                rows = [torch.cat([a, b]) for a, b in zip(out[key], rows)]
            out[key] = tuple(rows)
        return out

    # ---------------- tables of the CUDA kernels ----------------

    def kernel_tables(self, dtype, device):
        """(ints (int32), reals (dtype)) device tensors describing the
        world for ``csrc/cast_seg.cu`` (layout in ``csrc/collision.cuh``)."""
        key = ("tables", dtype, str(device))
        t = self._cache.get(key)
        if t is None:
            ints, reals = self._pack_tables()
            t = (torch.as_tensor(ints, dtype=torch.int32, device=device),
                 torch.as_tensor(reals, dtype=torch.float64,
                                 device=device).to(dtype))
            self._cache[key] = t
        return t

    def _work_lists(self):
        """The kernels' work lists (``csrc/cast_block.cuh``): five counts,
        then the pairs of phase B's [closed form | CONVEX side] and of phase
        C's [exact sweep (sphere, box) | min only | team route].  Closed
        forms and sweeps are grouped by kind pair, so that neighbouring
        threads run one route; the team items come heaviest first
        (Frank-Wolfe, then the larger vertex sets), so that a block's last
        round is a light one."""
        routes = self.pair_routes()
        kinds = [(self.geoms[i].kind, self.geoms[j].kind) for i, j in self.pairs]
        disc = [k for k in range(self.n_pairs)
                if routes[k][0] not in ("sphere", "boxbox")]

        def of(route):
            return [k for k in range(self.n_pairs) if routes[k][0] == route]

        def heavy(k):
            n1, n2 = routes[k][1]
            return (max(n1, n2) <= G.GENERIC_FEATURE_MAX_VERTS, -n1 * n2, k)

        lists = [
            sorted((k for k in disc if kinds[k][1] != CONVEX),
                   key=lambda k: (kinds[k], k)),
            sorted((k for k in disc if kinds[k][1] == CONVEX),
                   key=lambda k: (-_SUPPORT_N.get(kinds[k][0], 0), k)),
            sorted(of("sphere") + of("boxbox"), key=lambda k: (kinds[k], k)),
            sorted(of("none"), key=lambda k: (kinds[k], k)),
            sorted(of("hull") + of("convex"), key=heavy)]
        return [len(x) for x in lists] + [k for x in lists for k in x]

    def _disc_list(self):
        """K7's work list (``csrc/disc_block.cuh``): two counts,
        then every pair of [closed form | CONVEX side], the closed forms
        grouped by kind pair."""
        kinds = [(self.geoms[i].kind, self.geoms[j].kind) for i, j in self.pairs]
        lists = [sorted((k for k in range(self.n_pairs) if kinds[k][1] != CONVEX),
                        key=lambda k: (kinds[k], k)),
                 [k for k in range(self.n_pairs) if kinds[k][1] == CONVEX]]
        return [len(x) for x in lists] + [k for x in lists for k in x]

    def _pack_tables(self):
        ch = self.chain
        L, nd, NG, P = ch.n_links, ch.n_dof, len(self.geoms), self.n_pairs
        moving = ch.ancestor.any(axis=1)
        nv = self.n_convex_verts
        if nv > 8:
            raise NotImplementedError(
                f"the cast kernels take CONVEX geometry of at most 8 "
                f"vertices, not {nv}")
        if CONVEX in self._sphere_routes:
            raise NotImplementedError(
                "the sweep of a moving sphere against CONVEX geometry "
                "(d_convex_convex over the swept capsule) has no kernel yet")
        generic = sorted({n for ns in self.convex_sizes() for n in ns
                          if max(ns) <= G.GENERIC_FEATURE_MAX_VERTS and n > 2})
        head = 16
        off_dof = head
        off_link = off_dof + nd
        off_geom = off_link + 4 * L
        off_pair = off_geom + 4 * NG
        off_topo = off_pair + 8 * P
        ints = [L, nd, NG, P, off_dof, off_link, off_geom, off_pair]
        topo_blocks, o, at = [], off_topo, {}
        for kind, n in [("small", n) for n in (1, 2, 4, 8)] + \
                [("generic", n) for n in generic]:
            E, T = (G.small_hull_topology if kind == "small"
                    else G.generic_topology)(n)
            blk = [len(E), len(T)] + list(E.reshape(-1)) + list(T.reshape(-1))
            at[(kind, n)] = o
            topo_blocks.append(blk)
            o += len(blk)
        # the generic-topology directory (n = 0..12; 1 and 2 vertices are
        # the small blocks)
        directory = [at.get(("small" if n <= 2 else "generic", n), -1)
                     for n in range(G.GENERIC_FEATURE_MAX_VERTS + 1)]
        work = self._work_lists()
        ints += [at[("small", n)] for n in (1, 2, 4, 8)] + [
            nv, o, o + len(directory), o + len(directory) + len(work)]
        ints += [0] * (head - len(ints))
        ints += list(ch.link_of_dof)
        for l in range(L):
            bits = sum(1 << d for d in range(nd) if ch.ancestor[l, d])
            ints += [int(ch.parent[l]), int(ch.jtype[l]),
                     int(ch.dof_of_link[l]), bits]
        off_verts = LINK_REALS * L + GEOM_REALS * NG + G._PEN_DIRS.size
        convex = [g for g in self.geoms if g.kind == CONVEX]
        for g in self.geoms:
            ints += [g.link, g.kind, int(moving[g.link]),
                     off_verts + 3 * nv * convex.index(g)
                     if g.kind == CONVEX else 0]
        rec = [[i, j, ROUTE_NONE, 0, 0, 0, 0, 0] for i, j in self.pairs]
        for k, ((i, j), (route, hull)) in enumerate(
                zip(self.pairs, self.pair_routes())):
            if route in ("sphere", "boxbox"):
                # the moving sphere or box, then the static geometry
                gi, gj = self.geoms[i], self.geoms[j]
                s_is_i = gi.kind == (SPHERE if route == "sphere" else BOX) \
                    and moving[gi.link] and not moving[gj.link]
                rec[k][2] = ROUTE_SPHERE if route == "sphere" else ROUTE_BOXBOX
                rec[k][3], rec[k][4] = (i, j) if s_is_i else (j, i)
            elif route in ("hull", "convex"):
                rec[k][2] = ROUTE_HULL if route == "hull" else ROUTE_CONVEX
                rec[k][5], rec[k][6] = hull
        for r in rec:
            ints += r
        for blk in topo_blocks:
            ints += blk
        ints += directory
        ints += work
        ints += self._disc_list()
        reals = []
        for l in range(L):
            ax = ch.axis[l] / max(np.linalg.norm(ch.axis[l]), 1e-12)
            K = np.array([[0.0, -ax[2], ax[1]], [ax[2], 0.0, -ax[0]],
                          [-ax[1], ax[0], 0.0]])
            reals += list(ch.off_R[l].reshape(-1)) + list(ch.off_p[l]) \
                + list(ch.axis[l]) + list(K.reshape(-1)) \
                + list((K @ K).reshape(-1))
        for g in self.geoms:
            reals += list(np.asarray(g.off_R).reshape(-1)) \
                + list(np.asarray(g.off_p, np.float64)) + [g.radius] \
                + list(np.asarray(g.half, np.float64))
        reals += list(G._PEN_DIRS.reshape(-1))
        for g in convex:
            reals += list(np.asarray(g.verts, np.float64).reshape(-1))
        return np.asarray(ints, np.int64), np.asarray(reals, np.float64)


# --------------------------------------------------------------------------
# Building a world
# --------------------------------------------------------------------------


def _spec_from_urdf_geom(li: int, g, name: str) -> Optional[GeomSpec]:
    offR = rpy_to_matrix(torch.as_tensor(np.asarray(g.rpy, np.float64))).numpy()
    if g.kind == "sphere":
        return GeomSpec(li, SPHERE, offR, g.xyz, float(g.size[0]),
                        np.zeros(3), name)
    if g.kind in ("capsule", "cylinder"):
        r, ln = float(g.size[0]), float(g.size[1])
        return GeomSpec(li, CAPSULE, offR, g.xyz, r,
                        np.array([0.0, 0.0, ln / 2]), name)
    if g.kind == "box":
        return GeomSpec(li, BOX, offR, g.xyz, 0.0,
                        np.asarray(g.size) / 2.0, name)
    if g.kind in ("convex", "mesh") and getattr(g, "verts", None) is not None:
        # a convex hull's vertex set; ``size[0]``, where given, is the
        # hull's sweep radius
        r = float(g.size[0]) if np.ndim(g.size) and len(
            np.atleast_1d(g.size)) else 0.0
        return GeomSpec(li, CONVEX, offR, g.xyz, r, np.zeros(3), name,
                        verts=np.asarray(g.verts, np.float64))
    # raw meshes without vertices need an offline convex decomposition
    return None


def _geom_specs(model: RobotModel, chain: Chain) -> list:
    specs = []
    for lname, geoms in model.geoms.items():
        if lname not in chain.link_names:
            continue
        li = chain.link_index(lname)
        for gi, g in enumerate(geoms):
            s = _spec_from_urdf_geom(li, g, f"{lname}/{gi}")
            if s is not None:
                specs.append(s)
    return specs


def build_collision_world(model: RobotModel, chain: Chain,
                          extra_disabled: Optional[set] = None,
                          attachments: Optional[list] = None
                          ) -> CollisionWorld:
    """Candidate pairs: different links, not parent-child adjacent, not
    SRDF-disabled, at least one side movable; ordered grouped by kind pair.
    ``attachments``: (link_name, UrdfGeom) objects carried by a link."""
    specs = _geom_specs(model, chain)
    for ai, (lname, g) in enumerate(attachments or []):
        s = _spec_from_urdf_geom(chain.link_index(lname), g,
                                 f"{lname}/attached{ai}")
        if s is not None:
            specs.append(s)
    # pad the convex vertex sets to one V (repeat vertex 0)
    vmax = max((len(s.verts) for s in specs if s.verts is not None),
               default=0)
    specs = [dataclasses.replace(s, verts=np.concatenate(
        [s.verts, np.repeat(s.verts[:1], vmax - len(s.verts), axis=0)]))
        if s.verts is not None and len(s.verts) < vmax else s for s in specs]
    disabled = set(model.disabled_pairs) | (extra_disabled or set())
    moving = chain.ancestor.any(axis=1)
    parent = chain.parent

    def adjacent(li, lj):
        return parent[li] == lj or parent[lj] == li

    raw_pairs = []
    for i in range(len(specs)):
        for j in range(i + 1, len(specs)):
            li, lj = specs[i].link, specs[j].link
            if li == lj or adjacent(li, lj):
                continue
            names = tuple(sorted((chain.link_names[li], chain.link_names[lj])))
            if names in disabled:
                continue
            if not (moving[li] or moving[lj]):
                continue
            if specs[i].kind <= specs[j].kind:
                raw_pairs.append((i, j))
            else:
                raw_pairs.append((j, i))
    return _make_world(chain, specs, raw_pairs)


def _sweep_routes(chain: Chain, specs: list, pairs: list, kind_pos: dict):
    """The reference's ``_exact_sweep_overrides`` case split, made once.
    Raises for a pair that needs the two-pose hull of a moving box."""
    moving = chain.ancestor.any(axis=1)
    # no revolute dof: every link's rotation is constant (the reference's
    # translation_only)
    translation_only = not (np.asarray(chain.jtype)[
        np.asarray(chain.link_of_dof)] == 1).any() if chain.n_dof else True
    sphere_cases, hull_cases, boxbox_cases = {}, {}, []
    for k, (i, j) in enumerate(pairs):
        gi, gj = specs[i], specs[j]
        if not (moving[gi.link] or moving[gj.link]):
            continue
        matched = False
        for a_idx, b_idx in ((i, j), (j, i)):
            a, b = specs[a_idx], specs[b_idx]
            if moving[b.link] or not moving[a.link]:
                continue
            if a.kind == SPHERE:
                sphere_cases.setdefault(b.kind, []).append(
                    (k, kind_pos[SPHERE][a_idx], kind_pos[b.kind][b_idx]))
                matched = True
                break
            if a.kind == BOX and b.kind == BOX and translation_only:
                boxbox_cases.append(
                    (k, kind_pos[BOX][a_idx], kind_pos[BOX][b_idx]))
                matched = True
                break
        if matched:
            continue
        for g in (gi, gj):
            if g.kind == BOX and moving[g.link]:
                case = ("against a moving or non-box geometry needs the "
                        "two-pose box hull" if translation_only else
                        "of a chain with a revolute joint needs the rotating "
                        "two-pose box hull")
                raise NotImplementedError(
                    f"{g.name}: the sweep of a box on a moving link {case} "
                    "(16 vertices, d_convex_auto's Frank-Wolfe route), which "
                    "is not ported; a box on a translation-only chain "
                    "against a static box is (d_swept_box_box)")
        key = (gi.kind, gj.kind, bool(moving[gi.link]), bool(moving[gj.link]))
        hull_cases.setdefault(key, []).append(
            (k, kind_pos[gi.kind][i], kind_pos[gj.kind][j]))

    def arrays(cases):
        return tuple(np.array([c[m] for c in cases]) for m in range(3))

    def support_n(g):
        return len(g.verts) if g.kind == CONVEX else _SUPPORT_N[g.kind]

    sphere = {ok: arrays(c) for ok, c in sphere_cases.items()}
    hull = {}
    for (ka, kb, ma, mb), cases in hull_cases.items():
        i, j = pairs[cases[0][0]]
        na = support_n(specs[i]) * (2 if ma else 1)
        nb = support_n(specs[j]) * (2 if mb else 1)
        hull[(ka, kb, ma, mb)] = arrays(cases) + (na, nb)
    return sphere, hull, arrays(boxbox_cases) if boxbox_cases else None


def _make_world(chain: Chain, specs: list, raw_pairs: list) -> CollisionWorld:
    """Group candidate pairs by (kind, kind) and build the world."""
    kind_idx = {k: [] for k in (SPHERE, CAPSULE, BOX, CONVEX)}
    for gi, g in enumerate(specs):
        kind_idx[g.kind].append(gi)
    kind_idx = {k: np.asarray(v, dtype=np.int64) for k, v in kind_idx.items()}
    kind_pos = {k: {g: i for i, g in enumerate(idx)}
                for k, idx in kind_idx.items()}

    by_type: dict = {}
    for (i, j) in raw_pairs:
        by_type.setdefault((specs[i].kind, specs[j].kind), []).append((i, j))
    pairs, groups, pos = [], [], 0
    for key in sorted(by_type):
        plist = by_type[key]
        ia = np.array([kind_pos[key[0]][i] for i, _ in plist])
        ib = np.array([kind_pos[key[1]][j] for _, j in plist])
        groups.append((key, ia, ib, np.arange(pos, pos + len(plist))))
        pairs.extend(plist)
        pos += len(plist)
    sphere, hull, boxbox = _sweep_routes(chain, specs, pairs, kind_pos)
    return CollisionWorld(chain, tuple(specs), tuple(pairs), kind_idx,
                          tuple(groups), sphere, hull, boxbox)
