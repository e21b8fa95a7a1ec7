"""PyTorch port vs JAX reference: the CONVEX geometry of pick-and-place
(float64 on the CPU).

The same numpy inputs, made from a seed, go through the JAX functions and
their port: the two CONVEX routes (``d_convex_auto``'s generic feature
enumeration, ``d_convex_convex`` with ``_fw_weights``), the transfer world
of ``benchmarks._pnp_scene`` (a convex payload attached to the tool) and
its cast pipeline and gate.  Tolerances: values 1e-12 and Jacobians 1e-10
absolute on the rows without a tied decision (``convex_auto_ties``,
``CollisionWorld.cast_ties``); there another rounding may pick another
valid witness, so the tied rows' values are held to ``TIED_VALUE_TOL``
(an exact tie of two directions may start the Frank-Wolfe polish
elsewhere and move the lower bound; measured within 2.1e-13 here) and
their Jacobians are not compared.  The number of tied rows is printed.

The cast kernels' device code built for the host (``cast_host``, the CVX
instantiations) and the route probe (``convex_route_host``) are held
against the plain versions on the transfer world; those tests skip where
there is no C++ compiler.  ``test_tie_rules_flag_crossings`` moves rows
across each tie rule and checks that the Jacobian jumps there and that
the rule flags the row.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu import benchmarks as JB
from trajopt_tpu.collision import geometry as JG
from trajopt_tpu.terms import collision as JC
from trajopt_tpu_torch import benchmarks as TB
from trajopt_tpu_torch.collision import geometry as TG
from trajopt_tpu_torch.convert import chain_from_numpy, world_from_numpy
from trajopt_tpu_torch.terms import collision as TC

TOL, JTOL = 1e-12, 1e-10
# every row of the routes, tied ones included: 2.1e-13 measured on these
# inputs (the (2, 16) contacts), where the rows' two roundings take one
# witness or two witnesses of one value
TIED_VALUE_TOL = 1e-11
T, LANES = 6, 3
SIZES = [(4, 16), (2, 16), (8, 16), (2, 8), (8, 8)]
TIE64 = (1e-9, 1e-9, 0.0)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _host_compiler():
    if not (os.environ.get("CXX") or shutil.which("c++")):
        pytest.skip("no C++ compiler for the host build of the cast kernels")


def _box(c, h):
    """(8, 3) corners of the axis-aligned box at c with half extents h, in
    ``box_vertices`` order."""
    s = np.array([[a, b, d] for a in (-1, 1) for b in (-1, 1) for d in (-1, 1)])
    return np.asarray(c)[None] + s * np.asarray(h)[None]


def _route_inputs(n1, n2, seed):
    """Random hulls (48 rows) and axis-aligned contacts (16 rows): a box
    (n 8) or a segment along its top face (n 2, two poses n 4) resting on,
    touching or just penetrating an axis-aligned box (n2 8) or its two
    poses a small translation apart (n2 16)."""
    rng = np.random.default_rng(seed)
    n = 48
    V1 = rng.normal(0.0, 0.15, (n, n1, 3))
    V2 = rng.normal(0.0, 0.15, (n, n2, 3)) + rng.normal(0.0, 0.25, (n, 1, 3))
    A, B = [], []
    for gap in (-0.01, 0.0, 1e-3, 0.02) * 4:
        h2 = rng.uniform(0.05, 0.15, 3)
        c2 = rng.normal(0.0, 0.2, 3)
        top = c2[2] + h2[2] + gap
        if n1 == 8:
            h1 = rng.uniform(0.03, 0.1, 3)
            a = _box(c2 + [rng.uniform(-0.05, 0.05), 0.0, h2[2] + gap + h1[2]],
                     h1)
        else:
            x = c2[0] + rng.uniform(-0.5, 0.5) * h2[0]
            seg = np.array([[x, c2[1] - h2[1], top], [x, c2[1] + h2[1], top]])
            a = seg if n1 == 2 else np.concatenate(
                [seg, seg + [rng.uniform(0.01, 0.05), 0.0, 0.0]])
        b = _box(c2, h2)
        if n2 == 16:
            b = np.concatenate([b, b + [rng.uniform(0.01, 0.05), 0.0, 0.0]])
        A.append(a)
        B.append(b)
    V1 = np.concatenate([V1, np.stack(A)])
    V2 = np.concatenate([V2, np.stack(B)])
    r1 = rng.uniform(0.0, 0.05, len(V1))
    r2 = rng.uniform(0.0, 0.02, len(V1))
    return V1, r1, V2, r2


@pytest.mark.parametrize("n1,n2", SIZES)
def test_convex_routes(n1, n2):
    """``d_convex_auto`` (the generic enumeration up to 12 vertices,
    Frank-Wolfe beyond) and, on the FW sizes, ``_fw_weights``: values to
    1e-12 and jacfwd to 1e-10 on the untied rows, values of every row
    within TIED_VALUE_TOL."""
    V1, r1, V2, r2 = _route_inputs(n1, n2, 100 * n1 + n2)
    jf = jax.jit(jax.vmap(JG.d_convex_auto))
    ref = np.asarray(jf(V1, r1, V2, r2))
    args = [_t(a) for a in (V1, r1, V2, r2)]
    got = TG.d_convex_auto(*args).numpy()
    tie = TG.convex_auto_ties(n1, n2)(args[0], args[2], *TIE64).numpy()
    print(f"({n1},{n2}): {int(tie.sum())} of {len(tie)} tie rows skipped; "
          f"all rows within {np.abs(got - ref).max():.3e}")
    assert (ref < 0).any() and (ref > 0).any()
    np.testing.assert_allclose(got[~tie], ref[~tie], rtol=0, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TIED_VALUE_TOL)
    gj = jax.jit(jax.vmap(jax.jacfwd(JG.d_convex_auto, argnums=(0, 2))))(
        V1, r1, V2, r2)
    gt = torch.func.vmap(torch.func.jacfwd(TG.d_convex_auto,
                                           argnums=(0, 2)))(*args)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy()[~tie], np.asarray(b)[~tie],
                                   rtol=0, atol=JTOL)
    if max(n1, n2) > TG.GENERIC_FEATURE_MAX_VERTS:
        # the weights on the random hulls (the contacts' support picks tie
        # exactly; the FW direction decides there only where fw_pick says)
        lj = jax.jit(jax.vmap(lambda a, b: JG._fw_weights(a, b, 24)))(
            V1[:48], V2[:48])
        lt = TG._fw_weights(args[0][:48], args[2][:48])
        for a, b in zip(lt, lj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=TOL)


@pytest.fixture(scope="module")
def scenes():
    """(JAX world_att, port world_att, port world_free)."""
    _, _, _, jw = JB._pnp_scene()
    _, _, tf, tw = TB._pnp_scene()
    return jw, tw, tf


@pytest.fixture(scope="module")
def traj():
    """Transfer-like trajectories at T=6: the straight line from a
    perturbed grasp to a perturbed place (through the wall) plus a bump
    and seeded noise."""
    rng = np.random.default_rng(5)
    a = np.linspace(0.0, 1.0, T)[:, None]
    out = []
    for _ in range(LANES):
        g = JB.Q_PNP_GRASP + rng.uniform(-0.05, 0.05, 7)
        p = JB.Q_PNP_PLACE + rng.uniform(-0.05, 0.05, 7)
        bump = np.sin(np.pi * np.arange(T) / (T - 1))[:, None] \
            * rng.uniform(-0.3, 0.3, 7)
        out.append((1 - a) * g + a * p + bump + rng.normal(0.0, 0.02, (T, 7)))
    return np.stack(out).reshape(LANES, -1)


def test_transfer_world_tables(scenes):
    """The port's transfer world, its world built from the reference's
    numpy tables (vertices included) and the reference world: the same
    pairs in the same order, names, kinds, constants and routes."""
    jw, tw, tf = scenes
    geoms = [{f: getattr(g, f) for f in ("link", "kind", "off_R", "off_p",
                                         "radius", "half", "name", "verts")}
             for g in jw.geoms]
    cw = world_from_numpy(chain_from_numpy(jw.chain), geoms, jw.pairs)
    assert tw.n_pairs == cw.n_pairs == jw.n_pairs == 34 and tf.n_pairs == 28
    for w in (tw, cw):
        assert w.pairs == tuple(jw.pairs)
        assert w.pair_names() == jw.pair_names()
        for a, b in zip(w.geoms, jw.geoms):
            assert (a.link, a.kind, a.name) == (b.link, b.kind, b.name)
            assert a.radius == b.radius
            for f in ("off_R", "off_p", "half"):
                np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                           rtol=0, atol=TOL)
            assert (a.verts is None) == (b.verts is None)
            if a.verts is not None:
                np.testing.assert_array_equal(a.verts, b.verts)
        assert [(k, *[a.tolist() for a in g]) for k, *g in w._groups] \
            == [(k, *[a.tolist() for a in g]) for k, *g in jw._groups]
    routes = tw.pair_routes()
    assert routes == cw.pair_routes()
    assert [h for r, h in routes if r == "convex"] \
        == [(2, 16)] + [(4, 16)] * 5 + [(8, 16)]
    assert tw.convex_sizes() == [(2, 8), (2, 16), (4, 16), (8, 8), (8, 16)]
    assert tw.kernel_routes() == ["convex_feature", "convex_fw"]
    assert tf.kernel_routes() == [] and tf.n_convex_verts == 0


def test_transfer_pair_and_segment_distances(scenes):
    jw, tw, _ = scenes
    rng = np.random.default_rng(3)
    q = JB.Q_PNP_GRASP + rng.uniform(-1.0, 1.0, (6, 7))
    ref = np.asarray(jax.jit(jax.vmap(jw.pair_distances))(jnp.asarray(q)))
    np.testing.assert_allclose(tw.pair_distances(_t(q)).numpy(), ref,
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("n_sub", [2])
def test_transfer_cast_distance_pre(scenes, traj, n_sub):
    """``cast_pair_distances_seg`` through ``CastDistancePre.value`` /
    ``value_jac`` on the transfer world: D to 1e-12 on every row, Ja / Jb
    to 1e-10 on the rows without a tied decision."""
    jw, tw, _ = scenes
    jp = JC.CastDistancePre(jw, T, n_sub=n_sub)
    Dj, (Jaj, Jbj) = jax.jit(jax.vmap(jp.value_jac))(jnp.asarray(traj))
    tp = TC.CastDistancePre(tw, T, n_sub=n_sub)
    x = _t(traj)
    D, (Ja, Jb) = tp.value_jac(x)
    np.testing.assert_allclose(D.numpy(), np.asarray(Dj), rtol=0, atol=TOL)
    np.testing.assert_allclose(tp.value(x).numpy(), np.asarray(Dj), rtol=0,
                               atol=TOL)
    X = x.reshape(LANES, T, 7)
    np.testing.assert_allclose(
        tw.cast_pair_distances_seg(X[:, :-1], X[:, 1:], n_sub).numpy(),
        np.asarray(Dj).reshape(LANES, T - 1, n_sub - 1, -1), rtol=0, atol=TOL)
    tie = tw.cast_ties(X[:, :-1], X[:, 1:], n_sub).reshape(
        LANES, T - 1, -1).numpy()
    print(f"n_sub={n_sub}: {int(tie.sum())} of {tie.size} tie rows skipped")
    assert (~tie[..., -7:]).sum() > 0  # untied payload rows are compared
    for got, ref in ((Ja, Jaj), (Jb, Jbj)):
        np.testing.assert_allclose(got.numpy()[~tie], np.asarray(ref)[~tie],
                                   rtol=0, atol=JTOL)


def test_transfer_gate(scenes, traj):
    jw, tw, _ = scenes
    X = traj.reshape(LANES, T, 7)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda x: JC.trajectory_in_collision(jw, x)))(jnp.asarray(X)))
    got = TC.trajectory_in_collision(tw, _t(X)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    assert (got < 0).all()  # the straight transfer passes through the wall


# the host build's team sizes: 1 (one thread is the whole block) and the
# card's layout (128 threads in warps); the team-1 cases keep their ids
HOST_TEAMS = [pytest.param(2, 1, id="2"), pytest.param(3, 1, id="3"),
              pytest.param(2, TC.CAST_TEAM, id="2-team32"),
              pytest.param(3, TC.CAST_TEAM, id="3-team32")]


@pytest.mark.parametrize("n_sub,team", HOST_TEAMS)
def test_cast_kernels_host_build(scenes, traj, n_sub, team):
    """K4, K4v and K5's CVX instantiations built for the host (their block
    body, played at team size ``team``) against the plain versions on the
    transfer world: D and the n_sub=16 gate to 1e-12 on every row, Ja / Jb
    to 1e-10 on the untied rows; at team size 32 also bitwise equal to
    team size 1 and to each kernel's layout on the card."""
    _host_compiler()
    _, tw, _ = scenes
    x = _t(traj)
    tp = TC.CastDistancePre(tw, T, n_sub=n_sub)
    D, (Ja, Jb) = tp.value_jac(x)
    args = (T, 7, 0, T - 1, n_sub)
    Dk, Jak, Jbk = TC.cast_host("cast_seg", tw, x, *args, team=team)
    np.testing.assert_allclose(Dk.numpy(), D.numpy(), rtol=0, atol=TOL)
    Dv = TC.cast_host("cast_seg_value", tw, x, *args, team=team)[0]
    np.testing.assert_allclose(Dv.numpy(), D.numpy(), rtol=0, atol=TOL)
    X = x.reshape(LANES, T, 7)
    tie = tw.cast_ties(X[:, :-1], X[:, 1:], n_sub).reshape(
        LANES, T - 1, -1).numpy()
    print(f"host build, n_sub={n_sub}, team {team}: {int(tie.sum())} of "
          f"{tie.size} tie rows skipped")
    for got, ref in ((Jak, Ja), (Jbk, Jb)):
        np.testing.assert_allclose(got.numpy()[~tie], ref.numpy()[~tie],
                                   rtol=0, atol=JTOL)
    gate = (T, 7, 0, T - 1, 16)
    Ds = TC.cast_host("cast_sweep", tw, x, *gate, team=team)[0]
    np.testing.assert_allclose(Ds.numpy(),
                               TC.cast_sweep_distances(tw, X, 16).numpy(),
                               rtol=0, atol=TOL)
    if team != 1:  # how the block divides the work changes no bit: team
        # size 1, warps, and each kernel's layout on the card
        blocks = {k: TC.CAST_BLOCKS[k, True] for k in ("cast_seg",
                                                     "cast_seg_value",
                                                     "cast_sweep")}
        for layout in ({k: (128, 1) for k in blocks}, blocks):
            (thr, tm), (thr_v, tm_v), (thr_s, tm_s) = layout.values()
            other = TC.cast_host("cast_seg", tw, x, *args, team=tm,
                                 threads=thr) \
                + TC.cast_host("cast_seg_value", tw, x, *args, team=tm_v,
                               threads=thr_v)[:1] \
                + TC.cast_host("cast_sweep", tw, x, *gate, team=tm_s,
                               threads=thr_s)[:1]
            for a, b in zip((Dk, Jak, Jbk, Dv, Ds), other):
                assert torch.equal(a, b)


ROUTE_TEAMS = [pytest.param(n1, n2, 1, id=f"{n1}-{n2}") for n1, n2 in SIZES] \
    + [pytest.param(n1, n2, TC.CAST_TEAM, id=f"{n1}-{n2}-team32")
       for n1, n2 in SIZES]


@pytest.mark.parametrize("n1,n2,team", ROUTE_TEAMS)
def test_convex_route_host_build(scenes, n1, n2, team):
    """The route probe built for the host (one team per row, at team size
    ``team``) against the plain route on the same rows: values to 1e-12 on
    the untied rows; at the card's team size values and witness indices
    bitwise equal to team size 1."""
    _host_compiler()
    _, tw, _ = scenes
    fw = max(n1, n2) > TG.GENERIC_FEATURE_MAX_VERTS
    if not fw and n1 > 2 and n1 != 8:
        pytest.skip("no generic topology of this size in the world's tables")
    V1, r1, V2, r2 = (_t(a) for a in _route_inputs(n1, n2, 7 * n1 + n2))
    got, idx = TC.convex_route_host(tw, V1, r1, V2, r2, fw, team=team,
                                    index=True)
    ref = TC.convex_route(tw, V1, r1, V2, r2, fw).numpy()
    tie = (TG.convex_convex_ties if fw else TG.feature_ties(
        n1, n2, topology=TG.generic_topology))(V1, V2, *TIE64).numpy()
    np.testing.assert_allclose(got.numpy()[~tie], ref[~tie], rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TIED_VALUE_TOL)
    if team != 1:
        one, idx1 = TC.convex_route_host(tw, V1, r1, V2, r2, fw, index=True)
        assert torch.equal(got, one) and torch.equal(idx, idx1)


@pytest.mark.parametrize("team", [1, TC.CAST_TEAM])
def test_first_index_wins_on_tied_candidates(scenes, team):
    """Exact ties in the generic enumeration's candidate grid: a segment
    level above a box's top face (every coordinate a small dyadic number,
    so each candidate's d2 is exact) is as near to both top diagonals and
    to the top triangles under it.  The host build's winning candidate,
    strided over the team and combined on (d2, index), is the grid's first
    minimum, as the reference's argmin takes it (numpy's and torch's
    argmin agree), at team size 1 and at the card's."""
    _host_compiler()
    _, tw, _ = scenes
    V1 = np.array([[[-0.5, 0.0, 2.0], [0.5, 0.0, 2.0]],
                   [[0.25, -0.25, 1.5], [0.25, 0.25, 1.5]]])
    V2 = np.stack([_box([0.0, 0.0, 0.0], [1.0, 1.0, 1.0])] * 2)
    z = np.zeros(2)
    d2 = TG._FeatureTables(2, 8, TG.generic_topology).candidate_d2(
        _t(V1), _t(V2)).numpy()
    first = d2.argmin(-1)
    n_tied = (d2 == d2.min(-1, keepdims=True)).sum(-1)
    print(f"tied candidates per row {n_tied.tolist()}, first {first.tolist()}")
    assert (n_tied >= 3).all()
    assert (first == torch.argmin(_t(d2), -1).numpy()).all()
    D, idx = TC.convex_route_host(tw, _t(V1), _t(z), _t(V2), _t(z), False,
                                  team=team, index=True)
    assert idx.tolist() == first.tolist()
    np.testing.assert_allclose(D.numpy(), [1.0, 0.5], rtol=0, atol=TOL)


def test_collision_wrappers_launch_or_raise(scenes):
    """On a CPU tensor the plain route runs; the CUDA launchers refuse a
    CPU tensor instead of falling back."""
    _, tw, _ = scenes
    x = torch.zeros((1, 4 * 7), dtype=torch.float64)
    for kind in ("cast_seg", "cast_seg_value", "cast_sweep"):
        with pytest.raises(ValueError, match="CUDA"):
            TC._cast_launch(kind, tw, x, 4, 7, 0, 3, 2)
    V = torch.zeros((1, 16, 3), dtype=torch.float64)
    r = torch.zeros(1, dtype=torch.float64)
    assert TC.convex_route(tw, V[:, :2], r, V, r, True).shape == (1,)


def _box_t(c, h):
    return _t(_box(c, h))


def _seg(p, d):
    return _t(np.stack([p, np.asarray(p) + d]))


# families of rows moved across one tie rule (s in [lo, hi]): a segment
# over an axis-aligned box (the generic enumeration, (2, 8)) — tilted
# through level (the candidate argmin), and tilted and lowered to within
# 1e-6 of the top face (the separation test's threshold) — and a segment moved past a box's two
# poses (Frank-Wolfe, (2, 16)), at the crossings of the cover argmax, a
# polish step's ``better``, the support sharing threshold and the final
# argmax over the 29 directions
_B8 = _box([0.0, 0.0, 0.0], [0.1, 0.08, 0.05])
_B16 = np.concatenate([_box([-0.04798733425160721, -0.04090449767993217,
                             -0.20857202819690093],
                            [0.1248248503301754, 0.13607014095476777,
                             0.07471467403221074])] * 2)
_B16[8:, 0] += 0.016682117151290886
_P0 = np.array([-0.10808624467447772, -0.17196499535911666,
                -0.05261950890360859])
_P1 = np.array([-0.19096104641913136, 0.3757894947715604,
                -0.10313550534070677])
_D = np.array([-0.02371664934172196, -0.09721324879927722,
               -0.06538765984505739])
_FAMILIES = {
    "argmin": (False, 0.45, 0.55, lambda s: (
        _seg([-0.05, 0.005, 0.07 + 0.006 * (s - 0.5)],
             [0.12, 0.0, -0.012 * (s - 0.5)]), _t(_B8))),
    "threshold": (False, 0.4998, 0.5001, lambda s: (
        _seg([0.01, 0.0, 0.06 - 0.02 * s], [0.06, 0.01, 0.002]), _t(_B8))),
    "cover_argmax": (True, 0.4563, 0.4603, None),
    "polish_better": (True, 0.5483, 0.5523, None),
    "share": (True, 0.5545, 0.5585, None),
    "final_argmax": (True, 0.6464, 0.6484, None),
}


def _fw_family(s):
    return _seg(_P0 + (_P1 - _P0) * s, _D), _t(_B16)


def _jac(fw, V1, V2):
    fn = TG.d_convex_convex if fw else TG.d_convex_auto
    z = torch.zeros((), dtype=torch.float64)
    g = torch.func.jacfwd(lambda a, b: fn(a, z, b, z), argnums=(0, 1))(V1, V2)
    return torch.cat([g[0].reshape(-1), g[1].reshape(-1)])


@pytest.mark.parametrize("rule", list(_FAMILIES))
def test_tie_rules_flag_crossings(rule):
    """Move a row across one tie rule: bisect the Jacobian's jump along the
    family to 1e-13, check that it jumps by O(1) there, that the rule flags
    the rows on both sides (float64 rel / band 1e-9), and that it flags
    neither end of the family (but for the generic candidate argmin: the
    all-triples topology holds coplanar triangles with the same closest
    point and other weights, which it flags everywhere on a face)."""
    fw, lo, hi, fam = _FAMILIES[rule]
    fam = fam or _fw_family
    ss = np.linspace(lo, hi, 9)
    Js = [_jac(fw, *fam(s)) for s in ss]
    k = next(i for i in range(8)
             if float((Js[i] - Js[i + 1]).abs().max()) > 0.05)
    a, b, Ja, Jb = ss[k], ss[k + 1], Js[k], Js[k + 1]
    while b - a > 1e-13:
        m = 0.5 * (a + b)
        Jm = _jac(fw, *fam(m))
        if float((Jm - Ja).abs().max()) < float((Jm - Jb).abs().max()):
            a, Ja = m, Jm
        else:
            b, Jb = m, Jm
    jump = float((Ja - Jb).abs().max())
    assert jump > 0.05, jump

    def flags(s):
        V1, V2 = fam(s)
        if fw:
            r = TG.convex_convex_ties(V1[None], V2[None], 1e-9, 1e-9, 1e-9,
                                      rules=True)
        else:
            r = TG.feature_ties(2, 8, topology=TG.generic_topology)(
                V1[None], V2[None], 1e-9, 1e-9, 1e-9, rules=True)
        return {k: bool(v[0]) for k, v in r.items()}

    print(f"{rule}: the Jacobian jumps by {jump:.3f} at s = {a:.15f}; "
          f"flags {flags(a)} / {flags(b)}")
    assert flags(a)[rule] or flags(b)[rule]
    if rule != "argmin":  # the generic topology's coplanar triangles tie
        assert not flags(lo)[rule] and not flags(hi)[rule]  # everywhere
