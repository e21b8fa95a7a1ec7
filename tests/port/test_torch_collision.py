"""PyTorch port vs JAX reference: the cast-collision layer of the
glass-upright flagship (float64 on the CPU).

The same numpy inputs, made from a seed, go through the JAX functions and
their port.  Tolerances: values 1e-12 absolute (the same formulas in
float64; sum orders differ); Jacobians 1e-10 absolute (jacfwd through the
reference's scalar FK against jacfwd through the port's batched FK).  The
Jacobian comparisons skip rows whose witness decision is tied
(``CollisionWorld.cast_ties``): there another exact implementation may
pick another valid witness.  The number of skipped rows is printed.

The cast kernels' device code (``csrc/collision.cuh``) is also compiled
for the host (``csrc/cast_host.cpp``) and held against the port's plain
versions to the same tolerances; that test skips where there is no C++
compiler.  So are K4 at n_dof 9 (the rail world) and K4 / K4v at n_sub 8
(the planning scene).

The discrete terms (``DiscreteDistancePre``, ``discrete_collision_term``,
cost and constraint) are held against the reference on arm7 and the
spherebot: values to 1e-10, Jacobians to 1e-8 on every row (their closed
forms have no witness decision to tie at these draws); K7 / K7v built for
the host against the plain versions, float64 and float32.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.benchmarks import make_glass_upright as j_make
from trajopt_tpu.collision import geometry as JG
from trajopt_tpu.collision import world as JW
from trajopt_tpu.models import arm7 as j_arm7
from trajopt_tpu.models import spherebot as j_spherebot
from trajopt_tpu.terms import collision as JC
from trajopt_tpu_torch.benchmarks import make_glass_upright
from trajopt_tpu_torch.collision import geometry as TG
from trajopt_tpu_torch.collision import world as TW
from trajopt_tpu_torch.convert import chain_from_numpy, world_from_numpy
from trajopt_tpu_torch.kinematics.chain import build_chain
from trajopt_tpu_torch.kinematics.urdf import parse_urdf
from trajopt_tpu_torch.models import arm7 as t_arm7
from trajopt_tpu_torch.models import spherebot as t_spherebot
from trajopt_tpu_torch.terms import collision as TC

TOL, JTOL = 1e-12, 1e-10
T, LANES = 6, 3


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def worlds():
    jm, jc = j_arm7()
    tm, tc = t_arm7()
    return JW.build_collision_world(jm, jc), TW.build_collision_world(tm, tc)


@pytest.fixture(scope="module")
def jax_aux(worlds, traj):
    """The reference CastDistancePre.value_jac of ``traj`` per n_sub (one
    compile each, shared by the tests)."""
    cache = {}

    def get(n_sub):
        if n_sub not in cache:
            jp = JC.CastDistancePre(worlds[0], T, n_sub=n_sub)
            cache[n_sub] = (jp, jax.jit(jax.vmap(jp.value_jac))(
                jnp.asarray(traj)))
        return cache[n_sub]

    return get


@pytest.fixture(scope="module")
def traj():
    """The flagship's initial trajectories at T=6 plus seeded noise."""
    _, data, _, _ = j_make(LANES, n_steps=T, dtype=jnp.float64)
    rng = np.random.default_rng(7)
    x0 = np.asarray(data.x0)
    return x0 + rng.normal(0.0, 0.03, x0.shape)


def _rand_rot(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _closed_form_case(name, rng, n=48):
    """Inputs and the (JAX, port) function pair of one closed form."""
    P = lambda: rng.normal(0.0, 0.4, (n, 3))
    r = lambda: rng.uniform(0.02, 0.2, n)
    h = lambda: rng.uniform(0.05, 0.4, (n, 3))
    if name == "sphere_sphere":
        return (P(), r(), P(), r()), JG.d_sphere_sphere, TG.d_sphere_sphere
    if name == "sphere_capsule":
        return (P(), r(), P(), P(), r()), JG.d_sphere_capsule, TG.d_sphere_capsule
    if name == "capsule_capsule":
        return ((P(), P(), r(), P(), P(), r()), JG.d_capsule_capsule,
                TG.d_capsule_capsule)
    if name == "sphere_box":
        return ((P(), r(), P(), _rand_rot(rng, n), h()), JG.d_sphere_box,
                TG.d_sphere_box)
    if name == "box_point":
        return ((P(), P(), _rand_rot(rng, n), h()), JG.sdf_box_point,
                TG.sdf_box_point)
    return ((P(), P(), r(), P(), _rand_rot(rng, n), h()), JG.d_capsule_box,
            TG.d_capsule_box)


@pytest.mark.parametrize("name", ["sphere_sphere", "sphere_capsule",
                                  "capsule_capsule", "sphere_box",
                                  "box_point", "capsule_box"])
def test_closed_form_distances(name):
    """Values, and for the two iterated / clamped forms the gradient wrt
    the first point (d_capsule_box carries it through its 12 iterations)."""
    args, jf, tf = _closed_form_case(name, np.random.default_rng(11))
    ref = np.asarray(jax.vmap(jf)(*[jnp.asarray(a) for a in args]))
    got = tf(*[_t(a) for a in args]).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    if name in ("capsule_capsule", "capsule_box"):
        gj = np.asarray(jax.vmap(jax.grad(jf))(*[jnp.asarray(a) for a in args]))
        gt = torch.func.vmap(torch.func.jacfwd(tf))(*[_t(a) for a in args])
        np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=JTOL)


@pytest.mark.parametrize("n1,n2", [(4, 8), (4, 2), (4, 4), (2, 4)])
def test_feature_distance(n1, n2):
    """Random small hulls, separated and penetrating: value and the
    witness-linear gradient (ties skipped)."""
    rng = np.random.default_rng(n1 * 10 + n2)
    n = 64
    V1 = rng.normal(0.0, 0.15, (n, n1, 3))
    V2 = rng.normal(0.0, 0.15, (n, n2, 3)) + rng.normal(0.0, 0.25, (n, 1, 3))
    if n2 == 8:  # a box's vertex order and face topology
        R = _rand_rot(rng, n)
        hh = rng.uniform(0.05, 0.3, (n, 3))
        c = rng.normal(0.0, 0.3, (n, 3))
        V2 = np.asarray(jax.vmap(JG.box_vertices)(c, R, hh))
    r1, r2 = rng.uniform(0, 0.05, n), rng.uniform(0, 0.05, n)
    jf = JG.make_feature_distance(n1, n2)
    tf = TG.make_feature_distance(n1, n2)
    ref = np.asarray(jax.vmap(jf)(V1, r1, V2, r2))
    got = tf(_t(V1), _t(r1), _t(V2), _t(r2)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    assert (ref < 0).any() and (ref > 0).any()
    gj = np.asarray(jax.vmap(jax.grad(jf))(V1, r1, V2, r2))
    gt = torch.func.vmap(torch.func.jacfwd(tf))(_t(V1), _t(r1), _t(V2),
                                                _t(r2)).numpy()
    tie = TG.feature_ties(n1, n2)(_t(V1), _t(V2), 1e-9, 1e-9).numpy()
    print(f"feature ({n1},{n2}): {int(tie.sum())} of {n} tie rows skipped")
    np.testing.assert_allclose(gt[~tie], gj[~tie], rtol=0, atol=JTOL)


def test_world_tables_and_convert(worlds):
    """The port's world, its world built from the reference's numpy
    tables, and the reference world: pairs, names, kinds, links, constants
    and sweep routes equal."""
    jw, tw = worlds
    geoms = [{f: getattr(g, f) for f in ("link", "kind", "off_R", "off_p",
                                         "radius", "half", "name")}
             for g in jw.geoms]
    cw = world_from_numpy(chain_from_numpy(jw.chain), geoms, jw.pairs)
    assert tw.n_pairs == cw.n_pairs == jw.n_pairs == 28
    for w in (tw, cw):
        assert w.pairs == tuple(jw.pairs)
        assert w.pair_names() == jw.pair_names()
        for a, b in zip(w.geoms, jw.geoms):
            assert (a.link, a.kind, a.name) == (b.link, b.kind, b.name)
            assert a.radius == pytest.approx(b.radius, abs=0)
            for f in ("off_R", "off_p", "half"):
                np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                           rtol=0, atol=TOL)
        assert [(k, *[a.tolist() for a in g]) for k, *g in w._groups] \
            == [(k, *[a.tolist() for a in g]) for k, *g in jw._groups]
    routes = tw.pair_routes()
    assert routes == cw.pair_routes()
    assert sum(r == "sphere" for r, _ in routes) == 2
    sizes = [h for r, h in routes if r == "hull"]
    assert sorted(set(sizes)) == [(2, 4), (4, 4), (4, 8)]
    assert [sizes.count(s) for s in ((2, 4), (4, 4), (4, 8))] == [10, 10, 6]
    ints, reals = tw.kernel_tables(torch.float64, "cpu")
    assert ints[:4].tolist() == [tw.chain.n_links, 7, len(tw.geoms), 28]


def test_pair_and_segment_distances(worlds):
    jw, tw = worlds
    rng = np.random.default_rng(3)
    q = rng.uniform(-1.5, 1.5, (6, 7))
    ref = np.asarray(jax.jit(jax.vmap(jw.pair_distances))(jnp.asarray(q)))
    np.testing.assert_allclose(tw.pair_distances(_t(q)).numpy(), ref,
                               rtol=0, atol=TOL)
    qa, qb = q[:-1], q[1:]
    ref = np.asarray(jax.jit(jax.vmap(lambda a, b: jw.cast_pair_distances_seg(
        a, b, 3)))(jnp.asarray(qa), jnp.asarray(qb)))
    got = tw.cast_pair_distances_seg(_t(qa), _t(qb), 3).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("n_sub", [2, 3])
def test_cast_distance_pre(worlds, traj, jax_aux, n_sub):
    """value and value_jac at T=6 on 3 lanes: D to 1e-12, Ja / Jb to 1e-10
    on the rows without a tied witness decision."""
    _, tw = worlds
    tp = TC.CastDistancePre(tw, T, n_sub=n_sub)
    Dj, (Jaj, Jbj) = jax_aux(n_sub)[1]
    x = _t(traj)
    D, (Ja, Jb) = tp.value_jac(x)
    np.testing.assert_allclose(D.numpy(), np.asarray(Dj), rtol=0, atol=TOL)
    np.testing.assert_allclose(tp.value(x).numpy(), np.asarray(Dj), rtol=0,
                               atol=TOL)
    X = x.reshape(LANES, T, 7)
    tie = tw.cast_ties(X[:, :-1], X[:, 1:], n_sub).reshape(
        LANES, T - 1, -1).numpy()
    print(f"n_sub={n_sub}: {int(tie.sum())} of {tie.size} tie rows skipped")
    for got, ref in ((Ja, Jaj), (Jb, Jbj)):
        np.testing.assert_allclose(got.numpy()[~tie], np.asarray(ref)[~tie],
                                   rtol=0, atol=JTOL)


def test_trajectory_gate(worlds, traj):
    jw, tw = worlds
    X = traj.reshape(LANES, T, 7)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda x: JC.trajectory_in_collision(jw, x)))(jnp.asarray(X)))
    got = TC.trajectory_in_collision(tw, _t(X)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    assert (got < 0).any()  # the noisy initial lanes start in collision


@pytest.mark.parametrize("is_constraint", [False, True])
def test_cast_collision_term(worlds, traj, jax_aux, is_constraint):
    """err rows and banded windows of the hinge cost and the INEQ
    constraint from the same shared aux (the reference's D, Ja, Jb)."""
    jw, tw = worlds
    jp, aux = jax_aux(2)
    tp = TC.CastDistancePre(tw, T, n_sub=2)
    jt = JC.cast_collision_term("c", jw, T, n_sub=2, pre=jp,
                                is_constraint=is_constraint)
    tt = TC.cast_collision_term("c", tw, T, n_sub=2, pre=tp,
                                is_constraint=is_constraint)
    rng = np.random.default_rng(5)
    margins = rng.uniform(0.0, 0.05, LANES)
    coeffs = rng.uniform(0.5, 20.0, LANES)
    tparams = {"margins": _t(margins), "coeffs": _t(coeffs)}
    taux = (_t(aux[0]), (_t(aux[1][0]), _t(aux[1][1])))
    x = _t(traj)
    err = tt.err(x, tparams, taux[0]).numpy()
    Bt, Gt = tt.jac_banded(x, tparams, taux)
    for lane in range(LANES):
        p = {"margins": margins[lane], "coeffs": coeffs[lane]}
        a = (aux[0][lane], (aux[1][0][lane], aux[1][1][lane]))
        xl = jnp.asarray(traj[lane])
        np.testing.assert_allclose(err[lane], np.asarray(jt.fn(xl, p, a[0])),
                                   rtol=0, atol=TOL)
        Bj, Gj = jt.jac_banded_fn(xl, p, a)
        np.testing.assert_allclose(Bt[lane].numpy(), np.asarray(Bj), rtol=0,
                                   atol=TOL)
        np.testing.assert_array_equal(Gt.numpy(), np.asarray(Gj))
        if not is_constraint:
            np.testing.assert_allclose(tt.weights(tparams, x)[lane].numpy(),
                                       np.asarray(jt.weight_fn(p)), rtol=0,
                                       atol=TOL)


# the host build's team sizes: 1 (one thread is the whole block) and the
# card's layout (128 threads in warps); the team-1 cases keep their ids
HOST_TEAMS = [pytest.param(2, 1, id="2"), pytest.param(3, 1, id="3"),
              pytest.param(2, TC.CAST_TEAM, id="2-team32"),
              pytest.param(3, TC.CAST_TEAM, id="3-team32")]


@pytest.mark.parametrize("n_sub,team", HOST_TEAMS)
def test_cast_kernels_host_build(worlds, traj, n_sub, team):
    """K4, K4v and K5 built for the host (their block body, played at team
    size ``team``) against the plain versions: D and the n_sub=16 gate to
    1e-12, Ja / Jb to 1e-10 on the rows without a tied witness decision;
    at team size 32 also bitwise equal to team size 1 and to each kernel's
    layout on the card."""
    if not (os.environ.get("CXX") or shutil.which("c++")):
        pytest.skip("no C++ compiler for the host build of the cast kernels")
    _, tw = worlds
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
        blocks = {k: TC.CAST_BLOCKS[k, False] for k in ("cast_seg",
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


def test_collision_wrappers_launch_or_raise(worlds):
    """On a CPU tensor the plain version runs; the CUDA launcher refuses
    a CPU tensor instead of falling back."""
    _, tw = worlds
    x = torch.zeros((1, 4 * 7), dtype=torch.float64)
    for kind in ("cast_seg", "cast_seg_value", "cast_sweep"):
        with pytest.raises(ValueError, match="CUDA"):
            TC._cast_launch(kind, tw, x, 4, 7, 0, 3, 2)
    spec, data, _, world = make_glass_upright(2, n_steps=4,
                                              dtype=torch.float64,
                                              device="cpu")
    assert world.n_pairs == 28 and spec.n_x == 28


# ---------------------------------------------------------------------------
# the discrete terms, K7 / K7v, and K4 at n_dof 9 and n_sub 8
# ---------------------------------------------------------------------------

DISC_TOL, DISC_JTOL = 1e-10, 1e-8
# K7 / K7v (and K4 at the new sizes) built for the host against the plain
# versions: (values, Jacobians), absolute; float32 keeps ~7 digits of
# distances and tangents of order 1
HOST_TOLS = {torch.float64: (TOL, JTOL), torch.float32: (1e-5, 1e-4)}


def _disc_scene(name):
    """(reference world, port world, T, numpy x (3, T n_dof)): arm7 at
    T=6 over the flagship's initial trajectories plus noise, the spherebot
    at T=3 around its obstacle."""
    if name == "arm7":
        jm, jc = j_arm7()
        tm, tc = t_arm7()
        _, data, _, _ = j_make(LANES, n_steps=T, dtype=jnp.float64)
        x = np.asarray(data.x0) + np.random.default_rng(8).normal(
            0.0, 0.05, (LANES, T * 7))
        return JW.build_collision_world(jm, jc), \
            TW.build_collision_world(tm, tc), T, x
    jm, jc = j_spherebot()
    tm, tc = t_spherebot()
    x = np.random.default_rng(9).uniform(-1.3, 1.3, (LANES, 3 * 2))
    return JW.build_collision_world(jm, jc), \
        TW.build_collision_world(tm, tc), 3, x


def _host_compiler():
    if not (os.environ.get("CXX") or shutil.which("c++")):
        pytest.skip("no C++ compiler for the host build of the kernels")


@pytest.mark.parametrize("scene", ["arm7", "spherebot"])
def test_discrete_distance_pre_and_terms(scene):
    """DiscreteDistancePre.value / value_jac, and the discrete term's fn,
    jac_fn and jac_banded_fn as a hinge cost and as an INEQ constraint,
    against the reference lane by lane (the reference's terms read its
    pipeline's output as their aux; the port's run their own)."""
    jw, tw, TT, xn = _disc_scene(scene)
    nd = tw.chain.n_dof
    assert tw.pair_names() == jw.pair_names()
    jp = JC.DiscreteDistancePre(jw, TT)
    tp = TC.DiscreteDistancePre(tw, TT)
    x = _t(xn)
    Dj, Jj = jax.vmap(jp.value_jac)(jnp.asarray(xn))
    D, J = tp.value_jac(x)
    np.testing.assert_allclose(D.numpy(), np.asarray(Dj), rtol=0,
                               atol=DISC_TOL)
    np.testing.assert_allclose(tp.value(x).numpy(), np.asarray(Dj), rtol=0,
                               atol=DISC_TOL)
    np.testing.assert_allclose(J.numpy(), np.asarray(Jj), rtol=0,
                               atol=DISC_JTOL)
    rng = np.random.default_rng(10)
    margins = rng.uniform(0.05, 0.3, LANES)
    coeffs = rng.uniform(0.5, 20.0, LANES)
    tparams = {"margins": _t(margins), "coeffs": _t(coeffs)}
    for is_constraint in (False, True):
        jt = JC.discrete_collision_term("d", jw, TT, pre=jp,
                                        is_constraint=is_constraint)
        tt = TC.discrete_collision_term("d", tw, TT, pre=tp,
                                        is_constraint=is_constraint)
        assert tt.n_rows == jt.n_rows and tt.viol_groups == jt.viol_groups
        err = tt.fn(x, tparams).numpy()
        Jd = tt.jac_fn(x, tparams).numpy()
        Bt, Gt = tt.jac_banded_fn(x, tparams)
        for lane in range(LANES):
            p = {"margins": margins[lane], "coeffs": coeffs[lane]}
            xl = jnp.asarray(xn[lane])
            a = (Dj[lane], Jj[lane])
            np.testing.assert_allclose(err[lane],
                                       np.asarray(jt.fn(xl, p, a[0])),
                                       rtol=0, atol=DISC_TOL)
            np.testing.assert_allclose(Jd[lane],
                                       np.asarray(jt.jac_fn(xl, p, a)),
                                       rtol=0, atol=DISC_JTOL)
            if TT >= 2:  # one step has no window pair
                Bj, Gj = jt.jac_banded_fn(xl, p, a)
                np.testing.assert_allclose(Bt[lane].numpy(), np.asarray(Bj),
                                           rtol=0, atol=DISC_JTOL)
                np.testing.assert_array_equal(Gt.numpy(), np.asarray(Gj))
            if not is_constraint:
                np.testing.assert_allclose(
                    tt.weights(tparams, x)[lane].numpy(),
                    np.asarray(jt.weight_fn(p)), rtol=0, atol=DISC_TOL)
    assert (D.numpy() < 0.3).any(), "no row near contact"
    assert J.shape == (LANES, TT, tw.n_pairs, nd)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("scene", ["arm7", "spherebot"])
def test_disc_kernels_host_build(scene, dtype):
    """K7 and K7v built for the host (their block body, one thread or the
    card's layout) against the plain versions; the inv-dt column K7 writes
    past n_dof is zero; one thread and the card's block bitwise equal."""
    _host_compiler()
    _, tw, TT, xn = _disc_scene(scene)
    nd = tw.chain.n_dof
    vt, jt = HOST_TOLS[dtype]
    x = _t(xn).to(dtype)
    tp = TC.DiscreteDistancePre(tw, TT)
    D, J = tp.value_jac(x)
    args = (TT, nd, 0, TT)
    Dk, Jk = TC.disc_host("disc_dist", tw, x, *args)
    Dv = TC.disc_host("disc_dist_value", tw, x, *args)[0]
    np.testing.assert_allclose(Dk.numpy(), D.numpy(), rtol=0, atol=vt)
    np.testing.assert_allclose(Jk.numpy(), J.numpy(), rtol=0, atol=jt)
    assert torch.equal(Dv, Dk)
    D1, J1 = TC.disc_host("disc_dist", tw, x, *args, threads=1)
    assert torch.equal(D1, Dk) and torch.equal(J1, Jk)
    # steps [1, TT) of x with an inv-dt column: the column comes back zero
    xc = torch.cat([x.reshape(LANES, TT, nd),
                    torch.ones((LANES, TT, 1), dtype=dtype)], -1)
    Dc, Jc = TC.disc_host("disc_dist", tw, xc.reshape(LANES, -1).contiguous(),
                          TT, nd + 1, 1, TT - 1)
    assert torch.equal(Dc, Dk[:, 1:]) and torch.equal(Jc[..., :nd], Jk[:, 1:])
    assert (Jc[..., nd] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("scene", ["rail_nd9", "planning_nsub8"])
def test_cast_kernels_host_build_new_sizes(scene, dtype):
    """K4 at n_dof 9 on the rail world (two prismatic joints, the gantry's
    dofs an ancestor of every arm link), and K4 / K4v at n_sub 8 on the
    planning scene, built for the host at the card's layout, against the
    plain versions (Jacobians on the rows without a tied witness
    decision)."""
    _host_compiler()
    if scene == "rail_nd9":
        from trajopt_tpu_torch.benchmarks import make_redundant_rail
        _, data, chain, tw = make_redundant_rail(
            LANES, n_steps=5, dtype=torch.float64, device="cpu")
        TT, n_sub = 5, 2
    else:
        from trajopt_tpu_torch.benchmarks import make_planning
        _, data, chain, tw = make_planning(LANES, n_steps=T,
                                           dtype=torch.float64, device="cpu")
        TT, n_sub = T, 8
    nd = chain.n_dof
    vt, jt = HOST_TOLS[dtype]
    noise = np.random.default_rng(12).normal(0.0, 0.05, tuple(data.x0.shape))
    x = (data.x0 + _t(noise)).to(dtype).contiguous()
    tp = TC.CastDistancePre(tw, TT, n_sub=n_sub)
    D, (Ja, Jb) = tp.value_jac(x)
    args = (TT, nd, 0, TT - 1, n_sub)
    thr, tm = TC.CAST_BLOCKS["cast_seg", False]
    Dk, Jak, Jbk = TC.cast_host("cast_seg", tw, x, *args, team=tm,
                                threads=thr)
    thr, tm = TC.CAST_BLOCKS["cast_seg_value", False]
    Dv = TC.cast_host("cast_seg_value", tw, x, *args, team=tm,
                      threads=thr)[0]
    np.testing.assert_allclose(Dk.numpy(), D.numpy(), rtol=0, atol=vt)
    np.testing.assert_allclose(Dv.numpy(), D.numpy(), rtol=0, atol=vt)
    X = x.reshape(LANES, TT, nd)
    rule = (1e-9, 1e-9, 0.0) if dtype == torch.float64 else (1e-3, 1e-4, 1e-5)
    tie = tw.cast_ties(X[:, :-1], X[:, 1:], n_sub, *rule).reshape(
        LANES, TT - 1, -1).numpy()
    print(f"{scene} {dtype}: {int(tie.sum())} of {tie.size} tie rows skipped")
    if dtype == torch.float64:  # float32's tie rules are coarse
        assert tie.mean() < 0.5
    for got, ref in ((Jak, Ja), (Jbk, Jb)):
        np.testing.assert_allclose(got.numpy()[~tie], ref.numpy()[~tie],
                                   rtol=0, atol=jt)


def test_disc_wrappers_launch_or_raise():
    """K7 / K7v refuse a CPU tensor on the card's launcher, and a world
    with CONVEX geometry anywhere (no instantiation); K4 refuses an n_dof
    it is not built for (above its ceiling, 12: a 13-joint gantry)."""
    _, tw, TT, xn = _disc_scene("spherebot")
    x = _t(xn)
    for kind in ("disc_dist", "disc_dist_value"):
        with pytest.raises(ValueError, match="CUDA"):
            TC.disc_launch(kind, tw, x, TT, 2, 0, TT)
    links = "".join(f'<link name="l{i}"/>' for i in range(13))
    joints = "".join(
        f'<joint name="j{i}" type="prismatic"><parent link="'
        f'{"world" if i == 0 else f"l{i - 1}"}"/><child link="l{i}"/>'
        f'<axis xyz="1 0 0"/><limit lower="-1" upper="1"/></joint>'
        for i in range(13))
    m = parse_urdf(
        '<robot name="g"><link name="world"/>' + links.replace(
            '<link name="l12"/>', '<link name="l12"><collision><geometry>'
            '<sphere radius="0.1"/></geometry></collision></link>')
        + '<link name="ob"><collision><geometry><sphere radius="0.1"/>'
        '</geometry></collision></link><joint name="f" type="fixed">'
        '<parent link="world"/><child link="ob"/></joint>' + joints
        + "</robot>")
    w13 = TW.build_collision_world(m, build_chain(
        m, [f"j{i}" for i in range(13)]))
    x13 = torch.zeros((1, 2 * 13), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="n_dof 1 to 12"):
        TC.cast_host("cast_seg", w13, x13, 2, 13, 0, 1, 2)
