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
compiler.
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
from trajopt_tpu.terms import collision as JC
from trajopt_tpu_torch.benchmarks import make_glass_upright
from trajopt_tpu_torch.collision import geometry as TG
from trajopt_tpu_torch.collision import world as TW
from trajopt_tpu_torch.convert import chain_from_numpy, world_from_numpy
from trajopt_tpu_torch.models import arm7 as t_arm7
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
