"""PyTorch port vs JAX reference: boxes on moving links, float64 on the CPU.

- ``geometry.d_box_box`` (the 15-axis SAT distance) and
  ``d_swept_box_box`` (the 21-axis zonotope SAT of a translating box)
  against the JAX package's: values and ``jacfwd`` Jacobians at 1e-12 on
  seeded random poses, and on the two tied cases where ``jnp.max``'s
  tangent is the mean over the tied axes (a box at (1.2, 1.2, 0) beside a
  box at the origin: [0.5, 0.5, 0]; box_cast's first gap, (-1.9, 0) -> (0,
  1.9): -0.0707107 with +-0.35355339 in each component);
- boxbot's world (a unit box on an x-y gantry against a unit box):
  ``pair_distances``, ``cast_pair_distances_seg`` and
  ``CastDistancePre.value_jac`` at n_sub 48 against JAX's;
- the host build of K4 / K4v / K5 (``cast_host``) and K7 / K7v
  (``disc_host``) at n_dof 2 on boxbot against the plain versions: the
  values bitwise on every row, the Jacobians within 1e-12 of the largest
  on the rows off the SAT max's near ties (``cast_ties`` /
  ``pair_ties``; the two compute each tangent column in another order);
- the refusal of a box on a chain with a revolute joint, which names the
  rotating two-pose box hull.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.collision import geometry as JG
from trajopt_tpu.collision.world import build_collision_world as j_world
from trajopt_tpu.models import boxbot as j_boxbot
from trajopt_tpu.terms import collision as JC
from trajopt_tpu_torch.collision import geometry as TG
from trajopt_tpu_torch.collision.world import build_collision_world as t_world
from trajopt_tpu_torch.kinematics.chain import build_chain
from trajopt_tpu_torch.kinematics.urdf import parse_urdf
from trajopt_tpu_torch.models import BOXBOT_URDF, boxbot
from trajopt_tpu_torch.terms import collision as TC

jax.config.update("jax_enable_x64", True)

TOL = 1e-12
N_SUB = 48


def _rot(rng):
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _t(*a):
    return [torch.as_tensor(np.asarray(v, np.float64)) for v in a]


def _poses(seed):
    rng = np.random.default_rng(seed)
    c1, c2 = rng.normal(size=3), rng.normal(size=3)
    R1, R2 = _rot(rng), _rot(rng)
    h1, h2 = rng.uniform(0.2, 1.0, 3), rng.uniform(0.2, 1.0, 3)
    if seed % 2:  # axis-aligned boxes: the repeated face normals tie
        R1 = R2 = np.eye(3)
    return c1, R1, h1, c2, R2, h2, c1 + rng.normal(size=3)


@pytest.mark.parametrize("seed", range(6))
def test_box_box_matches_reference(seed):
    c1, R1, h1, c2, R2, h2, c1b = _poses(seed)
    tR1, th1, tc2, tR2, th2 = _t(R1, h1, c2, R2, h2)
    jv = JG.d_box_box(c1, R1, h1, c2, R2, h2)
    tv = TG.d_box_box(*_t(c1), tR1, th1, tc2, tR2, th2)
    np.testing.assert_allclose(float(tv), float(jv), rtol=0, atol=TOL)
    jj = jax.jacfwd(lambda c: JG.d_box_box(c, R1, h1, c2, R2, h2))(c1)
    tj = torch.func.jacfwd(lambda c: TG.d_box_box(c, tR1, th1, tc2, tR2,
                                                  th2))(*_t(c1))
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), rtol=0, atol=TOL)
    jv = JG.d_swept_box_box(c1, c1b, R1, h1, c2, R2, h2)
    tv = TG.d_swept_box_box(*_t(c1, c1b), tR1, th1, tc2, tR2, th2)
    np.testing.assert_allclose(float(tv), float(jv), rtol=0, atol=TOL)
    jj = jax.jacfwd(lambda a, b: JG.d_swept_box_box(a, b, R1, h1, c2, R2, h2),
                    argnums=(0, 1))(c1, c1b)
    tj = torch.func.jacfwd(lambda a, b: TG.d_swept_box_box(
        a, b, tR1, th1, tc2, tR2, th2), argnums=(0, 1))(*_t(c1, c1b))
    for a, b in zip(tj, jj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)


def test_tied_axes_average_their_tangents():
    """``jnp.max``'s tangent over tied maxima is their mean; so is the
    port's, through ``torch.amax``."""
    eye, h, o = np.eye(3), np.full(3, 0.5), np.zeros(3)
    c = np.array([1.2, 1.2, 0.0])
    tj = torch.func.jacfwd(lambda x: TG.d_box_box(x, *_t(eye, h, o, eye, h)))(
        *_t(c))
    np.testing.assert_allclose(tj.numpy(), [0.5, 0.5, 0.0], rtol=0, atol=TOL)
    np.testing.assert_allclose(
        tj.numpy(), np.asarray(jax.jacfwd(
            lambda x: JG.d_box_box(x, eye, h, o, eye, h))(c)), rtol=0,
        atol=TOL)
    a, b = np.array([-1.9, 0.0, 0.0]), np.array([0.0, 1.9, 0.0])
    tv = TG.d_swept_box_box(*_t(a, b, eye, h, o, eye, h))
    ta, tb = torch.func.jacfwd(lambda x, y: TG.d_swept_box_box(
        x, y, *_t(eye, h, o, eye, h)), argnums=(0, 1))(*_t(a, b))
    np.testing.assert_allclose(float(tv), -0.0707106781186548, rtol=0,
                               atol=1e-12)
    s = 0.35355339059327373
    for got in (ta, tb):
        np.testing.assert_allclose(got.numpy(), [-s, s, 0.0], rtol=0,
                                   atol=TOL)
    ja, jb = jax.jacfwd(lambda x, y: JG.d_swept_box_box(x, y, eye, h, o, eye,
                                                        h), argnums=(0, 1))(
        a, b)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=TOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def worlds():
    jm, jch = j_boxbot()
    tm, tch = boxbot()
    return j_world(jm, jch), t_world(tm, tch)


def _traj(lanes, T, seed):
    """boxbot trajectories around box_cast's diagonal move, seeded."""
    rng = np.random.default_rng(seed)
    start = np.array([-1.9, 0.0]) + rng.uniform(-0.2, 0.2, (lanes, 2))
    goal = np.array([1.9, 3.8]) + rng.uniform(-0.2, 0.2, (lanes, 2))
    s = np.linspace(0.0, 1.0, T)[None, :, None]
    return start[:, None] + s * (goal - start)[:, None] \
        + rng.normal(0.0, 0.1, (lanes, T, 2))


def test_boxbot_world_matches_reference(worlds):
    """``pair_distances``, ``cast_pair_distances_seg`` and the swept route:
    a box-box pair on a translation-only chain sets the swept SAT
    distance, as the reference's ``_exact_sweep_overrides``."""
    jw, tw = worlds
    assert tw.pair_routes() == (("boxbox", None),) and tw.n_box_pairs == 1
    X = _traj(3, 4, 0)
    q = X.reshape(-1, 2)
    jd = np.stack([np.asarray(jw.pair_distances(jnp.asarray(v))) for v in q])
    np.testing.assert_allclose(tw.pair_distances(torch.as_tensor(q)).numpy(),
                               jd, rtol=0, atol=TOL)
    for qa, qb in zip(q[:-1], q[1:]):
        js = np.asarray(jw.cast_pair_distances_seg(jnp.asarray(qa),
                                                   jnp.asarray(qb), N_SUB))
        ts = tw.cast_pair_distances_seg(*_t(qa, qb), N_SUB).numpy()
        np.testing.assert_allclose(ts, js, rtol=0, atol=TOL)


def test_boxbot_cast_pipeline_matches_reference(worlds):
    """``CastDistancePre.value_jac`` at n_sub 48 (the plain path: jacfwd
    over the plain world) against the JAX package's, lane by lane."""
    jw, tw = worlds
    T = 4
    X = _traj(2, T, 1).reshape(2, -1)
    jp = JC.CastDistancePre(jw, T, n_sub=N_SUB)
    tp = TC.CastDistancePre(tw, T, n_sub=N_SUB)
    D, (Ja, Jb) = tp.value_jac(torch.as_tensor(X))
    for z in range(2):
        jD, (jJa, jJb) = jax.jit(jp.value_jac)(jnp.asarray(X[z]))
        np.testing.assert_allclose(D[z].numpy(), np.asarray(jD), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(Ja[z].numpy(), np.asarray(jJa), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(Jb[z].numpy(), np.asarray(jJb), rtol=0,
                                   atol=TOL)


def _host():
    if not (os.environ.get("CXX") or shutil.which("c++")):
        pytest.skip("no C++ compiler for the host build of the kernels")


@pytest.mark.parametrize("n_sub", [2, N_SUB])
def test_cast_kernels_host_build_boxbot(worlds, n_sub):
    """K4, K4v and K5 at n_dof 2 (the ceiling instantiation) built for the
    host, at team size 1 and in warps, against the plain versions."""
    _host()
    _, tw = worlds
    lanes, T = 3, 6
    X = torch.as_tensor(_traj(lanes, T, 2))
    x = X.reshape(lanes, -1)
    tp = TC.CastDistancePre(tw, T, n_sub=n_sub)
    D, (Ja, Jb) = tp.value_jac(x)
    args = (T, 2, 0, T - 1, n_sub)
    tie = tw.cast_ties(X[:, :-1], X[:, 1:], n_sub).reshape(lanes, T - 1, -1)
    assert int(tie.sum()) < tie.numel() // 4, int(tie.sum())
    scale = max(float(Ja.abs().max()), float(Jb.abs().max()))
    for team in (1, 32):
        Dk, Jak, Jbk = TC.cast_host("cast_seg", tw, x, *args, team=team)
        Dv = TC.cast_host("cast_seg_value", tw, x, *args, team=team)[0]
        np.testing.assert_array_equal(Dk.numpy(), D.numpy())
        np.testing.assert_array_equal(Dv.numpy(), D.numpy())
        for got, ref in ((Jak, Ja), (Jbk, Jb)):
            np.testing.assert_allclose(got.numpy()[~tie.numpy()],
                                       ref.numpy()[~tie.numpy()], rtol=0,
                                       atol=TOL * scale)
        Ds = TC.cast_host("cast_sweep", tw, x, T, 2, 0, T - 1, 16,
                          team=team)[0]
        np.testing.assert_array_equal(
            Ds.numpy(), TC.cast_sweep_distances(tw, X, 16).numpy())


def test_disc_kernels_host_build_boxbot(worlds):
    """K7 / K7v (``d_box_box`` at one slot) built for the host against the
    plain discrete pipeline."""
    _host()
    _, tw = worlds
    lanes, T = 3, 6
    X = torch.as_tensor(_traj(lanes, T, 3))
    x = X.reshape(lanes, -1)
    pre = TC.DiscreteDistancePre(tw, T)
    D, J = pre.value_jac(x)
    Dk, Jk = TC.disc_host("disc_dist", tw, x, T, 2, 0, T)
    Dv = TC.disc_host("disc_dist_value", tw, x, T, 2, 0, T)[0]
    np.testing.assert_array_equal(Dk.numpy(), D.numpy())
    np.testing.assert_array_equal(Dv.numpy(), D.numpy())
    tie = tw.pair_ties(X).numpy()
    np.testing.assert_allclose(Jk.numpy()[~tie], J.numpy()[~tie], rtol=0,
                               atol=TOL * float(J.abs().max()))


def test_rotating_box_is_refused():
    """A box on a chain with a revolute joint needs the rotating two-pose
    box hull, which the port refuses by name when the world is built."""
    m = parse_urdf(BOXBOT_URDF.replace(
        '<joint name="y" type="prismatic">', '<joint name="y" type="revolute">'
    ).replace('<axis xyz="0 1 0"/>', '<axis xyz="0 0 1"/>'))
    with pytest.raises(NotImplementedError,
                       match="rotating two-pose box hull"):
        t_world(m, build_chain(m, ["x", "y"]))
