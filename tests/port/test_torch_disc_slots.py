"""PyTorch port vs JAX reference: K7 disc_dist / K7v disc_dist_value's
block of S (lane, step) slots (``csrc/disc_block.cuh``), float64 and
float32 on the CPU.

- the host build (``terms.collision.disc_host``: the block body with its
  threads played in turn) at S in {1, 3, the card's} and threads in {1,
  32, the card's}, on arm7's flagship world (T=6), the spherebot (T=3) and
  boxbot's box-box pair (T=4), against JAX's ``DiscreteDistancePre.value``
  / ``value_jac`` on the same seeded numpy inputs (float64,
  ``DISC_TOL`` / ``DISC_JTOL``);
- every layout, the tables staged or not, bitwise equal to every other,
  float32 and float64, with a lane count that S does not divide, and on
  steps [1, T) with an inv-dt column, which comes back zero;
- worlds of a few hundred sphere obstacles (arm7 with spheres on its
  table): the plan's slots cut to ``DISC_CTA_ITEMS`` items a CTA, the
  tables left in global memory past 48 KB, the slots lowered where the
  card's shared memory (227 KB) does not hold them, each layout the
  largest that fits (by the byte counts of ``csrc/disc_block.cuh``,
  recomputed here); the host build at those layouts against JAX (float64)
  and bitwise equal staged and unstaged; a world whose one (lane, step)
  record does not fit raises;
- the cached wrapper still raises: on a CPU tensor (the card's launcher),
  on CONVEX geometry, on a bad step range and a dtype it does not take,
  and again on the second call;
- chip_smoke phase 7f's documents (``json_docs("table_discrete")``: 7a's
  with discrete collision terms) at 4 lanes x T=6 through both
  ``load_problem``s: the same terms, and every term's fn and jac at x0
  within the JSON tests' tolerances.
"""

import itertools
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.benchmarks import make_glass_upright as j_make
from trajopt_tpu.collision import world as JW
from trajopt_tpu.kinematics.urdf import UrdfGeom as JGeom
from trajopt_tpu.models import arm7 as j_arm7
from trajopt_tpu.models import boxbot as j_boxbot
from trajopt_tpu.models import spherebot as j_spherebot
from trajopt_tpu.terms import collision as JC
from trajopt_tpu_torch import benchmarks as TB
from trajopt_tpu_torch.collision import world as TW
from trajopt_tpu_torch.kinematics.urdf import UrdfGeom as TGeom
from trajopt_tpu_torch.models import arm7 as t_arm7
from trajopt_tpu_torch.models import boxbot as t_boxbot
from trajopt_tpu_torch.models import spherebot as t_spherebot
from trajopt_tpu_torch.terms import collision as TC

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "scripts"))
import chip_smoke as CS  # noqa: E402
from jax_reference_counts import jax_json_problem  # noqa: E402

# the discrete pipeline's tolerances (tests/port/test_torch_collision.py)
DISC_TOL, DISC_JTOL = 1e-10, 1e-8
# one term's values and Jacobians (tests/port/test_torch_json_io.py)
VAL_TOL, JAC_TOL = 1e-10, 1e-8
# 5 lanes: a lane count that S = 3 (and the card's, 4-64) does not divide
LANES = 5
SCENES = {"arm7": 6, "spherebot": 3, "boxbot": 4}
KINDS = ("disc_dist", "disc_dist_value")


def _host_compiler():
    if not (os.environ.get("CXX") or shutil.which("c++")):
        pytest.skip("no C++ compiler for the host build of the kernels")


def _card(kind, dtype):
    """The card's (slots, threads) for an instantiation."""
    return TC.DISC_BLOCKS[kind, dtype]


def _layouts(kind, dtype):
    """(slots, threads, stage): S 1, 3 and the card's, threads 1, 32 and
    the card's, the tables staged (the card's choice on these worlds) and
    left in global memory."""
    S, nt = _card(kind, dtype)
    return sorted({(s, t, g) for s in (1, 3, S) for t in (1, 32, nt)
                   for g in (True, False)})


@pytest.fixture(scope="module")
def scenes():
    """{scene: (JAX world, port world, T, numpy x (LANES, T n_dof))}: arm7
    over the flagship's initial trajectories plus noise, the spherebot
    around its obstacle, boxbot across its box."""
    _, data, _, _ = j_make(LANES, n_steps=SCENES["arm7"], dtype=jnp.float64)
    rng = np.random.default_rng(17)
    out = {"arm7": (JW.build_collision_world(*j_arm7()),
                    TW.build_collision_world(*t_arm7()), SCENES["arm7"],
                    np.asarray(data.x0) + rng.normal(
                        0.0, 0.05, (LANES, SCENES["arm7"] * 7)))}
    for name, jm, tm, lim in (("spherebot", j_spherebot, t_spherebot, 1.3),
                              ("boxbot", j_boxbot, t_boxbot, 2.2)):
        T = SCENES[name]
        out[name] = (JW.build_collision_world(*jm()),
                     TW.build_collision_world(*tm()), T,
                     rng.uniform(-lim, lim, (LANES, T * 2)))
    return out


@pytest.fixture(scope="module")
def reference(scenes):
    """{scene: (D, J)} of JAX's DiscreteDistancePre (value_jac by one
    jitted vmap, value checked equal to its D)."""
    out = {}
    for name, (jw, _, T, x) in scenes.items():
        pre = JC.DiscreteDistancePre(jw, T)
        D, J = jax.jit(jax.vmap(pre.value_jac))(jnp.asarray(x))
        Dv = jax.jit(jax.vmap(pre.value))(jnp.asarray(x))
        np.testing.assert_array_equal(np.asarray(Dv), np.asarray(D))
        out[name] = (np.asarray(D), np.asarray(J))
    return out


@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("layout", ["S1", "S3", "card"])
def test_slots_match_reference(scenes, reference, scene, layout):
    """The host build at S 1, 3 and the card's, each at threads 1, 32 and
    the card's, against JAX's value / value_jac (float64)."""
    _host_compiler()
    _, tw, T, xn = scenes[scene]
    nd = tw.chain.n_dof
    x = torch.as_tensor(xn)
    Dj, Jj = reference[scene]
    for kind in KINDS:
        S = {"S1": 1, "S3": 3, "card": _card(kind, torch.float64)[0]}[layout]
        for nt in sorted({1, 32, _card(kind, torch.float64)[1]}):
            D, J = TC.disc_host(kind, tw, x, T, nd, 0, T, slots=S, threads=nt)
            assert D.shape == (LANES, T, tw.n_pairs)
            np.testing.assert_allclose(D.numpy(), Dj, rtol=0, atol=DISC_TOL)
            if kind == "disc_dist":
                assert J.shape == (LANES, T, tw.n_pairs, nd)
                np.testing.assert_allclose(J.numpy(), Jj, rtol=0,
                                           atol=DISC_JTOL)
    assert (Dj < 0.3).any(), "no row near contact"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_every_layout_bitwise_equal(scenes, scene, dtype):
    """Every (S, threads, staged or not) layout gives the bits of every
    other: all steps, and steps [1, T) of x with an inv-dt column (zero in
    J); K7v's D is K7's."""
    _host_compiler()
    _, tw, T, xn = scenes[scene]
    nd = tw.chain.n_dof
    x = torch.as_tensor(xn).to(dtype)
    xc = torch.cat([x.reshape(LANES, T, nd),
                    torch.full((LANES, T, 1), 7.5, dtype=dtype)], -1
                   ).reshape(LANES, -1).contiguous()
    ref = {}
    for kind in KINDS:
        for S, nt, g in _layouts(kind, dtype):
            got = (TC.disc_host(kind, tw, x, T, nd, 0, T, slots=S,
                                threads=nt, stage=g),
                   TC.disc_host(kind, tw, xc, T, nd + 1, 1, T - 1, slots=S,
                                threads=nt, stage=g))
            if kind not in ref:
                ref[kind] = got
            for (D, J), (Dr, Jr) in zip(got, ref[kind]):
                assert torch.equal(D, Dr), (kind, S, nt, g)
                assert J is None or torch.equal(J, Jr), (kind, S, nt, g)
    (D, J), (Dc, Jc) = ref["disc_dist"]
    assert torch.equal(ref["disc_dist_value"][0][0], D)
    assert torch.equal(Dc, D[:, 1:]) and torch.equal(Jc[..., :nd], J[:, 1:])
    assert (Jc[..., nd] == 0).all()


# the shared memory a block may use on the card, and the largest tables a
# block stages (csrc/disc_block.cuh)
DISC_MAX_SMEM, DISC_STAGE_MAX = 232448, 48 * 1024


def _sphere_worlds(n):
    """(JAX world, port world) of arm7 with n seeded spheres of radius 3 cm
    on its table, over and around the arm (7 pairs each)."""
    rng = np.random.default_rng(n)
    at = [(rng.uniform([-0.6, -0.6, 0.1], [0.6, 0.6, 1.0]))
          for _ in range(n)]
    return tuple(build(*model(), attachments=[
        ("table", geom("sphere", np.array([0.03]), p, np.zeros(3)))
        for p in at]) for build, model, geom in (
            (JW.build_collision_world, j_arm7, JGeom),
            (TW.build_collision_world, t_arm7, TGeom)))


def _block_bytes(world, dtype, S, stage):
    """A K7 block's shared-memory bytes, from the layout of
    csrc/disc_block.cuh: the tables (each 16-byte aligned) where staged,
    then S slot records."""
    ints, reals = world.kernel_tables(dtype, "cpu")
    esz = reals.element_size()
    L, nd, NG = world.chain.n_links, world.chain.n_dof, len(world.geoms)
    tables = ((ints.numel() * 4 + 15) // 16 * 16
              + (reals.numel() * esz + 15) // 16 * 16) if stage else 0
    return tables + S * (nd + 12 * L + 6 * nd + 15 * NG) * esz


@pytest.mark.parametrize("n", [0, 300, 450, 1900])
def test_large_world_layout(n):
    """The plan at n sphere obstacles, by default and asked for 16 slots:
    the card's slots, fewer where they would carry more than
    DISC_CTA_ITEMS items; the tables staged where they are at most 48 KB
    and fit beside the slots, else left in global memory and the slots
    lowered to the most that fit; where not even one record fits (float64
    at 1900), the wrapper raises.  Without spheres (arm7's own 28 pairs)
    every default is the card's, staged."""
    _host_compiler()
    _, tw = _sphere_worlds(n)
    lib = TC._native.host_library("cast_host")
    for dtype, kind, ask in itertools.product(
            (torch.float32, torch.float64), KINDS, (None, 16)):
        x = torch.zeros((1, 7), dtype=dtype)
        if _block_bytes(tw, dtype, 1, 0) > DISC_MAX_SMEM:
            with pytest.raises(ValueError, match="does not fit"):
                TC._disc_plan(lib, kind, tw, x, 1, 7, 0, 1, (ask, None, None))
            continue
        plan = TC._disc_plan(lib, kind, tw, x, 1, 7, 0, 1, (ask, None, None))
        items = tw.n_pairs * (7 if kind == "disc_dist" else 1)
        want = ask or min(_card(kind, dtype)[0],
                          max(1, TC.DISC_CTA_ITEMS // items))
        stage = int(_block_bytes(tw, dtype, 0, 1) <= DISC_STAGE_MAX
                    and _block_bytes(tw, dtype, want, 1) <= DISC_MAX_SMEM)
        assert plan.stage == stage, (kind, dtype, ask)
        assert 1 <= plan.slots <= want
        assert _block_bytes(tw, dtype, plan.slots, stage) <= DISC_MAX_SMEM
        assert plan.slots == want or _block_bytes(
            tw, dtype, plan.slots + 1, stage) > DISC_MAX_SMEM
        if n == 0 and ask is None:
            assert (plan.slots, plan.stage) == (_card(kind, dtype)[0], 1)
        if n == 450:  # the tables in global memory, 16 slots lowered
            assert not plan.stage and (ask is None or plan.slots < ask)


@pytest.mark.parametrize("n", [300, 450])
def test_large_world_matches_reference(n):
    """The host build at n sphere obstacles, at the card's plan, at
    unstaged layouts of 1 and 3 slots and, where it fits, one slot beside
    the staged tables: against JAX's value_jac (float64) and bitwise equal
    to each other (float32 and float64)."""
    _host_compiler()
    jw, tw = _sphere_worlds(n)
    T, lanes = 2, 3
    _, data, _, _ = j_make(lanes, n_steps=T, dtype=jnp.float64)
    xn = np.asarray(data.x0) + np.random.default_rng(n).normal(
        0.0, 0.05, (lanes, T * 7))
    D0, J0 = jax.jit(jax.vmap(JC.DiscreteDistancePre(jw, T).value_jac))(
        jnp.asarray(xn))
    for dtype in (torch.float64, torch.float32):
        x = torch.as_tensor(xn).to(dtype)
        for kind in KINDS:
            D, J = TC.disc_host(kind, tw, x, T, 7, 0, T)
            if dtype == torch.float64:
                np.testing.assert_allclose(D.numpy(), np.asarray(D0), rtol=0,
                                           atol=DISC_TOL)
                if J is not None:
                    np.testing.assert_allclose(J.numpy(), np.asarray(J0),
                                               rtol=0, atol=DISC_JTOL)
            staged = _block_bytes(tw, dtype, 1, 1) <= DISC_MAX_SMEM
            for S, g in [(1, False), (3, False)] + [(1, True)] * staged:
                Du, Ju = TC.disc_host(kind, tw, x, T, 7, 0, T, slots=S,
                                      threads=32, stage=g)
                assert torch.equal(Du, D), (kind, dtype, S, g)
                assert J is None or torch.equal(Ju, J), (kind, dtype, S, g)
    assert (np.asarray(D0) < 0.05).any(), "no obstacle near the arm"


def test_cached_wrapper_raises():
    """The wrapper caches what does not depend on x, and still raises, on
    every call: a CPU tensor on the card's launcher, CONVEX geometry (the
    pick-and-place transfer world), a bad step range, an integer dtype;
    a cached plan takes the next call's lanes."""
    _host_compiler()
    sw = TW.build_collision_world(*t_spherebot())
    x = torch.zeros((2, 3 * 2), dtype=torch.float64)
    cvx = TB._pnp_scene()[3]
    assert cvx.n_convex_verts
    xc = torch.zeros((1, 4 * 7), dtype=torch.float64)
    for _ in range(2):
        for kind in KINDS:
            with pytest.raises(ValueError, match="CUDA"):
                TC.disc_launch(kind, sw, x, 3, 2, 0, 3)
            with pytest.raises(NotImplementedError, match="CONVEX"):
                TC.disc_host(kind, cvx, xc, 4, 7, 0, 4)
            with pytest.raises(ValueError, match="step range"):
                TC.disc_host(kind, sw, x, 3, 2, 1, 3)
            with pytest.raises(TypeError, match="float32/float64"):
                TC.disc_host(kind, sw, x.to(torch.int64), 3, 2, 0, 3)
            with pytest.raises(ValueError, match="contiguous"):
                TC.disc_host(kind, sw, x[:, :4], 3, 2, 0, 3)
    D3 = TC.disc_host("disc_dist", sw, torch.zeros((3, 6),
                                                   dtype=torch.float64),
                      3, 2, 0, 3)[0]
    D2 = TC.disc_host("disc_dist", sw, x, 3, 2, 0, 3)[0]
    assert D3.shape == (3, 3, 1) and torch.equal(D3[:2], D2)


def _lane_aux(pre, X):
    """Per lane (value aux, value_jac aux) of a JAX discrete pipeline."""
    D, J = jax.jit(jax.vmap(pre.value_jac))(jnp.asarray(X))
    return [(D[i], (D[i], J[i])) for i in range(X.shape[0])]


def test_discrete_documents_match_reference():
    """Phase 7f's documents at 4 lanes x T=6 through both loaders: the
    same terms (names, kinds, rows), x0, both collision entries on one
    discrete pipeline, and every term's fn and jac at x0 (float64)."""
    docs = CS.json_docs("table_discrete", 4, 6)
    assert all(e["params"]["evaluator_type"] == 0 for d in docs
               for e in d["costs"] + d["constraints"]
               if e["type"] == "collision")
    js, jd, jp, _, _ = jax_json_problem(docs)
    ts, td, tp, _, _ = CS.port_json_problem(docs, torch.float64, "cpu")
    sig = lambda s: (s.n_x, s.n_cols, [  # noqa: E731
        (t.name, int(t.kind), t.n_rows) for t in s.cost_terms + s.cnt_terms])
    assert sig(ts) == sig(js)
    np.testing.assert_array_equal(td.x0.numpy(), np.asarray(jd.x0))
    coll = [t for t in ts.cost_terms + ts.cnt_terms if t.pre_fn is not None]
    assert len(coll) == 2 and coll[0].pre_fn is coll[1].pre_fn
    assert isinstance(coll[0].pre_fn, TC.DiscreteDistancePre)
    X = np.asarray(jd.x0)
    xt = torch.as_tensor(X)
    jaux = _lane_aux(next(t.pre_fn for t in js.cost_terms
                          if t.pre_fn is not None), X)
    for jt, tt, jps, tps in zip(
            js.cost_terms + js.cnt_terms, ts.cost_terms + ts.cnt_terms,
            jd.cost_params + jd.cnt_params, td.cost_params + td.cnt_params):
        lanes = range(X.shape[0])
        jpar = [{k: jnp.asarray(v[i]) for k, v in jps.items()}
                for i in lanes]
        aux = [(None, None) if jt.pre_fn is None else jaux[i] for i in lanes]
        e = np.stack([np.asarray(jt.err(jnp.asarray(X[i]), jpar[i],
                                        aux[i][0])) for i in lanes])
        np.testing.assert_allclose(tt.err(xt, tps).numpy(), e, rtol=0,
                                   atol=VAL_TOL)
        J = np.stack([np.asarray(jt.jac(jnp.asarray(X[i]), jpar[i],
                                        aux[i][1])) for i in lanes])
        np.testing.assert_allclose(tt.jac(xt, tps).numpy(), J, rtol=0,
                                   atol=JAC_TOL)
