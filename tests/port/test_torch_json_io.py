"""PyTorch port vs JAX reference: the JSON front end, float64 on the CPU.

- every document of ``tests/test_json_io.py`` through both
  ``load_problem``s (box_cast, boxbot's boxes on moving links, at n_sub
  48 as the JAX test loads it): term names, kinds, ``n_rows``,
  ``step_coupling``, ``viol_groups``, ``n_x`` and ``n_cols`` equal, data
  and parameters equal, ``SQPParams`` equal; solved by both ``solve``s:
  statuses equal, x within ``X_TOL``;
- chip_smoke phase 7's table documents (``chip_smoke.json_docs``) at T=6
  and a document with ``longest_valid_segment_length`` through both
  loaders, every term's rows and Jacobians against JAX's, one distance
  pipeline for the cost and constraint entries;
- the ``max_contacts >= n_pairs`` repair, the worst-contact selection
  (cast pair-level and discrete row-level, cost and constraint: fn, jac,
  jac_banded, with a constructed three-way tie that the lower indices must
  win), K10's host build against the plain selection bit for bit, and the
  weighted rows, on arm7's table world;
- ``prune_pairs`` at three cull distances, ``pair_value_array``,
  ``timed_joint_vel_term`` / ``total_time_term``, ``stationary_init``,
  a registered term type, ``max_time`` -> TIME_LIMIT;
- the CLI as a subprocess (``--device cpu --f64``; spherebot, and boxbot
  on box_cast's document at ``--n-sub 48``) against JAX's ``load_problem``
  + ``solve`` in process.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.collision import broadphase as JBP
from trajopt_tpu.collision.world import build_collision_world as j_world
from trajopt_tpu.models import arm7 as j_arm7
from trajopt_tpu.models import boxbot as j_boxbot
from trajopt_tpu.models import spherebot as j_spherebot
from trajopt_tpu.ops.qp import QPSettings as JQP
from trajopt_tpu.problem import json_io as JIO
from trajopt_tpu.problem.trajectory import stationary_init as j_stationary
from trajopt_tpu.solver.sqp import solve as j_solve
from trajopt_tpu.terms import collision as JCOL
from trajopt_tpu.terms import time as JTIME
from trajopt_tpu.terms.joint import joint_motion_term as j_joint_term
from trajopt_tpu_torch.collision import broadphase as TBP
from trajopt_tpu_torch.collision.world import build_collision_world as t_world
from trajopt_tpu_torch.models import arm7, boxbot, spherebot
from trajopt_tpu_torch.ops.qp import QPSettings as TQP
from trajopt_tpu_torch.problem import json_io as TIO
from trajopt_tpu_torch.problem.trajectory import stack_data, stationary_init
from trajopt_tpu_torch.solver.sqp import solve, solve_batch_compact
from trajopt_tpu_torch.solver.types import TIME_LIMIT
from trajopt_tpu_torch.terms import collision as TCOL
from trajopt_tpu_torch.terms import time as TTIME
from trajopt_tpu_torch.terms.joint import joint_motion_term as t_joint_term

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "scripts"))
import chip_smoke as CS  # noqa: E402
from jax_reference_counts import jax_json_problem  # noqa: E402

# values and Jacobians of one term (float64, the same arithmetic up to the
# order of sums); solved trajectories (both SQPs converge to 1e-6 QPs)
VAL_TOL, JAC_TOL, X_TOL = 1e-10, 1e-8, 1e-6
QP = dict(eps_abs=1e-6, eps_rel=1e-8, max_iter=4000)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU solves are many small ops, where torch's intra-op
    threads only add overhead, and the test run shares the machine's
    cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quat_of(R):
    w = np.sqrt(max(1 + R[0, 0] + R[1, 1] + R[2, 2], 0)) / 2
    return [w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
            (R[1, 0] - R[0, 1]) / (4 * w)]


# box_cast_test.json's document (tests/test_json_io.py:47-70), which the
# JAX test loads at n_sub 48
BOX_CAST = {
    "basic_info": {"n_steps": 3, "manip": "manipulator",
                   "fixed_timesteps": [0, 2]},
    "costs": [
        {"type": "joint_vel", "name": "jvel0",
         "params": {"coeffs": [1], "targets": [0, 0]}},
        {"type": "collision",
         "params": {"coeffs": 10, "dist_pen": 0.02, "evaluator_type": 4,
                    "longest_valid_segment_length": 0.05}}],
    "constraints": [
        {"type": "joint_pos", "name": "joint",
         "params": {"coeffs": [1, 1], "targets": [1.9, 3.8],
                    "first_step": 2, "last_step": 2}}],
    "init_info": {"type": "given_traj",
                  "data": [[-1.9, 0], [0, 1.9], [1.9, 3.8]]},
}
# load_problem's keywords per document (both packages)
LOAD_KW = {"box_cast": {"n_sub": 48}}


def _docs():
    """The documents of tests/test_json_io.py, by name: (document, model
    name, with a collision world, QP settings)."""
    _, chain = arm7()
    tool = chain.link_index("tool")
    R, p = chain.fk(torch.tensor([0.4, 0.6, -0.2, 0.9, 0.3, -0.5, 0.2],
                                 dtype=torch.float64))
    return {
        **{k: (d, "spherebot", w, q) for k, (d, w, q) in
           CS.spherebot_docs().items() if k != "cli"},
        "numerical_ik": ({
            "basic_info": {"n_steps": 1, "manip": "arm"},
            "constraints": [{"type": "cart_pose", "params": {
                "pos_coeffs": [1, 1, 1], "rot_coeffs": [1, 1, 1],
                "source_frame": "tool", "target_frame": "base",
                "target_frame_offset_xyz": p[tool].tolist(),
                "target_frame_offset_wxyz": _quat_of(R[tool].numpy())}}],
            "costs": [{"type": "joint_pos",
                       "params": {"coeffs": 1e-4, "targets": 0.0}}],
            "init_info": {"type": "given_traj", "data": [[0.1] * 7]},
        }, "arm7", False, True),
        "dynamic_cart_pose": ({
            "basic_info": {"n_steps": 1, "manip": "arm"},
            "constraints": [{"type": "dynamic_cart_pose", "params": {
                "source_frame": "tool", "target_frame": "l4",
                "target_frame_offset_xyz": [0.1478, 0.0, 0.5335],
                "rot_coeffs": [0, 0, 0]}}],
            "costs": [{"type": "joint_pos",
                       "params": {"coeffs": 1e-4, "targets": 0.0}}],
            "init_info": {"type": "given_traj",
                          "data": [[0.1, 0.4, 0.1, -0.6, 0.1, 0.3, 0.1]]},
        }, "arm7", False, True),
        "box_cast": (BOX_CAST, "boxbot", True, True),
    }


_MODELS = {"spherebot": (j_spherebot, spherebot), "arm7": (j_arm7, arm7),
           "boxbot": (j_boxbot, boxbot)}


def _scene(name, with_world):
    jm, tm = _MODELS[name]
    (jmod, jch), (tmod, tch) = jm(), tm()
    if not with_world:
        return jch, None, tch, None
    return jch, j_world(jmod, jch), tch, t_world(tmod, tch)


def _spec_sig(spec):
    return (spec.n_x, spec.n_steps, spec.n_cols,
            [(t.name, int(t.kind), t.n_rows, t.step_coupling, t.viol_groups)
             for t in spec.cost_terms + spec.cnt_terms])


def _assert_same_problem(js, jd, jp, ts, td, tp):
    assert _spec_sig(ts) == _spec_sig(js)
    for k in ("x0", "lb", "ub"):
        np.testing.assert_array_equal(getattr(td, k).numpy(),
                                      np.asarray(getattr(jd, k)))
    for jps, tps in ((jd.cost_params, td.cost_params),
                     (jd.cnt_params, td.cnt_params)):
        assert len(jps) == len(tps)
        for a, b in zip(jps, tps):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))
    for f in dataclasses.fields(tp):
        if f.name == "qp":
            for g in dataclasses.fields(tp.qp):
                assert getattr(tp.qp, g.name) == getattr(jp.qp, g.name), g
        else:
            assert getattr(tp, f.name) == getattr(jp, f.name), f.name


@pytest.mark.parametrize("name", list(_docs()))
def test_documents_match_reference(name):
    doc, model, with_world, qp = _docs()[name]
    jch, jw, tch, tw = _scene(model, with_world)
    kw = LOAD_KW.get(name, {})
    js, jd, jp = JIO.load_problem(doc, jch, jw, qp=JQP(**QP) if qp else None,
                                  **kw)
    ts, td, tp = TIO.load_problem(doc, tch, tw, qp=TQP(**QP) if qp else None,
                                  device="cpu", **kw)
    _assert_same_problem(js, jd, jp, ts, td, tp)
    jr = j_solve(js, jd, jp)
    tr = solve(ts, td, tp, device="cpu")
    assert int(tr.status) == int(jr.status)
    assert tr.x.shape == (ts.n_x,)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0,
                               atol=X_TOL)


def test_rejections_match_reference():
    """Unknown fields, a bad term type, a bad bool, timed acc."""
    _, jch = j_spherebot()
    _, tch = spherebot()
    bogus = {"basic_info": {"n_steps": 2, "manip": "m"},
             "costs": [{"type": "joint_vel",
                        "params": {"coeffs": 1, "bogus": 2}}]}
    badtype = {"basic_info": {"n_steps": 2, "manip": "m"},
               "costs": [{"type": "nope", "params": {}}]}
    badbool = {"basic_info": {"n_steps": 2, "manip": "m"},
               "costs": [{"type": "joint_vel", "use_time": "maybe"}]}
    acc = {"basic_info": {"n_steps": 4, "manip": "m"},
           "costs": [{"type": "joint_acc", "use_time": True}]}
    for doc, exc, msg in ((bogus, ValueError, "bogus"),
                          (badtype, ValueError, "unsupported term type"),
                          (badbool, ValueError, "bad bool"),
                          (acc, NotImplementedError, "use_time")):
        with pytest.raises(exc, match=msg):
            JIO.load_problem(doc, jch)
        with pytest.raises(exc, match=msg):
            TIO.load_problem(doc, tch, device="cpu")


@pytest.mark.parametrize("kind", ["table", "table_time", "lvs"])
def test_table_documents_match_reference(kind):
    """chip_smoke phase 7's documents at T=4 (and 7a's with
    longest_valid_segment_length 0.08, whose n_sub the loader draws from
    each lane's init): both loaders' problems, and every term's rows,
    Jacobians and banded windows at x0 plus seeded noise."""
    docs = CS.json_docs("table" if kind == "lvs" else kind, 2, T_COLL)
    if kind == "lvs":
        for d in docs:
            for e in d["costs"] + d["constraints"]:
                if e["type"] == "collision":
                    e["params"]["longest_valid_segment_length"] = 0.08
        # the two inits draw different n_sub: the batch builder refuses
        with pytest.raises(ValueError, match="another problem class"):
            CS.port_json_problem(docs, torch.float64, "cpu")
        docs = [docs[0], json.loads(json.dumps(docs[0]))]
    js, jd, jp, _, _ = jax_json_problem(docs)
    ts, td, tp, _, _ = CS.port_json_problem(docs, torch.float64, "cpu")
    _assert_same_problem(js, jd, jp, ts, td, tp)
    coll = [t for t in ts.cost_terms + ts.cnt_terms if t.pre_fn is not None]
    assert len(coll) == 2 and coll[0].pre_fn is coll[1].pre_fn
    if kind == "lvs":
        assert coll[0].pre_fn.n_seg + 1 > 8
    rng = np.random.default_rng(3)
    x0 = np.asarray(jd.x0).reshape(2, T_COLL, ts.n_cols)
    X = x0 + rng.normal(0.0, 0.05, x0.shape)
    X[..., 7:] = x0[..., 7:]  # the 1/dt column of table_time
    X = X.reshape(2, -1)
    # the JAX package's two entries have two identical pipelines: one aux
    jaux = _jax_aux(next(t.pre_fn for t in js.cost_terms
                         if t.pre_fn is not None), X)
    for jt, tt, jps, tps in zip(
            js.cost_terms + js.cnt_terms, ts.cost_terms + ts.cnt_terms,
            jd.cost_params + jd.cnt_params, td.cost_params + td.cnt_params):
        _compare_term(jt, tt, X, [{k: jnp.asarray(v[i]) for k, v in
                                   jps.items()} for i in range(2)], tps,
                      jaux if jt.pre_fn is not None else None)


def _compare_term(jt, tt, X, jparams, tparams, jaux=None, taux=None):
    """A JAX term lane by lane against the port's term on every lane at
    once; ``jaux``: per lane (value aux, value_jac aux) for the JAX term's
    functions, ``taux`` the port's (value aux, value_jac aux); without
    ``taux`` the port's term computes its distances itself."""
    xt = torch.as_tensor(X)
    B = X.shape[0]
    jv = [None] * B if jaux is None else [a[0] for a in jaux]
    jj = [None] * B if jaux is None else [a[1] for a in jaux]
    tv, tj = (None, None) if taux is None else taux

    def lanes(fn, aux):
        return [fn(jnp.asarray(X[i]), jparams[i], aux[i]) for i in range(B)]

    e = np.stack([np.asarray(v) for v in lanes(jt.err, jv)])
    np.testing.assert_allclose(tt.err(xt, tparams, tv).numpy(), e, rtol=0,
                               atol=VAL_TOL)
    J = np.stack([np.asarray(v) for v in lanes(jt.jac, jj)])
    np.testing.assert_allclose(tt.jac(xt, tparams, tj).numpy(), J, rtol=0,
                               atol=JAC_TOL)
    if jt.jac_banded_fn is not None:
        out = lanes(jt.jac_banded, jj)
        Bt, Gt = tt.jac_banded(xt, tparams, tj)
        np.testing.assert_allclose(
            Bt.numpy(), np.stack([np.asarray(o[0]) for o in out]), rtol=0,
            atol=JAC_TOL)
        np.testing.assert_array_equal(Gt.numpy(), np.asarray(out[0][1]))
    else:
        assert tt.jac_banded_fn is None
    if jt.is_cost:
        np.testing.assert_allclose(
            tt.weights(tparams, xt).numpy(),
            np.stack([np.broadcast_to(np.asarray(jt.weights(p)),
                                      (jt.n_rows,)) for p in jparams]),
            rtol=0, atol=VAL_TOL)
        v = [float(a) for a in lanes(jt.value, jv)]
        np.testing.assert_allclose(tt.value(xt, tparams, tv).numpy(), v,
                                   rtol=0, atol=VAL_TOL)
    else:
        v = np.stack([np.asarray(a) for a in lanes(jt.violations, jv)])
        np.testing.assert_allclose(tt.violations(xt, tparams, tv).numpy(), v,
                                   rtol=0, atol=VAL_TOL)


# --------------------------------------------------------------------------
# the collision terms on arm7's table world: max_contacts, the selection,
# the weighted rows
# --------------------------------------------------------------------------

T_COLL = 4


def _jax_aux(pre, X):
    """Per lane (value aux, value_jac aux) of a JAX distance pipeline, by
    one jitted vmap (its eager jacfwd takes a minute a call)."""
    import jax

    D, J = jax.jit(jax.vmap(pre.value_jac))(jnp.asarray(X))
    lane = (lambda i: tuple(j[i] for j in J)) if isinstance(J, tuple) \
        else (lambda i: J[i])
    return [(D[i], (D[i], lane(i))) for i in range(X.shape[0])]


@pytest.fixture(scope="module")
def table():
    """arm7's table world (28 pairs), 2 lanes at T=4 from phase 7's
    starts plus seeded noise, per-pair margins and coeffs, and the JAX
    pipelines' aux (cast at n_sub 3, discrete): the JAX terms take their
    distances from it, the port's terms compute their own."""
    jm, jch = j_arm7()
    tm, tch = arm7()
    jw, tw = j_world(jm, jch), t_world(tm, tch)
    assert jw.n_pairs == tw.n_pairs == 28
    rng = np.random.default_rng(7)
    docs = CS.json_docs("table", 2, T_COLL)
    X = np.stack([np.asarray(j_stationary(np.asarray(
        d["init_info"]["data"]), T_COLL)).reshape(-1) for d in docs])
    X = X + rng.normal(0.0, 0.3, X.shape)
    # per-pair margins and coeffs (B, P): the selection folds coeffs in
    m = rng.uniform(0.02, 0.3, (2, 28))
    c = rng.uniform(1.0, 20.0, (2, 28))
    aux = {"cast": _jax_aux(JCOL.CastDistancePre(jw, T_COLL, n_sub=3), X),
           "discrete": _jax_aux(JCOL.DiscreteDistancePre(jw, T_COLL), X)}
    return jw, tw, X, m, c, aux


def _coll_terms(jw, tw, form, cnt, **kw):
    if form == "cast":
        return (JCOL.cast_collision_term("c", jw, T_COLL, n_sub=3,
                                         is_constraint=cnt, **kw),
                TCOL.cast_collision_term("c", tw, T_COLL, n_sub=3,
                                         is_constraint=cnt, **kw))
    return (JCOL.discrete_collision_term("c", jw, T_COLL, is_constraint=cnt,
                                         **kw),
            TCOL.discrete_collision_term("c", tw, T_COLL, is_constraint=cnt,
                                         **kw))


def _coll_params(m, c, uniform=False):
    if uniform:
        c = np.broadcast_to(c[:, :1], c.shape).copy()
    return ([{"margins": jnp.asarray(m[i]), "coeffs": jnp.asarray(c[i])}
             for i in range(2)],
            {"margins": torch.as_tensor(m), "coeffs": torch.as_tensor(c)})


FORMS = [("cast", False), ("cast", True), ("discrete", False),
         ("discrete", True)]
FORM_IDS = ["cast-cost", "cast-cnt", "disc-cost", "disc-cnt"]


@pytest.mark.parametrize("form,cnt", FORMS, ids=FORM_IDS)
def test_max_contacts_at_least_pairs(table, form, cnt):
    """max_contacts >= n_pairs selects nothing, as in the JAX package (the
    parent raised for any max_contacts)."""
    jw, tw, X, m, c, aux = table
    jt, tt = _coll_terms(jw, tw, form, cnt, max_contacts=32)
    _, t_none = _coll_terms(jw, tw, form, cnt)
    assert (tt.n_rows, tt.viol_groups) == (jt.n_rows, jt.viol_groups) \
        == (t_none.n_rows, t_none.viol_groups)
    jp, tp = _coll_params(m, c)
    _compare_term(jt, tt, X, jp, tp, aux[form])


@pytest.mark.parametrize("form,cnt", FORMS, ids=FORM_IDS)
def test_selection_matches_reference(table, form, cnt):
    """max_contacts 3: the selected rows (fn, jac, jac_banded, values or
    violations) as JAX's, and on distances with a constructed three-way
    tie among the worst pairs (K = 2: the two lower indices win)."""
    jw, tw, X, m, c, aux = table
    jt, tt = _coll_terms(jw, tw, form, cnt, max_contacts=3, buffer=0.4)
    n_groups = T_COLL - 1 if form == "cast" else T_COLL
    per = (2 if form == "cast" else 1) * 3
    assert (tt.n_rows, tt.viol_groups) == (jt.n_rows, jt.viol_groups) \
        == (n_groups * per, n_groups if cnt else 1)
    jp, tp = _coll_params(m, c)
    _compare_term(jt, tt, X, jp, tp, aux[form])

    # the tie: pairs 4, 11 and 19 (one margin) share the largest error of
    # every group and segment
    jt2, tt2 = _coll_terms(jw, tw, form, cnt, max_contacts=2, buffer=0.4)
    m2 = m.copy()
    m2[:, [11, 19]] = m2[:, [4]]
    jp, tp = _coll_params(m2, c)
    D, J = tt2.pre_fn.value_jac(torch.as_tensor(X), kernels=False)
    D = D.clone() if form == "cast" else D[:, :, None, :].clone()
    mt = torch.as_tensor(m2)[:, None, None, :]
    E = torch.clamp(torch.amax(mt - D, dim=-1) + 0.2, min=0.05)
    for k in (19, 4, 11):
        D[..., k] = mt[..., k] - E
    errs = mt - D
    if form == "discrete":
        D = D[:, :, 0]
    jaux = [(jnp.asarray(D[i].numpy()),
             (jnp.asarray(D[i].numpy()),
              tuple(jnp.asarray(j[i].numpy()) for j in J) if form == "cast"
              else jnp.asarray(J[i].numpy()))) for i in range(2)]
    _compare_term(jt2, tt2, X, jp, tp, jaux, (D, (D, J)))
    # the kept pairs are 4 and 11: their error rows, coeff folded in
    err = tt2.err(torch.as_tensor(X), tp, D).reshape(2, n_groups, -1, 2)
    for k, pair in enumerate((4, 11)):
        want = torch.as_tensor(c[:, pair])[:, None, None] * errs[..., pair]
        assert torch.equal(err[..., k], want)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("form", ["cast", "discrete"])
def test_select_host_build_bitwise(table, form, dt):
    """K10 / K10v's host build (teams of 1 and 32) against the plain
    selection, bit for bit: the cast form on K4's plain distances and
    Jacobians (n_sub 4), the discrete form on K7's, 1/dt column padded
    (nc 8), with ties injected, margins and coeffs per pair, K = 3 and 5."""
    _, tw, X, m, c, _ = table
    x8 = torch.as_tensor(np.concatenate(
        [X.reshape(2, T_COLL, 7), np.full((2, T_COLL, 1), 10.0)], -1)
        .reshape(2, -1)).to(dt)
    if form == "cast":
        pre = TCOL.CastDistancePre(tw, T_COLL, n_sub=4, n_cols=8)
        D, (Ja, Jb) = pre.value_jac(x8, kernels=False)
        right = -1
    else:
        pre = TCOL.DiscreteDistancePre(tw, T_COLL, n_cols=8)
        D, Ja = pre.value_jac(x8, kernels=False)
        D, Jb, right = D[:, :, None, :], None, T_COLL - 1
    D = D.contiguous()
    D[0, 1, :, 6] = D[0, 1, :, 2]  # exact ties between pairs
    D[1, 0, :, 20] = D[1, 0, :, 9]
    mm, cc = torch.as_tensor(m).to(dt), torch.as_tensor(c).to(dt)
    mm[:, 6], mm[:, 20] = mm[:, 2], mm[:, 9]
    for K in (3, 5):
        ref = TCOL.contact_select_plain(D, mm, cc, 0.4, K, Ja, Jb, right)
        refv = TCOL.contact_select_plain(D, mm, cc, 0.4, K)
        assert torch.equal(ref[0], refv)
        for team in (1, 32):
            got = TCOL.contact_select_host(D, mm, cc, 0.4, K, Ja, Jb, right,
                                           team=team)
            gotv = TCOL.contact_select_host(D, mm, cc, 0.4, K, team=team)
            assert torch.equal(got[0], ref[0]) and torch.equal(gotv, refv)
            assert torch.equal(got[1], ref[1])
            assert torch.equal(torch.signbit(got[1]), torch.signbit(ref[1]))


def test_select_wrapper_launches_or_raises():
    """On the CPU the wrapper takes the plain version; the host build
    refuses what the kernel refuses."""
    D = torch.rand(1, 2, 1, 5, dtype=torch.float64)
    m = torch.zeros(1, 5, dtype=torch.float64)
    assert torch.equal(TCOL.contact_select(D, m, m + 1, 0.5, 2),
                       TCOL.contact_select_plain(D, m, m + 1, 0.5, 2))
    with pytest.raises(ValueError, match="outside"):
        TCOL.contact_select_host(D, m, m + 1, 0.5, 6)
    with pytest.raises(ValueError, match="contiguous"):
        TCOL.contact_select_host(D, m.float(), m + 1, 0.5, 2)


@pytest.mark.parametrize("form,cnt", FORMS, ids=FORM_IDS)
def test_weighted_rows_match_reference(table, form, cnt):
    """use_weighted_sum: one row per group, the error-weighted gradient."""
    jw, tw, X, m, c, aux = table
    jt, tt = _coll_terms(jw, tw, form, cnt, weighted=True)
    jp, tp = _coll_params(m, c, uniform=True)
    _compare_term(jt, tt, X, jp, tp, aux[form])


# --------------------------------------------------------------------------
# broad phase, per-pair overrides, time terms, init, the registry, max_time
# --------------------------------------------------------------------------


def test_prune_pairs_matches_reference():
    jm, jch = j_arm7()
    tm, tch = arm7()
    jw, tw = j_world(jm, jch), t_world(tm, tch)
    np.testing.assert_allclose(TBP.pair_distance_bounds(tw),
                               JBP.pair_distance_bounds(jw), rtol=0,
                               atol=1e-12)
    sizes = []
    for cull in (-1.6, -1.0, 0.05):  # the bounds lie in [-4.1, -0.3]
        jp, tp = JBP.prune_pairs(jw, cull), TBP.prune_pairs(tw, cull)
        assert tp.pair_names() == jp.pair_names()
        assert tp.pair_link_names() == jp.pair_link_names()
        ints, reals = tp.kernel_tables(torch.float64, "cpu")
        assert ints.numel() > 0 and reals.numel() > 0
        sizes.append(tp.n_pairs)
    assert sizes[0] < sizes[-1] <= tw.n_pairs


def test_pair_value_array():
    jm, jch = j_arm7()
    tm, tch = arm7()
    jw, tw = j_world(jm, jch), t_world(tm, tch)
    a, b = tw.pair_link_names()[3]
    c, d = tw.pair_link_names()[17]
    over = {f"{b},{a}": 0.5, (c, d): 0.25}
    np.testing.assert_array_equal(tw.pair_value_array(0.1, over),
                                  jw.pair_value_array(0.1, over))
    got = tw.pair_value_array(0.1, over)
    assert got[3] == 0.5 and got[17] == 0.25 and (got == 0.1).sum() >= 26
    for w in (jw, tw):
        with pytest.raises(ValueError, match="unknown pairs"):
            w.pair_value_array(0.1, {"base,nolink": 1.0})


TIME_CASES = {
    "vel-cost": ("vel", dict()), "vel-cnt": ("vel", dict(is_constraint=True)),
    "vel-tol-cost": ("vel", dict(toleranced=True)),
    "vel-tol-cnt": ("vel", dict(toleranced=True, is_constraint=True)),
    "total-cost": ("total", dict()),
    "total-ineq": ("total", dict(is_constraint=True)),
    "total-eq": ("total", dict(is_constraint=True, as_equality=True)),
}


@pytest.mark.parametrize("case", list(TIME_CASES))
def test_time_terms_match_reference(case):
    what, kw = TIME_CASES[case]
    T, D, B = 5, 3, 3
    rng = np.random.default_rng(11)
    X = rng.uniform(-1.0, 1.0, (B, T, D + 1))
    X[..., D] = rng.uniform(2.0, 10.0, (B, T))
    X = X.reshape(B, -1)
    if what == "vel":
        jt = JTIME.timed_joint_vel_term("v", T, D, first_step=1, **kw)
        tt = TTIME.timed_joint_vel_term("v", T, D, first_step=1, **kw)
        plist = [{"targets": rng.normal(size=D),
                  "coeffs": rng.uniform(0.5, 2.0, D),
                  "upper_tols": rng.uniform(0.1, 0.5, D),
                  "lower_tols": -rng.uniform(0.1, 0.5, D)}
                 for _ in range(B)]
        if not kw.get("toleranced"):
            plist = [{k: p[k] for k in ("targets", "coeffs")} for p in plist]
        assert tt.step_coupling == jt.step_coupling == 1
    else:
        jt = JTIME.total_time_term("t", T, D, **kw)
        tt = TTIME.total_time_term("t", T, D, **kw)
        plist = [{"limit": np.asarray(rng.uniform(0.5, 1.5)),
                  "coeff": np.asarray(rng.uniform(0.5, 3.0))}
                 for _ in range(B)]
        assert tt.step_coupling is jt.step_coupling is None
    assert (tt.kind, tt.n_rows) == (jt.kind, jt.n_rows)
    tp = {k: torch.as_tensor(np.stack([p[k] for p in plist]))
          for k in plist[0]}
    _compare_term(jt, tt, X, [{k: jnp.asarray(v) for k, v in p.items()}
                              for p in plist], tp)


def test_stationary_init():
    q0 = np.array([0.3, -0.2, 1.1])
    got = stationary_init(q0, 4)
    np.testing.assert_array_equal(got, np.asarray(j_stationary(q0, 4)))
    assert got.shape == (4, 3)


def test_user_registered_term_type():
    """A registered type drives the solve in both loaders; a cost kind
    under "constraints" fails the term-type check."""
    def maker(mod, joint_term):
        def make(entry, ctx):
            p = entry.get("params", {})
            term = joint_term(ctx["name"], 0, ctx["n_steps"], ctx["n_dof"],
                              first_step=ctx["n_steps"] - 1,
                              is_constraint=ctx["is_constraint"])
            return term, {"targets": mod(np.asarray(p["target"], np.float64)),
                          "coeffs": mod(np.ones(ctx["n_dof"]))}
        return make

    doc = {"basic_info": {"n_steps": 4, "manip": "manipulator"},
           "costs": [{"type": "joint_vel", "name": "jv",
                      "params": {"coeffs": [1], "targets": [0, 0]}}],
           "constraints": [{"type": "my_goal", "name": "g",
                            "params": {"target": [0.4, -0.3]}}],
           "init_info": {"type": "stationary", "data": [1.0, 1.0]}}
    JIO.register_term_type("my_goal", maker(jnp.asarray, j_joint_term))
    TIO.register_term_type("my_goal", maker(np.asarray, t_joint_term))
    try:
        _, jch = j_spherebot()
        _, tch = spherebot()
        js, jd, jp = JIO.load_problem(doc, jch, qp=JQP(**QP))
        ts, td, tp = TIO.load_problem(doc, tch, qp=TQP(**QP), device="cpu")
        _assert_same_problem(js, jd, jp, ts, td, tp)
        jr, tr = j_solve(js, jd, jp), solve(ts, td, tp, device="cpu")
        assert int(tr.status) == int(jr.status) == 1
        np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0,
                                   atol=X_TOL)
        bad = dict(doc, costs=[], constraints=[{"type": "my_goal_cost",
                                                "params": {"target": [0, 0]}}])

        def cost_maker(entry, ctx):
            return maker(np.asarray, t_joint_term)(
                entry, dict(ctx, is_constraint=False))
        TIO.register_term_type("my_goal_cost", cost_maker)
        with pytest.raises(ValueError, match="term-type check"):
            TIO.load_problem(bad, tch, device="cpu")
        with pytest.raises(TypeError, match="callable"):
            TIO.register_term_type("x", 3)
    finally:
        JIO.unregister_term_type("my_goal")
        TIO.unregister_term_type("my_goal")
        TIO.unregister_term_type("my_goal_cost")


def test_max_time_gives_time_limit():
    """opt_info max_time: TIME_LIMIT after the second QP solve in both
    ``solve``s (the clock starts at the first); ``solve_batch_compact``
    stamps it on the lanes still running at a phase boundary."""
    doc = _docs()["timed_vel_total_time"][0]
    # from dt 0.5 the start moves at 2 rad/s: the solve needs many QPs
    doc = dict(doc, opt_info={"max_time": 1e-9},
               init_info=dict(doc["init_info"], dt=0.5))
    _, jch = j_spherebot()
    _, tch = spherebot()
    js, jd, jp = JIO.load_problem(doc, jch, qp=JQP(**QP))
    ts, td, tp = TIO.load_problem(doc, tch, qp=TQP(**QP), device="cpu")
    assert tp.max_time == jp.max_time == 1e-9
    jr, tr = j_solve(js, jd, jp), solve(ts, td, tp, device="cpu")
    assert int(jr.status) == int(tr.status) == TIME_LIMIT
    assert int(jr.n_qp_solves) == int(tr.n_qp_solves) == 2
    data = stack_data([td, td])
    rc = solve_batch_compact(ts, data, tp, phase_qp_solves=1, device="cpu")
    assert rc.status.tolist() == [TIME_LIMIT] * 2
    assert rc.n_qp_solves.tolist() == [1, 1]


def _cli(args, env=None):
    return subprocess.run([sys.executable, "-m", "trajopt_tpu_torch", *args],
                          capture_output=True, text=True, timeout=300,
                          cwd=_ROOT, env=env)


def test_cli_solve_matches_reference(tmp_path):
    doc = CS.CLI_DOC  # tests/test_cli.py's document
    prob, out = tmp_path / "p.json", tmp_path / "r.json"
    prob.write_text(json.dumps(doc))
    r = _cli(["solve", str(prob), "--model", "spherebot", "--device", "cpu",
              "--f64", "--out", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "OPT_CONVERGED" in r.stdout
    got = json.loads(out.read_text())
    _, jch = j_spherebot()
    js, jd, jp = JIO.load_problem(doc, jch, j_world(*j_spherebot()))
    jr = j_solve(js, jd, jp)
    assert got["status"] == "OPT_CONVERGED" and int(jr.status) == 1
    np.testing.assert_allclose(np.asarray(got["trajectory"]).reshape(-1),
                               np.asarray(jr.x), rtol=0, atol=X_TOL)
    assert got["n_qp_solves"] == int(jr.n_qp_solves)

    prob.write_text(json.dumps({"basic_info": {"n_steps": 2, "manip": "m"},
                                "costs": [{"type": "nope", "params": {}}]}))
    r = _cli(["solve", str(prob), "--model", "spherebot", "--device", "cpu"])
    assert r.returncode != 0
    assert "unsupported term type" in r.stderr + r.stdout
    if not torch.cuda.is_available():  # no card: the default device raises
        r = _cli(["solve", str(prob), "--model", "spherebot"])
        assert r.returncode != 0 and "CUDA is not available" in r.stderr
        _, tch = spherebot()
        with pytest.raises(RuntimeError, match="CUDA"):
            TIO.load_problem(doc, tch)
        ts, td, tp = TIO.load_problem(doc, tch, device="cpu")
        with pytest.raises(RuntimeError, match="CUDA"):
            solve(ts, td, tp)


def test_cli_solve_boxbot_matches_reference(tmp_path):
    """``solve --model boxbot --n-sub 48`` on box_cast's document (CPU,
    float64) against JAX's ``load_problem(n_sub=48)`` + ``solve``."""
    prob, out = tmp_path / "p.json", tmp_path / "r.json"
    prob.write_text(json.dumps(BOX_CAST))
    r = _cli(["solve", str(prob), "--model", "boxbot", "--n-sub", "48",
              "--device", "cpu", "--f64", "--out", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "OPT_CONVERGED" in r.stdout
    got = json.loads(out.read_text())
    jm, jch = j_boxbot()
    js, jd, jp = JIO.load_problem(BOX_CAST, jch, j_world(jm, jch), n_sub=48)
    jr = j_solve(js, jd, jp)
    assert got["status"] == "OPT_CONVERGED" and int(jr.status) == 1
    np.testing.assert_allclose(np.asarray(got["trajectory"]).reshape(-1),
                               np.asarray(jr.x), rtol=0, atol=X_TOL)
    assert got["n_qp_solves"] == int(jr.n_qp_solves)
