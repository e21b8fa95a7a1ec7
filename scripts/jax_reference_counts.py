#!/usr/bin/env python3
"""The JAX package's own counts on the CPU for the entries of its
``run_benchmarks`` (``trajopt_tpu/benchmarks.py`` ``_BENCHES``): lanes
CONVERGED, lanes gated (CONVERGED, max violation < 1e-4 and, for the
scenes with a collision world, the n_sub=16 swept check >= 0), and the mean
QP solves per lane.  These are counts, not speeds: the limits of the port's
chip_smoke phase on the same entries are these counts less 5.

    JAX_PLATFORMS=cpu python3 scripts/jax_reference_counts.py \\
        [--batch 128] [--names planning redundant_rail] [--out FILE]

``--names json_table json_table_time json_timed_vel json_timed_vel_total
json_table_discrete`` counts chip_smoke's phases 7a, 7b, 7c(i) / (ii) and
7f: 128 lanes x T=30 of
``chip_smoke.json_docs`` (one reference-format document per lane), each
loaded by the JAX package's ``load_problem`` with its defaults, stacked,
and solved with the documents' own ``SQPParams`` in float32: converged,
gated (CONVERGED, max violation < 1e-4, for the table scenes the n_sub=16
swept check >= 0 on the full table world; 7f's discrete terms report the
swept check's lanes beside the gate, not in it) and the mean QP solves.

``--names box_cast box_cast_t30`` counts chip_smoke's phases 8a and 8b:
128 lanes of ``chip_smoke.box_docs`` on boxbot (T=3 and T=30), each loaded
by the JAX package's ``load_problem`` with n_sub ``chip_smoke.box_n_sub``
(48, or the batch's largest longest_valid_segment_length count), stacked
and solved with the documents' own ``SQPParams`` in float32: converged,
gated (CONVERGED, max violation < 1e-4, the n_sub=16 swept check >= 0)
and the mean QP solves.

``--names spherebot_docs`` counts chip_smoke's phase 8c: each document of
``chip_smoke.spherebot_docs`` (the spherebot documents of the JSON tests
and the CLI test's) in 128 copies through the JAX package's
``load_problem`` (its defaults) and solver in float32: the status counts
and the mean QP solves per document.

``--names cartesian_waypoints ik_goal solve_ik`` counts chip_smoke's
cartesian phases instead (6a, 6b: converged and gated at T=30, ``SQPParams()``;
6c: converged, plain and ``pos_only``), from the same numpy inputs
(``chip_smoke.cartesian_inputs`` / ``ik_inputs``, seed 0) built into the
JAX package's terms by :func:`jax_cartesian_problem`.

Each entry runs in a child process of its own (XLA:CPU compiles are
large; a fresh process per program, as the repo's test orchestrator
does).  Prints one JSON line per entry.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


CARTESIAN = ("cartesian_waypoints", "ik_goal", "solve_ik")
JSON = ("json_table", "json_table_time", "json_timed_vel",
        "json_timed_vel_total", "json_table_discrete")
BOX = ("box_cast", "box_cast_t30")
SPHERE_DOCS = "spherebot_docs"


def jax_json_problem(docs, model_fn=None, **load_kw):
    """(spec, stacked data, params, chain, world) of chip_smoke's phase-7
    documents through the JAX package's ``load_problem`` (arm7 and its
    table world, the loader's defaults), lane 0's spec and parameters: the
    twin of ``chip_smoke.port_json_problem``; with ``model_fn`` another
    model of the JAX zoo, ``load_kw`` passed to every ``load_problem``."""
    sys.path.insert(0, ROOT)
    from trajopt_tpu.collision.world import build_collision_world
    from trajopt_tpu.models import arm7
    from trajopt_tpu.problem.json_io import load_problem
    from trajopt_tpu.problem.trajectory import stack_data

    model, chain = (model_fn or arm7)()
    world = build_collision_world(model, chain)
    loaded = [load_problem(d, chain, world, **load_kw) for d in docs]
    spec, _, params = loaded[0]
    return spec, stack_data([d for _, d, _ in loaded]), params, chain, world


def jax_box_problem(docs):
    """chip_smoke phase 8's documents through the JAX package's
    ``load_problem`` on boxbot: the twin of ``chip_smoke.port_box_problem``."""
    sys.path.insert(0, ROOT)
    from chip_smoke import box_n_sub
    from trajopt_tpu.models import boxbot

    return jax_json_problem(docs, boxbot, n_sub=box_n_sub(docs))


def one_json(name, batch):
    """chip_smoke phase 7a / 7b / 7c's (and 8a / 8b's) counts in float32
    (JAX's default)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    sys.path.insert(0, ROOT)
    from chip_smoke import box_docs, json_docs
    from trajopt_tpu.solver.sqp import _solve
    from trajopt_tpu.solver.types import CONVERGED
    from trajopt_tpu.terms.collision import trajectory_in_collision

    if name in BOX:
        kind = "table"  # the swept gate over every gap, as 7a's
        spec, data, params, chain, world = jax_box_problem(
            box_docs(name, batch))
    else:
        kind = name[len("json_"):]
        spec, data, params, chain, world = jax_json_problem(
            json_docs(kind, batch))
    res = jax.jit(jax.vmap(lambda d: _solve(spec, params, d)))(data)
    jax.block_until_ready(res)
    status = np.asarray(res.status)
    viol = np.asarray(res.cnt_viols).max(axis=1)
    conv = status == CONVERGED
    gated = conv & (viol < 1e-4)
    X = np.asarray(res.x).reshape(batch, spec.n_steps, -1)
    rec = {"name": name, "batch": batch, "dtype": str(X.dtype),
           "n_x": spec.n_x, "converged": int(conv.sum()),
           "mean_qp_solves": float(np.asarray(res.n_qp_solves).mean()),
           "finite": bool(np.isfinite(X).all())}
    if kind.startswith("table"):
        swept = np.asarray(jax.jit(jax.vmap(
            lambda q: trajectory_in_collision(world, q)))(
                X[:, :, :chain.n_dof]))
        rec["min_swept_distance"] = float(swept.min())
        rec["swept_free_lanes"] = int((swept >= 0.0).sum())
        if kind != "table_discrete":  # a per-step term promises no sweep
            gated = gated & (swept >= 0.0)
    rec["gated"] = int(gated.sum())
    rec["status_counts"] = {int(k): int(v) for k, v in
                            zip(*np.unique(status, return_counts=True))}
    return rec


def jax_cartesian_problem(kind, inp, dtype):
    """(spec, batched data, chain) of chip_smoke's cartesian scene ``kind``
    ("waypoints" or "ik_goal") through the JAX package's public term API,
    from ``chip_smoke.cartesian_inputs``' numpy inputs: the scene of
    ``chip_smoke.port_cartesian_problem``, term for term."""
    import numpy as np

    sys.path.insert(0, ROOT)
    from trajopt_tpu.kinematics.ik import ik_term
    from trajopt_tpu.models import arm7
    from trajopt_tpu.problem.trajectory import TrajProblemBuilder, stack_data
    from trajopt_tpu.terms.cartesian import (cart_pose_term, cart_vel_term,
                                             default_cart_pose_params)
    from trajopt_tpu.terms.joint import joint_vel_term

    _, chain = arm7()
    T, D = inp["init_waypoints"].shape[1], chain.n_dof
    npdt = np.dtype(dtype)
    b = TrajProblemBuilder(chain, T)
    b.add_cost(joint_vel_term("jvel", T, D),
               {"targets": np.zeros(D, npdt), "coeffs": np.ones(D, npdt)})

    def cnt(i):
        if kind == "waypoints":
            out = [{k: np.asarray(v, npdt) for k, v in default_cart_pose_params(
                inp["waypoint_R"][i, w], inp["waypoint_p"][i, w]).items()}
                for w in range(3)]
            return out + [{"max_displacement": np.asarray(
                inp["max_displacement"], npdt)}]
        return [{"target_R": np.asarray(inp["waypoint_R"][i, 2], npdt),
                 "target_p": np.asarray(inp["waypoint_p"][i, 2], npdt),
                 "coeffs": np.ones(D, npdt)}]

    if kind == "waypoints":
        for w, s in enumerate(inp["steps"]):
            b.add_constraint(cart_pose_term(f"pose{w}", chain, T, s, "tool"),
                             cnt(0)[w])
        b.add_constraint(cart_vel_term("cart_vel", chain, T, "tool",
                                       is_constraint=True), cnt(0)[3])
        init = inp["init_waypoints"]
    else:
        b.add_constraint(ik_term("ik_goal", chain, T, T - 1, "tool"),
                         cnt(0)[0])
        init = inp["init_ik_goal"]
    b.fix_timestep(0)
    datas = []
    for i in range(init.shape[0]):
        spec, data = b.build(np.asarray(init[i], npdt))
        datas.append(data._replace(cnt_params=tuple(cnt(i))))
    return spec, stack_data(datas), chain


def one_cartesian(name, batch):
    """chip_smoke phase 6a / 6b / 6c's counts in float32 (JAX's default)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, ROOT)
    from chip_smoke import cartesian_inputs, ik_inputs
    from trajopt_tpu.kinematics.ik import solve_ik
    from trajopt_tpu.models import arm7
    from trajopt_tpu.solver.sqp import _solve
    from trajopt_tpu.solver.types import CONVERGED, SQPParams

    rec = {"name": name, "batch": batch, "dtype": "float32"}
    if name == "solve_ik":
        _, chain = arm7()
        inp = ik_inputs(batch)
        args = [jnp.asarray(inp[k], jnp.float32)
                for k in ("target_R", "target_p", "q0")]
        for po in (False, True):
            res = jax.jit(jax.vmap(lambda R, p, q0: solve_ik(
                chain, inp["link"], R, p, q0=q0, pos_only=po)))(*args)
            it = np.asarray(res.iters)
            rec["pos_only" if po else "full"] = {
                "converged": int(np.asarray(res.converged).sum()),
                "mean_iters": float(it.mean()), "max_iters": int(it.max()),
                "max_err_norm": float(np.asarray(res.err_norm).max())}
        return rec
    inp = cartesian_inputs(batch)
    spec, data, chain = jax_cartesian_problem(
        "waypoints" if name == "cartesian_waypoints" else "ik_goal", inp,
        np.float32)
    res = jax.jit(jax.vmap(lambda d: _solve(spec, SQPParams(), d)))(data)
    jax.block_until_ready(res)
    status = np.asarray(res.status)
    viol = np.asarray(res.cnt_viols).max(axis=1)
    conv = status == CONVERGED
    rec.update(converged=int(conv.sum()),
               gated=int((conv & (viol < 1e-4)).sum()),
               mean_qp_solves=float(np.asarray(res.n_qp_solves).mean()),
               finite=bool(np.isfinite(np.asarray(res.x)).all()),
               status_counts={int(k): int(v) for k, v in
                              zip(*np.unique(status, return_counts=True))})
    return rec


def one_spherebot_docs(batch):
    """chip_smoke phase 8c's counts: per document, the status counts of
    ``batch`` copies in float32 and the mean QP solves."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    sys.path.insert(0, ROOT)
    from chip_smoke import spherebot_docs
    from trajopt_tpu.models import spherebot
    from trajopt_tpu.solver.sqp import _solve

    out = {"name": SPHERE_DOCS, "batch": batch, "dtype": "float32"}
    for key, (doc, _, _) in spherebot_docs().items():
        spec, data, params, _, _ = jax_json_problem([doc] * batch, spherebot)
        res = jax.jit(jax.vmap(lambda d: _solve(spec, params, d)))(data)
        st = np.asarray(res.status)
        out[key] = {"status_counts": {int(k): int(v) for k, v in zip(
            *np.unique(st, return_counts=True))},
            "mean_qp_solves": float(np.asarray(res.n_qp_solves).mean())}
    return out


def one(name, batch):
    if name == SPHERE_DOCS:
        return one_spherebot_docs(batch)
    if name in CARTESIAN:
        return one_cartesian(name, batch)
    if name in JSON or name in BOX:
        return one_json(name, batch)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    sys.path.insert(0, ROOT)
    from trajopt_tpu.benchmarks import _BENCHES, bench_params
    from trajopt_tpu.solver.sqp import _solve
    from trajopt_tpu.solver.types import CONVERGED
    from trajopt_tpu.terms.collision import trajectory_in_collision

    spec, data, chain, world = _BENCHES[name](batch)
    params = bench_params()
    res = jax.jit(jax.vmap(lambda d: _solve(spec, params, d)))(data)
    jax.block_until_ready(res)
    status = np.asarray(res.status)
    viol = np.asarray(res.cnt_viols).max(axis=1) if res.cnt_viols.shape[1] \
        else np.zeros(batch)
    X = np.asarray(res.x).reshape(batch, spec.n_steps, chain.n_dof)
    conv = status == CONVERGED
    gated = conv & (viol < 1e-4)
    rec = {"name": name, "batch": batch, "dtype": str(np.asarray(res.x).dtype),
           "converged": int(conv.sum()),
           "mean_qp_solves": float(np.asarray(res.n_qp_solves).mean()),
           "finite": bool(np.isfinite(X).all())}
    if spec.n_steps >= 2:
        swept = np.asarray(jax.jit(jax.vmap(
            lambda x: trajectory_in_collision(world, x)))(X))
        gated = gated & (swept >= 0.0)
        rec["min_swept_distance"] = float(swept.min())
    rec["gated"] = int(gated.sum())
    rec["status_counts"] = {int(k): int(v) for k, v in
                            zip(*np.unique(status, return_counts=True))}
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--names", nargs="*",
                    default=["simple_collision", "planning", "glass_upright",
                             "redundant_rail"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None)
    a = ap.parse_args()
    if a.child:
        print(json.dumps(one(a.child, a.batch)), flush=True)
        return
    lines = []
    for name in a.names:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", name, "--batch", str(a.batch)],
                           capture_output=True, text=True, cwd=ROOT)
        out = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
        if p.returncode != 0 or not out:
            sys.stderr.write(p.stderr[-4000:])
            raise SystemExit(f"{name}: child failed (rc {p.returncode})")
        print(out[-1], flush=True)
        lines.append(out[-1])
    if a.out:
        with open(a.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
