#!/usr/bin/env python3
"""Time K6 ipm_banded (or, with --k11, K11 ipm_dense) of one checkout of
the port on one CUDA card.

    python3 scripts/ipm_ab.py [ROOT] [--label NAME] [--qps FILE]
                              [--out FILE] [--reps N] [--phases] [--e2e]
    python3 scripts/ipm_ab.py [ROOT] --k11 [--label NAME] [--qps FILE]
                              [--out FILE] [--reps N] [--phases]
    python3 scripts/ipm_ab.py --compare A.pt B.pt

ROOT (default: this checkout) is the directory that holds the
``trajopt_tpu_torch`` package to time; its kernels build into its own
``_build/``.  Run it on two checkouts in one call, in turns (A, B, B, A),
to compare two versions of K6 on one card.

The QPs are chip_smoke phase 2d's: the SQP's batched QP solves captured
from real runs, 128 lanes each, float32: the full flagship's first and
second (128 x T=30, b 7), the pick-and-place transfer's first (128 x
T=12), the redundant rail's first (b 9) and 7b's (``json_table_time``:
the 1/dt grid, b 8).  The flagship's first is also regrouped to
superblocks of two and three steps (b 14, 21).  ``--qps FILE`` loads
them from FILE, or captures them with ROOT's package and saves them there
when FILE does not exist, so that every checkout of one call solves the
same QPs.

Prints one JSON line: K6's ms per launch on each QP in float32 (CUDA
events over N launches after a warm-up), with the card's name and power
limit.  ``--out FILE`` saves K6's outputs on every QP in float32 and
float64 (the solution x, status, iterations per lane) for ``--compare``,
which prints per QP and dtype each lane's largest |dx| difference
(absolute, and relative to the lane's largest |x|), the lanes whose x is
bitwise equal, and the lanes that end apart (status or iteration count)
with both sides' statuses and iterations.  ``--phases``: the mean clock64
cycles per CTA and IPM iteration of each of K6's timer phases
(``ipm_qp.K6_PHASES``), float32, where ROOT's K6 has the timer, and the
factors per iteration that took their fallback.  ``--e2e``: the main paths' warm walls and
gated solves/s, counted as ``cast_ab.py --e2e`` counts them.  Only the
libraries a run needs are built.

``--k11``: K11 ipm_dense on chip_smoke phase 2h's QPs instead, the first
batched QP solve of each dense-row path, 128 lanes, captured in float32:
6a's cartesian waypoints and 6b's IK goal (K11's block route at b 7),
7c(i)'s timed velocity (b 8), 7c(ii)'s with total_time and
simple_collision's (its dense route).  Per QP: K11's bare launch on the
device clock (``chip_smoke.device_ms``), float32, its shared-memory plan
and its lists' sizes where the checkout reports them; ``--phases`` each
timer phase's cycles per CTA and IPM iteration and the set-up's cycles per
CTA (float32, where ROOT's K11 has the timer); ``--out`` every output of
the launch (dx, z5, z6, dxb, h, z1, p, nn, y, rp, rd, fb, it, status) in
float32 and float64, which ``--compare`` holds element by element (equal,
or NaN on both sides), per lane, with each lane's |dx| differences and
the lanes that end apart, as for K6.  Exits non-zero when CUDA is not
available.
"""

import argparse
import ctypes
import dataclasses
import inspect
import json
import os
import subprocess
import sys

QP_FIELDS = ("P", "q", "e_h", "w_h", "e_a", "w_a", "lb", "ub")


def _pack(qd, st):
    return {"data": {**{k: getattr(qd, k).cpu() for k in QP_FIELDS},
                     **{k: [t.cpu() for t in getattr(qd, k)]
                        for k in ("Bh", "Gh", "Ba", "Ga")}},
            "settings": dataclasses.asdict(st)}


def _unpack(rec, dev, dtype):
    import torch

    from trajopt_tpu_torch.ops.prox_qp import ProxQPData
    from trajopt_tpu_torch.ops.qp import QPSettings
    d = rec["data"]
    qd = ProxQPData(**{k: d[k].to(dev, dtype) for k in QP_FIELDS},
                    A_h=None, A_a=None,
                    Bh=tuple(t.to(dev, dtype) for t in d["Bh"]),
                    Gh=tuple(t.to(dev) for t in d["Gh"]),
                    Ba=tuple(t.to(dev, dtype) for t in d["Ba"]),
                    Ga=tuple(t.to(dev) for t in d["Ga"]))
    assert all(t.dtype == torch.int32 for t in qd.Gh + qd.Ga)
    return qd, QPSettings(**rec["settings"])


def _regrouped(rec, c):
    """rec's QP with its windows regrouped to superblocks of c steps."""
    import torch

    from trajopt_tpu_torch.ops.banded_rows import regroup
    d, st = dict(rec["data"]), dict(rec["settings"])
    b, nsb = st["kkt_block"], d["q"].shape[1] // (st["kkt_block"] * c)
    for kb, kg in (("Bh", "Gh"), ("Ba", "Ga")):
        out = [regroup(B, G, b, c, nsb) for B, G in zip(d[kb], d[kg])]
        d[kb] = [B for B, _ in out]
        d[kg] = [G.to(torch.int32) for _, G in out]
    st["kkt_block"] = b * c
    return {"data": d, "settings": st}


def capture_qps(dev, lanes):
    """The QPs of chip_smoke phase 2d, captured with this package (and the
    documents of this checkout's chip_smoke)."""
    import torch

    sys.path.insert(1, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from trajopt_tpu_torch.benchmarks import make_redundant_rail
    from trajopt_tpu_torch.solver.sqp import solve_batch

    from trajopt_tpu_torch.benchmarks import (bench_params, chain_transfer,
                                              make_glass_upright,
                                              make_pick_and_place)
    from trajopt_tpu_torch.solver import sqp as sqp_mod
    from trajopt_tpu_torch.solver.sqp import solve_batch_compact
    params = bench_params()

    def capture(fn, keep):
        got, seen = {}, [0]
        orig = sqp_mod.solve_ipm_qp

        def rec(qd, st, **kw):
            if seen[0] in keep:
                got[seen[0]] = _pack(qd, st)
            seen[0] += 1
            return orig(qd, st, **kw)
        sqp_mod.solve_ipm_qp = rec
        try:
            fn()
        finally:
            sqp_mod.solve_ipm_qp = orig
        return got

    f32 = torch.float32
    spec_f, data_f, _, _ = make_glass_upright(lanes, 30, dtype=f32,
                                              device=dev)
    got = capture(lambda: solve_batch_compact(
        spec_f, data_f, params, phase_qp_solves=8, device=dev), {0, 1})
    qps = {"flagship_qp1": got[0], "flagship_qp2": got[1]}
    specA, dataA, sc = make_pick_and_place(lanes, 12, f32, device=dev)
    rA = solve_batch_compact(specA, dataA, params, phase_qp_solves=8,
                             device=dev)
    specB, dataB = chain_transfer(
        sc, rA.x.reshape(lanes, 12, -1)[:, -1].cpu().numpy())
    qps["transfer_qp1"] = capture(lambda: solve_batch_compact(
        specB, dataB, params, phase_qp_solves=8, device=dev), {0})[0]
    spec_r, data_r = make_redundant_rail(lanes, dtype=f32, device=dev)[:2]
    qps["rail_qp1"] = capture(lambda: solve_batch(
        spec_r, data_r, dataclasses.replace(params, max_total_qp_solves=1),
        device=dev), {0})[0]
    spec_t, data_t, par_t = cs.port_json_problem(
        cs.json_docs("table_time", lanes), f32, dev)[:3]
    qps["json_table_time_qp1"] = capture(lambda: solve_batch(
        spec_t, data_t, dataclasses.replace(par_t, max_total_qp_solves=1),
        device=dev), {0})[0]
    qps["flagship_qp1_b14"] = _regrouped(qps["flagship_qp1"], 2)
    qps["flagship_qp1_b21"] = _regrouped(qps["flagship_qp1"], 3)
    return qps


# K11's outputs (ipm_qp._St's fields, by the kernel's argument names)
K11_OUTS = {"dx": "dx", "z5": "z5", "z6": "z6", "dxb": "dx_best", "h": "h",
            "z1": "z1", "p": "p", "nn": "nn", "y": "y", "rp": "rp", "rd": "rd",
            "fb": "f_best", "it": "it", "status": "status"}
DENSE_FIELDS = QP_FIELDS + ("A_h", "A_a")


def capture_dense_qps(dev, lanes):
    """The QPs of chip_smoke phase 2h (float32), captured with ROOT's
    package and the scenes of this checkout's chip_smoke."""
    import torch

    sys.path.insert(1, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from trajopt_tpu_torch.benchmarks import (bench_params,
                                              make_simple_collision)
    from trajopt_tpu_torch.solver import sqp as sqp_mod
    from trajopt_tpu_torch.solver.types import SQPParams
    f32 = torch.float32

    def first_qp(spec, data, par):
        got, orig = [], sqp_mod.solve_ipm_qp

        def rec(qd, st, **kw):
            if not got:
                got.append({"data": {k: getattr(qd, k).cpu()
                                     for k in DENSE_FIELDS},
                            "settings": dataclasses.asdict(st)})
            return orig(qd, st, **kw)
        sqp_mod.solve_ipm_qp = rec
        try:
            sqp_mod.solve_batch(spec, data, dataclasses.replace(
                par, max_total_qp_solves=1), device=dev)
        finally:
            sqp_mod.solve_ipm_qp = orig
        return got[0]

    inp = cs.cartesian_inputs(lanes, 30)
    qps = {}
    for kind in ("waypoints", "ik_goal"):
        qps[f"cartesian_{kind}_qp1"] = first_qp(*cs.port_cartesian_problem(
            kind, inp, f32, dev)[:2], SQPParams())
    for kind in ("timed_vel", "timed_vel_total"):
        qps[f"json_{kind}_qp1"] = first_qp(*cs.port_json_problem(
            cs.json_docs(kind, lanes), f32, dev)[:3])
    qps["simple_collision_qp1"] = first_qp(
        *make_simple_collision(lanes, f32, device=dev)[:2], bench_params())
    return qps


def lane_diffs(xa, xb, st_a, st_b, it_a, it_b):
    """Per lane: x's largest |difference|, absolute and relative to the
    lane's largest |x| on side A; the lanes that end apart (status or
    iterations), with both sides' statuses and iterations."""
    import torch
    d = (xa.double() - xb.double()).abs().amax(-1)
    rel = d / xa.double().abs().amax(-1).clamp(min=1e-30)
    apart = torch.nonzero((st_a != st_b) | (it_a != it_b))[:, 0].tolist()
    return {"dx_abs_per_lane": d.tolist(), "dx_rel_per_lane": rel.tolist(),
            "dx_rel_max": float(rel.max()),
            "dx_rel_median": float(rel.median()),
            "lanes_apart": apart,
            "apart_status": [[int(st_a[i]), int(st_b[i])] for i in apart],
            "apart_iters": [[int(it_a[i]), int(it_b[i])] for i in apart]}


def compare_dense(A, B, rec):
    """K11's outputs of two --k11 runs, element by element per lane."""
    import torch
    for key in A["out"]:
        a, b = A["out"][key], B["out"][key]
        q = {"lanes": int(a["it"].shape[0]), "differ": {}}
        bad = torch.zeros_like(a["it"], dtype=torch.bool)
        for k in K11_OUTS:
            x, y = a[k], b[k]
            same = (x == y) | (torch.isnan(x) & torch.isnan(y)) \
                if x.is_floating_point() else x == y
            same = same.reshape(same.shape[0], -1).all(-1)
            if not bool(same.all()):
                q["differ"][k] = torch.nonzero(~same)[:, 0].tolist()
            bad |= ~same
        q["lanes_equal"] = int((~bad).sum())
        d = (a["dx"].double() - b["dx"].double()).abs().amax(-1)
        q["dx_max_abs_diff"] = float(d.max())
        q.update(lane_diffs(a["dx"], b["dx"], a["status"], b["status"],
                            a["it"], b["it"]))
        rec["qps"][key] = q
    print(json.dumps(rec), flush=True)


def compare(a_path, b_path):
    import torch
    A = torch.load(a_path, weights_only=True)
    B = torch.load(b_path, weights_only=True)
    rec = {"compare": [A["label"], B["label"]], "qps": {}}
    if A.get("kernel") == "ipm_dense":
        compare_dense(A, B, rec)
        return
    for key in A["out"]:
        a, b = A["out"][key], B["out"][key]
        d = (a["x"] - b["x"]).abs().amax(-1)
        rec["qps"][key] = {
            "dx_max_abs_diff": float(d.max()),
            "lanes": int(d.numel()),
            "lanes_x_bitwise_equal": int((a["x"] == b["x"]).all(-1).sum()),
            "lanes_status_differ": int((a["status"] != b["status"]).sum()),
            "lanes_iters_differ": int((a["iters"] != b["iters"]).sum()),
            "iters_diff_max": int((a["iters"] - b["iters"]).abs().max()),
            **lane_diffs(a["x"], b["x"], a["status"], b["status"],
                         a["iters"], b["iters"])}
    print(json.dumps(rec), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?",
                    default=os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--qps", default="",
                    help="file of the captured QPs: loaded, or captured "
                    "with ROOT's package and saved when it does not exist")
    ap.add_argument("--out", default="",
                    help="save K6's outputs (x, status, iterations per lane, "
                    "float32 and float64) here for --compare")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="compare two --out files and exit")
    ap.add_argument("--k11", action="store_true",
                    help="K11 ipm_dense on chip_smoke phase 2h's QPs "
                    "instead of K6 on 2d's")
    ap.add_argument("--phases", action="store_true",
                    help="also K6's phase timer: mean clock64 cycles per "
                    "CTA and IPM iteration of each phase, float32")
    ap.add_argument("--e2e", action="store_true",
                    help="also the main paths end to end: the full flagship "
                    "(128 x 30) and pick-and-place (128 x 12), float32, one "
                    "cold and three warm runs each; warm walls and gated "
                    "solves/s, gated as chip_smoke phases 3b / 3c")
    a = ap.parse_args()
    if a.compare:
        compare(*a.compare)
        return
    sys.path.insert(0, os.path.abspath(a.root))

    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("ipm_ab: CUDA is not available\n")
        sys.exit(2)
    from trajopt_tpu_torch import _native
    from trajopt_tpu_torch.ops import ipm_qp

    dev, lanes = torch.device("cuda"), 128
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    def time_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(a.reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / a.reps

    if a.k11:
        run_k11(a, dev, lanes, smi)
        return
    # the libraries this run needs: K6 at the QPs' block sizes (and its
    # timer), the cast kernels of the captures and of --e2e, K10 of 7b's
    names = [_native.k6_library(f64, b) for f64 in (False, True)
             for b in (7, 8, 9, 14, 21)] + ["cast_seg", "cast_cvx",
                                             "contact_select"]
    if a.phases:
        names.append("ipm_timer")
    build_s = _native.build_all(sorted(set(names)) if not a.e2e else None)
    if a.qps and os.path.exists(a.qps):
        qps = torch.load(a.qps, weights_only=True)
    else:
        qps = capture_qps(dev, lanes)
        if a.qps:
            torch.save(qps, a.qps)

    rec = {"label": a.label, "root": os.path.abspath(a.root), "ms": {},
           "iters_mean": {}}
    timed = "clk" in inspect.signature(ipm_qp.ipm_banded_cuda).parameters
    if a.phases and timed:
        rec["phase_cycles_per_cta_iteration"] = {}
    outs = {}
    for name, q in qps.items():
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[-1]
            qd, st = _unpack(q, dev, dtype)
            su = ipm_qp._setup(qd, st)
            plan = ipm_qp.band_plan(qd, st.kkt_block)
            sol = ipm_qp._finish(su, ipm_qp.ipm_banded_cuda(su, plan))
            outs[f"{name}_{dname}"] = {"x": sol.x.cpu(),
                                       "status": sol.status.cpu(),
                                       "iters": sol.iters.cpu()}
            if dtype != torch.float32:
                continue
            rec["ms"][name] = time_ms(lambda: ipm_qp.ipm_banded_cuda(su,
                                                                     plan))
            rec["iters_mean"][name] = float(sol.iters.double().mean())
            if a.phases and timed:
                nph = len(ipm_qp.K6_PHASES)
                slots = getattr(ipm_qp, "K6_CLK_SLOTS", nph)
                clk = torch.zeros((lanes, slots), dtype=torch.int64,
                                  device=dev)
                st_k = ipm_qp.ipm_banded_cuda(su, plan, clk=clk)
                torch.cuda.synchronize()
                its = float(st_k.it.double().sum())
                cyc = (clk[:, :nph].double().sum(0) / its).tolist()
                rec["phase_cycles_per_cta_iteration"][name] = dict(
                    zip(ipm_qp.K6_PHASES, cyc), total=sum(cyc))
                if slots > nph:  # the factors that took their fallback
                    rec["phase_cycles_per_cta_iteration"][name][
                        "factor_fallbacks_per_iteration"] = float(
                            clk[:, nph].double().sum()) / its
    if a.phases and not timed:
        rec["phase_cycles_per_cta_iteration"] = "this checkout's K6 has " \
            "no timer"
    if a.out:
        torch.save({"label": a.label, "out": outs}, a.out)
    if a.e2e:
        import time

        from trajopt_tpu_torch.benchmarks import (bench_params,
                                                  make_glass_upright,
                                                  solve_pick_and_place)
        from trajopt_tpu_torch.solver.sqp import solve_batch_compact
        from trajopt_tpu_torch.solver.types import CONVERGED
        from trajopt_tpu_torch.terms.collision import trajectory_in_collision
        params, f32 = bench_params(), torch.float32
        spec_f, data_f, _, world_f = make_glass_upright(lanes, 30, dtype=f32,
                                                        device=dev)

        def gated(res, w, T):
            g = trajectory_in_collision(w, res.x.reshape(lanes, T, -1))
            ok = (res.status == CONVERGED) \
                & (res.cnt_viols.max(dim=1).values < 1e-4) & (g >= 0)
            return int(ok.sum())

        def flagship():
            res = solve_batch_compact(spec_f, data_f, params,
                                      phase_qp_solves=8, device=dev)
            torch.cuda.synchronize()
            return lambda: gated(res, world_f, 30)

        def pnp():
            rA, rB, sc = solve_pick_and_place(lanes, 12, f32, params=params,
                                              device=dev)
            torch.cuda.synchronize()
            return lambda: (gated(rA, sc["world_free"], 12)
                            + gated(rB, sc["world_att"], 12)) / 2

        rec["e2e"] = {}
        for name, fn in (("flagship", flagship), ("pick_and_place", pnp)):
            fn()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                gate = fn()
                walls.append(time.perf_counter() - t0)
            n_ok = gate()  # the last run's gate, outside its wall
            wall = sum(walls) / len(walls)
            rec["e2e"][name] = dict(walls_s=walls, wall_s=wall, gated=n_ok,
                                    gated_solves_per_s=n_ok / wall)
    if hasattr(ipm_qp, "kernel_attributes"):
        rec["attributes"] = ipm_qp.kernel_attributes()
    rec.update(reps=a.reps, build_s=build_s, card=smi)
    print(json.dumps(rec), flush=True)


def run_k11(a, dev, lanes, smi):
    """--k11: K11 of ROOT's package on phase 2h's QPs (see the module
    docstring); prints one JSON line."""
    import torch

    from trajopt_tpu_torch import _native
    from trajopt_tpu_torch.ops import ipm_qp
    from trajopt_tpu_torch.ops.prox_qp import ProxQPData
    from trajopt_tpu_torch.ops.qp import QPSettings
    sys.path.insert(1, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import device_ms

    timed = "clk" in inspect.signature(ipm_qp.ipm_dense_cuda).parameters
    # K11 at b 7, 8 and the dense route (the b 1-9 libraries), the timer,
    # and the kernels the captures' SQP runs (K7, K8, K9)
    libs = [_native.k11_library(f64, 1) for f64 in (False, True)]
    # a checkout whose dense order is a library of its own: those too
    split = "lists" in inspect.signature(_native.k11_library).parameters
    if split:
        libs += [_native.k11_library(f64, 0, False) for f64 in (False, True)]
    timers = ["ipm_dense_timer"] + (["ipm_dense_timer_dense"] if split
                                    else [])
    names = libs + ["cart_pose", "solve_ik", "disc_dist"] \
        + (timers if a.phases and timed else [])
    build_s = _native.build_all(names)
    if a.qps and os.path.exists(a.qps):
        qps = torch.load(a.qps, weights_only=True)
    else:
        qps = capture_dense_qps(dev, lanes)
        if a.qps:
            torch.save(qps, a.qps)
    rec = {"label": a.label, "root": os.path.abspath(a.root),
           "kernel": "ipm_dense", "ms": {}, "iters_mean": {}, "plan": {}}
    if a.phases:
        rec["phase_cycles_per_cta_iteration"] = {} if timed else \
            "this checkout's K11 has no timer"
    outs = {}
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, q in qps.items():
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[-1]
            d = q["data"]
            qd = ProxQPData(**{k: d[k].to(dev, dtype) for k in DENSE_FIELDS},
                            Bh=(), Gh=(), Ba=(), Ga=())
            su = ipm_qp._setup(qd, QPSettings(**q["settings"]))
            st = ipm_qp.ipm_dense_cuda(su)
            outs[f"{name}_{dname}"] = {k: getattr(st, f).cpu()
                                       for k, f in K11_OUTS.items()}
            if dtype != torch.float32:
                continue
            args, keep = ipm_qp._k11_args(su)
            run = _native.library(_native.k11_library(
                False, args.b, *([bool(args.lists)] if split else [])
            )).ipm_dense_run
            ms, queue = device_ms(lambda: run(ctypes.byref(args), stream),
                                  reps=a.reps)
            rec["ms"][name] = ms
            rec["iters_mean"][name] = float(st.it.double().mean())
            rec["plan"][name] = {
                k: getattr(args, k) for k, _ in args._fields_
                if k.startswith(("smem_", "nz_")) or k in ("n", "b", "nb",
                                                          "mh", "ma")}
            del keep
            if a.phases and timed and (su.nb == 0 or su.bsz <= 9):
                nph = len(ipm_qp.K6_PHASES)
                clk = torch.zeros((lanes, ipm_qp.K11_CLK_SLOTS),
                                  dtype=torch.int64, device=dev)
                st_k = ipm_qp.ipm_dense_cuda(su, clk=clk)
                torch.cuda.synchronize()
                its = float(st_k.it.double().sum())
                cyc = (clk[:, :nph].double().sum(0) / its).tolist()
                rec["phase_cycles_per_cta_iteration"][name] = dict(
                    zip(ipm_qp.K6_PHASES, cyc), total=sum(cyc),
                    factor_fallbacks_per_iteration=float(
                        clk[:, nph].double().sum()) / its,
                    setup_cycles_per_cta=float(
                        clk[:, nph + 1].double().mean()))
                if clk.shape[1] > nph + 2:  # the dense factor's split
                    rec["phase_cycles_per_cta_iteration"][name].update(
                        factor_panels=float(clk[:, nph + 2].double().sum())
                        / its, factor_trailing=float(
                            clk[:, nph + 3].double().sum()) / its)
    if a.out:
        torch.save({"label": a.label, "kernel": "ipm_dense", "out": outs},
                   a.out)
    attrs = {}
    for lib in libs:
        buf = (ctypes.c_int * 4)()
        _native.check("ipm_dense_attrs",
                      _native.library(lib).ipm_dense_attrs(buf))
        attrs[lib] = dict(zip(("num_regs", "local_bytes", "max_threads",
                               "static_smem_bytes"), list(buf)))
    rec.update(attributes=attrs, reps=a.reps, build_s=build_s, card=smi)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
