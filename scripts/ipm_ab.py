#!/usr/bin/env python3
"""Time K6 ipm_banded of one checkout of the port on one CUDA card.

    python3 scripts/ipm_ab.py [ROOT] [--label NAME] [--qps FILE]
                              [--out FILE] [--reps N] [--phases] [--e2e]
    python3 scripts/ipm_ab.py --compare A.pt B.pt

ROOT (default: this checkout) is the directory that holds the
``trajopt_tpu_torch`` package to time; its kernels build into its own
``_build/``.  Run it on two checkouts in one call, in turns (A, B, B, A),
to compare two versions of K6 on one card.

The QPs are chip_smoke phase 2d's: the SQP's batched QP solves captured
from real runs, 128 lanes each, float32: the full flagship's first and
second (128 x T=30, b 7) and the pick-and-place transfer's first (128 x
T=12).  The flagship's first is also regrouped to superblocks of two and
three steps (b 14, 21).  ``--qps FILE`` loads them from FILE, or captures
them with ROOT's package and saves them there when FILE does not exist, so
that every checkout of one call solves the same QPs.

Prints one JSON line: K6's ms per launch on each QP in float32 (CUDA
events over N launches after a warm-up), with the card's name and power
limit.  ``--out FILE`` saves K6's outputs on every QP in float32 and
float64 (the solution x, status, iterations per lane) for ``--compare``,
which prints per QP and dtype the largest |dx| difference per lane, the
lanes whose x is bitwise equal, and the lanes whose status or iteration
count differ.  ``--phases``: the mean clock64 cycles per CTA and IPM
iteration of each of K6's timer phases (``ipm_qp.K6_PHASES``), float32,
where ROOT's K6 has the timer, and the factors per iteration that took
their fallback.  ``--e2e``: the main paths' warm walls and
gated solves/s, counted as ``cast_ab.py --e2e`` counts them.  Exits
non-zero when CUDA is not available.
"""

import argparse
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
    """The QPs of chip_smoke phase 2d, captured with this package."""
    import torch

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
    qps["flagship_qp1_b14"] = _regrouped(qps["flagship_qp1"], 2)
    qps["flagship_qp1_b21"] = _regrouped(qps["flagship_qp1"], 3)
    return qps


def compare(a_path, b_path):
    import torch
    A = torch.load(a_path, weights_only=True)
    B = torch.load(b_path, weights_only=True)
    rec = {"compare": [A["label"], B["label"]], "qps": {}}
    for key in A["out"]:
        a, b = A["out"][key], B["out"][key]
        d = (a["x"] - b["x"]).abs().amax(-1)
        rec["qps"][key] = {
            "dx_max_abs_diff": float(d.max()),
            "lanes": int(d.numel()),
            "lanes_x_bitwise_equal": int((a["x"] == b["x"]).all(-1).sum()),
            "lanes_status_differ": int((a["status"] != b["status"]).sum()),
            "lanes_iters_differ": int((a["iters"] != b["iters"]).sum()),
            "iters_diff_max": int((a["iters"] - b["iters"]).abs().max())}
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
    build_s = _native.build_all()

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


if __name__ == "__main__":
    main()
