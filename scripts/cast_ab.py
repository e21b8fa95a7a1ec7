#!/usr/bin/env python3
"""Time the cast kernels of one checkout of the port on one CUDA card.

    python3 scripts/cast_ab.py [ROOT] [--label NAME] [--reps N]

ROOT (default: this checkout) is the directory that holds the
``trajopt_tpu_torch`` package to time; its kernels build into its own
``_build/``.  Run it on two checkouts in one call, in turns (A, B, B, A),
to compare two versions of the kernels on one card.  Times K4
``cast_seg``, K4v ``cast_seg_value`` and K5 ``cast_sweep`` (n_sub 16) in
float32 on chip_smoke's inputs: the flagship (128 lanes x T=30, its
initial trajectories plus seeded noise, n_sub 2) and the pick-and-place
transfer world (their CVX instantiations, 128 lanes x T=12, the
straight-line init plus seeded noise), and the route probe
``convex_route`` on the CONVEX routes' vertex sets of one K4 launch on the
transfer's straight-line init (summed over the set sizes of each route).
Prints one JSON line: ms per launch (CUDA events over N launches after a
warm-up), with the card's name and power limit; with ``--e2e`` also the
main paths' warm walls and gated solves/s, counted as chip_smoke counts
them (the gate outside the wall; pick-and-place the mean of its two
phases' gated lanes).  Exits non-zero when CUDA is not available.
"""

import argparse
import json
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?",
                    default=os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--phases", action="store_true",
                    help="also each kernel's phase timer: the mean clock "
                    "cycles of a CTA in phases A (FK), B (discrete "
                    "distances) and C (routes), and their total")
    ap.add_argument("--e2e", action="store_true",
                    help="also the main paths end to end: the full flagship "
                    "(128 x 30) and pick-and-place (128 x 12), float32, one "
                    "cold and three warm runs each; warm walls and gated "
                    "solves/s, gated as chip_smoke phases 3b / 3c")
    ap.add_argument("--blocks", default="",
                    help="comma-separated CTA layouts THREADSxTEAM (e.g. "
                    "64x8,128x16) to time every kernel at, besides the "
                    "defaults (a checkout whose cast kernels take one)")
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("cast_ab: CUDA is not available\n")
        sys.exit(2)
    from trajopt_tpu_torch import _native
    from trajopt_tpu_torch.benchmarks import (chain_transfer,
                                              make_glass_upright,
                                              make_pick_and_place)
    from trajopt_tpu_torch.collision.geometry import \
        GENERIC_FEATURE_MAX_VERTS
    from trajopt_tpu_torch.terms.collision import (CastDistancePre,
                                                   cast_sweep_distances,
                                                   convex_route)

    dev, f32, lanes = torch.device("cuda"), torch.float32, 128
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

    _, data, _, world = make_glass_upright(lanes, 30, dtype=f32, device=dev)
    noise = np.random.default_rng(2).normal(0.0, 0.02, tuple(data.x0.shape))
    x = (data.x0 + torch.as_tensor(noise, device=dev).to(f32)).contiguous()
    X = x.reshape(lanes, 30, -1)
    _, _, scene = make_pick_and_place(lanes, 12, f32, device=dev)
    wt = scene["world_att"]
    XB0 = chain_transfer(scene, scene["grasps"])[1].x0.reshape(lanes, 12, -1)
    noise = np.random.default_rng(5).normal(0.0, 0.02, tuple(XB0.shape))
    Xt = (XB0 + torch.as_tensor(noise, device=dev).to(XB0.dtype)).contiguous()
    xt = Xt.reshape(lanes, -1).contiguous()
    pre, pre_t = CastDistancePre(world, 30, n_sub=2), \
        CastDistancePre(wt, 12, n_sub=2)
    # the route probe's rows: the CONVEX routes' vertex sets of one K4
    # launch on the transfer's straight-line init (chip_smoke phase 2c)
    sets = wt.convex_route_sets(XB0[:, :-1], XB0[:, 1:], 2)

    def times():
        return {
            "cast_seg": time_ms(lambda: pre.value_jac(x)),
            "cast_seg_value": time_ms(lambda: pre.value(x)),
            "cast_sweep": time_ms(lambda: cast_sweep_distances(world, X, 16)),
            "cast_seg_cvx": time_ms(lambda: pre_t.value_jac(xt)),
            "cast_seg_value_cvx": time_ms(lambda: pre_t.value(xt)),
            "cast_sweep_cvx": time_ms(
                lambda: cast_sweep_distances(wt, Xt, 16)),
            **{name: sum(time_ms(lambda: convex_route(wt, *rows, fw))
                         for (n1, n2), rows in sets.items()
                         if (max(n1, n2) > GENERIC_FEATURE_MAX_VERTS) == fw)
               for name, fw in (("convex_feature", False),
                                ("convex_fw", True))},
        }

    rec = {"label": a.label, "root": os.path.abspath(a.root), "ms": times()}
    if a.phases:
        from trajopt_tpu_torch.terms.collision import _cast_launch
        calls = {
            "cast_seg": (world, x, 30, "cast_seg", 2),
            "cast_seg_value": (world, x, 30, "cast_seg_value", 2),
            "cast_sweep": (world, x, 30, "cast_sweep", 16),
            "cast_seg_cvx": (wt, xt, 12, "cast_seg", 2),
            "cast_seg_value_cvx": (wt, xt, 12, "cast_seg_value", 2),
            "cast_sweep_cvx": (wt, xt, 12, "cast_sweep", 16)}
        rec["phase_cycles"] = {}
        for name, (w, xx, T, kind, ns) in calls.items():
            clk = torch.zeros((lanes * (T - 1), 4), dtype=torch.int64,
                              device=dev)
            for _ in range(2):  # the second run's stamps
                _cast_launch(kind, w, xx, T, 7, 0, T - 1, ns, clk=clk)
            torch.cuda.synchronize()
            d = (clk[:, 1:] - clk[:, :-1]).double().mean(0).tolist()
            rec["phase_cycles"][name] = dict(
                A=d[0], B=d[1], C=d[2], total=sum(d),
                ctas=clk.shape[0])
    if a.blocks:  # every kernel at each layout
        from trajopt_tpu_torch.terms import collision as tc
        default = dict(tc.CAST_BLOCKS)
        rec["default_blocks"] = {f"{k[0]}{'_cvx' if k[1] else ''}": v
                                 for k, v in default.items()}
        rec["ms_by_block"] = {}
        for b in a.blocks.split(","):
            tc.CAST_BLOCKS.update(dict.fromkeys(
                default, tuple(int(v) for v in b.split("x"))))
            rec["ms_by_block"][b] = times()
        tc.CAST_BLOCKS.update(default)
    if a.e2e:
        import time
        from trajopt_tpu_torch.benchmarks import (bench_params,
                                                  solve_pick_and_place)
        from trajopt_tpu_torch.solver.sqp import solve_batch_compact
        from trajopt_tpu_torch.solver.types import CONVERGED
        from trajopt_tpu_torch.terms.collision import trajectory_in_collision
        params = bench_params()
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
    rec.update(reps=a.reps, build_s=build_s, card=smi)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
