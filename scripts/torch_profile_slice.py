#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's main path, on one CUDA card.

    python3 scripts/torch_profile_slice.py [--scene free|full|pnp|
                                            cartesian|ik_goal|
                                            json_table|json_time]
                                           [--batch 128] [--steps T]

Runs a scene through ``solve_batch_compact`` (float32, ``bench_params()``,
``phase_qp_solves=8``): ``--scene free`` is ``make_glass_upright_free``
(no collision terms), ``--scene full`` the full ``make_glass_upright``
(cast collision, n_sub=2), both at T=30 by default; ``--scene pnp`` is
pick-and-place at T=12 by default, its two chained problems measured one
after the other (the approach from ``make_pick_and_place``, then the
transfer from ``chain_transfer`` of the approach's solution);
``--scene cartesian`` and ``--scene ik_goal`` are chip_smoke's phases 6a
and 6b (``chip_smoke.cartesian_inputs`` built by
``port_cartesian_problem``, T=30), run as chip_smoke runs them, through
``solve_batch`` with ``SQPParams()``, their pose kernels K9 / K9v and K8
in ranges of their own; ``--scene json_table`` and ``--scene json_time``
are chip_smoke's phases 7a and 7b (``chip_smoke.json_docs("table")`` /
``("table_time")``, one document per lane through ``load_problem``,
``port_json_problem``), through ``solve_batch`` with the documents' own
``SQPParams``, K10's calls in a range of their own.  For each
problem: one warm-up run, one run timed without the profiler (with the
wall of each compaction phase), then one run under ``torch.profiler`` with
each layer of the path wrapped in a ``record_function`` range (convexify,
QP assembly, the IPM, model values, evaluation; inside them the CUDA
kernels).  Prints one JSON line per problem: wall times, phases, device
kernel time and busy share, CUDA kernel launches, the batched QP solves
and batched IPM iterations (a batched QP solve runs as many IPM iterations
as its slowest lane) with the launches per each, K6 ``ipm_banded``'s and
K11 ``ipm_dense``'s device time, host and device time per layer with the IPM layer's share of the
wall, and the top device kernels.  The full ``key_averages`` tables go
to one text file per problem in the repo's output directory.
"""

import argparse
import json
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def _dev_time(evt, self_only=False):
    """Device time (us) of a key_averages row, across torch versions."""
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    for n in names:
        v = getattr(evt, n, None)
        if v is not None:
            return float(v)
    return 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=("free", "full", "pnp", "cartesian",
                                        "ik_goal", "json_table", "json_time"),
                    default="free")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=None)
    args = ap.parse_args()
    steps = args.steps or (12 if args.scene == "pnp" else 30)

    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("torch_profile_slice: CUDA is not available\n")
        sys.exit(2)

    from trajopt_tpu_torch import _native
    from trajopt_tpu_torch.benchmarks import (bench_params, chain_transfer,
                                              make_glass_upright,
                                              make_glass_upright_free,
                                              make_pick_and_place)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _native.build_all()
    dev = torch.device("cuda")
    params = bench_params()
    if args.scene == "pnp":
        spec, data, scene = make_pick_and_place(args.batch, steps,
                                                torch.float32, device=dev)
        res = measure(spec, data, params, dev, smi, args, steps, "approach")
        spec, data = chain_transfer(scene, res.x.reshape(
            args.batch, steps, -1)[:, -1].cpu().numpy())
        measure(spec, data, params, dev, smi, args, steps, "transfer")
        return
    if args.scene in ("cartesian", "ik_goal"):
        from chip_smoke import cartesian_inputs, port_cartesian_problem
        from trajopt_tpu_torch.solver.types import SQPParams

        spec, data, _ = port_cartesian_problem(
            "waypoints" if args.scene == "cartesian" else "ik_goal",
            cartesian_inputs(args.batch, steps), torch.float32, dev)
        measure(spec, data, SQPParams(), dev, smi, args, steps, None,
                compact=False)
        return
    if args.scene in ("json_table", "json_time"):
        from chip_smoke import json_docs, port_json_problem

        kind = "table" if args.scene == "json_table" else "table_time"
        spec, data, par = port_json_problem(
            json_docs(kind, args.batch, steps), torch.float32, dev)[:3]
        measure(spec, data, par, dev, smi, args, steps, None, compact=False)
        return
    make = make_glass_upright if args.scene == "full" \
        else make_glass_upright_free
    spec, data = make(args.batch, n_steps=steps, dtype=torch.float32,
                      device=dev)[:2]
    measure(spec, data, params, dev, smi, args, steps, None)


def measure(spec, data, params, dev, smi, args, steps, problem,
            compact=True):
    """Warm-up, unprofiled and profiled runs of one problem (through
    ``solve_batch_compact``, or ``solve_batch`` without ``compact``); prints
    its JSON line and returns the unprofiled run's result."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from trajopt_tpu_torch import _native
    from trajopt_tpu_torch.kinematics import ik
    from trajopt_tpu_torch.ops import ipm_qp
    from trajopt_tpu_torch.solver import sqp
    from trajopt_tpu_torch.terms import cartesian
    from trajopt_tpu_torch.terms import collision
    from trajopt_tpu_torch.terms.collision import CastDistancePre

    # the SQP's batched QP solves: each call's per-lane IPM iterations
    # (read after the run, so the count adds no sync to it)
    qp_iters = []
    solve_qp = sqp.solve_ipm_qp

    def counted_qp(*a, **k):
        sol = solve_qp(*a, **k)
        qp_iters.append(sol.iters)
        return sol

    sqp.solve_ipm_qp = counted_qp

    def run():
        if compact:
            res = sqp.solve_batch_compact(spec, data, params,
                                          phase_qp_solves=8, device=dev)
        else:
            res = sqp.solve_batch(spec, data, params, device=dev)
        torch.cuda.synchronize()
        return res

    run()
    qp_iters.clear()
    # the wall of each compaction phase (one _solve call each)
    phases = []
    solve_fn = sqp._solve

    def timed_solve(spec_, p_, data_, kernels=True):
        t = time.perf_counter()
        r = solve_fn(spec_, p_, data_, kernels)
        torch.cuda.synchronize()
        phases.append({"lanes": int(data_.x0.shape[0]),
                       "qp_budget": p_.max_total_qp_solves,
                       "wall_s": time.perf_counter() - t})
        return r

    sqp._solve = timed_solve
    _native.reset_launches()
    try:
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
    finally:
        sqp._solve = solve_fn
    launches = dict(_native.LAUNCHES)
    n_qp = len(qp_iters)
    n_ipm = sum(int(it.max()) for it in qp_iters)
    lane_ipm = sum(int(it.sum()) for it in qp_iters)

    # layer ranges: wrap the module-level names the solver calls
    layers = {
        (sqp, "_convexify"): "L:convexify",
        (sqp, "_merit_row_weights"): "L:merit_weights",
        (sqp, "_assemble_qp"): "L:assemble_qp",
        (sqp, "solve_ipm_qp"): "L:ipm_qp",
        (sqp, "_model_values"): "L:model_values",
        (sqp, "_evaluate"): "L:evaluate",
        (ipm_qp, "ipm_banded_cuda"): "K:ipm_banded",
        (ipm_qp, "ipm_dense_cuda"): "K:ipm_dense",
        (CastDistancePre, "value_jac"): "K:cast_seg",
        (CastDistancePre, "value"): "K:cast_seg_value",
        (cartesian, "cart_pose_rows"): "K:cart_pose",
        (ik, "solve_ik"): "K:solve_ik",
        (collision, "contact_select"): "K:contact_select",
    }
    saved = {}
    for (mod, name), label in layers.items():
        fn = getattr(mod, name)
        saved[(mod, name)] = fn

        def wrapped(*a, _fn=fn, _label=label, **k):
            with record_function(_label):
                return _fn(*a, **k)
        setattr(mod, name, wrapped)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            prof_wall = time.perf_counter() - t0
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
        sqp.solve_ipm_qp = solve_qp

    rows = prof.key_averages()

    def on_cuda(e):
        return "CUDA" in str(getattr(e, "device_type", ""))

    def is_range(e):
        return e.key.startswith(("L:", "K:"))

    # device kernels: rows recorded on the card, minus the GPU-side copies
    # of the record_function ranges
    kernels = [e for e in rows if on_cuda(e) and not is_range(e)
               and _dev_time(e, True) > 0]
    dev_us = sum(_dev_time(e, True) for e in kernels)
    n_launch = sum(e.count for e in kernels)
    # per layer: host time of the CPU-side range, and the device time of the
    # kernels launched inside it
    layer_rows = {e.key: {"count": e.count,
                          "host_ms": e.cpu_time_total / 1e3,
                          "device_ms": _dev_time(e) / 1e3}
                  for e in rows if is_range(e) and not on_cuda(e)}
    top = sorted(kernels, key=lambda e: -_dev_time(e, True))[:12]
    k6_ms = sum(_dev_time(e, True) for e in kernels
                if "ipm_banded" in e.key) / 1e3
    k11_ms = sum(_dev_time(e, True) for e in kernels
                 if "ipm_dense" in e.key) / 1e3
    ipm_host_ms = layer_rows.get("L:ipm_qp", {}).get("host_ms", 0.0)
    out = {
        "card": smi, "scene": args.scene, "problem": problem,
        "batch": args.batch, "n_steps": steps, "phases": phases,
        "converged": int((res.status == 1).sum()),
        "mean_qp_solves": float(res.n_qp_solves.float().mean()),
        "wall_s": wall, "profiled_wall_s": prof_wall,
        "device_kernel_ms": dev_us / 1e3,
        "device_busy_share": dev_us / 1e6 / prof_wall,
        "device_kernel_share_of_unprofiled_wall": dev_us / 1e6 / wall,
        "cuda_kernel_launches": n_launch,
        "batched_qp_solves": n_qp,
        "ipm_iterations": n_ipm,
        "lane_ipm_iterations": lane_ipm,
        "launches_per_batched_qp_solve": n_launch / max(n_qp, 1),
        "launches_per_ipm_iteration": n_launch / max(n_ipm, 1),
        "k6_device_ms": k6_ms,
        "k11_device_ms": k11_ms,
        "ipm_layer_share_of_profiled_wall": ipm_host_ms / 1e3 / prof_wall,
        "hand_kernel_launches": launches,
        "layers": layer_rows,
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "device_ms": _dev_time(e, True) / 1e3}
                        for e in top],
    }
    os.makedirs(os.path.join(_ROOT, "chiprun_out"), exist_ok=True)
    tag = args.scene + (f"_{problem}" if problem else "")
    with open(os.path.join(_ROOT, "chiprun_out",
                           f"torch_profile_slice_{tag}.txt"), "w") as f:
        key = ("self_device_time_total" if hasattr(rows[0], "self_device_time_total")
               else "self_cuda_time_total")
        f.write(rows.table(sort_by=key, row_limit=60))
    print(json.dumps(out), flush=True)
    return res


if __name__ == "__main__":
    main()
