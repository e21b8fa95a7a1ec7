"""Command-line front end: ``python -m trajopt_tpu_torch <command>``
(``trajopt_tpu/__main__.py``).

The analog of the reference's CLI layer (trajopt_common/config.hpp:16-71)
and its JSON problem entry point (``ConstructProblem`` /
``OptimizeProblem``, trajopt/src/problem_description.cpp:394-408, 544).

Commands:
  solve       solve a reference-format JSON problem document, on the card
              unless ``--device cpu`` is given
  bench       run the reference's solve benchmarks and print their results
  decompose   not ported yet (needs ``collision.decompose.decompose``)

``solve -v`` and ``--log-dir`` need ``SQPParams.record_history``, which is
not ported yet: they raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _cmd_solve(args) -> int:
    import numpy as np
    import torch

    from . import models, resolve_device
    from .collision.world import build_collision_world
    from .problem.json_io import load_problem
    from .solver.sqp import solve
    from .solver.types import STATUS_NAMES
    from .utils.lanes import tree_map
    from .utils.telemetry import format_result

    if args.verbose or args.log_dir:
        raise NotImplementedError(
            "solve -v / --log-dir need SQPParams.record_history, which is "
            "not ported yet")
    device = resolve_device(args.device)
    with open(args.problem) as f:
        doc = json.load(f)

    if args.model == "urdf":
        if not args.urdf:
            print("--urdf required with --model urdf", file=sys.stderr)
            return 2
        from .kinematics.chain import build_chain
        from .kinematics.urdf import parse_urdf
        with open(args.urdf) as f:
            model = parse_urdf(f.read())
        joints = (args.joints.split(",") if args.joints
                  else model.actuated_joints())
        chain = build_chain(model, joints)
    else:
        model, chain = getattr(models, args.model)()
    world = build_collision_world(model, chain)

    spec, data, params = load_problem(doc, chain, world, n_sub=args.n_sub,
                                      device=device)
    dtype = torch.float64 if args.f64 else torch.float32
    data = tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    data)
    t0 = time.perf_counter()
    res = solve(spec, data, params, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0

    X = res.x.cpu().numpy().reshape(spec.n_steps, spec.n_cols)
    print(format_result(res, spec))
    print(f"wall: {dt:.3f}s")
    print("trajectory:")
    for row in X:
        print("  " + " ".join(f"{v: .4f}" for v in row))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"status": STATUS_NAMES[int(res.status)],
                       "trajectory": np.asarray(X, np.float64).tolist(),
                       "total_cost": float(res.total_cost),
                       "n_qp_solves": int(res.n_qp_solves)}, f, indent=1)
    return 0 if int(res.status) == 1 else 1


def _cmd_bench(args) -> int:
    from .benchmarks import run_benchmarks
    results = run_benchmarks(names=args.names.split(",") if args.names
                             else None, batch=args.batch,
                             repeats=args.repeats, device=args.device)
    print(json.dumps(results, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


def _cmd_decompose(args) -> int:
    raise NotImplementedError("decompose needs collision.decompose.decompose "
                              "(the approximate convex decomposition), which "
                              "is not ported yet")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trajopt_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("solve", help="solve a JSON problem document")
    sp.add_argument("problem", help="path to reference-format JSON problem")
    sp.add_argument("--model", default="arm7",
                    help="model zoo name (spherebot|boxbot|arm7) or 'urdf'")
    sp.add_argument("--urdf", help="URDF path when --model urdf")
    sp.add_argument("--joints", help="comma-separated joint names (urdf mode)")
    sp.add_argument("--n-sub", type=int, default=8,
                    help="swept-collision substates per gap")
    sp.add_argument("--f64", action="store_true",
                    help="solve in float64 (default float32)")
    sp.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    sp.add_argument("--log-dir", help="write per-iteration CSV logs here "
                    "(not ported yet)")
    sp.add_argument("--out", help="write result JSON here")
    sp.add_argument("-v", "--verbose", action="store_true",
                    help="per-iteration table (not ported yet)")
    sp.set_defaults(fn=_cmd_solve)

    bp = sub.add_parser("bench", help="run benchmark suite")
    bp.add_argument("--names", help="comma-separated benchmark names")
    bp.add_argument("--batch", type=int, default=32)
    bp.add_argument("--repeats", type=int, default=3)
    bp.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    bp.add_argument("--out", help="write results JSON here (the analog of "
                    "the reference's TRAJOPT_ENABLE_RUN_BENCHMARKING output)")
    bp.set_defaults(fn=_cmd_bench)

    dp = sub.add_parser("decompose", help="convex-decompose an OBJ mesh "
                        "(not ported yet)")
    dp.add_argument("mesh", help="OBJ file")
    dp.add_argument("--max-hulls", type=int, default=16)
    dp.add_argument("--out", default="decomposed.json")
    dp.set_defaults(fn=_cmd_decompose)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
