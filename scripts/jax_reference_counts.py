#!/usr/bin/env python3
"""The JAX package's own counts on the CPU for the entries of its
``run_benchmarks`` (``trajopt_tpu/benchmarks.py`` ``_BENCHES``): lanes
CONVERGED, lanes gated (CONVERGED, max violation < 1e-4 and, for the
scenes with a collision world, the n_sub=16 swept check >= 0), and the mean
QP solves per lane.  These are counts, not speeds: the limits of the port's
chip_smoke phase on the same entries are these counts less 5.

    JAX_PLATFORMS=cpu python3 scripts/jax_reference_counts.py \\
        [--batch 128] [--names planning redundant_rail] [--out FILE]

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


def one(name, batch):
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
