#!/usr/bin/env python3
"""Time K8 solve_ik, K9 cart_pose and K9v cart_pose_value of one checkout
of the port on one CUDA card.

    python3 scripts/pose_ab.py [ROOT] [--label NAME] [--ik6b FILE]
                               [--out FILE] [--reps N] [--phases]
    python3 scripts/pose_ab.py --compare A.pt B.pt

ROOT (default: this checkout) is the directory that holds the
``trajopt_tpu_torch`` package to time; its kernels build into its own
``_build/``.  Run it on two checkouts in one call, in turns (A, B, B, A),
to compare two versions of the pose kernels on one card.  The inputs come
from this checkout's ``chip_smoke.py``:

- K8 on phase 6c's queries (``chip_smoke.ik_inputs``, 128 lanes), the
  full pose and ``pos_only``;
- K8 on phase 6b's launches: every ``solve_ik`` call of one 6b solve (128
  lanes x T=30, float32, ``SQPParams()``), captured with ROOT's package
  into FILE (``--ik6b``) when FILE does not exist and loaded from it
  otherwise, so that every checkout of one call solves the same queries;
- K9 / K9v at phase 2f's shapes (``chip_smoke.pose_inputs``: 128 lanes,
  T=30, step 20; a world target, a moving target, a band).

Prints one JSON line with the card's name and power limit: each kernel's
bare launch on the device clock (``chip_smoke.device_ms``: the launches
queued behind a sleeping kernel), float32, with K8's mean and largest
iteration counts per input.  ``--phases``: K8's timer (library
``solve_ik_timer``, where ROOT has it), float32: each phase's clock64
cycles per lane and iteration (the start per lane), and the slowest
lane's cycles.  ``--out FILE`` saves every output in
float32 and float64 (K8: q, err, converged, iters; K9: E and J, K9v: E)
for ``--compare``, which holds two such files element by element: equal,
or NaN on both sides.  Only the libraries a run needs are built.  Exits
non-zero when CUDA is not available.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IK_FIELDS = ("q", "err_norm", "converged", "iters")
IK_PHASES = ("start", "dual_evaluation", "system", "elimination_and_solve",
             "step_and_clamp", "accept")


def _chip_smoke():
    """This checkout's chip_smoke.py, whatever ROOT is first on the path."""
    spec = importlib.util.spec_from_file_location(
        "pose_ab_chip_smoke", os.path.join(_HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def capture_6b(cs, dev, lanes):
    """Every solve_ik call of one 6b solve (float32), as CPU tensors."""
    import torch

    from trajopt_tpu_torch.kinematics import ik
    from trajopt_tpu_torch.solver.sqp import solve_batch
    from trajopt_tpu_torch.solver.types import SQPParams

    spec, data, _ = cs.port_cartesian_problem(
        "ik_goal", cs.cartesian_inputs(lanes, 30), torch.float32, dev)
    got, orig = [], ik.solve_ik

    def rec(chain, link, target_R, target_p, max_iters=60, tol=1e-6,
            damping=1e-3, pos_only=False, q0=None, kernels=True):
        got.append({"link": link, "target_R": target_R.cpu(),
                    "target_p": target_p.cpu(), "q0": q0.cpu(),
                    "max_iters": max_iters, "tol": tol, "damping": damping,
                    "pos_only": pos_only})
        return orig(chain, link, target_R, target_p, max_iters, tol,
                    damping, pos_only, q0, kernels)
    ik.solve_ik = rec
    try:
        solve_batch(spec, data, SQPParams(), device=dev)
    finally:
        ik.solve_ik = orig
    return got


def _same(x, y):
    import torch
    if x.is_floating_point():
        return (x == y) | (torch.isnan(x) & torch.isnan(y))
    return x == y


def compare(a_path, b_path):
    import torch
    A = torch.load(a_path, weights_only=True)
    B = torch.load(b_path, weights_only=True)
    rec = {"compare": [A["label"], B["label"]], "outputs": {},
           "all_equal": True}
    for key, outs in A["out"].items():
        r = {}
        for name, x in outs.items():
            y = B["out"][key][name]
            same = _same(x, y)
            lanes = same.reshape(same.shape[0], -1).all(-1)
            r[name] = {"elements": int(same.numel()),
                       "differ": int((~same).sum()),
                       "lanes_differ": torch.nonzero(~lanes)[:, 0].tolist()}
            rec["all_equal"] &= bool(same.all())
        rec["outputs"][key] = r
    print(json.dumps(rec), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=_HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ik6b", default="",
                    help="file of 6b's captured solve_ik calls: loaded, or "
                    "captured with ROOT's package and saved when it does "
                    "not exist")
    ap.add_argument("--out", default="",
                    help="save every output (float32 and float64) here for "
                    "--compare")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="compare two --out files and exit")
    ap.add_argument("--phases", action="store_true",
                    help="also K8's phase timer, float32")
    a = ap.parse_args()
    if a.compare:
        compare(*a.compare)
        return
    sys.path.insert(0, os.path.abspath(a.root))

    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("pose_ab: CUDA is not available\n")
        sys.exit(2)
    from trajopt_tpu_torch import _native
    from trajopt_tpu_torch.kinematics.ik import IKResult, _ik_args, solve_ik
    from trajopt_tpu_torch.models import arm7
    from trajopt_tpu_torch.terms.cartesian import _pose_args, cart_pose_rows
    cs = _chip_smoke()

    dev, lanes = torch.device("cuda"), 128
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    timed = "solve_ik_timer" in _native._SIGNATURES
    names = ["cart_pose", "solve_ik"] \
        + (["solve_ik_timer"] if a.phases and timed else [])
    capture = not (a.ik6b and os.path.exists(a.ik6b))
    if capture:  # 6b's path: K8 and K11 at b 7
        names += [_native.k11_library(False, 7)]
    build_s = _native.build_all(sorted(set(names)))
    if capture:
        calls = capture_6b(cs, dev, lanes)
        if a.ik6b:
            torch.save(calls, a.ik6b)
    else:
        calls = torch.load(a.ik6b, weights_only=True)

    _, chain = arm7()
    ik = cs.ik_inputs(lanes)
    queries = {f"6c_{'pos_only' if po else 'full'}": {
        "link": ik["link"], "target_R": torch.as_tensor(ik["target_R"]),
        "target_p": torch.as_tensor(ik["target_p"]),
        "q0": torch.as_tensor(ik["q0"]), "max_iters": 60, "tol": 1e-6,
        "damping": 1e-3, "pos_only": po} for po in (False, True)}
    for i, c in enumerate(calls):
        queries[f"6b_launch{i}"] = c

    rec = {"label": a.label, "root": os.path.abspath(a.root),
           "ms": {}, "iters": {}}
    if a.phases:
        rec["phase_cycles"] = {} if timed else "this checkout's K8 has no " \
            "timer"
    outs = {}
    lib = _native.library("solve_ik")
    for key, c in queries.items():
        for dtype in (torch.float32, torch.float64):
            tR, tp, q0 = (c[k].to(dev, dtype) for k in
                          ("target_R", "target_p", "q0"))
            settings = (c["max_iters"], c["tol"], c["damping"], c["pos_only"])
            fn, args, res, _keep = _ik_args(lib, chain, c["link"], tR, tp,
                                            *settings, q0)
            _native.check("solve_ik", fn(*args))
            torch.cuda.synchronize()
            res = IKResult(*[t.clone() for t in res])
            # the entry point gives the same
            r2 = solve_ik(chain, c["link"], tR, tp, *settings, q0=q0)
            assert all(torch.equal(x, y.to(x.dtype))
                       for x, y in zip(res, r2)), key
            dname = str(dtype).split(".")[-1]
            outs[f"ik_{key}_{dname}"] = {k: getattr(res, k).cpu()
                                         for k in IK_FIELDS}
            if dtype != torch.float32:
                continue
            rec["ms"][f"ik_{key}"], _ = cs.device_ms(
                lambda: _native.check("solve_ik", fn(*args)), reps=a.reps)
            rec["iters"][f"ik_{key}"] = {
                "mean": float(res.iters.double().mean()),
                "max": int(res.iters.max()),
                "converged": int(res.converged.sum())}
            if a.phases and timed:
                clk = torch.zeros((lanes, len(IK_PHASES)), dtype=torch.int64,
                                  device=dev)
                fn_t, args_t, res_t, _keep_t = _ik_args(
                    _native.library("solve_ik_timer"), chain, c["link"], tR,
                    tp, *settings, q0, clk=clk)
                _native.check("solve_ik", fn_t(*args_t))
                torch.cuda.synchronize()
                its = res_t.iters.double()
                cyc = clk.double()
                per_it = (cyc[:, 1:].sum(0) / its.sum()).tolist()
                slow = int(torch.argmax(its))
                rec["phase_cycles"][f"ik_{key}"] = {
                    "per_lane_iteration": dict(zip(IK_PHASES[1:], per_it)),
                    "iteration_total": sum(per_it),
                    "start_per_lane": float(cyc[:, 0].mean()),
                    "slowest_lane": {"iters": int(its[slow]),
                                     "cycles": float(cyc[slow].sum()),
                                     "dual_evaluation": float(cyc[slow, 1])}}

    pchain, x64, configs = cs.pose_inputs(lanes, dev)
    T, step, nd = 30, 20, pchain.n_dof
    tool = pchain.link_index("tool")
    for label, (p64, tgt) in configs.items():
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[-1]
            x = x64.to(dtype)
            p = {k: v.to(dtype) for k, v in p64.items()}
            E, J = cart_pose_rows(pchain, x, p, T, step, tool, tgt, jac=True)
            Ev = cart_pose_rows(pchain, x, p, T, step, tool, tgt)
            outs[f"pose_{label}_{dname}"] = {"E": E.cpu(), "J": J.cpu(),
                                             "E_value": Ev.cpu()}
            if dtype != torch.float32:
                continue
            for key, jac in (("cart_pose", True), ("cart_pose_value", False)):
                fn, args, *_keep = _pose_args(_native.library("cart_pose"),
                                              pchain, x, p, step, nd, tool,
                                              tgt, jac)
                rec["ms"][f"{key}_{label}"], _ = cs.device_ms(
                    lambda: _native.check("cart_pose", fn(*args)),
                    reps=a.reps)
    if a.out:
        torch.save({"label": a.label, "out": outs}, a.out)
    attrs = cs.pose_attributes()
    rec.update(attributes=attrs, reps=a.reps, build_s=build_s,
               ik6b_launches=len(calls), card=smi)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
