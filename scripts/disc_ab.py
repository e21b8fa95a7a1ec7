#!/usr/bin/env python3
"""Time K7 disc_dist and K7v disc_dist_value of one checkout of the port
on one CUDA card.

    python3 scripts/disc_ab.py [ROOT] [--label NAME] [--inputs FILE]
                               [--out FILE] [--reps N] [--calls N] [--sweep]
    python3 scripts/disc_ab.py --compare A.pt B.pt

ROOT (default: this checkout) is the directory that holds the
``trajopt_tpu_torch`` package to time; only its ``disc_dist`` library is
built, into its own ``_build/``.  Run it on two checkouts in one call, in
turns (A, B, B, A), to compare two versions of the kernels on one card.
The inputs are made here (float64, numpy noise), captured into FILE
(``--inputs``) when FILE does not exist and loaded from it otherwise, so
that every checkout of one call times the same tensors:

- ``spherebot``: simple_collision's shape, 128 lanes x 1 step, 1 pair,
  n_dof 2 (chip_smoke 2e's x: x0 + N(0, 0.1), seed 8);
- ``arm7``: the flagship's table world (28 pairs) on its x0 + N(0, 0.02)
  (seed 7), 128 x 30, n_dof 7 (chip_smoke 2e's ``flagship_x``);
- ``arm7_dt``: the same x with an inv-dt column (nc 8, U(2, 20)) and the
  steps [1, 30), as a 1/dt grid calls the discrete terms;
- ``boxbot``: 128 x 30, the box-box SAT pair, on 8b's x0 + N(0, 0.05)
  (seed 13);
- ``one_slot``: arm7's first (lane, step), the launch floor;
- ``spheres450``: arm7 with 450 seeded table spheres (3178 pairs) on
  arm7's x, 128 x 4 steps: a world whose tables and slot records outgrow
  a block's shared memory (a launch a checkout does not take is listed
  under ``errors``).

Prints one JSON line with the card's name and power limit: for each of K7
and K7v, float32, at each input, the bare launch on the device clock
(``chip_smoke.device_ms``: the launches, their arguments built once,
queued behind a sleeping kernel) and the wrapper's time per call
(``terms.collision.disc_launch``: host ``perf_counter`` over ``--calls``
calls, before and after the closing synchronize, the least of five such
blocks); and the registers and
local bytes of the instantiations (``disc_dist_attrs``).  ``--sweep``
(a checkout whose launcher takes a CTA of S slots: ``DISC_BLOCKS``) times
K7 / K7v in float32 and float64 at spherebot, arm7, boxbot and
``spheres450`` (arm7 with 450 seeded table spheres, 128 x 4 steps x 3178
pairs, whose tables and slots outgrow a block's shared memory) for every
S in ``SWEEP_SLOTS`` and thread count in ``SWEEP_THREADS`` (at spheres450
128 and 256, the tables staged and not) whose shared memory fits, each
output held bitwise to the default layout's.  ``--out
FILE`` saves every output (D, J) in float32 and float64 for ``--compare``,
which holds two such files element by element: equal, or NaN on both
sides.  Exits non-zero when CUDA is not available.
"""

import argparse
import ctypes
import importlib.util
import itertools
import json
import os
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = ("spherebot", "arm7", "arm7_dt", "boxbot", "one_slot",
          "spheres450")
KINDS = ("disc_dist", "disc_dist_value")
SWEEP_INPUTS = ("spherebot", "arm7", "boxbot", "spheres450")
SWEEP_SLOTS = (1, 2, 4, 6, 8, 10, 12, 16, 32, 64)
SWEEP_THREADS = (32, 64, 128, 192, 256)


def _chip_smoke():
    """This checkout's chip_smoke.py, whatever ROOT is first on the path."""
    spec = importlib.util.spec_from_file_location(
        "disc_ab_chip_smoke", os.path.join(_HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worlds():
    """{name: world} of ROOT's package (the same constructors every run)."""
    import torch

    from trajopt_tpu_torch import models
    from trajopt_tpu_torch.benchmarks import (make_glass_upright,
                                              make_simple_collision)
    from trajopt_tpu_torch.collision.world import build_collision_world

    return {"spherebot": make_simple_collision(1, torch.float64,
                                               device="cpu")[3],
            "arm7": make_glass_upright(1, 30, dtype=torch.float64,
                                       device="cpu")[3],
            "boxbot": build_collision_world(*models.boxbot()),
            "spheres450": spheres_world(450)}


def spheres_world(n):
    """arm7 with n seeded spheres of 3 cm on its table (chip_smoke 2e's
    and test_torch_disc_slots.py's at 450: 3178 pairs), a world whose
    tables and slot records outgrow a block's shared memory."""
    import numpy as np

    from trajopt_tpu_torch import models
    from trajopt_tpu_torch.collision.world import build_collision_world
    from trajopt_tpu_torch.kinematics.urdf import UrdfGeom

    rng = np.random.default_rng(n)
    return build_collision_world(*models.arm7(), attachments=[
        ("table", UrdfGeom("sphere", np.array([0.03]), rng.uniform(
            [-0.6, -0.6, 0.1], [0.6, 0.6, 1.0]), np.zeros(3)))
        for _ in range(n)])


def capture(cs, lanes):
    """{input: {"world", "x" (float64, CPU), "n_steps", "nc", "first",
    "span"}}."""
    import numpy as np
    import torch

    from trajopt_tpu_torch.benchmarks import (make_glass_upright,
                                              make_simple_collision)

    def noisy(x0, sigma, seed):
        return (x0 + torch.as_tensor(np.random.default_rng(seed).normal(
            0.0, sigma, tuple(x0.shape)))).contiguous()

    x_sb = noisy(make_simple_collision(lanes, torch.float64, device="cpu")[1]
                 .x0, 0.1, 8)
    x_arm = noisy(make_glass_upright(lanes, 30, dtype=torch.float64,
                                     device="cpu")[1].x0, 0.02, 7)
    inv = torch.as_tensor(np.random.default_rng(14).uniform(
        2.0, 20.0, (lanes, 30, 1)))
    x_dt = torch.cat([x_arm.reshape(lanes, 30, 7), inv], -1).reshape(
        lanes, -1).contiguous()
    x_box = noisy(cs.port_box_problem(cs.box_docs("box_cast_t30", lanes),
                                      torch.float64, "cpu")[1].x0, 0.05, 13)
    rec = lambda w, x, T, nc, first, span: dict(  # noqa: E731
        world=w, x=x, n_steps=T, nc=nc, first=first, span=span)
    return {"spherebot": rec("spherebot", x_sb, 1, 2, 0, 1),
            "arm7": rec("arm7", x_arm, 30, 7, 0, 30),
            "arm7_dt": rec("arm7", x_dt, 30, 8, 1, 29),
            "boxbot": rec("boxbot", x_box, 30, 2, 0, 30),
            "one_slot": rec("arm7", x_arm[:1, :7].contiguous(), 1, 7, 0, 1),
            "spheres450": rec("spheres450", x_arm.reshape(lanes, 30, 7)[
                :, :4].reshape(lanes, 28).contiguous(), 4, 7, 0, 4)}


def _same(x, y):
    import torch
    return (x == y) | (torch.isnan(x) & torch.isnan(y))


def compare(a_path, b_path):
    import torch
    A = torch.load(a_path, weights_only=True)
    B = torch.load(b_path, weights_only=True)
    rec = {"compare": [A["label"], B["label"]], "outputs": {},
           "all_equal": True}
    for key, x in A["out"].items():
        y = B["out"][key]
        same = _same(x, y) if x.shape == y.shape else torch.zeros(
            1, dtype=torch.bool)
        rec["outputs"][key] = {"elements": int(x.numel()),
                               "differ": int((~same).sum())}
        rec["all_equal"] &= bool(same.all())
    print(json.dumps(rec), flush=True)


def attributes(lib):
    """Registers and local bytes of each instantiation ROOT's library
    reports (``disc_dist_attrs``: 0..3 = K7 f32, f64, K7v f32, f64, 4..7
    the same reading the tables from global memory)."""
    out = {}
    for which, name in enumerate(f"{k}{g}_{s}" for g in ("", "_global")
                                 for k in ("disc_dist", "disc_dist_value")
                                 for s in ("f32", "f64")):
        buf = (ctypes.c_int * 4)()
        if lib.disc_dist_attrs(which, buf) != 0:
            continue
        out[name] = dict(zip(("num_regs", "local_bytes", "max_threads",
                              "static_smem_bytes"), list(buf)))
    return out


def bare_launch(cs, TC, lib, kind, world, x, inp, stream, block=None):
    """A zero-argument bare launch of ROOT's kernel (its outputs allocated
    once) and the outputs (D, J): ``chip_smoke.disc_bare_launch`` where
    ROOT's launcher takes a CTA of slots (``_disc_plan``), else the entry
    point of a launcher that takes one (lane, step) per CTA of
    ``DISC_THREADS`` threads."""
    import torch

    n_steps, nc, first, span = (inp[k] for k in ("n_steps", "nc", "first",
                                                 "span"))
    if hasattr(TC, "_disc_plan"):
        launch, D, J = cs.disc_bare_launch(kind, world, x, n_steps, nc,
                                           first, span, block)
        return launch, (D, J)
    lanes, P = x.shape[0], world.n_pairs
    D = torch.empty((lanes, span, P), dtype=x.dtype, device=x.device)
    J = torch.empty((lanes, span, P, nc), dtype=x.dtype, device=x.device) \
        if kind == "disc_dist" else None
    ints, reals = world.kernel_tables(x.dtype, x.device)
    fn = getattr(lib, f"{kind}_{'f32' if x.dtype == torch.float32 else 'f64'}")
    args = (ints.data_ptr(), reals.data_ptr(), x.data_ptr(), x.stride(0), nc,
            first, span, D.data_ptr(), 0 if J is None else J.data_ptr(),
            lanes, world.chain.n_links, world.chain.n_dof, len(world.geoms),
            P, TC.DISC_THREADS, stream)

    def launch(keep=(x, D, J)):  # the tensors behind the pointers
        code = fn(*args)
        if code != 0:
            raise RuntimeError(f"{kind}: launch returned {code}")
    return launch, (D, J)


def wrapper_ms(fn, calls, blocks=5):
    """(host ms per call to queue ``calls`` calls, ms per call through the
    closing synchronize), each the least over ``blocks`` blocks of calls
    (the host's clock varies with its load)."""
    import torch

    fn()
    torch.cuda.synchronize()
    host, total = [], []
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append(1e3 * (t1 - t0) / calls)
        total.append(1e3 * (t2 - t0) / calls)
    return min(host), min(total)


def sweep(cs, TC, lib, ws, inputs, dev, stream, reps):
    """Every (S, threads) of SWEEP_SLOTS x SWEEP_THREADS whose shared
    memory fits (at spheres450: threads 128 and 256, the tables staged and
    not): K7 / K7v float32 and float64 at SWEEP_INPUTS on the device
    clock, each output bitwise the default layout's."""
    import torch

    out, all_equal = {}, True
    for key in SWEEP_INPUTS:
        inp = inputs[key]
        world = ws[inp["world"]]
        for dt in (torch.float32, torch.float64):
            x = inp["x"].to(dev, dt).contiguous()
            for kind in KINDS:
                ref_fn, ref = bare_launch(cs, TC, lib, kind, world, x, inp,
                                          stream)
                ref_fn()
                big = key == "spheres450"
                for S, nt, g in itertools.product(
                        SWEEP_SLOTS, (128, 256) if big else SWEEP_THREADS,
                        (0, 1) if big else (None,)):
                    block = (S, nt, g)
                    if TC._disc_plan(lib, kind, world, x, inp["n_steps"],
                                     inp["nc"], inp["first"], inp["span"],
                                     block).slots != S:
                        continue  # the slots' shared memory does not fit
                    try:
                        fn, got = bare_launch(cs, TC, lib, kind, world, x,
                                              inp, stream, block)
                        fn()
                    except ValueError:
                        continue  # nor do the staged tables beside them
                    torch.cuda.synchronize()
                    eq = all(bool(_same(a, b).all())
                             for a, b in zip(got, ref) if a is not None)
                    all_equal &= eq
                    ms, _ = cs.device_ms(fn, reps=reps)
                    tag = "" if g is None else f"_stage{g}"
                    out[f"{kind}_{key}_{str(dt)[6:]}_S{S}_t{nt}{tag}"] = {
                        "ms": ms, "equal": eq}
    return out, all_equal


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=_HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--inputs", default="",
                    help="file of the captured inputs: loaded, or captured "
                    "and saved when it does not exist")
    ap.add_argument("--out", default="",
                    help="save every output (float32 and float64) here for "
                    "--compare")
    ap.add_argument("--sweep", action="store_true",
                    help="time every (slots, threads) layout as well")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="compare two --out files and exit")
    a = ap.parse_args()
    if a.compare:
        compare(*a.compare)
        return
    sys.path.insert(0, os.path.abspath(a.root))

    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("disc_ab: CUDA is not available\n")
        sys.exit(2)
    from trajopt_tpu_torch import _native
    from trajopt_tpu_torch.terms import collision as TC
    cs = _chip_smoke()

    dev, lanes = torch.device("cuda"), 128
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build_s = _native.build_all(["disc_dist"])
    lib = _native.library("disc_dist")
    if a.inputs and os.path.exists(a.inputs):
        inputs = torch.load(a.inputs, weights_only=True)
    else:
        inputs = capture(cs, lanes)
        if a.inputs:
            torch.save(inputs, a.inputs)
    ws = worlds()
    stream = torch.cuda.current_stream(dev).cuda_stream

    rec = {"label": a.label, "root": os.path.abspath(a.root), "ms": {},
           "wrapper_host_ms": {}, "wrapper_ms": {}, "shapes": {},
           "errors": {}}
    outs = {}
    for key in INPUTS:
        inp = inputs[key]
        world = ws[inp["world"]]
        n_steps, nc, first, span = (inp[k] for k in ("n_steps", "nc",
                                                     "first", "span"))
        for dt in (torch.float32, torch.float64):
            dname = str(dt)[6:]
            x = inp["x"].to(dev, dt).contiguous()
            for kind in KINDS:
                try:
                    fn, (D, J) = bare_launch(cs, TC, lib, kind, world, x,
                                             inp, stream)
                    fn()
                except (RuntimeError, ValueError) as e:  # a world too large
                    rec["errors"][f"{kind}_{key}_{dname}"] = str(e)
                    continue
                torch.cuda.synchronize()
                outs[f"{key}_{kind}_{dname}_D"] = D.cpu()
                if J is not None:
                    outs[f"{key}_{kind}_{dname}_J"] = J.cpu()
                if dt != torch.float32:
                    continue
                rec["ms"][f"{kind}_{key}"], _ = cs.device_ms(fn, reps=a.reps)
                host, total = wrapper_ms(lambda: TC.disc_launch(
                    kind, world, x, n_steps, nc, first, span), a.calls)
                rec["wrapper_host_ms"][f"{kind}_{key}"] = host
                rec["wrapper_ms"][f"{kind}_{key}"] = total
            rec["shapes"][key] = {"lanes": x.shape[0], "n_steps": n_steps,
                                  "nc": nc, "first": first, "span": span,
                                  "pairs": world.n_pairs}
    if a.sweep and hasattr(TC, "DISC_BLOCKS"):
        rec["blocks"] = {f"{k}_{str(d)[6:]}": v
                         for (k, d), v in TC.DISC_BLOCKS.items()}
        rec["sweep"], rec["sweep_all_equal"] = sweep(
            cs, TC, lib, ws, inputs, dev, stream, min(a.reps, 20))
    if a.out:
        torch.save({"label": a.label, "out": outs}, a.out)
    tables = {f"{k}_{str(dt)[6:]}": sum(t.numel() * t.element_size()
                                        for t in w.kernel_tables(dt, dev))
              for k, w in ws.items() for dt in (torch.float32, torch.float64)}
    rec.update(attributes=attributes(lib), table_bytes=tables,
               reps=a.reps, calls=a.calls, build_s=build_s, card=smi)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
