#!/usr/bin/env python3
"""Time K10 contact_select and K10v contact_select_value of one checkout
of the port on one CUDA card.

    python3 scripts/select_ab.py [ROOT] [--label NAME] [--inputs FILE]
                                 [--out FILE] [--reps N]
    python3 scripts/select_ab.py --compare A.pt B.pt

ROOT (default: this checkout) is the directory that holds the
``trajopt_tpu_torch`` package to time; its kernels build into its own
``_build/``.  Run it on two checkouts in one call, in turns (A, B, B, A),
to compare two versions of the selection on one card.  The inputs come
from this checkout's ``chip_smoke.py`` (``select_inputs``, the plain
distance pipelines, 128 lanes x T=30), float32 and float64, captured into
FILE (``--inputs``) when FILE does not exist and loaded from it otherwise,
so that every checkout of one call selects on the same inputs:

- ``7a_cast``: phase 2g's cast form on 7a's problem (29 gaps x 7 segments
  x 28 pairs, nc 7), K = 3;
- ``7a_discrete``: the discrete form on the full table world (30 steps x
  28 pairs, nc 7);
- ``7b_cast``: the cast form on 7b's problem (nc 8: the 1/dt column);
- ``one_group``: 7a_cast's first (lane, group), the same kernel's launch
  floor.

Prints one JSON line with the card's name and power limit: each kernel's
bare launch on the device clock (``chip_smoke.device_ms``: the launches
queued behind a sleeping kernel), float32, and each instantiation's
registers and local bytes.  ``--out FILE`` saves every output in float32
and float64 (K10's values and rows, K10v's values) for ``--compare``,
which holds two such files element by element: equal, or NaN on both
sides.  Only the selection's library is built.  Exits non-zero when CUDA
is not available.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = ("7a_cast", "7a_discrete", "7b_cast", "one_group")


def _chip_smoke():
    """This checkout's chip_smoke.py, whatever ROOT is first on the path."""
    spec = importlib.util.spec_from_file_location(
        "select_ab_chip_smoke", os.path.join(_HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def capture(cs, dev, lanes):
    """{input: {dtype: (D, margins, coeffs, Ja, Jb, right_group)}} as CPU
    tensors (Jb None for the discrete form)."""
    import torch

    probs = {kind: cs.port_json_problem(cs.json_docs(kind, lanes),
                                        torch.float32, dev)
             for kind in ("table", "table_time")}
    out = {k: {} for k in INPUTS}
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[-1]
        a = cs.select_inputs(probs["table"], lanes, dt, kernels=False)
        b = cs.select_inputs(probs["table_time"], lanes, dt, kernels=False)
        for key, val in (("7a_cast", a["cast"]),
                         ("7a_discrete", a["discrete"]),
                         ("7b_cast", b["cast"])):
            out[key][name] = tuple(t.cpu() if torch.is_tensor(t) else t
                                   for t in val)
        D, m, c, Ja, Jb, right = out["7a_cast"][name]
        out["one_group"][name] = (D[:1, :1].contiguous(), m[:1].contiguous(),
                                  c[:1].contiguous(), Ja[:1, :1].contiguous(),
                                  Jb[:1, :1].contiguous(), right)
    return out


def _same(x, y):
    import torch
    return (x == y) | (torch.isnan(x) & torch.isnan(y))


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
            same = _same(x, y) if x.shape == y.shape else torch.zeros(
                1, dtype=torch.bool)
            r[name] = {"elements": int(x.numel()),
                       "differ": int((~same).sum())}
            rec["all_equal"] &= bool(same.all())
        rec["outputs"][key] = r
    print(json.dumps(rec), flush=True)


def attributes(lib):
    """Registers and local bytes of each instantiation ROOT's library
    reports (``contact_select_attrs``)."""
    out = {}
    for which in range(4):
        buf = (ctypes.c_int * 4)()
        if lib.contact_select_attrs(which, buf) != 0:
            continue
        out[which] = dict(zip(("num_regs", "local_bytes", "max_threads",
                               "static_smem_bytes"), list(buf)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=_HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--inputs", default="",
                    help="file of the captured inputs: loaded, or captured "
                    "with ROOT's package and saved when it does not exist")
    ap.add_argument("--out", default="",
                    help="save every output (float32 and float64) here for "
                    "--compare")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="compare two --out files and exit")
    a = ap.parse_args()
    if a.compare:
        compare(*a.compare)
        return
    sys.path.insert(0, os.path.abspath(a.root))

    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("select_ab: CUDA is not available\n")
        sys.exit(2)
    from trajopt_tpu_torch import _native
    from trajopt_tpu_torch.terms.collision import contact_select
    cs = _chip_smoke()

    dev, lanes = torch.device("cuda"), 128
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build_s = _native.build_all(["contact_select"])
    if a.inputs and os.path.exists(a.inputs):
        inputs = torch.load(a.inputs, weights_only=True)
    else:
        inputs = capture(cs, dev, lanes)
        if a.inputs:
            torch.save(inputs, a.inputs)

    K, buf = cs.SELECT_K, cs.SELECT_BUFFER
    rec = {"label": a.label, "root": os.path.abspath(a.root), "ms": {},
           "shapes": {}}
    outs = {}
    for key in INPUTS:
        for dname, val in inputs[key].items():
            D, m, c, Ja, Jb, right = (t.to(dev) if torch.is_tensor(t) else t
                                      for t in val)
            jac = (Ja, Jb, right)
            vals, rows = contact_select(D, m, c, buf, K, *jac)
            vv = contact_select(D, m, c, buf, K)
            torch.cuda.synchronize()
            outs[f"{key}_{dname}"] = {"values": vals.cpu(),
                                      "rows": rows.cpu(),
                                      "values_K10v": vv.cpu()}
            if dname != "float32":
                continue
            rec["shapes"][key] = list(D.shape) + [Ja.shape[-1]]
            for kname, args in (("contact_select", jac),
                                ("contact_select_value", ())):
                rec["ms"][f"{kname}_{key}"], _ = cs.device_ms(
                    lambda: contact_select(D, m, c, buf, K, *args),
                    reps=a.reps)
    if a.out:
        torch.save({"label": a.label, "out": outs}, a.out)
    rec.update(attributes=attributes(_native.library("contact_select")),
               reps=a.reps, build_s=build_s, card=smi)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
