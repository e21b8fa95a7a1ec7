#!/usr/bin/env python3
"""Smoke run of the PyTorch port (trajopt_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Every line printed is one JSON object.  Phases, in order:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, and the build of every kernel of ``trajopt_tpu_torch/csrc``
   (one nvcc per source, all at once);
2. each kernel (K1 bb_quad, K2 btd_factor, K3 btd_solve) at the slice's
   shapes and at block sizes 14 and 21, in float32 and float64, on random
   well-conditioned inputs made with numpy, held against its plain PyTorch
   version on the same inputs (tolerances below); then its time, its
   plain version's time, one PyTorch library call's time where one
   computes the same function, and its bound on the card;
3. the slice's main path: ``make_glass_upright_free(batch=128, T=30,
   float32)`` through ``solve_batch_compact(bench_params(),
   phase_qp_solves=8)`` with every launch counter set to 0 just before and
   read just after; every kernel must have launched, no lane may be
   non-finite, and at least 120 of 128 lanes must be CONVERGED with max
   violation < 1e-4;
4. 16 lanes in float64 through the kernel path and through the plain path
   on the card: equal statuses and QP-solve counts, x within 1e-8;
5. the kernel summary line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Any failure raises and the script exits non-zero.  It exits non-zero with
no result when CUDA is not available.
"""

import json
import subprocess
import sys
import time

# kernel vs plain tolerance, relative to the plain result's largest entry:
# float32 carries ~7 digits and the kernels sum in another order than the
# plain versions (one FMA per step, the chains T*b long); float64 ~16
REL_TOL = {"float32": 1e-4, "float64": 1e-10}
# H100 SXM peaks (NVIDIA data sheet): HBM 3.35 TB/s; non-tensor-core
# float32 67 TFLOP/s, float64 34 TFLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def emit(obj):
    print(json.dumps(obj), flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: CUDA is not available\n")
        sys.exit(2)

    import numpy as np

    from trajopt_tpu_torch import _native
    from trajopt_tpu_torch.benchmarks import bench_params, make_glass_upright_free
    from trajopt_tpu_torch.ops import banded_rows as br
    from trajopt_tpu_torch.ops import btridiag as bt
    from trajopt_tpu_torch.solver.sqp import solve_batch_compact
    from trajopt_tpu_torch.solver.types import CONVERGED

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    build_s = _native.build_all()
    ptxas = {}
    for name in _native.LAUNCHES:
        log = (_native.BUILD_DIR / f"{name}.log")
        if log.exists():
            ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln]
    emit({"phase": "setup", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas})

    def sync():
        torch.cuda.synchronize()

    def time_ms(fn, reps=50):
        fn()
        sync()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        sync()
        return t0.elapsed_time(t1) / reps

    def rel_err(got, ref):
        scale = float(ref.abs().max().clamp(min=1e-30))
        return float((got - ref).abs().max()), float((got - ref).abs().max()) / scale

    # ------------------------------------------------------------------
    # phase 2: kernels vs plain versions
    # ------------------------------------------------------------------
    lanes, n_x, D = 128, 210, 7
    rng = np.random.default_rng(0)

    def spd(b, dtype):
        """Block-tridiagonal SPD systems like the IPM's: J' diag(d) J + I
        over gap windows, at n_x = 210 split into blocks of b."""
        T = n_x // b
        W = torch.as_tensor(rng.normal(size=(lanes, T - 1, 2 * b, 2 * b))
                            / np.sqrt(2 * b), device=dev)
        d = torch.as_tensor(rng.uniform(0.5, 2.0, (lanes, (T - 1) * 2 * b)),
                            device=dev)
        Dm = 2.0 * torch.eye(b, dtype=torch.float64, device=dev).repeat(
            lanes, T, 1, 1)
        Om = torch.zeros((lanes, T - 1, b, b), dtype=torch.float64, device=dev)
        br.bb_quad_group_plain(W, torch.arange(T - 1, dtype=torch.int32,
                                               device=dev), d, Dm, Om)
        r = torch.as_tensor(rng.normal(size=(lanes, T, b)), device=dev)
        return Dm.to(dtype), Om.to(dtype), r.to(dtype)

    def k1_inputs(b, dtype, ng, r):
        nb = n_x // b
        Bw = torch.as_tensor(rng.normal(size=(lanes, ng, r, 2 * b)),
                             device=dev).to(dtype)
        G = torch.as_tensor(np.minimum(np.arange(ng), nb - 2).astype(np.int32)
                            if ng > 1 else np.asarray([nb - 2], np.int32),
                            device=dev)
        d = torch.as_tensor(rng.uniform(0.1, 2.0, (lanes, ng * r)),
                            device=dev).to(dtype)
        D0 = torch.as_tensor(rng.normal(size=(lanes, nb, b, b)), device=dev).to(dtype)
        O0 = torch.as_tensor(rng.normal(size=(lanes, nb - 1, b, b)), device=dev).to(dtype)
        return Bw, G, d, D0, O0

    checks = {"bb_quad": [], "btd_factor": [], "btd_solve": []}
    slice_err = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        for b in (7, 14, 21):
            T = n_x // b
            # K1: the upright group (per-step windows, last step doubled up
            # in window nb-2) and the goal group (one window, r = 7)
            for ng, r in ((T, 2), (1, D)):
                Bw, G, d, D0, O0 = k1_inputs(b, dtype, ng, r)
                Dk, Ok = D0.clone(), O0.clone()
                Dp, Op = D0.clone(), O0.clone()
                br.bb_quad_group_cuda(Bw, G, d, Dk, Ok)
                br.bb_quad_group_plain(Bw, G, d, Dp, Op)
                sync()
                ea, er = max(rel_err(Dk, Dp), rel_err(Ok, Op), key=lambda e: e[1])
                ok = er < REL_TOL[dname]
                checks["bb_quad"].append(er)
                emit({"check": "bb_quad", "dtype": dname, "b": b, "n_g": ng,
                      "r": r, "max_abs_err": ea, "max_rel_err": er,
                      "tol": REL_TOL[dname], "ok": ok})
                assert ok, "bb_quad disagrees with its plain version"
                if b == 7 and dname == "float32" and ng == T:
                    slice_err["bb_quad"] = ea
            Dm, Om, rr = spd(b, dtype)
            LDk, LMk = bt.btd_factor_cuda(Dm, Om)
            LDp, LMp = bt.btd_factor_plain(Dm, Om)
            xk = bt.btd_solve_cuda(LDp, LMp, rr)
            xp = bt.btd_solve_plain(LDp, LMp, rr)
            sync()
            for name, (ea, er) in (
                    ("btd_factor", max(rel_err(LDk, LDp), rel_err(LMk, LMp),
                                       key=lambda e: e[1])),
                    ("btd_solve", rel_err(xk, xp))):
                ok = er < REL_TOL[dname]
                checks[name].append(er)
                emit({"check": name, "dtype": dname, "b": b, "T": T,
                      "max_abs_err": ea, "max_rel_err": er,
                      "tol": REL_TOL[dname], "ok": ok})
                assert ok, f"{name} disagrees with its plain version"
                if b == 7 and dname == "float32":
                    slice_err[name] = ea

    # ---- times at the main path's shapes (float32, b = 7, T = 30) ----
    f32, b, T = torch.float32, 7, 30
    es = 4
    Bw, G, d, D0, O0 = k1_inputs(b, f32, T, 2)
    Dm, Om, rr = spd(b, f32)
    LDp, LMp = bt.btd_factor_plain(Dm, Om)
    K = torch.zeros((lanes, n_x, n_x), dtype=f32, device=dev)
    for t in range(T):
        K[:, t * b:(t + 1) * b, t * b:(t + 1) * b] = Dm[:, t]
    for t in range(T - 1):
        K[:, (t + 1) * b:(t + 2) * b, t * b:(t + 1) * b] = Om[:, t]
        K[:, t * b:(t + 1) * b, (t + 1) * b:(t + 2) * b] = Om[:, t].transpose(1, 2)
    Lk = torch.linalg.cholesky(K)
    rflat = rr.reshape(lanes, n_x, 1)
    bb = b * b
    timing = {
        "bb_quad": dict(
            ms=time_ms(lambda: br.bb_quad_group_cuda(Bw, G, d, D0, O0)),
            plain_ms=time_ms(lambda: br.bb_quad_group_plain(Bw, G, d, D0, O0)),
            library_ms=None,
            bytes=es * (Bw.numel() + d.numel() + 2 * (D0.numel() + O0.numel()))
            + 4 * G.numel(),
            flops=lanes * T * 9 * bb * 2,
            shape="B (128, 30, 2, 14) upright group into D (128, 30, 7, 7)"),
        "btd_factor": dict(
            ms=time_ms(lambda: bt.btd_factor_cuda(Dm, Om)),
            plain_ms=time_ms(lambda: bt.btd_factor_plain(Dm, Om), reps=5),
            library_ms=time_ms(lambda: torch.linalg.cholesky(K)),
            bytes=es * 2 * (Dm.numel() + Om.numel()),
            flops=lanes * (T * bb * b // 3 + (T - 1) * 3 * bb * b),
            shape="D (128, 30, 7, 7), O (128, 29, 7, 7)"),
        "btd_solve": dict(
            ms=time_ms(lambda: bt.btd_solve_cuda(LDp, LMp, rr)),
            plain_ms=time_ms(lambda: bt.btd_solve_plain(LDp, LMp, rr), reps=5),
            library_ms=time_ms(lambda: torch.cholesky_solve(rflat, Lk)),
            bytes=es * (LDp.numel() + LMp.numel() + 2 * rr.numel()),
            flops=lanes * 2 * (T * bb + (T - 1) * 2 * bb),
            shape="LD (128, 30, 7, 7), LM (128, 29, 7, 7), r (128, 30, 7)"),
    }
    for name, tm in timing.items():
        t_bytes = tm["bytes"] / PEAK_BYTES * 1e3
        t_ops = tm["flops"] / PEAK_FLOPS["float32"] * 1e3
        tm["bound_ms"] = max(t_bytes, t_ops)
        tm["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        emit({"time": name, **tm, "card": smi})

    # ------------------------------------------------------------------
    # phase 3: the main path, float32, 128 lanes, T = 30
    # ------------------------------------------------------------------
    params = bench_params()
    spec, data, _ = make_glass_upright_free(batch=lanes, n_steps=30,
                                            dtype=torch.float32, device=dev)

    def run():
        res = solve_batch_compact(spec, data, params, phase_qp_solves=8,
                                  device=dev)
        sync()
        return res

    t0 = time.perf_counter()
    run()  # first call: allocator and library warm-up
    cold_s = time.perf_counter() - t0
    _native.reset_launches()
    t0 = time.perf_counter()
    res = run()
    wall_s = time.perf_counter() - t0
    launches = dict(_native.LAUNCHES)
    walls = [wall_s]
    for _ in range(2):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    status = res.status.cpu().numpy()
    viol = res.cnt_viols.max(dim=1).values.cpu().numpy()
    finite = bool(torch.isfinite(res.x).all())
    good = (status == CONVERGED) & (viol < 1e-4)
    n_ok = int(good.sum())
    mean_wall = sum(walls) / len(walls)
    emit({"phase": "slice", "batch": lanes, "n_steps": 30, "dtype": "float32",
          "converged": n_ok, "finite": finite,
          "mean_qp_solves": float(res.n_qp_solves.float().mean()),
          "max_viol": float(viol.max()), "cold_s": cold_s,
          "wall_s": mean_wall, "walls_s": walls,
          "solves_per_s": n_ok / mean_wall, "launches": launches,
          "card": smi})
    assert all(v > 0 for v in launches.values()), launches
    assert finite, "non-finite lanes"
    assert n_ok >= 120, f"only {n_ok}/128 lanes converged"

    # ------------------------------------------------------------------
    # phase 4: kernel path == plain path, float64, 16 lanes, on the card
    # ------------------------------------------------------------------
    spec64, data64, _ = make_glass_upright_free(batch=16, n_steps=30,
                                                dtype=torch.float64,
                                                device=dev)
    rk = solve_batch_compact(spec64, data64, params, phase_qp_solves=8,
                             device=dev, kernels=True)
    t0 = time.perf_counter()
    rp = solve_batch_compact(spec64, data64, params, phase_qp_solves=8,
                             device=dev, kernels=False)
    sync()
    plain_s = time.perf_counter() - t0
    same_status = bool((rk.status == rp.status).all())
    same_nqp = bool((rk.n_qp_solves == rp.n_qp_solves).all())
    dx = float((rk.x - rp.x).abs().max())
    emit({"phase": "f64_kernel_vs_plain", "lanes": 16,
          "status": rk.status.tolist(), "n_qp": rk.n_qp_solves.tolist(),
          "same_status": same_status, "same_n_qp": same_nqp,
          "max_abs_dx": dx, "tol": 1e-8, "plain_path_s": plain_s})
    assert same_status and same_nqp and dx < 1e-8, "kernel path != plain path"

    # ------------------------------------------------------------------
    # summary
    # ------------------------------------------------------------------
    replaces = {
        "bb_quad": "trajopt_tpu/ops/banded_rows.py:89",
        "btd_factor": "trajopt_tpu/ops/btridiag.py:208",
        "btd_solve": "trajopt_tpu/ops/btridiag.py:234",
    }
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"trajopt_tpu_torch/csrc/{name}.cu",
         "replaces": replaces[name], "launches": launches[name],
         "ok": True, "max_rel_err": max(checks[name]),
         "max_abs_err": slice_err[name],
         "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound_ms"],
         "bound_by": timing[name]["bound_by"],
         "library_ms": timing[name]["library_ms"]}
        for name in ("bb_quad", "btd_factor", "btd_solve")]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
