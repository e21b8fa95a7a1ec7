"""QP settings, backend resolution and status codes
(``trajopt_tpu/ops/qp.py:38-129``).

The ADMM solver itself (``solve_qp``) is not ported yet; the SQP loop of
this package runs the interior-point backend (``ops.ipm_qp``).
"""

from __future__ import annotations

import dataclasses
import os

# Reference solver names (sco::ModelType, solver_interface.hpp + the
# TRAJOPT_CONVEX_SOLVER env override, solver_interface.cpp:305-325) mapped
# onto this framework's backends: OSQP-class -> the ADMM kernel, BPMPD-class
# -> the interior-point kernel.
CONVEX_SOLVER_NAMES = {
    "OSQP": "admm",
    "ADMM": "admm",
    "BPMPD": "ipm",
    "IPM": "ipm",
    "AUTO": "auto",
    "AUTO_SOLVER": "auto",
}


def resolve_solver(name: str) -> str:
    """Resolve a QPSettings.solver value to a concrete backend.

    "auto" honors the TRAJOPT_CONVEX_SOLVER environment variable (reference
    createModel, trajopt_sco/src/solver_interface.cpp:305-325) and otherwise
    picks the preferred backend ("ipm").
    """
    got = CONVEX_SOLVER_NAMES.get(name.upper(), name.lower())
    if got == "auto":
        env = os.environ.get("TRAJOPT_CONVEX_SOLVER", "")
        if env and env.upper() not in ("AUTO", "AUTO_SOLVER"):
            env_got = CONVEX_SOLVER_NAMES.get(env.upper())
            if env_got in (None, "auto"):
                raise ValueError(
                    f"invalid solver {env!r} specified by "
                    "TRAJOPT_CONVEX_SOLVER (supported: "
                    f"{sorted(CONVEX_SOLVER_NAMES)})")
            return env_got
        return "ipm"
    if got not in ("admm", "ipm"):
        raise ValueError(
            f"convex solver {name!r} is not built in this framework "
            "(supported: OSQP/ADMM, BPMPD/IPM, AUTO_SOLVER — the reference's "
            "Gurobi/qpOASES backends are not ported, SURVEY §2.7.5)")
    return got


# QP status codes
QP_UNSOLVED = 0
QP_SOLVED = 1
QP_SOLVED_INACCURATE = 2
QP_MAX_ITER = 3


@dataclasses.dataclass(frozen=True)
class QPSettings:
    """Static solver settings (hashable).

    Defaults mirror the reference OSQP configuration
    (trajopt_sco/src/osqp_interface.cpp:78-90).
    """

    sigma: float = 1e-6
    alpha: float = 1.6
    rho: float = 0.1
    rho_eq_scale: float = 1e3  # rho multiplier on equality rows (l == u)
    rho_min: float = 1e-6
    rho_max: float = 1e6
    eps_abs: float = 1e-4
    eps_rel: float = 1e-6
    max_iter: int = 4000
    check_interval: int = 25
    adaptive_rho: bool = True
    adaptive_rho_interval: int = 100
    adaptive_rho_tol: float = 5.0  # only change rho if ratio exceeds this
    scaling_iters: int = 10
    refine_steps: int = 1  # iterative-refinement steps on each KKT solve
    # inner solver for the SQP subproblem: "admm" (OSQP parity), "ipm"
    # (Mehrotra predictor-corrector, ops.ipm_qp — the BPMPD-class backend),
    # or "auto" (the TRAJOPT_CONVEX_SOLVER env var if set, else "ipm")
    solver: str = "auto"
    max_ipm_iter: int = 40
    # KKT block size for the block-tridiagonal Cholesky path (ops.btridiag):
    # 0 = dense.  solver.sqp auto-sets it from the term metadata.
    kkt_block: int = 0
