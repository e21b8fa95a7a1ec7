"""Host-side solve telemetry (``trajopt_tpu/utils/telemetry.py``): the
result summary.  The iteration tables and CSV log streams need
``SQPParams.record_history``, which is not ported yet."""

from __future__ import annotations

from ..solver.types import STATUS_NAMES, ProblemSpec, SQPResult


def format_result(res: SQPResult, spec: ProblemSpec) -> str:
    """Reference-style summary of one instance's result, ``res`` without a
    lane axis (OptResults operator<<)."""
    lines = [
        "Optimization results:",
        f"status: {STATUS_NAMES.get(int(res.status), '?')}",
        f"total cost: {float(res.total_cost):.6g}",
        f"n func evals: {int(res.n_func_evals)}",
        f"n qp solves: {int(res.n_qp_solves)}",
    ]
    for t, v in zip(spec.cost_terms, res.cost_vals.tolist()):
        lines.append(f"  cost {t.name}: {float(v):.6g}")
    for t, v, m in zip(spec.cnt_terms, res.cnt_viols.tolist(),
                       res.merit_coeffs.tolist()):
        lines.append(f"  cnt {t.name}: viol={float(v):.3g} merit={float(m):.3g}")
    return "\n".join(lines)
