"""SQP solver types: parameters, statuses, results
(``trajopt_tpu/solver/types.py``).

Parameter names/defaults mirror the reference
``BasicTrustRegionSQPParameters`` (trajopt_sco/include/trajopt_sco/
optimizers.hpp:92-135) so configs translate 1:1.  Every tensor of
``ProblemData`` and ``SQPResult`` carries a leading lane axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from ..ops.qp import QPSettings
from ..terms.base import Term

# Status codes (reference OptStatus, trajopt_sco/include/trajopt_sco/
# optimizers.hpp:25-33; RUNNING is the in-progress sentinel).
RUNNING = 0
CONVERGED = 1
SCO_ITERATION_LIMIT = 2
PENALTY_ITERATION_LIMIT = 3
FAILED = 4
STOPPED_BY_CALLBACK = 5
TIME_LIMIT = 6

STATUS_NAMES = {
    RUNNING: "RUNNING",
    CONVERGED: "OPT_CONVERGED",
    SCO_ITERATION_LIMIT: "OPT_SCO_ITERATION_LIMIT",
    PENALTY_ITERATION_LIMIT: "OPT_PENALTY_ITERATION_LIMIT",
    FAILED: "OPT_FAILED",
    STOPPED_BY_CALLBACK: "OPT_STOPPED_BY_CALLBACK",
    TIME_LIMIT: "OPT_TIME_LIMIT",
}

_NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class SQPParams:
    """Trust-region penalty SQP knobs."""

    improve_ratio_threshold: float = 0.25
    min_trust_box_size: float = 1e-4
    min_approx_improve: float = 1e-4
    min_approx_improve_frac: float = _NEG_INF
    max_iter: int = 50
    trust_shrink_ratio: float = 0.1
    trust_expand_ratio: float = 1.5
    cnt_tolerance: float = 1e-4
    max_merit_coeff_increases: int = 5
    max_qp_solver_failures: int = 3
    merit_coeff_increase_ratio: float = 10.0
    initial_merit_error_coeff: float = 10.0
    inflate_constraints_individually: bool = True
    trust_box_size: float = 1e-1
    max_trust_box_size: float = float("inf")
    # backstop cap on total QP solves per lane
    max_total_qp_solves: int = 3000
    # wall-clock limit in seconds (TIME_LIMIT); the three below it are not
    # ported yet: the solver raises NotImplementedError when they are set
    max_time: float = float("inf")
    record_history: int = 0
    record_history_x: bool = False
    callback: Optional[Any] = None
    qp: QPSettings = QPSettings()


@dataclasses.dataclass(frozen=True, eq=False)
class ProblemSpec:
    """Static problem-class description (shapes + term functions)."""

    n_x: int
    cost_terms: tuple[Term, ...] = ()
    cnt_terms: tuple[Term, ...] = ()
    # trajectory grid shape (n_x == n_steps * n_cols when set)
    n_steps: int = 0
    n_cols: int = 0

    def __post_init__(self):
        for t in self.cost_terms:
            assert t.is_cost, f"{t.name} is not a cost term"
        for t in self.cnt_terms:
            assert not t.is_cost, f"{t.name} is not a constraint term"


class ProblemData(NamedTuple):
    """Per-instance data; every tensor leaf has a leading lane axis."""

    x0: torch.Tensor  # (B, n_x) initial iterate
    lb: torch.Tensor  # (B, n_x) variable lower bounds (limits / fixed vars)
    ub: torch.Tensor  # (B, n_x)
    cost_params: tuple  # dict of (B, ...) tensors per cost term
    cnt_params: tuple  # dict of (B, ...) tensors per constraint term
    # optional mid-solve resume state (None = fresh solve): a dict with
    # "merit" (B, n_entries), "box" (B,), "penalty_it" (B,) int32,
    # "it" (B,) int32 — used by the multi-phase batched solve
    resume: Any = None


class SQPResult(NamedTuple):
    """Solve outcome (reference OptResults, optimizers.hpp:40-59)."""

    x: torch.Tensor  # (B, n_x) final iterate
    status: torch.Tensor  # (B,) int32
    cost_vals: torch.Tensor  # (B, n_cost) per-term exact costs at x
    cnt_viols: torch.Tensor  # (B, n_cnt) per-group violations at x
    total_cost: torch.Tensor  # (B,)
    n_func_evals: torch.Tensor  # (B,) int32
    n_qp_solves: torch.Tensor  # (B,) int32
    n_admm_iters: torch.Tensor  # (B,) int32 total inner iterations
    merit_coeffs: torch.Tensor  # (B, n_cnt)
    trust_box_size: torch.Tensor  # (B,)
    sqp_it: torch.Tensor  # (B,) int32 accepted steps in the penalty round
    penalty_it: torch.Tensor  # (B,) int32 merit-coefficient increases
