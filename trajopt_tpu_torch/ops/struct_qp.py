"""The SQP subproblem solution container
(``trajopt_tpu/ops/struct_qp.py:54-61``).

The slack-eliminated ADMM solver (``solve_struct_qp``) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class StructQPSolution(NamedTuple):
    x: torch.Tensor  # (B, n) primal dx
    u: torch.Tensor  # (B, n + m_h + 2 m_a) full primal incl. slacks
    y: torch.Tensor  # (B, m) duals
    status: torch.Tensor  # (B,) int32
    iters: torch.Tensor  # (B,) int32
    prim_res: torch.Tensor  # (B,)
    dual_res: torch.Tensor  # (B,)
